"""Plots of the activation functions the models run, from the port's own
implementations (``ops/act.py``, which ``models/layers.py`` applies).

    python -m double_yolo_kaist_torch.plot_activations [out.png] \\
        [--panel zoo|curves] [--device cuda]

``--panel zoo`` (the default) is the port's counterpart of the JAX
package's ``tools/plot_activations.py``: every activation of the cfg layer
zoo but ``linear`` on one axis over [-6, 6]. ``--panel curves`` is the
``activations`` plot of ``tools/plot_curves.py`` (:104-130; reference
docs/draw_activation.py:1-40): a 2x2 panel of sigmoid, tanh, leaky ReLU
(0.1) and mish over [-10, 10). The functions run on ``--device``. It needs
matplotlib, and exits naming it where it is absent.
"""

from __future__ import annotations

import argparse

import numpy as np


def curves(panel: str, device) -> list:
    """[(label, x, y)]: what ``panel`` draws, each y computed on
    ``device`` by the port's own activations (the sigmoid and tanh of the
    ``curves`` panel are numpy's, as in the JAX tool)."""
    import torch

    from .ops.act import ACTIVATIONS, activate

    def run(fn, z):
        return fn(torch.from_numpy(z).to(device)).cpu().numpy()

    if panel == "zoo":
        x = np.linspace(-6, 6, 400, dtype=np.float32)
        return [(name, x, run(fn, x)) for name, fn in ACTIVATIONS.items()
                if name != "linear"]
    z = np.arange(-10, 10, 0.01, dtype=np.float32)
    return [("(a) Sigmoid", z, 1.0 / (1.0 + np.exp(-z))),
            ("(b) Tanh", z, np.tanh(z)),
            ("(c) Leaky ReLU", z, run(lambda t: activate("leaky", t), z)),
            ("(d) Mish", z, run(lambda t: activate("mish", t), z))]


def main(argv=None) -> str:
    """Writes the PNG; returns its path."""
    from .common import pyplot

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="activations.png")
    ap.add_argument("--panel", choices=("zoo", "curves"), default="zoo")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    plt = pyplot("plot_activations")

    from . import resolve_device

    lines = curves(args.panel, resolve_device(args.device))
    if args.panel == "zoo":
        fig, ax = plt.subplots(figsize=(8, 6))
        for name, x, y in lines:
            ax.plot(x, y, label=name)
        ax.grid(alpha=0.3)
        ax.legend()
        ax.set_title("activation functions")
        fig.savefig(args.out, bbox_inches="tight", dpi=120)
    else:
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        for ax, (title, z, g) in zip(axes.flat, lines):
            ax.spines["right"].set_visible(False)
            ax.spines["top"].set_visible(False)
            ax.set_title(title, y=-0.25)
            ax.set_xticks(np.linspace(-10, 10, 5))
            ax.set_xlabel("z")
            ax.set_ylabel("g(z)")
            ax.plot(z, g)
        fig.subplots_adjust(left=0.1, right=0.9, bottom=0.1, top=0.98,
                            wspace=0.3, hspace=0.3)
        fig.savefig(args.out, bbox_inches="tight", dpi=100)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
