"""Learning-dynamics check: overfit the tiny model on a synthetic 8-image
split and confirm that AP@0.5 climbs past 0.5. It holds the whole chain
end to end (pipeline -> loss -> gradients -> decode -> NMS -> metrics)
with no KAIST data.

    python -m double_yolo_kaist_torch.overfit_check [epochs] [--int8] \
        [--pct-sweep] [--device cuda]

The counterpart of the JAX package's ``tools/overfit_check.py``: the same
split, recipe and gates, on the port's ``train_batches``,
``make_train_step`` and ``evaluate_dataset``. With ``--int8`` the trained
weights are also evaluated through every int8 mode, each held within
``int8_tol`` of the fp AP (``edge_tol`` for edge, whose per-channel scales
are coarse on a 16-channel model). ``python -m double_yolo_kaist_torch.
bench --check-ap`` runs it with ``--int8``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from . import resolve_device
from .config.ir import compile_cfg
from .data.dataset import KaistDataset
from .data.pipeline import train_batches
from .eval.evaluator import evaluate_dataset
from .models import quantize as Q
from .train import optim as OPT
from .train.step import create_train_state, make_train_step
from .utils.general import deterministic

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tests", "fixtures", "tiny_dyolov3.cfg")
HYP = {"lr0": 5e-3, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0,
       "box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
       "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0,
       "degrees": 0, "translate": 0, "scale": 0, "shear": 0}


def make_dataset(root: str) -> str:
    """8 pairs of 128x160 with one bright "pedestrian" rectangle each at a
    seeded place; returns the split file."""
    import cv2

    img_dir = os.path.join(root, "images", "set00")
    lab_dir = os.path.join(root, "labels", "set00")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    rng = np.random.default_rng(0)
    logical = []
    for i in range(8):
        v = np.full((128, 160, 3), 40, np.uint8)
        l = np.full((128, 160, 3), 60, np.uint8)
        cx, cy = rng.uniform(0.25, 0.75), rng.uniform(0.3, 0.7)
        w, h = 0.15, 0.4
        x1, y1 = int((cx - w / 2) * 160), int((cy - h / 2) * 128)
        x2, y2 = int((cx + w / 2) * 160), int((cy + h / 2) * 128)
        v[y1:y2, x1:x2] = (220, 180, 120)
        l[y1:y2, x1:x2] = 230
        stem = f"I{i:05d}"
        cv2.imwrite(os.path.join(img_dir, f"{stem}_visible.jpg"), v)
        cv2.imwrite(os.path.join(img_dir, f"{stem}_lwir.jpg"), l)
        with open(os.path.join(lab_dir, f"{stem}.txt"), "w") as f:
            f.write(f"0 {cx:.4f} {cy:.4f} {w} {h}\n")
        logical.append(os.path.join(img_dir, f"{stem}.jpg"))
    split = os.path.join(root, "train.txt")
    with open(split, "w") as f:
        f.write("\n".join(logical) + "\n")
    return split


def main(epochs: int = 60, int8: bool = False, int8_tol: float = 0.05,
         int8_pcts: tuple = (100.0,), edge_tol: float = 0.15, device=None):
    """Overfit the tiny model (fp32) and assert the final AP@0.5 > 0.5.
    Returns the fp AP, and with ``int8`` also {(mode, pct): AP}.
    ``device``: None means ``cuda``. The whole check runs in true fp32
    under deterministic algorithms (:func:`.utils.general.deterministic`),
    so a device reaches the same weights, and the gates the same verdict,
    on every run."""
    with deterministic():
        return _main(epochs, int8, int8_tol, int8_pcts, edge_tol,
                     resolve_device(device))


def _main(epochs, int8, int8_tol, int8_pcts, edge_tol, dev):
    tmp = tempfile.mkdtemp()
    split = make_dataset(tmp)
    train_ds = KaistDataset(split, 64, 8, augment=True, hyp=HYP)
    val_ds = KaistDataset(split, 64, 8, rect=True)
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    sched = OPT.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], epochs, 1,
                                      warmup=False)
    tx = OPT.make_optimizer(HYP, sched, sgd=False)
    state = create_train_state(ir, 0, tx, device=dev)
    step = make_train_step(ir, HYP, tx, compute_dtype=torch.float32)

    ap_history = []
    for epoch in range(epochs):
        for batch, _ in train_batches(train_ds, 8, 7 * 1_000_003 + epoch,
                                      img_size=64, hyp=HYP,
                                      seed_epoch=epoch, device=dev):
            state, metrics = step(state, batch)
        if epoch % 10 == 9 or epoch == epochs - 1:
            res = evaluate_dataset(ir, _detached(state), val_ds,
                                   batch_size=8, conf_thres=0.01,
                                   compute_dtype=torch.float32, folded=False,
                                   device=dev)
            ap_history.append(res["ap"])
            print(f"epoch {epoch}: loss={float(metrics['loss']):.2f} "
                  f"AP@0.5={res['ap'] * 100:.1f}% "
                  f"LAMR={res['lamr'] * 100:.1f}%", flush=True)
    print("AP trajectory:", [f"{a * 100:.1f}" for a in ap_history])
    assert ap_history[-1] > 0.5, "overfit failed to reach AP 50%"
    fp_ap = float(ap_history[-1])
    int8_aps: dict = {}
    if int8:
        for pct in int8_pcts:
            for mode in Q.MODES:
                res_q = evaluate_dataset(
                    ir, _detached(state), val_ds, batch_size=8,
                    conf_thres=0.01, compute_dtype=torch.float32, int8=True,
                    int8_mode=mode, calibration_batches=1,
                    calibration_pct=pct, device=dev)
                int8_aps[(mode, pct)] = float(res_q["ap"])
                print(f"int8[{mode}, pct={pct}]: AP@0.5="
                      f"{res_q['ap'] * 100:.1f}% (fp {fp_ap * 100:.1f}%)",
                      flush=True)
                tol = edge_tol if mode == "edge" else int8_tol
                assert res_q["ap"] >= fp_ap - tol, (
                    f"int8 {mode}@pct{pct} AP {res_q['ap']:.3f} fell more "
                    f"than {tol} below fp {fp_ap:.3f}")
        print("INT8 AP GATE PASSED")
    print("OVERFIT CHECK PASSED")
    return (fp_ap, int8_aps) if int8 else fp_ap


def _detached(state) -> dict:
    from .utils import tree as TR

    return {"params": TR.map_leaves(lambda p: p.detach(), state.params),
            "state": state.bn_state}


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("epochs", nargs="?", type=int, default=60)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--pct-sweep", action="store_true",
                   help="check the 99.9 clipping percentile too")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    opt = p.parse_args(argv)
    return main(opt.epochs, int8=opt.int8,
                int8_pcts=(100.0, 99.9) if opt.pct_sweep else (100.0,),
                device=opt.device)


if __name__ == "__main__":
    cli()
