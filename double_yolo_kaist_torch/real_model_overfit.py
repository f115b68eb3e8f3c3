"""Real-zoo-model learning check: overfit a real cfg (the MobileNetv3 dual
model by default) on synthetic KAIST-sized pedestrian images and confirm
that AP@0.5 climbs.

    python -m double_yolo_kaist_torch.real_model_overfit [--model <zoo
        name or cfg>] [--steps 150] [--size 256 320] [--min-ap 0.5] \\
        [--device cuda]

The port's counterpart of the JAX package's ``tools/real_model_overfit.py``
(its ``--cpu`` is ``--device cpu`` here): 8 gray scenes with 1-2 bright
"pedestrian" boxes each, visible + LWIR, one fixed batch; Adam at lr 3e-3
on a cosine schedule, bf16 activations, 4 checkpointed segments, from
``graph.init``; every 50 steps the loss and the AP@0.5 of the eval forward
+ NMS on the same 8 frames. It holds the whole train loop on a production
cfg (strides, anchors, BN, decode), where the unit tests use a tiny cfg,
and exits 1 when the final AP is below ``--min-ap``. It trains under
deterministic algorithms (``utils.general.deterministic``), so a run on a
card repeats its weights and its verdict; it prints the final AP's
margin over ``--min-ap``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

HYP = {"lr0": 3e-3, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0,
       "box": 3.54, "obj": 102.88, "cls": 0.468, "cls_pw": 1.0,
       "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0}


def make_data(n=8, h=256, w=320, seed=0):
    """Gray scenes with 1-2 bright 'pedestrian' boxes, visible + LWIR ->
    (v, l, targets, tmask, labels)."""
    from .train import loss as LS

    rng = np.random.default_rng(seed)
    v = np.full((n, h, w, 3), 90, np.uint8)
    l = np.full((n, h, w, 3), 70, np.uint8)
    labels = []
    for i in range(n):
        rows = []
        for _ in range(rng.integers(1, 3)):
            cx, cy = rng.uniform(0.2, 0.8), rng.uniform(0.3, 0.75)
            bw, bh = rng.uniform(0.08, 0.14), rng.uniform(0.25, 0.4)
            x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            x2, y2 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
            v[i, y1:y2, x1:x2] = rng.integers(160, 255, 3)
            l[i, y1:y2, x1:x2] = 235
            rows.append([0, cx, cy, bw, bh])
        labels.append(np.asarray(rows, np.float32))
    t, m = LS.pad_labels(labels, 8)
    return v, l, t, m, labels


def main(argv=None) -> int:
    from . import resolve_device
    from .common import card_label, resolve_cfg
    from .config.ir import compile_cfg
    from .eval.metrics import compute_ap_lamr
    from .models import graph
    from .ops.nms import non_max_suppression
    from .train import optim as OPT
    from .train.step import create_train_state, make_train_step
    from .utils.general import deterministic

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="Double-YOLOv4-MNv3-Fshare-Global-CSE3",
                    help="zoo name or cfg")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, nargs=2, default=[256, 320])
    ap.add_argument("--min-ap", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bf16 = torch.bfloat16

    h, w = args.size
    ir = compile_cfg(resolve_cfg(args.model))
    v, l, t, m, labels = make_data(h=h, w=w)
    batch = {"v": torch.from_numpy(v).to(dev),
             "l": torch.from_numpy(l).to(dev),
             "targets": torch.from_numpy(t).to(dev),
             "tmask": torch.from_numpy(m).to(dev)}
    if not ir.dual_stream:
        del batch["l"]

    sched = OPT.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"],
                                      epochs=args.steps, steps_per_epoch=1,
                                      warmup=False)
    tx = OPT.make_optimizer(HYP, sched, sgd=False)
    state = create_train_state(ir, 0, tx, device=dev)
    step = make_train_step(ir, HYP, tx, compute_dtype=bf16,
                           remat_segments=4)
    rng = torch.Generator(device=dev)
    rng.manual_seed(1)

    @torch.no_grad()
    def eval_ap(state):
        xv = batch["v"].float() / 255.0
        xl = batch["l"].float() / 255.0 if "l" in batch else None
        (io, _), _ = graph.apply(
            ir, {"params": state.params, "state": state.bn_state}, xv, xl,
            train=False, compute_dtype=bf16)
        det, valid = non_max_suppression(io.float(), conf_thres=0.01,
                                         iou_thres=0.6, multi_label=False)
        det, valid = det.cpu().numpy(), valid.cpu().numpy()
        preds = []
        for i in range(len(v)):
            for d in det[i][valid[i]]:
                preds.append({"img_id": i, "conf": float(d[4]),
                              "bbox": d[:4]})
        preds.sort(key=lambda p: -p["conf"])
        shapes = np.asarray([[w, h]] * len(v), np.float64)
        return compute_ap_lamr(preds, labels, shapes)["ap"]

    with deterministic():
        for i in range(args.steps):
            state, metrics = step(state, batch, rng)
            if (i + 1) % 50 == 0:
                loss = float(metrics["loss"])
                print(f"step {i + 1}: loss={loss:.2f} AP@0.5="
                      f"{eval_ap(state) * 100:.1f}%", flush=True)
        final_ap = eval_ap(state)
    print(f"final AP@0.5 = {final_ap * 100:.1f}% ({args.model}, "
          f"{args.steps} steps, {h}x{w}, on {card_label(dev)}); margin over "
          f"--min-ap {args.min_ap}: {final_ap - args.min_ap:+.4f}")
    if final_ap < args.min_ap:
        print(f"real-model overfit failed: AP {final_ap:.4f} < "
              f"{args.min_ap}", flush=True)
        return 1
    print("REAL MODEL OVERFIT PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
