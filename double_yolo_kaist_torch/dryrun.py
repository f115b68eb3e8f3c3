"""The multi-device dryrun: ``python -m double_yolo_kaist_torch.dryrun N
[--device cuda|cpu]``.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(``_dryrun_impl``). It spawns N ranks (:func:`.parallel.multihost.
run_ranks`): NCCL over N distinct cards where N are visible, gloo where
they share ``cuda:0`` or run on the CPU. It never runs on fewer devices
than it was asked for. The ranks run JAX's three legs, each on 64 x 64
dual-stream images from a seed, and rank 0 prints JAX's lines:

1. the flagship's bf16 SGD train step (with EMA) over a 1-D data mesh of
   N, the global batch ``max(N, 2)``: the loss is finite and the step
   count 1;
2. the flagship's data-parallel inference from that step's weights: the
   BN-folded forward (the stem convs through K3), the head decode (K1)
   and NMS (K2, ``max_det`` 20), one image a rank, the packed detections
   gathered over the ranks;
3. the mini-flagship's (``models.builder.build_mini_flagship``) bf16
   train step on a 2-D (N/2, 2) data x space mesh (:mod:`.parallel.
   spatial`); skipped when N is odd or below 4, as in JAX.

The exit code is 0 when every rank passed every leg it ran.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

HYP = {"box": 3.54, "obj": 102.88, "cls": 0.468, "cls_pw": 1.0,
       "obj_pw": 1.0, "iou_t": 0.20, "fl_gamma": 0.0, "ciou": 1.0,
       "momentum": 0.937, "weight_decay": 5e-4}
HW = 64


def _say(n: int, tag: str, loss: float | None = None) -> None:
    """Rank 0 prints JAX's line for a leg that passed."""
    from .parallel import multihost as MH
    if MH.is_main_process():
        tail = "" if loss is None else f", loss={loss:.3f}"
        print(f"dryrun_multichip({n}): ok [{tag}]{tail}", flush=True)


def _train_step(ir, dev, batch, group=None, space=None):
    """One bf16 SGD step with EMA from ``graph.init(ir, 0)`` on this
    rank's part of ``batch``; returns (new state, loss)."""
    from .parallel import spatial as SP
    from .train import optim as OPT
    from .train import step as ST
    tx = OPT.make_optimizer(HYP, OPT.cosine_epoch_schedule(
        1e-3, 0.1, epochs=50, steps_per_epoch=100), sgd=True)
    state = ST.create_train_state(ir, 0, tx, ema=True, device=dev)
    step = ST.make_train_step(ir, HYP, tx, compute_dtype=torch.bfloat16,
                              group=group, space=space)
    if space is not None:
        mine = SP.local_batch(batch, space)
    else:
        from .parallel import multihost as MH
        k, r = MH.process_count(), MH.process_index()
        n = len(batch["v"]) // k
        mine = {key: v[r * n:(r + 1) * n] for key, v in batch.items()}
    new, metrics = step(state, {key: v.to(dev) for key, v in mine.items()})
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if new.step != 1:
        raise AssertionError(f"the state's step is {new.step}, not 1")
    return new, loss


def _batch(n_images: int):
    """JAX's dryrun batch: uint8 images from ``default_rng(0)`` and one
    box [0, 0.5, 0.5, 0.2, 0.4] an image, padded to 8 labels."""
    from .train import loss as LS
    rng = np.random.default_rng(0)
    v = rng.integers(0, 256, (n_images, HW, HW, 3), dtype=np.uint8)
    l = rng.integers(0, 256, (n_images, HW, HW, 3), dtype=np.uint8)
    t, m = LS.pad_labels([np.asarray([[0, 0.5, 0.5, 0.2, 0.4]], np.float32)
                          for _ in range(n_images)], 8)
    return {k: torch.from_numpy(x) for k, x in
            {"v": v, "l": l, "targets": t, "tmask": m}.items()}


def _inference(ir, state, dev, n: int, group):
    """Leg 2: this rank's image through the folded forward, decode and
    NMS; the packed (N, 20, 7) detections gathered over the ranks."""
    from .models import graph
    from .ops.nms import non_max_suppression
    from .parallel import multihost as MH
    r = MH.process_index()
    variables = {"params": state.params, "state": state.bn_state}
    with torch.no_grad():
        folded = graph.place_folded(
            ir, graph.fold_batchnorm(ir, variables), dev, torch.bfloat16)
    rng = np.random.default_rng(2)
    xv = torch.from_numpy(rng.random((n, HW, HW, 3), np.float32))
    xl = torch.from_numpy(rng.random((n, HW, HW, 3), np.float32))
    with torch.inference_mode():
        io, _ = graph.apply_folded(ir, folded, xv[r:r + 1].to(dev),
                                   xl[r:r + 1].to(dev),
                                   compute_dtype=torch.bfloat16)
        det, valid = non_max_suppression(io.float(), conf_thres=0.001,
                                         iou_thres=0.5, max_det=20)
        packed = torch.cat([det, valid[..., None].to(det.dtype)], dim=-1)
    every = MH.allgather_predictions(packed[0], group)
    if every.shape[0] != n or not torch.isfinite(every).all():
        raise AssertionError(f"gathered detections {tuple(every.shape)}, "
                             f"finite {bool(torch.isfinite(every).all())}")


def _rank(n: int, device: str) -> None:
    """One rank's three legs (a process that :func:`main` spawned)."""
    from .config.ir import compile_cfg
    from .models.builder import build_mini_flagship
    from .models.zoo import FLAGSHIP, cfg_path
    from .parallel import multihost as MH
    from .parallel import spatial as SP
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    nccl = device == "cuda" and torch.cuda.device_count() >= n
    MH.maybe_initialize_distributed(backend="nccl" if nccl else "gloo")
    if MH.process_count() != n:
        raise AssertionError(f"{MH.process_count()} ranks, not {n}")
    dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
           else torch.device("cuda", 0) if device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = MH.data_group()

    ir = compile_cfg(cfg_path(FLAGSHIP))
    state, loss = _train_step(ir, dev, _batch(max(n, 2)), group=group)
    _say(n, "flagship train, 1-D data parallel", loss)
    _inference(ir, state, dev, n, group)
    _say(n, f"flagship DP inference, fused forward+NMS, batch sharded "
            f"over {n}")
    del state
    if n >= 4 and n % 2 == 0:
        space = SP.make_space_shard((n // 2, 2))
        _, loss = _train_step(build_mini_flagship(img_size=HW), dev,
                              _batch(n), space=space)
        _say(n, "mini-flagship train, 2-D data x space", loss)
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks (devices) to certify")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rank-of", action="store_true",
                   help=argparse.SUPPRESS)       # a spawned rank
    opt = p.parse_args(argv)
    if opt.n < 1:
        p.error("N must be at least 1")
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run the ranks on the CPU")
    if opt.rank_of:
        _rank(opt.n, opt.device)
        return 0
    from .parallel.multihost import run_ranks
    return run_ranks(opt.n, ["-m", "double_yolo_kaist_torch.dryrun",
                             str(opt.n), "--device", opt.device, "--rank-of"])


if __name__ == "__main__":
    sys.exit(main())
