"""Training entry point: the reference's train.py:244-286 argument surface
on the port's trainer (:mod:`.trainer`), run as

    python -m double_yolo_kaist_torch.train --cfg <model.cfg or zoo name> \\
        --data <split.data> [--weights <ckpt dir, .pt or .weights>] \\
        [--epochs 50] [--batch-size 16] [--img-size 512] [--fp32] ...

The flags are those of the JAX package's ``cli/train.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). It
writes ``<out-dir>/<name>/last``, ``best`` (checkpoint directories in the
JAX package's layout) and ``results.txt``. ``--snow`` (the snowflake
cutout, with CLAHE) and ``--clahe`` (CLAHE in training and evaluation)
change the data as the JAX package's flags do. ``--steps-per-dispatch K``
runs K optimizer steps a call (on CUDA one captured graph of the step
replayed K times).

Data-parallel training runs one process a card. With several cards
visible and no process group, the plain command spawns k ranks itself,
k the largest count of visible cards that divides ``--batch-size``, as
the JAX package's trainer builds its mesh (JAX trainer.py:95-106): each
rank joins an NCCL group on the card ``LOCAL_RANK`` names through
:func:`..parallel.multihost.maybe_initialize_distributed`, trains on its
``B / k`` rows of each global batch, and rank 0 alone writes. A launcher
does the same:

    DYK_DISTRIBUTED=1 python -m torch.distributed.run --nproc_per_node N \
        -m double_yolo_kaist_torch.train --batch-size <global batch> ...

(gloo with ``--device cpu``). ``--no-dp`` trains each process alone, as
the JAX package's flag turns its mesh off.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .. import resolve_device
from ..common import DEFAULT_HYP, build_model, resolve_cfg
from ..config.parser import load_hyp, parse_data_cfg
from ..data.dataset import KaistDataset
from ..parallel.multihost import maybe_initialize_distributed, run_ranks
from .trainer import Trainer, data_parallel_count


def str2bool(v: str) -> bool:
    """argparse type for explicit boolean flags (``--single-cls False``)."""
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--hyp", type=str, default=DEFAULT_HYP)
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint dir to resume from")
    p.add_argument("--name", default="exp")
    p.add_argument("--freeze-layers", type=int, default=-1)
    p.add_argument("--data", type=str, default="data/kaist_data.data")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--sgd", action="store_true")
    p.add_argument("--snow", action="store_true",
                   help="snowflake cutout augmentation (CLAHEs the mosaic "
                        "canvas first, as the reference's cutout does)")
    p.add_argument("--clahe", action="store_true",
                   help="CLAHE preprocessing, in training and evaluation")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--single-cls", type=str2bool, nargs="?",
                   const=True, default=True,
                   help="treat all classes as one; accepts True/False")
    p.add_argument("--anchor-cluster", action="store_true")
    p.add_argument("--cache-images", choices=("ram", "disk"), default=None,
                   help="cache decoded pairs in RAM or as .npy files")
    p.add_argument("--save-best", type=str2bool, nargs="?",
                   const=True, default=True,
                   help="save best on in-train eval improvement; accepts "
                        "True/False")
    p.add_argument("--notest", action="store_true")
    p.add_argument("--accumulate", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--out-dir", type=str, default="runs")
    p.add_argument("--fp32", action="store_true",
                   help="fp32 activations instead of bf16")
    p.add_argument("--cutoff", type=int, default=-1,
                   help="darknet .weights layer cutoff for transfer learning")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps per dispatch (on CUDA one captured "
                        "graph of the step, replayed K times)")
    p.add_argument("--remat-segments", type=int, default=0,
                   help="gradient-checkpoint the forward into N segments")
    p.add_argument("--no-dp", action="store_true",
                   help="train this process alone even when launched in a "
                        "torch.distributed group")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto",
                   help="keep the split's u8 pairs resident (device memory "
                        "if it fits DYK_DEVICE_CACHE_GB, else pinned host "
                        "memory) and gather batches there")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    return p


def main(argv=None):
    opt = make_parser().parse_args(argv)
    # a missing card refuses before any work
    dev = resolve_device(opt.device)
    k = _ranks_to_spawn(opt, dev)
    if k > 1:
        print(f"data parallel: {k}-device mesh "
              f"({opt.batch_size // k} images/device)", flush=True)
        rc = run_ranks(k, ["-m", "double_yolo_kaist_torch.train",
                           *(sys.argv[1:] if argv is None else argv)])
        if rc:
            raise SystemExit(rc)
        return
    # opt-in (DYK_DISTRIBUTED=1, as torch.distributed.run's ranks and
    # run_ranks's are launched); one process trains as it always did
    owned = not torch.distributed.is_initialized()
    joined = maybe_initialize_distributed(
        backend="nccl" if dev.type == "cuda" else "gloo")
    if joined and dev.type == "cuda" and dev.index is None:
        opt.device = f"cuda:{torch.cuda.current_device()}"
    try:
        _train(opt)
    finally:
        if joined and owned:
            torch.distributed.destroy_process_group()


def _ranks_to_spawn(opt, dev) -> int:
    """How many data-parallel ranks this command spawns: on ``cuda`` (no
    card named), with no process group, no launcher (``DYK_DISTRIBUTED``)
    and no ``--no-dp``, the largest count of visible cards that divides
    the batch; else 1 (this process trains)."""
    if (dev.type != "cuda" or dev.index is not None or opt.no_dp
            or torch.distributed.is_initialized()
            or os.environ.get("DYK_DISTRIBUTED", "0") == "1"):
        return 1
    return data_parallel_count(opt.batch_size, torch.cuda.device_count())


def _train(opt):
    opt.cfg = resolve_cfg(opt.cfg)
    hyp = load_hyp(opt.hyp)
    data_dict = parse_data_cfg(opt.data)
    nc = 1 if opt.single_cls else int(data_dict["classes"])
    hyp["cls"] *= nc / 80.0
    hyp["obj"] *= opt.img_size / 320.0

    if opt.anchor_cluster:
        from .anchors import (dataset_box_sizes, evolve_anchors,
                                    rewrite_cfg_anchors)
        tmp_ds = KaistDataset(data_dict["train"], opt.img_size,
                              opt.batch_size, single_cls=opt.single_cls)
        whs = dataset_box_sizes(tmp_ds, opt.img_size)
        rewrite_cfg_anchors(opt.cfg, evolve_anchors(whs, verbose=True))

    train_ds = KaistDataset(data_dict["train"], opt.img_size, opt.batch_size,
                            augment=True, hyp=hyp, snowflake=opt.snow,
                            clahe=opt.clahe, single_cls=opt.single_cls,
                            cache_images=opt.cache_images)
    val_ds = KaistDataset(data_dict["valid"], opt.img_size, opt.batch_size,
                          hyp=hyp, rect=True, clahe=opt.clahe,
                          single_cls=opt.single_cls)

    ir, variables = build_model(opt.cfg, opt.weights, cutoff=opt.cutoff)
    trainer = Trainer(ir, hyp, epochs=opt.epochs, batch_size=opt.batch_size,
                      img_size=opt.img_size, train_dataset=train_ds,
                      val_dataset=val_ds, sgd=opt.sgd,
                      freeze_layers=opt.freeze_layers,
                      multi_scale=opt.multi_scale, ema=opt.ema,
                      compute_dtype=torch.float32 if opt.fp32
                      else torch.bfloat16,
                      out_dir=opt.out_dir, name=opt.name,
                      accumulate=opt.accumulate, snowflake=opt.snow,
                      remat_segments=opt.remat_segments,
                      steps_per_dispatch=opt.steps_per_dispatch,
                      data_parallel=not opt.no_dp,
                      device_cache={"auto": None, "on": True,
                                    "off": False}[opt.device_cache],
                      device=opt.device, variables=variables)
    if opt.resume:
        trainer.load(opt.resume)
    best = trainer.fit(save_best=opt.save_best, notest=opt.notest)
    print(f"training done; best mAP@[0.50:0.95] = {best:.4f}")
