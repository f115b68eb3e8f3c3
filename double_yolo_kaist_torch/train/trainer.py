"""Training orchestration: the reference's train.py:20-241 epoch loop.

Counterpart of the JAX package's ``train/trainer.py``. Per epoch: mosaic-
augmented batches on the device (:func:`..data.pipeline.train_batches`,
prefetched by a background thread) -> one optimizer step each
(:func:`.step.make_train_step`, bf16 activations by default) -> the
cosine LR (epoch-granular) -> the in-train evaluation (the BN-folded
forward with kernels K1-K3, :func:`..eval.evaluator.evaluate_dataset`) ->
``results.txt`` and TensorBoard scalars -> the ``last`` checkpoint and
``best`` on improvement. Checkpoints are in the JAX package's layout,
``opt_state`` under the keys its optax chain flattens to, so either
package resumes the other's SGD or Adam run. Multi-scale training draws
from a fixed set of size buckets.

``steps_per_dispatch = K > 1`` runs K optimizer steps a call
(:func:`.step.make_multi_step`; on CUDA one captured graph of the step,
replayed K times), the NaN check once a call. Where the split is resident
(the device pool or the pinned host pool), the epoch gathers and augments
inside that call (:meth:`Trainer._train_one_epoch_fused`), as the JAX
package's fused epoch does.

Data parallelism is one process a card under ``torch.distributed``
(:mod:`..parallel.multihost`; JAX's mesh over the devices of one
program): in a group of W > 1 processes every rank plans and draws the
global batch and steps on its B / W rows of it, BN and the loss take the
global batch's statistics, and one all-reduce a step sums the gradients,
so every rank applies the global step. Only rank 0 writes checkpoints,
``results.txt`` and TensorBoard; the in-train evaluation is split over
the ranks and every rank gets the same metrics.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import (make_train_augment_fn, prefetch,
                             select_image_pool, train_batch_plan,
                             train_batches)
from ..eval.evaluator import evaluate_dataset
from ..models import graph
from ..models import weights as W
from ..parallel import multihost as MH
from ..utils import tree as TR
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger, ResultsWriter, TB_TAGS, make_tb_writer
from ..utils.profiling import StepTimer
from . import optim as OPT
from .step import (TrainState, create_train_state, make_fused_multi_step,
                   make_multi_step, make_train_step, metrics_to_host)

ONE_PROCESS_A_CARD = (
    "the port trains data-parallel with one process a card, not over "
    "several devices of one process; python -m double_yolo_kaist_torch."
    "train spawns them, or launch DYK_DISTRIBUTED=1 python -m "
    "torch.distributed.run --nproc_per_node <cards> -m "
    "double_yolo_kaist_torch.train ...")
EPOCH_SEED = 123      # the JAX trainer's PRNGKey(123), folded by epoch


def _group_batches(batches, k: int):
    """Group k batches into one stacked batch for :func:`.step.
    make_multi_step` (JAX trainer.py:34-47); a partial last group is
    dropped, as ``drop_last`` drops a partial batch."""
    group, idxs = [], []
    for batch, idx in batches:
        group.append(batch)
        idxs.extend(list(idx))
        if len(group) == k:
            yield ({key: torch.stack([g[key] for g in group])
                    for key in group[0]}, idxs)
            group, idxs = [], []


def data_parallel_count(batch_size: int, n_devices: int) -> int:
    """The data-parallel width JAX's trainer picks: the largest count of
    the ``n_devices`` devices that divides the batch (JAX
    trainer.py:100-106)."""
    return max(d for d in range(1, max(n_devices, 1) + 1)
               if batch_size % d == 0)


def multi_scale_buckets(img_size: int, gs: int = 32):
    """The reference samples sizes in [imgsz//1.5, imgsz//0.667] on a 32-px
    grid (train.py:51-58); the buckets are {min, mid, base, max}."""
    lo = int(img_size // 1.5) // gs * gs
    hi = int(img_size // 0.667) // gs * gs
    mid = (lo + hi) // 2 // gs * gs
    return sorted({lo, mid, img_size, hi})


class Trainer:
    def __init__(self, ir, hyp: dict, *, epochs: int, batch_size: int,
                 img_size: int = 512, train_dataset=None, val_dataset=None,
                 sgd: bool = False, freeze_layers: int = -1,
                 multi_scale: bool = False, ema: bool = False,
                 compute_dtype=torch.bfloat16, out_dir: str = "runs",
                 name: str = "exp", accumulate: int = 1,
                 snowflake: bool = False, seed: int = 0,
                 remat_segments: int = 0, steps_per_dispatch: int = 1,
                 data_parallel: bool = True, devices=None,
                 device_cache: bool | None = None, device=None,
                 variables: dict | None = None):
        """``device``: None means ``cuda`` (the CPU only when asked for).
        ``variables``: the starting weights (default ``graph.init(ir,
        seed)``).

        ``data_parallel``: in a ``torch.distributed`` group of more than
        one process, train data-parallel over it (``batch_size`` is the
        global batch and must split evenly over the ranks); False trains
        this process alone, as JAX's ``--no-dp`` does. ``devices``: a list
        of several raises ``ValueError`` (the port trains one process a
        card; launch it under ``torch.distributed.run``)."""
        self.clahe = bool(getattr(train_dataset, "clahe", False))
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        if devices is not None and len(devices) > 1:
            raise ValueError(ONE_PROCESS_A_CARD)
        self.device = resolve_device(device)
        self.group = MH.data_group(data_parallel)
        self.ranks = 1 if self.group is None else MH.process_count()
        self.rank = MH.process_index() if self.group is not None else 0
        if batch_size % self.ranks:
            raise ValueError(f"batch size {batch_size} does not split over "
                             f"{self.ranks} data-parallel ranks")
        if self.group is not None:
            print(f"data parallel: {self.ranks} processes "
                  f"({batch_size // self.ranks} images each)", flush=True)
        self.ir = ir
        self.hyp = dict(hyp)
        self.epochs = epochs
        self.batch_size = batch_size
        self.img_size = img_size
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.multi_scale = multi_scale
        self.snowflake = snowflake
        self.device_cache = device_cache
        self.compute_dtype = compute_dtype
        self.out_dir = os.path.join(out_dir, name)
        os.makedirs(self.out_dir, exist_ok=True)

        steps_per_epoch = max(
            len(train_dataset) // batch_size if train_dataset else 100, 1)
        self.schedule = OPT.cosine_epoch_schedule(
            hyp["lr0"], hyp["lrf"], epochs, steps_per_epoch)
        if variables is None:
            variables = graph.init(ir, seed)
        freeze_mask = None
        if freeze_layers >= 0:
            freeze_mask = OPT.freeze_mask_by_layer(variables["params"],
                                                   freeze_layers)
        self.tx = OPT.make_optimizer(self.hyp, self.schedule, sgd=sgd,
                                     freeze_mask=freeze_mask,
                                     accumulate=accumulate)
        self.state = create_train_state(ir, seed, self.tx, ema=ema,
                                        variables=variables,
                                        device=self.device)
        self.remat_segments = remat_segments
        self.steps_per_dispatch = steps_per_dispatch
        make = make_multi_step if steps_per_dispatch > 1 else make_train_step
        self.step_fn = make(ir, self.hyp, self.tx,
                            compute_dtype=compute_dtype,
                            remat_segments=remat_segments, group=self.group)
        # fused K-step calls, made when a resident pool serves the epoch:
        # one a (tier, size), sharing the step's captured graphs
        self._fused_steps: dict = {}
        # dropout's generator: a CUDA one that the captured steps register
        # (reseeded each call), or a CPU one each call; None without dropout
        self._dropout = any(n.kind == "dropout" and n.p > 0
                            for n in ir.nodes)
        self._cuda_rng = None
        self.start_epoch = 0
        self.best_map = 0.0
        self.results = ResultsWriter(os.path.join(self.out_dir, "results.txt"))
        self.tb = make_tb_writer(os.path.join(self.out_dir, "tb"))

    # ------------------------------------------------------------------ resume

    def _jax_tree(self) -> dict:
        """The state in the JAX package's checkpoint layout."""
        jx = W.to_jax_variables({"params": self.state.params,
                                 "state": self.state.bn_state})
        tree = {"params": jx["params"], "bn_state": jx["state"],
                "opt_state": W.to_jax_tree(self.state.opt_state)}
        if self.state.ema is not None:
            tree["ema"] = W.to_jax_tree(self.state.ema)
        return tree

    def load(self, ckpt_path: str):
        """Tolerant resume (reference train.py:96-128): leaves missing from
        the checkpoint, or of another shape, keep their current values."""
        loaded = load_checkpoint(ckpt_path, self._jax_tree())
        st = self.state
        params = W.from_jax_tree(loaded["params"], st.params)
        params = TR.map_leaves(lambda p: p.requires_grad_(True), params)
        self.state = TrainState(
            params=params,
            bn_state=W.from_jax_tree(loaded["bn_state"], st.bn_state),
            opt_state=W.from_jax_tree(loaded["opt_state"], st.opt_state),
            step=int(loaded["step"]),
            ema=(None if st.ema is None
                 else W.from_jax_tree(loaded["ema"], st.ema)))
        self.best_map = loaded["best_map"]
        self.start_epoch = loaded["epoch"] + 1
        if self.epochs < self.start_epoch:
            self.epochs += loaded["epoch"]    # fine-tune extension
        if loaded["training_results"]:
            self.results.write_text(loaded["training_results"])
        self._sync_state()

    def _sync_state(self):
        """Under data parallelism, rank 0's state on every rank (after a
        resume, or weights set from outside)."""
        if self.group is not None:
            MH.broadcast_tensors(TR.leaves(self.state.params)
                                 + TR.leaves(self.state.bn_state)
                                 + TR.leaves(self.state.opt_state)
                                 + TR.leaves(self.state.ema), self.group)

    @property
    def _shard(self):
        """(rank, ranks) of the data-parallel batch split, or None."""
        return None if self.group is None else (self.rank, self.ranks)

    def save(self, path: str, epoch: int):
        if not MH.is_main_process():
            return
        tree = self._jax_tree()
        save_checkpoint(path, params=tree["params"],
                        bn_state=tree["bn_state"],
                        opt_state=tree["opt_state"], step=self.state.step,
                        epoch=epoch, best_map=self.best_map,
                        training_results=self.results.read(),
                        ema=tree.get("ema"))

    # ------------------------------------------------------------------- train

    def _rng(self, seed: int, i: int):
        """Dropout's generator for call ``i`` of the epoch seeded ``seed``."""
        if not self._dropout:
            return None
        # under data parallelism each rank draws its own masks
        s = seed * 1_000_003 + i + self.rank * 7_919
        if self.device.type != "cuda":
            return torch.Generator().manual_seed(s)
        if self._cuda_rng is None:
            self._cuda_rng = torch.Generator(device=self.device)
        return self._cuda_rng.manual_seed(s)

    def train_one_epoch(self, epoch: int, print_freq: int = 50):
        seed = EPOCH_SEED * 1_000_003 + epoch
        K = self.steps_per_dispatch
        if K > 1:
            src_hw = tuple(int(x)
                           for x in self.train_dataset.shapes[0][::-1])
            tier, pool = select_image_pool(self.train_dataset, src_hw,
                                           self.device_cache, self.device)
            if tier is not None:
                return self._train_one_epoch_fused(epoch, seed, tier, pool,
                                                   print_freq)
        logger = MetricLogger(print_freq=print_freq)
        timer = StepTimer()
        sizes = (multi_scale_buckets(self.img_size) if self.multi_scale
                 else self.img_size)
        batches = prefetch(train_batches(
            self.train_dataset, self.batch_size, seed, img_size=sizes,
            hyp=self.hyp, snowflake=self.snowflake, clahe=self.clahe,
            seed_epoch=epoch, device_cache=self.device_cache,
            # K stacked batches share one shape: the multi-scale bucket is
            # drawn once a group
            size_every=K, device=self.device, shard=self._shard))
        if K > 1:
            batches = _group_batches(batches, K)
        last = {}
        for i, (batch, idx) in logger.log_every(batches, f"epoch {epoch}"):
            timer.data_ready()
            self.state, metrics = self.step_fn(self.state, batch,
                                               self._rng(seed, i))
            last = self._check(metrics, epoch, i, idx)
            timer.step_done()
            logger.update(**last)
        lr = float(self.schedule(self.state.step))
        print(f"epoch {epoch} timing: {timer.summary()}", flush=True)
        return last, lr

    def _check(self, metrics, epoch: int, i: int, idx) -> dict:
        """The call's last metrics on the host (one fetch), raising on a
        non-finite loss."""
        last = metrics_to_host(metrics)
        if not math.isfinite(last["loss"]):
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} call {i}: {last} "
                f"(images {[self.train_dataset.img_files[j] for j in idx]})")
        return last

    def _fused_for(self, tier: str, size: int):
        key = (tier, size)
        if key not in self._fused_steps:
            src_hw = tuple(int(x)
                           for x in self.train_dataset.shapes[0][::-1])
            aug = make_train_augment_fn(src_hw, size, self.hyp,
                                        snowflake=self.snowflake,
                                        clahe=self.clahe,
                                        from_pool=tier == "hbm",
                                        shard=self._shard)
            # every size and tier shares the step's graphs and their pool
            self._fused_steps[key] = make_fused_multi_step(
                self.ir, self.hyp, self.tx, aug,
                compute_dtype=self.compute_dtype,
                remat_segments=self.remat_segments, images_in=tier != "hbm",
                multi_step=self.step_fn)
        return self._fused_steps[key]

    def _train_one_epoch_fused(self, epoch: int, seed: int, tier: str, pool,
                               print_freq: int = 50):
        """The epoch over fused K-step calls (JAX trainer.py:241-357): the
        host plans each group of K batches (indices, mosaic partners,
        padded labels, one size a group, :func:`..data.pipeline.
        train_batch_plan` with ``size_every=K``); each call gathers the
        rows (from the device pool inside it, or, on the pinned host tier,
        one two-stream gather of the group's rows right before it),
        augments and steps K times. The augment generators are seeded as
        ``train_batches`` seeds them, so the epoch equals the unfused
        one."""
        ds = self.train_dataset
        K = self.steps_per_dispatch
        sizes = (multi_scale_buckets(self.img_size) if self.multi_scale
                 else [self.img_size])
        dev = self.device

        def groups():
            buf = []
            for b0, idx, load, t, m, size in train_batch_plan(
                    ds, self.batch_size, sizes, seed_epoch=epoch,
                    size_every=K):
                buf.append((b0, idx, load, t, m))
                if len(buf) == K:
                    # size_every=K draws the bucket at group boundaries, so
                    # the K batches share ``size``
                    xs = {"b0": [int(b[0]) for b in buf],
                          "targets": torch.from_numpy(
                              np.stack([b[3] for b in buf])).to(dev),
                          "tmask": torch.from_numpy(
                              np.stack([b[4] for b in buf])).to(dev),
                          "load": np.stack([b[2] for b in buf])}
                    yield xs, np.concatenate([b[1] for b in buf]), size
                    buf = []

        logger = MetricLogger(print_freq=print_freq)
        timer = StepTimer()
        last = {}
        for i, (xs, idx, size) in logger.log_every(groups(),
                                                   f"epoch {epoch}"):
            load = xs.pop("load")
            if tier == "hbm":
                xs["load"] = torch.from_numpy(load).long().to(dev)
            else:
                # one two-stream gather for the whole call; (K * 4B, H, W,
                # 3) -> (K, 4B, ...)
                hp_v, hp_l, hgather = pool
                rows_v, rows_l = hgather((hp_v, hp_l), load.reshape(-1))
                xs["v_u8"] = rows_v.reshape(load.shape + hp_v.shape[1:])
                xs["l_u8"] = rows_l.reshape(load.shape + hp_l.shape[1:])
            timer.data_ready()
            step_fn = self._fused_for(tier, size)
            rng = self._rng(seed, i)
            if tier == "hbm":
                self.state, metrics = step_fn(self.state, pool[0], pool[1],
                                              xs, seed, rng)
            else:
                self.state, metrics = step_fn(self.state, xs, seed, rng)
            last = self._check(metrics, epoch, i, idx)
            timer.step_done()
            logger.update(**last)
        lr = float(self.schedule(self.state.step))
        print(f"epoch {epoch} timing: {timer.summary()}", flush=True)
        return last, lr

    def evaluate(self, batch_size: int | None = None, use_ema: bool = False):
        """In-train COCO eval of the BN-folded model; ``use_ema`` evaluates
        the EMA weights (reference ModelEMA's intended use,
        torch_utils.py:77-126). Under data parallelism the batches are
        split over the ranks and every rank returns the same metrics."""
        params = (self.state.ema["params"]
                  if use_ema and self.state.ema is not None
                  else self.state.params)
        with torch.no_grad():
            variables = {"params": TR.map_leaves(lambda p: p.detach(),
                                                 params),
                         "state": self.state.bn_state}
            return evaluate_dataset(self.ir, variables, self.val_dataset,
                                    batch_size=batch_size or self.batch_size,
                                    compute_dtype=self.compute_dtype,
                                    device_cache=self.device_cache,
                                    device=self.device, group=self.group)

    def fit(self, save_best: bool = True, notest: bool = False):
        self._sync_state()
        for epoch in range(self.start_epoch, self.epochs):
            mloss, lr = self.train_one_epoch(epoch)
            if notest and epoch != self.epochs - 1:
                continue
            res = self.evaluate()
            coco = res["coco_stats"]
            scalars = [mloss.get("box_loss", 0), mloss.get("obj_loss", 0),
                       mloss.get("class_loss", 0), mloss.get("loss", 0),
                       lr, coco[0], coco[1], coco[8]]
            for tag, v in zip(TB_TAGS, scalars):
                self.tb.add_scalar(tag, float(v), epoch)
            self.results.append(epoch, coco, mloss.get("loss", 0.0), lr)

            if coco[0] > self.best_map:
                self.best_map = float(coco[0])
            # "last" every epoch (reference train.py:214-233 saves last.pt
            # beside best.pt), so that a resume never depends on the best
            # epoch having been the final one
            self.save(os.path.join(self.out_dir, "last"), epoch)
            if save_best:
                if self.best_map == float(coco[0]):
                    self.save(os.path.join(self.out_dir, "best"), epoch)
            else:
                self.save(os.path.join(self.out_dir, f"epoch{epoch}"), epoch)
        return self.best_map
