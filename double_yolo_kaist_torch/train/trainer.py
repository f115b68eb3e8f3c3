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

Not ported: ``steps_per_dispatch > 1`` (ROADMAP.md, queue 1 item 17) and
data parallelism over several devices (item 12).
"""

from __future__ import annotations

import math
import os

import torch

from .. import resolve_device
from ..data.pipeline import prefetch, train_batches
from ..eval.evaluator import evaluate_dataset
from ..models import graph
from ..models import weights as W
from ..utils import tree as TR
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger, ResultsWriter, TB_TAGS, make_tb_writer
from ..utils.profiling import StepTimer
from . import optim as OPT
from .step import TrainState, create_train_state, make_train_step, \
    metrics_to_host

MULTI_STEP_NOT_PORTED = (
    "steps_per_dispatch > 1 (several optimizer steps per dispatch) is not "
    "ported yet (ROADMAP.md, queue 1 item 17)")
DATA_PARALLEL_NOT_PORTED = (
    "training over several devices is not ported yet (ROADMAP.md, queue 1 "
    "item 12); the port trains on one device")
EPOCH_SEED = 123      # the JAX trainer's PRNGKey(123), folded by epoch


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
        seed)``)."""
        self.clahe = bool(getattr(train_dataset, "clahe", False))
        if steps_per_dispatch > 1:
            raise NotImplementedError(MULTI_STEP_NOT_PORTED)
        if data_parallel and devices is not None and len(devices) > 1:
            raise NotImplementedError(DATA_PARALLEL_NOT_PORTED)
        self.device = resolve_device(device)
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
        self.step_fn = make_train_step(ir, self.hyp, self.tx,
                                       compute_dtype=compute_dtype,
                                       remat_segments=remat_segments)
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

    def save(self, path: str, epoch: int):
        tree = self._jax_tree()
        save_checkpoint(path, params=tree["params"],
                        bn_state=tree["bn_state"],
                        opt_state=tree["opt_state"], step=self.state.step,
                        epoch=epoch, best_map=self.best_map,
                        training_results=self.results.read(),
                        ema=tree.get("ema"))

    # ------------------------------------------------------------------- train

    def train_one_epoch(self, epoch: int, print_freq: int = 50):
        seed = EPOCH_SEED * 1_000_003 + epoch
        logger = MetricLogger(print_freq=print_freq)
        timer = StepTimer()
        sizes = (multi_scale_buckets(self.img_size) if self.multi_scale
                 else self.img_size)
        batches = prefetch(train_batches(
            self.train_dataset, self.batch_size, seed, img_size=sizes,
            hyp=self.hyp, snowflake=self.snowflake, clahe=self.clahe,
            seed_epoch=epoch, device_cache=self.device_cache,
            device=self.device))
        last = {}
        for i, (batch, idx) in logger.log_every(batches, f"epoch {epoch}"):
            timer.data_ready()
            rng = torch.Generator().manual_seed(seed * 1_000_003 + i)
            self.state, metrics = self.step_fn(self.state, batch, rng)
            last = metrics_to_host(metrics)
            timer.step_done()
            if not math.isfinite(last["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step {i}: {last} "
                    f"(images {[self.train_dataset.img_files[j] for j in idx]})")
            logger.update(**last)
        lr = float(self.schedule(self.state.step))
        print(f"epoch {epoch} timing: {timer.summary()}", flush=True)
        return last, lr

    def evaluate(self, batch_size: int | None = None, use_ema: bool = False):
        """In-train COCO eval of the BN-folded model; ``use_ema`` evaluates
        the EMA weights (reference ModelEMA's intended use,
        torch_utils.py:77-126)."""
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
                                    device=self.device)

    def fit(self, save_best: bool = True, notest: bool = False):
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
