"""Training observability: smoothed console metrics, results.txt lines and
optional TensorBoard scalars.

Counterpart of the JAX package's ``utils/logging.py``: the reference's
MetricLogger / SmoothedValue console output (distributed_utils.py:13-71,
145-231), its per-epoch results file (train.py:212-216: 12 COCO stats +
loss + lr) and the 8 TensorBoard tags (train.py:204-209) when
``torch.utils.tensorboard`` imports. With several processes only rank 0
writes.
"""

from __future__ import annotations

import collections
import datetime
import time


def _is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


class SmoothedValue:
    """Windowed median / avg tracker (reference distributed_utils.py:13-71)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 50):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for i, obj in enumerate(iterable):
            t0 = time.time()
            yield i, obj
            iter_time.update(time.time() - t0)
            if i % self.print_freq == 0:
                meters = self.delimiter.join(
                    f"{k}: {v}" for k, v in self.meters.items())
                print(f"{header} [{i}] {meters} time: {iter_time}",
                      flush=True)
        total = str(datetime.timedelta(seconds=int(time.time() - start)))
        print(f"{header} total time: {total}", flush=True)


class ResultsWriter:
    """Appends per-epoch result lines (reference train.py:212-216 format:
    'epoch:N <12 coco stats> <loss> <lr>')."""

    def __init__(self, path: str):
        self.path = path

    def append(self, epoch: int, coco_stats, loss: float, lr: float):
        if not _is_main_process():
            return
        vals = [f"{float(v):.4f}" for v in coco_stats] + [
            f"{loss:.4f}", f"{lr:.6f}"]
        with open(self.path, "a") as f:
            f.write(f"epoch:{epoch} " + "  ".join(vals) + "\n")

    def read(self) -> str:
        try:
            with open(self.path) as f:
                return f.read()
        except OSError:
            return ""

    def write_text(self, text: str):
        if not _is_main_process():
            return
        with open(self.path, "w") as f:
            f.write(text)


class _NoopWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def make_tb_writer(logdir: str):
    """A TensorBoard SummaryWriter when ``torch.utils.tensorboard`` imports
    (and this is rank 0), else a writer that does nothing."""
    if not _is_main_process():
        return _NoopWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=logdir)
    except Exception:  # noqa: BLE001 — tensorboard is optional
        return _NoopWriter()


TB_TAGS = ["train/box_loss", "train/obj_loss", "train/cls_loss", "train/loss",
           "learning_rate", "mAP@[IoU=0.50:0.95]", "mAP@[IoU=0.5]",
           "mAR@[IoU=0.50:0.95]"]
