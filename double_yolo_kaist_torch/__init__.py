"""double_yolo_kaist_torch — the PyTorch / CUDA port of double_yolo_kaist_tpu.

Module names mirror the JAX package so that each counterpart is easy to find.
The port imports torch and numpy only: never jax, and nothing of the JAX
package. Entry points take ``device=None``, which means ``"cuda"``; they run
on the CPU only when the caller asks for it, and raise when CUDA is absent.
The hand-written Hopper kernels live in ``ops/csrc`` and are built at first
use (``ops/_build.py``).

With ``DYK_PEAK_MEMORY=<file>`` in its environment, a process that imports
the package prints its peak device memory on standard error when it exits
(a SIGTERM too ends it that way) and appends it to ``<file>`` as a JSON
line: what a run that starts many processes on one card reads to see how
much each took.
"""

__version__ = "0.1.0"

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def _report_peak_memory(path: str) -> None:
    """At exit: this process's peak device memory, if it used the card."""
    import json
    import sys

    if not torch.cuda.is_initialized():
        return
    gib = 2.0 ** 30
    rec = {"pid": os.getpid(), "argv": " ".join(sys.argv)[:300],
           "allocated_gib": round(torch.cuda.max_memory_allocated() / gib, 3),
           "reserved_gib": round(torch.cuda.max_memory_reserved() / gib, 3)}
    print(f"peak device memory (pid {rec['pid']}): {rec['allocated_gib']} "
          f"GiB allocated, {rec['reserved_gib']} GiB reserved",
          file=sys.stderr, flush=True)
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def _watch_peak_memory() -> None:
    import atexit
    import signal
    import sys
    import threading

    path = os.environ.get("DYK_PEAK_MEMORY")
    if not path or getattr(_watch_peak_memory, "on", False):
        return
    _watch_peak_memory.on = True
    atexit.register(_report_peak_memory, path)
    if (threading.current_thread() is threading.main_thread()
            and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL):
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))


_watch_peak_memory()
