"""Probes of K3: the stem conv's CUDA kernel with stages left out, to show
where its time goes on the card.

Counterpart of the JAX package's ``tools/archive/stem_probe.py`` (variants
dma / mm / nocarry / full), ``stem_probe2.py``, ``stem_probe3.py`` and
``stem_probe4.py`` (in-only, out-only and flat copies at the kernel's access
pattern). Each variant is the bf16 kernel of ``csrc/stem.cu`` compiled
without some of its stages, at the same segmentation (strips of 64 output
columns cut into runs of ``seg_rows`` output rows, one block each), and each
has a plain PyTorch version:

  ==========  ===========================================  =================
  variant     does                                         plain version
  ==========  ===========================================  =================
  ``load``    the ring's loads only; a checksum per block  the same sums
  ``store``   streams the output from a constant           ``torch.full``
  ``copy``    loads and stores the conv's bytes, no MMA    a strided copy
  ``mma``     loads, MMAs, stores: raw sums, no bias/act   fp32 conv, rounded
  ``full``    the conv itself                              the plain conv
  ==========  ===========================================  =================

No path of the model calls them. :func:`probe` launches the kernel for a
CUDA tensor and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from . import stem as K3

MODES = {"full": 0, "load": 1, "store": 2, "copy": 3, "mma": 4}
STRIP = 64                         # output columns per strip (csrc/stem.cu)
# dyk_stem_probe's and dyk_stem_plan's C signatures (csrc/stem.cu)
_PROBE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]


def _out_hw(x):
    return (x.shape[2] + 1) // 2, (x.shape[3] + 1) // 2


def load_sums_plain(x, seg_rows: int):
    """What the ``load`` probe sums: for every block (image, strip, run of
    ``seg_rows`` output rows oy0 ... oy1 - 1) the 16-bit patterns of input
    rows 2 oy0 - 1 ... 2 oy1 - 1, columns 128 strip - 1 ... 128 strip + 127,
    zero outside the image, added mod 2**32. x (B, 32, H, W) bf16. Returns
    (B, strips, runs) int64."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the load probe sums bf16 patterns, got {x.dtype}")
    B, _, H, W = x.shape
    ho, wo = _out_hw(x)
    strips, runs = -(-wo // STRIP), -(-ho // seg_rows)
    bits = x.permute(0, 2, 3, 1).contiguous().view(torch.int16)
    per_px = (bits.to(torch.int64) & 0xFFFF).sum(-1)          # (B, H, W)
    # index = coordinate + 1: row -1 and column -1 are the pad
    pad = torch.zeros((B, 2 * ho + 1, 2 * STRIP * strips + 1),
                      dtype=torch.int64, device=x.device)
    pad[:, 1:H + 1, 1:W + 1] = per_px
    out = torch.empty((B, strips, runs), dtype=torch.int64, device=x.device)
    for s in range(strips):
        for r in range(runs):
            oy0, oy1 = r * seg_rows, min(ho, (r + 1) * seg_rows)
            out[:, s, r] = pad[:, 2 * oy0:2 * oy1 + 1,
                               2 * STRIP * s:2 * STRIP * s + 2 * STRIP + 1
                               ].sum((1, 2))
    return out % (1 << 32)


def copy_plain(x, o: int):
    """What the ``copy`` probe writes: y[b, c, oy, ox] = x[b, c & 31, 2 oy,
    2 ox + ((c >> 5) & 1)], zero outside the image. Returns (B, o, ceil(H /
    2), ceil(W / 2)) channels-last."""
    ho, wo = _out_hw(x)
    rows = F.pad(x, (0, 1))[:, :, 0:2 * ho:2]                 # (B, 32, Ho, W+1)
    c = torch.arange(o, device=x.device)
    cols = 2 * torch.arange(wo, device=x.device)[None, :] \
        + ((c >> 5) & 1)[:, None]                             # (o, Wo)
    y = rows[:, (c & 31)[:, None], :, cols]                   # (o, Wo, B, Ho)
    return y.permute(2, 0, 3, 1).contiguous(
        memory_format=torch.channels_last)


def probe_plain(variant: str, x, weights, act: str, seg_rows: int,
                fill: float = 1.0):
    """The plain PyTorch version of each variant (see the module's table);
    ``weights`` from :func:`.stem.pack_weights`."""
    ho, wo = _out_hw(x)
    w, b = weights.w, weights.b
    if variant == "load":
        return load_sums_plain(x, seg_rows)
    if variant == "store":
        return torch.full((x.shape[0], w.shape[0], ho, wo), fill,
                          dtype=x.dtype, device=x.device).contiguous(
                              memory_format=torch.channels_last)
    if variant == "copy":
        return copy_plain(x, w.shape[0])
    if variant == "mma":
        y = F.conv2d(x.float(), w.float(), stride=2, padding=1)
        return y.to(x.dtype).contiguous(memory_format=torch.channels_last)
    if variant == "full":
        return K3.stem_conv_s2_plain(x, w, b, act)
    raise ValueError(f"probe variant must be one of {sorted(MODES)}, got "
                     f"{variant!r}")


def plan(x, o: int):
    """(strips, output rows per block, blocks per strip) of the bf16 conv's
    grid for the CUDA tensor ``x`` and ``o`` outputs, as the card's
    resident-block count makes it."""
    lib = _build.library("stem.cu")
    fn = lib.dyk_stem_plan
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _PLAN_ARGTYPES
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(x.device):
        status = fn(x.shape[0], x.shape[2], x.shape[3], o, out)
    _build.check(lib, status, "stem_plan")
    return tuple(out)


def probe(variant: str, x, weights, act: str, seg_rows: int | None = None,
          fill: float = 1.0):
    """One probe variant on x (B, 32, H, W) with the conv's ``weights``
    (:func:`.stem.pack_weights`).
    ``load`` returns the per-block sums (B, strips, runs) int64; the others
    (B, O, ceil(H/2), ceil(W/2)) in ``x.dtype``. ``seg_rows`` defaults to
    the conv's own segmentation on the card and to one block per strip on
    the CPU. A CPU tensor goes to :func:`probe_plain`; a CUDA tensor (bf16)
    to the kernel, or this raises."""
    if variant not in MODES:
        raise ValueError(f"probe variant must be one of {sorted(MODES)}, got "
                         f"{variant!r}")
    K3._check(x, weights, act)
    ho, wo = _out_hw(x)
    if x.device.type == "cpu":
        return probe_plain(variant, x, weights, act, seg_rows or ho, fill)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the probes are variants of the bf16 kernel, got "
                        f"{x.dtype}")
    xc = K3._cuda_input(x, weights)
    B, _, H, W = x.shape
    O = weights.w.shape[0]
    strips, auto_rows, _ = plan(x, O)
    seg_rows = min(ho, auto_rows if seg_rows is None else int(seg_rows))
    if seg_rows < 1:
        raise ValueError(f"seg_rows must be >= 1, got {seg_rows}")
    runs = -(-ho // seg_rows)
    y = sums = None
    if variant == "load":
        sums = torch.empty((B, strips, runs), dtype=torch.int32,
                           device=x.device)
    else:
        y = torch.empty((B, O, ho, wo), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
    lib = _build.library("stem.cu")
    fn = lib.dyk_stem_probe
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _PROBE_ARGTYPES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(MODES[variant], xc.data_ptr(), weights.kernel.data_ptr(),
                    weights.bias.data_ptr(),
                    None if y is None else y.data_ptr(),
                    None if sums is None else sums.data_ptr(), B, H, W, O,
                    K3.ACTS[act], seg_rows, float(fill), stream)
    _build.check(lib, status, f"stem_probe {variant}")
    _build.launches["stem_probe"] += 1
    return y if sums is None else sums.to(torch.int64) % (1 << 32)


def breakdown(x, weights, act: str, iters: int = 20, warmup: int = 3) -> dict:
    """Where K3's time goes on the card: {variant: ms per launch} for the
    five variants on the same CUDA inputs at the conv's own segmentation,
    by CUDA events around ``iters`` back-to-back launches after ``warmup``.
    ``full - mma`` is the epilogue's share (bias, activation), ``mma -
    copy`` the MMAs', ``copy`` against ``load`` and ``store`` the two
    directions of the traffic."""
    if x.device.type != "cuda":
        raise ValueError("the breakdown times the kernels on the card; "
                         f"got a tensor on {x.device}")
    times = {}
    for variant in ("load", "store", "copy", "mma", "full"):
        def run():
            return probe(variant, x, weights, act)
        for _ in range(warmup):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        times[variant] = start.elapsed_time(end) / iters
    return times
