"""The eval input pipeline: rect-letterboxed dual-stream batches on the device.

Counterpart of the eval half of the JAX package's ``data/pipeline.py``:
the reference's two-stage eval preprocessing (max-side resize with int()
truncation, then a letterbox pad to the batch shape, kaist_dataset.py:
203-208 and img_utils.py:5-53), the residency tiers of the split's uint8
pairs, a background prefetch thread and :func:`eval_batches`.

Tiers, as the JAX package chooses them (:func:`select_image_pool`):
  * ``"hbm"``: the whole split's uint8 pairs in device memory, under the
    ``DYK_DEVICE_CACHE_GB`` budget (default 4) shared by every pool of the
    process; a batch is a row gather inside the preprocess call;
  * ``"host"``: the pairs in pinned host memory, under ``DYK_HOST_CACHE_GB``
    (default 16); a batch is gathered on the host into a pinned buffer and
    copied with ``non_blocking=True``. Not on a CPU device (the JAX package's
    CPU backend has no pinned host memory either);
  * ``None``: per-batch streaming from :meth:`.dataset.KaistDataset.
    load_pair`.

The train-side functions (batch plan, augmentation) are not ported yet
(ROADMAP.md, queue 1 item 10), nor is CLAHE.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from .letterbox import resize_bilinear


def make_eval_preprocess_fn(src_hw, dst_hw, img_size: int,
                            clahe: bool = False, from_pool: bool = False):
    """Eval preprocessing with the reference's exact two stages: (1) a
    max-side resize to ``img_size`` with int() truncation, then (2) a
    letterbox pad to ``dst_hw`` with scale_up=False. Returns (fn, ratio,
    pad) matching the reference's ``shapes`` tuple for scale_coords undo:
    ``fn(v_u8, l_u8) -> (v, l)``, fp32 NHWC in [0, 1] on the inputs' device.

    ``from_pool``: fn takes the whole split's u8 pools and an index tensor
    and gathers the batch rows in the same call."""
    if clahe:
        raise NotImplementedError(
            "CLAHE preprocessing is not ported yet (ROADMAP.md, queue 1 "
            "item 10: data/clahe.py comes with augmentation)")
    h0, w0 = src_hw
    r1 = img_size / max(h0, w0)
    h1, w1 = (int(h0 * r1), int(w0 * r1)) if r1 != 1 else (h0, w0)

    r2 = min(dst_hw[0] / h1, dst_hw[1] / w1, 1.0)   # scale_up=False at eval
    new_h, new_w = int(round(h1 * r2)), int(round(w1 * r2))
    dw, dh = (dst_hw[1] - new_w) / 2, (dst_hw[0] - new_h) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    bottom, right = dst_hw[0] - new_h - top, dst_hw[1] - new_w - left

    def core(v_u8, l_u8):
        out = []
        for im in (v_u8, l_u8):
            x = resize_bilinear(im, h1, w1)
            if (new_h, new_w) != (h1, w1):
                x = resize_bilinear(x, new_h, new_w)
            # F.pad pads from the last dim backwards: C, W, H
            out.append(F.pad(x, (0, 0, left, right, top, bottom)) / 255.0)
        return tuple(out)

    if from_pool:
        def fn(pool_v, pool_l, idx):
            return core(pool_v.index_select(0, idx),
                        pool_l.index_select(0, idx))
    else:
        fn = core

    # reference shapes tuple: ((h0, w0), ((h1/h0, w1/w0), (dw, dh)))
    return fn, (h1 / h0, w1 / w0), (dw, dh)


# ------------------------------------------------------------------ tiers

# combined device bytes of every device_image_pool built by this process,
# and combined pinned-host bytes of every host_image_pool; each entry is
# released when its owning dataset is garbage-collected (the pools live on
# the dataset object)
_RESIDENT = {"bytes": 0}
_HOST_RESIDENT = {"bytes": 0}


def _claim_resident(account: dict, owner, nbytes: int) -> None:
    account["bytes"] += nbytes

    def release():
        account["bytes"] -= nbytes

    weakref.finalize(owner, release)


def _stack_pairs(dataset, indices):
    """(N, H, W, 3) uint8 CPU tensors of the visible and LWIR frames."""
    pairs = [dataset.load_pair(int(i)) for i in indices]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])),
            torch.from_numpy(np.stack([p[1] for p in pairs])))


def device_image_pool(dataset, src_hw, force: bool | None = None,
                      device=None):
    """Copy the whole split's uint8 source pairs to ``device`` once, as two
    (N, H, W, 3) tensors kept on the dataset object.

    ``force``: True copies regardless of the budget, False disables, None
    copies when 2*N*H*W*3 bytes fit ``DYK_DEVICE_CACHE_GB`` (default 4)
    beside every pool this process already holds."""
    if force is False:
        return None
    device = torch.device("cpu" if device is None else device)
    pools = dataset.__dict__.setdefault("_device_pools", {})
    pool = pools.get(str(device))
    if pool is not None:
        return pool
    n = len(dataset)
    h, w = src_hw
    need = 2 * n * h * w * 3
    budget = float(os.environ.get("DYK_DEVICE_CACHE_GB", "4")) * 1e9
    if force is None and need + _RESIDENT["bytes"] > budget:
        return None
    # filled in chunks of 64 rows, so the host holds one chunk at a time
    pv = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    pl = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i0 in range(0, n, 64):
        i1 = min(i0 + 64, n)
        v, l = _stack_pairs(dataset, range(i0, i1))
        pv[i0:i1].copy_(v)
        pl[i0:i1].copy_(l)
    pools[str(device)] = pool = (pv, pl)
    print(f"device image pool: {n} pairs resident on {device} "
          f"({need / 1e9:.2f} GB); batches gather on the device", flush=True)
    _claim_resident(_RESIDENT, dataset, need)
    return pool


def host_image_pool(dataset, src_hw, device=None):
    """The middle tier: the whole split's uint8 pairs in pinned host memory.
    Returns (pool_v, pool_l, gather) with ``gather((pool_v, pool_l),
    idx_np)`` -> the pair's rows on ``device``, or None on a CPU device or
    when pinned memory cannot be had."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return None
    cached = getattr(dataset, "_host_pool", None)
    if cached is not None:
        return cached
    n = len(dataset)
    h, w = src_hw
    try:
        pool_v = torch.empty((n, h, w, 3), dtype=torch.uint8,
                             pin_memory=True)
        pool_l = torch.empty((n, h, w, 3), dtype=torch.uint8,
                             pin_memory=True)
    except RuntimeError as e:       # no pinnable memory: stream instead
        print(f"host image pool unavailable ({str(e)[:200]}); streaming "
              f"instead", flush=True)
        return None
    for i0 in range(0, n, 64):
        i1 = min(i0 + 64, n)
        pool_v[i0:i1], pool_l[i0:i1] = _stack_pairs(dataset, range(i0, i1))

    def rows(pool, idx):
        # a fresh pinned buffer per gather: the caching host allocator keeps
        # it from reuse until the asynchronous copy out of it has finished
        out = torch.empty((len(idx),) + tuple(pool.shape[1:]),
                          dtype=pool.dtype, pin_memory=True)
        torch.index_select(pool, 0, idx, out=out)
        return out.to(device, non_blocking=True)

    def gather(pools, idx_np):
        idx = torch.as_tensor(np.asarray(idx_np), dtype=torch.long)
        return tuple(rows(p, idx) for p in pools)

    print(f"host image pool: {n} pairs pinned in host memory "
          f"({2 * n * h * w * 3 / 1e9:.2f} GB); batches gather host-side",
          flush=True)
    dataset._host_pool = (pool_v, pool_l, gather)
    _claim_resident(_HOST_RESIDENT, dataset, 2 * n * h * w * 3)
    return dataset._host_pool


def select_image_pool(dataset, src_hw, device_cache, device=None):
    """The residency tier: ("hbm", (pool_v, pool_l)) when the split fits the
    shared ``DYK_DEVICE_CACHE_GB`` budget (or ``device_cache=True`` forces
    it), else ("host", (pool_v, pool_l, gather)) when it fits
    ``DYK_HOST_CACHE_GB`` and the device takes pinned copies, else
    (None, None): per-batch streaming."""
    pool = device_image_pool(dataset, src_hw, device_cache, device)
    if pool is not None:
        return "hbm", pool
    if device_cache is not False:
        cached = getattr(dataset, "_host_pool", None)
        if cached is not None:
            # this dataset's bytes are already inside _HOST_RESIDENT: the
            # budget check below would count them twice and demote a pinned
            # dataset to streaming once any other pool pins after it
            return "host", cached
        n = len(dataset)
        need = 2 * n * src_hw[0] * src_hw[1] * 3
        hbudget = float(os.environ.get("DYK_HOST_CACHE_GB", "16")) * 1e9
        if need + _HOST_RESIDENT["bytes"] <= hbudget:
            hpool = host_image_pool(dataset, src_hw, device)
            if hpool is not None:
                return "host", hpool
    return None, None


# ------------------------------------------------------------------ iterators

def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread, keeping ``depth`` items
    ahead: host JPEG decode and the preprocess launches overlap the
    consumer's forward. A worker's exception is raised in the consumer; the
    worker stops when the consumer stops."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []
    stop = threading.Event()   # consumer gone: drop the pipeline

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer has left, so that an
        # aborted loop does not leave the worker blocked forever holding
        # ``depth`` device batches and the dataset
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # drain so that a worker in the middle of a put sees stop and exits
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def eval_batches(dataset, batch_size: int, device_cache: bool | None = None,
                 device=None):
    """Yield (v, l, indices, (ratio, pad)) rect-letterboxed batches on
    ``device`` (None: the CPU; the evaluator passes its device).

    ``device_cache``: the residency tier (:func:`select_image_pool`). Pooling
    needs one source shape for the whole split (KAIST has one); a
    mixed-shape split streams, and each batch is split into runs of
    consecutive same-shape images, one sub-batch per run."""
    device = torch.device("cpu" if device is None else device)
    n = len(dataset)
    fns: dict = {}
    tier = pool = None
    if n and device_cache is not False:
        shapes = np.asarray(dataset.shapes)
        if (shapes == shapes[0]).all():
            src_hw0 = tuple(int(x) for x in shapes[0][::-1])
            tier, pool = select_image_pool(dataset, src_hw0, device_cache,
                                           device)
    for b0 in range(0, n, batch_size):
        idx_full = np.arange(b0, min(b0 + batch_size, n))
        shp = [tuple(int(x) for x in dataset.shapes[i]) for i in idx_full]
        runs, start = [], 0
        for k in range(1, len(idx_full) + 1):
            if k == len(idx_full) or shp[k] != shp[start]:
                runs.append(idx_full[start:k])
                start = k
        yield from _eval_run_batches(dataset, runs, fns, tier, pool, device)


def _eval_run_batches(dataset, runs, fns, tier, pool, device):
    for idx in runs:
        src_hw = tuple(int(x) for x in dataset.shapes[idx[0]][::-1])
        if dataset.rect:
            dst = tuple(int(x) for x in
                        dataset.batch_shapes[dataset.batch_index[idx[0]]])
        else:
            dst = (dataset.img_size, dataset.img_size)
        sig = (src_hw, dst)
        if sig not in fns:
            fns[sig] = make_eval_preprocess_fn(src_hw, dst, dataset.img_size,
                                               clahe=dataset.clahe,
                                               from_pool=tier == "hbm")
        fn, r, pad = fns[sig]
        if tier == "hbm":
            v, l = fn(pool[0], pool[1],
                      torch.as_tensor(idx, dtype=torch.long, device=device))
        elif tier == "host":
            pv, pl, gather = pool
            v, l = fn(*gather((pv, pl), idx))
        else:
            rv, rl = _stack_pairs(dataset, idx)
            v, l = fn(rv.to(device), rl.to(device))
        yield v, l, idx, (r, pad)

