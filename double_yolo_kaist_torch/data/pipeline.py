"""The input pipelines: mosaic-augmented train batches and rect-letterboxed
eval batches, dual-stream, on the device.

Counterpart of the JAX package's ``data/pipeline.py``. Train path
(reference kaist_dataset.py:321-388, mosaic "quadra" order): decode (host)
-> resize to max side s -> mosaic-4 canvas (2s x 2s) -> [CLAHE + snowflake
cutout] -> random affine (border -s//2 -> s x s) -> HSV jitter ->
normalized xywh -> 50% flip -> float [0, 1] (:func:`make_train_augment_fn`,
:func:`train_batch_plan`, :func:`train_batches`). Eval path: the
reference's two-stage eval preprocessing (max-side resize with int()
truncation, [CLAHE,] then a letterbox pad to the batch shape,
kaist_dataset.py:203-208 and img_utils.py:5-53), the residency tiers of the
split's uint8 pairs, a background prefetch thread and :func:`eval_batches`.

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
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..train.loss import pad_labels
from . import augment as A
from .letterbox import clahe_u8, resize_bilinear

# the quadra path's cutout settings (reference kaist_dataset.py:276)
N_SNOW, N_THR, CUT_STEP = 80, 24, 32


def make_train_augment_fn(src_hw, img_size: int, hyp: dict,
                          snowflake: bool = False, clahe: bool = False,
                          epoch_partners: bool = True,
                          from_pool: bool = False):
    """The train-time augmentation program (JAX pipeline.py:45-222, its
    ``gather`` route, unchunked, fp32 pixels).

    Returns ``fn(generator, v_u8, l_u8, labels, lmask)`` -> batch dict for
    the train step ({"v", "l"}: (B, s, s, 3) fp32 in [0, 1]; "targets":
    (B, 4T, 5) normalized xywh; "tmask": (B, 4T)), on the inputs' device.
    With ``from_pool`` it is ``fn(generator, pool_v, pool_l, load_idx,
    labels, lmask)`` and gathers the rows itself. Labels (B', T, 5) are
    normalized xywh.

    ``epoch_partners``: the inputs hold 4B pairs, B batch images followed
    by 3B host-drawn mosaic partners (image i mosaics with B+3i..B+3i+2);
    False: B pairs, partners drawn from the batch.

    ``snowflake``: the reference recipe's cutout (:func:`.augment.
    snowflake_cutout`, 80 squares of 32 in images with at most 24 labels),
    which CLAHEs the canvas first, as the reference's cutout does
    (snowflake.py:67-69). ``clahe``: CLAHE the canvas alone. Both come
    after the mosaic and before the affine (JAX pipeline.py:135-151).
    Standalone ``clahe`` on the mosaic path is the JAX package's deliberate
    deviation from the reference, whose mosaic path never CLAHEs: eval
    always CLAHEs under ``clahe``, so training does too.

    Every random is drawn at full-batch shape, on the CPU, from five
    streams seeded from ``generator`` in JAX's order (mosaic, cutout,
    affine, HSV, flip); the cutout stream is drawn only with
    ``snowflake`` and moves none of the others. ``fn.heavy`` runs the
    transforms from given randoms, as JAX's ``heavy`` does, and
    ``fn.draw(generator, nb)`` returns them."""
    s = img_size
    r = s / max(src_hw)
    h1, w1 = int(src_hw[0] * r), int(src_hw[1] * r)
    separable = (hyp.get("degrees", 0.0) == 0.0
                 and hyp.get("shear", 0.0) == 0.0)

    def draw(generator, nb: int) -> dict:
        seeds = torch.randint(0, 2 ** 62, (5,), generator=generator).tolist()
        g_mosaic, g_cut, g_affine, g_hsv, g_flip = (
            torch.Generator().manual_seed(x) for x in seeds)
        centers = torch.randint(int(s * 0.5), int(s * 1.5) + 1, (nb, 2),
                                generator=g_mosaic)
        if epoch_partners:
            partners = nb + torch.arange(3 * nb).reshape(nb, 3)
        else:
            partners = torch.randint(0, nb, (nb, 3), generator=g_mosaic)
        Ms = A._affine_matrices(
            g_affine, nb, (2 * s, 2 * s), hyp.get("degrees", 0.0),
            hyp.get("translate", 0.0), hyp.get("scale", 0.0),
            hyp.get("shear", 0.0), -s // 2)
        hsv_r = (A._uniform(g_hsv, (nb, 3), -1.0, 1.0)
                 * torch.tensor([hyp.get("hsv_h", 0.0), hyp.get("hsv_s", 0.0),
                                 hyp.get("hsv_v", 0.0)], dtype=torch.float32)
                 + 1.0)
        do = torch.rand(nb, generator=g_flip) < 0.5
        cut_u = (torch.rand((nb, N_SNOW, 2), generator=g_cut)
                 if snowflake else None)
        return {"idx": torch.cat([torch.arange(nb)[:, None], partners], 1),
                "centers": centers, "cut_u": cut_u, "Ms": Ms,
                "hsv_r": hsv_r, "do": do}

    def heavy(v_u8, l_u8, labels, lmask, idx, centers, cut_u, Ms, hsv_r,
              do):
        """Resize -> mosaic paste -> CLAHE / cutout -> affine -> HSV ->
        flip; every random comes in as an argument. ``labels`` normalized
        xywh."""
        dev = v_u8.device
        idx = idx.to(dev)
        # normalized xywh -> absolute xyxy in the resized frame
        # (reference load_quadra_images, kaist_dataset.py:258-264)
        cx, cy = labels[..., 1] * w1, labels[..., 2] * h1
        bw, bh = labels[..., 3] * w1, labels[..., 4] * h1
        lab = torch.stack([labels[..., 0], cx - bw / 2, cy - bh / 2,
                           cx + bw / 2, cy + bh / 2], -1)
        v4t = resize_bilinear(v_u8[idx], h1, w1)           # (b, 4, h1, w1, 3)
        l4t = resize_bilinear(l_u8[idx], h1, w1)
        v4, l4, lab4, m4 = A.mosaic_place(v4t, l4t, lab[idx], lmask[idx],
                                          centers.to(dev), s)
        if snowflake or clahe:
            v4, l4 = clahe_u8(v4), clahe_u8(l4)
        if snowflake:
            v4, l4, m4 = A.snowflake_cutout(None, v4, l4, lab4, m4,
                                            n_thr=N_THR, step=CUT_STEP,
                                            n_snow=N_SNOW, u=cut_u)
        v4, l4, lab4, m4 = A.random_affine_batch(
            None, v4, l4, lab4, m4, border=-s // 2, Ms=Ms,
            separable=separable)
        v4, l4 = A.hsv_jitter(None, v4, l4, 0, 0, 0, gains=hsv_r)
        targets = A.xyxy_to_norm_xywh(lab4, m4, (s, s))
        v4, l4, targets = A.flip_lr(None, v4, l4, targets, do=do)
        targets = torch.where(m4[..., None], targets, 0.0)
        return {"v": v4 / 255.0, "l": l4 / 255.0, "targets": targets,
                "tmask": m4}

    def fn(generator, v_u8, l_u8, *rest):
        if from_pool:
            load_idx, labels, lmask = rest
            v_u8 = v_u8.index_select(0, load_idx)
            l_u8 = l_u8.index_select(0, load_idx)
        else:
            labels, lmask = rest
        nb = v_u8.shape[0] // 4 if epoch_partners else v_u8.shape[0]
        return heavy(v_u8, l_u8, labels, lmask, **draw(generator, nb))

    fn.heavy = heavy
    fn.draw = draw
    return fn


def make_eval_preprocess_fn(src_hw, dst_hw, img_size: int,
                            clahe: bool = False, from_pool: bool = False):
    """Eval preprocessing with the reference's exact two stages: (1) a
    max-side resize to ``img_size`` with int() truncation, then (2) a
    letterbox pad to ``dst_hw`` with scale_up=False. Returns (fn, ratio,
    pad) matching the reference's ``shapes`` tuple for scale_coords undo:
    ``fn(v_u8, l_u8) -> (v, l)``, fp32 NHWC in [0, 1] on the inputs' device.

    ``clahe``: CLAHE each frame after the first resize (JAX
    pipeline.py:224-251), as an eval split with ``clahe`` set asks.

    ``from_pool``: fn takes the whole split's u8 pools and an index tensor
    and gathers the batch rows in the same call."""
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
            if clahe:
                x = clahe_u8(x)
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
    beside every pool this process already holds. ``device``: None means
    ``cuda``."""
    device = resolve_device(device)
    if force is False:
        return None
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
    idx_np)`` -> the pair's rows on ``device`` (None means ``cuda``), or
    None on a CPU device or when pinned memory cannot be had."""
    device = resolve_device(device)
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
    ``device`` (None means ``cuda``; the evaluator passes its device).

    ``device_cache``: the residency tier (:func:`select_image_pool`). Pooling
    needs one source shape for the whole split (KAIST has one); a
    mixed-shape split streams, and each batch is split into runs of
    consecutive same-shape images, one sub-batch per run."""
    device = resolve_device(device)
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



# ------------------------------------------------------------- train batches

def train_batch_plan(dataset, batch_size: int, sizes, *,
                     max_targets_per_img: int = 16, shuffle: bool = True,
                     drop_last: bool = True, seed_epoch: int = 0,
                     epoch_partners: bool = True, size_every: int = 1):
    """Host-side epoch plan (JAX pipeline.py:500-532, the same numpy draws
    in the same order): yields (b0, idx, load, targets, tmask, size) per
    batch from one rng sequence: shuffle, then per batch the 3B mosaic
    partners (uniform over the whole split, reference kaist_dataset.py:230)
    and, every ``size_every`` batches, the multi-scale size."""
    n = len(dataset)
    order = np.arange(n)
    rng = np.random.default_rng(seed_epoch)
    if shuffle:
        rng.shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    size = sizes[0]
    for k, b0 in enumerate(range(0, stop, batch_size)):
        idx = order[b0:b0 + batch_size]
        load = list(idx)
        if epoch_partners:
            load += list(rng.integers(0, n, 3 * len(idx)))
        t, m = pad_labels([dataset.labels[i] for i in load],
                          max_targets_per_img)
        if k % size_every == 0:
            size = sizes[int(rng.integers(len(sizes)))]
        yield b0, idx, np.asarray(load, np.int32), t, m, size


def train_batches(dataset, batch_size: int, seed: int, *, img_size,
                  hyp: dict, snowflake: bool = False, clahe: bool = False,
                  max_targets_per_img: int = 16, shuffle: bool = True,
                  drop_last: bool = True, seed_epoch: int = 0,
                  epoch_partners: bool = True,
                  device_cache: bool | None = None, size_every: int = 1,
                  device=None):
    """Yield (augmented batch on ``device``, image indices) for one epoch
    (JAX pipeline.py:535-617).

    ``img_size``: an int, or a list of bucket sizes drawn per batch (multi-
    scale training, reference train.py:46-59). ``seed``: the augment
    randoms of the batch at offset b0 come from a generator seeded with
    ``seed`` and b0. The split's pairs come from the residency tier
    :func:`select_image_pool` picks (the device pool, the pinned host pool,
    or per-batch decode: with epoch partners that loads 4 x batch_size
    pairs a batch). ``device``: None means ``cuda``."""
    device = resolve_device(device)
    src_hw = tuple(int(x) for x in dataset.shapes[0][::-1])
    tier, pool = select_image_pool(dataset, src_hw, device_cache, device)
    if tier is None and epoch_partners and not getattr(
            dataset, "_warned_stream_partners", False):
        dataset._warned_stream_partners = True
        print("train_batches: streaming tier with epoch-wide mosaic "
              "partners loads 4x batch_size pairs per batch; enable "
              "cache_images or raise DYK_DEVICE_CACHE_GB / "
              "DYK_HOST_CACHE_GB", flush=True)
    sizes = [img_size] if isinstance(img_size, int) else list(img_size)
    augs = {s: make_train_augment_fn(src_hw, s, hyp, snowflake=snowflake,
                                     clahe=clahe,
                                     epoch_partners=epoch_partners,
                                     from_pool=tier == "hbm")
            for s in sizes}
    for b0, idx, load, t, m, size in train_batch_plan(
            dataset, batch_size, sizes,
            max_targets_per_img=max_targets_per_img, shuffle=shuffle,
            drop_last=drop_last, seed_epoch=seed_epoch,
            epoch_partners=epoch_partners, size_every=size_every):
        gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + int(b0))
        t = torch.from_numpy(t).to(device)
        m = torch.from_numpy(m).to(device)
        if tier == "hbm":
            batch = augs[size](gen, pool[0], pool[1],
                               torch.from_numpy(load).long().to(device), t, m)
        elif tier == "host":
            pv, pl, gather = pool
            rows_v, rows_l = gather((pv, pl), load)
            batch = augs[size](gen, rows_v, rows_l, t, m)
        else:
            rv, rl = _stack_pairs(dataset, load)
            batch = augs[size](gen, rv.to(device), rl.to(device), t, m)
        yield batch, idx
