"""The port's eval input side against the JAX package's, on the CPU:
``data/dataset.py::KaistDataset`` and ``data/pipeline.py`` (the two-stage
eval preprocess, the residency tiers, ``eval_batches``, ``prefetch``).

Splits are written with ``cv2.imwrite`` under ``tmp_path`` in the KAIST
layout (``*_visible.jpg`` / ``*_lwir.jpg``, ``labels/*.txt``), as
``tests/test_dataset_pipeline.py`` writes them. Everything the dataset
computes on the host (shapes, labels, rect batch shapes, ground truth,
decoded pairs) must be exactly equal; the preprocessed batches, fp32 on
both sides with the same formulas, within 1e-5.
"""

import os
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.data import dataset as JD
from double_yolo_kaist_tpu.data import pipeline as JP
from double_yolo_kaist_torch.data import dataset as TD
from double_yolo_kaist_torch.data import pipeline as TP


def write_split(root, frames, labels=None, name="split"):
    """A KAIST-layout split under ``root``: ``frames`` is a list of (visible,
    lwir) uint8 RGB arrays, ``labels`` a list of (n, 5) arrays (None: one
    box per frame). Returns the split file's path."""
    img_dir = os.path.join(str(root), "images", name)
    lab_dir = os.path.join(str(root), "labels", name)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    logical = []
    for i, (v, l) in enumerate(frames):
        stem = f"I{i:05d}"
        cv2.imwrite(os.path.join(img_dir, f"{stem}_visible.jpg"), v[..., ::-1])
        cv2.imwrite(os.path.join(img_dir, f"{stem}_lwir.jpg"), l[..., ::-1])
        lab = (np.asarray([[0, 0.5, 0.5, 0.25, 0.4]]) if labels is None
               else labels[i])
        with open(os.path.join(lab_dir, f"{stem}.txt"), "w") as f:
            f.write("".join(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                            f"{r[4]:.6f}\n" for r in lab))
        logical.append(os.path.join(img_dir, f"{stem}.jpg"))
    path = os.path.join(str(root), f"{name}.txt")
    with open(path, "w") as f:
        f.write("\n".join(logical) + "\n")
    return path


def random_frames(rng, n, hw):
    return [tuple(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                  for _ in range(2)) for _ in range(n)]


def random_labels(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        lab = np.zeros((k, 5))
        lab[:, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        lab[:, 3:] = rng.uniform(0.05, 0.3, (k, 2))
        out.append(lab)
    return out


@pytest.fixture(scope="module", params=[(128, 160), (64, 96), (512, 640)],
            ids=["128x160", "64x96", "512x640"])
def split(request, tmp_path_factory):
    """(split path, frame hw, img sizes to try)."""
    hw = request.param
    rng = np.random.default_rng(sum(hw))
    n = 3 if hw == (512, 640) else 7
    root = tmp_path_factory.mktemp("split")
    path = write_split(root, random_frames(rng, n, hw), random_labels(rng, n))
    sizes = {(128, 160): (64, 160), (64, 96): (96, 64), (512, 640): (512,)}
    return path, hw, sizes[hw]


def test_dataset_matches_jax(split):
    """shapes, labels, batch_index and the rect batch_shapes exactly equal;
    the 64x96 frames at img_size 96 make h/w * img_size / 32 an integer."""
    path, hw, sizes = split
    for img_size in sizes:
        for rect in (False, True):
            kw = dict(img_size=img_size, batch_size=3, rect=rect)
            ref, mine = JD.KaistDataset(path, **kw), TD.KaistDataset(path, **kw)
            assert mine.img_files == ref.img_files
            assert mine.visible_files == ref.visible_files
            assert mine.lwir_files == ref.lwir_files
            assert mine.label_files == ref.label_files
            np.testing.assert_array_equal(mine.shapes, ref.shapes)
            assert mine.shapes.dtype == ref.shapes.dtype == np.float64
            np.testing.assert_array_equal(mine.batch_index, ref.batch_index)
            assert len(mine.labels) == len(ref.labels)
            for a, b in zip(mine.labels, ref.labels):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            if rect:
                np.testing.assert_array_equal(mine.batch_shapes,
                                              ref.batch_shapes)
            gt_m, gt_r = mine.coco_ground_truth(), ref.coco_ground_truth()
            assert sorted(gt_m) == sorted(gt_r)
            for k in gt_r:
                np.testing.assert_array_equal(gt_m[k], gt_r[k])
    assert os.path.exists(path.replace(".txt", ".shapes"))


def test_rect_shape_lands_on_an_integer(tmp_path):
    """64x96 frames at img_size 96: ar * 96 / 32 is 2 up to rounding, and
    ceil() must land where the JAX package's lands."""
    path = write_split(tmp_path, random_frames(np.random.default_rng(0), 2,
                                               (64, 96)))
    ref = JD.KaistDataset(path, img_size=96, rect=True)
    mine = TD.KaistDataset(path, img_size=96, rect=True)
    np.testing.assert_array_equal(mine.batch_shapes, ref.batch_shapes)
    assert tuple(mine.batch_shapes[0]) == (64, 96)


@pytest.mark.parametrize("mode", [None, "ram", "disk"])
def test_load_pair_matches_jax(split, mode, tmp_path):
    """Decoded pairs equal the JAX package's, fresh and through the RAM and
    disk caches (the second read is served from the cache)."""
    path, _, sizes = split
    ref = JD.KaistDataset(path, img_size=sizes[0])
    mine = TD.KaistDataset(path, img_size=sizes[0], cache_images=mode)
    for i in range(len(ref)):
        v0, l0 = ref.load_pair(i)
        for _ in range(2):
            v, l = mine.load_pair(i)
            np.testing.assert_array_equal(v, v0)
            np.testing.assert_array_equal(l, l0)
    if mode == "disk":
        assert len(list(mine._disk_dir.glob("*.npy"))) == len(ref)


def test_bad_cache_mode_raises(split):
    with pytest.raises(ValueError, match="cache_images"):
        TD.KaistDataset(split[0], cache_images="gpu")


@pytest.mark.parametrize("src_hw,dst_hw,img_size", [
    ((512, 640), (416, 512), 512),     # KAIST rect eval: 409 rows + 3 / 4
    ((37, 53), (64, 64), 64),          # odd source, upscaled, square pad
    ((81, 47), (64, 32), 64),          # portrait, pad on the columns
    ((64, 96), (64, 96), 96),          # r1 == 1: no resize
])
@pytest.mark.parametrize("from_pool", [False, True])
def test_eval_preprocess_matches_jax(src_hw, dst_hw, img_size, from_pool):
    rng = np.random.default_rng(3)
    v = rng.integers(0, 256, (2,) + src_hw + (3,), dtype=np.uint8)
    l = rng.integers(0, 256, (2,) + src_hw + (3,), dtype=np.uint8)
    jfn, jr, jpad = JP.make_eval_preprocess_fn(src_hw, dst_hw, img_size,
                                               from_pool=from_pool)
    tfn, tr, tpad = TP.make_eval_preprocess_fn(src_hw, dst_hw, img_size,
                                               from_pool=from_pool)
    assert (tr, tpad) == (jr, jpad)
    if from_pool:
        idx = np.asarray([1, 0, 1])
        want = jfn(jnp.asarray(v), jnp.asarray(l), jnp.asarray(idx))
        got = tfn(torch.from_numpy(v), torch.from_numpy(l),
                  torch.from_numpy(idx))
    else:
        want = jfn(jnp.asarray(v), jnp.asarray(l))
        got = tfn(torch.from_numpy(v), torch.from_numpy(l))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert tuple(g.shape[1:3]) == dst_hw
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("src_hw,dst_hw,img_size", [
    ((128, 160), (104, 128), 128),     # KAIST's rect eval at a quarter
    ((64, 96), (64, 96), 96),          # r1 == 1: CLAHE of the frame itself
    ((37, 53), (64, 64), 64),          # a CLAHE shape off the tile grid
])
@pytest.mark.parametrize("from_pool", [False, True])
def test_eval_preprocess_clahe_matches_jax(src_hw, dst_hw, img_size,
                                           from_pool):
    """``clahe=True`` CLAHEs after the first resize, as the JAX package
    does. JAX is run op by op (``jax.disable_jit``), as the port runs: its
    jitted resize fuses the lerp differently and moves a value by up to
    4e-3, which tips the uint8 rounding of about 1e-4 of the pixels going
    into CLAHE, and a tile's LUT moves with its histogram. Op by op, the
    same bytes go into CLAHE, so the batches agree within 1e-5."""
    rng = np.random.default_rng(8)
    v = rng.integers(0, 256, (2,) + src_hw + (3,), dtype=np.uint8)
    l = (rng.integers(0, 40, (2,) + src_hw + (3,)) + 90).astype(np.uint8)
    jfn, jr, jpad = JP.make_eval_preprocess_fn(src_hw, dst_hw, img_size,
                                               clahe=True,
                                               from_pool=from_pool)
    tfn, tr, tpad = TP.make_eval_preprocess_fn(src_hw, dst_hw, img_size,
                                               clahe=True,
                                               from_pool=from_pool)
    plain, _, _ = TP.make_eval_preprocess_fn(src_hw, dst_hw, img_size)
    assert (tr, tpad) == (jr, jpad)
    args = (v, l, np.asarray([1, 0])) if from_pool else (v, l)
    with jax.disable_jit():
        want = jfn(*map(jnp.asarray, args))
    got = tfn(*map(torch.from_numpy, args))
    for g, w, p in zip(got, want, plain(torch.from_numpy(v),
                                        torch.from_numpy(l))):
        assert tuple(g.shape[1:3]) == dst_hw
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        assert not torch.equal(g, p)               # CLAHE did something


def test_eval_batches_clahe_matches_jax(tmp_path):
    """A split with ``clahe`` set: eval_batches CLAHEs, as the JAX
    package's does (run op by op, as in
    test_eval_preprocess_clahe_matches_jax), from the device pool and
    streaming alike."""
    rng = np.random.default_rng(9)
    path = write_split(tmp_path, random_frames(rng, 5, (64, 96)),
                       random_labels(rng, 5))
    kw = dict(img_size=96, batch_size=4, rect=True, clahe=True)
    with jax.disable_jit():
        ref = [(np.asarray(v), np.asarray(l), list(idx), rp)
               for v, l, idx, rp in JP.eval_batches(
                   JD.KaistDataset(path, **kw), 4, device_cache=False)]
    for cache in (True, False):
        got = _batches(TP.eval_batches(TD.KaistDataset(path, **kw), 4,
                                       device_cache=cache, device="cpu"))
        assert len(got) == len(ref)
        for a, r in zip(got, ref):
            assert a[2] == r[2] and a[3] == r[3]
            np.testing.assert_allclose(a[0], r[0], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(a[1], r[1], rtol=1e-5, atol=1e-5)
    plain = _batches(TP.eval_batches(TD.KaistDataset(
        path, **dict(kw, clahe=False)), 4, device_cache=False, device="cpu"))
    assert not np.array_equal(plain[0][0], got[0][0])


@pytest.mark.parametrize("name", ["iter_preprocessed", "device_image_pool",
                                  "host_image_pool", "eval_batches",
                                  "train_batches", "create_train_state"])
def test_public_functions_default_to_cuda(name, tmp_path):
    """``device=None`` means ``cuda`` in every public function of the data
    and train paths: without a card each raises, as resolve_device does,
    unless it is given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: None takes it")
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.data import streams as TS
    from double_yolo_kaist_torch.train import optim as TO
    from double_yolo_kaist_torch.train import step as TST
    hw = (64, 96)
    rng = np.random.default_rng(2)
    path = write_split(tmp_path, random_frames(rng, 2, hw),
                       random_labels(rng, 2))
    ds = TD.KaistDataset(path, img_size=96, batch_size=2,
                         augment=name == "train_batches")

    class Frames:                      # a stream of one frame
        img_size = 64

        def __iter__(self):
            return iter([np.zeros((48, 64, 3), np.uint8)])

    tiny = os.path.join(os.path.dirname(__file__), "fixtures",
                        "tiny_dyolov3.cfg")
    calls = {
        "iter_preprocessed": lambda **kw: next(TS.iter_preprocessed(
            Frames(), TP.make_eval_preprocess_fn, **kw)),
        "device_image_pool": lambda **kw: TP.device_image_pool(
            ds, tuple(hw), True, **kw),
        "host_image_pool": lambda **kw: TP.host_image_pool(
            ds, tuple(hw), **kw),
        "eval_batches": lambda **kw: next(TP.eval_batches(ds, 2, **kw)),
        "train_batches": lambda **kw: next(TP.train_batches(
            ds, 2, 0, img_size=64, hyp={}, **kw)),
        "create_train_state": lambda **kw: TST.create_train_state(
            compile_cfg(tiny, yolo_strides=[8, 4]), 0,
            TO.make_optimizer({"lr0": 0.01, "momentum": 0.9,
                               "weight_decay": 0.0},
                              lambda i: 0.01), **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()
    calls[name](device="cpu")


def _batches(it):
    return [(v.numpy(), l.numpy(), list(idx), rp) for v, l, idx, rp in it]


def test_eval_batches_tiers_and_jax(split, monkeypatch):
    """The device-pool tier (on the CPU device) and the streaming tier give
    identical batches; both equal the JAX package's within 1e-5, with the
    same indices and letterbox parameters."""
    path, _, sizes = split
    monkeypatch.setenv("DYK_DEVICE_CACHE_GB", "1")
    kw = dict(img_size=sizes[0], batch_size=4, rect=True)
    ds = TD.KaistDataset(path, **kw)
    pooled = _batches(TP.eval_batches(ds, 4, device_cache=None,
                                      device="cpu"))
    assert "cpu" in ds._device_pools                # it took the pool tier
    streamed = _batches(TP.eval_batches(TD.KaistDataset(path, **kw), 4,
                                        device_cache=False, device="cpu"))
    ref = [(np.asarray(v), np.asarray(l), list(idx), rp) for v, l, idx, rp
           in JP.eval_batches(JD.KaistDataset(path, **kw), 4,
                              device_cache=False)]
    assert len(pooled) == len(streamed) == len(ref) == -(-len(ds) // 4)
    for a, b, r in zip(pooled, streamed, ref):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] == r[2] and a[3] == b[3] == r[3]
        np.testing.assert_allclose(a[0], r[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a[1], r[1], rtol=1e-5, atol=1e-5)


def test_tier_selection(split, monkeypatch):
    """The device pool is taken within DYK_DEVICE_CACHE_GB and declined
    beyond it; the pinned host tier is never taken for a CPU device."""
    path, hw, sizes = split
    src_hw = tuple(hw)
    monkeypatch.setenv("DYK_DEVICE_CACHE_GB", "0")
    ds = TD.KaistDataset(path, img_size=sizes[0])
    assert TP.select_image_pool(ds, src_hw, None, "cpu") == (None, None)
    assert TP.host_image_pool(ds, src_hw, "cpu") is None
    tier, pool = TP.select_image_pool(ds, src_hw, True, "cpu")
    assert tier == "hbm" and pool[0].shape == (len(ds),) + src_hw + (3,)
    assert TP.select_image_pool(ds, src_hw, False, "cpu") == (None, None)


def test_eval_batches_mixed_shapes(tmp_path):
    """A mixed-shape split streams in runs of one source shape, as the JAX
    package splits it."""
    rng = np.random.default_rng(1)
    shapes = [(64, 96), (64, 96), (48, 80), (64, 96), (48, 80), (48, 80)]
    frames = [tuple(rng.integers(0, 256, s + (3,), dtype=np.uint8)
                    for _ in range(2)) for s in shapes]
    path = write_split(tmp_path, frames)
    kw = dict(img_size=64, batch_size=4, rect=False)
    mine = _batches(TP.eval_batches(TD.KaistDataset(path, **kw), 4,
                                    device="cpu"))
    ref = [(np.asarray(v), np.asarray(l), list(idx), rp) for v, l, idx, rp
           in JP.eval_batches(JD.KaistDataset(path, **kw), 4)]
    assert [m[2] for m in mine] == [r[2] for r in ref] == [
        [0, 1], [2], [3], [4, 5]]
    for m, r in zip(mine, ref):
        assert m[0].shape == r[0].shape and m[3] == r[3]
        np.testing.assert_allclose(m[0], r[0], rtol=1e-5, atol=1e-5)


def test_prefetch_order_and_error():
    assert list(TP.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("worker failed")

    it = TP.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="worker failed"):
        next(it)


def test_prefetch_stops_with_the_consumer():
    """Once the consumer stops, the worker stops pulling from its source and
    its thread ends."""
    pulled = []

    def source():
        for i in range(10_000):
            pulled.append(i)
            yield i

    before = set(threading.enumerate())
    it = TP.prefetch(source(), depth=2)
    for i, x in enumerate(it):
        if i == 3:
            break
    it.close()
    deadline = time.monotonic() + 5
    workers = [t for t in threading.enumerate() if t not in before]
    while any(t.is_alive() for t in workers) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in workers)
    assert len(pulled) <= 4 + 2 + 2
