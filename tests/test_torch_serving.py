"""``serving.Predictor``'s packed body and its CUDA graphs, the port against
the JAX package.

On the CPU the body (uint8 letterbox -> forward -> NMS -> packed
``(B, max_det, 7)``) runs eagerly; it is held against JAX's
``Predictor._full_program`` in fp32 at 64x96: the same valid slots, boxes
and scores within rtol 1e-4 / atol 1e-3 (the same fp32 math, summed in
another order; ``tests/test_torch_slice.py``). ``__call__`` must equal the
eager ``run_batch`` + ``unpack_detections`` bit for bit, from any thread.

The ``cuda`` cases hold the graph path against the eager path on the card
(bit-identical: the same kernels on the same inputs), on MNv3 (K1, K2) and
the full flagship at 64x96 with seeded weights (K3, and K4 in int8), and a
replay after new frames are staged. JAX is imported inside the CPU cases,
so that the card, which has no JAX, runs the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_serving.py
"""

import os
import threading

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.bench import seeded_variables
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.serving import (Predictor, pack,
                                             unpack_detections)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")
FLAGSHIP = os.path.join(REPO, "configs",
                        "kaist_dyolov4_fshare_global_concat_se3.cfg")
HW = (64, 96)


@pytest.fixture(scope="module", params=["tiny", "mnv3"])
def model(request):
    """(name, jax ir, jax variables, port ir, port variables)."""
    import jax

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.models import import_weights as JW
    from tests.test_torch_slice import _perturb_bn
    if request.param == "tiny":
        jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
        tir = compile_cfg(TINY, yolo_strides=[8, 4])
        jv = _perturb_bn(jax.tree.map(
            lambda a: np.array(a), JG.init(jir, jax.random.PRNGKey(0))))
        return "tiny", jir, jv, tir, TW.from_jax_variables(tir, jv)
    jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
    with np.load(NPZ) as z:
        jv = JW.from_torch_state_dict(jir, {k: z[k] for k in z.files})
    return "mnv3", jir, jv, tir, TW.load_state_dict_npz(tir, NPZ)


def _frames(seed, n, hw=HW):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8),
            rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8))


def test_packed_body_matches_jax_full_program(model):
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.serving import Predictor as JaxPredictor
    name, jir, jv, tir, tv = model
    kw = dict(img_size=96, conf_thres=0.01, batch_buckets=(2,))
    v, l = _frames(0, 2)
    jp = JaxPredictor(jir, jv, compute_dtype=jnp.float32, **kw)
    ref = np.asarray(jp._full_program(HW, False)(
        jp.folded, jnp.asarray(v), jnp.asarray(l)))
    pred = Predictor(tir, tv, compute_dtype=torch.float32, device="cpu", **kw)
    with torch.inference_mode():
        got = pred._body(torch.from_numpy(v), torch.from_numpy(l),
                         False).numpy()
    assert got.shape == ref.shape == (2, 100, 7)
    np.testing.assert_array_equal(got[..., 6], ref[..., 6], err_msg=name)
    valid = ref[..., 6] > 0.5
    assert valid.sum() > 0, name
    np.testing.assert_allclose(got[..., :5][valid], ref[..., :5][valid],
                               rtol=1e-4, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got[..., 5][valid], ref[..., 5][valid])


def test_call_equals_eager_run_batch(model):
    """Three frames in a bucket of four, then one: ``__call__`` through the
    staged inputs equals ``run_batch`` on a freshly padded batch."""
    _, _, _, tir, tv = model
    pred = Predictor(tir, tv, img_size=96, conf_thres=0.01,
                     batch_buckets=(4,), compute_dtype=torch.float32,
                     device="cpu")
    _, ratio, pad = pred._preprocess(HW)
    for n, seed in ((3, 1), (1, 2)):
        v, l = _frames(seed, n)
        got = pred(v, l)
        pv = torch.zeros((4,) + HW + (3,), dtype=torch.uint8)
        pl = torch.zeros_like(pv)
        pv[:n], pl[:n] = torch.from_numpy(v), torch.from_numpy(l)
        det, valid = pred.run_batch(pv, pl)
        want = unpack_detections(det.numpy(), valid.numpy(), n, ratio[0],
                                 pad, HW)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    stage = pred._stages[(4, HW)]
    assert stage.filled == 1
    assert all(int(t[1:].sum()) == 0 for t in stage.dev)   # padded slots


def test_warmup_snaps_to_its_bucket(model):
    _, _, _, tir, tv = model
    pred = Predictor(tir, tv, img_size=96, conf_thres=0.01,
                     batch_buckets=(2, 4), compute_dtype=torch.float32,
                     device="cpu")
    assert pred._bucket(3) == 4
    pred.warmup(HW, batch=3)
    assert list(pred._stages) == [(4, HW)]


def test_warmup_leaves_calibration_alone():
    """Warming up an int8 Predictor takes no calibration slot; the first
    real request (calibration_batches=1) calibrates."""
    import jax

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(lambda a: np.array(a),
                      JG.init(jir, jax.random.PRNGKey(0)))
    q = Predictor(ir, TW.from_jax_variables(ir, jv), img_size=64,
                  batch_buckets=(2,), compute_dtype=torch.float32, int8=True,
                  calibration_batches=1, device="cpu")
    assert q._int8
    q.warmup((96, 128))
    assert q.qvars is None and not q._cal_batches
    v, _ = _frames(3, 2, (96, 128))
    q(v, v)
    assert q.qvars is not None and not q._cal_batches


def test_concurrent_calls_equal_sequential(model):
    """Eight threads share one Predictor: each gets its own frames' result
    (the staging buffers are shared and held under the lock)."""
    _, _, _, tir, tv = model
    pred = Predictor(tir, tv, img_size=96, conf_thres=0.01,
                     batch_buckets=(1, 2), compute_dtype=torch.float32,
                     device="cpu")
    frames = [_frames(10 + i, 1) for i in range(8)]
    want = [pred(v, l) for v, l in frames]
    got = [None] * len(frames)

    def work(i):
        got[i] = pred(*frames[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        for a, b in zip(g[0], w[0]):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _eager(pred, v, l, bucket):
    """``run_batch`` + ``unpack_detections`` on one zero-padded bucket."""
    n = len(v)
    pv = torch.zeros((bucket,) + v.shape[1:], dtype=torch.uint8,
                     device=pred.device)
    pl = torch.zeros_like(pv)
    pv[:n], pl[:n] = torch.from_numpy(v), torch.from_numpy(l)
    _, ratio, pad = pred._preprocess(tuple(v.shape[1:3]))
    packed = pack(*pred.run_batch(pv, pl)).cpu().numpy()
    return unpack_detections(packed[..., :6], packed[..., 6] > 0.5, n,
                             ratio[0], pad, tuple(v.shape[1:3]))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mnv3", "flagship", "flagship int8"])
def test_graph_equals_eager_on_card(cuda, name):
    """Requests of 1 and 3 frames served from graphs equal the eager path;
    the graph holds K1 once, K2 once, and on the flagship K3 twice and in
    int8 K4 ten times; replays count them."""
    if name == "mnv3":
        ir = compile_cfg(MNV3)
        variables = TW.load_state_dict_npz(ir, NPZ)
    else:
        ir = compile_cfg(FLAGSHIP)
        variables = seeded_variables(ir, 0)
    int8 = name.endswith("int8")
    pred = Predictor(ir, variables, img_size=96, batch_buckets=(1, 4),
                     conf_thres=0.01, int8=int8, device=cuda)
    if int8:
        for seed in (20, 21):                # the two calibration requests
            pred(*_frames(seed, 4))
        assert pred.qvars is not None
    want_held = {"decode_head": 1, "nms_indices": 1}
    if name != "mnv3":
        want_held["stem_conv_s2"] = 2
    if int8:
        want_held["qgemm"] = 10
    for n, bucket in ((1, 1), (3, 4)):
        v, l = _frames(30 + n, n)
        got = pred(v, l)
        g = pred._graphs[(bucket, HW, int8)]
        assert {k: g.launches.get(k, 0) for k in want_held} == want_held
        assert g.replays == 1
        _same(got, _eager(pred, v, l, bucket))
    before = dict(_build.launches)
    pred(*_frames(40, 1))
    assert {k: _build.launches[k] - before.get(k, 0)
            for k in want_held} == want_held


@pytest.mark.cuda
def test_replay_after_new_frames_on_card(cuda):
    """A replay reads what was staged last: new frames, fewer frames (the
    slots they leave are zeroed), then the first frames again."""
    ir = compile_cfg(MNV3)
    pred = Predictor(ir, TW.load_state_dict_npz(ir, NPZ), img_size=96,
                     batch_buckets=(4,), conf_thres=0.01, device=cuda)
    first = _frames(50, 4)
    a = pred(*first)
    for n, seed in ((4, 51), (2, 52)):
        v, l = _frames(seed, n)
        _same(pred(v, l), _eager(pred, v, l, 4))
    _same(pred(*first), a)
    assert pred._graphs[(4, HW, False)].replays == 4
