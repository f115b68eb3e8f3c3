"""The port's 2-D data x space path (``parallel/spatial.py``,
``graph.apply(space=)``, ``compute_loss(space=)``, ``make_train_step(
space=)``): gloo processes on the CPU, each with one band of rows of its
data shard's images, against one process (and JAX) with the whole batch.

Two spawns of ranks (``tests/test_torch_dp_train.spawn_ranks``), each
rank writing its results to an npz that the tests below read:

  * mesh (2, 2), four ranks: (a) the tiny cfg's eval forward at 64x64,
    batch 4, halos as one all-reduce of a zeroed buffer (gloo's way) and
    as point-to-point messages (NCCL's way, which gloo runs for CPU
    tensors); (b) the tiny cfg's first SGD step in fp32, boxes placed so
    that the two bands hold different match counts and one box on the
    band boundary; (c) the mini-flagship's eval forward at 64x64, where
    the SPP's 13x13 pool at stride 32 needs a halo of 6 rows from bands
    of 1; (d) the mini-flagship's first SGD step in float64 under
    deterministic algorithms;
  * mesh (1, 2), two ranks: (e) MNv3 (stride-2 ``dwconv``, SE) and (f)
    the inception cfg ``kaist_dyolov3_concat_seinc.cfg`` (inception, SE,
    SPP), eval forwards at 64x64.

Tolerances, and why:
  * (a) against JAX's single-device ``graph.apply(train=False)``: rtol
    2e-4, atol 2e-4, ``tests/test_spatial_sharding.py``'s bounds for
    JAX's own 2-D mesh;
  * (b) loss, box and obj terms against JAX's ``make_train_step`` on the
    whole batch: 1e-4 absolute, that file's bound;
  * (c), (e), (f) fp32 forwards against JAX's single-device
    ``graph.apply(train=False)`` on the same weights and against the
    port's one process: rtol and atol 2e-4 (a band's convs and SE's sum
    over the bands add in other orders than the whole map's);
  * (d) float64: the loss, every metric, the parameters, the BN running
    state and the momentum traces (the first SGD step's trace is the
    gradient plus the decay) within 1e-9 of the largest magnitude of
    each array, the float64 bound of tests/test_torch_dp_train.py.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from double_yolo_kaist_torch.config.ir import compile_cfg  # noqa: E402
from double_yolo_kaist_torch.models import graph as TG  # noqa: E402
from double_yolo_kaist_torch.models import layers as TL  # noqa: E402
from double_yolo_kaist_torch.models.builder import \
    build_mini_flagship  # noqa: E402
from double_yolo_kaist_torch.parallel import multihost as MH  # noqa: E402
from double_yolo_kaist_torch.parallel import spatial as SP  # noqa: E402
from double_yolo_kaist_torch.train import optim as TO  # noqa: E402
from double_yolo_kaist_torch.train import step as TS  # noqa: E402
from double_yolo_kaist_torch.utils import tree as TR  # noqa: E402
from double_yolo_kaist_torch.utils.general import \
    deterministic  # noqa: E402

TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
SEINC = os.path.join(REPO, "configs", "kaist_dyolov3_concat_seinc.cfg")
HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0, "momentum": 0.937,
       "weight_decay": 0.05, "lr0": 0.01, "lrf": 0.1}
# (cx, cy) of each image's boxes, normalized: at 64 rows the bands split
# at cy 0.5, which the last box of image 0 sits on (its cell row belongs to
# band 1); the top band holds 4 boxes, the bottom one 3
BOXES = ([(0.3, 0.2), (0.6, 0.5)], [(0.5, 0.7)],
         [(0.4, 0.1), (0.2, 0.3), (0.7, 0.8)], [(0.55, 0.45)])
HW = 64
TIMEOUT = 180


def tiny_ir():
    return compile_cfg(TINY, yolo_strides=[8, 4])


def images(seed, n=4, hw=HW, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((n, hw, hw, 3), dtype))
            for _ in range(2)]


def train_batch():
    rng = np.random.default_rng(11)
    t = np.zeros((len(BOXES), 4, 5), np.float32)
    m = np.zeros((len(BOXES), 4), bool)
    for b, boxes in enumerate(BOXES):
        for k, (cx, cy) in enumerate(boxes):
            t[b, k] = [0, cx, cy, 0.25, 0.35]
            m[b, k] = True
    hw = (len(BOXES), HW, HW, 3)
    return {"v": rng.integers(0, 256, hw, dtype=np.uint8),
            "l": rng.integers(0, 256, hw, dtype=np.uint8),
            "targets": t, "tmask": m}


def forward(ir, variables, xv, xl, space=None, dtype=torch.float32):
    """The eval forward's decoded rows of this rank's data shard (the
    whole batch in one process)."""
    if space is not None:
        b = SP.local_batch({"v": xv, "l": xl}, space)
        xv, xl = b["v"], b["l"]
    v = TR.map_leaves(lambda t: t.to(dtype), variables)
    with torch.inference_mode():
        (io, _), _ = TG.apply(ir, v, xv.to(dtype), xl.to(dtype),
                              train=False, space=space)
    return io.numpy()


def jax_forward(jir, variables, xv, xl):
    """JAX's single-device eval forward (decoded rows) of the port's
    ``variables``, carried over by the port's weight function."""
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_torch.models import weights as TW
    from double_yolo_kaist_tpu.models import graph as JG
    jv = jax.tree.map(jnp.asarray, TW.to_jax_variables(variables))
    return np.asarray(JG.apply(jir, jv, jnp.asarray(xv.numpy()),
                               jnp.asarray(xl.numpy()), train=False)[0][0])


def first_step(ir, dtype, space=None):
    """The first SGD step on :func:`train_batch` from ``graph.init(ir,
    0)`` in ``dtype``: the metrics and every leaf of the new state."""
    v = TR.map_leaves(lambda t: t.to(dtype), TG.init(ir, 0))
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           v["params"])
    tx = TO.make_optimizer(HYP, TO.cosine_epoch_schedule(
        HYP["lr0"], HYP["lrf"], 3, 2), sgd=True)
    state = TS.TrainState(params, v["state"], tx.init(params), 0, None)
    step = TS.make_train_step(ir, HYP, tx, compute_dtype=dtype, space=space)
    batch = {k: torch.from_numpy(x) for k, x in train_batch().items()}
    if space is not None:
        batch = SP.local_batch(batch, space)
    with deterministic():
        state, m = step(state, batch)
    out = {f"m/{k}": x.detach().double().numpy() for k, x in m.items()}
    for j, t in enumerate(TS._state_leaves(state)):
        out[f"leaf/{j:04d}"] = t.detach().double().numpy()
    return out


def _mesh_2x2(space):
    """Spawn A's work on one rank."""
    out = {}
    ir = tiny_ir()
    v = TG.init(ir, 0)
    xv, xl = images(0)
    space.p2p = False
    out["a/reduce"] = forward(ir, v, xv, xl, space)
    space.p2p = True
    out["a/p2p"] = forward(ir, v, xv, xl, space)
    space.p2p = False
    for k, x in first_step(ir, torch.float32, space).items():
        if k.startswith("m/"):
            out[f"b/{k}"] = x
    mini = build_mini_flagship(img_size=HW)
    halos = []
    exchange = MH.exchange

    def counting(*a, **kw):
        halos.append(1)
        return exchange(*a, **kw)

    MH.exchange = counting
    layouts = []
    conv2d = TL.conv2d

    def recording(*a, **kw):
        y = conv2d(*a, **kw)
        layouts.append(y.is_contiguous(memory_format=torch.channels_last))
        return y

    TL.conv2d = recording
    try:
        out["c/out"] = forward(mini, TG.init(mini, 0), *images(1), space)
    finally:
        TL.conv2d = conv2d
    out["c/channels_last"] = np.asarray(layouts)
    try:
        for k, x in first_step(mini, torch.float64, space).items():
            out[f"d/{k}"] = x
    finally:
        MH.exchange = exchange
    out["halos"] = np.asarray(len(halos))
    return out


def _mesh_1x2(space):
    """Spawn B's work on one rank."""
    out = {}
    for tag, cfg in (("e", MNV3), ("f", SEINC)):
        ir = compile_cfg(cfg)
        out[tag] = forward(ir, TG.init(ir, 0), *images(2, n=1), space)
    return out


def _worker(rank: int, out: str, shape: str) -> None:
    torch.set_num_threads(1)
    D, S = (int(n) for n in shape.split("x"))
    assert MH.maybe_initialize_distributed(
        coordinator=f"file://{os.path.join(out, 'rendezvous')}",
        num_processes=D * S, process_id=rank, backend="gloo")
    space = SP.make_space_shard((D, S))
    assert (space.d, space.s) == divmod(rank, S)
    res = (_mesh_2x2 if (D, S) == (2, 2) else _mesh_1x2)(space)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
    print(f"rank{rank} OK", flush=True)


def _spawn(tmp_path_factory, shape):
    from tests.test_torch_dp_train import spawn_ranks

    root = tmp_path_factory.mktemp(f"space{shape}")
    D, S = (int(n) for n in shape.split("x"))
    spawn_ranks(os.path.abspath(__file__), [str(root), shape], ranks=D * S,
                timeout=TIMEOUT)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(D * S)]


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    return _spawn(tmp_path_factory, "2x2")


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    return _spawn(tmp_path_factory, "1x2")


def _rows(whole, rank, D, S):
    b = len(whole) // D
    d = rank // S
    return whole[d * b:(d + 1) * b]


@pytest.mark.parametrize("transport", ["reduce", "p2p"])
def test_tiny_forward_matches_jax(mesh_2x2, transport):
    """(a) Every rank's decoded rows equal JAX's one device on its data
    shard's images, with either transport of the halos."""
    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_cfg
    want = jax_forward(jax_cfg(TINY, yolo_strides=[8, 4]),
                       TG.init(tiny_ir(), 0), *images(0))
    for r, got in enumerate(mesh_2x2):
        np.testing.assert_allclose(got[f"a/{transport}"],
                                   _rows(want, r, 2, 2), rtol=2e-4,
                                   atol=2e-4, err_msg=f"rank {r}")


def test_tiny_train_step_matches_jax(mesh_2x2):
    """(b) The first step's loss, box and obj terms on every rank equal
    JAX's step on the whole batch; the bands' match counts differ."""
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_torch.models import weights as TW
    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_cfg
    from double_yolo_kaist_tpu.train import optim as JO
    from double_yolo_kaist_tpu.train import step as JS
    cy = [c for boxes in BOXES for _, c in boxes]
    assert sum(c < 0.5 for c in cy) != sum(c >= 0.5 for c in cy)
    assert 0.5 in cy
    jir = jax_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(jnp.asarray, TW.to_jax_variables(TG.init(tiny_ir(), 0)))
    jtx = JO.make_optimizer(HYP, JO.cosine_epoch_schedule(
        HYP["lr0"], HYP["lrf"], 3, 2), sgd=True)
    js = JS.create_train_state(jir, None, jtx, variables=jv)
    step = JS.make_train_step(jir, HYP, jtx, compute_dtype=jnp.float32,
                              donate=False)
    _, jm = step(js, {k: jnp.asarray(x) for k, x in train_batch().items()},
                 jax.random.PRNGKey(0))
    for r, got in enumerate(mesh_2x2):
        for k in ("loss", "box_loss", "obj_loss"):
            assert abs(float(got[f"b/m/{k}"]) - float(jm[k])) < 1e-4, (r, k)


def test_mini_flagship_forward_matches_one_process(mesh_2x2):
    """(c) The mini-flagship's SPP at stride 32 takes a 6-row halo from
    bands of 1 row; every rank's rows equal JAX's one device and the
    port's one process; every conv output on the band stays
    channels-last."""
    from double_yolo_kaist_tpu.models import builder as JB
    ir = build_mini_flagship(img_size=HW)
    v = TG.init(ir, 0)
    one = forward(ir, v, *images(1))
    jax_want = jax_forward(JB.build_mini_flagship(img_size=HW), v,
                           *images(1))
    for r, got in enumerate(mesh_2x2):
        for who, want in (("JAX", jax_want), ("one process", one)):
            np.testing.assert_allclose(got["c/out"], _rows(want, r, 2, 2),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"rank {r} vs {who}")
        assert got["c/channels_last"].size and got["c/channels_last"].all()


def test_mini_flagship_float64_step_matches_one_process(mesh_2x2):
    """(d) Loss, metrics, params, BN state and momentum traces of every
    rank within 1e-9 of one process's step on the whole batch."""
    one = first_step(build_mini_flagship(img_size=HW), torch.float64)
    for r, got in enumerate(mesh_2x2):
        for k, want in one.items():
            a = got[f"d/{k}"]
            assert a.shape == want.shape, (r, k)
            scale = max(np.abs(want).max(initial=0.0), 1e-300)
            assert np.abs(a - want).max(initial=0.0) <= 1e-9 * scale, (r, k)
        assert int(got["halos"]) > 0


@pytest.mark.parametrize("tag, cfg", [("e", MNV3), ("f", SEINC)],
                         ids=["mnv3-dwconv-se", "seinc-inception"])
def test_forward_on_two_bands_matches_one_process(mesh_1x2, tag, cfg):
    """(e) MNv3 (stride-2 dwconv, SE) and (f) the inception cfg at mesh
    (1, 2), against JAX's one device and the port's one process."""
    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_cfg
    ir = compile_cfg(cfg)
    v = TG.init(ir, 0)
    one = forward(ir, v, *images(2, n=1))
    jax_want = jax_forward(jax_cfg(cfg), v, *images(2, n=1))
    for r, got in enumerate(mesh_1x2):
        for who, want in (("JAX", jax_want), ("one process", one)):
            np.testing.assert_allclose(got[tag], want, rtol=2e-4, atol=2e-4,
                                       err_msg=f"rank {r} vs {who}")


def _one_band_of_two():
    """A shard that raises before any collective would run."""
    return SP.SpaceShard(d=0, s=0, D=1, S=2)


def test_refusals_name_the_node():
    """(g) A band that the deepest stride cannot split raises naming the
    node, before any collective; so do an avgpool whose bins cross the
    bands, a node reading a global avgpool's map, and K > 1 steps a
    dispatch on the 2-D path."""
    ir = tiny_ir()
    v = TG.init(ir, 0)
    x = torch.zeros(1, 20, 64, 3)             # a band of 20 rows of 40
    with pytest.raises(ValueError, match=r"l\d+ \(conv, stride 2\): a band "
                       r"of 20 input rows \(2 bands\) does not split at "
                       r"stride 8"):
        TG.apply(ir, v, x, x, train=True, space=_one_band_of_two())

    def node(i, kind, **kw):
        base = dict(index=i, kind=kind, inputs=(), stride=(1, 1),
                    takes_second_input=False, out_size=1, scale=1)
        return types.SimpleNamespace(**{**base, **kw})

    two = types.SimpleNamespace(nodes=[node(0, "conv"),
                                       node(1, "avgpool", out_size=2)])
    with pytest.raises(ValueError, match=r"l1 \(avgpool to 2 x 2\)"):
        SP.check_bands(two, 32, 2)
    glob = types.SimpleNamespace(nodes=[node(0, "conv"), node(1, "avgpool"),
                                        node(2, "conv")])
    with pytest.raises(ValueError, match=r"l2 \(conv\) reads the 1 x 1 map"):
        SP.check_bands(glob, 32, 2)
    SP.check_bands(ir, 32, 2)

    tx = TO.make_optimizer(HYP, lambda c: torch.tensor(1e-3), sgd=True)
    multi = TS.make_multi_step(ir, HYP, tx, compute_dtype=torch.float32,
                               space=_one_band_of_two())
    with pytest.raises(ValueError, match="ROADMAP.md"):
        multi(None, {"v": torch.zeros(2, 1, 32, 64, 3)})


def test_halo_rows_without_neighbours_pads_and_keeps_layout():
    """One band of one: the halo is the padding (0 or -inf), the layout
    channels-last, and the gradient of the padding rows is dropped."""
    shard = SP.SpaceShard(d=0, s=0, D=1, S=1)
    x = torch.rand(2, 3, 5, 4).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = SP.halo_rows(x, 2, 1, shard, float("-inf"))
    assert y.shape == (2, 3, 8, 4)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y[:, :, 2:7], x)
    assert torch.isinf(y[:, :, :2]).all() and torch.isinf(y[:, :, 7:]).all()
    y[:, :, 2:7].sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert SP.halo_rows(x, 0, 0, shard) is x
    assert SP.conv_rows(x, 3, (2, 2), 1, None) == (x, 1)


def test_halo_plan_takes_rows_from_several_neighbours():
    """A 6-row halo over bands of 1 row (the SPP at stride 32, S = 2) and
    over bands of 2 (S = 4): each row comes from its owner, rows beyond
    the image are padding."""
    plan = SP._halo_plan(2, 1, 6, 6)
    assert plan == [(1, 0, 1, 6, 0), (0, 1, 1, 5, 0)]
    plan = SP._halo_plan(4, 2, 3, 3)
    got = {t: sorted((u, n, j, r) for u, tt, n, j, r in plan if tt == t)
           for t in range(4)}
    # band 1 (rows 2-3) reads rows -1..1 (band 0's rows 0, 1) and 4..6
    # (band 2's rows 0, 1 and band 3's row 0)
    assert got[1] == [(0, 2, 1, 0), (2, 2, 3, 0), (3, 1, 5, 0)]
    assert got[0] == [(1, 2, 3, 0), (2, 1, 5, 0)]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
