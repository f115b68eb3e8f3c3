"""The train augment's ``matmul`` route (JAX's default), its chunks and its
bf16 pixels, against the JAX package on the CPU, from the same seeded
uint8 frames and labels with every random passed explicitly (the two
frameworks cannot share draws).

Tolerances, and why:
  * the port's ``matmul`` route against JAX's, fp32 pixels: the same
    interpolation matrices (built with JAX's numpy code) and fp32 products;
    the two BLAS may sum a row's two taps in another order (an fp32 ulp),
    so pixels on the 0-255 scale within 1e-3; labels within 1e-5, masks
    exact; the port's mosaic paste (a take, on both routes) against JAX's
    ``mosaic_place_mm``: its 0 / 1 matrices move pixels exactly: equal;
  * bf16 pixels: the products run on the bf16 values in fp32 and round
    once, on both sides, so the ulps above can tip that rounding: pixels
    within one bf16 ulp of the value;
  * with CLAHE (under the snowflake cutout): rounding the pixels to uint8
    for CLAHE can tip a value that sits on .5 by one level (the resize
    puts a quarter of them on .5 here), and a tile's LUT carries that
    level to its neighbours: as the gather route is held
    (``test_torch_augment.py``), a share of the pixels may lie beyond
    1e-3 (fp32) or one bf16 ulp (bf16): at most 1% (measured 0.68% and
    0.02% of v and l in fp32, none in bf16), none by 2 levels or more
    (measured 0.92 and 1.00) and a mean below 0.02 of a level (measured
    1.1e-3 and 9.8e-3);
  * the port's ``matmul`` route against its own ``gather`` route: JAX's
    own bounds (``tests/test_augment_mm.py:110-122``): on the [0, 1]
    output atol 2.5/255 (8/255 in bf16, 10/255 with CLAHE), the 99.9th
    percentile within 1.5/255 (3/255 in bf16 or with CLAHE), the mean
    below 0.2/255 (0.5/255 in bf16); labels and masks equal;
  * chunked against unchunked, with and without ``shard=`` and the pool:
    each chunk runs the unchunked ops on its rows: equal;
  * the defaults (no ``DYK_AUG_*`` variable): the whole function, chunked
    by 8, against JAX's default route at 1e-3 as above; with
    ``DYK_AUG_RESAMPLE=gather DYK_AUG_CHUNK=0`` the port's output is the
    plain gather route's, unchunked: equal;
  * the ``cuda`` cases (the card's run; they skip here): the route on the
    card against the CPU, pixels within 1e-3 in fp32 (one bf16 ulp in
    bf16), labels within 1e-5, masks exact; chunked against unchunked on
    the card within the same bounds (cuBLAS may pick another algorithm
    for another batch count); and with TF32 on the route refuses to run
    on the card.
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.data import augment as TA
from double_yolo_kaist_torch.data import letterbox as TLB
from double_yolo_kaist_torch.data import pipeline as TP

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.data import augment as JA
    from double_yolo_kaist_tpu.data import pipeline as JP
    from tests.test_torch_augment import (KAIST_HYP, S, SRC, _train_draws,
                                          frames, norm_labels,
                                          xyxy_labels)
except ModuleNotFoundError:
    jax = None
    S, SRC = 64, (64, 96)
    KAIST_HYP = {"hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36,
                 "degrees": 0.0, "translate": 0.0, "scale": 0.0,
                 "shear": 0.0}

    def frames(seed, n, hw=SRC):
        return np.random.default_rng(seed).integers(
            0, 256, (n,) + hw + (3,), dtype=np.uint8)

    def norm_labels(seed, n, n_t=3):
        rng = np.random.default_rng(seed)
        lab = np.zeros((n, n_t, 5), np.float32)
        lab[:, :, 1:3] = rng.uniform(0.2, 0.8, (n, n_t, 2))
        lab[:, :, 3:5] = rng.uniform(0.1, 0.4, (n, n_t, 2))
        return lab, np.ones((n, n_t), bool)

SCALE_HYP = dict(KAIST_HYP, translate=0.1, scale=0.5)
PIX = {"f32": (torch.float32, "float32"), "bf16": (torch.bfloat16,
                                                  "bfloat16")}


def t(a):
    return torch.from_numpy(np.array(a))


def f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a, np.float32).astype(np.float64)


def bf16_ulp(a, b):
    """One bf16 ulp at the larger magnitude of each pair."""
    m = np.maximum(np.abs(a), np.abs(b))
    return np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


def hold(got, want, pix, tol=1e-3, share=0.0):
    """``got`` against ``want``: within ``tol`` (fp32) or one bf16 ulp
    (bf16), all of them, or all but a ``share`` of them."""
    g, w = f64(got), f64(want)
    d = np.abs(g - w)
    bound = tol if pix == "f32" else bf16_ulp(g, w)
    out = d > bound
    assert out.mean() <= share, (pix, float(d.max()), float(out.mean()))


# ------------------------------------------------------- the three stages

@pytest.mark.parametrize("pix", ["f32", "bf16"])
def test_resize_bilinear_mm_matches_jax(pix):
    td, jd = PIX[pix]
    x = frames(0, 6)
    for hw in ((42, 64), (80, 120)):               # down and up
        got = TA.resize_bilinear_mm(t(x), *hw, dtype=td)
        assert got.dtype == td and tuple(got.shape) == (6,) + hw + (3,)
        want = jax.jit(JA.resize_bilinear_mm, static_argnums=(1, 2, 3))(
            jnp.asarray(x), *hw, jd)
        hold(got, want, pix)
        if pix == "f32":       # JAX's bound of its own two routes
            hold(got, TLB.resize_bilinear(t(x), *hw), pix)
    # the gather form in bf16 is JAX's too
    hold(TLB.resize_bilinear(t(x), 42, 64, dtype=td),
         jax.jit(JA.resize_bilinear, static_argnums=(1, 2, 3))(
             jnp.asarray(x), 42, 64, jd), pix)


def _mosaic_inputs(seed, b=3):
    v4 = frames(seed, 4 * b, (42, 64)).reshape(b, 4, 42, 64, 3)
    l4 = frames(seed + 1, 4 * b, (42, 64)).reshape(b, 4, 42, 64, 3)
    lab, m = xyxy_labels(seed, 4 * b, 3, (42, 64))
    centers = np.random.default_rng(seed).integers(S // 2, 3 * S // 2 + 1,
                                                   (b, 2))
    return v4, l4, lab.reshape(b, 4, 3, 5), m.reshape(b, 4, 3), centers


@pytest.mark.parametrize("pix", ["f32", "bf16"])
def test_mosaic_place_mm_matches_jax(pix):
    """JAX's matmul route pastes by 0 / 1 matrices: the port's take (on
    both routes) gives its canvas exactly."""
    td, jd = PIX[pix]
    v4, l4, lab, m, centers = _mosaic_inputs(1)
    v4, l4 = v4.astype(np.float32), l4.astype(np.float32)
    got = TA.mosaic_place(t(v4).to(td), t(l4).to(td), t(lab), t(m),
                          t(centers), S)
    want = jax.jit(JA.mosaic_place_mm, static_argnums=5)(
        jnp.asarray(v4, jd), jnp.asarray(l4, jd), jnp.asarray(lab),
        jnp.asarray(m), jnp.asarray(centers), S)
    for i in (0, 1):
        assert got[i].dtype == td
        np.testing.assert_array_equal(f64(got[i]), f64(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("pix", ["f32", "bf16"])
def test_random_affine_matmul_matches_jax(pix):
    td, jd = PIX[pix]
    img = frames(5, 3, (128, 128)).astype(np.float32)
    img2 = frames(6, 3, (128, 128)).astype(np.float32)
    lab, m = xyxy_labels(5, 3, 6, (128, 128))
    Ms = JA._affine_matrices(jax.random.PRNGKey(2), 3, (128, 128),
                             0.0, 0.1, 0.5, 0.0, -32)
    # KAIST's shift and a random scale (the inverse then JAX's own)
    affine = jax.jit(lambda a, b, c, d, M, sc: JA.random_affine_batch(
        None, a, b, c, d, border=-32, Ms=(M, sc), separable=True,
        resample="matmul"))
    for M, sc in ((Ms[0].at[:, :2, :2].set(jnp.eye(2)), jnp.ones(3)), Ms):
        want = affine(jnp.asarray(img, jd), jnp.asarray(img2, jd),
                      jnp.asarray(lab), jnp.asarray(m), M, sc)
        args = (t(img).to(td), t(img2).to(td), t(lab), t(m))
        kw = dict(border=-32, Ms=(t(M), t(sc)), separable=True)
        got = TA.random_affine_batch(None, *args, resample="matmul", **kw)
        gat = TA.random_affine_batch(None, *args, **kw)
        # the port's inverse of a scaling M may differ from JAX's by an
        # ulp: the matrices are built from the port's, the pixels held
        # as the gather route is (test_torch_augment.py)
        tol = 1e-3 if sc is not Ms[1] else 1e-2
        for i in (0, 1):
            assert got[i].dtype == td
            hold(got[i], want[i], pix, tol=tol)
            if pix == "f32":
                hold(got[i], gat[i], pix)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert torch.equal(got[2], gat[2]) and torch.equal(got[3], gat[3])


# ------------------------------------------------------ the whole augment

@pytest.mark.parametrize("pix,snow", [("bf16", False), ("f32", True),
                                      ("bf16", True)],
                         ids=["bf16", "snow+clahe-f32", "snow+clahe-bf16"])
def test_train_augment_matmul_matches_jax(pix, snow):
    """The whole function from JAX's draws (fp32 without the cutout and
    CLAHE: test_defaults_are_jax_default_route)."""
    td, jd = PIX[pix]
    nb, clahe = 2, snow
    v, l = frames(12, 4 * nb), frames(13, 4 * nb)
    lab, m = norm_labels(12, 4 * nb)
    key = jax.random.PRNGKey(11)
    want = JP.make_train_augment_fn(SRC, S, SCALE_HYP, snowflake=snow,
                                    clahe=clahe, chunk=0,
                                    resample="matmul", pix_dtype=jd)(
        key, jnp.asarray(v), jnp.asarray(l), jnp.asarray(lab),
        jnp.asarray(m))
    tfn = TP.make_train_augment_fn(SRC, S, SCALE_HYP, snowflake=snow,
                                   clahe=clahe, resample="matmul",
                                   pix_dtype=td)
    got = tfn.heavy(t(v), t(l), t(lab), t(m),
                    **_train_draws(key, nb, SCALE_HYP, snowflake=snow))
    for name in ("v", "l"):
        assert got[name].dtype == td
        assert tuple(got[name].shape) == (nb, S, S, 3)
        if clahe:
            g = f64(got[name]) * 255
            w = np.asarray(want[name], np.float32).astype(np.float64) * 255
            d = np.abs(g - w)
            far = d > (1e-3 if pix == "f32" else bf16_ulp(g, w))
            print(f"matmul+CLAHE vs JAX, {pix} {name}: share beyond the "
                  f"bound {far.mean():.5f}, largest {d.max():.4f}, mean "
                  f"{d.mean():.2e} levels")
            hold(g, w, pix, share=0.01)
            assert d.max() < 2 and d.mean() < 0.02, (d.max(), d.mean())
        else:
            # SCALE_HYP: the port inverts the affine itself, an ulp off
            # JAX's (test_torch_augment.py holds the gather route so)
            hold(got[name] * 255, np.asarray(want[name], np.float32) * 255,
                 pix, tol=1e-2)
    np.testing.assert_allclose(got["targets"].numpy(),
                               np.asarray(want["targets"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["tmask"].numpy(),
                                  np.asarray(want["tmask"]))


@pytest.mark.parametrize("pix,clahe", [("f32", False), ("bf16", False),
                                       ("f32", True)])
def test_matmul_route_within_jax_bounds_of_gather(pix, clahe):
    """The port's two routes from the same randoms, held as JAX holds its
    own two (tests/test_augment_mm.py:110-122)."""
    td, _ = PIX[pix]
    src = (128, 160)
    rng = np.random.default_rng(7)
    v = t(rng.integers(0, 256, (8,) + src + (3,), dtype=np.uint8))
    l = t(rng.integers(0, 256, (8,) + src + (3,), dtype=np.uint8))
    lab, m = norm_labels(8, 8)
    out = {}
    for route in ("gather", "matmul"):
        fn = TP.make_train_augment_fn(src, 64, SCALE_HYP, snowflake=clahe,
                                      clahe=clahe, pix_dtype=td,
                                      resample=route)
        out[route] = fn(torch.Generator().manual_seed(4), v, l, t(lab),
                        t(m))
    ga, mm = out["gather"], out["matmul"]
    assert torch.equal(ga["targets"], mm["targets"])
    assert torch.equal(ga["tmask"], mm["tmask"])
    for k in ("v", "l"):
        _jax_bounds(ga[k], mm[k], pix == "bf16", clahe)


def _jax_bounds(a, b, bf16: bool, clahe: bool):
    """JAX's bounds of its matmul route against its gather route on the
    [0, 1] output (tests/test_augment_mm.py:110-122)."""
    d = np.abs(f64(b) - f64(a))
    atol = 10 / 255 if clahe else (8 / 255 if bf16 else 2.5 / 255)
    assert d.max() <= atol, d.max()
    q = 3.0 / 255 if (clahe or bf16) else 1.5 / 255
    assert np.quantile(d, 0.999) <= q
    assert d.mean() < (0.5 if bf16 else 0.2) / 255


# ---------------------------------------------------- chunks and defaults

@pytest.mark.parametrize("shard,from_pool", [(None, False), ((1, 2), False),
                                             ((1, 2), True)],
                         ids=["one", "shard", "shard-pool"])
def test_chunked_equals_unchunked(shard, from_pool):
    """nb 8 and chunk 3 (a non-divisor: chunks of 2; a rank's 4 rows:
    chunks of 2 too); the rank's rows are the one-process batch's."""
    nb = 8
    v, l = frames(21, 4 * nb), frames(22, 4 * nb)
    lab, m = norm_labels(21, 4 * nb)
    assert TP.chunk_size(8, 3) == 2 and TP.chunk_size(4, 3) == 2
    assert TP.chunk_size(5, 8) == 5 and TP.chunk_size(10, 8) == 5
    assert TP.chunk_size(8, 0) == 8
    load = torch.arange(4 * nb).flip(0)
    if from_pool:
        pv, pl = t(v).flip(0), t(l).flip(0)   # row load[i] is image i
        args = (pv, pl, load, t(lab), t(m))
    else:
        args = (t(v), t(l), t(lab), t(m))
    outs = {}
    for chunk in (0, 3):
        fn = TP.make_train_augment_fn(SRC, S, SCALE_HYP, chunk=chunk,
                                      shard=shard, from_pool=from_pool,
                                      resample="matmul")
        outs[chunk] = fn(torch.Generator().manual_seed(5), *args)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[3][k]), k
    if shard is not None:
        whole = TP.make_train_augment_fn(SRC, S, SCALE_HYP, chunk=3)(
            torch.Generator().manual_seed(5), t(v), t(l), t(lab), t(m))
        for k in whole:
            assert torch.equal(outs[3][k], whole[k][4:]), k


def _clear_env(monkeypatch):
    for k in ("DYK_AUG_RESAMPLE", "DYK_AUG_CHUNK", "DYK_AUG_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def test_defaults_are_jax_default_route(monkeypatch):
    """No DYK_AUG_* variable: matmul, chunks of 8, fp32 pixels; the whole
    function (a batch of 10: two chunks of 5) against JAX's default."""
    _clear_env(monkeypatch)
    nb = 10
    v, l = frames(31, 4 * nb), frames(32, 4 * nb)
    lab, m = norm_labels(31, 4 * nb)
    key = jax.random.PRNGKey(13)
    want = JP.make_train_augment_fn(SRC, S, KAIST_HYP)(
        key, jnp.asarray(v), jnp.asarray(l), jnp.asarray(lab),
        jnp.asarray(m))
    fn = TP.make_train_augment_fn(SRC, S, KAIST_HYP)
    assert (fn.resample, fn.chunk, fn.pix_dtype) == ("matmul", 8,
                                                     torch.float32)
    draws = _train_draws(key, nb, KAIST_HYP)
    fn.draw = lambda generator, n: draws
    got = fn(None, t(v), t(l), t(lab), t(m))
    for name in ("v", "l"):
        hold(got[name] * 255, np.asarray(want[name]) * 255, "f32")
    np.testing.assert_allclose(got["targets"].numpy(),
                               np.asarray(want["targets"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["tmask"].numpy(),
                                  np.asarray(want["tmask"]))


def test_env_switches(monkeypatch):
    """DYK_AUG_RESAMPLE=gather DYK_AUG_CHUNK=0 gives the gather route
    unchunked in fp32 (the port's output before the matmul route);
    DYK_AUG_DTYPE=bf16 selects bf16 pixels; an unknown route raises; an
    argument beats the variable."""
    _clear_env(monkeypatch)
    nb = 4
    v, l = frames(41, 4 * nb), frames(42, 4 * nb)
    lab, m = norm_labels(41, 4 * nb)
    args = (t(v), t(l), t(lab), t(m))
    plain = TP.make_train_augment_fn(SRC, S, SCALE_HYP, resample="gather",
                                     chunk=0, pix_dtype=torch.float32)(
        torch.Generator().manual_seed(2), *args)
    monkeypatch.setenv("DYK_AUG_RESAMPLE", "gather")
    monkeypatch.setenv("DYK_AUG_CHUNK", "0")
    fn = TP.make_train_augment_fn(SRC, S, SCALE_HYP)
    assert (fn.resample, fn.chunk, fn.pix_dtype) == ("gather", 0,
                                                     torch.float32)
    got = fn(torch.Generator().manual_seed(2), *args)
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
    monkeypatch.setenv("DYK_AUG_DTYPE", "bfloat16")
    assert TP.make_train_augment_fn(SRC, S, SCALE_HYP).pix_dtype == \
        torch.bfloat16
    assert TP.make_train_augment_fn(SRC, S, SCALE_HYP, resample="matmul",
                                    chunk=2).resample == "matmul"
    monkeypatch.setenv("DYK_AUG_RESAMPLE", "nearest")
    with pytest.raises(ValueError, match="resample"):
        TP.make_train_augment_fn(SRC, S, SCALE_HYP)


def test_tf32_check_reads_both_switches():
    """The matmul resample's TF32 check reads the legacy switch (which
    ``set_float32_matmul_precision`` sets) and the per-backend one; on
    the CPU the switches do not apply and the route runs."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    x = t(frames(0, 2))
    want = TA.resize_bilinear_mm(x, 42, 64)
    try:
        m.allow_tf32 = False
        assert not TLB._tf32_matmul_on()
        torch.set_float32_matmul_precision("high")
        assert TLB._tf32_matmul_on()
        assert torch.equal(TA.resize_bilinear_mm(x, 42, 64), want)
        torch.set_float32_matmul_precision("highest")
        m.fp32_precision = "tf32"
        assert TLB._tf32_matmul_on()
        m.fp32_precision = "ieee"
        assert not TLB._tf32_matmul_on()
    finally:
        m.fp32_precision = "none"
        m.allow_tf32 = prev


# ------------------------------------------------------------- the card

def _card_inputs(nb=4, src=(128, 160)):
    v, l = frames(14, 4 * nb, src), frames(15, 4 * nb, src)
    lab, m = norm_labels(14, 4 * nb)
    return v, l, lab, m


@pytest.mark.cuda
@pytest.mark.parametrize("pix", ["f32", "bf16"])
def test_matmul_augment_card_matches_cpu(pix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td, _ = PIX[pix]
    v, l, lab, m = _card_inputs()
    fn = TP.make_train_augment_fn((128, 160), 128, SCALE_HYP,
                                  resample="matmul", pix_dtype=td)
    out = {dev: fn(torch.Generator().manual_seed(9),
                   *(t(a).to(dev) for a in (v, l, lab, m)))
           for dev in ("cuda", "cpu")}
    got, want = out["cuda"], out["cpu"]
    for k in ("v", "l"):
        # the card inverts the scaling affine itself: 1e-2 as in
        # test_torch_augment.py's card case
        hold(got[k].cpu() * 255, want[k] * 255, pix, tol=1e-2)
    np.testing.assert_allclose(got["targets"].cpu().numpy(),
                               want["targets"].numpy(), rtol=0, atol=1e-5)
    assert torch.equal(got["tmask"].cpu(), want["tmask"])


@pytest.mark.cuda
@pytest.mark.parametrize("pix", ["f32", "bf16"])
def test_chunked_equals_unchunked_on_card(pix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td, _ = PIX[pix]
    v, l, lab, m = _card_inputs(nb=8)
    outs = {}
    for chunk in (0, 3):
        fn = TP.make_train_augment_fn((128, 160), 128, SCALE_HYP,
                                      chunk=chunk, pix_dtype=td)
        outs[chunk] = fn(torch.Generator().manual_seed(9),
                         *(t(a).cuda() for a in (v, l, lab, m)))
    for k in ("v", "l"):
        hold(outs[3][k].cpu() * 255, outs[0][k].cpu() * 255, pix)
    assert torch.equal(outs[3]["targets"], outs[0]["targets"])
    assert torch.equal(outs[3]["tmask"], outs[0]["tmask"])


@pytest.mark.cuda
def test_matmul_route_refuses_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = t(frames(0, 6, (512, 640))).cuda()
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    try:
        m.allow_tf32 = False
        want = TA.resize_bilinear_mm(x, 409, 512)
        m.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            TA.resize_bilinear_mm(x, 409, 512)
        m.allow_tf32 = False
        assert torch.equal(TA.resize_bilinear_mm(x, 409, 512), want)
    finally:
        m.allow_tf32 = prev
