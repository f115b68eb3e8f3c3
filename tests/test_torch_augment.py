"""The port's train-time augmentation and batch plan against the JAX
package on the CPU, from the same seeded uint8 frames and labels with
every random passed explicitly (the two frameworks cannot share draws).

Tolerances, and why:
  * against JAX's ``gather`` route (the port's too): the same
    fp32 formulas in the same order, run eagerly on both sides: pixels
    (0-255) within 1e-3, labels within 1e-5, masks exact. Where the port
    inverts a random (scaled or rotating) affine itself, the two fp32
    inverses may differ by an ulp: pixels within 1e-2 there; the
    end-to-end case with rotation and shear within 5e-3;
  * the port's gather forms against JAX's default ``matmul`` route: within
    1 u8 LSB (1.0), labels within 1e-5; the whole augment on each route
    against JAX's on the same route (pixels within 1e-3 on the kaist hyp,
    5e-3 with rotation and shear, as above); the port's own ``matmul``
    route is held in ``tests/test_torch_aug_matmul.py``;
  * ``train_batch_plan`` is numpy on both sides: identical;
  * CLAHE: byte for byte JAX's ``clahe_batch`` (random, low-contrast,
    constant and peaked frames, a shape off the tile grid), and against
    cv2 to the bounds JAX's own test holds JAX to; the snowflake cutout
    given the same uniforms: masks, images and kept labels exactly;
  * the train augment with the cutout and / or CLAHE: the pixels before
    CLAHE agree to 1e-3 as above, and rounding them to uint8 for CLAHE can
    tip a value that sits on .5 by one level, which CLAHE's LUT can
    widen: so at most 0.5% of pixels differ, labels within 1e-5 and masks
    exact;
  * the ``cuda`` case (the card's run; it skips here): the augment program
    on the card against the CPU from one generator seed: pixels within
    1e-3 of 0-255 with KAIST's hyp (the card divides by 255 as a product
    with the reciprocal), within 1e-2 with a rotating one (the card
    inverts the affine otherwise, as above), labels within 1e-5, masks
    exact.
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.data import augment as TA
from double_yolo_kaist_torch.data import clahe as TC
from double_yolo_kaist_torch.data import pipeline as TP
from double_yolo_kaist_torch.data.dataset import KaistDataset

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.data import augment as JA
    from double_yolo_kaist_tpu.data import pipeline as JP
    from double_yolo_kaist_tpu.data.clahe import clahe_batch as jax_clahe
    from tests.test_torch_dataset import (random_frames, random_labels,
                                          write_split)
except ModuleNotFoundError:
    jax = None

SRC = (64, 96)
S = 64
KAIST_HYP = {"hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36, "degrees": 0.0,
             "translate": 0.0, "scale": 0.0, "shear": 0.0}
WARP_HYP = dict(KAIST_HYP, degrees=10.0, translate=0.1, scale=0.5, shear=3.0)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def frames(seed, n, hw=SRC):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,),
                                                dtype=np.uint8)


def xyxy_labels(seed, b, n_t, hw):
    """(b, n_t, 5) absolute xyxy boxes inside ``hw`` and a partial mask."""
    rng = np.random.default_rng(seed)
    h, w = hw
    xy = rng.uniform(0, 0.7, (b, n_t, 2)) * [w, h]
    wh = rng.uniform(0.05, 0.3, (b, n_t, 2)) * [w, h]
    lab = np.concatenate([rng.integers(0, 3, (b, n_t, 1)), xy, xy + wh],
                         -1).astype(np.float32)
    return lab, rng.random((b, n_t)) < 0.7


def norm_labels(seed, n, n_t=3):
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, n_t, 5), np.float32)
    m = np.zeros((n, n_t), bool)
    for i in range(n):
        k = int(rng.integers(0, n_t + 1))
        lab[i, :k, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        lab[i, :k, 3:5] = rng.uniform(0.1, 0.4, (k, 2))
        m[i, :k] = True
    return lab, m


def test_resize_bilinear_matches_jax():
    x = frames(0, 6)
    want = JA.resize_bilinear(jnp.asarray(x), 42, 64)
    close(TA.resize_bilinear(t(x), 42, 64), want, 1e-3)
    close(TA.resize_bilinear(t(x), 42, 64),
          JA.resize_bilinear_mm(jnp.asarray(x), 42, 64), 1.0)


def _mosaic_inputs(seed, b=3):
    v4 = frames(seed, 4 * b, (42, 64)).reshape(b, 4, 42, 64, 3)
    l4 = frames(seed + 1, 4 * b, (42, 64)).reshape(b, 4, 42, 64, 3)
    lab, m = xyxy_labels(seed, 4 * b, 3, (42, 64))
    centers = np.random.default_rng(seed).integers(S // 2, 3 * S // 2 + 1,
                                                   (b, 2))
    return (v4.astype(np.float32), l4.astype(np.float32),
            lab.reshape(b, 4, 3, 5), m.reshape(b, 4, 3), centers)


def test_mosaic_place_matches_jax():
    v4, l4, lab, m, centers = _mosaic_inputs(1)
    want = JA.mosaic_place(*(jnp.asarray(a) for a in (v4, l4, lab, m,
                                                      centers)), S)
    got = TA.mosaic_place(t(v4), t(l4), t(lab), t(m), t(centers), S)
    close(got[0], want[0], 1e-3)
    close(got[1], want[1], 1e-3)
    close(got[2], want[2], 1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    mm = JA.mosaic_place_mm(*(jnp.asarray(a) for a in (v4, l4, lab, m,
                                                       centers)), S)
    close(got[0], mm[0], 1.0)
    close(got[2], mm[2], 1e-5)


def test_mosaic4_matches_jax():
    """Partners given, centres drawn by JAX and passed in."""
    b = 2
    v, l = frames(2, 4 * b, (42, 64)), frames(3, 4 * b, (42, 64))
    lab, m = xyxy_labels(2, 4 * b, 3, (42, 64))
    partners = b + np.arange(3 * b).reshape(b, 3)
    key = jax.random.PRNGKey(5)
    want = JA.mosaic4(key, jnp.asarray(v, jnp.float32),
                      jnp.asarray(l, jnp.float32), jnp.asarray(lab),
                      jnp.asarray(m), S, partner_idx=jnp.asarray(partners))
    centers = jax.random.randint(key, (b, 2), S // 2, 3 * S // 2 + 1)
    got = TA.mosaic4(None, t(v).float(), t(l).float(), t(lab), t(m), S,
                     partner_idx=t(partners), centers=t(centers))
    for g, w, tol in zip(got, want, (1e-3, 1e-3, 1e-5, 0)):
        close(g, w, tol)


def _jax_draws(key, b, src_hw, hyp, border):
    """JAX's _affine_matrices draws, as its code makes them."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d, tr, sc, sh = (hyp["degrees"], hyp["translate"], hyp["scale"],
                     hyp["shear"])
    draws = (jax.random.uniform(k1, (b,), minval=-d, maxval=d),
             jax.random.uniform(k2, (b,), minval=1 - sc, maxval=1 + sc),
             jax.random.uniform(k3, (b,), minval=-tr, maxval=tr),
             jax.random.uniform(k4, (b,), minval=-tr, maxval=tr),
             jax.random.uniform(k5, (b, 2), minval=-sh, maxval=sh))
    return [t(a) for a in draws]


@pytest.mark.parametrize("hyp", [KAIST_HYP, WARP_HYP], ids=["kaist", "warp"])
def test_affine_matrices_match_jax(hyp):
    key = jax.random.PRNGKey(7)
    M, s = JA._affine_matrices(key, 4, (128, 128), hyp["degrees"],
                               hyp["translate"], hyp["scale"], hyp["shear"],
                               -32)
    gM, gs = TA.affine_from_draws(*_jax_draws(key, 4, (128, 128), hyp, -32),
                                  (128, 128), -32)
    close(gM, M, 1e-5 * 128)
    close(gs, s, 1e-7)
    # drawn from a generator: the shape, and translations within bounds
    dM, ds = TA._affine_matrices(torch.Generator().manual_seed(0), 4,
                                 (128, 128), 0.0, 0.1, 0.5, 0.0, -32)
    assert dM.shape == (4, 3, 3) and ((ds >= 0.5) & (ds <= 1.5)).all()


@pytest.mark.parametrize("separable", [True, False])
def test_warp_matches_jax(separable):
    img = frames(4, 3, (128, 128))
    hyp = KAIST_HYP if separable else WARP_HYP
    M, _ = JA._affine_matrices(jax.random.PRNGKey(3), 3, (128, 128),
                               hyp["degrees"], 0.1, 0.5, hyp["shear"], -32)
    minv = jnp.linalg.inv(M)
    want = jax.vmap(lambda a, b: JA._warp_bilinear(
        a, b, 64, 64, separable=separable))(jnp.asarray(img), minv)
    got = TA._warp_bilinear(t(img), t(minv), 64, 64, separable=separable)
    close(got, want, 1e-3)


SCALE_HYP = dict(KAIST_HYP, translate=0.1, scale=0.5)


@pytest.mark.parametrize("hyp,pix", [(KAIST_HYP, 1e-3), (SCALE_HYP, 1e-2),
                                     (WARP_HYP, 1e-2)],
                         ids=["kaist", "scale", "warp"])
def test_random_affine_batch_matches_jax(hyp, pix):
    """The warp inverts M itself: with KAIST's hyp M is a shift and its
    inverse exact; with a random scale or rotation the two fp32 inverses
    may differ by an ulp, which moves a sample point by up to ~3e-5 px
    and a noise pixel by up to ~1e-2 (the warp itself, given one inverse,
    is held at 1e-3 above)."""
    img = frames(5, 3, (128, 128)).astype(np.float32)
    img2 = frames(6, 3, (128, 128)).astype(np.float32)
    lab, m = xyxy_labels(5, 3, 6, (128, 128))
    Ms = JA._affine_matrices(jax.random.PRNGKey(8), 3, (128, 128),
                             hyp["degrees"], hyp["translate"], hyp["scale"],
                             hyp["shear"], -32)
    sep = hyp["degrees"] == 0 and hyp["shear"] == 0
    want = JA.random_affine_batch(None, jnp.asarray(img), jnp.asarray(img2),
                                  jnp.asarray(lab), jnp.asarray(m),
                                  border=-32, Ms=Ms, separable=sep,
                                  resample="gather")
    got = TA.random_affine_batch(None, t(img), t(img2), t(lab), t(m),
                                 border=-32, Ms=(t(Ms[0]), t(Ms[1])),
                                 separable=sep)
    for g, w, tol in zip(got, want, (pix, pix, 1e-5, 0)):
        close(g, w, tol)
    if sep:
        mm = JA.random_affine_batch(None, jnp.asarray(img), jnp.asarray(img2),
                                    jnp.asarray(lab), jnp.asarray(m),
                                    border=-32, Ms=Ms, separable=True,
                                    resample="matmul")
        close(got[0], mm[0], 1.0 + pix)
        close(got[2], mm[2], 1e-5)
    with pytest.raises(ValueError, match="separable"):
        TA.random_affine_batch(None, t(img), t(img2), t(lab), t(m),
                               border=-32, Ms=(t(Ms[0]), t(Ms[1])))


def test_hsv_matches_jax():
    rng = np.random.default_rng(9)
    rgb = rng.random((2, 16, 16, 3)).astype(np.float32)
    rgb[0, 0, :4] = [[0.5, 0.5, 0.5], [1, 0, 0], [0, 0, 0], [0.2, 0.7, 0.7]]
    close(TA._rgb_to_hsv(t(rgb)), JA._rgb_to_hsv(jnp.asarray(rgb)), 1e-5)
    hsv = np.asarray(JA._rgb_to_hsv(jnp.asarray(rgb)))
    close(TA._hsv_to_rgb(t(hsv)), JA._hsv_to_rgb(jnp.asarray(hsv)), 1e-5)
    v = rng.random((3, 16, 16, 3)).astype(np.float32) * 255
    l = rng.random((3, 16, 16, 3)).astype(np.float32) * 255
    gains = (rng.uniform(-1, 1, (3, 3)) * [0.0138, 0.678, 0.36] + 1) \
        .astype(np.float32)
    want = JA.hsv_jitter(None, jnp.asarray(v), jnp.asarray(l), 0, 0, 0,
                         gains=jnp.asarray(gains))
    got = TA.hsv_jitter(None, t(v), t(l), 0, 0, 0, gains=t(gains))
    close(got[0], want[0], 1e-3)
    close(got[1], want[1], 1e-3)


def test_flip_and_label_formats_match_jax():
    v = frames(10, 4).astype(np.float32)
    l = frames(11, 4).astype(np.float32)
    lab, m = xyxy_labels(10, 4, 5, SRC)
    norm = JA.xyxy_to_norm_xywh(jnp.asarray(lab), jnp.asarray(m), SRC)
    gnorm = TA.xyxy_to_norm_xywh(t(lab), t(m), SRC)
    close(gnorm, norm, 1e-6)
    do = np.array([True, False, True, False])
    want = JA.flip_lr(None, jnp.asarray(v), jnp.asarray(l), norm,
                      do=jnp.asarray(do))
    got = TA.flip_lr(None, t(v), t(l), gnorm, do=t(do))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


def _train_draws(key, nb, hyp, snowflake=False):
    """The randoms of JAX's make_train_augment_fn ``fn``, as it draws them
    (epoch partners)."""
    k_mosaic, k_cut, k_affine, k_hsv, k_flip = jax.random.split(key, 5)
    centers = jax.random.randint(k_mosaic, (nb, 2), S // 2, 3 * S // 2 + 1)
    Ms = JA._affine_matrices(k_affine, nb, (2 * S, 2 * S), hyp["degrees"],
                             hyp["translate"], hyp["scale"], hyp["shear"],
                             -S // 2)
    hsv_r = (jax.random.uniform(k_hsv, (nb, 3), minval=-1.0, maxval=1.0)
             * jnp.asarray([hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]])
             + 1.0)
    do = jax.random.bernoulli(k_flip, 0.5, (nb,))
    idx = np.concatenate([np.arange(nb)[:, None],
                          nb + np.arange(3 * nb).reshape(nb, 3)], 1)
    cut_u = (t(jax.random.uniform(k_cut, (nb, TP.N_SNOW, 2)))
             if snowflake else None)
    return {"idx": t(idx), "centers": t(centers), "cut_u": cut_u,
            "Ms": (t(Ms[0]), t(Ms[1])), "hsv_r": t(hsv_r), "do": t(do)}


@pytest.mark.parametrize("hyp,pix", [(KAIST_HYP, 1e-3), (WARP_HYP, 5e-3)],
                         ids=["kaist", "warp"])
def test_train_augment_fn_matches_jax(hyp, pix):
    nb = 2
    v, l = frames(12, 4 * nb), frames(13, 4 * nb)
    lab, m = norm_labels(12, 4 * nb)
    key = jax.random.PRNGKey(11)
    args = (jnp.asarray(v), jnp.asarray(l), jnp.asarray(lab), jnp.asarray(m))
    for route in ("gather", "matmul"):
        tfn = TP.make_train_augment_fn(SRC, S, hyp, resample=route)
        got = tfn.heavy(t(v), t(l), t(lab), t(m),
                        **_train_draws(key, nb, hyp))
        want = JP.make_train_augment_fn(SRC, S, hyp, chunk=0, jit=False,
                                        resample=route)(key, *args)
        assert got["v"].shape == (nb, S, S, 3)
        assert got["targets"].shape == (nb, 12, 5)
        close(got["v"] * 255, np.asarray(want["v"]) * 255, pix)
        close(got["l"] * 255, np.asarray(want["l"]) * 255, pix)
        close(got["targets"], want["targets"], 1e-5)
        np.testing.assert_array_equal(got["tmask"].numpy(),
                                      np.asarray(want["tmask"]))
    # drawn from a generator: reproducible from its seed, in range
    a = tfn(torch.Generator().manual_seed(3), t(v), t(l), t(lab), t(m))
    b = tfn(torch.Generator().manual_seed(3), t(v), t(l), t(lab), t(m))
    assert torch.equal(a["v"], b["v"]) and torch.equal(a["targets"],
                                                       b["targets"])
    assert 0 <= float(a["v"].min()) and float(a["v"].max()) <= 1


# ------------------------------------------------------- CLAHE and cutout

def clahe_frames(kind, shape, seed):
    """uint8 frames: ``random``; ``low`` contrast (12 levels); ``constant``;
    ``peaked`` (two values, so that each tile clips a large excess whose
    residual exercises cv2's bump of every step-th bin)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "low":
        return (100 + rng.integers(0, 12, shape)).astype(np.uint8)
    if kind == "constant":
        return np.full(shape, 77, np.uint8)
    return np.where(rng.random(shape) < 0.9, 40, 200).astype(np.uint8)


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), (2, 62, 78, 3)],
                         ids=["64x80", "62x78"])
@pytest.mark.parametrize("kind", ["random", "low", "constant", "peaked"])
def test_clahe_equals_jax(kind, shape):
    x = clahe_frames(kind, shape, 21)
    got = TC.clahe_batch(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_clahe(jnp.asarray(x))))
    if kind == "peaked":                       # the bump rule is exercised
        tile = x[0, :shape[1] // 4, :shape[2] // 4, 0].reshape(-1)
        hist = np.bincount(tile, minlength=256)
        limit = max(int(tile.size / 256.0), 1)
        excess = int((hist - np.minimum(hist, limit)).sum())
        assert excess % 256 != 0


@pytest.mark.parametrize("hw,mean,p99", [((64, 64), 1.5, 4),
                                         ((42, 63), 1.0, 2)])
def test_clahe_against_cv2(hw, mean, p99):
    """The bounds tests/test_augment.py holds the JAX package's CLAHE to
    against cv2 (divisible and reflect-extended shapes)."""
    import cv2
    img = np.random.default_rng(2).integers(0, 256, hw + (3,),
                                            dtype=np.uint8)
    op = cv2.createCLAHE(clipLimit=1.0, tileGridSize=(4, 4))
    ref = np.stack([op.apply(np.ascontiguousarray(img[..., c]))
                    for c in range(3)], -1)
    got = TC.clahe_batch(torch.from_numpy(img[None]))[0].numpy()
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert np.mean(diff) < mean and np.quantile(diff, 0.99) <= p99


def _cutout_inputs(seed, b=3, n_t=8, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    v = rng.uniform(1, 255, (b,) + hw + (3,)).astype(np.float32)
    l = rng.uniform(1, 255, (b,) + hw + (3,)).astype(np.float32)
    lab, _ = xyxy_labels(seed, b, n_t, hw)
    m = np.zeros((b, n_t), bool)
    for i, k in enumerate((2, 6, 7)):   # 6 = n_thr: active; 7: not
        m[i, :k] = True
    return v, l, lab, m


@pytest.mark.parametrize("step,n_snow", [(16, 25), (32, 80)])
def test_snowflake_cutout_equals_jax(step, n_snow):
    v, l, lab, m = _cutout_inputs(5)
    u = np.random.default_rng(6).random((3, n_snow, 2), dtype=np.float32)
    want = JA.snowflake_cutout(None, jnp.asarray(v), jnp.asarray(l),
                               jnp.asarray(lab), jnp.asarray(m), n_thr=6,
                               step=step, n_snow=n_snow, u=jnp.asarray(u))
    got = TA.snowflake_cutout(None, t(v), t(l), t(lab), t(m), n_thr=6,
                              step=step, n_snow=n_snow, u=t(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cut = got[0].numpy() == 0
    assert cut[:2].any() and not cut[2].any()    # 7 labels > n_thr: none
    assert (got[2].numpy() != m).any()            # some label was dropped


@pytest.mark.parametrize("snow,clahe", [(True, False), (False, True),
                                        (True, True)],
                         ids=["snow", "clahe", "both"])
def test_train_augment_fn_cutout_clahe_match_jax(snow, clahe):
    nb = 2
    v, l = frames(16, 4 * nb), frames(17, 4 * nb)
    lab, m = norm_labels(16, 4 * nb)
    key = jax.random.PRNGKey(19)
    want = JP.make_train_augment_fn(SRC, S, KAIST_HYP, snowflake=snow,
                                    clahe=clahe, chunk=0, jit=False,
                                    resample="gather")(
        key, jnp.asarray(v), jnp.asarray(l), jnp.asarray(lab),
        jnp.asarray(m))
    tfn = TP.make_train_augment_fn(SRC, S, KAIST_HYP, snowflake=snow,
                                   clahe=clahe, resample="gather")
    got = tfn.heavy(t(v), t(l), t(lab), t(m),
                    **_train_draws(key, nb, KAIST_HYP, snowflake=snow))
    for name in ("v", "l"):
        d = np.abs(got[name].numpy() * 255 - np.asarray(want[name]) * 255)
        assert (d > 1e-3).mean() <= 0.005, (name, (d > 1e-3).mean())
    close(got["targets"], want["targets"], 1e-5)
    np.testing.assert_array_equal(got["tmask"].numpy(),
                                  np.asarray(want["tmask"]))


def test_draws_without_snow_unchanged():
    """The cutout stream is its own generator: a draw without --snow is
    the draw of before, and one with it moves no other random."""
    plain = TP.make_train_augment_fn(SRC, S, WARP_HYP).draw
    snow = TP.make_train_augment_fn(SRC, S, WARP_HYP, snowflake=True).draw
    a = plain(torch.Generator().manual_seed(4), 3)
    b = snow(torch.Generator().manual_seed(4), 3)
    assert a["cut_u"] is None and b["cut_u"].shape == (3, TP.N_SNOW, 2)
    for k in ("idx", "centers", "hsv_r", "do"):
        assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["Ms"], b["Ms"]))
    # the streams as seeded before the cutout's was drawn from
    seeds = torch.randint(0, 2 ** 62, (5,),
                          generator=torch.Generator().manual_seed(4))
    g_mosaic = torch.Generator().manual_seed(int(seeds[0]))
    assert torch.equal(a["centers"], torch.randint(S // 2, 3 * S // 2 + 1,
                                                   (3, 2),
                                                   generator=g_mosaic))
    g_flip = torch.Generator().manual_seed(int(seeds[4]))
    assert torch.equal(a["do"], torch.rand(3, generator=g_flip) < 0.5)


class _Labels:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.labels = [rng.random((int(rng.integers(0, 20)), 5))
                       .astype(np.float32) for _ in range(n)]

    def __len__(self):
        return len(self.labels)


@pytest.mark.parametrize("sizes,size_every", [([64], 1),
                                              ([64, 96, 128], 1),
                                              ([64, 96, 128], 3)])
def test_train_batch_plan_matches_jax(sizes, size_every):
    ds = _Labels(37, 4)
    for epoch in (0, 5):
        want = list(JP.train_batch_plan(ds, 4, sizes, seed_epoch=epoch,
                                        size_every=size_every))
        got = list(TP.train_batch_plan(ds, 4, sizes, seed_epoch=epoch,
                                       size_every=size_every))
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[5] == w[5]
            for a, b in zip(g[1:5], w[1:5]):
                np.testing.assert_array_equal(a, b)


def test_train_batches_on_a_split(tmp_path):
    rng = np.random.default_rng(6)
    path = write_split(tmp_path, random_frames(rng, 8, SRC),
                       random_labels(rng, 8))
    ds = KaistDataset(path, S, 4, augment=True)
    for cache in (None, False):            # the device pool, then streaming
        got = list(TP.train_batches(ds, 4, 7, img_size=S, hyp=KAIST_HYP,
                                    device_cache=cache, device="cpu"))
        assert len(got) == 2
        for batch, idx in got:
            assert batch["v"].shape == (4, S, S, 3) == batch["l"].shape
            assert batch["targets"].shape == (4, 64, 5)
            assert len(idx) == 4
        if cache is None:
            pooled = got
    for (a, _), (b, _) in zip(pooled, got):
        assert torch.equal(a["v"], b["v"])       # tiers change nothing


def test_train_batches_snow_clahe_on_a_split(tmp_path):
    """train_batches with the cutout and CLAHE: the batch of a plain run
    from the same seed CLAHE'd and cut, reproducible from its seed."""
    rng = np.random.default_rng(6)
    path = write_split(tmp_path, random_frames(rng, 8, SRC),
                       random_labels(rng, 8))
    ds = KaistDataset(path, S, 4, augment=True)
    runs = [list(TP.train_batches(ds, 4, 7, img_size=S, hyp=KAIST_HYP,
                                  snowflake=snow, clahe=snow,
                                  device="cpu"))
            for snow in (False, True, True)]
    for (plain, i0), (cut, i1), (again, _) in zip(*runs):
        assert list(i0) == list(i1)
        assert cut["v"].shape == plain["v"].shape == (4, S, S, 3)
        assert not torch.equal(cut["v"], plain["v"])
        assert torch.equal(cut["v"], again["v"])
        assert torch.equal(cut["tmask"], again["tmask"])
        assert (cut["tmask"] <= plain["tmask"]).all()  # cutout only drops
        assert 0 <= float(cut["v"].min()) and float(cut["v"].max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hyp,pix", [(KAIST_HYP, 1e-3), (WARP_HYP, 1e-2)],
                         ids=["kaist", "warp"])
def test_augment_card_matches_cpu(hyp, pix):
    """The augment program on the card against the CPU from one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nb = 4
    v, l = frames(14, 4 * nb, (128, 160)), frames(15, 4 * nb, (128, 160))
    lab, m = norm_labels(14, 4 * nb)
    fn = TP.make_train_augment_fn((128, 160), 128, hyp)
    out = {dev: fn(torch.Generator().manual_seed(9),
                   *(t(a).to(dev) for a in (v, l, lab, m)))
           for dev in ("cuda", "cpu")}
    got, want = out["cuda"], out["cpu"]
    close(got["v"].cpu() * 255, want["v"] * 255, pix)
    close(got["l"].cpu() * 255, want["l"] * 255, pix)
    close(got["targets"].cpu(), want["targets"], 1e-5)
    assert torch.equal(got["tmask"].cpu(), want["tmask"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "low", "peaked"])
def test_clahe_and_cutout_card_equal_cpu(kind):
    """CLAHE on the card gives the CPU's bytes (integer histograms, the
    blend op by op), a shape off the tile grid too; the cutout from the
    same uniforms gives the CPU's images and labels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape in ((4, 512, 640, 3), (2, 62, 78, 3)):
        x = torch.from_numpy(clahe_frames(kind, shape, 23))
        assert torch.equal(TC.clahe_batch(x.cuda()).cpu(),
                           TC.clahe_batch(x))
    v, l, lab, m = _cutout_inputs(7)
    u = t(np.random.default_rng(8).random((3, 80, 2), dtype=np.float32))
    kw = dict(n_thr=6, step=32, n_snow=80, u=u)
    want = TA.snowflake_cutout(None, t(v), t(l), t(lab), t(m), **kw)
    got = TA.snowflake_cutout(None, *(t(a).cuda() for a in (v, l, lab, m)),
                              **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
