"""The whole serving slice: BN fold -> forward -> decode -> NMS -> letterbox
undo, the port on the CPU in fp32 against the JAX package in fp32.

Tolerances, and why:
  * raw heads and decoded boxes: the same fp32 math on both sides, but the
    convs sum in another order (and the JAX package runs its exact stem /
    s2d rewrites), so differences grow through the depth: rtol 1e-4 with an
    atol of 1e-4 (raw logits) or 1e-3 (decoded pixels, values up to ~10^3);
  * Predictor detections: the same valid count per image, and boxes and
    scores within 1e-3 (pixels in the original frame; probabilities).

The models: the tiny cfg and MNv3 with its trained fixture weights, and
the flagship Double-YOLOv4-Fshare-Global-CSE3 narrowed for the CPU (every
``filters=`` divided by 4 except the head predictors', 64x96 frames) with
seeded JAX ``graph.init`` weights scaled up by :data:`FLAGSHIP_GAIN` and
perturbed BN statistics.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import import_weights as JW
from double_yolo_kaist_tpu.models import layers as JL
from double_yolo_kaist_tpu.serving import Predictor as JaxPredictor
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.serving import Predictor

JL.set_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")
FLAGSHIP = os.path.join(REPO, "configs",
                        "kaist_dyolov4_fshare_global_concat_se3.cfg")
# graph.init's kaiming-uniform kernels shrink the signal layer by layer, so
# that after ~100 convs the heads no longer depend on the input. This gain
# keeps the narrowed flagship's raw heads input-dependent (mean |change|
# ~0.05 between two inputs, std ~3) while its int8 forward stays stable: at
# 2.25 the net is near chaos and 1e-7 of input noise already flips int8
# codes, whose steps then compound to the size of the quantization error.
FLAGSHIP_GAIN = 2.2


def write_narrow_flagship(directory) -> str:
    """The flagship cfg with every ``filters=`` divided by 4 except the head
    predictors' (18), written into ``directory``; returns its path (the
    file name keeps the flagship's, from which the strides derive)."""
    out = []
    with open(FLAGSHIP) as f:
        for line in f:
            m = re.match(r"^(\s*filters\s*=\s*)(\d+)(\s*)$", line)
            if m and int(m.group(2)) != 18:
                line = f"{m.group(1)}{int(m.group(2)) // 4}{m.group(3)}"
            out.append(line)
    path = os.path.join(str(directory), os.path.basename(FLAGSHIP))
    with open(path, "w") as f:
        f.write("".join(out))
    return path


def flagship_variables(jir, seed=0):
    """Seeded JAX variables (numpy) for the narrowed flagship: graph.init,
    conv kernels times FLAGSHIP_GAIN, perturbed BN."""
    v = jax.tree.map(lambda a: np.array(a),
                     JG.init(jir, jax.random.PRNGKey(seed)))
    for p in v["params"].values():
        if isinstance(p, dict) and np.ndim(p.get("w")) == 4:
            p["w"] = (p["w"] * FLAGSHIP_GAIN).astype(np.float32)
    return _perturb_bn(v, seed)


def _perturb_bn(variables, seed=0):
    """graph.init's BN state is the identity; give it real statistics so
    the fold is exercised."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if k == "bn":
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(p[k], dict) and isinstance(s, dict) and k in s:
                walk(p[k], s[k])

    for key, p in variables["params"].items():
        if key in variables["state"]:
            walk(p, variables["state"][key])
    return variables


@pytest.fixture(scope="module", params=["tiny", "mnv3", "flagship"])
def model(request, tmp_path_factory):
    """(name, jax ir, jax variables, port ir, port variables, frame hw,
    img_size)."""
    if request.param == "tiny":
        jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
        tir = compile_cfg(TINY, yolo_strides=[8, 4])
        jv = _perturb_bn(jax.tree.map(
            lambda a: np.array(a), JG.init(jir, jax.random.PRNGKey(0))))
        tv = TW.from_jax_variables(tir, jv)
        return "tiny", jir, jv, tir, tv, (64, 64), 64
    if request.param == "flagship":
        cfg = write_narrow_flagship(tmp_path_factory.mktemp("flagship"))
        jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
        jv = flagship_variables(jir)
        return "flagship", jir, jv, tir, TW.from_jax_variables(tir, jv), \
            (64, 96), 96
    jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
    with np.load(NPZ) as z:
        jv = JW.from_torch_state_dict(jir, {k: z[k] for k in z.files})
    tv = TW.load_state_dict_npz(tir, NPZ)
    # 64x96 frames letterbox into 64x128 (padded to a multiple of 64)
    return "mnv3", jir, jv, tir, tv, (64, 96), 96


def test_apply_folded_matches_jax(model):
    name, jir, jv, tir, tv, hw, _ = model
    rng = np.random.default_rng(1)
    xv = rng.random((2,) + hw + (3,), dtype=np.float32)
    xl = rng.random((2,) + hw + (3,), dtype=np.float32)
    jio, jraw = jax.jit(lambda f, a, b: JG.apply_folded(jir, f, a, b))(
        JG.fold_batchnorm(jir, jv), jnp.asarray(xv), jnp.asarray(xl))
    folded = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                             torch.float32)
    io, raw = TG.apply_folded(tir, folded, torch.from_numpy(xv),
                              torch.from_numpy(xl))
    assert len(raw) == len(jraw) == len(tir.yolo_indices)
    for mine, ref in zip(raw, jraw):
        assert tuple(mine.shape) == ref.shape
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert tuple(io.shape) == jio.shape and io.dtype == torch.float32
    np.testing.assert_allclose(io.numpy(), np.asarray(jio), rtol=1e-4,
                               atol=1e-3, err_msg=name)


def test_forward_stays_channels_last(model):
    """Every conv output and every head of the bf16 forward is channels-last
    (the layout cuDNN's NHWC kernels and K1's 16-byte path read): the
    upsamples keep it through the routes that concatenate them."""
    _, _, _, tir, tv, hw, _ = model
    placed = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                             torch.bfloat16)
    off = []

    def conv(node, inp, p):
        out = TG.conv_folded(node, inp, p)
        if not out.is_contiguous(memory_format=torch.channels_last):
            off.append(node.index)
        return out

    x = torch.rand((2,) + hw + (3,))
    with torch.inference_mode():
        heads = TG.run_graph(tir, placed["params"], x, x,
                             dtype=torch.bfloat16, conv=conv)
    assert not off
    assert all(h.is_contiguous(memory_format=torch.channels_last)
               for h, _ in heads)


def test_eval_heads_take_the_fast_decode():
    """MNv3 at the rect eval size, 416x512: all three heads (52x64, 26x32,
    13x16) have the layout of K1's 16-byte path."""
    from double_yolo_kaist_torch.ops.decode import fast_path
    tir = compile_cfg(MNV3)
    placed = TG.place_folded(tir, TG.fold_batchnorm(
        tir, TW.load_state_dict_npz(tir, NPZ)), "cpu", torch.bfloat16)
    x = torch.rand((1, 416, 512, 3))
    with torch.inference_mode():
        heads = TG.run_graph(tir, placed["params"], x, x,
                             dtype=torch.bfloat16)
    assert [tuple(h.shape[2:]) for h, _ in heads] == [(52, 64), (26, 32),
                                                      (13, 16)]
    assert all(fast_path(h.shape, h.stride(), h.dtype, len(n.anchors))
               for h, n in heads)


def test_predictor_matches_jax(model):
    """uint8 frames through both Predictors (fp32, CPU for the port); three
    frames in a bucket of four exercise the padding."""
    name, jir, jv, tir, tv, hw, img_size = model
    kw = dict(img_size=img_size, conf_thres=0.01, batch_buckets=(1, 4))
    rng = np.random.default_rng(2)
    v = rng.integers(0, 256, (3,) + hw + (3,), dtype=np.uint8)
    l = rng.integers(0, 256, (3,) + hw + (3,), dtype=np.uint8)
    ref = JaxPredictor(jir, jv, compute_dtype=jnp.float32, **kw)(v, l)
    mine = Predictor(tir, tv, compute_dtype=torch.float32, device="cpu",
                     **kw)(v, l)
    assert len(mine) == len(ref) == 3
    n_dets = 0
    for (b, s, c), (rb, rs, rc) in zip(mine, ref):
        assert b.shape == rb.shape, name
        np.testing.assert_allclose(b, rb, rtol=1e-4, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-3, err_msg=name)
        np.testing.assert_array_equal(c, rc)
        n_dets += len(b)
    assert n_dets > 0, name


def test_entry_points_refuse_missing_cuda(model, monkeypatch):
    """device=None means CUDA; without it the Predictor raises instead of
    running on the CPU."""
    _, _, _, tir, tv, _, img_size = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(tir, tv, img_size=img_size)
