"""The whole offline evaluation slice, the port on the CPU against the JAX
package: ``eval/evaluator.py::evaluate_dataset``, the checkpoint and
calibration artifacts both ways, and the ``evaluate`` entry point.

Splits are 6 frames of 64x96 written under ``tmp_path`` (``batch_size=4``,
so the second batch is partial), with labels made from JAX's own fp32
detections (the 5 most confident per frame), so that AP is not
degenerate. Tolerances, and why:
  * fp32 (the tiny cfg with seeded weights, MNv3 with its trained fixture
    weights): the same math, summed in another order: AP and LAMR within
    1e-4, the 12 COCO stats within 1e-3, detections matched one to one
    with boxes within 1e-2 px and scores within 1e-5;
  * int8 chain on the flagship narrowed as in ``tests/test_torch_slice.py``,
    from JAX's calibration artifact: each quantized conv agrees to an ulp,
    but an ulp on an int8 rounding boundary moves a value by one step and
    the steps compound (``tests/test_torch_quantize.py``), so detections
    are matched statistically: at least 90% of JAX's scoring >= 0.02 have a
    port detection with IoU >= 0.8 and a score within 0.1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.data.dataset import KaistDataset as JaxDataset
from double_yolo_kaist_tpu.eval import evaluator as JE
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import import_weights as JW
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_tpu.utils import checkpoint as JCK
from double_yolo_kaist_torch import evaluate as TEV
from double_yolo_kaist_torch.bench import seeded_variables
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval import evaluator as TE
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.utils import checkpoint as TCK
from tests.test_torch_dataset import random_frames, write_split
from tests.test_torch_quantize import _match_rate, one_thread
from tests.test_torch_slice import (MNV3, NPZ, TINY, _perturb_bn,
                                    write_narrow_flagship)

HW = (64, 96)
IMG = 96

# torch on one thread: reproducible int8 forwards, and no contention for
# the cores between pytest-xdist workers (test_torch_quantize.one_thread)
_one_thread = pytest.fixture(autouse=True)(one_thread)


def labels_from(predictions, shapes, k=5, seed=0):
    """The ``k`` most confident detections of each image as normalized
    ``cls cx cy w h`` rows (boxes under 2 px dropped), and one random box
    an image that no detection need match, so that AP stays under 1."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(shapes)):
        boxes, scores = predictions.get(i, (np.zeros((0, 4)), np.zeros(0)))
        keep = np.argsort(-scores, kind="stable")[:k]
        w, h = shapes[i]
        rows = []
        for b in np.asarray(boxes)[keep]:
            bw, bh = b[2] - b[0], b[3] - b[1]
            if bw >= 2 and bh >= 2:
                rows.append([0, (b[0] + bw / 2) / w, (b[1] + bh / 2) / h,
                             bw / w, bh / h])
        rows.append([0, *rng.uniform(0.3, 0.7, 2), *rng.uniform(0.1, 0.3, 2)])
        out.append(np.asarray(rows).reshape(-1, 5))
    return out


@pytest.fixture(scope="module", params=["tiny", "mnv3"])
def model(request, tmp_path_factory):
    """(name, jax ir, jax variables, port ir, port variables, split path
    with labels from JAX's fp32 detections)."""
    if request.param == "tiny":
        jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
        tir = compile_cfg(TINY, yolo_strides=[8, 4])
        jv = _perturb_bn(jax.tree.map(
            lambda a: np.array(a), JG.init(jir, jax.random.PRNGKey(0))))
        tv = TW.from_jax_variables(tir, jv)
    else:
        jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
        with np.load(NPZ) as z:
            jv = JW.from_torch_state_dict(jir, {k: z[k] for k in z.files})
        tv = TW.load_state_dict_npz(tir, NPZ)
    root = tmp_path_factory.mktemp(request.param)
    frames = random_frames(np.random.default_rng(11), 6, HW)
    path = write_split(root, frames)
    ds = JaxDataset(path, IMG, 4, rect=True)
    res = JE.evaluate_dataset(jir, jv, ds, batch_size=4,
                              compute_dtype=jnp.float32, device_cache=False)
    labels = labels_from(res["predictions"], ds.shapes)
    # MNv3 finds one box a frame at this size, the tiny cfg several
    assert sum(len(lab) for lab in labels) >= 2 * len(frames)
    # the labels belong to the images in the dataset's (rect-sorted) order
    order = [int(os.path.basename(f)[1:6]) for f in ds.img_files]
    path = write_split(root, frames,
                       [labels[order.index(i)] for i in range(len(frames))])
    return request.param, jir, jv, tir, tv, path


def _match_detections(mine, ref):
    """Every image: the same number of detections, matched one to one with
    boxes within 1e-2 px and scores within 1e-5. Returns the count."""
    assert sorted(mine) == sorted(ref)
    n = 0
    for img, (rb, rs) in ref.items():
        b, s = mine[img]
        assert b.shape == rb.shape and s.shape == rs.shape, img
        used = np.zeros(len(b), bool)
        for box, score in zip(rb, rs):
            ok = (~used & (np.abs(b - box).max(1) <= 1e-2)
                  & (np.abs(s - score) <= 1e-5))
            assert ok.any(), (img, box, score)
            used[np.argmax(ok)] = True
        n += len(rb)
    return n


def test_evaluate_dataset_matches_jax(model):
    name, jir, jv, tir, tv, path = model
    ref = JE.evaluate_dataset(jir, jv, JaxDataset(path, IMG, 4, rect=True),
                              batch_size=4, compute_dtype=jnp.float32)
    mine = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4, rect=True),
                               batch_size=4, compute_dtype=torch.float32,
                               device="cpu")
    print(f"{name}: AP {mine['ap']:.6f} (JAX {ref['ap']:.6f}), LAMR "
          f"{mine['lamr']:.6f} (JAX {ref['lamr']:.6f})")
    assert 0.05 < ref["ap"] < 1.0 and 0.0 < ref["lamr"] < 1.0
    assert abs(mine["ap"] - ref["ap"]) <= 1e-4
    assert abs(mine["lamr"] - ref["lamr"]) <= 1e-4
    np.testing.assert_allclose(mine["coco_stats"], ref["coco_stats"],
                               atol=1e-3)
    assert _match_detections(mine["predictions"], ref["predictions"]) > 0
    assert mine["batches"] == 2 and mine["fps"] > 0
    assert set(mine["seconds"]) == {"infer", "loop", "metrics"}


def test_device_pool_and_streaming_agree(model, monkeypatch):
    """The device-pool tier (CPU device) and streaming give the same
    predictions."""
    _, _, _, tir, tv, path = model
    monkeypatch.setenv("DYK_DEVICE_CACHE_GB", "1")
    kw = dict(batch_size=4, compute_dtype=torch.float32, device="cpu")
    ds = KaistDataset(path, IMG, 4, rect=True)
    pooled = TE.evaluate_dataset(tir, tv, ds, device_cache=None, **kw)
    assert "cpu" in ds._device_pools
    streamed = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4,
                                                         rect=True),
                                   device_cache=False, **kw)
    assert pooled["ap"] == streamed["ap"]
    for img, (b, s) in streamed["predictions"].items():
        np.testing.assert_array_equal(pooled["predictions"][img][0], b)
        np.testing.assert_array_equal(pooled["predictions"][img][1], s)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(jax ir, jax variables, port ir, port variables, split path)."""
    root = tmp_path_factory.mktemp("flagship")
    cfg = write_narrow_flagship(root)
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    # bench's seeded draw: graph.init's distributions times the gain
    tv = seeded_variables(tir, 0)
    path = write_split(root, random_frames(np.random.default_rng(12), 6, HW))
    return jir, TW.to_jax_variables(tv), tir, tv, path


def test_int8_evaluate_matches_jax(flagship, tmp_path, monkeypatch):
    """int8 chain: JAX calibrates on its first two batches and saves the
    artifact; the port evaluates from that artifact. Detections matched
    statistically (module docstring)."""
    jir, jv, tir, tv, path = flagship
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    monkeypatch.setattr(TG, "_S2D_REGION", False)
    cal = str(tmp_path / "cal.npz")
    kw = dict(batch_size=4, conf_thres=0.01, int8=True, calibration=cal)
    ref = JE.evaluate_dataset(jir, jv, JaxDataset(path, IMG, 4, rect=True),
                              compute_dtype=jnp.float32, **kw)
    assert os.path.exists(cal)
    mine = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4, rect=True),
                               compute_dtype=torch.float32, device="cpu",
                               **kw)

    def per_image(res):
        return [(b, s, np.zeros(len(s), int)) for _, (b, s) in
                sorted(res["predictions"].items())]

    # the seeded narrowed flagship scores low: count from 0.02 (422
    # detections, 396 matched on the CPU when the bound was set)
    hit, total = _match_rate(per_image(mine), per_image(ref), min_score=0.02)
    print(f"int8 detections matched: {hit} of {total}")
    assert total > 0 and hit >= 0.9 * total


def test_int8_calibration_saved_then_reused(flagship, tmp_path):
    """The port calibrates on its first eval batches and saves the artifact;
    a second evaluation from that artifact gives identical predictions, and
    the artifact loads in the JAX package with the same stats."""
    _, _, tir, tv, path = flagship
    cal = str(tmp_path / "cal.npz")
    kw = dict(batch_size=4, int8=True, calibration=cal,
              compute_dtype=torch.float32, device="cpu")
    first = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4,
                                                      rect=True), **kw)
    assert os.path.exists(cal)
    again = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4,
                                                      rect=True), **kw)
    assert first["ap"] == again["ap"]
    for img, (b, s) in first["predictions"].items():
        np.testing.assert_array_equal(again["predictions"][img][0], b)
        np.testing.assert_array_equal(again["predictions"][img][1], s)
    stats, pct = TQ.load_calibration(cal)
    jstats, jpct = JQ.load_calibration(cal)
    assert pct == jpct == 100.0 and sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_array_equal(stats[k], v)
    assert set(stats) >= {f"l{i}" for i in TQ.plan_quantization(tir)[0]}
    # the per-channel vectors edge mode reads are there too
    assert set(stats) >= {f"l{i}.out" for i, v in
                          TQ.plan_edges(tir)[1].items() if v
                          and tir.nodes[i].kind in ("conv", "shortcut")}


def test_calibration_artifacts_cross_load(tmp_path):
    """JAX's save_calibration loads in the port (vectors kept as arrays),
    the port's in JAX; the percentile survives both ways."""
    stats = {"l3": 1.25, "l7": 0.0625, "l9.out": np.asarray([1.0, 2.5])}
    JQ.save_calibration(str(tmp_path / "j.npz"), stats, pct=99.9)
    got, pct = TQ.load_calibration(str(tmp_path / "j.npz"))
    assert pct == 99.9 and sorted(got) == sorted(stats)
    assert got["l3"] == 1.25 and got["l7"] == 0.0625
    np.testing.assert_array_equal(got["l9.out"], stats["l9.out"])
    TQ.save_calibration(str(tmp_path / "t.npz"), {"l3": 1.25, "l7": 0.0625},
                        pct=99.0)
    assert JQ.load_calibration(str(tmp_path / "t.npz")) == (
        {"l3": 1.25, "l7": 0.0625}, 99.0)


def test_predictor_calibration_artifact(flagship, tmp_path):
    """Predictor(calibration=): a missing file is written after the
    calibration requests; an existing one makes int8 live from the first
    request, with the same quantized weights."""
    from double_yolo_kaist_torch.serving import Predictor
    _, _, tir, tv, _ = flagship
    cal = str(tmp_path / "serve_cal.npz")
    kw = dict(img_size=IMG, int8=True, compute_dtype=torch.float32,
              device="cpu", batch_buckets=(2,), calibration=cal,
              calibration_batches=1)
    frames = np.random.default_rng(5).integers(0, 256, (2, 2) + HW + (3,),
                                               dtype=np.uint8)
    first = Predictor(tir, tv, **kw)
    assert first.qvars is None
    first(*frames)
    assert first.qvars is not None and os.path.exists(cal)
    second = Predictor(tir, tv, **kw)
    assert second.qvars is not None             # live before any request
    for (b, s, c), (rb, rs, rc) in zip(second(*frames), first(*frames)):
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(s, rs)


def _jax_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def test_checkpoint_port_to_jax(tmp_path):
    """The port's variables through to_jax_variables and the port's
    save_checkpoint load in the JAX package exactly, with and without a
    template; opt_state and ema come back as stored."""
    jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
    tv = TW.load_state_dict_npz(tir, NPZ)
    with np.load(NPZ) as z:
        jv = JW.from_torch_state_dict(jir, {k: z[k] for k in z.files})
    jx = TW.to_jax_variables(tv)
    extra = {"opt_state": {"mu": {"l0": np.arange(3.0)}},
             "ema": {"l0": {"w": np.ones(2)}}}
    TCK.save_checkpoint(str(tmp_path / "ck"), params=jx["params"],
                        bn_state=jx["state"], epoch=4, best_map=0.5, **extra)
    got = JCK.load_checkpoint(str(tmp_path / "ck"))
    assert (got["epoch"], got["best_map"]) == (4, 0.5)
    for k in ("params", "state"):
        want = jax.tree_util.tree_leaves_with_path(jv[k])
        have = _jax_tree(got[k if k == "params" else "bn_state"])
        assert len(jax.tree_util.tree_leaves(have)) == len(want)
        for path, leaf in want:
            node = have
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, np.asarray(leaf, np.float32))
    np.testing.assert_array_equal(got["opt_state"]["mu"]["l0"], np.arange(3.))
    np.testing.assert_array_equal(got["ema"]["l0"]["w"], np.ones(2))
    templ = JCK.load_checkpoint(str(tmp_path / "ck"), {
        "params": jax.tree.map(np.zeros_like, jv["params"])})
    np.testing.assert_array_equal(templ["params"]["l0"]["w"],
                                  jv["params"]["l0"]["w"])


def test_checkpoint_jax_to_port(tmp_path):
    """A checkpoint the JAX package writes loads in the port and, through
    from_jax_variables, equals the port's own variables exactly; with a
    template, leaves of the wrong shape keep the template's value."""
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = _perturb_bn(_jax_tree(JG.init(jir, jax.random.PRNGKey(3))))
    JCK.save_checkpoint(str(tmp_path / "ck"), params=jv["params"],
                        bn_state=jv["state"], step=7,
                        ema={"l0": {"w": np.zeros(2)}})
    got = TCK.load_checkpoint(str(tmp_path / "ck"))
    assert got["step"] == 7
    np.testing.assert_array_equal(got["ema"]["l0"]["w"], np.zeros(2))
    mine = TW.from_jax_variables(tir, {"params": got["params"],
                                       "state": got["bn_state"]})
    ref = TW.from_jax_variables(tir, jv)
    flat_m = TCK._flatten(mine)
    flat_r = TCK._flatten(ref)
    assert sorted(flat_m) == sorted(flat_r)
    for k in flat_r:
        np.testing.assert_array_equal(flat_m[k], flat_r[k])
    # round trip back through to_jax_variables is exact
    back = TCK._flatten(TW.to_jax_variables(mine))
    for k, v in TCK._flatten(jv).items():
        np.testing.assert_array_equal(back[k], v)
    template = {"params": {"l0": {"w": np.zeros((1, 1, 1, 1))},
                           "l1": jv["params"]["l1"]}}
    grafted = TCK.load_checkpoint(str(tmp_path / "ck"), template)
    assert grafted["params"]["l0"]["w"].shape == (1, 1, 1, 1)
    np.testing.assert_array_equal(grafted["params"]["l1"]["w"],
                                  jv["params"]["l1"]["w"])


def _write_data(tmp_path, split):
    data = tmp_path / "m.data"
    data.write_text(f"classes=1\ntrain={split}\nvalid={split}\n"
                    f"test={split}\n")
    return str(data)


def test_entry_point_cpu(model, tmp_path, capsys):
    """``python -m double_yolo_kaist_torch.evaluate --device cpu`` on a
    checkpoint the port wrote: the 12 COCO lines, VOC-AP and LAMR, and the
    AP of evaluate_dataset on the same inputs. (The entry point derives the
    heads' strides from the cfg's file name, as the JAX CLI does, so the
    tiny cfg runs with the v3 strides there; its AP is compared all the
    same.)"""
    name, _, _, _, tv, path = model
    cfg = MNV3 if name == "mnv3" else TINY
    jx = TW.to_jax_variables(tv)
    TCK.save_checkpoint(str(tmp_path / "ck"), params=jx["params"],
                        bn_state=jx["state"])
    npy = str(tmp_path / "curves.npy")
    TEV.main(["--cfg", cfg, "--weights", str(tmp_path / "ck"),
              "--data", _write_data(tmp_path, path), "--img-size", str(IMG),
              "--batch-size", "4", "--fp32", "--device", "cpu",
              "--cache-images", "disk", "--npy-path", npy])
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith(("AP@", "AR@")) for line in out) == 12
    assert any(line.startswith("VOC Average Precision") for line in out)
    assert any(line.startswith("Log Average Miss Rate") for line in out)
    ap = np.load(npy, allow_pickle=True).item()["ap"]
    res = TE.evaluate_dataset(compile_cfg(cfg), tv,
                              KaistDataset(path, IMG, 4, rect=True),
                              batch_size=4, compute_dtype=torch.float32,
                              device="cpu")
    assert ap == res["ap"]
    if name == "mnv3":
        assert ap > 0.05


def test_not_ported_raise(model, tmp_path):
    """Nothing of the evaluator is left unported: ``mesh`` runs data-
    parallel (``tests/test_torch_dp_inference.py``), and a mesh that is
    not a ``parallel.mesh.Mesh`` is refused with a TypeError. Lifted
    before it: folded=False runs the unfolded forward, build_model without
    weights starts from graph.init, CLAHE and the quantized artifacts are
    ported (the tests below)."""
    name, _, _, tir, tv, path = model
    ds = KaistDataset(path, IMG, 4, rect=True)
    with pytest.raises(TypeError, match="Mesh"):
        TE.evaluate_dataset(tir, tv, ds, device="cpu", mesh=object())
    ir, variables = TEV.build_model(MNV3, "")
    assert sorted(TCK._flatten(variables)) == sorted(
        TCK._flatten(TW.load_state_dict_npz(ir, NPZ)))


@pytest.mark.parametrize("model", ["tiny"], indirect=True)
def test_evaluate_clahe_split(model):
    """A split with ``clahe`` set evaluates with CLAHE'd frames: the
    predictions differ from the plain split's, as the JAX package's do."""
    name, jir, jv, tir, tv, path = model
    kw = dict(batch_size=4, compute_dtype=torch.float32, device="cpu")
    plain = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4,
                                                      rect=True), **kw)
    res = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4, rect=True,
                                                    clahe=True), **kw)
    assert res["batches"] == plain["batches"] == 2
    assert any(not np.array_equal(res["predictions"][i][1], s)
               for i, (_, s) in plain["predictions"].items())


@pytest.mark.parametrize("model", ["tiny"], indirect=True)
@pytest.mark.parametrize("mode", ["edge", "spineall"])
def test_evaluate_from_quantized_artifact(model, tmp_path, mode):
    """evaluate_dataset(quantized=) on the tiny cfg: the variables
    quantize() makes from a calibration, saved as an artifact, give the
    predictions of the evaluation that quantized them from that
    calibration, exactly; a mode other than the artifact's is refused."""
    _, _, _, tir, tv, path = model
    cal, qpath = str(tmp_path / "cal.npz"), str(tmp_path / "q.npz")
    kw = dict(batch_size=4, int8=True, int8_mode=mode,
              compute_dtype=torch.float32, device="cpu")
    ds = KaistDataset(path, IMG, 4, rect=True)
    first = TE.evaluate_dataset(tir, tv, ds, calibration=cal, **kw)
    stats, _ = TQ.load_calibration(cal)
    qv = TQ.quantize(tir, TG.fold_batchnorm(tir, tv), stats, mode=mode)
    TQ.save_quantized(qpath, qv, mode=mode, hw=(IMG, IMG))
    again = TE.evaluate_dataset(tir, None, ds, quantized=qpath, **kw)
    assert again["ap"] == first["ap"]
    for img, (b, s) in first["predictions"].items():
        np.testing.assert_array_equal(again["predictions"][img][0], b)
        np.testing.assert_array_equal(again["predictions"][img][1], s)
    with pytest.raises(ValueError, match="mode="):
        TE.evaluate_dataset(tir, None, ds, quantized=qpath,
                            **dict(kw, int8_mode="chain"))


@pytest.mark.parametrize("model", ["tiny"], indirect=True)
def test_calibrate_and_evaluate_int8_qvars_entry_points(model, tmp_path,
                                                        capsys):
    """``python -m double_yolo_kaist_torch.calibrate --quantized-out`` on
    the tiny cfg with ``--device cpu`` writes both artifacts, in the JAX
    package's format; ``evaluate --int8 --int8-mode edge --int8-qvars`` on
    that file prints the VOC-AP of evaluate_dataset(quantized=)."""
    from double_yolo_kaist_torch import calibrate as TCAL
    name, _, _, _, tv, path = model
    cfg = MNV3 if name == "mnv3" else TINY
    jx = TW.to_jax_variables(tv)
    TCK.save_checkpoint(str(tmp_path / "ck"), params=jx["params"],
                        bn_state=jx["state"])
    data = _write_data(tmp_path, path)
    cal, qpath = str(tmp_path / "cal.npz"), str(tmp_path / "q.npz")
    TCAL.main(["--cfg", cfg, "--weights", str(tmp_path / "ck"), "--data",
               data, "--img-size", str(IMG), "--batch-size", "4",
               "--batches", "2", "--fp32", "--out", cal, "--quantized-out",
               qpath, "--int8-mode", "edge", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "calibration:" in out and "quantized variables (mode=edge" in out
    jstats, _ = JQ.load_calibration(cal)
    assert any(k.endswith(".out") for k in jstats)
    jq, jmode, jhw = JQ.load_quantized(qpath)
    assert (jmode, jhw) == ("edge", (IMG, IMG)) and jq["params"]
    npy = str(tmp_path / "curves.npy")
    TEV.main(["--cfg", cfg, "--weights", str(tmp_path / "ck"), "--data",
              data, "--img-size", str(IMG), "--batch-size", "4", "--fp32",
              "--int8", "--int8-mode", "edge", "--int8-qvars", qpath,
              "--device", "cpu", "--npy-path", npy])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("VOC Average Precision")]
    res = TE.evaluate_dataset(compile_cfg(cfg), None,
                              KaistDataset(path, IMG, 4, rect=True),
                              batch_size=4, compute_dtype=torch.float32,
                              int8=True, int8_mode="edge", quantized=qpath,
                              device="cpu")
    assert np.load(npy, allow_pickle=True).item()["ap"] == res["ap"]
    assert printed == [f"VOC Average Precision (VOC-AP)@[IoU = 0.5] = "
                       f"{res['ap'] * 100:.2f}%"]


def test_unfolded_matches_jax(model):
    """evaluate_dataset(folded=False), the unfolded forward with BN from
    the running state, on both packages, fp32: AP and LAMR within 1e-4."""
    name, jir, jv, tir, tv, path = model
    want = JE.evaluate_dataset(jir, jv, JaxDataset(path, IMG, 4, rect=True),
                               batch_size=4, compute_dtype=jnp.float32,
                               folded=False, device_cache=False)
    got = TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4, rect=True),
                              batch_size=4, compute_dtype=torch.float32,
                              folded=False, device="cpu")
    assert abs(got["ap"] - want["ap"]) <= 1e-4
    assert abs(got["lamr"] - want["lamr"]) <= 1e-4
    if name == "mnv3":
        assert got["ap"] > 0.05


def _reference_pt(tmp_path):
    """The MNv3 fixture as a reference ``.pt`` checkpoint ({"model": state
    dict})."""
    with np.load(NPZ) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    path = str(tmp_path / "mnv3.pt")
    torch.save({"model": sd, "epoch": 0}, path)
    return path


def test_build_model_reads_reference_pt(tmp_path):
    ir, variables = TEV.build_model(MNV3, _reference_pt(tmp_path))
    want = TCK._flatten(TW.load_state_dict_npz(ir, NPZ))
    got = TCK._flatten(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_entry_point_refuses_missing_cuda(model, monkeypatch):
    """device=None means CUDA: without it evaluate_dataset raises."""
    _, _, _, tir, tv, path = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.evaluate_dataset(tir, tv, KaistDataset(path, IMG, 4, rect=True))
