"""The port's inference surface beyond the Predictor, on the CPU: the model
zoo and ``common.build_model`` (names through ``evaluate``), darknet
``.weights`` against the JAX package's reader, ``detect``, ``data/streams``
and ``bench``, and what ``serve`` / ``bench`` refuse.

Tolerances: the darknet import must give exactly JAX's arrays (a
transpose apart); the forward on them, fp32 at 64x64, within rtol 1e-4 /
atol 1e-3 as ``tests/test_torch_slice.py`` holds decoded heads; the stream's
letterboxed frames within 1e-5 as ``tests/test_torch_dataset.py`` holds the
eval preprocess. Entry points must print what the in-process calls give.
"""

import json
import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.data import pipeline as JP
from double_yolo_kaist_tpu.data import streams as JS
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import import_weights as JW
from double_yolo_kaist_torch import bench as TB
from double_yolo_kaist_torch import common as TC
from double_yolo_kaist_torch import detect as TD
from double_yolo_kaist_torch import evaluate as TEV
from double_yolo_kaist_torch import serve as TSV
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data import pipeline as TP
from double_yolo_kaist_torch.data import streams as TS
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval import evaluator as TE
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.models import zoo
from double_yolo_kaist_torch.serving import Predictor
from double_yolo_kaist_torch.utils import checkpoint as TCK
from tests.test_torch_dataset import random_frames, random_labels, write_split
from tests.test_torch_quantize import one_thread
from tests.test_torch_slice import MNV3, NPZ, TINY, write_narrow_flagship

# torch on one thread: reproducible int8 forwards, and no contention for
# the cores between pytest-xdist workers (test_torch_quantize.one_thread)
_one_thread = pytest.fixture(autouse=True)(one_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNV3_NAME = "Double-YOLOv4-MNv3-Fshare-Global-CSE3"
YOLOV3 = os.path.join(REPO, "configs", "kaist_yolov3.cfg")


@pytest.fixture(scope="module")
def mnv3_ckpt(tmp_path_factory):
    """The MNv3 fixture weights as a checkpoint directory."""
    ir = compile_cfg(MNV3)
    jx = TW.to_jax_variables(TW.load_state_dict_npz(ir, NPZ))
    path = str(tmp_path_factory.mktemp("ckpt") / "mnv3")
    TCK.save_checkpoint(path, params=jx["params"], bn_state=jx["state"])
    return path


# ---------------------------------------------------------------- the zoo


def test_zoo_matches_jax_and_reads_configs_only(tmp_path, monkeypatch):
    """The JAX zoo falls back to the reference checkout's cfg directory;
    the port's reads the repository's ``configs/`` and nothing else."""
    from double_yolo_kaist_tpu.models import zoo as jzoo
    assert zoo.MODELS == jzoo.MODELS and zoo.FLAGSHIP == jzoo.FLAGSHIP
    for name in zoo.MODELS:
        path = zoo.cfg_path(name)
        assert path == os.path.join(REPO, "configs", zoo.MODELS[name][0])
        assert zoo.reference_fps(name) == jzoo.reference_fps(name)
    with pytest.raises(KeyError, match="unknown model"):
        zoo.cfg_path("No-Such-Model")
    with open(zoo.__file__) as f:
        assert jzoo._REFERENCE_CFG_DIR not in f.read()
    monkeypatch.setattr(zoo, "CFG_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        zoo.cfg_path(MNV3_NAME)


def test_build_model_takes_a_zoo_name(mnv3_ckpt):
    ir, variables = TC.build_model(MNV3_NAME, mnv3_ckpt)
    assert len(ir.nodes) == len(compile_cfg(MNV3).nodes)
    want = TCK._flatten(TW.load_state_dict_npz(ir, NPZ))
    got = TCK._flatten(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_evaluate_entry_point_takes_a_zoo_name(mnv3_ckpt, tmp_path, capsys):
    """``python -m double_yolo_kaist_torch.evaluate --cfg <zoo name>``: the
    JAX CLI resolves names through the zoo; the port did not."""
    rng = np.random.default_rng(0)
    split = write_split(tmp_path, random_frames(rng, 4, (64, 96)),
                        random_labels(rng, 4))
    data = tmp_path / "m.data"
    data.write_text(f"classes=1\ntest={split}\n")
    npy = str(tmp_path / "curves.npy")
    TEV.main(["--cfg", MNV3_NAME, "--weights", mnv3_ckpt, "--data",
              str(data), "--img-size", "96", "--batch-size", "4", "--fp32",
              "--device", "cpu", "--npy-path", npy])
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith(("AP@", "AR@")) for line in out) == 12
    ir = compile_cfg(MNV3)
    res = TE.evaluate_dataset(ir, TW.load_state_dict_npz(ir, NPZ),
                              KaistDataset(split, 96, 4, rect=True),
                              batch_size=4, compute_dtype=torch.float32,
                              device="cpu")
    assert np.load(npy, allow_pickle=True).item()["ap"] == res["ap"]


# ------------------------------------------------------- darknet .weights


def _narrow_yolov3(directory) -> str:
    """configs/kaist_yolov3.cfg with every ``filters=`` divided by 4 except
    the head predictors' (18); the file name keeps the v3 strides."""
    out = []
    with open(YOLOV3) as f:
        for line in f:
            m = re.match(r"^(\s*filters\s*=\s*)(\d+)(\s*)$", line)
            if m and int(m.group(2)) != 18:
                line = f"{m.group(1)}{int(m.group(2)) // 4}{m.group(3)}"
            out.append(line)
    path = os.path.join(str(directory), os.path.basename(YOLOV3))
    with open(path, "w") as f:
        f.write("".join(out))
    return path


def _write_darknet(ir, path, seed=0):
    """A darknet .weights file for every conv of ``ir``, from a seed: the
    header, then per BN conv bias, scale, mean, var and the OIHW kernel,
    per plain conv bias and kernel."""
    rng = np.random.default_rng(seed)
    parts = []
    for node in ir.nodes:
        if node.kind != "conv":
            continue
        co = node.out_ch
        fan_in = node.in_ch // node.groups * node.kernel ** 2
        if node.bn:
            parts += [rng.normal(0, 0.1, co), rng.uniform(0.5, 1.5, co),
                      rng.normal(0, 0.1, co), rng.uniform(0.5, 2.0, co)]
        else:
            parts.append(rng.uniform(-0.1, 0.1, co))
        parts.append(rng.uniform(-1, 1, co * fan_in) * np.sqrt(3 / fan_in))
    with open(path, "wb") as f:
        np.asarray([0, 2, 5], np.int32).tofile(f)
        np.asarray([0], np.int64).tofile(f)
        np.concatenate(parts).astype(np.float32).tofile(f)


@pytest.fixture(scope="module")
def darknet(tmp_path_factory):
    d = tmp_path_factory.mktemp("darknet")
    cfg = _narrow_yolov3(d)
    path = str(d / "yolov3.weights")
    _write_darknet(compile_cfg(cfg), path)
    return cfg, path


def test_darknet_weights_match_jax(darknet):
    """A whole file through build_model, then the fp32 forward at 64x64,
    against JAX's from_darknet_weights + merge_variables over the tree of
    graph.init (its shapes, as zeros: the file must replace every leaf)."""
    cfg, path = darknet
    jir = jax_compile_cfg(cfg)
    shapes = jax.eval_shape(lambda k: JG.init(jir, k), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    jv = JW.merge_variables(zeros, JW.from_darknet_weights(jir, path))
    tir, tv = TC.build_model(cfg, path)
    want = TCK._flatten(TW.from_jax_variables(tir, jax.tree.map(np.asarray,
                                                                jv)))
    got = TCK._flatten(tv)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    jio, _ = jax.jit(lambda f, a: JG.apply_folded(jir, f, a))(
        JG.fold_batchnorm(jir, jv), jnp.asarray(x))
    placed = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                             torch.float32)
    io, _ = TG.apply_folded(tir, placed, torch.from_numpy(x))
    np.testing.assert_allclose(io.numpy(), np.asarray(jio), rtol=1e-4,
                               atol=1e-3)


def test_darknet_cutoff_matches_jax(darknet):
    cfg, path = darknet
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    cutoff = 10
    ref = JW.from_darknet_weights(jir, path, cutoff=cutoff)
    got = TW.from_darknet_weights(tir, path, cutoff=cutoff)
    want = TCK._flatten(TW.from_jax_variables(tir, ref))
    assert sorted(TCK._flatten(got)) == sorted(want)
    for k, v in TCK._flatten(got).items():
        np.testing.assert_array_equal(v, want[k])
    missing = TW.missing_from_darknet(tir, cutoff)
    assert missing
    # build_model grafts the file over graph.init node by node, as JAX's
    # cli/common.py merges it
    _, built = TC.build_model(cfg, path, cutoff=cutoff)
    init = TCK._flatten(TG.init(tir, 0))
    flat = TCK._flatten(built)
    assert sorted(flat) == sorted(init)
    for k, v in flat.items():
        node = k.split("/")[1]
        src = want if node not in missing else init
        np.testing.assert_array_equal(v, src[k], err_msg=k)


def test_darknet_needs_init_for_other_layers(tmp_path):
    """MNv3 has SE and depthwise-separable blocks, which darknet files do
    not hold: those come from graph.init, the convs from the file."""
    ir = compile_cfg(MNV3)
    path = str(tmp_path / "mnv3.weights")
    _write_darknet(ir, path)
    _, built = TC.build_model(MNV3_NAME, path)
    missing = TW.missing_from_darknet(ir)
    assert any(ir.nodes[int(k[1:])].kind == "dwconv" for k in missing)
    assert any(ir.nodes[int(k[1:])].kind == "se" for k in missing)
    init = TCK._flatten(TG.init(ir, 0))
    loaded = TCK._flatten(TW.from_darknet_weights(ir, path))
    for k, v in TCK._flatten(built).items():
        src = init if k.split("/")[1] in missing else loaded
        np.testing.assert_array_equal(v, src[k], err_msg=k)


# ------------------------------------------------------ detect and streams


def test_detect_entry_point(mnv3_ckpt, tmp_path, capsys):
    """``detect --device cpu`` on 2 pairs: one line per image with the
    in-process Predictor's count, the fps and miss-rate lines; with figures
    one 3-panel image per pair."""
    rng = np.random.default_rng(4)
    write_split(tmp_path, random_frames(rng, 2, (64, 96)))
    src = str(tmp_path / "images" / "split")
    argv = ["--cfg", MNV3_NAME, "--weights", mnv3_ckpt, "--source", src,
            "--img-size", "96", "--conf-thres", "0.01", "--device", "cpu"]
    TD.main(argv + ["--no-figure"])
    lines = capsys.readouterr().out.splitlines()
    counts = dict(re.match(r"(\S+): (\d+) detections", x).groups()
                  for x in lines[:-2])
    assert lines[-2].startswith("average fps: ")
    assert lines[-1].startswith("miss rate (no-detection fraction): ")
    ir = compile_cfg(MNV3)
    pred = Predictor(ir, TW.load_state_dict_npz(ir, NPZ), img_size=96,
                     conf_thres=0.01, iou_thres=0.5, batch_buckets=(1,),
                     device="cpu")
    for name, n in counts.items():
        vp, lp = TD.get_pair_paths(os.path.join(src, name))
        v = cv2.imread(vp)[None, :, :, ::-1]
        l = cv2.imread(lp)[None, :, :, ::-1]
        assert int(n) == len(pred(v, l)[0][0]), name
    assert len(counts) == 2 and sum(map(int, counts.values())) > 0
    out_dir = tmp_path / "figures"
    TD.main(argv + ["--out-dir", str(out_dir), "--merge-nms"])
    assert sorted(os.listdir(out_dir)) == sorted(
        n.replace("_visible", "_det") for n in counts)


def test_load_stream_matches_jax(tmp_path):
    """A video written with cv2.VideoWriter, read by both packages'
    LoadStream and letterboxed by both iter_preprocessed."""
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (96, 64))
    rng = np.random.default_rng(5)
    for _ in range(4):
        w.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    w.release()
    mine = list(TS.iter_preprocessed(TS.LoadStream(path, img_size=96),
                                     TP.make_eval_preprocess_fn,
                                     device="cpu"))
    ref = list(JS.iter_preprocessed(JS.LoadStream(path, img_size=96),
                                    JP.make_eval_preprocess_fn))
    assert len(mine) == len(ref) == 4
    for (v, frame, meta), (jv, jframe, jmeta) in zip(mine, ref):
        np.testing.assert_array_equal(frame, jframe)
        assert tuple(v.shape) == jv.shape == (1, 64, 128, 3)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
        assert meta[2] == jmeta[2] and np.allclose(meta[0], jmeta[0])
    with pytest.raises(RuntimeError, match="cannot open"):
        TS.LoadStream(str(tmp_path / "missing.avi"))


# -------------------------------------------------------------- bench, serve


def test_bench_entry_point_cpu(mnv3_ckpt, capsys):
    TB.main(["--model", MNV3_NAME, "--weights", mnv3_ckpt, "--height", "64",
             "--width", "96", "--batch", "2", "--iters", "1", "--warmup", "1",
             "--device", "cpu", "--bf16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "repeats",
                        "device"}
    assert out["unit"] == "fps" and out["value"] > 0
    assert out["device"] == "cpu"
    assert out["vs_baseline"] == round(
        out["value"] / zoo.reference_fps(MNV3_NAME), 2)
    assert out["repeats"]["min"] <= out["repeats"]["max"]


def test_bench_both_legs_on_seeded_weights(tmp_path, capsys):
    """No --weights: seeded_variables on the narrowed flagship, bf16 and
    int8 legs, one JSON line with bf16_fps beside the int8 value."""
    cfg = write_narrow_flagship(tmp_path)
    TB.main(["--model", cfg, "--height", "64", "--width", "96", "--batch",
             "1", "--iters", "1", "--warmup", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "int8 PTQ chain" in out["metric"] and out["vs_baseline"] is None
    assert out["value"] > 0 and out["bf16_fps"] > 0
    assert set(out["bf16_repeats"]) == {"min", "mean", "max"}


@pytest.mark.parametrize("mode", ["edge", "spineall"])
def test_bench_new_int8_modes(capsys, mode):
    """``bench --int8 --int8-mode`` in the edge and spine modes, on the tiny
    cfg with seeded weights: one JSON line naming the mode."""
    TB.main(["--model", TINY, "--height", "64", "--width", "96", "--batch",
             "1", "--iters", "1", "--warmup", "1", "--int8", "--int8-mode",
             mode, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert f"int8 PTQ {mode}" in out["metric"] and out["value"] > 0
    assert "bf16_fps" not in out


@pytest.mark.parametrize("argv, replicas", [
    (["--cfg", MNV3_NAME, "--dp", "2"], 2)],
    ids=["argv2-item 12"])     # the id it always had
def test_serve_refuses_what_is_not_ported(monkeypatch, argv, replicas):
    """``serve --dp 2 --device cpu`` (it raised before data parallelism was
    ported) builds a Predictor on a mesh of two CPU replicas, its bucket
    rounded up to 2, that answers a frame as the one-replica server does;
    ``--dp -1`` on the CPU is one replica."""
    kw = ["--img-size", "96", "--no-warmup"]
    pred = _serve_built(monkeypatch, argv + kw)
    one = _serve_built(monkeypatch, argv[:2] + kw)
    assert pred.mesh.size == replicas and one.mesh is None
    assert pred.batch_buckets == [2] and one.batch_buckets == [1]
    frames = np.random.default_rng(8).integers(0, 256, (1, 64, 96, 3),
                                               dtype=np.uint8)
    for (b, s, c), (rb, rs, rc) in zip(pred(frames), one(frames)):
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(c, rc)
    assert _serve_built(monkeypatch, argv[:2] + ["--dp", "-1"]
                        + kw).mesh.size == 1


def test_serve_exported_refuses_dp():
    """``--exported`` bakes the replica layout in: ``--dp`` is refused
    with the JAX package's message, before the artifact is read."""
    with pytest.raises(SystemExit, match="one server per card instead of "
                                         "--dp"):
        TSV.main(["--exported", "absent.zip", "--dp", "2", "--device",
                  "cpu"])


def _serve_built(monkeypatch, argv):
    """Run ``serve``'s main up to the listening socket, which is not
    opened; returns the Predictor it built."""
    built = {}

    class NoServer:
        def __init__(self, addr, handler):
            self.server_address = addr      # the banner names its port

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def handler(predictor, name):
        built["predictor"] = predictor
        return None

    monkeypatch.setattr(TSV, "ThreadingHTTPServer", NoServer)
    monkeypatch.setattr(TSV, "make_handler", handler)
    TSV.main(argv + ["--device", "cpu", "--microbatch", "0"])
    return built["predictor"]


@pytest.mark.parametrize("mode", ["edge", "spine", "spineall"])
def test_serve_int8_modes(mnv3_ckpt, monkeypatch, mode):
    """``serve --int8 --int8-mode`` in the new modes builds its Predictor:
    MNv3's edge plan quantizes (its 1x1 and 3x3 standard convs), its
    spine plans are empty and serve bf16 with the warning."""
    argv = ["--cfg", MNV3_NAME, "--weights", mnv3_ckpt, "--int8",
            "--int8-mode", mode, "--img-size", "96", "--no-warmup"]
    if mode == "edge":
        pred = _serve_built(monkeypatch, argv)
    else:
        with pytest.warns(UserWarning, match="int8 plan"):
            pred = _serve_built(monkeypatch, argv)
    assert pred._int8 == (mode == "edge") and pred._int8_mode == mode


def test_serve_int8_qvars(monkeypatch, tmp_path):
    """``serve --int8-qvars`` (the tiny cfg, weights from graph.init): a
    missing file is written by the server's
    first quantization; an existing one is served from the first request
    (no calibration), with the first server's detections; a file of
    another mode is refused."""
    qpath = str(tmp_path / "q.npz")
    argv = ["--cfg", TINY, "--int8", "--int8-mode", "edge", "--img-size",
            "96", "--no-warmup", "--int8-qvars", qpath,
            "--calibration-batches", "1"]
    first = _serve_built(monkeypatch, argv)
    assert first.qvars is None and not os.path.exists(qpath)
    frames = np.random.default_rng(3).integers(0, 256, (2, 1, 64, 96, 3),
                                               dtype=np.uint8)
    first(*frames)                                   # calibrates, saves
    assert first.qvars is not None and os.path.exists(qpath)
    second = _serve_built(monkeypatch, argv)
    assert second.qvars is not None and not second._cal_batches
    for (b, s, c), (rb, rs, rc) in zip(second(*frames), first(*frames)):
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(s, rs)
    with pytest.raises(ValueError, match="built for mode='edge'"):
        _serve_built(monkeypatch, [a if a != "edge" else "all"
                                   for a in argv])


def test_bench_check_ap(capsys):
    """``bench --check-ap`` on the CPU: the overfit check's 60 epochs pass
    its gates (AP@0.5 > 0.5, every int8 mode within its bound) and the
    JSON line reports them."""
    TB.main(["--check-ap", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OVERFIT CHECK PASSED" in out and "INT8 AP GATE PASSED" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["value"] > 0.5 and res["vs_baseline"] > 1.0
    assert res["int8_worst_ap"] >= res["value"] - 0.15
    assert res["unit"] == "AP" and res["device"] == "cpu"


def test_serve_exported(monkeypatch, tmp_path, capsys):
    """``serve --exported`` (the tiny cfg exported on the CPU at batch 2):
    it serves an ExportedPredictor that answers as the Predictor it was
    exported from, prints which baked-in flags it ignores, and refuses
    ``--int8``."""
    from double_yolo_kaist_torch.export import ExportedPredictor
    from double_yolo_kaist_torch.export_model import main as export_main

    path = str(tmp_path / "tiny.zip")
    export_main(["--cfg", TINY, "--img-size", "64", "--src-hw", "64", "96",
                 "--batch", "2", "--out", path, "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    pred = _serve_built(monkeypatch, ["--exported", path, "--weights",
                                      "ignored", "--img-size", "320"])
    out = capsys.readouterr().out
    assert "# --exported: ignoring --weights, --img-size" in out
    assert isinstance(pred, ExportedPredictor)
    ir, variables = TC.build_model(TINY)
    ref = Predictor(ir, variables, img_size=64, batch_buckets=(2,),
                    device="cpu")
    frames = np.random.default_rng(5).integers(0, 256, (3, 64, 96, 3),
                                               dtype=np.uint8)
    for (b, s, c), (rb, rs, rc) in zip(pred(frames), ref(frames)):
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(c, rc)
    with pytest.raises(SystemExit, match="bakes precision"):
        TSV.main(["--exported", path, "--int8", "--device", "cpu"])
