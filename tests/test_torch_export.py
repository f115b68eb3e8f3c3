"""Exported serving artifacts (``double_yolo_kaist_torch/export.py``): the
port's counterparts of ``tests/test_export.py``, on the CPU.

  * An artifact's ``ExportedPredictor`` gives its ``Predictor``'s
    detections bit for bit (the same ATen operators and registered K1-K4
    operators on the same tensors), padding a partial batch; it checks the
    frame size and warms up.
  * int8: a quantized Predictor (the tiny cfg in chain, edge and spineall;
    the flagship narrowed for the CPU in chain, whose program holds K4)
    exports and serves its int8 detections bit for bit; an uncalibrated
    one is refused.
  * ``python -m double_yolo_kaist_torch.export_model`` writes a file that
    serves; a flipped byte fails the sha256 check; a JAX ``.dykx`` and a
    program exported for another device are refused, each saying why.
  * The loading host imports no model code: a subprocess that loads and
    serves an artifact has imported no ``double_yolo_kaist_torch.models``,
    ``.config`` or ``.serving`` module.
  * Against JAX: the narrowed flagship exported by each package (fp32,
    the same weights) serves the same detections, within the bounds of
    ``tests/test_torch_serving.py::test_packed_body_matches_jax_full_
    program`` (the same valid slots; boxes and scores within rtol 1e-4 /
    atol 1e-3, the same fp32 math summed in another order).
  * ``cuda`` case (skips here): on the card the exported program's graph
    replay equals the Predictor's graph replay bit for bit, with the same
    K1-K4 launches a replay.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.export import (ExportedPredictor,
                                            export_serving_artifact)
from double_yolo_kaist_torch.export_model import main as export_main
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.serving import Predictor

try:        # the card's machine has no JAX: only the cuda case runs there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.export import (
        ExportedPredictor as JaxExportedPredictor)
    from double_yolo_kaist_tpu.export import (
        export_serving_artifact as jax_export)
    from double_yolo_kaist_tpu.serving import Predictor as JaxPredictor
    from tests.test_torch_slice import (flagship_variables,
                                        write_narrow_flagship)
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")
SRC_HW = (96, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread (as ``tests/test_torch_quantize.py::one_thread``
    argues: the CPU's fp32 rounding depends on the thread split, which an
    int8 forward compounds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tiny_predictor(**kw):
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    return Predictor(ir, TG.init(ir, 0), img_size=64, conf_thres=0.005,
                     batch_buckets=(2,), compute_dtype=torch.float32,
                     device="cpu", **kw)


def _frames(n, seed=0, hw=SRC_HW):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8),
            rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8))


def _assert_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g[0]) == len(w[0])
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_exported_matches_predictor(tmp_path):
    pred = _tiny_predictor()
    path = str(tmp_path / "tiny.zip")
    meta = export_serving_artifact(pred, SRC_HW, 2, path)
    assert meta["platforms"] == ["cpu"] and meta["runtime"] == "torch"
    assert meta["int8"] is False and meta["torch_version"] == torch.__version__
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.pt2",
                                         "variables.npz"]
    loaded = ExportedPredictor(path, device="cpu")
    assert loaded.src_hw == SRC_HW and loaded.batch == 2
    v, l = _frames(3)                   # 2 + a chunk of 1, padded
    out = loaded(v, l)
    assert sum(len(b) for b, _, _ in out) > 0
    _assert_identical(out, pred(v, l))


def test_exported_warmup_and_frame_size_check(tmp_path):
    pred = _tiny_predictor()
    path = str(tmp_path / "tiny.zip")
    export_serving_artifact(pred, SRC_HW, 2, path)
    loaded = ExportedPredictor(path, device="cpu")
    loaded.warmup()
    with pytest.raises(ValueError, match="compiled for frames"):
        loaded(np.zeros((1, 64, 64, 3), np.uint8))


@pytest.mark.parametrize("mode", ["chain", "edge", "spineall"])
def test_export_int8_roundtrip(tmp_path, mode):
    qpath = str(tmp_path / "q.npz")
    pred = _tiny_predictor(int8=True, int8_mode=mode, calibration_batches=1,
                           quantized=qpath)
    v, l = _frames(2, seed=3)
    pred(v, l)                          # calibrates, quantizes, saves
    assert pred.qvars is not None and os.path.exists(qpath)
    path = str(tmp_path / "tiny_int8.zip")
    meta = export_serving_artifact(pred, SRC_HW, 2, path)
    assert meta["int8"] is True and meta["int8_mode"] == mode
    v, l = _frames(3, seed=4)
    _assert_identical(ExportedPredictor(path, device="cpu")(v, l),
                      pred(v, l))


def test_export_int8_flagship_holds_k4(tmp_path):
    """The narrowed flagship in int8 chain: its program holds K1, K2 and
    the chain's ten 1x1 convs (K4) as registered operators and serves the
    Predictor's detections bit for bit. (Narrowed, its stem convs take 8
    channels, which K3 does not: the card holds K3 in an exported program,
    ``chip_smoke.py`` phase 15.)"""
    cfg = write_narrow_flagship(tmp_path)
    ir = compile_cfg(cfg)
    tv = TW.from_jax_variables(ir, flagship_variables(jax_compile_cfg(cfg)))
    pred = Predictor(ir, tv, img_size=96, conf_thres=0.01,
                     batch_buckets=(2,), compute_dtype=torch.float32,
                     int8=True, calibration_batches=1, device="cpu")
    v, l = _frames(2, seed=6, hw=(64, 96))
    pred(v, l)
    path = str(tmp_path / "flag.zip")
    export_serving_artifact(pred, (64, 96), 2, path)
    with zipfile.ZipFile(path) as zf:
        program = torch.export.load(io.BytesIO(zf.read("program.pt2")))
    called = [str(n.target) for n in program.graph.nodes
              if n.op == "call_function"]
    k4 = sum("k4" in p.get("q", p) for p in pred.qvars["params"].values()
             if isinstance(p, dict))
    assert k4 == 10
    for op, n in (("decode_heads_into", 1), ("nms_indices", 1),
                  ("qgemm", k4)):
        assert called.count(f"dyk.{op}.default") == n, op
    v, l = _frames(2, seed=7, hw=(64, 96))
    _assert_identical(ExportedPredictor(path, device="cpu")(v, l),
                      pred(v, l))


def test_export_refuses_uncalibrated_int8(tmp_path):
    pred = _tiny_predictor(int8=True, calibration_batches=4)
    with pytest.raises(ValueError, match="not quantized yet"):
        export_serving_artifact(pred, SRC_HW, 2, str(tmp_path / "no.zip"))


def test_export_model_entry_point(tmp_path, capsys):
    out = str(tmp_path / "cli.zip")
    meta = export_main(["--cfg", TINY, "--img-size", "64", "--src-hw",
                        "96", "128", "--batch", "1", "--conf-thres",
                        "0.005", "--out", out, "--device", "cpu"])
    assert os.path.exists(out) and meta["batch"] == 1
    assert f"wrote {out}" in capsys.readouterr().out
    v, l = _frames(1, seed=5)
    assert len(ExportedPredictor(out, device="cpu")(v, l)) == 1


def _rewrite(src, dst, **members):
    with zipfile.ZipFile(src) as zf:
        data = {n: zf.read(n) for n in zf.namelist()}
    data.update(members)
    with zipfile.ZipFile(dst, "w") as zf:
        for n, b in data.items():
            zf.writestr(n, b)
    return data


def test_export_integrity_check(tmp_path):
    path = str(tmp_path / "tiny.zip")
    export_serving_artifact(_tiny_predictor(), SRC_HW, 2, path)
    with zipfile.ZipFile(path) as zf:
        blob = bytearray(zf.read("variables.npz"))
    blob[len(blob) // 2] ^= 0xFF
    bad = str(tmp_path / "bad.zip")
    _rewrite(path, bad, **{"variables.npz": bytes(blob)})
    with pytest.raises(ValueError, match="sha256 mismatch"):
        ExportedPredictor(bad, device="cpu")


def test_refuses_other_device_and_jax_artifacts(tmp_path):
    path = str(tmp_path / "tiny.zip")
    export_serving_artifact(_tiny_predictor(), SRC_HW, 2, path)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    meta["platforms"] = ["cuda"]
    other = str(tmp_path / "cuda.zip")
    _rewrite(path, other, **{"meta.json": json.dumps(meta)})
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        ExportedPredictor(other, device="cpu")
    # a JAX package artifact of the same model
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    from double_yolo_kaist_tpu.models import graph as JG
    jp = JaxPredictor(jir, JG.init(jir, jax.random.PRNGKey(0)), img_size=64,
                      batch_buckets=(2,), compute_dtype=jnp.float32)
    dykx = str(tmp_path / "tiny.dykx")
    jax_export(jp, SRC_HW, 2, dykx, platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX package artifact"):
        ExportedPredictor(dykx, device="cpu")


def test_loader_imports_no_model_code(tmp_path):
    path = str(tmp_path / "tiny.zip")
    pred = _tiny_predictor()
    export_serving_artifact(pred, SRC_HW, 2, path)
    v, l = _frames(2, seed=8)
    np.savez(tmp_path / "frames.npz", v=v, l=l)
    want = pred(v, l)
    code = (
        "import sys, numpy as np\n"
        "from double_yolo_kaist_torch.export import ExportedPredictor\n"
        f"f = np.load({str(tmp_path / 'frames.npz')!r})\n"
        f"out = ExportedPredictor({path!r}, device='cpu')(f['v'], f['l'])\n"
        "bad = sorted(m for m in sys.modules if m.startswith(\n"
        "    ('double_yolo_kaist_torch.models', 'double_yolo_kaist_torch."
        "config', 'double_yolo_kaist_torch.serving', 'jax',\n"
        "     'double_yolo_kaist_tpu')))\n"
        "assert not bad, bad\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, "
        "*[a for d in out for a in d])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(tmp_path / "out.npz") as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    for a, b in zip(got, [a for d in want for a in d]):
        np.testing.assert_array_equal(a, b)


def test_exported_matches_jax_exported(tmp_path):
    """The narrowed flagship, exported by each package in fp32 from the
    same seeded weights: the same detections per frame within the
    Predictor parity bounds."""
    cfg = write_narrow_flagship(tmp_path)
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    jv = flagship_variables(jir)
    kw = dict(img_size=96, conf_thres=0.01, batch_buckets=(2,))
    jp = JaxPredictor(jir, jv, compute_dtype=jnp.float32, **kw)
    tp = Predictor(tir, TW.from_jax_variables(tir, jv),
                   compute_dtype=torch.float32, device="cpu", **kw)
    hw = (64, 96)
    jax_export(jp, hw, 2, str(tmp_path / "j.dykx"), platforms=("cpu",))
    export_serving_artifact(tp, hw, 2, str(tmp_path / "t.zip"))
    v, l = _frames(2, seed=9, hw=hw)
    want = JaxExportedPredictor(str(tmp_path / "j.dykx"))(v, l)
    got = ExportedPredictor(str(tmp_path / "t.zip"), device="cpu")(v, l)
    assert sum(len(b) for b, _, _ in want) > 0
    for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
        assert len(gb) == len(wb)
        np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.cuda
def test_exported_graph_equals_predictor_graph_on_card(tmp_path):
    """MNv3 (fixture weights, bf16) at 64x96, batch 2: the exported
    program's captured replay against the Predictor's captured replay on
    the same frames, bit for bit, and the same K1 / K2 launches a
    replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ir = compile_cfg(MNV3)
    pred = Predictor(ir, TW.load_state_dict_npz(ir, NPZ), img_size=96,
                     conf_thres=0.01, batch_buckets=(2,))
    path = str(tmp_path / "mnv3.zip")
    export_serving_artifact(pred, (64, 96), 2, path)
    loaded = ExportedPredictor(path)
    pred.warmup((64, 96), 2)
    loaded.warmup()
    v, l = _frames(2, seed=10, hw=(64, 96))
    runs = []
    for serve in (pred, loaded):
        _build.launches.clear()
        out = serve(v, l)
        runs.append((out, dict(_build.launches)))
    (want, lw), (got, lg) = runs
    _assert_identical(got, want)
    assert lg == lw and lw["decode_head"] == 1 and lw["nms_indices"] == 1
