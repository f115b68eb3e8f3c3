"""The port's tools (the modules that replace the JAX package's ``tools/``
scripts) run on the CPU at a tiny size: each ``main`` on the tiny test cfg
or a small zoo model with ``--device cpu``, at 64x96 where the tool takes
a size (``serving_bench`` and ``train_wallclock`` fix KAIST's 512x640
frames, as the JAX tools do), printing what the JAX tool prints. Timings here are the CPU's and mean nothing; the tools' card
figures come from ``chip_smoke.py`` phase 18 and ``PERF.md``.
"""

import json
import os

import numpy as np
import pytest

from double_yolo_kaist_torch import compare_clahe, dataset_preview, int8_ab
from double_yolo_kaist_torch import plot_activations, real_model_overfit
from double_yolo_kaist_torch import serve_loadtest, serving_bench
from double_yolo_kaist_torch import train_wallclock, zoo_bench
from double_yolo_kaist_torch.bench import strip_int8_stems
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.export_model import main as export_main
from double_yolo_kaist_torch.models import graph
from double_yolo_kaist_torch.models import quantize as Q
from tests.test_torch_quantize import one_thread
from tests.test_torch_slice import MNV3, TINY

# torch on one thread in every test (test_torch_quantize.one_thread)
_one_thread = pytest.fixture(autouse=True)(one_thread)
CPU = ["--device", "cpu"]
SMALL = ["--batch", "1", "--height", "64", "--width", "96", "--iters", "1"]
ZOO_KEYS = {"model", "batch", "hw", "device", "bf16_fps", "bf16_repeats",
            "ref_fps", "vs_ref", "wall_s"}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A .data file over 4 seeded 64x80 pairs (train_wallclock's maker)."""
    root = tmp_path_factory.mktemp("split")
    path = train_wallclock.make_dataset(str(root), 4, (64, 80))
    data = root / "m.data"
    data.write_text(f"classes=1\ntrain={path}\nvalid={path}\n")
    return str(data), path


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_zoo_bench_rows_and_table(tmp_path, capsys):
    out = tmp_path / "zoo.jsonl"
    rc = zoo_bench.main(["--models", "Double-YOLOv3-Global-Fshare-CSE3",
                         "Visible-YOLOv4-MobileNetv3", "--int8",
                         "--out", str(out), *SMALL, *CPU])
    assert rc == 0
    chain, mnv3 = _rows(out)
    assert set(chain) == ZOO_KEYS | {"int8_fps", "int8_repeats"}
    assert chain["int8_fps"] > 0 and chain["bf16_fps"] > 0
    assert chain["hw"] == [64, 96] and chain["device"] == "cpu"
    assert chain["vs_ref"] == round(chain["int8_fps"] / chain["ref_fps"], 1)
    # the MobileNet chain plan is empty: no int8 leg, said so
    assert set(mnv3) == ZOO_KEYS | {"int8_plan"}
    assert mnv3["int8_plan"] == "empty"
    table = capsys.readouterr().out
    assert "| Model | bf16 fps | int8 fps | ref GPU fps | speedup |" in table
    assert "| Visible-YOLOv4-MobileNetv3 |" in table
    assert "bf16 (empty plan)" in table


def test_zoo_bench_failed_row_exits_1(tmp_path, capsys):
    out = tmp_path / "zoo.jsonl"
    rc = zoo_bench.main(["--models", "No-Such-Model",
                         "Visible-YOLOv4-MobileNetv2", "--out", str(out),
                         *SMALL, *CPU])
    assert rc == 1
    bad, good = _rows(out)
    assert "error" in bad and "No-Such-Model" in bad["error"]
    assert "error" not in good and good["bf16_fps"] > 0  # the sweep went on
    assert "| No-Such-Model | ERROR |" in capsys.readouterr().out


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_serving_bench(int8, capsys):
    res = serving_bench.main(["--model", TINY, "--batch", "2", "--n", "2",
                              *(["--int8"] if int8 else []), *CPU])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    mode = "int8" if int8 else "bf16"
    assert line.startswith(f"serving e2e ({TINY}, {mode}, bs2): ")
    assert "letterbox+forward+NMS+fetch included" in line
    assert line.endswith("on cpu")
    assert res["img_s"] > 0 and res["mode"] == mode


def test_serving_bench_int8_on_an_empty_plan(capsys):
    """MNv3's chain plan is empty: ``--int8`` serves bf16 (no calibration
    to wait for) and says so."""
    res = serving_bench.main(["--model", MNV3, "--batch", "1", "--n", "1",
                              "--int8", *CPU])
    assert res["mode"] == "bf16 (int8 plan empty)" and res["img_s"] > 0
    assert "bf16 (int8 plan empty), bs1)" in capsys.readouterr().out


def test_serving_bench_exported(tmp_path, capsys):
    art = str(tmp_path / "tiny.zip")
    export_main(["--cfg", TINY, "--img-size", "96", "--src-hw", "64", "96",
                 "--batch", "2", "--out", art, *CPU])
    capsys.readouterr()
    res = serving_bench.main(["--exported", art, "--batch", "4", "--n", "2",
                              *CPU])
    out = capsys.readouterr().out
    assert "# --batch 4 ignored: artifact compiled for batch 2" in out
    assert "# artifact src_hw (64, 96) (not the KAIST 512x640)" in out
    assert "(tiny.zip, bf16 exported, bs2)" in out
    assert res["batch"] == 2 and res["img_s"] > 0
    with pytest.raises(SystemExit, match="precision is baked"):
        serving_bench.main(["--exported", art, "--int8", *CPU])


def test_serve_loadtest_inproc(capsys):
    lines = serve_loadtest.main(["--inproc", "--cfg", TINY, "--img-size",
                                 "96", "--hw", "64", "96", "--concurrency",
                                 "1", "4", "--requests", "8", *CPU])
    printed = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == json.loads(json.dumps(lines))
    assert [x["concurrency"] for x in lines] == [1, 4]
    for x in lines:
        assert x["requests"] == 8 and x["fps"] > 0
        assert x["p50_ms"] <= x["p95_ms"] <= x["p99_ms"]
        assert x["mean_batch"] >= 1 and x["device"] == "cpu"
        assert {"batches", "frames", "mean_batch"} <= set(x["microbatch"])
    assert lines[0]["mean_batch"] == 1.0       # one client: one frame a batch


def test_serve_loadtest_spawn_against_serve(capsys):
    """``--spawn``: ``python -m double_yolo_kaist_torch.serve`` on the tiny
    cfg, bound to a port of the system's choosing (``--port 0``, read back
    from its banner), answers every request of each level over HTTP."""
    lines = serve_loadtest.main(["--spawn", "--cfg", TINY, "--img-size",
                                 "96", "--hw", "64", "96", "--payload",
                                 "raw", "--concurrency", "1", "4",
                                 "--requests", "8", "--port", "0", *CPU])
    out = capsys.readouterr().out
    assert "# spawned server bound port " in out
    assert int(out.split("# spawned server bound port ")[1].split()[0]) > 0
    assert [x["concurrency"] for x in lines] == [1, 4]
    for x in lines:
        assert x["requests"] == 8 and x["rps"] > 0 and x["device"] == "cpu"
        assert x["p50_ms"] <= x["p95_ms"] <= x["p99_ms"]
        assert x["mean_batch"] >= 1
        assert {"batches", "frames", "size_hist"} <= set(x["microbatch"])
    # the warm-up level and both levels went through the server's batcher
    assert lines[-1]["microbatch"]["frames"] == 8 + 8 + 8


def test_serve_loadtest_refuses_above_64():
    with pytest.raises(SystemExit, match="up to 64"):
        serve_loadtest.main(["--inproc", "--concurrency", "128", *CPU])


def test_train_wallclock(tmp_path, capsys):
    res = train_wallclock.main(["--images", "4", "--epochs", "1", "--batch",
                                "2", "--img-size", "64", "--model", TINY,
                                "--spd", "1",
                                "--remat", "0", "--root", str(tmp_path),
                                *CPU])
    out = capsys.readouterr().out
    assert "[wallclock] epoch 0: " in out
    assert "[wallclock] 1 epochs x 4 imgs (bs2, 64px, spd=1, remat=0)" in out
    assert "KAIST 7989-img epoch = " in out and out.rstrip().endswith(
        "on cpu")
    assert len(res["epoch_s"]) == 1 and res["img_s"] > 0


def test_int8_ab_two_modes(capsys):
    best = int8_ab.main(["--model", TINY, "--modes", "chain", "edge",
                         "--rounds", "2", "--batch", "2", "--height", "64",
                         "--width", "96", "--iters", "1", *CPU])
    out = capsys.readouterr().out
    assert set(best) == {"chain", "edge"} and min(best.values()) > 0
    assert out.count("# round ") == 2
    assert "chain: " in out and "edge: " in out


@pytest.mark.parametrize("mode, names", [
    ("chain-qgemm", "K4"), ("edge+qgemm", "K4")])
def test_int8_ab_refuses_jax_suffixes(mode, names):
    with pytest.raises(SystemExit, match=names):
        int8_ab.main(["--modes", "chain", mode, *CPU])


def test_int8_ab_fpstem(capsys):
    """``+fpstem`` runs as in JAX's tools/int8_ab.py: the base mode,
    quantized for the run's size, less the int8 stems' leaves."""
    best = int8_ab.main(["--model", TINY, "--modes", "chain",
                         "chain+fpstem", "--rounds", "1", "--batch", "1",
                         "--height", "64", "--width", "96", "--iters", "1",
                         *CPU])
    assert set(best) == {"chain", "chain+fpstem"}
    assert "chain+fpstem: " in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["chain", "edge"])
def test_strip_int8_stems(mode):
    """What ``+fpstem`` serves: quantize with int8 stems, less the stems'
    leaves, is the quantization without them, leaf for leaf (edge keeps
    the stems' ``stem_out_*``, as JAX's strip does)."""
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    folded = graph.fold_batchnorm(ir, graph.init(ir, 0))
    rng = np.random.default_rng(0)
    stats = {}
    for n in ir.nodes:
        if n.kind == "conv":
            stats[f"l{n.index}"] = float(rng.uniform(0.5, 8.0))
        if n.kind in ("conv", "shortcut", "se"):
            stats[f"l{n.index}.out"] = rng.uniform(0.1, 6.0, n.out_ch)
    with_stems = Q.quantize(ir, folded, stats, mode=mode, hw=(64, 96),
                            int8_stems=True)
    assert any("stem_q" in e for e in with_stems["params"].values())
    got = strip_int8_stems(with_stems)["params"]
    want = Q.quantize(ir, folded, stats, mode=mode, hw=(64, 96))["params"]
    assert sorted(got) == sorted(want)
    for k, e in got.items():
        extra = {"stem_out_s", "stem_out_inv"} if mode == "edge" else set()
        assert set(e) - extra == set(want[k]), k


def test_real_model_overfit(capsys):
    rc = real_model_overfit.main(["--model", TINY, "--steps", "4", "--size",
                                  "64", "96", "--min-ap", "0", *CPU])
    out = capsys.readouterr().out
    assert rc == 0 and "REAL MODEL OVERFIT PASSED" in out
    assert "final AP@0.5 = " in out
    # an AP gate the tiny run cannot reach exits 1
    assert real_model_overfit.main(["--model", TINY, "--steps", "1",
                                    "--size", "64", "96", "--min-ap", "2",
                                    *CPU]) == 1


def _png(path):
    with open(path, "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n" and os.path.getsize(path) > 1000


def test_dataset_preview_writes_png(split, tmp_path):
    out = str(tmp_path / "preview.png")
    assert dataset_preview.main(["--data", split[0], "--img-size", "64",
                                 "--n", "2", "--out", out, *CPU]) == out
    _png(out)


def test_compare_clahe_writes_png(split, tmp_path, capsys):
    image = split[1].replace("train.txt", "images/set00/I00000_visible.jpg")
    out = str(tmp_path / "clahe.png")
    assert compare_clahe.main([image, out, *CPU]) == out
    _png(out)
    assert "of pixels" in capsys.readouterr().out


@pytest.mark.parametrize("panel", ["zoo", "curves"])
def test_plot_activations_writes_png(panel, tmp_path):
    out = str(tmp_path / f"{panel}.png")
    assert plot_activations.main([out, "--panel", panel, *CPU]) == out
    _png(out)


@pytest.mark.parametrize("tool", ["plot_activations", "compare_clahe",
                                  "dataset_preview"])
def test_visual_tools_name_missing_matplotlib(tool, split, monkeypatch,
                                              tmp_path):
    """Without matplotlib each tool exits naming it and writes nothing."""
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = str(tmp_path / "a.png")
    image = split[1].replace("train.txt", "images/set00/I00000_visible.jpg")
    main, argv = {
        "plot_activations": (plot_activations.main, [out]),
        "compare_clahe": (compare_clahe.main, [image, out]),
        "dataset_preview": (dataset_preview.main,
                            ["--data", split[0], "--out", out])}[tool]
    with pytest.raises(SystemExit, match="matplotlib"):
        main([*argv, *CPU])
    assert not os.path.exists(out)


# ------------------------------------------ what the visual tools draw, JAX

@pytest.mark.parametrize("panel", ["zoo", "curves"])
def test_plot_activations_curves_match_jax(panel):
    """The curves each panel draws: the JAX tools' (``tools/
    plot_activations.py``, ``tools/plot_curves.py:104-130``) within 1e-6."""
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.models import layers as JL
    got = plot_activations.curves(panel, "cpu")
    if panel == "zoo":
        x = jnp.linspace(-6, 6, 400)
        want = [(name, x, fn(x)) for name, fn in JL.ACTIVATIONS.items()
                if name != "linear"]
    else:
        z = np.arange(-10, 10, 0.01, dtype=np.float32)
        zj = jnp.asarray(z)
        want = [("(a) Sigmoid", z, 1.0 / (1.0 + np.exp(-z))),
                ("(b) Tanh", z, np.tanh(z)),
                ("(c) Leaky ReLU", z, JL.activate("leaky", zj)),
                ("(d) Mish", z, JL.activate("mish", zj))]
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gx, gy), (name, wx, wy) in zip(got, want):
        np.testing.assert_allclose(gx, np.asarray(wx), rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(gy, np.asarray(wy), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_compare_clahe_arrays_equal_jax(tmp_path):
    """The frame cropped to the tile grid and its CLAHE: byte for byte
    what ``tools/compare_clahe.py`` draws (JAX's ``clahe_batch``), on a
    frame whose sides are off the grid."""
    import cv2
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.data.clahe import clahe_batch
    rng = np.random.default_rng(3)
    frame = (rng.normal(110, 25, (66, 83, 3)).clip(0, 255)
             .astype(np.uint8))
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, frame)
    img = cv2.imread(path)[:, :, ::-1]
    crop, eq, ref = compare_clahe.clahe_arrays(img, "cpu")
    want = img[:64, :80]
    np.testing.assert_array_equal(crop, want)
    np.testing.assert_array_equal(
        eq, np.asarray(clahe_batch(jnp.asarray(want[None])))[0])
    assert ref.shape == eq.shape and ref.dtype == np.uint8


def test_dataset_preview_boxes_match_jax(split):
    """The boxes the preview draws: those of the first batch of JAX's
    ``train_batches`` from ``PRNGKey(seed)`` (``tools/dataset_preview.py``),
    the port's augment given the randoms JAX drew for that batch (the two
    frameworks cannot share a generator) on the same batch plan."""
    import jax
    import torch

    from double_yolo_kaist_torch.data import pipeline as TP
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_tpu.data import pipeline as JP
    from double_yolo_kaist_tpu.data.dataset import KaistDataset as JDataset
    from tests.test_torch_augment import KAIST_HYP, S, _train_draws
    n, seed = 2, 0
    path = split[1]
    jds = JDataset(path, S, n, augment=True, hyp=KAIST_HYP)
    jb, _ = next(iter(JP.train_batches(jds, n, jax.random.PRNGKey(seed),
                                       img_size=S, hyp=KAIST_HYP,
                                       seed_epoch=seed)))
    ds = KaistDataset(path, S, n, augment=True, hyp=KAIST_HYP)
    b0, _, load, t, m, _ = next(iter(TP.train_batch_plan(
        ds, n, [S], seed_epoch=seed)))
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), JP.AUG_STREAM_TAG), b0)
    rv, rl = TP._stack_pairs(ds, load)
    tfn = TP.make_train_augment_fn(tuple(ds.shapes[0][::-1]), S, KAIST_HYP)
    batch = tfn.heavy(rv, rl, torch.from_numpy(t), torch.from_numpy(m),
                      **_train_draws(key, n, KAIST_HYP))
    v, l, boxes = dataset_preview.preview_arrays(batch)
    assert v.shape == l.shape == (n, S, S, 3) and v.dtype == np.uint8
    jt, jm = np.asarray(jb["targets"]), np.asarray(jb["tmask"])
    assert sum(len(b) for b, _ in boxes) > 0
    for i, (b, cls) in enumerate(boxes):
        lab = jt[i][jm[i]]
        want = np.stack([(lab[:, 1] - lab[:, 3] / 2) * S,
                         (lab[:, 2] - lab[:, 4] / 2) * S,
                         (lab[:, 1] + lab[:, 3] / 2) * S,
                         (lab[:, 2] + lab[:, 4] / 2) * S], 1)
        np.testing.assert_allclose(b, want, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(cls, lab[:, 0])


@pytest.mark.parametrize("watch", [False, True], ids=["off", "on"])
def test_peak_memory_hook(watch, tmp_path):
    """``DYK_PEAK_MEMORY``: a process that imports the port reports its
    peak device memory at exit (a SIGTERM ends it through the same exit);
    one that never used the card reports nothing. Unset: nothing changes."""
    import subprocess
    import sys
    path = tmp_path / "peaks.jsonl"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("DYK_PEAK_MEMORY", None)
    if watch:
        env["DYK_PEAK_MEMORY"] = str(path)
    code = ("import signal, double_yolo_kaist_torch\n"
            "print(signal.getsignal(signal.SIGTERM) is signal.SIG_DFL)\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(not watch)
    assert "peak device memory" not in r.stderr    # the CPU only
    assert not path.exists()
