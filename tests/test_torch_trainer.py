"""The port's trainer and its entry point, ``python -m
double_yolo_kaist_torch.train``, on the CPU (``--device cpu``): a 4-pair
split of the tiny cfg for 2 epochs writes ``last``, ``best`` and
``results.txt``; ``--resume`` trains on from ``last``; ``--snow`` and
``--clahe`` train with the cutout and CLAHE; ``--steps-per-dispatch 2``
trains, fused and grouped; ``--no-dp`` trains; without CUDA an unset
``--device`` refuses. Also the numpy copies the anchor rewrite needs
(``train/anchors.py``, ``config/writer.py``), equal to JAX's on a seed,
and ``multi_scale_buckets``.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config import parser as TPARSE
from double_yolo_kaist_torch.config import writer as TWR
from double_yolo_kaist_torch.train import anchors as TAN
from double_yolo_kaist_torch.train.cli import main
from double_yolo_kaist_torch.train.trainer import multi_scale_buckets

try:        # the card's machine has no JAX: only the cuda case runs there
    from double_yolo_kaist_tpu.config import parser as JPARSE
    from double_yolo_kaist_tpu.config import writer as JWR
    from double_yolo_kaist_tpu.train import anchors as JAN
    from double_yolo_kaist_tpu.train.trainer import (multi_scale_buckets as
                                                     jax_buckets)
except ModuleNotFoundError:
    JAN = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")

HYP = ("lr0: 0.001\nlrf: 0.1\nmomentum: 0.9\nweight_decay: 0.0005\n"
       "box: 3.54\ncls: 37.4\nobj: 64.3\ncls_pw: 1.0\nobj_pw: 1.0\n"
       "iou_t: 0.2\nanchor_t: 4.0\nfl_gamma: 0.0\nciou: 1.0\n"
       "hsv_h: 0.0138\nhsv_s: 0.678\nhsv_v: 0.36\n"
       "degrees: 0\ntranslate: 0\nscale: 0\nshear: 0\n")


def write_split(root, n=4, hw=(64, 96), seed=0):
    """A KAIST-layout split of ``n`` seeded pairs with 1-3 boxes each."""
    rng = np.random.default_rng(seed)
    (root / "images" / "s").mkdir(parents=True)
    (root / "labels" / "s").mkdir(parents=True)
    logical = []
    for i in range(n):
        for mod in ("visible", "lwir"):
            cv2.imwrite(str(root / "images" / "s" / f"I{i:05d}_{mod}.jpg"),
                        rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        k = int(rng.integers(1, 4))
        rows = [f"0 {x:.4f} {y:.4f} {w:.4f} {h:.4f}\n" for x, y, w, h in
                zip(*rng.uniform(0.2, 0.8, (2, k)),
                    *rng.uniform(0.05, 0.3, (2, k)))]
        (root / "labels" / "s" / f"I{i:05d}.txt").write_text("".join(rows))
        logical.append(str(root / "images" / "s" / f"I{i:05d}.jpg"))
    path = root / "s.txt"
    path.write_text("\n".join(logical) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    path = write_split(root)
    data = root / "m.data"
    data.write_text(f"classes=1\ntrain={path}\nvalid={path}\n")
    hyp = root / "hyp.yaml"
    hyp.write_text(HYP)
    return root, str(data), str(hyp)


def argv(split, *extra):
    root, data, hyp = split
    return ["--cfg", TINY, "--data", data, "--hyp", hyp, "--batch-size",
            "2", "--img-size", "64", "--fp32", "--device", "cpu",
            "--out-dir", str(root / "runs"), *extra]


def results(root, name):
    with open(root / "runs" / name / "results.txt") as f:
        return [x for x in f.read().splitlines() if x.startswith("epoch:")]


def test_train_entry_point_and_resume(split, capsys):
    root, _, _ = split
    main(argv(split, "--epochs", "2", "--name", "t", "--ema"))
    assert "training done" in capsys.readouterr().out
    out = root / "runs" / "t"
    for name in ("last", "best", "results.txt"):
        assert (out / name).exists(), name
    lines = results(root, "t")
    assert [x.split()[0] for x in lines] == ["epoch:0", "epoch:1"]
    assert all(len(x.split()) == 15 for x in lines)    # 12 stats, loss, lr
    with open(out / "last" / "manifest.json") as f:
        man = json.load(f)
    assert man["epoch"] == 1 and man["step"] == 4
    assert any(k.startswith("opt_state/1/1/") for k in man["keys"])  # Adam
    assert "ema/updates" in man["keys"]
    # resume: one more epoch from last, results continued
    main(argv(split, "--epochs", "3", "--name", "t", "--ema", "--resume",
              str(out / "last")))
    lines = results(root, "t")
    assert [x.split()[0] for x in lines] == ["epoch:0", "epoch:1", "epoch:2"]
    with open(out / "last" / "manifest.json") as f:
        man = json.load(f)
    assert man["epoch"] == 2 and man["step"] == 6


def test_train_options(split):
    """SGD, accumulation, frozen layers, multi-scale buckets, remat and
    --save-best False (one checkpoint an epoch) run together."""
    root, _, _ = split
    main(argv(split, "--epochs", "1", "--name", "o", "--sgd",
              "--accumulate", "2", "--freeze-layers", "1", "--multi-scale",
              "--remat-segments", "2", "--save-best", "False", "--notest"))
    out = root / "runs" / "o"
    assert (out / "epoch0").exists() and not (out / "best").exists()
    with open(out / "epoch0" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    # MultiSteps(mask + SGD chain): mini_step, gradient_step, inner, acc
    assert {"opt_state/0", "opt_state/1"} <= set(keys)
    assert any(k.startswith("opt_state/2/1/1/0/") for k in keys)
    assert any(k.startswith("opt_state/3/") for k in keys)


@pytest.mark.parametrize("flag", ["--snow", "--clahe"])
def test_train_snow_clahe(split, flag, monkeypatch):
    """One epoch with the cutout (which CLAHEs the canvas too) or with
    CLAHE in training and evaluation: ``last`` and ``results.txt`` are
    written, and the batches went through the flag's transforms."""
    from double_yolo_kaist_torch.data import augment as TA
    from double_yolo_kaist_torch.data import letterbox as TL
    calls = {"clahe": 0, "cutout": 0}
    clahe_u8, cutout = TL.clahe_u8, TA.snowflake_cutout

    def count_clahe(x):
        calls["clahe"] += 1
        return clahe_u8(x)

    def count_cutout(*a, **kw):
        calls["cutout"] += 1
        return cutout(*a, **kw)

    monkeypatch.setattr("double_yolo_kaist_torch.data.pipeline.clahe_u8",
                        count_clahe)
    monkeypatch.setattr(TA, "snowflake_cutout", count_cutout)
    root, _, _ = split
    name = flag.strip("-")
    main(argv(split, "--epochs", "1", "--name", name, flag))
    out = root / "runs" / name
    assert (out / "last").exists() and (out / "results.txt").exists()
    assert [x.split()[0] for x in results(root, name)] == ["epoch:0"]
    # 2 train batches x 2 streams; --clahe evaluates with CLAHE too
    assert calls["clahe"] == (4 if flag == "--snow" else 4 + 2 * 2)
    assert calls["cutout"] == (2 if flag == "--snow" else 0)


@pytest.mark.parametrize("extra,name", [(["--no-dp"], "nodp")],
                         ids=["extra3-item 12"])  # the id it always had
def test_not_ported_raise(split, extra, name):
    """``--no-dp``, which raised before data parallelism was ported, trains
    one epoch (F4): as in the JAX package it only turns data parallelism
    off."""
    root, _, _ = split
    main(argv(split, "--epochs", "1", "--name", name, *extra))
    assert (root / "runs" / name / "last" / "manifest.json").exists()
    assert [x.split()[0] for x in results(root, name)] == ["epoch:0"]


@pytest.mark.parametrize("cache", ["on", "off"])
def test_steps_per_dispatch_trains(split, capsys, cache):
    """--steps-per-dispatch 2 trains on the CPU: the fused epoch over the
    resident pool (``on``) and the grouped batches of the streaming tier
    (``off``); 4 pairs at batch 2 are one call of 2 steps an epoch."""
    root, _, _ = split
    name = f"k2{cache}"
    main(argv(split, "--epochs", "2", "--name", name, "--ema",
              "--steps-per-dispatch", "2", "--device-cache", cache))
    assert "training done" in capsys.readouterr().out
    assert [x.split()[0] for x in results(root, name)] == [
        "epoch:0", "epoch:1"]
    with open(root / "runs" / name / "last" / "manifest.json") as f:
        assert json.load(f)["step"] == 4


def _default_device(split, *extra):
    return [x for x in argv(split, *extra) if x not in ("--device", "cpu")]


def test_device_defaults_to_cuda(split):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda case trains on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_default_device(split, "--epochs", "1"))


@pytest.mark.cuda
def test_train_entry_point_on_card(split, capsys):
    """Left unset, --device is the card: 2 epochs, then a resume."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, _, _ = split
    main(_default_device(split, "--epochs", "2", "--name", "card"))
    main(_default_device(split, "--epochs", "3", "--name", "card",
                         "--resume", str(root / "runs" / "card" / "last")))
    assert "training done" in capsys.readouterr().out
    assert [x.split()[0] for x in results(root, "card")] == [
        "epoch:0", "epoch:1", "epoch:2"]


@pytest.mark.parametrize("cards, extra, want", [
    (4, ["--batch-size", "8"], 4), (4, ["--batch-size", "6"], 3),
    (4, ["--batch-size", "8", "--no-dp"], 1),
    (1, ["--batch-size", "8"], 1)],
    ids=["4cards-bs8", "4cards-bs6", "no-dp", "1card"])
def test_train_spawns_a_rank_a_card(split, monkeypatch, capsys, cards, extra,
                                    want):
    """F6: with several cards visible and no process group, plain
    ``train`` spawns k ranks, k the largest count of cards that divides
    the batch (JAX trainer.py:100-106), and prints JAX's line;
    ``--no-dp`` and one card train in this process."""
    from double_yolo_kaist_torch.train import cli

    spawned, trained = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("DYK_DISTRIBUTED", raising=False)
    monkeypatch.setattr(cli, "run_ranks",
                        lambda k, args: spawned.append((k, args)) or 0)
    monkeypatch.setattr(cli, "_train", lambda opt: trained.append(opt))
    args = _default_device(split, "--epochs", "1") + extra
    main(args)
    if want > 1:
        assert spawned == [(want, ["-m", "double_yolo_kaist_torch.train",
                                   *args])] and not trained
        bs = int(extra[1])
        assert (f"data parallel: {want}-device mesh ({bs // want} "
                f"images/device)") in capsys.readouterr().out
    else:
        assert not spawned and len(trained) == 1
        assert trained[0].device == "cuda"


def test_multi_scale_buckets_match_jax():
    for s in (64, 320, 416, 512, 640):
        assert multi_scale_buckets(s) == jax_buckets(s)


def test_anchor_evolution_matches_jax():
    rng = np.random.default_rng(0)
    whs = np.abs(rng.normal(40, 20, (300, 2))).astype(np.float32) + 2
    want = JAN.evolve_anchors(whs, n=9, gen=60, seed=3)
    got = TAN.evolve_anchors(whs, n=9, gen=60, seed=3)
    np.testing.assert_array_equal(got, want)
    assert TAN.anchor_fitness(got, whs) == JAN.anchor_fitness(want, whs)


def test_anchor_rewrite_and_writer_match_jax(tmp_path):
    net, blocks = TPARSE.parse_model_cfg(MNV3)
    assert TWR.format_cfg(net, blocks, "h") == JWR.format_cfg(
        *JPARSE.parse_model_cfg(MNV3), "h")
    assert TWR.blocks_equal((net, blocks), JPARSE.parse_model_cfg(MNV3))
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119], [116, 90], [156, 198], [373, 326]])
    paths = []
    for mod in (TAN, JAN):
        p = tmp_path / f"{mod.__name__.split('.')[0]}.cfg"
        p.write_text(open(TINY).read())
        mod.rewrite_cfg_anchors(str(p), anchors * 2)
        paths.append(p.read_text())
    assert paths[0] == paths[1] and "anchors = 20, 26" in paths[0]
