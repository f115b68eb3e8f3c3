"""The fused K-step's ``double_buffer`` and the port's
``fused_train_probe``, on the CPU.

  * ``make_fused_multi_step(double_buffer=True)`` against the plain fused
    call (the JAX package holds its own double buffer to the plain scan,
    ``tests/test_multi_step.py:127-170``): ``tests/fixtures/
    tiny_dyolov3.cfg``, K = 3, bs 2, the default augment (the matmul
    route): the same batches, generators and step order, so the state
    (params, BN state, optimizer state) and the metrics are equal, bit for
    bit; with ``images_in`` it raises, as JAX's does;
  * ``python -m double_yolo_kaist_torch.fused_train_probe --device cpu``
    on the tiny cfg: every leg prints its line and returns a positive
    rate, the stages a time each;
  * the ``cuda`` case (the card's run; it skips here): the double buffer
    on the card (batch i + 1 augmented on a side stream while step i
    replays) against the plain captured call, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data import pipeline as TPL
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.train import optim as TO
from double_yolo_kaist_torch.train import step as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0,
       "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
       "momentum": 0.937, "weight_decay": 5e-4, "lr0": 0.01, "lrf": 0.1,
       "hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36, "degrees": 0.0,
       "translate": 0.1, "scale": 0.5, "shear": 0.0}
SRC_HW, K, B, N = (128, 160), 3, 2, 8


def _fused_runs(device):
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(tir, 2)
    rng = np.random.default_rng(11)
    pool_v, pool_l = (torch.from_numpy(rng.integers(
        0, 256, (N,) + SRC_HW + (3,), np.uint8)).to(device)
        for _ in range(2))
    t = np.zeros((K, 4 * B, 4, 5), np.float32)
    t[..., 0, 1:] = (0.5, 0.5, 0.2, 0.4)
    m = np.zeros((K, 4 * B, 4), bool)
    m[..., 0] = True
    xs = {"b0": torch.arange(K) * B,
          "load": torch.from_numpy(rng.integers(0, N, (K, 4 * B))).long()
          .to(device),
          "targets": torch.from_numpy(t).to(device),
          "tmask": torch.from_numpy(m).to(device)}
    aug = TPL.make_train_augment_fn(SRC_HW, 64, HYP, from_pool=True)
    assert aug.resample == "matmul"
    out = []
    for db in (False, True):
        tx = TO.make_optimizer(HYP, lambda s: 1e-3, sgd=True)
        st = TS.create_train_state(tir, 0, tx, variables=tv, device=device)
        fused = TS.make_fused_multi_step(tir, HYP, tx, aug,
                                         compute_dtype=torch.float32,
                                         double_buffer=db)
        st, met = fused(st, pool_v, pool_l, xs, 3)
        out.append((st, met))
    return out


def _equal(out):
    (s1, m1), (s2, m2) = out
    assert s1.step == s2.step == K
    for k in TS.METRICS:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(TS._state_leaves(s1), TS._state_leaves(s2)):
        assert torch.equal(a, b)


def test_double_buffer_equals_plain_fused():
    _equal(_fused_runs("cpu"))


def test_double_buffer_with_images_in_raises():
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tx = TO.make_optimizer(HYP, lambda s: 1e-3, sgd=True)
    aug = TPL.make_train_augment_fn(SRC_HW, 64, HYP)
    with pytest.raises(ValueError, match="double_buffer"):
        TS.make_fused_multi_step(tir, HYP, tx, aug, images_in=True,
                                 double_buffer=True)


def test_fused_train_probe_on_cpu(capsys):
    from double_yolo_kaist_torch import fused_train_probe
    res = fused_train_probe.main([
        "--model", TINY, "--batch", "2", "--spd", "2", "--img-size", "64",
        "--pool", "8", "--iters", "1", "--dtypes", "f32", "bf16",
        "--resamples", "gather", "matmul", "--stages", "--double-buffer",
        "--device", "cpu"])
    out = capsys.readouterr().out
    rates = {k: v for k, v in res.items() if not k.startswith("stages")}
    assert "step-only K steps" in rates
    for dt in ("f32", "bf16"):
        for rs in ("gather", "matmul"):
            assert f"fused aug+train pix={dt} {rs}" in rates
            assert f"augment-only x2 pix={dt} {rs}" in rates
            stages = res[f"stages {dt} {rs}"]
            assert list(stages) == ["gather+resize", "mosaic", "affine",
                                    "hsv+flip"]
            assert all(v > 0 for v in stages.values())
        for db in ("plain", "DOUBLE-BUF"):
            assert f"fused {db} pix={dt} (matmul) #2" in rates
    assert all(v > 0 for v in rates.values())
    assert out.count("on cpu") >= len(rates) + 4
    assert "% of step-only" in out


@pytest.mark.cuda
def test_double_buffer_equals_plain_fused_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _equal(_fused_runs("cuda"))
