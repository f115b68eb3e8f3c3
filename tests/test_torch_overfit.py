"""The overfit check (``double_yolo_kaist_torch/overfit_check.py``, which
``bench --check-ap`` runs) and the int8 evaluation it gates.

  * On the CPU the port's check trains the tiny model (60 epochs, 8
    synthetic pairs) and evaluates it in fp32 and through every int8 mode.
    The JAX package's ``evaluate_dataset`` on the same trained weights
    (``models.weights.to_jax_variables``) must give the same AP@0.5 in fp32
    and in each mode, to 1e-9: the AP is a rank statistic of 8 boxes, so
    the same detections give the same number. This holds the whole chain
    the gate reads against the reference on one set of weights; which
    weights a run reaches depends on the summation order of its training
    (the device, the CPU's thread count), and with them how far an int8
    mode lands from fp.
  * ``cuda`` case (skips here): ``evaluate_dataset(int8=True)`` of
    variables that live on the card, in edge mode, gives the predictions
    of the same variables on the CPU evaluated on the card. (It raised
    before: edge mode's quantization met the card's fold with host
    scales.)
"""

import glob
import os
import tempfile

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch import overfit_check as TO
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.utils import tree as TR

try:        # the card's machine has no JAX: only the cuda case runs there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.data.dataset import KaistDataset as JDataset
    from double_yolo_kaist_tpu.eval.evaluator import (evaluate_dataset as
                                                      jax_evaluate)
except ModuleNotFoundError:
    jax = None

MODES = ("seed", "chain", "all", "edge", "spine", "spineall")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_overfit_aps_match_jax_on_the_same_weights(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    trained = {}
    detached = TO._detached

    def keep(state):
        trained["v"] = detached(state)
        return trained["v"]

    monkeypatch.setattr(TO, "_detached", keep)
    fp, int8_aps = TO.main(60, int8=True, device="cpu")
    assert fp > 0.5
    jv = jax.tree.map(jnp.asarray, TW.to_jax_variables(trained["v"]))
    jir = jax_compile_cfg(TO.TINY, yolo_strides=[8, 4])
    split, = glob.glob(os.path.join(str(tmp_path), "*", "train.txt"))
    ds = JDataset(split, 64, 8, rect=True)
    kw = dict(batch_size=8, conf_thres=0.01, compute_dtype=jnp.float32)
    want = jax_evaluate(jir, jv, ds, folded=False, **kw)["ap"]
    assert abs(fp - float(want)) <= 1e-9
    for mode in MODES:
        want = jax_evaluate(jir, jv, ds, int8=True, int8_mode=mode,
                            calibration_batches=1, **kw)["ap"]
        assert abs(int8_aps[(mode, 100.0)] - float(want)) <= 1e-9, mode


@pytest.mark.cuda
def test_int8_eval_of_card_variables(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ir = compile_cfg(TO.TINY, yolo_strides=[8, 4])
    cpu_vars = TG.init(ir, 3)
    card_vars = TR.map_leaves(lambda t: t.cuda(), cpu_vars)
    split = TO.make_dataset(str(tmp_path / "d"))
    ds = KaistDataset(split, 64, 8, rect=True)
    preds = []
    for variables in (cpu_vars, card_vars):
        res = evaluate_dataset(ir, variables, ds, batch_size=8,
                               conf_thres=0.01, compute_dtype=torch.float32,
                               int8=True, int8_mode="edge",
                               calibration_batches=1, device="cuda")
        preds.append(res["predictions"])
    a, b = preds
    assert sorted(a) == sorted(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
