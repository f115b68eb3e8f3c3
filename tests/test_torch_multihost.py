"""Rank-0 write gating and the one-process defaults of the port's
``parallel/multihost.py``, the cases of ``tests/test_multihost.py`` (the
reference's save_on_master semantics, distributed_utils.py:283-297).
Checkpoints, ``results.txt`` and TensorBoard are written by the main
process only; without ``DYK_DISTRIBUTED=1`` or a coordinator nothing
joins a group, and the fixed-shape gather is the identity."""

import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.parallel import multihost as JMH
from double_yolo_kaist_torch.parallel import multihost as MH
from double_yolo_kaist_torch.utils import checkpoint as CK
from double_yolo_kaist_torch.utils import logging as LG


def test_single_process_defaults(monkeypatch):
    monkeypatch.delenv("DYK_DISTRIBUTED", raising=False)
    assert MH.is_main_process() and JMH.is_main_process()
    assert MH.process_index() == JMH.process_index() == 0
    assert MH.process_count() == 1
    # no env trigger -> no-op, returns False
    assert MH.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert MH.data_group() is None
    # allgather is the identity at process_count 1, as JAX's
    tree = {"a": np.arange(4), "t": torch.ones(2)}
    out = MH.allgather_predictions(tree)
    np.testing.assert_array_equal(out["a"], JMH.allgather_predictions(
        {"a": np.arange(4)})["a"])
    assert out["t"] is tree["t"]


def test_save_checkpoint_gated(tmp_path, monkeypatch):
    monkeypatch.setattr(MH, "is_main_process", lambda: False)
    p = str(tmp_path / "ck")
    CK.save_checkpoint(p, params={"w": np.zeros(2)}, bn_state={})
    assert not os.path.exists(p)
    monkeypatch.setattr(MH, "is_main_process", lambda: True)
    CK.save_checkpoint(p, params={"w": np.zeros(2)}, bn_state={})
    assert os.path.exists(os.path.join(p, "arrays.npz"))


def test_results_writer_gated(tmp_path, monkeypatch):
    monkeypatch.setattr(MH, "is_main_process", lambda: False)
    w = LG.ResultsWriter(str(tmp_path / "r.txt"))
    w.append(0, np.zeros(12), 1.0, 1e-3)
    w.write_text("x")
    assert not os.path.exists(w.path)
    monkeypatch.setattr(MH, "is_main_process", lambda: True)
    w.append(0, np.zeros(12), 1.0, 1e-3)
    assert os.path.exists(w.path)


def test_tb_writer_gated(tmp_path, monkeypatch):
    monkeypatch.setattr(MH, "is_main_process", lambda: False)
    tb = LG.make_tb_writer(str(tmp_path / "tb"))
    tb.add_scalar("x", 1.0, 0)   # must be a no-op stub
    tb.close()
    assert not os.path.exists(str(tmp_path / "tb"))


def test_trainer_save_gated(tmp_path, monkeypatch):
    """The trainer's ``save`` writes nothing off the main process."""
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.train.trainer import Trainer
    from tests.test_torch_dp_train import HYP, TINY

    monkeypatch.setattr(MH, "is_main_process", lambda: False)
    tr = Trainer(compile_cfg(TINY, yolo_strides=[8, 4]), HYP, epochs=1,
                 batch_size=2, img_size=64, device="cpu",
                 compute_dtype=torch.float32, out_dir=str(tmp_path))
    tr.save(str(tmp_path / "last"), 0)
    assert not (tmp_path / "last").exists()
    monkeypatch.setattr(MH, "is_main_process", lambda: True)
    tr.save(str(tmp_path / "last"), 0)
    assert (tmp_path / "last" / "manifest.json").exists()


def test_several_devices_and_uncapturable_backends_refuse(monkeypatch):
    """A Trainer given several devices of one process raises ValueError
    with the launch line (the port trains one process a card); a captured
    K-step dispatch over a gloo group raises naming the backend, since
    gloo's collectives cannot be captured in a CUDA graph."""
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.train import step as TS
    from double_yolo_kaist_torch.train.trainer import Trainer
    from tests.test_torch_dp_train import HYP, TINY

    with pytest.raises(ValueError, match="torch.distributed.run"):
        Trainer(compile_cfg(TINY, yolo_strides=[8, 4]), HYP, epochs=1,
                batch_size=2, devices=["cpu", "cpu"], device="cpu")
    monkeypatch.setattr(MH, "backend_of", lambda group: "gloo")
    steps = TS.CapturedSteps(None, None, group=object())
    with pytest.raises(RuntimeError, match="gloo backend cannot"):
        steps._capture(None, {"v": torch.zeros(1)}, None)
