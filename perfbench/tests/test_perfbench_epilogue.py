"""Kernel K5's bytes and the reader of its share of the roofline."""

import os
import types

import pytest

from perfbench import harness
from perfbench.reference import cfg as RC
from perfbench.rooflines import epilogue
from perfbench.tests.conftest import ROOT
from perfbench.trace import Trace

CONFIG = os.path.join(ROOT, "perfbench", "configs",
                      "Double-YOLOv4-Fshare-Global-CSE3")
K5_NAMES = [f"void (anonymous namespace)::{k}<__nv_bfloat16, {a}>"
            "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
            "long long, int, int)"
            for k, a in (("bias_act_kernel", 2), ("bias_act_kernel", 1),
                         ("bias_act_kernel_scalar", 0))]


def _flagship():
    return RC.build(os.path.join(CONFIG,
                                 "kaist_dyolov4_fshare_global_concat_se3.cfg"),
                    [8, 16, 32], "yolov4")


def _ctx(kernels):
    mix = harness.read_json(os.path.join(ROOT, "perfbench", "traffic",
                                         "serve_closed.json"))
    trace = Trace()
    trace.kernels = kernels
    return types.SimpleNamespace(model=_flagship(), mix=mix, trace=trace)


def _reader():
    return harness.load_file_module(
        os.path.join(ROOT, "perfbench", "metrics",
                     "epilogue_roofline.serve.py"), "t_epilogue_roofline")


def test_flagship_bytes_a_request():
    """183 launches a forward (185 convs less the two stems); a bf16
    request of 8 pairs at 448x512 moves 3.94 GB through them."""
    m = _flagship()
    convs = epilogue.launched(m)
    sh = RC.shapes(m, 448, 512)
    total = sum(epilogue.bytes_moved(8, *sh[L.i]) for L in convs)
    assert len(convs) == 183
    assert total / 1e9 == pytest.approx(3.94, rel=0.01)
    assert epilogue.bound_s(8, 64, 224, 256) == pytest.approx(
        (8 * 64 * 224 * 256 * 4 + 128) / 3.35e12)


def test_reader_gives_the_share():
    """Ten forwards' launches (mish, leaky and the heads' scalar walk) in
    50 ms of device time: 10 x the bound of a forward (3.94 GB at 3.35
    TB/s) over 50 ms."""
    kernels = dict(zip(K5_NAMES, ([1450, 0.04], [350, 0.009], [30, 0.001])))
    got = _reader().read(_ctx({**kernels, "other_kernel": [10, 0.5]}))
    m = _flagship()
    sh = RC.shapes(m, 448, 512)
    forward = sum(epilogue.bytes_moved(8, *sh[L.i])
                  for L in epilogue.launched(m)) / 3.35e12
    assert got == pytest.approx(100.0 * 10 * forward / 0.05, rel=1e-12)
    assert got == pytest.approx(100.0 * 10 * 3.935e9 / 3.35e12 / 0.05,
                                rel=1e-3)


def test_reader_gives_nothing_without_k5():
    assert _reader().read(_ctx({"other_kernel": [10, 0.5]})) is None
