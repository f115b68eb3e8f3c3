"""The FLOP count and the kernels' bytes and operations."""

import os

import pytest

from perfbench import flops
from perfbench.reference import cfg as RC
from perfbench.rooflines import decode, stem
from perfbench.tests.conftest import DATA, ROOT


def _model(name, cfg, strides):
    return RC.build(os.path.join(*name, cfg), strides, "yolov4")


def test_tiny_count_by_hand():
    m = RC.build(os.path.join(DATA, "configs", "tiny-dual",
                              "tiny_dual.cfg"), [4, 2], "yolov4")
    # at 64x64: (layer, out hw, k, cin, cout)
    convs = [(64, 3, 3, 8), (32, 3, 8, 16), (32, 1, 16, 16),
             (64, 3, 3, 8), (32, 3, 8, 16), (16, 3, 32, 32),
             (16, 1, 64, 32), (16, 1, 32, 18), (32, 1, 64, 18)]
    want = sum(2 * hw * hw * k * k * ci * co for hw, k, ci, co in convs)
    want += 2 * 32 * 32 * (9 * 16 + 16 * 16)      # the depthwise block
    want += 2 * 2 * 16 * 8                        # SE: 16 -> 8 -> 16
    assert flops.forward_flops(m, 64, 64) == want


@pytest.mark.parametrize("h,w,gflop", [(448, 512, 150.0), (512, 512, 171.4)])
def test_flagship_totals(h, w, gflop):
    m = RC.build(os.path.join(ROOT, "perfbench", "configs",
                              "Double-YOLOv4-Fshare-Global-CSE3",
                              "kaist_dyolov4_fshare_global_concat_se3.cfg"),
                 [8, 16, 32], "yolov4")
    assert round(flops.forward_flops(m, h, w) / 1e9, 1) == gflop


def test_kernel_counts_at_512x640():
    """K1 and K3 at a batch of 8 frames of 512x640, as the port's kernel
    table counts them: 5.81 MB; 251.7 MB and 24.2 GFLOP."""
    rows = 3 * (64 * 80 + 32 * 40 + 16 * 20)
    assert round(decode.bytes_moved(8, rows, 6) / 1e6, 2) == 5.81
    assert round(stem.bytes_moved(8, 512, 640, 32, 64) / 1e6, 1) == 251.7
    assert round(stem.flops(8, 512, 640, 32, 64) / 1e9, 1) == 24.2
    assert stem.bound_s(8, 512, 640, 32, 64) == pytest.approx(251.65824e6
                                                              / 3.35e12)
