"""The benchmark's plain reference against the measured program, at a
tiny size on the CPU: the same seeded weights and inputs through both,
in float32, must agree to rounding. And the control and the faults of
the check come out as not correct."""

import pytest
import torch

from perfbench.tests.conftest import run_tiny

SERVE_SEED = 2         # a seed whose tiny heads give detections


def test_serve_path_equals_program_in_fp32(tiny_bench):
    out = run_tiny(tiny_bench, "tiny-serve32", SERVE_SEED)
    c, ch = out["counts"], out["checks"]
    assert c["reference_boxes"] > 50
    assert c["due_boxes"] > 20
    assert c["served_boxes"] == c["reference_boxes"]
    assert c["gap_p99"] < 1e-4
    assert c["extra"] == 0 and c["missed"] == 0
    assert ch["gap_excess"]["value"] < -0.99
    assert out["correct"]


def test_bf16_serving_passes_its_limits(tiny_bench):
    assert run_tiny(tiny_bench, "tiny-serve", SERVE_SEED)["correct"]


@pytest.mark.parametrize("variant", ["control", "half", "alter", "nms-none",
                                     "nms-over"])
def test_controls_and_faults_are_not_correct(tiny_bench, variant):
    out = run_tiny(tiny_bench, "tiny-serve", SERVE_SEED, variant)
    assert not out["correct"], out["checks"]


def test_reference_forward_matches_program_forward():
    """The folded forward of the program and the reference's BN-in-
    inference forward, on the tiny dual-stream cfg (every layer kind)."""
    import os
    from double_yolo_kaist_torch.models import graph
    from perfbench import program, weights
    from perfbench.reference import cfg as RC, model as RM
    from perfbench.tests.conftest import DATA
    cdir = os.path.join(DATA, "configs", "tiny-dual")
    conf = {"cfg_path": os.path.join(cdir, "tiny_dual.cfg"),
            "yolo_strides": [4, 2], "bf_type": "yolov4"}
    m = RC.build(conf["cfg_path"], conf["yolo_strides"], conf["bf_type"])
    W = weights.seeded(m, 11, "cpu")
    ir = program.compile_ir(conf)
    folded = graph.place_folded(ir, graph.fold_batchnorm(
        ir, program.variables(m, W)), "cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    xv, xl = torch.rand((2, 64, 64, 3), generator=g), torch.rand(
        (2, 64, 64, 3), generator=g)
    got, _ = graph.apply_folded(ir, folded, xv, xl,
                                compute_dtype=torch.float32)
    want = RM.decode(m, RM.forward(m, W, xv, xl))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
