"""The port's compile_cfg gives the same GraphIR as the JAX package's, on
the tiny test cfg and on all 25 detection cfgs of ``configs/``."""

import dataclasses
import os

import numpy as np
import pytest

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_torch.config.ir import compile_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [
    ("tests/fixtures/tiny_dyolov3.cfg", [8, 4]),
    ("configs/kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg", None),
    ("configs/kaist_dyolov4_fshare_global_concat_se3.cfg", None),
]
# every other detection cfg of configs/ (the 16 zoo models' among them),
# strides from the filename as the entry points derive them
CASES += [(f"configs/{f}", None)
          for f in sorted(os.listdir(os.path.join(REPO, "configs")))
          if f.startswith("kaist_") and f.endswith(".cfg")
          and (f"configs/{f}", None) not in CASES]


@pytest.mark.parametrize("cfg,strides", CASES, ids=[c[0] for c in CASES])
def test_compile_cfg_matches_jax(cfg, strides):
    path = os.path.join(REPO, cfg)
    ref = jax_compile_cfg(path, yolo_strides=strides)
    mine = compile_cfg(path, yolo_strides=strides)
    assert mine.consumed == ref.consumed
    assert mine.routs == ref.routs
    assert mine.yolo_indices == ref.yolo_indices
    assert mine.second_index == ref.second_index
    assert len(mine.nodes) == len(ref.nodes)
    for a, b in zip(mine.nodes, ref.nodes):
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb)
                assert va.dtype == vb.dtype
            else:
                assert va == vb, (b.index, f.name, va, vb)
