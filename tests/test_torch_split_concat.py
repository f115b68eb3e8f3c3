"""The JAX package's opt-in concat elimination
(``DYK_SPLIT_CONCAT_CONV``) in the port's BN-folded forward, against the
JAX package on the CPU with both packages' switches set alike (their
module flags, as JAX's own test sets its flag).

Tolerances, and why:
  * ``apply_folded`` of MNv3 (its trained fixture weights; five route
    concats deferred) at 64x96, fp32, with ``_SPLIT_CONCAT_CONV`` on
    against JAX's with its switch on: within 1e-5 of the decoded rows'
    scale (pixels and probabilities), the bound JAX holds its own
    rewrite to (``tests/test_forward_parity.py:132-155``); against the
    port's forward without it: the same bound;
  * the int8 chain forward (calibrated and quantized on the tiny cfg) with
    the switch on is the forward without it: equal (JAX's int8 forward
    never defers a concat);
  * the ``cuda`` case (the card's run; it skips here): the deferred MNv3
    forward on the card against the CPU in fp32, TF32 off: within 1e-4
    of the decoded rows' scale.
"""

import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.models import import_weights as JW
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")


def _switch(monkeypatch, on):
    monkeypatch.setattr(TG, "_SPLIT_CONCAT_CONV", on)
    if jax is not None:
        monkeypatch.setattr(JG, "_SPLIT_CONCAT_CONV", on)


def _images(seed, bs=2, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    return (rng.random((bs,) + hw + (3,), np.float32),
            rng.random((bs,) + hw + (3,), np.float32))


def _scale_close(got, want, tol):
    """Within ``tol`` of each decoded column's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(0)
    assert (np.abs(got - want) <= tol * np.maximum(scale, 1.0)).all(), \
        float(np.abs(got - want).max())


# ------------------------------------------------------------ split-concat

def test_split_concat_matches_jax(monkeypatch):
    jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
    deferred = [n.index for n in tir.nodes
                if n.kind == "route" and TG._defer_concat(tir, n)]
    assert deferred == [150, 158, 168, 179, 190]
    with np.load(NPZ) as z:
        jv = jax.tree.map(np.asarray, JW.from_torch_state_dict(
            jir, {k: z[k] for k in z.files}))
    tv = TW.from_jax_variables(tir, jv)
    jf = JG.fold_batchnorm(jir, jv)
    tf = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                         torch.float32)
    xv, xl = _images(3)
    out = {}
    for on in (False, True):
        _switch(monkeypatch, on)
        out[on] = TG.apply_folded(tir, tf, torch.from_numpy(xv),
                                  torch.from_numpy(xl))[0]
    # the convs that took the pieces: one after each deferred concat
    seen = []

    def spy(node, inp, p):
        if isinstance(inp, list):
            seen.append(node.index)
        return TG.conv_folded(node, inp, p)

    TG.run_graph(tir, tf["params"], torch.from_numpy(xv),
                 torch.from_numpy(xl), dtype=torch.float32, conv=spy,
                 split_concat=True)
    assert seen == [i + 1 for i in deferred]
    _switch(monkeypatch, True)
    want, _ = jax.jit(lambda v, a, b: JG.apply_folded(
        jir, v, a, b, compute_dtype=jnp.float32))(jf, jnp.asarray(xv),
                                                  jnp.asarray(xl))
    _scale_close(out[True].numpy(), want, 1e-5)
    _scale_close(out[True].numpy(), out[False].numpy(), 1e-5)


def test_int8_forward_unchanged_by_split_concat(monkeypatch):
    from double_yolo_kaist_torch.models import quantize as TQ
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    folded = TG.fold_batchnorm(tir, TG.init(tir, 2))
    xv, xl = (torch.from_numpy(a) for a in _images(4, hw=(64, 64)))
    stats = TQ.make_calibration_fn(tir, torch.float32)(
        TG.place_folded(tir, folded, "cpu", torch.float32), xv, xl)
    qv = TQ.place_quantized(tir, TQ.quantize(tir, folded, stats, "chain",
                                             hw=(64, 64)),
                            "cpu", torch.float32)
    out = {}
    for on in (False, True):
        _switch(monkeypatch, on)
        out[on] = TQ.apply_quantized(tir, qv, xv, xl,
                                     compute_dtype=torch.float32)[0]
    assert torch.equal(out[True], out[False])



@pytest.mark.cuda
def test_split_concat_card_matches_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(TG, "_SPLIT_CONCAT_CONV", True)
    tir = compile_cfg(MNV3)
    folded = TG.fold_batchnorm(tir, TW.load_state_dict_npz(tir, NPZ))
    xv, xl = (torch.from_numpy(a) for a in _images(3))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {dev: TG.apply_folded(
            tir, TG.place_folded(tir, folded, dev, torch.float32),
            xv.to(dev), xl.to(dev))[0].cpu() for dev in ("cpu", "cuda")}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    _scale_close(out["cuda"].numpy(), out["cpu"].numpy(), 1e-4)
