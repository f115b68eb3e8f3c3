"""K5 (a conv's bias + activation epilogue): the operator on the CPU is the
plain version, its fake keeps the output's layout, ``conv_folded`` keeps
its CPU bits and asks K5 only where K5 takes the input; on the card the
kernel equals the eager ops bit for bit, and the flagship's folded
forward runs it on every conv but the stems.

Every comparison is exact (the bits of the values): K5 stands for the
eager ops and rounds where they round. The file imports no JAX, so that
the card, which has none, runs the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_bias_act.py
"""

import os
import types

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.models import graph as G
from double_yolo_kaist_torch.models import layers as L
from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops import bias_act as K5
from double_yolo_kaist_torch.ops.act import activate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs",
                        "kaist_dyolov4_fshare_global_concat_se3.cfg")
ACTS = ["linear", "leaky", "mish"]
DTYPES = [torch.bfloat16, torch.float32]
CL = torch.channels_last


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (_bits(got) != _bits(want)).sum().item()
    assert diff == 0, f"{diff} of {got.numel()} values differ"


def _output(shape, dtype, seed, device="cpu", scale=4.0):
    """A conv output (B, C, H, W) in channels-last memory and its bias."""
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=g) * scale).to(dtype)
    b = (torch.randn(shape[1], generator=g)).to(dtype)
    return y.to(device).contiguous(memory_format=CL), b.to(device)


def _conv_node(act):
    return types.SimpleNamespace(kind="conv", kernel=3, stride=(1, 1), pad=1,
                                 groups=1, in_ch=16, out_ch=24, act=act,
                                 bn=True)


def _conv_params(dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(24, 16, 3, 3, generator=g) * 0.2).to(dtype)
    return {"w": w.contiguous(memory_format=CL),
            "b": torch.randn(24, generator=g).to(dtype)}


# ----------------------------------------------------------------- the CPU


@pytest.mark.parametrize("layout", ["channels-last", "nchw"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ACTS)
def test_op_on_cpu_is_the_plain_version(act, dtype, layout):
    """The plain version's values, channels-last whatever ``y``'s layout
    (as the kernel writes them)."""
    y, b = _output((2, 24, 5, 7), dtype, seed=1)
    if layout == "nchw":
        y = y.contiguous()
    got = K5.bias_act(y, b, act)
    want = activate(act, y + b.to(y.dtype)[:, None, None])
    _same_bits(got, want)
    assert got.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("layout", ["channels-last", "nchw"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_fake_keeps_shape_dtype_and_channels_last_strides(dtype, layout):
    """The fake gives what the kernel gives: ``y``'s shape and dtype in
    channels-last memory (a program traced by ``torch.export`` may hand
    it a conv output of another layout, as export traces with cuDNN
    off)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    y, b = _output((2, 24, 5, 7), dtype, seed=2)
    K5.bias_act(y, b, "mish")                   # registers the operator
    cl_strides = y.stride()
    if layout == "nchw":
        y = y.contiguous()
    with FakeTensorMode() as mode:
        out = torch.ops.dyk.bias_act(mode.from_tensor(y), mode.from_tensor(b),
                                     "mish")
    assert out.shape == y.shape and out.dtype == y.dtype
    assert out.stride() == cl_strides
    assert out.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("path", ["single", "split"])
@pytest.mark.parametrize("act", ACTS + ["relu6"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_conv_folded_on_cpu_gives_the_eager_bits(act, path, dtype,
                                                 monkeypatch):
    """On the CPU the dispatch never takes K5: the conv adds its own bias
    (as before K5), and the split-concat sum gets the eager epilogue."""
    def no_k5(*a):
        raise AssertionError("K5 asked for on the CPU")
    monkeypatch.setattr(K5, "bias_act", no_k5)
    node, p = _conv_node(act), _conv_params(dtype)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 9, 11, generator=g).to(dtype).contiguous(
        memory_format=CL)
    if path == "single":
        got = G.conv_folded(node, x, p)
        want = activate(act, L.conv2d(x, p["w"], p["b"], stride=(1, 1),
                                      pad=1))
    else:
        pieces = [x[:, :6], x[:, 6:]]
        got = G.conv_folded(node, pieces, p)
        y = (L.conv2d(pieces[0], p["w"][:, :6], stride=(1, 1), pad=1)
             + L.conv2d(pieces[1], p["w"][:, 6:], stride=(1, 1), pad=1))
        want = activate(act, y + p["b"].to(y.dtype)[:, None, None])
    _same_bits(got, want)


def _card_output(dtype=torch.bfloat16, shape=(2, 24, 5, 7), stride=None):
    """A fake CUDA tensor: what the gate reads of a conv output on the
    card (device, dtype, shape, strides, gradient), on a host without
    one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        if stride is None:
            return torch.empty(shape, dtype=dtype, device="cuda",
                               memory_format=CL if len(shape) == 4
                               else torch.contiguous_format)
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="cuda")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ACTS)
def test_gate_takes_the_cards_convs(act, dtype):
    y = _card_output(dtype)
    assert y.device.type == "cuda"
    assert K5.takes(y, act)
    b = torch.zeros(24, dtype=dtype)
    assert K5.takes(y, act, b)


@pytest.mark.parametrize("case,act,make", [
    ("relu6", "relu6", lambda: _card_output()),
    ("hard-swish", "hard-swish", lambda: _card_output()),
    ("fp16", "mish", lambda: _card_output(torch.float16)),
    ("requires-grad", "mish",
     lambda: _card_output(torch.float32).requires_grad_()),
    ("3-d", "leaky", lambda: _card_output(shape=(24, 5, 7))),
    ("cpu", "mish", lambda: _output((2, 24, 5, 7), torch.bfloat16, 5)[0])],
    ids=["relu6-relu6-None-activation",
         "hard-swish-hard-swish-None-activation", "fp16-mish-<lambda>-dtype",
         "requires-grad-mish-<lambda>-gradient", "3-d-leaky-<lambda>-3-d",
         "cpu-mish-None-device cpu"])
def test_gate_refuses(case, act, make):
    """Each case differs from one the gate takes
    (:func:`test_gate_takes_the_cards_convs`) in one property."""
    assert not K5.takes(make(), act)


def test_gate_refuses_a_parameter_that_wants_a_gradient():
    """The bias or the weight of a conv: K5 has no backward."""
    y = _card_output(torch.float32)
    w = torch.zeros(24, 16, 3, 3, requires_grad=True)
    b = torch.zeros(24)
    assert not K5.takes(y, "mish", w, b)
    assert not K5.takes(y, "mish", b, w)
    with torch.no_grad():
        assert K5.takes(y, "mish", w, b)


@pytest.mark.parametrize("layout", ["channels-last", "nchw", "strided"])
def test_gate_asks_no_layout(layout):
    """``torch.export`` traces with cuDNN off, so a traced conv's output
    is NCHW where the card's is channels-last: the gate leaves the layout
    to the kernel's wrapper."""
    stride = {"channels-last": None, "nchw": (840, 35, 7, 1),
              "strided": (1680, 70, 7, 1)}[layout]
    assert K5.takes(_card_output(stride=stride), "mish")


def test_gate_wants_no_gradient_only_under_grad_mode():
    y = _card_output(torch.float32).requires_grad_()
    assert not K5.takes(y, "mish")
    with torch.no_grad():
        assert K5.takes(y, "mish")


def test_wrapper_and_launch_refuse_what_the_kernel_does_not_take():
    """The launch holds the checks that keep the kernel in bounds; the
    gate (:func:`..bias_act.takes`) keeps the program's calls inside
    them."""
    y, b = _output((2, 24, 5, 7), torch.bfloat16, seed=7)
    with pytest.raises(ValueError, match="activation"):
        K5.launch(y, b, "relu6")
    with pytest.raises(ValueError, match="bf16 or fp32"):
        K5.launch(y.half(), b, "mish")
    with pytest.raises(ValueError, match="bias"):
        K5.launch(y, b[:5], "mish")
    with pytest.raises(ValueError, match="bias"):
        K5.launch(y[0], b, "mish")
    with pytest.raises(ValueError, match="device cpu"):
        K5.launch(y, b, "mish")


# ----------------------------------------------------------------- the card

SHAPES = [(8, 32, 56, 64), (8, 1024, 14, 16), (2, 18, 7, 9), (3, 24, 5, 11),
          (1, 37, 13, 17), (2, 64, 33, 35)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels-last", "nchw"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ACTS)
def test_kernel_equals_eager_on_card(cuda, act, dtype, shape, layout):
    """"nchw": an output of another layout is read channels-last."""
    y, b = _output(shape, dtype, seed=sum(shape), device=cuda)
    want = K5.plain(y, b, act)
    before = _build.launches["bias_act"]
    got = K5.bias_act(y if layout == "channels-last" else y.contiguous(), b,
                      act)
    assert got.is_contiguous(memory_format=CL)
    torch.cuda.synchronize()
    assert _build.launches["bias_act"] == before + 1
    _same_bits(got, want)


EDGES = [0.0, -0.0, 1e-40, -1e-40, 1e-30, -1e-30, 0.5, -0.5, 9.0, -9.0,
         20.0, -20.0, 88.0, -88.0, 104.0, -104.0, 200.0, -200.0, 1e30,
         -1e30, 3e38, -3e38, float("inf"), float("-inf"), float("nan")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ACTS)
def test_kernel_equals_eager_on_edge_values(cuda, act, dtype):
    """Signed zeros, denormals, values where exp underflows and tanh
    saturates, the largest finite values, infinities and NaN, as outputs
    and as biases (inf + -inf makes a NaN)."""
    e = torch.tensor(EDGES)
    n = len(EDGES)
    y = torch.empty(2, 32, n, n)
    y[0] = e[None, :, None]                     # every value on each row
    y[1] = e[None, None, :]
    b = torch.zeros(32)
    b[8:8 + n // 2] = e[: n // 2]
    b[24:] = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e-40,
                           -0.0, 3e38, -3e38, 0.25])
    y = y.to(dtype).to(cuda).contiguous(memory_format=CL)
    b = b.to(dtype).to(cuda)
    want = K5.plain(y, b, act)
    got = K5.launch(y, b, act)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.cuda
def test_flagship_forward_runs_k5_on_every_other_conv(cuda, monkeypatch):
    """The flagship's folded bf16 forward at bs 8 (448x512): one K5 launch
    a conv but the two stems (183), the same bits as the forward with K5
    off, and a CUDA graph of it replays the same bits."""
    from double_yolo_kaist_torch import cuda_graphs
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.ops import stem as K3
    ir = compile_cfg(FLAGSHIP)
    placed = G.place_folded(ir, G.fold_batchnorm(ir, seeded_variables(ir, 0)),
                            cuda, torch.bfloat16)
    rng = np.random.default_rng(8)
    xv, xl = (torch.from_numpy(rng.random((8, 448, 512, 3), np.float32)
                               ).to(cuda) for _ in range(2))
    convs = [n for n in ir.nodes if n.kind == "conv" and not K3.matches(n)]
    assert len(convs) == 183

    def forward():
        dec, raw = G.apply_folded(ir, placed, xv, xl,
                                  compute_dtype=torch.bfloat16)
        return [dec] + list(raw)

    with torch.no_grad():
        _build.launches.clear()
        eager = forward()
        torch.cuda.synchronize()
        assert _build.launches["bias_act"] == 183
        graph, out, held = cuda_graphs.capture(forward, cuda)
        assert held.get("bias_act") == 183
        cuda_graphs.replay(graph, held)
        torch.cuda.synchronize()
        for g, e in zip(out, eager):
            _same_bits(g, e)
        monkeypatch.setattr(K5, "takes", lambda *a: False)
        _build.launches.clear()
        off = forward()
        torch.cuda.synchronize()
        assert _build.launches["bias_act"] == 0
    for o, e in zip(off, eager):
        _same_bits(o, e)
