"""A darknet ``.cfg`` reader of the benchmark's own: the layer list, each
layer's input and output channels, and the shapes a forward produces.

It reads the dialect of the Double-YOLO-Kaist cfgs: ``[net]`` with
``second_index`` (the layer that reads the LWIR image), ``[convolutional]``,
``[depthwiseconvolutional]`` (3x3 depthwise + BN + relu6, then 1x1 + BN +
relu6), ``[se]``, ``[maxpool]``, ``[upsample]``, ``[route]``,
``[shortcut]`` (``weights_type``: sigmoid-weighted inputs) and ``[yolo]``.
It imports nothing of the measured program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def _value(key: str, text: str):
    if key == "anchors":
        nums = [float(x) for x in text.replace(" ", "").split(",")]
        return [(nums[i], nums[i + 1]) for i in range(0, len(nums), 2)]
    if key in ("from", "layers", "mask"):
        return [int(x) for x in text.split(",")]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_blocks(path: str) -> list:
    """The cfg's sections in order, ``[net]`` first, as dicts with a
    ``type``."""
    blocks: list = []
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line[0] in "#;":
                continue
            if line.startswith("["):
                blocks.append({"type": line[1:-1].strip()})
                continue
            key, _, text = line.partition("=")
            blocks[-1][key.strip()] = _value(key.strip(), text.strip())
    if not blocks or blocks[0]["type"] != "net":
        raise ValueError(f"{path}: no [net] section first")
    return blocks


@dataclass
class Layer:
    i: int
    kind: str
    cin: int
    cout: int
    k: int = 1
    stride: int = 1
    pad: int = 0
    groups: int = 1
    bn: bool = False
    act: str = "linear"
    second: bool = False        # reads the LWIR image
    inputs: list = field(default_factory=list)
    weighted: bool = False
    squeeze: int = 0
    anchors: list = field(default_factory=list)
    nc: int = 0
    stride_px: int = 0          # yolo: the head's stride in input pixels


@dataclass
class Model:
    layers: list
    second_index: int
    yolo: list                  # indices of the yolo layers
    bf_type: str

    @property
    def heads(self):
        return [self.layers[i] for i in self.yolo]


def build(path: str, yolo_strides, bf_type: str) -> Model:
    """The layers of the cfg at ``path``; ``yolo_strides``: each head's
    stride in pixels, in the order of the heads; ``bf_type``: the box
    formula (``yolov4``: xy = 2 sigmoid - 0.5, wh = (2 sigmoid)^2 anchor;
    ``yolov3``: xy = sigmoid, wh = exp anchor)."""
    blocks = read_blocks(path)
    net, blocks = blocks[0], blocks[1:]
    second = net.get("second_index")
    layers: list = []
    yolo: list = []
    prev = 3
    for i, b in enumerate(blocks):
        t = b["type"]
        if t == "convolutional":
            k = b["size"]
            is2 = second is not None and i == second
            L = Layer(i, "conv", 3 if is2 else prev, b["filters"], k=k,
                      stride=b.get("stride", 1),
                      pad=k // 2 if b.get("pad") else 0,
                      groups=b.get("groups", 1),
                      bn=bool(b.get("batch_normalize", 0)),
                      act=b.get("activation", "linear"), second=is2)
        elif t == "depthwiseconvolutional":
            L = Layer(i, "dwconv", prev, b["filters"], k=b.get("size", 3),
                      stride=b.get("stride", 1), pad=1)
        elif t == "se":
            sq = int(math.ceil((prev // b["squeeze_factor"]) / 8) * 8)
            L = Layer(i, "se", prev, prev, squeeze=sq)
        elif t == "maxpool":
            k = b["size"]
            L = Layer(i, "maxpool", prev, prev, k=k, stride=b["stride"],
                      pad=(k - 1) // 2)
        elif t == "upsample":
            L = Layer(i, "upsample", prev, prev, stride=b["stride"])
        elif t == "route":
            ins = [j if j >= 0 else i + j for j in b["layers"]]
            c = sum(layers[j].cout for j in ins)
            L = Layer(i, "route", c, c, inputs=ins)
        elif t == "shortcut":
            ins = [j if j >= 0 else i + j for j in b["from"]]
            L = Layer(i, "shortcut", prev, prev, inputs=ins,
                      weighted="weights_type" in b)
        elif t == "yolo":
            L = Layer(i, "yolo", prev, prev,
                      anchors=[b["anchors"][m] for m in b["mask"]],
                      nc=b["classes"], stride_px=yolo_strides[len(yolo)])
            yolo.append(i)
        else:
            raise ValueError(f"{path}: layer {i}: unknown type {t}")
        layers.append(L)
        prev = L.cout
    return Model(layers, second, yolo, bf_type)


def out_hw(h: int, w: int, k: int, s: int, p: int):
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def shapes(model: Model, h: int, w: int) -> list:
    """Each layer's output (channels, height, width) at input (h, w)."""
    out: list = []
    cur = (3, h, w)
    for L in model.layers:
        if L.kind in ("conv", "dwconv", "maxpool"):
            src = (3, h, w) if L.second else cur
            cur = (L.cout,) + out_hw(src[1], src[2], L.k, L.stride, L.pad)
        elif L.kind == "upsample":
            cur = (cur[0], cur[1] * L.stride, cur[2] * L.stride)
        elif L.kind == "route":
            f = [out[j] for j in L.inputs]
            cur = (sum(x[0] for x in f), f[0][1], f[0][2])
        out.append(cur)
    return out
