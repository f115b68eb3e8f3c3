"""Programmatic model builder: construct the Double-YOLO architectures in
code, without .cfg files.

A numpy copy of the JAX package's ``models/builder.py``: every ``build_*``
(and the mini flagship) emits the same cfg-dialect block dicts, compiled
through the port's :func:`..config.ir.compile_blocks`, so a built model is
the GraphIR its ``.cfg`` gives (``tests/test_torch_builder.py`` holds each
against the JAX builder's). Covered: Darknet53 / CSPDarknet53 /
MobileNetV2 / MobileNetV3-large backbones; YOLOv3 SPP+FPN, YOLOv4
SPP+PANet and the lightweight depthwise PANet heads; every fusion family
(Add-SL, Add-Simple, Concat, CSE, Concat-Inception-SE, Fshare-CSE
ladders, Global-Fshare CSE / CSE3 / Add-SL); and all 16 published zoo
models (:mod:`.zoo`) plus two extra cfg variants.
"""

from __future__ import annotations

import numpy as np

from ..config.ir import GraphIR, compile_blocks

# KAIST GA-clustered anchors (reference cfg data). Order: small -> large,
# heads consume masks [6,7,8] (stride 32), [3,4,5] (16), [0,1,2] (8).
KAIST_ANCHORS_V3_SINGLE = [16, 33, 18, 37, 19, 47, 23, 42, 20, 51, 28, 66,
                           37, 86, 45, 104, 58, 140]
KAIST_ANCHORS_V3_DOUBLE = [16, 42, 22, 44, 20, 53, 29, 53, 26, 64, 29, 85,
                           34, 75, 41, 104, 59, 147]


class NetBuilder:
    """Accumulates cfg-dialect layer blocks with index bookkeeping."""

    def __init__(self, width: int = 512, height: int = 512):
        self.net = {"width": width, "height": height, "channels": 3}
        self.blocks: list[dict] = []

    @property
    def last(self) -> int:
        return len(self.blocks) - 1

    def _add(self, block: dict) -> int:
        self.blocks.append(block)
        return self.last

    def conv(self, filters: int, size: int = 3, stride: int = 1,
             act: str = "leaky", bn: bool = True, groups: int = 1) -> int:
        block = {"type": "convolutional",
                 "batch_normalize": int(bn), "filters": filters,
                 "size": size, "stride": stride, "pad": 1,
                 "activation": act}
        if groups != 1:
            block["groups"] = groups
        return self._add(block)

    def dwconv(self, filters: int, stride: int = 1) -> int:
        """Depthwise-separable conv block (3x3 dw + 1x1 pw, BN+ReLU6 each)."""
        return self._add({"type": "depthwiseconvolutional",
                          "filters": filters, "size": 3, "stride": stride})

    def shortcut(self, frm: int, weighted: bool = False) -> int:
        b = {"type": "shortcut", "from": [frm], "activation": "linear"}
        if weighted:
            b["weights_type"] = 1.0
        return self._add(b)

    def route(self, *layers: int) -> int:
        return self._add({"type": "route", "layers": list(layers)})

    def maxpool(self, size: int, stride: int = 1) -> int:
        return self._add({"type": "maxpool", "size": size, "stride": stride})

    def upsample(self, stride: int = 2) -> int:
        return self._add({"type": "upsample", "stride": stride})

    def se(self, squeeze_factor: int = 4) -> int:
        return self._add({"type": "se", "squeeze_factor": squeeze_factor})

    def inception(self, ch: int) -> int:
        """GoogLeNet block with the reference's width schedule: branches
        (C/4, 3C/8 | 3C/16 x3) summing back to C (kaist_dyolov3_concat_seinc
        inception blocks)."""
        return self._add({"type": "inception", "n1x1": ch // 4,
                          "n3x3_reduce": 3 * ch // 8, "n3x3": 3 * ch // 8,
                          "n5x5_reduce": 3 * ch // 16, "n5x5": 3 * ch // 16,
                          "pool_proj": 3 * ch // 16})

    def yolo(self, anchors: list, mask: list, nc: int) -> int:
        na = len(mask)
        self.conv(na * (nc + 5), size=1, act="linear", bn=False)
        return self._add({"type": "yolo",
                          "anchors": np.asarray(anchors, np.float32)
                          .reshape(-1, 2),
                          "mask": list(mask), "classes": nc,
                          "num": len(anchors) // 2})

    def compile(self, yolo_strides, bf_type: str, name: str) -> GraphIR:
        return compile_blocks(self.net, self.blocks, yolo_strides, bf_type,
                              path=name)


# ------------------------------------------------------------------ backbones

def darknet_stage(b: NetBuilder, ch: int, n_blocks: int,
                  first_block_weighted: bool = False) -> int:
    """One Darknet53 stage: stride-2 conv + n residual blocks.
    ``first_block_weighted`` replicates a reference quirk
    (kaist_dyolov3_fshare_global_add_sl.cfg layer 16: the first residual
    shortcut of the post-fusion stage carries learned weights)."""
    b.conv(ch, stride=2)
    for i in range(n_blocks):
        b.conv(ch // 2, size=1)
        b.conv(ch)
        b.shortcut(-3, weighted=first_block_weighted and i == 0)
    return b.last


def darknet53(b: NetBuilder):
    """Darknet53 (reference kaist_yolov3.cfg layers 0-74).
    Returns the /8, /16, /32 feature indices."""
    b.conv(32)
    taps = {}
    for ch, n_blocks in [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]:
        taps[ch] = darknet_stage(b, ch, n_blocks)
    return taps[256], taps[512], taps[1024]   # /8, /16, /32


def csp_stage(b: NetBuilder, ch: int, n_blocks: int,
              first: bool = False) -> int:
    """One CSPDarknet53 stage (reference kaist_yolov4.cfg): stride-2 conv,
    cross-stage split (two 1x1 branches), n residual blocks on one branch,
    branch concat, 1x1 transition. The first stage keeps full-width branches.
    All convs mish."""
    half = ch if first else ch // 2
    hidden = ch // 2 if first else half
    down = b.conv(ch, stride=2, act="mish")
    split_a = b.conv(half, 1, act="mish")
    b.route(down)
    b.conv(half, 1, act="mish")
    for _ in range(n_blocks):
        b.conv(hidden, 1, act="mish")
        b.conv(half, act="mish")
        b.shortcut(-3)
    split_b = b.conv(half, 1, act="mish")
    b.route(split_b, split_a)
    return b.conv(ch, 1, act="mish")


def cspdarknet53(b: NetBuilder):
    """CSPDarknet53 (reference kaist_yolov4.cfg layers 0-104).
    Returns the /8, /16, /32 feature indices."""
    b.conv(32, act="mish")
    csp_stage(b, 64, 1, first=True)
    csp_stage(b, 128, 2)
    f8 = csp_stage(b, 256, 8)
    f16 = csp_stage(b, 512, 8)
    f32 = csp_stage(b, 1024, 4)
    return f8, f16, f32


def mbv2_block(b: NetBuilder, c_in: int, c_out: int, stride: int = 1,
               expand: int = 6) -> int:
    """MobileNetV2 inverted residual: [1x1 expand relu6] -> 3x3 depthwise
    (grouped conv) relu6 -> 1x1 linear project -> shortcut when shapes match
    (reference kaist_yolov4_mobilenetv2.cfg blocks)."""
    mid = c_in * expand
    # NB: the reference cfgs put the block's stride-2 on the 1x1 EXPAND conv
    # (not the depthwise, as standard MobileNet does) — replicated exactly
    if expand != 1:
        b.conv(mid, 1, stride, act="relu6")
        b.conv(mid, 3, 1, act="relu6", groups=mid)
    else:
        b.conv(mid, 3, stride, act="relu6", groups=mid)
    out = b.conv(c_out, 1, act="linear")
    if stride == 1 and c_in == c_out:
        out = b.shortcut(-4 if expand != 1 else -3)
    return out


def mbv2_stage(b: NetBuilder, c_in: int, c: int, n: int, s: int,
               first: bool = False) -> int:
    for i in range(n):
        mbv2_block(b, c_in if i == 0 else c, c, stride=s if i == 0 else 1,
                   expand=1 if first else 6)
    return b.last


def mobilenet_v2_backbone(b: NetBuilder):
    """MobileNetV2 (reference kaist_yolov4_mobilenetv2.cfg layers 0-60).
    Returns /8, /16, /32-path feature indices (32ch, 96ch, 320ch taps)."""
    b.conv(32, 3, 2, act="relu6")
    c_in = 32
    taps = {}
    first = True
    for c, n, s in [(16, 1, 1), (24, 2, 2), (32, 3, 2), (64, 4, 2),
                    (96, 3, 1), (160, 3, 2), (320, 1, 1)]:
        for i in range(n):
            mbv2_block(b, c_in, c, stride=s if i == 0 else 1,
                       expand=1 if first else 6)
            first = False
            c_in = c
        taps[c] = b.last
    return taps[32], taps[96], taps[320]


# MobileNetV3-large rows: (kernel, expand, out, se, act, stride)
MBV3_ROWS = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hard-swish", 2),
    (3, 200, 80, False, "hard-swish", 1),
    (3, 184, 80, False, "hard-swish", 1),
    (3, 184, 80, False, "hard-swish", 1),
    (3, 480, 112, True, "hard-swish", 1),
    (3, 672, 112, True, "hard-swish", 1),
    (5, 672, 160, True, "hard-swish", 2),
    (5, 960, 160, True, "hard-swish", 1),
    (5, 960, 160, True, "hard-swish", 1),
]


def mobilenet_v3_backbone(b: NetBuilder):
    """MobileNetV3-large (reference kaist_yolov4_mobilenetv3.cfg layers 0-61).
    Returns /8, /16, /32-path taps (40ch, 112ch, 160ch)."""
    b.conv(16, 3, 2, act="hard-swish")
    c_in = 16
    taps = {}
    for k, exp, out, se, act, s in MBV3_ROWS:
        n_layers = 2 + int(se) + int(exp != c_in)  # expand? + dw + se? + proj
        # stride rides on the expand conv (see mbv2_block note)
        if exp != c_in:
            b.conv(exp, 1, s, act=act)
            b.conv(exp, k, 1, act=act, groups=exp)
        else:
            b.conv(exp, k, s, act=act, groups=exp)
        if se:
            b.se(4)
        b.conv(out, 1, act="linear")
        # residual when shapes match — except the stem row (exp == c_in),
        # where the reference cfg omits it
        if s == 1 and c_in == out and exp != c_in:
            b.shortcut(-(n_layers + 1))
        c_in = out
        taps[out] = b.last
    return taps[40], taps[112], taps[160]


# ---------------------------------------------------------------------- heads

def _spp(b: NetBuilder):
    """SPP block: maxpools k=5,9,13 over the same input, concat
    (reference kaist_yolov3.cfg layers 78-83)."""
    pre = b.last
    b.maxpool(5)
    b.route(pre)
    b.maxpool(9)
    b.route(pre)
    b.maxpool(13)
    b.route(b.last, b.last - 2, b.last - 4, pre)


def yolov3_spp_fpn_head(b: NetBuilder, f8: int, f16: int, f32: int,
                        anchors: list, nc: int):
    """YOLOv3 SPP + FPN decode head over /8, /16, /32 features
    (reference kaist_yolov3.cfg layers 75-113)."""
    # scale 1 (/32)
    if b.last != f32:
        b.route(f32)
    b.conv(512, 1)
    b.conv(1024)
    b.conv(512, 1)
    _spp(b)
    b.conv(512, 1)
    b.conv(1024)
    tap1 = b.conv(512, 1)
    b.conv(1024)
    b.yolo(anchors, [6, 7, 8], nc)

    # scale 2 (/16)
    b.route(tap1)
    b.conv(256, 1)
    b.upsample()
    b.route(b.last, f16)
    b.conv(256, 1)
    b.conv(512)
    b.conv(256, 1)
    b.conv(512)
    tap2 = b.conv(256, 1)
    b.conv(512)
    b.yolo(anchors, [3, 4, 5], nc)

    # scale 3 (/8)
    b.route(tap2)
    b.conv(128, 1)
    b.upsample()
    b.route(b.last, f8)
    b.conv(128, 1)
    b.conv(256)
    b.conv(128, 1)
    b.conv(256)
    b.conv(128, 1)
    b.conv(256)
    b.yolo(anchors, [0, 1, 2], nc)


def yolov4_spp_panet_head(b: NetBuilder, f8: int, f16: int, f32: int,
                          anchors: list, nc: int, w=lambda c: c):
    """YOLOv4 SPP + PANet head (reference kaist_yolov4.cfg layers 105-161):
    top-down FPN with lateral 1x1s, then bottom-up path aggregation; heads
    fire small->large (strides 8, 16, 32). Leaky activations. ``w`` maps
    nominal channel widths (identity for the published models; the
    mini-flagship dryrun model scales them down)."""
    # P5: SPP block over the /32 feature
    if b.last != f32:
        b.route(f32)
    b.conv(w(512), 1)
    b.conv(w(1024))
    b.conv(w(512), 1)
    _spp(b)
    b.conv(w(512), 1)
    b.conv(w(1024))
    p5 = b.conv(w(512), 1)

    # top-down to /16
    b.conv(w(256), 1)
    up16 = b.upsample()
    b.route(f16)
    lat16 = b.conv(w(256), 1)
    b.route(lat16, up16)
    b.conv(w(256), 1)
    b.conv(w(512))
    b.conv(w(256), 1)
    b.conv(w(512))
    p4 = b.conv(w(256), 1)

    # top-down to /8
    b.conv(w(128), 1)
    up8 = b.upsample()
    b.route(f8)
    lat8 = b.conv(w(128), 1)
    b.route(lat8, up8)
    b.conv(w(128), 1)
    b.conv(w(256))
    b.conv(w(128), 1)
    b.conv(w(256))
    p3 = b.conv(w(128), 1)

    # head /8
    b.conv(w(256))
    b.yolo(anchors, [0, 1, 2], nc)

    # bottom-up /8 -> /16
    b.route(p3)
    b.conv(w(256), stride=2)
    b.route(b.last, p4)
    b.conv(w(256), 1)
    b.conv(w(512))
    b.conv(w(256), 1)
    b.conv(w(512))
    n4 = b.conv(w(256), 1)
    b.conv(w(512))
    b.yolo(anchors, [3, 4, 5], nc)

    # bottom-up /16 -> /32
    b.route(n4)
    b.conv(w(512), stride=2)
    b.route(b.last, p5)
    b.conv(w(512), 1)
    b.conv(w(1024))
    b.conv(w(512), 1)
    b.conv(w(1024))
    b.conv(w(512), 1)
    b.conv(w(1024))
    b.yolo(anchors, [6, 7, 8], nc)


def yolov4_mobile_head(b: NetBuilder, f8: int, f16: int, f32: int,
                       anchors: list, nc: int):
    """Lightweight YOLOv4 SPP + PANet head: every 3x3 conv replaced by a
    depthwise-separable block, 1x1 convs relu6 (reference
    kaist_yolov4_mobilenetv2.cfg layers 61-117)."""
    if b.last != f32:
        b.route(f32)
    b.conv(512, 1, act="relu6")
    b.dwconv(1024)
    b.conv(512, 1, act="relu6")
    _spp(b)
    b.conv(512, 1, act="relu6")
    b.dwconv(1024)
    p5 = b.conv(512, 1, act="relu6")

    b.conv(256, 1, act="relu6")
    up16 = b.upsample()
    b.route(f16)
    lat16 = b.conv(256, 1, act="relu6")
    b.route(lat16, up16)
    b.conv(256, 1, act="relu6")
    b.dwconv(512)
    b.conv(256, 1, act="relu6")
    b.dwconv(512)
    p4 = b.conv(256, 1, act="relu6")

    b.conv(128, 1, act="relu6")
    up8 = b.upsample()
    b.route(f8)
    lat8 = b.conv(128, 1, act="relu6")
    b.route(lat8, up8)
    b.conv(128, 1, act="relu6")
    b.dwconv(256)
    b.conv(128, 1, act="relu6")
    b.dwconv(256)
    p3 = b.conv(128, 1, act="relu6")
    b.dwconv(256)
    b.yolo(anchors, [0, 1, 2], nc)

    b.route(p3)
    b.dwconv(256, stride=2)
    b.route(b.last, p4)
    b.conv(256, 1, act="relu6")
    b.dwconv(512)
    b.conv(256, 1, act="relu6")
    b.dwconv(512)
    n4 = b.conv(256, 1, act="relu6")
    b.dwconv(512)
    b.yolo(anchors, [3, 4, 5], nc)

    b.route(n4)
    b.dwconv(512, stride=2)
    b.route(b.last, p5)
    # NB: the reference cfg marks this one conv 'leaky' while every other
    # head 1x1 is relu6 (kaist_yolov4_mobilenetv2.cfg layer 110) — replicated
    # for exact weight-import parity
    b.conv(512, 1, act="leaky")
    b.dwconv(1024)
    b.conv(512, 1, act="relu6")
    b.dwconv(1024)
    b.conv(512, 1, act="relu6")
    b.dwconv(1024)
    b.yolo(anchors, [6, 7, 8], nc)


KAIST_ANCHORS_V4_SINGLE = [16, 32, 18, 42, 22, 44, 22, 55, 30, 58, 27, 65,
                           34, 80, 43, 102, 62, 153]


def build_yolov4_mobilenetv2(nc: int = 1, anchors=None,
                             img_size: int = 512) -> GraphIR:
    """Visible-YOLOv4-MobileNetv2 (reference kaist_yolov4_mobilenetv2.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)
    f8, f16, f32 = mobilenet_v2_backbone(b)
    yolov4_mobile_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", "built_yolov4_mnv2")


def build_yolov4(nc: int = 1, anchors=None, img_size: int = 512) -> GraphIR:
    """Single-stream Visible-YOLOv4: CSPDarknet53 + SPP + PANet
    (reference kaist_yolov4.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)
    f8, f16, f32 = cspdarknet53(b)
    yolov4_spp_panet_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", "built_yolov4")


# --------------------------------------------------------------------- models

def build_yolov3(nc: int = 1, anchors=None, img_size: int = 512) -> GraphIR:
    """Single-stream Visible-YOLOv3 (reference kaist_yolov3.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V3_SINGLE
    b = NetBuilder(img_size, img_size)
    f8, f16, f32 = darknet53(b)
    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3", "built_yolov3")


def build_double_yolov3_add(nc: int = 1, anchors=None, img_size: int = 512,
                            learned_weights: bool = True) -> GraphIR:
    """Dual-stream Double-YOLOv3 with additive fusion at the three scales.
    ``learned_weights=True`` -> Add-SL (sigmoid-weighted blend, reference
    kaist_dyolov3_add_sl.cfg); False -> Add-Simple."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)
    v8, v16, v32 = darknet53(b)                 # visible stream, 0..74
    b.net["second_index"] = b.last + 1
    l8, l16, l32 = darknet53(b)                 # lwir stream, 75..149

    # additive fusion per scale: route to the L feature, (weighted) add of
    # the V feature, then a conv — 3x3 for Add-SL, 1x1 for Add-Simple
    # (reference kaist_dyolov3_add_sl.cfg:1080-1125 / kaist_dyolov3_add_simple)
    k = 3 if learned_weights else 1
    fused = []
    for vf, lf, ch in ((v8, l8, 256), (v16, l16, 512), (v32, l32, 1024)):
        b.route(lf)
        b.shortcut(vf, weighted=learned_weights)
        fused.append(b.conv(ch, size=k))
    f8, f16, f32 = fused

    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3",
                     "built_dyolov3_add_sl" if learned_weights
                     else "built_dyolov3_add_simple")


def build_double_yolov3_concat(nc: int = 1, anchors=None,
                               img_size: int = 512, se: bool = False,
                               inception: bool = False) -> GraphIR:
    """Dual-stream Double-YOLOv3 with channel-concat fusion per scale:
    route([V, L]) -> 3x3 conv -> [inception] -> [SE]
    (reference kaist_dyolov3_concat{,_se,_seinc}.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)
    v8, v16, v32 = darknet53(b)
    b.net["second_index"] = b.last + 1
    l8, l16, l32 = darknet53(b)

    fused = []
    for vf, lf, ch in ((v8, l8, 256), (v16, l16, 512), (v32, l32, 1024)):
        b.route(vf, lf)
        b.conv(ch)
        if inception:
            b.inception(ch)
        if se:
            b.se(4)
        fused.append(b.last)
    f8, f16, f32 = fused

    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    tag = "cse" if (se and not inception) else \
        ("seinc" if (se and inception) else
         ("inc" if inception else "concat"))
    return b.compile([32, 16, 8], "yolov3", f"built_dyolov3_{tag}")


def build_double_yolov3_global_fshare_cse3(nc: int = 1, anchors=None,
                                           img_size: int = 512) -> GraphIR:
    """Double-YOLOv3 Global-Fshare-CSE3 (reference
    kaist_dyolov3_fshare_global_concat_se3.cfg): the two streams run the
    darknet stages in alternation with FSNet-style "global feature sharing" —
    after each deep stage, concat both streams -> 3x3 conv -> SE, then blend
    the shared feature back into EACH stream with a learned weighted shortcut
    before its next stage; the FPN consumes the shared SE features."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(32)
        darknet_stage(bb, 64, 1)
        darknet_stage(bb, 128, 2)
        return darknet_stage(bb, 256, 8)

    v8 = stem(b)                              # 0..36
    b.net["second_index"] = b.last + 1
    l8 = stem(b)                              # 37..73

    def fuse(vf, lf, ch, reinject_v=True):
        b.route(vf, lf)
        b.conv(ch)
        shared = b.se(4)
        if reinject_v:
            b.shortcut(vf, weighted=True)     # fused -> V stream
        return shared

    f8 = fuse(v8, l8, 256)                    # 74..77
    v16 = darknet_stage(b, 512, 8)            # V stage 4 -> 102
    b.route(f8)
    b.shortcut(l8, weighted=True)             # fused -> L stream
    l16 = darknet_stage(b, 512, 8)            # L stage 4 -> 129

    f16 = fuse(v16, l16, 512)                 # 130..133
    v32 = darknet_stage(b, 1024, 4)           # -> 146
    b.route(f16)
    b.shortcut(l16, weighted=True)
    l32 = darknet_stage(b, 1024, 4)           # -> 161

    fuse(v32, l32, 1024, reinject_v=False)    # 162..164, ends at SE
    f32 = b.last

    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3", "built_dyolov3_gf_cse3")


def build_yolov4_mobilenetv3(nc: int = 1, anchors=None,
                             img_size: int = 512) -> GraphIR:
    """Visible-YOLOv4-MobileNetv3 (reference kaist_yolov4_mobilenetv3.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)
    f8, f16, f32 = mobilenet_v3_backbone(b)
    yolov4_mobile_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", "built_yolov4_mnv3")


def build_double_yolov4(nc: int = 1, anchors=None, img_size: int = 512,
                        fusion: str = "add_sl") -> GraphIR:
    """Dual-stream Double-YOLOv4 (CSPDarknet53 x2 + SPP/PANet) with
    per-scale fusion: 'add_sl' (weighted additive, reference
    kaist_dyolov4_add_sl.cfg) or 'cse' (concat + 3x3 conv + SE,
    kaist_dyolov4_concat_se.cfg)."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)
    v8, v16, v32 = cspdarknet53(b)              # 0..104
    b.net["second_index"] = b.last + 1
    l8, l16, l32 = cspdarknet53(b)              # 105..209

    fused = []
    for vf, lf, ch in ((v8, l8, 256), (v16, l16, 512), (v32, l32, 1024)):
        if fusion == "add_sl":
            b.route(lf)
            b.shortcut(vf, weighted=True)
            fused.append(b.conv(ch))
        elif fusion == "cse":
            b.route(vf, lf)
            b.conv(ch)
            fused.append(b.se(4))
        else:
            raise ValueError(f"unknown fusion '{fusion}'")
    f8, f16, f32 = fused

    yolov4_spp_panet_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", f"built_dyolov4_{fusion}")


def build_double_yolov4_global_fshare_cse3(nc: int = 1, anchors=None,
                                           img_size: int = 512) -> GraphIR:
    """Double-YOLOv4 Fshare-Global-CSE3 — the reference's best model
    (kaist_dyolov4_fshare_global_concat_se3.cfg, README.md:132): CSP streams
    alternate per stage with FSNet global feature sharing (concat -> 3x3 conv
    -> SE, reinjected into both streams by learned weighted shortcuts),
    SPP + PANet head on the shared features."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(32, act="mish")
        csp_stage(bb, 64, 1, first=True)
        csp_stage(bb, 128, 2)
        return csp_stage(bb, 256, 8)

    v8 = stem(b)                                 # 0..54
    b.net["second_index"] = b.last + 1
    l8 = stem(b)                                 # 55..109

    def fuse(vf, lf, ch, reinject_v=True):
        b.route(vf, lf)
        b.conv(ch)
        shared = b.se(4)
        if reinject_v:
            b.shortcut(vf, weighted=True)
        return shared

    f8 = fuse(v8, l8, 256)
    v16 = csp_stage(b, 512, 8)
    b.route(f8)
    b.shortcut(l8, weighted=True)
    l16 = csp_stage(b, 512, 8)

    f16 = fuse(v16, l16, 512)
    v32 = csp_stage(b, 1024, 4)
    b.route(f16)
    b.shortcut(l16, weighted=True)
    l32 = csp_stage(b, 1024, 4)

    fuse(v32, l32, 1024, reinject_v=False)
    f32 = b.last

    yolov4_spp_panet_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", "built_dyolov4_gf_cse3")


def build_mini_flagship(nc: int = 1, anchors=None, img_size: int = 64,
                        div: int = 4) -> GraphIR:
    """Reduced Double-YOLOv4-Fshare-Global-CSE3 for the multi-chip dryrun
    (VERDICT r4 item 9): the SAME layer-type inventory and fusion topology
    as build_double_yolov4_global_fshare_cse3 — twin CSP streams, FSNet
    global sharing (route -> 3x3 conv -> SE), learned weighted reinjection
    shortcuts, SPP + PANet head, three YOLO scales — at 1/div width and
    depth 1, so the production 2-D data x space GSPMD partitioning (halo
    exchanges through CSP routes, SE global pooling, SPP, upsample) is
    exercised continuously within the driver's CPU-mesh budget instead of
    hiding behind DYK_DRYRUN_SPATIAL=1."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    w = lambda c: max(8, c // div)  # noqa: E731
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(w(32), act="mish")
        csp_stage(bb, w(64), 1, first=True)
        csp_stage(bb, w(128), 1)
        return csp_stage(bb, w(256), 1)

    v8 = stem(b)
    b.net["second_index"] = b.last + 1
    l8 = stem(b)

    def fuse(vf, lf, ch, reinject_v=True):
        b.route(vf, lf)
        b.conv(ch)
        shared = b.se(4)
        if reinject_v:
            b.shortcut(vf, weighted=True)
        return shared

    f8 = fuse(v8, l8, w(256))
    v16 = csp_stage(b, w(512), 1)
    b.route(f8)
    b.shortcut(l8, weighted=True)
    l16 = csp_stage(b, w(512), 1)

    f16 = fuse(v16, l16, w(512))
    v32 = csp_stage(b, w(1024), 1)
    b.route(f16)
    b.shortcut(l16, weighted=True)
    l32 = csp_stage(b, w(1024), 1)

    fuse(v32, l32, w(1024), reinject_v=False)
    f32 = b.last

    yolov4_spp_panet_head(b, f8, f16, f32, anchors, nc, w=w)
    return b.compile([8, 16, 32], "yolov4", "built_mini_flagship")


def build_double_yolov4_mnv2_global_fshare_cse3(nc: int = 1, anchors=None,
                                                img_size: int = 512
                                                ) -> GraphIR:
    """Double-YOLOv4-MNv2-Fshare-Global-CSE3 (reference
    kaist_dyolov4_mobilenetv2_fshare_global_cse3.cfg): twin MobileNetV2
    streams with FSNet global sharing; the mobile fusion block is
    route -> 3x3 depthwise (grouped) -> SE -> 1x1 linear project ->
    learned weighted shortcut; lightweight SPP+PANet head."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(32, 3, 2, act="relu6")
        mbv2_stage(bb, 32, 16, 1, 1, first=True)
        mbv2_stage(bb, 16, 24, 2, 2)
        return mbv2_stage(bb, 24, 32, 3, 2)

    def mid(bb):
        mbv2_stage(bb, 32, 64, 4, 2)
        return mbv2_stage(bb, 64, 96, 3, 1)

    def tail(bb):
        mbv2_stage(bb, 96, 160, 3, 2)
        return mbv2_stage(bb, 160, 320, 1, 1)

    def fuse(vf, lf, ch, reinject_v=True):
        b.route(vf, lf)
        b.conv(2 * ch, 3, act="relu6", groups=2 * ch)
        b.se(4)
        shared = b.conv(ch, 1, act="linear")
        if reinject_v:
            b.shortcut(vf, weighted=True)
        return shared

    v8 = stem(b)                                  # 0..20
    b.net["second_index"] = b.last + 1
    l8 = stem(b)                                  # 21..41
    f8 = fuse(v8, l8, 32)                         # 42..46
    v16 = mid(b)
    b.route(f8)
    b.shortcut(l8, weighted=True)
    l16 = mid(b)
    f16 = fuse(v16, l16, 96)
    v32 = tail(b)
    b.route(f16)
    b.shortcut(l16, weighted=True)
    l32 = tail(b)
    f32 = fuse(v32, l32, 320, reinject_v=False)
    yolov4_mobile_head(b, f8, f16, f32, anchors, nc)
    return b.compile([8, 16, 32], "yolov4", "built_dyolov4_mnv2_gf_cse3")


def build_double_yolov4_mnv3_global_fshare_cse3(nc: int = 1, anchors=None,
                                                img_size: int = 512
                                                ) -> GraphIR:
    """Double-YOLOv4-MNv3-Fshare-Global-CSE3 (reference
    kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg): twin MobileNetV3
    streams with the mobile FSNet fusion blocks and lightweight head."""
    anchors = anchors or KAIST_ANCHORS_V4_SINGLE
    b = NetBuilder(img_size, img_size)

    def rows(bb, c_in, row_slice):
        for k, exp, out, se, act, s in MBV3_ROWS[row_slice]:
            n_layers = 2 + int(se) + int(exp != c_in)
            # stride rides on the expand conv (see mbv2_block note)
            if exp != c_in:
                bb.conv(exp, 1, s, act=act)
                bb.conv(exp, k, 1, act=act, groups=exp)
            else:
                bb.conv(exp, k, s, act=act, groups=exp)
            if se:
                bb.se(4)
            bb.conv(out, 1, act="linear")
            if s == 1 and c_in == out and exp != c_in:
                bb.shortcut(-(n_layers + 1))
            c_in = out
        return bb.last

    def stem(bb):
        bb.conv(16, 3, 2, act="hard-swish")
        return rows(bb, 16, slice(0, 6))        # through the c=40 stage

    def fuse(vf, lf, ch, reinject_v=True):
        b.route(vf, lf)
        b.conv(2 * ch, 3, act="relu6", groups=2 * ch)
        b.se(4)
        shared = b.conv(ch, 1, act="linear")
        if reinject_v:
            b.shortcut(vf, weighted=True)
        return shared

    v8 = stem(b)                                  # 0..23
    b.net["second_index"] = b.last + 1
    l8 = stem(b)                                  # 24..47
    f8 = fuse(v8, l8, 40)                         # 48..52
    v16 = rows(b, 40, slice(6, 12))               # c80 + c112 rows
    b.route(f8)
    b.shortcut(l8, weighted=True)
    l16 = rows(b, 40, slice(6, 12))
    f16 = fuse(v16, l16, 112)
    v32 = rows(b, 112, slice(12, 15))             # c160 rows
    b.route(f16)
    b.shortcut(l16, weighted=True)
    l32 = rows(b, 112, slice(12, 15))
    f32 = fuse(v32, l32, 160, reinject_v=False)
    # NB: replicating the reference cfg's head lateral targets verbatim
    # (kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg routes 156/166): the
    # /16 lateral reads fusion-2's depthwise output (pre-SE, 224ch) and the
    # /8 lateral reads the L-stem's last SE output (120ch) rather than the
    # shared projections — quirks of the shipped (and benchmarked) model
    yolov4_mobile_head(b, f8=l8 - 2, f16=f16 - 2, f32=f32,
                       anchors=anchors, nc=nc)
    return b.compile([8, 16, 32], "yolov4", "built_dyolov4_mnv3_gf_cse3")


def build_double_yolov3_global_fshare_cse(nc: int = 1, anchors=None,
                                          img_size: int = 512) -> GraphIR:
    """Double-YOLOv3 Global-Fshare-CSE (reference
    kaist_dyolov3_fshare_global_concat_se.cfg): streams interleave after
    EVERY darknet stage; each fusion is concat -> 3x3 conv -> SE, reinjected
    into both streams by plain additive shortcuts; the FPN consumes the SE
    features of the three deepest fusions."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(32)
        return darknet_stage(bb, 64, 1)

    v = stem(b)                                  # 0..4
    b.net["second_index"] = b.last + 1
    l = stem(b)                                  # 5..9

    ses = []
    for ch, n_blocks in [(64, None), (128, 2), (256, 8), (512, 8),
                         (1024, 4)]:
        if ch > 64:
            v = darknet_stage(b, ch, n_blocks)
            b.route(ses[-1])
            b.shortcut(l)
            l = darknet_stage(b, ch, n_blocks)
        b.route(v, l)
        b.conv(ch)
        ses.append(b.se(4))
        if ch < 1024:
            b.shortcut(v)                        # fused -> V stream
    f8, f16, f32 = ses[2], ses[3], ses[4]
    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3", "built_dyolov3_gf_cse")


def build_double_yolov3_global_fshare_add_sl(nc: int = 1, anchors=None,
                                             img_size: int = 512) -> GraphIR:
    """Double-YOLOv3 Global-Fshare-Add-SL (reference
    kaist_dyolov3_fshare_global_add_sl.cfg): per-stage additive sharing —
    weighted blend of the two streams, 3x3 conv, weighted blend again —
    reinjected into the L stream before its next stage; the FPN consumes the
    fusion convs of the three deepest scales."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)

    def stem(bb):
        bb.conv(32)
        return darknet_stage(bb, 64, 1)

    v = stem(b)                                  # 0..4
    b.net["second_index"] = b.last + 1
    l = stem(b)                                  # 5..9

    fconvs = []
    for ch, n_blocks in [(64, None), (128, 2), (256, 8), (512, 8),
                         (1024, 4)]:
        if ch > 64:
            # the first residual of the post-fusion 128 stage is weighted
            # (reference quirk, layer 16)
            v = darknet_stage(b, ch, n_blocks,
                              first_block_weighted=(ch == 128))
            b.route(fconvs[-1])
            b.shortcut(l, weighted=True)
            l = darknet_stage(b, ch, n_blocks)
        b.shortcut(v, weighted=True)             # blend L (prev) with V
        fconvs.append(b.conv(ch))
        if ch < 1024:
            b.shortcut(v, weighted=True)         # blend fused back with V
    f8, f16, f32 = fconvs[2], fconvs[3], fconvs[4]
    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3", "built_dyolov3_gf_add_sl")


def build_double_yolov3_fshare_cse(nc: int = 1, anchors=None,
                                   img_size: int = 512) -> GraphIR:
    """Double-YOLOv3 Fshare-CSE (reference kaist_dyolov3_fshare_concat_se.cfg):
    two full Darknet53 backbones, then a per-scale sharing ladder — concat ->
    3x3 conv -> SE, reinjected into each stream followed by two residual
    refinement blocks per stream, then a second concat -> conv -> SE that
    yields the shared FPN feature."""
    anchors = anchors or KAIST_ANCHORS_V3_DOUBLE
    b = NetBuilder(img_size, img_size)
    v8, v16, v32 = darknet53(b)                  # 0..74
    b.net["second_index"] = b.last + 1
    l8, l16, l32 = darknet53(b)                  # 75..149

    def refine(ch, n=2):
        for _ in range(n):
            b.conv(ch // 2, 1)
            b.conv(ch)
            b.shortcut(-3)
        return b.last

    def ladder(vf, lf, ch):
        b.route(vf, lf)
        b.conv(ch)
        se1 = b.se(4)
        b.shortcut(vf)
        v_ref = refine(ch)
        b.route(se1)
        b.shortcut(lf)
        l_ref = refine(ch)
        b.route(l_ref, v_ref)
        b.conv(ch)
        return b.se(4)

    f8 = ladder(v8, l8, 256)
    f16 = ladder(v16, l16, 512)
    f32 = ladder(v32, l32, 1024)
    yolov3_spp_fpn_head(b, f8, f16, f32, anchors, nc)
    return b.compile([32, 16, 8], "yolov3", "built_dyolov3_fshare_cse")


BUILDERS = {
    "Visible-YOLOv3-Normal": build_yolov3,
    "Double-YOLOv3-Add-SL": build_double_yolov3_add,
    "Double-YOLOv3-Add-Simple":
        lambda **kw: build_double_yolov3_add(learned_weights=False, **kw),
    "Double-YOLOv3-Concat": build_double_yolov3_concat,
    "Double-YOLOv3-CSE":
        lambda **kw: build_double_yolov3_concat(se=True, **kw),
    "Double-YOLOv3-Concat-Inception-SE":
        lambda **kw: build_double_yolov3_concat(se=True, inception=True, **kw),
    "Double-YOLOv3-Global-Fshare-CSE3": build_double_yolov3_global_fshare_cse3,
    "Double-YOLOv3-Fshare-CSE": build_double_yolov3_fshare_cse,
    "Double-YOLOv3-Global-Fshare-CSE": build_double_yolov3_global_fshare_cse,
    "Double-YOLOv3-Global-Fshare-Add-SL":
        build_double_yolov3_global_fshare_add_sl,
    "Visible-YOLOv4-Normal": build_yolov4,
    "Double-YOLOv4-Add-SL": build_double_yolov4,
    "Double-YOLOv4-CSE": lambda **kw: build_double_yolov4(fusion="cse", **kw),
    "Double-YOLOv4-Fshare-Global-CSE3": build_double_yolov4_global_fshare_cse3,
    "Visible-YOLOv4-MobileNetv2": build_yolov4_mobilenetv2,
    "Visible-YOLOv4-MobileNetv3": build_yolov4_mobilenetv3,
    "Double-YOLOv4-MNv2-Fshare-Global-CSE3":
        build_double_yolov4_mnv2_global_fshare_cse3,
    "Double-YOLOv4-MNv3-Fshare-Global-CSE3":
        build_double_yolov4_mnv3_global_fshare_cse3,
}
