"""The general generator of serve mixes: one client that calls
``serving.Predictor.__call__`` with requests of uint8 frame pairs in host
memory, one after another (a closed loop), for the window.

The mix's file gives ``batch`` (pairs a request), ``ring`` (distinct
seeded requests, made at set-up and cycled through), ``src_hw``,
``img_size``, ``compute_dtype``, the NMS settings and
``checked_requests`` (how many of the ring's requests the check
compares). Set-up makes the
weights and the ring on the device from the seed, builds the Predictor
with the one bucket ``batch``, captures its graph and serves
``warm_requests`` requests. ``correct``: every answer served in the
window to a seeded sample of the ring's requests, against the float32
reference of its request (:mod:`perfbench.compare_serve`).

Variants for the check's own readings (``--variant``): ``control``
serves through the program's int8 path in its ``edge`` mode (the most
convs in int8), the precision below the bf16 the cell states; the faults
``half`` (the second half of each request's frames answered with
nothing), ``alter`` (every box of each answer's first frame moved by half
its size), ``nms-none`` (the program's NMS at an IoU threshold of 1: it
suppresses nothing) and ``nms-over`` (at -1: it keeps one box a class).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _nms_kw(mix):
    return {k: mix[k] for k in ("conf_thres", "iou_thres", "max_det",
                                "top_k")}


def setup(ctx) -> None:
    import torch

    from perfbench import program, weights

    from perfbench.reference import detect

    mix, dev = ctx.mix, ctx.device
    b, h, w = mix["batch"], *mix["src_hw"]
    ctx.W = weights.seeded(ctx.model, ctx.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(ctx.seed) + 1) % (2 ** 63))
    ring = torch.randint(0, 256, (2, mix["ring"], b, h, w, 3),
                         dtype=torch.uint8, device=dev, generator=gen)
    weights.calibrate(ctx.model, ctx.W,
                      *(detect.letterbox(ring[i, 0, :1], mix["img_size"])
                        for i in (0, 1)))
    ctx.ring = ring.cpu().numpy()
    del ring
    ctx.serve = _server(ctx, torch, program)
    for i in range(mix["warm_requests"]):
        ctx.serve(ctx.ring[0, i % mix["ring"]], ctx.ring[1, i % mix["ring"]])


def _server(ctx, torch, program):
    """The callable the window drives: the Predictor's ``__call__``, or a
    variant of it."""
    from double_yolo_kaist_torch.serving import Predictor

    mix, v = ctx.mix, ctx.variant
    kw = _nms_kw(mix)
    iou_thres = {"nms-none": 1.0, "nms-over": -1.0}.get(v, kw["iou_thres"])
    int8 = v == "control"
    # int8 quantizes from the fold on the host, as a server loading a
    # checkpoint does
    W = ({k: {kk: (vv.cpu() if hasattr(vv, "cpu") else
                   {a: b.cpu() for a, b in vv.items()})
              for kk, vv in p.items()} for k, p in ctx.W.items()}
         if int8 else ctx.W)
    pred = Predictor(program.compile_ir(ctx.cfg),
                     program.variables(ctx.model, W),
                     img_size=mix["img_size"],
                     conf_thres=kw["conf_thres"], iou_thres=iou_thres,
                     max_det=kw["max_det"], batch_buckets=(mix["batch"],),
                     compute_dtype=getattr(torch, mix["compute_dtype"]),
                     int8=int8, int8_mode="edge", device=ctx.device)
    ctx.predictor = pred
    if not int8:
        pred.warmup(tuple(mix["src_hw"]), mix["batch"])
    if v in ("program", "control", "nms-none", "nms-over"):
        return pred
    if v == "half":
        def half(v_u8, l_u8):
            out = pred(v_u8, l_u8)
            n = len(out) // 2
            return out[:n] + [(np.zeros((0, 4), np.float32),
                               np.zeros(0, np.float32),
                               np.zeros(0, np.int64))] * (len(out) - n)
        return half
    if v == "alter":
        def alter(v_u8, l_u8):
            out = pred(v_u8, l_u8)
            bx, s, c = out[0]
            out[0] = (bx + np.tile(bx[:, 2:] - bx[:, :2], 2) * 0.5, s, c)
            return out
        return alter
    raise ValueError(f"unknown variant {v}")


def window(ctx) -> None:
    """Requests back to back until ``ctx.seconds`` have passed; each
    request's latency on the host clock, from the call to its answer."""
    mix = ctx.mix
    r, b = mix["ring"], mix["batch"]
    lat, answers = [], []
    t0 = time.perf_counter()
    i = 0
    now = t0
    while now - t0 < ctx.seconds:
        k = i % r
        t = time.perf_counter()
        try:
            out = ctx.serve(ctx.ring[0, k], ctx.ring[1, k])
        except RuntimeError as e:
            ctx.failed += 1
            ctx.counts.setdefault("errors", []).append(str(e)[:200])
            out = None
        now = time.perf_counter()
        lat.append(now - t)
        answers.append((k, out))
        i += 1
    span = now - t0
    ctx.attempted = len(lat)
    ctx.answers = answers
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    n = len(lat_ms)
    ctx.e2e["frames_per_s"] = n * b / span
    ctx.e2e["request_p95_ms"] = float(lat_ms[int(np.ceil(0.95 * n)) - 1])
    ctx.counts.update(requests=n, frames=n * b, window_s=span,
                      request_p50_ms=float(np.median(lat_ms)),
                      beyond_p95=int(n - np.ceil(0.95 * n)))
    print(f"window: {n} requests of {b} pairs in {span:.3f} s; latency "
          f"p50 {np.median(lat_ms):.3f} ms, p95 "
          f"{ctx.e2e['request_p95_ms']:.3f} ms over {n} samples",
          file=sys.stderr)


def release(ctx) -> None:
    ctx.serve = None
    ctx.predictor = None


def check(ctx) -> dict:
    """Every answer of the window to the requests of a sample of the ring
    drawn from the seed (``checked_requests`` of them) against the float32
    reference of its request, beside a plain bf16 computation of the same
    request (:mod:`perfbench.compare_serve`); each distinct answer once."""
    import torch

    from perfbench import compare_serve as C
    from perfbench.reference import detect, model as RM

    mix = ctx.mix
    kw = _nms_kw(mix)
    clear = (C.MARGIN, C.IOU_SLACK)
    ring = mix["ring"]
    sample = set(np.random.default_rng(ctx.seed).choice(
        ring, min(mix["checked_requests"], ring), replace=False).tolist())
    refs: dict = {}
    frames, emu, seen = [], [], set()
    for k, out in ctx.answers:
        if out is None or k not in sample:
            continue
        key = (k, b"".join(np.asarray(x).tobytes() for f in out for x in f))
        if key in seen:
            continue
        seen.add(key)
        if k not in refs:
            v, l = (torch.from_numpy(ctx.ring[i, k]).to(ctx.device)
                    for i in (0, 1))
            with RM.strict_fp32(), torch.no_grad():
                refs[k] = detect.serve(ctx.model, ctx.W, v, l, kw,
                                       mix["img_size"], clear=clear)
                bf = detect.serve(ctx.model, ctx.W, v, l, kw,
                                  mix["img_size"], bf16=True, clear=clear)
            emu += [C.frame(e["det"], r, kw) for e, r in zip(bf, refs[k])]
        frames += [C.frame(f, r, kw) for f, r in zip(out, refs[k])]
    res = C.compare(frames, emu)
    ctx.counts.update({k: v for k, v in res.items() if k not in C.CHECKED},
                      distinct_answers=len(seen), references=len(refs))
    lim = ctx.cell.limits
    return {name: {"value": res[name], "limit": lim.get(name)}
            for name in C.CHECKED}
