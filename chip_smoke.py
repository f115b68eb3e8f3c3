#!/usr/bin/env python3
"""Smoke run of the PyTorch port (double_yolo_kaist_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: every kernel in double_yolo_kaist_torch/ops/csrc with nvcc
     for sm_90a, one nvcc per source, all started together;
  3. K1 (head decode), one launch for the three MNv3 heads at 512x640,
     bf16 in, against its plain version at bs 8 (the shape that is timed)
     and bs 1, both decode formulas; and a (2, 21, 13, 17) fp32 NCHW input
     that takes the kernel's general path;
  4. K2 (greedy NMS) against its plain version, max_det = 100, scores in
     random order: index-exact at K = 512 with 8 images (the shape that is
     timed and reported, also with the pool sorted as the serving path
     sorts it), at K = 1024 with 2 images and at K = 512 with 32; at each
     shape 200 more launches on the same pool must repeat the first;
  5. end to end: the MNv3 Fshare-Global-CSE3 Predictor with the trained
     fixture weights serves 512x640 uint8 visible+LWIR requests of 1, 3 and
     8 frames (bf16); the launch counts, cleared just before, must show K1
     once per forward (decoding every head) and K2 for every batch; the
     kernel-decoded heads are held against the plain decode of the same
     raw heads; and an fp32 run on a small input is held against the
     port's CPU path. K3 and K4 must not launch on this model;
  6. K3 (stem conv) against its plain version at the flagship's shape, bs
     8, (8, 512, 640, 32) -> 64 channels, bf16 for mish and leaky, and once
     in fp32 (TF32 off); and at an odd-sized input, (1, 37, 141, 32) -> 24;
     then the K3 probes (the kernel with stages left out: load, store,
     copy, mma, full) at the flagship's shape, each against its plain
     version, and one line of their times: the share of K3 that is loads,
     stores, MMAs and epilogue. The probes' launches are counted over one
     run of their own entry point, ops.stem_probe.breakdown;
  7. K4 (int8 GEMM) against its plain version at the flagship's ten chain
     1x1 shapes at bs 8 and at bs 1, each with the requant flag its int8
     plan gives it, bf16 epilogue and once fp32, and at a shape off every
     tile (M 1000, K 144, N 80); times per family of shapes (A: K 1024,
     B: K 512, C: K 256) beside each bound and the library call's time;
  8. end to end: the flagship Double-YOLOv4-Fshare-Global-CSE3 at full
     width and depth with seeded weights, served in bf16 and then in int8
     (two calibration requests of 8 frames, then int8 requests of 1, 3 and
     8); the launch counts of each request must show K3 twice per forward,
     K4 ten times per int8 forward and never otherwise, K1 once per
     forward for its three heads and K2 per batch; the profile of one stem conv as the forward calls it must
     show K3's kernel and nothing else (the weights are packed when they
     are placed); an int8 fp32 run on the card on a small input is held
     against the port's int8 CPU path on the same quantized weights;
  9. evaluate: an 80-pair KAIST-layout split of 640x512 frames from a seed
     (JPEGs, or without cv2 the dataset's disk cache), labelled with the 5
     most confident MNv3 fp32 detections of each frame, scored by
     eval.evaluator.evaluate_dataset in rect batches of 32 at 416x512:
     fp32 on the card against the port's CPU path on 8 frames (VOC-AP,
     LAMR and the 12 COCO stats within 1e-3); MNv3 bf16 from the device
     pool, the pinned host pool and streaming (identical predictions), with
     fps, the device busy share of the batch loop and host ms per stage;
     the flagship (seeded
     weights) in bf16 and int8 chain, calibrating on the first 2 batches
     and saving the artifact, then from the artifact (identical
     predictions); launch counts per run (K1 once per forward, K2 once per
     batch, K3 twice per flagship forward, K4 ten times per int8 forward);
     K1-K4 held against their plain versions at the eval's shapes (K2 on
     the pools the eval runs handed it); and the entry point
     ``python -m double_yolo_kaist_torch.evaluate`` as a subprocess, given
     the model by its zoo name, whose VOC-AP must be within 1e-3 of the
     in-process bf16 run's;
 10. serving from CUDA graphs, on the Predictors of phases 5 and 8 (MNv3
     bf16, the flagship bf16 and int8): requests of 1, 3 and 8 frames
     through ``Predictor.__call__``, each one replay of its bucket's graph,
     must give exactly the detections of the eager path (``run_batch`` +
     ``unpack_detections``) on the same frames; one torch.profiler window
     around one replay must show K1 once, K2 once, K3 twice (flagship) and
     K4 ten times (int8) by kernel name; the median (min-max) request ms of
     graph and eager at bs 1 and 8 with their device busy shares;
 11. the entry points as subprocesses: ``serve`` (the MNv3 zoo name and a
     checkpoint directory) answering 32 concurrent raw-frame ``/detect``
     requests with the in-process Predictor's detections, its ``/healthz``
     showing a mean micro-batch above 1; ``detect --no-figure`` on 8 pairs
     of phase 9's split, its count per image the in-process Predictor's;
     ``bench --bf16`` and ``bench --int8``, each printing its JSON line; and
     in process a MicroBatcher over the flagship bf16 graph Predictor with
     16 submitter threads, giving what unbatched requests give;
 12. the train step on the card: MNv3 (fixture weights) at bs 2, 128x160,
     one SGD and one Adam step from the same variables and batch on the
     card and on the CPU, TF32 off: in float64 activations the losses,
     grad norm, parameter deltas and BN running stats must agree within
     STEP_F64_BOUNDS; in fp32 the card must be as close to the float64
     step as the CPU is (3x its error + 1e-6). Then the flagship at full
     width and depth from graph.init, bf16, bs 8, 512x512, 20 Adam steps
     at lr 1e-3 on one fixed batch: every loss finite, the last below the
     first; median / min / max step ms over 10 steps after 3, images/s,
     the device busy share and the top 10 kernels of one profiled step,
     and the peak memory; MNv3's step at the same shape;
 13. training end to end: the Trainer in process (flagship bf16, bs 8, one
     epoch on phase 9's split and its evaluation), whose launch counts
     must show K1 and K2 once and K3 twice per evaluation batch; then
     ``python -m double_yolo_kaist_torch.train`` as subprocesses: 2 epochs
     (``last``, ``best``, ``results.txt``), ``--resume <out>/last --epochs
     3`` (one more epoch), and MNv3 fine-tuned with ``--ema`` for 1 epoch
     from phase 9's checkpoint (SGD); their checkpoints hold the JAX package's
     layout (every key of params, BN state, the Adam or SGD optimizer
     state and the EMA; ``load_checkpoint`` takes them all); ``python -m
     double_yolo_kaist_torch.evaluate`` on the flagship's and MNv3's
     ``last`` at the trainer's batch size must print the last mAP of its
     results.txt and give the detections of the checkpoint scored in
     process;
 14. slice 8 (``--only int8aug`` runs it after phase 8): CLAHE on seeded
     uint8 frames (8 at 512x640, 2 at 1024x1024, random and low-contrast)
     and the snowflake cutout of 8 canvases of 1024x1024 from the same
     uniforms, byte for byte the CPU's, with device ms; one
     make_train_augment_fn(snowflake=True, clahe=True) batch of 8 at 512
     from the same randoms on the card and the CPU (at most 0.5% of pixels
     differ, the CPU test's bound against JAX; labels within 1e-5, masks
     equal) and its data ms; the flagship at full width in int8 edge,
     spine and spineall: each Predictor calibrates on two requests of 8,
     quantizes and saves its artifact, serves 1 and 8 frames from CUDA
     graphs with K4 launched as its plan says (106, 10, 56 a forward), and
     a Predictor from the artifact must serve the same detections bit for
     bit; spine plans as chain does, and its artifact must be chain's
     quantization of the same stats, so it is not timed; edge and
     spineall: every K4 call of an eager forward at bs 8 and bs 1 against
     ``qgemm_plain`` on the same operands, median / min / max request ms
     and the device busy share beside phase 8's bf16 and chain, the
     startup from the artifact against calibrate + quantize, and the int8
     path on the card against the CPU at 64x96 as phase 8 holds chain;
     then ``python -m double_yolo_kaist_torch.calibrate --quantized-out``
     (MNv3, edge) and ``evaluate --int8 --int8-mode edge --int8-qvars`` on
     its artifact as subprocesses, whose VOC-AP line must be
     evaluate_dataset(quantized=)'s in process, and every K4 call of the
     eval's first batch against ``qgemm_plain``, while ``python -m
     double_yolo_kaist_torch.train --snow --clahe`` runs one epoch of 8
     pairs of phase 9's split beside them (``last``, ``results.txt``).
``python3 chip_smoke.py --only train`` runs phases 12 and 13 alone, and
``--only int8aug`` phases 8 and 14 (no result line). After each phase the
script prints its elapsed time. Then a JSON line of
kernel numbers, the nvidia-smi line, and last {"ok": true, "device":
{...}}.

Times come from CUDA events (kernels) or the host clock around a
synchronised request (end to end), after warm-up; each is the median of
several runs. A Predictor on the card serves each bucket from one CUDA
graph (phases 5, 8, 10); a graph's kernels are counted on each replay. bound_ms is the least time the card could take: the larger of
bytes moved (each input read once, each output written once) at 3.35 TB/s
and operations at the peak rate of the work's own type (H100 SXM data
sheet, dense, 700 W): 67 TFLOP/s fp32 on the CUDA cores for K1 and K2,
989 TFLOP/s bf16 on the tensor cores for K3, 1979 TOP/s int8 for K4.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MNV3_CFG = os.path.join(
    ROOT, "configs", "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
MNV3_NPZ = os.path.join(ROOT, "tests", "fixtures", "fullparity",
                        "mnv3_selftrained.fp16.npz")
FLAGSHIP_CFG = os.path.join(ROOT, "configs",
                            "kaist_dyolov4_fshare_global_concat_se3.cfg")
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12            # CUDA cores
BF16_OPS_PER_S = 989e12           # tensor cores, dense
INT8_OPS_PER_S = 1979e12          # tensor cores, dense
SEED = 0
MNV3_NAME = "Double-YOLOv4-MNv3-Fshare-Global-CSE3"   # its zoo name
K2_REPEATS = 200      # launches of K2 on one pool that must all agree


def _stamp(t0: float, what: str) -> None:
    """The script's elapsed time after ``what`` (where its time goes)."""
    print(f"[{time.perf_counter() - t0:.1f} s] {what} done", flush=True)


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters=20, reps=7, warmup=3):
    """Median over ``reps`` of the mean time of ``iters`` calls, by CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _profile(torch, fn, iters=1):
    """torch.profiler over ``iters`` calls of ``fn``: {kernel name: device
    ms per call}, or {} when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            # the profiler may drop an event of the window: the mean time
            # of those it kept, times the launches a call makes
            per_call = max(1, round(e.count / iters))
            out[e.key] = out.get(e.key, 0.0) + us / e.count * per_call / 1e3
    return out


def _kernel_events(torch, fn, iters):
    """{kernel name: device events} of ``iters`` calls of ``fn`` in one
    torch.profiler window. The profiler may lose an event of a window
    (its first, as a rule), and a short window may come back empty: the
    callers allow for the one and try the other again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:                          # device activity, not API calls
            out[e.key] = e.count
    return out


def _device_ms(torch, fn, name: str, iters=20):
    """Device time per call of the kernels whose name holds ``name``; None
    if three profiler windows in a row show none of them."""
    for _ in range(3):                      # a blind window is tried again
        prof = _profile(torch, fn, iters)
        total = sum(ms for k, ms in prof.items() if name in k)
        if total > 0:
            return total
    return None


def _bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    """The larger of bytes at the HBM rate and operations at ``ops_per_s``,
    the peak of the work's own type: FP32_OPS_PER_S (K1, K2),
    BF16_OPS_PER_S (K3), INT8_OPS_PER_S (K4)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k1_hold(torch, got, want, what):
    """K1's bound: 1e-5 relative + 1e-5 (the same fp32 formulas; expf and
    the library's exp differ by a few ulp). Returns the max abs error."""
    torch.cuda.synchronize()
    bad = (got - want).abs() > 1e-5 * want.abs() + 1e-5
    e = float((got - want).abs().max())
    print(f"K1 {what}: max_abs_err {e:.3e} (bound 1e-5 rel + 1e-5), "
          f"{int(bad.sum())} elements over", flush=True)
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"K1 {what} disagrees with its plain version")
    return e


def phase_decode(torch, ir, dev, launches):
    """K1, one launch for the three MNv3 heads at 512x640, bf16 in: bs 8
    (timed) and bs 1, both formulas; and one input on the general path."""
    from double_yolo_kaist_torch.ops import decode as K1
    (h, w), no = (512, 640), ir.nc + 5
    g = torch.Generator(device=dev).manual_seed(SEED)

    def make(bs):
        heads = []
        for node in ir.head_nodes():
            s = node.yolo_stride
            x = torch.randn((bs, len(node.anchors) * no, h // s, w // s),
                            generator=g, device=dev)
            heads.append((x.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last), node.anchors, s))
        return heads

    def plain(heads, bf_type):
        return torch.cat([K1.decode_head_plain(
            K1.reshape_head(x, len(a), x.shape[1] // len(a)), a, s, bf_type)
            for x, a, s in heads], dim=1)

    err = 0.0
    for bs in (8, 1):
        heads = make(bs)
        if not all(K1.fast_path(x.shape, x.stride(), x.dtype, len(a))
                   for x, a, _ in heads):
            raise AssertionError("an MNv3 head is off K1's 16-byte path")
        for bf_type in ("yolov3", "yolov4"):
            n0 = launches["decode_head"]
            got = K1.decode_heads(heads, bf_type)
            if launches["decode_head"] != n0 + 1:
                raise AssertionError("K1 took more than one launch for "
                                     "three heads")
            err = max(err, _k1_hold(torch, got, plain(heads, bf_type),
                                    f"{bf_type} bs {bs}, 3 heads, 1 launch"))
    # the general path: NCHW fp32, a grid off the warps, 2 classes
    anchors = ir.head_nodes()[0].anchors
    xg = torch.randn((2, len(anchors) * 7, 13, 17), generator=g, device=dev)
    if K1.fast_path(xg.shape, xg.stride(), xg.dtype, len(anchors)):
        raise AssertionError("the general-path input took the fast path")
    for bf_type in ("yolov3", "yolov4"):
        err = max(err, _k1_hold(
            torch, K1.decode_heads([(xg, anchors, 8)], bf_type),
            plain([(xg, anchors, 8)], bf_type),
            f"{bf_type} (2, {xg.shape[1]}, 13, 17) fp32 NCHW, general path"))

    bf = ir.head_nodes()[0].bf_type
    res = {}
    for bs in (8, 1):
        heads = make(bs)
        rows = sum(len(a) * x.shape[2] * x.shape[3] for x, a, _ in heads)
        out = torch.empty((bs, rows, no), device=dev)

        def kernel():
            return K1.decode_heads(heads, bf, out=out)

        def kernel_replanned():             # what the kept plan saves
            K1._plan.cache_clear()
            return K1.decode_heads(heads, bf, out=out)

        ms = _time_ms(torch, kernel)
        replanned_ms = _time_ms(torch, kernel_replanned)
        device_ms = _device_ms(torch, kernel, "decode_heads_kernel")
        plain_ms = _time_ms(torch, lambda: plain(heads, bf))
        elems = bs * rows * no
        bound, by = _bound_ms(elems * (2 + 4), elems * 8, FP32_OPS_PER_S)
        print(f"K1 {bf} bs {bs}, 3 heads in 1 launch: kernel {ms:.4f} ms by "
              f"events ({replanned_ms:.4f} ms with the plan made anew each "
              f"call; device {device_ms} ms), plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({by})", flush=True)
        res[bs] = {"ms": ms, "replanned_ms": replanned_ms,
                   "device_ms": device_ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by}
    return {"max_abs_err": err, **res[8], "bs1_ms": res[1]["ms"],
            "bs1_device_ms": res[1]["device_ms"],
            "bs1_bound_ms": res[1]["bound_ms"]}


def _nms_pool(torch, dev, bs, k, seed):
    rng = np.random.default_rng(seed)
    xy = rng.random((bs, k, 2), dtype=np.float32) * [640, 512]
    wh = rng.random((bs, k, 2), dtype=np.float32) * 120 + 4
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32)).to(dev)
    scores = torch.from_numpy(rng.random((bs, k), dtype=np.float32)).to(dev)
    scores[1, 50:] = -1e10                 # one image with a short pool
    return boxes, scores


def phase_nms(torch, dev):
    """K2, max_det = 100, scores in random order: K 512 x 8 images (timed
    and reported), K 1024 x 2 and K 512 x 32 (checked and timed)."""
    from double_yolo_kaist_torch.ops.nms_kernel import (nms_indices,
                                                        nms_indices_plain)
    max_det, iou = 100, 0.5
    out, err = {}, 0.0
    for bs, k in ((8, 512), (2, 1024), (32, 512)):
        boxes, scores = _nms_pool(torch, dev, bs, k, SEED + k + bs)
        idx, valid = nms_indices(boxes, scores, iou, max_det)
        ridx, rvalid = nms_indices_plain(boxes, scores, iou, max_det)
        torch.cuda.synchronize()
        same = (torch.equal(valid, rvalid)
                and torch.equal(torch.where(valid, idx, 0),
                                torch.where(rvalid, ridx, 0)))
        # the largest difference of a kept index (0 where index-exact)
        err = max(err, float((torch.where(valid, idx, 0).long()
                              - torch.where(rvalid, ridx, 0).long())
                             .abs().max()))
        print(f"K2 bs {bs} K {k} max_det {max_det}: index-exact {same}, "
              f"kept per image {valid.sum(1).tolist()}; then {K2_REPEATS} "
              f"launches on the same pool, each held against the first",
              flush=True)
        if not same:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"bs {bs}, K {k}")
        # launch after launch on the same pool: every output the same
        want = (valid, torch.where(valid, idx, 0))
        outs = [nms_indices(boxes, scores, iou, max_det)
                for _ in range(K2_REPEATS)]
        torch.cuda.synchronize()
        bad = [n for n, (i, v) in enumerate(outs) if not (
            torch.equal(v, want[0])
            and torch.equal(torch.where(v, i, 0), want[1]))]
        if bad:
            raise AssertionError(f"K2 at bs {bs}, K {k}: launches {bad[:10]} "
                                 f"of {K2_REPEATS} on the same pool disagree "
                                 f"with the first")
        del outs
        ms = _time_ms(torch, lambda: nms_indices(boxes, scores, iou, max_det))
        device_ms = _device_ms(
            torch, lambda: nms_indices(boxes, scores, iou, max_det),
            "nms_kernel")
        kept = int(valid.sum())
        # bytes: boxes + scores in, idx + valid out; operations: one IoU
        # (~14 flops) per kept winner and candidate, one compare per round
        # and candidate
        bound, by = _bound_ms(bs * k * 20 + bs * max_det * 8,
                              kept * k * 14 + (kept + bs) * k, FP32_OPS_PER_S)
        out[(bs, k)] = {"ms": ms, "device_ms": device_ms, "bound_ms": bound,
                        "bound_by": by}
        if (bs, k) == (8, 512):
            out[(bs, k)]["plain_ms"] = _time_ms(
                torch, lambda: nms_indices_plain(boxes, scores, iou, max_det),
                iters=3, reps=3, warmup=1)
            # the pool as the serving path hands it over: sorted descending
            top, order = torch.sort(scores, dim=1, descending=True,
                                    stable=True)
            sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)
                                  ).contiguous()
            top = top.contiguous()
            sidx, svalid = nms_indices(sboxes, top, iou, max_det)
            torch.cuda.synchronize()
            if not (torch.equal(svalid, valid) and torch.equal(
                    torch.where(svalid, torch.gather(order, 1, sidx.long()),
                                0), torch.where(valid, idx.long(), 0))):
                raise AssertionError("K2 on the sorted pool disagrees with "
                                     "K2 on the same pool in random order")
            out[(bs, k)]["sorted_ms"] = _time_ms(
                torch, lambda: nms_indices(sboxes, top, iou, max_det))
            out[(bs, k)]["sorted_device_ms"] = _device_ms(
                torch, lambda: nms_indices(sboxes, top, iou, max_det),
                "nms_kernel")
        print(f"K2 bs {bs} K {k}: kernel {ms:.4f} ms (device {device_ms} "
              f"ms), bound {bound:.6f} ms ({by}); " + ", ".join(
                  f"{n} {v}" for n, v in out[(bs, k)].items()
                  if n in ("plain_ms", "sorted_ms", "sorted_device_ms")),
              flush=True)
    main = out[(8, 512)]
    return {"max_abs_err": err, **main,
            "k1024_bs2_ms": out[(2, 1024)]["ms"],
            "k1024_bs2_device_ms": out[(2, 1024)]["device_ms"],
            "k512_bs32_ms": out[(32, 512)]["ms"],
            "k512_bs32_device_ms": out[(32, 512)]["device_ms"]}


def phase_end_to_end(torch, ir, dev, launches):
    from double_yolo_kaist_torch.models import graph, weights
    from double_yolo_kaist_torch.ops import decode as K1
    from double_yolo_kaist_torch.ops.decode import decode_head_plain
    from double_yolo_kaist_torch.serving import Predictor

    variables = weights.load_state_dict_npz(ir, MNV3_NPZ)
    pred = Predictor(ir, variables, img_size=640, device=dev)
    rng = np.random.default_rng(SEED)
    frames = {n: (rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8),
                  rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8))
              for n in (1, 3, 8)}
    for n in (1, 3, 8):                    # warm-up (cuDNN plans, build)
        pred(*frames[n])
    torch.cuda.synchronize()

    n_heads = len(ir.yolo_indices)
    launches.clear()                        # the main path's run starts here
    for n in (1, 3, 8):
        before = dict(launches)
        t0 = time.perf_counter()
        out = pred(*frames[n])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        d1 = launches["decode_head"] - before.get("decode_head", 0)
        d2 = launches["nms_indices"] - before.get("nms_indices", 0)
        dh = launches[K1.HEADS_DECODED] - before.get(K1.HEADS_DECODED, 0)
        print(f"request of {n} (bucket {pred._bucket(n)}): {dt:.3f} ms, "
              f"detections per image {[len(b) for b, _, _ in out]}, "
              f"K1 launches {d1} ({dh} heads), K2 launches {d2}", flush=True)
        if d1 != 1 or dh != n_heads or d2 != 1:
            raise AssertionError(f"request of {n}: want 1 K1 launch for "
                                 f"{n_heads} heads and 1 K2 launch, got {d1} "
                                 f"for {dh} and {d2}")
        if len(out) != n or not all(np.isfinite(b).all() and
                                    np.isfinite(s).all() for b, s, _ in out):
            raise AssertionError(f"request of {n}: bad output")
    counts = dict(launches)                 # read just after the run
    if counts.get("stem_conv_s2", 0) or counts.get("qgemm", 0):
        raise AssertionError(f"MNv3 launched K3 or K4: {counts}")

    times = {}
    for n in (1, 3, 8):
        ts = []
        for _ in range(12):
            t0 = time.perf_counter()
            pred(*frames[n])
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[n] = statistics.median(ts)
        print(f"ms per request of {n} frames, 12 requests: median "
              f"{times[n]:.3f}, min {min(ts):.3f}, max {max(ts):.3f}",
              flush=True)

    # where a request's time goes on the device
    for n in (1, 8):
        prof = _profile(torch, lambda: pred(*frames[n]))
        busy = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile, request of {n}: device busy {busy:.3f} ms, "
              f"{100 * busy / times[n]:.1f}% of the median request time; "
              f"{len(prof)} kernel names; top: "
              + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top), flush=True)

    # kernel-decoded heads of one batch vs the plain decode of its raw heads
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            v = torch.from_numpy(frames[8][0]).to(dev)
            l = torch.from_numpy(frames[8][1]).to(dev)
            fn, _, _ = pred._preprocess((512, 640))
            xv, xl = fn(v, l)
            io, raw = graph.apply_folded(ir, pred.folded, xv, xl,
                                         compute_dtype=torch.bfloat16)
            plain = torch.cat([decode_head_plain(r, n.anchors, n.yolo_stride,
                                                 n.bf_type)
                               for r, n in zip(raw, ir.head_nodes())], 1)
            torch.cuda.synchronize()
        err = float((io - plain).abs().max())
        bad = int(((io - plain).abs() > 1e-5 * plain.abs() + 1e-5).sum())
        print(f"e2e decoded heads vs plain decode (bs 8): max_abs_err "
              f"{err:.3e}, {bad} elements over 1e-5 rel + 1e-5", flush=True)
        if bad or not torch.isfinite(io).all():
            raise AssertionError("kernel-decoded heads disagree")

        # fp32 on the card vs the port's CPU path on a small input
        small = rng.integers(0, 256, (2, 2, 64, 96, 3), dtype=np.uint8)
        kw = dict(img_size=96, conf_thres=0.01, batch_buckets=(2,),
                  compute_dtype=torch.float32)
        got = Predictor(ir, variables, device=dev, **kw)(*small)
        want = Predictor(ir, variables, device="cpu", **kw)(*small)
        if len(got) != len(want):
            raise AssertionError("fp32 card run: wrong number of images")
        for (b, s, c), (rb, rs, rc) in zip(got, want):
            if (b.shape != rb.shape or not np.allclose(b, rb, 1e-4, 1e-2)
                    or not np.allclose(s, rs, 1e-4, 1e-3)
                    or not (c == rc).all()):
                raise AssertionError("fp32 card run disagrees with the CPU "
                                     "path on the small input")
        print(f"fp32 small input, card vs CPU: detections "
              f"{[len(b) for b, _, _ in got]} agree (boxes 1e-2 px, scores "
              f"1e-3)", flush=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return counts, times, (pred, frames, variables)

class _NoTF32:
    """TF32 off for cuDNN and matmuls inside the block (fp32 checks)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.prev = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.prev


def phase_stem(torch, dev):
    """K3 at the flagship's stem shape, bs 8: bf16 (mish, leaky) and fp32."""
    import torch.nn.functional as F

    from double_yolo_kaist_torch.models import layers as L
    from double_yolo_kaist_torch.ops.stem import (pack_weights, stem_conv_s2,
                                                  stem_conv_s2_plain)
    bs, h, w, c, o = 8, 512, 640, 32, 64
    g = torch.Generator(device=dev).manual_seed(SEED)
    x32 = torch.rand((bs, c, h, w), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    w32 = torch.randn((o, c, 3, 3), generator=g, device=dev) * 0.06
    b32 = torch.randn((o,), generator=g, device=dev) * 0.1
    err = 0.0
    with _NoTF32(torch):
        for dtype, act, rtol, atol in (
                (torch.bfloat16, "mish", 2 ** -7, 1e-5),
                (torch.bfloat16, "leaky", 2 ** -7, 1e-5),
                (torch.float32, "mish", 1e-5, 1e-5)):
            x, wt = x32.to(dtype), w32.to(dtype)
            got = stem_conv_s2(x, pack_weights(wt, b32), act)
            want = stem_conv_s2_plain(x, wt, b32, act)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            bad = int((d > rtol * want.float().abs() + atol).sum())
            e = float(d.max())
            print(f"K3 {dtype} {act}: max_abs_err {e:.3e} (bound {rtol:.3g} "
                  f"rel + {atol:g}), {bad} elements over", flush=True)
            if bad or not torch.isfinite(got).all():
                raise AssertionError(f"K3 {dtype} {act} disagrees with its "
                                     f"plain version")
            if dtype == torch.bfloat16:
                err = max(err, e)
        # odd H and W, 24 outputs: the zero fill on all four sides
        xo = torch.rand((1, c, 37, 141), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wo = w32[:24].to(torch.bfloat16)
        for act in ("mish", "leaky"):
            got = stem_conv_s2(xo, pack_weights(wo, b32[:24]), act)
            want = stem_conv_s2_plain(xo, wo, b32[:24], act)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            bad = int((d > 2 ** -7 * want.float().abs() + 1e-5).sum())
            print(f"K3 bf16 {act} (1, 32, 37, 141) -> 24: max_abs_err "
                  f"{float(d.max()):.3e}, {bad} elements over", flush=True)
            if bad or got.shape != (1, 24, 19, 71):
                raise AssertionError(f"K3 {act} disagrees with its plain "
                                     f"version at the odd-sized input")
        x, wt = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        b16 = b32.to(torch.bfloat16)
        weights = pack_weights(wt, b32)    # once, as graph.place_folded
        weights32 = pack_weights(w32, b32)

        def kernel():
            return stem_conv_s2(x, weights, "mish")

        ms = _time_ms(torch, kernel)
        device_ms = _device_ms(torch, kernel, "stem_wg_kernel")
        plain_ms = _time_ms(torch, lambda: stem_conv_s2_plain(
            x, wt, b32, "mish"), iters=5, reps=5)
        library_ms = _time_ms(torch, lambda: L.activate("mish", F.conv2d(
            x, wt, b16, stride=2, padding=1)))
        ms32 = _time_ms(torch, lambda: stem_conv_s2(x32, weights32, "mish"),
                        iters=5, reps=5)
    n_bytes = (x.numel() + bs * o * (h // 2) * (w // 2) + wt.numel()) * 2 \
        + o * 4
    bound, by = _bound_ms(n_bytes, 2 * bs * o * (h // 2) * (w // 2) * 9 * c,
                          BF16_OPS_PER_S)
    print(f"K3 bf16 mish bs {bs} (8, 32, 512, 640) -> 64: kernel {ms:.4f} "
          f"ms (device {device_ms} ms), plain {plain_ms:.4f} ms, library "
          f"(cuDNN conv + eager mish) {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); fp32 kernel {ms32:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def phase_probes(torch, dev, launches):
    """The K3 probes at the flagship's stem shape, bs 8: each variant
    against its plain version, then their times."""
    import torch.nn.functional as F

    from double_yolo_kaist_torch.models import layers as L
    from double_yolo_kaist_torch.ops import stem_probe as SP
    from double_yolo_kaist_torch.ops.stem import pack_weights
    bs, h, w, c, o = 8, 512, 640, 32, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.rand((bs, c, h, w), generator=g, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((o, c, 3, 3), generator=g, device=dev) * 0.06).to(
        torch.bfloat16)
    weights = pack_weights(
        wt, torch.randn((o,), generator=g, device=dev) * 0.1)
    strips, seg_rows, runs = SP.plan(x, o)
    print(f"K3 grid at bs {bs}: {strips} strips x {runs} runs of {seg_rows} "
          f"output rows = {bs * strips * runs} blocks", flush=True)
    variants = ("load", "store", "copy", "mma", "full")
    err, plain_ms, device_ms = 0.0, {}, {}
    with _NoTF32(torch):
        for v in variants:
            got = SP.probe(v, x, weights, "mish", fill=0.75)
            want = SP.probe_plain(v, x, weights, "mish", seg_rows, fill=0.75)
            torch.cuda.synchronize()
            if v in ("load", "store", "copy"):
                ok, e = torch.equal(got, want), 0.0
            else:
                d = (got.float() - want.float()).abs()
                ok = not bool((d > 2 ** -7 * want.float().abs() + 1e-5).any())
                e = float(d.max())
            print(f"K3 probe {v}: agrees with its plain version {ok} "
                  f"(max_abs_err {e:.3e}; load, store, copy exact, mma and "
                  f"full 2^-7 rel + 1e-5)", flush=True)
            if not ok:
                raise AssertionError(f"K3 probe {v} disagrees with its plain "
                                     f"version")
            err = max(err, e)
            del got, want
            plain_ms[v] = _time_ms(torch, lambda: SP.probe_plain(
                v, x, weights, "mish", seg_rows, fill=0.75), iters=2, reps=3,
                warmup=1)
            device_ms[v] = _device_ms(
                torch, lambda: SP.probe(v, x, weights, "mish"),
                "stem_wg_kernel")
        # one PyTorch call for the same function, where there is one; none
        # sums the ring's loads per block as ``load`` does. They are timed
        # here and used nowhere in the port.
        y = torch.empty((bs, o, h // 2, w // 2), dtype=x.dtype, device=dev,
                        memory_format=torch.channels_last)
        y_nhwc = y.permute(0, 2, 3, 1)
        # even rows, column pairs side by side: copy_plain for O = 64, even W
        src = x.permute(0, 2, 3, 1)[:, ::2].unflatten(
            2, (w // 2, 2)).flatten(3)
        b16 = weights.b.to(torch.bfloat16)
        library = {
            "load": None,
            "store": lambda: y.fill_(0.75),
            "copy": lambda: y_nhwc.copy_(src),
            "mma": lambda: F.conv2d(x, wt, stride=2, padding=1),
            "full": lambda: L.activate("mish", F.conv2d(x, wt, b16, stride=2,
                                                        padding=1))}
        if not torch.equal(library["copy"](),
                           SP.copy_plain(x, o).permute(0, 2, 3, 1)):
            raise AssertionError("the copy probe's library call is not its "
                                 "plain version")
        d = (library["mma"]().float() - SP.probe_plain(
            "mma", x, weights, "mish", seg_rows).float()).abs()
        if float(d.max()) > 2 ** -6:
            raise AssertionError("the mma probe's library call is not its "
                                 "plain version")
        library_ms = {v: None if fn is None else _time_ms(torch, fn, iters=10,
                                                          reps=5)
                      for v, fn in library.items()}
        del y, y_nhwc, src
    launches.clear()                       # the probes' own run
    times = SP.breakdown(x, weights, "mish")
    torch.cuda.synchronize()
    n_launches = launches["stem_probe"]     # read just after it
    # a share is of device times; where the profiler gave none for a
    # variant, its time by events stands in and the line says so
    dm = {v: device_ms[v] if device_ms[v] is not None else times[v]
          for v in variants}
    stand_ins = [v for v in variants if device_ms[v] is None]
    print("K3 probes, library call for the same function, ms (cuDNN conv "
          "for mma and, with eager mish, full; fill_ for store; one strided "
          "copy_ for copy; none for load): " + ", ".join(
              f"{v} {t if t is None else round(t, 4)}"
              for v, t in library_ms.items()), flush=True)
    print("K3 probes, ms by events (device ms): " + ", ".join(
        f"{v} {times[v]:.4f} ({device_ms[v]})" for v in variants)
        + (f"; shares estimated, from the time by events for {stand_ins}"
           if stand_ins else "")
        + f"; of full: loads {100 * dm['load'] / dm['full']:.0f}%, stores "
        f"{100 * dm['store'] / dm['full']:.0f}%, loads + stores together "
        f"(copy) {100 * dm['copy'] / dm['full']:.0f}%, MMAs on top (mma - "
        f"copy) {100 * (dm['mma'] - dm['copy']) / dm['full']:.0f}%, epilogue "
        f"on top (full - mma) {100 * (dm['full'] - dm['mma']) / dm['full']:.0f}"
        f"%", flush=True)
    in_b, out_b = x.numel() * 2, bs * o * (h // 2) * (w // 2) * 2
    w_b = wt.numel() * 2 + o * 4
    ops = 2 * bs * o * (h // 2) * (w // 2) * 9 * c
    bounds = {"load": _bound_ms(in_b, 0, BF16_OPS_PER_S)[0],
              "store": _bound_ms(out_b, 0, BF16_OPS_PER_S)[0],
              "copy": _bound_ms(in_b + out_b, 0, BF16_OPS_PER_S)[0],
              "mma": _bound_ms(in_b + out_b + w_b, ops, BF16_OPS_PER_S)[0],
              "full": _bound_ms(in_b + out_b + w_b, ops, BF16_OPS_PER_S)[0]}
    return {"launches": n_launches, "max_abs_err": err,
            "ms": sum(times.values()), "plain_ms": sum(plain_ms.values()),
            "bound_ms": sum(bounds.values()), "bound_by": "bytes",
            # the four variants that have a library call
            "library_ms": sum(t for t in library_ms.values() if t is not None),
            "variant_ms": times, "device_ms": device_ms,
            "variant_bound_ms": bounds, "variant_plain_ms": plain_ms,
            "variant_library_ms": library_ms}


def _k4_shapes(ir, bs, hw):
    """(node, M, K, N, requant) of the chain 1x1 convs K4 computes on the
    flagship at batch ``bs`` and input size ``hw``."""
    from double_yolo_kaist_torch.config.ir import infer_shapes
    from double_yolo_kaist_torch.models import quantize as Q
    targets, emits = Q.plan_quantization(ir, "chain")
    shapes = infer_shapes(ir, *hw)
    out = []
    for i in sorted(targets):
        node = ir.nodes[i]
        if Q._gemm_conv(node):
            _, ho, wo = shapes[i]
            out.append((i, bs * ho * wo, node.in_ch, node.out_ch,
                        i in emits))
    return out


def _k4_case(torch, rng, dev, m, k, n, rq):
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    scale = torch.from_numpy((rng.random(n) * 1e-3 + 1e-5)
                             .astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=n) * 0.1).astype(np.float32))
    inv = np.float32(rng.random() * 20 + 5) if rq else None
    return {"x": x.to(dev), "w": wq.to(dev), "scale": scale.to(dev),
            "bias": bias.to(dev), "inv": inv, "mkn": (m, k, n)}


def _k4_hold(torch, case, what, out_dtype):
    """K4 against its plain version on one case: bf16 / fp32 outputs equal,
    s8 within 1 LSB on < 5%. Returns (the number of differing elements,
    the largest |kernel - plain|: in s8 steps where the output is s8)."""
    from double_yolo_kaist_torch.ops import qgemm as K4
    c = case
    got = K4.qgemm(c["x"], c["packed"], c["scale"], c["bias"], "leaky",
                   out_inv_s=c["inv"], out_dtype=out_dtype)
    want = K4.qgemm_plain(c["x"], c["w"], c["scale"], c["bias"], "leaky",
                          out_inv_s=c["inv"], out_dtype=out_dtype)
    torch.cuda.synchronize()
    if c["inv"] is not None:
        d = (got.int() - want.int()).abs()
        ok = int(d.max()) <= 1 and float((d != 0).float().mean()) < 0.05
    else:
        d = (got.float() - want.float()).abs()
        ok = torch.equal(got, want)
    n_bad, err = int((got != want).sum()), float(d.max())
    if not ok or got.dtype != want.dtype:
        raise AssertionError(f"K4 at {what} disagrees with its plain version "
                             f"({n_bad} elements, max abs {err})")
    return n_bad, err


def phase_qgemm(torch, ir, dev, launches):
    """K4 at the flagship's ten chain 1x1 shapes at bs 8 and bs 1 and at one
    ragged shape; times per family (A: K 1024, B: K 512, C: K 256) at bs 8."""
    from double_yolo_kaist_torch.ops import qgemm as K4
    rng = np.random.default_rng(SEED)
    cases = {}
    for bs in (8, 1):
        shapes = _k4_shapes(ir, bs, (512, 640))
        if len(shapes) != 10:
            raise AssertionError(f"expected 10 chain 1x1 convs, got {shapes}")
        cases[bs] = []
        for i, m, k, n, rq in shapes:
            c = _k4_case(torch, rng, dev, m, k, n, rq)
            c.update(layer=i, rq=rq, packed=K4.pack_weights(c["w"]),
                     w_t=c["w"].t().contiguous(),
                     family={1024: "A", 512: "B", 256: "C"}[k])
            cases[bs].append(c)
    n0 = launches["qgemm"]
    held = []                               # (elements differing, max abs)

    def hold(cs, what, dt):
        """Holds the cases; returns how many elements differ in them."""
        got = [_k4_hold(torch, c, what(c), dt) for c in cs]
        held.extend(got)
        return sum(n for n, _ in got)

    for bs in (8, 1):
        n_bad = hold(cases[bs], lambda c: f"l{c['layer']} bs {bs}",
                     torch.bfloat16)
        tiles = sorted({(c["family"], K4.choose_tile(*c["mkn"]))
                        for c in cases[bs]})
        print(f"K4 10 shapes, bs {bs}, leaky, bf16 epilogue: {n_bad} "
              f"elements differ (bound: bf16 outputs equal, s8 within 1 LSB "
              f"on < 5%); tiles {tiles}", flush=True)
    n_bad = hold(cases[8], lambda c: f"l{c['layer']} bs 8 fp32",
                 torch.float32)
    print(f"K4 10 shapes, bs 8, fp32 epilogue: {n_bad} elements differ",
          flush=True)
    # M off every tile, K off the 128-byte stage, N off the tile
    for rq in (False, True):
        c = _k4_case(torch, rng, dev, 1000, 144, 80, rq)
        c["packed"] = K4.pack_weights(c["w"])
        for dt in (torch.bfloat16, torch.float32):
            n_bad = hold([c], lambda c: f"M 1000 K 144 N 80 {dt}", dt)
            print(f"K4 ragged M 1000 K 144 N 80, requant {rq}, {dt}: tile "
                  f"{K4.choose_tile(1000, 144, 80)}, {n_bad} elements differ",
                  flush=True)
    if launches["qgemm"] - n0 != 34 or len(held) != 34:
        raise AssertionError("a K4 check did not launch the kernel once")
    err = max(e for _, e in held)
    n_differ = sum(n for n, _ in held)
    print(f"K4 34 checks: max_abs_err {err} (an s8 output's in s8 steps), "
          f"{n_differ} elements differ in all", flush=True)

    def run(cs, fn):
        for c in cs:
            fn(c)

    def kernel(c):
        return K4.qgemm(c["x"], c["packed"], c["scale"], c["bias"], "leaky",
                        out_inv_s=c["inv"])

    def plain(c):
        return K4.qgemm_plain(c["x"], c["w"], c["scale"], c["bias"], "leaky",
                              out_inv_s=c["inv"])

    def library(c):
        return K4.epilogue_plain(torch._int_mm(c["x"], c["w_t"].t()),
                                 c["scale"], c["bias"], "leaky", c["inv"],
                                 torch.bfloat16)

    all8 = cases[8]
    ms = _time_ms(torch, lambda: run(all8, kernel))
    plain_ms = _time_ms(torch, lambda: run(all8, plain), iters=5)
    fam = {}
    tot_bytes = tot_ops = 0
    for name in "ABC":
        cs = [c for c in all8 if c["family"] == name]
        nb = nops = 0
        for c in cs:
            m, k, n = c["mkn"]
            nb += m * k + k * n + m * n * (1 if c["rq"] else 2) + n * 8
            nops += 2 * m * k * n
        bound, by = _bound_ms(nb, nops, INT8_OPS_PER_S)
        fam[name] = {
            "shapes": len(cs), "mkn": cs[0]["mkn"],
            "device_ms": _device_ms(torch, lambda: run(cs, kernel),
                                    "qgemm_wg_kernel"),
            "ms": _time_ms(torch, lambda: run(cs, kernel)),
            "library_ms": _time_ms(torch, lambda: run(cs, library), iters=5),
            "bound_ms": bound, "bound_by": by}
        m, k, n = cs[0]["mkn"]
        print(f"K4 family {name}, {len(cs)} shapes M {m} K {k} N {n} "
              f"(requant {[c['rq'] for c in cs]}), tile "
              f"{K4.choose_tile(m, k, n)}: device {fam[name]['device_ms']} "
              f"ms, by events {fam[name]['ms']:.4f} ms, bound {bound:.5f} ms "
              f"({by}; {nb / 1e6:.2f} MB, {nops / 1e9:.2f} GOP), library "
              f"(_int_mm + eager epilogue) {fam[name]['library_ms']:.4f} ms",
              flush=True)
        tot_bytes += nb
        tot_ops += nops
    bound, by = _bound_ms(tot_bytes, tot_ops, INT8_OPS_PER_S)
    parts = [f["device_ms"] for f in fam.values()]
    device_ms = None if None in parts else sum(parts)
    library_ms = sum(f["library_ms"] for f in fam.values())
    bs1 = cases[1]
    bs1_device_ms = _device_ms(torch, lambda: run(bs1, kernel),
                               "qgemm_wg_kernel")
    print(f"K4 10 shapes, bs 8: kernel {ms:.4f} ms by events (device "
          f"{device_ms} ms), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
          f"{tot_bytes / 1e6:.1f} MB, {tot_ops / 1e9:.1f} GOP); bs 1: device "
          f"{bs1_device_ms} ms", flush=True)
    return {"max_abs_err": err, "n_differ": n_differ, "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "families": fam,
            "bs1_device_ms": bs1_device_ms}


def _serve(torch, pred, frames, launches, n, want, n_heads):
    """One request of ``n`` frames; launch counts must equal ``want``, and
    K1's launches must have decoded ``n_heads`` heads each. Returns the
    detections."""
    from double_yolo_kaist_torch.ops import decode as K1
    before = dict(launches)
    t0 = time.perf_counter()
    out = pred(*frames[n])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    got = {k: launches[k] - before.get(k, 0) for k in want}
    dh = launches[K1.HEADS_DECODED] - before.get(K1.HEADS_DECODED, 0)
    print(f"  request of {n}: {dt:.3f} ms, detections per image "
          f"{[len(b) for b, _, _ in out]}, launches {got}, heads decoded "
          f"{dh}", flush=True)
    if got != want or dh != n_heads * want["decode_head"]:
        raise AssertionError(f"request of {n}: want launches {want} and "
                             f"{n_heads} heads a K1 launch, got {got} and "
                             f"{dh} heads")
    if len(out) != n or not all(np.isfinite(b).all() and np.isfinite(s).all()
                                for b, s, _ in out):
        raise AssertionError(f"request of {n}: bad output")
    return out


def _medians(torch, pred, frames, label):
    """Median ms of 12 requests of 1, 3 and 8 frames, and the device busy
    ms and share of one profiled request of 1 and of 8 (``"busy"``)."""
    times = {"busy": {}}
    for n in (1, 3, 8):
        ts = []
        for _ in range(12):
            t0 = time.perf_counter()
            pred(*frames[n])
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[n] = statistics.median(ts)
        print(f"{label}: ms per request of {n} frames, 12 requests: median "
              f"{times[n]:.3f}, min {min(ts):.3f}, max {max(ts):.3f}",
              flush=True)
    for n in (1, 8):
        prof = _profile(torch, lambda: pred(*frames[n]))
        busy = sum(prof.values())
        times["busy"][n] = (busy, busy / times[n])
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:8]
        print(f"{label} profile, request of {n}: device busy {busy:.3f} ms, "
              f"{100 * busy / times[n]:.1f}% of the median request time; "
              f"{len(prof)} kernel names; top: "
              + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top), flush=True)
    return times


def phase_flagship(torch, dev, launches):
    """The flagship end to end: bf16, then int8 (chain PTQ)."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q
    from double_yolo_kaist_torch.serving import Predictor

    ir = compile_cfg(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    variables = seeded_variables(ir, SEED)
    print(f"flagship: {len(ir.nodes)} nodes, seeded weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 1)
    frames = {n: (rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8),
                  rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8))
              for n in (1, 3, 8)}
    n_heads = len(ir.yolo_indices)
    fwd = {"stem_conv_s2": 2, "qgemm": 0, "decode_head": 1,
           "nms_indices": 1}
    q_fwd = dict(fwd, qgemm=10)
    counts = {}

    pred = Predictor(ir, variables, img_size=640, device=dev)
    for n in (1, 8):
        pred.warmup((512, 640), batch=n)
    torch.cuda.synchronize()
    print("flagship bf16:", flush=True)
    launches.clear()                        # the bf16 path's run
    for n in (1, 3, 8):
        _serve(torch, pred, frames, launches, n, fwd, n_heads)
    counts["bf16"] = dict(launches)          # read just after it
    times = {"bf16": _medians(torch, pred, frames, "flagship bf16")}

    # one stem conv as the forward calls it: K3's kernel and nothing else
    # (a packing or cast kernel would show beside it), once per call
    node = ir.nodes[1]
    iters = 20
    with torch.inference_mode():
        xin = torch.rand((8, node.in_ch, 512, 640), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for tries in range(1, 7):           # a blind window is tried again,
            events = _kernel_events(torch, lambda: graph.conv_folded(
                node, xin, pred.folded["params"]["l1"]), iters)
            # and one that shows K3 alone but lost more than one of its
            # events (the profiler dropped 16 of 20 once)
            if events and (len(events) != 1
                           or next(iter(events.values())) >= iters - 1):
                break
        for _ in range(3):                  # and so is one that lost more
            fwd_events = _kernel_events(torch, lambda: pred(*frames[8]), 2)
            k3_events = sum(n for k, n in fwd_events.items()
                            if "stem_wg_kernel" in k)
            if k3_events == 2 * 2:
                break
    print(f"profile of the flagship's stem conv l1 (bs 8), {iters} calls, "
          f"window {tries}: device events {events}; K3 events in 2 "
          f"forwards: {k3_events} of {sum(fwd_events.values())}", flush=True)
    if not events:
        raise AssertionError("the profiler showed no kernel of a stem conv "
                             "in 6 windows")
    if len(events) != 1 or "stem_wg_kernel" not in next(iter(events)) \
            or not iters - 1 <= next(iter(events.values())) <= iters:
        raise AssertionError(f"a stem conv did not launch K3 alone, once a "
                             f"call: {events} in {iters} calls")
    if not 2 * 2 - 1 <= k3_events <= 2 * 2:
        raise AssertionError(f"the profile of 2 flagship forwards shows "
                             f"{k3_events} K3 kernels, want 4 (3 if the "
                             f"window lost one)")
    del xin

    with torch.inference_mode():            # largest head value, bs 8
        fn, _, _ = pred._preprocess((512, 640))
        v = torch.from_numpy(frames[8][0]).to(dev)
        l = torch.from_numpy(frames[8][1]).to(dev)
        xv, xl = fn(v, l)
        io_bf16, raw = graph.apply_folded(ir, pred.folded, xv, xl,
                                          compute_dtype=torch.bfloat16)
        print(f"flagship bf16 bs 8: largest |raw head| "
              f"{max(float(r.float().abs().max()) for r in raw):.3f}, "
              f"finite {all(bool(torch.isfinite(r).all()) for r in raw)}",
              flush=True)

    qpred = Predictor(ir, variables, img_size=640, device=dev, int8=True)
    for n in (1, 8):
        qpred.warmup((512, 640), batch=n)
    torch.cuda.synchronize()
    if qpred.qvars is not None or qpred._cal_batches:
        raise AssertionError("warmup touched the int8 calibration state")
    print("flagship int8 (chain), two calibration requests of 8 then int8 "
          "requests:", flush=True)
    launches.clear()                        # the int8 path's run
    _serve(torch, qpred, frames, launches, 8, fwd, n_heads)
    # the second calibration request runs two calibration forwards (K3
    # only), quantizes, then serves int8
    _serve(torch, qpred, frames, launches, 8,
           dict(q_fwd, stem_conv_s2=3 * 2), n_heads)
    # the first int8 request of a bucket captures its graph: one eager
    # forward before the capture, then the replay
    for n in (1, 8):
        _serve(torch, qpred, frames, launches, n,
               {k: 2 * v for k, v in q_fwd.items()}, n_heads)
    for n in (1, 3, 8):
        _serve(torch, qpred, frames, launches, n, q_fwd, n_heads)
    counts["int8"] = dict(launches)          # read just after it
    times["int8"] = _medians(torch, qpred, frames, "flagship int8")

    with torch.inference_mode():
        io_q, _ = Q.apply_quantized(ir, qpred.qvars, xv, xl,
                                    compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (io_q - io_bf16).abs()
        obj = slice(4, 5)
        print(f"flagship bs 8, int8 vs bf16 decoded heads: mean |diff| "
              f"{float(d.mean()):.4f}, max {float(d.max()):.3f}; objectness "
              f"mean |diff| {float(d[..., obj].mean()):.5f}; int8 finite "
              f"{bool(torch.isfinite(io_q).all())}", flush=True)
        if not torch.isfinite(io_q).all():
            raise AssertionError("int8 forward is not finite")

    phase_flagship_int8_vs_cpu(torch, ir, variables, qpred, dev)
    return counts, times, {"flagship bf16": (pred, frames),
                           "flagship int8": (qpred, frames)}


def phase_flagship_int8_vs_cpu(torch, ir, variables, qpred, dev,
                               mode="chain"):
    """The int8 path of ``mode`` on the card against the port's int8 path on
    the CPU: the same quantized weights, fp32 compute, TF32 off, 2 frames
    of 64x96.

    1. Every quantized conv (K4 for the 1x1s, im2col + ``_int_mm`` for the
       3x3s) on the same input, its input in the CPU fp32 forward, and, for
       a conv fed s8 codes (after a spine add; a folded-in edge conv), on
       those codes too: fp outputs within 1e-5 relative + 1e-5,
       requantized s8 outputs within one step on under 1% of the
       elements.
    2. The whole int8 forward: finite, and its mean raw-head difference at
       most twice the mean int8 error (int8 against fp32 on the card). An
       ulp on an int8 rounding boundary moves a value by one step, and at
       full width these steps compound to the size of the int8 error
       itself (tests/test_torch_quantize.py), so only a gross fault (a
       wrong scale or layout) fails this bound; step 1 holds the math."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q

    stats = Q.calibrate(ir, qpred.folded, [(
        torch.rand((2, 64, 96, 3), device=dev),
        torch.rand((2, 64, 96, 3), device=dev))],
        compute_dtype=torch.bfloat16)
    qv = Q.quantize(ir, qpred._folded_cpu, stats, mode=mode)
    targets, emits = Q.plan_quantization(ir, mode)
    s8_fed = {}                       # conv -> the inverse scale of its codes
    if mode == "edge":
        s8_fed = {i: "in_inv" for i in Q.plan_edges(ir)[2]}
        emits = {i for i in targets if "out_inv" in qv["params"][f"l{i}"]["q"]}
    elif mode in ("spine", "spineall"):
        s8_fed = {si + 1: si for si in Q._plan_with_spine(ir, mode)[2]}
    rng = np.random.default_rng(SEED + 2)
    xv = torch.from_numpy(rng.random((2, 64, 96, 3), dtype=np.float32))
    xl = torch.from_numpy(rng.random((2, 64, 96, 3), dtype=np.float32))
    with _NoTF32(torch), torch.inference_mode():
        qp = {str(w): Q.place_quantized(ir, qv, w, torch.float32)
              for w in ("cpu", dev)}
        inputs = {}

        def record(node, inp, p):
            if node.index in targets:
                inputs[node.index] = inp
            return graph.conv_folded(node, inp, p)

        graph.run_graph(ir, graph.place_folded(
            ir, qpred._folded_cpu, "cpu", torch.float32)["params"], xv, xl,
            dtype=torch.float32, conv=record)
        def conv(where, node, x):
            p = qp[str(where)]["params"][f"l{node.index}"]["q"]
            if mode == "edge":           # codes arrive with their scales
                x = x.to(where)
                y = Q.qconv_edge(node, Q.QVal(x, None)
                                 if x.dtype == torch.int8 else x, p,
                                 torch.float32)
                return (y.q if isinstance(y, Q.QVal) else y).cpu()
            return Q.qconv(node, x.to(where), p, torch.float32).cpu()

        worst = (0.0, 0.0)
        n_s8 = 0
        for i in sorted(targets):
            node, x = ir.nodes[i], inputs[i]
            cases = [x]
            if i in s8_fed:               # the codes its producer emits
                src = s8_fed[i]
                inv = (qp["cpu"]["params"][f"l{i}"]["q"]["in_inv"]
                       if src == "in_inv" else
                       qp["cpu"]["params"][f"l{src}"]["spine"]["inv_sy"])
                cases.append(Q._quantize_input(x, inv))
                n_s8 += 1
            for inp in cases:
                ref, got = conv("cpu", node, inp), conv(dev, node, inp)
                if i in emits:
                    d = (got.int() - ref.int()).abs()
                    share = float((d != 0).float().mean())
                    ok = int(d.max()) <= 1 and share < 0.01
                    worst = (worst[0], max(worst[1], share))
                else:
                    d = (got - ref).abs()
                    ok = bool((d <= 1e-5 * ref.abs() + 1e-5).all())
                    worst = (max(worst[0], float(d.max())), worst[1])
                if not ok:
                    raise AssertionError(f"int8 {mode} conv l{i} "
                                         f"({inp.dtype} in): card disagrees "
                                         f"with the CPU path")
        print(f"int8 {mode} fp32, each of {len(targets)} quantized convs "
              f"({n_s8} also from s8 codes), card vs CPU on the same "
              f"input: max abs err {worst[0]:.3e} (fp outputs), largest "
              f"share of s8 codes one step off {worst[1]:.2e}", flush=True)

        raws = {}
        for where in ("cpu", dev):
            _, raw = Q.apply_quantized(ir, qp[str(where)], xv.to(where),
                                       xl.to(where),
                                       compute_dtype=torch.float32,
                                       mode=mode)
            raws[str(where)] = [r.float().cpu() for r in raw]
        fold = graph.place_folded(ir, qpred._folded_cpu, dev, torch.float32)
        _, fp = graph.apply_folded(ir, fold, xv.to(dev), xl.to(dev))
        fp = [r.float().cpu() for r in fp]
    for i, (mine, ref, f) in enumerate(zip(raws[str(dev)], raws["cpu"], fp)):
        d = (mine - ref).abs()
        q_err = float((mine - f).abs().mean())
        print(f"int8 {mode} fp32 forward, card vs CPU, head {i}: median "
              f"|diff| "
              f"{float(d.median()):.2e}, mean {float(d.mean()):.2e}, max "
              f"{float(d.max()):.3e}; mean int8 error {q_err:.3e}",
              flush=True)
        if not (torch.isfinite(mine).all() and float(d.mean()) <= 2 * q_err):
            raise AssertionError("int8 card run disagrees with the CPU path")


# ------------------------------------------------------------------ phase 9

EVAL_FRAMES = 80
EVAL_BS = 32
EVAL_CAL_BATCHES = 2
EVAL_HW = (512, 640)          # KAIST frames; rect eval at --img-size 512
EVAL_IMG = 512                # gives batches of 416x512


def _eval_split(root, cv2):
    """An 80-pair KAIST-layout split of 640x512 uint8 frames from SEED under
    ``root``: JPEG pairs (or, without cv2, the dataset's disk cache filled
    with the arrays), the split files (all 80 frames and the first 8) with
    their ``.shapes`` sidecars. Returns ({name: split path}, frames,
    cache_images)."""
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    rng = np.random.default_rng(SEED + 9)
    frames = [tuple(rng.integers(0, 256, EVAL_HW + (3,), dtype=np.uint8)
                    for _ in range(2)) for _ in range(EVAL_FRAMES)]
    img_dir = os.path.join(root, "images", "eval")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(root, "labels", "eval"))
    logical = [os.path.join(img_dir, f"I{i:05d}.jpg")
               for i in range(EVAL_FRAMES)]
    splits = {}
    for name, n in (("eval80", EVAL_FRAMES), ("eval8", 8)):
        splits[name] = os.path.join(root, f"{name}.txt")
        with open(splits[name], "w") as f:
            f.write("\n".join(logical[:n]) + "\n")
        with open(os.path.join(root, f"{name}.shapes"), "w") as f:
            f.write(f"{EVAL_HW[1]} {EVAL_HW[0]}\n" * n)
    if cv2 is not None:
        for path, (v, l) in zip(logical, frames):
            cv2.imwrite(path.replace(".jpg", "_visible.jpg"), v[..., ::-1])
            cv2.imwrite(path.replace(".jpg", "_lwir.jpg"), l[..., ::-1])
        return splits, None

    class Seeded(KaistDataset):
        def _decode_pair(self, index):
            return frames[int(os.path.basename(self.img_files[index])[1:6])]

    for name in splits:              # one disk cache a split file
        ds = Seeded(splits[name], EVAL_IMG, EVAL_BS, rect=True,
                    cache_images="disk")
        for i in range(len(ds)):
            ds.load_pair(i)
    return splits, "disk"


def _write_labels(ds, predictions, k=5):
    """The ``k`` most confident detections of each image as its label file
    (normalized ``cls cx cy w h``; boxes under 2 px dropped)."""
    n = 0
    for i, path in enumerate(ds.label_files):
        boxes, scores = predictions.get(i, (np.zeros((0, 4)), np.zeros(0)))
        w, h = ds.shapes[i]
        rows = []
        for b in np.asarray(boxes)[np.argsort(-scores, kind="stable")[:k]]:
            bw, bh = b[2] - b[0], b[3] - b[1]
            if bw >= 2 and bh >= 2:
                rows.append(f"0 {(b[0] + bw / 2) / w:.6f} "
                            f"{(b[1] + bh / 2) / h:.6f} {bw / w:.6f} "
                            f"{bh / h:.6f}\n")
        with open(path, "w") as f:
            f.write("".join(rows))
        n += len(rows)
    return n


class _PoolRecorder:
    """Keeps a copy of the first pool each eval run hands K2 (boxes with
    the class offset, scores), passing every call through to the kernel's
    wrapper unchanged."""

    def __init__(self):
        from double_yolo_kaist_torch.ops import nms as NMS
        self.module, self.inner, self.pool = NMS, NMS.nms_indices, None

    def __enter__(self):
        def record(boxes, scores, iou_thres, max_det):
            if self.pool is None:
                self.pool = (boxes.clone(), scores.clone(), iou_thres,
                             max_det)
            return self.inner(boxes, scores, iou_thres, max_det)
        self.module.nms_indices = record
        return self

    def __exit__(self, *exc):
        self.module.nms_indices = self.inner


def _eval_run(torch, launches, label, ir, variables, ds, want, **kw):
    """One evaluate_dataset run with the launch counts cleared just before
    and read just after; they must equal ``want`` (per run). Returns (result,
    counts, K2's first pool)."""
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    from double_yolo_kaist_torch.ops import decode as K1
    with _PoolRecorder() as rec:
        launches.clear()
        res = evaluate_dataset(ir, variables, ds, batch_size=EVAL_BS, **kw)
        torch.cuda.synchronize()
        counts = dict(launches)
    got = {k: counts.get(k, 0) for k in want}
    heads = counts.get(K1.HEADS_DECODED, 0)
    s = res["seconds"]
    print(f"eval {label}: AP {res['ap']:.6f}, LAMR {res['lamr']:.6f}, fps "
          f"{res['fps']:.2f} ({res['batches']} batches; host s: infer "
          f"{s['infer']:.4f}, loop {s['loop']:.4f}, metrics "
          f"{s['metrics']:.4f}); launches {got}, heads decoded {heads}",
          flush=True)
    if got != want or heads != 3 * want["decode_head"]:
        raise AssertionError(f"eval {label}: want launches {want} (3 heads a "
                             f"K1 launch), got {got} and {heads} heads")
    if not (np.isfinite(res["coco_stats"]).all() and 0 <= res["ap"] <= 1):
        raise AssertionError(f"eval {label}: bad metrics")
    return res, counts, rec.pool


def _same_predictions(a, b, what):
    pa, pb = a["predictions"], b["predictions"]
    same = sorted(pa) == sorted(pb) and all(
        np.array_equal(pa[k][0], pb[k][0]) and np.array_equal(pa[k][1],
                                                             pb[k][1])
        for k in pa)
    print(f"eval {what}: predictions identical {same} "
          f"({sum(len(s) for _, s in pa.values())} detections)", flush=True)
    if not same or a["ap"] != b["ap"]:
        raise AssertionError(f"eval {what}: predictions differ")


def _busy(torch, res, fn, label):
    """Device busy ms of the batch loop of one profiled eval run ``fn``: the
    kernels and copies that start inside the evaluator's loop span (weights
    placed before it, and calibration, are left out), over the host time of
    the unprofiled run ``res``'s loop. Returns (busy ms, share %)."""
    from torch.profiler import ProfilerActivity, profile

    from double_yolo_kaist_torch.eval.evaluator import LOOP_SPAN
    for tries in range(1, 4):               # a blind window is tried again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()

        def on_card(e):
            return str(getattr(e, "device_type", "")).endswith("CUDA")

        # the span is on the host's timeline; the trace repeats it on the
        # card's as an annotation, which is no device work
        spans = [e for e in events if e.name == LOOP_SPAN and not on_card(e)]
        if len(spans) != 1:
            raise AssertionError(f"{len(spans)} eval loop spans in a trace")
        lo, hi = spans[0].time_range.start, spans[0].time_range.end
        inside = {}
        for e in events:
            if (on_card(e) and e.name != LOOP_SPAN
                    and lo <= e.time_range.start <= hi):
                inside[e.name] = inside.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        if inside:
            break
    if not inside:
        raise AssertionError(f"eval {label}: the profiler showed no device "
                             f"event in the batch loop in 3 windows")
    busy = sum(inside.values())
    loop_ms = res["seconds"]["loop"] * 1e3
    top = sorted(inside.items(), key=lambda kv: -kv[1])[:6]
    print(f"eval {label} profile: device busy {busy:.3f} ms in the batch "
          f"loop (its span {(hi - lo) / 1e3:.3f} ms profiled), over the "
          f"unprofiled loop's {loop_ms:.3f} ms: {100 * busy / loop_ms:.1f}% "
          f"busy; top: " + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top),
          flush=True)
    return busy, 100 * busy / loop_ms


def _stage_ms(torch, ds, dev, res):
    """Host ms per batch of each eval stage: load (decode a batch of pairs),
    preprocess (gather + letterbox of a batch from the device pool,
    synchronised), forward + NMS + fetch, and the metrics (whole split)."""
    from double_yolo_kaist_torch.data import pipeline as P
    n_b = -(-len(ds) // EVAL_BS)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds.load_pair(i)
    load = (time.perf_counter() - t0) * 1e3 / n_b
    tier, pool = P.select_image_pool(ds, EVAL_HW, None, dev)
    if tier != "hbm":
        raise AssertionError(f"the 80-frame split took the {tier} tier")
    fn, _, _ = P.make_eval_preprocess_fn(
        EVAL_HW, tuple(int(x) for x in ds.batch_shapes[0]), EVAL_IMG,
        from_pool=True)
    idx = torch.arange(EVAL_BS, device=dev)
    fn(pool[0], pool[1], idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn(pool[0], pool[1], idx)
    torch.cuda.synchronize()
    pre = (time.perf_counter() - t0) * 1e3 / 5
    return {"load": load, "preprocess": pre,
            "forward_nms_fetch": res["seconds"]["infer"] * 1e3
            / res["batches"], "metrics": res["seconds"]["metrics"] * 1e3}


def _k2_hold_pool(torch, pool, what):
    """K2 on a pool an eval run handed it: index-exact against the plain
    loop, then K2_REPEATS launches on it that must repeat the first.
    Returns (device ms, kept per image)."""
    from double_yolo_kaist_torch.ops.nms_kernel import (nms_indices,
                                                        nms_indices_plain)
    boxes, scores, iou, max_det = pool
    idx, valid = nms_indices(boxes, scores, iou, max_det)
    ridx, rvalid = nms_indices_plain(boxes, scores, iou, max_det)
    torch.cuda.synchronize()
    want = (rvalid, torch.where(rvalid, ridx, 0))
    outs = [nms_indices(boxes, scores, iou, max_det)
            for _ in range(K2_REPEATS)]
    torch.cuda.synchronize()
    bad = [n for n, (i, v) in enumerate([(idx, valid)] + outs)
           if not (torch.equal(v, want[0])
                   and torch.equal(torch.where(v, i, 0), want[1]))]
    kept = valid.sum(1).tolist()
    live = (scores > -1e9).sum(1).tolist()
    print(f"K2 {what}: K {boxes.shape[1]}, bs {boxes.shape[0]}, IoU {iou}: "
          f"index-exact and {K2_REPEATS} repeats agree {not bad}; kept per "
          f"image {kept}; candidates above conf per image {live}; "
          f"{sum(k < max_det for k in kept)} of {len(kept)} pools run out "
          f"before max_det {max_det}", flush=True)
    if bad:
        raise AssertionError(f"K2 {what}: launches {bad[:10]} disagree with "
                             f"the plain loop")
    ms = _device_ms(torch, lambda: nms_indices(boxes, scores, iou, max_det),
                    "nms_kernel")
    # the kernel's events in one window of 20 calls: the ms above assumes
    # one event a call (a profiler may lose one, or repeat them)
    events = _kernel_events(torch, lambda: nms_indices(boxes, scores, iou,
                                                       max_det), 20)
    bs, k = scores.shape
    # as phase 4 counts it, with the rounds this pool's data needs
    bound, by = _bound_ms(bs * k * 20 + bs * max_det * 8,
                          sum(kept) * k * 14 + (sum(kept) + bs) * k,
                          FP32_OPS_PER_S)
    print(f"K2 {what}: device {ms} ms a call, bound {bound:.6f} ms ({by}); "
          f"profiler events in a window of 20 calls {events}", flush=True)
    return ms, kept, bound


def _eval_shape_kernels(torch, dev, mnv3_ir, placed, ds, flagship_ir, pools,
                        results):
    """K1, K2, K3 and K4 at the eval's shapes, each against its plain version
    and timed on the device, beside the 512x640 figures of phases 3-7."""
    from double_yolo_kaist_torch.data.pipeline import eval_batches
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.ops import decode as K1
    from double_yolo_kaist_torch.ops import qgemm as K4
    from double_yolo_kaist_torch.ops.stem import (pack_weights, stem_conv_s2,
                                                  stem_conv_s2_plain)
    out = {}
    # K1 on the heads of a bs-32 MNv3 forward of the first eval batch
    with torch.inference_mode():
        xv, xl, _, _ = next(iter(eval_batches(ds, EVAL_BS, device=dev)))
        heads = graph.run_graph(mnv3_ir, placed["params"], xv, xl,
                                dtype=torch.bfloat16)
        spec = [(h, n.anchors, n.yolo_stride) for h, n in heads]
        bf = heads[0][1].bf_type
        got = K1.decode_heads(spec, bf)
        want = torch.cat([K1.decode_head_plain(
            K1.reshape_head(h, len(n.anchors), n.nc + 5), n.anchors,
            n.yolo_stride, bf) for h, n in heads], 1)
    grids = [tuple(h.shape[2:]) for h, _ in heads]
    fast = [K1.fast_path(h.shape, h.stride(), h.dtype, len(n.anchors))
            for h, n in heads]
    err = _k1_hold(torch, got, want, f"eval bs {EVAL_BS}, grids {grids}")
    with torch.inference_mode():
        ms = _device_ms(torch, lambda: K1.decode_heads(spec, bf),
                        "decode_heads_kernel")
    elems = got.numel()
    bound, _ = _bound_ms(elems * (2 + 4), elems * 8, FP32_OPS_PER_S)
    print(f"K1 eval bs {EVAL_BS} {grids}, 16-byte path {fast}: device {ms} "
          f"ms, bound {bound:.5f} ms (512x640 bs 8: "
          f"{results['K1']['device_ms']} ms)", flush=True)
    if not all(fast):
        raise AssertionError("an eval head is off K1's 16-byte path")
    out["K1"] = {"eval_device_ms": ms, "eval_max_abs_err": err,
                 "eval_bound_ms": bound}

    # K2 on the pools the eval runs produced (first batch of each model)
    k2, k2_bound = {}, {}
    for name, pool in pools.items():
        k2[name], _, k2_bound[name] = _k2_hold_pool(torch, pool,
                                                    f"eval pool, {name}")
    print(f"K2 eval pools device ms {k2} (512x640 bs 8 K 512: "
          f"{results['K2']['device_ms']} ms)", flush=True)
    out["K2"] = {"eval_device_ms": k2, "eval_bound_ms": k2_bound}

    # K3 at the flagship's stem shape in eval, (32, 416, 512, 32) bf16
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    h, w = (int(x) for x in ds.batch_shapes[0])
    x = torch.rand((EVAL_BS, 32, h, w), generator=g, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((64, 32, 3, 3), generator=g, device=dev) * 0.06).to(
        torch.bfloat16)
    b = torch.randn((64,), generator=g, device=dev) * 0.1
    weights = pack_weights(wt, b)
    got = stem_conv_s2(x, weights, "mish")
    want = stem_conv_s2_plain(x, wt, b, "mish")
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    bad = int((d > 2 ** -7 * want.float().abs() + 1e-5).sum())
    ms = _device_ms(torch, lambda: stem_conv_s2(x, weights, "mish"),
                    "stem_wg_kernel")
    # as phase 6 counts it
    bound, _ = _bound_ms((x.numel() + got.numel() + wt.numel()) * 2 + 64 * 4,
                         2 * got.numel() * 9 * 32, BF16_OPS_PER_S)
    print(f"K3 eval ({EVAL_BS}, {h}, {w}, 32) bf16 mish: max_abs_err "
          f"{float(d.max()):.3e}, {bad} elements over 2^-7 rel + 1e-5; "
          f"device {ms} ms, bound {bound:.4f} ms (512x640 bs 8: "
          f"{results['K3']['device_ms']} ms)", flush=True)
    if bad or not torch.isfinite(got).all():
        raise AssertionError("K3 disagrees with its plain version at the "
                             "eval shape")
    out["K3"] = {"eval_device_ms": ms, "eval_max_abs_err": float(d.max()),
                 "eval_bound_ms": bound}
    del x, got, want, d

    # K4 at the ten chain shapes at bs 32 and at the partial batch's
    rng = np.random.default_rng(SEED + 9)
    partial = len(ds) % EVAL_BS or EVAL_BS
    k4, k4_bound = {}, {}
    for bs in (EVAL_BS, partial):
        cases = []
        for i, m, k, n, rq in _k4_shapes(flagship_ir, bs, (h, w)):
            c = _k4_case(torch, rng, dev, m, k, n, rq)
            c["packed"] = K4.pack_weights(c["w"])
            _k4_hold(torch, c, f"eval l{i} bs {bs} (M {m})", torch.bfloat16)
            cases.append(c)
        if len(cases) != 10:
            raise AssertionError(f"expected 10 chain 1x1 convs, got "
                                 f"{len(cases)}")

        def run(cs=cases):
            for c in cs:
                K4.qgemm(c["x"], c["packed"], c["scale"], c["bias"], "leaky",
                         out_inv_s=c["inv"])

        k4[bs] = _device_ms(torch, run, "qgemm_wg_kernel")
        # as phase 7 counts it
        k4_bound[bs], _ = _bound_ms(
            sum(m * k + k * n + m * n * (1 if c["inv"] is not None else 2)
                + n * 8 for c in cases for m, k, n in [c["mkn"]]),
            sum(2 * m * k * n for c in cases for m, k, n in [c["mkn"]]),
            INT8_OPS_PER_S)
        print(f"K4 eval 10 shapes bs {bs} (M {[c['mkn'][0] for c in cases]})"
              f": bit-equal to the plain version; device {k4[bs]} ms, bound "
              f"{k4_bound[bs]:.5f} ms (512x640 bs 8: "
              f"{results['K4']['device_ms']} ms)", flush=True)
        del cases
    out["K4"] = {"eval_device_ms": k4[EVAL_BS],
                 "eval_partial_device_ms": k4[partial],
                 "eval_bound_ms": k4_bound[EVAL_BS],
                 "eval_partial_bound_ms": k4_bound[partial]}
    return out


def phase_eval(torch, dev, launches, mnv3_ir, flagship_ir, results, root):
    """The offline evaluation path: evaluate_dataset on an 80-frame KAIST
    split written under ``root`` (MNv3 bf16, the flagship bf16 and int8),
    card against CPU, the tiers, the calibration artifact, launch counts
    per run, K1-K4 at the eval's shapes, and the entry point as a
    subprocess. Returns (counts, kernel numbers, the MNv3 checkpoint
    directory it wrote)."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.data import pipeline as P
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    from double_yolo_kaist_torch.models import graph, weights
    from double_yolo_kaist_torch.utils import native
    from double_yolo_kaist_torch.utils.checkpoint import save_checkpoint
    try:
        import cv2
    except ImportError:
        cv2 = None
    print(f"eval: host matcher {native.matcher()}, frames written with "
          f"{'cv2 JPEGs' if cv2 is not None else 'the disk cache'}",
          flush=True)
    counts, numbers = {}, {}
    splits, cache = _eval_split(root, cv2)

    def dataset(name):
        return KaistDataset(splits[name], EVAL_IMG, EVAL_BS, rect=True,
                            cache_images=cache)

    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    unlabelled = dataset("eval80")
    print(f"eval split: {len(unlabelled)} pairs {EVAL_HW}, batch shapes "
          f"{sorted({tuple(s) for s in unlabelled.batch_shapes.tolist()})}",
          flush=True)
    with _NoTF32(torch):
        res = evaluate_dataset(mnv3_ir, mnv3_vars, unlabelled,
                               batch_size=EVAL_BS, device_cache=False,
                               compute_dtype=torch.float32, device=dev)
    n_labels = _write_labels(unlabelled, res["predictions"])
    print(f"eval labels: {n_labels} boxes, the 5 most confident MNv3 "
          f"fp32 detections of each frame", flush=True)
    ds = dataset("eval80")            # reads the labels just written

    # 1. card against the port's CPU path, fp32, the first 8 frames
    fp = {}
    with _NoTF32(torch):
        for where in (dev, "cpu"):
            fp[str(where)] = evaluate_dataset(
                mnv3_ir, mnv3_vars, dataset("eval8"), batch_size=8,
                compute_dtype=torch.float32, device=where)
    card, cpu = fp[str(dev)], fp["cpu"]
    d = max(abs(card["ap"] - cpu["ap"]), abs(card["lamr"] - cpu["lamr"]),
            float(np.abs(card["coco_stats"] - cpu["coco_stats"]).max()))
    print(f"eval fp32 8 frames, card vs CPU: AP {card['ap']:.6f} / "
          f"{cpu['ap']:.6f}, LAMR {card['lamr']:.6f} / {cpu['lamr']:.6f}, "
          f"largest difference over AP, LAMR and the 12 COCO stats "
          f"{d:.2e} (bound 1e-3)", flush=True)
    if d > 1e-3:
        raise AssertionError("eval fp32: card disagrees with the CPU")

    # 2. MNv3 bf16: device pool, then streaming
    pools = {}
    nb = -(-len(ds) // EVAL_BS)                 # batches a run
    want = {"decode_head": nb, "nms_indices": nb, "stem_conv_s2": 0,
            "qgemm": 0}
    kw = dict(compute_dtype=torch.bfloat16, device=dev)
    evaluate_dataset(mnv3_ir, mnv3_vars, ds, batch_size=EVAL_BS, **kw)
    mnv3, counts["eval mnv3 bf16"], pools["MNv3"] = _eval_run(
        torch, launches, "MNv3 bf16 (device pool)", mnv3_ir, mnv3_vars,
        ds, want, **kw)
    streamed, counts["eval mnv3 bf16 streaming"], _ = _eval_run(
        torch, launches, "MNv3 bf16 (streaming)", mnv3_ir, mnv3_vars,
        dataset("eval80"), want, device_cache=False, **kw)
    _same_predictions(mnv3, streamed, "MNv3 bf16, device pool vs "
                      "streaming")
    budget = os.environ.get("DYK_DEVICE_CACHE_GB")
    os.environ["DYK_DEVICE_CACHE_GB"] = "0"   # declines the device pool
    try:
        pinned_ds = dataset("eval80")
        # pinned before the run, as the device pool of ``ds`` was
        P.select_image_pool(pinned_ds, EVAL_HW, None, dev)
        pinned, counts["eval mnv3 bf16 pinned"], _ = _eval_run(
            torch, launches, "MNv3 bf16 (pinned host pool)", mnv3_ir,
            mnv3_vars, pinned_ds, want, **kw)
    finally:
        if budget is None:
            del os.environ["DYK_DEVICE_CACHE_GB"]
        else:
            os.environ["DYK_DEVICE_CACHE_GB"] = budget
    if getattr(pinned_ds, "_host_pool", None) is None:
        raise AssertionError("the pinned host tier was not taken")
    _same_predictions(mnv3, pinned, "MNv3 bf16, device pool vs pinned "
                      "host pool")
    del pinned_ds
    busy = _busy(torch, mnv3, lambda: evaluate_dataset(
        mnv3_ir, mnv3_vars, ds, batch_size=EVAL_BS, **kw), "MNv3 bf16")
    stages = _stage_ms(torch, dataset("eval80"), dev, mnv3)
    print(f"eval MNv3 bf16, host ms per batch of {EVAL_BS}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + " (metrics: whole split)", flush=True)
    numbers["MNv3 bf16"] = {"ap": mnv3["ap"], "lamr": mnv3["lamr"],
                            "fps": mnv3["fps"],
                            "streaming_fps": streamed["fps"],
                            "pinned_fps": pinned["fps"],
                            "busy_ms": busy[0], "busy_pct": busy[1],
                            "stage_ms": stages}

    # 3. the flagship at full width and depth, seeded weights
    fl_vars = seeded_variables(flagship_ir, SEED)
    want = dict(want, stem_conv_s2=2 * nb)
    evaluate_dataset(flagship_ir, fl_vars, ds, batch_size=EVAL_BS, **kw)
    fl, counts["eval flagship bf16"], pools["flagship bf16"] = _eval_run(
        torch, launches, "flagship bf16", flagship_ir, fl_vars, ds, want,
        **kw)
    busy = _busy(torch, fl, lambda: evaluate_dataset(
        flagship_ir, fl_vars, ds, batch_size=EVAL_BS, **kw),
        "flagship bf16")
    numbers["flagship bf16"] = {"ap": fl["ap"], "fps": fl["fps"],
                                "busy_ms": busy[0], "busy_pct": busy[1]}
    cal = os.path.join(root, "calibration.npz")
    qkw = dict(kw, int8=True, calibration=cal,
               calibration_batches=EVAL_CAL_BATCHES)
    want = dict(want, stem_conv_s2=2 * (nb + EVAL_CAL_BATCHES),
                qgemm=10 * nb)
    q1, counts["eval flagship int8 calibrating"], pools[
        "flagship int8"] = _eval_run(
        torch, launches, "flagship int8 (calibrating, saves the "
        "artifact)", flagship_ir, fl_vars, ds, want, **qkw)
    if not os.path.exists(cal):
        raise AssertionError("the calibration artifact was not saved")
    want = dict(want, stem_conv_s2=2 * nb)
    q2, counts["eval flagship int8 from artifact"], _ = _eval_run(
        torch, launches, "flagship int8 (from the artifact)",
        flagship_ir, fl_vars, ds, want, **qkw)
    _same_predictions(q1, q2, "flagship int8, calibrating vs from the "
                      "artifact")
    busy = _busy(torch, q2, lambda: evaluate_dataset(
        flagship_ir, fl_vars, ds, batch_size=EVAL_BS, **qkw),
        "flagship int8")
    numbers["flagship int8"] = {"ap": q2["ap"], "fps": q2["fps"],
                                "busy_ms": busy[0], "busy_pct": busy[1]}
    del fl_vars

    # 5. K1-K4 at the eval's shapes
    placed = graph.place_folded(
        mnv3_ir, graph.fold_batchnorm(mnv3_ir, mnv3_vars), dev,
        torch.bfloat16)
    kernels = _eval_shape_kernels(torch, dev, mnv3_ir, placed, ds,
                                  flagship_ir, pools, results)
    del placed

    # 6. the entry point as a subprocess
    ck = os.path.join(root, "mnv3_ckpt")
    jx = weights.to_jax_variables(mnv3_vars)
    save_checkpoint(ck, params=jx["params"], bn_state=jx["state"])
    data = os.path.join(root, "eval.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntest={splits['eval80']}\n")
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.evaluate",
           "--cfg", MNV3_NAME, "--weights", ck, "--data", data,
           "--img-size", str(EVAL_IMG), "--batch-size", str(EVAL_BS),
           "--cache-images", "disk"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.splitlines()
    print(f"entry point: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; stdout:\n  "
          + "\n  ".join(lines), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"the entry point failed:\n"
                             f"{r.stderr[-3000:]}")
    ap_line = [x for x in lines if x.startswith("VOC Average Precision")]
    if (sum(x.startswith(("AP@", "AR@")) for x in lines) != 12
            or len(ap_line) != 1
            or not any(x.startswith("Log Average Miss Rate")
                       for x in lines)
            or not any(x.startswith("average detecting fps")
                       for x in lines)):
        raise AssertionError("the entry point did not print the CLI's "
                             "lines")
    ap = float(ap_line[0].split("=")[-1].strip().rstrip("%")) / 100
    print(f"entry point VOC-AP {ap:.4f}, in-process bf16 "
          f"{mnv3['ap']:.6f} (bound 1e-3)", flush=True)
    if abs(ap - mnv3["ap"]) > 1e-3:
        raise AssertionError("the entry point's AP differs from the "
                             "in-process run's")
    print("eval numbers: " + json.dumps(numbers), flush=True)
    return counts, kernels, ck


# ---------------------------------------------------------------- phase 10

# the substring of each kernel's name in a profile
KERNEL_NAMES = {"K1": "decode_heads_kernel", "K2": "nms_kernel",
                "K3": "stem_wg_kernel", "K4": "qgemm_wg_kernel"}


def _eager_request(torch, pred, v, l):
    """A request on the eager path: the frames zero-padded into their bucket
    on the device, ``run_batch``, one fetch of the packed output,
    ``unpack_detections``."""
    from double_yolo_kaist_torch.serving import pack, unpack_detections
    n, src_hw = len(v), tuple(v.shape[1:3])
    _, ratio, pad = pred._preprocess(src_hw)
    pv = torch.zeros((pred._bucket(n),) + v.shape[1:], dtype=torch.uint8,
                     device=pred.device)
    pl = torch.zeros_like(pv)
    pv[:n] = torch.from_numpy(v).to(pred.device)
    pl[:n] = torch.from_numpy(l).to(pred.device)
    packed = pack(*pred.run_batch(pv, pl)).cpu().numpy()
    return unpack_detections(packed[..., :6], packed[..., 6] > 0.5, n,
                             ratio[0], pad, src_hw)


def _same_detections(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


def _request_ms(torch, fn, reps=12):
    """(median, min, max) host ms of ``reps`` synchronised calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def _busy_ms(torch, fn):
    """Device ms of one call of ``fn`` by torch.profiler (a blind window is
    tried again); None if three windows show nothing."""
    for _ in range(3):
        busy = sum(_profile(torch, fn).values())
        if busy > 0:
            return busy
    return None


def phase_graphs(torch, launches, served):
    """Serving from CUDA graphs. ``served``: [(label, Predictor, frames, the
    launches one forward holds)]. Returns (counts per run, {label: {bs:
    graph and eager ms and busy}})."""
    counts, table = {}, {}
    for label, pred, frames, held in served:
        quant = pred._int8
        hw = tuple(frames[1][0].shape[1:3])
        launches.clear()                     # this run: graph + eager
        for n in (1, 3, 8):
            g = pred._graphs.get((pred._bucket(n), hw, quant))
            replays = g.replays if g is not None else 0
            got = pred(*frames[n])
            g = pred._graphs.get((pred._bucket(n), hw, quant))
            if g is None or g.replays != replays + 1:
                raise AssertionError(f"{label}: a request of {n} was not one "
                                     f"replay of its bucket's graph")
            if {k: g.launches.get(k, 0) for k in held} != held:
                raise AssertionError(f"{label}: the graph of bucket "
                                     f"{pred._bucket(n)} holds {g.launches}, "
                                     f"want {held}")
            want = _eager_request(torch, pred, *frames[n])
            same = _same_detections(got, want)
            print(f"{label}, graph vs eager, request of {n} (bucket "
                  f"{pred._bucket(n)}, replay {g.replays}): detections "
                  f"{[len(b) for b, _, _ in got]} identical {same}",
                  flush=True)
            if not same:
                raise AssertionError(f"{label}: the graph's detections "
                                     f"differ from the eager path's")
        counts[f"graph {label}"] = dict(launches)     # read just after it
        bad = {k: counts[f"graph {label}"].get(k, 0) for k in held
               if counts[f"graph {label}"].get(k, 0) != 6 * held[k]}
        if bad:
            raise AssertionError(f"{label}: 3 replays and 3 eager forwards "
                                 f"launched {bad}, want 6 x {held}")

        # one replay in a profiler window: the kernels by name
        g = pred._graphs[(pred._bucket(8), hw, quant)]
        want = {"K1": 1, "K2": 1, "K3": held.get("stem_conv_s2", 0),
                "K4": held.get("qgemm", 0)}
        for tries in range(1, 7):               # a window may lose an event
            events = _kernel_events(torch, g.graph.replay, 1)
            got = {k: sum(c for name, c in events.items() if sub in name)
                   for k, sub in KERNEL_NAMES.items()}
            if got == want:
                break
        print(f"{label}, profile of one replay (bs 8), window {tries}: "
              f"{got} of {sum(events.values())} device events, "
              f"{len(events)} kernel names", flush=True)
        if got != want:
            raise AssertionError(f"{label}: one replay showed {got}, want "
                                 f"{want}")

        stage = pred._stages[(pred._bucket(8), hw)]
        t0 = time.perf_counter()
        with torch.inference_mode():
            stage.load(*frames[8])
        torch.cuda.synchronize()
        print(f"{label}: staging 8 frames (host copy into pinned memory, "
              f"then H2D): {(time.perf_counter() - t0) * 1e3:.3f} ms",
              flush=True)
        table[label] = {}
        for n in (1, 8):
            row = {}
            for path, fn in (("graph", lambda: pred(*frames[n])),
                             ("eager", lambda: _eager_request(
                                 torch, pred, *frames[n]))):
                med, lo, hi = _request_ms(torch, fn)
                busy = _busy_ms(torch, fn)
                row[path] = {"median_ms": med, "min_ms": lo, "max_ms": hi,
                             "busy_ms": busy,
                             "busy_pct": None if busy is None
                             else 100 * busy / med}
                print(f"{label}, {path}, request of {n}: median {med:.3f} "
                      f"ms ({lo:.3f}-{hi:.3f}), device busy {busy} ms, "
                      f"{row[path]['busy_pct']}% of the median", flush=True)
            table[label][n] = row
    print("graph numbers: " + json.dumps(table), flush=True)
    return counts, table


# ---------------------------------------------------------------- phase 11

def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(url, body=None, timeout=300):
    import urllib.request
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _alone(pred, v, l, buckets):
    """One frame served alone in each bucket: {bucket: detections}."""
    out = {}
    for b in buckets:
        fv = np.zeros((b,) + v.shape, np.uint8)
        fl = np.zeros_like(fv)
        fv[0], fl[0] = v, l
        out[b] = pred(fv, fl)[0]
    return out


def _matching_bucket(got, alone):
    """The buckets whose lone-frame detections equal ``got`` (boxes,
    scores, classes as lists or arrays)."""
    def equal(x, y):
        y = np.asarray(y)
        x = np.asarray(x, dtype=y.dtype)
        return x.size == y.size and np.array_equal(x.reshape(y.shape), y)

    return [b for b, want in alone.items()
            if all(equal(x, y) for x, y in zip(got, want))]


def _serve_subprocess(torch, dev, mnv3_ir, mnv3_vars, ckpt):
    """``serve`` on MNv3 by its zoo name: 32 concurrent raw requests."""
    import base64

    from double_yolo_kaist_torch.serving import Predictor
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.serve", "--cfg",
           MNV3_NAME, "--weights", ckpt, "--img-size", "640",
           "--warmup-hw", "512", "640", "--port", str(port)]
    rng = np.random.default_rng(SEED + 11)
    frames = [tuple(rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
                    for _ in range(2)) for _ in range(32)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ,
                                                    PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while True:
            try:
                if _http(f"{url}/healthz", timeout=2)["status"] == "ok":
                    break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"serve exited {proc.returncode}:\n"
                                         f"{proc.stdout.read()[-3000:]}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("serve did not come up in 300 s")
                time.sleep(0.5)
        up = time.perf_counter() - t0

        def post(pair):
            v, l = pair
            return _http(f"{url}/detect", json.dumps({
                "visible": base64.b64encode(v.tobytes()).decode(),
                "lwir": base64.b64encode(l.tobytes()).decode(),
                "encoding": "raw", "shape": [512, 640]}).encode())

        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=32) as ex:
            answers = list(ex.map(post, frames))
        burst = time.perf_counter() - t1
        stats = _http(f"{url}/healthz")["microbatch"]
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    print(f"serve: up in {up:.1f} s ({out.strip().splitlines()}); 32 "
          f"concurrent raw requests in {burst:.3f} s; micro-batch stats "
          f"{stats}", flush=True)
    buckets = (1, 4, 16)
    pred = Predictor(mnv3_ir, mnv3_vars, img_size=640, batch_buckets=buckets,
                     device=dev)
    matched = []
    for (v, l), a in zip(frames, answers):
        got = (a["boxes"], a["scores"], a["classes"])
        alone = _alone(pred, v, l, buckets)
        matched.append(_matching_bucket(got, alone))
    print(f"serve: answers equal to the frame served alone in process, "
          f"buckets matched per request {matched}; detections "
          f"{[len(a['boxes']) for a in answers]}", flush=True)
    if not all(matched):
        raise AssertionError("serve answered other detections than the "
                             "in-process Predictor")
    if stats["frames"] != 32 or not stats["mean_batch"] > 1:
        raise AssertionError(f"serve did not coalesce: {stats}")
    return stats


def _detect_subprocess(dev, mnv3_ir, mnv3_vars, ckpt, root):
    """``detect --no-figure`` on 8 pairs of phase 9's split."""
    import cv2

    from double_yolo_kaist_torch.detect import get_pair_paths
    from double_yolo_kaist_torch.serving import Predictor
    src = os.path.join(root, "images", "eval")
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.detect", "--cfg",
           MNV3_NAME, "--weights", ckpt, "--source", src, "--max-images",
           "8", "--no-figure"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    print(f"detect: exit {r.returncode} in {time.perf_counter() - t0:.1f} "
          f"s; stdout:\n  " + "\n  ".join(lines), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"detect failed:\n{r.stderr[-3000:]}")
    counts = {}
    for x in lines[:-2]:
        name, n = x.rsplit(": ", 1)
        counts[name] = int(n.split()[0])
    if len(counts) != 8 or not lines[-2].startswith("average fps: ") \
            or not lines[-1].startswith("miss rate"):
        raise AssertionError("detect did not print its lines")
    pred = Predictor(mnv3_ir, mnv3_vars, img_size=512, conf_thres=0.1,
                     iou_thres=0.5, batch_buckets=(1,), device=dev)
    want = {}
    for name in counts:
        vp, lp = get_pair_paths(os.path.join(src, name))
        v = cv2.imread(vp)[None, :, :, ::-1]
        l = cv2.imread(lp)[None, :, :, ::-1]
        want[name] = len(pred(v, l)[0][0])
    print(f"detect: counts per image {counts}, in process {want}",
          flush=True)
    if counts != want:
        raise AssertionError("detect's counts differ from the in-process "
                             "Predictor's")


def _bench_subprocess(leg):
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.bench", leg]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=600)
    print(f"bench {leg}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; stderr "
          f"{r.stderr.strip().splitlines()[-4:]}", flush=True)
    if r.returncode != 0:
        raise AssertionError(f"bench {leg} failed:\n{r.stderr[-3000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"bench {leg}: {json.dumps(line)}", flush=True)
    if not ({"metric", "value", "unit", "vs_baseline", "repeats"}
            <= set(line) and line["value"] > 0):
        raise AssertionError(f"bench {leg} printed {line}")
    return line


def _microbatch(torch, launches, pred, counts):
    """A MicroBatcher over the flagship bf16 graph Predictor, 16 submitter
    threads, against the frames served alone."""
    import threading

    from double_yolo_kaist_torch.serving import MicroBatcher
    rng = np.random.default_rng(SEED + 12)
    frames = [tuple(rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
                    for _ in range(2)) for _ in range(16)]
    got = [None] * 16
    mb = MicroBatcher(pred, max_batch=16)
    try:
        def submit(i):
            got[i] = mb.submit(*frames[i])

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(16)]
        launches.clear()                     # the micro-batched run
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        counts["microbatch flagship bf16"] = dict(launches)
        dt = (time.perf_counter() - t0) * 1e3
        if any(t.is_alive() for t in threads) or None in got:
            raise AssertionError("a MicroBatcher submitter did not finish")
        stats = mb.stats
    finally:
        mb.close()
    alone = [_alone(pred, v, l, pred.batch_buckets) for v, l in frames]
    matched = [_matching_bucket(g, a) for g, a in zip(got, alone)]
    print(f"MicroBatcher, flagship bf16 graphs, 16 threads: {dt:.1f} ms, "
          f"stats {stats}, launches {counts['microbatch flagship bf16']}; "
          f"buckets whose lone-frame detections each answer equals "
          f"{matched}", flush=True)
    if not all(matched):
        raise AssertionError("the MicroBatcher's answers differ from "
                             "unbatched requests")
    # a frame served in a bigger bucket against the same frame in bucket 1
    # (cuDNN may pick other kernels for another batch size). Near-equal
    # scores may swap places, so detections are matched as sets: each box
    # to the nearest box of the other answer, scores in sorted order.
    same_n = d_box = d_score = 0
    for g, a in zip(got, alone):
        want = a[1]
        if len(g[0]) == len(want[0]):
            same_n += 1
            if len(g[0]):
                d = np.abs(g[0][:, None] - want[0][None]).max(-1)
                d_box = max(d_box, float(d.min(1).max()), float(d.min(0).max()))
                d_score = max(d_score, float(np.abs(
                    np.sort(g[1]) - np.sort(want[1])).max()))
    print(f"MicroBatcher answers against bucket 1 (unbatched): "
          f"{sum(1 in m for m in matched)} of 16 bit-identical, {same_n} "
          f"with the same count; every box within {d_box:.4f} px of one in "
          f"the other answer, sorted scores within {d_score:.6f}", flush=True)


def phase_entry_points(torch, dev, launches, mnv3_ir, mnv3_vars,
                       flagship_pred, ckpt, root):
    """The entry points as subprocesses, and the MicroBatcher in process.
    Returns (launch counts of the in-process run, numbers)."""
    counts, numbers = {}, {}
    numbers["serve"] = _serve_subprocess(torch, dev, mnv3_ir, mnv3_vars,
                                         ckpt)
    _detect_subprocess(dev, mnv3_ir, mnv3_vars, ckpt, root)
    numbers["bench"] = {leg: _bench_subprocess(leg)
                        for leg in ("--bf16", "--int8")}
    _microbatch(torch, launches, flagship_pred, counts)
    return counts, numbers


# ---------------------------------------------------------------- phase 12

TRAIN_BS = 8
TRAIN_HW = 512
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FIT = 3, 10, 20
TRAIN_LR = 1e-3
TRAIN_HYP = {"box": 3.54, "cls": 37.4 / 80, "obj": 64.3 * TRAIN_HW / 320,
             "cls_pw": 1.0, "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0,
             "ciou": 1.0, "momentum": 0.937, "weight_decay": 0.0005,
             "lr0": TRAIN_LR, "lrf": 0.1}


def _train_batch(torch, rng, bs, hw, dev, n_boxes=4):
    """A fixed train batch from ``rng``: uint8 frames and up to
    ``n_boxes`` labels an image (normalized cls cx cy w h)."""
    from double_yolo_kaist_torch.train.loss import pad_labels
    labels = []
    for _ in range(bs):
        n = int(rng.integers(1, n_boxes + 1))
        cxy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.04, 0.3, (n, 2))
        labels.append(np.concatenate([np.zeros((n, 1)), cxy, wh], 1)
                      .astype(np.float32))
    t, m = pad_labels(labels, 16)
    return {"v": torch.from_numpy(rng.integers(0, 256, (bs,) + hw + (3,),
                                               dtype=np.uint8)).to(dev),
            "l": torch.from_numpy(rng.integers(0, 256, (bs,) + hw + (3,),
                                               dtype=np.uint8)).to(dev),
            "targets": torch.from_numpy(t).to(dev),
            "tmask": torch.from_numpy(m).to(dev)}


def _leaf_err(torch, a, b):
    """max over leaves of ||a - b|| / ||b|| (leaves with b = 0 skipped)."""
    worst = 0.0
    for x, y in zip(a, b):
        y = y.detach().cpu().double()
        x = x.detach().cpu().double()
        scale = float(torch.linalg.vector_norm(y))
        if scale > 0:
            worst = max(worst, float(torch.linalg.vector_norm(x - y)) / scale)
    return worst


def _one_step(torch, ir, variables, batch, where, dtype, sgd):
    """One train step of ``ir`` from ``variables`` on ``batch`` at
    ``where`` with activations in ``dtype``: (metrics, param deltas, BN
    state)."""
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils import tree as TR
    tx = OPT.make_optimizer(TRAIN_HYP, lambda c: torch.tensor(TRAIN_LR),
                            sgd=sgd)
    st = ST.create_train_state(ir, SEED, tx, variables=variables,
                               device=where)
    before = [p.detach().clone() for p in TR.leaves(st.params)]
    fn = ST.make_train_step(ir, TRAIN_HYP, tx, compute_dtype=dtype)
    st, m = fn(st, {k: v.to(where) for k, v in batch.items()})
    return (ST.metrics_to_host(m),
            [p.detach() - b for p, b in zip(TR.leaves(st.params), before)],
            TR.leaves(st.bn_state))


def _step_errs(torch, got, want):
    """Relative errors of one step against another: the loss terms, the
    grad norm, the param deltas and the BN state (leaf by leaf, by norm)."""
    (mg, dg, sg), (mw, dw, sw) = got, want
    return {"loss": max(abs(mg[k] - mw[k]) / max(abs(mw[k]), 1e-12)
                        for k in ("box_loss", "obj_loss", "class_loss",
                                  "loss")),
            "grad_norm": abs(mg["grad_norm"] - mw["grad_norm"])
            / mw["grad_norm"],
            "delta": _leaf_err(torch, dg, dw),
            "state": _leaf_err(torch, sg, sw)}


def _step_card_vs_cpu(torch, dev, ir, variables):
    """One SGD and one Adam step of MNv3 at bs 2, 128x160 from the same
    variables and batch, on the card and on the CPU, TF32 off. In float64
    activations the two must agree tightly (STEP_F64_BOUNDS). In fp32,
    train-mode BN over bs 2 amplifies rounding (one fp32 step moves some
    leaves by tens of percent between any two summation orders), so the
    card's fp32 step is held against the float64 step as closely as the
    CPU's fp32 step is: within 3x the CPU's error, plus 1e-6."""
    batch = _train_batch(torch, np.random.default_rng(SEED + 12), 2,
                         (128, 160), "cpu")
    cpu = torch.device("cpu")
    with _NoTF32(torch):
        for sgd in (True, False):
            name = "SGD" if sgd else "Adam"
            run = {(w.type, str(dt)[6:]): _one_step(torch, ir, variables,
                                                    batch, w, dt, sgd)
                   for w in (dev, cpu)
                   for dt in (torch.float64, torch.float32)}
            f64 = _step_errs(torch, run[("cuda", "float64")],
                             run[("cpu", "float64")])
            card32 = _step_errs(torch, run[("cuda", "float32")],
                                run[("cpu", "float64")])
            cpu32 = _step_errs(torch, run[("cpu", "float32")],
                               run[("cpu", "float64")])
            m = run[("cuda", "float32")][0]
            print(f"train step MNv3 {name}, loss {m['loss']:.6f}, grad_norm "
                  f"{m['grad_norm']:.4f}; float64 card vs CPU (bound): "
                  + ", ".join(f"{k} {v:.2e} ({STEP_F64_BOUNDS[k]:g})"
                              for k, v in f64.items())
                  + "; fp32 against the float64 step, card / CPU: "
                  + ", ".join(f"{k} {card32[k]:.2e} / {cpu32[k]:.2e}"
                              for k in card32), flush=True)
            bad = [k for k, v in f64.items() if not v <= STEP_F64_BOUNDS[k]]
            bad += [f"fp32 {k}" for k in card32
                    if not card32[k] <= 3 * cpu32[k] + 1e-6]
            if bad:
                raise AssertionError(f"train step {name}: card disagrees "
                                     f"with the CPU: {bad}")


STEP_F64_BOUNDS = {"loss": 1e-8, "grad_norm": 1e-6, "delta": 1e-4,
                   "state": 1e-8}


def _time_steps(torch, ir, variables, dev, label, n_steps):
    """``n_steps`` bf16 Adam steps at constant lr on one fixed batch of
    TRAIN_BS at TRAIN_HW x TRAIN_HW; each timed on the host clock (the
    metrics' fetch synchronises). Returns (losses, ms of the steps after
    the warm-up, profile of one more step, peak bytes)."""
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    batch = _train_batch(torch, np.random.default_rng(SEED + 13), TRAIN_BS,
                         (TRAIN_HW, TRAIN_HW), dev)
    tx = OPT.make_optimizer(TRAIN_HYP, lambda c: torch.tensor(TRAIN_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = [ST.create_train_state(ir, SEED, tx, variables=variables,
                                   device=dev)]
    fn = ST.make_train_step(ir, TRAIN_HYP, tx, compute_dtype=torch.bfloat16)
    losses, ms = [], []

    def one():
        state[0], m = fn(state[0], batch)
        return ST.metrics_to_host(m)

    for _ in range(n_steps):
        t0 = time.perf_counter()
        m = one()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train {label}: non-finite metrics {m}")
    peak = torch.cuda.max_memory_allocated()
    prof = {}
    for _ in range(3):                      # a blind window is tried again
        prof = _profile(torch, one)
        if prof:
            break
    timed = ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    return losses, timed, prof, peak


def phase_train_step(torch, dev, mnv3_ir, flagship_ir):
    """The train step on the card: MNv3 card vs CPU (fp32, SGD and Adam);
    the flagship at full width, bf16, bs 8, 512x512 from graph.init: step
    times, images/s, busy share, top kernels, peak memory, and 20 steps on
    one batch that must lower its loss; MNv3's step at the same shape.
    Returns the numbers."""
    from double_yolo_kaist_torch.models import graph, weights
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    _step_card_vs_cpu(torch, dev, mnv3_ir, mnv3_vars)
    numbers = {}
    for label, ir, variables, n in (
            ("flagship", flagship_ir, graph.init(flagship_ir, SEED),
             TRAIN_FIT),
            ("MNv3", mnv3_ir, mnv3_vars, TRAIN_WARMUP + TRAIN_TIMED)):
        losses, timed, prof, peak = _time_steps(torch, ir, variables, dev,
                                                label, n)
        med = statistics.median(timed)
        busy = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:10]
        numbers[label] = {
            "step_ms_median": med, "step_ms_min": min(timed),
            "step_ms_max": max(timed), "images_per_s": TRAIN_BS / med * 1e3,
            "busy_ms": busy, "busy_pct": 100 * busy / med,
            "peak_bytes": peak, "first_loss": losses[0],
            "last_loss": losses[-1]}
        print(f"train {label} bf16 bs {TRAIN_BS} {TRAIN_HW}x{TRAIN_HW}: step "
              f"median {med:.3f} ms (min {min(timed):.3f}, max "
              f"{max(timed):.3f}) over {len(timed)} steps after "
              f"{TRAIN_WARMUP}; {TRAIN_BS / med * 1e3:.2f} images/s; "
              f"device busy {busy:.3f} ms of a step ({100 * busy / med:.1f}%)"
              f"; peak memory {peak / 2 ** 30:.3f} GiB; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
              f"steps", flush=True)
        print(f"train {label} top kernels (device ms a step):\n  "
              + "\n  ".join(f"{v:.3f} {k[:200]}" for k, v in top),
              flush=True)
        if label == "flagship" and not losses[-1] < losses[0]:
            raise AssertionError(f"train {label}: {len(losses)} steps on one "
                                 f"batch did not lower the loss")
    print("train numbers: " + json.dumps(numbers), flush=True)
    return numbers


# ---------------------------------------------------------------- phase 13

def _run(cmd, what, timeout=900):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=timeout)
    lines = r.stdout.splitlines()
    print(f"{what}: exit {r.returncode} in {time.perf_counter() - t0:.1f} "
          f"s; last lines:\n  " + "\n  ".join(lines[-6:]), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"{what} failed:\n{r.stderr[-3000:]}")
    return lines


def _results_lines(path):
    with open(path) as f:
        return [x for x in f.read().splitlines() if x.startswith("epoch:")]


def _expected_keys(params_keys, ema: bool, sgd: bool):
    """The flat keys JAX's chain (add_decayed_weights -> scale_by_adam or
    trace -> scale_by_learning_rate) gives its opt_state, and the EMA's."""
    keys = {"opt_state/2/0"} | (set() if sgd else {"opt_state/1/0"})
    for k in params_keys:
        rest = k[len("params/"):]
        keys |= ({f"opt_state/1/0/{rest}"} if sgd else
                 {f"opt_state/1/1/{rest}", f"opt_state/1/2/{rest}"})
        if ema:
            keys.add(f"ema/params/{rest}")
    if ema:
        keys.add("ema/updates")
    return keys


def _check_checkpoint(path, ema: bool, sgd: bool = False):
    """A checkpoint the port wrote holds the JAX layout: every key of
    params, bn_state, the Adam or SGD opt_state and the EMA, and nothing
    else; load_checkpoint with that structure as template takes every
    array."""
    from double_yolo_kaist_torch.utils.checkpoint import load_checkpoint
    with open(os.path.join(path, "manifest.json")) as f:
        keys = set(json.load(f)["keys"])
    params = {k for k in keys if k.startswith("params/")}
    bn = {k for k in keys if k.startswith("bn_state/")}
    want = params | bn | _expected_keys(params, ema, sgd)
    raw = load_checkpoint(path)

    def template(tree):
        if isinstance(tree, dict):
            return {k: template(v) for k, v in tree.items()}
        return np.zeros_like(tree)
    tmpl = {k: template(v) for k, v in raw.items()
            if k in ("params", "bn_state", "opt_state", "ema")}
    back = load_checkpoint(path, tmpl)
    got = load_checkpoint(path)
    same = all(np.array_equal(a, b) for a, b in zip(
        _leaves_np({k: back[k] for k in tmpl}),
        _leaves_np({k: got[k] for k in tmpl})))
    print(f"checkpoint {os.path.basename(path)}: {len(keys)} keys, JAX "
          f"layout of {'SGD' if sgd else 'Adam'} "
          f"{'with' if ema else 'without'} EMA: missing "
          f"{sorted(want - keys)[:4]}, extra {sorted(keys - want)[:4]}; "
          f"load_checkpoint with the JAX template takes every array: "
          f"{same}", flush=True)
    if keys != want or not same:
        raise AssertionError(f"checkpoint {path}: not the JAX layout")


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves_np(v)]
    return [np.asarray(tree)]


def phase_train_entry(torch, dev, launches, flagship_ir, root):
    """The trainer in process (flagship bf16, bs 8, one epoch with its
    evaluation, launch counts), then ``python -m
    double_yolo_kaist_torch.train`` as subprocesses on phase 9's split:
    2 epochs, a resume to 3, and beside them MNv3 fine-tuned with
    ``--ema``; ``evaluate``
    on each ``last`` at the trainer's batch size must print results.txt's
    last mAP; the checkpoints hold the JAX layout. Returns the launch
    counts of the in-process run."""
    from double_yolo_kaist_torch.config.parser import load_hyp
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.train.trainer import Trainer
    split = os.path.join(root, "eval80.txt")
    data = os.path.join(root, "train.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")
    hyp = load_hyp(os.path.join(ROOT, "configs", "hyp.scratch.4.yaml"))
    hyp["cls"] *= 1 / 80.0
    hyp["obj"] *= TRAIN_HW / 320.0
    runs = os.path.join(root, "runs")

    # the main path in process: one epoch and its evaluation
    train_ds = KaistDataset(split, TRAIN_HW, TRAIN_BS, augment=True, hyp=hyp,
                            single_cls=True)
    val_ds = KaistDataset(split, TRAIN_HW, TRAIN_BS, hyp=hyp, rect=True,
                          single_cls=True)
    n_batches = len(train_ds) // TRAIN_BS
    n_eval = -(-len(val_ds) // TRAIN_BS)
    trainer = Trainer(flagship_ir, hyp, epochs=1, batch_size=TRAIN_BS,
                      img_size=TRAIN_HW, train_dataset=train_ds,
                      val_dataset=val_ds, out_dir=runs, name="inproc",
                      device=dev)
    launches.clear()
    t0 = time.perf_counter()
    best = trainer.fit()
    torch.cuda.synchronize()
    counts = dict(launches)
    want = {"decode_head": n_eval, "nms_indices": n_eval,
            "stem_conv_s2": 2 * n_eval, "qgemm": 0}
    got = {k: counts.get(k, 0) for k in want}
    print(f"train in process: flagship bf16, {n_batches} steps + eval of "
          f"{len(val_ds)} frames in {time.perf_counter() - t0:.1f} s, best "
          f"mAP {best:.4f}; launches {got} (want {want})", flush=True)
    if got != want:
        raise AssertionError("train in process: launch counts")
    del trainer

    # the entry point as subprocesses (nothing timed): the flagship's runs
    # and, beside them, the shorter --ema run: MNv3 from its trained
    # weights (phase 9's checkpoint), one epoch of SGD (Adam's first steps
    # at lr 1e-3 undo trained weights); its mAP is not 0, so that
    # evaluate's reproduction of it means something
    base = [sys.executable, "-m", "double_yolo_kaist_torch.train", "--cfg",
            "Double-YOLOv4-Fshare-Global-CSE3", "--data", data,
            "--img-size", str(TRAIN_HW), "--batch-size", str(TRAIN_BS),
            "--out-dir", runs]

    def mnv3_ema():
        ckpt = os.path.join(root, "mnv3_ckpt")
        _run(base[:4] + [MNV3_NAME, "--weights", ckpt] + base[5:]
             + ["--epochs", "1", "--name", "mnv3", "--ema", "--sgd"],
             "train MNv3 --ema --sgd, 1 epoch from its trained weights")
        _check_checkpoint(os.path.join(runs, "mnv3", "last"), ema=True,
                          sgd=True)
        if _evaluate_last(os.path.join(runs, "mnv3"), MNV3_NAME, data) <= 0:
            raise AssertionError("train MNv3: mAP 0 after fine-tuning")

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ema = pool.submit(mnv3_ema)
        out = os.path.join(runs, "t2")
        _run(base + ["--epochs", "2", "--name", "t2"], "train 2 epochs")
        for name in ("last", "best", "results.txt"):
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"train: no {name} in {out}")
        if len(_results_lines(os.path.join(out, "results.txt"))) != 2:
            raise AssertionError("train: results.txt wants 2 epoch lines")
        _run(base + ["--epochs", "3", "--name", "t2", "--resume",
                     os.path.join(out, "last")], "train resumed to 3 epochs")
        res = _results_lines(os.path.join(out, "results.txt"))
        with open(os.path.join(out, "last", "manifest.json")) as f:
            epoch = json.load(f)["epoch"]
        print(f"resume: results.txt {len(res)} lines, last checkpoint epoch "
              f"{epoch}", flush=True)
        if len(res) != 3 or not res[-1].startswith("epoch:2 ") or epoch != 2:
            raise AssertionError("train: the resume did not train epoch 2")
        _check_checkpoint(os.path.join(out, "last"), ema=False)
        _evaluate_last(out, "Double-YOLOv4-Fshare-Global-CSE3", data)
        ema.result()
    return counts


def _evaluate_last(out, cfg, data):
    """``evaluate`` on ``out``/last at the trainer's batch size must print
    the last mAP of ``out``/results.txt (4 decimals), and give the
    detections (its precision curve) of the same checkpoint scored in
    process; returns the mAP."""
    from double_yolo_kaist_torch.common import build_model
    from double_yolo_kaist_torch.config.parser import parse_data_cfg
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    npy = os.path.join(out, "curves.npy")
    lines = _run([sys.executable, "-m", "double_yolo_kaist_torch.evaluate",
                  "--cfg", cfg, "--weights", os.path.join(out, "last"),
                  "--data", data, "--img-size", str(TRAIN_HW),
                  "--batch-size", str(TRAIN_BS), "--npy-path", npy],
                 f"evaluate {cfg} on last")
    got_map = [x for x in lines if x.startswith("AP@")][0].split("=")[-1]
    want_map = _results_lines(os.path.join(out, "results.txt"))[-1].split()[1]
    cli = np.load(npy, allow_pickle=True).item()
    ir, variables = build_model(cfg, os.path.join(out, "last"))
    res = evaluate_dataset(ir, variables, KaistDataset(
        parse_data_cfg(data)["test"], TRAIN_HW, TRAIN_BS, rect=True),
        batch_size=TRAIN_BS, device="cuda")
    same = np.array_equal(cli["precision"], res["curves"]["precision"])
    print(f"evaluate {cfg} on last: mAP@[0.50:0.95] {got_map.strip()}, "
          f"results.txt {want_map}; VOC-AP {cli['ap']:.6f}, in process "
          f"{res['ap']:.6f}; the {len(cli['precision'])} detections' "
          f"precision curve equal to the in-process run's: {same}",
          flush=True)
    if got_map.strip() != want_map or not same:
        raise AssertionError("evaluate does not reproduce results.txt")
    return float(want_map)


# ---------------------------------------------------------------- phase 14

INT8_NEW_MODES = ("edge", "spine", "spineall")
CLAHE_SHAPES = ((8, 512, 640), (2, 1024, 1024))
AUG_BS = 8
# the CPU test of the same call against JAX (tests/test_torch_augment.py):
# rounding to uint8 for CLAHE can tip a value on .5 by a level
AUG_CLAHE_SHARE = 0.005


def _clahe_and_cutout(torch, dev):
    """CLAHE on the card byte for byte the CPU's, and the snowflake cutout
    from the same uniforms the CPU's; device ms by CUDA events."""
    from double_yolo_kaist_torch.data import augment as A
    from double_yolo_kaist_torch.data.clahe import clahe_batch
    rng = np.random.default_rng(SEED + 14)
    out = {}
    for n, h, w in CLAHE_SHAPES:
        for kind in ("random", "low-contrast"):
            if kind == "random":
                x = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
            else:
                x = (100 + rng.integers(0, 12, (n, h, w, 3))).astype(
                    np.uint8)
            x = torch.from_numpy(x)
            want = clahe_batch(x)
            xd = x.to(dev)
            got = clahe_batch(xd).cpu()
            diff = int((got.int() - want.int()).abs().max())
            ms = _time_ms(torch, lambda: clahe_batch(xd), iters=5, reps=5)
            out[f"{n}x{h}x{w} {kind}"] = {"max_diff": diff, "ms": ms}
            print(f"CLAHE {kind} ({n}, {h}, {w}, 3) uint8: card vs CPU max "
                  f"|diff| {diff} (want 0), device {ms:.4f} ms", flush=True)
            if diff != 0:
                raise AssertionError("CLAHE on the card differs from the CPU")
    b, hw = AUG_BS, (1024, 1024)
    v = torch.from_numpy(rng.uniform(1, 255, (b,) + hw + (3,)).astype(
        np.float32))
    l = torch.from_numpy(rng.uniform(1, 255, (b,) + hw + (3,)).astype(
        np.float32))
    xy = rng.uniform(0, 900, (b, 30, 2))
    lab = torch.from_numpy(np.concatenate(
        [np.zeros((b, 30, 1)), xy, xy + rng.uniform(8, 120, (b, 30, 2))],
        -1).astype(np.float32))
    m = torch.from_numpy(np.arange(30)[None, :] < rng.integers(
        0, 30, (b, 1)))
    u = torch.rand((b, 80, 2), generator=torch.Generator().manual_seed(SEED))
    kw = dict(n_thr=24, step=32, n_snow=80, u=u)
    want = A.snowflake_cutout(None, v, l, lab, m, **kw)
    args = [t.to(dev) for t in (v, l, lab, m)]
    got = A.snowflake_cutout(None, *args, **kw)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    ms = _time_ms(torch, lambda: A.snowflake_cutout(None, *args, **kw),
                  iters=5, reps=5)
    cut = float((want[0] == 0).all(-1).float().mean())
    print(f"snowflake cutout ({b}, 1024, 1024, 3), 80 squares of 32: card "
          f"vs CPU images, labels kept equal {same} ({int(want[2].sum())} of "
          f"{int(m.sum())} labels kept, {cut:.4f} of pixels cut), device "
          f"{ms:.4f} ms", flush=True)
    if not same:
        raise AssertionError("the cutout on the card differs from the CPU")
    out["cutout ms"] = ms
    return out


def _augment_snow_clahe(torch, dev):
    """One make_train_augment_fn(snowflake=True, clahe=True) batch of 8 at
    512, from the same drawn randoms on the card and on the CPU, and the
    card's data ms a step (host clock, the call synchronised)."""
    from double_yolo_kaist_torch.config.parser import load_hyp
    from double_yolo_kaist_torch.data import pipeline as P
    hyp = load_hyp(os.path.join(ROOT, "configs", "hyp.scratch.4.yaml"))
    rng = np.random.default_rng(SEED + 15)
    nb, src = AUG_BS, EVAL_HW
    v = torch.from_numpy(rng.integers(0, 256, (4 * nb,) + src + (3,),
                                      dtype=np.uint8))
    l = torch.from_numpy(rng.integers(0, 256, (4 * nb,) + src + (3,),
                                      dtype=np.uint8))
    lab = np.zeros((4 * nb, 6, 5), np.float32)
    lab[..., 1:3] = rng.uniform(0.2, 0.8, (4 * nb, 6, 2))
    lab[..., 3:] = rng.uniform(0.05, 0.3, (4 * nb, 6, 2))
    m = torch.from_numpy(rng.random((4 * nb, 6)) < 0.6)
    lab = torch.from_numpy(lab)
    fn = P.make_train_augment_fn(src, 512, hyp, snowflake=True, clahe=True)
    draws = fn.draw(torch.Generator().manual_seed(SEED), nb)
    want = fn.heavy(v, l, lab, m, **draws)
    args = [t.to(dev) for t in (v, l, lab, m)]
    got = fn.heavy(*args, **draws)
    out = {}
    for name in ("v", "l"):
        d = (got[name].cpu() * 255 - want[name] * 255).abs()
        share = float((d > 1e-3).float().mean())
        out[name] = (share, float(d.max()))
    t_err = float((got["targets"].cpu() - want["targets"]).abs().max())
    same_m = torch.equal(got["tmask"].cpu(), want["tmask"])
    times = []
    for i in range(6):
        t0 = time.perf_counter()
        fn(torch.Generator().manual_seed(SEED + i), *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times[1:])
    print(f"train augment snow+clahe bs {nb} at 512, card vs CPU from the "
          f"same randoms: share of pixels differing v {out['v'][0]:.2e} l "
          f"{out['l'][0]:.2e} (bound {AUG_CLAHE_SHARE}), largest |diff| v "
          f"{out['v'][1]:.3f} l {out['l'][1]:.3f} of 255; targets max err "
          f"{t_err:.2e}, masks equal {same_m}; data ms a step on the card "
          f"(host clock) median {ms:.2f}, min {min(times[1:]):.2f}, max "
          f"{max(times[1:]):.2f}", flush=True)
    if (max(out["v"][0], out["l"][0]) > AUG_CLAHE_SHARE or t_err > 1e-5
            or not same_m):
        raise AssertionError("the snow+clahe augment on the card differs "
                             "from the CPU beyond its bound")
    return {"data_ms": ms, "share": max(out["v"][0], out["l"][0])}


def _k4_per_forward(ir, mode):
    from double_yolo_kaist_torch.models import quantize as Q
    targets = Q.plan_quantization(ir, mode)[0]
    return sum(Q._gemm_conv(ir.nodes[i]) for i in targets)


def _k4_hold_forward(torch, ir, qvars, mode, xv, xl, what):
    """Every K4 call of one eager int8 forward of ``mode`` on the card, at
    the main path's operands (its M, weights, scales, activations and bf16
    output), against ``qgemm_plain`` on the same tensors, by
    :func:`_k4_hold`'s bounds: bf16 outputs equal, s8 within one step on
    under 5%. Returns the number of calls held."""
    from double_yolo_kaist_torch.models import quantize as Q
    from double_yolo_kaist_torch.ops import qgemm as K4
    kernel, held = K4.qgemm, []

    def hold(x, w, scale, bias, act, out_inv_s=None,
             out_dtype=torch.bfloat16):
        got = kernel(x, w, scale, bias, act, out_inv_s=out_inv_s,
                     out_dtype=out_dtype)
        want = K4.qgemm_plain(x, w.t(), scale, bias, act,
                              out_inv_s=out_inv_s, out_dtype=out_dtype)
        if out_inv_s is not None:
            d = (got.int() - want.int()).abs()
            ok = int(d.max()) <= 1 and float((d != 0).float().mean()) < 0.05
        else:
            ok = torch.equal(got, want)
        m, n_bad = x.numel() // x.shape[-1], int((got != want).sum())
        held.append((m, x.shape[-1], w.shape[0], act, got.dtype, n_bad))
        if not ok or got.dtype != want.dtype:
            raise AssertionError(
                f"K4 in the {what} forward, M {m} K {x.shape[-1]} N "
                f"{w.shape[0]} {act} -> {got.dtype}: {n_bad} elements "
                f"disagree with its plain version")
        return got

    K4.qgemm = hold
    try:
        with torch.inference_mode():
            Q.apply_quantized(ir, qvars, xv, xl, compute_dtype=torch.bfloat16,
                              mode=mode)
        torch.cuda.synchronize()
    finally:
        K4.qgemm = kernel
    n_k4 = _k4_per_forward(ir, mode)
    shapes = sorted({(m, k, n) for m, k, n, _, _, _ in held})
    print(f"K4 in one eager {what} forward: {len(held)} calls (want "
          f"{n_k4}), each against qgemm_plain on the same card tensors: "
          f"{sum(h[-1] for h in held)} elements differ (bf16 outputs equal, "
          f"s8 within one step on < 5%); activations "
          f"{sorted({h[3] for h in held})}, outputs "
          f"{sorted({str(h[4]) for h in held})}, {len(shapes)} (M, K, N) "
          f"shapes, M {sorted({s[0] for s in shapes})}", flush=True)
    if len(held) != n_k4:
        raise AssertionError(f"{what}: {len(held)} K4 calls, want {n_k4}")
    return len(held)


def _int8_mode(torch, dev, launches, ir, variables, frames, mode, path,
               timed=True):
    """The flagship in int8 ``mode``: a Predictor calibrates on two requests
    of 8 (its stats saved beside ``path``), quantizes and saves ``path``;
    requests of 1 and 8 from its CUDA graphs; then a Predictor from
    ``path`` must serve the same detections bit for bit from its own
    graphs; every K4 call of an eager bs-8 and bs-1 forward is held
    against its plain version. ``timed``: the request times and busy
    shares of the artifact's Predictor. Returns (launch counts of the two
    runs, timings or None, startup seconds, the in-process Predictor)."""
    from double_yolo_kaist_torch.serving import Predictor
    n_heads = len(ir.yolo_indices)
    n_k4 = _k4_per_forward(ir, mode)
    fwd = {"stem_conv_s2": 2, "qgemm": 0, "decode_head": 1,
           "nms_indices": 1}
    q_fwd = dict(fwd, qgemm=n_k4)
    print(f"flagship int8 {mode}: {n_k4} K4 convs a forward; two "
          f"calibration requests of 8, then int8:", flush=True)
    launches.clear()                        # this mode's run
    t0 = time.perf_counter()
    pred = Predictor(ir, variables, img_size=640, device=dev, int8=True,
                     int8_mode=mode, quantized=path,
                     calibration=path[:-4] + "_cal.npz")
    _serve(torch, pred, frames, launches, 8, fwd, n_heads)
    _serve(torch, pred, frames, launches, 8,
           dict(q_fwd, stem_conv_s2=3 * 2), n_heads)
    t_quant = time.perf_counter() - t0
    if not os.path.exists(path):
        raise AssertionError(f"int8 {mode}: no artifact written")
    for n in (1, 8):                        # the capture's eager forward
        _serve(torch, pred, frames, launches, n,
               {k: 2 * v for k, v in q_fwd.items()}, n_heads)
    for n in (1, 3, 8):
        _serve(torch, pred, frames, launches, n, q_fwd, n_heads)
    counts = {f"int8 {mode}": dict(launches)}

    launches.clear()                        # the artifact's run
    t0 = time.perf_counter()
    loaded = Predictor(ir, variables, img_size=640, device=dev, int8=True,
                       int8_mode=mode, quantized=path)
    t_load = time.perf_counter() - t0
    if loaded.qvars is None:
        raise AssertionError(f"int8 {mode}: the artifact did not load")
    served = []
    for k, n in enumerate((1, 8, 1, 8)):   # capture, then replay
        served.append((n, _serve(
            torch, loaded, frames, launches, n,
            {k2: (2 if k < 2 else 1) * v for k2, v in q_fwd.items()},
            n_heads)))
    counts[f"int8 {mode} artifact"] = dict(launches)
    same = all(np.array_equal(a, b) for n, got in served
               for g, w in zip(got, pred(*frames[n]))
               for a, b in zip(g, w))
    print(f"flagship int8 {mode}: startup from the artifact {t_load:.2f} s "
          f"(Predictor built, weights placed) against {t_quant:.2f} s for "
          f"Predictor + 2 calibration requests (calibrate, quantize, save); "
          f"detections from the artifact equal the in-process Predictor's "
          f"bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError(f"int8 {mode}: the artifact's Predictor "
                             f"serves other detections")
    if timed:
        for n in (8, 1):
            with torch.inference_mode():
                fn, _, _ = pred._preprocess((512, 640))
                xv, xl = fn(*(torch.from_numpy(f).to(dev)
                              for f in frames[n]))
            _k4_hold_forward(torch, ir, pred.qvars, mode, xv, xl,
                             f"flagship int8 {mode} bs {n}, 512x640")
    times = (_medians(torch, loaded, frames, f"flagship int8 {mode}")
             if timed else None)
    del loaded
    return counts, times, {"load_s": t_load, "quantize_s": t_quant,
                           "k4_per_forward": n_k4}, pred


def _spine_is_chain(torch, ir, pred, path):
    """``spine`` plans no int8 add without the JAX package's s2d regions:
    its plan must be chain's, and its artifact the chain quantization of
    the same stats, leaf for leaf (so its serving is chain's, which phase
    8 times and holds against the CPU)."""
    from double_yolo_kaist_torch.models import quantize as Q
    if Q.plan_quantization(ir, "spine") != Q.plan_quantization(ir, "chain") \
            or Q._plan_with_spine(ir, "spine")[2]:
        raise AssertionError("spine plans otherwise than chain")
    stats, _ = Q.load_calibration(path[:-4] + "_cal.npz")
    got, _, _ = Q.load_quantized(path)
    want = Q.quantize(ir, pred._folded_cpu, stats, mode="chain")

    def leaves(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{pre}{k}/")
            else:
                yield pre + k, (v if isinstance(v, torch.Tensor)
                                else torch.as_tensor(np.asarray(v)))

    a, b = dict(leaves(got)), dict(leaves(want))
    same = sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k].to(a[k].dtype)) for k in a)
    print(f"flagship int8 spine: plan = chain's; its artifact ({len(a)} "
          f"leaves) equals chain's quantization of the same stats: {same}",
          flush=True)
    if not same:
        raise AssertionError("spine's artifact differs from chain's")


def _int8_entry_points(torch, dev, launches, root):
    """``python -m double_yolo_kaist_torch.calibrate --quantized-out`` (MNv3
    from phase 9's checkpoint, edge mode, on phase 9's split) and
    ``evaluate --int8 --int8-mode edge --int8-qvars`` on its artifact, as
    subprocesses; evaluate's VOC-AP line must equal evaluate_dataset(
    quantized=) in process on the same artifact, and every K4 call of the
    eval's first batch is held against its plain version. Returns the
    in-process run's launch counts."""
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.data.pipeline import eval_batches
    from double_yolo_kaist_torch.models import quantize as Q
    split = os.path.join(root, "eval80.txt")
    data = os.path.join(root, "int8.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")
    ck = os.path.join(root, "mnv3_ckpt")
    cal, qpath = (os.path.join(root, "mnv3_cal.npz"),
                  os.path.join(root, "mnv3_edge.npz"))
    _run([sys.executable, "-m", "double_yolo_kaist_torch.calibrate",
          "--cfg", MNV3_NAME, "--weights", ck, "--data", data, "--split",
          "test", "--img-size", str(EVAL_IMG), "--batch-size", "8",
          "--batches", "2", "--out", cal, "--quantized-out", qpath,
          "--int8-mode", "edge"], "calibrate --quantized-out (MNv3 edge)")
    qv, qmode, qhw = Q.load_quantized(qpath)
    if qmode != "edge" or qhw != (EVAL_IMG, EVAL_IMG):
        raise AssertionError(f"calibrate wrote mode {qmode}, hw {qhw}")
    lines = _run([sys.executable, "-m", "double_yolo_kaist_torch.evaluate",
                  "--cfg", MNV3_NAME, "--weights", ck, "--data", data,
                  "--img-size", str(EVAL_IMG), "--batch-size",
                  str(EVAL_BS), "--int8", "--int8-mode", "edge",
                  "--int8-qvars", qpath],
                 "evaluate --int8 --int8-mode edge --int8-qvars")
    printed = [x for x in lines if x.startswith("VOC Average Precision")]
    ir = compile_cfg(MNV3_CFG)
    ds = KaistDataset(split, EVAL_IMG, EVAL_BS, rect=True)
    n_b = -(-len(ds) // EVAL_BS)
    want = {"decode_head": n_b, "nms_indices": n_b,
            "qgemm": n_b * _k4_per_forward(ir, "edge")}
    res, counts, _ = _eval_run(torch, launches, "MNv3 int8 edge from the "
                               "artifact", ir, None, ds, want, int8=True,
                               int8_mode="edge", quantized=qpath, device=dev)
    line = (f"VOC Average Precision (VOC-AP)@[IoU = 0.5] = "
            f"{res['ap'] * 100:.2f}%")
    print(f"evaluate --int8-qvars printed {printed}; in process: {line}",
          flush=True)
    if printed != [line]:
        raise AssertionError("evaluate --int8-qvars printed another mAP "
                             "than evaluate_dataset(quantized=)")
    with torch.inference_mode():            # the eval's first batch
        xv, xl, _, _ = next(iter(eval_batches(ds, EVAL_BS, device=dev)))
    _k4_hold_forward(torch, ir, Q.place_quantized(ir, qv, dev,
                                                  torch.bfloat16),
                     "edge", xv, xl, f"MNv3 int8 edge eval bs {EVAL_BS}, "
                     f"{tuple(xv.shape[1:3])}")
    return {"eval int8 edge": counts}


def phase_int8aug(torch, dev, launches, root, flagship_times):
    """Phase 14: CLAHE and the cutout on the card, the train augment with
    both, ``train --snow --clahe``, the flagship in int8 edge, spine and
    spineall (artifacts, graphs, K4 at the served operands, card vs CPU),
    timed beside phase 8's bf16 and chain (``flagship_times``), and the
    calibrate / evaluate --int8-qvars entry points. Needs phase 9's
    labelled split and MNv3 checkpoint under ``root``. Returns the launch
    counts of its main-path runs."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.config.ir import compile_cfg
    t_phase = time.perf_counter()
    numbers = {"clahe": _clahe_and_cutout(torch, dev),
               "augment": _augment_snow_clahe(torch, dev)}

    ir = compile_cfg(FLAGSHIP_CFG)
    variables = seeded_variables(ir, SEED)
    rng = np.random.default_rng(SEED + 1)   # phase 8's frames
    frames = {n: (rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8),
                  rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8))
              for n in (1, 3, 8)}
    counts, startup = {}, {}
    times = {"bf16": flagship_times["bf16"], "chain": flagship_times["int8"]}
    for mode in INT8_NEW_MODES:
        path = os.path.join(root, f"flagship_{mode}.npz")
        c, t, startup[mode], pred = _int8_mode(
            torch, dev, launches, ir, variables, frames, mode, path,
            timed=mode != "spine")
        counts.update(c)
        if mode == "spine":
            _spine_is_chain(torch, ir, pred, path)
        else:
            times[mode] = t
            phase_flagship_int8_vs_cpu(torch, ir, variables, pred, dev,
                                       mode=mode)
        del pred
        torch.cuda.empty_cache()
    summary = {m: {"median_ms": {n: round(t[n], 4) for n in (1, 8)},
                   "busy_ms": {n: round(t["busy"][n][0], 4) for n in (1, 8)},
                   "busy_share": {n: round(t["busy"][n][1], 4)
                                  for n in (1, 8)},
                   **({k: round(v, 4) for k, v in startup[m].items()}
                      if m in startup else {})}
               for m, t in times.items()}
    summary["spine"] = {k: round(v, 4) for k, v in startup["spine"].items()}
    numbers["flagship"] = summary
    # one short epoch of the split's first 8 pairs (one step and their
    # CLAHE'd evaluation), run beside the entry points below: nothing is
    # timed from here on
    split = os.path.join(root, "eval8.txt")
    data = os.path.join(root, "snow.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")
    out = os.path.join(root, "runs", "snow")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        train = pool.submit(
            _run, [sys.executable, "-m", "double_yolo_kaist_torch.train",
                   "--cfg", MNV3_NAME, "--weights",
                   os.path.join(root, "mnv3_ckpt"), "--data", data,
                   "--img-size", str(TRAIN_HW), "--batch-size",
                   str(TRAIN_BS), "--epochs", "1", "--sgd", "--snow",
                   "--clahe", "--out-dir", os.path.dirname(out), "--name",
                   "snow"],
            "train --snow --clahe, MNv3, 1 epoch of 8 pairs")
        counts.update(_int8_entry_points(torch, dev, launches, root))
        train.result()
    for name in ("last", "results.txt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"train --snow --clahe: no {name}")
    if len(_results_lines(os.path.join(out, "results.txt"))) != 1:
        raise AssertionError("train --snow --clahe: results.txt wants 1 line")
    print("int8aug numbers (bf16 and chain: phase 8's Predictors; spine "
          "serves chain's program): " + json.dumps(numbers), flush=True)
    print(f"phase 14 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def _labelled_split(torch, dev, mnv3_ir, root):
    """Phase 9's split under ``root``, labelled with MNv3's fp32 detections,
    and MNv3's checkpoint beside it, as phase 9 makes them (for the runs
    of single phases)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    from double_yolo_kaist_torch.models import weights
    from double_yolo_kaist_torch.utils.checkpoint import save_checkpoint
    splits, cache = _eval_split(root, cv2)
    ds = KaistDataset(splits["eval80"], EVAL_IMG, EVAL_BS, rect=True,
                      cache_images=cache)
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    with _NoTF32(torch):
        res = evaluate_dataset(mnv3_ir, mnv3_vars, ds, batch_size=EVAL_BS,
                               device_cache=False,
                               compute_dtype=torch.float32, device=dev)
    _write_labels(ds, res["predictions"])
    jx = weights.to_jax_variables(mnv3_vars)
    save_checkpoint(os.path.join(root, "mnv3_ckpt"), params=jx["params"],
                    bn_state=jx["state"])


def _train_phases(torch, dev, mnv3_ir, flagship_ir, root, counts, failed):
    """Phases 12 and 13 (after the others have passed); returns the names
    of those that failed."""
    from double_yolo_kaist_torch.ops import _build
    out = []
    if failed:
        return out
    try:
        phase_train_step(torch, dev, mnv3_ir, flagship_ir)
    except Exception:                      # noqa: BLE001
        traceback.print_exc()
        out.append("train step")
    if not out:
        try:
            counts["train"] = phase_train_entry(torch, dev, _build.launches,
                                                flagship_ir, root)
        except Exception:                  # noqa: BLE001
            traceback.print_exc()
            out.append("train entry point")
    return out


def _only_train(torch, dev, mnv3_ir, flagship_ir) -> int:
    """``--only train``: phases 12 and 13 alone, on phase 9's split
    labelled and checkpointed as phase 9 does it (a quicker run for work on
    the training path; it prints no result line)."""
    with tempfile.TemporaryDirectory(prefix="dyk_smoke_") as root:
        _labelled_split(torch, dev, mnv3_ir, root)
        failed = _train_phases(torch, dev, mnv3_ir, flagship_ir, root, {},
                               [])
    if failed:
        return _fail(f"phases failed: {failed}")
    print("chip_smoke --only train: phases 12 and 13 passed", flush=True)
    return 0


def _only_int8aug(torch, dev, mnv3_ir) -> int:
    """``--only int8aug``: phase 14 after phase 8 (its bf16 and chain
    times), on phase 9's split labelled and checkpointed as phase 9 does it
    (it prints no result line)."""
    from double_yolo_kaist_torch.ops import _build
    _, times, served = phase_flagship(torch, dev, _build.launches)
    served.clear()
    with tempfile.TemporaryDirectory(prefix="dyk_smoke_") as root:
        _labelled_split(torch, dev, mnv3_ir, root)
        phase_int8aug(torch, dev, _build.launches, root, times)
    print("chip_smoke --only int8aug: phase 14 passed", flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return _fail("CUDA is not available; this script needs one GPU")
    sys.path.insert(0, ROOT)
    try:
        import double_yolo_kaist_torch as port
    except ImportError as e:
        return _fail(f"the port is not next to this script ({e})")
    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        return _fail(f"imported the port from {port.__file__}, not {ROOT}")
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.ops import _build

    failed = []
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = _smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        return _fail(f"kernel build: {e}")
    print(f"build: {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    ir = compile_cfg(MNV3_CFG)
    flagship_ir = compile_cfg(FLAGSHIP_CFG)
    if sys.argv[1:] == ["--only", "train"]:
        return _only_train(torch, dev, ir, flagship_ir)
    if sys.argv[1:] == ["--only", "int8aug"]:
        return _only_int8aug(torch, dev, ir)
    results = {}
    for name, fn in (("K1", lambda: phase_decode(torch, ir, dev,
                                                 _build.launches)),
                     ("K2", lambda: phase_nms(torch, dev)),
                     ("K3", lambda: phase_stem(torch, dev)),
                     ("K3 probes", lambda: phase_probes(torch, dev,
                                                        _build.launches)),
                     ("K4", lambda: phase_qgemm(torch, flagship_ir, dev,
                                                _build.launches))):
        try:
            results[name] = fn()
        except Exception:                  # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(name)
        _stamp(t_start, f"phase {name}")
    counts, served = {}, {}
    try:
        counts["mnv3"], _, served["mnv3"] = phase_end_to_end(
            torch, ir, dev, _build.launches)
    except Exception:                      # noqa: BLE001
        traceback.print_exc()
        failed.append("end to end")
    _stamp(t_start, "MNv3 end to end")
    try:
        flagship_counts, flagship_times, flagship_served = phase_flagship(
            torch, dev, _build.launches)
        counts.update(flagship_counts)
        served.update(flagship_served)
    except Exception:                      # noqa: BLE001
        traceback.print_exc()
        failed.append("flagship end to end")
    _stamp(t_start, "flagship end to end")
    eval_kernels = {}
    with tempfile.TemporaryDirectory(prefix="dyk_smoke_") as root:
        ckpt = None
        if not failed:                     # it prints beside phases 3-7
            try:
                eval_counts, eval_kernels, ckpt = phase_eval(
                    torch, dev, _build.launches, ir, flagship_ir, results,
                    root)
                counts.update(eval_counts)
            except Exception:              # noqa: BLE001
                traceback.print_exc()
                failed.append("evaluate")
            _stamp(t_start, "evaluate")
        if not failed:
            held = {"decode_head": 1, "nms_indices": 1}
            try:
                graph_counts, _ = phase_graphs(torch, _build.launches, [
                    ("MNv3 bf16", served["mnv3"][0], served["mnv3"][1],
                     held),
                    ("flagship bf16", *served["flagship bf16"],
                     dict(held, stem_conv_s2=2)),
                    ("flagship int8", *served["flagship int8"],
                     dict(held, stem_conv_s2=2, qgemm=10))])
                counts.update(graph_counts)
            except Exception:              # noqa: BLE001
                traceback.print_exc()
                failed.append("graphs")
            _stamp(t_start, "graphs")
        if not failed:
            try:
                entry_counts, _ = phase_entry_points(
                    torch, dev, _build.launches, ir, served["mnv3"][2],
                    served["flagship bf16"][0], ckpt, root)
                counts.update(entry_counts)
            except Exception:              # noqa: BLE001
                traceback.print_exc()
                failed.append("entry points")
            _stamp(t_start, "entry points")
        failed += _train_phases(torch, dev, ir, flagship_ir, root, counts,
                                failed)
        _stamp(t_start, "train step and entry point")
        served.clear()                 # phase 10 and 11 are done with them
        flagship_served = None
        if not failed:
            try:
                counts.update(phase_int8aug(torch, dev, _build.launches,
                                            root, flagship_times))
            except Exception:              # noqa: BLE001
                traceback.print_exc()
                failed.append("int8 modes and augment")
            _stamp(t_start, "int8 modes and augment")
    if failed:
        return _fail(f"phases failed: {failed}")

    def launched(kernel):
        """Launches of ``kernel`` summed over the main-path runs (MNv3,
        flagship bf16, flagship int8, the eval runs of phase 9, the graph
        runs of phase 10, the micro-batched run of phase 11, the Trainer's
        epoch of phase 13, the int8 runs of each mode and the edge eval of
        phase 14), each counted from 0 just before its run and read just
        after it."""
        return sum(c.get(kernel, 0) for c in counts.values())

    kernels = [
        {"name": "K1 head decode", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/decode.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_decode.py:28",
         "launches": launched("decode_head"), **results["K1"],
         **eval_kernels["K1"], "library_ms": None},
        {"name": "K2 greedy NMS", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/nms.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_nms.py:34",
         "launches": launched("nms_indices"), **results["K2"],
         **eval_kernels["K2"], "library_ms": None},
        {"name": "K3 stem conv 3x3 s2", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/stem.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_stem.py:138",
         "launches": launched("stem_conv_s2"), **results["K3"],
         **eval_kernels["K3"]},
        {"name": "K4 int8 GEMM + epilogue", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/qgemm.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_qgemm.py:101",
         "launches": launched("qgemm"), **results["K4"],
         **eval_kernels["K4"]},
        # launches: one run of the probes' own entry point (breakdown)
        {"name": "K3 probes", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/stem.cu",
         "replaces": "tools/archive/stem_probe.py:99", **results["K3 probes"]},
    ]
    if any(k["launches"] < 1 for k in kernels):
        return _fail(f"a kernel of the main path never launched: {counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
