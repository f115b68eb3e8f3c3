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
     then K5 (bias + activation epilogue) at the output of each conv of
     the flagship it finishes (all but the stems: mish, leaky and the
     heads' linear 18 channels), bs 8 at 512x640, bf16 and fp32, bit for
     bit the eager ops, and one forward's 183 launches timed in bf16
     beside their bound (bytes) and the eager ops' time;
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
     around one replay must show K1 once, K2 once, K3 twice (flagship),
     K4 ten times (int8) and K5 37 (MNv3), 183 (flagship bf16) and 101
     (flagship int8) times by kernel name; the median (min-max) request ms of
     graph and eager at bs 1 and 8 with their device busy shares;
 11. the entry points as subprocesses: ``serve`` (the MNv3 zoo name and a
     checkpoint directory) answering 32 concurrent raw-frame ``/detect``
     requests with the in-process Predictor's detections, its ``/healthz``
     showing a mean micro-batch above 1; ``detect --no-figure`` on 8 pairs
     of phase 9's split (run beside ``serve``), its count per image the
     in-process Predictor's;
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
     must show K1 and K2 once and K3 twice per evaluation batch; beside
     it ``python -m double_yolo_kaist_torch.train`` as subprocesses: 1
     epoch (``last``, ``best``, ``results.txt``), ``--resume <out>/last
     --epochs 2`` (one more epoch), and MNv3 fine-tuned with ``--ema`` for
     1 epoch from phase 9's checkpoint (SGD, deterministic algorithms: its
     mAP above 0 is a gate); their checkpoints hold the
     JAX package's layout (every key of params, BN state, the Adam or SGD
     optimizer state and the EMA; ``load_checkpoint`` takes them all);
     ``python -m double_yolo_kaist_torch.evaluate`` on the flagship's and
     MNv3's
     ``last`` at the trainer's batch size must print the last mAP of its
     results.txt and give the detections of the checkpoint scored in
     process;
 14. slice 8 (``--only int8aug`` runs it after phase 8): CLAHE on seeded
     uint8 frames (8 at 512x640, 2 at 1024x1024, random and low-contrast)
     and the snowflake cutout of 8 canvases of 1024x1024 from the same
     uniforms, byte for byte the CPU's, with device ms; one
     make_train_augment_fn(snowflake=True, clahe=True) batch of 8 at 512
     on the gather route from the same randoms on the card and the CPU (at most 0.5% of pixels
     differ, the CPU test's bound against JAX; labels within 1e-5, masks
     equal) and its data ms; the flagship at full width in int8 edge,
     spine and spineall: each Predictor calibrates on two requests of 8,
     quantizes for its size (640x640; the JAX package's defaults: the s2d
     plan sets spine's 6 int8 adds and 88 targets and edge's 156 targets
     and 233 int8 edges, checked) and saves its artifact (the s2d kernels
     of the 32 planned convs, checked on load), serves 1 and 8 frames
     from CUDA graphs with K4 launched as its plan says (84, 16, 56 a
     forward), and a Predictor from the artifact must serve the same
     detections bit for bit; every K4 call of an eager forward at bs 8
     and bs 1 against ``qgemm_plain`` on the same operands, median / min
     / max request ms and the device busy share beside phase 8's bf16 and
     chain, the startup from the artifact against calibrate + quantize,
     and the int8 path on the card against the CPU at 64x96 as phase 8
     holds chain; chain and edge with int8 stem pairs, each from an
     artifact: K3 launched 0 times, the stem pairs card against CPU;
     then ``python -m double_yolo_kaist_torch.calibrate --quantized-out``
     (MNv3, edge) and ``evaluate --int8 --int8-mode edge --int8-qvars`` on
     its artifact as subprocesses, whose VOC-AP line must be
     evaluate_dataset(quantized=)'s in process, and every K4 call of the
     eval's first batch against ``qgemm_plain``, while ``python -m
     double_yolo_kaist_torch.train --snow --clahe`` runs one epoch of 8
     pairs of phase 9's split beside them (``last``, ``results.txt``).
 15. slice 9 (``--only slice9`` runs it alone): K = 4 train steps
     replayed from one captured CUDA graph against 4 eager steps of MNv3
     (fp32, bs 2, 128x160, deterministic algorithms, TF32 off; SGD, Adam,
     Adam with accumulate=2, EMA on), params, BN state, optimizer state,
     EMA and metrics bit for bit; the A/B of K=1 eager against K=4
     captured (bf16 Adam, bs 8, 512x512, the flagship and MNv3): step ms
     (median dispatch ms / 4), images/s, device busy share, peak memory;
     the host ms a call of a registered operator (``torch.ops.dyk``) adds
     over its kernel's launch function (K4, K1); the exported artifacts
     at 512x640 (the flagship bf16 at bs 1 and 8, the flagship int8 chain
     from its quantized artifact and MNv3 bf16 at bs 8): each loads in a
     fresh process that imports no ``models`` / ``config`` / ``serving``
     module and replays the Predictor's frames to its packed rows bit for
     bit with the same K1-K4 launches a replay, request ms of artifact and
     Predictor in turns, export and load s; ``serve --exported`` answers
     one HTTP request as the artifact does in process; ``python -m
     double_yolo_kaist_torch.train --steps-per-dispatch 4`` one epoch of
     phase 9's split on the device-pool tier (the flagship) and the
     pinned-host tier (MNv3), their in-train evaluations launching K1, K2
     (and K3 on the flagship), beside ``python -m
     double_yolo_kaist_torch.bench --check-ap``, which must exit 0 with
     its fp and int8 gates passed (``_check_ap``).
 16. slice 10 (``--only dp`` runs it alone): data parallelism on the one
     card. (a) The flagship at full width, bf16 and int8 chain (both from
     phase 15's quantized artifact), on the mesh [cuda:0, cuda:0] at
     bucket 8: requests of 1, 3 and 8 frames bit-equal to one Predictor
     at bucket 4 on each half, K1 and K2 twice, K3 four times and K4
     twenty times (int8) a request; request ms of both. (b)
     ``evaluate_dataset(mesh=)`` of MNv3 on phase 9's split: in fp32 the
     single run's metrics within 1e-3 at batch 32, in bf16 its
     predictions bit for bit against the single run at batch 16 (the
     replicas' shape). (c) Two
     gloo ranks on cuda:0, spawned: MNv3 (fixture weights) float64, 2 SGD
     steps at a global bs 4 of 128x160, each rank within 1e-9 relative of
     one process at bs 4 on the card; the flagship bf16 at a global bs 8
     of 512x512, two ranks of 4: step ms, the gradient all-reduce's ms,
     peak GiB a rank (one card: not a scaling number). (d) NCCL at world
     size 1 in this process: phase 15's captured K = 4 steps (SGD) with
     the all-reduce inside the graph bit-equal to eager steps; MNv3's bf16
     K = 4 dispatch with the group against phase 15's without. (e)
     ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
     double_yolo_kaist_torch.train`` (DYK_DISTRIBUTED=1) one epoch; ``serve
     --dp 2`` exits naming the one card; ``serve --dp 1`` answers as the
     in-process Predictor; the two gloo ranks run ``Trainer.fit`` for an
     epoch of 8 pairs: rank 0 alone writes, equal params, the same
     in-train mAP, K1 and K2 launched by each rank's evaluation.
 17. slice 11: the 2-D data x space path on the one card. (a) Four gloo
     ranks on cuda:0 at mesh (2, 2) (this process is rank 0, three are
     spawned) against one process on the card at the whole global batch
     of 4: the tiny cfg's and the mini-flagship's fp32 eval forwards at
     64x64 (TF32 off) within rtol and atol 2e-4, K1 launched once by each
     rank's gathering forward; the tiny cfg's first fp32 SGD step, loss
     terms within 1e-4; the mini-flagship's first float64 step (params, BN
     state, momentum traces) within 1e-9 of each array's largest
     magnitude. (b) The flagship at full width: its fp32 2-D loss at
     global bs 4 of 256x320 within 1e-3 relative of one process; its bf16
     Adam step at global bs 4 of 512x640, one step after a warm-up: step
     ms, halo exchanges a step, their bytes and their ms (CUDA events
     around each), the gradient all-reduce's ms, peak GiB a rank (one
     card: not a scaling number). (c) ``python -m
     double_yolo_kaist_torch.dryrun 4`` exits 0 with its three lines (a
     job of its own: its four ranks are the card's four processes). (d)
     A Predictor on the mesh ["cuda:0"] * 4 of shape (2, 2): buckets
     (1, 8) become [2, 8], requests of 3 and 8 frames bit-equal to a 1-D
     mesh of 2, K1 and K2 once a replica.
 18. the tools: the whole zoo on the card and the port's tools. (a) Each
     of the 16 zoo models on ``bench.seeded_variables``: the folded fp32
     forward on the card (TF32 off) against the CPU's plain path on one
     seeded 64x96 pair (one frame for the single-stream models), raw
     heads within 1e-3 of their scale and decoded rows within 1e-3
     relative, then bf16 at 512x640 on the card, finite heads that move
     when the visible frame changes; K1 once a forward. Then each tool
     as a subprocess (``python -m double_yolo_kaist_torch.<tool>``, its
     launch counts printed after its run and held): (b) ``zoo_bench
     --int8`` on a leaky YOLOv3, the inception cfg and a MobileNet (the
     draws F7 repaired) at ``--iters 2``: a finite bf16 fps a row, an
     int8 chain fps where the chain plan is not empty and the empty plan
     marked where it is; (c) ``serving_bench`` on MNv3 and the flagship,
     bf16 and int8 (the flagship's int8 run as a subprocess, the other
     three through ``serving_bench.main`` in the job's process; K3 twice
     and K4 ten times a flagship int8 forward);
     (d) ``serve_loadtest --spawn --payload raw`` on MNv3 at concurrency
     1 and 4 (rps, p50 / p95 / p99, the batch histogram); (e)
     ``int8_ab`` on the flagship, chain and edge, one round; (f)
     ``train_wallclock`` on MNv3, one epoch; (g) ``real_model_overfit``
     on MNv3, 100 steps, deterministic, AP@0.5 at least 0.5 with its
     margin printed; (h) ``dataset_preview``, ``compare_clahe`` and
     ``plot_activations`` (both panels): their PNGs, or, where matplotlib
     is absent (the card's machine), a refusal naming it.
 19. slice 15, the training half of item 14 (``--only slice15``): (a) the
     train augment's matmul route (the default, as JAX's) on the card
     against the CPU, a batch of 8 at 512 from 512x640 frames with
     KAIST's hyp, from the same randoms, in fp32 (pixels within 1e-3 of
     255) and bf16 (within two bf16 ulps: an order of the two taps' sum
     may tip the resample's rounding by one, which the HSV stage's gains
     carry into its own), labels within 1e-5 and masks
     equal; chunked (chunk 3) against unchunked on the card within the
     same bounds; with the cutout and CLAHE, card against CPU: at most
     0.5% of the pixels beyond 1e-3 of 255 (as phase 14 holds the gather
     route), none by 2 levels; the data ms of each route and pixel dtype. (b) The
     flagship at full width, bf16, bs 8 at 512, K = 4 fused augment +
     train steps with ``double_buffer`` against without, under
     deterministic algorithms: metrics and every state leaf bit for bit,
     the ms of a dispatch of each. (c) A process started with
     ``DYK_SPLIT_CONCAT_CONV=1``: the flagship (seeded weights) served in
     bf16, a request of 8 frames launching K1 and K2 once and K3 twice;
     its forward with the rewrite (18 concats left unbuilt) and without
     it: in fp32 (TF32 off) their decoded outputs within 1e-4 relative by
     norm (an exact rewrite), and in bf16, replayed from captured graphs,
     the rewrite's output no further from the fp32 one than twice the
     plain bf16 output's distance from it (the partial convs round in
     bf16 where one conv rounded once). (d) A process started with ``DYK_S2D_TRAIN=1``: one fp32
     SGD step of the flagship (graph.init, bs 2 at 512x512, TF32 off,
     deterministic algorithms) eager and captured, in the s2d basis (the
     stem pair as an e3 entry and an x3 exit) and in the plain basis:
     losses within 1e-4 relative.

How the script runs. The process started as ``python3 chip_smoke.py``
never creates a context on the card: it builds the kernels, then starts
each group of phases as a job, ``chip_smoke.py --job NAME``, a process
of its own running groups of phases one after another (core: phases
3-10 and the references of 11's subprocesses, then int8aug: 14, train:
12-13, tools: 18 (a) and (c) in process, slice15: 19 (a) and (b); and
slice9: 15, then dp: 16; then spatial: 17 but (c), and dryrun: 17
(c)), runs every subprocess
whose check needs no card as a task (a thread of the script: phase 11's
entry points, 13's and 15's train runs, 14's snow train, 15's check-ap,
16's torchrun train and serve --dp, 18's tools, and 19 (c) and (d),
each a ``chip_smoke.py --check NAME`` process with its switch set), and
reads what each wrote. At most four processes hold a context on the card at once, a rank
counted as one: each holds one of four slots (flock'd files) from its
start to its end, taken by whoever starts it; two jobs run at once, a
job's subprocesses go before the tasks and the tasks go in TASKS' order;
spatial and dryrun run with the card to themselves; nvidia-smi's count
of processes on the card, read each second, must stay within the four.
Core times the kernels before anything else starts; what reads phase
9's split starts once core has written it. Every process
that imports the port prints its peak device memory as it exits (and
the script lists them all). No check depends on a time or a ratio of
times: times are printed. A check on a trained result runs under
deterministic algorithms from its seed and prints its margin. Servers
bind port 0 and name the port they bound. Each caught failure prints
``chip_smoke: FAILED <phase>: <type>: <message>`` (a wait that ran out:
"timed out after N s"), and a failed run ends with ``chip_smoke: failed
phases: ...`` and exit 1. A job past its own limit, or any job still
running 1080 s into the script, is stopped and reported.
The script makes itself the reaper of every process it starts, and of
those processes' own children (Linux's child subreaper). Before it exits,
whatever the outcome, it stops any of them still there, names each on its
standard error, and reaps them, so that nothing it started outlives it.
``python3 chip_smoke.py --only JOB [JOB ...]`` runs those jobs alone
(each makes phase 9's split for itself where it reads it) and prints no
result line. Each job prints its elapsed time after each phase. Then a
JSON line of kernel numbers, the nvidia-smi line, and last {"ok": true,
"device": {...}}.

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
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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


def _failed(phase: str, e: BaseException) -> None:
    """The line a caught failure prints on stdout: the phase, the
    exception's type and its message (a wait that ran out says so)."""
    if isinstance(e, subprocess.TimeoutExpired):
        msg = (f"{os.path.basename(str(e.cmd[0] if isinstance(e.cmd, list) else e.cmd))} "
               f"timed out after {e.timeout:.0f} s")
    else:
        msg = " ".join(str(e).split())[:600]
    print(f"chip_smoke: FAILED {phase}: {type(e).__name__}: {msg}",
          flush=True)


# ------------------------------------------------- the card's process budget

CUDA_SLOTS = 4        # CUDA processes on the card at once (a rank is one)
SLOTS_ENV = "DYK_SMOKE_SLOTS"


_JOBS_WAITING = threading.Event()    # the script's tasks hold back
_IS_SCRIPT = [False]       # this process is the script (it runs the tasks)
_TASK = threading.local()  # .priority: the task's place in TASKS
_WAITING = {}              # thread id: priority of a task waiting for a slot
_WAITING_LOCK = threading.Lock()


def _take_slots(n: int, wait: bool = True, first: bool = False) -> list:
    """Take ``n`` of the run's CUDA slots at once (all or none; waiting
    until ``n`` are free, or else returning [] at once): flock'd files in
    the directory that ``DYK_SMOKE_SLOTS`` names, shared by every process
    of the run. A job started by hand, outside the script, has no budget
    and takes nothing. Jobs go before tasks: a job process that waits
    leaves a ``want.*`` file there meanwhile, and the script's tasks take
    nothing while one is there or while a job waits to start
    (``_JOBS_WAITING``; the script's own take for it is ``first``)."""
    import fcntl
    import glob
    d = os.environ.get(SLOTS_ENV)
    if not d or n <= 0:
        return []
    want = None
    me = threading.get_ident()
    prio = getattr(_TASK, "priority", None)
    if prio is not None:
        with _WAITING_LOCK:
            _WAITING[me] = prio
    try:
        while True:
            if _IS_SCRIPT[0] and not first and (
                    _JOBS_WAITING.is_set()
                    or glob.glob(os.path.join(d, "want.*"))):
                time.sleep(0.1)
                continue
            if prio is not None:      # the first task in TASKS' order goes
                with _WAITING_LOCK:
                    ahead = min(_WAITING.values()) < prio
                if ahead:
                    time.sleep(0.1)
                    continue
            held = []
            for i in range(CUDA_SLOTS):
                fd = os.open(os.path.join(d, f"slot{i}"),
                             os.O_RDWR | os.O_CREAT)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    os.close(fd)
                    continue
                held.append(fd)
                if len(held) == n:
                    return held
            for fd in held:
                os.close(fd)
            if not wait:
                return []
            if want is None and not _IS_SCRIPT[0]:
                want = os.path.join(
                    d, f"want.{os.getpid()}.{threading.get_ident()}")
                open(want, "w").close()
            time.sleep(0.1)
    finally:
        if want is not None:
            os.remove(want)
        with _WAITING_LOCK:
            _WAITING.pop(me, None)


_SLOTS_LOCK = threading.Lock()


def _give_slots(held: list) -> None:
    with _SLOTS_LOCK:
        while held:
            os.close(held.pop())    # closing the file drops its lock


def _give_when_done(procs, held: list) -> None:
    """Give ``held`` back once every process of ``procs`` has ended (a
    thread of its own waits), whoever else waits for them and when."""
    def watch():
        for p in procs:
            subprocess.Popen.wait(p)
        _give_slots(held)

    threading.Thread(target=watch, daemon=True).start()


class _Proc(subprocess.Popen):
    """A subprocess that holds ``slots`` of the run's CUDA slots from just
    before its start until it ends (``slots=0``: one that never reaches
    the card). A slot never waits on a caller that is itself waiting for
    a slot."""

    def __init__(self, *args, slots: int = 1, **kw):
        t0 = time.perf_counter()
        held = _take_slots(slots)
        self.t_start = time.perf_counter()
        self.waited = self.t_start - t0
        try:
            super().__init__(*args, **kw)
        except BaseException:
            _give_slots(held)
            raise
        if held:
            _give_when_done([self], held)


def _sub(cmd, timeout=900, slots=1, **kw):
    """``subprocess.run`` (output captured as text) through :class:`_Proc`;
    a run past ``timeout`` is killed and raises TimeoutExpired. The result
    carries ``waited`` (s its slot took to come) and ``ran`` (s from the
    start)."""
    kw.setdefault("cwd", ROOT)
    kw.setdefault("env", dict(os.environ, PYTHONPATH=ROOT))
    with _Proc(cmd, slots=slots, stdout=subprocess.PIPE,
               stderr=subprocess.PIPE, text=True, **kw) as p:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise
    r = subprocess.CompletedProcess(cmd, p.returncode, out, err)
    r.waited, r.ran = p.waited, time.perf_counter() - p.t_start
    print(f"  [{_what(cmd)}: a slot after {r.waited:.1f} s, ran "
          f"{r.ran:.1f} s]", flush=True)
    return r


def _what(cmd) -> str:
    """A short name of a subprocess's command line."""
    mods = [x for x in cmd if x.startswith("double_yolo_kaist_torch.")]
    return mods[0].split(".", 1)[1] if mods else os.path.basename(cmd[-1])


# run a module of the port as its entry point, clearing the kernels'
# launch counts before and printing them after (its last stdout line);
# with "1" as its second argument, under utils.general.deterministic
RUNPY = ("import contextlib, json, runpy, sys\n"
         "from double_yolo_kaist_torch.ops import _build\n"
         "from double_yolo_kaist_torch.utils.general import deterministic\n"
         "mod, det = sys.argv[1], sys.argv[2] == '1'\n"
         "sys.argv = [mod] + sys.argv[3:]\n"
         "_build.launches.clear()\n"
         "try:\n"
         "    with deterministic() if det else contextlib.nullcontext():\n"
         "        runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
         "finally:\n"
         "    print('launches ' + json.dumps(dict(_build.launches)),\n"
         "          flush=True)\n")


def _runpy(module: str, *args, deterministic: bool = False) -> list:
    """argv of ``python -m double_yolo_kaist_torch.<module> *args`` through
    RUNPY."""
    return [sys.executable, "-c", RUNPY, f"double_yolo_kaist_torch.{module}",
            "1" if deterministic else "0", *map(str, args)]


def _launches_of(lines) -> dict:
    """The launch counts RUNPY printed."""
    got = [x for x in lines if x.startswith("launches ")]
    if not got:
        raise AssertionError("the run printed no launch counts")
    return json.loads(got[-1][len("launches "):])


PR_SET_CHILD_SUBREAPER = 36       # <linux/prctl.h>


def _become_subreaper() -> None:
    """Orphaned descendants (a tool's server, a launcher's ranks in a
    session of their own) are handed to this process instead of to init,
    so that :func:`_stop_leftovers` can find and reap them."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)
    except (OSError, AttributeError):
        pass


def _descendants(pid: int) -> list:
    """[(pid, state, command line)] of every live process under ``pid``,
    read from /proc."""
    kids, info = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        kids.setdefault(int(ppid), []).append(int(d))
        info[int(d)] = (state, cmd.strip())
    out, todo = [], [pid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append((c, *info[c]))
            todo.append(c)
    return out


def _reap() -> None:
    """Collect the exit of every child that has ended."""
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


def _stop_leftovers(limit_s: float = 60.0) -> None:
    """Stop and reap every process this script started that is still
    there, naming each (but zombies) on standard error."""
    named = set()
    deadline = time.monotonic() + limit_s
    while True:
        _reap()
        left = _descendants(os.getpid())
        if not left:
            return
        for pid, state, cmd in left:
            if state != "Z" and pid not in named:
                named.add(pid)
                print(f"chip_smoke: stopping a process left running: pid "
                      f"{pid} ({state}) {cmd[:300]}", file=sys.stderr,
                      flush=True)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if time.monotonic() > deadline:
            print(f"chip_smoke: {len(left)} processes did not end within "
                  f"{limit_s:.0f} s", file=sys.stderr, flush=True)
            return
        time.sleep(0.1)


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

    from double_yolo_kaist_torch.ops import act as L
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

    from double_yolo_kaist_torch.ops import act as L
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


def phase_bias_act(torch, ir, dev, launches):
    """K5 at the output of every conv of the flagship it finishes (all but
    the two stems: 145 mish, 35 leaky, 3 linear heads of 18 channels),
    bs 8 at 512x640: bf16 and fp32, each bit for bit its plain version
    (the eager ops); then one forward's 183 launches timed in bf16."""
    from double_yolo_kaist_torch.config.ir import infer_shapes
    from double_yolo_kaist_torch.ops import bias_act as K5
    from double_yolo_kaist_torch.ops import stem as K3
    bs = 8
    shapes = infer_shapes(ir, 512, 640)
    convs = [n for n in ir.nodes if n.kind == "conv" and n.groups == 1
             and not K3.matches(n)]
    acts = {a: sum(n.act == a for n in convs) for a in K5.ACTS}
    if len(convs) != 183 or acts != {"linear": 3, "leaky": 35, "mish": 145}:
        raise AssertionError(f"expected 183 convs for K5 (3 linear, 35 "
                             f"leaky, 145 mish), got {len(convs)}: {acts}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = {}                          # (C, H, W, act): the convs of it
    for n in convs:
        cases.setdefault((*shapes[n.index], n.act), []).append(n.index)
    n0 = launches["bias_act"]
    for dtype in (torch.bfloat16, torch.float32):
        for (c, h, w, act), layers in cases.items():
            y = (torch.randn((bs, c, h, w), generator=g, device=dev) * 4).to(
                dtype).contiguous(memory_format=torch.channels_last)
            b = torch.randn((c,), generator=g, device=dev).to(dtype)
            got, want = K5.bias_act(y, b, act), K5.plain(y, b, act)
            torch.cuda.synchronize()
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            differ = int((got.view(bits) != want.view(bits)).sum()) \
                if got.shape == want.shape else -1
            if differ or not got.is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(
                    f"K5 {dtype} {act} ({bs}, {c}, {h}, {w}) (layers "
                    f"{layers}): {differ} values differ from the eager ops")
    checked = launches["bias_act"] - n0
    print(f"K5 bs {bs}: {len(cases)} (C, H, W, act) cases of the "
          f"flagship's 183 convs ({acts}; C {min(k[0] for k in cases)}-"
          f"{max(k[0] for k in cases)}, the heads' 18 on the scalar walk), "
          f"bf16 and fp32: {checked} launches, every value equal to the "
          f"eager ops' bit for bit", flush=True)
    if checked != 2 * len(cases):
        raise AssertionError(f"K5 launched {checked} times for "
                             f"{2 * len(cases)} calls")

    # one forward's launches (each conv's own output and bias), bf16
    outs = []
    for n in convs:
        c, h, w = shapes[n.index]
        y = torch.randn((bs, c, h, w), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        outs.append((y, torch.randn((c,), generator=g, device=dev).to(
            torch.bfloat16), n.act))

    def kernel():
        for y, b, act in outs:
            K5.bias_act(y, b, act)

    def plain():
        for y, b, act in outs:
            K5.plain(y, b, act)

    ms = _time_ms(torch, kernel, iters=5, reps=5)
    device_ms = _device_ms(torch, kernel, "bias_act_kernel", iters=2)
    plain_ms = _time_ms(torch, plain, iters=2, reps=5)
    n_bytes = sum(2 * y.numel() * 2 + b.numel() * 2 for y, b, _ in outs)
    bound, by = _bound_ms(n_bytes, 0, BF16_OPS_PER_S)
    print(f"K5 bf16, one flagship forward's 183 launches at bs {bs} "
          f"(512x640 frames): kernel {ms:.4f} ms (device {device_ms} ms), "
          f"plain (the eager ops) {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}: {n_bytes / 1e9:.3f} GB at 3.35 TB/s)", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


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
                               mode="chain", int8_stems=False):
    """The int8 path of ``mode`` on the card against the port's int8 path on
    the CPU: the same quantized weights (for the Predictor's size, as it
    quantizes; with ``int8_stems``, the int8 stem pairs too), fp32
    compute, TF32 off, 2 frames of 64x96.

    1. Every quantized conv (K4 for the 1x1s, im2col + ``_int_mm`` for the
       3x3s) on the same input, its input in the CPU fp32 forward, and, for
       a conv fed s8 codes (after a spine add; a folded-in edge conv), on
       those codes too: fp outputs within 1e-5 relative + 1e-5,
       requantized s8 outputs within one step on under 1% of the
       elements. With ``int8_stems``, each int8 stem pair on its image
       too: s8 outputs (edge) by that rule, fp outputs within 1e-5
       relative + 1e-5 on 99% of the elements and within one mid step's
       worth (an ulp of mish can move a mid code by a step) on the rest.
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
    qv = Q.quantize(ir, qpred._folded_cpu, stats, mode=mode,
                    hw=(qpred.img_size, qpred.img_size),
                    int8_stems=int8_stems)
    ents = qv["params"]
    targets = {n.index for n in ir.nodes
               if "q" in ents.get(f"l{n.index}", {})}
    emits = {i for i in targets if {"out_inv_s", "out_inv"}
             & set(ents[f"l{i}"]["q"])}
    # conv -> the inverse scale of the codes its producer emits
    s8_fed = {i: "in_inv" for i in targets if "in_s" in ents[f"l{i}"]["q"]}
    s8_fed.update({int(k[1:]) + 1: int(k[1:]) for k, e in ents.items()
                   if "spine" in e})
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
        if int8_stems:
            _stems_card_vs_cpu(torch, ir, ents, qp, dev, xv, xl, mode)

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


def _stems_card_vs_cpu(torch, ir, ents, qp, dev, xv, xl, mode):
    """Each int8 stem pair (``quantize._stem8``) on its image, card
    against CPU, fp32: s8 outputs (edge's re-emission) within one step on
    under 1%; fp outputs within 1e-5 relative + 1e-5 on 99% of the
    elements and within one mid step's worth (1.1 x 127 x the second
    conv's weight scale x the mid activation's scale) on all."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q
    pairs = graph.stem_fusion_pairs(ir)
    for i, j in pairs.items():
        img = (xl if ir.nodes[i].takes_second_input else xv).permute(
            0, 3, 1, 2)
        outs = []
        for where in ("cpu", dev):
            fused = set()
            y = Q._stem8(ir, ir.nodes[i], img.to(where),
                         qp[str(where)]["params"][f"l{i}"], torch.float32,
                         fused)
            if y is None or fused != {j}:
                raise AssertionError(f"int8 {mode}: stem pair l{i} did not "
                                     f"run int8")
            outs.append((y.q if isinstance(y, Q.QVal) else y).cpu())
        ref, got = outs
        if ref.dtype == torch.int8:
            d = (got.int() - ref.int()).abs()
            share = float((d != 0).float().mean())
            ok, what = int(d.max()) <= 1 and share < 0.01, f"{share:.2e} s8"
        else:
            d = (got - ref).abs()
            e = ents[f"l{i}"]
            step = 1.1 * 127 * float(e["stem_q"]["sw2"].max()) * float(
                Q._inv_scale(e["amax_mid"])[0])
            share = float((d > 1e-5 * ref.abs() + 1e-5).float().mean())
            ok = share < 0.01 and float(d.max()) <= step
            what = f"{share:.2e} fp beyond 1e-5, max {float(d.max()):.3e}"
        print(f"int8 {mode} stem pair l{i}-l{j}, card vs CPU: {what}",
              flush=True)
        if not ok:
            raise AssertionError(f"int8 {mode}: stem pair l{i} on the card "
                                 f"disagrees with the CPU path")


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


def phase_eval(torch, dev, launches, mnv3_ir, flagship_ir, results, root,
               ready=None):
    """The offline evaluation path: evaluate_dataset on an 80-frame KAIST
    split written under ``root`` (MNv3 bf16, the flagship bf16 and int8),
    card against CPU, the tiers, the calibration artifact, launch counts
    per run, K1-K4 at the eval's shapes, and the entry point as a
    subprocess. ``ready`` is called once the split is labelled and MNv3's
    checkpoint written beside it. Returns (counts, kernel numbers, the
    MNv3 checkpoint directory it wrote)."""
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
    ck = os.path.join(root, "mnv3_ckpt")
    jx = weights.to_jax_variables(mnv3_vars)
    save_checkpoint(ck, params=jx["params"], bn_state=jx["state"])
    if ready is not None:
        ready()
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

    # 6. the entry point as a subprocess (on the checkpoint written above)
    data = os.path.join(root, "eval.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntest={splits['eval80']}\n")
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.evaluate",
           "--cfg", MNV3_NAME, "--weights", ck, "--data", data,
           "--img-size", str(EVAL_IMG), "--batch-size", str(EVAL_BS),
           "--cache-images", "disk"]
    t0 = time.perf_counter()
    r = _sub(cmd, timeout=600)
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
                "K3": "stem_wg_kernel", "K4": "qgemm_wg_kernel",
                "K5": "bias_act_kernel"}


def _eager_request(torch, pred, v, l):
    """A request on the eager path: the frames zero-padded into their bucket
    on the device, ``run_batch``, one fetch of the packed output,
    ``unpack_detections``."""
    from double_yolo_kaist_torch.export import unpack_detections
    from double_yolo_kaist_torch.serving import pack
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
                "K4": held.get("qgemm", 0), "K5": held.get("bias_act", 0)}
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

class _Server:
    """A ``serve`` subprocess started with ``--port 0``: it binds a port of
    the system's choosing (no other process can race it for a port picked
    before), named in its banner; up once that port's ``/healthz``
    answers ok. Its output (stdout and stderr) collects in ``lines``;
    :meth:`stop` ends it."""

    def __init__(self, cmd, what, limit=300):
        self.what, self.lines, self.url = what, [], None
        self.proc = _Proc(cmd + ["--port", "0"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
        t0 = self.proc.t_start
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        try:
            while True:
                if self.url is None:
                    on = [x for x in list(self.lines) if " on http://" in x]
                    if on:
                        self.url = "http://" + on[0].split(
                            " on http://", 1)[1].strip()
                if self.url is not None:
                    try:
                        if _http(f"{self.url}/healthz",
                                 timeout=2)["status"] == "ok":
                            break
                    except OSError:
                        pass
                if self.proc.poll() is not None:
                    raise AssertionError(
                        f"{what} exited {self.proc.returncode}:\n"
                        + "\n".join(self.lines[-30:]))
                if time.perf_counter() - t0 > limit:
                    raise AssertionError(f"{what}: timed out after "
                                         f"{limit} s coming up")
                time.sleep(0.3)
        except BaseException:
            self.stop()
            raise
        self.up_s = time.perf_counter() - t0
        print(f"{what}: bound {self.url}, up in {self.up_s:.1f} s (a slot "
              f"after {self.proc.waited:.1f} s)", flush=True)

    def _read(self):
        for x in self.proc.stdout:
            self.lines.append(x.rstrip("\n"))

    def stop(self) -> list:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        return self.lines


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


def _placed(pred, frames, buckets):
    """Each of ``frames`` served at every position of each bucket:
    [{(bucket, position): detections}] a frame. cuDNN's kxk convs may
    round a frame's output differently at some positions of a batch (the
    MicroBatcher check prints where), so a micro-batched answer equals its
    frame's answer at the position it was served at, not at position 0.
    Each call holds up to ``bucket`` frames, rotated one position a call,
    zero frames filling the rest."""
    out = [{} for _ in frames]
    for b in buckets:
        for c0 in range(0, len(frames), b):
            chunk = list(range(c0, min(c0 + b, len(frames))))
            for r in range(b):
                fv = np.zeros((b,) + frames[0][0].shape, np.uint8)
                fl = np.zeros_like(fv)
                at = {(k + r) % b: i for k, i in enumerate(chunk)}
                for p, i in at.items():
                    fv[p], fl[p] = frames[i]
                dets = pred(fv, fl)
                for p, i in at.items():
                    out[i][(b, p)] = dets[p]
    return out


def _matching_bucket(got, alone):
    """The keys of ``alone`` (buckets, or (bucket, position) pairs) whose
    detections equal ``got`` (boxes, scores, classes as lists or
    arrays)."""
    def equal(x, y):
        y = np.asarray(y)
        x = np.asarray(x, dtype=y.dtype)
        return x.size == y.size and np.array_equal(x.reshape(y.shape), y)

    return [b for b, want in alone.items()
            if all(equal(x, y) for x, y in zip(got, want))]


SERVE_BUCKETS = (1, 4, 16)     # serve's MicroBatcher buckets at --microbatch 16


def _serve_frames():
    """The 32 raw request frames of :func:`_serve_check`."""
    rng = np.random.default_rng(SEED + 11)
    return [tuple(rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
                  for _ in range(2)) for _ in range(32)]


def _entry_refs(torch, dev, mnv3_ir, mnv3_vars, root):
    """What phase 11's subprocesses (and phase 16's ``serve --dp 1``) are
    held against, made in process on the card: each of
    :func:`_serve_frames` served at every position of each of serve's
    buckets (:func:`_placed`) and :func:`_dp_frame` alone in each
    (``serve_alone.npz``), and the detections of every
    pair of the split as ``detect``'s Predictor serves it
    (``detect_counts.json``)."""
    import cv2

    from double_yolo_kaist_torch.detect import get_pair_paths
    from double_yolo_kaist_torch.serving import Predictor
    pred = Predictor(mnv3_ir, mnv3_vars, img_size=640,
                     batch_buckets=SERVE_BUCKETS, device=dev)
    out = {}
    for i, placed in enumerate(_placed(pred, _serve_frames(),
                                       SERVE_BUCKETS)):
        for (b, p), dets in placed.items():
            for k, x in zip(("boxes", "scores", "classes"), dets):
                out[f"{i}/{b}/{p}/{k}"] = np.asarray(x)
    v, l = _dp_frame()
    for b, dets in _alone(pred, v, l, SERVE_BUCKETS).items():
        for k, x in zip(("boxes", "scores", "classes"), dets):
            out[f"dp/{b}/{k}"] = np.asarray(x)
    np.savez(os.path.join(root, "serve_alone.npz"), **out)
    del pred
    src = os.path.join(root, "images", "eval")
    pred = Predictor(mnv3_ir, mnv3_vars, img_size=512, conf_thres=0.1,
                     iou_thres=0.5, batch_buckets=(1,), device=dev)
    counts = {}
    for name in sorted(os.listdir(src)):
        if name.endswith("_visible.jpg"):
            vp, lp = get_pair_paths(os.path.join(src, name))
            v = cv2.imread(vp)[None, :, :, ::-1]
            l = cv2.imread(lp)[None, :, :, ::-1]
            counts[name] = len(pred(v, l)[0][0])
    with open(os.path.join(root, "detect_counts.json"), "w") as f:
        json.dump(counts, f)
    print(f"entry refs: 32 frames at each position of buckets "
          f"{SERVE_BUCKETS}, "
          f"detect's counts of {len(counts)} pairs", flush=True)


def _serve_check(root):
    """``serve`` on MNv3 by its zoo name and phase 9's checkpoint: 32
    concurrent raw requests, each answer the detections of its frame served
    at one position of one of the buckets (:func:`_entry_refs`), and a
    mean micro-batch above 1 in ``/healthz``."""
    import base64
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.serve", "--cfg",
           MNV3_NAME, "--weights", os.path.join(root, "mnv3_ckpt"),
           "--img-size", "640", "--warmup-hw", "512", "640"]
    frames = _serve_frames()
    srv = _Server(cmd, "serve")
    url, up = srv.url, srv.up_s
    try:
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
        out = srv.stop()
    print(f"serve: up in {up:.1f} s ({out}); 32 "
          f"concurrent raw requests in {burst:.3f} s; micro-batch stats "
          f"{stats}", flush=True)
    ref = np.load(os.path.join(root, "serve_alone.npz"))
    matched = []
    for i, a in enumerate(answers):
        got = (a["boxes"], a["scores"], a["classes"])
        alone = {(b, p): tuple(ref[f"{i}/{b}/{p}/{k}"] for k in
                               ("boxes", "scores", "classes"))
                 for b in SERVE_BUCKETS for p in range(b)}
        matched.append(_matching_bucket(got, alone))
    print(f"serve: answers equal to the frame served in process, (bucket, "
          f"position) matched per request {matched}; detections "
          f"{[len(a['boxes']) for a in answers]}", flush=True)
    if not all(matched):
        raise AssertionError("serve answered other detections than the "
                             "in-process Predictor")
    if stats["frames"] != 32 or not stats["mean_batch"] > 1:
        raise AssertionError(f"serve did not coalesce: {stats}")
    return {}


def _detect_check(root):
    """``detect --no-figure`` on 8 pairs of phase 9's split: its count per
    image that of the in-process Predictor (:func:`_entry_refs`)."""
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.detect", "--cfg",
           MNV3_NAME, "--weights", os.path.join(root, "mnv3_ckpt"),
           "--source", os.path.join(root, "images", "eval"),
           "--max-images", "8", "--no-figure"]
    t0 = time.perf_counter()
    r = _sub(cmd, timeout=600)
    lines = r.stdout.splitlines()
    print(f"detect: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; stdout:\n  "
          + "\n  ".join(lines), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"detect failed:\n{r.stderr[-3000:]}")
    counts = {}
    for x in lines[:-2]:
        name, n = x.rsplit(": ", 1)
        counts[name] = int(n.split()[0])
    if len(counts) != 8 or not lines[-2].startswith("average fps: ") \
            or not lines[-1].startswith("miss rate"):
        raise AssertionError("detect did not print its lines")
    with open(os.path.join(root, "detect_counts.json")) as f:
        ref = json.load(f)
    want = {name: ref[name] for name in counts}
    print(f"detect: counts per image {counts}, in process {want}",
          flush=True)
    if counts != want:
        raise AssertionError("detect's counts differ from the in-process "
                             "Predictor's")
    return {}


BENCH_ITERS = 10     # replays a repeat of phase 11's bench legs (20 by
                     # default; the zoo sweep of PERF.md §5 runs 20)


def _bench_subprocess(leg):
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.bench", leg,
           "--iters", str(BENCH_ITERS)]
    t0 = time.perf_counter()
    r = _sub(cmd, timeout=600)
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
    threads, against each frame served at every position of each bucket
    (:func:`_placed`)."""
    import threading

    from double_yolo_kaist_torch.microbatch import MicroBatcher
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
    alone = _placed(pred, frames, pred.batch_buckets)
    matched = [_matching_bucket(g, a) for g, a in zip(got, alone)]
    moved = {b: [p for p in range(1, b) if any(
        _matching_bucket(a[(b, p)], {0: a[(b, 0)]}) == [] for a in alone)]
        for b in pred.batch_buckets if b > 1}
    print(f"MicroBatcher references: positions whose answers differ from "
          f"position 0's for some frame, per bucket: {moved}", flush=True)
    print(f"MicroBatcher, flagship bf16 graphs, 16 threads: {dt:.1f} ms, "
          f"stats {stats}, launches {counts['microbatch flagship bf16']}; "
          f"(bucket, position) whose detections of the frame each answer "
          f"equals {matched}", flush=True)
    if not all(matched):
        raise AssertionError("the MicroBatcher's answers differ from "
                             "unbatched requests")
    # a frame served in a bigger bucket against the same frame in bucket 1
    # (cuDNN may pick other kernels for another batch size). Near-equal
    # scores may swap places, so detections are matched as sets: each box
    # to the nearest box of the other answer, scores in sorted order.
    same_n = d_box = d_score = 0
    for g, a in zip(got, alone):
        want = a[(1, 0)]
        if len(g[0]) == len(want[0]):
            same_n += 1
            if len(g[0]):
                d = np.abs(g[0][:, None] - want[0][None]).max(-1)
                d_box = max(d_box, float(d.min(1).max()), float(d.min(0).max()))
                d_score = max(d_score, float(np.abs(
                    np.sort(g[1]) - np.sort(want[1])).max()))
    print(f"MicroBatcher answers against bucket 1 (unbatched): "
          f"{sum((1, 0) in m for m in matched)} of 16 bit-identical, "
          f"{same_n} "
          f"with the same count; every box within {d_box:.4f} px of one in "
          f"the other answer, sorted scores within {d_score:.6f}", flush=True)


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
    one batch that must lower its loss (a gate on a trained result: these
    steps run under deterministic algorithms, so the verdict repeats, and
    the margin is printed); MNv3's step at the same shape. Returns the
    numbers."""
    import contextlib

    from double_yolo_kaist_torch.models import graph, weights
    from double_yolo_kaist_torch.utils.general import deterministic
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    _step_card_vs_cpu(torch, dev, mnv3_ir, mnv3_vars)
    numbers = {}
    for label, ir, variables, n in (
            ("flagship", flagship_ir, graph.init(flagship_ir, SEED),
             TRAIN_FIT),
            ("MNv3", mnv3_ir, mnv3_vars, TRAIN_WARMUP + TRAIN_TIMED)):
        with (deterministic() if label == "flagship"
              else contextlib.nullcontext()):
            losses, timed, prof, peak = _time_steps(torch, ir, variables,
                                                    dev, label, n)
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
        if label == "flagship":
            print(f"train flagship: the last of {len(losses)} losses under "
                  f"the first by {losses[0] - losses[-1]:+.4f} (the gate: "
                  f"above 0; deterministic algorithms)", flush=True)
            if not losses[-1] < losses[0]:
                raise AssertionError(f"train {label}: {len(losses)} steps "
                                     f"on one batch did not lower the loss")
    print("train numbers: " + json.dumps(numbers), flush=True)
    return numbers


# ---------------------------------------------------------------- phase 13

def _run(cmd, what, timeout=900):
    t0 = time.perf_counter()
    r = _sub(cmd, timeout=timeout)
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


TRAIN_RUNS = "runs13"            # phase 13's entry-point runs, under the
                                 # run's directory
TRAIN_WAIT_S = 480


TRAIN_PAIRS = 32         # the entry-point train runs' split (phases 13, 15)


def _train_data(root, name="train"):
    """A .data file over the first TRAIN_PAIRS pairs of ``root``'s split
    (train, valid and test)."""
    with open(os.path.join(root, "eval80.txt")) as f:
        lines = f.read().splitlines()[:TRAIN_PAIRS]
    split = os.path.join(root, f"{name}.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    data = os.path.join(root, f"{name}.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")
    return data


def _train_base(root):
    """``python -m double_yolo_kaist_torch.train`` on the flagship with
    phase 13's data, size, batch and runs directory (the run's, beside the
    task's own directory ``root``)."""
    return [sys.executable, "-m", "double_yolo_kaist_torch.train", "--cfg",
            "Double-YOLOv4-Fshare-Global-CSE3", "--data", _train_data(root),
            "--img-size", str(TRAIN_HW), "--batch-size", str(TRAIN_BS),
            "--out-dir", os.path.join(os.path.dirname(root), TRAIN_RUNS)]


def _train_ema(root):
    """Phase 13's MNv3 fine-tuned with ``--ema``: one epoch of SGD from its
    trained weights (phase 9's checkpoint; Adam's first steps at lr 1e-3
    undo trained weights), so that its mAP is not 0 and evaluate's
    reproduction of it means something. The mAP is gated (above 0): the
    run is deterministic (RUNPY). Its checkpoint holds the JAX layout."""
    base = _train_base(root)
    runs = base[-1]
    _run(_runpy("train", "--cfg", MNV3_NAME, "--weights",
                os.path.join(root, "mnv3_ckpt"), *base[5:], "--epochs", "1",
                "--name", "mnv3", "--ema", "--sgd", deterministic=True),
         "train MNv3 --ema --sgd, 1 epoch from its trained weights "
         "(deterministic algorithms)")
    _check_checkpoint(os.path.join(runs, "mnv3", "last"), ema=True,
                      sgd=True)
    _mark(runs, "mnv3.done")
    return {}


def _train_resumed(root):
    """Phase 13's flagship runs: 1 epoch (``last``, ``best``,
    ``results.txt``), then ``--resume <out>/last --epochs 2`` (one more
    epoch); the checkpoint holds the JAX layout."""
    base = _train_base(root)
    out = os.path.join(base[-1], "t2")
    _run(base + ["--epochs", "1", "--name", "t2"], "train 1 epoch")
    for name in ("last", "best", "results.txt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"train: no {name} in {out}")
    if len(_results_lines(os.path.join(out, "results.txt"))) != 1:
        raise AssertionError("train: results.txt wants 1 epoch line")
    _run(base + ["--epochs", "2", "--name", "t2", "--resume",
                 os.path.join(out, "last")], "train resumed to 2 epochs")
    res = _results_lines(os.path.join(out, "results.txt"))
    with open(os.path.join(out, "last", "manifest.json")) as f:
        epoch = json.load(f)["epoch"]
    print(f"resume: results.txt {len(res)} lines, last checkpoint epoch "
          f"{epoch}", flush=True)
    if len(res) != 2 or not res[-1].startswith("epoch:1 ") or epoch != 1:
        raise AssertionError("train: the resume did not train epoch 1")
    _check_checkpoint(os.path.join(out, "last"), ema=False)
    _mark(base[-1], "t2.done")
    return {}


def _wait_for(path, what, limit=TRAIN_WAIT_S):
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"{what}: timed out after {limit} s")
        time.sleep(0.5)


def phase_train_entry(torch, dev, launches, flagship_ir, root, shared):
    """The trainer in process (flagship bf16, bs 8, one epoch with its
    evaluation, launch counts); then ``evaluate`` on the ``last`` of each
    of phase 13's entry-point runs (tasks of the script: :func:`_train_ema`,
    :func:`_train_resumed`, writing under ``shared``) at the trainer's
    batch size must print results.txt's last mAP and give the detections
    of the same checkpoint scored in process; MNv3's mAP must be above 0.
    Returns the launch counts of the in-process run."""
    from double_yolo_kaist_torch.config.parser import load_hyp
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.train.trainer import Trainer
    split = os.path.join(root, "eval80.txt")
    data = _train_data(root, "train13")
    hyp = load_hyp(os.path.join(ROOT, "configs", "hyp.scratch.4.yaml"))
    hyp["cls"] *= 1 / 80.0
    hyp["obj"] *= TRAIN_HW / 320.0
    # the main path in process: one epoch and its evaluation
    train_ds = KaistDataset(split, TRAIN_HW, TRAIN_BS, augment=True,
                            hyp=hyp, single_cls=True)
    val_ds = KaistDataset(split, TRAIN_HW, TRAIN_BS, hyp=hyp, rect=True,
                          single_cls=True)
    n_batches = len(train_ds) // TRAIN_BS
    n_eval = -(-len(val_ds) // TRAIN_BS)
    trainer = Trainer(flagship_ir, hyp, epochs=1, batch_size=TRAIN_BS,
                      img_size=TRAIN_HW, train_dataset=train_ds,
                      val_dataset=val_ds, out_dir=os.path.join(root, "runs"),
                      name="inproc", device=dev)
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
    torch.cuda.empty_cache()
    runs = os.path.join(shared, TRAIN_RUNS)

    def mnv3():
        _wait_for(os.path.join(runs, "mnv3.done"), "train MNv3 --ema")
        got = _evaluate_last(os.path.join(runs, "mnv3"), MNV3_NAME, data)
        print(f"train MNv3: mAP {got:.4f} after fine-tuning, over the gate "
              f"(above 0) by {got:+.4f}", flush=True)
        if got <= 0:
            raise AssertionError("train MNv3: mAP 0 after fine-tuning")

    def flagship():
        _wait_for(os.path.join(runs, "t2.done"), "train 1 epoch + resume")
        _evaluate_last(os.path.join(runs, "t2"),
                       "Double-YOLOv4-Fshare-Global-CSE3", data)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(mnv3), pool.submit(flagship)]:
            f.result()
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
    512 on the gather route (the matmul route's is phase 19 (a)), from the
    same drawn randoms on the card and on the CPU, and the card's data ms
    a step (host clock, the call synchronised)."""
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
    fn = P.make_train_augment_fn(src, 512, hyp, snowflake=True, clahe=True,
                                 resample="gather")
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


def _k4_per_forward(ir, mode, hw=None):
    """K4 launches a forward of ``mode`` quantized for ``hw``: its quantized
    1x1 convs (the s2d plan at ``hw`` sets spine's and edge's plans)."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q
    plan = graph.s2d_plan(ir, *hw) if hw and graph._S2D_REGION else {}
    if mode == "edge":
        targets = Q.plan_edges(ir, hw)[0]
    else:
        targets = Q.plan_quantization(ir, mode, plan)[0]
    return sum(Q._gemm_conv(ir.nodes[i]) for i in targets)


def _k4_hold_forward(torch, ir, qvars, mode, xv, xl, what, hw=None):
    """Every K4 call of one eager int8 forward of ``mode`` on the card, at
    the main path's operands (its M, weights, scales, activations and bf16
    output), against ``qgemm_plain`` on the same tensors, by
    :func:`_k4_hold`'s bounds: bf16 outputs equal, s8 within one step on
    under 5%; as many calls as the plan of ``mode`` at ``hw`` quantizes
    1x1 convs. Returns the number of calls held."""
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
    n_k4 = _k4_per_forward(ir, mode, hw)
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


def _int8_mode(torch, dev, launches, ir, variables, frames, mode, path):
    """The flagship in int8 ``mode``: a Predictor calibrates on two requests
    of 8 (its stats saved beside ``path``), quantizes for its size
    (``SERVED_HW``) and saves ``path``; requests of 1 and 8 from its CUDA
    graphs; then a Predictor from ``path`` must serve the same detections
    bit for bit from its own graphs; every K4 call of an eager bs-8 and
    bs-1 forward is held against its plain version; the request times and
    busy shares of the artifact's Predictor. Returns (launch counts of the
    two runs, timings, startup seconds, the in-process Predictor)."""
    from double_yolo_kaist_torch.serving import Predictor
    n_heads = len(ir.yolo_indices)
    n_k4 = _k4_per_forward(ir, mode, SERVED_HW)
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
    for n in (8, 1):
        with torch.inference_mode():
            fn, _, _ = pred._preprocess((512, 640))
            xv, xl = fn(*(torch.from_numpy(f).to(dev) for f in frames[n]))
        _k4_hold_forward(torch, ir, pred.qvars, mode, xv, xl,
                         f"flagship int8 {mode} bs {n}, 512x640", SERVED_HW)
    times = _medians(torch, loaded, frames, f"flagship int8 {mode}")
    del loaded
    return counts, times, {"load_s": t_load, "quantize_s": t_quant,
                           "k4_per_forward": n_k4}, pred


# the Predictors' size (img_size 640): what they quantize for; at 512x640
# the flagship's s2d plan and int8 plans are the same
SERVED_HW = (640, 640)
# the flagship's plans at JAX's defaults (tests/test_torch_s2d.py holds
# them against JAX): spine's int8 adds and targets, edge's targets and
# int8 edges; the s2d plan's convs
SERVED_PLANS = {"spine": (6, 88), "edge": (156, 233)}
SERVED_S2D_CONVS = 32


def _served_plan(torch, ir, mode, path):
    """F8's repair on the card's path: the plan of ``mode`` at the served
    size (spine: 6 int8 adds and 88 targets; edge: 156 targets and 233
    int8 edges), and its artifact (loaded, so checked by
    ``load_quantized``: every s2d kernel the transform of its plain one)
    holds the s2d kernels of all 32 planned convs, and spine's its 6
    adds."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q
    qv, _, hw = Q.load_quantized(path)
    plan = graph.s2d_plan(ir, *hw)
    if mode == "spine":
        targets, _, adds = Q._plan_with_spine(ir, mode, plan)
        got = (len(adds), len(targets))
    else:
        targets, int8_out, _ = Q.plan_edges(ir, hw)
        got = (len(targets), sum(int8_out.values()))
    ents = qv["params"].values()
    n_s2d = sum("wq_t" in e.get("q", {}) or "wt" in e.get("fp", {})
                for e in ents)
    n_adds = sum("spine" in e for e in ents)
    print(f"flagship int8 {mode} at {hw}: plan {got} (want "
          f"{SERVED_PLANS[mode]}); its artifact holds the s2d kernels of "
          f"{n_s2d} of {len(plan)} planned convs (checked on load) and "
          f"{n_adds} int8 adds", flush=True)
    if (got != SERVED_PLANS[mode] or len(plan) != SERVED_S2D_CONVS
            or n_s2d != len(plan)
            or n_adds != (got[0] if mode == "spine" else 0)):
        raise AssertionError(f"int8 {mode}: the served plan or its "
                             f"artifact is not JAX's default")


def _int8_stems(torch, dev, launches, ir, variables, frames, root):
    """The flagship in chain and in edge with int8 stem pairs
    (``quantize(int8_stems=True)``, JAX's ``_q_fused_stem``): each
    quantized for the served size from the stats of phase 14's edge run,
    saved as an artifact and served by a Predictor from it: requests of
    1 and 8, captured then replayed, with K3 launched 0 times (both stem
    pairs run int8) and K4 as the plan says; then the int8 path, stems
    included, on the card against the CPU
    (:func:`phase_flagship_int8_vs_cpu`). Returns the launch counts."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models import quantize as Q
    from double_yolo_kaist_torch.serving import Predictor
    stats, _ = Q.load_calibration(os.path.join(root,
                                               "flagship_edge_cal.npz"))
    folded = graph.fold_batchnorm(ir, variables)
    n_heads, counts = len(ir.yolo_indices), {}
    for mode in ("chain", "edge"):
        path = os.path.join(root, f"flagship_{mode}_int8stems.npz")
        Q.save_quantized(path, Q.quantize(ir, folded, stats, mode=mode,
                                          hw=SERVED_HW, int8_stems=True),
                         mode=mode, hw=SERVED_HW)
        launches.clear()
        pred = Predictor(ir, variables, img_size=SERVED_HW[0], device=dev,
                         int8=True, int8_mode=mode, quantized=path)
        q_fwd = {"stem_conv_s2": 0, "qgemm": _k4_per_forward(ir, mode,
                                                             SERVED_HW),
                 "decode_head": 1, "nms_indices": 1}
        print(f"flagship int8 {mode} with int8 stems, from its artifact: "
              f"{q_fwd['qgemm']} K4 convs and no K3 a forward", flush=True)
        for k, n in enumerate((1, 8, 1, 8)):     # capture, then replay
            _serve(torch, pred, frames, launches, n,
                   {k2: (2 if k < 2 else 1) * v for k2, v in q_fwd.items()},
                   n_heads)
        counts[f"int8 {mode} int8 stems"] = dict(launches)
        phase_flagship_int8_vs_cpu(torch, ir, variables, pred, dev,
                                   mode=mode, int8_stems=True)
        del pred
        torch.cuda.empty_cache()
    return counts


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


def _snow_train(root):
    """``python -m double_yolo_kaist_torch.train --snow --clahe``: one short
    epoch of MNv3 on the split's first 8 pairs (one step and their CLAHE'd
    evaluation): ``last`` and one line of ``results.txt``."""
    split = os.path.join(root, "eval8.txt")
    data = os.path.join(root, "snow.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")
    out = os.path.join(root, "runs", "snow")
    _run([sys.executable, "-m", "double_yolo_kaist_torch.train", "--cfg",
          MNV3_NAME, "--weights", os.path.join(root, "mnv3_ckpt"), "--data",
          data, "--img-size", str(TRAIN_HW), "--batch-size", str(TRAIN_BS),
          "--epochs", "1", "--sgd", "--snow", "--clahe", "--out-dir",
          os.path.dirname(out), "--name", "snow"],
         "train --snow --clahe, MNv3, 1 epoch of 8 pairs")
    for name in ("last", "results.txt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"train --snow --clahe: no {name}")
    if len(_results_lines(os.path.join(out, "results.txt"))) != 1:
        raise AssertionError("train --snow --clahe: results.txt wants 1 line")
    return {}


def phase_int8aug(torch, dev, launches, root, flagship_times):
    """Phase 14: CLAHE and the cutout on the card, the train augment with
    both, the flagship in int8 edge, spine and spineall (artifacts,
    graphs, K4 at the served operands, card vs CPU, spine's and edge's
    plans at the served size), timed beside phase 8's bf16 and chain
    (``flagship_times``), chain and edge with int8 stem pairs
    (:func:`_int8_stems`), and the calibrate / evaluate
    --int8-qvars entry points (``train --snow --clahe`` is a task of the
    script: :func:`_snow_train`). Needs phase 9's
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
        c, times[mode], startup[mode], pred = _int8_mode(
            torch, dev, launches, ir, variables, frames, mode, path)
        counts.update(c)
        if mode in SERVED_PLANS:
            _served_plan(torch, ir, mode, path)
        phase_flagship_int8_vs_cpu(torch, ir, variables, pred, dev,
                                   mode=mode)
        del pred
        torch.cuda.empty_cache()
    counts.update(_int8_stems(torch, dev, launches, ir, variables, frames,
                              root))
    summary = {m: {"median_ms": {n: round(t[n], 4) for n in (1, 8)},
                   "busy_ms": {n: round(t["busy"][n][0], 4) for n in (1, 8)},
                   "busy_share": {n: round(t["busy"][n][1], 4)
                                  for n in (1, 8)},
                   **({k: round(v, 4) for k, v in startup[m].items()}
                      if m in startup else {})}
               for m, t in times.items()}
    numbers["flagship"] = summary
    counts.update(_int8_entry_points(torch, dev, launches, root))
    print("int8aug numbers (bf16 and chain: phase 8's Predictors): "
          + json.dumps(numbers), flush=True)
    print(f"phase 14 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------- phase 15

K_STEPS = 4                  # steps a dispatch in the A/B
AB_WARMUP, AB_TIMED = 1, 2   # dispatches (K=4) or 4x as many steps (K=1);
                             # earlier figures in PERF.md timed 4
EXPORT_HW = (512, 640)
EXPORT_BS = 8


def _captured_equals_eager(torch, dev, mnv3_ir, mnv3_vars, group=None,
                           optimizers=(("SGD", True, 1), ("Adam", False, 1),
                                       ("Adam accumulate=2", False, 2))):
    """MNv3 (fixture weights), fp32, bs 2, 128x160: K_STEPS steps replayed
    from one captured graph against K_STEPS eager steps from the same
    state and batches, with SGD, Adam and Adam over accumulate=2 (EMA on):
    params, BN state, optimizer state, EMA and metrics bit for bit.
    ``group``: the steps' data-parallel group (phase 16: NCCL, its
    collectives captured in the graph)."""
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils.general import deterministic
    rng = np.random.default_rng(SEED + 15)
    batches = [_train_batch(torch, rng, 2, (128, 160), dev)
               for _ in range(K_STEPS)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    out = {}
    with deterministic():
        for name, sgd, acc in optimizers:
            runs = []
            for captured in (False, True):
                sched = OPT.cosine_epoch_schedule(TRAIN_LR, 0.1, 3, 2)
                tx = OPT.make_optimizer(TRAIN_HYP, sched, sgd=sgd,
                                        accumulate=acc)
                st = ST.create_train_state(mnv3_ir, SEED, tx, ema=True,
                                           variables=mnv3_vars, device=dev)
                multi = ST.make_multi_step(mnv3_ir, TRAIN_HYP, tx,
                                           compute_dtype=torch.float32,
                                           group=group)
                if captured:
                    st, m = multi(st, stacked)
                    if multi.captured.replays != K_STEPS:
                        raise AssertionError("the steps were not replayed")
                else:
                    st, m = ST._eager_steps(multi.step_fn, st,
                                            lambda i: batches[i], K_STEPS)
                leaves = [t.detach().cpu() for t in ST._state_leaves(st)]
                runs.append((leaves, {k: v.cpu() for k, v in m.items()}))
            (le, me), (lc, mc) = runs
            diff = sum(int(not torch.equal(a, b)) for a, b in zip(le, lc))
            mdiff = [k for k in me if not torch.equal(me[k], mc[k])]
            out[name] = {"leaves": len(le), "leaves_differing": diff,
                         "metrics_differing": mdiff,
                         "last_loss": float(mc["loss"][-1])}
            if diff or mdiff:
                raise AssertionError(f"captured {name} steps differ from "
                                     f"eager: {out[name]}")
    print(f"captured K={K_STEPS} steps equal eager steps (MNv3 fp32, "
          f"deterministic{', NCCL group' if group else ''}): "
          f"{json.dumps(out)}", flush=True)
    return out


def _ab_run(torch, ir, variables, dev, k, group=None):
    """bf16 Adam at bs TRAIN_BS, TRAIN_HW^2 on K_STEPS fixed batches: K=1
    eager steps, or K=k steps a dispatch replayed from one captured graph.
    Step ms = median dispatch ms / k (host clock; the metrics' fetch
    synchronises), images/s, device busy ms a step, peak memory.
    ``group``: the steps' data-parallel group (phase 16)."""
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    rng = np.random.default_rng(SEED + 16)
    batches = [_train_batch(torch, rng, TRAIN_BS, (TRAIN_HW, TRAIN_HW), dev)
               for _ in range(K_STEPS)]
    stacked = {n: torch.stack([b[n] for b in batches]) for n in batches[0]}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tx = OPT.make_optimizer(TRAIN_HYP, lambda c: torch.tensor(TRAIN_LR))
    state = [ST.create_train_state(ir, SEED, tx, variables=variables,
                                   device=dev)]
    if k == 1:
        fn = ST.make_train_step(ir, TRAIN_HYP, tx,
                                compute_dtype=torch.bfloat16)
        it = [0]

        def one():
            state[0], m = fn(state[0], batches[it[0] % K_STEPS])
            it[0] += 1
            return ST.metrics_to_host(m)
        n_warm, n_timed = AB_WARMUP * K_STEPS, AB_TIMED * K_STEPS
    else:
        fn = ST.make_multi_step(ir, TRAIN_HYP, tx,
                                compute_dtype=torch.bfloat16, group=group)

        def one():
            state[0], m = fn(state[0], stacked)
            return ST.metrics_to_host(m)
        n_warm, n_timed = AB_WARMUP, AB_TIMED
    t0 = time.perf_counter()
    one()                                  # K=k: warm-up and capture
    first_s = time.perf_counter() - t0
    ms, losses = [], []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        m = one()
        if i >= n_warm:
            ms.append((time.perf_counter() - t0) * 1e3 / k)
        losses.append(m["loss"])
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train K={k}: non-finite metrics {m}")
    peak = torch.cuda.max_memory_allocated()
    prof = {}
    for _ in range(3):                      # a blind window is tried again
        prof = _profile(torch, one)
        if prof:
            break
    busy = sum(prof.values()) / k
    med = statistics.median(ms)
    del fn, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"step_ms_median": med, "step_ms_min": min(ms),
            "step_ms_max": max(ms), "images_per_s": TRAIN_BS / med * 1e3,
            "busy_ms": busy, "busy_pct": 100 * busy / med,
            "peak_gib": peak / 2 ** 30, "first_call_s": first_s,
            "loss_first": losses[0], "loss_last": losses[-1]}


def _multi_step_ab(torch, dev, mnv3_ir, mnv3_vars, flagship_ir):
    from double_yolo_kaist_torch.models import graph
    numbers = {}
    for label, ir, variables in (
            ("flagship", flagship_ir, graph.init(flagship_ir, SEED)),
            ("MNv3", mnv3_ir, mnv3_vars)):
        for k in (1, K_STEPS):
            r = _ab_run(torch, ir, variables, dev, k)
            numbers[f"{label} K={k}"] = r
            print(f"train A/B {label} bf16 bs {TRAIN_BS} {TRAIN_HW}x"
                  f"{TRAIN_HW}, K={k} ({'captured' if k > 1 else 'eager'}): "
                  f"step {r['step_ms_median']:.3f} ms (min "
                  f"{r['step_ms_min']:.3f}, max {r['step_ms_max']:.3f}), "
                  f"{r['images_per_s']:.2f} images/s, busy "
                  f"{r['busy_ms']:.3f} ms a step ({r['busy_pct']:.1f}%), "
                  f"peak {r['peak_gib']:.3f} GiB, first call "
                  f"{r['first_call_s']:.2f} s", flush=True)
    return numbers


SLICE9_TRAIN_RUNS = {
    "flagship device pool": (["--cfg", FLAGSHIP_CFG, "--device-cache", "on"],
                             {}),
    "MNv3 pinned host": (["--cfg", MNV3_NAME, "--sgd"],
                         {"DYK_DEVICE_CACHE_GB": "0"})}


def _slice9_train(root, name):
    """``python -m double_yolo_kaist_torch.train --steps-per-dispatch 4``,
    one epoch on TRAIN_PAIRS pairs of phase 9's split, run ``name`` of
    SLICE9_TRAIN_RUNS: the
    flagship on the device-pool tier, MNv3 from phase 9's checkpoint on the
    pinned-host tier (no device pool: DYK_DEVICE_CACHE_GB=0); the entry
    point through RUNPY, which prints the kernel launches of the run.
    Returns them."""
    data = _train_data(root, "slice9")
    extra, env = SLICE9_TRAIN_RUNS[name]
    if "MNv3" in name:
        extra = extra + ["--weights", os.path.join(root, "mnv3_ckpt")]
    cmd = _runpy("train", "--data", data, "--img-size", TRAIN_HW,
                 "--batch-size", TRAIN_BS, "--epochs", 1,
                 "--steps-per-dispatch", K_STEPS, "--out-dir",
                 os.path.join(root, "k4runs"), "--name", name.split()[0],
                 *extra)
    r = _sub(cmd, env=dict(os.environ, PYTHONPATH=ROOT, **env))
    lines = r.stdout.splitlines()
    print(f"train --steps-per-dispatch {K_STEPS} ({name}): exit "
          f"{r.returncode}; last lines:\n  " + "\n  ".join(
              lines[-5:] + [x for x in r.stderr.splitlines()
                            if x.startswith("peak device memory")]),
          flush=True)
    if r.returncode != 0:
        raise AssertionError(f"train --steps-per-dispatch ({name}) "
                             f"failed:\n{(r.stdout + r.stderr)[-3000:]}")
    tier = "device image pool" if "flagship" in name else "host image pool"
    if not any(tier in x for x in lines):
        raise AssertionError(f"train ({name}) did not use the {tier}")
    got = _launches_of(lines)
    want = {"decode_head", "nms_indices"} | (
        {"stem_conv_s2"} if "flagship" in name else set())
    if not all(got.get(k, 0) > 0 for k in want):
        raise AssertionError(f"train ({name}): the in-train evaluation "
                             f"launched {got}, wants {sorted(want)}")
    return {f"train K={K_STEPS} {name}": got}


def _check_ap():
    """``python -m double_yolo_kaist_torch.bench --check-ap`` on the card:
    it must exit 0, its fp gate (the overfit's AP@0.5 > 0.5) and its int8
    gate (every mode within 0.05 of the fp AP, edge 0.15) passed. The
    check trains in true fp32 under deterministic algorithms, so its
    weights and verdict are the same on every run. Returns the numbers."""
    t0 = time.perf_counter()
    r = _sub([sys.executable, "-m", "double_yolo_kaist_torch.bench",
              "--check-ap"], timeout=900)
    lines = r.stdout.splitlines()
    traj = [x for x in lines if x.startswith("AP trajectory:")]
    int8 = [x for x in lines if x.startswith("int8[")]
    print(f"bench --check-ap: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s:\n  "
          + "\n  ".join(traj + int8 + lines[-1:]), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"bench --check-ap failed:\n"
                             f"{(r.stdout + r.stderr)[-3000:]}")
    res = json.loads(lines[-1])
    # the margins over its gates (bench.py: fp AP > 0.5, every int8 mode
    # within 0.05 of it, edge within 0.15)
    gaps = {}
    for x in int8:
        mode = x[len("int8["):].split(",")[0]
        ap, fp = (float(v.rstrip("%)")) / 100 for v in
                  (x.split("AP@0.5=")[1].split()[0],
                   x.split("(fp ")[1]))
        gaps[mode] = round((0.15 if mode == "edge" else 0.05)
                           - (fp - ap), 4)
    print(f"bench --check-ap margins: fp AP {res['value']:.4f} over its "
          f"gate 0.5 by {res['value'] - 0.5:+.4f}; int8 modes under their "
          f"bound by {gaps}", flush=True)
    return res


def _fresh_process_loads(paths, frames_npz, root):
    """Load every artifact of ``paths`` ({name: path}) in one fresh process
    that must import no ``models`` / ``config`` / ``serving`` module:
    capture each, replay the saved frames and write its packed rows
    (``<root>/fresh_<i>.npy``) and the launches a replay holds. Returns
    the process, started; :func:`_fresh_process_result` reads it."""
    code = (
        "import json, sys, time, numpy as np, torch\n"
        "from double_yolo_kaist_torch.export import ExportedPredictor\n"
        f"f = np.load({frames_npz!r})\n"
        "out = {}\n"
        f"for i, path in enumerate({list(paths.values())!r}):\n"
        "    t0 = time.perf_counter()\n"
        "    p = ExportedPredictor(path)\n"
        "    p.warmup()\n"
        "    ready = time.perf_counter() - t0\n"
        "    with torch.inference_mode():\n"
        "        p._ready().load(f['v'], f['l'])\n"
        "        packed = p._graph.run(len(f['v']))\n"
        f"    np.save({root!r} + f'/fresh_{{i}}.npy', packed)\n"
        "    out[path] = {'ready_s': ready, 'launches': p._graph.launches}\n"
        "    del p\n"
        "bad = sorted(m for m in sys.modules if m.startswith((\n"
        "    'double_yolo_kaist_torch.models', 'double_yolo_kaist_torch.config',"
        "\n    'double_yolo_kaist_torch.serving')))\n"
        "assert not bad, bad\n"
        "print('loaded ' + json.dumps(out))\n")
    return _Proc([sys.executable, "-c", code], cwd=ROOT,
                 env=dict(os.environ, PYTHONPATH=ROOT),
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _fresh_process_result(proc, paths, wants, root):
    """Each artifact's packed rows from the fresh process against the
    Predictor's (``wants``: {name: (packed rows, launches a replay)})."""
    text, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"loading the artifacts in a fresh process "
                             f"failed:\n{text[-3000:]}")
    res = json.loads([x for x in text.splitlines()
                      if x.startswith("loaded ")][-1][7:])
    out = {}
    for i, (name, path) in enumerate(paths.items()):
        got = np.load(os.path.join(root, f"fresh_{i}.npy"))
        want, launches = wants[name]
        if got.tobytes() != want.tobytes() or got.shape != want.shape:
            raise AssertionError(f"{name}: the fresh process's replay "
                                 f"differs from the Predictor's")
        if res[path]["launches"] != launches:
            raise AssertionError(f"{name}: launches a replay in the fresh "
                                 f"process {res[path]['launches']}, the "
                                 f"Predictor's {launches}")
        out[name] = res[path]["ready_s"]
    print("fresh process (no models / config / serving imported): every "
          "artifact's replay bit-equal to its Predictor's, the same "
          "launches; load + warm-up s " + json.dumps(out), flush=True)
    return out


def _serve_exported(path, frame):
    """``serve --exported`` answering one raw request over HTTP."""
    import base64
    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.serve",
           "--exported", path, "--img-size", "640"]
    srv = _Server(cmd, "serve --exported")
    url, up = srv.url, srv.up_s
    try:
        v, l = frame
        ans = _http(f"{url}/detect", json.dumps({
            "visible": base64.b64encode(v.tobytes()).decode(),
            "lwir": base64.b64encode(l.tobytes()).decode(),
            "encoding": "raw", "shape": list(v.shape[:2])}).encode())
    finally:
        lines = srv.stop()
    if not any(x.startswith("# --exported: ignoring --img-size")
               for x in lines):
        raise AssertionError(f"serve --exported printed {lines}")
    print(f"serve --exported: up in {up:.1f} s ({lines}); one request, "
          f"{len(ans['boxes'])} detections", flush=True)
    return ans


def _export_all(torch, dev, mnv3_ir, mnv3_vars, flagship_ir, root):
    """Export at bs EXPORT_BS, 512x640: the flagship bf16, the flagship
    int8 chain from its quantized artifact (calibrated on two requests of
    8) and MNv3 bf16. Returns ({name: (Predictor, int8)}, {name: path},
    {name: export s}, the frames)."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.export import export_serving_artifact
    from double_yolo_kaist_torch.serving import Predictor
    rng = np.random.default_rng(SEED + 17)
    frames = tuple(rng.integers(0, 256, (EXPORT_BS,) + EXPORT_HW + (3,),
                                dtype=np.uint8) for _ in range(2))
    np.savez(os.path.join(root, "export_frames.npz"), v=frames[0],
             l=frames[1])
    fvars = seeded_variables(flagship_ir, SEED)
    qpath = os.path.join(root, "flagship_chain_q.npz")
    cal = Predictor(flagship_ir, fvars, img_size=640, int8=True,
                    batch_buckets=(EXPORT_BS,), quantized=qpath, device=dev)
    for _ in range(2):                          # two calibration requests
        cal(*frames)
    del cal
    preds, paths, export_s = {}, {}, {}
    for name, ir, variables, kw in (
            ("flagship bf16", flagship_ir, fvars, {}),
            ("flagship int8 chain", flagship_ir, fvars,
             {"int8": True, "quantized": qpath}),
            ("MNv3 bf16", mnv3_ir, mnv3_vars, {})):
        pred = Predictor(ir, variables, img_size=640, device=dev,
                         batch_buckets=(EXPORT_BS,), **kw)
        if kw.get("int8") and pred.qvars is None:
            raise AssertionError("the int8 Predictor did not load its "
                                 "artifact")
        paths[name] = os.path.join(root, name.replace(" ", "_") + ".zip")
        t0 = time.perf_counter()
        export_serving_artifact(pred, EXPORT_HW, EXPORT_BS, paths[name])
        export_s[name] = time.perf_counter() - t0
        preds[name] = (pred, bool(kw.get("int8")))
    return preds, paths, export_s, frames


def _hold_exports(torch, launches, preds, paths, export_s, frames):
    """In process, each artifact of :func:`_export_all` loaded and warmed
    up: its graph replay equals its Predictor's on the same frames bit for
    bit with the same K1-K4 launches a replay, and requests of 1 and 8
    frames are timed on both in turns (the Predictor's bucket is EXPORT_BS
    too). Returns (numbers, launch counts, {name: (the Predictor's packed
    rows, launches a replay)}, MNv3's artifact's answer for frame 0
    alone)."""
    from double_yolo_kaist_torch.export import ExportedPredictor
    numbers, counts, wants, alone = {}, {}, {}, None
    for name, (pred, quant) in list(preds.items()):
        t0 = time.perf_counter()
        exp = ExportedPredictor(paths[name])
        exp.warmup()
        ready_s = time.perf_counter() - t0
        pred.warmup(EXPORT_HW, EXPORT_BS)
        g = pred._graph(EXPORT_BS, EXPORT_HW, quant)
        rows = {}
        for who in ("predictor", "exported"):
            launches.clear()
            with torch.inference_mode():
                if who == "exported":
                    exp._ready().load(*frames)
                    rows[who] = exp._graph.run(EXPORT_BS)
                else:
                    pred._stage(EXPORT_BS, EXPORT_HW).load(*frames)
                    rows[who] = g.run(EXPORT_BS)
            counts[f"{who} {name}"] = dict(launches)
        if rows["exported"].tobytes() != rows["predictor"].tobytes():
            raise AssertionError(f"{name}: the exported replay differs from "
                                 f"the Predictor's")
        if exp._graph.launches != g.launches:
            raise AssertionError(f"{name}: launches a replay "
                                 f"{exp._graph.launches} against the "
                                 f"Predictor's {g.launches}")
        wants[name] = (rows["predictor"], g.launches)
        ms = {}
        for n in (1, EXPORT_BS):
            sub = frames[0][:n], frames[1][:n]
            t = {"exported": [], "predictor": []}
            for _ in range(12):                 # in turns
                for who, fn in (("predictor", pred), ("exported", exp)):
                    t0 = time.perf_counter()
                    fn(*sub)
                    t[who].append((time.perf_counter() - t0) * 1e3)
            ms[n] = {who: statistics.median(v) for who, v in t.items()}
        numbers[name] = {"export_s": export_s[name], "ready_s": ready_s,
                         "launches_a_replay": g.launches,
                         "request_ms": ms,
                         "bytes": os.path.getsize(paths[name])}
        print(f"export {name} (bs {EXPORT_BS}): replay bit-equal to the "
              f"Predictor's, launches a replay {g.launches}; request ms "
              f"(exported / Predictor): 1 frame {ms[1]['exported']:.3f} / "
              f"{ms[1]['predictor']:.3f}, {EXPORT_BS} frames "
              f"{ms[EXPORT_BS]['exported']:.3f} / "
              f"{ms[EXPORT_BS]['predictor']:.3f}; export "
              f"{export_s[name]:.1f} s, load + warm-up {ready_s:.2f} s; "
              f"{numbers[name]['bytes'] / 1e6:.1f} MB", flush=True)
        if name == "MNv3 bf16":
            alone = exp(frames[0][:1], frames[1][:1])[0]
        del preds[name], pred, exp
        torch.cuda.empty_cache()
    return numbers, counts, wants, alone


def _op_dispatch_cost(torch, dev, flagship_ir):
    """Host ms a call of a registered operator adds over its kernel's
    launch function: K4 at the flagship's first chain shape (bs 8) and K1
    at the MNv3 heads, each called 200 times back to back through
    ``torch.ops.dyk`` and through the module's ``launch``, in turns, host
    clock to a synchronise."""
    from double_yolo_kaist_torch.ops import decode as K1
    from double_yolo_kaist_torch.ops import library  # noqa: F401
    from double_yolo_kaist_torch.ops import qgemm as K4
    rng = np.random.default_rng(SEED + 18)
    _, m, k, n, _ = _k4_shapes(flagship_ir, EXPORT_BS, EXPORT_HW)[0]
    c = _k4_case(torch, rng, dev, m, k, n, False)
    args = (c["x"], K4.pack_weights(c["w"]), c["scale"], c["bias"], "leaky",
            None, torch.bfloat16)
    heads = [(torch.randn((EXPORT_BS, 18, EXPORT_HW[0] // s,
                           EXPORT_HW[1] // s), device=dev,
                          dtype=torch.bfloat16)
              .contiguous(memory_format=torch.channels_last),
              [(10, 13), (16, 30), (33, 23)], s) for s in (8, 16, 32)]
    k1_args = K1.op_args(heads, "yolov4")
    hs, types = K1.op_heads(*k1_args)
    k1_out = K1.decode_heads(heads, "yolov4")
    calls = {"K4 op": lambda: torch.ops.dyk.qgemm(*args),
             "K4 launch": lambda: K4.launch(*args),
             "K1 op": lambda: torch.ops.dyk.decode_heads_into(k1_out,
                                                              *k1_args, 0),
             "K1 launch": lambda: K1.launch(hs, types, k1_out, 0)}
    ms = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    for _ in range(5):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / 200)
    med = {name: statistics.median(v) for name, v in ms.items()}
    out = {"K4 op_ms": med["K4 op"], "K4 launch_ms": med["K4 launch"],
           "K4 added_ms": med["K4 op"] - med["K4 launch"],
           "K1 op_ms": med["K1 op"], "K1 launch_ms": med["K1 launch"],
           "K1 added_ms": med["K1 op"] - med["K1 launch"],
           "K4 shape": [m, k, n]}
    print("registered-op dispatch, host ms a call (median of 5 x 200): "
          + json.dumps(out), flush=True)
    return out


class _DirectLaunch:
    """Within the block the wrappers launch their kernels without the
    registered operators (``torch.ops.dyk``), as the port did before them:
    the same checks and launch functions, no operator dispatch. For timing
    the dispatch's cost only."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from double_yolo_kaist_torch.ops import decode as K1
        from double_yolo_kaist_torch.ops import nms as NMS
        from double_yolo_kaist_torch.ops import nms_kernel as K2
        from double_yolo_kaist_torch.ops import qgemm as K4
        from double_yolo_kaist_torch.ops import stem as K3
        bf16 = self.torch.bfloat16

        def decode(heads, bf_type, out=None, row_offset=0):
            hs, types = K1.op_heads(*K1.op_args(list(heads), bf_type))
            if out is None:
                bs, no, rows = K1._check(K1._specs(hs), types)
                out = self.torch.empty((bs, sum(rows), no),
                                       dtype=self.torch.float32,
                                       device=hs[0][0].device)
                row_offset = 0
            return K1.launch(hs, types, out, row_offset)

        def nms(boxes, scores, iou_thres, max_det):
            K2.check(boxes, scores, max_det)
            return K2.launch(boxes, scores, float(iou_thres), int(max_det))

        def stem(x, weights, act):
            K3._check(x, weights, act)
            return K3.launch(x, weights, act)

        def qgemm(x, w, scale, bias, act, out_inv_s=None, out_dtype=bf16):
            K4._check(x, w, scale, bias, act, out_dtype)
            return K4.launch(x, w, scale, bias, act,
                             None if out_inv_s is None else float(out_inv_s),
                             out_dtype)

        self.saved = [(K1, "decode_heads", decode), (NMS, "nms_indices", nms),
                      (K3, "stem_conv_s2", stem), (K4, "qgemm", qgemm)]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, old, _ in self.saved:
            setattr(m, n, old)


def _eval_dispatch_ab(torch, dev, mnv3_ir, mnv3_vars, root):
    """Phase 9's eager MNv3 bf16 evaluation (the device pool, bs 32 at
    416x512) through the registered operators and with the kernels
    launched directly, in turns, 2 runs each: fps and their predictions,
    which must be the same."""
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    ds = KaistDataset(os.path.join(root, "eval80.txt"), EVAL_IMG, EVAL_BS,
                      rect=True)
    fps = {"ops": [], "direct": []}
    results = {}
    for _ in range(2):
        for how in ("ops", "direct"):
            if how == "direct":
                with _DirectLaunch(torch):
                    res = evaluate_dataset(mnv3_ir, mnv3_vars, ds,
                                           batch_size=EVAL_BS,
                                           device_cache=True, device=dev)
            else:
                res = evaluate_dataset(mnv3_ir, mnv3_vars, ds,
                                       batch_size=EVAL_BS, device_cache=True,
                                       device=dev)
            fps[how].append(res["fps"])
            results[how] = res
    _same_predictions(results["ops"], results["direct"],
                      "through the registered ops and direct launches")
    out = {how: {"median": statistics.median(v), "all": v}
           for how, v in fps.items()}
    print("eager eval MNv3 bf16 fps, registered ops against direct "
          "launches (in turns): " + json.dumps(out), flush=True)
    return out


def phase_slice9(torch, dev, launches, mnv3_ir, flagship_ir, root):
    """Phase 15: captured K steps against eager (bit for bit), the K=1 /
    K=4 train A/B of the flagship and MNv3, the registered ops' dispatch
    cost; then the three artifacts are exported, each is held and timed
    against its Predictor; last, the artifacts load in a fresh process
    with no model code while ``serve --exported`` answers. (``train
    --steps-per-dispatch 4`` on both residency tiers and ``bench
    --check-ap`` are tasks of the script: :func:`_slice9_train`,
    :func:`_check_ap`.) Needs phase 9's split and checkpoint under
    ``root``. Returns the main-path launch counts of its runs and its
    numbers."""
    from double_yolo_kaist_torch.models import weights
    t_phase = time.perf_counter()
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    numbers = {"equal": _captured_equals_eager(torch, dev, mnv3_ir,
                                               mnv3_vars)}
    numbers["ab"] = _multi_step_ab(torch, dev, mnv3_ir, mnv3_vars,
                                   flagship_ir)
    numbers["dispatch"] = _op_dispatch_cost(torch, dev, flagship_ir)
    numbers["eval_dispatch"] = _eval_dispatch_ab(torch, dev, mnv3_ir,
                                                 mnv3_vars, root)
    _stamp(t_phase, "phase 15 timings")
    counts = {}
    preds, paths, export_s, frames = _export_all(
        torch, dev, mnv3_ir, mnv3_vars, flagship_ir, root)
    _stamp(t_phase, "phase 15 exports")
    numbers["export"], held, wants, alone = _hold_exports(
        torch, launches, preds, paths, export_s, frames)
    counts.update(held)
    fresh = _fresh_process_loads(paths, os.path.join(root,
                                                     "export_frames.npz"),
                                 root)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        served = ex.submit(_serve_exported, paths["MNv3 bf16"],
                           (frames[0][0], frames[1][0]))
        numbers["fresh_ready_s"] = _fresh_process_result(fresh, paths,
                                                         wants, root)
        ans = served.result()
    if not _matching_bucket((ans["boxes"], ans["scores"], ans["classes"]),
                            {EXPORT_BS: alone}):
        raise AssertionError("serve --exported answered other detections "
                             "than the artifact in process")
    print("slice9 numbers: " + json.dumps(numbers), flush=True)
    print(f"phase 15 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, numbers


# ----------------------------------------------------------- phase 16: dp

DP_MESH_BS = 8                # the mesh's bucket: two replicas of 4
DP_F64_HW = (128, 160)        # the two-rank float64 step, MNv3, bs 4
DP_F64_BOUND = 1e-9           # relative, float64 summed in other orders
DP_TRAIN_PAIRS = 8            # the two ranks' Trainer split
DP_TIMEOUT = 600


def _dp_mesh_serving(torch, dev, launches, flagship_ir, fvars, qpath):
    """(a) The flagship at full width, bf16 and int8 chain (both sides
    from one quantized artifact), on the mesh [cuda:0, cuda:0] at bucket
    8: requests of 1, 3 and 8 frames bit-equal to a single-device
    Predictor at bucket 4 on each half, K1-K4 launched by each replica;
    the request ms of both. Returns the launch counts of the mesh runs."""
    from double_yolo_kaist_torch.parallel import mesh as M
    from double_yolo_kaist_torch.serving import Predictor
    mesh = M.make_mesh([dev, dev])
    rng = np.random.default_rng(SEED + 160)
    frames = {n: (rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8),
                  rng.integers(0, 256, (n, 512, 640, 3), dtype=np.uint8))
              for n in (1, 3, 8)}
    n_heads = len(flagship_ir.yolo_indices)
    half = DP_MESH_BS // 2
    counts, numbers = {}, {}
    for label, kw, per in (
            ("bf16", {}, {"qgemm": 0}),
            ("int8 chain", {"int8": True, "quantized": qpath},
             {"qgemm": 20})):
        single = Predictor(flagship_ir, fvars, img_size=640, device=dev,
                           batch_buckets=(half,), **kw)
        meshed = Predictor(flagship_ir, fvars, img_size=640, mesh=mesh,
                           batch_buckets=(DP_MESH_BS,), **kw)
        if meshed.batch_buckets != [DP_MESH_BS]:
            raise AssertionError(f"mesh buckets {meshed.batch_buckets}")
        if kw and (single.qvars is None or meshed.qvars is None):
            raise AssertionError("an int8 Predictor did not load its "
                                 "artifact")
        # the first request of a bucket captures its graphs (an eager run
        # each): not counted
        meshed(*frames[8])
        single(*frames[8])
        torch.cuda.synchronize()
        want = dict(per, stem_conv_s2=4, decode_head=2, nms_indices=2)
        launches.clear()                   # the mesh path's run
        outs = {n: _serve(torch, meshed, frames, launches, n, want, n_heads)
                for n in (1, 3, 8)}
        counts[f"dp mesh {label}"] = dict(launches)   # read just after it
        for n, got in outs.items():
            v, l = frames[n]
            ref = single(v[:half], l[:half])
            if n > half:
                ref += single(v[half:], l[half:])
            for i, ((b, s, c), (rb, rs, rc)) in enumerate(zip(got, ref)):
                if not (np.array_equal(b, rb) and np.array_equal(s, rs)
                        and np.array_equal(c, rc)):
                    raise AssertionError(f"mesh {label}: frame {i} of a "
                                         f"request of {n} differs from the "
                                         f"single-device half")
        for n in (1, 8):
            for name, pred in (("mesh", meshed), ("single", single)):
                ts = []
                for _ in range(12):
                    t0 = time.perf_counter()
                    pred(*frames[n])
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                numbers[f"{label} {name} request of {n} ms"] = {
                    "median": statistics.median(ts), "min": min(ts),
                    "max": max(ts)}
        del single, meshed
        torch.cuda.empty_cache()
    print(f"dp (a) mesh [cuda:0, cuda:0] at bucket {DP_MESH_BS} (two "
          f"replicas of {half}) against one Predictor at bucket {half}, "
          f"flagship 512x640: bit-equal; request ms {json.dumps(numbers)}",
          flush=True)
    return counts, numbers


def _dp_mesh_eval(torch, dev, launches, mnv3_ir, root):
    """(b) evaluate_dataset(mesh=) of MNv3 (fixture weights) on phase 9's
    split. bf16: at batch EVAL_BS its predictions equal, bit for bit,
    those of the single-device run at EVAL_BS / 2, the replicas' shape.
    fp32 (TF32 off): at batch EVAL_BS its metrics are within 1e-3 of the
    single-device run's at EVAL_BS (in bf16, cuDNN's kernels for the
    replicas' batch of 16 and the single run's 32 differ, and the AP with
    them: their difference is printed)."""
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    from double_yolo_kaist_torch.models import weights
    from double_yolo_kaist_torch.parallel import mesh as M
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    split = os.path.join(root, "eval80.txt")
    mesh = M.make_mesh([dev, dev])

    def run(bs, dtype, mesh=None):
        ds = KaistDataset(split, EVAL_IMG, bs, rect=True)
        kw = {"device": dev} if mesh is None else {"mesh": mesh}
        return evaluate_dataset(mnv3_ir, mnv3_vars, ds, batch_size=bs,
                                compute_dtype=dtype, **kw)

    def metric_diff(a, b):
        return max(abs(a["ap"] - b["ap"]), abs(a["lamr"] - b["lamr"]),
                   float(np.abs(np.asarray(a["coco_stats"])
                                - np.asarray(b["coco_stats"])).max()))

    half = run(EVAL_BS // 2, torch.bfloat16)
    single = run(EVAL_BS, torch.bfloat16)
    launches.clear()                       # the mesh evaluation's run
    meshed = run(EVAL_BS, torch.bfloat16, mesh)
    counts = dict(launches)                # read just after it
    batches = -(-EVAL_FRAMES // EVAL_BS)
    if counts.get("decode_head") != 2 * batches or \
            counts.get("nms_indices") != 2 * batches:
        raise AssertionError(f"mesh eval: {batches} batches on 2 replicas "
                             f"launched {counts}")
    same = set(meshed["predictions"]) == set(half["predictions"]) and all(
        np.array_equal(meshed["predictions"][k][0], half["predictions"][k][0])
        and np.array_equal(meshed["predictions"][k][1],
                           half["predictions"][k][1])
        for k in half["predictions"])
    with _NoTF32(torch):
        f32 = run(EVAL_BS, torch.float32)
        f32_mesh = run(EVAL_BS, torch.float32, mesh)
    d32, d16 = metric_diff(f32_mesh, f32), metric_diff(meshed, single)
    print(f"dp (b) mesh eval of MNv3 on {EVAL_FRAMES} pairs, batch "
          f"{EVAL_BS} on two replicas: bf16 predictions equal to the single "
          f"run at batch {EVAL_BS // 2}: {same}; fp32 AP {f32_mesh['ap']:.6f} "
          f"(single {f32['ap']:.6f}), max metric diff {d32:.2e} (bound "
          f"1e-3); bf16 against the single run at batch {EVAL_BS}: max "
          f"metric diff {d16:.2e}; launches {counts}; bf16 fps mesh "
          f"{meshed['fps']:.1f}, single {single['fps']:.1f}", flush=True)
    if d32 > 1e-3 or not same:
        raise AssertionError("the mesh evaluation differs from the "
                             "single-device one")
    return counts, {"fp32_max_metric_diff": d32,
                    "bf16_max_metric_diff_other_shape": d16,
                    "ap": meshed["ap"], "fps_mesh": meshed["fps"],
                    "fps_single": single["fps"]}


def _dp_f64_steps(torch, dev, ir, variables, group, rank, ranks):
    """Two SGD steps of MNv3 in float64 (params, state and optimizer too)
    at a global batch of 4, DP_F64_HW, on the rank's rows, under
    deterministic algorithms (a run repeats: train-mode BN over so few
    cells amplifies float64 rounding to ~1e-9); the metrics and the final
    state's leaves as numpy arrays."""
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils import tree as TR
    from double_yolo_kaist_torch.utils.general import deterministic
    v = TR.map_leaves(lambda t: t.to(dev, torch.float64), variables)
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           v["params"])
    tx = OPT.make_optimizer(TRAIN_HYP, OPT.cosine_epoch_schedule(
        TRAIN_LR, 0.1, 3, 2), sgd=True)
    st = ST.TrainState(params, v["state"], tx.init(params), 0, None)
    step = ST.make_train_step(ir, TRAIN_HYP, tx, compute_dtype=torch.float64,
                              group=group)
    rng = np.random.default_rng(SEED + 161)
    out = {}
    n = 4 // ranks
    for i in range(2):
        batch = _train_batch(torch, rng, 4, DP_F64_HW, dev)
        with deterministic():
            st, m = step(st, {k: x[rank * n:(rank + 1) * n]
                              for k, x in batch.items()})
        for k, x in m.items():
            out[f"step{i} {k}"] = x.detach().double().cpu().numpy()
    for j, t in enumerate(ST._state_leaves(st)):
        out[f"leaf {j:04d}"] = t.detach().double().cpu().numpy()
    return out


def _dp_flagship_steps(torch, dev, flagship_ir, group, rank, ranks):
    """The flagship at full width, bf16 Adam, a global batch of TRAIN_BS
    at TRAIN_HW^2 over the ranks: step ms (host clock, the metrics'
    fetch synchronises), the ms of one all-reduce of the gradients' flat
    buffer, the peak memory, and a digest of the params."""
    import hashlib

    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils import tree as TR
    torch.cuda.reset_peak_memory_stats(dev)
    tx = OPT.make_optimizer(TRAIN_HYP, lambda c: torch.tensor(TRAIN_LR))
    st = ST.create_train_state(flagship_ir, SEED, tx, device=dev,
                               variables=graph.init(flagship_ir, SEED))
    step = ST.make_train_step(flagship_ir, TRAIN_HYP, tx,
                              compute_dtype=torch.bfloat16, group=group)
    rng = np.random.default_rng(SEED + 162)
    batch = _train_batch(torch, rng, TRAIN_BS, (TRAIN_HW, TRAIN_HW), dev)
    n = TRAIN_BS // ranks
    mine = {k: x[rank * n:(rank + 1) * n] for k, x in batch.items()}
    ms, losses = [], []
    for i in range(3):
        t0 = time.perf_counter()
        st, m = step(st, mine)
        m = ST.metrics_to_host(m)
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    flat = torch.zeros(sum(p.numel() for p in TR.leaves(st.params)),
                       device=dev)
    ar = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(flat, group=group)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256()
    for p in TR.leaves(st.params):
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"step_ms_median": statistics.median(ms), "step_ms_min": min(ms),
            "step_ms_max": max(ms),
            "allreduce_ms_median": statistics.median(ar[1:]),
            "grad_floats": flat.numel(),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "losses": losses, "params_sha256": digest.hexdigest()}


def _dp_trainer(torch, dev, mnv3_ir, root, rank):
    """``Trainer.fit`` of MNv3 (phase 9's checkpoint) for one epoch of
    DP_TRAIN_PAIRS pairs of phase 9's split at a global batch of 4 under
    the group; rank r writes into ``root/dp_runs/r<r>``. Returns the
    kernels launched in the fit, the params' digest and the in-train
    mAP."""
    import hashlib

    from double_yolo_kaist_torch.common import DEFAULT_HYP
    from double_yolo_kaist_torch.config.parser import load_hyp
    from double_yolo_kaist_torch.data.dataset import KaistDataset
    from double_yolo_kaist_torch.models import weights
    from double_yolo_kaist_torch.ops import _build
    from double_yolo_kaist_torch.train.trainer import Trainer
    from double_yolo_kaist_torch.utils import tree as TR
    split = os.path.join(root, "dp8.txt")
    hyp = load_hyp(DEFAULT_HYP)
    hyp["cls"] *= 1 / 80.0
    hyp["obj"] *= TRAIN_HW / 320.0
    tr = Trainer(mnv3_ir, hyp, epochs=1, batch_size=4, img_size=TRAIN_HW,
                 train_dataset=KaistDataset(split, TRAIN_HW, 4, augment=True,
                                            hyp=hyp),
                 val_dataset=KaistDataset(split, TRAIN_HW, 4, hyp=hyp,
                                          rect=True),
                 device=dev, out_dir=os.path.join(root, "dp_runs"),
                 name=f"r{rank}",
                 variables=weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ))
    if tr.ranks != 2 or tr.rank != rank:
        raise AssertionError(f"Trainer saw {tr.ranks} ranks, rank {tr.rank}")
    _build.launches.clear()                # the rank's fit
    best = tr.fit()
    launched = dict(_build.launches)       # read just after it
    digest = hashlib.sha256()
    for p in TR.leaves(tr.state.params):
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"launches": launched, "params_sha256": digest.hexdigest(),
            "best_map": best}


def _dp_rank_main(rank: int, root: str) -> None:
    """One of the two gloo ranks of phase 16 (c) and (e), on cuda:0; its
    results go to ``root/dp_rank<r>.json`` and ``.npz``."""
    import torch

    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import weights
    from double_yolo_kaist_torch.parallel import multihost as MH
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    MH.maybe_initialize_distributed(
        coordinator=f"file://{os.path.join(root, 'gloo_rendezvous')}",
        num_processes=2, process_id=rank, backend="gloo")
    group = MH.data_group()
    mnv3_ir = compile_cfg(MNV3_CFG)
    f64 = _dp_f64_steps(torch, dev, mnv3_ir,
                        weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ),
                        group, rank, 2)
    np.savez(os.path.join(root, f"dp_rank{rank}.npz"), **f64)
    out = {"flagship": _dp_flagship_steps(torch, dev,
                                          compile_cfg(FLAGSHIP_CFG), group,
                                          rank, 2)}
    torch.cuda.empty_cache()
    out["trainer"] = _dp_trainer(torch, dev, mnv3_ir, root, rank)
    with open(os.path.join(root, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _spawn_ranks(main: str, ranks, root: str, tag: str) -> list:
    """Start ``chip_smoke.<main>(r, root)`` for each r of ``ranks``, the
    output of rank r to ``root/<tag><r>.log``. The ranks' CUDA slots are
    taken together before the first starts and given back once all have
    ended."""
    code = ("import sys; import chip_smoke; "
            f"chip_smoke.{main}(int(sys.argv[1]), sys.argv[2])")
    held = _take_slots(len(ranks))
    procs = []
    try:
        for r in ranks:
            with open(os.path.join(root, f"{tag}{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(r), root], cwd=ROOT,
                    env=dict(os.environ, PYTHONPATH=ROOT), stdout=log,
                    stderr=subprocess.STDOUT))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        _give_slots(held)
        raise
    _give_when_done(procs, held)
    return procs


def _dp_spawn_ranks(root):
    """Start the two gloo ranks of (c) and (e) (:func:`_dp_rank_main`),
    their output to ``root/dp_rank<r>.log``."""
    return _spawn_ranks("_dp_rank_main", range(2), root, "dp_rank")


def _dp_two_ranks(torch, dev, mnv3_ir, root, procs):
    """(c) and (e): the two gloo ranks on cuda:0 (``procs``), held against
    one process at the whole batch on the card (float64 MNv3 steps, run
    here while they run), each other (params) and what they wrote. Every
    rank has ended when this returns."""
    from double_yolo_kaist_torch.models import weights
    try:
        one = _dp_f64_steps(torch, dev, mnv3_ir,
                            weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ),
                            None, 0, 1)
        for p in procs:
            p.wait(timeout=DP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"dp_rank{r}.log")) as f:
                text = f.read()
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    # relative as _leaf_err takes it: ||a - b|| / ||b|| an array; the
    # largest element error over the array's largest magnitude beside it
    worst, worst_el = (0.0, ""), (0.0, "")
    for r in range(2):
        with np.load(os.path.join(root, f"dp_rank{r}.npz")) as z:
            got = {k: z[k] for k in z.files}
        if sorted(got) != sorted(one):
            raise AssertionError("the ranks' float64 results have other "
                                 "keys than one process's")
        for k, want in one.items():
            if not np.abs(want).max(initial=0.0) > 0:
                continue
            rel = float(np.linalg.norm(got[k] - want) / np.linalg.norm(want))
            el = float(np.abs(got[k] - want).max() / np.abs(want).max())
            worst = max(worst, (rel, f"rank {r} {k}"))
            worst_el = max(worst_el, (el, f"rank {r} {k}"))
    print(f"dp (c) two gloo ranks on cuda:0 (MNv3 fixture weights, "
          f"float64, global bs 4 at {DP_F64_HW[0]}x{DP_F64_HW[1]}, 2 SGD "
          f"steps) against one process at bs 4 on the card, {len(one)} "
          f"arrays: worst relative error {worst[0]:.3e} ({worst[1]}; bound "
          f"{DP_F64_BOUND}); worst element over the array's largest "
          f"{worst_el[0]:.3e} ({worst_el[1]})", flush=True)
    failed = [] if worst[0] <= DP_F64_BOUND else [
        "two gloo ranks disagree with one process"]
    res = []
    for r in range(2):
        with open(os.path.join(root, f"dp_rank{r}.json")) as f:
            res.append(json.load(f))
    fl = [x["flagship"] for x in res]
    print("dp (c) flagship bf16, global bs 8 at 512x512 over two gloo "
          "ranks of 4 on ONE card (a correctness run, not a scaling "
          "number): " + json.dumps(fl), flush=True)
    if fl[0]["params_sha256"] != fl[1]["params_sha256"] or not all(
            np.isfinite(x["losses"]).all() for x in fl):
        raise AssertionError("the flagship's ranks diverged")
    tr = [x["trainer"] for x in res]
    runs = os.path.join(root, "dp_runs")
    wrote = {r: sorted(os.listdir(os.path.join(runs, f"r{r}")))
             for r in range(2)}
    print(f"dp (e) Trainer.fit under two gloo ranks, MNv3, "
          f"{DP_TRAIN_PAIRS} pairs, one epoch: {json.dumps(tr)}; files "
          f"written {wrote}", flush=True)
    if tr[0]["params_sha256"] != tr[1]["params_sha256"]:
        raise AssertionError("the Trainer's ranks hold other params")
    if tr[0]["best_map"] != tr[1]["best_map"]:
        raise AssertionError("the ranks report other in-train mAPs")
    if not {"last", "results.txt"} <= set(wrote[0]) or {
            "last", "results.txt", "best"} & set(wrote[1]):
        raise AssertionError(f"rank 0 alone must write: {wrote}")
    for r, x in enumerate(tr):
        if not (x["launches"].get("decode_head", 0) > 0
                and x["launches"].get("nms_indices", 0) > 0):
            raise AssertionError(f"rank {r}'s in-train evaluation launched "
                                 f"{x['launches']}")
    if failed:
        raise AssertionError(failed[0])
    return {f"dp trainer rank {r}": x["launches"]
            for r, x in enumerate(tr)}, {"flagship": fl, "trainer": tr,
                                         "f64_worst_rel": worst[0],
                                         "f64_worst_element": worst_el[0]}


def _dp_nccl(torch, dev, mnv3_ir, ab_without):
    """(d) NCCL with world size 1 in this process: K_STEPS captured steps
    with the gradient all-reduce in the graph equal K_STEPS eager steps
    (phase 15's check, with the group); the K_STEPS dispatch of MNv3 bf16
    with the group against phase 15's without one (``ab_without``, or
    timed here)."""
    from double_yolo_kaist_torch.models import weights
    dist = torch.distributed
    mnv3_vars = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    # a file rendezvous: no port to pick (NCCL binds its own)
    rdzv = os.path.join(tempfile.mkdtemp(prefix="dyk_nccl_"), "rendezvous")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        # one optimizer: the group's collectives are the same in each
        equal = _captured_equals_eager(torch, dev, mnv3_ir, mnv3_vars,
                                       group=group,
                                       optimizers=(("SGD", True, 1),))
        with_group = _ab_run(torch, mnv3_ir, mnv3_vars, dev, K_STEPS,
                             group=group)
    finally:
        dist.destroy_process_group()
    if ab_without is None:
        ab_without = _ab_run(torch, mnv3_ir, mnv3_vars, dev, K_STEPS)
    print(f"dp (d) NCCL world size 1: captured K={K_STEPS} steps with the "
          f"all-reduce in the graph equal eager steps; MNv3 bf16 bs "
          f"{TRAIN_BS} {TRAIN_HW}x{TRAIN_HW} K={K_STEPS} step "
          f"{with_group['step_ms_median']:.3f} ms with the group (busy "
          f"{with_group['busy_pct']:.1f}%) against "
          f"{ab_without['step_ms_median']:.3f} ms without (busy "
          f"{ab_without['busy_pct']:.1f}%)", flush=True)
    return {"equal": equal, "with_group": with_group,
            "without_group": ab_without}


def _dp_torchrun(root):
    """(e) ``python -m torch.distributed.run --nproc_per_node 1 -m
    double_yolo_kaist_torch.train`` with DYK_DISTRIBUTED=1: one epoch of
    MNv3 on DP_TRAIN_PAIRS pairs, its ``last`` and results.txt."""
    _dp_split(root)
    r = _sub([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "1", "-m", "double_yolo_kaist_torch.train",
              "--cfg", MNV3_NAME, "--weights",
              os.path.join(root, "mnv3_ckpt"), "--data",
              os.path.join(root, "dp8.data"), "--img-size", str(TRAIN_HW),
              "--batch-size", "4", "--epochs", "1", "--out-dir",
              os.path.join(root, "dp_torchrun"), "--name", "mnv3"],
             timeout=DP_TIMEOUT,
             env=dict(os.environ, PYTHONPATH=ROOT, DYK_DISTRIBUTED="1"))
    text = r.stdout + r.stderr
    print(f"dp (e) torch.distributed.run --nproc_per_node 1 -m "
          f"double_yolo_kaist_torch.train: exit {r.returncode}; last "
          f"lines:\n  " + "\n  ".join(r.stdout.splitlines()[-3:]),
          flush=True)
    out_dir = os.path.join(root, "dp_torchrun", "mnv3")
    if r.returncode != 0 or not os.path.exists(
            os.path.join(out_dir, "last", "manifest.json")) or \
            len(_results_lines(os.path.join(out_dir, "results.txt"))) != 1:
        raise AssertionError(f"train under torch.distributed.run failed:\n"
                             f"{text[-3000:]}")
    return {}


def _dp_frame():
    """The raw frame ``serve --dp 1`` answers (:func:`_dp_entry_points`)."""
    rng = np.random.default_rng(SEED + 163)
    return tuple(rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
                 for _ in range(2))


def _dp_entry_points(root):
    """(e) the serving entry points as subprocesses: ``serve --dp 2``
    (must exit naming the one visible card) and ``serve --dp 1``, whose
    answer to one request must be the frame's served alone in one of the
    buckets (core's references, :func:`_entry_refs`)."""
    import base64
    env = dict(os.environ, PYTHONPATH=ROOT)
    serve = [sys.executable, "-m", "double_yolo_kaist_torch.serve", "--cfg",
             MNV3_NAME, "--weights", os.path.join(root, "mnv3_ckpt"),
             "--img-size", "640", "--warmup-hw", "512", "640"]
    refused = _sub(serve + ["--dp", "2"], env=env, timeout=300, slots=0)
    last = (refused.stdout + refused.stderr).strip().splitlines()[-1:]
    print(f"dp (e) serve --dp 2: exit {refused.returncode}, {last}",
          flush=True)
    if refused.returncode == 0 or \
            "--dp 2: only 1 device(s) visible" not in refused.stderr:
        raise AssertionError("serve --dp 2 did not refuse the one card")
    v, l = _dp_frame()
    srv = _Server(serve + ["--dp", "1"], "serve --dp 1")
    url = srv.url
    try:
        answer = _http(f"{url}/detect", json.dumps({
            "visible": base64.b64encode(v.tobytes()).decode(),
            "lwir": base64.b64encode(l.tobytes()).decode(),
            "encoding": "raw", "shape": [512, 640]}).encode())
    finally:
        out = srv.stop()
    print(f"dp (e) serve --dp 1: up in {srv.up_s:.1f} s, "
          f"{[x for x in out if 'data-parallel' in x]}, "
          f"{len(answer['boxes'])} detections", flush=True)
    ref = np.load(os.path.join(root, "serve_alone.npz"))
    alone = {b: tuple(ref[f"dp/{b}/{k}"] for k in
                      ("boxes", "scores", "classes"))
             for b in SERVE_BUCKETS}
    if not _matching_bucket((answer["boxes"], answer["scores"],
                             answer["classes"]), alone):
        raise AssertionError("serve --dp 1 answered other detections than "
                             "the in-process Predictor")
    return {}


def _dp_split(root):
    """DP_TRAIN_PAIRS pairs of phase 9's split and a data file for them."""
    with open(os.path.join(root, "eval80.txt")) as f:
        lines = f.read().splitlines()[:DP_TRAIN_PAIRS]
    split = os.path.join(root, "dp8.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "dp8.data"), "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\ntest={split}\n")


def _chain_artifact(torch, dev, flagship_ir, fvars, root):
    """The flagship's int8 chain artifact of phase 15 (calibrated on two
    requests of 8), made here when phase 15 did not run."""
    from double_yolo_kaist_torch.serving import Predictor
    qpath = os.path.join(root, "flagship_chain_q.npz")
    if not os.path.exists(qpath):
        rng = np.random.default_rng(SEED + 17)
        frames = tuple(rng.integers(0, 256, (EXPORT_BS,) + EXPORT_HW + (3,),
                                    dtype=np.uint8) for _ in range(2))
        cal = Predictor(flagship_ir, fvars, img_size=640, int8=True,
                        batch_buckets=(EXPORT_BS,), quantized=qpath,
                        device=dev)
        for _ in range(2):
            cal(*frames)
    return qpath


def phase_dp(torch, dev, launches, mnv3_ir, flagship_ir, root,
             ab_without=None):
    """Phase 16: data parallelism on one card. The two gloo ranks of (c)
    and (e) start first and run beside (b) and the one-process float64
    reference; then (a) and (d) run alone. (e)'s entry points are tasks of
    the script: :func:`_dp_torchrun`, :func:`_dp_entry_points`. Each part
    runs even when one before it failed; the phase fails if any did.
    Needs phase 9's split and checkpoint under ``root``. Returns (launch
    counts of its main-path runs, numbers)."""
    from double_yolo_kaist_torch.bench import seeded_variables
    t_phase = time.perf_counter()
    smi = _smi_line()
    _dp_split(root)
    numbers, counts, failed = {"card": smi}, {}, []

    def part(name, fn):
        try:
            c, numbers[name] = fn()
            counts.update(c)
        except Exception as e:             # noqa: BLE001 — report, go on
            traceback.print_exc()
            _failed(f"dp/{name}", e)
            failed.append(name)
        _stamp(t_phase, f"phase 16 {name}")

    def mesh_eval():
        c, n = _dp_mesh_eval(torch, dev, launches, mnv3_ir, root)
        return {"dp mesh eval": c}, n

    def mesh_serving():
        fvars = seeded_variables(flagship_ir, SEED)
        qpath = _chain_artifact(torch, dev, flagship_ir, fvars, root)
        return _dp_mesh_serving(torch, dev, launches, flagship_ir, fvars,
                                qpath)

    # the ranks run beside (b): their step times are the one card's under
    # that load, not a scaling number
    procs = _dp_spawn_ranks(root)
    part("(b)", mesh_eval)
    part("(c) and (e)'s ranks",
         lambda: _dp_two_ranks(torch, dev, mnv3_ir, root, procs))
    torch.cuda.empty_cache()
    part("(a)", mesh_serving)
    torch.cuda.empty_cache()
    part("(d)", lambda: ({}, _dp_nccl(torch, dev, mnv3_ir, ab_without)))
    print(f"dp numbers ({smi}; one card: no multi-card number): "
          + json.dumps(numbers), flush=True)
    print(f"phase 16 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 16 parts failed: {failed}")
    return counts, numbers


# ------------------------------------------------ phase 17: data x space

SP_MESH = (2, 2)              # (data, space): four gloo ranks on cuda:0
SP_TINY_HW = 64
SP_FLAGSHIP_F32_HW = (256, 320)
SP_FLAGSHIP_HW = (512, 640)
SP_BS = 4                     # global batch of every 2-D step and forward
SP_F64_BOUND = 1e-9           # relative to each array's largest magnitude
SP_FWD_TOL = 2e-4             # rtol and atol, tests/test_spatial_sharding.py
SP_LOSS_TOL = 1e-4            # absolute, the tiny step's loss terms
SP_FLAGSHIP_LOSS_REL = 1e-3
SP_HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0,
          "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
          "momentum": 0.937, "weight_decay": 0.05, "lr0": 0.01, "lrf": 0.1}
# the tiny step's boxes (cx, cy) an image: the bands split at cy 0.5,
# where one box sits, and the bands hold different match counts
SP_BOXES = ([(0.3, 0.2), (0.6, 0.5)], [(0.5, 0.7)],
            [(0.4, 0.1), (0.2, 0.3), (0.7, 0.8)], [(0.55, 0.45)])
SP_TIMEOUT = 600


def _sp_tiny_ir():
    from double_yolo_kaist_torch.config.ir import compile_cfg
    return compile_cfg(os.path.join(ROOT, "tests", "fixtures",
                                    "tiny_dyolov3.cfg"), yolo_strides=[8, 4])


def _sp_images(torch, seed, hw, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((SP_BS,) + hw + (3,), np.float32))
            .to(dev) for _ in range(2)]


def _sp_forward(torch, ir, xv, xl, dev, space=None):
    """fp32 eval forward of graph.init(ir, SEED) (TF32 off): the decoded
    rows of this rank's data shard, or of the whole batch."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.parallel import spatial as SP
    if space is not None:
        b = SP.local_batch({"v": xv, "l": xl}, space)
        xv, xl = b["v"], b["l"]
    v = graph.place_variables(graph.init(ir, SEED), dev)
    with _NoTF32(torch), torch.inference_mode():
        (io, _), _ = graph.apply(ir, v, xv, xl, train=False, space=space)
    return io.cpu().numpy()


def _sp_batch(torch, dev, hw, boxes=SP_BOXES, seed=SEED + 170):
    rng = np.random.default_rng(seed)
    t = np.zeros((SP_BS, 4, 5), np.float32)
    m = np.zeros((SP_BS, 4), bool)
    for b, bx in enumerate(boxes):
        for k, (cx, cy) in enumerate(bx):
            t[b, k] = [0, cx, cy, 0.25, 0.35]
            m[b, k] = True
    shape = (SP_BS,) + tuple(hw) + (3,)
    return {"v": torch.from_numpy(rng.integers(0, 256, shape,
                                               dtype=np.uint8)).to(dev),
            "l": torch.from_numpy(rng.integers(0, 256, shape,
                                               dtype=np.uint8)).to(dev),
            "targets": torch.from_numpy(t).to(dev),
            "tmask": torch.from_numpy(m).to(dev)}


def _sp_first_step(torch, ir, dev, dtype, hw, space=None, leaves=True,
                   variables=None):
    """The first SGD step from ``variables`` (graph.init(ir, SEED) where
    not given) on _sp_batch in ``dtype`` under deterministic algorithms
    (TF32 off): its metrics and, with ``leaves``, every leaf of the new
    state (params, BN state, momentum traces), as numpy."""
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.parallel import spatial as SP
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils import tree as TR
    from double_yolo_kaist_torch.utils.general import deterministic
    v = TR.map_leaves(lambda t: t.to(dev, dtype),
                      variables or graph.init(ir, SEED))
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           v["params"])
    tx = OPT.make_optimizer(SP_HYP, OPT.cosine_epoch_schedule(
        SP_HYP["lr0"], SP_HYP["lrf"], 3, 2), sgd=True)
    st = ST.TrainState(params, v["state"], tx.init(params), 0, None)
    step = ST.make_train_step(ir, SP_HYP, tx, compute_dtype=dtype,
                              space=space)
    batch = _sp_batch(torch, dev, hw)
    if space is not None:
        batch = SP.local_batch(batch, space)
    with deterministic():
        st, m = step(st, batch)
    out = {f"m/{k}": x.detach().double().cpu().numpy() for k, x in m.items()}
    if leaves:
        for j, t in enumerate(ST._state_leaves(st)):
            out[f"leaf/{j:04d}"] = t.detach().double().cpu().numpy()
    return out


def _sp_counted_exchanges(torch):
    """Wrap ``parallel.multihost.exchange`` (every halo and gather of the
    2-D path goes through it) to count the exchanges, the bytes this rank
    sends and, with CUDA events on the current stream around each (no
    synchronisation added), their device-timeline ms. Returns the record,
    a dict whose ``"events"`` the caller reads after a synchronise."""
    from double_yolo_kaist_torch.parallel import multihost as MH
    exchange = MH.exchange
    rec = {"n": 0, "bytes": 0, "events": []}

    def counted(table, outgoing, *a, **kw):
        rec["n"] += 1
        rec["bytes"] += sum(t.numel() * t.element_size()
                            for t in outgoing.values())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = exchange(table, outgoing, *a, **kw)
        end.record()
        rec["events"].append((start, end))
        return got

    MH.exchange = counted
    return rec


def _sp_flagship_timing(torch, dev, flagship_ir, variables, space):
    """The flagship at full width, bf16 Adam, a global batch of SP_BS at
    SP_FLAGSHIP_HW over the mesh, from ``variables``: a warm-up step, then
    one measured step: its ms (host clock, the metrics' fetch
    synchronises), its halo exchanges, the bytes this rank sent in them
    and their ms (CUDA events around each exchange:
    :func:`_sp_counted_exchanges`); the ms of one all-reduce of the
    gradients' flat buffer over the world; peak GiB."""
    from double_yolo_kaist_torch.parallel import multihost as MH
    from double_yolo_kaist_torch.parallel import spatial as SP
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils import tree as TR
    torch.cuda.reset_peak_memory_stats(dev)
    tx = OPT.make_optimizer(TRAIN_HYP, lambda c: torch.tensor(TRAIN_LR))
    st = ST.create_train_state(flagship_ir, SEED, tx, device=dev,
                               variables=variables)
    step = ST.make_train_step(flagship_ir, TRAIN_HYP, tx,
                              compute_dtype=torch.bfloat16, space=space)
    rng = np.random.default_rng(SEED + 171)
    mine = SP.local_batch(_train_batch(torch, rng, SP_BS, SP_FLAGSHIP_HW,
                                       dev), space)
    st, m = step(st, mine)                        # warm-up
    losses = [ST.metrics_to_host(m)["loss"]]
    exchange = MH.exchange
    rec = _sp_counted_exchanges(torch)
    try:
        t0 = time.perf_counter()
        st, m = step(st, mine)
        losses.append(ST.metrics_to_host(m)["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        MH.exchange = exchange
    torch.cuda.synchronize(dev)
    halo_ms = sum(a.elapsed_time(b) for a, b in rec["events"])
    flat = torch.zeros(sum(p.numel() for p in TR.leaves(st.params)),
                       device=dev)
    ar = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(flat, group=space.world)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": step_ms, "halos_a_step": rec["n"],
            "halo_ms_a_step": halo_ms,
            "halo_bytes_sent_a_step": rec["bytes"],
            "allreduce_ms_median": statistics.median(ar[1:]),
            "grad_floats": flat.numel(),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "losses": losses}


def _sp_rank_main(rank: int, root: str) -> None:
    """One of the four gloo ranks of phase 17 (a) and (b), on cuda:0; its
    results go to ``root/sp_rank<r>.npz`` and ``.json``."""
    import torch

    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models.builder import build_mini_flagship
    from double_yolo_kaist_torch.ops import _build
    from double_yolo_kaist_torch.parallel import multihost as MH
    from double_yolo_kaist_torch.parallel import spatial as SP
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    MH.maybe_initialize_distributed(
        coordinator=f"file://{os.path.join(root, 'sp_rendezvous')}",
        num_processes=SP_MESH[0] * SP_MESH[1], process_id=rank,
        backend="gloo")
    space = SP.make_space_shard(SP_MESH)
    hw = (SP_TINY_HW, SP_TINY_HW)
    tiny, mini = _sp_tiny_ir(), build_mini_flagship(img_size=SP_TINY_HW)
    out = {}
    _build.launches.clear()              # the 2-D path's two forwards
    out["a tiny"] = _sp_forward(torch, tiny, *_sp_images(
        torch, SEED + 172, hw, dev), dev, space)
    out["c mini"] = _sp_forward(torch, mini, *_sp_images(
        torch, SEED + 173, hw, dev), dev, space)
    numbers = {"launches": dict(_build.launches)}    # read just after
    for k, x in _sp_first_step(torch, tiny, dev, torch.float32, hw, space,
                               leaves=False).items():
        out[f"b {k}"] = x
    for k, x in _sp_first_step(torch, mini, dev, torch.float64, hw,
                               space).items():
        out[f"d {k}"] = x
    flagship = compile_cfg(FLAGSHIP_CFG)
    fvars = graph.init(flagship, SEED)
    numbers["flagship fp32 loss"] = float(_sp_first_step(
        torch, flagship, dev, torch.float32, SP_FLAGSHIP_F32_HW, space,
        leaves=False, variables=fvars)["m/loss"])
    torch.cuda.empty_cache()
    # the timing waits until the dryrun and the references have left the
    # card (the main process writes sp_go)
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(root, "sp_go")):
        if time.perf_counter() - t0 > SP_TIMEOUT:
            raise AssertionError(f"the go for the 2-D timing: timed out "
                                 f"after {SP_TIMEOUT} s")
        time.sleep(0.2)
    numbers["flagship bf16"] = _sp_flagship_timing(torch, dev, flagship,
                                                   fvars, space)
    np.savez(os.path.join(root, f"sp_rank{rank}.npz"), **out)
    with open(os.path.join(root, f"sp_rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    torch.distributed.destroy_process_group()


class _InProcessRank:
    """Rank 0 of (a) and (b), run in this process (:func:`_sp_ranks`), as
    :func:`_sp_hold_ranks` waits for a spawned one."""

    def __init__(self, returncode: int):
        self.returncode = returncode

    def wait(self, timeout=None):
        return self.returncode

    poll = wait

    def kill(self):
        pass


def _sp_ranks(root) -> list:
    """(a) and (b): ranks 1-3 spawned (:func:`_sp_rank_main`, output to
    ``root/sp_rank<r>.log``) and rank 0 run here, so that four processes
    share the card, this one among them. Returns the four ranks' records
    for :func:`_sp_hold_ranks`."""
    n = SP_MESH[0] * SP_MESH[1]
    procs = _spawn_ranks("_sp_rank_main", range(1, n), root, "sp_rank")
    rc = 0
    try:
        _sp_rank_main(0, root)
    except Exception as e:                 # noqa: BLE001 — held below
        traceback.print_exc()
        _failed("spatial/rank 0", e)
        with open(os.path.join(root, "sp_rank0.log"), "w") as f:
            f.write(traceback.format_exc())
        rc = 1
        import torch
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for p in procs:
            p.kill()
    return [_InProcessRank(rc)] + procs


def _sp_references(torch, dev, flagship_ir):
    """One process on the card, the whole global batch: what the ranks are
    held against."""
    from double_yolo_kaist_torch.models.builder import build_mini_flagship
    hw = (SP_TINY_HW, SP_TINY_HW)
    tiny, mini = _sp_tiny_ir(), build_mini_flagship(img_size=SP_TINY_HW)
    return {
        "a tiny": _sp_forward(torch, tiny, *_sp_images(
            torch, SEED + 172, hw, dev), dev),
        "c mini": _sp_forward(torch, mini, *_sp_images(
            torch, SEED + 173, hw, dev), dev),
        "b": _sp_first_step(torch, tiny, dev, torch.float32, hw,
                            leaves=False),
        "d": _sp_first_step(torch, mini, dev, torch.float64, hw),
        "flagship fp32 loss": float(_sp_first_step(
            torch, flagship_ir, dev, torch.float32, SP_FLAGSHIP_F32_HW,
            leaves=False)["m/loss"])}


def _sp_hold_ranks(ref, root, procs):
    """(a) and (b): the four ranks (``procs``) against one process on the
    card (``ref``: :func:`_sp_references`). Every rank has ended when this
    returns. Returns (launch counts of the ranks' 2-D forwards, numbers)."""
    try:
        for p in procs:
            p.wait(timeout=SP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not ref:
        raise AssertionError("no one-process reference to hold the ranks to")
    ranks = len(procs)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"sp_rank{r}.log")) as f:
                text = f.read()
            raise AssertionError(f"space rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    got = [dict(np.load(os.path.join(root, f"sp_rank{r}.npz")))
           for r in range(ranks)]
    nums = []
    for r in range(ranks):
        with open(os.path.join(root, f"sp_rank{r}.json")) as f:
            nums.append(json.load(f))
    b = SP_BS // SP_MESH[0]
    errs = {"a tiny": 0.0, "c mini": 0.0, "b": 0.0, "d": 0.0}
    failed = []
    for r, g in enumerate(got):
        d = r // SP_MESH[1]
        for k in ("a tiny", "c mini"):
            want = ref[k][d * b:(d + 1) * b]
            err = float(np.max(np.abs(g[k] - want)
                               / (SP_FWD_TOL + SP_FWD_TOL * np.abs(want))))
            errs[k] = max(errs[k], err)     # <= 1: within rtol and atol
        for k in ("loss", "box_loss", "obj_loss"):
            errs["b"] = max(errs["b"], abs(float(g[f"b m/{k}"])
                                           - float(ref["b"][f"m/{k}"])))
        for k, want in ref["d"].items():
            scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
            errs["d"] = max(errs["d"], float(np.abs(
                g[f"d {k}"] - want).max(initial=0.0)) / scale)
    for k, bound in (("a tiny", 1.0), ("c mini", 1.0), ("b", SP_LOSS_TOL),
                     ("d", SP_F64_BOUND)):
        if not errs[k] <= bound:
            failed.append(f"{k}: {errs[k]:.3e} over {bound}")
    loss_rel = max(abs(n["flagship fp32 loss"] - ref["flagship fp32 loss"])
                   / abs(ref["flagship fp32 loss"]) for n in nums)
    if not loss_rel <= SP_FLAGSHIP_LOSS_REL:
        failed.append(f"flagship fp32 loss {loss_rel:.3e} relative")
    launched = [n["launches"] for n in nums]
    if any(x.get("decode_head", 0) != 2 for x in launched):
        failed.append(f"K1 launches of the two gathering forwards a rank: "
                      f"{launched}")
    print(f"space (a) four gloo ranks on cuda:0, mesh {SP_MESH} against one "
          f"process on the card (TF32 off): tiny forward worst "
          f"|err|/(atol + rtol |want|) {errs['a tiny']:.3e}, mini-flagship "
          f"forward {errs['c mini']:.3e} (bound 1, tol {SP_FWD_TOL}); tiny "
          f"fp32 step loss terms {errs['b']:.3e} (bound {SP_LOSS_TOL}); "
          f"mini-flagship float64 step worst element over the array's "
          f"largest {errs['d']:.3e} (bound {SP_F64_BOUND}); K1 launches "
          f"a rank for its two forwards {launched}", flush=True)
    fl = [n["flagship bf16"] for n in nums]
    print(f"space (b) flagship fp32 at global bs {SP_BS} of "
          f"{SP_FLAGSHIP_F32_HW[0]}x{SP_FLAGSHIP_F32_HW[1]}: loss "
          f"{[n['flagship fp32 loss'] for n in nums]} against "
          f"{ref['flagship fp32 loss']} (worst relative {loss_rel:.3e}, "
          f"bound {SP_FLAGSHIP_LOSS_REL}); bf16 at global bs {SP_BS} of "
          f"{SP_FLAGSHIP_HW[0]}x{SP_FLAGSHIP_HW[1]} over four gloo ranks "
          f"of ONE card (a correctness run, not a scaling number): "
          + json.dumps(fl), flush=True)
    if not all(np.isfinite(x["losses"]).all() for x in fl):
        failed.append("the flagship's bf16 2-D losses are not finite")
    if failed:
        raise AssertionError("; ".join(failed))
    counts = {f"space rank {r}": x for r, x in enumerate(launched)}
    return counts, {"errors": errs, "flagship_fp32_loss_rel": loss_rel,
                    "flagship_bf16": fl}


def _sp_dryrun(rc: int, out: str, err: str, took: float) -> None:
    """(c) ``python -m double_yolo_kaist_torch.dryrun 4`` (four gloo ranks
    on cuda:0) ended with ``rc``: exit 0 and JAX's three lines."""
    lines = [x for x in out.splitlines()
             if x.startswith("dryrun_multichip(4): ok")]
    print(f"space (c) dryrun 4: exit {rc} in {took:.1f} s:\n  "
          + "\n  ".join(lines + [x for x in err.splitlines()
                                  if x.startswith("peak device memory")]),
          flush=True)
    legs = ("flagship train, 1-D data parallel", "flagship DP inference",
            "mini-flagship train, 2-D data x space")
    if rc != 0 or not all(any(leg in x for x in lines) for leg in legs):
        raise AssertionError(f"dryrun 4 failed:\n{out[-2000:]}\n"
                             f"{err[-3000:]}")


def _sp_mesh_predictor(torch, dev, launches, mnv3_ir):
    """(d) F5 repaired: a Predictor on the mesh ["cuda:0"] * 4 of shape
    (2, 2) serves one replica a data row: buckets (1, 8) become [2, 8],
    and requests of 3 and 8 frames (512x640, MNv3 bf16) are bit-equal to a
    1-D mesh of 2, K1 and K2 twice a request."""
    from double_yolo_kaist_torch.models import weights
    from double_yolo_kaist_torch.parallel import mesh as M
    from double_yolo_kaist_torch.serving import Predictor
    mv = weights.load_state_dict_npz(mnv3_ir, MNV3_NPZ)
    two_d = M.make_mesh([dev] * 4, axis_names=("data", "space"),
                        shape=(2, 2))
    kw = dict(img_size=640, batch_buckets=(1, 8))
    p2 = Predictor(mnv3_ir, mv, mesh=two_d, **kw)
    p1 = Predictor(mnv3_ir, mv, mesh=M.make_mesh([dev, dev]), **kw)
    if p2.batch_buckets != [2, 8] or len(two_d.replicas) != 2:
        raise AssertionError(f"2-D mesh buckets {p2.batch_buckets}, "
                             f"replicas {two_d.replicas}")
    rng = np.random.default_rng(SEED + 174)
    frames = {n: tuple(rng.integers(0, 256, (n, 512, 640, 3),
                                    dtype=np.uint8) for _ in range(2))
              for n in (3, 8)}
    for n in frames:                   # the first request captures
        p2(*frames[n])
        p1(*frames[n])
    torch.cuda.synchronize()
    launches.clear()                   # the 2-D mesh's requests
    got = {n: p2(*frames[n]) for n in frames}
    counts = {"space mesh predictor": dict(launches)}    # read just after
    for n, dets in got.items():
        for (b, s, c), (rb, rs, rc) in zip(dets, p1(*frames[n])):
            if not (np.array_equal(b, rb) and np.array_equal(s, rs)
                    and np.array_equal(c, rc)):
                raise AssertionError(f"2-D mesh request of {n} differs "
                                     f"from the 1-D mesh of 2")
    c = counts["space mesh predictor"]
    if c.get("decode_head") != 4 or c.get("nms_indices") != 4:
        raise AssertionError(f"2-D mesh launches {c}")
    print(f"space (d) Predictor on mesh (2, 2) of cuda:0: buckets "
          f"{p2.batch_buckets}, replicas {[str(d) for d in two_d.replicas]}"
          f", requests of 3 and 8 bit-equal to the 1-D mesh of 2; "
          f"launches {c}", flush=True)
    return counts, {}


def phase_spatial(torch, dev, launches, mnv3_ir, flagship_ir, root):
    """Phase 17: the 2-D data x space path on the one card: (d) and the
    one-process references first, then the four gloo ranks of (a) and (b)
    (this process is rank 0, three are spawned), whose bf16 timing has
    the card to itself. ``python -m double_yolo_kaist_torch.dryrun 4``,
    (c), is a job of its own (:func:`_dryrun_job`). Each part runs even
    when one before it failed; the phase fails if any did. Returns
    (launch counts of its main-path runs, numbers)."""
    t_phase = time.perf_counter()
    smi = _smi_line()
    numbers, counts, failed = {"card": smi}, {}, []

    def part(name, fn):
        try:
            c, numbers[name] = fn()
            counts.update(c)
        except Exception as e:             # noqa: BLE001 — report, go on
            traceback.print_exc()
            _failed(f"spatial/{name}", e)
            failed.append(name)
        _stamp(t_phase, f"phase 17 {name}")

    ref = {}
    part("(d)", lambda: _sp_mesh_predictor(torch, dev, launches, mnv3_ir))
    part("references", lambda: ({}, ref.update(
        _sp_references(torch, dev, flagship_ir))))
    torch.cuda.empty_cache()
    with open(os.path.join(root, "sp_go"), "w"):
        pass
    part("(a) and (b)", lambda: _sp_hold_ranks(ref, root, _sp_ranks(root)))
    print(f"space numbers ({smi}; one card: no multi-card number): "
          + json.dumps(numbers), flush=True)
    print(f"phase 17 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 17 parts failed: {failed}")
    return counts, numbers


# ----------------------------------------------------------------- phase 18

ZOO_HW = (64, 96)             # (a): the card against the CPU, fp32
ZOO_REL = 1e-3                # phase 9's relative bound
ZOO_MOVES = 1e-3              # least max |change| of a head, one frame new
TOOLS_BS = 16                 # zoo_bench, serving_bench, int8_ab
# (b): a leaky Darknet53 YOLOv3, the inception cfg and a MobileNet (its
# chain plan is empty), the three kinds of draw F7 repaired; the sweep of
# all 16 at 20 iters is PERF.md's, run on its own
ZOO_SMOKE_MODELS = ("Double-YOLOv3-Add-SL",
                    "Double-YOLOv3-Concat-Inception-SE",
                    "Visible-YOLOv4-MobileNetv2")
ZOO_SMOKE_ITERS = 2
TOOLS_TIMEOUT = 600


def _zoo_card_vs_cpu(torch, dev, launches):
    """(a) every zoo model on bench.seeded_variables: the folded fp32
    forward on the card (TF32 off) against the CPU's plain path on one
    seeded 64x96 pair (the visible frame alone for single-stream models),
    raw heads within ZOO_REL of their scale and decoded rows within
    ZOO_REL relative; then bf16 at 512x640 on the card: finite heads that
    move when the visible frame changes. K1 launches once a forward."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.models.zoo import MODELS, cfg_path
    rng = np.random.default_rng(SEED + 180)
    small = [rng.random((1,) + ZOO_HW + (3,), dtype=np.float32)
             for _ in range(2)]
    big = [torch.from_numpy(rng.random((1,) + EVAL_HW + (3,),
                                       dtype=np.float32)).to(dev,
                                                             torch.bfloat16)
           for _ in range(3)]

    def prepare(name):
        ir = compile_cfg(cfg_path(name))
        folded = graph.fold_batchnorm(ir, seeded_variables(ir, SEED))
        cpu = graph.place_folded(ir, folded, "cpu", torch.float32)
        with torch.inference_mode():
            io, raw = graph.apply_folded(
                ir, cpu, torch.from_numpy(small[0]),
                torch.from_numpy(small[1]) if ir.dual_stream else None)
        return ir, folded, io, raw

    # the CPU's forwards (and the draws) run in a pool beside the card's
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(prepare, name) for name in MODELS}
        launches.clear()
        for name, fut in futs.items():
            ir, folded, want_io, want_raw = fut.result()
            two = ir.dual_stream
            placed = graph.place_folded(ir, folded, dev, torch.float32)
            with _NoTF32(torch), torch.inference_mode():
                io, raw = graph.apply_folded(
                    ir, placed, torch.from_numpy(small[0]).to(dev),
                    torch.from_numpy(small[1]).to(dev) if two else None)
                io, raw = io.cpu(), [r.cpu() for r in raw]
            scale = max(float(r.abs().max()) for r in want_raw)
            err = max(float((a - b).abs().max())
                      for a, b in zip(raw, want_raw)) / scale
            io_err = float(((io - want_io).abs()
                            / (want_io.abs() + 1)).max())
            del placed
            placed = graph.place_folded(ir, folded, dev, torch.bfloat16)
            with torch.inference_mode():
                a = graph.apply_folded(ir, placed, big[0],
                                       big[2] if two else None,
                                       compute_dtype=torch.bfloat16)
                b = graph.apply_folded(ir, placed, big[1],
                                       big[2] if two else None,
                                       compute_dtype=torch.bfloat16)
                finite = bool(torch.isfinite(a[0]).all()
                              and torch.isfinite(b[0]).all())
                moved = max(float((x.float() - y.float()).abs().max())
                            for x, y in zip(a[1], b[1]))
            del placed, a, b
            print(f"zoo (a) {name}: fp32 {ZOO_HW[0]}x{ZOO_HW[1]} card vs "
                  f"CPU heads {err:.2e} of their scale {scale:.3g}, "
                  f"decoded {io_err:.2e} rel; bf16 {EVAL_HW[0]}x"
                  f"{EVAL_HW[1]} finite {finite}, heads move by "
                  f"{moved:.3g}", flush=True)
            if not (err <= ZOO_REL and io_err <= ZOO_REL and finite
                    and moved > ZOO_MOVES):
                raise AssertionError(f"zoo (a) {name}: card vs CPU or the "
                                     f"bf16 heads")
        torch.cuda.synchronize()
        counts = dict(launches)
    print(f"zoo (a): launches {counts} ({3 * len(MODELS)} forwards; K3 in "
          f"the forwards of the models whose stems are packed for it)",
          flush=True)
    if counts.get("decode_head", 0) != 3 * len(MODELS):
        raise AssertionError(f"zoo (a): K1 launched {counts} (want one a "
                             f"forward, {3 * len(MODELS)})")
    return counts


def _tool(name, module, *args, deterministic=False, slots=1):
    """``python -m double_yolo_kaist_torch.<module> *args`` through RUNPY
    (launch counts printed last); prints its exit, time, last lines and
    peak device memory. Returns (exit code, stdout lines, stderr)."""
    t0 = time.perf_counter()
    r = _sub(_runpy(module, *args, deterministic=deterministic),
             timeout=TOOLS_TIMEOUT, slots=slots)
    lines = r.stdout.splitlines()
    shown = [x for x in lines if not x.startswith("launches ")][-4:]
    peak = [x for x in r.stderr.splitlines()
            if x.startswith("peak device memory")]
    print(f"tool {name}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; last lines:\n  "
          + "\n  ".join(shown + peak), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"{name} exited {r.returncode}:\n"
                             f"{r.stdout[-1500:]}\n{r.stderr[-3000:]}")
    return lines


def _zoo_bench(tools):
    """(b) ``zoo_bench --int8`` over ZOO_SMOKE_MODELS: a finite bf16 fps on
    each row, an int8 chain fps on each model whose chain plan is not
    empty and the empty plan marked (no int8 number) on the others; K1
    and K4 launched."""
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import quantize as Q
    from double_yolo_kaist_torch.models.zoo import cfg_path
    out = os.path.join(tools, "zoo.jsonl")
    lines = _tool("zoo_bench", "zoo_bench", "--int8", "--models",
                  *ZOO_SMOKE_MODELS, "--batch", TOOLS_BS, "--height",
                  EVAL_HW[0], "--width", EVAL_HW[1], "--iters",
                  ZOO_SMOKE_ITERS, "--out", out)
    with open(out) as f:
        rows = {r["model"]: r for r in map(json.loads, f) if r}
    table = [x for x in lines if x.startswith("|")]
    print("zoo_bench table:\n  " + "\n  ".join(table), flush=True)

    def fps(x):
        return isinstance(x, (int, float)) and np.isfinite(x) and x > 0

    for name in ZOO_SMOKE_MODELS:
        r = rows.get(name, {})
        planned = bool(Q.plan_quantization(compile_cfg(cfg_path(name)),
                                           "chain")[0])
        ok = "error" not in r and fps(r.get("bf16_fps"))
        if planned:
            ok = ok and fps(r.get("int8_fps"))
        else:
            ok = ok and r.get("int8_plan") == "empty" \
                and "int8_fps" not in r
        if not ok:
            raise AssertionError(f"zoo_bench row of {name}: {r}")
    c = _launches_of(lines)
    if c.get("decode_head", 0) <= 0 or c.get("qgemm", 0) <= 0:
        raise AssertionError(f"zoo_bench launched {c}")
    return {"tools zoo_bench": c}


def _serving_bench_args(model, int8):
    return ["--model", model, "--batch", str(TOOLS_BS), "--n", "5",
            *(["--int8"] if int8 else [])]


def _serving_bench(model, int8):
    """(c) ``serving_bench`` on ``model`` in bf16 or int8 as a subprocess:
    its line and the launch counts of its run (:func:`_hold_serving`)."""
    label = f"{model} {'int8' if int8 else 'bf16'}"
    lines = _tool(f"serving_bench {label}", "serving_bench",
                  *_serving_bench_args(model, int8))
    if not any(x.startswith("serving e2e") for x in lines):
        raise AssertionError(f"serving_bench {label} printed no result")
    c = _launches_of(lines)
    _hold_serving(model, int8, c)
    return {f"tools serving_bench {label}": c}


def _serving_bench_inproc(torch, launches, model, int8):
    """(c) ``serving_bench.main`` in process on ``model`` in bf16 or int8,
    its launch counts held (:func:`_hold_serving`)."""
    from double_yolo_kaist_torch import serving_bench
    label = f"{model} {'int8' if int8 else 'bf16'}"
    launches.clear()
    res = serving_bench.main(_serving_bench_args(model, int8))
    torch.cuda.synchronize()
    c = dict(launches)
    print(f"serving_bench {label} (in process): {res['ms']:.3f} ms a batch "
          f"of {res['batch']}, {res['img_s']:.1f} img/s; launches {c}",
          flush=True)
    _hold_serving(model, int8, c)
    return {f"serving_bench {label}": c}


def _hold_serving(model, int8, c):
    """K1 and K2 launched by a serving_bench run on ``model``; K3 twice and
    K4 ten times a flagship int8 forward (the calibration request's batch
    is calibrated first: one undecoded forward, 2 stems), K3 twice a
    flagship bf16 forward, neither on MNv3 (its chain plan is empty: it
    serves bf16)."""
    from double_yolo_kaist_torch.models.zoo import FLAGSHIP
    label = f"{model} {'int8' if int8 else 'bf16'}"
    k1, k2 = c.get("decode_head", 0), c.get("nms_indices", 0)
    k3, k4 = c.get("stem_conv_s2", 0), c.get("qgemm", 0)
    ok = k1 > 0 and k2 > 0
    if model == FLAGSHIP and int8:
        # the calibration request's batch is calibrated (one undecoded
        # forward: 2 stems), then served in int8
        ok = ok and k3 == 2 * k1 + 2 and k4 == 10 * k1
    elif model == FLAGSHIP:
        ok = ok and k3 == 2 * k1 and k4 == 0
    else:
        ok = ok and k3 == 0 and k4 == 0
    if not ok:
        raise AssertionError(f"serving_bench {label}: launches {c}")


def _loadtest(root):
    """(d) ``serve_loadtest --spawn --payload raw`` on MNv3 at concurrency
    1 and 4: one line a level with rps, p50/p95/p99 and the MicroBatcher's
    batch histogram (printed, not gated: how requests coalesce depends
    on timing)."""
    ckpt = os.path.join(root, "mnv3_ckpt")
    lines = _tool("serve_loadtest", "serve_loadtest", "--spawn", "--payload",
                  "raw", "--cfg", MNV3_NAME, "--weights", ckpt,
                  "--concurrency", 1, 4, "--requests", 32, "--port", 0)
    levels = [json.loads(x) for x in lines if x.startswith("{")]
    keys = {"rps", "p50_ms", "p95_ms", "p99_ms", "microbatch", "device"}
    if ([x["concurrency"] for x in levels] != [1, 4]
            or not all(keys <= set(x) and x["rps"] > 0
                       and "size_hist" in x["microbatch"] for x in levels)):
        raise AssertionError(f"serve_loadtest printed {levels}")
    return {}


def _wallclock(tools):
    """(f) ``train_wallclock`` on MNv3: one epoch of 64 pairs at bs 8, 4
    steps a dispatch; its epoch time and the extrapolation to KAIST."""
    lines = _tool("train_wallclock", "train_wallclock", "--model",
                  MNV3_NAME, "--images", 64, "--epochs", 1, "--batch", 8,
                  "--spd", 4, "--root", os.path.join(tools, "wallclock"))
    if not (any("[wallclock] epoch 0:" in x for x in lines)
            and any("steady-state" in x and "KAIST" in x for x in lines)):
        raise AssertionError("train_wallclock did not print its lines")
    return {}


def _int8_ab():
    """(e) ``int8_ab`` on the flagship, chain and edge, one round: a
    finite fps a mode, K3 and K4 launched."""
    lines = _tool("int8_ab", "int8_ab", "--modes", "chain", "edge",
                  "--rounds", 1, "--batch", TOOLS_BS, "--iters", 5)
    best = {x.split(":")[0]: float(x.split(":")[1].split()[0])
            for x in lines if x.startswith(("chain:", "edge:"))}
    c = _launches_of(lines)
    if (set(best) != {"chain", "edge"} or min(best.values()) <= 0
            or c.get("qgemm", 0) <= 0 or c.get("stem_conv_s2", 0) <= 0):
        raise AssertionError(f"int8_ab: {best}, launches {c}")
    return {"tools int8_ab": c}


OVERFIT_STEPS = 100     # the tool's default is 150


def _overfit():
    """(g) ``real_model_overfit`` on MNv3, OVERFIT_STEPS steps, under
    deterministic algorithms (the tool's own): AP@0.5 at least 0.5 (its
    default gate), the margin printed by the tool."""
    lines = _tool("real_model_overfit", "real_model_overfit", "--steps",
                  OVERFIT_STEPS)
    if "REAL MODEL OVERFIT PASSED" not in lines:
        raise AssertionError("real_model_overfit did not pass")
    return {}


def _visual(tools):
    """(h) ``dataset_preview``, ``compare_clahe`` and ``plot_activations``
    (both panels): their PNGs, or, where matplotlib is absent, a refusal
    naming it before the card is touched."""
    import importlib.util

    from double_yolo_kaist_torch.train_wallclock import make_dataset
    split = make_dataset(os.path.join(tools, "preview"), 4, EVAL_HW)
    data = os.path.join(tools, "preview", "m.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={split}\nvalid={split}\n")
    with open(split) as f:
        image = f.readline().strip().replace(".jpg", "_visible.jpg")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    for module, png, args in (
            ("dataset_preview", "preview.png",
             ["--data", data, "--n", "2", "--out"]),
            ("compare_clahe", "clahe.png", [image]),
            ("plot_activations", "activations.png", []),
            ("plot_activations", "curves.png", ["--panel", "curves"])):
        path = os.path.join(tools, png)
        argv = args + [path] if module != "plot_activations" \
            else [path] + args
        r = _sub([sys.executable, "-m", f"double_yolo_kaist_torch.{module}",
                  *argv], timeout=TOOLS_TIMEOUT,
                 slots=1 if has_mpl else 0)
        print(f"tool {module} {png}: exit {r.returncode}; "
              f"{(r.stdout + r.stderr).strip().splitlines()[-1:]}",
              flush=True)
        if has_mpl:
            with open(path, "rb") as f:
                ok = f.read(8) == b"\x89PNG\r\n\x1a\n"
            if r.returncode != 0 or not ok or os.path.getsize(path) < 1000:
                raise AssertionError(f"{module}: no PNG\n{r.stderr[-2000:]}")
        elif (r.returncode == 0 or "matplotlib" not in r.stderr
              or os.path.exists(path)):
            raise AssertionError(f"{module} without matplotlib:\n"
                                 f"{r.stderr[-2000:]}")
    print("visual tools: " + ("PNGs written" if has_mpl else
                              "refused, naming matplotlib (absent)"),
          flush=True)
    return {}


def phase_tools(torch, dev, launches):
    """Phase 18's in-process parts: (a) the 16 zoo models card vs CPU, and
    (c) ``serving_bench.main`` on MNv3 (bf16 and int8) and the flagship in
    bf16 (its int8 run, and the other tools, (b)-(h), are subprocesses:
    tasks of the script, TASKS). Returns (launch counts of each run,
    numbers)."""
    from double_yolo_kaist_torch.models.zoo import FLAGSHIP
    counts = {"zoo card vs CPU": _zoo_card_vs_cpu(torch, dev, launches)}
    for model, int8 in ((FLAGSHIP, False), (MNV3_NAME, False),
                        (MNV3_NAME, True)):
        counts.update(_serving_bench_inproc(torch, launches, model, int8))
    return counts, {}


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


# ---------------------------------------------------------------- phase 19

S15_BS = 8                   # the train batch of every slice-15 check
S15_SIZE = 512               # the train size
S15_POOL = 32                # pairs of the double buffer's device pool
S15_K = 4                    # steps a dispatch of the double buffer
S15_STEP_BS = 2              # the fp32 s2d-train step's batch
S15_S2D_REL = 1e-4           # s2d against plain: relative loss bound
S15_CHECKS = ("split_concat", "s2d_train")


def _s15_hyp():
    from double_yolo_kaist_torch.config.parser import load_hyp
    return load_hyp(os.path.join(ROOT, "configs", "hyp.scratch.4.yaml"))


def _s15_far(torch, got, want, pix):
    """Share of the pixels of ``got`` (on the 0-255 scale) beyond 1e-3 of
    ``want``'s (fp32) or two bf16 ulps of the value (bf16: the card and
    the CPU may sum a row's two taps in another order, which can tip the
    resample's one rounding to bf16 by an ulp, and the HSV stage's gains
    carry that ulp into its own rounding), and the largest
    |difference|."""
    g, w = got.double().cpu(), want.double().cpu()
    d = (g - w).abs() * 255
    bound = 1e-3
    if pix == torch.bfloat16:
        m = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        bound = 2 * torch.exp2(torch.floor(torch.log2(m)) - 7) * 255
    return float((d > bound).double().mean()), float(d.max())


def _s15_augment(torch, dev):
    """(a) The matmul route (JAX's default) on the card against the CPU, a
    batch of 8 at 512 from 512x640 frames, from the same randoms, in fp32
    and bf16 pixels; chunked (chunk 3: chunks of 2) against unchunked on
    the card; the data ms of each route and pixel dtype on the card."""
    from double_yolo_kaist_torch.data import pipeline as P
    hyp = _s15_hyp()
    rng = np.random.default_rng(SEED + 19)
    nb, src = S15_BS, EVAL_HW
    v, l = (torch.from_numpy(rng.integers(0, 256, (4 * nb,) + src + (3,),
                                          dtype=np.uint8)) for _ in "vl")
    lab = np.zeros((4 * nb, 6, 5), np.float32)
    lab[..., 1:3] = rng.uniform(0.2, 0.8, (4 * nb, 6, 2))
    lab[..., 3:] = rng.uniform(0.05, 0.3, (4 * nb, 6, 2))
    lab = torch.from_numpy(lab)
    m = torch.from_numpy(rng.random((4 * nb, 6)) < 0.6)
    args = [t.to(dev) for t in (v, l, lab, m)]
    numbers, bad = {}, []
    for pix in (torch.float32, torch.bfloat16):
        name = "bf16" if pix == torch.bfloat16 else "fp32"
        fn = P.make_train_augment_fn(src, S15_SIZE, hyp, pix_dtype=pix)
        if fn.resample != "matmul":
            raise AssertionError(f"the default route is {fn.resample}")
        draws = fn.draw(torch.Generator().manual_seed(SEED), nb)
        want = fn.heavy(v, l, lab, m, **draws)
        got = fn.heavy(*args, **draws)
        chunked = P.make_train_augment_fn(src, S15_SIZE, hyp, pix_dtype=pix,
                                          chunk=3)
        chunked.draw = lambda g, n: draws
        parts = chunked(None, *args)
        for what, a, b in (("card vs CPU", got, want),
                           ("chunked vs unchunked", parts, got)):
            far = {k: _s15_far(torch, a[k], b[k], pix) for k in ("v", "l")}
            t_err = float((a["targets"].cpu() - b["targets"].cpu())
                          .abs().max())
            same_m = torch.equal(a["tmask"].cpu(), b["tmask"].cpu())
            print(f"slice15 augment matmul {name} bs {nb} at {S15_SIZE}, "
                  f"{what}: pixels beyond the bound v {far['v'][0]:.2e} l "
                  f"{far['l'][0]:.2e} (largest |diff| {far['v'][1]:.2e} / "
                  f"{far['l'][1]:.2e} of 255); targets max err {t_err:.2e}, "
                  f"masks equal {same_m}", flush=True)
            if (max(far["v"][0], far["l"][0]) > 0 or t_err > 1e-5
                    or not same_m or a["v"].dtype != pix):
                bad.append(f"{name} {what}")
        if pix == torch.float32:
            # with the cutout and CLAHE: a value on .5 may round to uint8
            # the other way, and CLAHE carries that level across its
            # tile: a share of the pixels beyond 1e-3, held as phase 14
            # holds the gather route, and none by 2 levels or more
            fc = P.make_train_augment_fn(src, S15_SIZE, hyp, snowflake=True,
                                         clahe=True)
            dc = fc.draw(torch.Generator().manual_seed(SEED + 1), nb)
            a, b = fc.heavy(*args, **dc), fc.heavy(v, l, lab, m, **dc)
            for k in ("v", "l"):
                share, big = _s15_far(torch, a[k], b[k], pix)
                print(f"slice15 augment matmul fp32 snow+clahe, card vs "
                      f"CPU, {k}: share of pixels beyond 1e-3 {share:.2e} "
                      f"(bound {AUG_CLAHE_SHARE}), largest |diff| {big:.3f}"
                      f" (bound 2) of 255", flush=True)
                if share > AUG_CLAHE_SHARE or big >= 2:
                    bad.append(f"snow+clahe {k}")
            if not torch.equal(a["tmask"].cpu(), b["tmask"]):
                bad.append("snow+clahe masks")
        for route in ("matmul", "gather"):
            f = P.make_train_augment_fn(src, S15_SIZE, hyp, pix_dtype=pix,
                                        resample=route)
            times = []
            for i in range(6):
                t0 = time.perf_counter()
                f(torch.Generator().manual_seed(SEED + i), *args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            numbers[f"{route} {name}"] = statistics.median(times[1:])
    print("slice15 augment data ms a step on the card (host clock, median "
          "of 5 after 1): " + json.dumps(
              {k: round(x, 3) for k, x in numbers.items()}), flush=True)
    if bad:
        raise AssertionError(f"the matmul augment differs beyond its bound: "
                             f"{bad}")
    return numbers


def _s15_double_buffer(torch, dev, fir):
    """(b) The flagship at full width, bf16, bs 8 at 512: K = 4 fused
    augment + train steps with ``double_buffer`` against without, from the
    same variables, pool and plan, under deterministic algorithms: the
    metrics and every leaf of the state equal bit for bit; the ms of a
    dispatch of each, in turns."""
    from double_yolo_kaist_torch.data import pipeline as P
    from double_yolo_kaist_torch.models import graph
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils.general import deterministic
    hyp = dict(_s15_hyp(), **{k: TRAIN_HYP[k] for k in ("obj", "cls")})
    variables = graph.init(fir, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    pool = [torch.randint(0, 256, (S15_POOL,) + EVAL_HW + (3,),
                          dtype=torch.uint8, device=dev, generator=gen)
            for _ in "vl"]
    rng = np.random.default_rng(SEED + 20)
    t = np.zeros((S15_K, 4 * S15_BS, 4, 5), np.float32)
    t[..., 0, 1:3] = rng.uniform(0.3, 0.7, (S15_K, 4 * S15_BS, 2))
    t[..., 0, 3:] = rng.uniform(0.05, 0.3, (S15_K, 4 * S15_BS, 2))
    mk = np.zeros((S15_K, 4 * S15_BS, 4), bool)
    mk[..., 0] = True
    xs = {"b0": torch.arange(S15_K) * S15_BS,
          "load": torch.from_numpy(rng.integers(
              0, S15_POOL, (S15_K, 4 * S15_BS))).long().to(dev),
          "targets": torch.from_numpy(t).to(dev),
          "tmask": torch.from_numpy(mk).to(dev)}
    aug = P.make_train_augment_fn(EVAL_HW, S15_SIZE, hyp, from_pool=True)
    tx = OPT.make_optimizer(hyp, lambda c: torch.tensor(TRAIN_LR), sgd=True)
    multi = ST.make_multi_step(fir, hyp, tx)
    fused = {db: ST.make_fused_multi_step(fir, hyp, tx, aug,
                                          multi_step=multi, double_buffer=db)
             for db in (False, True)}
    out, ms = {}, {False: [], True: []}
    with deterministic():
        for db in (False, True):
            st = ST.create_train_state(fir, SEED, tx, variables=variables,
                                       device=dev)
            st, met = fused[db](st, *pool, xs, SEED)
            out[db] = ([x.detach().clone() for x in ST._state_leaves(st)],
                       {k: v.clone() for k, v in met.items()})
        st = ST.create_train_state(fir, SEED, tx, variables=variables,
                                   device=dev)
        for _ in range(2):                    # in turns: plain, double, ...
            for db in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, met = fused[db](st, *pool, xs, SEED)
                torch.cuda.synchronize()
                ms[db].append((time.perf_counter() - t0) * 1e3)
    (s0, m0), (s1, m1) = out[False], out[True]
    same_m = all(torch.equal(m0[k], m1[k]) for k in ST.METRICS)
    n_diff = sum(not torch.equal(a, b) for a, b in zip(s0, s1))
    losses = m0["loss"].float().cpu().tolist()
    print(f"slice15 double buffer, flagship bf16 bs {S15_BS} at {S15_SIZE}, "
          f"K={S15_K} fused: metrics equal {same_m}, state leaves differing "
          f"{n_diff} of {len(s0)}; losses {[round(x, 4) for x in losses]}; "
          f"ms a dispatch (host clock, in turns) plain "
          f"{[round(x, 1) for x in ms[False]]}, double "
          f"{[round(x, 1) for x in ms[True]]}", flush=True)
    if not same_m or n_diff or not all(np.isfinite(losses)):
        raise AssertionError("the double-buffered fused steps differ from "
                             "the plain ones")
    return {"plain_ms": min(ms[False]), "double_ms": min(ms[True])}


def phase_slice15(torch, dev, launches, ir, fir, root):
    """Phase 19 (a), (b) in the job's process; (c) and (d) are the tasks
    ``slice15 split-concat`` and ``slice15 s2d-train``."""
    numbers = {"augment": _s15_augment(torch, dev)}
    torch.cuda.empty_cache()
    numbers["double buffer"] = _s15_double_buffer(torch, dev, fir)
    torch.cuda.empty_cache()
    print("slice15 numbers: " + json.dumps(numbers), flush=True)
    return {}, numbers


def _s15_check(root, name: str, env: str) -> dict:
    """Run ``chip_smoke.py --check NAME`` with ``env``=1 set (the switch
    is read when the port is imported) and read what it wrote."""
    r = _sub([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--check",
              name, root], timeout=600,
             env=dict(os.environ, PYTHONPATH=ROOT, **{env: "1"}))
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        raise AssertionError(f"--check {name} exited {r.returncode}:\n"
                             f"{(r.stdout + r.stderr)[-3000:]}")
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def _nrel(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _check_split_concat(torch, dev, root):
    """(c), in a process started with DYK_SPLIT_CONCAT_CONV=1: the flagship
    (seeded weights) served in bf16 by a Predictor, 8 frames of 512x640:
    K1 and K2 once and K3 twice in the request's replay. Its forward with
    the rewrite (18 route concats left unbuilt) and, the switch turned
    off, without it: fp32 (TF32 off) eagerly, and bf16 replayed from
    captured graphs, with each replay's ms."""
    from double_yolo_kaist_torch.bench import seeded_variables
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.cuda_graphs import capture
    from double_yolo_kaist_torch.models import graph as G
    from double_yolo_kaist_torch.ops import _build
    from double_yolo_kaist_torch.serving import Predictor
    if not G._SPLIT_CONCAT_CONV:
        raise AssertionError("DYK_SPLIT_CONCAT_CONV=1 did not turn the "
                             "rewrite on")
    ir = compile_cfg(FLAGSHIP_CFG)
    deferred = [n.index for n in ir.nodes
                if n.kind == "route" and G._defer_concat(ir, n)]
    variables = seeded_variables(ir, SEED)
    rng = np.random.default_rng(SEED + 1)
    v, l = (rng.integers(0, 256, (8, 512, 640, 3), dtype=np.uint8)
            for _ in "vl")
    pred = Predictor(ir, variables, img_size=640, device=dev)
    pred.warmup((512, 640), batch=8)
    torch.cuda.synchronize()
    _build.launches.clear()
    dets = pred(v, l)
    counts = dict(_build.launches)
    fn, _, _ = pred._preprocess((512, 640))
    xv, xl = fn(torch.from_numpy(v).to(dev), torch.from_numpy(l).to(dev))
    pool = torch.cuda.graph_pool_handle()
    f32 = G.place_folded(ir, G.fold_batchnorm(ir, variables), dev,
                         torch.float32)
    outs, ref, ms = {}, {}, {}
    with torch.inference_mode():
        for on in (True, False):
            G._SPLIT_CONCAT_CONV = on
            g, out, _ = capture(lambda: G.apply_folded(
                ir, pred.folded, xv, xl, compute_dtype=torch.bfloat16)[0],
                dev, pool)
            g.replay()
            torch.cuda.synchronize()
            outs[on] = out.clone()
            ms[on] = _time_ms(torch, g.replay, iters=10, reps=3, warmup=2)
            with _NoTF32(torch):
                ref[on] = G.apply_folded(ir, f32, xv, xl,
                                         compute_dtype=torch.float32)[0]
    G._SPLIT_CONCAT_CONV = True
    exact = _nrel(torch, ref[True], ref[False])
    split = _nrel(torch, outs[True], ref[False])
    bf16 = _nrel(torch, outs[False], ref[False])
    conf = _nrel(torch, outs[True][..., 4], outs[False][..., 4])
    finite = bool(torch.isfinite(outs[True]).all())
    n_det = [len(d[1]) for d in dets]
    res = {"deferred": len(deferred), "counts": counts, "fp32_rel": exact,
           "split_rel": split, "bf16_rel": bf16, "conf_rel": conf,
           "finite": finite, "ms_split": ms[True], "ms_plain": ms[False],
           "dets": n_det}
    print(f"slice15 split-concat, flagship bs 8 at 512x640 (letterboxed "
          f"to 640): {len(deferred)} concats left unbuilt; the bf16 "
          f"request's launches {counts}, detections a frame {n_det}; "
          f"decoded rows relative by norm: fp32 with vs without "
          f"{exact:.3e} (bound 1e-4); bf16 with the rewrite vs fp32 "
          f"{split:.3e}, without it vs fp32 {bf16:.3e} (bound: twice "
          f"that); bf16 with vs without, objectness {conf:.3e}; bf16 "
          f"replay ms {ms[True]:.3f} with, {ms[False]:.3f} without",
          flush=True)
    return res


def _check_s2d_train(torch, dev, root):
    """(d), in a process started with DYK_S2D_TRAIN=1: the flagship from
    graph.init, fp32 (TF32 off, deterministic algorithms), bs 2 at
    512x512: one SGD step eager and one captured (make_multi_step, a CUDA
    graph), in the s2d basis and, the switch turned off, in the plain
    basis; each step's loss (computed before the update) within 1e-4
    relative of the plain one's; the step ms of each."""
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.models import graph as G
    from double_yolo_kaist_torch.train import optim as OPT
    from double_yolo_kaist_torch.train import step as ST
    from double_yolo_kaist_torch.utils.general import deterministic
    if not G._S2D_TRAIN:
        raise AssertionError("DYK_S2D_TRAIN=1 did not turn the basis on")
    ir = compile_cfg(FLAGSHIP_CFG)
    plan = G.s2d_plan(ir, S15_SIZE, S15_SIZE, exclude_stems=False)
    variables = G.init(ir, SEED)
    batch = _train_batch(torch, np.random.default_rng(SEED + 21),
                         S15_STEP_BS, (S15_SIZE, S15_SIZE), dev)
    losses, ms = {}, {}
    with deterministic():
        for on in (True, False):
            G._S2D_TRAIN = on
            for how in ("eager", "captured"):
                tx = OPT.make_optimizer(TRAIN_HYP,
                                        lambda c: torch.tensor(TRAIN_LR),
                                        sgd=True)
                st = ST.create_train_state(ir, SEED, tx,
                                           variables=variables, device=dev)
                multi = ST.make_multi_step(ir, TRAIN_HYP, tx,
                                           compute_dtype=torch.float32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if how == "eager":
                    st, m = multi.step_fn(st, batch)
                else:
                    st, m = multi(st, {k: x[None] for k, x in batch.items()})
                loss = ST.metrics_to_host(m)["loss"]
                ms[(on, how)] = (time.perf_counter() - t0) * 1e3
                losses[(on, how)] = loss
    rel = {how: abs(losses[(True, how)] - losses[(False, how)])
           / abs(losses[(False, how)]) for how in ("eager", "captured")}
    res = {"plan": len(plan), "roles": sorted(set(plan.values())),
           "losses": {f"{'s2d' if on else 'plain'} {how}": x
                      for (on, how), x in losses.items()},
           "rel": rel, "ms": {f"{'s2d' if on else 'plain'} {how}": x
                              for (on, how), x in ms.items()}}
    print(f"slice15 s2d-train, flagship fp32 bs {S15_STEP_BS} at "
          f"{S15_SIZE}x{S15_SIZE}: {len(plan)} convs in the s2d basis "
          f"(roles {res['roles']}); losses {res['losses']}; s2d vs plain "
          f"relative {rel} (bound {S15_S2D_REL}); step ms (host clock, a "
          f"captured one with its capture) {res['ms']}", flush=True)
    return res


def _check_main(name: str, root: str) -> int:
    """``--check NAME ROOT``: one slice-15 check in a process of its own
    (its switch set by the caller's environment); writes
    ``ROOT/NAME.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    sys.path.insert(0, ROOT)
    from double_yolo_kaist_torch.ops import _build
    _build.build_all()
    fn = {"split_concat": _check_split_concat,
          "s2d_train": _check_s2d_train}[name]
    res = fn(torch, torch.device("cuda", 0), root)
    with open(os.path.join(root, f"{name}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _s15_split_task(root):
    """The task of (c): its launch counts are the main path's (a request
    of the flagship bf16 with the rewrite)."""
    res = _s15_check(root, "split_concat", "DYK_SPLIT_CONCAT_CONV")
    want = {"decode_head": 1, "nms_indices": 1, "stem_conv_s2": 2}
    got = {k: res["counts"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"split-concat request launches {got}, want "
                             f"{want}")
    if not res["finite"] or res["deferred"] < 1:
        raise AssertionError("split-concat: non-finite output or nothing "
                             "deferred")
    if not res["fp32_rel"] <= 1e-4:
        raise AssertionError(f"split-concat in fp32: {res['fp32_rel']:.3e} "
                             f"from the forward without it")
    if not res["split_rel"] <= 2 * res["bf16_rel"]:
        raise AssertionError(
            f"split-concat's bf16 forward is {res['split_rel']:.3e} from "
            f"fp32, more than twice the plain one's {res['bf16_rel']:.3e}")
    return {"split-concat request": res["counts"]}


def _s15_s2d_task(root):
    res = _s15_check(root, "s2d_train", "DYK_S2D_TRAIN")
    if not {"e3", "x3"} <= set(res["roles"]):
        raise AssertionError(f"s2d-train: the stem pair is not planned "
                             f"(roles {res['roles']})")
    losses = list(res["losses"].values())
    if not all(np.isfinite(losses)) or max(res["rel"].values()) > \
            S15_S2D_REL:
        raise AssertionError(f"s2d-train: losses {res['losses']} beyond "
                             f"{S15_S2D_REL} relative")
    return {}


# ------------------------------------------------------------------ the jobs
#
# The script runs as one process that never touches the card (it builds
# the kernels, starts the jobs, holds the card's process budget and reads
# what the jobs wrote) and a process a job (``--job NAME``), each with its
# own subprocesses. Every process on the card holds one of CUDA_SLOTS
# slots; at most MAX_MAINS jobs run at once, so that a slot is always left
# for their subprocesses. "core" times the kernels on a quiet card first;
# the jobs that read phase 9's split start once core has written it.

class _Job:
    """What a job process keeps: its launch counts by run, its failed
    phases, its numbers for the result line."""

    def __init__(self, name: str, root: str):
        self.name, self.root = name, root
        self.counts, self.failed, self.out = {}, [], {}
        self.state = {}      # what a group leaves for the next one
        self.t0 = time.perf_counter()

    def run(self, phase: str, fn):
        """``fn()``; a failure is printed (``chip_smoke: FAILED``) and
        recorded, and gives None."""
        try:
            return fn()
        except Exception as e:             # noqa: BLE001 — report, go on
            traceback.print_exc()
            _failed(f"{self.name}/{phase}", e)
            self.failed.append(phase)
            return None
        finally:
            _stamp(self.t0, f"{self.name}: {phase}")


def _mark(root: str, what: str) -> None:
    with open(os.path.join(root, what), "w"):
        pass


def _job_core(j, torch, dev, ir, fir):
    """Phases 3-10: the kernels against their plain versions (timed on a
    quiet card: no other job starts before ``kernels.timed``), MNv3 and
    the flagship end to end, evaluate (which writes the split the other
    jobs read: ``split.ready``), the CUDA graphs."""
    from double_yolo_kaist_torch.ops import _build
    L = _build.launches
    results = {}
    try:
        for name, fn in (("K1", lambda: phase_decode(torch, ir, dev, L)),
                         ("K2", lambda: phase_nms(torch, dev)),
                         ("K3", lambda: phase_stem(torch, dev)),
                         ("K3 probes", lambda: phase_probes(torch, dev, L)),
                         ("K4", lambda: phase_qgemm(torch, fir, dev, L)),
                         ("K5", lambda: phase_bias_act(torch, fir, dev, L))):
            r = j.run(name, fn)
            if r is not None:
                results[name] = r
    finally:
        _mark(j.root, "kernels.timed")
    j.out["results"] = results
    served = {}
    r = j.run("MNv3 end to end", lambda: phase_end_to_end(torch, ir, dev, L))
    if r is not None:
        j.counts["mnv3"], _, served["mnv3"] = r
    r = j.run("flagship end to end", lambda: phase_flagship(torch, dev, L))
    if r is not None:
        j.counts.update(r[0])
        j.state["flagship times"] = r[1]
        served.update(r[2])
    r = j.run("evaluate", lambda: phase_eval(
        torch, dev, L, ir, fir, results, j.root,
        ready=lambda: _mark(j.root, "split.ready")))
    if r is not None:
        j.counts.update(r[0])
        j.out["eval_kernels"] = r[1]
    held = {"decode_head": 1, "nms_indices": 1}
    r = j.run("graphs", lambda: phase_graphs(torch, L, [
        ("MNv3 bf16", served["mnv3"][0], served["mnv3"][1],
         dict(held, bias_act=37)),
        ("flagship bf16", *served["flagship bf16"],
         dict(held, stem_conv_s2=2, bias_act=183)),
        ("flagship int8", *served["flagship int8"],
         dict(held, stem_conv_s2=2, qgemm=10, bias_act=101))]))
    if r is not None:
        j.counts.update(r[0])

    def entry():
        _entry_refs(torch, dev, ir, served["mnv3"][2], j.root)
        _mark(j.root, "entry.refs")
        _microbatch(torch, L, served["flagship bf16"][0], j.counts)

    j.run("entry refs and MicroBatcher", entry)
    served.clear()
    torch.cuda.empty_cache()


def _job_train(j, torch, dev, ir, fir):
    """Phases 12 and 13 (13's entry-point runs are tasks of the script,
    which run meanwhile)."""
    from double_yolo_kaist_torch.ops import _build
    j.run("train step", lambda: phase_train_step(torch, dev, ir, fir))
    r = j.run("train entry point", lambda: phase_train_entry(
        torch, dev, _build.launches, fir, j.root, j.shared))
    if r is not None:
        j.counts["train"] = r


def _job_int8aug(j, torch, dev, ir, fir):
    """Phase 14 beside phase 8's bf16 and chain times: core's, when it ran
    in this process before, else phase 8 again."""
    from double_yolo_kaist_torch.ops import _build
    times = j.state.get("flagship times")
    if times is None:
        r = j.run("flagship end to end", lambda: phase_flagship(
            torch, dev, _build.launches))
        if r is None:
            return
        counts, times, served = r
        j.counts.update({f"int8aug {k}": v for k, v in counts.items()})
        served.clear()
        torch.cuda.empty_cache()
    r = j.run("int8 modes and augment", lambda: phase_int8aug(
        torch, dev, _build.launches, j.root, times))
    if r is not None:
        j.counts.update(r)


def _job_slice9(j, torch, dev, ir, fir):
    """Phase 15; it leaves MNv3's K=4 A/B for phase 16 (d)."""
    from double_yolo_kaist_torch.ops import _build
    r = j.run("slice9", lambda: phase_slice9(torch, dev, _build.launches, ir,
                                             fir, j.root))
    if r is not None:
        j.counts.update(r[0])
        j.state["ab"] = r[1]["ab"][f"MNv3 K={K_STEPS}"]
    torch.cuda.empty_cache()


def _job_dp(j, torch, dev, ir, fir):
    """Phase 16 (with phase 15's A/B and chain artifact where phase 15 ran
    in this process before)."""
    from double_yolo_kaist_torch.ops import _build
    r = j.run("dp", lambda: phase_dp(torch, dev, _build.launches, ir, fir,
                                     j.root, j.state.get("ab")))
    if r is not None:
        j.counts.update(r[0])
    torch.cuda.empty_cache()


def _job_phase(name, fn):
    """A group of one phase function that returns (counts, numbers)."""
    def job(j, torch, dev, ir, fir):
        from double_yolo_kaist_torch.ops import _build
        r = j.run(name, lambda: fn(torch, dev, _build.launches, ir, fir,
                                   j.root))
        if r is not None:
            j.counts.update(r[0])
    return job


def _job_split(j, torch, dev, ir, fir):
    """For ``--only`` runs without core: phase 9's split, labelled and
    checkpointed as phase 9 does it, and core's references for the
    serving entry points."""
    from double_yolo_kaist_torch.models import weights
    try:
        j.run("split", lambda: _labelled_split(torch, dev, ir, j.root))
        if not j.failed:
            _mark(j.root, "split.ready")
            j.run("entry refs", lambda: _entry_refs(
                torch, dev, ir, weights.load_state_dict_npz(ir, MNV3_NPZ),
                j.root))
            if not j.failed:
                _mark(j.root, "entry.refs")
    finally:
        _mark(j.root, "kernels.timed")


SPLIT_FILES = ("images", "labels", "mnv3_ckpt", "eval80.txt",
               "eval80.shapes", "eval8.txt", "eval8.shapes")

# name: (function, reads phase 9's split, runs with the card to itself)
JOBS = {
    "split": (_job_split, False, False),  # --only runs without core
    "core": (_job_core, False, False),
    "slice9": (_job_slice9, True, False),
    "train": (_job_train, True, False),
    "int8aug": (_job_int8aug, True, False),
    "dp": (_job_dp, True, False),
    "tools": (_job_phase("tools", lambda torch, dev, L, ir, fir, root:
                         phase_tools(torch, dev, L)), False, False),
    "spatial": (_job_phase("spatial", phase_spatial), False, True),
    "slice15": (_job_phase("slice15", phase_slice15), False, False),
    "dryrun": (None, False, True),      # run by the script itself
}
# the whole run's jobs: two lanes, each a process that runs its groups
# one after another, then the two that have the card to themselves
RUN = ("core+int8aug+train+tools+slice15", "slice9+dp", "spatial",
       "dryrun")
PRODUCERS = ("core", "split")    # the jobs that write the markers
MAX_MAINS = 2            # jobs at once (two slots are left for subprocesses)
# a job of several groups: the sum of theirs
JOB_LIMIT_S = {"core": 300, "slice9": 420, "train": 360, "int8aug": 300,
               "dp": 300, "tools": 180, "spatial": 300, "dryrun": 240,
               "split": 300, "slice15": 180}

# the subprocess runs whose checks need no card (what they are held
# against, if anything, a job wrote first): run by the script itself, in
# threads, each subprocess holding a slot. name: (function of the task's
# directory, the marker it waits for)
TASKS = {
    "train flagship 1 epoch + resume": (_train_resumed, "split.ready"),
    "train MNv3 --ema": (_train_ema, "split.ready"),
    "slice9 train K=4 flagship": (
        lambda root: _slice9_train(root, "flagship device pool"),
        "split.ready"),
    "slice9 train K=4 MNv3": (
        lambda root: _slice9_train(root, "MNv3 pinned host"), "split.ready"),
    "slice9 bench --check-ap": (lambda root: (_check_ap(), {})[1],
                                "kernels.timed"),
    "entry serve": (_serve_check, "entry.refs"),
    "entry detect": (_detect_check, "entry.refs"),
    "entry bench --bf16": (lambda root: (_bench_subprocess("--bf16"), {})[1],
                           "kernels.timed"),
    "entry bench --int8": (lambda root: (_bench_subprocess("--int8"), {})[1],
                           "kernels.timed"),
    "int8aug train --snow --clahe": (_snow_train, "split.ready"),
    "dp torchrun train": (_dp_torchrun, "split.ready"),
    "dp serve --dp": (_dp_entry_points, "entry.refs"),
    "tools real_model_overfit": (lambda root: _overfit(), "kernels.timed"),
    "tools zoo_bench": (_zoo_bench, "kernels.timed"),
    "tools serve_loadtest": (_loadtest, "split.ready"),
    "tools train_wallclock": (_wallclock, "kernels.timed"),
    "tools int8_ab": (lambda root: _int8_ab(), "kernels.timed"),
    "tools serving_bench flagship int8": (
        lambda root: _serving_bench("Double-YOLOv4-Fshare-Global-CSE3", True),
        "kernels.timed"),
    "tools visual": (_visual, "kernels.timed"),
    "slice15 split-concat": (_s15_split_task, "kernels.timed"),
    "slice15 s2d-train": (_s15_s2d_task, "kernels.timed"),
}
# the jobs and tasks of each --only name
ONLY = {name: [name] + [t for t in TASKS if t.split()[0] == name]
        for name in JOBS if name != "split"}
ONLY["entry"] = ["core"] + [t for t in TASKS if t.startswith("entry")]
SCRIPT_LIMIT_S = 1080    # the whole script's own limit, inside the 1200 s
                         # a smoke run is held to: past it every job still
                         # running is stopped and reported


def _groups(name: str) -> list:
    """The groups of phases of job ``name`` ("a+b": a, then b)."""
    return name.split("+")


def _spec(name: str):
    """(reads phase 9's split, has the card to itself, writes the markers,
    its time limit) of job ``name``."""
    groups = _groups(name)
    return (any(JOBS[g][1] for g in groups), any(JOBS[g][2] for g in groups),
            any(g in PRODUCERS for g in groups),
            sum(JOB_LIMIT_S[g] for g in groups))


def _job_main(name: str, shared: str) -> int:
    """``--job NAME SHARED``: one job in its own process, its groups of
    phases one after another; what it found goes to
    ``SHARED/NAME.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    sys.path.insert(0, ROOT)
    from double_yolo_kaist_torch.config.ir import compile_cfg
    from double_yolo_kaist_torch.ops import _build
    reads_split, _, produces, _ = _spec(name)
    root = shared if produces else os.path.join(shared, name)
    os.makedirs(root, exist_ok=True)
    j = _Job(name, root)
    j.shared = shared
    dev = torch.device("cuda", 0)
    _build.build_all()                # built by the script: loads them
    ir, fir = compile_cfg(MNV3_CFG), compile_cfg(FLAGSHIP_CFG)
    if reads_split and not produces:
        for f in SPLIT_FILES:
            os.symlink(os.path.join(shared, f), os.path.join(root, f))
    for g in _groups(name):
        JOBS[g][0](j, torch, dev, ir, fir)
    gib = 2.0 ** 30
    print(f"job {name}: peak device memory {torch.cuda.max_memory_allocated() / gib:.3f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / gib:.3f} GiB reserved; "
          f"failed {j.failed}", flush=True)
    with open(os.path.join(shared, f"{name}.json"), "w") as f:
        json.dump(dict(j.out, counts=j.counts, failed=j.failed), f)
    return 1 if j.failed else 0


def _card_processes() -> int:
    """Processes holding a context on the card, as nvidia-smi lists them."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=20)
    return len([x for x in r.stdout.splitlines() if x.strip()])


class _Monitor(threading.Thread):
    """The most processes on the card at once, read each second."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak, self.over, self.stopped = 0, 0, threading.Event()

    def run(self):
        prev = 0
        while not self.stopped.wait(1.0):
            try:
                n = _card_processes()
            except (OSError, subprocess.SubprocessError):
                continue
            self.peak = max(self.peak, n)
            # a process ending as the next starts can show once: two
            # readings in a row over the budget are a breach
            if n > CUDA_SLOTS and prev > CUDA_SLOTS:
                self.over += 1
            prev = n


def _dryrun_job(shared: str):
    """(c) of phase 17: ``python -m double_yolo_kaist_torch.dryrun 4``,
    four ranks on the card (its four slots); started here, by a process
    that holds no context."""
    out, err = (open(os.path.join(shared, f"dryrun.{k}"), "w")
                for k in ("out", "err"))
    with out, err:
        return subprocess.Popen([sys.executable, "-m",
                                 "double_yolo_kaist_torch.dryrun", "4"],
                                cwd=ROOT, env=dict(os.environ,
                                                   PYTHONPATH=ROOT),
                                stdout=out, stderr=err,
                                start_new_session=True)


def _start_job(name: str, shared: str):
    if name == "dryrun":
        return _dryrun_job(shared)
    out, err = (open(os.path.join(shared, f"{name}.{k}"), "w")
                for k in ("out", "err"))
    with out, err:
        return subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--job",
             name, shared],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
            stderr=err, start_new_session=True)


def _end_job(name, rc, took, shared, records, failed):
    """Print a job's output and collect what it wrote."""
    def read(k):
        with open(os.path.join(shared, f"{name}.{k}")) as f:
            return f.read()

    out, err = read("out"), read("err")
    state = ("timed out" if rc == "timeout" else f"exit {rc}")
    print(f"=== job {name}: {state} in {took:.1f} s ===", flush=True)
    sys.stdout.write(out if out.endswith("\n") or not out else out + "\n")
    if rc == "timeout":
        _failed(name, TimeoutError(
            f"the job timed out after {_spec(name)[3]} s"))
        failed.append(name)
    elif name == "dryrun":
        try:
            _sp_dryrun(rc, out, err, took)
        except Exception as e:             # noqa: BLE001
            _failed("spatial/(c) dryrun 4", e)
            failed.append("spatial/(c) dryrun 4")
    else:
        path = os.path.join(shared, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                records[name] = json.load(f)
            failed += [f"{name}/{p}" for p in records[name]["failed"]]
        if rc != 0 and not (name in records and records[name]["failed"]):
            _failed(name, RuntimeError(f"the job exited {rc}"))
            failed.append(name)
    if rc != 0:
        print(f"--- job {name}: the end of its standard error ---\n"
              f"{err[-4000:]}", file=sys.stderr, flush=True)


class _ThreadOut:
    """The script's stdout while tasks run in its threads: what a task's
    thread prints collects in its buffer (printed whole when the task
    ends), the rest goes straight through."""

    def __init__(self, real):
        self.real, self.bufs = real, {}

    def write(self, text):
        buf = self.bufs.get(threading.get_ident())
        if buf is None:
            return self.real.write(text)
        buf.append(text)
        return len(text)

    def flush(self):
        self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


def _task_root(shared: str, name: str) -> str:
    """A directory of the task's own (its caches and outputs), phase 9's
    split and core's references for phase 11 linked in."""
    root = os.path.join(shared, name.replace(" ", "_"))
    os.makedirs(root)
    for f in SPLIT_FILES + ("serve_alone.npz", "detect_counts.json"):
        if os.path.exists(os.path.join(shared, f)):
            os.symlink(os.path.join(shared, f), os.path.join(root, f))
    return root


def _start_task(name, shared, out, records, failed, lock, t_start):
    """Run task ``name`` in a thread; its output is printed as one block
    when it ends."""
    fn, _ = TASKS[name]

    def run():
        buf = out.bufs[threading.get_ident()] = []
        _TASK.priority = list(TASKS).index(name)
        t0 = time.perf_counter()
        ok = False
        try:
            root = _task_root(shared, name)
            records[name] = {"counts": fn(root) or {}, "failed": []}
            ok = True
        except Exception as e:             # noqa: BLE001 — report, go on
            buf.append(traceback.format_exc())
            _failed(name, e)
            with lock:
                failed.append(name)
        finally:
            del out.bufs[threading.get_ident()]
            with lock:
                out.real.write(
                    f"=== task {name}: {'passed' if ok else 'FAILED'} in "
                    f"{time.perf_counter() - t0:.1f} s (ended at "
                    f"{time.perf_counter() - t_start:.1f} s) ===\n"
                    + "".join(buf))
                out.real.flush()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _run_jobs(names, shared, t_start):
    """Run the jobs and tasks ``names`` (in JOBS' and TASKS' order of
    priority) under the card's budget; returns ({job or task: what it
    wrote}, [failed phases])."""
    import signal as sg
    pending = [n for n in names if n not in TASKS]
    tasks = [n for n in TASKS if n in names]
    producers = [n for n in pending if _spec(n)[2]]
    running, threads, records, failed = {}, {}, {}, []
    lock = threading.Lock()
    out = sys.stdout = _ThreadOut(sys.stdout)
    try:
        while pending or running or tasks or any(
                t.is_alive() for t in threads.values()):
            with lock:
                for name, (proc, t0, held) in list(running.items()):
                    rc = proc.poll()
                    took = time.perf_counter() - t0
                    if rc is None and (took > _spec(name)[3] or
                                       time.perf_counter() - t_start
                                       > SCRIPT_LIMIT_S):
                        try:
                            os.killpg(proc.pid, sg.SIGKILL)
                        except ProcessLookupError:
                            pass
                        proc.wait()
                        rc = "timeout"
                    if rc is not None:
                        _give_slots(held)
                        del running[name]
                        _end_job(name, rc, took, shared, records, failed)
            if time.perf_counter() - t_start > SCRIPT_LIMIT_S:
                for name in pending + tasks:
                    _failed(name, TimeoutError(
                        f"not started: the script's limit of "
                        f"{SCRIPT_LIMIT_S} s ran out"))
                    failed.append(name)
                pending, tasks = [], []
                if not running:
                    break          # tasks still running: their threads end
                                   # with the script, their processes are
                                   # stopped on its exit
            def ready(marker):
                if not producers or os.path.exists(os.path.join(shared,
                                                                marker)):
                    return True
                if not any(n in running or n in pending for n in producers):
                    raise RuntimeError(f"not started: {producers[0]} did "
                                       f"not write {marker}")
                return False

            want_slot = False
            for name in list(pending):
                reads_split, alone, produces, _ = _spec(name)
                marker = "split.ready" if reads_split else "kernels.timed"
                try:
                    go = produces or ready(marker)
                except RuntimeError as e:
                    _failed(name, e)
                    failed.append(name)
                    pending.remove(name)
                    continue
                if not go:
                    continue
                if alone and (running or any(t.is_alive() for t in
                                             threads.values()) or tasks):
                    break             # the card to itself: after the rest
                if len(running) >= MAX_MAINS:
                    break
                held = _take_slots(CUDA_SLOTS if name == "dryrun" else 1,
                                   wait=False, first=True)
                if not held:
                    want_slot = True
                    break
                running[name] = (_start_job(name, shared),
                                 time.perf_counter(), held)
                pending.remove(name)
                print(f"[{time.perf_counter() - t_start:.1f} s] job {name} "
                      f"started", flush=True)
            for name in list(tasks):
                try:
                    go = ready(TASKS[name][1])
                except RuntimeError as e:
                    _failed(name, e)
                    failed.append(name)
                    tasks.remove(name)
                    continue
                if go:
                    tasks.remove(name)
                    threads[name] = _start_task(name, shared, out, records,
                                                failed, lock, t_start)
            # while a job waits for a slot, the tasks' threads hold back
            (_JOBS_WAITING.set if want_slot else _JOBS_WAITING.clear)()
            time.sleep(0.2)
    finally:
        sys.stdout = out.real
        _JOBS_WAITING.clear()
    for name, t in threads.items():
        if t.is_alive():
            _failed(name, TimeoutError(f"still running at the script's "
                                       f"limit of {SCRIPT_LIMIT_S} s"))
            failed.append(name)
    return records, failed


def _kernels_line(records):
    """The result line's kernels: core's numbers, launches summed over
    every job's main-path runs."""
    core = next(r for r in records.values() if "results" in r)
    results, ek = core["results"], core["eval_kernels"]

    def launched(kernel):
        """Launches of ``kernel`` summed over the main-path runs of every
        job and task (each counted from 0 just before its run and read
        just after it): MNv3, flagship bf16 and int8, the eval runs, the
        graph replays and the micro-batched run of core; the Trainer's
        epoch of train; phase 8's runs again, the int8 modes and the edge
        eval of int8aug; the exported and Predictor replays of slice9 and
        its K-step train runs' evaluations; the mesh Predictors, the mesh
        evaluation and the ranks' Trainer fits of dp; the 2-D forwards and
        the 2-D mesh Predictor of spatial; the zoo's card forwards of
        tools, and the tools' runs; the split-concat request of
        slice15."""
        return sum(c.get(kernel, 0) for r in records.values()
                   for c in r["counts"].values())

    return [
        {"name": "K1 head decode", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/decode.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_decode.py:28",
         "launches": launched("decode_head"), **results["K1"],
         **ek["K1"], "library_ms": None},
        {"name": "K2 greedy NMS", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/nms.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_nms.py:34",
         "launches": launched("nms_indices"), **results["K2"],
         **ek["K2"], "library_ms": None},
        {"name": "K3 stem conv 3x3 s2", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/stem.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_stem.py:138",
         "launches": launched("stem_conv_s2"), **results["K3"],
         **ek["K3"]},
        {"name": "K4 int8 GEMM + epilogue", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/qgemm.cu",
         "replaces": "double_yolo_kaist_tpu/ops/pallas_qgemm.py:101",
         "launches": launched("qgemm"), **results["K4"], **ek["K4"]},
        {"name": "K5 bias + activation epilogue", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/bias_act.cu",
         "replaces": None, "launches": launched("bias_act"),
         **results["K5"]},
        # launches: one run of the probes' own entry point (breakdown)
        {"name": "K3 probes", "route": "cuda",
         "source": "double_yolo_kaist_torch/ops/csrc/stem.cu",
         "replaces": "tools/archive/stem_probe.py:99",
         **results["K3 probes"]},
    ]


def main(argv) -> int:
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
    from double_yolo_kaist_torch.ops import _build
    only = None
    if argv:
        if argv[0] != "--only" or not set(argv[1:]) <= set(ONLY) \
                or len(argv) < 2:
            return _fail(f"usage: chip_smoke.py [--only NAME ...]; names: "
                         f"{' '.join(ONLY)}")
        only = argv[1:]
    t_start = time.perf_counter()
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
    _IS_SCRIPT[0] = True
    shared = tempfile.mkdtemp(prefix="dyk_smoke_")
    slots = os.path.join(shared, "slots")
    os.makedirs(slots)
    os.environ[SLOTS_ENV] = slots
    os.environ["DYK_PEAK_MEMORY"] = os.path.join(shared, "peaks.jsonl")
    monitor = _Monitor()
    monitor.start()
    try:
        if only is None:
            names = list(RUN) + list(TASKS)
        else:
            picked = {x for n in only for x in ONLY[n]}
            if "core" not in picked and (
                    any(JOBS[n][1] for n in picked if n in JOBS)
                    or any(TASKS[n][1] != "kernels.timed" for n in picked
                           if n in TASKS)):
                picked.add("split")
            names = [n for n in list(JOBS) + list(TASKS) if n in picked]
        records, failed = _run_jobs(names, shared, t_start)
    finally:
        monitor.stopped.set()
        monitor.join()
    print(f"jobs done in {time.perf_counter() - t_start:.1f} s; processes "
          f"on the card at once (nvidia-smi, read each second): at most "
          f"{monitor.peak} (budget {CUDA_SLOTS})", flush=True)
    if monitor.over:
        _failed("load", RuntimeError(
            f"{monitor.peak} processes on the card at once, over the "
            f"budget of {CUDA_SLOTS}"))
        failed.append("load")
    peaks = os.path.join(shared, "peaks.jsonl")
    if os.path.exists(peaks):
        with open(peaks) as f:
            for x in f:
                r = json.loads(x)
                print(f"peak device memory: {r['allocated_gib']} GiB "
                      f"allocated, {r['reserved_gib']} GiB reserved: "
                      f"{r['argv'][:160]}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", flush=True)
        return 1
    if only is not None:
        print(f"chip_smoke --only {' '.join(only)}: passed", flush=True)
        return 0
    kernels = _kernels_line(records)
    if any(k["launches"] < 1 for k in kernels):
        print("chip_smoke: failed phases: launches (a kernel of the main "
              "path never launched)", flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--job"]:
        sys.exit(_job_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--check"]:
        sys.exit(_check_main(sys.argv[2], sys.argv[3]))
    _become_subreaper()
    try:
        rc = main(sys.argv[1:])
    finally:
        _stop_leftovers()
    sys.exit(rc)
