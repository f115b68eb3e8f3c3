"""Load test of ``python -m double_yolo_kaist_torch.serve``: N concurrent
clients against ``/detect``.

    # against a live server
    python -m double_yolo_kaist_torch.serve_loadtest --port 8321 \\
        [--concurrency 1 4 16] [--requests 64] [--payload jpeg|raw]
    # spawn a server first (its --cfg / --weights / --int8 / --microbatch)
    python -m double_yolo_kaist_torch.serve_loadtest --spawn --cfg <model> \\
        [--weights <ckpt>] [--int8] [--payload raw]
    # no HTTP: Predictor + MicroBatcher driven from threads in process
    python -m double_yolo_kaist_torch.serve_loadtest --inproc --cfg <model>

The port's counterpart of the JAX package's ``tools/serve_loadtest.py``.
Each level of ``--concurrency`` (up to 64) sends ``--requests`` requests
from that many client threads and prints one JSON line: ``rps``, ``p50_ms``,
``p95_ms``, ``p99_ms`` (host clock per request) and ``mean_batch``, the
frames per device batch the server's ``MicroBatcher`` formed over the
level (from ``/healthz``), with the batcher's ``stats`` themselves and the
card's name and power limit (``device``). Every bucket the batcher can hit
is warmed first. ``--payload raw`` sends decoded uint8 frames and so
leaves the server's JPEG decode out; ``jpeg`` (the default) includes it.

``--inproc`` drives :class:`.serving.Predictor` and
:class:`.microbatch.MicroBatcher` from threads with no HTTP, after
warming every bucket (1, 2, 4, 8, 16), and prints ``fps`` in place of
``rps``. Its weights are those ``serve`` would load (``--weights``, or
``graph.init``'s).
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

INPROC_BUCKETS = (1, 2, 4, 8, 16)
SPAWN_TIMEOUT_S = 1200      # for the spawned server to answer /healthz


def _percentiles(lat: list) -> dict:
    lat = np.asarray(sorted(lat))
    n = len(lat)
    return {"p50_ms": float(lat[n // 2] * 1e3),
            "p95_ms": float(lat[min(int(n * 0.95), n - 1)] * 1e3),
            "p99_ms": float(lat[min(int(n * 0.99), n - 1)] * 1e3)}


def _detect(port: int, payload: bytes, timeout: float = 600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect", data=payload,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
    if "boxes" not in body:
        raise RuntimeError(f"/detect answered {body}")
    return time.perf_counter() - t0


def run_level(port: int, payloads: list, conc: int, n_req: int) -> dict:
    """``n_req`` requests from ``conc`` client threads."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=conc) as ex:
        t0 = time.perf_counter()
        futs = [ex.submit(_detect, port, payloads[i % len(payloads)])
                for i in range(n_req)]
        lat = [f.result() for f in futs]
        wall = time.perf_counter() - t0
    return {"concurrency": conc, "requests": n_req, "rps": n_req / wall,
            **_percentiles(lat)}


def make_payloads(hw, kind: str) -> list:
    """8 request bodies of seeded ``hw`` frames, JPEG or raw."""
    rng = np.random.default_rng(0)
    payloads = []
    for _ in range(8):
        v = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        if kind == "raw":
            b64 = base64.b64encode(v.tobytes()).decode()
            payloads.append(json.dumps(
                {"visible": b64, "lwir": b64, "encoding": "raw",
                 "shape": list(hw)}).encode())
            continue
        import cv2

        ok, buf = cv2.imencode(".jpg", v)
        assert ok
        b64 = base64.b64encode(buf.tobytes()).decode()
        payloads.append(json.dumps({"visible": b64, "lwir": b64}).encode())
    return payloads


def run_inproc(args, label: str) -> list:
    """Threads submitting ndarray frames to a MicroBatcher over a
    Predictor in this process (no JSON, base64 or sockets)."""
    from .common import build_model
    from .microbatch import MicroBatcher
    from .models.zoo import FLAGSHIP
    from .serving import Predictor

    ir, variables = build_model(args.cfg or FLAGSHIP, args.weights)
    kw = {}
    if args.int8 and os.environ.get("DYK_INT8_QVARS"):
        kw["quantized"] = os.environ["DYK_INT8_QVARS"]
    pred = Predictor(ir, variables, img_size=args.img_size,
                     batch_buckets=INPROC_BUCKETS, int8=args.int8,
                     calibration_batches=1, device=args.device, **kw)
    mb = MicroBatcher(pred, max_batch=args.microbatch)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (*args.hw, 3), dtype=np.uint8)
              for _ in range(8)]

    def one(i):
        t0 = time.perf_counter()
        mb.submit(frames[i % len(frames)], frames[(i + 1) % len(frames)])
        return time.perf_counter() - t0

    # warm every bucket in turn (captures are one-time; int8 also
    # calibrates): a free-form concurrent warm-up mostly lands on buckets
    # 1 and max, and the first mid-size level would pay a capture
    for b in INPROC_BUCKETS:
        big = np.stack([frames[i % len(frames)] for i in range(b)])
        pred(big, big)
        pred(big, big)
    prev = mb.stats
    lines = []
    try:
        for conc in args.concurrency:
            with concurrent.futures.ThreadPoolExecutor(conc) as ex:
                t0 = time.perf_counter()
                lat = list(ex.map(one, range(args.requests)))
                wall = time.perf_counter() - t0
            cur = mb.stats
            db = cur["batches"] - prev["batches"]
            df = cur["frames"] - prev["frames"]
            prev = cur
            line = {"concurrency": conc, "requests": args.requests,
                    "fps": args.requests / wall, **_percentiles(lat),
                    "mean_batch": round(df / max(db, 1), 2),
                    "microbatch": cur, "device": label}
            print(json.dumps(line), flush=True)
            lines.append(line)
    finally:
        mb.close()
    return lines


def spawn_server(args):
    """``python -m double_yolo_kaist_torch.serve`` as a child of this
    process (in its process group), up once ``/healthz`` answers ok on the
    port its banner names (``--port 0``: one the system picked as the
    server bound it, so no other process can take it first). Returns
    (the process, that port)."""
    import threading

    cmd = [sys.executable, "-m", "double_yolo_kaist_torch.serve",
           "--cfg", args.cfg, "--img-size", str(args.img_size),
           "--microbatch", str(args.microbatch), "--port", str(args.port),
           "--warmup-hw", *map(str, args.hw), "--device", args.device]
    if args.weights:
        cmd += ["--weights", args.weights]
    if args.int8:
        cmd.append("--int8")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []

    def read():
        for x in proc.stdout:
            lines.append(x.rstrip("\n"))

    threading.Thread(target=read, daemon=True).start()
    port = None
    deadline = time.time() + SPAWN_TIMEOUT_S
    while time.time() < deadline:
        if port is None:
            on = [x for x in list(lines) if x.startswith("serving on http")]
            if on:
                port = int(on[0].rsplit(":", 1)[1])
                print(f"# spawned server bound port {port}", flush=True)
        if port is not None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if json.loads(r.read()).get("status") == "ok":
                        return proc, port
            except OSError:
                pass
        if proc.poll() is not None:
            time.sleep(0.5)               # the reader takes the last lines
            raise RuntimeError(f"serve exited {proc.returncode}:\n"
                               + "\n".join(lines[-30:]))
        time.sleep(0.5)
    stop_server(proc)
    raise TimeoutError(f"the server did not come up in {SPAWN_TIMEOUT_S} s")


def stop_server(proc) -> None:
    """Stop the spawned server (it starts no process of its own)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main(argv=None) -> list:
    """Runs the levels; returns their JSON lines as dicts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8321,
                    help="the server's port; with --spawn, 0 lets the "
                         "spawned server bind a free one")
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 640),
                    metavar=("H", "W"))
    ap.add_argument("--concurrency", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16])
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per concurrency level")
    ap.add_argument("--spawn", action="store_true",
                    help="spawn python -m double_yolo_kaist_torch.serve "
                         "first (with --cfg / --weights / --int8 / "
                         "--microbatch)")
    ap.add_argument("--cfg", default="")
    ap.add_argument("--weights", default="")
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--microbatch", type=int, default=16)
    ap.add_argument("--payload", choices=("jpeg", "raw"), default="jpeg",
                    help="request encoding: 'jpeg' includes the server's "
                         "image decode; 'raw' sends decoded uint8 frames")
    ap.add_argument("--inproc", action="store_true",
                    help="no HTTP: Predictor + MicroBatcher in process, "
                         "driven from threads")
    ap.add_argument("--device", default="cuda",
                    help="the server's torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    if max(args.concurrency) > 64:
        raise SystemExit("--concurrency goes up to 64")

    from . import resolve_device
    from .common import card_label

    label = card_label(resolve_device(args.device))
    if args.inproc:
        return run_inproc(args, label)

    payloads = make_payloads(tuple(args.hw), args.payload)
    proc, port = spawn_server(args) if args.spawn else (None, args.port)

    def mb_stats():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as rr:
            return json.loads(rr.read()).get("microbatch") or {}

    lines = []
    try:
        # warm every bucket the batcher can hit
        run_level(port, payloads, max(args.concurrency),
                  2 * max(args.concurrency))
        prev = mb_stats()
        for conc in args.concurrency:
            r = run_level(port, payloads, conc, args.requests)
            cur = mb_stats()
            if cur:
                db = cur["batches"] - prev.get("batches", 0)
                df = cur["frames"] - prev.get("frames", 0)
                r["mean_batch"] = round(df / max(db, 1), 2)
                r["microbatch"] = cur
                prev = cur
            r["device"] = label
            print(json.dumps(r), flush=True)
            lines.append(r)
    finally:
        if proc is not None:
            stop_server(proc)
    return lines


if __name__ == "__main__":
    main()
