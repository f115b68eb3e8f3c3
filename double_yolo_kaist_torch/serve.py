"""HTTP inference server over the batching Predictor.

    python -m double_yolo_kaist_torch.serve --cfg <model.cfg or zoo name> \\
        --weights <checkpoint dir, .pt or darknet .weights> [--int8] \\
        [--port 8321] [--device cuda]

POST /detect with a JSON body
  {"visible": <base64 jpg/png>, "lwir": <base64 jpg/png>}
or raw uint8 RGB frames
  {"visible": <base64 bytes>, "lwir": ..., "encoding": "raw", "shape": [H, W]}
-> {"boxes": [[x1, y1, x2, y2], ...], "scores": [...], "classes": [...]}
GET /healthz -> {"status": "ok", "model": ..., "microbatch": {stats}}

Mirrors the JAX package's ``cli/serve.py`` (stdlib ``http.server``; the
flags are its flags, plus ``--device``). Concurrent requests coalesce in a
:class:`.microbatch.MicroBatcher` (buckets 1, 4 and ``--microbatch``); on CUDA
each bucket is served from one CUDA graph, captured at startup unless
``--no-warmup``. ``--int8-qvars`` serves a quantized-variables artifact
(``python -m double_yolo_kaist_torch.calibrate --quantized-out``), or
writes this server's first quantization there. ``--exported <file>``
serves a one-file artifact (``python -m double_yolo_kaist_torch.
export_model``) through :class:`.export.ExportedPredictor`: the flags it
bakes in are refused or ignored, as in the JAX package, and the server
imports no model code. ``--dp N`` serves data-parallel over N replicas
(``-1``: every visible card; with ``--device cpu``, N CPU replicas): the
Predictor's mesh (:mod:`.parallel.mesh`).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import time
from http.server import BaseHTTPRequestHandler
from http.server import ThreadingHTTPServer as _ThreadingHTTPServer

import numpy as np


class ThreadingHTTPServer(_ThreadingHTTPServer):
    # the stdlib's listen backlog is 5: a burst of concurrent clients
    # overflows the accept queue and the kernel resets connections before
    # a handler runs
    request_queue_size = 128


def make_handler(predictor, model_name: str):
    """``predictor`` maps stacked frames to per-frame results: a
    :class:`.serving.Predictor` (called as ``predictor(v[None], l[None])``)
    or a :class:`.microbatch.MicroBatcher` (requests coalesce across handler
    threads)."""
    import cv2

    from .microbatch import MicroBatcher, QueueFull

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                payload = {"status": "ok", "model": model_name}
                if isinstance(predictor, MicroBatcher):
                    payload["microbatch"] = predictor.stats
                self._send(200, payload)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                if req.get("encoding") == "raw":
                    # decoded uint8 RGB HxWx3 frames, for services that
                    # already hold them (no JPEG decode on this host)
                    h, w = req["shape"]

                    def dec(b64):
                        a = np.frombuffer(base64.b64decode(b64), np.uint8)
                        return a.reshape(h, w, 3)
                else:
                    def dec(b64):
                        return cv2.imdecode(np.frombuffer(
                            base64.b64decode(b64), np.uint8),
                            cv2.IMREAD_COLOR)[:, :, ::-1]
                v = dec(req["visible"])
                l = dec(req["lwir"]) if "lwir" in req else v
                if isinstance(predictor, MicroBatcher):
                    boxes, scores, classes = predictor.submit(v, l)
                else:
                    (boxes, scores, classes), = predictor(v[None], l[None])
                self._send(200, {"boxes": boxes.tolist(),
                                 "scores": scores.tolist(),
                                 "classes": classes.tolist()})
            except QueueFull as e:  # shed load instead of queueing forever
                self._send(503, {"error": f"overloaded: {e}",
                                 "retry": True})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, default="")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--exported", type=str, default="",
                   help="serve a one-file exported artifact (python -m "
                        "double_yolo_kaist_torch.export_model)")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--conf-thres", type=float, default=0.1)
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 PTQ path (calibrates on the first "
                        "requests)")
    p.add_argument("--int8-mode", default="chain",
                   choices=("seed", "chain", "all", "edge", "spine",
                            "spineall"))
    p.add_argument("--int8-calib", default="",
                   help="calibration artifact (.npz): if it exists the "
                        "server starts quantized; otherwise the first "
                        "requests' stats are saved there")
    p.add_argument("--int8-qvars", default="",
                   help="quantized-variables artifact (.npz, python -m "
                        "double_yolo_kaist_torch.calibrate --quantized-out): "
                        "loads the finished int8 model; saved there after "
                        "the first quantization if missing")
    p.add_argument("--calibration-batches", type=int, default=2,
                   help="requests to gather activation stats from before "
                        "quantizing (--int8 without an --int8-calib "
                        "artifact)")
    p.add_argument("--calibration-pct", type=float, default=100.0,
                   help="max-abs calibration percentile (100.0 = exact "
                        "max-abs)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel serving over N devices (-1 = every "
                        "visible card): requests shard over the batch, the "
                        "weights are replicated")
    p.add_argument("--microbatch", type=int, default=16,
                   help="coalesce concurrent /detect requests into one "
                        "batched device call of up to this many frames; 0 "
                        "serves each request alone")
    p.add_argument("--microbatch-wait-ms", type=float, default=0.0,
                   help="hold the first request of a batch this long so "
                        "more arrivals join it")
    p.add_argument("--max-queue", type=int, default=256,
                   help="answer 503 once this many requests wait for the "
                        "device; 0 = unbounded")
    p.add_argument("--port", type=int, default=8321,
                   help="0: a free port, named in the 'serving on' line")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warmup (the first request of each "
                        "bucket then captures its graph)")
    p.add_argument("--warmup-hw", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="native frame size to warm up for (default: KAIST "
                        "512 640 scaled to --img-size)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    opt = p.parse_args(argv)

    if opt.exported:
        return serve_exported(opt)
    if not opt.cfg:
        raise SystemExit("--cfg is required (or pass --exported)")

    from .common import build_model
    from .microbatch import MicroBatcher
    from .serving import Predictor

    ir, variables = build_model(opt.cfg, opt.weights)
    mesh = make_serving_mesh(opt.dp, opt.device) if opt.dp else None
    # with micro-batching on, coalesced groups need padded batch buckets
    # beyond bs 1
    buckets = ((1,) if not opt.microbatch
               else tuple(sorted({1, 4, opt.microbatch})))
    predictor = Predictor(ir, variables, img_size=opt.img_size,
                          conf_thres=opt.conf_thres, batch_buckets=buckets,
                          int8=opt.int8, int8_mode=opt.int8_mode,
                          calibration_batches=opt.calibration_batches,
                          calibration_pct=opt.calibration_pct,
                          calibration=opt.int8_calib or None,
                          quantized=opt.int8_qvars or None,
                          device=opt.device, mesh=mesh)
    if not opt.no_warmup:
        h, w = opt.warmup_hw or (max(64, opt.img_size),
                                 max(64, int(opt.img_size * 1.25)))
        t0 = time.perf_counter()
        # Predictor.warmup, not predictor(dummy): a dummy request under
        # --int8 would take a calibration slot with zeros
        for b in buckets:
            predictor.warmup((h, w), batch=b)
        print(f"# warmup ({h}x{w}, buckets {list(buckets)}) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    if opt.microbatch:
        predictor = MicroBatcher(predictor, max_batch=opt.microbatch,
                                 max_wait_ms=opt.microbatch_wait_ms,
                                 max_queue=opt.max_queue or None)
    _serve(opt, predictor, os.path.basename(str(opt.cfg)), "serving on")


def make_serving_mesh(dp: int, device: str):
    """The mesh of ``--dp`` (JAX cli/serve.py:229-239): the first ``dp``
    visible cards (``-1``: all of them), or ``dp`` CPU replicas with
    ``--device cpu``."""
    import torch

    from .parallel import mesh as M

    if torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * (1 if dp < 0 else dp)
    else:
        from . import resolve_device
        resolve_device(device)
        visible = torch.cuda.device_count()
        n = visible if dp < 0 else dp
        if n > visible:
            raise SystemExit(f"--dp {n}: only {visible} device(s) visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    print(f"# data-parallel serving over {len(devs)} replica(s)", flush=True)
    return M.make_mesh(devs)


def _serve(opt, predictor, name: str, banner: str):
    """Serve until stopped; the banner names the port that was bound (the
    system's choice for ``--port 0``)."""
    from .microbatch import MicroBatcher

    server = ThreadingHTTPServer((opt.host, opt.port),
                                 make_handler(predictor, name))
    print(f"{banner} http://{opt.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if isinstance(predictor, MicroBatcher):
            predictor.close()


def serve_exported(opt):
    """``--exported``: serve an artifact (JAX ``cli/serve.py:172-217``).
    Everything about it was fixed at export time: flags that would change
    what it computes are refused, the rest are ignored with a note."""
    from .export import ExportedPredictor
    from .microbatch import MicroBatcher

    if opt.int8 or opt.dp:
        raise SystemExit(
            "--exported bakes precision and replica layout into the "
            "artifact: re-export with python -m "
            "double_yolo_kaist_torch.export_model --int8 for int8, and "
            "scale out by running one server per card instead of --dp")
    ignored = [name for name, val, dflt in (
        ("--cfg", opt.cfg, ""), ("--weights", opt.weights, ""),
        ("--conf-thres", opt.conf_thres, 0.1),
        ("--img-size", opt.img_size, 512),
        ("--int8-calib", opt.int8_calib, ""),
        ("--int8-qvars", opt.int8_qvars, ""),
        ("--calibration-batches", opt.calibration_batches, 2),
        ("--calibration-pct", opt.calibration_pct, 100.0),
        ("--warmup-hw", opt.warmup_hw, None)) if val != dflt]
    if ignored:
        print(f"# --exported: ignoring {', '.join(ignored)} (baked into the "
              f"artifact at export time)", flush=True)
    predictor = ExportedPredictor(opt.exported, device=opt.device)
    if predictor.batch > 1:
        print(f"# note: artifact compiled for batch {predictor.batch}; this "
              f"server issues single-frame requests, each padded to "
              f"{predictor.batch} — export with --batch 1 for lowest "
              f"per-request latency", flush=True)
    if not opt.no_warmup:
        t0 = time.perf_counter()
        predictor.warmup()
        print(f"# warmup {predictor.src_hw} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    if opt.microbatch:
        # coalesced groups fill the artifact's batch instead of each
        # request padding it alone
        predictor = MicroBatcher(predictor, max_batch=opt.microbatch,
                                 max_wait_ms=opt.microbatch_wait_ms,
                                 max_queue=opt.max_queue or None)
    _serve(opt, predictor, os.path.basename(opt.exported),
           "serving exported artifact on")


if __name__ == "__main__":
    main()
