"""The port's HTTP server: ``python -m double_yolo_kaist_torch.serve --device
cpu`` in a subprocess on the tiny cfg, with a checkpoint written from the
JAX package's ``graph.init`` (as ``tests/test_serve.py`` drives
``cli/serve.py``).

Every answer must equal the port's in-process Predictor on the same decoded
frame, served alone in one of the server's buckets (1, 4, 16): a frame's
detections depend on its own pixels and its bucket's size, not on the
frames beside it. /healthz carries the micro-batch stats, a bad body gets
400, and concurrent requests coalesce.
"""

import base64
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.serving import Predictor
from double_yolo_kaist_torch.utils import checkpoint as TCK
from tests.test_torch_slice import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 4, 16)
HW = (96, 128)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port, the in-process Predictor on the same weights)."""
    jir = jax_compile_cfg(TINY)          # the entry point's strides
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    ckpt = str(tmp_path_factory.mktemp("serve") / "ckpt")
    TCK.save_checkpoint(ckpt, params=jv["params"], bn_state=jv["state"])
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "double_yolo_kaist_torch.serve", "--cfg",
         TINY, "--weights", ckpt, "--img-size", "64", "--conf-thres",
         "0.005", "--device", "cpu", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except OSError:
                if proc.poll() is not None:
                    raise RuntimeError(proc.stdout.read())
                if time.time() > deadline:
                    raise TimeoutError("the server did not come up")
                time.sleep(0.5)
        ir = compile_cfg(TINY)
        pred = Predictor(ir, TW.from_jax_variables(ir, jv), img_size=64,
                         conf_thres=0.005, batch_buckets=BUCKETS,
                         device="cpu")
        yield port, pred
    finally:
        proc.kill()
        proc.wait(timeout=30)


def _post(port, body: bytes, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _raw_body(v):
    b64 = base64.b64encode(v.tobytes()).decode()
    return json.dumps({"visible": b64, "lwir": b64, "encoding": "raw",
                       "shape": list(v.shape[:2])}).encode()


def _in_process(pred, v):
    """The frame served alone in each bucket: {bucket: (boxes, scores,
    classes)} as JSON would carry them."""
    out = {}
    for b in BUCKETS:
        frames = np.zeros((b,) + v.shape, np.uint8)
        frames[0] = v
        boxes, scores, classes = pred(frames, frames)[0]
        out[b] = (boxes.tolist(), scores.tolist(), classes.tolist())
    return out


def _matches(answer, pred, v):
    got = (answer["boxes"], answer["scores"], answer["classes"])
    return any(got == want for want in _in_process(pred, v).values())


def _frame(seed):
    return np.random.default_rng(seed).integers(0, 256, HW + (3,),
                                                dtype=np.uint8)


def test_healthz_reports_microbatch_stats(served):
    port, _ = served
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
        out = json.loads(r.read())
    assert out["status"] == "ok" and out["model"] == os.path.basename(TINY)
    assert set(out["microbatch"]) == {"batches", "frames", "mean_batch",
                                      "size_hist"}


def test_detect_jpeg_equals_in_process(served):
    port, pred = served
    ok, buf = cv2.imencode(".jpg", _frame(0))
    assert ok
    b64 = base64.b64encode(buf.tobytes()).decode()
    out = _post(port, json.dumps({"visible": b64, "lwir": b64}).encode())
    decoded = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]
    assert set(out) == {"boxes", "scores", "classes"}
    assert _matches(out, pred, np.ascontiguousarray(decoded))


def test_detect_raw_equals_in_process(served):
    port, pred = served
    v = _frame(1)
    out = _post(port, _raw_body(v))
    assert len(out["boxes"]) > 0
    assert _matches(out, pred, v)


def test_bad_request_gets_400(served):
    port, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, b"not json", timeout=30)
    assert e.value.code == 400


def test_concurrent_requests_coalesce(served):
    """16 concurrent raw requests: each client gets its own frame's
    detections, and the dispatcher ran fewer batches than requests."""
    port, pred = served

    def stats():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            return json.loads(r.read())["microbatch"]

    before = stats()
    frames = [_frame(10 + i) for i in range(16)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
        outs = list(ex.map(lambda v: _post(port, _raw_body(v)), frames))
    after = stats()
    assert after["frames"] - before["frames"] == 16
    assert after["batches"] - before["batches"] < 16
    assert all(_matches(o, pred, v) for o, v in zip(outs, frames))
