"""Live single-modality inference sources (webcam / RTSP / video file).

The port's counterpart of the JAX package's ``data/streams.py`` (the
reference's unused LoadWebcam, other_utils/dataset.py:6-60): frames are read
with cv2 and, through :func:`iter_preprocessed`, letterboxed for the network
and yielded with the parameters that undo the letterbox.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class LoadStream:
    def __init__(self, source: str | int = 0, img_size: int = 512):
        import cv2

        self.source = int(source) if str(source).isdigit() else source
        self.img_size = img_size
        self.cap = cv2.VideoCapture(self.source)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open stream {source!r}")

    def __iter__(self):
        return self

    def __next__(self):
        ok, frame = self.cap.read()
        if not ok:
            self.cap.release()
            raise StopIteration
        return frame[:, :, ::-1]  # BGR -> RGB HWC uint8

    def close(self):
        self.cap.release()


def iter_preprocessed(stream: LoadStream, make_fn, device=None):
    """Wrap a stream with a letterbox fn built on the first frame.
    ``make_fn(src_hw, dst_hw, img_size)`` is
    :func:`.pipeline.make_eval_preprocess_fn`; ``dst_hw`` is the frame
    scaled to ``img_size`` and padded up to a multiple of 64. Yields (the
    letterboxed frame (1, H, W, 3) fp32 on ``device``, the frame, (ratio,
    pad, src_hw)). ``device``: None means ``cuda``."""
    device = resolve_device(device)
    fn = None
    meta = None
    s = stream.img_size
    for frame in stream:
        if fn is None:
            src_hw = frame.shape[:2]
            r = s / max(src_hw)
            dst = (int(np.ceil(src_hw[0] * r / 64) * 64),
                   int(np.ceil(src_hw[1] * r / 64) * 64))
            fn, ratio, pad = make_fn(src_hw, dst, s)
            meta = (ratio, pad, src_hw)
        x = torch.from_numpy(np.ascontiguousarray(frame)[None]).to(device)
        v, _ = fn(x, x)
        yield v, frame, meta
