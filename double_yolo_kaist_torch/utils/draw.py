"""PIL-based detection rendering (reference build_utils/draw_box_utils.py:
box + score label with a per-class color table, conf threshold 0.1).

The port's copy of the JAX package's ``utils/draw.py`` (numpy and PIL
only)."""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# a compact stable color table (the reference enumerates 120 named colors)
COLORS = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
]


def draw_boxes(img: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
               classes: np.ndarray, class_names: list | None = None,
               conf_thres: float = 0.1, width: int = 2) -> np.ndarray:
    """img: HWC uint8 RGB. boxes: (n, 4) xyxy abs. Returns a drawn copy."""
    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    try:
        font = ImageFont.load_default()
    except OSError:
        font = None
    for box, s, c in zip(boxes, scores, classes):
        if s < conf_thres:
            continue
        c = int(c)
        color = COLORS[c % len(COLORS)]
        x1, y1, x2, y2 = [float(v) for v in box]
        d.rectangle([x1, y1, x2, y2], outline=color, width=width)
        name = class_names[c] if class_names else str(c)
        label = f"{name} {s:.2f}"
        ty = max(y1 - 10, 0)
        d.text((x1 + 1, ty), label, fill=color, font=font)
    return np.asarray(im)
