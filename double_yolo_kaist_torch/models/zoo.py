"""Named model zoo: the reference's model names -> cfg paths and baseline
numbers.

The port's copy of the JAX package's ``models/zoo.py`` (``MODELS``,
``FLAGSHIP``, ``cfg_path``, ``reference_fps``), so that every entry point
takes a model by name as well as by cfg path. It reads the repository's
``configs/`` only: an unknown name or a missing file raises.
"""

from __future__ import annotations

import os

CFG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                       "configs"))

# name -> (cfg filename, reference FPS, reference all-day AP@0.5 %)
MODELS = {
    "Visible-YOLOv3-Normal": ("kaist_yolov3.cfg", 72.14, 82.42),
    "Double-YOLOv3-Add-SL": ("kaist_dyolov3_add_sl.cfg", 43.94, 89.69),
    "Double-YOLOv3-CSE": ("kaist_dyolov3_concat_se.cfg", 42.19, 89.05),
    "Double-YOLOv3-Concat-Inception-SE":
        ("kaist_dyolov3_concat_seinc.cfg", 34.56, 89.13),
    "Double-YOLOv3-Fshare-CSE":
        ("kaist_dyolov3_fshare_concat_se.cfg", 33.69, 89.17),
    "Double-YOLOv3-Global-Fshare-CSE":
        ("kaist_dyolov3_fshare_global_concat_se.cfg", 38.70, 89.47),
    "Double-YOLOv3-Global-Fshare-CSE3":
        ("kaist_dyolov3_fshare_global_concat_se3.cfg", 42.57, 89.58),
    "Double-YOLOv3-Global-Fshare-Add-SL":
        ("kaist_dyolov3_fshare_global_add_sl.cfg", 41.07, 89.14),
    "Visible-YOLOv4-Normal": ("kaist_yolov4.cfg", 51.62, 84.72),
    "Double-YOLOv4-Add-SL": ("kaist_dyolov4_add_sl.cfg", 30.30, 89.09),
    "Double-YOLOv4-CSE": ("kaist_dyolov4_concat_se.cfg", 29.91, 89.79),
    "Double-YOLOv4-Fshare-Global-CSE3":
        ("kaist_dyolov4_fshare_global_concat_se3.cfg", 29.04, 90.22),
    "Visible-YOLOv4-MobileNetv2": ("kaist_yolov4_mobilenetv2.cfg", 72.69, 81.68),
    "Visible-YOLOv4-MobileNetv3": ("kaist_yolov4_mobilenetv3.cfg", 71.03, 80.80),
    "Double-YOLOv4-MNv2-Fshare-Global-CSE3":
        ("kaist_dyolov4_mobilenetv2_fshare_global_cse3.cfg", 44.95, 88.42),
    "Double-YOLOv4-MNv3-Fshare-Global-CSE3":
        ("kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg", 41.17, 87.26),
}

FLAGSHIP = "Double-YOLOv4-Fshare-Global-CSE3"


def cfg_path(name: str) -> str:
    """The cfg file of a zoo model, in the repository's ``configs/``."""
    if name not in MODELS:
        raise KeyError(f"unknown model '{name}'; known: {sorted(MODELS)}")
    path = os.path.join(CFG_DIR, MODELS[name][0])
    if not os.path.exists(path):
        raise FileNotFoundError(f"cfg of model '{name}' not found: {path}")
    return path


def reference_fps(name: str) -> float:
    """The reference's published FPS of a zoo model (its README's table:
    bs 1 on a Quadro RTX 6000; not a figure of this port)."""
    return MODELS[name][1]
