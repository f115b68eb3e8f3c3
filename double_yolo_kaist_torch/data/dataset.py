"""Host-side KAIST paired-modality dataset reader.

The port's copy of the JAX package's ``data/dataset.py`` (host numpy, the
same code line for line; ``cv2`` and ``PIL`` are imported where they are
used). Directory and naming conventions follow the reference
(build_utils/kaist_dataset.py:38-186): a split .txt lists logical image
paths (``.../images/.../I01234.jpg``) that expand to ``*_visible.jpg`` /
``*_lwir.jpg`` siblings; labels live at ``images -> labels`` with a ``.txt``
suffix (class cx cy w h, normalized); a ``.shapes`` sidecar caches the
per-image (w, h); label arrays are cached to a ``.npy`` next to the labels.

The host reads files and decodes JPEGs; the transforms run on the device
(:mod:`.pipeline`). Rect-mode batch shapes (aspect-ratio sort -> per-batch
mod-32 shapes, kaist_dataset.py:105-133) are computed with the same float64
numpy expression as the JAX package's, so that ``ceil`` lands on the same
side.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _read_split(data_txt_path: str):
    with open(data_txt_path, "r") as f:
        lines = f.read().splitlines()
    img_files = [x for x in lines
                 if os.path.splitext(x)[-1].lower() == ".jpg"]
    if not img_files:
        raise FileNotFoundError(f"no .jpg entries in {data_txt_path}")
    return img_files


class KaistDataset:
    def __init__(self, data_txt_path: str, img_size: int = 512,
                 batch_size: int = 4, augment: bool = False,
                 hyp: dict | None = None, rect: bool = False,
                 single_cls: bool = False, snowflake: bool = False,
                 clahe: bool = False, pad: float = 0.0,
                 cache_images: str | None = None):
        data_txt_path = str(Path(data_txt_path))
        self.img_files = _read_split(data_txt_path)
        n = len(self.img_files)
        self.visible_files = [x.replace(".jpg", "_visible.jpg")
                              for x in self.img_files]
        self.lwir_files = [x.replace(".jpg", "_lwir.jpg")
                           for x in self.img_files]
        self.label_files = [
            x.replace("images", "labels").replace(
                os.path.splitext(x)[-1], ".txt")
            for x in self.img_files]

        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.hyp = hyp or {}
        self.rect = rect
        self.snowflake = snowflake
        self.clahe = clahe
        self.quadra = augment and not rect

        self.batch_index = np.floor(np.arange(n) / batch_size).astype(np.int32)
        n_batches = int(self.batch_index[-1]) + 1

        # per-image (w, h), from the .shapes sidecar or by reading headers
        shape_path = data_txt_path.replace(".txt", ".shapes")
        sp = None
        if os.path.exists(shape_path):
            with open(shape_path) as f:
                sp = [x.split() for x in f.read().splitlines()]
            if len(sp) != n:
                sp = None
        if sp is None:
            from PIL import Image
            sp = [Image.open(f).size for f in self.visible_files]
            np.savetxt(shape_path, sp, fmt="%g")
        self.shapes = np.asarray(sp, dtype=np.float64)

        if rect:
            ar = self.shapes[:, 1] / self.shapes[:, 0]      # h / w
            order = ar.argsort()
            self.img_files = [self.img_files[i] for i in order]
            self.visible_files = [self.visible_files[i] for i in order]
            self.lwir_files = [self.lwir_files[i] for i in order]
            self.label_files = [self.label_files[i] for i in order]
            self.shapes = self.shapes[order]
            ar = ar[order]
            shapes = [[1.0, 1.0]] * n_batches
            for b in range(n_batches):
                ar_b = ar[self.batch_index == b]
                mini, maxi = ar_b.min(), ar_b.max()
                if maxi < 1:
                    shapes[b] = [maxi, 1.0]
                elif mini > 1:
                    shapes[b] = [1.0, 1.0 / mini]
            self.batch_shapes = (np.ceil(
                np.asarray(shapes) * img_size / 32.0 + pad) * 32).astype(int)

        self.labels = self._load_labels(single_cls)

        # decoded-image cache (reference kaist_dataset.py --cache-images, in
        # RAM), plus a "disk" mode: raw uint8 .npy pairs, memmap-read
        # instead of decoding each JPEG again every epoch.
        if cache_images not in (None, "", "ram", "disk"):
            raise ValueError(f"cache_images must be None, 'ram' or 'disk', "
                             f"not {cache_images!r}")
        self.cache_mode = cache_images or None
        self._ram: list = [None] * n
        self._disk_dir = None
        if self.cache_mode == "disk":
            self._disk_dir = Path(data_txt_path).with_suffix(".imgcache")
            self._disk_dir.mkdir(exist_ok=True)
            # purge entries from the pre-path-key scheme ({index}.npy):
            # they are never read again and would sit next to the new
            # sha-keyed files, doubling the cache's disk footprint
            stale = [p for p in self._disk_dir.glob("*.npy")
                     if p.stem.isdigit()]
            for p in stale:
                try:
                    p.unlink()
                except OSError:
                    pass
            if stale:
                print(f"image cache: purged {len(stale)} stale "
                      f"position-keyed entries from {self._disk_dir}",
                      flush=True)

    def _disk_key(self, index: int) -> "Path":
        """Cache filename keyed by the SOURCE IMAGE PATH (hash), not the
        split-file position: if the split is edited, reordered, or
        regenerated, a position key would silently map stale entries onto
        the wrong visible/LWIR pairs. Path-keyed entries stay valid under
        any split reshuffle and simply miss for new images."""
        import hashlib

        h = hashlib.sha1(self.visible_files[index].encode()).hexdigest()[:20]
        return self._disk_dir / f"{h}.npy"

    # ------------------------------------------------------------------ labels

    def _load_labels(self, single_cls: bool):
        n = len(self.img_files)
        labels = [np.zeros((0, 5), np.float32)] * n
        cache = (str(Path(self.label_files[0]).parent)
                 + (".rect.npy" if self.rect else ".norect.npy"))
        if os.path.exists(cache):
            x = np.load(cache, allow_pickle=True)
            if len(x) == n:
                return list(x)
        found = 0
        for i, lf in enumerate(self.label_files):
            try:
                with open(lf) as f:
                    l = np.asarray([ln.split() for ln in f.read().splitlines()],
                                   np.float32)
            except OSError:
                continue
            if l.shape[0]:
                if l.shape[1] != 5:
                    raise ValueError(f"bad label file {lf}: {l.shape}")
                if (l < 0).any() or (l[:, 1:] > 1).any():
                    raise ValueError(f"non-normalized labels in {lf}")
                if single_cls:
                    l[:, 0] = 0
                labels[i] = l
                found += 1
        if found and n > 1000:
            try:
                np.save(cache, np.asarray(labels, dtype=object))
            except OSError:
                pass
        return labels

    # ------------------------------------------------------------------ access

    def __len__(self):
        return len(self.img_files)

    def load_pair(self, index: int):
        """Decode one visible/LWIR pair -> (v, l) uint8 RGB HWC at native
        size, via the RAM/disk cache when enabled (decode happens at most
        once per image; later epochs skip libjpeg entirely)."""
        if self.cache_mode == "ram" and self._ram[index] is not None:
            return self._ram[index]
        if self.cache_mode == "disk":
            p = self._disk_key(index)
            if p.exists():
                arr = np.load(p, mmap_mode="r")
                return np.ascontiguousarray(arr[0]), \
                    np.ascontiguousarray(arr[1])
        pair = self._decode_pair(index)
        if self.cache_mode == "ram":
            self._ram[index] = pair
        elif self.cache_mode == "disk":
            v, l = pair
            if v.shape == l.shape:
                p = self._disk_key(index)
                tmp = p.with_name("." + p.name + ".tmp")
                with open(tmp, "wb") as f:
                    np.save(f, np.stack([v, l]))
                os.replace(tmp, p)
        return pair

    def _decode_pair(self, index: int):
        import cv2

        v = cv2.imread(self.visible_files[index])
        l = cv2.imread(self.lwir_files[index])
        if v is None or l is None:
            raise FileNotFoundError(
                f"missing pair for {self.img_files[index]}")
        if v.shape[:2] != l.shape[:2]:
            raise ValueError(f"modality size mismatch at {index}")
        return np.ascontiguousarray(v[:, :, ::-1]), \
            np.ascontiguousarray(l[:, :, ::-1])     # BGR -> RGB

    def coco_index(self, index: int):
        """(labels, (h, w)) without any processing — for COCO gt assembly
        (reference kaist_dataset.py:390-396)."""
        return self.labels[index].copy(), self.shapes[index][::-1]

    def coco_ground_truth(self) -> dict:
        """img_id -> (m, 4) absolute xyxy gt boxes for eval/coco_map."""
        out = {}
        for i in range(len(self)):
            l, (h, w) = self.coco_index(i)
            if l.size == 0:
                out[i] = np.zeros((0, 4))
                continue
            cx, cy = l[:, 1] * w, l[:, 2] * h
            bw, bh = l[:, 3] * w, l[:, 4] * h
            out[i] = np.stack([cx - bw / 2, cy - bh / 2,
                               cx + bw / 2, cy + bh / 2], 1)
        return out
