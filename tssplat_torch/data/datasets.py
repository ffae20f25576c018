"""Multi-view image datasets (host side, numpy): the port's own copy of
``tssplat_tpu/data/datasets.py`` (reference data/dataset.py).

  MitsubaImgDataset  ``img*rgba*.png`` + ``mvp_mtx_{id}.npy`` + ``mv_{id}.npy``
                     (+ optional ``depth_{id}.npy`` / ``normal_{id}.npy``);
                     campos = inv(mv)[:3,3] (dataset.py:119-199)
  BlenderImgDataset  the same layout (dataset.py:202-287)
  Wonder3DImgDataset six fixed named views; masked colours under
                     ``masked_colors1/`` with the alpha thresholded at 0.8,
                     normals under ``normals/`` remapped to [-1,1], both
                     resized bicubically (OpenCV); per-view
                     ``{view}_mvp.npy``; the capture is orthographic, so
                     mv == mvp and campos is a (0,0,1) placeholder
                     (dataset.py:18-116)
  ArrayDataset       in-memory arrays (synthetic targets, tests)

Every dataset exposes all_tgt_imgs (N,H,W,4), all_mvp_mats, all_mv_mats,
all_campos, all_tgt_ns, all_tgt_ds, bgs (white), resolution (square) and
spp = 1. Loading faults raise ValueError with the offending file.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..config import parse_structured


def _load_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im).astype(np.float32) / 255.0


def _check_finite(name: str, *arrays) -> None:
    for a in arrays:
        if not np.all(np.isfinite(a)):
            raise ValueError(f"non-finite values while loading {name}")


class _BaseViews:
    """Derived fields every dataset sets (reference dataset.py:29-40)."""

    def _finalize(self):
        n = len(self.all_tgt_imgs)
        if n == 0:
            raise ValueError("dataset is empty")
        h, w = self.all_tgt_imgs[0].shape[:2]
        self.bgs = [np.ones((h, w, 3), np.float32) for _ in range(n)]
        self.camera_p = self.all_mvp_mats[0] @ np.linalg.inv(
            self.all_mv_mats[0])
        self.camera_dist = float(np.linalg.norm(self.all_campos[0]))
        self.resolution = h
        self.spp = 1

    def __len__(self):
        return len(self.all_tgt_imgs)


class ArrayDataset(_BaseViews):
    """In-memory dataset of images (N,H,W,4), mvp and mv (N,4,4)."""

    def __init__(self, imgs, mvp, mv, campos=None, normals=None, depths=None):
        imgs = np.asarray(imgs, np.float32)
        self.all_tgt_imgs = list(imgs)
        self.all_mvp_mats = [np.asarray(m, np.float32) for m in mvp]
        self.all_mv_mats = [np.asarray(m, np.float32) for m in mv]
        if campos is None:
            campos = [np.linalg.inv(m)[:3, 3] for m in self.all_mv_mats]
        self.all_campos = [np.asarray(c, np.float32) for c in campos]
        z = [np.zeros_like(i) for i in self.all_tgt_imgs]
        self.all_tgt_ns = list(normals) if normals is not None else z
        self.all_tgt_ds = list(depths) if depths is not None else \
            [i[..., -1:] * 0 for i in self.all_tgt_imgs]
        self._finalize()


class MitsubaImgDataset(_BaseViews):
    @dataclass
    class Config:
        image_root: str = ""

    def __init__(self, cfg=None):
        self.cfg = parse_structured(self.Config, cfg)
        root = self.cfg.image_root
        if not os.path.isdir(root):
            raise ValueError(f"image_root is not a directory: {root}")

        self.all_tgt_imgs, self.all_mvp_mats, self.all_mv_mats = [], [], []
        self.all_campos, self.all_tgt_ns, self.all_tgt_ds = [], [], []
        files = sorted(glob.glob(os.path.join(root, "img*rgba*.png")))
        for img_file in files:
            img = _load_png(img_file)
            img_id = os.path.basename(img_file).split(".")[0].split("_")[-1]
            mvp = np.load(os.path.join(root, f"mvp_mtx_{img_id}.npy"))
            mv = np.load(os.path.join(root, f"mv_{img_id}.npy"))
            campos = np.linalg.inv(mv)[:3, 3]

            nf = os.path.join(root, f"normal_{img_id}.npy")
            n = np.load(nf) if os.path.exists(nf) else np.zeros_like(img)
            df = os.path.join(root, f"depth_{img_id}.npy")
            d = np.load(df)[..., None] if os.path.exists(df) \
                else np.zeros_like(img)

            _check_finite(img_file, img, mvp, mv, campos, d)
            self.all_tgt_imgs.append(img)
            self.all_mvp_mats.append(mvp.astype(np.float32))
            self.all_mv_mats.append(mv.astype(np.float32))
            self.all_campos.append(campos.astype(np.float32))
            self.all_tgt_ns.append(n)
            self.all_tgt_ds.append(d)
        self._finalize()


class BlenderImgDataset(MitsubaImgDataset):
    """The same on-disk layout (the reference class is a near-clone,
    dataset.py:202-287)."""


class Wonder3DImgDataset(_BaseViews):
    """The Wonder3D layout (``Wonder3DImgDataset``, datasets.py:123-186):
    ``camera_mvp_root/{view}_mvp.npy`` per named view, and beside
    ``image_root`` (its parent directory) ``masked_colors1/`` and
    ``normals/``, whose files are matched to views by the longest view
    name in the file name."""

    @dataclass
    class Config:
        camera_mvp_root: str = ""
        camera_views: List[str] = field(default_factory=lambda: [
            "front", "front_right", "right", "back", "left", "front_left"])
        image_root: str = ""
        resolution: int = 512

    def __init__(self, cfg=None):
        import cv2
        self.cfg = parse_structured(self.Config, cfg)
        c = self.cfg
        views = list(c.camera_views)
        res = int(c.resolution)
        mvps = [np.load(os.path.join(c.camera_mvp_root, f"{v}_mvp.npy"))
                for v in views]
        imgs: list = [None] * len(views)
        ns: list = [None] * len(views)

        def match_view(fname):
            """The longest view name in ``fname``: 'front' must not claim
            'front_right' files (the reference's first-match loop is
            order-sensitive, dataset.py:60-64)."""
            best = None
            for i, v in enumerate(views):
                if v in fname and (best is None or len(v) > len(views[best])):
                    best = i
            return best

        def resized(path):
            return cv2.resize(_load_png(path), (res, res),
                              interpolation=cv2.INTER_CUBIC)

        color_root = os.path.join(os.path.dirname(c.image_root),
                                  "masked_colors1")
        for f in sorted(os.listdir(color_root)):
            i = match_view(f)
            if i is not None:
                img = resized(os.path.join(color_root, f))
                img[..., 3] = np.where(img[..., 3] < 0.8, 0.0, 1.0)
                imgs[i] = img

        normal_root = os.path.join(os.path.dirname(c.image_root), "normals")
        if os.path.isdir(normal_root):
            for f in sorted(os.listdir(normal_root)):
                i = match_view(f)
                if i is not None:
                    n = resized(os.path.join(normal_root, f))
                    n[..., 0:3] = (n[..., 0:3] - 0.5) * 2.0
                    ns[i] = n

        self.all_tgt_imgs, self.all_mvp_mats, self.all_mv_mats = [], [], []
        self.all_campos, self.all_tgt_ns, self.all_tgt_ds = [], [], []
        for img, n, mvp in zip(imgs, ns, mvps):
            if img is None:
                continue
            self.all_tgt_imgs.append(img)
            self.all_tgt_ds.append(img[..., -1:])
            self.all_tgt_ns.append(n if n is not None else np.zeros_like(img))
            self.all_mvp_mats.append(mvp.astype(np.float32))
            # orthographic capture: mv == mvp, campos placeholder (:112-115)
            self.all_mv_mats.append(mvp.astype(np.float32))
            self.all_campos.append(np.asarray([0.0, 0.0, 1.0], np.float32))
        self._finalize()
