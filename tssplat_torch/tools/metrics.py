"""Reconstruction quality metrics (port of ``tssplat_tpu/tools/metrics.py``):
the symmetric Chamfer-L2 over surface samples, the multi-view silhouette
IoU and the volume IoU over an occupancy grid. The reference publishes no
metric code; these are the standard GSO/DTU definitions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.queries import signed_distance
from ..ops.rasterize import rasterize_ids
from ..ops.transform import fibonacci_views, transform_pos


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on a triangle mesh (n,3), the JAX
    package's numpy draws (``sample_surface``, metrics.py:14)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-30)
    rng = np.random.default_rng(seed)
    fi = rng.choice(faces.shape[0], size=n, p=p)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return (1 - r1) * v0[fi] + r1 * (1 - r2) * v1[fi] + r1 * r2 * v2[fi]


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 512,
                     device: DeviceLike = None) -> float:
    """Symmetric Chamfer-L2, mean_a min_b ||a-b||² + mean_b min_a ||a-b||²,
    in f32 on ``device``, ``chunk`` points of one side at a time."""
    dev = resolve_device(device)
    a, b = _f32(a, dev), _f32(b, dev)

    def one_side(x, y):
        mins = []
        for s in range(0, x.shape[0], chunk):
            d = x[s:s + chunk, None, :] - y[None]
            mins.append((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                         + d[..., 2] * d[..., 2]).amin(dim=1))
        return torch.cat(mins)

    return float(torch.mean(one_side(a, b)) + torch.mean(one_side(b, a)))


def mesh_chamfer(verts_a, faces_a, verts_b, faces_b, n: int = 30000,
                 seed: int = 0, device: DeviceLike = None) -> float:
    """Chamfer-L2 of ``n`` samples of each surface (seeds seed, seed + 1)."""
    return chamfer_distance(sample_surface(verts_a, faces_a, n, seed),
                            sample_surface(verts_b, faces_b, n, seed + 1),
                            device=device)


def silhouette_iou(verts_a, faces_a, verts_b, faces_b, n_views: int = 12,
                   resolution: int = 128, device: DeviceLike = None) -> float:
    """Silhouette IoU over ``fibonacci_views(n_views)`` at resolution²,
    pixels counted over all views, each silhouette from the brute-force
    ``rasterize_ids`` (``silhouette_iou``, metrics.py:58). Robust where
    volume_iou's nearest-face sign misfires on self-overlapping
    components."""
    dev = resolve_device(device)
    mvp, _, _ = fibonacci_views(n_views)
    mvp = _f32(mvp, dev)

    def sil(v, f):
        pos = transform_pos(mvp, _f32(v, dev))
        ids = rasterize_ids(pos, torch.as_tensor(np.asarray(f), device=dev),
                            (resolution, resolution))
        return ids.cpu().numpy() > 0

    a = sil(verts_a, faces_a)
    b = sil(verts_b, faces_b)
    return float(np.logical_and(a, b).sum()
                 / max(np.logical_or(a, b).sum(), 1))


def volume_iou(verts_a, faces_a, verts_b, faces_b, dim: int = 64,
               bound: float = None, device: DeviceLike = None) -> float:
    """Occupancy IoU on a dim³ grid over [-bound, bound]³ (default 1.05 x
    the largest |coordinate| of either mesh), inside where the signed
    distance is negative (``volume_iou``, metrics.py:81). The nearest-face
    sign assumes locally clean geometry: prefer silhouette_iou for unions
    of overlapping components."""
    dev = resolve_device(device)
    va = np.asarray(verts_a)
    vb = np.asarray(verts_b)
    if bound is None:
        bound = 1.05 * max(np.abs(va).max(), np.abs(vb).max())
    lin = np.linspace(-bound, bound, dim).astype(np.float32)
    g = _f32(np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
             .reshape(-1, 3), dev)

    def occ(v, f):
        sd = signed_distance(g, _f32(v, dev), torch.as_tensor(
            np.asarray(f), dtype=torch.int64, device=dev))
        return sd.cpu().numpy() < 0

    oa, ob = occ(va, faces_a), occ(vb, faces_b)
    union = np.logical_or(oa, ob).sum()
    return float(np.logical_and(oa, ob).sum() / max(union, 1))
