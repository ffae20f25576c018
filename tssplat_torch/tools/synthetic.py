"""Silhouette targets of a fixed surface mesh, rendered by the port's own
forward pass (the alpha channel of ``tssplat_tpu/tools/synthetic.py``
``render_views_of_mesh``): visibility (K1) and antialias (K4) over the
mesh's faces in the corner layout; and the benchmark scene built on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.tet_geometry import TetMeshGeometry
from ..mesh.spheres import icosphere, tet_sphere
from ..mesh.surface import triangle_edge_neighbors
from ..mesh.tetmesh import TetMesh
from ..ops.rasterize import (antialias_silhouette,
                             rasterize_silhouette_with_rows)
from ..ops.transform import fibonacci_views, transform_pos


@torch.no_grad()
def render_alpha_of_mesh(verts, faces, mvp, resolution: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Antialiased alpha (B,H,W,1) f32 of surface mesh (verts (N,3), faces
    (F,3)) for the views mvp (B,4,4), on ``device``."""
    dev = resolve_device(device)
    faces = np.asarray(faces, np.int64)
    corners = torch.as_tensor(np.asarray(verts)[faces.reshape(-1)],
                              dtype=torch.float32, device=dev)
    nbrs = torch.as_tensor(triangle_edge_neighbors(faces), device=dev)
    pos = transform_pos(torch.as_tensor(np.asarray(mvp), dtype=torch.float32,
                                        device=dev), corners)
    res = (int(resolution), int(resolution))
    ids, z, g6, gaux, _ = rasterize_silhouette_with_rows(pos, nbrs, res)
    return antialias_silhouette(ids, z, g6, gaux)[..., None]


def bench_scene(device: DeviceLike = None, n_views: int = 8,
                resolution: int = 512, edge_length: float = 0.03):
    """The geometry-stage benchmark scene of the repository (bench.py
    defaults): one TetSphere ``tet_sphere(edge_length, radius=0.25)``
    (0.03: 4,741 vertices, 26,426 tets, 2,012 faces) fitted to the
    silhouettes of the ellipsoid ``icosphere(3) * (0.30, 0.24, 0.18)`` seen
    from ``fibonacci_views(n_views)``. Returns (TetMeshGeometry, batch)
    with batch = {"mvp" (B,4,4), "img" (B,H,W,1) alpha} on ``device``."""
    dev = resolve_device(device)
    v, t = tet_sphere(edge_length, radius=0.25)
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(v, t), device=dev)
    sv, sf = icosphere(subdivisions=3)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, _, _ = fibonacci_views(n_views)
    batch = {"mvp": torch.tensor(mvp, dtype=torch.float32, device=dev),
             "img": render_alpha_of_mesh(sv, sf, mvp, resolution, device=dev)}
    return geo, batch
