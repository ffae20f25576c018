"""Targets of a fixed surface mesh, rendered by the port's own forward
pass (``tssplat_tpu/tools/synthetic.py`` ``render_views_of_mesh``, without
the Lambertian colour, which only the texture stage reads), and the scenes
built on them:

  bench_scene       the repository's geometry-stage benchmark (one sphere)
  multisphere_scene the production multi-sphere geometry at the size
                    where both capped visibility kernels run
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.multisphere import TetMeshMultiSphereGeometry
from ..geometry.tet_geometry import TetMeshGeometry, compute_vertex_normals
from ..mesh.spheres import icosphere, tet_sphere
from ..mesh.surface import triangle_edge_neighbors
from ..mesh.tetmesh import TetMesh
from ..ops.rasterize import (antialias_silhouette, interpolate, rasterize,
                             rasterize_silhouette_with_rows)
from ..ops.transform import fibonacci_views, transform_pos


def _corner_clip(verts, faces, mvp, dev):
    faces = np.asarray(faces, np.int64)
    corners = torch.as_tensor(np.asarray(verts)[faces.reshape(-1)],
                              dtype=torch.float32, device=dev)
    pos = transform_pos(torch.as_tensor(np.asarray(mvp), dtype=torch.float32,
                                        device=dev), corners)
    return faces, corners, pos


@torch.no_grad()
def render_alpha_of_mesh(verts, faces, mvp, resolution: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Antialiased alpha (B,H,W,1) f32 of surface mesh (verts (N,3), faces
    (F,3)) for the views mvp (B,4,4), on ``device``."""
    dev = resolve_device(device)
    faces, _, pos = _corner_clip(verts, faces, mvp, dev)
    nbrs = torch.as_tensor(triangle_edge_neighbors(faces), device=dev)
    res = (int(resolution), int(resolution))
    ids, z, g6, gaux, _ = rasterize_silhouette_with_rows(pos, nbrs, res)
    return antialias_silhouette(ids, z, g6, gaux)[..., None]


@torch.no_grad()
def render_views_of_mesh(verts, faces, mvp, campos, resolution: int,
                         device: DeviceLike = None):
    """Alpha (B,H,W,1), depth ||p - campos|| (B,H,W) and geometric normal
    (B,H,W,3) images of a fixed surface mesh, each zero on background
    (``render_views_of_mesh``, tools/synthetic.py:30)."""
    dev = resolve_device(device)
    alpha = render_alpha_of_mesh(verts, faces, mvp, resolution, device=dev)
    faces, corners, pos = _corner_clip(verts, faces, mvp, dev)
    rast, _ = rasterize(pos, (int(resolution), int(resolution)))
    v = torch.as_tensor(np.asarray(verts), dtype=torch.float32, device=dev)
    f = torch.as_tensor(faces, device=dev)
    nrm = interpolate(compute_vertex_normals(v, f)[f.reshape(-1)], rast)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                1e-8)
    fg = rast[..., 3:4] > 0
    wp = interpolate(corners, rast)
    cam = torch.as_tensor(np.asarray(campos), dtype=torch.float32, device=dev)
    depth = torch.linalg.norm(wp - cam[:, None, None, :], dim=-1) * fg[..., 0]
    return alpha, depth, nrm * fg


def _ellipsoid_targets(n_views: int):
    """The benchmark's target: ``icosphere(3) * (0.30, 0.24, 0.18)`` seen
    from ``fibonacci_views(n_views)``."""
    sv, sf = icosphere(subdivisions=3)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, _, campos = fibonacci_views(n_views)
    return sv, sf, mvp, campos


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
    sv, sf, mvp, _ = _ellipsoid_targets(n_views)
    batch = {"mvp": torch.tensor(mvp, dtype=torch.float32, device=dev),
             "img": render_alpha_of_mesh(sv, sf, mvp, resolution, device=dev)}
    return geo, batch


def multisphere_scene(device: DeviceLike = None, n_spheres: int = 18,
                      n_views: int = 8, resolution: int = 512):
    """The production multi-sphere geometry at benchmark views, as
    ``bench.py:67-108`` builds it with BENCH_SPHERES: ``n_spheres`` spheres
    of radius 0.16 centred on ``fibonacci_views(n_spheres, radius=0.18)``,
    through ``TetMeshMultiSphereGeometry`` init path A (18 spheres: 24,804
    vertices, 132,750 tets, 14,796 faces — the smallest such scene on which
    the JAX package takes the capped layout both with and without winner
    rows at 8 x 512²), fitted to the ellipsoid's alpha, depth and normal
    images. The key points and path A's files live in a temporary
    directory. Returns (geometry, batch) with batch = {"mvp", "campos"
    (B,3), "img" (B,H,W,1) alpha, "d" (B,H,W,1) depth, "n" (B,H,W,3)}."""
    dev = resolve_device(device)
    _, _, centers = fibonacci_views(n_spheres, radius=0.18)
    with tempfile.TemporaryDirectory(prefix="tss_spheres_") as tmp:
        kp = os.path.join(tmp, "kp.json")
        with open(kp, "w") as fh:
            json.dump({"pt": centers.tolist(), "r": [0.16] * n_spheres}, fh)
        geo = TetMeshMultiSphereGeometry(dict(
            use_smooth_barrier=True, key_points_file_path=kp,
            tetwild_cache_folder=os.path.join(tmp, "cache"),
            output_path=tmp), device=dev)
    sv, sf, mvp, campos = _ellipsoid_targets(n_views)
    alpha, depth, normal = render_views_of_mesh(sv, sf, mvp, campos,
                                                resolution, device=dev)
    batch = {"mvp": torch.tensor(mvp, dtype=torch.float32, device=dev),
             "campos": torch.tensor(campos, dtype=torch.float32, device=dev),
             "img": alpha, "d": depth[..., None], "n": normal}
    return geo, batch
