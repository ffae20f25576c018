"""Small capped-layout scenes that corner the visibility kernels K2a/K2b:
the inputs on which the search inside each face's pixel box (the packed
(z, id) key, the fold of -0.0, the box rule, the padding of the candidate
matrix) could part from the walk that defines the result. The CPU tests
run the plain versions on them; the CUDA tests and ``chip_smoke.py`` run
the kernels on the same inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..mesh.spheres import tet_sphere
from ..mesh.tetmesh import TetMesh
from ..ops.binning import (CAP_TILE_H, CAP_TILE_W, CappedBins,
                           bin_faces_capped, capacity, face_table, next_pow2)
from ..ops.transform import fibonacci_views, transform_pos

Case = Tuple[CappedBins, Tuple[int, int]]

CASE_NAMES = ("spheres_64x128", "spheres_128x128", "spheres_k8_drops_64x128",
              "spheres_k8_drops_128x128", "twin_faces", "signed_zero",
              "fullscreen", "nan_and_behind_eye", "listed_everywhere",
              "more_than_a_pass", "all_tiles_empty",
              "vertices_on_pixel_centres")


def three_spheres(device, n_views: int = 2):
    """Three overlapping tet_sphere(0.12, radius=0.3) balls (534 faces) as
    one disjoint mesh: corner-layout clip positions (n_views, 3F, 4) and the
    edge neighbours (F, 3)."""
    parts = [tet_sphere(0.12, radius=0.3, center=c)
             for c in ((0.0, 0.0, 0.0), (0.2, 0.05, 0.0), (-0.1, 0.2, 0.1))]
    v = np.concatenate([p[0] for p in parts])
    offs = np.cumsum([0] + [p[0].shape[0] for p in parts])[:-1]
    t = np.concatenate([p[1] + o for p, o in zip(parts, offs)])
    mesh = TetMesh(v, t)
    corners = mesh.vtx[mesh.surface_vid[mesh.surface_fid].reshape(-1)]
    mvp, _, _ = fibonacci_views(n_views)
    pos = transform_pos(
        torch.tensor(mvp, dtype=torch.float32, device=device),
        torch.tensor(corners, dtype=torch.float32, device=device))
    nbrs = torch.tensor(mesh.surface_edge_neighbors(), device=device)
    return pos, nbrs


def clip_of_triangles(tris, device) -> torch.Tensor:
    """NDC triangles (B, F, 3, 3) = (x, y, z) per vertex -> corner-layout
    clip positions (B, 3F, 4) with w = 1."""
    tris = torch.as_tensor(tris, dtype=torch.float32, device=device)
    B, F = tris.shape[:2]
    w = torch.ones((B, F, 3, 1), dtype=torch.float32, device=device)
    return torch.cat([tris, w], dim=-1).reshape(B, 3 * F, 4)


def fullscreen_triangles(device, n_views: int = 1) -> torch.Tensor:
    """One triangle that covers every pixel (z = 0.5) with small ones in
    front of it (z = 0.2) and behind it (z = 0.8), of both orientations:
    clip positions (n_views, 3F, 4). The large face's box is the whole of
    every tile."""
    big = [[-1.5, -1.5, 0.5], [3.5, -1.5, 0.5], [-1.5, 3.5, 0.5]]
    tris = [big]
    rng = np.random.default_rng(0)
    for i in range(40):
        cx, cy = rng.uniform(-0.9, 0.9, 2)
        z = 0.2 if i % 2 else 0.8
        d = rng.uniform(0.02, 0.12)
        tri = [[cx - d, cy - d, z], [cx + d, cy - d, z], [cx, cy + d, z]]
        tris.append(tri if i % 4 < 2 else tri[::-1])
    return clip_of_triangles(np.array([tris] * n_views), device)


def _signed_zero(device) -> torch.Tensor:
    """Two overlapping triangles at depth +0.0 and -0.0 (which compare
    equal: the smaller id wins where both cover), in both orders: view 0
    has the smaller id at +0.0, view 1 at -0.0."""
    a = [[-0.8, -0.7, 0.0], [0.5, -0.6, 0.0], [-0.2, 0.8, 0.0]]
    b = [[-0.4, -0.8, -0.0], [0.9, -0.1, -0.0], [0.1, 0.7, -0.0]]

    def at(tri, z):
        return [[x, y, z] for x, y, _ in tri]

    return clip_of_triangles(np.array([[at(a, 0.0), at(b, -0.0)],
                                       [at(a, -0.0), at(b, 0.0)]]), device)


def _snapped_slivers(device, res, n_views: int = 2) -> torch.Tensor:
    """200 thin triangles a view (the third vertex 1e-3 .. 1e-7 of the
    length off the line of the first two) with every vertex moved onto the
    nearest pixel centre: edges run through pixel centres, where the edge
    functions are exactly 0, and the boxes' borders lie on pixels."""
    H, W = res
    rng = np.random.default_rng(4)
    F = 200
    a = rng.uniform(-1.1, 1.1, (n_views, F, 2))
    d = rng.uniform(-1.0, 1.0, (n_views, F, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    length = rng.uniform(0.01, 1.5, (n_views, F, 1))
    off = 10.0 ** rng.uniform(-7, -3, (n_views, F, 1))
    normal = np.stack([-d[..., 1], d[..., 0]], -1)
    c = a + d * length * rng.uniform(-0.5, 1.5, (n_views, F, 1)) \
        + normal * off
    xy = np.stack([a, a + d * length, c], 2)            # (B,F,3,2)
    n = np.array([W, H], dtype=np.float64)
    xy = (np.round((xy + 1.0) * 0.5 * n - 0.5) + 0.5) / n * 2.0 - 1.0
    z = rng.uniform(-0.9, 0.9, (n_views, F, 3, 1))
    return clip_of_triangles(np.concatenate([xy, z], -1), device)


def _listed_everywhere(pos, nbrs, res) -> CappedBins:
    """Every face a candidate of every tile (counts = F, k = next_pow2(F)
    padded with F), with rows the binning would never list: a NaN, an
    infinite and a huge coordinate under a non-zero inverse area, and a
    face behind the eye (inverse area 0)."""
    H, W = res
    pos = pos.clone()
    pos[:, 3 * 7: 3 * 7 + 3, 3] = -1.0           # face 7 behind the eye
    table, _, _ = face_table(pos, nbrs)
    B, F, _ = table.shape
    table[:, 11, 0] = float("nan")
    table[:, 12, 3] = float("inf")
    table[:, 13, 4] = -float("inf")
    table[:, 14, 2] = 1e30
    table[:, 15, 1] = -3e38
    nt = (H // CAP_TILE_H) * (W // CAP_TILE_W)
    k = next_pow2(F)
    cand = torch.full((B * nt, k), F, dtype=torch.int32, device=pos.device)
    cand[:, :F] = torch.arange(F, dtype=torch.int32, device=pos.device)
    counts = torch.full((B * nt,), F, dtype=torch.int32, device=pos.device)
    return CappedBins(table=table.contiguous(), counts=counts, cand=cand,
                      n_drop=torch.zeros(B, dtype=torch.int32,
                                         device=pos.device),
                      nty=H // CAP_TILE_H, ntx=W // CAP_TILE_W)


def capped_cases(device) -> Dict[str, Case]:
    """name -> (CappedBins with neighbour columns, resolution), one per
    name of CASE_NAMES."""
    pos, nbrs = three_spheres(device)
    F = int(nbrs.shape[0])
    cases = {}
    for res in ((64, 128), (128, 128)):
        tag = f"{res[0]}x{res[1]}"
        cases[f"spheres_{tag}"] = (
            bin_faces_capped(pos, nbrs, res, capacity(None, F, res)), res)
        cases[f"spheres_k8_drops_{tag}"] = (
            bin_faces_capped(pos, nbrs, res, 8), res)
    res = (64, 128)
    # the same faces twice under different ids: the smaller id wins
    cases["twin_faces"] = (
        bin_faces_capped(torch.cat([pos, pos], dim=1),
                         torch.cat([nbrs, nbrs]), res,
                         capacity(None, 2 * F, res)), res)
    cases["signed_zero"] = (bin_faces_capped(_signed_zero(device), None, res,
                                             128), res)
    cases["fullscreen"] = (bin_faces_capped(fullscreen_triangles(device, 2),
                                            None, (64, 256), 128), (64, 256))
    # a NaN vertex and a face behind the eye, as the binning sees them
    bad = pos.clone()
    bad[0, 3 * 5, 0] = float("nan")
    bad[:, 3 * 9: 3 * 9 + 3, 3] = -1.0
    cases["nan_and_behind_eye"] = (
        bin_faces_capped(bad, nbrs, res, capacity(None, F, res)), res)
    cases["listed_everywhere"] = (_listed_everywhere(pos, nbrs, res), res)
    # eight copies of every face in every tile: 4,272 candidates a tile, more
    # than the 4,096 the kernels stage in one pass
    cases["more_than_a_pass"] = (_listed_everywhere(
        torch.cat([pos[:1]] * 8, dim=1), torch.cat([nbrs] * 8), res), res)
    # no face in front of the eye: every tile has counts == 0
    gone = pos.clone()
    gone[..., 3] = -1.0
    cases["all_tiles_empty"] = (bin_faces_capped(gone, nbrs, res, 128), res)
    cases["vertices_on_pixel_centres"] = (bin_faces_capped(
        _snapped_slivers(device, (64, 256)), None, (64, 256), 256), (64, 256))
    if set(cases) != set(CASE_NAMES):
        raise AssertionError("CASE_NAMES is out of date")
    return cases
