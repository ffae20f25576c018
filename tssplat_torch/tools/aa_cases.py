"""Small scenes that corner the antialias kernels K4/K5: the inputs on which
their tile of 8x128 pixels, runs of four pixels and pair list could part
from the plain versions. Each case is two views of NDC triangles (made from
a seed with numpy) rasterized by the plain visibility (K1's walk), so the
inputs are what the main path hands the kernels: (ids+1 (B,H,W) int32,
z (B,H,W), g6 (B,6,H,W), gaux (B,4,H,W)). The CPU tests hold the plain K4/K5
against JAX on them; the CUDA tests and ``chip_smoke.py`` hold the kernels
against the plain versions on the same inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..mesh.surface import triangle_edge_neighbors
from ..ops import raster_kernels as rk
from ..ops.binning import bin_faces
from .vis_cases import clip_of_triangles

Inputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

CASE_NAMES = ("tile_borders", "background_and_full_tile", "interior_edges",
              "shared_vertex", "owner_tie", "half_step", "one_pixel_faces",
              "dense_pairs", "image_border_72x100", "ragged_37x102")


def rasterized(tris, nbrs, res, device) -> Inputs:
    """NDC triangles (B, F, 3, 3) with edge neighbours (F, 3) (-1 on an
    open edge) -> the plain visibility's (ids, z, g6, gaux) at ``res``."""
    pos = clip_of_triangles(np.asarray(tris, dtype=np.float32), device)
    nb = torch.as_tensor(np.asarray(nbrs), dtype=torch.int64, device=device)
    return rk.visibility_plain(bin_faces(pos, nb, res), res)


def _px(i, n):
    """NDC of pixel edge i (between pixels i-1 and i) on an axis of n."""
    return 2.0 * i / n - 1.0


def _sheet(rng, nx, ny, x0, x1, y0, y1, jitter, z0, slope):
    """A jittered grid of nx x ny quads over [x0, x1] x [y0, y1], two
    triangles a quad, as (vertices (V,3), faces (F,3)); z is a plane plus
    noise. Interior vertices move by up to ``jitter`` cells, the border
    ones along the border only."""
    gx, gy = np.meshgrid(np.linspace(x0, x1, nx + 1),
                         np.linspace(y0, y1, ny + 1))
    dx, dy = (x1 - x0) / nx, (y1 - y0) / ny
    jx = rng.uniform(-jitter, jitter, gx.shape) * dx
    jy = rng.uniform(-jitter, jitter, gy.shape) * dy
    jx[:, [0, -1]] = 0.0
    jy[[0, -1], :] = 0.0
    v = np.stack([gx + jx, gy + jy], -1).reshape(-1, 2)
    z = z0 + slope * v[:, 0] + rng.uniform(-0.02, 0.02, v.shape[0])
    v = np.concatenate([v, z[:, None]], -1)
    idx = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    return v, faces


def _sheets(views):
    """Per-view (vertices, faces) of sheets of one grid -> (tris (B,F,3,3),
    their edge neighbours (F,3))."""
    tris = np.stack([v[f] for v, f in views])
    return tris, triangle_edge_neighbors(views[0][1])


def _soup(rng, n, lo, hi, size):
    """n random triangles of both orientations, centres in [lo, hi]^2."""
    c = rng.uniform(lo, hi, (n, 1, 2))
    off = rng.uniform(-size, size, (n, 3, 2))
    z = rng.uniform(-0.9, 0.9, (n, 3, 1))
    return np.concatenate([c + off, z], -1)


def aa_cases(device) -> Dict[str, Inputs]:
    """name -> (ids, z, g6, gaux), one per name of CASE_NAMES; B = 2."""
    cases = {}
    open3 = lambda F: -np.ones((F, 3), dtype=np.int64)  # noqa: E731

    # 64x256: sheets whose borders run along column 128 and row 32 (a
    # border of the kernels' tiles), within half a pixel of them (view 0 left
    # of and above the borders, view 1 right of and below), and one slanted
    # edge crossing both
    res = (64, 256)
    rng = np.random.default_rng(10)
    views = []
    for side in (0, 1):
        xs = (-0.8, 0.0) if side == 0 else (0.0, 0.8)
        ys = (-0.9, 0.0) if side == 0 else (0.0, 0.9)
        v, f = _sheet(rng, 12, 3, *xs, *ys, 0.3, 0.1, 0.2)
        # move the sheet's vertices on the tile borders by < 0.5 px
        on_x = np.isclose(v[:, 0], 0.0)
        v[:, 0] += on_x * rng.uniform(-0.9, 0.9, on_x.shape) / res[1]
        on_y = np.isclose(v[:, 1], 0.0)
        v[:, 1] += on_y * rng.uniform(-0.9, 0.9, on_y.shape) / res[0]
        views.append((v, f))
    tris, nb = _sheets(views)
    slant = np.array([[[[-0.5, -1.2, 0.5], [0.6, 1.3, 0.5],
                        [0.9, -1.1, 0.5]]]] * 2)
    cases["tile_borders"] = rasterized(
        np.concatenate([tris, slant], 1), np.concatenate([nb, open3(1)]),
        res, device)

    # one face over the whole of the top-left quarter (a tile) and beyond,
    # the bottom-right quarter background; view 1 holds nothing at all
    big = [[-1.5, -1.5, 0.3], [1.5, -1.5, 0.3], [-1.5, 1.5, 0.3]]
    away = [[3.0, 3.0, 0.3], [3.5, 3.0, 0.3], [3.0, 3.5, 0.3]]
    cases["background_and_full_tile"] = rasterized(
        [[big], [away]], open3(1), res, device)

    # a jittered mesh sheet: interior edges between neighbouring faces
    # differ and are not valid; its outline is a silhouette
    res = (16, 256)
    rng = np.random.default_rng(11)
    cases["interior_edges"] = rasterized(*_sheets(
        [_sheet(rng, 20, 4, -0.9, 0.85, -0.8, 0.7, 0.35, 0.0, s)
         for s in (0.3, -0.4)]), res, device)

    # a fan of triangles around one vertex, every other one left out: the
    # faces share the vertex and no edge
    res = (64, 128)
    rng = np.random.default_rng(12)
    views = []
    for cx, cy in ((0.03, -0.02), (-0.21, 0.13)):
        ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
        r = rng.uniform(0.3, 0.7, 12)
        ring = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1)
        tri = [[[cx, cy, 0.2], [*ring[i], 0.1 + 0.05 * i],
                [*ring[i + 1], 0.3]] for i in range(0, 12, 2)]
        views.append(tri)
    cases["shared_vertex"] = rasterized(views, open3(6), res, device)

    # faces at z = 0 exactly side by side and overlapping, not listed as
    # neighbours: both pixels of a pair have equal z (owner a on the tie)
    quads = []
    for x0 in (-0.7, -0.1):
        quads += [[[x0, -0.6, 0.0], [x0 + 0.62, -0.6, 0.0],
                   [x0 + 0.62, 0.5, 0.0]],
                  [[x0, -0.6, 0.0], [x0 + 0.62, 0.5, 0.0],
                   [x0, 0.5, 0.0]]]
    tie = np.array(quads)
    flip = tie.copy()
    flip[..., 1] *= -1.0
    cases["owner_tie"] = rasterized([tie, flip[:, ::-1]], open3(4), res,
                                    device)

    # rectangles whose edges lie on pixel edges of a power-of-two image:
    # every silhouette crossing is at t = 0.5 exactly, where the step's
    # derivative is 1/2
    res = (128, 128)
    views = []
    for (c0, c1, r0, r1) in ((17, 90, 30, 77), (40, 120, 5, 64)):
        x0, x1 = _px(c0, 128), _px(c1, 128)
        y0, y1 = _px(r0, 128), _px(r1, 128)
        views.append([[[x0, y0, 0.2], [x1, y0, 0.2], [x1, y1, 0.4]],
                      [[x0, y0, 0.2], [x1, y1, 0.4], [x0, y1, 0.4]]])
    cases["half_step"] = rasterized(views, [[-1, -1, 1], [0, -1, -1]], res,
                                    device)

    # faces that cover one pixel centre each: alone on the background, in
    # front of a larger face, and next to one another
    res = (64, 128)
    rng = np.random.default_rng(13)
    views = []
    for _ in range(2):
        cols = np.concatenate([rng.integers(1, 127, 30),
                               np.arange(60, 66)])
        rows = np.concatenate([rng.integers(1, 63, 30), np.full(6, 30)])
        tri = []
        for c, r in zip(cols, rows):
            x, y = _px(c + 0.5, 128), _px(r + 0.5, 64)
            hx, hy = 1.2 / 128, 1.2 / 64
            z = rng.uniform(-0.5, 0.0)
            tri.append([[x - hx * 0.5, y - hy * 0.4, z],
                        [x + hx * 0.5, y - hy * 0.4, z],
                        [x, y + hy * 0.6, z]])
        tri.append([[-0.6, -0.7, 0.5], [0.7, -0.5, 0.5], [0.0, 0.8, 0.5]])
        views.append(tri)
    cases["one_pixel_faces"] = rasterized(views, open3(37), res, device)

    # faces of about two pixels over most of the screen: nearly every pair
    # differs, so a tile's list fills nearly all of its kNP positions and
    # the lane-dealt loop runs at its longest
    res = (64, 256)
    rng = np.random.default_rng(16)
    cases["dense_pairs"] = rasterized(*_sheets(
        [_sheet(rng, 150, 40, -0.95, 0.95, -0.9, 0.9, 0.3, 0.0, s)
         for s in (0.2, -0.3)]), res, device)

    # random triangles over and past the image's border, on sizes that are
    # no multiple of the tile (72x100) and of the run of four (37x102)
    for name, res, seed in (("image_border_72x100", (72, 100), 14),
                            ("ragged_37x102", (37, 102), 15)):
        rng = np.random.default_rng(seed)
        tris = np.stack([_soup(rng, 40, -1.2, 1.2, 0.5) for _ in range(2)])
        cases[name] = rasterized(tris, open3(40), res, device)

    if set(cases) != set(CASE_NAMES):
        raise AssertionError("CASE_NAMES is out of date")
    return cases
