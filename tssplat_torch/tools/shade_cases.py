"""Inputs of the shaded path's per-pixel kernels (K6 shading, K7
interpolation, K8 the antialias rows) and their comparison with the plain
versions. ``shaded_inputs`` makes the inputs of one render from clip
positions and winners; ``shade_cases`` the small ones that corner the
kernels' runs and viewports; ``check_shaded`` holds every kernel to its
plain version on the card; ``shaded_bounds`` counts the bytes each needs.
The CUDA tests run ``check_shaded`` on ``shade_cases``; ``chip_smoke.py``
on the 18-sphere scene's inputs at gso.yaml's and at the Wonder3D cell's
shape, with the bounds beside its timings.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..mesh.spheres import tet_sphere
from ..mesh.tetmesh import TetMesh
from ..ops import raster_kernels as rk
from ..ops.binning import bin_faces
from ..ops.rasterize import _shade_table, rasterize_ids, screen_xy_table
from ..ops.transform import fibonacci_views, transform_pos
from .timing import bound_ms
from .vis_cases import fullscreen_triangles

CASE_NAMES = ("sphere_128x128", "sphere_72x90", "all_background",
              "fullscreen", "slab_above", "slab_below", "per_view_c5")


def shaded_inputs(pos: torch.Tensor, ids: torch.Tensor,
                  edge_nbrs: torch.Tensor, gen: torch.Generator,
                  viewport=None, channels=(3, 3), per_view=False) -> dict:
    """The inputs of one shaded render of clip positions ``pos`` (B,3F,4)
    with winners ``ids`` (B,H,W): K6's screen table, K8's xy table and
    edge neighbours, and one seeded attribute table per entry of
    ``channels`` (C channels, (1,F,3C) shared by the views or, with
    ``per_view``, (B,F,3C)), as the step's normals and positions are."""
    B, F = pos.shape[0], pos.shape[1] // 3
    attrs = [torch.randn((B if per_view else 1, F, 3 * c), generator=gen,
                         device=pos.device) for c in channels]
    return dict(ids=ids.contiguous(), tbl=_shade_table(pos).contiguous(),
                tbl6=screen_xy_table(pos, F).contiguous(),
                nbrs=edge_nbrs.long().contiguous(), attrs=attrs,
                viewport=viewport)


def _sphere(device, lens=1.0):
    """tet_sphere(0.12, radius 0.3) (178 faces) from 2 views, its x and y
    scaled by ``lens`` in clip space: (pos, edge neighbours)."""
    mesh = TetMesh(*tet_sphere(0.12, radius=0.3))
    corners = torch.tensor(mesh.vtx[mesh.surface_vid[mesh.surface_fid]
                                    .reshape(-1)], dtype=torch.float32,
                           device=device)
    mvp, _, _ = fibonacci_views(2)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32,
                                     device=device), corners)
    pos = pos * torch.tensor([lens, lens, 1.0, 1.0], device=device)
    return pos, torch.tensor(mesh.surface_edge_neighbors(), device=device)


def shade_cases(device) -> Dict[str, dict]:
    """``shaded_inputs`` of small renders that corner the kernels: the
    sphere at 128x128 (16-byte runs) and 72x90 (a width that is no multiple
    of four: scalar runs, a ragged last tile); every pixel background; a
    triangle over the whole screen with small ones before and behind it
    (one face over whole tiles); 48-row slabs of the sphere through a
    lens three times longer (its silhouette crosses the image's first and
    last rows) at row0 -8 and at row0 100 of a 128-row image (rows above
    and below the image); per-view attribute tables of 5 channels."""
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, res in (("sphere_128x128", (128, 128)),
                      ("sphere_72x90", (72, 90))):
        pos, nbrs = _sphere(device)
        ids = rk.visibility_plain(bin_faces(pos, None, res), res,
                                  emit_g=False)[0]
        out[name] = shaded_inputs(pos, ids, nbrs, gen)
    out["all_background"] = dict(out["sphere_128x128"],
                                 ids=torch.zeros_like(
                                     out["sphere_128x128"]["ids"]))
    pos = fullscreen_triangles(device, 2)
    F = pos.shape[1] // 3
    tri = torch.arange(3 * F, device=device).view(F, 3)
    out["fullscreen"] = shaded_inputs(
        pos, rasterize_ids(pos, tri, (128, 128)),
        torch.full((F, 3), -1, dtype=torch.int64, device=device), gen)
    pos, nbrs = _sphere(device, lens=3.0)
    tri = torch.arange(pos.shape[1], device=device).view(-1, 3)
    for name, row0 in (("slab_above", -8), ("slab_below", 100)):
        vp = (row0, 128)
        out[name] = shaded_inputs(
            pos, rasterize_ids(pos, tri, (48, 128), viewport=vp), nbrs, gen,
            viewport=vp)
    pos, nbrs = _sphere(device)
    ids = rk.visibility_plain(bin_faces(pos, None, (64, 128)), (64, 128),
                              emit_g=False)[0]
    out["per_view_c5"] = shaded_inputs(pos, ids, nbrs, gen, channels=(5,),
                                       per_view=True)
    return out


def _folds_agree(name, got, want, tol):
    """Each entry of a per-face fold within ``tol`` (1e-5 of the sum of
    |values| its row adds: float32 atomics in any order) of the plain
    fold. Returns the largest difference."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    if not bool((diff <= tol.double()).all()):
        raise AssertionError(f"{name}: differs from plain by up to "
                             f"{float(diff.max()):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


def _require_equal(name, got, want):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")


def check_shaded(inp: dict, gen: torch.Generator) -> dict:
    """Every kernel of the shaded path against its plain version on
    ``inp`` (``shaded_inputs``) under seeded cotangents: K6's rast, K7's
    output and d rast and K8's outputs equal; K6's and K7's table
    gradients each within 1e-5 of the sum of |values| its row adds.
    Returns {wrapper: max abs error}; raises AssertionError where a kernel
    disagrees."""
    ids, tbl, vp = inp["ids"], inp["tbl"], inp["viewport"]
    B, F = ids.shape[0], tbl.shape[1]
    err = {}
    rast = rk.shade(ids, tbl, vp)
    _require_equal("K6", [rast], [rk.shade_plain(ids, tbl, vp)])
    err["shade"] = 0.0
    ct = torch.randn(rast.shape, generator=gen, device=ids.device)
    d, b, f = rk._shade_grad_pixels(ids, tbl, ct, vp)
    err["shade_backward"] = _folds_agree(
        "K6's backward", rk.shade_backward(ids, tbl, ct, vp),
        rk._fold_rows(d, b, f, B, F), 1e-5 * rk._fold_rows(d.abs(), b, f,
                                                            B, F))
    err["interp"] = err["interp_backward"] = 0.0
    for attr in inp["attrs"]:
        out = rk.interp(rast, attr)
        _require_equal("K7", [out], [rk.interp_plain(rast, attr)])
        ct = torch.randn(out.shape, generator=gen, device=ids.device)
        d_tbl, d_rast = rk.interp_backward(rast, attr, ct)
        want_r, vals, view, vid = rk._interp_grad_pixels(rast, attr, ct)
        _require_equal("K7's d rast", [d_rast], [want_r])
        err["interp_backward"] = max(err["interp_backward"], _folds_agree(
            "K7's backward", d_tbl, rk._fold_rows(vals, view, vid, B, F),
            1e-5 * rk._fold_rows(vals.abs(), view, vid, B, F)))
    rows = rk.winner_rows(rast, inp["tbl6"], inp["nbrs"])
    _require_equal("K8", rows, rk.winner_rows_plain(rast, inp["tbl6"],
                                                    inp["nbrs"]))
    err["winner_rows"] = 0.0
    return err


def shaded_bounds(inp: dict) -> dict:
    """{wrapper: bound_ms(bytes, 0)}: the bytes each kernel needs on
    ``inp``, each input read once and each output written once, counting
    what these winners need: K6 the ids (4 B/px), rast (16 B/px) and the
    screen table read (48 B a row); its backward the ids, the cotangent at
    the foreground (16 B/px), the table read and its gradient written; K7
    (for the first attribute table, C channels) rast, the output (4C B/px)
    and the table; its backward rast, the cotangent at the foreground
    (4C B/px), d rast (16 B/px) and the table read and written (one row a
    view); K8 rast, its outputs (48 B/px: ids, z, six row planes, four aux
    planes), the xy table (24 B a row) and the neighbours (24 B a face)."""
    ids, tbl = inp["ids"], inp["tbl"]
    attr = inp["attrs"][0]
    B, F = ids.shape[0], tbl.shape[1]
    P, fg = ids.numel(), int((ids > 0).sum())
    C = attr.shape[-1] // 3
    return {
        "shade": bound_ms(20 * P + 48 * B * F, 0),
        "shade_backward": bound_ms(4 * P + 16 * fg + 2 * 48 * B * F, 0),
        "interp": bound_ms((16 + 4 * C) * P + 4 * attr.numel(), 0),
        "interp_backward": bound_ms(32 * P + 4 * C * fg + 4 * attr.numel()
                                    + 12 * C * B * F, 0),
        "winner_rows": bound_ms(64 * P + 24 * B * F + 24 * F, 0),
    }
