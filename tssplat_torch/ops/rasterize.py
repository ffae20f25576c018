"""Differentiable rasterization (port of ``tssplat_tpu/ops/rasterize.py``).

  rasterize_silhouette_with_rows(pos_clip, edge_nbrs, (H, W), k)
      -> ids+1 (B,H,W) int32, z (B,H,W), g6 (B,6,H,W) differentiable
         winner screen rows, gaux (B,4,H,W), n_drop (B,)
  antialias_silhouette(ids, z, g6, gaux) -> (B,H,W) coverage; the sole
      source of coverage gradients (reference renderers/mesh_rasterizer.py:
      106-108, nvdiffrast dr.antialias semantics)
  rasterize(pos_clip, (H, W), k) -> rast (B,H,W,4) = (u, v, z/w, id+1),
      n_drop (B,); perspective-correct and differentiable in u, v, z
  interpolate(attr, rast) -> (B,H,W,C) barycentric attributes
  antialias(rast, pos_clip, edge_nbrs) -> (B,H,W) coverage antialias of
      the ``rasterize`` path

Visibility (binning + K1, K2a or K2b) runs without gradients. Which
binning: the capped 8x128 layout (K2a without rows, K2b with) in exactly
the scenes where the JAX package takes it (``binning.uses_capped_layout``),
the uncapped 16x16 lists of K1 everywhere else. The winner rows carry their
gradient through ``winner_screen_rows``, whose backward folds the
per-pixel cotangents into per-face rows (K3) and lets autograd take them
back through the per-face screen table to the clip positions. The
antialias pass is one autograd.Function: K4 forward, K5 backward. Inputs
are in the corner layout (pos_clip (B,3F,4), face f = rows 3f..3f+2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import raster_kernels as rk
from .binning import (bin_faces, bin_faces_capped, capacity,
                      uses_capped_layout)
from .screen import AREA_EPS, W_EPS, edge, pixel_centers, screen

_INF = float("inf")


def rasterize_ids(pos_clip: torch.Tensor, tri: torch.Tensor,
                  resolution: Tuple[int, int], chunk: int = 64
                  ) -> torch.Tensor:
    """Brute-force oracle (``rasterize_ids``, rasterize.py:133): every face
    against every pixel in chunks of faces; (B,H,W) int32 winning id+1.
    Ties in z go to the smaller id (the chunk argmin keeps the first)."""
    H, W = resolution
    px, py = pixel_centers(resolution, pos_clip.device)
    sx, sy, sz, v_ok = screen(pos_clip.detach())
    out = []
    F = tri.shape[0]
    for b in range(pos_clip.shape[0]):
        best_z = torch.full((H, W), _INF, device=pos_clip.device)
        best_id = torch.zeros((H, W), dtype=torch.int32,
                              device=pos_clip.device)
        for s in range(0, F, chunk):
            t = tri[s:s + chunk].long()
            ax, ay = sx[b, t[:, 0]], sy[b, t[:, 0]]
            bx, by = sx[b, t[:, 1]], sy[b, t[:, 1]]
            cx, cy = sx[b, t[:, 2]], sy[b, t[:, 2]]
            ok = v_ok[b, t].all(dim=1)
            area = edge(ax, ay, bx, by, cx, cy)
            ok = ok & (torch.abs(area) > AREA_EPS)
            inv_area = torch.where(ok, 1.0 / torch.where(ok, area,
                                                         torch.ones_like(area)),
                                   torch.zeros_like(area))

            def e(p, q, r, s_):
                return edge(p[:, None, None], q[:, None, None],
                            r[:, None, None], s_[:, None, None], px[None],
                            py[None])

            ia = inv_area[:, None, None]
            l0 = e(bx, by, cx, cy) * ia
            l1 = e(cx, cy, ax, ay) * ia
            l2 = e(ax, ay, bx, by) * ia
            z = (l0 * sz[b, t[:, 0], None, None] + l1 * sz[b, t[:, 1], None, None]
                 + l2 * sz[b, t[:, 2], None, None])
            cov = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok[:, None, None] \
                & (z >= -1.0) & (z <= 1.0)
            z = torch.where(cov, z, torch.full_like(z, _INF))
            zmin, k = torch.min(z, dim=0)
            take = zmin < best_z
            best_z = torch.where(take, zmin, best_z)
            best_id = torch.where(take, (k + s + 1).to(torch.int32), best_id)
        out.append(best_id)
    return torch.stack(out)


def screen_xy_table(pos_clip: torch.Tensor, F: int) -> torch.Tensor:
    """Differentiable per-face screen rows (B,F,6) = (ax,bx,cx,ay,by,cy):
    the xy channels of ``_build_screen_table`` (rasterize.py:483) in the
    corner layout."""
    B = pos_clip.shape[0]
    sx, sy, _, _ = screen(pos_clip)
    return torch.cat([sx.view(B, F, 3), sy.view(B, F, 3)], dim=-1)


class _RowGather(torch.autograd.Function):
    """Per-pixel rows of a per-face table at the foreground pixels only:
    the backward adds each foreground pixel's cotangent into its face's
    row (``index_add_``) and never touches the background, which a dense
    gather's backward sums, millions of zero rows, into one dummy row."""

    @staticmethod
    def forward(ctx, tbl, ids):
        B, F, C = tbl.shape
        fg = ids > 0
        bidx = torch.arange(B, device=ids.device).view(B, 1, 1)
        t = (bidx * F + ids.long() - 1)[fg]              # (n_fg,) one sync
        out = tbl.new_zeros((*ids.shape, C))
        out[fg] = tbl.reshape(B * F, C)[t]
        ctx.save_for_backward(fg, t)
        ctx.tbl_shape = tbl.shape
        return out

    @staticmethod
    def backward(ctx, ct):
        fg, t = ctx.saved_tensors
        B, F, C = ctx.tbl_shape
        d = ct.new_zeros((B * F, C)).index_add_(0, t, ct[fg])
        return d.view(B, F, C), None


def _row_gather(tbl: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel rows (B,H,W,C) of the (B,F,C) face table at the winners
    ids+1 (B,H,W); background pixels get an all-zero row
    (``_row_gather``, rasterize.py:517)."""
    return _RowGather.apply(tbl, ids)


class _WinnerRows(torch.autograd.Function):
    """Value: the visibility kernel's winner rows g6. Gradient: per-pixel
    cotangents summed into per-face rows by K3 (``_wsr_bwd``,
    rasterize.py:537), handed to the table's own autograd."""

    @staticmethod
    def forward(ctx, tbl6, ids, g6_kernel):
        ctx.save_for_backward(ids)
        ctx.F = tbl6.shape[1]
        return g6_kernel            # autograd returns an alias, no copy

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        d_tbl = rk.wsr_table_grad(ids, ct.contiguous(), ctx.F)
        return d_tbl[:, :ctx.F], None, None


def winner_screen_rows(tbl6: torch.Tensor, ids: torch.Tensor,
                       g6_kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable winner rows whose value comes from the visibility
    kernel (equal to gathering ``tbl6`` at the winners, channel-major, zero
    on background) and whose gradient is the true one of that gather."""
    return _WinnerRows.apply(tbl6, ids, g6_kernel)


def rasterize_silhouette_with_rows(pos_clip: torch.Tensor,
                                   edge_nbrs: torch.Tensor,
                                   resolution: Tuple[int, int],
                                   k: Optional[int] = None):
    """Silhouette visibility + the winner's differentiable AA rows
    (``rasterize_silhouette_with_rows``, rasterize.py:794, kernel path):
    K2b over the capped layout where the JAX package caps (``k`` per tile,
    default ``default_tile_capacity``), else K1. Returns (ids, z, g6, gaux,
    n_drop)."""
    B, F = pos_clip.shape[0], edge_nbrs.shape[0]
    H, W = resolution
    pos = pos_clip.detach()
    with torch.no_grad():
        if uses_capped_layout(F, 14, B, H, W):
            bins = bin_faces_capped(pos, edge_nbrs, resolution,
                                    capacity(k, F, resolution))
            ids, z, g6k, gaux = rk.visibility_capped(bins, resolution)
        else:
            bins = bin_faces(pos, edge_nbrs, resolution)
            ids, z, g6k, gaux = rk.visibility(bins, resolution)
    g6 = winner_screen_rows(screen_xy_table(pos_clip, F), ids, g6k)
    return ids, z, g6, gaux, bins.n_drop


def _shade_rast(pos_clip: torch.Tensor, ids: torch.Tensor,
                resolution: Tuple[int, int]) -> torch.Tensor:
    """(u, v, z/w, id+1) of each pixel's winner (``_shade_rast``,
    rasterize.py:688): barycentrics recomputed from one row gather of the
    per-face screen table, perspective-corrected by 1/w, differentiable in
    pos_clip; zero on background."""
    B = pos_clip.shape[0]
    F = pos_clip.shape[1] // 3
    sx, sy, sz, valid = screen(pos_clip)
    iw = torch.where(valid, 1.0 / torch.clamp_min(pos_clip[..., 3], W_EPS),
                     torch.zeros_like(sx))
    tbl = torch.cat([a.view(B, F, 3) for a in (sx, sy, sz, iw)], dim=-1)
    g = _row_gather(tbl, ids)                            # (B,H,W,12)
    px, py = pixel_centers(resolution, pos_clip.device, pos_clip.dtype)

    ax, bx, cx = g[..., 0], g[..., 1], g[..., 2]
    ay, by, cy = g[..., 3], g[..., 4], g[..., 5]
    area = edge(ax, ay, bx, by, cx, cy)
    safe_area = torch.where(torch.abs(area) > AREA_EPS, area,
                            torch.ones_like(area))
    l0 = edge(bx, by, cx, cy, px, py) / safe_area
    l1 = edge(cx, cy, ax, ay, px, py) / safe_area
    l2 = edge(ax, ay, bx, by, px, py) / safe_area

    d0, d1, d2 = l0 * g[..., 9], l1 * g[..., 10], l2 * g[..., 11]
    s = d0 + d1 + d2
    s = torch.where(torch.abs(s) > W_EPS, s, torch.ones_like(s))
    u = d0 / s
    v = d1 / s
    zbuf = l0 * g[..., 6] + l1 * g[..., 7] + l2 * g[..., 8]
    fg = (ids > 0).to(pos_clip.dtype)
    return torch.stack([u * fg, v * fg, zbuf * fg, ids.to(pos_clip.dtype)],
                       dim=-1)


def rasterize(pos_clip: torch.Tensor, resolution: Tuple[int, int],
              k: Optional[int] = None):
    """Full rasterization (``rasterize``, rasterize.py:719): visibility by
    K2a over the capped layout where the JAX package caps (table R = 11),
    else by K1 without winner rows; then the differentiable shading of the
    winners. Returns (rast (B,H,W,4) = (u, v, z/w, id+1), n_drop (B,))."""
    B, F = pos_clip.shape[0], pos_clip.shape[1] // 3
    H, W = resolution
    pos = pos_clip.detach()
    with torch.no_grad():
        if uses_capped_layout(F, 11, B, H, W):
            bins = bin_faces_capped(pos, None, resolution,
                                    capacity(k, F, resolution))
            ids, _ = rk.visibility_capped_ids(bins, resolution)
        else:
            bins = bin_faces(pos, None, resolution)
            ids, _ = rk.visibility(bins, resolution, emit_g=False)
    return _shade_rast(pos_clip, ids, resolution), bins.n_drop


def interpolate(attr: torch.Tensor, rast: torch.Tensor) -> torch.Tensor:
    """Barycentric attribute interpolation (``interpolate``,
    rasterize.py:842, corner layout): attr (3F,C) shared by the views ->
    u*a0 + v*a1 + (1-u-v)*a2 (B,H,W,C), zero on background."""
    ids = rast[..., 3].detach().to(torch.int32)
    B = ids.shape[0]
    F, C = attr.shape[0] // 3, attr.shape[1]
    tbl = attr.reshape(1, F, 3 * C).expand(B, F, 3 * C)
    a = _row_gather(tbl, ids).view(*ids.shape, 3, C)
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    out = a[..., 0, :] * u + a[..., 1, :] * v + a[..., 2, :] * (1.0 - u - v)
    return out * (ids > 0)[..., None].to(out.dtype)


class _AntialiasSilhouette(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g6, ids, z, gaux):
        g6 = g6.contiguous()
        ctx.save_for_backward(g6, ids, z, gaux)
        return rk.aa_forward(ids, z, g6, gaux)

    @staticmethod
    def backward(ctx, ct):
        g6, ids, z, gaux = ctx.saved_tensors
        return rk.aa_backward(ids, z, g6, gaux, ct.contiguous()), \
            None, None, None


def antialias_silhouette(ids: torch.Tensor, z: torch.Tensor,
                         g6: torch.Tensor, gaux: torch.Tensor
                         ) -> torch.Tensor:
    """Antialiased silhouette coverage (B,H,W): ``antialias`` of the
    coverage colour (rasterize.py:975), equivalently
    ``antialias_silhouette_halo`` (:1153). Differentiable w.r.t. g6."""
    return _AntialiasSilhouette.apply(g6, ids, z, gaux)


def antialias(rast: torch.Tensor, pos_clip: torch.Tensor,
              edge_nbrs: torch.Tensor) -> torch.Tensor:
    """Antialiased coverage (B,H,W) of the ``rasterize`` path: ``antialias``
    (rasterize.py:975) of the colour clip(id, 0, 1) without precomputed
    rows. The winner rows' value is a plain gather of the face table (xy,
    edge neighbours, sign of the screen area); their gradient goes through
    ``winner_screen_rows`` (K3); K4/K5 run the pairs. The owner test uses
    the shaded z of ``rast``, as JAX's does."""
    ids = rast[..., 3].detach().to(torch.int32).contiguous()
    z = rast[..., 2].detach().contiguous()
    B, F = pos_clip.shape[0], edge_nbrs.shape[0]
    tbl6 = screen_xy_table(pos_clip, F)
    with torch.no_grad():
        t = tbl6.detach()
        area = edge(t[..., 0], t[..., 3], t[..., 1], t[..., 4], t[..., 2],
                    t[..., 5])
        nb = edge_nbrs.to(t.dtype).unsqueeze(0).expand(B, F, 3)
        rows = _row_gather(torch.cat([t, nb, torch.sign(area)[..., None]],
                                     dim=-1), ids).permute(0, 3, 1, 2)
    g6 = winner_screen_rows(tbl6, ids, rows[:, :6].contiguous())
    return antialias_silhouette(ids, z, g6, rows[:, 6:].contiguous())
