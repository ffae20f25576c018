"""Differentiable silhouette rasterization (port of the silhouette part of
``tssplat_tpu/ops/rasterize.py``).

  rasterize_silhouette_with_rows(pos_clip, edge_nbrs, (H, W))
      -> ids+1 (B,H,W) int32, z (B,H,W), g6 (B,6,H,W) differentiable
         winner screen rows, gaux (B,4,H,W), n_drop (B,)
  antialias_silhouette(ids, z, g6, gaux) -> (B,H,W) coverage; the sole
      source of coverage gradients (reference renderers/mesh_rasterizer.py:
      106-108, nvdiffrast dr.antialias semantics)

Visibility (binning + K1) runs without gradients. The winner rows carry
their gradient through ``winner_screen_rows``, whose backward folds the
per-pixel cotangents into per-face rows (K3) and lets autograd take them
back through the per-face screen table to the clip positions. The
antialias pass is one autograd.Function: K4 forward, K5 backward. Inputs
are in the corner layout (pos_clip (B,3F,4), face f = rows 3f..3f+2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import raster_kernels as rk
from .binning import bin_faces
from .screen import AREA_EPS, edge, pixel_centers, screen

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
                                   resolution: Tuple[int, int]):
    """Silhouette visibility + the winner's differentiable AA rows
    (``rasterize_silhouette_with_rows``, rasterize.py:794, kernel path).
    Returns (ids, z, g6, gaux, n_drop)."""
    F = edge_nbrs.shape[0]
    bins = bin_faces(pos_clip.detach(), edge_nbrs, resolution)
    with torch.no_grad():
        ids, z, g6k, gaux = rk.visibility(bins, resolution)
    g6 = winner_screen_rows(screen_xy_table(pos_clip, F), ids, g6k)
    return ids, z, g6, gaux, bins.n_drop


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
