"""Differentiable rasterization (port of ``tssplat_tpu/ops/rasterize.py``).

  silhouette_visibility(pos_clip, edge_nbrs, (H, W), k)
      -> ids+1 (B,H,W) int32, z (B,H,W), g6 values (B,6,H,W), gaux
         (B,4,H,W), n_drop (B,), without gradient
  rasterize_silhouette_with_rows(pos_clip, edge_nbrs, (H, W), k, vis)
      -> the same with g6 the differentiable winner screen rows
  antialias_silhouette(ids, z, g6, gaux) -> (B,H,W) coverage; the sole
      source of coverage gradients (reference renderers/mesh_rasterizer.py:
      106-108, nvdiffrast dr.antialias semantics)
  visibility_ids(pos_clip, (H, W), k) -> ids+1, n_drop, without gradient
  rasterize(pos_clip, (H, W), k, vis) -> rast (B,H,W,4) = (u, v, z/w,
      id+1), n_drop (B,); perspective-correct and differentiable in u, v, z
  rasterize_silhouette(pos_clip, (H, W), k) -> rasterize's rast with
      u = v = 0 and no gradient, n_drop
  interpolate(attr, rast) -> (B,H,W,C) barycentric attributes of attr
      (3F,C) shared by the views or (B,3F,C) per view
  antialias(rast, pos_clip, edge_nbrs) -> (B,H,W) coverage antialias of
      the ``rasterize`` path
  antialias_rows(rast, tbl6, edge_nbrs) -> K4/K5's inputs (ids, z, g6,
      gaux) on that path, without gradient
  antialias_color(color, rast, pos_clip, edge_nbrs) -> (B,H,W,C) colour
      antialias (the texture stage), differentiable in the colour and, when
      pos_clip carries a gradient, in the positions (through K3)
  color_aa_weights(rast, pos_clip, edge_nbrs) -> (B,H,W,4) its weights
      toward each pixel's four neighbours, without gradient

Every renderer below takes an optional ``viewport=(row0, full_h)``: its H
rows are then a horizontal slab, absolute rows row0.. of a full_h-tall image
(row-slab spatial sharding, ``parallel/spatial.py``; JAX's viewport, row0
negative for a halo above the image). Binning shifts the faces into the
slab's tiles, the kernels and the shading take the absolute rows' pixel
centres, and the antialias cuts a vertical pair with a row outside the image.
The caller zeroes what a slab renders on rows outside the image, as
spatial.py:133-143 does.

Visibility (binning + K1, K2a or K2b) runs without gradients, and can be
run beforehand and handed in as ``vis`` (the view-chunked step keeps it
out of the recomputed part); its binning alone, ``visibility_bins``, can be
run beforehand and handed in as ``bins`` (the geometry step bins in front
of its CUDA graph, which replays the visibility kernel). Which
binning: the capped 8x128 layout (K2a without rows, K2b with) in exactly
the scenes where the JAX package takes it (``binning.uses_capped_layout``),
the uncapped 16x16 lists of K1 everywhere else. The winner rows carry their
gradient through ``winner_screen_rows``, whose backward folds the
per-pixel cotangents into per-face rows (K3) and lets autograd take them
back through the per-face screen table to the clip positions. The
antialias pass is one autograd.Function: K4 forward, K5 backward. Inputs
are in the corner layout (pos_clip (B,3F,4), face f = rows 3f..3f+2).

On the shaded path (``rasterize``, ``interpolate``, ``antialias_rows``) a
CUDA tensor takes K6 (the shading of the winners), K7 (the interpolation)
and K8 (the antialias rows), each reading its winners' rows straight from
the per-face table, K6 and K7 as autograd.Functions with a kernel backward;
a CPU tensor takes their plain versions, a row gather of the table
(``raster_kernels._row_gather``) and PyTorch's chain, differentiable by
autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn.functional import pad as F_pad

from ..utils.profiling import span
from . import raster_kernels as rk
from .binning import (CappedBins, CappedFront, bin_faces, capacity,
                      capped_back, capped_front, uses_capped_layout)
from .screen import AREA_EPS, W_EPS, edge, ndc_center, pixel_centers, screen

_INF = float("inf")


def rasterize_ids(pos_clip: torch.Tensor, tri: torch.Tensor,
                  resolution: Tuple[int, int], chunk: int = 64,
                  viewport=None) -> torch.Tensor:
    """Brute-force oracle (``rasterize_ids``, rasterize.py:133): every face
    against every pixel in chunks of faces; (B,H,W) int32 winning id+1.
    Ties in z go to the smaller id (the chunk argmin keeps the first).
    ``viewport=(row0, full_h)``: the H rows are a slab of the image, as
    for the renderers below."""
    H, W = resolution
    row0, full_h = viewport if viewport is not None else (0, None)
    px, py = pixel_centers(resolution, pos_clip.device, row0=row0,
                           full_h=full_h)
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


def _capacity_and_viewport(k, F, resolution, viewport):
    """The capped layout's k, sized on the whole image (JAX passes (full_h,
    W), pallas_raster.py:728-733), and the viewport as (row0, full_h)."""
    H, W = resolution
    row0, full_h = viewport if viewport is not None else (0, H)
    return capacity(k, F, (full_h, W)), (int(row0), int(full_h))


def visibility_front(pos_clip: torch.Tensor,
                     edge_nbrs: Optional[torch.Tensor],
                     resolution: Tuple[int, int], k: Optional[int] = None,
                     viewport=None) -> Optional[CappedFront]:
    """The capped layout's ``capped_front`` of the visibility pass (no
    gradient, no host read) where the JAX package caps (``k`` per tile,
    default ``default_tile_capacity``), else None (K1's uncapped lists).
    With ``edge_nbrs`` the table carries the winner rows' neighbours (K2b
    or K1 with rows, table R = 14), without them it does not (K2a, R =
    11). The layout is chosen on the (slab's) H x W."""
    if not _capped(pos_clip, edge_nbrs, resolution):
        return None
    cap, vp = _capacity_and_viewport(k, pos_clip.shape[1] // 3, resolution,
                                     viewport)
    return capped_front(pos_clip.detach(), edge_nbrs, resolution, cap, vp)


def _capped(pos_clip, edge_nbrs, resolution) -> bool:
    """Whether the visibility pass of these views takes the capped layout
    (``uses_capped_layout`` with the table's width)."""
    return uses_capped_layout(pos_clip.shape[1] // 3,
                              11 if edge_nbrs is None else 14,
                              pos_clip.shape[0], *resolution)


def visibility_bins(pos_clip: torch.Tensor,
                    edge_nbrs: Optional[torch.Tensor],
                    resolution: Tuple[int, int], k: Optional[int] = None,
                    viewport=None):
    """The binning of the visibility pass, without gradient: the capped
    layout's ``CappedBins`` (``visibility_front``, then ``capped_back``)
    where the JAX package caps, else K1's ``FaceBins``."""
    if not _capped(pos_clip, edge_nbrs, resolution):
        _, vp = _capacity_and_viewport(k, pos_clip.shape[1] // 3,
                                       resolution, viewport)
        return bin_faces(pos_clip.detach(), edge_nbrs, resolution, vp)
    with torch.no_grad(), span("tssplat.binning"):
        return capped_back(visibility_front(pos_clip, edge_nbrs, resolution,
                                            k, viewport))


def silhouette_visibility(pos_clip: torch.Tensor, edge_nbrs: torch.Tensor,
                          resolution: Tuple[int, int],
                          k: Optional[int] = None, viewport=None,
                          bins=None):
    """Silhouette visibility without gradient: ``visibility_bins`` (or its
    output ``bins`` made beforehand, with ``edge_nbrs``), then K2b over
    the capped layout, else K1. Returns (ids, z, the kernel's winner rows
    g6, gaux, n_drop), which ``rasterize_silhouette_with_rows`` takes as
    ``vis``."""
    with torch.no_grad(), span("tssplat.visibility"):
        if bins is None:
            bins = visibility_bins(pos_clip, edge_nbrs, resolution, k,
                                   viewport)
        if isinstance(bins, CappedBins):
            ids, z, g6k, gaux = rk.visibility_capped(bins, resolution)
        else:
            ids, z, g6k, gaux = rk.visibility(bins, resolution)
    return ids, z, g6k, gaux, bins.n_drop


def rasterize_silhouette_with_rows(pos_clip: torch.Tensor,
                                   edge_nbrs: torch.Tensor,
                                   resolution: Tuple[int, int],
                                   k: Optional[int] = None, vis=None,
                                   viewport=None, bins=None):
    """Silhouette visibility + the winner's differentiable AA rows
    (``rasterize_silhouette_with_rows``, rasterize.py:794, kernel path):
    ``silhouette_visibility`` (on ``bins`` where given), or its outputs
    ``vis`` computed beforehand, and the rows' gradient path. Returns
    (ids, z, g6, gaux, n_drop)."""
    ids, z, g6k, gaux, n_drop = vis if vis is not None else \
        silhouette_visibility(pos_clip, edge_nbrs, resolution, k, viewport,
                              bins)
    g6 = winner_screen_rows(screen_xy_table(pos_clip, edge_nbrs.shape[0]),
                            ids, g6k)
    return ids, z, g6, gaux, n_drop


class _Shade(torch.autograd.Function):
    """K6: the shading of the winners from the per-face screen table,
    forward and backward; autograd takes the table's gradient on to
    pos_clip."""

    @staticmethod
    def forward(ctx, tbl, ids, viewport):
        ctx.save_for_backward(tbl, ids)
        ctx.viewport = viewport
        return rk.shade(ids, tbl, viewport)

    @staticmethod
    def backward(ctx, ct):
        tbl, ids = ctx.saved_tensors
        return rk.shade_backward(ids, tbl, ct.contiguous(),
                                 ctx.viewport), None, None


def _shade_table(pos_clip: torch.Tensor) -> torch.Tensor:
    """Differentiable per-face screen table (B,F,12) = (ax,bx,cx, ay,by,cy,
    z0,z1,z2, iw0,iw1,iw2) of the corner layout: the C = 12 table of
    ``_build_screen_table`` (rasterize.py:483), 1/w zero where w is
    invalid."""
    B = pos_clip.shape[0]
    F = pos_clip.shape[1] // 3
    sx, sy, sz, valid = screen(pos_clip)
    iw = torch.where(valid, 1.0 / torch.clamp_min(pos_clip[..., 3], W_EPS),
                     torch.zeros_like(sx))
    return torch.cat([a.view(B, F, 3) for a in (sx, sy, sz, iw)], dim=-1)


def _shade_rast(pos_clip: torch.Tensor, ids: torch.Tensor,
                viewport=None) -> torch.Tensor:
    """(u, v, z/w, id+1) of each pixel's winner (``_shade_rast``,
    rasterize.py:688): barycentrics recomputed from the winner's row of
    the per-face screen table, perspective-corrected by 1/w,
    differentiable in pos_clip; zero on background. K6 on the card; its
    plain version (a row gather and PyTorch's chain) on the CPU."""
    tbl = _shade_table(pos_clip)
    if ids.is_cuda:
        return _Shade.apply(tbl, ids, viewport)
    return rk.shade_plain(ids, tbl, viewport)


def visibility_ids(pos_clip: torch.Tensor, resolution: Tuple[int, int],
                   k: Optional[int] = None, viewport=None, bins=None):
    """Visibility without winner rows and without gradient:
    ``visibility_bins`` without neighbours (or its output ``bins`` made
    beforehand), then K2a over the capped layout, else K1 without rows.
    Returns (ids, n_drop), which ``rasterize`` takes as ``vis``."""
    with torch.no_grad(), span("tssplat.visibility"):
        if bins is None:
            bins = visibility_bins(pos_clip, None, resolution, k, viewport)
        if isinstance(bins, CappedBins):
            ids, _ = rk.visibility_capped_ids(bins, resolution)
        else:
            ids, _ = rk.visibility(bins, resolution, emit_g=False)
    return ids, bins.n_drop


def rasterize(pos_clip: torch.Tensor, resolution: Tuple[int, int],
              k: Optional[int] = None, vis=None, viewport=None, bins=None):
    """Full rasterization (``rasterize``, rasterize.py:719): visibility
    (``visibility_ids``, on ``bins`` where given, or its outputs ``vis``
    computed beforehand), then the differentiable shading of the winners.
    Returns (rast (B,H,W,4) = (u, v, z/w, id+1), n_drop (B,))."""
    ids, n_drop = vis if vis is not None else \
        visibility_ids(pos_clip, resolution, k, viewport, bins)
    return _shade_rast(pos_clip, ids, viewport), n_drop


def rasterize_silhouette(pos_clip: torch.Tensor,
                         resolution: Tuple[int, int],
                         k: Optional[int] = None, vis=None, viewport=None):
    """Silhouette-only rasterization (``rasterize_silhouette``,
    rasterize.py:760): ``rasterize``'s (B,H,W,4) with u = v = 0 and no
    gradient in any channel (z and id+1 kept), and n_drop (B,). The
    silhouette loss takes its gradient from the antialias pass alone
    (nvdiffrast's grad_db=False, reference renderers/mesh_rasterizer.py:
    103-108)."""
    with torch.no_grad():
        rast, n_drop = rasterize(pos_clip.detach(), resolution, k, vis,
                                 viewport)
    rast[..., 0:2] = 0.0
    return rast, n_drop


class _Interp(torch.autograd.Function):
    """K7: the barycentric blend of the winners' attribute rows, forward
    and backward; a shared table's per-view rows are summed over the
    views."""

    @staticmethod
    def forward(ctx, tbl, rast):
        ctx.save_for_backward(tbl, rast)
        return rk.interp(rast, tbl)

    @staticmethod
    def backward(ctx, ct):
        tbl, rast = ctx.saved_tensors
        d_tbl, d_rast = rk.interp_backward(rast, tbl, ct.contiguous())
        if tbl.shape[0] == 1:
            d_tbl = d_tbl.sum(0, keepdim=True)
        return d_tbl, d_rast


def interpolate(attr: torch.Tensor, rast: torch.Tensor) -> torch.Tensor:
    """Barycentric attribute interpolation (``interpolate``,
    rasterize.py:842, corner layout): attr (3F,C) shared by the views, or
    (B,3F,C) one per view -> u*a0 + v*a1 + (1-u-v)*a2 (B,H,W,C), zero on
    background. K7 on the card, its plain version on the CPU."""
    F, C = attr.shape[-2] // 3, attr.shape[-1]
    tbl = attr.reshape(-1, F, 3 * C)
    if rast.is_cuda:
        return _Interp.apply(tbl.contiguous(), rast.contiguous())
    return rk.interp_plain(rast, tbl)


class _AntialiasSilhouette(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g6, ids, z, gaux, viewport):
        g6 = g6.contiguous()
        ctx.save_for_backward(g6, ids, z, gaux)
        ctx.viewport = viewport
        return rk.aa_forward(ids, z, g6, gaux, viewport)

    @staticmethod
    def backward(ctx, ct):
        g6, ids, z, gaux = ctx.saved_tensors
        return rk.aa_backward(ids, z, g6, gaux, ct.contiguous(),
                              ctx.viewport), None, None, None, None


def antialias_silhouette(ids: torch.Tensor, z: torch.Tensor,
                         g6: torch.Tensor, gaux: torch.Tensor,
                         viewport=None) -> torch.Tensor:
    """Antialiased silhouette coverage (B,H,W): ``antialias`` of the
    coverage colour (rasterize.py:975), equivalently
    ``antialias_silhouette_halo`` (:1153). Differentiable w.r.t. g6. With
    a ``viewport`` it is ``antialias(..., viewport, row_valid)`` of the
    slab, JAX's dense chain there (:1012-1044)."""
    return _AntialiasSilhouette.apply(g6, ids, z, gaux, viewport)


def antialias_rows(rast: torch.Tensor, tbl6: torch.Tensor,
                   edge_nbrs: torch.Tensor):
    """K4/K5's inputs on the ``rasterize`` path, without gradient: (ids
    (B,H,W) int32, z (B,H,W), g6 (B,6,H,W), gaux (B,4,H,W)). The rows are
    the winners' rows of the face table ``tbl6`` (B,F,6) = (ax,bx,cx,ay,by,
    cy) with the edge neighbours and the sign of the screen area; z is the
    shaded z of ``rast``, which the owner test uses, as JAX's does. K8 on
    the card, its plain version (a row gather) on the CPU."""
    return rk.winner_rows(rast.detach().contiguous(), tbl6.detach(),
                          edge_nbrs.long())


def antialias(rast: torch.Tensor, pos_clip: torch.Tensor,
              edge_nbrs: torch.Tensor, viewport=None) -> torch.Tensor:
    """Antialiased coverage (B,H,W) of the ``rasterize`` path: ``antialias``
    (rasterize.py:975) of the colour clip(id, 0, 1) without precomputed
    rows. The winner rows' value is ``antialias_rows``; their gradient goes
    through ``winner_screen_rows`` (K3); K4/K5 run the pairs."""
    tbl6 = screen_xy_table(pos_clip, edge_nbrs.shape[0])
    ids, z, rows6, gaux = antialias_rows(rast, tbl6, edge_nbrs)
    g6 = winner_screen_rows(tbl6, ids, rows6)
    return antialias_silhouette(ids, z, g6, gaux, viewport)


def _aa_pair_weights(id_a, id_b, z_a, z_b, g_a, g_b, aux_a, aux_b,
                     pax, pay, pbx, pby):
    """Blend weights (w_a, w_b) of one axis of pixel pairs: the plain
    transcription of ``_aa_pairs`` (rasterize.py:880-972) up to its
    deltas. a/b are the two pixels of each pair, g_* their winner xy rows
    channel-major (B,6,…), aux_* the edge neighbours and the area sign
    (B,4,…), p* their NDC centres. The weights depend on the colour not at
    all, and on the positions only through g."""
    differ = (id_a != id_b) & ((id_a > 0) | (id_b > 0))
    # the owner is the foreground face at the boundary: non-background
    # first, then the smaller depth
    owner_a = torch.where(id_a == 0, False,
                          torch.where(id_b == 0, True, z_a <= z_b))
    other_tri = torch.where(owner_a, id_b, id_a) - 1

    def oc(j):
        return torch.where(owner_a, g_a[:, j], g_b[:, j])

    def oa(j):
        return torch.where(owner_a, aux_a[:, j], aux_b[:, j])

    vx0, vx1, vx2 = oc(0), oc(1), oc(2)
    vy0, vy1, vy2 = oc(3), oc(4), oc(5)
    sgn = oa(3)

    def crossing(x0, y0, x1, y1):
        sa = edge(x0, y0, x1, y1, pax, pay) * sgn
        sb = edge(x0, y0, x1, y1, pbx, pby) * sgn
        denom = sa - sb
        safe = torch.where(torch.abs(denom) > 1e-20, denom,
                           torch.ones_like(denom))
        t_all = sa / safe
        # owner at a: coverage [0, t], exit crossing sa >= 0 > sb;
        # owner at b: coverage [t, 1], entry crossing sa < 0 <= sb
        t_exit = torch.where((sa >= 0) & (sb < 0), t_all, _INF)
        t_entry = torch.where((sa < 0) & (sb >= 0), t_all, -_INF)
        return t_exit, t_entry

    te0, tn0 = crossing(vx0, vy0, vx1, vy1)
    te1, tn1 = crossing(vx1, vy1, vx2, vy2)
    te2, tn2 = crossing(vx2, vy2, vx0, vy0)

    def pick3(v0, v1, v2, better):
        b1 = better(v1, v0)
        k01 = torch.where(b1, 1, 0)
        b01 = torch.where(b1, v1, v0)
        b2 = better(v2, b01)
        return torch.where(b2, v2, b01), torch.where(b2, 2, k01)

    te, k_exit = pick3(te0, te1, te2, lambda x, y: x < y)
    tn, k_entry = pick3(tn0, tn1, tn2, lambda x, y: x > y)
    k = torch.where(owner_a, k_exit, k_entry)
    t = torch.where(owner_a, te, tn)
    found = torch.isfinite(t)

    # the crossing edge must not be shared with the other pixel's face
    nbr = torch.where(k == 0, oa(0), torch.where(k == 1, oa(1), oa(2)))
    shared = (nbr == other_tri.to(nbr.dtype)) & (other_tri >= 0) & \
        torch.where(owner_a, id_b > 0, id_a > 0)
    valid = differ & found & ~shared
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    # jnp.clip and jnp.maximum: their gradients split evenly at a tie,
    # as torch.maximum / torch.minimum do
    t = torch.minimum(torch.maximum(torch.where(valid, t, 0.5), zero),
                      zero + 1.0)
    vf = valid.to(t.dtype)
    w_a = torch.maximum(0.5 - t, zero) * vf
    w_b = torch.maximum(t - 0.5, zero) * vf
    return w_a, w_b


def _color_pair_weights(ids, z, g, gaux):
    """(w_a, w_b) of the horizontal pairs a = (r, c), b = (r, c+1), each
    (B,H,W-1), and of the vertical pairs a = (r, c), b = (r+1, c), each
    (B,H-1,W), from the winner rows of ``antialias_rows``."""
    B, H, W = ids.shape
    dt, dev = z.dtype, z.device
    px = ndc_center(torch.arange(W, dtype=dt, device=dev), W)[None, None, :]
    py = ndc_center(torch.arange(H, dtype=dt, device=dev), H)[None, :, None]
    px, py = px.expand(B, H, W), py.expand(B, H, W)
    horizontal = _aa_pair_weights(
        ids[:, :, :-1], ids[:, :, 1:], z[:, :, :-1], z[:, :, 1:],
        g[..., :-1], g[..., 1:], gaux[..., :-1], gaux[..., 1:],
        px[:, :, :-1], py[:, :, :-1], px[:, :, 1:], py[:, :, 1:])
    vertical = _aa_pair_weights(
        ids[:, :-1], ids[:, 1:], z[:, :-1], z[:, 1:],
        g[:, :, :-1], g[:, :, 1:], gaux[:, :, :-1], gaux[:, :, 1:],
        px[:, :-1], py[:, :-1], px[:, 1:], py[:, 1:])
    return horizontal, vertical


def antialias_color(color: torch.Tensor, rast: torch.Tensor,
                    pos_clip: torch.Tensor, edge_nbrs: torch.Tensor
                    ) -> torch.Tensor:
    """Colour antialias (``antialias``, rasterize.py:975, over any (B,H,W,C)
    colour; nvdiffrast dr.antialias semantics): for each horizontally or
    vertically adjacent pixel pair whose ids differ, the owner face's
    silhouette edge crossing the segment between the centres blends the
    pixel on the receding side toward its neighbour. The winner rows come
    from ``antialias_rows``; when pos_clip carries a gradient they go
    through ``winner_screen_rows``, so the position gradient is folded into
    the face table by K3. The pairs run as plain PyTorch, as JAX runs them
    outside any Pallas kernel, and the deltas are added in JAX's order:
    horizontal a, b, then vertical a, b. This is the dense colour path's
    (``render/pipeline.py``); the exact texture loss, whose geometry is
    frozen, makes the weights once (``color_aa_weights``) and runs the
    blend in K10 (``ops/aa_l1.py``)."""
    with span("tssplat.antialias_color"):
        return _antialias_color(color, rast, pos_clip, edge_nbrs)


def _antialias_color(color, rast, pos_clip, edge_nbrs):
    tbl6 = screen_xy_table(pos_clip, edge_nbrs.shape[0])
    ids, z, rows6, gaux = antialias_rows(rast, tbl6, edge_nbrs)
    g = winner_screen_rows(tbl6, ids, rows6) if pos_clip.requires_grad \
        else rows6
    (wha, whb), (wva, wvb) = _color_pair_weights(ids, z, g, gaux)
    out = color
    # horizontal pairs: a = (r, c), b = (r, c+1)
    ca, cb = color[:, :, :-1], color[:, :, 1:]
    out = out + F_pad((cb - ca) * wha[..., None], (0, 0, 0, 1))
    out = out + F_pad((ca - cb) * whb[..., None], (0, 0, 1, 0))
    # vertical pairs: a = (r, c), b = (r+1, c)
    ca, cb = color[:, :-1], color[:, 1:]
    out = out + F_pad((cb - ca) * wva[..., None], (0, 0, 0, 0, 0, 1))
    out = out + F_pad((ca - cb) * wvb[..., None], (0, 0, 0, 0, 1, 0))
    return out


@torch.no_grad()
def color_aa_weights(rast: torch.Tensor, pos_clip: torch.Tensor,
                     edge_nbrs: torch.Tensor) -> torch.Tensor:
    """The colour antialias's weights at each pixel, without gradient:
    (B,H,W,4), the weight that blends the pixel toward its right, left,
    lower and upper neighbour (``antialias_color``'s horizontal a, b and
    vertical a, b weights, zero where its pads put no pair). The same
    ``_aa_pair_weights`` on the same winner rows, so a blend with them
    gives ``antialias_color``'s values to the bit where pos_clip is
    frozen."""
    tbl6 = screen_xy_table(pos_clip, edge_nbrs.shape[0])
    ids, z, rows6, gaux = antialias_rows(rast, tbl6, edge_nbrs)
    (wha, whb), (wva, wvb) = _color_pair_weights(ids, z, rows6, gaux)
    return torch.stack([F_pad(wha, (0, 1)), F_pad(whb, (1, 0)),
                        F_pad(wva, (0, 0, 0, 1)), F_pad(wvb, (0, 0, 1, 0))],
                       dim=-1)
