"""Screen-tile binning of faces for the visibility kernel (counterpart of
``bin_triangles`` / ``_prepare_candidates``, ``tssplat_tpu/ops/
pallas_raster.py:403,562``, which are XLA code in JAX — torch ops here).

Per view: face bounding box -> inclusive tile range (the same ±0.5-slack
pixel-centre predicate as ``_tile_range``) -> one (tile, face) pair per
overlapped tile -> one sort over all views -> per-tile start/count into
the sorted face list. There are no capacity caps and no big-face pool: a
face is listed in every tile its box touches, so nothing is ever dropped
and ``n_drop`` is always 0. The expansion needs the pair total on the
host (one device sync per call).

Per-face table rows, (B, F, 16) f32, one 64-byte row per face:
  ax, ay, bx, by, cx, cy, z0, z1, z2, inv_area, nbr0, nbr1, nbr2, 0, 0, 0
with ``inv_area`` computed exactly as at pallas_raster.py:617-619 (0 for a
face with a vertex at w <= eps or |area| <= 1e-14, which then covers no
pixel) and the edge-neighbour ids as exact small-integer floats.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .screen import AREA_EPS, screen

TILE_H = 16
TILE_W = 16


class FaceBins(NamedTuple):
    table: torch.Tensor        # (B,F,16) f32 per-face rows (see module doc)
    tile_start: torch.Tensor   # (B*ntiles,) int32 — offset into ``faces``
    tile_count: torch.Tensor   # (B*ntiles,) int32
    faces: torch.Tensor        # (L,) int32 face ids sorted by (view, tile, id)
    n_drop: torch.Tensor       # (B,) int32 — always 0 (no caps)
    nty: int
    ntx: int


def face_table(pos_clip: torch.Tensor, edge_nbrs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-layout clip positions (B,3F,4) -> (table (B,F,16), ok (B,F)
    bool: the face can cover pixels)."""
    B = pos_clip.shape[0]
    F = edge_nbrs.shape[0]
    sx, sy, sz, valid = screen(pos_clip)
    vx, vy, zr = sx.view(B, F, 3), sy.view(B, F, 3), sz.view(B, F, 3)
    ax, bx, cx = vx.unbind(-1)
    ay, by, cy = vy.unbind(-1)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = valid.view(B, F, 3).all(dim=-1) & (torch.abs(area) > AREA_EPS)
    one = torch.ones_like(area)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, one),
                           torch.zeros_like(area))
    nb = edge_nbrs.to(pos_clip.dtype).unsqueeze(0).expand(B, F, 3)
    zero = torch.zeros_like(area)
    cols = [ax, ay, bx, by, cx, cy, zr[..., 0], zr[..., 1], zr[..., 2],
            inv_area, nb[..., 0], nb[..., 1], nb[..., 2], zero, zero, zero]
    return torch.stack(cols, dim=-1).contiguous(), ok


def _tile_range(lo, hi, tile_px: int, n: int):
    """Inclusive tile range [t0, t1] whose pixel-centre span meets the box
    [lo, hi] (pixel-centre coordinates); ``empty`` when it misses the grid."""
    t0 = torch.ceil((lo + 0.5) / tile_px - 1.0)
    t1 = torch.floor((hi + 0.5) / tile_px)
    empty = (t1 < 0) | (t0 > n - 1) | ~torch.isfinite(lo) | ~torch.isfinite(hi)
    # clamp in float first: a huge coordinate must not overflow the int cast
    t0 = torch.nan_to_num(t0).clamp(0, n - 1).to(torch.int64)
    t1 = torch.nan_to_num(t1).clamp(0, n - 1).to(torch.int64)
    return t0, t1, empty


@torch.no_grad()
def bin_faces(pos_clip: torch.Tensor, edge_nbrs: torch.Tensor,
              resolution: Tuple[int, int]) -> FaceBins:
    """Bin the faces of every view into TILE_H x TILE_W screen tiles."""
    H, W = resolution
    B = pos_clip.shape[0]
    F = edge_nbrs.shape[0]
    dev = pos_clip.device
    nty, ntx = -(-H // TILE_H), -(-W // TILE_W)
    ntiles = nty * ntx
    table, ok = face_table(pos_clip, edge_nbrs)

    px = (table[..., 0:5:2] + 1.0) * 0.5 * W - 0.5              # (B,F,3)
    py = (table[..., 1:6:2] + 1.0) * 0.5 * H - 0.5
    tx0, tx1, ex = _tile_range(px.amin(-1), px.amax(-1), TILE_W, ntx)
    ty0, ty1, ey = _tile_range(py.amin(-1), py.amax(-1), TILE_H, nty)
    live = (ok & ~ex & ~ey).to(torch.int64)
    spanx = (tx1 - tx0 + 1) * live
    npair = (spanx * (ty1 - ty0 + 1) * live).reshape(-1)        # (B*F,)
    total = int(npair.sum())                                    # host sync

    src = torch.repeat_interleave(torch.arange(B * F, device=dev), npair,
                                  output_size=total)
    local = torch.arange(total, device=dev) \
        - (torch.cumsum(npair, 0) - npair)[src]
    sx_src = spanx.reshape(-1)[src]
    tile = (ty0.reshape(-1)[src] + local // sx_src) * ntx \
        + tx0.reshape(-1)[src] + local % sx_src
    view, face = src // F, src % F
    code = torch.sort((view * ntiles + tile) * F + face).values
    counts = torch.bincount(code // F, minlength=B * ntiles)
    starts = torch.cumsum(counts, 0) - counts
    return FaceBins(table=table, tile_start=starts.to(torch.int32),
                    tile_count=counts.to(torch.int32),
                    faces=(code % F).to(torch.int32),
                    n_drop=torch.zeros(B, dtype=torch.int32, device=dev),
                    nty=nty, ntx=ntx)
