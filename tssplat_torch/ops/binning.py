"""Screen-tile binning of faces for the visibility kernels (counterpart of
``bin_triangles`` / ``_prepare_candidates``, ``tssplat_tpu/ops/
pallas_raster.py:403,562``, which are XLA code in JAX — torch ops here),
and the capacity helpers of ``tssplat_tpu/ops/rasterize.py:162-209``.

Per view: face bounding box -> inclusive tile range (the same ±0.5-slack
pixel-centre predicate as ``_tile_range``) -> one (tile, face) pair per
overlapped tile -> one sort over all views -> per-tile start/count into
the sorted face list. The expansion needs the pair total on the host (one
device sync per call, the only one: each tile's count is a fixed-length
count over the sorted pairs, ``tile_counts``). Two layouts come out of
it:

  ``bin_faces``        K1's uncapped lists on 16x16 tiles: a face is listed
                       in every tile its box touches, so nothing is ever
                       dropped and ``n_drop`` is 0.
  ``bin_faces_capped`` the JAX package's capped layout on 8x128 tiles: a
                       dense (B*ntiles, k) candidate matrix holding, per
                       tile, the k smallest ids among the faces whose box
                       meets it; ``n_drop[b]`` counts the faces cut off, over
                       the view's tiles. This is what JAX's dense
                       ``bin_triangles`` keeps when its tier-2 pool is empty
                       (it sorts the packed (tile, id) code and takes the
                       first k). The port has no tiers and no pool: JAX
                       walks up to 64 large faces in every tile and counts
                       the faces beyond that pool as drops too, so with a
                       non-empty pool the two packages count drops
                       differently.

``uses_capped_layout`` is the rule that picks between them: the port caps
its candidates in exactly the scenes where the JAX package leaves its flat
layout (``pallas_raster.py:732-759``), whose size test is the TPU's SMEM
budget ``FLAT_BUDGET_BYTES``. The rule decides only which scenes cap; it
puts no limit on the port's kernels, which read their tables from global
memory at any size. It is kept for parity with the JAX package (the same
scenes drop the same faces, counted per 8x128 tile as JAX counts them):
nothing on the GPU calls for it. K2a/K2b search each candidate inside its
pixel box and are no slower than K1 on the same scene (PERF.md).

Per-face table rows, (B, F, 16) f32, one 64-byte row per face:
  ax, ay, bx, by, cx, cy, z0, z1, z2, inv_area, nbr0, nbr1, nbr2, 0, 0, 0
with ``inv_area`` computed exactly as at pallas_raster.py:617-619 (0 for a
face with a vertex at w <= eps or |area| <= 1e-14, which then covers no
pixel) and the edge-neighbour ids as exact small-integer floats (0 when
the table is built without neighbours).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span
from .screen import AREA_EPS, screen

TILE_H = 16                  # K1's tiles
TILE_W = 16
CAP_TILE_H = 8               # the capped layout's tiles (JAX's (8, 128))
CAP_TILE_W = 128

# JAX's flat-layout budget (pallas_raster.py:49, _SMEM_TBL_BUDGET), a TPU
# SMEM size with no meaning on the GPU: the scene size above which the
# capped layout is taken, for parity with JAX. Module-level so tests can
# monkeypatch it as the JAX tests patch _SMEM_TBL_BUDGET.
FLAT_BUDGET_BYTES = 880 * 1024


class FaceBins(NamedTuple):
    table: torch.Tensor        # (B,F,16) f32 per-face rows (see module doc)
    tile_start: torch.Tensor   # (B*ntiles,) int32 — offset into ``faces``
    tile_count: torch.Tensor   # (B*ntiles,) int32
    faces: torch.Tensor        # (L,) int32 face ids sorted by (view, tile, id)
    n_drop: torch.Tensor       # (B,) int32 — 0: the lists have no caps
    nty: int
    ntx: int
    row0: int = 0              # viewport: local row r is absolute row0 + r
    full_h: Optional[int] = None   # of a full_h-tall image (None: H)


class CappedBins(NamedTuple):
    table: torch.Tensor        # (B,F,16) f32 per-face rows (see module doc)
    counts: torch.Tensor       # (B*ntiles,) int32 — min(count, k)
    cand: torch.Tensor         # (B*ntiles,k) int32 ascending ids; pad F
    n_drop: torch.Tensor       # (B,) int32 — sum over tiles of count - k
    nty: int                   # tiles of CAP_TILE_H x CAP_TILE_W
    ntx: int
    row0: int = 0              # viewport, as FaceBins
    full_h: Optional[int] = None


# ---------------------------------------------------------------------------
# which layout (pallas_raster.py:732-759)
# ---------------------------------------------------------------------------

def uses_capped_layout(F: int, R: int, B: int, H: int, W: int) -> bool:
    """True where JAX's ``_rasterize_ids_pallas_jit`` leaves its flat
    layout for the capped one, for F faces, an R-column table (14 with
    winner rows, 11 without), B views at H x W. Unaligned resolutions never
    reach JAX's binned kernels, so they stay on K1. For a slab H is the
    slab's rows, as JAX sizes ``flat_bytes`` by the slab's tiles."""
    if H % CAP_TILE_H or W % CAP_TILE_W:
        return False
    ntiles = (H // CAP_TILE_H) * (W // CAP_TILE_W)
    shared_tbl = (F + 1) * R * 4 <= FLAT_BUDGET_BYTES
    med_cap = min(256, F)
    pool_cap = min(64, F)
    L = 4 * F + 32 * med_cap
    prefetch_bytes = (2 * B * ntiles + B + 1) * 4
    flat_bytes = ((F + 1) * R + L + pool_cap) * 4 + prefetch_bytes
    return not (shared_tbl and flat_bytes <= FLAT_BUDGET_BYTES)


# ---------------------------------------------------------------------------
# capacity (rasterize.py:162-209)
# ---------------------------------------------------------------------------

def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def default_tile_capacity(num_tris: int, resolution: Tuple[int, int]
                          ) -> int:
    """Per-tile capacity heuristic of the capped layout: ~10x the
    uniform-density expectation plus 128, as a power of two, clamped to
    [128, next_pow2(num_tris)]."""
    H, W = resolution
    expect = num_tris * (CAP_TILE_H * CAP_TILE_W) / max(H * W, 1)
    return max(128, min(next_pow2(int(10 * expect) + 128),
                        next_pow2(num_tris)))


def capacity(k: Optional[int], F: int, resolution: Tuple[int, int]) -> int:
    """The static k of the capped layout: the heuristic when ``k`` is None,
    as a power of two no larger than next_pow2(F)
    (pallas_raster.py:732-734). ``resolution`` is the whole image's, also
    for a slab (JAX passes (full_h, W))."""
    if k is None:
        k = default_tile_capacity(F, resolution)
    return min(next_pow2(int(k)), next_pow2(F))


@torch.no_grad()
def tile_overlap_counts(pos_clip: torch.Tensor,
                        resolution: Tuple[int, int]) -> int:
    """Max per-tile candidate count over views of the corner-layout clip
    positions (B,3F,4) on the capped layout's tiles, with
    ``_bbox_tile_overlap``'s predicate."""
    H, W = resolution
    B = pos_clip.shape[0]
    F = pos_clip.shape[1] // 3
    sx, sy, _, valid = screen(pos_clip)
    px = (sx.view(B, F, 3) + 1.0) * 0.5 * W - 0.5
    py = (sy.view(B, F, 3) + 1.0) * 0.5 * H - 0.5
    ok = valid.view(B, F, 3).all(dim=-1)
    dev = pos_clip.device
    tx = torch.arange(W // CAP_TILE_W, device=dev, dtype=torch.float32)
    ty = torch.arange(H // CAP_TILE_H, device=dev, dtype=torch.float32)

    def overlap(lo, hi, t, n):                 # (B,ntiles_axis,F)
        t0 = t * n - 0.5
        t1 = (t + 1) * n - 0.5
        return (hi.amax(-1)[:, None, :] >= t0[None, :, None]) \
            & (lo.amin(-1)[:, None, :] <= t1[None, :, None])

    ox = overlap(px, px, tx, CAP_TILE_W)
    oy = overlap(py, py, ty, CAP_TILE_H) & ok[:, None, :]
    counts = torch.einsum("byf,bxf->byx", oy.to(torch.float32),
                          ox.to(torch.float32))
    return int(counts.max()) if counts.numel() else 0


def validate_tile_capacity(pos_clip: torch.Tensor,
                           resolution: Tuple[int, int]) -> int:
    """A safe capped-layout k for this scene: max(heuristic,
    next_pow2(2 x the measured per-tile overlap)), at most next_pow2(F);
    the margin of 2 covers deformation between validations. Tiles past k
    drop faces (counted in n_drop)."""
    F = pos_clip.shape[1] // 3
    need = tile_overlap_counts(pos_clip, resolution)
    k = max(default_tile_capacity(F, resolution), next_pow2(int(need * 2.0)))
    return min(k, next_pow2(F))


# ---------------------------------------------------------------------------
# the per-face table and the sorted (tile, face) pairs
# ---------------------------------------------------------------------------

def face_table(pos_clip: torch.Tensor, edge_nbrs: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corner-layout clip positions (B,3F,4) -> (table (B,F,16), ok (B,F)
    bool: the face can cover pixels, valid (B,F) bool: no vertex at
    w <= eps)."""
    B = pos_clip.shape[0]
    F = pos_clip.shape[1] // 3
    sx, sy, sz, v_ok = screen(pos_clip)
    vx, vy, zr = sx.view(B, F, 3), sy.view(B, F, 3), sz.view(B, F, 3)
    ax, bx, cx = vx.unbind(-1)
    ay, by, cy = vy.unbind(-1)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    valid = v_ok.view(B, F, 3).all(dim=-1)
    ok = valid & (torch.abs(area) > AREA_EPS)
    one = torch.ones_like(area)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, one),
                           torch.zeros_like(area))
    nb = torch.zeros_like(vx) if edge_nbrs is None else \
        edge_nbrs.to(pos_clip.dtype).unsqueeze(0).expand(B, F, 3)
    # (ax, ay, bx, by, cx, cy), z0..z2, inv_area, the neighbours, 0, 0, 0
    cols = [torch.stack([vx, vy], dim=-1).reshape(B, F, 6), zr,
            inv_area[..., None], nb, torch.zeros_like(vx)]
    return torch.cat(cols, dim=-1), ok, valid


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


class PairFront(NamedTuple):
    """The pair expansion up to its pair total: every tensor has a shape
    fixed by the views, faces and tiles, and nothing was read on the host
    (the geometry step's CUDA graph runs it, ``step_graph.py``)."""
    rec: torch.Tensor          # (4,B*F) int64 per face, for its pairs'
    #                            codes (``_pair_codes``): a = the first
    #                            pair's code - its index * F, the index of
    #                            its first pair, its tiles across s, and
    #                            (ntx - s) * F
    npair: torch.Tensor        # (B*F,) int64 pairs of each face
    total: torch.Tensor        # () int64, the pair total
    F: int
    nty: int
    ntx: int


def _pair_front(table, live, resolution, tile_h, tile_w, row0=0,
                full_h=None) -> PairFront:
    """Each live face's tile range and pair count (see ``PairFront``). A
    pair's code is ``(view * ntiles + tile) * F + face``. With a viewport
    ``(row0, full_h)`` the face's absolute pixel rows are shifted by row0
    into the slab's rows and clipped to its tiles (``bin_triangles``,
    pallas_raster.py:453-455)."""
    H, W = resolution
    B, F, _ = table.shape
    dev = table.device
    nty, ntx = -(-H // tile_h), -(-W // tile_w)
    fh = H if full_h is None else full_h
    px = (table[..., 0:5:2] + 1.0) * 0.5 * W - 0.5              # (B,F,3)
    py = (table[..., 1:6:2] + 1.0) * 0.5 * fh - 0.5 - row0
    tx0, tx1, ex = _tile_range(px.amin(-1), px.amax(-1), tile_w, ntx)
    ty0, ty1, ey = _tile_range(py.amin(-1), py.amax(-1), tile_h, nty)
    live = (live & ~ex & ~ey).to(torch.int64)
    spanx = (tx1 - tx0 + 1) * live
    npair = (spanx * (ty1 - ty0 + 1) * live).reshape(-1)        # (B*F,)
    first = torch.cumsum(npair, 0) - npair
    view = torch.arange(B, device=dev)[:, None]
    code0 = (((view * nty + ty0) * ntx + tx0) * F
             + torch.arange(F, device=dev)).reshape(-1)
    spanx = spanx.reshape(-1)
    rec = torch.stack([code0 - first * F, first, spanx, (ntx - spanx) * F])
    return PairFront(rec=rec, npair=npair, total=npair.sum(), F=F, nty=nty,
                     ntx=ntx)


def _pair_codes(front: PairFront) -> torch.Tensor:
    """The sorted pair codes ``(view * ntiles + tile) * F + face`` of the
    faces of ``front``: one pair per tile each face's box meets. The
    expansion's length is the pair total, read on the host: the binning's
    one wait."""
    with span("tssplat.sync.binning"):
        total = int(front.total)                                # host sync
    dev = front.npair.device
    # each face's index, once for each of its pairs
    src = torch.repeat_interleave(front.npair, output_size=total)
    a, first, spanx, row_skip = front.rec.index_select(1, src).unbind(0)
    # pair p of a face is its (p - first)-th: tile row (p - first) // s,
    # column (p - first) % s of its range, each row ntx tiles on
    p = torch.arange(total, device=dev)
    row = (p - first).div_(spanx, rounding_mode="floor")
    return torch.sort(a.add_(p, alpha=front.F).add_(row.mul_(row_skip))
                      ).values


def tile_counts(code: torch.Tensor, F: int, n: int) -> torch.Tensor:
    """(n,) int64 pairs of each (view, tile) among the sorted pair codes
    ``(view * ntiles + tile) * F + face``: each tile's pairs are a run of
    the codes, its count the distance between the run's ends. A count of
    fixed length: ``torch.bincount(code // F, minlength=n)`` would read the
    codes' min and max on the host."""
    ends = torch.searchsorted(code // F, torch.arange(n + 1,
                                                      device=code.device))
    return ends[1:] - ends[:-1]


def _sorted_pairs(table, live, resolution, tile_h, tile_w, row0=0,
                  full_h=None):
    """Expand every live face into one (tile, face) pair per tile its box
    meets and sort them: (faces (L,) int64 sorted by (view, tile, id),
    counts (B*ntiles,) int64, nty, ntx). ``row0``, ``full_h`` as in
    ``_pair_front``."""
    front = _pair_front(table, live, resolution, tile_h, tile_w, row0,
                        full_h)
    code = _pair_codes(front)
    n = table.shape[0] * front.nty * front.ntx
    return code % front.F, tile_counts(code, front.F, n), front.nty, \
        front.ntx


@torch.no_grad()
def bin_faces(pos_clip: torch.Tensor, edge_nbrs: Optional[torch.Tensor],
              resolution: Tuple[int, int], viewport=None) -> FaceBins:
    """Bin the faces of every view into TILE_H x TILE_W screen tiles (K1's
    uncapped lists). ``resolution`` is the (slab's) H x W; ``viewport``
    (row0, full_h) makes its rows absolute rows row0.. of a full_h-tall
    image. A slab of 8-aligned rows may end in a partial 16-row tile."""
    with span("tssplat.binning"):
        B = pos_clip.shape[0]
        row0, full_h = viewport if viewport is not None else (0, None)
        table, ok, _ = face_table(pos_clip, edge_nbrs)
        faces, counts, nty, ntx = _sorted_pairs(table, ok, resolution,
                                                TILE_H, TILE_W, row0, full_h)
        starts = torch.cumsum(counts, 0) - counts
        return FaceBins(table=table, tile_start=starts.to(torch.int32),
                        tile_count=counts.to(torch.int32),
                        faces=faces.to(torch.int32),
                        n_drop=torch.zeros(B, dtype=torch.int32,
                                           device=pos_clip.device),
                        nty=nty, ntx=ntx, row0=int(row0), full_h=full_h)


class CappedFront(NamedTuple):
    """``bin_faces_capped`` up to the host's read of its pair total."""
    table: torch.Tensor        # (B,F,16) f32 per-face rows
    pairs: PairFront
    k: int
    row0: int
    full_h: Optional[int]


@torch.no_grad()
def capped_front(pos_clip: torch.Tensor, edge_nbrs: Optional[torch.Tensor],
                 resolution: Tuple[int, int], k: int,
                 viewport=None) -> CappedFront:
    """The first half of ``bin_faces_capped``: the face table and each
    face's tiles, with no host read. A face is binned when its three
    vertices are valid (JAX's predicate: a face of zero area still takes a
    slot; it covers no pixel)."""
    H, W = resolution
    if H % CAP_TILE_H or W % CAP_TILE_W:
        raise ValueError(f"capped layout needs H % {CAP_TILE_H} == 0 and "
                         f"W % {CAP_TILE_W} == 0, got {resolution}")
    row0, full_h = viewport if viewport is not None else (0, None)
    table, _, valid = face_table(pos_clip, edge_nbrs)
    return CappedFront(table=table, pairs=_pair_front(
        table, valid, resolution, CAP_TILE_H, CAP_TILE_W, row0, full_h),
        k=int(k), row0=int(row0), full_h=full_h)


@torch.no_grad()
def capped_back(front: CappedFront,
                out: Optional[CappedBins] = None) -> CappedBins:
    """The second half of ``bin_faces_capped``: the pairs expanded (the
    host reads their total) and sorted, each tile's count, and its k
    smallest ids kept as its candidates (ascending, padded with F). Every
    output has a fixed shape; ``out``, the bins of an earlier call (same
    views, faces, resolution and k), takes them in its tensors. The table
    is the front's."""
    pairs, k, F = front.pairs, front.k, front.pairs.F
    B = front.table.shape[0]
    dev = front.table.device
    ntile = B * pairs.nty * pairs.ntx
    n = ntile * k
    if out is None:
        out = CappedBins(
            table=front.table,
            counts=torch.empty(ntile, dtype=torch.int32, device=dev),
            cand=torch.empty(n + 1, dtype=torch.int32,
                             device=dev)[:n].view(ntile, k),
            n_drop=torch.empty(B, dtype=torch.int32, device=dev),
            nty=pairs.nty, ntx=pairs.ntx, row0=front.row0,
            full_h=front.full_h)
    code = _pair_codes(pairs)
    tile = code // F
    ends = torch.searchsorted(tile, torch.arange(ntile + 1, device=dev))
    counts = ends[1:] - ends[:-1]
    rank = torch.arange(code.numel(), device=dev) \
        - ends.index_select(0, tile)
    # the candidates and one spare slot past them (their storage holds
    # it), where every pair past its tile's k lands
    slots = out.cand.as_strided((n + 1,), (1,))
    slots.fill_(F)
    slots.index_put_((torch.where(rank < k, rank.add(tile, alpha=k), n),),
                     (code % F).to(torch.int32))
    kept = torch.clamp(counts, max=k)
    out.counts.copy_(kept)
    out.n_drop.copy_((counts - kept).view(B, -1).sum(dim=1))
    return out._replace(table=front.table)


@torch.no_grad()
def bin_faces_capped(pos_clip: torch.Tensor,
                     edge_nbrs: Optional[torch.Tensor],
                     resolution: Tuple[int, int], k: int,
                     viewport=None) -> CappedBins:
    """Bin the faces of every view into CAP_TILE_H x CAP_TILE_W tiles and
    keep, per tile, the k smallest ids (see the module doc): ``capped_front``
    then ``capped_back``. ``viewport`` as in ``bin_faces``; the tiles, and
    so the drops, are the slab's."""
    with span("tssplat.binning"):
        return capped_back(capped_front(pos_clip, edge_nbrs, resolution, k,
                                        viewport))
