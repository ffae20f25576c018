"""The rasterizer's hand-written CUDA kernels, each beside its plain
PyTorch version (counterpart of ``tssplat_tpu/ops/pallas_raster.py``).

  K1  ``visibility``             csrc/vis.cu         <- _vis_kernel_flat
  K2a ``visibility_capped_ids``  csrc/vis_capped.cu  <- _vis_kernel
  K2b ``visibility_capped``      csrc/vis_capped.cu  <- _vis_kernel_g
  K3  ``wsr_table_grad``         csrc/wsr_grad.cu    <- _wsr_grad_kernel
  K4  ``aa_forward``             csrc/aa_fwd.cu      <- _aa_halo_fwd_kernel
  K5  ``aa_backward``            csrc/aa_bwd.cu      <- _aa_halo_bwd_kernel
  K6  ``shade``, ``shade_backward``      csrc/shade.cu        <- none
  K7  ``interp``, ``interp_backward``    csrc/interp.cu       <- none
  K8  ``winner_rows``                    csrc/winner_rows.cu  <- none

(K4 and K5 also take the place of the XLA border pass beside their TPU
kernels. K6-K8 replace no Pallas kernel: JAX runs the shading of the
winners, the attribute interpolation and the antialias pass's row gather
as XLA code, ``_shade_rast``, ``interpolate`` and ``_gather_tri_screen``
of rasterize.py. On the card each read its winners' face rows straight
from the per-face table, where PyTorch would gather dense per-pixel rows
and run a chain of elementwise kernels over them. Their plain versions
are that chain: the port's CPU path.)

Each kernel renders a horizontal slab of rows as well as a whole image (row-
slab spatial sharding, ``parallel/spatial.py``): its H rows are absolute
rows row0 .. row0 + H - 1 of a full_h-tall image, pixel centres are those of
the absolute rows, and a vertical antialias pair counts only where both of
its absolute rows lie in [0, full_h) (JAX's ``row_valid``). The visibility
kernels take (row0, full_h) from their bins (``bin_faces(...,
viewport=...)``), K4/K5 as ``viewport``; the default (0, H) is the whole
image and gives the same bits as before the viewport existed.

Each wrapper takes the plain version for tensors on the CPU, and launches
its kernel for CUDA tensors (or raises: there is no fallback). It checks
device, dtype, shape and contiguity, allocates the outputs, launches on
PyTorch's current stream, raises if ``cudaGetLastError`` is not 0, and
adds one to its ``launches`` count; under the NaN trap
(``utils/debug.py``), which sees no ctypes launch, it checks its own
floating outputs. The plain versions repeat the kernels'
arithmetic in the same order, so on the card the two agree to the last bit
except where K3's atomics reorder sums. K2a/K2b have two: the walk over
each tile's candidates, which defines the result and is what a CPU tensor
gets, and ``visibility_capped_boxed_plain``, the kernels' own search inside
each face's pixel box, which the tests hold against the walk. What bounds
each kernel and what its design does about it is noted at the top of its
source. ``KERNELS`` and ``launch_counts()`` also count K9, the hash-grid
encoding's pair (``ops/hash_grid.py``), and K10, the exact texture loss's
tail (``ops/aa_l1.py``), so that one count shows every hand-written kernel
a run launched.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.launch import check as _check
from ..kernels.launch import launch as _launch
from ..kernels.launch import on_cuda as _on_cuda
from ..kernels.launch import ptr as _ptr
from ..utils.debug import check_kernel_outputs
from ..utils.profiling import span
from .binning import (CAP_TILE_H, CAP_TILE_W, CappedBins, FaceBins, TILE_H,
                      TILE_W)
from .aa_l1 import aa_l1, aa_l1_backward
from .hash_grid import hash_grid, hash_grid_backward
from .screen import AREA_EPS, W_EPS, edge, ndc_center, pixel_centers

_INF = float("inf")


def _viewport(viewport, H: int) -> Tuple[int, int]:
    """(row0, full_h) of a viewport given as (row0, full_h or None), or of
    the whole image when it is None."""
    row0, full_h = viewport if viewport is not None else (0, None)
    return int(row0), int(H if full_h is None else full_h)


# ---------------------------------------------------------------------------
# K1 — visibility over the uncapped lists, with or without winner rows
# ---------------------------------------------------------------------------

def visibility(bins: FaceBins, resolution: Tuple[int, int],
               emit_g: bool = True):
    """Winner per pixel over the binned faces: (ids+1 (B,H,W) int32,
    z (B,H,W) f32, g6 (B,6,H,W) f32 = (ax,bx,cx,ay,by,cy), gaux (B,4,H,W)
    f32 = (nbr0,nbr1,nbr2,sign)); all zero on background. With ``emit_g``
    off, (ids, z) only."""
    table = bins.table
    if not _on_cuda(table, "visibility"):
        return visibility_plain(bins, resolution, emit_g)
    H, W = resolution
    B, F, _ = table.shape
    dev = table.device
    _check(table, "table", torch.float32, (B, F, 16))
    nt = B * bins.nty * bins.ntx
    if bins.nty != -(-H // TILE_H) or bins.ntx != -(-W // TILE_W):
        raise ValueError("visibility: bins were made for another resolution")
    _check(bins.tile_start, "tile_start", torch.int32, (nt,), dev)
    _check(bins.tile_count, "tile_count", torch.int32, (nt,), dev)
    _check(bins.faces, "faces", torch.int32, None, dev)
    faces = bins.faces if bins.faces.numel() else \
        torch.zeros(1, dtype=torch.int32, device=dev)
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    g6 = gaux = None
    if emit_g:
        g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
        gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    row0, full_h = _viewport((bins.row0, bins.full_h), H)
    _launch("tss_vis_launch", _ptr(table), _ptr(bins.tile_start),
            _ptr(bins.tile_count), _ptr(faces), B, F, H, W, bins.nty,
            bins.ntx, int(emit_g), row0, full_h, _ptr(ids), _ptr(z),
            _ptr(g6) if emit_g else None, _ptr(gaux) if emit_g else None)
    visibility.launches += 1
    check_kernel_outputs("visibility", z, g6, gaux)
    return (ids, z, g6, gaux) if emit_g else (ids, z)


def visibility_plain(bins: FaceBins, resolution: Tuple[int, int],
                     emit_g: bool = True):
    """Plain version of K1: the same per-tile candidate walk, one candidate
    slot of every tile at a time, with the kernel's arithmetic order."""
    start = bins.tile_start.long()
    ids, z = _walk_tiles(
        bins.table, lambda j, tl: bins.faces[start[tl] + j].long(),
        bins.tile_count, bins.nty, bins.ntx, TILE_H, TILE_W, resolution,
        _viewport((bins.row0, bins.full_h), resolution[0]))
    return (ids, z, *_winner_rows(bins.table, ids)) if emit_g else (ids, z)


def _walk_tiles(table, face_at, count, nty, ntx, tile_h, tile_w,
                resolution, viewport):
    """The kernels' per-tile search, vectorized over (tile, pixel):
    candidate slot j of every tile whose count exceeds j at a time
    (``face_at(j, tl)`` gives the face ids at slot j of the flat tiles
    tl = view * ntiles + tile), in the kernels' arithmetic order. The tiles
    are sorted by count once (one host read), so slot j walks a prefix of
    them and the loop ends at the largest real count, never at a capacity
    above it. Pixel centres are those of the absolute rows of ``viewport``
    (row0, full_h). Returns (ids+1 (B,H,W) int32, z (B,H,W) f32, 0 on
    background)."""
    H, W = resolution
    B, F, _ = table.shape
    dev = table.device
    nt = nty * ntx
    # per-tile pixel centres (nt, tile_h*tile_w), row-major inside the tile
    ly = torch.arange(tile_h, device=dev).repeat_interleave(tile_w)
    lx = torch.arange(tile_w, device=dev).repeat(tile_h)
    tiles = torch.arange(nt, device=dev)
    row = (tiles // ntx)[:, None] * tile_h + ly[None]
    col = (tiles % ntx)[:, None] * tile_w + lx[None]

    row0, full_h = viewport
    count = count.reshape(-1).long()
    order = torch.argsort(count, descending=True, stable=True)
    counts_desc = count[order].tolist()                  # host read
    px = ndc_center(col.to(torch.float32), W)[order % nt]   # sorted tiles
    py = ndc_center((row + row0).to(torch.float32), full_h)[order % nt]
    best_z = torch.full((B * nt, tile_h * tile_w), _INF, device=dev)
    best_id = torch.zeros((B * nt, tile_h * tile_w), dtype=torch.int32,
                          device=dev)
    rows = table.reshape(B * F, -1)
    n = len(counts_desc)
    for j in range(counts_desc[0] if n else 0):
        while counts_desc[n - 1] <= j:
            n -= 1
        tl = order[:n]
        f = face_at(j, tl)
        r = rows[(tl // nt) * F + f][:, None, :]         # (n,1,16)
        ax, ay, bx, by = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        cx, cy, z0, z1 = r[..., 4], r[..., 5], r[..., 6], r[..., 7]
        z2, inv_area = r[..., 8], r[..., 9]
        pxs, pys = px[:n], py[:n]
        e0 = ((cx - bx) * (pys - by) - (cy - by) * (pxs - bx)) * inv_area
        e1 = ((ax - cx) * (pys - cy) - (ay - cy) * (pxs - cx)) * inv_area
        e2 = ((bx - ax) * (pys - ay) - (by - ay) * (pxs - ax)) * inv_area
        z = e0 * z0 + e1 * z1 + e2 * z2
        cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (inv_area != 0) \
            & (z >= -1.0) & (z <= 1.0)
        zc = torch.where(cov, z, torch.full_like(z, _INF))
        tid = (f + 1).to(torch.int32)[:, None]
        bz, bi = best_z[:n], best_id[:n]
        take = (zc < bz) | ((zc == bz) & cov & (tid < bi))
        best_z[:n] = torch.where(take, zc, bz)
        best_id[:n] = torch.where(take, tid, bi)

    def to_image(x):                                     # sorted tiles
        x = torch.empty_like(x).index_copy_(0, order, x)
        x = x.view(B, nty, ntx, tile_h, tile_w).permute(0, 1, 3, 2, 4)
        return x.reshape(B, nty * tile_h, ntx * tile_w)[:, :H, :W]

    ids = to_image(best_id).contiguous()
    z = torch.where(ids > 0, to_image(best_z), torch.zeros((), device=dev))
    return ids, z.contiguous()


def _winner_rows(table, ids):
    """The winner's rows gathered from the (B,F,16) face table: g6
    (B,6,H,W) = (ax,bx,cx,ay,by,cy), gaux (B,4,H,W) = (nbr0,nbr1,nbr2,
    sign(inv_area)); zero on background."""
    B = table.shape[0]
    bidx = torch.arange(B, device=table.device)[:, None, None]
    fg = ids > 0
    rows = table[bidx, torch.clamp(ids.long() - 1, min=0)]
    rows = rows * fg[..., None]                          # (B,H,W,16)
    g6 = rows[..., [0, 2, 4, 1, 3, 5]].permute(0, 3, 1, 2).contiguous()
    sgn = torch.sign(rows[..., 9:10])
    gaux = torch.cat([rows[..., 10:13], sgn], -1).permute(0, 3, 1, 2) \
        .contiguous()
    return g6, gaux


# ---------------------------------------------------------------------------
# K2a / K2b — visibility over the capped candidate matrix
# ---------------------------------------------------------------------------

def _check_capped(bins: CappedBins, resolution: Tuple[int, int]):
    H, W = resolution
    table = bins.table
    B, F, _ = table.shape
    dev = table.device
    if H % CAP_TILE_H or W % CAP_TILE_W:
        raise ValueError(f"capped visibility needs H % {CAP_TILE_H} == 0 and"
                         f" W % {CAP_TILE_W} == 0, got {resolution}")
    if bins.nty != H // CAP_TILE_H or bins.ntx != W // CAP_TILE_W:
        raise ValueError("capped visibility: bins were made for another "
                         "resolution")
    nt = B * bins.nty * bins.ntx
    _check(table, "table", torch.float32, (B, F, 16))
    _check(bins.counts, "counts", torch.int32, (nt,), dev)
    _check(bins.cand, "cand", torch.int32, (nt, bins.cand.shape[1]), dev)
    return B, F, H, W, bins.cand.shape[1]


def visibility_capped(bins: CappedBins, resolution: Tuple[int, int]):
    """K2b: the outputs of K1 — (ids+1, z, g6, gaux) — over the capped
    candidate matrix (ascending ids, counts <= k, as bin_faces_capped
    builds it)."""
    if not _on_cuda(bins.table, "visibility_capped"):
        return visibility_capped_plain(bins, resolution)
    B, F, H, W, k = _check_capped(bins, resolution)
    dev = bins.table.device
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
    gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    row0, full_h = _viewport((bins.row0, bins.full_h), H)
    _launch("tss_vis_capped_g_launch", _ptr(bins.table), _ptr(bins.counts),
            _ptr(bins.cand), B, F, H, W, k, row0, full_h, _ptr(ids), _ptr(z),
            _ptr(g6), _ptr(gaux))
    visibility_capped.launches += 1
    check_kernel_outputs("visibility_capped", z, g6, gaux)
    return ids, z, g6, gaux


def visibility_capped_ids(bins: CappedBins, resolution: Tuple[int, int]):
    """K2a: (ids+1, z) over the capped candidate matrix."""
    if not _on_cuda(bins.table, "visibility_capped_ids"):
        return visibility_capped_ids_plain(bins, resolution)
    B, F, H, W, k = _check_capped(bins, resolution)
    dev = bins.table.device
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    row0, full_h = _viewport((bins.row0, bins.full_h), H)
    _launch("tss_vis_capped_launch", _ptr(bins.table), _ptr(bins.counts),
            _ptr(bins.cand), B, F, H, W, k, row0, full_h, _ptr(ids),
            _ptr(z))
    visibility_capped_ids.launches += 1
    check_kernel_outputs("visibility_capped_ids", z)
    return ids, z


def visibility_capped_ids_plain(bins: CappedBins,
                                resolution: Tuple[int, int]):
    """Plain version of K2a: K1's walk over the candidate matrix's rows."""
    return _walk_tiles(bins.table, lambda j, tl: bins.cand[tl, j].long(),
                       bins.counts, bins.nty, bins.ntx, CAP_TILE_H,
                       CAP_TILE_W, resolution,
                       _viewport((bins.row0, bins.full_h), resolution[0]))


def visibility_capped_plain(bins: CappedBins, resolution: Tuple[int, int]):
    """Plain version of K2b: K2a's walk, then the winner's rows."""
    ids, z = visibility_capped_ids_plain(bins, resolution)
    return (ids, z, *_winner_rows(bins.table, ids))


# The kernels do not walk: they test each candidate only at the pixels of
# its screen box and take the minimum of a packed (z, id) key per pixel.
# ``visibility_capped_boxed_plain`` repeats that algorithm in PyTorch, so the
# key's order, the fold of -0.0, the box rule and the padding can be held
# against the walk (the definition) where there is no card.

_KEY_BACKGROUND = torch.iinfo(torch.int64).max


def _clip_axis(v: torch.Tensor, n: int, origin: torch.Tensor, extent: int):
    """One axis of the faces' pixel boxes (csrc/vis_capped.cu clip_axis):
    vertex NDC coordinates v (P,3) on an axis of n pixels, clipped to the
    tile pixels [origin, origin + extent). Returns the inclusive global
    pixel range (p0, p1) as int64 and ``empty`` (P,) bool. The box is the
    vertices' pixel-centre span with binning's half-pixel slack
    (``_tile_range`` at a tile of one pixel) and one more pixel on each
    side; a non-finite coordinate empties it. Floats are clamped before the
    cast, so a huge coordinate cannot overflow it."""
    pix = (v + 1.0) * 0.5 * n - 0.5
    lo, hi = pix.amin(-1), pix.amax(-1)
    f0 = torch.ceil(lo - 0.5) - 1.0
    f1 = torch.floor(hi + 0.5) + 1.0
    t0 = origin.to(v.dtype)
    t1 = t0 + (extent - 1)
    empty = ~torch.isfinite(lo) | ~torch.isfinite(hi) | (f1 < t0) | (f0 > t1)
    p0 = torch.maximum(torch.nan_to_num(f0), t0).to(torch.int64)
    p1 = torch.minimum(torch.nan_to_num(f1), t1).to(torch.int64)
    return p0, p1, empty


def _pack_key(z: torch.Tensor, id1: torch.Tensor) -> torch.Tensor:
    """(z, id+1) as an int64 whose signed order is the winner's order:
    smaller z first (-0.0 folded onto +0.0, which compare equal), then the
    smaller id; bit 0 keeps the folded sign so that the z read back has the
    bits it came with. z must be finite."""
    bits = z.contiguous().view(torch.int32)
    neg_zero = bits == -2 ** 31
    bits = torch.where(neg_zero, torch.zeros_like(bits), bits).long()
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return mono * 2 ** 32 + id1.long() * 2 + neg_zero.long()


def _unpack_key(key: torch.Tensor):
    """Inverse of ``_pack_key``: (ids+1 int32, z f32), 0 on background."""
    fg = key != _KEY_BACKGROUND
    key = torch.where(fg, key, torch.zeros_like(key))
    low = key & 0xFFFFFFFF
    mono = key >> 32
    bits = torch.where(mono >= 0, mono, mono ^ 0x7FFFFFFF).to(torch.int32)
    z = bits.view(torch.float32)
    z = torch.where((low & 1) == 1, torch.full_like(z, -0.0), z)
    return (low >> 1).to(torch.int32), z


def boxed_pairs(bins: CappedBins, resolution: Tuple[int, int]):
    """Every live (tile, candidate) pair of the capped layout with its
    clipped pixel box, in the order of the candidate matrix: (view, face,
    x0, x1, y0, y1, npx), int64 (P,) each; x and y are pixel indices of the
    (slab's) output,
    inclusive, and npx is the number of pixel tests the pair needs (0 for
    an empty box or a face that can cover nothing)."""
    H, W = resolution
    table = bins.table
    dev = table.device
    nt = bins.nty * bins.ntx
    k = bins.cand.shape[1]
    live = torch.arange(k, device=dev)[None] < bins.counts[:, None]
    slot = live.nonzero()[:, 0]                  # flat tile of every pair
    f = bins.cand[live].long()                   # padding is never read
    view, tile = slot // nt, slot % nt
    r = table[view, f]                           # (P,16)
    x0, x1, ex = _clip_axis(r[:, 0:5:2], W, (tile % bins.ntx) * CAP_TILE_W,
                            CAP_TILE_W)
    row0, full_h = _viewport((bins.row0, bins.full_h), H)
    y0, y1, ey = _clip_axis(r[:, 1:6:2], full_h,
                            (tile // bins.ntx) * CAP_TILE_H + row0,
                            CAP_TILE_H)
    y0, y1 = y0 - row0, y1 - row0                # absolute -> slab rows
    keep = ~ex & ~ey & (r[:, 9] != 0)            # inv_area 0 covers nothing
    npx = (x1 - x0 + 1) * (y1 - y0 + 1)
    return view, f, x0, x1, y0, y1, torch.where(keep, npx,
                                                torch.zeros_like(npx))


def visibility_capped_boxed_plain(bins: CappedBins,
                                  resolution: Tuple[int, int],
                                  emit_g: bool = True):
    """The kernels' own algorithm in PyTorch: expand every live (tile,
    candidate) pair into the pixels of its clipped box, evaluate coverage
    and z there in the kernels' arithmetic order, pack (z, id+1) keys and
    take the minimum per pixel with one scatter-reduce. Equal to the walk
    (``visibility_capped_plain`` / ``visibility_capped_ids_plain``) bit for
    bit; (ids, z, g6, gaux), or (ids, z) with ``emit_g`` off. One host read
    (the number of pixel tests, ``boxed_pairs(...)[6].sum()``)."""
    H, W = resolution
    table = bins.table
    B, F, _ = table.shape
    dev = table.device
    view, f, x0, x1, y0, y1, npx = boxed_pairs(bins, resolution)
    bw = x1 - x0 + 1
    total = int(npx.sum())                       # host read

    # one row per pixel test
    src = torch.repeat_interleave(torch.arange(f.numel(), device=dev), npx,
                                  output_size=total)
    local = torch.arange(total, device=dev) \
        - (torch.cumsum(npx, 0) - npx)[src]
    bws = bw[src]
    col = x0[src] + local % bws
    row = y0[src] + local // bws
    row0, full_h = _viewport((bins.row0, bins.full_h), H)
    px = ndc_center(col.to(torch.float32), W)
    py = ndc_center((row + row0).to(torch.float32), full_h)
    r = table[view[src], f[src]]                 # (total,16)
    ax, ay, bx, by = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    cx, cy, z0, z1 = r[:, 4], r[:, 5], r[:, 6], r[:, 7]
    z2, inv_area = r[:, 8], r[:, 9]
    e0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area
    e1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv_area
    e2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * inv_area
    z = e0 * z0 + e1 * z1 + e2 * z2
    cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (inv_area != 0) \
        & (z >= -1.0) & (z <= 1.0)

    key = _pack_key(z[cov], f[src][cov] + 1)
    pixel = (view[src][cov] * H + row[cov]) * W + col[cov]
    best = torch.full((B * H * W,), _KEY_BACKGROUND, dtype=torch.int64,
                      device=dev)
    best.scatter_reduce_(0, pixel, key, "amin")
    ids, zw = _unpack_key(best.view(B, H, W))
    return (ids, zw, *_winner_rows(table, ids)) if emit_g else (ids, zw)


# ---------------------------------------------------------------------------
# K3 — table gradient of the winner rows
# ---------------------------------------------------------------------------

def wsr_table_grad(ids: torch.Tensor, ct6: torch.Tensor, F: int
                   ) -> torch.Tensor:
    """Per-face sums of the winner-row cotangents: ids (B,H,W) int32,
    ct6 (B,6,H,W) f32 -> (B,F+1,6) f32; a pixel counts where its id is > 0
    and a cotangent != 0; row F is zero. The C entry zeroes the table."""
    if not _on_cuda(ct6, "wsr_table_grad"):
        return wsr_table_grad_plain(ids, ct6, F)
    B, C, H, W = ct6.shape
    dev = ct6.device
    _check(ids, "ids", torch.int32, (B, H, W), dev)
    _check(ct6, "ct6", torch.float32, (B, 6, H, W))
    out = torch.empty((B, F + 1, 6), dtype=torch.float32, device=dev)
    _launch("tss_wsr_grad_launch", _ptr(ids), _ptr(ct6), B, H, W, F,
            _ptr(out))
    wsr_table_grad.launches += 1
    check_kernel_outputs("wsr_table_grad", out)
    return out


def wsr_table_grad_plain(ids: torch.Tensor, ct6: torch.Tensor, F: int
                         ) -> torch.Tensor:
    """Plain version of K3: each face's active pixels (``id > 0`` and a
    cotangent != 0) summed into its own row in float64 (``index_add_``),
    so a NaN or inf reaches that face's row and no other."""
    B, C, H, W = ct6.shape
    rows = ct6.permute(0, 2, 3, 1).reshape(-1, C)        # (B*H*W, 6)
    b = torch.arange(B, device=ct6.device).repeat_interleave(H * W)
    idv = ids.reshape(-1).long()
    active = (idv > 0) & (rows != 0).any(dim=1)
    key = (b * (F + 1) + idv - 1)[active]
    out = torch.zeros((B * (F + 1), C), dtype=torch.float64,
                      device=ct6.device)
    out.index_add_(0, key, rows[active].double())
    return out.to(ct6.dtype).view(B, F + 1, C)


# ---------------------------------------------------------------------------
# K4 / K5 — silhouette antialias forward and backward (all pixel pairs)
# ---------------------------------------------------------------------------

def _pair_eval(ida, idb, za, zb, ga, gb, auxa, auxb, pax, pay, pbx, pby,
               pair_ok):
    """The pair math of ``_aa_pairs`` (rasterize.py:880) on one axis of
    pixel pairs a -> b; colour = coverage. Channel-major g (B,6,...),
    aux (B,4,...); ``pair_ok`` is False where the pair does not exist (a
    vertical pair with a row outside the image, JAX's ``row_valid`` cut).
    Returns the quantities K4 and K5 need."""
    differ = (ida != idb) & ((ida > 0) | (idb > 0)) & pair_ok
    owner_a = (ida != 0) & ((idb == 0) | (za <= zb))
    other_tri = torch.where(owner_a, idb, ida) - 1
    o = owner_a[:, None]
    g = torch.where(o, ga, gb)
    aux = torch.where(o, auxa, auxb)
    sgn = aux[:, 3]
    te, tn = [], []
    for e in range(3):
        e1 = (e + 1) % 3
        x0, y0, x1, y1 = g[:, e], g[:, 3 + e], g[:, e1], g[:, 3 + e1]
        sa = ((x1 - x0) * (pay - y0) - (y1 - y0) * (pax - x0)) * sgn
        sb = ((x1 - x0) * (pby - y0) - (y1 - y0) * (pbx - x0)) * sgn
        denom = sa - sb
        safe = torch.where(torch.abs(denom) > 1e-20, denom,
                           torch.ones_like(denom))
        t_all = sa / safe
        te.append(torch.where((sa >= 0) & (sb < 0), t_all,
                              torch.full_like(t_all, _INF)))
        tn.append(torch.where((sa < 0) & (sb >= 0), t_all,
                              torch.full_like(t_all, -_INF)))

    def pick3(v, better):
        c01 = better(v[1], v[0])
        b01 = torch.where(c01, v[1], v[0])
        c2 = better(v[2], b01)
        k = torch.where(c2, 2, torch.where(c01, 1, 0))
        return torch.where(c2, v[2], b01), k

    t_exit, k_exit = pick3(te, lambda x, y: x < y)
    t_entry, k_entry = pick3(tn, lambda x, y: x > y)
    k = torch.where(owner_a, k_exit, k_entry)
    t = torch.where(owner_a, t_exit, t_entry)
    found = torch.isfinite(t)
    nbr = torch.where(k == 0, aux[:, 0], torch.where(k == 1, aux[:, 1],
                                                     aux[:, 2]))
    other_fg = torch.where(owner_a, idb > 0, ida > 0)
    shared = (nbr == other_tri.to(nbr.dtype)) & (other_tri >= 0) & other_fg
    valid = differ & found & ~shared
    tc = torch.clamp(torch.where(valid, t, torch.full_like(t, 0.5)), 0.0, 1.0)
    v = valid.to(tc.dtype)
    w_a = torch.clamp_min(0.5 - tc, 0.0) * v
    w_b = torch.clamp_min(tc - 0.5, 0.0) * v
    col_a = (ida > 0).to(tc.dtype)
    col_b = (idb > 0).to(tc.dtype)
    return dict(valid=valid, owner_a=owner_a, k=k, t=t, tc=tc, g=g,
                sgn=sgn, col_a=col_a, col_b=col_b,
                delta_a=(col_b - col_a) * w_a, delta_b=(col_a - col_b) * w_b)


def _step(u):
    """d max(u, 0)/du with JAX's balanced tie (1/2 at u == 0)."""
    return torch.where(u > 0, 1.0, torch.where(u == 0, 0.5, 0.0))


def _pair_grad(P, ct_a, ct_b, pax, pay, pbx, pby):
    """Owner d g6 (B,6,...) of ct_a*delta_a + ct_b*delta_b (aa_pair.cuh
    aa::grad, vectorized)."""
    g, s, k = P["g"], P["sgn"], P["k"]
    g_tc = ct_a * (P["col_b"] - P["col_a"]) * -_step(0.5 - P["tc"]) \
        + ct_b * (P["col_a"] - P["col_b"]) * _step(P["tc"] - 0.5)
    g_t = g_tc * _step(P["t"]) * _step(1.0 - P["t"])
    g_t = torch.where(P["valid"], g_t, torch.zeros_like(g_t))
    c = torch.zeros_like(g)
    for e in range(3):
        e1 = (e + 1) % 3
        sel = P["valid"] & (k == e)
        x0, y0, x1, y1 = g[:, e], g[:, 3 + e], g[:, e1], g[:, 3 + e1]
        sa = ((x1 - x0) * (pay - y0) - (y1 - y0) * (pax - x0)) * s
        sb = ((x1 - x0) * (pby - y0) - (y1 - y0) * (pbx - x0)) * s
        denom = sa - sb
        big = torch.abs(denom) > 1e-20
        safe = torch.where(big, denom, torch.ones_like(denom))
        gt = torch.where(sel, g_t, torch.zeros_like(g_t))
        g_safe = torch.where(big, -gt * sa / (safe * safe),
                             torch.zeros_like(gt))
        ga = (gt / safe + g_safe) * s
        gb = -g_safe * s
        a1, c1 = x1 - x0, y1 - y0
        ba, da = pay - y0, pax - x0
        bb, db = pby - y0, pbx - x0
        zero = torch.zeros_like(gt)
        c[:, e] += torch.where(sel, ga * (c1 - ba) + gb * (c1 - bb), zero)
        c[:, e1] += torch.where(sel, ga * ba + gb * bb, zero)
        c[:, 3 + e] += torch.where(sel, ga * (da - a1) + gb * (db - a1), zero)
        c[:, 3 + e1] += torch.where(sel, -ga * da - gb * db, zero)
    return c


def _pairs(ids, z, g6, gaux, axis: int, viewport):
    """Pair operands along ``axis`` (2: horizontal a=(r,c), b=(r,c+1);
    1: vertical a=(r,c), b=(r+1,c)) with the pixel centres of the absolute
    rows of ``viewport`` (row0, full_h), and whether each pair exists:
    always across, down only where both absolute rows lie in the image."""
    B, H, W = ids.shape
    row0, full_h = viewport
    px, py = pixel_centers((H, W), ids.device, row0=row0, full_h=full_h)
    px, py = px.expand(H, W), py.expand(H, W)
    absr = torch.arange(H, device=ids.device) + row0
    inside = ((absr >= 0) & (absr < full_h))[:, None].expand(H, W)

    def a(x, d):                       # d: index of the H/W dim in x
        return x.narrow(d + (axis - 1), 0, x.shape[d + axis - 1] - 1)

    def b(x, d):
        return x.narrow(d + (axis - 1), 1, x.shape[d + axis - 1] - 1)

    ok = a(inside, 0) & b(inside, 0) if axis == 1 else \
        torch.ones_like(a(inside, 0))
    return (a(ids, 1), b(ids, 1), a(z, 1), b(z, 1), a(g6, 2), b(g6, 2),
            a(gaux, 2), b(gaux, 2), a(px, 0), a(py, 0), b(px, 0), b(py, 0),
            ok)


def _pad(x, axis: int, before: bool):
    """Pad one zero row/column on the H (axis 1) or W (axis 2) axis of the
    last two dims of x."""
    pad = [0, 0, 0, 0]
    pad[(2 - axis) * 2 + (0 if before else 1)] = 1
    return torch.nn.functional.pad(x, pad)


def aa_forward(ids, z, g6, gaux, viewport=None) -> torch.Tensor:
    """Antialiased silhouette coverage (B,H,W) f32 from the winner ids
    (B,H,W) int32, z (B,H,W), g6 (B,6,H,W) and gaux (B,4,H,W); the H rows
    are absolute rows row0.. of a full_h-tall image with ``viewport``
    (row0, full_h)."""
    if not _on_cuda(g6, "aa_forward"):
        return aa_forward_plain(ids, z, g6, gaux, viewport)
    B, H, W = ids.shape
    _check_aa(ids, z, g6, gaux)
    row0, full_h = _viewport(viewport, H)
    out = torch.empty((B, H, W), dtype=torch.float32, device=g6.device)
    _launch("tss_aa_fwd_launch", _ptr(ids), _ptr(z), _ptr(g6), _ptr(gaux),
            B, H, W, row0, full_h, _ptr(out))
    aa_forward.launches += 1
    check_kernel_outputs("aa_forward", out)
    return out


def aa_forward_plain(ids, z, g6, gaux, viewport=None) -> torch.Tensor:
    """Plain version of K4: the dense antialias chain of rasterize.py:975
    on the silhouette (horizontal pairs, then vertical)."""
    vp = _viewport(viewport, ids.shape[1])
    out = (ids > 0).to(torch.float32)
    for axis in (2, 1):
        ops = _pairs(ids, z, g6, gaux, axis, vp)
        P = _pair_eval(*ops)
        out = out + _pad(P["delta_a"], axis, before=False)
        out = out + _pad(P["delta_b"], axis, before=True)
    return out


def aa_backward(ids, z, g6, gaux, ct, viewport=None) -> torch.Tensor:
    """d g6 (B,6,H,W) of ``aa_forward`` under the cotangent ct (B,H,W)."""
    if not _on_cuda(g6, "aa_backward"):
        return aa_backward_plain(ids, z, g6, gaux, ct, viewport)
    B, H, W = ids.shape
    _check_aa(ids, z, g6, gaux)
    _check(ct, "ct", torch.float32, (B, H, W), g6.device)
    row0, full_h = _viewport(viewport, H)
    dg6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=g6.device)
    _launch("tss_aa_bwd_launch", _ptr(ids), _ptr(z), _ptr(g6), _ptr(gaux),
            _ptr(ct), B, H, W, row0, full_h, _ptr(dg6))
    aa_backward.launches += 1
    check_kernel_outputs("aa_backward", dg6)
    return dg6


def aa_backward_plain(ids, z, g6, gaux, ct, viewport=None) -> torch.Tensor:
    """Plain version of K5: the hand-derived pair backward, vectorized; each
    pair's owner gradient lands on its owner pixel."""
    vp = _viewport(viewport, ids.shape[1])
    dg = torch.zeros_like(g6)
    for axis in (2, 1):
        ops = _pairs(ids, z, g6, gaux, axis, vp)
        P = _pair_eval(*ops)
        pax, pay, pbx, pby = ops[8:12]
        n = ids.shape[axis] - 1
        c = _pair_grad(P, ct.narrow(axis, 0, n), ct.narrow(axis, 1, n),
                       pax, pay, pbx, pby)
        own = P["owner_a"][:, None]
        zero = torch.zeros_like(c)
        dg = dg + _pad(torch.where(own, c, zero), axis, before=False)
        dg = dg + _pad(torch.where(own, zero, c), axis, before=True)
    return dg


def _check_aa(ids, z, g6, gaux):
    B, H, W = ids.shape
    dev = g6.device
    _check(ids, "ids", torch.int32, (B, H, W), dev)
    _check(z, "z", torch.float32, (B, H, W), dev)
    _check(g6, "g6", torch.float32, (B, 6, H, W))
    _check(gaux, "gaux", torch.float32, (B, 4, H, W), dev)


# ---------------------------------------------------------------------------
# K6 / K7 / K8 — the shaded path's per-pixel work on the winners' face rows
# ---------------------------------------------------------------------------

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
        # each boolean mask waits for the device to count its pixels
        with span("tssplat.sync.row_gather"):
            t = (bidx * F + ids.long() - 1)[fg]          # (n_fg,)
        out = tbl.new_zeros((*ids.shape, C))
        with span("tssplat.sync.row_gather"):
            out[fg] = tbl.reshape(B * F, C)[t]
        ctx.save_for_backward(fg, t)
        ctx.tbl_shape = tbl.shape
        return out

    @staticmethod
    def backward(ctx, ct):
        fg, t = ctx.saved_tensors
        B, F, C = ctx.tbl_shape
        with span("tssplat.sync.row_gather"):
            ct_fg = ct[fg]
        d = ct.new_zeros((B * F, C)).index_add_(0, t, ct_fg)
        return d.view(B, F, C), None


def _row_gather(tbl: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel rows (B,H,W,C) of the (B,F,C) face table at the winners
    ids+1 (B,H,W); background pixels get an all-zero row
    (``_row_gather``, rasterize.py:517). The plain versions of K6-K8 gather
    with it: on the CPU it is the shaded path's gather, differentiable."""
    return _RowGather.apply(tbl, ids)


def _fold_rows(vals: torch.Tensor, view: torch.Tensor, ids: torch.Tensor,
               B: int, F: int) -> torch.Tensor:
    """Per-pixel rows ``vals`` (n,C) of the pixels of views ``view`` with
    winners ``ids`` (id+1) summed into their faces' rows in float64
    (``index_add_``, as K3's plain version folds): (B,F,C) in vals' type."""
    out = torch.zeros((B * F, vals.shape[-1]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, view * F + ids.long() - 1, vals.double())
    return out.to(vals.dtype).view(B, F, -1)


def shade(ids: torch.Tensor, tbl: torch.Tensor, viewport=None
          ) -> torch.Tensor:
    """K6: rast (B,H,W,4) = (u, v, z/w, id+1) of each pixel's winner ids+1
    (B,H,W) int32, from the per-face screen table tbl (B,F,12) = (ax,bx,cx,
    ay,by,cy, z0,z1,z2, iw0,iw1,iw2): barycentrics perspective-corrected by
    1/w, zero on background, at the pixel centres of the absolute rows of
    ``viewport`` (row0, full_h). Its gradient is ``shade_backward``."""
    if not _on_cuda(tbl, "shade"):
        return shade_plain(ids, tbl, viewport)
    B, H, W = ids.shape
    F = tbl.shape[1]
    dev = tbl.device
    _check(ids, "ids", torch.int32, (B, H, W), dev)
    _check(tbl, "tbl", torch.float32, (B, F, 12))
    row0, full_h = _viewport(viewport, H)
    rast = torch.empty((B, H, W, 4), dtype=torch.float32, device=dev)
    _launch("tss_shade_launch", _ptr(ids), _ptr(tbl), B, H, W, F, row0,
            full_h, _ptr(rast))
    shade.launches += 1
    check_kernel_outputs("shade", rast)
    return rast


def shade_plain(ids: torch.Tensor, tbl: torch.Tensor, viewport=None
                ) -> torch.Tensor:
    """Plain version of K6 (``_shade_rast``, rasterize.py:688),
    differentiable in tbl: one row gather of the table at the winners, the
    barycentrics recomputed from it, the 1/w correction."""
    g = _row_gather(tbl, ids)                            # (B,H,W,12)
    H, W = ids.shape[1:]
    row0, full_h = _viewport(viewport, H)
    px, py = pixel_centers((H, W), tbl.device, tbl.dtype, row0, full_h)

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
    fg = (ids > 0).to(tbl.dtype)
    return torch.stack([u * fg, v * fg, zbuf * fg, ids.to(tbl.dtype)],
                       dim=-1)


def shade_backward(ids: torch.Tensor, tbl: torch.Tensor, ct: torch.Tensor,
                   viewport=None) -> torch.Tensor:
    """K6's backward: d tbl (B,F,12) of ``shade`` under the cotangent ct
    (B,H,W,4) of rast; a pixel counts where its id is > 0 and its
    cotangent of (u, v, z) is not all 0 (channel 3, the id, has none). The
    C entry zeroes the table."""
    if not _on_cuda(ct, "shade_backward"):
        return shade_backward_plain(ids, tbl, ct, viewport)
    B, H, W = ids.shape
    F = tbl.shape[1]
    dev = tbl.device
    _check(ids, "ids", torch.int32, (B, H, W), dev)
    _check(tbl, "tbl", torch.float32, (B, F, 12))
    _check(ct, "ct", torch.float32, (B, H, W, 4), dev)
    row0, full_h = _viewport(viewport, H)
    out = torch.empty((B, F, 12), dtype=torch.float32, device=dev)
    _launch("tss_shade_grad_launch", _ptr(ids), _ptr(tbl), _ptr(ct), B, H,
            W, F, row0, full_h, _ptr(out))
    shade_backward.launches += 1
    check_kernel_outputs("shade_backward", out)
    return out


def _shade_grad(r, px, py, gu, gv, gz):
    """d (u, v, z) / d row at pixels (px, py) of faces with rows r (n,12),
    under the cotangents (gu, gv, gz): (n,12) in the table's channel order.
    The forward's area, edges and barycentrics are recomputed as K6
    computes them, then their backward; every operation in the order of
    csrc/shade.cu's ``row_grad``."""
    ax, bx, cx, ay, by, cy, z0, z1, z2, w0, w1, w2 = r.unbind(-1)
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    area = edge(ax, ay, bx, by, cx, cy)
    ok_a = torch.abs(area) > AREA_EPS
    sa = torch.where(ok_a, area, one)
    l0 = edge(bx, by, cx, cy, px, py) / sa
    l1 = edge(cx, cy, ax, ay, px, py) / sa
    l2 = edge(ax, ay, bx, by, px, py) / sa
    d0, d1, d2 = l0 * w0, l1 * w1, l2 * w2
    s = d0 + d1 + d2
    ok_s = torch.abs(s) > W_EPS
    s = torch.where(ok_s, s, one)
    u, v = d0 / s, d1 / s
    gs = torch.where(ok_s, -(gu * u + gv * v) / s, zero)
    gd0, gd1, gd2 = gu / s + gs, gv / s + gs, gs
    # the cotangents of the edge values, and of the area where it divides
    ge0 = (gd0 * w0 + gz * z0) / sa
    ge1 = (gd1 * w1 + gz * z1) / sa
    ge2 = (gd2 * w2 + gz * z2) / sa
    ga = torch.where(ok_a, -(ge0 * l0 + ge1 * l1 + ge2 * l2), zero)
    return torch.stack([
        ge1 * (py - cy) + ge2 * (by - py) + ga * (by - cy),
        ge0 * (cy - py) + ge2 * (py - ay) + ga * (cy - ay),
        ge0 * (py - by) + ge1 * (ay - py) + ga * (ay - by),
        ge1 * (cx - px) + ge2 * (px - bx) + ga * (cx - bx),
        ge0 * (px - cx) + ge2 * (ax - px) + ga * (ax - cx),
        ge0 * (bx - px) + ge1 * (px - ax) + ga * (bx - ax),
        gz * l0, gz * l1, gz * l2,
        gd0 * l0, gd1 * l1, gd2 * l2], dim=-1)


def _shade_grad_pixels(ids, tbl, ct, viewport=None):
    """K6's backward before its fold: the rows (n,12) of the counted pixels
    (``_shade_grad``), with their views (n,) and ids+1 (n,)."""
    H, W = ids.shape[1:]
    row0, full_h = _viewport(viewport, H)
    g = ct[..., :3]
    act = (ids > 0) & (g != 0).any(-1)
    b, r, c = act.nonzero(as_tuple=True)
    f = ids[act]
    px = ndc_center(c.to(tbl.dtype), W)
    py = ndc_center((r + row0).to(tbl.dtype), full_h)
    gu, gv, gz = g[act].unbind(-1)
    return (_shade_grad(tbl.detach()[b, f.long() - 1], px, py, gu, gv, gz),
            b, f)


def shade_backward_plain(ids: torch.Tensor, tbl: torch.Tensor,
                         ct: torch.Tensor, viewport=None) -> torch.Tensor:
    """Plain version of K6's backward: each counted pixel's gradient of its
    face's row (``_shade_grad``), summed per face in float64."""
    return _fold_rows(*_shade_grad_pixels(ids, tbl, ct, viewport),
                      ids.shape[0], tbl.shape[1])


def _check_attr(rast, tbl, name):
    B, H, W, _ = rast.shape
    dev = tbl.device
    _check(rast, "rast", torch.float32, (B, H, W, 4), dev)
    _check(tbl, name, torch.float32)
    if tbl.dim() != 3 or tbl.shape[0] not in (1, B) or tbl.shape[2] % 3:
        raise ValueError(f"{name}: expected (1 or {B}, F, 3C), got "
                         f"{tuple(tbl.shape)}")
    return B, H, W, tbl.shape[1], tbl.shape[2] // 3, int(tbl.shape[0] > 1)


def interp(rast: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """K7: the attributes (B,H,W,C) = u*a0 + v*a1 + (1-u-v)*a2 at the
    winners of rast (B,H,W,4), from the per-face table tbl (1,F,3C), shared
    by the views, or (B,F,3C), one per view (row f = corners 3f..3f+2 of
    the corner layout); zero on background. Its gradient is
    ``interp_backward``."""
    if not _on_cuda(tbl, "interp"):
        return interp_plain(rast, tbl)
    B, H, W, F, C, per_view = _check_attr(rast, tbl, "tbl")
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=tbl.device)
    _launch("tss_interp_launch", _ptr(rast), _ptr(tbl), B, H, W, F, C,
            per_view, _ptr(out))
    interp.launches += 1
    check_kernel_outputs("interp", out)
    return out


def interp_plain(rast: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (``interpolate``, rasterize.py:842, corner
    layout), differentiable in tbl and in rast's u and v: one row gather of
    the table at the winners, then the barycentric blend."""
    ids = rast[..., 3].detach().to(torch.int32)
    B = ids.shape[0]
    F, C = tbl.shape[1], tbl.shape[2] // 3
    a = _row_gather(tbl.expand(B, F, 3 * C), ids).view(*ids.shape, 3, C)
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    out = a[..., 0, :] * u + a[..., 1, :] * v + a[..., 2, :] * (1.0 - u - v)
    return out * (ids > 0)[..., None].to(out.dtype)


def interp_backward(rast: torch.Tensor, tbl: torch.Tensor, ct: torch.Tensor):
    """K7's backward under the cotangent ct (B,H,W,C): (d tbl (B,F,3C),
    one row per view even where tbl is shared; d rast (B,H,W,4) = (d u,
    d v, 0, 0), zero on background). A pixel counts towards d tbl where
    its id is > 0 and its cotangent is not all 0. The C entry zeroes
    d tbl."""
    if not _on_cuda(ct, "interp_backward"):
        return interp_backward_plain(rast, tbl, ct)
    B, H, W, F, C, per_view = _check_attr(rast, tbl, "tbl")
    dev = tbl.device
    _check(ct, "ct", torch.float32, (B, H, W, C), dev)
    d_tbl = torch.empty((B, F, 3 * C), dtype=torch.float32, device=dev)
    d_rast = torch.empty((B, H, W, 4), dtype=torch.float32, device=dev)
    _launch("tss_interp_grad_launch", _ptr(rast), _ptr(tbl), _ptr(ct), B, H,
            W, F, C, per_view, _ptr(d_tbl), _ptr(d_rast))
    interp_backward.launches += 1
    check_kernel_outputs("interp_backward", d_tbl, d_rast)
    return d_tbl, d_rast


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim in index order, as K7 adds channels."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _interp_grad_pixels(rast, tbl, ct):
    """K7's backward before its fold: d rast, and the attribute rows
    (n,3C) = (ct u, ct v, ct (1-u-v)) of the counted pixels with their
    views (n,) and ids+1 (n,)."""
    ids = rast[..., 3].to(torch.int32)
    B, H, W, C = ct.shape
    F = tbl.shape[1]
    fg = ids > 0
    with torch.no_grad():
        a = _row_gather(tbl.detach().expand(B, F, 3 * C), ids) \
            .view(B, H, W, 3, C)
    u, v = rast[..., 0:1], rast[..., 1:2]
    s0, s1, s2 = (_channel_sum(ct * a[..., k, :]) for k in range(3))
    zero = torch.zeros((), dtype=ct.dtype, device=ct.device)
    du, dv = torch.where(fg, s0 - s2, zero), torch.where(fg, s1 - s2, zero)
    d_rast = torch.stack([du, dv, torch.zeros_like(du), torch.zeros_like(du)],
                         dim=-1)
    act = fg & (ct != 0).any(-1)
    vals = torch.cat([ct * u, ct * v, ct * (1.0 - u - v)], dim=-1)[act]
    return d_rast, vals, act.nonzero()[:, 0], ids[act]


def interp_backward_plain(rast: torch.Tensor, tbl: torch.Tensor,
                          ct: torch.Tensor):
    """Plain version of K7's backward: d u = sum_c ct a0 - sum_c ct a2 and
    d v = sum_c ct a1 - sum_c ct a2 at each foreground pixel; the
    attributes' cotangents (ct u, ct v, ct (1-u-v)) of each counted pixel
    summed per (view, face) in float64."""
    d_rast, vals, view, ids = _interp_grad_pixels(rast, tbl, ct)
    return _fold_rows(vals, view, ids, ct.shape[0], tbl.shape[1]), d_rast


def winner_rows(rast: torch.Tensor, tbl6: torch.Tensor,
                edge_nbrs: torch.Tensor):
    """K8: K4/K5's inputs on the shaded path, without gradient: ids
    (B,H,W) int32 and z (B,H,W) of rast (B,H,W,4), and the winners' rows
    channel-major, g6 (B,6,H,W) from tbl6 (B,F,6) = (ax,bx,cx,ay,by,cy) and
    gaux (B,4,H,W) = (the edge neighbours edge_nbrs (F,3) int64 as floats,
    the sign of the face's screen area); rows zero on background."""
    if not _on_cuda(tbl6, "winner_rows"):
        return winner_rows_plain(rast, tbl6, edge_nbrs)
    B, H, W, _ = rast.shape
    F = tbl6.shape[1]
    dev = tbl6.device
    _check(rast, "rast", torch.float32, (B, H, W, 4), dev)
    _check(tbl6, "tbl6", torch.float32, (B, F, 6))
    _check(edge_nbrs, "edge_nbrs", torch.int64, (F, 3), dev)
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
    gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    _launch("tss_winner_rows_launch", _ptr(rast), _ptr(tbl6),
            _ptr(edge_nbrs), B, H, W, F, _ptr(ids), _ptr(z), _ptr(g6),
            _ptr(gaux))
    winner_rows.launches += 1
    check_kernel_outputs("winner_rows", z, g6, gaux)
    return ids, z, g6, gaux


def winner_rows_plain(rast: torch.Tensor, tbl6: torch.Tensor,
                      edge_nbrs: torch.Tensor):
    """Plain version of K8: one row gather of the table widened by the
    edge neighbours and the area's sign, put channel-major."""
    ids = rast[..., 3].detach().to(torch.int32).contiguous()
    z = rast[..., 2].detach().contiguous()
    B, F = tbl6.shape[0], edge_nbrs.shape[0]
    with torch.no_grad():
        t = tbl6.detach()
        area = edge(t[..., 0], t[..., 3], t[..., 1], t[..., 4], t[..., 2],
                    t[..., 5])
        nb = edge_nbrs.to(t.dtype).unsqueeze(0).expand(B, F, 3)
        rows = _row_gather(torch.cat([t, nb, torch.sign(area)[..., None]],
                                     dim=-1), ids).permute(0, 3, 1, 2)
    return ids, z, rows[:, :6].contiguous(), rows[:, 6:].contiguous()


# every hand-written kernel of the port, K9 (``ops/hash_grid.py``) and K10
# (``ops/aa_l1.py``) too
KERNELS = (visibility, visibility_capped_ids, visibility_capped,
           wsr_table_grad, aa_forward, aa_backward, shade, shade_backward,
           interp, interp_backward, winner_rows, hash_grid,
           hash_grid_backward, aa_l1, aa_l1_backward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
