"""The rasterizer's hand-written CUDA kernels, each beside its plain
PyTorch version (counterpart of ``tssplat_tpu/ops/pallas_raster.py``).

  K1  ``visibility``             csrc/vis.cu         <- _vis_kernel_flat
  K2a ``visibility_capped_ids``  csrc/vis_capped.cu  <- _vis_kernel
  K2b ``visibility_capped``      csrc/vis_capped.cu  <- _vis_kernel_g
  K3  ``wsr_table_grad``         csrc/wsr_grad.cu    <- _wsr_grad_kernel
  K4  ``aa_forward``             csrc/aa_fwd.cu      <- _aa_halo_fwd_kernel
  K5  ``aa_backward``            csrc/aa_bwd.cu      <- _aa_halo_bwd_kernel

(K4 and K5 also take the place of the XLA border pass beside their TPU
kernels.)

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
source.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..utils.debug import check_kernel_outputs
from .binning import (CAP_TILE_H, CAP_TILE_W, CappedBins, FaceBins, TILE_H,
                      TILE_W)
from .screen import ndc_center, pixel_centers

_INF = float("inf")


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (plain version), True for CUDA (kernel)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _launch(fn_name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = build.entry(fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


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


KERNELS = (visibility, visibility_capped_ids, visibility_capped,
           wsr_table_grad, aa_forward, aa_backward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
