"""The rasterizer's hand-written CUDA kernels, each beside its plain
PyTorch version (counterpart of ``tssplat_tpu/ops/pallas_raster.py``).

  K1 ``visibility``      csrc/vis.cu       <- _vis_kernel_flat (emit_g)
  K3 ``wsr_table_grad``  csrc/wsr_grad.cu  <- _wsr_grad_kernel
  K4 ``aa_forward``      csrc/aa_fwd.cu    <- _aa_halo_fwd_kernel + border pass
  K5 ``aa_backward``     csrc/aa_bwd.cu    <- _aa_halo_bwd_kernel + border pass

Each wrapper takes the plain version for tensors on the CPU, and launches
its kernel for CUDA tensors (or raises: there is no fallback). It checks
device, dtype, shape and contiguity, allocates the outputs, launches on
PyTorch's current stream, raises if ``cudaGetLastError`` is not 0, and
adds one to its ``launches`` count. The plain versions repeat the kernels'
arithmetic in the same order, so on the card the two agree to the last bit
except where K3's atomics reorder sums. What bounds each kernel and what
its design does about it is noted at the top of its source.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from .binning import FaceBins, TILE_H, TILE_W
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


# ---------------------------------------------------------------------------
# K1 — visibility with winner rows
# ---------------------------------------------------------------------------

def visibility(bins: FaceBins, resolution: Tuple[int, int]):
    """Winner per pixel over the binned faces: (ids+1 (B,H,W) int32,
    z (B,H,W) f32, g6 (B,6,H,W) f32 = (ax,bx,cx,ay,by,cy), gaux (B,4,H,W)
    f32 = (nbr0,nbr1,nbr2,sign)); all zero on background."""
    table = bins.table
    if not _on_cuda(table, "visibility"):
        return visibility_plain(bins, resolution)
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
    g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
    gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    _launch("tss_vis_launch", _ptr(table), _ptr(bins.tile_start),
            _ptr(bins.tile_count), _ptr(faces), B, F, H, W, bins.nty,
            bins.ntx, 1, _ptr(ids), _ptr(z), _ptr(g6), _ptr(gaux))
    visibility.launches += 1
    return ids, z, g6, gaux


def visibility_plain(bins: FaceBins, resolution: Tuple[int, int]):
    """Plain version of K1: the same per-tile candidate walk, one candidate
    slot of every tile at a time, with the kernel's arithmetic order."""
    H, W = resolution
    table = bins.table
    B, F, _ = table.shape
    dev = table.device
    nty, ntx = bins.nty, bins.ntx
    nt = nty * ntx
    # per-tile pixel centres (nt, TILE_H*TILE_W), row-major inside the tile
    ly = torch.arange(TILE_H, device=dev).repeat_interleave(TILE_W)
    lx = torch.arange(TILE_W, device=dev).repeat(TILE_H)
    tiles = torch.arange(nt, device=dev)
    row = (tiles // ntx)[:, None] * TILE_H + ly[None]
    col = (tiles % ntx)[:, None] * TILE_W + lx[None]
    px = ndc_center(col.to(torch.float32), W)
    py = ndc_center(row.to(torch.float32), H)

    start = bins.tile_start.view(B, nt).long()
    count = bins.tile_count.view(B, nt).long()
    best_z = torch.full((B, nt, TILE_H * TILE_W), _INF, device=dev)
    best_id = torch.zeros((B, nt, TILE_H * TILE_W), dtype=torch.int32,
                          device=dev)
    n_faces = bins.faces.numel()
    bidx = torch.arange(B, device=dev)[:, None]
    for j in range(int(count.max()) if count.numel() else 0):
        live = (j < count)[..., None]
        f = bins.faces[torch.clamp(start + j, max=n_faces - 1)].long()
        r = table[bidx, f][..., None, :]                 # (B,nt,1,16)
        ax, ay, bx, by = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        cx, cy, z0, z1 = r[..., 4], r[..., 5], r[..., 6], r[..., 7]
        z2, inv_area = r[..., 8], r[..., 9]
        e0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area
        e1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv_area
        e2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * inv_area
        z = e0 * z0 + e1 * z1 + e2 * z2
        cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (inv_area != 0) \
            & (z >= -1.0) & (z <= 1.0)
        zc = torch.where(cov, z, torch.full_like(z, _INF))
        tid = (f + 1).to(torch.int32)[..., None]
        take = ((zc < best_z) | ((zc == best_z) & cov & (tid < best_id))) \
            & live
        best_z = torch.where(take, zc, best_z)
        best_id = torch.where(take, tid, best_id)

    def to_image(x):                                     # (B,nt,th*tw)
        x = x.view(B, nty, ntx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
        return x.reshape(B, nty * TILE_H, ntx * TILE_W)[:, :H, :W]

    ids = to_image(best_id).contiguous()
    fg = ids > 0
    z = torch.where(fg, to_image(best_z), torch.zeros((), device=dev))
    rows = table[bidx[..., None], torch.clamp(ids.long() - 1, min=0)]
    rows = rows * fg[..., None]                          # (B,H,W,16)
    g6 = rows[..., [0, 2, 4, 1, 3, 5]].permute(0, 3, 1, 2).contiguous()
    sgn = torch.sign(rows[..., 9:10])
    gaux = torch.cat([rows[..., 10:13], sgn], -1).permute(0, 3, 1, 2) \
        .contiguous()
    return ids, z.contiguous(), g6, gaux


# ---------------------------------------------------------------------------
# K3 — table gradient of the winner rows
# ---------------------------------------------------------------------------

def wsr_table_grad(ids: torch.Tensor, ct6: torch.Tensor, F: int
                   ) -> torch.Tensor:
    """Per-face sums of the winner-row cotangents: ids (B,H,W) int32,
    ct6 (B,6,H,W) f32 -> (B,F+1,6) f32; row F is never written."""
    if not _on_cuda(ct6, "wsr_table_grad"):
        return wsr_table_grad_plain(ids, ct6, F)
    B, C, H, W = ct6.shape
    dev = ct6.device
    _check(ids, "ids", torch.int32, (B, H, W), dev)
    _check(ct6, "ct6", torch.float32, (B, 6, H, W))
    out = torch.zeros((B, F + 1, 6), dtype=torch.float32, device=dev)
    _launch("tss_wsr_grad_launch", _ptr(ids), _ptr(ct6), B, H, W, F,
            _ptr(out))
    wsr_table_grad.launches += 1
    return out


def wsr_table_grad_plain(ids: torch.Tensor, ct6: torch.Tensor, F: int
                         ) -> torch.Tensor:
    """Plain version of K3: gather the active pixels, sort them by face and
    sum each face's run (float64 prefix sums, differenced at run ends)."""
    B, C, H, W = ct6.shape
    rows = ct6.permute(0, 2, 3, 1).reshape(-1, C)        # (B*H*W, 6)
    b = torch.arange(B, device=ct6.device).repeat_interleave(H * W)
    idv = ids.reshape(-1).long()
    active = (idv > 0) & (rows != 0).any(dim=1)
    key = (b * (F + 1) + idv - 1)[active]
    vals = rows[active].double()
    out = torch.zeros((B * (F + 1), C), dtype=torch.float64,
                      device=ct6.device)
    if key.numel():
        key, order = torch.sort(key, stable=True)
        csum = torch.cumsum(vals[order], dim=0)
        last = torch.ones_like(key, dtype=torch.bool)
        last[:-1] = key[1:] != key[:-1]
        tot = csum[last]
        out[key[last]] = torch.cat([tot[:1], tot[1:] - tot[:-1]])
    return out.to(ct6.dtype).view(B, F + 1, C)


# ---------------------------------------------------------------------------
# K4 / K5 — silhouette antialias forward and backward (all pixel pairs)
# ---------------------------------------------------------------------------

def _pair_eval(ida, idb, za, zb, ga, gb, auxa, auxb, pax, pay, pbx, pby):
    """The pair math of ``_aa_pairs`` (rasterize.py:880) on one axis of
    pixel pairs a -> b; colour = coverage. Channel-major g (B,6,...),
    aux (B,4,...). Returns the quantities K4 and K5 need."""
    differ = (ida != idb) & ((ida > 0) | (idb > 0))
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


def _pairs(ids, z, g6, gaux, axis: int):
    """Pair operands along ``axis`` (2: horizontal a=(r,c), b=(r,c+1);
    1: vertical a=(r,c), b=(r+1,c)) with their pixel centres."""
    B, H, W = ids.shape
    px, py = pixel_centers((H, W), ids.device)
    px, py = px.expand(H, W), py.expand(H, W)

    def a(x, d):                       # d: index of the H/W dim in x
        return x.narrow(d + (axis - 1), 0, x.shape[d + axis - 1] - 1)

    def b(x, d):
        return x.narrow(d + (axis - 1), 1, x.shape[d + axis - 1] - 1)

    return (a(ids, 1), b(ids, 1), a(z, 1), b(z, 1), a(g6, 2), b(g6, 2),
            a(gaux, 2), b(gaux, 2), a(px, 0), a(py, 0), b(px, 0), b(py, 0))


def _pad(x, axis: int, before: bool):
    """Pad one zero row/column on the H (axis 1) or W (axis 2) axis of the
    last two dims of x."""
    pad = [0, 0, 0, 0]
    pad[(2 - axis) * 2 + (0 if before else 1)] = 1
    return torch.nn.functional.pad(x, pad)


def aa_forward(ids, z, g6, gaux) -> torch.Tensor:
    """Antialiased silhouette coverage (B,H,W) f32 from the winner ids
    (B,H,W) int32, z (B,H,W), g6 (B,6,H,W) and gaux (B,4,H,W)."""
    if not _on_cuda(g6, "aa_forward"):
        return aa_forward_plain(ids, z, g6, gaux)
    B, H, W = ids.shape
    _check_aa(ids, z, g6, gaux)
    out = torch.empty((B, H, W), dtype=torch.float32, device=g6.device)
    _launch("tss_aa_fwd_launch", _ptr(ids), _ptr(z), _ptr(g6), _ptr(gaux),
            B, H, W, _ptr(out))
    aa_forward.launches += 1
    return out


def aa_forward_plain(ids, z, g6, gaux) -> torch.Tensor:
    """Plain version of K4: the dense antialias chain of rasterize.py:975
    on the silhouette (horizontal pairs, then vertical)."""
    out = (ids > 0).to(torch.float32)
    for axis in (2, 1):
        ops = _pairs(ids, z, g6, gaux, axis)
        P = _pair_eval(*ops)
        out = out + _pad(P["delta_a"], axis, before=False)
        out = out + _pad(P["delta_b"], axis, before=True)
    return out


def aa_backward(ids, z, g6, gaux, ct) -> torch.Tensor:
    """d g6 (B,6,H,W) of ``aa_forward`` under the cotangent ct (B,H,W)."""
    if not _on_cuda(g6, "aa_backward"):
        return aa_backward_plain(ids, z, g6, gaux, ct)
    B, H, W = ids.shape
    _check_aa(ids, z, g6, gaux)
    _check(ct, "ct", torch.float32, (B, H, W), g6.device)
    dg6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=g6.device)
    _launch("tss_aa_bwd_launch", _ptr(ids), _ptr(z), _ptr(g6), _ptr(gaux),
            _ptr(ct), B, H, W, _ptr(dg6))
    aa_backward.launches += 1
    return dg6


def aa_backward_plain(ids, z, g6, gaux, ct) -> torch.Tensor:
    """Plain version of K5: the hand-derived pair backward, vectorized; each
    pair's owner gradient lands on its owner pixel."""
    dg = torch.zeros_like(g6)
    for axis in (2, 1):
        ops = _pairs(ids, z, g6, gaux, axis)
        P = _pair_eval(*ops)
        pax, pay, pbx, pby = ops[8:]
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


KERNELS = (visibility, wsr_table_grad, aa_forward, aa_backward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
