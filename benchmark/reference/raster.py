"""Rasterization from its definition, in plain PyTorch.

Pixel (row r, col c) has NDC centre ((c+.5)/W*2-1, (r+.5)/H*2-1); a
vertex with w <= 1e-9 is invalid. A face covers a pixel where its three
barycentric edge values are >= 0 and its interpolated z/w lies in [-1, 1];
a pixel's winner is the covering face of least z, the smaller id on a tie.
The z-buffer tests each face at the pixels of its screen box only and takes
the least packed (z, id) key per pixel.

The antialias is nvdiffrast's: for every horizontally or vertically
adjacent pixel pair whose winners differ, the owner (the foreground face,
the nearer of two) blends the pixel on the far side of its silhouette edge
toward its neighbour by how far the edge crosses the segment between the
centres, unless that edge is shared with the other pixel's face.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

W_EPS = 1e-9
AREA_EPS = 1e-14
INF = float("inf")
_KEY_NONE = torch.iinfo(torch.int64).max


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, forward and
    backward, accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = (g @ tf32(b).transpose(-1, -2)).sum_to_size(a.shape)
        gb = (tf32(a).transpose(-1, -2) @ g).sum_to_size(b.shape)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"):
    """a @ b in float32, or with its operands rounded to TF32."""
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def clip_positions(points: torch.Tensor, mvp: torch.Tensor,
                   precision: str = "f32") -> torch.Tensor:
    """World points (V,3) -> clip space (B,V,4) of the cameras mvp (B,4,4):
    row vectors times mvp^T."""
    ph = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    if precision == "tf32":
        return _TF32MatMul.apply(ph, mvp.transpose(1, 2))
    # the contraction as the program writes it, so that the card picks the
    # same product and a pixel on a face's edge rounds alike on both sides
    return torch.einsum("vj,bij->bvi", ph, mvp)


def ndc(idx: torch.Tensor, n: int) -> torch.Tensor:
    """NDC centre of float pixel indices on an axis of n pixels."""
    return (idx + 0.5) / torch.full_like(idx, float(n)) * 2.0 - 1.0


def screen(pos: torch.Tensor):
    """Clip (...,4) -> (x/w, y/w, z/w, valid)."""
    w = pos[..., 3]
    valid = w > W_EPS
    iw = torch.where(valid, 1.0 / torch.clamp_min(w, W_EPS),
                     torch.zeros_like(w))
    return pos[..., 0] * iw, pos[..., 1] * iw, pos[..., 2] * iw, valid


def _pack(z: torch.Tensor, id1: torch.Tensor) -> torch.Tensor:
    """(z, id+1) as an int64 whose order is z's, then the id's."""
    bits = z.contiguous().view(torch.int32)
    bits = torch.where(bits == -2 ** 31, torch.zeros_like(bits), bits).long()
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return mono * 2 ** 32 + id1.long()


def _unpack(key: torch.Tensor):
    fg = key != _KEY_NONE
    key = torch.where(fg, key, torch.zeros_like(key))
    mono = key >> 32
    bits = torch.where(mono >= 0, mono, mono ^ 0x7FFFFFFF).to(torch.int32)
    return (key & 0xFFFFFFFF).to(torch.int32), bits.view(torch.float32)


@torch.no_grad()
def visibility(pos_clip: torch.Tensor, res: int):
    """Winners of every pixel: (ids+1 (B,H,W) int32, z (B,H,W) f32), 0 on
    background. pos_clip (B,3F,4) in the corner layout (face f = rows
    3f..3f+2)."""
    B, F = pos_clip.shape[0], pos_clip.shape[1] // 3
    dev = pos_clip.device
    sx, sy, sz, ok_v = screen(pos_clip)
    vx, vy, vz = sx.view(B, F, 3), sy.view(B, F, 3), sz.view(B, F, 3)
    ax, bx, cx = vx.unbind(-1)
    ay, by, cy = vy.unbind(-1)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = ok_v.view(B, F, 3).all(-1) & (torch.abs(area) > AREA_EPS)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(
        area)), torch.zeros_like(area))

    def box(v):
        pix = (v + 1.0) * 0.5 * res - 0.5
        lo = torch.ceil(pix.amin(-1)) - 1.0
        hi = torch.floor(pix.amax(-1)) + 1.0
        bad = ~torch.isfinite(lo) | ~torch.isfinite(hi) | (hi < 0) \
            | (lo > res - 1)
        lo = torch.nan_to_num(lo).clamp(0, res - 1).long()
        hi = torch.nan_to_num(hi).clamp(0, res - 1).long()
        return lo, hi, bad

    x0, x1, bx_bad = box(vx)
    y0, y1, by_bad = box(vy)
    live = ok & ~bx_bad & ~by_bad
    view, face = live.nonzero(as_tuple=True)
    x0, x1, y0, y1 = (t[view, face] for t in (x0, x1, y0, y1))
    bw = x1 - x0 + 1
    npx = bw * (y1 - y0 + 1)
    cells = torch.cumsum(npx, 0)
    best = torch.full((B * res * res,), _KEY_NONE, dtype=torch.int64,
                      device=dev)
    total = int(cells[-1]) if cells.numel() else 0
    block = 1 << 25             # pixel tests at a time
    edges = torch.arange(0, total + block, block, device=dev)
    cut = torch.searchsorted(cells, edges, right=True).tolist()
    for s, e in zip(cut[:-1], cut[1:]):
        if e <= s:
            continue
        n = npx[s:e]
        src = torch.repeat_interleave(torch.arange(s, e, device=dev), n)
        local = torch.arange(src.numel(), device=dev) \
            - (torch.cumsum(n, 0) - n)[src - s]
        col = x0[src] + local % bw[src]
        row = y0[src] + local // bw[src]
        px, py = ndc(col.float(), res), ndc(row.float(), res)
        v, f = view[src], face[src]
        Ax, Ay, Bx, By = ax[v, f], ay[v, f], bx[v, f], by[v, f]
        Cx, Cy, ia = cx[v, f], cy[v, f], inv_area[v, f]
        e0 = ((Cx - Bx) * (py - By) - (Cy - By) * (px - Bx)) * ia
        e1 = ((Ax - Cx) * (py - Cy) - (Ay - Cy) * (px - Cx)) * ia
        e2 = ((Bx - Ax) * (py - Ay) - (By - Ay) * (px - Ax)) * ia
        z = e0 * vz[v, f, 0] + e1 * vz[v, f, 1] + e2 * vz[v, f, 2]
        cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z >= -1.0) & (z <= 1.0)
        pixel = (v[cov] * res + row[cov]) * res + col[cov]
        best.scatter_reduce_(0, pixel, _pack(z[cov], f[cov] + 1), "amin")
    ids, z = _unpack(best.view(B, res, res))
    return ids, torch.where(ids > 0, z, torch.zeros_like(z))


def gather_rows(tbl: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows (B,H,W,C) of the per-face table (B,F,C) at the winners,
    differentiable in the table; 0 on background."""
    B, F, C = tbl.shape
    fg = ids > 0
    t = torch.arange(B, device=ids.device).view(B, 1, 1) * F \
        + torch.clamp_min(ids.long() - 1, 0)
    return tbl.reshape(B * F, C)[t] * fg[..., None].to(tbl.dtype)


def screen_rows(pos_clip: torch.Tensor, F: int) -> torch.Tensor:
    """Per-face screen rows (B,F,6) = (ax, bx, cx, ay, by, cy)."""
    B = pos_clip.shape[0]
    sx, sy, _, _ = screen(pos_clip)
    return torch.cat([sx.view(B, F, 3), sy.view(B, F, 3)], dim=-1)


def winner_rows(pos_clip: torch.Tensor, nbrs: torch.Tensor,
                ids: torch.Tensor):
    """The antialias's per-pixel rows of each winner: g (B,6,H,W) screen
    xy of its corners, differentiable in pos_clip, and aux (B,4,H,W) its
    edge neighbours and the sign of its screen area, without gradient."""
    F = nbrs.shape[0]
    tbl6 = screen_rows(pos_clip, F)
    g = gather_rows(tbl6, ids).permute(0, 3, 1, 2)
    with torch.no_grad():
        t = tbl6.detach()
        area = (t[..., 1] - t[..., 0]) * (t[..., 5] - t[..., 3]) \
            - (t[..., 4] - t[..., 3]) * (t[..., 2] - t[..., 0])
        nb = nbrs.to(t.dtype).unsqueeze(0).expand(t.shape[0], F, 3)
        aux = gather_rows(torch.cat([nb, torch.sign(area)[..., None]], -1),
                          ids).permute(0, 3, 1, 2)
    return g, aux


def shade(pos_clip: torch.Tensor, ids: torch.Tensor, res: int):
    """(u, v, z/w, id+1) (B,H,W,4) of each pixel's winner: screen-space
    barycentrics corrected by 1/w, differentiable in pos_clip."""
    B, F = pos_clip.shape[0], pos_clip.shape[1] // 3
    sx, sy, sz, valid = screen(pos_clip)
    iw = torch.where(valid, 1.0 / torch.clamp_min(pos_clip[..., 3], W_EPS),
                     torch.zeros_like(sx))
    g = gather_rows(torch.cat([a.view(B, F, 3) for a in (sx, sy, sz, iw)],
                              dim=-1), ids)
    idx = torch.arange(res, dtype=pos_clip.dtype, device=pos_clip.device)
    px, py = ndc(idx, res)[None, :], ndc(idx, res)[:, None]

    def edge(ax, ay, bx, by, qx, qy):
        return (bx - ax) * (qy - ay) - (by - ay) * (qx - ax)

    ax, bx, cx, ay, by, cy = (g[..., i] for i in range(6))
    area = edge(ax, ay, bx, by, cx, cy)
    area = torch.where(torch.abs(area) > AREA_EPS, area,
                       torch.ones_like(area))
    l0 = edge(bx, by, cx, cy, px, py) / area
    l1 = edge(cx, cy, ax, ay, px, py) / area
    l2 = edge(ax, ay, bx, by, px, py) / area
    d0, d1, d2 = l0 * g[..., 9], l1 * g[..., 10], l2 * g[..., 11]
    s = d0 + d1 + d2
    s = torch.where(torch.abs(s) > W_EPS, s, torch.ones_like(s))
    zbuf = l0 * g[..., 6] + l1 * g[..., 7] + l2 * g[..., 8]
    fg = (ids > 0).to(pos_clip.dtype)
    return torch.stack([d0 / s * fg, d1 / s * fg, zbuf * fg,
                        ids.to(pos_clip.dtype)], dim=-1)


def interpolate(attr: torch.Tensor, rast: torch.Tensor) -> torch.Tensor:
    """u*a0 + v*a1 + (1-u-v)*a2 (B,H,W,C) of per-corner attributes (3F,C)
    or (B,3F,C); 0 on background."""
    ids = rast[..., 3].detach().to(torch.int32)
    B = ids.shape[0]
    F, C = attr.shape[-2] // 3, attr.shape[-1]
    a = gather_rows(attr.reshape(-1, F, 3 * C).expand(B, F, 3 * C),
                    ids).view(*ids.shape, 3, C)
    u, v = rast[..., 0:1], rast[..., 1:2]
    out = a[..., 0, :] * u + a[..., 1, :] * v + a[..., 2, :] * (1.0 - u - v)
    return out * (ids > 0)[..., None].to(out.dtype)


def vertex_normals(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals; +z where the sum vanishes."""
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    fn = torch.linalg.cross(v[i1] - v[i0], v[i2] - v[i0])
    z = torch.zeros_like(v)
    n = z.index_add(0, i0, fn) + z.index_add(0, i1, fn) \
        + z.index_add(0, i2, fn)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    n = torch.where(torch.sum(n * n, -1, keepdim=True) > 1e-20, n, up)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _pair_weights(id_a, id_b, z_a, z_b, g_a, g_b, aux_a, aux_b,
                  pax, pay, pbx, pby, with_masks: bool = False):
    """Blend weights (w_a, w_b) of one axis of pixel pairs; with
    ``with_masks`` also whether each pair blends (``valid``) and whether
    pixel a owns it."""
    differ = (id_a != id_b) & ((id_a > 0) | (id_b > 0))
    owner_a = torch.where(id_a == 0, False,
                          torch.where(id_b == 0, True, z_a <= z_b))
    other = torch.where(owner_a, id_b, id_a) - 1

    def oc(j):
        return torch.where(owner_a, g_a[:, j], g_b[:, j])

    def oa(j):
        return torch.where(owner_a, aux_a[:, j], aux_b[:, j])

    sgn = oa(3)

    def crossing(x0, y0, x1, y1):
        sa = ((x1 - x0) * (pay - y0) - (y1 - y0) * (pax - x0)) * sgn
        sb = ((x1 - x0) * (pby - y0) - (y1 - y0) * (pbx - x0)) * sgn
        d = sa - sb
        t = sa / torch.where(torch.abs(d) > 1e-20, d, torch.ones_like(d))
        return (torch.where((sa >= 0) & (sb < 0), t, INF),
                torch.where((sa < 0) & (sb >= 0), t, -INF))

    te, tn = zip(*(crossing(oc(e), oc(3 + e), oc((e + 1) % 3),
                            oc(3 + (e + 1) % 3)) for e in range(3)))

    def pick3(v, better):
        b1 = better(v[1], v[0])
        k, b = torch.where(b1, 1, 0), torch.where(b1, v[1], v[0])
        b2 = better(v[2], b)
        return torch.where(b2, v[2], b), torch.where(b2, 2, k)

    t_e, k_e = pick3(te, lambda x, y: x < y)
    t_n, k_n = pick3(tn, lambda x, y: x > y)
    k = torch.where(owner_a, k_e, k_n)
    t = torch.where(owner_a, t_e, t_n)
    nbr = torch.where(k == 0, oa(0), torch.where(k == 1, oa(1), oa(2)))
    shared = (nbr == other.to(nbr.dtype)) & (other >= 0) & \
        torch.where(owner_a, id_b > 0, id_a > 0)
    valid = differ & torch.isfinite(t) & ~shared
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    # maximum / minimum split the gradient evenly at a tie
    t = torch.minimum(torch.maximum(torch.where(valid, t, 0.5), zero),
                      zero + 1.0)
    vf = valid.to(t.dtype)
    w_a = torch.maximum(0.5 - t, zero) * vf
    w_b = torch.maximum(t - 0.5, zero) * vf
    return (w_a, w_b, valid, owner_a) if with_masks else (w_a, w_b)


def antialias(color: torch.Tensor, ids: torch.Tensor, z: torch.Tensor,
              g: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """The antialiased colour (B,H,W,C): horizontal pairs, then vertical;
    differentiable in the colour and in the winner rows g."""
    B, H, W, _ = color.shape
    idx = torch.arange(W, dtype=color.dtype, device=color.device)
    px = ndc(idx, W)[None, None, :].expand(B, H, W)
    py = ndc(torch.arange(H, dtype=color.dtype, device=color.device),
             H)[None, :, None].expand(B, H, W)
    out = color
    w_a, w_b = _pair_weights(
        ids[:, :, :-1], ids[:, :, 1:], z[:, :, :-1], z[:, :, 1:],
        g[..., :-1], g[..., 1:], aux[..., :-1], aux[..., 1:],
        px[:, :, :-1], py[:, :, :-1], px[:, :, 1:], py[:, :, 1:])
    ca, cb = color[:, :, :-1], color[:, :, 1:]
    out = out + tnf.pad((cb - ca) * w_a[..., None], (0, 0, 0, 1))
    out = out + tnf.pad((ca - cb) * w_b[..., None], (0, 0, 1, 0))
    w_a, w_b = _pair_weights(
        ids[:, :-1], ids[:, 1:], z[:, :-1], z[:, 1:],
        g[:, :, :-1], g[:, :, 1:], aux[:, :, :-1], aux[:, :, 1:],
        px[:, :-1], py[:, :-1], px[:, 1:], py[:, 1:])
    ca, cb = color[:, :-1], color[:, 1:]
    out = out + tnf.pad((cb - ca) * w_a[..., None], (0, 0, 0, 0, 0, 1))
    out = out + tnf.pad((ca - cb) * w_b[..., None], (0, 0, 0, 0, 1, 0))
    return out


@torch.no_grad()
def pair_counts(ids, z, g, aux) -> dict:
    """What the silhouette antialias forward and backward must read beyond
    the ids, over both axes' pairs: the pairs whose ids differ and the
    valid ones; the pixels whose z decides an owner (both sides of a
    differing pair foreground); the pixels that own a differing pair,
    whose rows decide it; the pixels of a valid pair, whose cotangent the
    backward reads."""
    B, H, W = ids.shape
    dev = ids.device
    px = ndc(torch.arange(W, dtype=torch.float32, device=dev),
             W)[None, None, :].expand(B, H, W)
    py = ndc(torch.arange(H, dtype=torch.float32, device=dev),
             H)[None, :, None].expand(B, H, W)
    n_differ = n_valid = 0
    need_z, owner, in_valid = (torch.zeros_like(ids, dtype=torch.bool)
                               for _ in range(3))
    for axis in (2, 1):
        def a(x, d=1):
            return x.narrow(d + axis - 1, 0, x.shape[d + axis - 1] - 1)

        def b(x, d=1):
            return x.narrow(d + axis - 1, 1, x.shape[d + axis - 1] - 1)

        ida, idb = a(ids), b(ids)
        _, _, valid, own_a = _pair_weights(
            ida, idb, a(z), b(z), a(g, 2), b(g, 2), a(aux, 2), b(aux, 2),
            a(px), a(py), b(px), b(py), with_masks=True)
        d = (ida != idb) & ((ida > 0) | (idb > 0))
        n_differ += int(d.sum())
        n_valid += int(valid.sum())
        both = d & (ida > 0) & (idb > 0)
        n = ids.shape[axis] - 1
        for mask, on_a, on_b in ((need_z, both, both),
                                 (owner, d & own_a, d & ~own_a),
                                 (in_valid, valid, valid)):
            mask.narrow(axis, 0, n).logical_or_(on_a)
            mask.narrow(axis, 1, n).logical_or_(on_b)
    return {"pairs_differ": n_differ, "pairs_valid": n_valid,
            "px_z": int(need_z.sum()), "px_owner": int(owner.sum()),
            "px_in_a_valid_pair": int(in_valid.sum())}
