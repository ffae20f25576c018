"""The exact texture loss's image-space tail and its hand-written kernel
pair, each direction beside its plain PyTorch version.

  K10 ``aa_l1``, ``aa_l1_backward``   csrc/aa_l1.cu   <- none

The tail (``materials/exact_stage.py``): the (n_fg, 3) colours of the
exact cache's foreground points put back on the image (zero elsewhere),
composited over the background by the mask, colour-antialiased, and the
L1 against the target summed over every pixel of every view. The geometry
is frozen there, so the cache makes everything but the colours once
(``tail_tables``): ``fg`` (n,H,W) int32, the colour row of each pixel
(-1 on background); ``aa`` (n,H,W) int32, the row of ``aa_w`` of each
pixel that the antialias blends toward a neighbour (-1 where it blends
toward none); ``aa_w`` (n_aa, 4), those weights toward the right, left,
lower and upper neighbour (``rasterize.color_aa_weights``: the JAX-matched
``_aa_pair_weights`` run once). Valid pairs lie only where a silhouette
edge crosses between two pixel centres, so ``aa_w`` holds a few rows in a
hundred.

K10 replaces no Pallas kernel: the JAX package runs the tail as XLA code.
On the card the plain chain (``aa_l1_plain``) makes a dozen full-image
passes forward and some twenty in autograd's backward; K10's forward makes
one pass over the pixels, writes the L1 sum and a sign byte a pixel, and
its backward gathers each point's gradient from its own sign and its pair
partners' (the blend's transpose).

``image_l1_loss(colors, cache)`` is the tail's one entry: the image loss
(the L1 sum over n_total·res²·3, x 20). A CPU tensor takes the plain
chain with autograd's gradients. A CUDA tensor goes through ``_AaL1``:
its forward is K10, its backward K10's backward. The wrappers take the
plain versions for CPU tensors, launch their kernel for CUDA tensors (or
raise: there is no fallback), check device, dtype, shape and contiguity,
and count their launches in ``.launches`` (``ops/raster_kernels.py
launch_counts``). The plain versions repeat the kernels' arithmetic in the
same order, so on the card the shaded values and d colours agree to the
bit (up to the sign of a zero) and the sum up to its order.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.nn.functional import pad as F_pad

from ..kernels.launch import check, launch, on_cuda, ptr
from ..utils.debug import check_kernel_outputs

# the neighbour of each of a pixel's four weights: (dc, dr), and the
# component of the neighbour's weights that points back at the pixel
NEIGHBOURS = ((1, 0, 1), (-1, 0, 0), (0, 1, 3), (0, -1, 2))


@torch.no_grad()
def tail_tables(w4: torch.Tensor, first_row: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``aa`` (B,H,W) int32 and ``aa_w`` (n_aa, 4) of the pixel weights
    w4 (B,H,W,4) (``rasterize.color_aa_weights``): the pixels with a
    weight that is not zero, in raster order, numbered from
    ``first_row``."""
    flat = w4.reshape(-1, 4)
    has = (flat != 0).any(-1)
    rows = flat[has].contiguous()
    aa = torch.full((flat.shape[0],), -1, dtype=torch.int32,
                    device=w4.device)
    aa[has] = torch.arange(first_row, first_row + rows.shape[0],
                           dtype=torch.int32, device=w4.device)
    return aa.view(w4.shape[:-1]), rows


def _dense_weights(cache: dict) -> torch.Tensor:
    """(n,H,W,4) weights of every pixel from the cache's rows."""
    w = cache["aa_w"]
    table = torch.cat([w.new_zeros((1, 4)), w])
    return table[cache["aa"].long() + 1]


def aa_l1_plain(colors: torch.Tensor, cache: dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10's forward, differentiable in the colours: (the
    L1 sum (), the shaded image (n,H,W,3)). The exact loss's chain as
    ``antialias_color`` runs it, on the cache's weights: the colours put on
    a zeroed image, composited, the four deltas added in JAX's order
    (horizontal a, b, vertical a, b), |shaded - gt| summed."""
    fg, gt, bg = cache["fg"], cache["gt"], cache["bg"]
    n, H, W = fg.shape
    full = colors.new_zeros((n * H * W, colors.shape[-1]))
    full = full.index_put((cache["pix"],), colors).view(n, H, W, -1)
    mask = (fg >= 0).to(colors.dtype)[..., None]
    gb = bg + (full - bg) * mask
    w = _dense_weights(cache)
    out = gb
    ca, cb = gb[:, :, :-1], gb[:, :, 1:]
    out = out + F_pad((cb - ca) * w[:, :, :-1, 0:1], (0, 0, 0, 1))
    out = out + F_pad((ca - cb) * w[:, :, 1:, 1:2], (0, 0, 1, 0))
    ca, cb = gb[:, :-1], gb[:, 1:]
    out = out + F_pad((cb - ca) * w[:, :-1, :, 2:3], (0, 0, 0, 0, 0, 1))
    out = out + F_pad((ca - cb) * w[:, 1:, :, 3:4], (0, 0, 0, 0, 1, 0))
    return torch.sum(torch.abs(out - gt)), out


def sign_codes(shaded: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """K10's sign byte of each pixel (n,H,W) uint8: 2 bits a channel, 1
    where shaded > gt, 2 where it is below, 0 where equal (or NaN)."""
    d = (shaded - gt).detach()
    s = (d > 0).to(torch.uint8) + 2 * (d < 0).to(torch.uint8)
    return s[..., 0] + 4 * s[..., 1] + 16 * s[..., 2]


def _signs(codes: torch.Tensor) -> torch.Tensor:
    """The signs (…, 3) float32 of sign bytes (…)."""
    s = torch.stack([(codes.long() >> (2 * ch)) & 3 for ch in range(3)], -1)
    one = torch.ones((), dtype=torch.float32, device=codes.device)
    return torch.where(s == 1, one, torch.where(s == 2, -one, 0 * one))


def _check_tail(colors: torch.Tensor, cache: dict):
    """(n, H, W, n_fg) of a K10 call; raises on what the kernels do not
    take."""
    fg = cache["fg"]
    n, H, W = fg.shape
    dev = colors.device
    n_fg = int(cache["pix"].shape[0])
    if n * H * W >= 2 ** 31:
        raise ValueError(f"aa_l1: {n * H * W} pixels, 2^31 at most")
    check(colors, "colors", torch.float32, (n_fg, 3), dev)
    check(fg, "fg", torch.int32, (n, H, W), dev)
    check(cache["aa"], "aa", torch.int32, (n, H, W), dev)
    check(cache["aa_w"], "aa_w", torch.float32,
          (cache["aa_w"].shape[0], 4), dev)
    check(cache["pix"], "pix", torch.int64, (n_fg,), dev)
    for k in ("bg", "gt"):
        check(cache[k], k, torch.float32, (n, H, W, 3), dev)
    return n, H, W, n_fg


def aa_l1(colors: torch.Tensor, cache: dict, want_shaded: bool = False):
    """K10: (the L1 sum (), the sign bytes (n,H,W) uint8, the shaded
    image (n,H,W,3) where ``want_shaded``, else None) of the colours
    (n_fg, 3); no gradient (``_AaL1`` carries it)."""
    if not on_cuda(colors, "aa_l1"):
        with torch.no_grad():
            s, shaded = aa_l1_plain(colors, cache)
        return s, sign_codes(shaded, cache["gt"]), \
            shaded if want_shaded else None
    n, H, W, _ = _check_tail(colors, cache)
    dev = colors.device
    P = n * H * W
    codes = torch.empty((n, H, W), dtype=torch.uint8, device=dev)
    shaded = torch.empty((n, H, W, 3), dtype=torch.float32, device=dev) \
        if want_shaded else None
    partial = torch.empty((max(1, -(-P // 1024)),), dtype=torch.float64,
                          device=dev)
    s = torch.empty((), dtype=torch.float32, device=dev)
    launch("tss_aa_l1_launch", ptr(colors), ptr(cache["fg"]),
           ptr(cache["aa"]), ptr(cache["aa_w"]), ptr(cache["bg"]),
           ptr(cache["gt"]), P, H, W, ptr(codes),
           ptr(shaded) if want_shaded else None, ptr(partial), ptr(s))
    aa_l1.launches += 1
    check_kernel_outputs("aa_l1", *(t for t in (s, shaded) if t is not None))
    return s, codes, shaded


def aa_l1_backward_plain(g: torch.Tensor, codes: torch.Tensor,
                         cache: dict) -> torch.Tensor:
    """Plain version of K10's backward: d colours (n_fg, 3) under the
    gradient g () of the L1 sum. Per point at pixel p, d = g·s(p), then
    for each neighbour q (right, left, lower, upper) d - (g·s(p))·w_p(toward
    q) + (g·s(q))·w_q(toward p), zero where q lies outside the image:
    the transpose of ``aa_l1_plain``'s blend, as K10 takes it."""
    fg = cache["fg"]
    n, H, W = fg.shape
    pix = cache["pix"]
    flat = codes.reshape(-1)
    aa = cache["aa"].reshape(-1).long() + 1
    table = torch.cat([cache["aa_w"].new_zeros((1, 4)), cache["aa_w"]])
    c, r = pix % W, (pix // W) % H
    dp = g * _signs(flat[pix])
    wp = table[aa[pix]]
    d = dp
    for k, (dc, dr, k_in) in enumerate(NEIGHBOURS):
        inside = ((c + dc >= 0) & (c + dc < W) & (r + dr >= 0)
                  & (r + dr < H))
        q = torch.where(inside, pix + dc + dr * W, pix)
        d = d - dp * wp[:, k:k + 1]
        w_in = torch.where(inside, table[aa[q], k_in], 0.0)
        d = d + (g * _signs(flat[q])) * w_in[:, None]
    return d


def aa_l1_backward(g: torch.Tensor, codes: torch.Tensor, cache: dict
                   ) -> torch.Tensor:
    """K10's backward: d colours (n_fg, 3) under the gradient g () of the
    L1 sum, from the forward's sign bytes ``codes``."""
    if not on_cuda(g, "aa_l1_backward"):
        return aa_l1_backward_plain(g, codes, cache)
    dev = g.device
    n, H, W = cache["fg"].shape
    n_fg = int(cache["pix"].shape[0])
    check(g, "g", torch.float32, (), dev)
    check(codes, "codes", torch.uint8, (n, H, W), dev)
    check(cache["aa"], "aa", torch.int32, (n, H, W), dev)
    check(cache["aa_w"], "aa_w", torch.float32,
          (cache["aa_w"].shape[0], 4), dev)
    check(cache["pix"], "pix", torch.int64, (n_fg,), dev)
    d = torch.empty((n_fg, 3), dtype=torch.float32, device=dev)
    launch("tss_aa_l1_grad_launch", ptr(cache["aa"]), ptr(cache["aa_w"]),
           ptr(cache["pix"]), ptr(codes), ptr(g), n_fg, H, W, ptr(d))
    aa_l1_backward.launches += 1
    check_kernel_outputs("aa_l1_backward", d)
    return d


class _AaL1(torch.autograd.Function):
    """K10 with K10's backward; keeps the sign bytes for the backward."""

    @staticmethod
    def forward(ctx, colors, cache):
        s, codes, _ = aa_l1(colors.contiguous(), cache)
        ctx.codes, ctx.cache = codes, cache
        return s

    @staticmethod
    def backward(ctx, g):
        d = aa_l1_backward(g.contiguous(), ctx.codes, ctx.cache)
        ctx.codes = None
        return d, None


def image_l1_loss(colors: torch.Tensor, cache: dict) -> torch.Tensor:
    """The exact texture loss's image term of the colours (n_fg, 3): the
    tail's L1 sum over the cache's n_total·res²·3 (the views of every
    shard), x 20. Differentiable in the colours: ``aa_l1_plain`` for CPU
    tensors, K10 for CUDA tensors."""
    denom = float(cache["n_total"] * cache["res"] ** 2 * 3)
    if on_cuda(colors, "aa_l1"):
        s = _AaL1.apply(colors, cache)
    else:
        s = aa_l1_plain(colors, cache)[0]
    # divide by a tensor: CUDA division by a Python scalar multiplies by
    # its reciprocal and rounds unlike the CPU and JAX
    return s / torch.full_like(s, denom) * 20.0


aa_l1.launches = 0
aa_l1_backward.launches = 0
