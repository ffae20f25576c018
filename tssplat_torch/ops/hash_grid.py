"""The multi-resolution hash-grid encoding (InstantNGP, tiny-cuda-nn
semantics) and its hand-written kernel pair, each direction beside its
plain PyTorch version.

  K9  ``hash_grid``, ``hash_grid_backward``   csrc/hash_grid.cu   <- none

K9 replaces no Pallas kernel: the JAX package evaluates the grid as XLA
code (``_grid_exact``, tssplat_tpu/models/networks.py:132) and keeps static
hash-table buckets there to avoid TPU scatters. On the card the plain
chain (``grid_exact``) would build (N,L,8) int64 rows and weights, gather
(N,L,8,F) rows, and leave autograd to fill and add eight select gradients
and to sort and segment-sum N·L·8 row keys; K9 reads each point once,
writes its feature row once, and adds the table gradient with atomics.

``grid_lookup(table, x, grid)`` is the encoding's one entry. A CPU tensor
takes ``grid_exact`` with autograd's gradients. A CUDA tensor goes through
``_HashGrid``: its forward is K9, its backward K9's backward (the table
gradient where the table needs one, d x where x does); it saves x and the
table only. The wrappers take the plain versions for CPU tensors, launch
their kernel for CUDA tensors (or raise: there is no fallback), check
device, dtype, shape and contiguity, and count their launches in
``.launches`` (``ops/raster_kernels.py launch_counts``). The plain versions
repeat the kernels' arithmetic in the same order, so on the card the two
agree to the bit but for the order of the table gradient's atomics.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.launch import check, launch, on_cuda, ptr
from ..utils.debug import check_kernel_outputs
from ..utils.profiling import span

HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# corner i is the bit pattern (i>>2, i>>1, i) & 1 (JAX's _CORNERS, the
# meshgrid over three {0,1} axes in "ij" order)
CORNERS = [((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8)]

# (per-level resolutions, per-level dense flags, table rows per level)
Grid = Tuple[Sequence[int], Sequence[bool], int]

MAX_LEVELS = 32
WIDTHS = (1, 2, 4, 8)


def hash_coords(c: torch.Tensor, hashmap_size: int) -> torch.Tensor:
    """Spatial hash of non-negative int64 grid coordinates (…,3) into
    [0, hashmap_size): JAX's uint32 arithmetic with wraparound, done in
    int64 and masked to 32 bits after each product and the xors."""
    h = (c[..., 0] * HASH_PRIMES[0]) & _U32
    h = h ^ ((c[..., 1] * HASH_PRIMES[1]) & _U32)
    h = h ^ ((c[..., 2] * HASH_PRIMES[2]) & _U32)
    return h % hashmap_size


def grid_levels(n_levels, base_resolution, per_level_scale,
                log2_hashmap_size) -> Grid:
    """Per-level resolutions, dense flags and the table size per level:
    a level whose (r+1)^3 grid fits the table is indexed densely."""
    H = 1 << log2_hashmap_size
    res = [int(math.floor(base_resolution * per_level_scale ** l))
           for l in range(n_levels)]
    dense = [(r + 1) ** 3 <= H for r in res]
    return res, dense, H


def _level_setup(x: torch.Tensor, r: int):
    """(lower corner (…,3) int64, fraction (…,3)) of x in [0,1]^3 on a
    grid of resolution r."""
    xl = x * float(r)
    i0 = torch.clamp(torch.floor(xl).to(torch.int64), 0, r - 1)
    return i0, xl - i0.to(x.dtype)


def _factors(w: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """The trilinear factors (…,8,3) of fractions w (…,3): w on an axis
    where the corner is upper, 1 - w where it is lower."""
    return torch.where(upper, w[..., None, :], 1.0 - w[..., None, :])


def grid_corners(x: torch.Tensor, res, dense, H):
    """Table rows (…,L,8) int64 and trilinear weights (…,L,8) of every
    (level, corner), corners in CORNERS order; each level's eight corners
    in one pass of elementwise ops."""
    with span("tssplat.sync.encoding"):      # a host-to-device copy
        corners = torch.as_tensor(CORNERS, dtype=torch.int64,
                                  device=x.device)
    upper = corners.bool()                                  # (8,3)
    idx, wgt = [], []
    for l, r in enumerate(res):
        i0, w = _level_setup(x, r)
        c = i0[..., None, :] + corners                      # (…,8,3)
        if dense[l]:
            rows = (c[..., 0] * (r + 1) + c[..., 1]) * (r + 1) + c[..., 2]
        else:
            rows = hash_coords(c, H)
        idx.append(rows + l * H)
        f = _factors(w, upper)
        wgt.append(f[..., 0] * f[..., 1] * f[..., 2])
    return torch.stack(idx, dim=-2), torch.stack(wgt, dim=-2)


def grid_exact(table: torch.Tensor, x: torch.Tensor, res, dense, H):
    """Exact multi-level trilinear lookup (…,3) -> (…, L*F): each level's
    corners summed in CORNERS order from the first, as the JAX package
    sums them."""
    idx, wgt = grid_corners(x, res, dense, H)              # (…,L,8)
    prod = table[idx] * wgt[..., None]                     # (…,L,8,F)
    feats = prod[..., 0, :]
    for ci in range(1, 8):
        feats = feats + prod[..., ci, :]
    return feats.reshape(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# K9 — the lookup and its gradient
# ---------------------------------------------------------------------------

def _check_grid(table: torch.Tensor, x: torch.Tensor, grid: Grid):
    """(N, L, F, log2 H, the C entry's level array: resolutions, then dense
    flags) of a K9 call; raises on what the kernels do not take."""
    res, dense, H = grid
    L = len(res)
    if not 1 <= L <= MAX_LEVELS or len(dense) != L:
        raise ValueError(f"hash_grid: 1 to {MAX_LEVELS} levels, got {L}")
    if H < 1 or H & (H - 1) or L * H > 2 ** 31:
        raise ValueError(f"hash_grid: {L} levels of {H} rows: the rows per "
                         f"level must be a power of two, 2^31 rows at most")
    for r, d in zip(res, dense):
        if r < 1 or r >= 2 ** 24 or (d and (r + 1) ** 3 > H):
            raise ValueError(f"hash_grid: resolution {r} (dense {d}) does "
                             f"not fit {H} rows")
    if table.dim() != 2 or table.shape[0] != L * H \
            or table.shape[1] not in WIDTHS:
        raise ValueError(f"hash_grid: table must be ({L * H}, F), F in "
                         f"{WIDTHS}, got {tuple(table.shape)}")
    check(table, "table", torch.float32)
    if x.dim() != 2 or x.shape[1] != 3 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"hash_grid: x must be (N, 3), got "
                         f"{tuple(x.shape)}")
    check(x, "x", torch.float32, device=table.device)
    lv = (ctypes.c_int * (2 * L))(*res, *(int(bool(d)) for d in dense))
    return int(x.shape[0]), L, int(table.shape[1]), H.bit_length() - 1, lv


def hash_grid(table: torch.Tensor, x: torch.Tensor, grid: Grid
              ) -> torch.Tensor:
    """K9: the features (N, L·F) of the points x (N,3) in the table
    (L·H, F) of ``grid`` (``grid_levels``'s (resolutions, dense flags,
    H)); no gradient (``_HashGrid`` carries it)."""
    if not on_cuda(table, "hash_grid"):
        return hash_grid_plain(table, x, grid)
    N, L, F, log2H, lv = _check_grid(table, x, grid)
    out = torch.empty((N, L * F), dtype=torch.float32, device=table.device)
    launch("tss_hash_grid_launch", ptr(x), ptr(table), N, L, F, log2H,
           ctypes.addressof(lv), ptr(out))
    hash_grid.launches += 1
    check_kernel_outputs("hash_grid", out)
    return out


def hash_grid_plain(table: torch.Tensor, x: torch.Tensor, grid: Grid
                    ) -> torch.Tensor:
    """Plain version of K9: ``grid_exact``, whose order the kernel keeps."""
    return grid_exact(table, x, *grid)


def hash_grid_backward(table: torch.Tensor, x: torch.Tensor,
                       ct: torch.Tensor, grid: Grid, need_table: bool = True,
                       need_x: bool = False
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """K9's backward under the cotangent ct (N, L·F) of the features:
    (d table (L·H, F) where ``need_table``, d x (N,3) where ``need_x``;
    None for the other). The C entry zeroes d table, whose rows the
    kernel adds with float atomics in no fixed order."""
    if not on_cuda(ct, "hash_grid_backward"):
        return hash_grid_backward_plain(table, x, ct, grid, need_table,
                                        need_x)
    N, L, F, log2H, lv = _check_grid(table, x, grid)
    dev = table.device
    check(ct, "ct", torch.float32, (N, L * F), dev)
    d_table = torch.empty_like(table) if need_table else None
    d_x = torch.empty((N, 3), dtype=torch.float32, device=dev) \
        if need_x else None
    launch("tss_hash_grid_grad_launch", ptr(x), ptr(table), ptr(ct), N, L,
           F, log2H, ctypes.addressof(lv),
           ptr(d_table) if need_table else None,
           ptr(d_x) if need_x else None)
    hash_grid_backward.launches += 1
    check_kernel_outputs("hash_grid_backward",
                         *(t for t in (d_table, d_x) if t is not None))
    return d_table, d_x


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim in index order, as K9 adds channels."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _level_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum over the levels (dim -2) of v (N,L,3) as K9's lanes take it:
    padded with zeros to a power of two, then pairwise in level order."""
    n = 1 << (v.shape[-2] - 1).bit_length()
    v = torch.cat([v, v.new_zeros((*v.shape[:-2], n - v.shape[-2],
                                   v.shape[-1]))], dim=-2)
    while v.shape[-2] > 1:
        v = v[..., 0::2, :] + v[..., 1::2, :]
    return v[..., 0, :]


def hash_grid_backward_plain(table: torch.Tensor, x: torch.Tensor,
                             ct: torch.Tensor, grid: Grid,
                             need_table: bool = True, need_x: bool = False
                             ) -> Tuple[Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """Plain version of K9's backward: d table, each corner's w·ct added
    into its row (``index_add_``); d x, per level and axis the corners'
    dot products of row and cotangent times the other two factors, those
    of the upper corners less those of the lower ones (each side summed in
    corner order), times r, then the levels summed as K9 sums them."""
    res, dense, H = grid
    table, x = table.detach(), x.detach()
    N, L, F = x.shape[0], len(res), table.shape[1]
    g = ct.reshape(N, L, 1, F)
    idx, wgt = grid_corners(x, res, dense, H)              # (N,L,8)
    d_table = d_x = None
    if need_table:
        d_table = torch.zeros_like(table).index_add_(
            0, idx.reshape(-1), (wgt[..., None] * g).reshape(-1, F))
    if need_x:
        dot = _channel_sum(table[idx] * g)                 # (N,L,8)
        upper = torch.as_tensor(CORNERS, device=x.device).bool()
        per_level = []
        for l, r in enumerate(res):
            f = _factors(_level_setup(x, r)[1], upper)     # (N,8,3)
            d = dot[:, l]
            parts = torch.stack([(d * f[..., 2]) * f[..., 1],
                                 (d * f[..., 2]) * f[..., 0],
                                 d * (f[..., 0] * f[..., 1])], dim=-1)
            pos = torch.zeros((N, 3), dtype=x.dtype, device=x.device)
            neg = torch.zeros_like(pos)
            for k in range(8):
                up = upper[k]
                pos = pos + torch.where(up, parts[:, k], 0.0)
                neg = neg + torch.where(up, 0.0, parts[:, k])
            per_level.append((pos - neg) * float(r))
        d_x = _level_sum(torch.stack(per_level, dim=1))
    return d_table, d_x


class _HashGrid(torch.autograd.Function):
    """K9 with K9's backward; saves the table and x only."""

    @staticmethod
    def forward(ctx, table, x, grid):
        ctx.save_for_backward(table, x)
        ctx.grid = grid
        return hash_grid(table, x, grid)

    @staticmethod
    def backward(ctx, d_out):
        table, x = ctx.saved_tensors
        d_table, d_x = hash_grid_backward(
            table, x, d_out.contiguous(), ctx.grid,
            need_table=ctx.needs_input_grad[0],
            need_x=ctx.needs_input_grad[1])
        return d_table, d_x, None


def grid_lookup(table: torch.Tensor, x: torch.Tensor, grid: Grid
                ) -> torch.Tensor:
    """The features (…, L·F) of points x (…,3) in [0,1]^3, differentiable
    in the table and in x: ``grid_exact`` for CPU tensors, K9 for CUDA
    tensors."""
    if not on_cuda(x, "hash_grid"):
        return grid_exact(table, x, *grid)
    out = _HashGrid.apply(table, x.reshape(-1, 3).contiguous(), grid)
    return out.reshape(*x.shape[:-1], out.shape[-1])


hash_grid.launches = 0
hash_grid_backward.launches = 0
