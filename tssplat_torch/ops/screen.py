"""Screen-space conventions shared by binning, visibility and antialias
(``_pixel_centers``, ``_edge`` and ``_screen`` of
``tssplat_tpu/ops/rasterize.py:48-71``).

Pixel (row r, col c) has NDC centre ((c+.5)/W*2-1, (r+.5)/H*2-1): row 0
is NDC y = -1, with no y-flip. A slab of rows (spatial sharding) is given
as a viewport ``(row0, full_h)``: its local row r is absolute row row0 + r
of a full_h-tall image. A vertex with w <= 1e-9 is invalid and its
faces are discarded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

W_EPS = 1e-9
AREA_EPS = 1e-14


def ndc_center(idx: torch.Tensor, n: int) -> torch.Tensor:
    """NDC centre (idx + 0.5) / n * 2 - 1 of float pixel indices along an
    axis of n pixels. The divisor is a tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the kernels, the CPU and JAX when n is not a power of two."""
    return (idx + 0.5) / torch.full_like(idx, float(n)) * 2.0 - 1.0


def pixel_centers(resolution: Tuple[int, int], device,
                  dtype=torch.float32, row0: int = 0,
                  full_h: Optional[int] = None):
    """Pixel-centre NDC grids, broadcastable as (1,W) and (H,1). With
    ``(row0, full_h)`` the H rows are a horizontal slab: local row r is
    absolute row row0 + r of a full_h-tall image (``_pixel_centers``,
    rasterize.py:48); row0 may be negative (a halo above the image)."""
    H, W = resolution
    x = ndc_center(torch.arange(W, dtype=dtype, device=device), W)
    y = ndc_center(torch.arange(H, dtype=dtype, device=device) + float(row0),
                   H if full_h is None else full_h)
    return x[None, :], y[:, None]


def edge(ax, ay, bx, by, px, py):
    """2D cross product (b-a) x (p-a): positive when p is left of a->b."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def screen(pos: torch.Tensor):
    """Clip (...,4) -> (sx, sy, z/w, valid) NDC screen coordinates."""
    w = pos[..., 3]
    valid = w > W_EPS
    inv_w = torch.where(valid, 1.0 / torch.clamp_min(w, W_EPS),
                        torch.zeros_like(w))
    return pos[..., 0] * inv_w, pos[..., 1] * inv_w, pos[..., 2] * inv_w, valid
