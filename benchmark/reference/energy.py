"""The geometry's regularisation energy, from its definition:

  E(x) = c1 * 1/2 * sum_t ||(L F)_t||^2 + c2 * sum_t max(-det F_t, 0)^order
  F_t = dx_t dX_t^-1,  (L F)_t = deg_t F_t - sum of t's face neighbours' F

with c1, c2 ramped x1 -> x16 over 1,200 iterations and the barrier's order
2 until ``increase_order_iter``, then 4 (the reference trainer's
energies/smooth_barrier.py). Autograd gives its gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .mesh import tet_neighbours


class Tets(NamedTuple):
    tets: torch.Tensor       # (T,4) int64
    dX_inv: torch.Tensor     # (T,3,3) f32, the rest edge matrices' inverses
    nbrs: torch.Tensor       # (T,4) int64, self where there is none
    mask: torch.Tensor       # (T,4) f32, 1 for a real neighbour
    degree: torch.Tensor     # (T,) f32


def tets_of(verts: np.ndarray, tets: np.ndarray, device) -> Tets:
    """The energy's operators of the rest mesh (verts f64, tets int64)."""
    v = verts[tets]
    dX = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]],
                  axis=2)
    nb, deg = tet_neighbours(tets)
    T = tets.shape[0]

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return Tets(t(tets, torch.int64), t(np.linalg.inv(dX), torch.float32),
                t(np.where(nb >= 0, nb, np.arange(T)[:, None]), torch.int64),
                t(nb >= 0, torch.float32), t(deg, torch.float32))


def coefficients(it: int, smooth: float, barrier: float):
    """(c1, c2) at iteration ``it``, computed in float32."""
    it32 = torch.tensor(float(it), dtype=torch.float32)
    phase = torch.clamp_max(it32 / 300.0 / 4.0 * 0.5 * math.pi,
                            0.5 * math.pi)
    mult = torch.pow(torch.tensor(2.0), torch.abs(torch.sin(phase)) * 4.0)
    return (float(torch.tensor(smooth, dtype=torch.float32) * mult),
            float(torch.tensor(barrier, dtype=torch.float32) * mult))


def energy(x: torch.Tensor, ops: Tets, c1: float, c2: float,
           order: int) -> torch.Tensor:
    v = x[ops.tets]
    dx = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], dim=2)
    F = torch.sum(dx[:, :, :, None] * ops.dX_inv[:, None, :, :], dim=2)
    LF = ops.degree[:, None, None] * F
    for k in range(4):
        LF = LF - ops.mask[:, k, None, None] * F[ops.nbrs[:, k]]
    det = (F[:, 0, 0] * (F[:, 1, 1] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 1])
           - F[:, 0, 1] * (F[:, 1, 0] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 0])
           + F[:, 0, 2] * (F[:, 1, 0] * F[:, 2, 1] - F[:, 1, 1] * F[:, 2, 0]))
    neg = torch.clamp_min(-det, 0.0)
    p2 = neg * neg
    return c1 * 0.5 * torch.sum(LF * LF) \
        + c2 * torch.sum(p2 * p2 if order == 4 else p2)
