"""Geometry regularization: biharmonic smoothness + tet non-inversion barrier
(port of ``tssplat_tpu/ops/energy.py``).

  E(x) = c1 * 1/2 * sum_t ||(L F)_t||^2 + c2 * sum_t max(-det F_t, 0)^order
  F_t  = dx_t @ dX_inv_t, (L F)_t = deg_t F_t - sum_{n in nbr(t)} F_n

Same flat (T,9) formulation and the same closed-form backward as the JAX
package's ``_sb_bwd_core9``: the Laplacian is symmetric, so dE/dF is the
same 4-neighbour stencil; the barrier term is the cofactor formula; the
tet-corner -> vertex fold is the vertex-sorted segmented scan with the -1
sentinel for vertices no tet references. The JAX energy is XLA code, not a
Pallas kernel, so plain PyTorch is its counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class EnergyOps(NamedTuple):
    """Static per-mesh operator tensors (the JAX ``EnergyOps`` fields the
    flat-(T,9) path reads)."""
    tets: torch.Tensor          # (T,4) int64
    dX_inv: torch.Tensor        # (T,3,3) f32 — rest edge-matrix inverses
    nbrs: torch.Tensor          # (T,4) int64 — face-adjacent tets, self-padded
    nbr_mask: torch.Tensor      # (T,4) f32 — 1 for a real neighbour
    degree: torch.Tensor        # (T,) f32
    num_vertices: int
    row_w: Optional[torch.Tensor]   # (T,) f32 Laplacian row weights or None
    fold_src: torch.Tensor      # (4T,) int64 — vertex-sorted permutation
    fold_sv: torch.Tensor       # (4T,) int64 — sorted vertex ids
    fold_last: torch.Tensor     # (n,) int64 — segment end slot, -1 if none
    max_incidence: int          # D: most (tet, corner) slots of one vertex


def energy_ops_from_arrays(tets, dX_inv, nbrs, nbr_mask, degree, num_vertices,
                           row_w, fold_src, fold_sv, fold_last,
                           device) -> EnergyOps:
    """Tensors on ``device`` from host arrays (shared by build_energy_ops
    and convert.py)."""
    def i64(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    fold_sv_np = np.asarray(fold_sv)
    D = int(np.bincount(fold_sv_np).max()) if fold_sv_np.size else 1
    return EnergyOps(
        tets=i64(tets), dX_inv=f32(dX_inv), nbrs=i64(nbrs),
        nbr_mask=f32(nbr_mask), degree=f32(degree),
        num_vertices=int(num_vertices),
        row_w=None if row_w is None else f32(row_w),
        fold_src=i64(fold_src), fold_sv=i64(fold_sv),
        fold_last=i64(fold_last), max_incidence=D)


def build_energy_ops(tetmesh, device, laplacian_weighting: str = "uniform"
                     ) -> EnergyOps:
    """Host numpy operator build (as ``tssplat_tpu.ops.energy.
    build_energy_ops``), returned as tensors on ``device``."""
    dX_inv, vol = tetmesh.rest_matrices()
    nbrs, degree = tetmesh.tet_neighbors()
    if np.any(vol <= 0):
        raise ValueError("rest mesh contains inverted/degenerate tets")
    row_w = None
    if laplacian_weighting == "volume":
        row_w = vol / vol.mean()
    elif laplacian_weighting != "uniform":
        raise ValueError(f"unknown laplacian_weighting "
                         f"{laplacian_weighting!r}")
    T = tetmesh.elem.shape[0]
    mask = (nbrs >= 0).astype(np.float32)
    safe_nbrs = np.where(nbrs >= 0, nbrs, np.arange(T)[:, None])

    n = int(tetmesh.vtx_init.shape[0])
    flat_v = np.asarray(tetmesh.elem, np.int64).reshape(-1)      # (4T,)
    counts = np.bincount(flat_v, minlength=n)
    order_srt = np.argsort(flat_v, kind="stable")
    sorted_v = flat_v[order_srt]
    starts = np.cumsum(counts) - counts
    # -1 sentinel: a vertex no tet references gets an exactly-zero gradient
    seg_last = np.where(counts > 0, starts + counts - 1, -1)
    return energy_ops_from_arrays(tetmesh.elem, dX_inv, safe_nbrs, mask,
                                  degree, n, row_w, order_srt, sorted_v,
                                  seg_last, device)


def _deformation_gradients9(x, tets, dX_inv):
    """Flat (T,9) deformation gradients; entry 3*i+j == F[i,j]."""
    v0 = x[tets[:, 0]]
    e0, e1, e2 = x[tets[:, 1]] - v0, x[tets[:, 2]] - v0, x[tets[:, 3]] - v0
    F = (e0[:, :, None] * dX_inv[:, None, 0, :]
         + e1[:, :, None] * dX_inv[:, None, 1, :]
         + e2[:, :, None] * dX_inv[:, None, 2, :])           # (T,3,3)
    return F.reshape(-1, 9)


def _det9(F9):
    f = F9.unbind(-1)
    return (f[0] * (f[4] * f[8] - f[5] * f[7])
            - f[1] * (f[3] * f[8] - f[5] * f[6])
            + f[2] * (f[3] * f[7] - f[4] * f[6]))


def _cof9(F9):
    """Flat cofactor matrix: entry 3*i+j == d det / d F[i,j]."""
    f = F9.unbind(-1)
    return torch.stack([f[4] * f[8] - f[5] * f[7],
                        f[5] * f[6] - f[3] * f[8],
                        f[3] * f[7] - f[4] * f[6],
                        f[2] * f[7] - f[1] * f[8],
                        f[0] * f[8] - f[2] * f[6],
                        f[1] * f[6] - f[0] * f[7],
                        f[1] * f[5] - f[2] * f[4],
                        f[2] * f[3] - f[0] * f[5],
                        f[0] * f[4] - f[1] * f[3]], dim=-1)


def _unweighted_lap9(F9, nbrs, nbr_mask, degree):
    out = degree[:, None] * F9
    for k in range(4):
        out = out - nbr_mask[:, k, None] * F9[nbrs[:, k]]
    return out


def _barrier_coeff(neg, order: int):
    return 4.0 * neg * neg * neg if order == 4 else 2.0 * neg


class _SmoothBarrier(torch.autograd.Function):
    """Value c1*E_smooth + c2*E_barrier; gradient w.r.t. ``x`` only (the
    coefficients and operator tables are constants of the train step)."""

    @staticmethod
    def forward(ctx, x, c1, c2, order: int, ops: EnergyOps):
        F9 = _deformation_gradients9(x, ops.tets, ops.dX_inv)
        UF9 = _unweighted_lap9(F9, ops.nbrs, ops.nbr_mask, ops.degree)
        WUF = ops.row_w[:, None] * UF9 if ops.row_w is not None else UF9
        e_smooth = 0.5 * torch.sum(WUF * WUF)
        neg = torch.clamp_min(-_det9(F9), 0.0)
        p2 = neg * neg
        e_barrier = torch.sum(p2 * p2 if order == 4 else p2)
        ctx.save_for_backward(F9, UF9)
        ctx.c1, ctx.c2, ctx.order, ctx.ops = c1, c2, order, ops
        return c1 * e_smooth + c2 * e_barrier

    @staticmethod
    def backward(ctx, g):
        F9, UF9 = ctx.saved_tensors
        ops = ctx.ops
        w2UF = (ops.row_w[:, None] ** 2) * UF9 if ops.row_w is not None \
            else UF9
        dF9 = ctx.c1 * _unweighted_lap9(w2UF, ops.nbrs, ops.nbr_mask,
                                        ops.degree)
        neg = torch.clamp_min(-_det9(F9), 0.0)
        dF9 = dF9 - (ctx.c2 * _barrier_coeff(neg, ctx.order))[:, None] \
            * _cof9(F9)
        # P[i][k] = sum_j dF[i,j] * dX_inv[k,j]; corner rows (corner, xyz)
        dX = ops.dX_inv
        P = [[dF9[:, 3 * i + 0] * dX[:, k, 0] + dF9[:, 3 * i + 1] * dX[:, k, 1]
              + dF9[:, 3 * i + 2] * dX[:, k, 2] for k in range(3)]
             for i in range(3)]
        cols = [-(P[i][0] + P[i][1] + P[i][2]) for i in range(3)]
        for k in range(3):
            cols += [P[i][k] for i in range(3)]
        flat = torch.stack(cols, dim=-1).reshape(-1, 3)          # (4T,3)
        # vertex-sorted segmented inclusive scan (Hillis-Steele), then each
        # segment's last slot — the JAX fold's summation order
        c = flat[ops.fold_src]
        sv = ops.fold_sv
        for r in range(math.ceil(math.log2(max(ops.max_incidence, 1)))):
            s = 1 << r
            if s >= c.shape[0]:
                break
            same = (sv[s:] == sv[:-s]).to(c.dtype)[:, None]
            c = torch.cat([c[:s], c[s:] + c[:-s] * same], dim=0)
        last = ops.fold_last
        gx = c[torch.clamp_min(last, 0)] * (last >= 0).to(c.dtype)[:, None]
        return g * gx, None, None, None, None


def smooth_barrier_energy(x: torch.Tensor, ops: EnergyOps, c1, c2,
                          order: int) -> torch.Tensor:
    """Total regularization energy (0-dim tensor). ``order`` is 2 or 4.
    ``c1`` and ``c2`` are floats, or float32 0-dim tensors on x's device
    (the same products: a float of the schedule is a float32 value)."""
    def coeff(c):
        return c if torch.is_tensor(c) else float(c)
    return _SmoothBarrier.apply(x, coeff(c1), coeff(c2), int(order), ops)


def deformation_gradients(x: torch.Tensor, tets: torch.Tensor,
                          dX_inv: torch.Tensor) -> torch.Tensor:
    """Per-tet deformation gradient F = dx @ dX_inv (T,3,3), dx's columns
    the current edge vectors [v1-v0, v2-v0, v3-v0] (``deformation_
    gradients``, energy.py:153; reference geometry/mesh_utils.py:51-53),
    as a broadcast multiply and sum."""
    v = x[tets]                                           # (T,4,3)
    dx = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], dim=2)          # columns
    return torch.sum(dx[:, :, :, None] * dX_inv[:, None, :, :], dim=2)


def _det3(F: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (the expansion of ``_det3``,
    energy.py:168)."""
    return (F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2]
                            - F[..., 1, 2] * F[..., 2, 1])
            - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2]
                              - F[..., 1, 2] * F[..., 2, 0])
            + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1]
                              - F[..., 1, 1] * F[..., 2, 0]))


def laplacian_F(F: torch.Tensor, ops: EnergyOps) -> torch.Tensor:
    """The tet-graph Laplacian applied blockwise to the F field, (LF)_t =
    deg_t F_t - sum of the neighbours' F, row-scaled by ops.row_w where a
    weighting is set (``laplacian_F``, energy.py:191)."""
    LF = ops.degree[:, None, None] * F
    for k in range(4):
        LF = LF - ops.nbr_mask[:, k, None, None] * F[ops.nbrs[:, k]]
    if ops.row_w is not None:
        LF = ops.row_w[:, None, None] * LF
    return LF


def smooth_barrier_energy_ref(x: torch.Tensor, ops: EnergyOps, c1, c2,
                              order: int) -> torch.Tensor:
    """The energy in plain PyTorch (``smooth_barrier_energy_ref``,
    energy.py:467): the same math as ``smooth_barrier_energy`` with
    autograd's own backward, reverse or forward mode (``torch.func.jvp``);
    the oracle of the closed-form gradient."""
    F = deformation_gradients(x, ops.tets, ops.dX_inv)
    LF = laplacian_F(F, ops)
    e_smooth = 0.5 * torch.sum(LF * LF)
    neg = torch.clamp_min(-_det3(F), 0.0)
    p2 = neg * neg
    e_barrier = torch.sum(p2 * p2 if int(order) == 4 else p2)
    return c1 * e_smooth + c2 * e_barrier


def compute_G_matrix(verts, tets) -> torch.Tensor:
    """Dense per-tet deformation-gradient operator G (T,9,12) f32:
    flat(F_t) = G_t @ x_t with x_t the tet's 12 stacked vertex coordinates
    (``compute_G_matrix``, energy.py:485; reference geometry/mesh_utils.py:
    38-69, the dense form of the reference's sparse G), from the rest
    edge matrices' inverses taken in float64. A test oracle; the
    energy uses the gather form (deformation_gradients). On the device of
    ``verts`` where it is a tensor, else the CPU."""
    verts = torch.as_tensor(verts, dtype=torch.float32)
    tets = torch.as_tensor(tets, dtype=torch.int64, device=verts.device)
    v = verts[tets]                                       # (T,4,3)
    dX = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], dim=2)
    # the inverse in f64, rounded once: within 3e-7 of JAX's f32 LU
    # inverse where two f32 algorithms part by 1e-6
    dX_inv = torch.linalg.inv(dX.double()).float()        # (T,3,3)
    # F_ij = sum_k dx_ik dXinv_kj with edge_k = v_{k+1} - v_0
    G = torch.zeros((tets.shape[0], 9, 12), dtype=torch.float32,
                    device=verts.device)
    for i in range(3):          # row of F
        for j in range(3):      # column of F
            r = i * 3 + j
            for k in range(3):  # edge
                w = dX_inv[:, k, j]
                G[:, r, 3 * (k + 1) + i] += w
                G[:, r, i] += -w
    return G


def energy_coeff_schedule(it: int, smooth_coeff: float, barrier_coeff: float):
    """Coefficient ramp x1 -> x16 over ~1200 iterations (reference
    energies/smooth_barrier.py:47-58), evaluated in float32 like the JAX
    schedule; returns Python floats."""
    it32 = torch.tensor(float(it), dtype=torch.float32)
    phase = torch.clamp_max(it32 / 300.0 / 4.0 * 0.5 * math.pi,
                            0.5 * math.pi)
    mult = torch.pow(torch.tensor(2.0), torch.abs(torch.sin(phase)) * 4.0)
    c1 = torch.tensor(smooth_coeff, dtype=torch.float32) * mult
    c2 = torch.tensor(barrier_coeff, dtype=torch.float32) * mult
    return float(c1), float(c2)


def barrier_order(it: int, increase_order_iter: int) -> int:
    """2 until ``increase_order_iter``, then 4."""
    return 4 if it > increase_order_iter else 2
