"""Carry state from the JAX package into the port's tensors.

Takes the JAX side's arrays (anything ``numpy.asarray`` accepts: numpy
arrays, or JAX arrays, which this module never imports) and returns the
port's structures on ``device``, so both packages can compute the same
thing from the same inputs:

  geometry_statics   GeometryStatics (surface_vid, surface_fid, edge_nbrs,
                     corner_vid, EnergyOps and the scalar coefficients)
  tet_v              (N,3) f32 vertex positions
  adam_state         AdamUniformState (count, g1, g2, limit_ptr, cc)
  optax_adam_state   AdamState (count, mu, nu) of ``optax.adam``
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .geometry.tet_geometry import GeometryStatics
from .ops.energy import EnergyOps, energy_ops_from_arrays
from .optim.adam import AdamState
from .optim.adam_uniform import AdamUniformState


def _i64(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)


def _f32(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _i32(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)


def energy_ops(ops, device: DeviceLike = None) -> EnergyOps:
    """A JAX ``EnergyOps`` (needs the fold fields build_energy_ops sets)."""
    if ops.fold_src is None:
        raise ValueError("EnergyOps without the segmented-fold tables")
    return energy_ops_from_arrays(
        ops.tets, ops.dX_inv, ops.nbrs, ops.nbr_mask, ops.degree,
        ops.num_vertices, ops.row_w, ops.fold_src, ops.fold_sv,
        ops.fold_last, resolve_device(device))


def geometry_statics(statics, device: DeviceLike = None) -> GeometryStatics:
    """A JAX ``GeometryStatics``."""
    dev = resolve_device(device)
    return GeometryStatics(
        surface_vid=_i64(statics.surface_vid, dev),
        surface_fid=_i64(statics.surface_fid, dev),
        edge_nbrs=_i64(statics.edge_nbrs, dev),
        corner_vid=_i64(statics.corner_vid, dev),
        energy=None if statics.energy is None
        else energy_ops(statics.energy, dev),
        smooth_coeff=float(statics.smooth_coeff),
        barrier_coeff=float(statics.barrier_coeff),
        increase_order_iter=int(statics.increase_order_iter))


def tet_v(a, device: DeviceLike = None) -> torch.Tensor:
    return _f32(a, resolve_device(device))


def adam_state(state, device: DeviceLike = None) -> AdamUniformState:
    """A JAX ``AdamUniformState`` whose moments are single arrays."""
    dev = resolve_device(device)
    return AdamUniformState(count=_i32(state.count, dev),
                            g1=_f32(state.g1, dev), g2=_f32(state.g2, dev),
                            limit_ptr=_i32(state.limit_ptr, dev),
                            cc=_i32(state.cc, dev))


def optax_adam_state(state, device: DeviceLike = None) -> AdamState:
    """The state of ``optax.adam(schedule)`` on one array: (ScaleByAdamState
    (count, mu, nu), ScaleByScheduleState(count)); the two counts agree."""
    dev = resolve_device(device)
    adam_st = state[0]
    return AdamState(count=_i32(adam_st.count, dev), mu=_f32(adam_st.mu, dev),
                     nu=_f32(adam_st.nu, dev))
