"""Carry state from the JAX package into the port's tensors.

Takes the JAX side's arrays (anything ``numpy.asarray`` accepts: numpy
arrays, or JAX arrays, which this module never imports) and returns the
port's structures on ``device``, so both packages can compute the same
thing from the same inputs:

  geometry_statics   GeometryStatics (surface_vid, surface_fid, edge_nbrs,
                     corner_vid, EnergyOps and the scalar coefficients)
  tet_v              (N,3) f32 vertex positions
  material_params    a material's nested dict of f32 tensors (MLP
                     weights stay (in, out), as both packages store them)
  adam_state         AdamUniformState (count, g1, g2, limit_ptr, cc)
  optax_adam_state   AdamState (count, mu, nu) of ``optax.adam``
  train_state        TrainState (params, either optimizer's state, best
                     loss / iteration / params) of either stage
  sds_state          SDSState (tet_v, optax.adam's state) of the SDS driver
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .geometry.tet_geometry import GeometryStatics, normal_constants
from .ops.energy import EnergyOps, energy_ops_from_arrays
from .optim.adam import AdamState
from .optim.adam_uniform import AdamUniformState
from .train import TrainState
from .train_sds import SDSState
from .utils.tree import tree_map


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
    z_up, z_flip = normal_constants(dev)
    return GeometryStatics(
        surface_vid=_i64(statics.surface_vid, dev),
        surface_fid=_i64(statics.surface_fid, dev),
        edge_nbrs=_i64(statics.edge_nbrs, dev),
        corner_vid=_i64(statics.corner_vid, dev),
        energy=None if statics.energy is None
        else energy_ops(statics.energy, dev),
        smooth_coeff=float(statics.smooth_coeff),
        barrier_coeff=float(statics.barrier_coeff),
        increase_order_iter=int(statics.increase_order_iter),
        z_up=z_up, z_flip=z_flip)


def tet_v(a, device: DeviceLike = None) -> torch.Tensor:
    return _f32(a, resolve_device(device))


def _tree_f32(tree, dev):
    """An array, or a (nested) dict of arrays, as f32 tensors."""
    return tree_map(lambda a: _f32(a, dev), tree)


def material_params(params, device: DeviceLike = None):
    """A JAX material's parameters ({"encoding": {...}, "network": {...}},
    e.g. ``ExplicitMaterial(cfg).params``) as the port's dict of tensors.
    Both packages store the MLP weights (in, out): nothing is
    transposed."""
    return _tree_f32(params, resolve_device(device))


def adam_state(state, device: DeviceLike = None) -> AdamUniformState:
    """A JAX ``AdamUniformState`` whose moments are arrays or dicts of
    them."""
    dev = resolve_device(device)
    return AdamUniformState(count=_i32(state.count, dev),
                            g1=_tree_f32(state.g1, dev),
                            g2=_tree_f32(state.g2, dev),
                            limit_ptr=_i32(state.limit_ptr, dev),
                            cc=_i32(state.cc, dev))


def optax_adam_state(state, device: DeviceLike = None) -> AdamState:
    """The state of ``optax.adam(schedule)`` on an array or a dict of them:
    (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)); the two
    counts agree."""
    dev = resolve_device(device)
    adam_st = state[0]
    return AdamState(count=_i32(adam_st.count, dev),
                     mu=_tree_f32(adam_st.mu, dev),
                     nu=_tree_f32(adam_st.nu, dev))


def train_state(state, device: DeviceLike = None) -> TrainState:
    """A JAX ``TrainState`` of either stage (e.g. from ``jax.device_get``)
    whose opt_state is AdamUniform's or ``optax.adam``'s."""
    dev = resolve_device(device)
    opt = state.opt_state
    opt = adam_state(opt, dev) if hasattr(opt, "g1") \
        else optax_adam_state(opt, dev)
    return TrainState(params=_tree_f32(state.params, dev), opt_state=opt,
                      best_loss=_f32(state.best_loss, dev),
                      best_iter=_i32(state.best_iter, dev),
                      best_params=_tree_f32(state.best_params, dev))


def sds_state(state, device: DeviceLike = None) -> SDSState:
    """A JAX ``train_sds.SDSState``: tet_v and the state of
    ``optax.adam(lr)``."""
    dev = resolve_device(device)
    return SDSState(params=tet_v(state.params, dev),
                    opt_state=optax_adam_state(state.opt_state, dev))
