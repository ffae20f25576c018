"""Encodings and small MLPs of the colour field (port of
``tssplat_tpu/models/networks.py``; reference models/networks.py).

Functional, like the JAX module: each factory returns a ``Module``
(init_fn, apply_fn, n_output_dims, n_input_dims) with
``params = init_fn(generator, device)`` (a dict of tensors, drawn from a
CPU ``torch.Generator`` and then moved to ``device``, so the CPU and the
card start alike for one seed) and ``y = apply_fn(params, x, step)``.

  get_activation, scale_tensor
  hash_grid_encoding            multi-resolution hash grid (InstantNGP,
                                tiny-cuda-nn semantics), exact trilinear
                                forward; optional stochastic table gradient
  progressive_band_hash_grid    coarse-to-fine level masking
  frequency_encoding            NeRF sin/cos with band masking
  composite_encoding            xyz concatenated in front
  get_encoding                  factory on tiny-cuda-nn ``otype`` names
  vanilla_mlp, sphere_init_mlp, get_mlp
  create_network_with_input_encoding

MLP weights are stored (in, out), as the JAX package stores them, so a
``material.npz`` of either package loads in the other. The JAX package's
bucketed table gradient (``build_hash_grad_buckets`` and its appliers) is
not ported: it exists to avoid TPU scatters, and on the card autograd's
scatter-add of the gathered table rows gives the same loss and gradients.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..device import DeviceLike, resolve_device
from ..utils.profiling import span


def get_activation(name) -> Callable:
    """Activation by the reference's names (models/networks.py:16-49)."""
    if name is None:
        return lambda x: x
    name_l = str(name).lower()

    def lin2srgb(x):
        return torch.clamp(torch.where(
            x > 0.0031308,
            torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055
            - 0.055, 12.92 * x), 0.0, 1.0)

    table = {
        "none": lambda x: x,
        "lin2srgb": lin2srgb,
        "exp": torch.exp,
        "shifted_exp": lambda x: torch.exp(x - 1.0),
        "trunc_exp": lambda x: torch.exp(torch.clamp(x, max=15.0)),
        "shifted_trunc_exp": lambda x: torch.exp(torch.clamp(x - 1.0,
                                                             max=15.0)),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "shifted_softplus": lambda x: tnf.softplus(x - 1.0),
        "scale_-11_01": lambda x: x * 0.5 + 0.5,
        "relu": torch.relu,
        "softplus": tnf.softplus,
    }
    if name_l in table:
        return table[name_l]
    if hasattr(tnf, name_l):
        return getattr(tnf, name_l)
    raise ValueError(f"Unknown activation function: {name}")


def scale_tensor(dat, inp_scale, tgt_scale):
    """Affine map of ``dat`` from the range inp_scale to tgt_scale (scalars
    or per-dimension tensors; reference :407-418)."""
    if inp_scale is None:
        inp_scale = (0.0, 1.0)
    if tgt_scale is None:
        tgt_scale = (0.0, 1.0)
    lo_i, hi_i = inp_scale[0], inp_scale[1]
    lo_t, hi_t = tgt_scale[0], tgt_scale[1]
    dat = (dat - lo_i) / (hi_i - lo_i)
    return dat * (hi_t - lo_t) + lo_t


class Module(NamedTuple):
    """params = init_fn(generator, device); y = apply_fn(params, x[, step])."""
    init_fn: Callable
    apply_fn: Callable
    n_output_dims: int
    n_input_dims: int


# ---------------------------------------------------------------------------
# hash grid
# ---------------------------------------------------------------------------

_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# corner i is the bit pattern (i>>2, i>>1, i) & 1 (JAX's _CORNERS, the
# meshgrid over three {0,1} axes in "ij" order)
_CORNERS = [((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8)]


def _hash_coords(c: torch.Tensor, hashmap_size: int) -> torch.Tensor:
    """Spatial hash of non-negative int64 grid coordinates (…,3) into
    [0, hashmap_size): JAX's uint32 arithmetic with wraparound, done in
    int64 and masked to 32 bits after each product and the xors."""
    h = (c[..., 0] * _HASH_PRIMES[0]) & _U32
    h = h ^ ((c[..., 1] * _HASH_PRIMES[1]) & _U32)
    h = h ^ ((c[..., 2] * _HASH_PRIMES[2]) & _U32)
    return h % hashmap_size


def _grid_levels(n_levels, base_resolution, per_level_scale,
                 log2_hashmap_size):
    """Per-level resolutions, dense flags and the table size per level:
    a level whose (r+1)^3 grid fits the table is indexed densely."""
    H = 1 << log2_hashmap_size
    res = [int(math.floor(base_resolution * per_level_scale ** l))
           for l in range(n_levels)]
    dense = [(r + 1) ** 3 <= H for r in res]
    return res, dense, H


def _grid_level_setup(x: torch.Tensor, r: int):
    """(lower corner (…,3) int64, fraction (…,3)) of x in [0,1]^3 on a
    grid of resolution r."""
    xl = x * float(r)
    i0 = torch.clamp(torch.floor(xl).to(torch.int64), 0, r - 1)
    return i0, xl - i0.to(x.dtype)


def _grid_corners(x: torch.Tensor, res, dense, H):
    """Table rows (…,L,8) int64 and trilinear weights (…,L,8) of every
    (level, corner), corners in _CORNERS order; each level's eight corners
    in one pass of elementwise ops."""
    with span("tssplat.sync.encoding"):      # a host-to-device copy
        corners = torch.as_tensor(_CORNERS, dtype=torch.int64,
                                  device=x.device)
    upper = corners.bool()                                  # (8,3)
    idx, wgt = [], []
    for l, r in enumerate(res):
        i0, w = _grid_level_setup(x, r)
        c = i0[..., None, :] + corners                      # (…,8,3)
        if dense[l]:
            rows = (c[..., 0] * (r + 1) + c[..., 1]) * (r + 1) + c[..., 2]
        else:
            rows = _hash_coords(c, H)
        idx.append(rows + l * H)
        f = torch.where(upper, w[..., None, :], 1.0 - w[..., None, :])
        wgt.append(f[..., 0] * f[..., 1] * f[..., 2])
    return torch.stack(idx, dim=-2), torch.stack(wgt, dim=-2)


def _grid_exact(table: torch.Tensor, x: torch.Tensor, res, dense, H):
    """Exact multi-level trilinear lookup (…,3) -> (…, L*F): each level's
    corners summed in _CORNERS order from the first, as the JAX package
    sums them."""
    idx, wgt = _grid_corners(x, res, dense, H)             # (…,L,8)
    prod = table[idx] * wgt[..., None]                     # (…,L,8,F)
    feats = prod[..., 0, :]
    for ci in range(1, 8):
        feats = feats + prod[..., ci, :]
    return feats.reshape(*x.shape[:-1], -1)


class _StochasticTableGrad(torch.autograd.Function):
    """Exact forward and position gradient; the table gradient scatters
    each level's feature cotangent, unscaled, to one corner drawn with
    probability equal to its trilinear weight by the uniforms ``u``
    (…, L) — an unbiased estimate of the 8-corner gradient with 8x fewer
    rows (networks.py:221-264). The corner is chosen by the cumulative
    where-chain of the JAX package: corner ci where acc <= u < acc + w_ci,
    corner 7 for the rest."""

    @staticmethod
    def forward(ctx, table, x, u, grid):
        ctx.save_for_backward(table, x, u)
        ctx.grid = grid
        with torch.no_grad():
            return _grid_exact(table, x, *grid)

    @staticmethod
    def backward(ctx, d_out):
        table, x, u = ctx.saved_tensors
        res, dense, H = ctx.grid
        L = len(res)
        F = table.shape[-1]
        N = x.shape[:-1]
        d_feats = d_out.reshape(*N, L, F)
        d_table = d_x = None
        if ctx.needs_input_grad[0]:
            idx, wgt = _grid_corners(x, res, dense, H)     # (…,L,8)
            sel = []
            for l in range(L):
                acc = torch.zeros(N, dtype=x.dtype, device=x.device)
                csel = torch.full(N, 7, dtype=torch.int64, device=x.device)
                ul = u[..., l]
                for ci in range(7):
                    wc = wgt[..., l, ci]
                    hit = (ul >= acc) & (ul < acc + wc) & (csel == 7)
                    csel = torch.where(hit, ci, csel)
                    acc = acc + wc
                sel.append(torch.gather(idx[..., l, :], -1, csel[..., None]))
            d_table = torch.zeros_like(table).index_add_(
                0, torch.cat(sel, dim=-1).reshape(-1),
                d_feats.reshape(-1, F))
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                out = _grid_exact(table.detach(), xx, res, dense, H)
                (d_x,) = torch.autograd.grad(out, xx, d_out)
        return d_table, d_x, None, None


def hash_grid_encoding(n_input_dims: int = 3, n_levels: int = 16,
                       n_features_per_level: int = 2,
                       log2_hashmap_size: int = 19, base_resolution: int = 16,
                       per_level_scale: float = 1.447269237440378,
                       init_scale: float = 1e-4,
                       stochastic_table_grad: bool = False) -> Module:
    """Multi-resolution hash-grid encoding (``hash_grid_encoding``,
    networks.py:179): input in [0,1]^3, output (…, n_levels *
    n_features_per_level); a (n_levels * 2^log2_hashmap_size, F) table,
    levels whose dense grid fits indexed densely, the others hashed.

    ``apply_fn(params, x, step, grad_u=None, grad_gen=None)``: with
    ``stochastic_table_grad`` and uniforms ``grad_u`` (…, n_levels) —
    or a CPU generator ``grad_gen`` to draw them from — the table gradient
    is the one-corner-per-level estimate of ``_StochasticTableGrad``;
    otherwise autograd's exact gradient (a scatter-add of the gathered
    rows)."""
    assert n_input_dims == 3, "hash grid implemented for 3-D inputs"
    grid = _grid_levels(n_levels, base_resolution, per_level_scale,
                        log2_hashmap_size)
    H = grid[2]
    F = n_features_per_level

    def init_fn(generator: torch.Generator, device: DeviceLike = "cpu"):
        t = torch.rand((n_levels * H, F), generator=generator,
                       dtype=torch.float32)
        t = t * (2.0 * init_scale) - init_scale
        return {"table": t.to(resolve_device(device))}

    def apply_fn(params, x, step=None, grad_u=None, grad_gen=None):
        if stochastic_table_grad and (grad_u is not None
                                      or grad_gen is not None):
            if grad_u is None:
                grad_u = torch.rand((*x.shape[:-1], n_levels),
                                    generator=grad_gen).to(x.device)
            return _StochasticTableGrad.apply(params["table"], x, grad_u,
                                              grid)
        return _grid_exact(params["table"], x, *grid)

    return Module(init_fn, apply_fn, n_levels * F, n_input_dims)


def progressive_band_hash_grid(n_input_dims: int = 3, start_level: int = 4,
                               start_step: int = 0, update_steps: int = 500,
                               **kwargs) -> Module:
    """Hash grid whose levels unlock coarse to fine (networks.py:404):
    ``start_level`` levels at ``start_step``, one more every
    ``update_steps`` steps."""
    grid = hash_grid_encoding(n_input_dims, **kwargs)
    n_levels = kwargs.get("n_levels", 16)
    F = kwargs.get("n_features_per_level", 2)

    def apply_fn(params, x, step=0, grad_u=None, grad_gen=None):
        feats = grid.apply_fn(params, x, grad_u=grad_u, grad_gen=grad_gen)
        current = start_level + max(int(step) - start_step, 0) \
            // update_steps
        mask = torch.arange(n_levels, device=x.device) < current
        mask = mask.repeat_interleave(F).to(feats.dtype)
        return feats * mask

    return Module(grid.init_fn, apply_fn, grid.n_output_dims, n_input_dims)


def frequency_encoding(n_input_dims: int, n_frequencies: int = 10,
                       n_masking_step: int = 0) -> Module:
    """NeRF positional encoding (networks.py:425) with optional band
    masking: frequency j weighted by (1 - cos(pi clamp(alpha - j, 0, 1)))
    / 2, alpha = step / n_masking_step * n_frequencies."""
    freqs = (2.0 ** np.arange(n_frequencies)).astype(np.float32)
    n_out = n_input_dims * n_frequencies * 2

    def init_fn(generator: torch.Generator, device: DeviceLike = "cpu"):
        return {}

    def apply_fn(params, x, step=0, grad_u=None, grad_gen=None):
        xs = x[..., None] * torch.as_tensor(freqs, device=x.device)
        enc = torch.stack([torch.sin(xs), torch.cos(xs)], dim=-1)
        if n_masking_step > 0:
            alpha = torch.tensor(float(step), dtype=torch.float32,
                                 device=x.device)
            alpha = alpha / torch.full_like(alpha, float(n_masking_step)) \
                * n_frequencies
            j = torch.arange(n_frequencies, dtype=torch.float32,
                             device=x.device)
            w = (1.0 - torch.cos(math.pi * torch.clamp(alpha - j, 0.0, 1.0))
                 ) / 2.0
            enc = enc * w[:, None]
        return enc.reshape(*x.shape[:-1], n_out)

    return Module(init_fn, apply_fn, n_out, n_input_dims)


def composite_encoding(enc: Module, include_xyz: bool = False,
                       xyz_scale: float = 2.0, xyz_offset: float = -1.0
                       ) -> Module:
    """Optionally (scaled) xyz concatenated in front of an encoding
    (networks.py:450)."""
    if not include_xyz:
        return enc

    def apply_fn(params, x, step=0, grad_u=None, grad_gen=None):
        return torch.cat([x * xyz_scale + xyz_offset,
                          enc.apply_fn(params, x, step, grad_u=grad_u,
                                       grad_gen=grad_gen)], dim=-1)

    return Module(enc.init_fn, apply_fn,
                  enc.n_output_dims + enc.n_input_dims, enc.n_input_dims)


def _grid_kwargs(cfg: dict) -> dict:
    keys = ("n_levels", "n_features_per_level", "log2_hashmap_size",
            "base_resolution", "per_level_scale", "stochastic_table_grad")
    return {k: cfg[k] for k in keys if k in cfg}


def get_encoding(n_input_dims: int, config: dict) -> Module:
    """Encoding by tiny-cuda-nn ``otype`` (networks.py:466)."""
    cfg = dict(config)
    otype = cfg.pop("otype", "HashGrid")
    include_xyz = cfg.pop("include_xyz", False)
    xyz_scale = cfg.pop("xyz_scale", 2.0)
    xyz_offset = cfg.pop("xyz_offset", -1.0)
    if otype in ("HashGrid", "Grid"):
        enc = hash_grid_encoding(n_input_dims, **_grid_kwargs(cfg))
    elif otype == "ProgressiveBandHashGrid":
        enc = progressive_band_hash_grid(
            n_input_dims, start_level=cfg.pop("start_level", 4),
            start_step=cfg.pop("start_step", 0),
            update_steps=cfg.pop("update_steps", 500), **_grid_kwargs(cfg))
    elif otype in ("Frequency", "ProgressiveBandFrequency"):
        enc = frequency_encoding(
            n_input_dims, n_frequencies=cfg.get("n_frequencies", 10),
            n_masking_step=cfg.get("n_masking_step", 0))
    else:
        raise ValueError(f"unknown encoding otype {otype!r}")
    return composite_encoding(enc, include_xyz, xyz_scale, xyz_offset)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _dense(params, x, name, act=None):
    y = x @ params[name + "_w"] + params[name + "_b"]
    return act(y) if act is not None else y


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def vanilla_mlp(dim_in: int, dim_out: int, n_neurons: int = 64,
                n_hidden_layers: int = 1, activation: str = "ReLU",
                output_activation: str = "none") -> Module:
    """Plain MLP (networks.py:505): ``n_hidden_layers`` hidden layers of
    ``n_neurons``, He-initialised weights, zero biases."""
    act = get_activation(activation)
    out_act = get_activation(output_activation)
    dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]

    def init_fn(generator: torch.Generator, device: DeviceLike = "cpu"):
        dev = resolve_device(device)
        params = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"l{i}_w"] = (_normal(generator, (a, b))
                                 * math.sqrt(2.0 / a)).to(dev)
            params[f"l{i}_b"] = torch.zeros((b,), device=dev)
        return params

    def apply_fn(params, x, step=None):
        h = x
        for i in range(len(dims) - 2):
            h = _dense(params, h, f"l{i}", act)
        return out_act(_dense(params, h, f"l{len(dims) - 2}"))

    return Module(init_fn, apply_fn, dim_out, dim_in)


def sphere_init_mlp(dim_in: int, dim_out: int, n_neurons: int = 64,
                    n_hidden_layers: int = 1, sphere_radius: float = 0.5,
                    inside_out: bool = False) -> Module:
    """MLP initialised to approximate the SDF of a sphere of
    ``sphere_radius`` (networks.py:533), softplus(beta=100) activations."""
    beta = 100.0

    def act(x):
        return tnf.softplus(x * beta) / beta

    dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]

    def init_fn(generator: torch.Generator, device: DeviceLike = "cpu"):
        dev = resolve_device(device)
        params = {}
        n = len(dims) - 1
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            if i == n - 1:                                 # output layer
                mean = math.sqrt(math.pi) / math.sqrt(a)
                w = _normal(generator, (a, b)) * 1e-4 + mean
                bias = torch.full((b,), -sphere_radius)
            elif i == 0:                # first layer: weights on xyz only
                w = torch.zeros((a, b))
                w[:3] = _normal(generator, (3, b)) * math.sqrt(2.0 / b)
                bias = torch.zeros((b,))
            else:
                w = _normal(generator, (a, b)) * math.sqrt(2.0 / b)
                bias = torch.zeros((b,))
            if inside_out and i == n - 1:
                w, bias = -w, -bias
            params[f"l{i}_w"] = w.to(dev)
            params[f"l{i}_b"] = bias.to(dev)
        return params

    def apply_fn(params, x, step=None):
        h = x
        for i in range(len(dims) - 2):
            h = act(_dense(params, h, f"l{i}"))
        return _dense(params, h, f"l{len(dims) - 2}")

    return Module(init_fn, apply_fn, dim_out, dim_in)


def get_mlp(dim_in: int, dim_out: int, config: dict) -> Module:
    """MLP by ``otype`` (networks.py:578)."""
    cfg = dict(config)
    otype = cfg.pop("otype", "VanillaMLP")
    if otype in ("VanillaMLP", "FullyFusedMLP", "CutlassMLP", "TCNNNetwork"):
        return vanilla_mlp(dim_in, dim_out,
                           n_neurons=cfg.get("n_neurons", 64),
                           n_hidden_layers=cfg.get("n_hidden_layers", 1),
                           activation=cfg.get("activation", "ReLU"),
                           output_activation=cfg.get("output_activation",
                                                     "none"))
    if otype == "SphereInitVanillaMLP":
        return sphere_init_mlp(dim_in, dim_out,
                               n_neurons=cfg.get("n_neurons", 64),
                               n_hidden_layers=cfg.get("n_hidden_layers", 1),
                               sphere_radius=cfg.get("sphere_init_radius",
                                                     0.5),
                               inside_out=cfg.get("inside_out", False))
    raise ValueError(f"unknown mlp otype {otype!r}")


def create_network_with_input_encoding(n_input_dims: int, n_output_dims: int,
                                       encoding_config: dict,
                                       network_config: dict) -> Module:
    """Encoding -> MLP (networks.py:597); params {"encoding", "network"}."""
    enc = get_encoding(n_input_dims, encoding_config)
    mlp = get_mlp(enc.n_output_dims, n_output_dims, network_config)

    def init_fn(generator: torch.Generator, device: DeviceLike = "cpu"):
        return {"encoding": enc.init_fn(generator, device),
                "network": mlp.init_fn(generator, device)}

    def apply_fn(params, x, step=0, grad_u=None, grad_gen=None):
        return mlp.apply_fn(params["network"],
                            enc.apply_fn(params["encoding"], x, step,
                                         grad_u=grad_u, grad_gen=grad_gen))

    return Module(init_fn, apply_fn, n_output_dims, n_input_dims)
