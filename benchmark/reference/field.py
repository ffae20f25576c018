"""The colour field: a multi-resolution hash-grid encoding (InstantNGP,
tiny-cuda-nn's hash and level sizes), an MLP with ReLU hidden layers, and
a sigmoid. Autograd gives the gradients (the table's is the scatter-add of
its gathered rows)."""

from __future__ import annotations

import math

import torch

from .raster import matmul

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# corner i is the bit pattern (i>>2, i>>1, i) & 1
_CORNERS = [((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8)]


def encode(table: torch.Tensor, x: torch.Tensor, enc: dict) -> torch.Tensor:
    """Features (N, levels * F) of points x (N,3) in [0,1]^3: per level the
    trilinear blend of its eight corners' rows, a level indexed densely
    where its (r+1)^3 grid fits the level's 2^log2_hashmap_size rows, by
    the spatial hash (uint32 arithmetic) elsewhere."""
    H = 1 << int(enc["log2_hashmap_size"])
    base, scale = int(enc["base_resolution"]), float(enc["per_level_scale"])
    corners = torch.as_tensor(_CORNERS, dtype=torch.int64, device=x.device)
    upper = corners.bool()
    feats = []
    for lv in range(int(enc["n_levels"])):
        r = int(math.floor(base * scale ** lv))
        xl = x * float(r)
        i0 = torch.clamp(torch.floor(xl).to(torch.int64), 0, r - 1)
        w = xl - i0.to(x.dtype)
        c = i0[:, None, :] + corners
        if (r + 1) ** 3 <= H:
            rows = (c[..., 0] * (r + 1) + c[..., 1]) * (r + 1) + c[..., 2]
        else:
            h = (c[..., 0] * _PRIMES[0]) & _U32
            h = h ^ ((c[..., 1] * _PRIMES[1]) & _U32)
            h = h ^ ((c[..., 2] * _PRIMES[2]) & _U32)
            rows = h % H
        f = torch.where(upper, w[:, None, :], 1.0 - w[:, None, :])
        wgt = f[..., 0] * f[..., 1] * f[..., 2]
        prod = table[rows + lv * H] * wgt[..., None]
        acc = prod[:, 0]
        for ci in range(1, 8):
            acc = acc + prod[:, ci]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def colour(params: dict, x: torch.Tensor, enc: dict,
           precision: str = "f32") -> torch.Tensor:
    """sigmoid(MLP(encode(x))) (N,3)."""
    h = encode(params["encoding"]["table"], x, enc)
    net = params["network"]
    n = len(net) // 2
    for i in range(n):
        h = matmul(h, net[f"l{i}_w"], precision) + net[f"l{i}_b"]
        if i < n - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)
