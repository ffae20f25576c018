"""Explicit colour-field material: positions -> hash-grid encoding ->
small MLP -> activation (port of ``tssplat_tpu/materials/
explicit_material.py``; reference materials/explicit_material.py:32-112).

``material.params`` is the dict the texture stage optimises,
{"encoding": {"table"}, "network": {"l0_w", "l0_b", ...}};
``material.apply_fn(params, positions, step)`` returns (…,3) colours.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import MATERIALS, parse_structured
from ..device import DeviceLike, resolve_device
from ..models.networks import (get_activation, get_encoding, get_mlp,
                               scale_tensor)
from ..utils.profiling import span
from ..utils.tree import leaf_names, tree_leaves, tree_unflatten


def contract_to_unisphere(x: torch.Tensor, bbox: torch.Tensor,
                          unbounded: bool = False) -> torch.Tensor:
    """Positions mapped into [0,1]^3 by the (2,3) box ``bbox`` = (lo, hi)
    (``contract_to_unisphere``, explicit_material.py:23); ``unbounded``
    contracts the outside of the unit ball as the reference does."""
    x = scale_tensor(x, (bbox[0], bbox[1]), (0.0, 1.0))
    if unbounded:
        x = x * 2 - 1
        mag = torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                              1e-12)
        contracted = (2 - 1 / mag) * (x / mag)
        x = torch.where(mag > 1.0, contracted, x)
        x = x / 4 + 0.5
    return x


@MATERIALS.register("ExplicitMaterial")
class ExplicitMaterial:
    """The colour field on ``device`` (``cuda`` unless the caller asks for
    the CPU); parameters drawn from a CPU generator seeded by ``seed``."""

    @dataclass
    class Config:
        n_output_dims: int = 3
        material_activation: str = "sigmoid"
        pos_encoding_config: dict = field(default_factory=lambda: {
            "otype": "HashGrid",
            "n_levels": 16,
            "n_features_per_level": 2,
            "log2_hashmap_size": 19,
            "base_resolution": 16,
            "per_level_scale": 1.447269237440378,
        })
        mlp_network_config: dict = field(default_factory=lambda: {
            "otype": "VanillaMLP",
            "activation": "ReLU",
            "output_activation": "none",
            "n_neurons": 64,
            "n_hidden_layers": 1,
        })
        seed: int = 0

    def __init__(self, cfg=None, device: DeviceLike = None):
        self.cfg = parse_structured(self.Config, cfg)
        self.device = resolve_device(device)
        self.bbox = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],
                                 device=self.device)
        self.encoding = get_encoding(3, self.cfg.pos_encoding_config)
        self.network = get_mlp(self.encoding.n_output_dims,
                               self.cfg.n_output_dims,
                               self.cfg.mlp_network_config)
        self.activation = get_activation(self.cfg.material_activation)
        gen = torch.Generator().manual_seed(int(self.cfg.seed))
        self.params = {"encoding": self.encoding.init_fn(gen, self.device),
                       "network": self.network.init_fn(gen, self.device)}

    def apply_fn(self, params, positions: torch.Tensor, step: int = 0,
                 grad_u=None, grad_gen=None) -> torch.Tensor:
        """Colours (…,3) at world positions (…,3); ``grad_u`` /
        ``grad_gen`` switch on the encoding's stochastic table gradient
        when the config enables it (the sampled texture loss passes
        them)."""
        x = contract_to_unisphere(positions, self.bbox)
        with span("tssplat.encoding"):
            feats = self.encoding.apply_fn(params["encoding"], x, step,
                                           grad_u=grad_u, grad_gen=grad_gen)
        with span("tssplat.mlp"):
            return self.activation(self.network.apply_fn(
                params["network"], feats))

    def export(self, path: str, folder: str) -> None:
        """``<path>/<folder>/material.npz``, one array per leaf under the
        JAX package's key names (``"['encoding']/['table']"``, ...)."""
        os.makedirs(os.path.join(path, folder), exist_ok=True)
        out = {name: leaf.detach().cpu().numpy() for name, leaf in
               zip(leaf_names(self.params), tree_leaves(self.params))}
        np.savez(os.path.join(path, folder, "material.npz"), **out)

    def load(self, npz_path: str) -> None:
        """Parameters from a ``material.npz`` of either package."""
        data = np.load(npz_path)
        leaves = [torch.as_tensor(data[name], dtype=torch.float32,
                                  device=self.device)
                  for name in leaf_names(self.params)]
        self.params = tree_unflatten(self.params, leaves)
