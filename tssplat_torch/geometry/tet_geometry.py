"""Optimizable tet-mesh geometry (port of ``tssplat_tpu/geometry/
tet_geometry.py``, single-sphere path).

The learnable state is a bare ``tet_v`` (N,3) f32 tensor; ``geometry_forward``
is a function of (tet_v, statics, it). All topology (surface gather ids,
the corner layout, AA edge adjacency, energy operators) is built once into
``GeometryStatics`` tensors on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import parse_structured
from ..device import DeviceLike, resolve_device
from ..mesh.tetmesh import TetMesh
from ..ops.energy import (EnergyOps, build_energy_ops, smooth_barrier_energy,
                          energy_coeff_schedule, barrier_order)


class GeometryStatics(NamedTuple):
    """Static topology + energy operators for one tet mesh."""
    surface_vid: torch.Tensor      # (S,) int64 — tet-vertex ids on the surface
    surface_fid: torch.Tensor      # (Fs,3) int64 — surface tris in surface ids
    edge_nbrs: torch.Tensor        # (Fs,3) int64 — AA edge adjacency (-1 open)
    corner_vid: torch.Tensor       # (3*Fs,) int64 — tet-vertex id per corner
    energy: Optional[EnergyOps]    # None when use_smooth_barrier=False
    smooth_coeff: float
    barrier_coeff: float
    increase_order_iter: int


class GeometryForwardData(NamedTuple):
    v_pos: torch.Tensor            # (S,3) surface vertex positions
    t_pos_idx: torch.Tensor        # (Fs,3)
    energy: torch.Tensor           # scalar regularization energy


def geometry_forward(tet_v: torch.Tensor, geom: GeometryStatics,
                     it: int) -> GeometryForwardData:
    """Surface gather + the scheduled energy (coefficient ramp and the
    barrier order switch, reference energies/smooth_barrier.py:47-63)."""
    v_pos = tet_v[geom.surface_vid]
    if geom.energy is not None:
        c1, c2 = energy_coeff_schedule(it, geom.smooth_coeff,
                                       geom.barrier_coeff)
        order = barrier_order(it, geom.increase_order_iter)
        e = smooth_barrier_energy(tet_v, geom.energy, c1, c2, order)
    else:
        e = torch.zeros((), dtype=tet_v.dtype, device=tet_v.device)
    return GeometryForwardData(v_pos=v_pos, t_pos_idx=geom.surface_fid,
                               energy=e)


@dataclass
class SmoothBarrierParam:
    smooth_eng_coeff: float = 2e-4
    barrier_coeff: float = 2e-4
    increase_order_iter: int = 1000
    laplacian_weighting: str = "uniform"


class TetMeshGeometry:
    """Host-side geometry owner: builds statics on ``device`` and holds the
    current ``tet_v`` (reference geometry/tetmesh_geometry.py:118-199)."""

    @dataclass
    class Config:
        use_smooth_barrier: bool = True
        initial_mesh_path: str = ""
        smooth_barrier_param: Optional[dict] = None
        optimize_geo: bool = True

    def __init__(self, cfg=None, tetmesh: Optional[TetMesh] = None,
                 device: DeviceLike = None):
        self.cfg = parse_structured(self.Config, cfg)
        self.device = resolve_device(device)
        if tetmesh is None:
            if not self.cfg.initial_mesh_path:
                raise ValueError("TetMeshGeometry needs initial_mesh_path or "
                                 "tetmesh")
            path = self.cfg.initial_mesh_path
            if os.path.isdir(path):
                path = os.path.join(path, "final.veg")
            tetmesh = TetMesh.from_veg(path)
        self.tetmesh = tetmesh
        sb = parse_structured(SmoothBarrierParam,
                              self.cfg.smooth_barrier_param or {})
        dev = self.device
        energy = build_energy_ops(
            tetmesh, dev, laplacian_weighting=sb.laplacian_weighting) \
            if self.cfg.use_smooth_barrier else None

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=dev)

        self.statics = GeometryStatics(
            surface_vid=i64(tetmesh.surface_vid),
            surface_fid=i64(tetmesh.surface_fid),
            edge_nbrs=i64(tetmesh.surface_edge_neighbors()),
            corner_vid=i64(tetmesh.surface_vid[tetmesh.surface_fid]
                           .reshape(-1)),
            energy=energy,
            smooth_coeff=float(sb.smooth_eng_coeff),
            barrier_coeff=float(sb.barrier_coeff),
            increase_order_iter=int(sb.increase_order_iter))
        self.tet_v = torch.as_tensor(tetmesh.vtx, dtype=torch.float32,
                                     device=dev)

    @property
    def optimize_geo(self) -> bool:
        return self.cfg.optimize_geo

    def forward(self, it: int = 0) -> GeometryForwardData:
        return geometry_forward(self.tet_v, self.statics, it)

    __call__ = forward

    def set_tet_v(self, tet_v) -> None:
        self.tet_v = torch.as_tensor(tet_v, dtype=torch.float32,
                                     device=self.device)

    def export(self, path: str, filename: str) -> None:
        self.tetmesh.update_vtx_pos(self.tet_v.detach().cpu().double().numpy())
        self.tetmesh.save(path, filename)
