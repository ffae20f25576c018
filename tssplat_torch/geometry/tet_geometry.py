"""Optimizable tet-mesh geometry (port of ``tssplat_tpu/geometry/
tet_geometry.py``; the multi-sphere class is in ``multisphere.py``).

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

from ..config import GEOMETRIES, parse_structured
from ..device import DeviceLike, resolve_device
from ..mesh.tetmesh import TetMesh
from ..utils import debug
from ..utils.profiling import span
from ..ops.energy import (EnergyOps, build_energy_ops, smooth_barrier_energy,
                          energy_coeff_schedule, barrier_order)


class GeometryStatics(NamedTuple):
    """Static topology + energy operators for one tet mesh."""
    surface_vid: torch.Tensor      # (S,) int64 — tet-vertex ids on the surface
    surface_fid: torch.Tensor      # (Fs,3) int64 — surface tris in surface ids
    edge_nbrs: torch.Tensor        # (Fs,3) int64 — AA edge adjacency (-1 open)
    corner_vid: torch.Tensor       # (3*Fs,) int64 — tet-vertex id per corner
    energy: Optional[EnergyOps]    # None without use_smooth_barrier or optimize_geo
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
        with span("tssplat.energy"):
            c1, c2 = energy_coeff_schedule(it, geom.smooth_coeff,
                                           geom.barrier_coeff)
            order = barrier_order(it, geom.increase_order_iter)
            e = smooth_barrier_energy(tet_v, geom.energy, c1, c2, order)
    else:
        e = torch.zeros((), dtype=tet_v.dtype, device=tet_v.device)
    return GeometryForwardData(v_pos=v_pos, t_pos_idx=geom.surface_fid,
                               energy=e)


def permute_surface_vertices(tet_v: torch.Tensor, surface_vid: torch.Tensor,
                             generator: torch.Generator,
                             dev: float) -> torch.Tensor:
    """Uniform noise in [-dev/2, dev/2) added to the surface vertices,
    outside the gradient path (``permute_surface_vertices``,
    tet_geometry.py:70; reference geometry/tetmesh_geometry.py:176-182).

    The noise is drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``) and then moved to tet_v's device, so the CPU and
    the card perturb alike for one seed. JAX's ``jax.random`` bits cannot
    be reproduced here: this function is held to its contract (only surface
    vertices move, each coordinate by less than dev/2, the same noise for
    the same seed), not to the JAX package's values."""
    noise = torch.rand((surface_vid.shape[0], 3), generator=generator,
                       dtype=tet_v.dtype) * dev - dev * 0.5
    return tet_v.index_add(0, surface_vid, noise.to(tet_v.device))


def compute_vertex_normals(v_pos: torch.Tensor,
                           t_pos_idx: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (``compute_vertex_normals``,
    tet_geometry.py:80): face normals summed into their three vertices,
    +z where the sum is degenerate, then normalized."""
    i0, i1, i2 = t_pos_idx[:, 0], t_pos_idx[:, 1], t_pos_idx[:, 2]
    v0, v1, v2 = v_pos[i0], v_pos[i1], v_pos[i2]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    z = torch.zeros_like(v_pos)
    v_nrm = (z.index_add(0, i0, fn) + z.index_add(0, i1, fn)
             + z.index_add(0, i2, fn))
    sq = torch.sum(v_nrm * v_nrm, dim=-1, keepdim=True)
    with span("tssplat.sync.normals"):       # a host-to-device copy
        up = torch.tensor([0.0, 0.0, 1.0], dtype=v_pos.dtype,
                          device=v_pos.device)
    v_nrm = torch.where(sq > 1e-20, v_nrm, up)
    v_nrm = v_nrm / torch.linalg.norm(v_nrm, dim=-1, keepdim=True)
    debug.check_finite(v_nrm, "vertex_normals")   # ref :63-64 anomaly gate
    return v_nrm


def compute_vertex_tangents(v_pos: torch.Tensor, t_pos_idx: torch.Tensor,
                            v_tex: torch.Tensor, t_tex_idx: torch.Tensor,
                            v_nrm: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Per-vertex tangents from the UVs (``compute_vertex_tangents``,
    tet_geometry.py:99; reference geometry/tetmesh_geometry.py:68-115):
    each triangle's tangent, its UV determinant clamped away from 0 by
    1e-6 with its sign kept, averaged into its vertices, normalized and
    orthonormalized against the vertex normals."""
    if v_nrm is None:
        v_nrm = compute_vertex_normals(v_pos, t_pos_idx)
    pos = [v_pos[t_pos_idx[:, i]] for i in range(3)]
    tex = [v_tex[t_tex_idx[:, i]] for i in range(3)]

    uve1 = tex[1] - tex[0]
    uve2 = tex[2] - tex[0]
    pe1 = pos[1] - pos[0]
    pe2 = pos[2] - pos[0]
    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    denom = torch.where(denom > 0.0, torch.clamp_min(denom, 1e-6),
                        torch.clamp_max(denom, -1e-6))
    tang = nom / denom

    tangents = torch.zeros_like(v_pos)
    tansum = torch.zeros_like(v_pos)
    ones = torch.ones_like(tang)
    for i in range(3):
        idx = t_pos_idx[:, i]
        tangents = tangents + torch.zeros_like(v_pos).index_add(0, idx, tang)
        tansum = tansum + torch.zeros_like(v_pos).index_add(0, idx, ones)
    tangents = tangents / torch.clamp_min(tansum, 1.0)

    def normalize(x):
        return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                                   1e-20)

    tangents = normalize(tangents)
    tangents = normalize(tangents - torch.sum(tangents * v_nrm, -1,
                                              keepdim=True) * v_nrm)
    debug.check_finite(tangents, "vertex_tangents")  # ref :112-113 gate
    return tangents


def statics_to(statics: GeometryStatics, device: DeviceLike
               ) -> GeometryStatics:
    """The same statics with every tensor on ``device``."""
    dev = resolve_device(device)

    def move(nt):
        return nt._replace(**{k: v.to(dev) for k, v in nt._asdict().items()
                              if isinstance(v, torch.Tensor)})

    out = move(statics)
    return out if out.energy is None else out._replace(
        energy=move(out.energy))


class LinearInterpolateScheduler:
    """Fires every ``freq`` iterations from ``start_iter`` on with a
    linearly interpolated value, None otherwise (``LinearInterpolate
    Scheduler``, tet_geometry.py:142; reference trainer.py:18-31, including
    the unclamped extrapolation past end_iter)."""

    def __init__(self, start_iter, end_iter, start_val, end_val, freq):
        self.start_iter = start_iter
        self.end_iter = end_iter
        self.start_val = start_val
        self.end_val = end_val
        self.freq = freq

    def __call__(self, it: int):
        if it < self.start_iter or it % self.freq != 0 or it == 0:
            return None
        p = (it - self.start_iter) / (self.end_iter - self.start_iter)
        return self.start_val * (1 - p) + self.end_val * p


@dataclass
class SmoothBarrierParam:
    smooth_eng_coeff: float = 2e-4
    barrier_coeff: float = 2e-4
    increase_order_iter: int = 1000
    laplacian_weighting: str = "uniform"


@GEOMETRIES.register("TetMeshGeometry")
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
        self.setup()

    def setup(self, smooth_scale: float = 1.0) -> None:
        """Build the statics and tet_v of ``self.tetmesh`` on the device,
        with the smoothness coefficient times ``smooth_scale``
        (1/num_spheres for the multi-sphere geometry, tet_geometry.py:
        199-214); ``reset`` keeps it."""
        self.smooth_scale = smooth_scale
        tetmesh = self.tetmesh
        sb = parse_structured(SmoothBarrierParam,
                              self.cfg.smooth_barrier_param or {})
        dev = self.device
        # a frozen geometry (the texture stage) never evaluates its energy:
        # none is built, so a fitted mesh with an inverted tet loads (JAX
        # builds it anyway and refuses such a mesh)
        energy = build_energy_ops(
            tetmesh, dev, laplacian_weighting=sb.laplacian_weighting) \
            if self.cfg.use_smooth_barrier and self.cfg.optimize_geo \
            else None

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
            smooth_coeff=float(sb.smooth_eng_coeff) * smooth_scale,
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

    def reset(self, vtx_np, elem_np, surface_vid=None,
              surface_fid=None) -> None:
        """Swap in a new mesh and rebuild the statics and tet_v on the
        device, the smoothness scale kept (``reset``, tet_geometry.py:233;
        reference geometry/tetmesh_geometry.py:164-173)."""
        self.tetmesh = TetMesh(vtx_np, elem_np, surface_vid, surface_fid)
        self.setup(self.smooth_scale)

    def remesh(self, edge_length: Optional[float] = None,
               grid_dim: int = 64) -> None:
        """Re-tetrahedralise the volume inside the surface of
        ``self.tetmesh.vtx`` (the caller writes the current positions
        there first) into fresh tets and ``reset`` to them (``remesh``,
        tet_geometry.py:238; ``mesh/remesh.py``); the edge length defaults
        to the median tet edge (each tet's first edge). The optimizer state
        is the caller's to rebuild: the topology changed."""
        from ..mesh.remesh import tet_remesh_from_surface

        if edge_length is None:
            v, e = self.tetmesh.vtx, self.tetmesh.elem
            edge_length = float(np.median(
                np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1)))
        sv, sf = self.tetmesh.surface_mesh()
        self.reset(*tet_remesh_from_surface(sv, sf, edge_length,
                                            grid_dim=grid_dim,
                                            device=self.device))

    def export(self, path: str, filename: str, **kwargs) -> np.ndarray:
        """Save the tet mesh at the current tet_v (``kwargs`` go to
        ``TetMesh.save``); returns tet_v as f64."""
        tet_v = self.tet_v.detach().cpu().double().numpy()
        self.tetmesh.update_vtx_pos(tet_v)
        self.tetmesh.save(path, filename, **kwargs)
        return tet_v
