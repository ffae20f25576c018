"""TetMesh: the host-side tetrahedral mesh container (numpy).

The port's own copy of ``tssplat_tpu/mesh/tetmesh.py`` without the UV
atlas: rest vertices + connectivity, the boundary surface, rest-shape
inverse edge matrices, tet face adjacency and surface-triangle edge
adjacency, and .veg/.obj persistence (reference
geometry/tetrahedron_mesh.py:27-91).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .io import load_veg, save_veg, save_obj
from .surface import get_surface_vf, tet_face_neighbors, triangle_edge_neighbors


def tet_rest_matrices(verts: np.ndarray, tets: np.ndarray):
    """Per-tet rest edge matrix inverse and volume: dX = [v1-v0, v2-v0,
    v3-v0] as columns; returns (dX_inv (T,3,3) float64, volume (T,))."""
    v = verts[tets]                      # (T,4,3)
    dX = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]],
                  axis=2)                # columns
    vol = np.linalg.det(dX) / 6.0
    dX_inv = np.linalg.inv(dX)
    return dX_inv, vol


@dataclass
class TetMesh:
    vtx_init: np.ndarray                 # (N,3) float rest positions
    elem: np.ndarray                     # (T,4) int tets
    surface_vid: np.ndarray = field(default=None)  # (S,) vert ids on surface
    surface_fid: np.ndarray = field(default=None)  # (Fs,3) in surface ids
    # fixed material constants, kept for .veg parity
    E: float = 1e5
    nu: float = 0.45
    density: float = 1000.0

    def __post_init__(self):
        self.vtx_init = np.asarray(self.vtx_init, dtype=np.float64).reshape(-1, 3)
        self.elem = np.asarray(self.elem, dtype=np.int64).reshape(-1, 4)
        if self.surface_vid is None or self.surface_fid is None:
            self.surface_vid, self.surface_fid = get_surface_vf(self.elem)
        else:
            self.surface_vid = np.asarray(self.surface_vid, dtype=np.int64)
            self.surface_fid = np.asarray(self.surface_fid, dtype=np.int64)
        self.vtx = self.vtx_init.copy()
        self._cache: dict = {}

    @classmethod
    def from_veg(cls, path: str) -> "TetMesh":
        v, t = load_veg(path)
        return cls(v, t)

    @property
    def num_vertices(self) -> int:
        return self.vtx_init.shape[0]

    @property
    def num_tets(self) -> int:
        return self.elem.shape[0]

    def rest_matrices(self):
        if "rest" not in self._cache:
            self._cache["rest"] = tet_rest_matrices(self.vtx_init, self.elem)
        return self._cache["rest"]

    def tet_neighbors(self):
        if "tet_nbrs" not in self._cache:
            self._cache["tet_nbrs"] = tet_face_neighbors(self.elem)
        return self._cache["tet_nbrs"]

    def surface_edge_neighbors(self):
        if "edge_nbrs" not in self._cache:
            self._cache["edge_nbrs"] = triangle_edge_neighbors(self.surface_fid)
        return self._cache["edge_nbrs"]

    def update_vtx_pos(self, vtx: np.ndarray) -> None:
        self.vtx = np.asarray(vtx, dtype=np.float64).reshape(-1, 3).copy()

    def surface_mesh(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vtx[self.surface_vid], self.surface_fid

    def save(self, path: str, filename: str = "tet_mesh",
             save_surface_mesh: bool = True, save_npy: bool = False) -> None:
        """Persist as .veg (+ surface .obj, + ``_vtx.npy`` / ``_elem.npy``):
        the reference's artifact set (geometry/tetrahedron_mesh.py:82-91)."""
        os.makedirs(path, exist_ok=True)
        save_veg(os.path.join(path, filename + ".veg"), self.vtx, self.elem,
                 E=self.E, nu=self.nu, density=self.density)
        if save_surface_mesh:
            sv, sf = self.surface_mesh()
            save_obj(os.path.join(path, filename + "_surface_mesh.obj"), sv, sf)
        if save_npy:
            np.save(os.path.join(path, filename + "_vtx.npy"), self.vtx)
            np.save(os.path.join(path, filename + "_elem.npy"), self.elem)
