"""TetMesh: the host-side tetrahedral mesh container (numpy).

The port's own copy of ``tssplat_tpu/mesh/tetmesh.py``: rest vertices +
connectivity, the boundary surface, rest-shape inverse edge matrices, tet
face adjacency and surface-triangle edge adjacency, the surface's UV atlas
(chart-based, or the trivial per-triangle one), and .veg/.obj persistence
(reference geometry/tetrahedron_mesh.py:27-91).
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


def trivial_uv_atlas(faces: np.ndarray, border: float = 0.002):
    """Per-triangle UV atlas on a square grid (``trivial_uv_atlas``,
    tetmesh.py:43): each triangle an isolated right triangle in its own
    cell. Returns (uv (3F,2) float32, uv_faces (F,3) int64, uv_vid (3F,)
    int64, the mesh vertex of each UV vertex)."""
    F = faces.shape[0]
    n = int(np.ceil(np.sqrt(F)))
    cell = 1.0 / n
    tri = np.arange(F)
    cx = (tri % n).astype(np.float64) * cell
    cy = (tri // n).astype(np.float64) * cell
    b, s = border, cell - 2 * border
    uv = np.zeros((F, 3, 2), dtype=np.float64)
    uv[:, 0] = np.stack([cx + b, cy + b], axis=1)
    uv[:, 1] = np.stack([cx + b + s, cy + b], axis=1)
    uv[:, 2] = np.stack([cx + b, cy + b + s], axis=1)
    uv_faces = np.arange(3 * F, dtype=np.int64).reshape(F, 3)
    return (uv.reshape(-1, 2).astype(np.float32), uv_faces,
            faces.reshape(-1).astype(np.int64))


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

    @classmethod
    def from_npy(cls, vtx_path: str, elem_path: str) -> "TetMesh":
        """The mesh of a vertex array (N,3) and a tet array (T,4), each an
        .npy file (``TetMesh.from_npy``, tetmesh.py:96)."""
        return cls(np.load(vtx_path), np.load(elem_path))

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

    def uv_atlas(self):
        """(uv (U,2) in [0,1], uv_faces (F,3), uv_vid (U,) surface vertex of
        each UV vertex) of the surface at the current vertices, cached:
        the chart-based LSCM atlas (``mesh/uv.py``, the reference's
        xatlas), or, as the JAX package does when the chart pipeline
        raises, the trivial per-triangle atlas. Prints which was taken."""
        if "uv" not in self._cache:
            try:
                from .uv import chart_uv_atlas
                atlas = chart_uv_atlas(self.vtx[self.surface_vid],
                                       self.surface_fid)
                print(f"uv atlas: charts, {atlas[0].shape[0]} uv vertices",
                      flush=True)
            except Exception as e:
                atlas = trivial_uv_atlas(self.surface_fid)
                print(f"uv atlas: the chart atlas failed ({e!r}); the "
                      f"trivial per-triangle atlas is taken", flush=True)
            self._cache["uv"] = atlas
        return self._cache["uv"]

    def update_vtx_pos(self, vtx: np.ndarray) -> None:
        self.vtx = np.asarray(vtx, dtype=np.float64).reshape(-1, 3).copy()

    def surface_mesh(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vtx[self.surface_vid], self.surface_fid

    def save_surface_mesh(self, path: str,
                          filename: str = "surface_mesh.obj") -> None:
        """The boundary surface at the current vertices as ``path/filename``
        (OBJ)."""
        os.makedirs(path, exist_ok=True)
        sv, sf = self.surface_mesh()
        save_obj(os.path.join(path, filename), sv, sf)

    def save(self, path: str, filename: str = "tet_mesh",
             save_surface_mesh: bool = True, save_npy: bool = False) -> None:
        """Persist as .veg (+ surface .obj, + ``_vtx.npy`` / ``_elem.npy``):
        the reference's artifact set (geometry/tetrahedron_mesh.py:82-91)."""
        os.makedirs(path, exist_ok=True)
        save_veg(os.path.join(path, filename + ".veg"), self.vtx, self.elem,
                 E=self.E, nu=self.nu, density=self.density)
        if save_surface_mesh:
            self.save_surface_mesh(path, filename + "_surface_mesh.obj")
        if save_npy:
            np.save(os.path.join(path, filename + "_vtx.npy"), self.vtx)
            np.save(os.path.join(path, filename + "_elem.npy"), self.elem)
