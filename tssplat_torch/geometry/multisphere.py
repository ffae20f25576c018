"""Multi-sphere tet geometry: the config-selected geometry of the pipeline
(port of ``tssplat_tpu/geometry/multisphere.py:37-272``; reference
TetMeshMultiSphereGeometry, geometry/tetmesh_geometry.py:200-382).

Init paths, as in the JAX package:
  A (fresh): read the key-points JSON {pt, r}; per sphere, a tet ball at
     the target edge length (``tet_sphere``, the native Delaunay ball);
     concatenate the spheres with vertex offsets into one disjoint tet
     mesh; persist final_tet_v/t.npy in the cache folder and the per-sphere
     index JSONs in <output_path>/final and the cache folder.
  B (precomputed): load final_tet_v/t.npy + the index JSONs.
  C (resume): initial_mesh_path -> final.veg + the index JSONs.

The smoothness coefficient is scaled by 1/num_spheres, and the target edge
length comes from the smallest radius so every sphere gets >= ~100 surface
triangles, clamped to [0.015, 0.03]. The TetWild subprocess path of the
JAX package is not ported: configuring an existing ``tetwild_exec`` raises.
``export`` also writes the per-sphere vertex/element arrays and the index
JSONs (reference :373-382).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

from ..config import parse_structured
from ..device import DeviceLike, resolve_device
from ..mesh.spheres import tet_sphere
from ..mesh.tetmesh import TetMesh
from .tet_geometry import TetMeshGeometry


def target_edge_length(min_radius: float, min_n_triangles: int = 100,
                       edge_length_wrt_bb: float = 0.03,
                       edge_length_min: float = 0.015) -> float:
    """Edge length so the smallest sphere gets >= min_n_triangles surface
    triangles, clamped to [edge_length_min, edge_length_wrt_bb]
    (reference: geometry/tetmesh_geometry.py:251-266)."""
    min_surface_area = min_radius * min_radius * math.pi
    min_triangle_area = min_surface_area / min_n_triangles
    edge_wrt_tris = math.sqrt(min_triangle_area * 4.0 / math.sqrt(3.0))
    return max(edge_length_min, min(edge_length_wrt_bb, edge_wrt_tris))


def _concat_spheres(parts):
    """Concatenate per-sphere (verts, tets) with vertex-index offsets into one
    disjoint mesh. Returns (v, t, vtx_idx_lists, elem_lists); elem lists are
    in *local* (per-sphere) vertex indices (reference :305-340)."""
    all_v, all_t, vtx_idx, elem_idx = [], [], [], []
    base = 0
    for (v, t) in parts:
        all_v.append(np.asarray(v, np.float64))
        all_t.append(np.asarray(t, np.int64) + base)
        vtx_idx.append(list(range(base, base + v.shape[0])))
        elem_idx.append(np.asarray(t, np.int64).tolist())
        base += v.shape[0]
    return (np.concatenate(all_v, axis=0), np.concatenate(all_t, axis=0),
            vtx_idx, elem_idx)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


class TetMeshMultiSphereGeometry(TetMeshGeometry):
    """Disjoint union of tet spheres from key points (paths A, B, C above),
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""

    @dataclass
    class Config(TetMeshGeometry.Config):
        template_surface_sphere_path: str = ""
        key_points_file_path: str = ""
        tetwild_exec: str = ""
        tetwild_cache_folder: str = ".tetwild_cache"
        load_precomputed_tetwild_mesh: bool = False
        output_path: str = "."
        debug_mode: bool = False

    def __init__(self, cfg=None, device: DeviceLike = None):
        self.cfg = parse_structured(self.Config, cfg)
        self.device = resolve_device(device)
        c = self.cfg

        if c.initial_mesh_path:
            # Path C: resume from a previous run's artifacts.
            tetmesh = TetMesh.from_veg(os.path.join(c.initial_mesh_path,
                                                    "final.veg"))
            vtx_idx = _read_json(os.path.join(c.initial_mesh_path,
                                              "spheres_vtx_idx.json"))
            elem_idx = _read_json(os.path.join(c.initial_mesh_path,
                                               "spheres_elem_idx.json"))
        else:
            cache = c.tetwild_cache_folder
            final_dir = os.path.join(c.output_path, "final")
            os.makedirs(final_dir, exist_ok=True)
            if c.load_precomputed_tetwild_mesh:
                # Path B; the index JSONs from the run's final dir, else the
                # copies path A wrote next to the cached arrays
                v = np.load(os.path.join(cache, "final_tet_v.npy"))
                t = np.load(os.path.join(cache, "final_tet_t.npy"))
                src = final_dir if os.path.exists(
                    os.path.join(final_dir, "spheres_vtx_idx.json")) else cache
                vtx_idx = _read_json(os.path.join(src, "spheres_vtx_idx.json"))
                elem_idx = _read_json(os.path.join(src,
                                                   "spheres_elem_idx.json"))
            else:
                # Path A: fresh build from key points.
                skel = _read_json(c.key_points_file_path)
                pts = np.asarray(skel["pt"], np.float64).reshape(-1, 3)
                radii = np.asarray(skel["r"], np.float64).reshape(-1)
                edge_len = target_edge_length(float(radii.min()))
                if c.tetwild_exec and c.tetwild_exec.lower() not in (
                        "none", "null") and os.path.exists(c.tetwild_exec):
                    raise NotImplementedError(
                        "the TetWild subprocess path is not ported; leave "
                        "tetwild_exec empty to mesh the spheres natively")
                parts = [tet_sphere(edge_len, radius=float(r), center=p)
                         for p, r in zip(pts, radii)]
                v, t, vtx_idx, elem_idx = _concat_spheres(parts)
                os.makedirs(cache, exist_ok=True)
                np.save(os.path.join(cache, "final_tet_v.npy"), v)
                np.save(os.path.join(cache, "final_tet_t.npy"), t)
                for d in (final_dir, cache):
                    _write_json(os.path.join(d, "spheres_vtx_idx.json"),
                                vtx_idx)
                    _write_json(os.path.join(d, "spheres_elem_idx.json"),
                                elem_idx)
            tetmesh = TetMesh(v, t)

        self.all_spheres_vtx_idx = vtx_idx
        self.all_spheres_elem_idx = elem_idx
        self.tetmesh = tetmesh
        self.setup(smooth_scale=1.0 / max(len(vtx_idx), 1))
        if c.debug_mode:
            self.tetmesh.save("debug", "debug_multi_spheres",
                              save_surface_mesh=True)

    @property
    def num_spheres(self) -> int:
        return len(self.all_spheres_vtx_idx)

    def export(self, path: str, filename: str) -> None:
        """The tet mesh, plus per sphere its vertices and local elements as
        npy, and the index JSONs that init path C reads."""
        tet_v = super().export(path, filename)
        for i, vid in enumerate(self.all_spheres_vtx_idx):
            np.save(os.path.join(path, f"{filename}_sp{i}_vtx.npy"),
                    tet_v[np.asarray(vid, np.int64), :])
            np.save(os.path.join(path, f"{filename}_sp{i}_elem.npy"),
                    np.asarray(self.all_spheres_elem_idx[i]))
        _write_json(os.path.join(path, "spheres_vtx_idx.json"),
                    [list(map(int, v)) for v in self.all_spheres_vtx_idx])
        _write_json(os.path.join(path, "spheres_elem_idx.json"),
                    self.all_spheres_elem_idx)
