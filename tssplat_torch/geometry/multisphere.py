"""Multi-sphere tet geometry: the config-selected geometry of the pipeline
(port of ``tssplat_tpu/geometry/multisphere.py:37-272``; reference
TetMeshMultiSphereGeometry, geometry/tetmesh_geometry.py:200-382).

Init paths, as in the JAX package:
  A (fresh): read the key-points JSON {pt, r}; per sphere, a tet ball at
     the target edge length (``tet_sphere``, the native Delaunay ball, or
     a TetWild process on the template sphere);
     concatenate the spheres with vertex offsets into one disjoint tet
     mesh; persist final_tet_v/t.npy in the cache folder and the per-sphere
     index JSONs in <output_path>/final and the cache folder.
  B (precomputed): load final_tet_v/t.npy + the index JSONs.
  C (resume): initial_mesh_path -> final.veg + the index JSONs.

The smoothness coefficient is scaled by 1/num_spheres, and the target edge
length comes from the smallest radius so every sphere gets >= ~100 surface
triangles, clamped to [0.015, 0.03]. Where ``tetwild_exec`` names an
existing file, path A meshes each sphere with that TetWild executable
instead (``_tetwild_spheres``), one process per sphere, all at once.
``export`` also writes the per-sphere vertex/element arrays and the index
JSONs (reference :373-382). ``remesh`` re-derives the per-sphere partition
on the new tets (``repartition_spheres``) and keeps the 1/num_spheres
smoothness scale.

The skeleton geometry (``TetMeshSkeletonGeometry``, also registered as
``TetMeshFish``) builds one tet capsule per skeleton edge and shares that
bookkeeping.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
from dataclasses import dataclass

import numpy as np

from ..config import GEOMETRIES, parse_structured
from ..device import DeviceLike, resolve_device
from ..mesh.io import save_obj
from ..mesh.spheres import load_template_sphere, tet_capsule, tet_sphere
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


def _vertex_sphere_ids(all_vtx_idx, n_vertices: int) -> np.ndarray:
    """Vertex -> sphere id (-1 for none) from the per-sphere vertex lists;
    where lists overlap (after a remesh) the first sphere wins
    (``_vertex_sphere_ids``, multisphere.py:66)."""
    sid = np.full(n_vertices, -1, np.int64)
    for s, vid in enumerate(all_vtx_idx):
        v = np.asarray(vid, np.int64)
        fresh = sid[v] < 0
        sid[v[fresh]] = s
    return sid


def repartition_spheres(old_vtx, old_sid, new_vtx, new_elem):
    """The per-sphere bookkeeping on a remeshed topology
    (``repartition_spheres``, multisphere.py:78): each new tet goes to the
    sphere of the old (deformed) vertex nearest its centroid (an unassigned
    one to sphere 0); a sphere's vertex list is the sorted union of its
    tets' vertices and its elem list those tets in local indices of that
    list. Tets, not vertices, partition: neighbouring spheres may share
    boundary vertices. Returns (vtx_idx lists, elem_idx lists)."""
    from scipy.spatial import cKDTree

    new_elem = np.asarray(new_elem, np.int64)
    cent = np.asarray(new_vtx, np.float64)[new_elem].mean(axis=1)
    _, nn = cKDTree(np.asarray(old_vtx, np.float64)).query(cent)
    sid = np.maximum(old_sid[nn], 0)
    n_s = int(old_sid.max()) + 1 if old_sid.size else 0
    vtx_idx, elem_idx = [], []
    for s in range(n_s):
        ts = new_elem[sid == s]
        vs = np.unique(ts)
        vtx_idx.append(vs.tolist())
        elem_idx.append(np.searchsorted(vs, ts).tolist())
    return vtx_idx, elem_idx


def _tetwild_spheres(key_pts, key_r, edge_len, template_path, tetwild_exec,
                     cache_folder):
    """Path A through a TetWild executable (``_tetwild_spheres``,
    multisphere.py:155; reference geometry/tetmesh_geometry.py:271-315):
    per sphere, the template surface (``load_template_sphere``) scaled by
    its radius and moved to its centre is written as ``temp{i}.obj`` in
    the cache folder, and one process per sphere, all started together,
    tetrahedralises it (a TetWild fork that writes ``temp{i}.msh_VO.npy``
    and ``temp{i}.msh_TO.npy``). ``edge_len`` is not passed: the
    reference asks for the template's vertex count instead. Returns the
    per-sphere (verts f64, tets int64) in the order of the spheres.

    Unlike the JAX package, which ignores how a process ends, a process
    that exits non-zero or leaves an output missing raises, naming its
    command; nothing falls back to the native spheres."""
    os.makedirs(cache_folder, exist_ok=True)
    tv, tf = load_template_sphere(template_path)
    cmds = []
    for i, (c, r) in enumerate(zip(key_pts, key_r)):
        sv = tv * r + c
        obj = os.path.join(cache_folder, f"temp{i}.obj")
        save_obj(obj, sv, tf)
        out = os.path.join(cache_folder, f"temp{i}.msh")
        cmds.append([tetwild_exec, "--input", obj, "--output", out,
                     "--targeted-num-v", str(sv.shape[0]), "--epsilon",
                     "0.001", "--is-quiet"])
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd))
        codes = [p.wait() for p in procs]
    finally:                     # none left running if one fails to start
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    parts = []
    for i, (cmd, code) in enumerate(zip(cmds, codes)):
        if code != 0:
            raise RuntimeError(f"TetWild exited with {code}: {' '.join(cmd)}")
        arrays = []
        for suffix in ("_VO.npy", "_TO.npy"):
            path = os.path.join(cache_folder, f"temp{i}.msh{suffix}")
            if not os.path.exists(path):
                raise RuntimeError(f"TetWild wrote no {path}: "
                                   f"{' '.join(cmd)}")
            arrays.append(np.load(path))
        parts.append((arrays[0].astype(np.float64),
                      arrays[1].astype(np.int64)))
    return parts


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


class _SphereBookkeepingMixin:
    """The per-sphere partition of the multi-sphere and skeleton
    geometries (``_SphereBookkeepingMixin``, multisphere.py:109-150):
    ``num_spheres``, the partition re-derived after a remesh, and the
    per-sphere exports. The class sets ``all_spheres_vtx_idx`` and
    ``all_spheres_elem_idx`` before ``setup``."""

    @property
    def num_spheres(self) -> int:
        return len(self.all_spheres_vtx_idx)

    def remesh(self, *args, **kwargs) -> None:
        """``TetMeshGeometry.remesh``, then the partition re-derived on the
        new tets from the deformed vertices' spheres. The 1/num_spheres
        scale is an init-time constant of the objective (reference
        geometry/tetmesh_geometry.py:242-243) and is kept, so the loss
        stays continuous where spheres merged."""
        old_vtx = np.asarray(self.tetmesh.vtx, np.float64)
        old_sid = _vertex_sphere_ids(self.all_spheres_vtx_idx,
                                     self.tetmesh.num_vertices)
        super().remesh(*args, **kwargs)
        self.all_spheres_vtx_idx, self.all_spheres_elem_idx = \
            repartition_spheres(old_vtx, old_sid, self.tetmesh.vtx,
                                self.tetmesh.elem)

    def export(self, path: str, filename: str, **kwargs) -> None:
        """The tet mesh (``kwargs`` go to ``TetMesh.save``), plus per sphere
        its vertices and local elements as npy, and the index JSONs that
        init path C reads."""
        tet_v = super().export(path, filename, **kwargs)
        for i, vid in enumerate(self.all_spheres_vtx_idx):
            np.save(os.path.join(path, f"{filename}_sp{i}_vtx.npy"),
                    tet_v[np.asarray(vid, np.int64), :])
            np.save(os.path.join(path, f"{filename}_sp{i}_elem.npy"),
                    np.asarray(self.all_spheres_elem_idx[i]))
        _write_json(os.path.join(path, "spheres_vtx_idx.json"),
                    [list(map(int, v)) for v in self.all_spheres_vtx_idx])
        _write_json(os.path.join(path, "spheres_elem_idx.json"),
                    self.all_spheres_elem_idx)


@GEOMETRIES.register("TetMeshMultiSphereGeometry")
class TetMeshMultiSphereGeometry(_SphereBookkeepingMixin, TetMeshGeometry):
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
                    parts = _tetwild_spheres(pts, radii, edge_len,
                                             c.template_surface_sphere_path,
                                             c.tetwild_exec, cache)
                else:
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


@GEOMETRIES.register("TetMeshFish")
@GEOMETRIES.register("TetMeshSkeletonGeometry")
class TetMeshSkeletonGeometry(_SphereBookkeepingMixin, TetMeshGeometry):
    """Skeleton-edge sweep geometry (``TetMeshSkeletonGeometry``,
    multisphere.py:276; reference geometry/tetmesh_fish.py:38-132, which
    sweeps spheres along the edges with pypgo and TetWild): one tet capsule
    per skeleton edge, concatenated, each edge a "sphere" of the partition.
    The key-point JSON holds ``centers`` [[p0, p1], ...] and ``radii``
    [[r0, r1], ...], one pair per edge."""

    @dataclass
    class Config(TetMeshGeometry.Config):
        key_points_file_path: str = ""
        output_path: str = "."
        debug_mode: bool = False

    def __init__(self, cfg=None, device: DeviceLike = None):
        self.cfg = parse_structured(self.Config, cfg)
        self.device = resolve_device(device)
        c = self.cfg
        skel = _read_json(c.key_points_file_path)
        centers = np.asarray(skel["centers"], np.float64)
        radii = np.asarray(skel["radii"], np.float64)
        edge_len = target_edge_length(float(radii.min()))
        parts = [tet_capsule(edge_len, p0=centers[i, 0], p1=centers[i, 1],
                             r0=float(radii[i, 0]), r1=float(radii[i, 1]))
                 for i in range(centers.shape[0])]
        v, t, self.all_spheres_vtx_idx, self.all_spheres_elem_idx = \
            _concat_spheres(parts)
        self.tetmesh = TetMesh(v, t)
        self.setup(smooth_scale=1.0 / max(len(self.all_spheres_vtx_idx), 1))
        if c.debug_mode:
            self.tetmesh.save("debug", "debug_skeleton",
                              save_surface_mesh=True)
