"""Mesh file IO: Vega ``.veg`` tet meshes and Wavefront ``.obj`` surfaces.

TPU-native replacement for the libpgo-backed load/save path
(reference: geometry/tetrahedron_mesh.py:14-24,82-91 uses
pypgo.create_tetmesh_from_file / save_tetmesh_to_file) and for the manual
OBJ/MTL writers (reference: utils/save.py:8-123). The .veg text format is
plain (see the reference example tssplat_ext/a.veg): ``*VERTICES`` header
``<n> 3 0 0`` with 1-based indexed rows, ``*ELEMENTS TET`` header
``<m> 4 0`` with 1-based connectivity, optional ``*MATERIAL``/``*SET``
blocks which we emit for compatibility and skip on read.

The port's own copy of ``tssplat_tpu/mesh/io.py`` (numpy only).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def load_veg(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a Vega .veg tet mesh → (vertices (N,3) float64, tets (T,4) int64)."""
    verts = []
    tets = []
    section = None
    seen_header = False
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("*"):
                tok = line[1:].strip().upper()
                if tok.startswith("VERTICES"):
                    section, seen_header = "verts", False
                elif tok.startswith("ELEMENTS"):
                    section, seen_header = "elems", False
                else:
                    section = None
                continue
            if section == "elems" and not seen_header and line.upper() in (
                    "TET", "TETS", "TETRAHEDRA", "TETRAHEDRON"):
                continue  # element-type tag line between *ELEMENTS and the count header
            parts = line.split()
            if not seen_header:
                seen_header = True  # count header line: "<n> <dim> ..."
                continue
            if section == "verts" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif section == "elems" and len(parts) >= 5:
                tets.append([int(parts[1]) - 1, int(parts[2]) - 1,
                             int(parts[3]) - 1, int(parts[4]) - 1])
    return np.asarray(verts, dtype=np.float64), np.asarray(tets, dtype=np.int64)


def save_veg(path: str, verts: np.ndarray, tets: np.ndarray,
             E: float = 1e5, nu: float = 0.45, density: float = 1000.0) -> None:
    """Write a Vega .veg tet mesh with a single ENU material block.

    Material constants default to the reference's fixed values
    (geometry/tetrahedron_mesh.py:30-32).
    """
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tets = np.asarray(tets, dtype=np.int64).reshape(-1, 4)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# Vega mesh file.\n")
        f.write(f"# {len(verts)} vertices, {len(tets)} elements\n\n")
        f.write("*VERTICES\n")
        f.write(f"{len(verts)} 3 0 0\n")
        for i, v in enumerate(verts):
            f.write(f"{i + 1} {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        f.write("\n*ELEMENTS\nTET\n")
        f.write(f"{len(tets)} 4 0\n")
        for i, t in enumerate(tets):
            f.write(f"{i + 1} {t[0] + 1} {t[1] + 1} {t[2] + 1} {t[3] + 1}\n")
        f.write("\n*MATERIAL defaultMaterial\n")
        f.write(f"ENU, {density:.17g}, {E:.17g}, {nu:.17g}\n")
        f.write("\n*REGION\nallElements, defaultMaterial\n")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader → (vertices (N,3) float64, faces (F,3) int64).

    Polygon faces are fan-triangulated; texture/normal indices are ignored.
    """
    verts = []
    faces = []
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             vertex_colors: Optional[np.ndarray] = None,
             uvs: Optional[np.ndarray] = None,
             uv_faces: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None,
             mtllib: Optional[str] = None,
             matname: Optional[str] = None) -> None:
    """OBJ writer supporting vertex colors (xyzrgb rows), UVs and normals.

    Covers the export capabilities of the reference's manual writer
    (utils/save.py:8-51) and its trimesh vertex-color export
    (renderers/mesh_rasterizer.py:222-225).
    """
    verts = np.asarray(verts).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if mtllib:
            f.write(f"mtllib {mtllib}\n")
        if matname:
            f.write(f"usemtl {matname}\n")
        if vertex_colors is not None:
            vc = np.asarray(vertex_colors).reshape(-1, 3)
            for v, c in zip(verts, vc):
                f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g} "
                        f"{c[0]:.6g} {c[1]:.6g} {c[2]:.6g}\n")
        else:
            for v in verts:
                f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        if uvs is not None:
            for t in np.asarray(uvs).reshape(-1, 2):
                f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if normals is not None:
            for n in np.asarray(normals).reshape(-1, 3):
                f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        has_uv = uvs is not None and uv_faces is not None
        uvf = np.asarray(uv_faces, dtype=np.int64).reshape(-1, 3) if has_uv else None
        for i, tri in enumerate(faces):
            if has_uv:
                a, b, c = tri + 1
                ta, tb, tc = uvf[i] + 1
                f.write(f"f {a}/{ta} {b}/{tb} {c}/{tc}\n")
            else:
                a, b, c = tri + 1
                f.write(f"f {a} {b} {c}\n")


def save_mtl(path: str, matname: str,
             texture_maps: Optional[Dict[str, str]] = None,
             kd=(1.0, 1.0, 1.0), ks=(0.0, 0.0, 0.0)) -> None:
    """MTL writer with optional texture map references (``save_mtl``,
    io.py:149; reference utils/save.py:54-123)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"newmtl {matname}\n")
        f.write("illum 2\n")
        f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
        f.write(f"Ks {ks[0]} {ks[1]} {ks[2]}\n")
        for key, fname in (texture_maps or {}).items():
            f.write(f"{key} {fname}\n")
