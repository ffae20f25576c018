"""ctypes binding of the host topology library (``csrc/topology.cpp``).

The library is the port's copy of the JAX package's native topology
passes, so both packages get the same boundary faces, the same tet
adjacency in the same slot order and the same triangle edge pairing, also at
a non-manifold fan edge. It is built at first use with

    g++ -O2 -shared -fPIC -std=c++17 -o build/kernels/libtopology_<hash>.so

(``$CXX`` in place of g++ where it is set), named by a hash of the source
and flags so an edited source is rebuilt. A failed build raises: there is
no quiet fallback to the numpy paths of ``mesh/surface.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
from pathlib import Path

import numpy as np

from .kernels import build

SOURCE = build.CSRC / "topology.cpp"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def cxx_path() -> str:
    """``$CXX``, else g++ on PATH; raises when neither is there."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"topology library: no C++ compiler {cxx!r} on "
                           f"PATH")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build.BUILD_DIR / f"libtopology_{h.hexdigest()[:12]}.so"


@functools.cache
def _library() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        build.compile_all({"topology": ([cxx_path(), *CXX_FLAGS,
                                         str(SOURCE)], out)})
    lib = ctypes.CDLL(str(out))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.tss_surface_faces.restype = ctypes.c_int64
    lib.tss_surface_faces.argtypes = [i64p, ctypes.c_int64, i64p]
    lib.tss_tet_face_neighbors.restype = None
    lib.tss_tet_face_neighbors.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    lib.tss_triangle_edge_neighbors.restype = None
    lib.tss_triangle_edge_neighbors.argtypes = [i64p, ctypes.c_int64, i64p]
    return lib


def surface_faces(tets: np.ndarray) -> np.ndarray:
    """Boundary faces (faces of exactly one tet) in the original vertex
    ids, winding kept, in first-occurrence order: (Fs,3) int64."""
    tets = np.ascontiguousarray(tets, np.int64)
    out = np.empty((4 * tets.shape[0], 3), np.int64)
    n = _library().tss_surface_faces(tets, tets.shape[0], out)
    return out[:n].copy()


def tet_face_neighbors(tets: np.ndarray):
    """``(neighbours (T,4) int64, -1 padded, degree (T,))`` of the tets'
    shared faces, in the hash table's slot order."""
    tets = np.ascontiguousarray(tets, np.int64)
    T = tets.shape[0]
    nbrs = np.empty((T, 4), np.int64)
    degree = np.empty((T,), np.int64)
    _library().tss_tet_face_neighbors(tets, T, nbrs, degree)
    return nbrs, degree


def triangle_edge_neighbors(faces: np.ndarray) -> np.ndarray:
    """(F,3) int64: the triangle across each local edge ((0,1), (1,2),
    (2,0)), -1 on an open boundary; at a fan edge of 3+ triangles the
    first of them pairs with each later one in turn."""
    faces = np.ascontiguousarray(faces, np.int64)
    out = np.empty((faces.shape[0], 3), np.int64)
    _library().tss_triangle_edge_neighbors(faces, faces.shape[0], out)
    return out
