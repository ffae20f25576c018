"""Surface topology utilities for tetrahedral meshes.

The port of ``tssplat_tpu/mesh/surface.py``: boundary-surface extraction
(reference geometry/mesh_utils.py:5-35), triangle edge adjacency for the
antialias pass and tet face adjacency for the energy Laplacian. Each takes
the host topology library (``native.py``, the hash-table passes of
``csrc/topology.cpp``) by default, as the JAX package does, and its numpy
sort path with ``use_native=False``. The two agree except where a choice
is arbitrary: the slot order of the tet neighbours, and which triangle of
a non-manifold fan edge an entry names. The library makes those choices
as the JAX package's does, so after a remesh (whose surfaces have fan
edges) both packages suppress the same antialias pairs.
"""

from __future__ import annotations

import numpy as np

from .. import native

# Local faces of a tet (i0,i1,i2,i3) with outward winding, matching the
# boundary-face convention of the reference extractor
# (geometry/mesh_utils.py:7-13).
_TET_FACES = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int64)


def get_surface_vf(tets: np.ndarray, use_native: bool = True):
    """Boundary surface of a tet mesh: ``(surface_vertices, surface_faces)``.

    Sorted original vertex ids on the boundary, and boundary triangles
    remapped to compact surface vertex indices in first-occurrence order,
    outward winding preserved (both paths give the same arrays)."""
    tets = np.asarray(tets)
    if use_native:
        surface_tris_orig = native.surface_faces(tets)
    else:
        org_tris = tets[:, _TET_FACES].reshape(-1, 3)  # winding preserved
        key = np.sort(org_tris, axis=1)
        # faces appearing exactly once are boundary faces
        _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                   return_counts=True)
        surface_tris_orig = org_tris[counts[inv.reshape(-1)] == 1]

    surface_vertices = np.unique(surface_tris_orig)
    remap = np.full(int(tets.max()) + 1, -1, dtype=np.int64)
    remap[surface_vertices] = np.arange(surface_vertices.shape[0])
    mapped = remap[surface_tris_orig]
    return surface_vertices.astype(np.int64), mapped.astype(np.int64)


def triangle_edge_neighbors(faces: np.ndarray,
                            use_native: bool = True) -> np.ndarray:
    """(F,3) edge-adjacent triangle table: ``out[t, e]`` is the other
    triangle sharing local edge ``e`` ((0,1),(1,2),(2,0)) of ``t``, or -1 on
    an open boundary. At a non-manifold edge each path names a genuine
    neighbour, not the same one: the library pairs the fan's first triangle
    with each later one, the numpy path consecutive ones in sorted order
    (the AA pass only uses the entry to suppress blending across interior
    edges)."""
    faces = np.asarray(faces, dtype=np.int64)
    if use_native:
        return native.triangle_edge_neighbors(faces)
    F = faces.shape[0]
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)       # (3F, 2)
    tri_of_edge = np.tile(np.arange(F), 3)
    key = np.sort(edges, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    key_s = key[order]
    tri_s = tri_of_edge[order]
    slot_s = order // F                                      # local edge slot

    out = np.full((F, 3), -1, dtype=np.int64)
    same = np.all(key_s[1:] == key_s[:-1], axis=1)
    a = np.nonzero(same)[0]
    b = a + 1
    out[tri_s[a], slot_s[a]] = tri_s[b]
    out[tri_s[b], slot_s[b]] = tri_s[a]
    return out


def tet_face_neighbors(tets: np.ndarray, use_native: bool = True):
    """Face adjacency of tets: ``(neighbors (T,4) int64 with -1 padding,
    degree (T,))``. Two tets are adjacent iff they share a triangle; this
    adjacency defines the tet-graph Laplacian of the smoothness energy. The
    paths give the same neighbour sets in another slot order (the library's
    is its hash table's, the numpy path's that of its face sort)."""
    tets = np.asarray(tets, dtype=np.int64)
    if use_native:
        return native.tet_face_neighbors(tets)
    T = tets.shape[0]
    faces = tets[:, _TET_FACES].reshape(-1, 3)
    key = np.sort(faces, axis=1)
    tet_of_face = np.repeat(np.arange(T), 4)

    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    key_s = key[order]
    tet_s = tet_of_face[order]

    same = np.all(key_s[1:] == key_s[:-1], axis=1)
    i = np.nonzero(same)[0]
    # both directions of each shared-face pair
    src = np.concatenate([tet_s[i], tet_s[i + 1]])
    dst = np.concatenate([tet_s[i + 1], tet_s[i]])
    # per-src slot = rank within the src group (each tet has <= 4 neighbours)
    order2 = np.argsort(src, kind="stable")
    src_s, dst_s = src[order2], dst[order2]
    first = np.concatenate([[0], np.nonzero(src_s[1:] != src_s[:-1])[0] + 1])
    group_start = np.zeros(src_s.shape[0], dtype=np.int64)
    group_start[first] = first
    group_start = np.maximum.accumulate(group_start)
    slot = np.arange(src_s.shape[0]) - group_start

    nbrs = np.full((T, 4), -1, dtype=np.int64)
    nbrs[src_s, slot] = dst_s
    degree = np.bincount(src, minlength=T).astype(np.int64)
    return nbrs, degree
