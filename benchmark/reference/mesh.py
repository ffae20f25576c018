"""Topology of a tet mesh, in numpy: the boundary surface, the surface
triangles' edge neighbours and the tets' face neighbours."""

from __future__ import annotations

import numpy as np

# a tet's faces, outward for a positively oriented tet
TET_FACES = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], np.int64)


def surface(tets: np.ndarray):
    """(surface vertex ids (S,) sorted, faces (F,3) in surface ids): the
    faces that belong to one tet only, in tet order, winding kept."""
    tris = tets[:, TET_FACES].reshape(-1, 3)
    _, inv, counts = np.unique(np.sort(tris, axis=1), axis=0,
                               return_inverse=True, return_counts=True)
    tris = tris[counts[inv.reshape(-1)] == 1]
    sv = np.unique(tris)
    remap = np.full(int(tets.max()) + 1, -1, np.int64)
    remap[sv] = np.arange(sv.shape[0])
    return sv.astype(np.int64), remap[tris]


def edge_neighbours(faces: np.ndarray) -> np.ndarray:
    """(F,3): the triangle across local edge e = (e, e+1 mod 3) of each
    triangle, -1 on an open edge."""
    F = faces.shape[0]
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    tri = np.tile(np.arange(F), 3)
    key = np.sort(edges, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    ks, ts, slot = key[order], tri[order], order // F
    out = np.full((F, 3), -1, np.int64)
    a = np.nonzero(np.all(ks[1:] == ks[:-1], axis=1))[0]
    out[ts[a], slot[a]] = ts[a + 1]
    out[ts[a + 1], slot[a + 1]] = ts[a]
    return out


def tet_neighbours(tets: np.ndarray):
    """(neighbours (T,4) with -1 padding, degree (T,)): tets sharing a
    face."""
    T = tets.shape[0]
    key = np.sort(tets[:, TET_FACES].reshape(-1, 3), axis=1)
    owner = np.repeat(np.arange(T), 4)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    ks, os_ = key[order], owner[order]
    i = np.nonzero(np.all(ks[1:] == ks[:-1], axis=1))[0]
    src = np.concatenate([os_[i], os_[i + 1]])
    dst = np.concatenate([os_[i + 1], os_[i]])
    o2 = np.argsort(src, kind="stable")
    src, dst = src[o2], dst[o2]
    start = np.searchsorted(src, src, side="left")
    nbrs = np.full((T, 4), -1, np.int64)
    nbrs[src, np.arange(src.shape[0]) - start] = dst
    return nbrs, np.bincount(src, minlength=T)
