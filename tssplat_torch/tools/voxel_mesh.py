"""Binary-volume meshing: naive surface nets + Laplacian smoothing (the
port's own copy of ``tssplat_tpu/tools/voxel_mesh.py``, numpy only).

Surface nets on a binary grid place one vertex at the centre of every
sign-change cell (the dual cube) and one quad on every sign-change grid
edge: a watertight mesh, oriented from occupied toward empty; a few
uniform Laplacian steps smooth its staircase (the reference's binary
marching cubes and isotropic remeshing, data/generate_init_spheres.py:
231-238, 427-435). ``save_sdf`` / ``load_sdf`` read and write the Vega
binary .sdf layout (reference :92-110).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def surface_nets(occ: np.ndarray, origin, spacing) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh the boundary of a binary occupancy grid.

    occ: (nx,ny,nz) bool — occupancy sampled at grid points.
    origin: world position of grid point (0,0,0); spacing: scalar or (3,).
    Returns (verts (N,3) float64, faces (F,3) int64) with outward
    orientation (normals pointing from occupied toward empty).
    """
    occ = np.asarray(occ, bool)
    origin = np.asarray(origin, np.float64)
    spacing = np.broadcast_to(np.asarray(spacing, np.float64), (3,))
    nx, ny, nz = occ.shape

    # cells (cubes) indexed by their min corner; mixed cells get a vertex
    c = occ[:-1, :-1, :-1].astype(np.int8)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx or dy or dz:
                    c = c + occ[dx:nx - 1 + dx, dy:ny - 1 + dy,
                                dz:nz - 1 + dz]
    mixed = (c > 0) & (c < 8)
    cell_id = np.full(mixed.shape, -1, np.int64)
    idx = np.argwhere(mixed)
    cell_id[mixed] = np.arange(idx.shape[0])

    # binary grid: vertex at the cube center
    verts = (idx + 0.5) * spacing[None, :] + origin[None, :]

    faces = []
    # a sign-change edge along axis k connects the 4 cells sharing it
    for axis in range(3):
        a = occ
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, -1)
        sl1[axis] = slice(1, None)
        e_in = a[tuple(sl0)] & ~a[tuple(sl1)]        # occupied -> empty (+axis)
        e_out = ~a[tuple(sl0)] & a[tuple(sl1)]       # empty -> occupied
        u, v = (axis + 1) % 3, (axis + 2) % 3

        for flip, edges in ((False, e_in), (True, e_out)):
            pts = np.argwhere(edges)
            if pts.shape[0] == 0:
                continue
            # interior edges only: need all 4 adjacent cells to exist
            ok = (pts[:, u] >= 1) & (pts[:, v] >= 1) \
                & (pts[:, u] <= occ.shape[u] - 2) \
                & (pts[:, v] <= occ.shape[v] - 2) \
                & (pts[:, axis] <= occ.shape[axis] - 2)
            pts = pts[ok]

            def cid(du, dv):
                q = pts.copy()
                q[:, u] -= du
                q[:, v] -= dv
                return cell_id[q[:, 0], q[:, 1], q[:, 2]]

            q00, q10, q11, q01 = cid(0, 0), cid(1, 0), cid(1, 1), cid(0, 1)
            good = (q00 >= 0) & (q10 >= 0) & (q11 >= 0) & (q01 >= 0)
            q00, q10, q11, q01 = q00[good], q10[good], q11[good], q01[good]
            if flip:
                q10, q01 = q01, q10
            faces.append(np.stack([q00, q10, q11], axis=1))
            faces.append(np.stack([q00, q11, q01], axis=1))

    if not faces:
        return verts, np.zeros((0, 3), np.int64)
    return verts, np.concatenate(faces, axis=0).astype(np.int64)


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray, iters: int = 4,
                     lam: float = 0.5) -> np.ndarray:
    """Uniform-weight Laplacian smoothing (plays the role of the reference's
    isotropic remeshing pass for the blocky hull mesh)."""
    verts = np.asarray(verts, np.float64).copy()
    n = verts.shape[0]
    src = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2],
                          faces[:, 1], faces[:, 2], faces[:, 0]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0],
                          faces[:, 0], faces[:, 1], faces[:, 2]])
    deg = np.bincount(src, minlength=n).astype(np.float64)
    deg = np.maximum(deg, 1.0)
    for _ in range(iters):
        acc = np.zeros_like(verts)
        np.add.at(acc, src, verts[dst])
        verts = verts + lam * (acc / deg[:, None] - verts)
    return verts


def save_sdf(path: str, sdf: np.ndarray, bmin, bmax) -> None:
    """Write a distance-field volume in the Vega binary .sdf layout the
    reference init pipeline emits (reference:
    data/generate_init_spheres.py:92-110): int32 (-dim, dim, dim), six
    float64 bbox values, then the (dim^3) float32 grid."""
    import struct

    sdf = np.asarray(sdf, np.float32)
    dim = sdf.shape[0]
    assert sdf.shape == (dim, dim, dim)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("iii", -dim, dim, dim))
        f.write(struct.pack("ddd", *bmin))
        f.write(struct.pack("ddd", *bmax))
        f.write(sdf.tobytes())


def load_sdf(path: str):
    """Read the Vega binary .sdf layout -> (sdf (d,d,d) f32, bmin, bmax)."""
    import struct

    with open(path, "rb") as f:
        d0, d1, d2 = struct.unpack("iii", f.read(12))
        dim = abs(d0)
        assert (abs(d0), d1, d2) == (dim, dim, dim), "unexpected .sdf header"
        bmin = np.asarray(struct.unpack("ddd", f.read(24)))
        bmax = np.asarray(struct.unpack("ddd", f.read(24)))
        sdf = np.frombuffer(f.read(dim ** 3 * 4), np.float32) \
            .reshape(dim, dim, dim).copy()
    return sdf, bmin, bmax
