"""Sphere mesh generation: icosphere surfaces and tetrahedralized balls.

The reference pipeline turns each initial sphere into a tet mesh by
(a) scaling a template icosphere surface (mesh_data/s.1.obj),
(b) isotropic remeshing via libpgo, and (c) spawning a TetWild subprocess
per sphere (reference: geometry/tetmesh_geometry.py:268-303). TetWild is a
general surface→tet mesher, but in this pipeline its input is always a
sphere (or a swept capsule) — a convex body — so a Delaunay
tetrahedralization of a well-spaced point set produces an equivalent
high-quality tet ball natively, with no external executable. TetWild
subprocess orchestration is not part of this package.

The port's own copy of ``tssplat_tpu/mesh/spheres.py`` (numpy only): the
same functions and seeds, so both packages build the same tet balls.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere surface (verts (N,3), faces (F,3)), outward winding."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)

    for _ in range(subdivisions):
        edge_cache: dict = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key in edge_cache:
                return edge_cache[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            idx = len(verts_list) - 1
            edge_cache[key] = idx
            return idx

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return verts * radius, faces


def fibonacci_sphere(n: int, radius: float = 1.0) -> np.ndarray:
    """n near-uniform points on a sphere (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _tet_volumes(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    return _volumes_of(verts[tets])


def _volumes_of(v: np.ndarray) -> np.ndarray:
    """Signed volumes (T,) of tets with corner positions v (T,4,3); the
    cross product as np.cross takes it."""
    d = v[:, 1:] - v[:, :1]                              # (T,3,3)
    a, b = d[:, 0], d[:, 1]
    c = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                  a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                  a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)
    return np.einsum("ij,ij->i", c, d[:, 2]) / 6.0


def _bcc_lattice(lo: np.ndarray, hi: np.ndarray, a: float) -> np.ndarray:
    """Body-centered-cubic lattice covering [lo, hi] with cube size ``a`` —
    the optimal point lattice for Delaunay tet quality (its Delaunay cells
    are well-shaped disphenoid tets)."""
    axes = [np.arange(lo[d] - a, hi[d] + 2 * a, a) for d in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([g, g + 0.5 * a], axis=0)


def tet_ball_union(target_edge_length: float, centers, radii,
                   min_surface_points: int = 64
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Tetrahedralize the convex hull of a union of balls (one ball -> the
    ball; balls along a segment -> a cone-sphere capsule).

    Point set: per-ball Fibonacci surface samples kept only where they are
    not inside another ball (the union surface), plus a jittered BCC
    interior lattice. Delaunay-tetrahedralized (exact for convex bodies).
    The BCC interior + jitter avoids the co-spherical degeneracies that
    concentric-shell point sets hand to Delaunay (sliver tets with huge
    rest-matrix inverses would poison the energy kernels' conditioning).

    Returns (verts (N,3) float64, tets (T,4) int64), tets positively
    oriented, degenerate cells dropped.
    """
    h = float(target_edge_length)
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    radii = np.asarray(radii, np.float64).reshape(-1)

    # union surface samples
    surf, normals = [], []
    for j, (c, r) in enumerate(zip(centers, radii)):
        n = max(min_surface_points,
                int(round(4.0 * math.pi * r * r / (math.sqrt(3.0) / 2.0 * h * h))))
        p = fibonacci_sphere(n, r) + c
        if centers.shape[0] > 1:
            d = np.linalg.norm(p[:, None, :] - centers[None], axis=-1) - radii[None]
            d[:, j] = np.inf
            p = p[d.min(axis=1) > -0.05 * h]
        surf.append(p)
        normals.append((p - c) / max(r, 1e-12))
    surf = np.concatenate(surf, axis=0)
    normals = np.concatenate(normals, axis=0)
    if centers.shape[0] > 1:
        # Adjacent overlapping balls keep near-coincident boundary-band
        # samples; grid-dedupe to one point per 0.45h cell.
        key = np.round(surf / (0.45 * h)).astype(np.int64)
        _, keep_i = np.unique(key, axis=0, return_index=True)
        keep_i = np.sort(keep_i)
        surf, normals = surf[keep_i], normals[keep_i]

    # Offset layer just beneath the surface: guarantees an interior point
    # near every boundary patch, which suppresses Delaunay boundary slivers
    # (4 nearly coplanar surface samples with an empty circumsphere).
    rng = np.random.default_rng(12345)
    layer = surf - 0.6 * h * normals
    layer = layer + rng.uniform(-0.1 * h, 0.1 * h, size=layer.shape)

    # jittered BCC interior, kept clear of the offset layer
    lo = (centers - radii[:, None]).min(axis=0)
    hi = (centers + radii[:, None]).max(axis=0)
    lattice = _bcc_lattice(lo, hi, 1.05 * h)
    sd = (np.linalg.norm(lattice[:, None, :] - centers[None], axis=-1)
          - radii[None]).min(axis=1)
    inner = lattice[sd < -1.1 * h]
    inner = inner + rng.uniform(-0.08 * h, 0.08 * h, size=inner.shape)

    verts = np.concatenate([surf, layer, inner], axis=0)
    tri = Delaunay(verts)
    tets = tri.simplices.astype(np.int64)
    vol = _tet_volumes(verts, tets)
    flip = vol < 0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    vol = np.abs(vol)

    # Boundary-sliver peeling (alpha-complex criterion): a flat tet whose
    # circumcenter falls outside the body is a Delaunay artifact of the
    # boundary sampling, not real volume — its near-zero rest volume would
    # blow up dX_inv and poison the energy conditioning. Interior tets from
    # the jittered BCC lattice are far from both thresholds.
    cc = _circumcenters(verts, tets)
    sd_cc = (np.linalg.norm(cc[:, None, :] - centers[None], axis=-1)
             - radii[None]).min(axis=1)
    bad = (vol < 5e-3 * h ** 3) & (sd_cc > -0.1 * h)
    keep = (vol > 1e-8 * h ** 3) & ~bad
    tets = tets[keep]

    # Interior-sliver repair: peeling only removes BOUNDARY slivers (flat
    # tets whose circumcenter escapes the body); an interior sliver with
    # an inside circumsphere survives it. A single such tet is enough to
    # stall the reference's AdamUniform at multi-sphere scale: its barrier
    # gradient spikes to 1e3-1e4 while silhouette gradients sit at ~0.1,
    # and the optimizer's GLOBAL max-normalization then scales every other
    # vertex's update by ~1e-5 (measured on GSO Mario — examples/
    # stall_probe.py; the reference avoids this via TetWild's quality
    # optimization, reference geometry/tetmesh_geometry.py:230-260).
    verts = repair_sliver_tets(verts, tets, n_fixed=surf.shape[0], h=h)
    return verts, tets


_EDGE_I, _EDGE_J = np.triu_indices(4, k=1)


def _quality_of(v: np.ndarray, vol: np.ndarray) -> np.ndarray:
    """|vol| / maxEdge^3 of tets with corner positions v (T,4,3) and signed
    volumes vol (T,); the edge lengths as np.linalg.norm takes them."""
    e = v[:, _EDGE_I] - v[:, _EDGE_J]                    # (T,6,3)
    L = np.sqrt(np.add.reduce(e * e, axis=2)).max(axis=1)
    return np.abs(vol) / np.maximum(L ** 3, 1e-300)


def _tet_quality(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Scale-free tet quality |vol| / maxEdge^3 (regular tet ~= 0.118;
    slivers -> 0)."""
    v = verts[tets]
    return _quality_of(v, _volumes_of(v))


def repair_sliver_tets(verts: np.ndarray, tets: np.ndarray, n_fixed: int,
                       h: float, q_min: float = 2e-3, iters: int = 20,
                       ring: int = 1) -> np.ndarray:
    """Open up sliver tets by smoothing their movable vertices (the
    lightweight stand-in for TetWild's quality-optimization pass).

    Vertices < ``n_fixed`` (the union-surface samples) are pinned — the
    mesh boundary IS the geometry. For every tet below ``q_min``, the
    movable vertices of the tet and its ``ring``-neighborhood relax toward
    their vertex-neighborhood centroid (Laplacian step, 0.5 blend). Moves
    that would invert or worsen the LOCAL minimum quality are rejected
    per-iteration, so the pass is monotone in min-quality and terminates
    early once every tet clears the threshold. Operates on float64 host
    arrays at init time (one-off, not in the training path).

    The JAX package's function, vertex by vertex in the same order, with
    each vertex's seven candidate positions evaluated in one batch: every
    volume and quality is the same row computation, so the result is the
    same to the bit."""
    verts = verts.copy()
    T = tets.shape[0]
    # vertex -> incident tets (CSR) once
    order = np.argsort(tets.reshape(-1), kind="stable")
    flat_t = np.repeat(np.arange(T), 4)[order]
    counts = np.bincount(tets.reshape(-1), minlength=verts.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)])

    def incident(vids):
        return np.unique(np.concatenate(
            [flat_t[starts[v]:starts[v + 1]] for v in vids])) \
            if len(vids) else np.empty((0,), np.int64)

    for _ in range(iters):
        q = _tet_quality(verts, tets)
        bad = np.where(q < q_min)[0]
        if bad.size == 0:
            break
        region_v = np.unique(tets[bad].reshape(-1))
        for _ in range(ring):
            region_v = np.unique(tets[incident(region_v)].reshape(-1))
        movable = region_v[region_v >= n_fixed]
        if movable.size == 0:
            break
        moved_any = False
        for vid in movable:
            inc = flat_t[starts[vid]:starts[vid + 1]]
            inc_t = tets[inc]
            nbr = np.unique(inc_t.reshape(-1))
            nbr = nbr[nbr != vid]
            old = verts[vid].copy()
            cur = verts[inc_t]                           # (n,4,3)
            qi = _quality_of(cur, _volumes_of(cur))
            q_old = qi.min()

            # candidate moves: Laplacian blends (opens clustered slivers)
            # + nudges along the worst incident tet's opposite-face normal
            # (the direction that actually grows a flat tet's height —
            # a sliver's Laplacian target is often IN its plane)
            lap = verts[nbr].mean(axis=0)
            wt = inc_t[qi.argmin()]
            opp = wt[wt != vid][:3]
            a = verts[opp[1]] - verts[opp[0]]
            b = verts[opp[2]] - verts[opp[0]]
            # np.cross's arithmetic, without its axis handling
            nrm = np.array([a[1] * b[2] - a[2] * b[1],
                            a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])
            nn = np.linalg.norm(nrm)
            nrm = nrm / nn if nn > 1e-30 else np.zeros(3)
            cands = [old + b * (lap - old) for b in (1.0, 0.5, 0.25)]
            cands += [old + s * h * nrm for s in (0.3, -0.3, 0.6, -0.6)]

            # every candidate's incident tets at once: (7n,4,3)
            at = (inc_t == vid)[None, :, :, None]
            v7 = np.where(at, np.asarray(cands)[:, None, None, :],
                          cur[None]).reshape(-1, 4, 3)
            vol7 = _volumes_of(v7)
            q7 = _quality_of(v7, vol7).reshape(len(cands), -1)
            vol7 = vol7.reshape(len(cands), -1)
            best_q, best_p = q_old, None
            for k, p in enumerate(cands):
                if (vol7[k] <= 0).any():
                    continue
                qn = q7[k].min()
                if qn > best_q:
                    best_q, best_p = qn, p
            verts[vid] = best_p if best_p is not None else old
            moved_any |= best_p is not None
        if not moved_any:
            break
    return verts


def _circumcenters(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Circumcenters of tets ((T,3)); degenerate tets get their centroid."""
    p = verts[tets]                       # (T,4,3)
    a = p[:, 1:] - p[:, :1]               # (T,3,3)
    rhs = 0.5 * np.einsum("tij,tij->ti", a, a)
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-30
    cc = np.mean(p, axis=1)
    if ok.any():
        sol = np.linalg.solve(a[ok], rhs[ok][..., None])[..., 0]
        cc[ok] = p[ok, 0] + sol
    return cc


def tet_sphere(target_edge_length: float, radius: float = 1.0,
               center=(0.0, 0.0, 0.0), min_surface_points: int = 64,
               rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Tetrahedralize a ball into well-shaped tets (native replacement for
    the per-sphere TetWild subprocess of the reference,
    geometry/tetmesh_geometry.py:268-303). See tet_ball_union."""
    del rng
    return tet_ball_union(target_edge_length, [center], [radius],
                          min_surface_points=min_surface_points)


def tet_capsule(target_edge_length: float, p0, p1, r0: float, r1: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Tetrahedralized cone-sphere (a sphere swept along a straight edge
    with linearly varying radius): the skeleton-edge primitive of the
    skeleton geometry (reference: pypgo.create_tetsphere_edge_surface +
    TetWild, geometry/tetmesh_fish.py:73-87). The body is convex, so the
    ball-union Delaunay tetrahedralizer applies with stations every half
    edge length."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    h = float(target_edge_length)
    length = float(np.linalg.norm(p1 - p0))
    n_st = max(2, int(math.ceil(length / max(0.5 * h, 1e-9))) + 1)
    a = np.linspace(0.0, 1.0, n_st)[:, None]
    centers = (1 - a) * p0 + a * p1
    radii = (1 - a[:, 0]) * r0 + a[:, 0] * r1
    return tet_ball_union(h, centers, radii)


def load_template_sphere(path: Optional[str] = None,
                         subdivisions: int = 3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Template surface sphere: from an OBJ file if given (the reference
    uses mesh_data/s.1.obj, config/gso.yaml:13), else an icosphere."""
    if path:
        from .io import load_obj
        return load_obj(path)
    return icosphere(subdivisions=subdivisions)
