"""Mesh geometry queries: batched ray casting and signed distance (port of
``tssplat_tpu/ops/queries.py``).

  ray_mesh_first_hit(origins, dirs, verts, faces)  first-hit t, inf on miss
  ray_mesh_hit_full(origins, dirs, verts, faces)   (t, triangle id or -1,
                                                    u, v) of the first hit
  signed_distance(points, verts, faces)            closest distance, signed
                                                   by the nearest face's
                                                   normal (negative inside)

Brute force over the triangles in chunks (128 for rays, 256 for points;
JAX scans 512 and 256), and over the queries in blocks as well, so a
(query, triangle) temporary stays at a few million entries whatever the
number of queries; each query's answer does not depend on the others, so
the blocks change no result. The arithmetic is written as JAX writes it
(``jnp.cross``'s component formula, sums of three products left to right)
and the tie rules are JAX's: inside a chunk the first index wins (argmin),
across chunks a strict ``<`` keeps the earlier one (so the lowest index
of the equal minima wins, whatever the chunk), and a zero sign counts as
+1.

A ray is tested against a chunk of triangles only where it meets the
chunk's box (grown by 1e-3 of the mesh's box diagonal): elsewhere it
cannot hit them, and keeps the answer the full test would give it.

Plain PyTorch on the tensors' device: the JAX counterparts are XLA code
(``jax.lax.scan``), not Pallas kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-9
_INF = float("inf")


def _block(dev: torch.device, chunk: int) -> int:
    """Queries per block: a (block, chunk) f32 plane of 8 M entries on the
    card, of 256 k (1 MB, cache-sized) on the CPU."""
    return max(1, (1 << (18 if dev.type == "cpu" else 23)) // chunk)


# Vectors are held as three planes (x, y, z): each (Q,1) or (1,C) in the
# (query, triangle) arithmetic, so no (Q,C,3) tensor is stacked or read
# with a stride.

def _planes(a: torch.Tensor, axis: int):
    """The columns of a (n,3) tensor as three (n,1) (axis 1) or (1,n)
    (axis 0) planes."""
    return tuple(a[:, k].unsqueeze(axis) for k in range(3))


def _pdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pcross(a, b):
    """``jnp.cross``'s component formula."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _psub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (3), summed left to right."""
    return _pdot(a.unbind(-1), b.unbind(-1))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (3), ``jnp.cross``'s formula."""
    return torch.stack(_pcross(a.unbind(-1), b.unbind(-1)), -1)


def _triangles(verts: torch.Tensor, faces: torch.Tensor):
    tri = verts[faces.long()]                            # (F,3,3)
    return tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]


def _ray_tri_tuv(orig, d, v0, e1, e2):
    """Möller–Trumbore (``_ray_tri_tuv``, queries.py:19): (t, u, v) (R,C)
    of rays (R,3) against a chunk of triangles (C,3); t = inf on a miss."""
    o, d = _planes(orig, 1), _planes(d, 1)
    v0, e1, e2 = _planes(v0, 0), _planes(e1, 0), _planes(e2, 0)
    p = _pcross(d, e2)
    det = _pdot(e1, p)
    ok = torch.abs(det) > _EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    s = _psub(o, v0)
    u = _pdot(s, p) * inv
    q = _pcross(s, e1)
    v = _pdot(d, q) * inv
    t = _pdot(e2, q) * inv
    hit = ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1 + _EPS) & (t > _EPS)
    return torch.where(hit, t, _INF), u, v


def _rays_near_box(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """(R,) bool: the rays o + t d (float64) meet the box [lo, hi] at some
    t >= 0 (slab test)."""
    inv = 1.0 / d                                        # +-inf where d = 0
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    inside = (o >= lo) & (o <= hi)
    t1 = torch.where(d == 0, torch.where(inside, -_INF, _INF), t1)
    t2 = torch.where(d == 0, torch.where(inside, _INF, -_INF), t2)
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return far >= torch.clamp_min(near, 0.0)


def ray_mesh_hit_full(origins: torch.Tensor, dirs: torch.Tensor,
                      verts: torch.Tensor, faces: torch.Tensor,
                      chunk: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """First hit with attributes (``ray_mesh_hit_full``, queries.py:69):
    (t (R,), triangle id (R,) int32, -1 on a miss, u (R,), v (R,) the
    barycentrics of corners 1 and 2). Inputs f32 (ids any integer type),
    all on one device.

    Each chunk of ``chunk`` triangles is tested against the rays that meet
    its box (grown by 1e-3 of the mesh's box diagonal); the others cannot
    hit it and keep their answer. The first of equal minima wins across
    chunks as inside one, so the result does not depend on ``chunk`` (JAX
    scans 512 at a time; smaller chunks have tighter boxes)."""
    R, dev = origins.shape[0], origins.device
    t_out = torch.full((R,), _INF, device=dev)
    id_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), device=dev)
    v_out = torch.zeros((R,), device=dev)
    F = faces.shape[0]
    if F == 0 or R == 0:
        return t_out, id_out, u_out, v_out
    v0, e1, e2 = _triangles(verts, faces)
    corners = verts[faces.long()].double()               # (F,3,3)
    margin = 1e-3 * float(torch.linalg.norm(
        corners.amax((0, 1)) - corners.amin((0, 1)))) + 1e-6
    o64, d64 = origins.double(), dirs.double()
    blk = _block(dev, chunk)
    for c in range(0, F, chunk):
        box = corners[c:c + chunk].reshape(-1, 3)
        live = torch.nonzero(_rays_near_box(
            o64, d64, box.amin(0) - margin, box.amax(0) + margin)).reshape(-1)
        for s in range(0, live.shape[0], blk):
            rows = live[s:s + blk]
            t, u, v = _ray_tri_tuv(origins[rows], dirs[rows], v0[c:c + chunk],
                                   e1[c:c + chunk], e2[c:c + chunk])
            j = torch.argmin(t, dim=1)
            r = torch.arange(rows.shape[0], device=dev)
            tm = t[r, j]
            take = tm < t_out[rows]
            t_out[rows] = torch.where(take, tm, t_out[rows])
            id_out[rows] = torch.where(take, (j + c).to(torch.int32),
                                       id_out[rows])
            u_out[rows] = torch.where(take, u[r, j], u_out[rows])
            v_out[rows] = torch.where(take, v[r, j], v_out[rows])
    return t_out, id_out, u_out, v_out


def ray_mesh_first_hit(origins: torch.Tensor, dirs: torch.Tensor,
                       verts: torch.Tensor, faces: torch.Tensor,
                       chunk: int = 128) -> torch.Tensor:
    """First-hit distance t per ray (R,), inf where the ray misses
    (``ray_mesh_first_hit``, queries.py:42): the t of
    ``ray_mesh_hit_full``, the same minimum."""
    return ray_mesh_hit_full(origins, dirs, verts, faces, chunk)[0]


def _edge_point(o, dvec, w):
    """Closest points to w's points on the segments o + [0, 1] dvec."""
    tt = torch.clamp(_pdot(dvec, w) / torch.clamp_min(_pdot(dvec, dvec), _EPS),
                     0.0, 1.0)
    return tuple(oc + tt * dc for oc, dc in zip(o, dvec))


def _point_tri_closest(p, v0, e1, e2, with_point: bool):
    """Squared distance of points to triangles (``_point_tri_closest``,
    queries.py:110), and with ``with_point`` the closest point as three
    planes; every argument is three broadcastable planes (points (P,1)
    against a chunk (1,C), or one pair a row). JAX's branch-free
    approximation, not Ericson's exact region walk: the unconstrained
    (s, t) clamped to [0, 1] and rescaled onto the hypotenuse, then the best
    of that point and the projections on the three edges (the first of
    equals)."""
    a, b, c = _pdot(e1, e1), _pdot(e1, e2), _pdot(e2, e2)
    w = _psub(p, v0)
    d = _pdot(e1, w)
    e = _pdot(e2, w)
    det = torch.clamp_min(a * c - b * b, _EPS)
    s = (c * d - b * e) / det
    t = (a * e - b * d) / det
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.clamp(t, 0.0, 1.0)
    over = s + t - 1.0
    s = torch.where(over > 0, s - over * s / torch.clamp_min(s + t, _EPS), s)
    t = torch.where(over > 0, t - over * t / torch.clamp_min(s + t, _EPS), t)

    v1 = tuple(x + y for x, y in zip(v0, e1))
    best = tuple(vc + s * e1c + t * e2c for vc, e1c, e2c in zip(v0, e1, e2))
    diff = _psub(best, p)
    best_d2 = _pdot(diff, diff)
    for cand in (_edge_point(v0, e1, w), _edge_point(v0, e2, w),
                 _edge_point(v1, _psub(e2, e1), _psub(p, v1))):
        diff = _psub(cand, p)
        d2 = _pdot(diff, diff)
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        if with_point:
            best = tuple(torch.where(take, x, y) for x, y in zip(cand, best))
    return best_d2, (best if with_point else None)


def signed_distance(points: torch.Tensor, verts: torch.Tensor,
                    faces: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Signed distance (P,) of points (P,3) to a closed mesh
    (``signed_distance``, queries.py:155): the unsigned closest distance,
    its sign that of (point - closest point) . the closest triangle's
    normal (negative inside, +1 where the product is 0). Inputs f32.

    Each chunk's nearest triangle is found from the squared distances
    alone; its closest point is then computed again for that one
    (point, triangle) pair: the same operations on the same values, so the
    same bits as keeping every pair's point."""
    P, dev = points.shape[0], points.device
    v0, e1, e2 = _triangles(verts, faces)
    nrm = cross3(e1, e2)
    tri = [_planes(x, 0) for x in (v0, e1, e2)]
    F = faces.shape[0]
    out = torch.empty((P,), device=dev)
    blk = _block(dev, chunk)
    for s in range(0, P, blk):
        pts = points[s:s + blk]
        n = pts.shape[0]
        p_col, p_row = _planes(pts, 1), tuple(pts.unbind(1))
        r = torch.arange(n, device=dev)
        best_d2 = torch.full((n,), _INF, device=dev)
        best_sign = torch.ones((n,), device=dev)
        for c in range(0, F, chunk):
            d2 = _point_tri_closest(p_col, *(tuple(x[:, c:c + chunk]
                                                   for x in pl)
                                             for pl in tri), False)[0]
            j = torch.argmin(d2, dim=1)
            d2m = d2[r, j]
            k = j + c
            cp = _point_tri_closest(p_row, *(tuple(x.unbind(1))
                                             for x in (v0[k], e1[k], e2[k])),
                                    True)[1]
            sign = torch.sign(_pdot(_psub(p_row, cp), tuple(nrm[k].unbind(1))))
            sign = torch.where(sign == 0, 1.0, sign)
            take = d2m < best_d2
            best_d2 = torch.where(take, d2m, best_d2)
            best_sign = torch.where(take, sign, best_sign)
        out[s:s + n] = best_sign * torch.sqrt(best_d2)
    return out
