"""Chart-based UV parametrization: the native replacement for xatlas
(the port's own copy of ``tssplat_tpu/mesh/uv.py``, numpy and scipy).

The reference runs xatlas on the boundary surface at mesh build
(reference: geometry/tetrahedron_mesh.py:66-68) and bakes textures into
that atlas. This module reproduces the pipeline's three xatlas stages with
host-side numpy/scipy:

  1. chart segmentation — greedy normal-coherent region growth over the
     triangle adjacency graph;
  2. per-chart parametrization — LSCM (least-squares conformal map,
     Lévy et al. 2002) with two pinned diameter vertices, falling back to
     best-fit-plane projection for degenerate charts;
  3. atlas packing — texel-density-equalized shelf packing with a gutter.

Output is (uv (U,2) float32, uv_faces (F,3) int64) where UV vertices are
unique (chart, mesh-vertex) pairs — vertices interior to a chart share one
UV (seams only at chart boundaries), unlike the trivial per-triangle
atlas's isolated cells that waste half the texture area and seam every
triangle.
"""

from __future__ import annotations

import numpy as np


def _face_normals(v, f):
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    a = np.linalg.norm(n, axis=1)
    return n / np.maximum(a, 1e-20)[:, None], 0.5 * a


def grow_charts(verts, faces, nbrs, angle_deg: float = 60.0,
                max_chart_faces: int = 4000):
    """Greedy BFS chart growth: faces join a chart while their normal stays
    within ``angle_deg`` of the chart's running average normal. Returns
    (chart_id (F,) int32, n_charts)."""
    F = faces.shape[0]
    normals, _ = _face_normals(verts, faces)
    cos_thr = np.cos(np.radians(angle_deg))
    chart = np.full(F, -1, np.int32)
    n_charts = 0
    order = np.arange(F)
    for seed in order:
        if chart[seed] >= 0:
            continue
        cid = n_charts
        n_charts += 1
        chart[seed] = cid
        avg = normals[seed].copy()
        size = 1
        queue = [seed]
        while queue and size < max_chart_faces:
            fcur = queue.pop()
            for nb in nbrs[fcur]:
                if nb < 0 or chart[nb] >= 0:
                    continue
                if normals[nb] @ (avg / max(np.linalg.norm(avg), 1e-20)) \
                        >= cos_thr:
                    chart[nb] = cid
                    avg += normals[nb]
                    size += 1
                    queue.append(nb)
                    if size >= max_chart_faces:
                        break
    return chart, n_charts


def _lscm(v2_local, faces_local, n_verts):
    """LSCM solve for one chart: local per-triangle 2D frames -> complex
    conformal constraints -> real sparse least squares with two pinned
    vertices. Returns (U (n_verts,2)) or None on failure."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    F = faces_local.shape[0]
    # complex coefficient per (triangle, corner): c_m = z_{m+1} - z_{m+2}
    z = v2_local[..., 0] + 1j * v2_local[..., 1]        # (F,3)
    c = np.stack([z[:, 1] - z[:, 2], z[:, 2] - z[:, 0],
                  z[:, 0] - z[:, 1]], axis=1)           # (F,3)
    area2 = np.abs(np.imag(np.conj(z[:, 1] - z[:, 0])
                           * (z[:, 2] - z[:, 0])))
    c = c / np.sqrt(np.maximum(area2, 1e-20))[:, None]

    # pin the two bbox-diameter vertices
    if n_verts < 3:
        return None
    ext = v2_local.reshape(-1, 2)
    vid = faces_local.reshape(-1)
    pos = np.zeros((n_verts, 2))
    pos[vid] = ext
    d = pos - pos.mean(axis=0)
    p0 = int(np.argmax((d ** 2).sum(axis=1)))
    p1 = int(np.argmax(((pos - pos[p0]) ** 2).sum(axis=1)))
    if p0 == p1:
        return None
    pinned = np.array([p0, p1])
    pin_uv = np.array([[0.0, 0.0], [1.0, 0.0]])

    free = np.setdiff1d(np.arange(n_verts), pinned)
    col_of = np.full(n_verts, -1)
    col_of[free] = np.arange(free.size)

    rows, cols, re_d, im_d = [], [], [], []
    rhs = np.zeros(2 * F)
    for m in range(3):
        vm = faces_local[:, m]
        cre, cim = np.real(c[:, m]), np.imag(c[:, m])
        isfree = col_of[vm] >= 0
        fi = np.nonzero(isfree)[0]
        j = col_of[vm[fi]]
        # rows 2t (real part), 2t+1 (imag part); unknowns (u_j, v_j)
        rows += [2 * fi, 2 * fi, 2 * fi + 1, 2 * fi + 1]
        cols += [2 * j, 2 * j + 1, 2 * j, 2 * j + 1]
        re_d += [cre[fi], -cim[fi], cim[fi], cre[fi]]
        pi = np.nonzero(~isfree)[0]
        for t in pi:
            k = 0 if vm[t] == pinned[0] else 1
            u0, v0 = pin_uv[k]
            rhs[2 * t] -= cre[t] * u0 - cim[t] * v0
            rhs[2 * t + 1] -= cim[t] * u0 + cre[t] * v0
    A = sp.csr_matrix((np.concatenate(re_d),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(2 * F, 2 * free.size))
    sol = spla.lsqr(A, rhs, atol=1e-10, btol=1e-10)[0]
    U = np.zeros((n_verts, 2))
    U[pinned] = pin_uv
    U[free, 0] = sol[0::2]
    U[free, 1] = sol[1::2]
    if not np.isfinite(U).all():
        return None
    return U


def _local_frames(verts, faces):
    """Per-triangle 2D coordinates of the three corners in an orthonormal
    in-plane basis: (F,3,2)."""
    p = verts[faces]                                     # (F,3,3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    n = np.cross(e1, e2)
    bx = e1 / np.maximum(np.linalg.norm(e1, axis=1), 1e-20)[:, None]
    nn = n / np.maximum(np.linalg.norm(n, axis=1), 1e-20)[:, None]
    by = np.cross(nn, bx)
    x = np.stack([np.zeros(len(p)), (e1 * bx).sum(1), (e2 * bx).sum(1)], 1)
    y = np.stack([np.zeros(len(p)), (e1 * by).sum(1), (e2 * by).sum(1)], 1)
    return np.stack([x, y], axis=-1)


def _project_chart(verts, vids):
    """Best-fit-plane projection fallback: (len(vids),2)."""
    p = verts[vids]
    c = p.mean(axis=0)
    _, _, vt = np.linalg.svd(p - c, full_matrices=False)
    return (p - c) @ vt[:2].T


def chart_uv_atlas(verts, faces, angle_deg: float = 60.0,
                   gutter: float = 4.0 / 1024.0):
    """Full pipeline: charts -> LSCM -> packed atlas.

    Returns (uv (U,2) float32 in [0,1], uv_faces (F,3) int64,
    uv_vid (U,) int64 — the mesh vertex behind each UV vertex) with UV
    vertices unique per (chart, mesh vertex)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    from .surface import triangle_edge_neighbors
    nbrs = triangle_edge_neighbors(faces)
    chart, n_charts = grow_charts(verts, faces, nbrs, angle_deg)
    frames = _local_frames(verts, faces)
    _, tri_area = _face_normals(verts, faces)

    uv_faces = np.zeros((faces.shape[0], 3), np.int64)
    chart_uvs = []            # per chart: local uv (n,2)
    chart_vids = []           # per chart: mesh vertex ids (n,)
    chart_vert_base = []
    total_u = 0
    for cid in range(n_charts):
        fsel = np.nonzero(chart == cid)[0]
        vids, local_f = np.unique(faces[fsel].reshape(-1),
                                  return_inverse=True)
        local_f = local_f.reshape(-1, 3)
        n_local = vids.size
        U = None
        if fsel.size > 1:
            U = _lscm(frames[fsel], local_f, n_local)
        if U is None:
            U = _project_chart(verts, vids)
        # equalize texel density: scale uv so uv area == 3d area
        a3 = float(tri_area[fsel].sum())
        e1 = U[local_f[:, 1]] - U[local_f[:, 0]]
        e2 = U[local_f[:, 2]] - U[local_f[:, 0]]
        auv = 0.5 * float(np.abs(e1[:, 0] * e2[:, 1]
                                 - e1[:, 1] * e2[:, 0]).sum())
        U = U * np.sqrt(a3 / max(auv, 1e-20))
        U = U - U.min(axis=0)
        chart_uvs.append(U)
        chart_vids.append(vids)
        chart_vert_base.append(total_u)
        uv_faces[fsel] = total_u + local_f
        total_u += n_local

    # shelf packing, sorted by height; iterate the shelf width so the
    # atlas comes out near-square (a lopsided W x H wastes the rest of the
    # [0,1]^2 square)
    sizes = np.array([u.max(axis=0) if len(u) else np.zeros(2)
                      for u in chart_uvs])               # (C,2) w,h
    order = np.argsort(-sizes[:, 1])
    total_area = float((sizes[:, 0] * sizes[:, 1]).sum())
    W = max(np.sqrt(total_area) * 1.05, sizes[:, 0].max() + 1e-12)

    def pack(W):
        g = gutter * W
        offsets = np.zeros((n_charts, 2))
        x = y = row_h = 0.0
        used_w = 0.0
        for cid in order:
            w, h = sizes[cid]
            if x + w + g > W and x > 0:
                x = 0.0
                y += row_h + g
                row_h = 0.0
            offsets[cid] = (x, y)
            x += w + g
            used_w = max(used_w, x)
            row_h = max(row_h, h)
        return offsets, used_w, y + row_h

    best = None
    for _ in range(6):
        offsets, uw, H = pack(W)
        side = max(uw, H)
        if best is None or side < best[0]:
            best = (side, offsets)
        if H <= 0 or uw <= 0:
            break
        W = max(np.sqrt(uw * H), sizes[:, 0].max() + 1e-12)
    side, offsets = best
    side = side * (1.0 + gutter)

    uv = np.zeros((total_u, 2), np.float32)
    for cid in range(n_charts):
        b = chart_vert_base[cid]
        n_local = chart_uvs[cid].shape[0]
        uv[b:b + n_local] = ((chart_uvs[cid] + offsets[cid]) / side) \
            .astype(np.float32)
    uv_vid = np.concatenate(chart_vids).astype(np.int64)
    return uv, uv_faces, uv_vid
