"""The helpers the inputs writers (``benchmark/inputs/``) share to make a
run's inputs from its seed: the cameras, the 18 spheres' tet mesh, the
ellipsoid's target images, the Mitsuba dataset layout and the colour
field's shapes.

The same seed gives the same inputs; the sizes never depend on it. The
seed turns and stretches the target ellipsoid and turns the sphere layout,
within the ranges the configuration's ``assumed`` block states. The tet
ball is one mesh for every seed (its radius and edge length are the
configuration's), placed at each sphere centre.

The mesher, the cameras and the key-point layout are frozen copies of the
port's ``mesh/spheres.py tet_ball_union`` (one ball), ``ops/transform.py
fibonacci_views`` and ``tools/synthetic.py write_multisphere_key_points``,
so the program's later changes move no input. Everything here is host
numpy or plain PyTorch, and imports nothing of the program.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator of (seed, stream); any whole number is a seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, int(stream)])


def torch_seed_of(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, drawn from (seed, stream)."""
    return int(rng_of(seed, stream).integers(0, 2 ** 63 - 1))


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniformly drawn rotation matrix (3,3), from a unit quaternion."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


# ---------------------------------------------------------------------------
# cameras (frozen copy of the port's ops/transform.py)
# ---------------------------------------------------------------------------

def _look_at(eye, center, up) -> np.ndarray:
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    up2 /= np.linalg.norm(up2)
    M = np.eye(4)
    M[0, :3], M[1, :3], M[2, :3] = right, up2, -fwd
    M[0, 3] = -right @ eye
    M[1, 3] = -up2 @ eye
    M[2, 3] = fwd @ eye
    return M


def _perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    t = math.tan(math.radians(fov_deg) * 0.5)
    M = np.zeros((4, 4))
    M[0, 0] = 1.0 / t
    M[1, 1] = -1.0 / t                       # y flip, as the reference's
    M[2, 2] = -(far + near) / (far - near)
    M[2, 3] = -(2 * far * near) / (far - near)
    M[3, 2] = -1.0
    return M


def fibonacci_views(n: int, radius: float = 4.0, fov_deg: float = 39.3077,
                    near: float = 1e-3, far: float = 10.0):
    """Golden-spiral cameras looking at the origin: (mvp (n,4,4), mv (n,4,4),
    campos (n,3)), float64."""
    golden = (1 + 5 ** 0.5) / 2
    i = np.arange(n)
    theta = 2 * math.pi * i / golden
    phi = np.arccos(1 - 2 * i / n)
    xyz = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                    np.cos(phi)], axis=1) * radius
    P = _perspective(fov_deg, near, far)
    mvps, mvs = [], []
    for eye in xyz:
        d = eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 0.0, 1.0])
        if abs(up @ d) > math.cos(math.pi / 8.0):
            up = np.asarray([0.0, 1.0, 0.0])
        V = _look_at(eye, np.zeros(3), up)
        mvs.append(V)
        mvps.append(P @ V)
    return np.stack(mvps), np.stack(mvs), xyz


# ---------------------------------------------------------------------------
# the tet ball (frozen copy of the port's mesh/spheres.py, one ball)
# ---------------------------------------------------------------------------

def target_edge_length(min_radius: float, min_n_triangles: int = 100,
                       edge_length_wrt_bb: float = 0.03,
                       edge_length_min: float = 0.015) -> float:
    """The multi-sphere geometry's edge length for its smallest sphere."""
    area = min_radius * min_radius * math.pi / min_n_triangles
    edge = math.sqrt(area * 4.0 / math.sqrt(3.0))
    return max(edge_length_min, min(edge_length_wrt_bb, edge))


def _fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _volumes_of(v: np.ndarray) -> np.ndarray:
    d = v[:, 1:] - v[:, :1]
    a, b = d[:, 0], d[:, 1]
    c = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                  a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                  a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)
    return np.einsum("ij,ij->i", c, d[:, 2]) / 6.0


_EDGE_I, _EDGE_J = np.triu_indices(4, k=1)


def _quality_of(v: np.ndarray, vol: np.ndarray) -> np.ndarray:
    e = v[:, _EDGE_I] - v[:, _EDGE_J]
    L = np.sqrt(np.add.reduce(e * e, axis=2)).max(axis=1)
    return np.abs(vol) / np.maximum(L ** 3, 1e-300)


def _circumcenters(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    p = verts[tets]
    a = p[:, 1:] - p[:, :1]
    rhs = 0.5 * np.einsum("tij,tij->ti", a, a)
    ok = np.abs(np.linalg.det(a)) > 1e-30
    cc = np.mean(p, axis=1)
    if ok.any():
        cc[ok] = p[ok, 0] + np.linalg.solve(a[ok], rhs[ok][..., None])[..., 0]
    return cc


def _repair_slivers(verts, tets, n_fixed: int, h: float, q_min: float = 2e-3,
                    iters: int = 20) -> np.ndarray:
    """Relax the movable vertices around sliver tets (the port's
    ``repair_sliver_tets`` with ring 1)."""
    verts = verts.copy()
    T = tets.shape[0]
    order = np.argsort(tets.reshape(-1), kind="stable")
    flat_t = np.repeat(np.arange(T), 4)[order]
    counts = np.bincount(tets.reshape(-1), minlength=verts.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)])

    def incident(vids):
        return np.unique(np.concatenate(
            [flat_t[starts[v]:starts[v + 1]] for v in vids])) \
            if len(vids) else np.empty((0,), np.int64)

    for _ in range(iters):
        v4 = verts[tets]
        bad = np.where(_quality_of(v4, _volumes_of(v4)) < q_min)[0]
        if bad.size == 0:
            break
        region = np.unique(tets[incident(np.unique(tets[bad]))].reshape(-1))
        movable = region[region >= n_fixed]
        moved = False
        for vid in movable:
            inc_t = tets[flat_t[starts[vid]:starts[vid + 1]]]
            nbr = np.unique(inc_t.reshape(-1))
            nbr = nbr[nbr != vid]
            old = verts[vid].copy()
            cur = verts[inc_t]
            qi = _quality_of(cur, _volumes_of(cur))
            lap = verts[nbr].mean(axis=0)
            wt = inc_t[qi.argmin()]
            opp = wt[wt != vid][:3]
            a = verts[opp[1]] - verts[opp[0]]
            b = verts[opp[2]] - verts[opp[0]]
            nrm = np.array([a[1] * b[2] - a[2] * b[1],
                            a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])
            nn = np.linalg.norm(nrm)
            nrm = nrm / nn if nn > 1e-30 else np.zeros(3)
            cands = [old + s * (lap - old) for s in (1.0, 0.5, 0.25)]
            cands += [old + s * h * nrm for s in (0.3, -0.3, 0.6, -0.6)]
            at = (inc_t == vid)[None, :, :, None]
            v7 = np.where(at, np.asarray(cands)[:, None, None, :],
                          cur[None]).reshape(-1, 4, 3)
            vol7 = _volumes_of(v7)
            q7 = _quality_of(v7, vol7).reshape(len(cands), -1)
            vol7 = vol7.reshape(len(cands), -1)
            best_q, best_p = qi.min(), None
            for k, p in enumerate(cands):
                if (vol7[k] > 0).all() and q7[k].min() > best_q:
                    best_q, best_p = q7[k].min(), p
            verts[vid] = best_p if best_p is not None else old
            moved |= best_p is not None
        if not moved:
            break
    return verts


def tet_ball(h: float, radius: float, min_surface_points: int = 64):
    """A tetrahedralised ball at the origin: (verts (N,3) f64, tets (T,4)
    int64), positively oriented; Fibonacci surface samples, an offset layer
    beneath them and a jittered BCC interior, Delaunay, boundary slivers
    peeled and interior slivers relaxed."""
    from scipy.spatial import Delaunay

    n = max(min_surface_points,
            int(round(4.0 * math.pi * radius * radius
                      / (math.sqrt(3.0) / 2.0 * h * h))))
    surf = _fibonacci_sphere(n, radius)
    normals = surf / max(radius, 1e-12)
    rng = np.random.default_rng(12345)
    layer = surf - 0.6 * h * normals
    layer = layer + rng.uniform(-0.1 * h, 0.1 * h, size=layer.shape)
    a = 1.05 * h
    axes = [np.arange(-radius - a, radius + 2 * a, a) for _ in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    lattice = np.concatenate([g, g + 0.5 * a], axis=0)
    inner = lattice[np.linalg.norm(lattice, axis=-1) - radius < -1.1 * h]
    inner = inner + rng.uniform(-0.08 * h, 0.08 * h, size=inner.shape)
    verts = np.concatenate([surf, layer, inner], axis=0)
    tets = Delaunay(verts).simplices.astype(np.int64)
    vol = _volumes_of(verts[tets])
    flip = vol < 0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    vol = np.abs(vol)
    sd_cc = np.linalg.norm(_circumcenters(verts, tets), axis=-1) - radius
    bad = (vol < 5e-3 * h ** 3) & (sd_cc > -0.1 * h)
    tets = tets[(vol > 1e-8 * h ** 3) & ~bad]
    return _repair_slivers(verts, tets, n_fixed=surf.shape[0], h=h), tets


def sphere_centres(assumed: dict, rng: np.random.Generator) -> np.ndarray:
    """The key points of the 18-sphere layout (``write_multisphere_key_
    points``: a golden spiral of ``spheres`` points), at a radius drawn
    within ``sphere_layout_radius`` and turned by a drawn rotation."""
    n = int(assumed["spheres"])
    lo, hi = assumed["sphere_layout_radius"]
    _, _, c = fibonacci_views(n, radius=float(rng.uniform(lo, hi)))
    return c @ random_rotation(rng).T


def sphere_mesh(assumed: dict, rng: np.random.Generator):
    """The spheres' tet mesh: one ball of ``sphere_radius`` meshed at the
    edge length the geometry would take, placed at each centre. Returns
    (verts (N,3) f64, tets (T,4) int64, per-sphere vertex id lists,
    per-sphere local tet lists), the layout of the geometry's precomputed
    mesh path."""
    r = float(assumed["sphere_radius"])
    bv, bt = tet_ball(target_edge_length(r), r)
    centres = sphere_centres(assumed, rng)
    verts = np.concatenate([bv + c for c in centres])
    tets = np.concatenate([bt + i * bv.shape[0] for i in range(len(centres))])
    vtx_idx = [list(range(i * bv.shape[0], (i + 1) * bv.shape[0]))
               for i in range(len(centres))]
    return verts, tets, vtx_idx, [bt.tolist()] * len(centres)


def write_sphere_cache(folder: str, verts, tets, vtx_idx, elem_idx) -> None:
    """The files the geometry's precomputed-mesh path reads."""
    os.makedirs(folder, exist_ok=True)
    np.save(os.path.join(folder, "final_tet_v.npy"), verts)
    np.save(os.path.join(folder, "final_tet_t.npy"), tets)
    for name, obj in (("spheres_vtx_idx.json", vtx_idx),
                      ("spheres_elem_idx.json", elem_idx)):
        with open(os.path.join(folder, name), "w") as fh:
            json.dump(obj, fh)


# ---------------------------------------------------------------------------
# the target: an ellipsoid, ray cast per pixel
# ---------------------------------------------------------------------------

def ellipsoid_of(assumed: dict, rng: np.random.Generator):
    """(axes (3,), rotation (3,3), albedo phases (3,)) of the target drawn
    from the configuration's ranges."""
    axes = np.asarray(assumed["target_axes"], np.float64)
    j = float(assumed["target_axes_jitter"])
    axes = axes * rng.uniform(1.0 - j, 1.0 + j, size=3)
    return axes, random_rotation(rng), rng.uniform(0, 2 * math.pi, size=3)


@torch.no_grad()
def render_targets(assumed: dict, ellipsoid, mvp, campos, resolution: int,
                   depth_normal: bool, device) -> dict:
    """The target images of the ellipsoid, ray cast in float64: "rgba"
    (B,H,W,4) uint8 (colour at the hits of a pixel's 2 x 2 subsamples,
    alpha their share), and with ``depth_normal`` "depth" (B,H,W) f32 (the
    distance from the camera to the pixel centre's hit) and "normal"
    (B,H,W,4) f32 (the unit normal there, z negated as the GSO convention
    has it, then the alpha), 0 where the centre misses. Pixel (r, c) has
    NDC centre ((c+.5)/W*2-1, (r+.5)/H*2-1), as the program renders."""
    axes, R, phase = ellipsoid
    dt = torch.float64
    res = int(resolution)
    A = torch.as_tensor(axes, dtype=dt, device=device)
    Rt = torch.as_tensor(R, dtype=dt, device=device)
    ph = torch.as_tensor(phase, dtype=dt, device=device)
    light = torch.as_tensor(np.asarray(assumed["light_dir"], np.float64),
                            device=device)
    light = light / torch.linalg.norm(light)
    freq = float(assumed["target_albedo_frequency"])
    mvp_t = torch.as_tensor(np.asarray(mvp, np.float64), device=device)
    cam = torch.as_tensor(np.asarray(campos, np.float64), device=device)
    idx = (torch.arange(res, dtype=dt, device=device) + 0.5) / res * 2 - 1
    sub = torch.tensor([-0.25, 0.25], dtype=dt, device=device) * 2 / res
    out = {"rgba": [], "depth": [], "normal": []}

    def cast(inv, o, x, y):
        """Hit mask, distance, world point and world normal of the rays
        through NDC (x, y) (any shape) of one view."""
        far = torch.stack([x, y, torch.ones_like(x), torch.ones_like(x)], -1)
        p = far @ inv.T
        d = p[..., :3] / p[..., 3:4] - o
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        q = (o @ Rt) / A
        e = (d @ Rt) / A
        a2 = torch.sum(e * e, -1)
        b2 = torch.sum(e * q, -1)
        c2 = torch.sum(q * q) - 1.0
        disc = b2 * b2 - a2 * c2
        t = (-b2 - torch.sqrt(torch.clamp_min(disc, 0.0))) / a2
        hit = (disc >= 0) & (t > 0)
        pw = o + t[..., None] * d
        nrm = ((pw @ Rt) / (A * A)) @ Rt.T
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        return hit, t, pw, nrm

    def shade(pw, nrm):
        lam = torch.clamp(torch.abs(nrm @ light), 0.2, 1.0)[..., None]
        albedo = 0.55 + 0.35 * torch.sin(freq * pw + ph)
        return lam * albedo

    invs = torch.linalg.inv(mvp_t)
    y, x = torch.meshgrid(idx, idx, indexing="ij")
    for b in range(invs.shape[0]):
        o = cam[b]
        rgb = torch.zeros((res, res, 3), dtype=dt, device=device)
        cov = torch.zeros((res, res), dtype=dt, device=device)
        for dy in sub:
            for dx in sub:
                hit, _, pw, nrm = cast(invs[b], o, x + dx, y + dy)
                h = hit.to(dt)
                cov = cov + h
                rgb = rgb + shade(pw, nrm) * h[..., None]
        col = rgb / torch.clamp_min(cov, 1.0)[..., None]
        alpha = cov / 4.0
        rgba = torch.cat([col, alpha[..., None]], -1)
        out["rgba"].append(torch.round(torch.clamp(rgba, 0, 1) * 255)
                           .to(torch.uint8).cpu())
        if depth_normal:
            hit, t, pw, nrm = cast(invs[b], o, x, y)
            h = hit.to(dt)
            out["depth"].append((torch.linalg.norm(pw - o, dim=-1) * h)
                                .float().cpu())
            nz = nrm * torch.tensor([1.0, 1.0, -1.0], dtype=dt,
                                    device=device) * h[..., None]
            out["normal"].append(torch.cat([nz, alpha[..., None]], -1)
                                 .float().cpu())
    return {k: torch.stack(v).numpy() for k, v in out.items() if v}


def write_dataset(folder: str, targets: dict, mvp, mv) -> None:
    """The Mitsuba layout the program's loader reads: ``img_rgba_{i}.png``,
    ``mvp_mtx_{i}.npy``, ``mv_{i}.npy`` and, where the targets have them,
    ``depth_{i}.npy`` and ``normal_{i}.npy``."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    for i in range(targets["rgba"].shape[0]):
        Image.fromarray(targets["rgba"][i]).save(
            os.path.join(folder, f"img_rgba_{i}.png"), compress_level=1)
        np.save(os.path.join(folder, f"mvp_mtx_{i}.npy"),
                np.asarray(mvp[i], np.float32))
        np.save(os.path.join(folder, f"mv_{i}.npy"),
                np.asarray(mv[i], np.float32))
        if "depth" in targets:
            np.save(os.path.join(folder, f"depth_{i}.npy"),
                    targets["depth"][i])
            np.save(os.path.join(folder, f"normal_{i}.npy"),
                    targets["normal"][i])


# ---------------------------------------------------------------------------
# the colour field's shapes
# ---------------------------------------------------------------------------

def field_shapes(material: dict) -> dict:
    """{leaf path: shape} of the colour field the configuration states:
    the hash table (levels x 2^log2_hashmap_size, features) and the MLP's
    (in, out) weights and biases."""
    enc = material["pos_encoding_config"]
    mlp = material["mlp_network_config"]
    feat = int(enc["n_features_per_level"])
    dims = [int(enc["n_levels"]) * feat] \
        + [int(mlp["n_neurons"])] * int(mlp["n_hidden_layers"]) \
        + [int(material["n_output_dims"])]
    shapes = {("encoding", "table"): (int(enc["n_levels"])
                                      << int(enc["log2_hashmap_size"]), feat)}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[("network", f"l{i}_w")] = (a, b)
        shapes[("network", f"l{i}_b")] = (b,)
    return shapes
