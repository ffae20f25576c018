"""Sphere initialisation from images (port of
``tssplat_tpu/tools/init_spheres.py``): multi-view masks -> visual hull ->
medial skeleton -> MILP sphere cover -> the key-points JSON that
``TetMeshMultiSphereGeometry`` reads (reference
data/generate_init_spheres.py and data/utils.py).

  1. visual hull: a dim³ grid over [-1.2, 1.2]³ projected through every
     view's MVP on the device; a point stays where it lands on alpha > 0.01
     in every view (out-of-frame points read the border pixel); the binary
     volume is meshed by surface nets and smoothed (``voxel_mesh.py``);
  2. local shape diameter: 50 rays in a cone about each hull vertex's
     inward normal (``ops/queries.py ray_mesh_first_hit``);
  3. skeleton: gradient descent of the hull vertices on a Gaussian-smoothed
     signed distance (``ops/queries.py signed_distance``), each point frozen
     once it has travelled 0.6 of its diameter;
  4. radii: the mean distance to the 10 nearest hull vertices, times
     radius_scale plus offset;
  5. the cover: scipy's HiGHS MILP, a 20% gap pass and then an exact pass
     over what it left uncovered; final radii get offset x 0.3 more.

The device stages cast to f32 and the host stages stay f64, as in the JAX
package; the numpy generators draw what the JAX package's draw.

CLI: python -m tssplat_torch.tools.init_spheres --img_path ... --save_path ...
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..mesh.io import save_obj
from ..ops.queries import ray_mesh_first_hit, signed_distance
from .voxel_mesh import laplacian_smooth, surface_nets


def load_data(tgt_path: str):
    """Alpha masks + MVPs of the dataset layout (``load_data``,
    init_spheres.py:38; reference :112-128)."""
    from PIL import Image
    imgs, mvps = [], []
    for img_file in sorted(glob.glob(os.path.join(tgt_path, "img*rgba*.png"))):
        img = np.asarray(Image.open(img_file)).astype(np.float32) / 255.0
        img_id = os.path.basename(img_file).split(".")[0].split("_")[-1]
        mvp = np.load(os.path.join(tgt_path, f"mvp_mtx_{img_id}.npy"))
        if not np.all(np.isfinite(mvp)):
            raise ValueError(f"non-finite mvp for view {img_id}")
        imgs.append(img)
        mvps.append(mvp.astype(np.float32))
    if not imgs:
        raise ValueError(f"no views found under {tgt_path}")
    return imgs, mvps


def visual_hull(imgs, mvps, dim: int, bound: float = 1.2,
                alpha_thresh: float = 0.01, device: DeviceLike = None):
    """Binary occupancy grid of the visual hull (``visual_hull``,
    init_spheres.py:56): every grid point projected through every view at
    once on ``device``; pixel (row y, column x) from the f32 coordinates
    truncated toward zero, clamped to the frame. Returns (occ (dim,)*3
    bool, origin, spacing)."""
    dev = resolve_device(device)
    res = imgs[0].shape[0]
    lin = np.linspace(-bound, bound, dim).astype(np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    pts4 = torch.as_tensor(np.concatenate(
        [pts, np.ones_like(pts[:, :1])], axis=1), device=dev)
    alphas = torch.as_tensor(np.stack([im[..., 3] for im in imgs]),
                             device=dev)                 # (V,H,W)
    mvp_t = torch.as_tensor(np.stack(mvps), device=dev).transpose(1, 2)
    V = alphas.shape[0]
    view = torch.arange(V, device=dev)[:, None]
    block = max(1, (1 << 24) // V)
    occ = torch.empty((pts4.shape[0],), dtype=torch.bool, device=dev)
    for s in range(0, pts4.shape[0], block):
        p = torch.matmul(pts4[s:s + block][None], mvp_t)  # (V,n,4)
        p = p / p[..., 3:4]
        coord = (p[..., 0:2] * 0.5 + 0.5) * res
        ij = torch.clamp(coord.to(torch.int32), 0, res - 1).long()
        ok = alphas[view, ij[..., 1], ij[..., 0]] > alpha_thresh
        occ[s:s + block] = ok.all(dim=0)
    spacing = 2.0 * bound / (dim - 1)
    return (occ.cpu().numpy().reshape(dim, dim, dim),
            np.asarray([-bound, -bound, -bound]), spacing)


def hull_surface_mesh(occ, origin, spacing, smooth_iters: int = 6):
    v, f = surface_nets(occ, origin, spacing)
    if f.shape[0] == 0:
        raise ValueError("visual hull is empty — check masks/cameras")
    v = laplacian_smooth(v, f, iters=smooth_iters)
    return v, f


def _vertex_normals(v, f):
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def local_shape_diameter(verts, normals, mesh_v, mesh_f,
                         dir_angle: float = np.pi / 6, num_samples: int = 50,
                         seed: int = 0, device: DeviceLike = None):
    """Mean of the cone-sampled inward ray distances, a miss counting as
    the median hit (``local_shape_diameter``, init_spheres.py:111;
    reference data/utils.py:63-122): (V,1) f64. The rays are cast in f32
    on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta = np.cos(dir_angle)
    z = rng.uniform(theta, 1.0, size=(num_samples, 1))
    ang = rng.uniform(0.0, 2 * np.pi, size=(num_samples, 1))
    cone = np.concatenate([np.sqrt(1 - z ** 2) * np.cos(ang),
                           np.sqrt(1 - z ** 2) * np.sin(ang), z], axis=1)

    # rotate the cone (about +z) onto each vertex's inward normal
    tgt = -normals
    src = np.asarray([0.0, 0.0, 1.0])
    vcross = np.cross(np.broadcast_to(src, tgt.shape), tgt)
    cc = tgt @ src
    ss2 = np.sum(vcross * vcross, axis=1)
    K = np.zeros((tgt.shape[0], 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -vcross[:, 2], vcross[:, 1]
    K[:, 1, 0], K[:, 1, 2] = vcross[:, 2], -vcross[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -vcross[:, 1], vcross[:, 0]
    R = np.eye(3)[None] + K \
        + (K @ K) * ((1 - cc) / (ss2 + 1e-8))[:, None, None]
    dirs = np.einsum("vij,sj->vsi", R, cone)             # (V,S,3)

    V, S = dirs.shape[:2]
    origins = np.repeat(verts[:, None, :], S, axis=1).reshape(-1, 3)
    # nudged off the surface so a ray does not hit its own start
    origins = origins + 1e-4 * dirs.reshape(-1, 3)
    t = ray_mesh_first_hit(
        _f32(origins, dev), _f32(dirs.reshape(-1, 3), dev), _f32(mesh_v, dev),
        torch.as_tensor(np.asarray(mesh_f), dtype=torch.int64, device=dev))
    t = t.cpu().numpy().reshape(V, S)
    finite = t[np.isfinite(t)]
    pad = np.median(finite) if finite.size else 0.1
    t = np.where(np.isfinite(t), t, pad)
    return t.mean(axis=1, keepdims=True)                 # (V,1)


def smoothed_sdf_grad(x: torch.Tensor, noise: torch.Tensor,
                      mesh_v: torch.Tensor, mesh_f: torch.Tensor
                      ) -> torch.Tensor:
    """Gradient of sum_i smoothed_sdf(x_i) (``smoothed_sdf_grad``,
    init_spheres.py:177-191): the neighbours are the detached points plus
    ``noise`` (P,k,3) and their signed distances are constants, so the
    gradient flows only through the Gaussian weights exp(-d²/0.002),
    normalised over each point's neighbours."""
    x = x.detach().requires_grad_(True)
    neighbs = x.detach()[:, None, :] + noise             # (P,k,3)
    with torch.no_grad():
        sd = signed_distance(neighbs.reshape(-1, 3), mesh_v, mesh_f) \
            .reshape(x.shape[0], -1)
    diff = x[:, None, :] - neighbs
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    w = torch.exp(-d ** 2 / 0.002)
    w = w / torch.sum(w, dim=1, keepdim=True)
    return torch.autograd.grad(torch.sum(sd * w), x)[0]


def min_sdf_skeleton(mesh_v, mesh_f, num_iter: int = 50,
                     lsds_mult: float = 0.6, alpha: float = 0.1,
                     k_neighb: int = 20, seed: int = 0,
                     device: DeviceLike = None,
                     times: Optional[dict] = None):
    """Surface points descended toward the medial axis
    (``min_sdf_skeleton``, init_spheres.py:155; reference data/utils.py:
    125-170): each iteration moves the active points by -alpha x
    ``smoothed_sdf_grad`` (noise 0.003 N(0, 1) clipped above at 0.01);
    from iteration 10 on a point freezes once it is lsds_mult x its local
    shape diameter from its start. ``times`` (optional) gets the seconds of
    the 'lsd' and 'skeleton' stages."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    verts = np.asarray(mesh_v, np.float64)
    normals = _vertex_normals(verts, mesh_f)
    lsds = local_shape_diameter(verts, normals, mesh_v, mesh_f, seed=seed,
                                device=dev)
    skel = verts - 0.5 * lsds * normals
    t1 = time.perf_counter()

    mv = _f32(mesh_v, dev)
    mf = torch.as_tensor(np.asarray(mesh_f), dtype=torch.int64, device=dev)
    rng = np.random.default_rng(seed + 1)
    active = np.arange(skel.shape[0])
    for i in range(num_iter):
        if active.size == 0:
            break
        cur = skel[active]
        noise = np.clip(0.003 * rng.standard_normal((cur.shape[0], k_neighb,
                                                     3)),
                        a_min=None, a_max=0.01)
        g = smoothed_sdf_grad(_f32(cur, dev), _f32(noise, dev), mv, mf)
        new = cur - alpha * g.cpu().numpy()

        disps = np.linalg.norm(skel - verts, axis=1)
        keep = disps < 1e3 if i < 10 else disps < lsds_mult * lsds[:, 0]
        keep_active = keep[active]
        skel[active[keep_active]] = new[keep_active]
        active = active[keep_active]
    if times is not None:
        times["lsd"] = t1 - t0
        times["skeleton"] = time.perf_counter() - t1
    return skel


def full_min_sdf_skeleton(mesh_v, mesh_f, num_iter: int = 50,
                          lsds_mult: float = 0.6, device: DeviceLike = None):
    """Deduplicated skeleton points and the skeleton edges inherited from
    the surface's edges (``full_min_sdf_skeleton``, init_spheres.py:211;
    reference data/utils.py:173-191)."""
    from scipy.spatial import KDTree

    skel = min_sdf_skeleton(mesh_v, mesh_f, num_iter=num_iter,
                            lsds_mult=lsds_mult, device=device)
    reduced = np.unique(np.round(0.5 * skel, decimals=3), axis=0) * 2
    tree = KDTree(reduced)
    _, inds = tree.query(skel)

    mesh_f = np.asarray(mesh_f)
    mesh_edges = np.unique(np.sort(np.concatenate(
        [mesh_f[:, [0, 1]], mesh_f[:, [1, 2]], mesh_f[:, [2, 0]]]), axis=1),
        axis=0)
    e = np.sort(inds[mesh_edges], axis=1)
    e = e[e[:, 0] != e[:, 1]]
    edges = np.unique(e, axis=0)
    return reduced, edges


def solve_milp(inner_set, point_set, radius_scaled, options):
    """Min-count set cover: A x >= 1 over coverage D[i,j] = (r_j > d_ij)
    (``solve_milp``, init_spheres.py:235; reference :388-420)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    dist = np.linalg.norm(point_set[:, None, :] - inner_set[None], axis=-1)
    D = (radius_scaled[None, :, 0] > dist).astype(np.int32)   # (N,Nin)

    zero_rows = np.all(D == 0, axis=1)
    if zero_rows.sum() < 200:
        D = D[~zero_rows]
        point_set = point_set[~zero_rows]

    n = inner_set.shape[0]
    res = milp(np.ones(n), integrality=np.ones(n),
               bounds=Bounds(np.zeros(n), np.ones(n)),
               constraints=LinearConstraint(D, lb=np.ones(D.shape[0])),
               options=options)
    return res, D, point_set


def select_spheres(skel, hull_v, radius_scale: float, offset: float):
    """The cover of ``generate_spheres`` (init_spheres.py:262-282;
    reference :451-506) over the skeleton candidates ``skel``: (centres,
    radii (n,1))."""
    inner_set = np.asarray(skel, np.float64)
    point_set = np.asarray(hull_v, np.float64)

    dist = np.linalg.norm(inner_set[:, None, :] - point_set[None], axis=-1)
    radius = np.sort(dist, axis=1)[:, :10].mean(axis=1, keepdims=True)
    radius_scaled = radius * radius_scale + offset

    options = {"disp": False, "time_limit": 30000, "mip_rel_gap": 0.20}
    res, D, pts_used = solve_milp(inner_set, point_set, radius_scaled, options)
    x = np.asarray([int(round(v)) for v in res.x])
    sel = np.nonzero(x)[0]

    covered = D @ x
    uncovered = pts_used[covered < 0.5]
    if uncovered.shape[0] > 0:
        options = {"disp": False, "time_limit": 30000, "mip_rel_gap": 0.0}
        res2, _, _ = solve_milp(inner_set, uncovered, radius_scaled, options)
        x2 = np.asarray([int(round(v)) for v in res2.x])
        sel = np.concatenate([sel, np.nonzero(x2)[0]])

    final_radius = radius_scaled + offset * 0.3          # (:501-504)
    return inner_set[sel], final_radius[sel]


def generate_spheres(hull_v, hull_f, radius_scale: float, offset: float,
                     save_path: str, num_iter: int = 50,
                     device: DeviceLike = None,
                     times: Optional[dict] = None):
    """Skeleton candidates -> radii -> the two-phase MILP cover
    (``generate_spheres``, init_spheres.py:256). ``times`` (optional) gets
    the seconds of 'lsd', 'skeleton' and 'milp'."""
    skel = min_sdf_skeleton(hull_v, hull_f, num_iter=num_iter, device=device,
                            times=times)
    t0 = time.perf_counter()
    out = select_spheres(skel, hull_v, radius_scale, offset)
    if times is not None:
        times["milp"] = time.perf_counter() - t0
    return out


def main_pipeline(tgt_path: str, mesh_name: str, save_path: str,
                  radius_scale: float = 1.1, offset: float = 0.06,
                  surf_res: int = 50, num_iter: int = 50,
                  device: DeviceLike = None):
    """Images of ``tgt_path`` -> ``<save_path>/<mesh_name>.json`` ({"pt",
    "r"}), ``<mesh_name>_surf.obj`` (the hull) and
    ``<mesh_name>_final_pc.obj`` (the centres); prints the seconds of each
    stage. Returns (centres, radii (n,1))."""
    dev = resolve_device(device)
    os.makedirs(save_path, exist_ok=True)
    t1 = time.time()
    times = {}

    t0 = time.perf_counter()
    imgs, mvps = load_data(tgt_path)
    occ, origin, spacing = visual_hull(imgs, mvps, surf_res, device=dev)
    times["hull"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hull_v, hull_f = hull_surface_mesh(occ, origin, spacing)
    times["surface"] = time.perf_counter() - t0

    save_obj(os.path.join(save_path, f"{mesh_name}_surf.obj"), hull_v, hull_f)

    pts, radii = generate_spheres(hull_v, hull_f, radius_scale, offset,
                                  save_path, num_iter=num_iter, device=dev,
                                  times=times)
    print(f"selected {pts.shape[0]} spheres in {time.time() - t1:.1f}s")
    print("stage seconds: " + ", ".join(
        f"{k} {times[k]:.3f}" for k in ("hull", "surface", "lsd", "skeleton",
                                        "milp"))
          + f" ({len(imgs)} views, surf_res {surf_res}: {hull_v.shape[0]} "
          f"hull vertices, {hull_f.shape[0]} faces)", flush=True)

    with open(os.path.join(save_path, f"{mesh_name}.json"), "w") as f:
        json.dump({"pt": pts.tolist(), "r": radii[:, 0].tolist()}, f, indent=4)
    save_obj(os.path.join(save_path, f"{mesh_name}_final_pc.obj"), pts,
             np.zeros((0, 3), np.int64))
    return pts, radii


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(
        prog="python -m tssplat_torch.tools.init_spheres")
    p.add_argument("--img_path", required=True, help="path to mv images")
    p.add_argument("--expr_name", default="shape")
    p.add_argument("--save_path", required=True)
    p.add_argument("--radius_scale", default=1.1, type=float)
    p.add_argument("--offset", default=0.06, type=float)
    p.add_argument("--surf_res", default=50, type=int)
    p.add_argument("--num_iter", default=50, type=int)
    args = p.parse_args(argv)
    return main_pipeline(args.img_path, args.expr_name, args.save_path,
                         radius_scale=args.radius_scale, offset=args.offset,
                         surf_res=args.surf_res, num_iter=args.num_iter,
                         device=device)


if __name__ == "__main__":
    main()
