"""Ray-traced ground truth: a visibility machine independent of the
rasterizer (port of ``tssplat_tpu/tools/raytrace.py``).

The reference renders its targets with Mitsuba 3: a ``path`` integrator
over a diffuse BSDF under a hidden constant environment emitter, with an
AOV pass for depth and the geometric normal (reference
data/render_dataset.py:190-235). This module writes the same dataset
layout by casting rays through every pixel (``ops/queries.py``,
Möller–Trumbore), sharing no visibility code with the rasterizer:

  - alpha  = the fraction of the spp subpixel rays that hit (area sampling);
  - depth  = the mean camera distance over the hitting rays;
  - normal = the interpolated vertex normal at the hit (normalised mean),
             or the face normal with ``geo_normal_aov`` (the reference's
             ``nn:geo_normal`` AOV);
  - colour = ``"lambert"``: one directional light, clip(|n . l|, 0.2, 1)
             x the albedo, as ``tools/synthetic.py`` shades; or ``"path"``:
             the reference's transport, cosine-sampled bounces to
             ``max_depth`` under a white environment (radiance = albedo on
             a convex body).

Rays come from unprojecting the pixels through inv(mvp), not from the
rasterizer's forward mapping. The path integrator draws from a
``torch.Generator``; JAX's ``jax.random`` streams cannot be reproduced, so
its results agree with the JAX package's in distribution, not draw for
draw.

CLI: python -m tssplat_torch.tools.raytrace --mesh model.obj --save_path out/
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.tet_geometry import compute_vertex_normals
from ..mesh.io import load_obj
from ..ops.queries import (cross3, dot3, ray_mesh_first_hit,
                           ray_mesh_hit_full)
from ..ops.transform import fibonacci_views


def _subpixel_offsets(spp: int):
    """Stratified subpixel pattern (spp,2), fractions of a pixel
    (``_subpixel_offsets``, raytrace.py:49); spp a square number."""
    n = int(round(spp ** 0.5))
    if n * n != spp:
        raise ValueError("spp must be a square number (1, 4, 9, …)")
    g = (np.arange(n) + 0.5) / n
    ox, oy = np.meshgrid(g, g)
    return np.stack([ox.ravel(), oy.ravel()], axis=-1)


def _unit(x: torch.Tensor, floor: float) -> torch.Tensor:
    return x / torch.clamp_min(torch.sqrt(dot3(x, x)), floor)[:, None]


def raytrace_views_of_mesh(verts, faces, mvp, campos, resolution: int,
                           spp: int = 4,
                           light_dir=(0.3, 0.4, 0.85),
                           base_color=(0.8, 0.8, 0.8),
                           shadows: bool = False,
                           ray_chunk: int = 1 << 20,
                           integrator: str = "lambert",
                           max_depth: int = 8,
                           vertex_colors=None,
                           geo_normal_aov: bool = False,
                           seed: int = 0,
                           generator: Optional[torch.Generator] = None,
                           device: DeviceLike = None):
    """Ray-trace RGBA (B,H,W,4), depth (B,H,W) and normal (B,H,W,3) numpy
    f32 images of a fixed surface mesh for the views mvp (B,4,4) from
    campos (B,3), as ``raytrace_views_of_mesh`` (raytrace.py:59) does, on
    ``device``: one view at a time, all its subpixel rays in batches of
    ``ray_chunk`` (a view of 512² at spp 4 in one; the JAX package casts
    65,536 at a time, which changes no result of the lambert integrator).

    ``integrator="path"`` unrolls ``max_depth`` cosine-sampled bounces with
    per-ray alive masks (a bounce ray that escapes adds its throughput x
    the environment's 1); its draws come from ``generator`` (one on the
    device seeded with ``seed`` when None). ``vertex_colors`` (N,3 in
    [0, 1]) interpolates a per-vertex albedo, else ``base_color``."""
    dev = resolve_device(device)
    if integrator not in ("lambert", "path"):
        raise ValueError(f"unknown integrator {integrator!r}")
    H = W = int(resolution)
    v = torch.as_tensor(np.asarray(verts), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    v_nrm = compute_vertex_normals(v, f)
    ld = np.asarray(light_dir, np.float64)
    ld = torch.as_tensor(ld / np.linalg.norm(ld), dtype=torch.float32,
                         device=dev)
    base = torch.as_tensor(base_color, dtype=torch.float32, device=dev)
    v_col = (None if vertex_colors is None else torch.as_tensor(
        np.asarray(vertex_colors), dtype=torch.float32, device=dev))
    if integrator == "path" and generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))

    offs = _subpixel_offsets(spp)
    mvp = np.asarray(mvp, np.float64)
    inv_mvp = torch.as_tensor(np.linalg.inv(mvp), device=dev)  # (B,4,4) f64
    cols = torch.arange(W, dtype=torch.float64, device=dev)
    rows = torch.arange(H, dtype=torch.float64, device=dev)

    def rays_for_view(ivm, cam):
        """Unit directions (spp*H*W,3) f32 through every pixel, offset by
        offset, unprojected in float64 on the device; row 0 at NDC y = -1,
        the dataset's convention."""
        dirs = []
        for off in offs:
            x = ((cols[None, :] + float(off[0])) / W * 2.0 - 1.0) \
                .expand(H, W).reshape(-1)
            y = ((rows[:, None] + float(off[1])) / H * 2.0 - 1.0) \
                .expand(H, W).reshape(-1)
            near = torch.stack([x, y, torch.full_like(x, -0.9),
                                torch.ones_like(x)], dim=-1)   # (HW,4)
            p = near @ ivm.T
            d = p[:, :3] / p[:, 3:4] - cam[None, :]
            dirs.append(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
        return torch.cat(dirs).float()

    def geo_normal(tids):
        tri = v[f[tids]]                                 # (R,3,3)
        return _unit(cross3(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                     1e-12)

    def bary(attr, tids, u, vv):
        a = attr[f[tids]]                                # (R,3,C)
        w0 = 1.0 - u - vv
        return (a[:, 0] * w0[:, None] + a[:, 1] * u[:, None]
                + a[:, 2] * vv[:, None])

    def shading_normal(tids, u, vv):
        return _unit(bary(v_nrm, tids, u, vv), 1e-8)

    def albedo(tids, u, vv):
        if v_col is None:
            return base[None, :].expand(tids.shape[0], 3)
        return bary(v_col, tids, u, vv)

    def cosine_sample(n):
        """Cosine-weighted directions about unit normals n (R,3), Duff et
        al.'s branchless orthonormal basis."""
        u12 = torch.rand((2, n.shape[0]), generator=generator,
                         device=generator.device).to(dev)
        r = torch.sqrt(u12[0])
        phi = 2.0 * math.pi * u12[1]
        s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + n[:, 2])
        bb = n[:, 0] * n[:, 1] * a
        t1 = torch.stack([1.0 + s * n[:, 0] ** 2 * a, s * bb, -s * n[:, 0]],
                         dim=-1)
        t2 = torch.stack([bb, s + n[:, 1] ** 2 * a, -n[:, 1]], dim=-1)
        x = r * torch.cos(phi)
        y = r * torch.sin(phi)
        z = torch.sqrt(torch.clamp_min(1.0 - u12[0], 0.0))
        return t1 * x[:, None] + t2 * y[:, None] + n * z[:, None]

    def facing(gn, d):
        """-sign(gn . d) (R,1), +1 where it is 0: the side the ray came
        from."""
        sgn = -torch.sign(dot3(gn, d))[:, None]
        return torch.where(sgn == 0.0, 1.0, sgn)

    def shade(origin, dirs):
        t, tid, u, vv = ray_mesh_hit_full(origin, dirs, v, f)
        hit = torch.isfinite(t)
        tids = torch.clamp_min(tid, 0).long()
        t0 = torch.where(hit, t, 0.0)
        nrm = shading_normal(tids, u, vv)
        lam = torch.clamp(torch.abs(dot3(nrm, ld[None])), 0.2, 1.0)
        if shadows:
            so = origin + dirs * t0[:, None] + nrm * 1e-3
            ts = ray_mesh_first_hit(so, ld[None].expand_as(so), v, f)
            lam = torch.where(torch.isfinite(ts), 0.2, lam)
        color = lam[:, None] * albedo(tids, u, vv)
        aov_n = geo_normal(tids) if geo_normal_aov else nrm
        hitf = hit.float()
        return color * hitf[:, None], t0, aov_n * hitf[:, None], hitf

    def shade_path(origin, dirs):
        t, tid, u, vv = ray_mesh_hit_full(origin, dirs, v, f)
        hit = torch.isfinite(t)
        tids = torch.clamp_min(tid, 0).long()
        t0 = torch.where(hit, t, 0.0)
        sn = shading_normal(tids, u, vv)
        gn = geo_normal(tids)
        aov_n = gn if geo_normal_aov else sn
        # both normals turned toward the incoming ray (two-sided diffuse;
        # the offset leaves on the side the ray came from)
        sgn = facing(gn, dirs)
        cur_n = sn * sgn
        tp = albedo(tids, u, vv) * hit[:, None].float()
        res = torch.zeros_like(tp)
        o = origin + dirs * t0[:, None] + gn * sgn * 1e-3
        alive = hit
        for _ in range(max_depth):
            d = cosine_sample(cur_n)
            t2, tid2, u2, v2 = ray_mesh_hit_full(o, d, v, f)
            h2 = torch.isfinite(t2)
            esc = alive & ~h2
            res = res + torch.where(esc[:, None], tp, 0.0)  # env radiance 1
            alive = alive & h2
            tids2 = torch.clamp_min(tid2, 0).long()
            gn2 = geo_normal(tids2)
            sgn2 = facing(gn2, d)
            tp = tp * albedo(tids2, u2, v2)
            o = o + d * torch.where(h2, t2, 0.0)[:, None] + gn2 * sgn2 * 1e-3
            cur_n = shading_normal(tids2, u2, v2) * sgn2
        # rays still alive at the truncation add nothing more
        hitf = hit.float()
        return res * hitf[:, None], t0, aov_n * hitf[:, None], hitf

    B = mvp.shape[0]
    rgba_out = np.zeros((B, H, W, 4), np.float32)
    depth_out = np.zeros((B, H, W), np.float32)
    nrm_out = np.zeros((B, H, W, 3), np.float32)
    n_rays = H * W
    fn = shade_path if integrator == "path" else shade
    for b in range(B):
        cam = torch.as_tensor(np.asarray(campos[b], np.float64), device=dev)
        cam_t = cam.float()
        # every subpixel offset's rays in one batch, split at ray_chunk
        dirs = rays_for_view(inv_mvp[b], cam)
        parts = [fn(cam_t[None].expand(dirs[k:k + ray_chunk].shape[0], 3),
                    dirs[k:k + ray_chunk])
                 for k in range(0, dirs.shape[0], ray_chunk)]
        c, dep, n, a = (torch.cat(x).reshape((spp, n_rays) + x[0].shape[1:])
                        for x in zip(*parts))
        # summed offset by offset, as the JAX package accumulates them
        acc_c, acc_d, acc_n, acc_a = c[0], dep[0], n[0], a[0]
        for i in range(1, spp):
            acc_c, acc_d = acc_c + c[i], acc_d + dep[i]
            acc_n, acc_a = acc_n + n[i], acc_a + a[i]
        acc_c, acc_d, acc_n, acc_a = (x.cpu().numpy()
                                      for x in (acc_c, acc_d, acc_n, acc_a))
        alpha = acc_a / spp
        nhit = np.maximum(acc_a, 1.0)
        rgba_out[b, ..., :3] = (acc_c / spp).reshape(H, W, 3)
        rgba_out[b, ..., 3] = alpha.reshape(H, W)
        depth_out[b] = (acc_d / nhit).reshape(H, W)
        nv = acc_n / nhit[:, None]
        nv = nv / np.maximum(np.linalg.norm(nv, axis=-1, keepdims=True),
                             1e-8) * (acc_a > 0)[:, None]
        nrm_out[b] = nv.reshape(H, W, 3)
    return rgba_out, depth_out, nrm_out


def write_raytraced_dataset(out_dir: str, verts, faces, n_views: int = 120,
                            resolution: int = 512, radius: float = 4.0,
                            spp: int = 4, shadows: bool = False,
                            integrator: str = "lambert",
                            max_depth: int = 8,
                            vertex_colors=None,
                            geo_normal_aov: bool = False,
                            device: DeviceLike = None) -> None:
    """Write the reference dataset layout (``img_rgba_{i}.png``,
    ``depth_{i}.npy``, ``normal_{i}.npy`` with alpha as its 4th channel,
    ``mvp_mtx_{i}.npy``, ``mv_{i}.npy``; reference data/render_dataset.py:
    264-299) of the mesh seen from ``fibonacci_views(n_views, radius)``,
    ray-traced on ``device`` (``write_raytraced_dataset``,
    raytrace.py:276)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    mvp, mv, campos = fibonacci_views(n_views, radius=radius)
    rgba, depth, normal = raytrace_views_of_mesh(
        verts, faces, mvp, campos, resolution, spp=spp, shadows=shadows,
        integrator=integrator, max_depth=max_depth,
        vertex_colors=vertex_colors, geo_normal_aov=geo_normal_aov,
        device=device)
    for i in range(n_views):
        img = np.clip(rgba[i] * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(
            os.path.join(out_dir, f"img_rgba_{i}.png"))
        np.save(os.path.join(out_dir, f"mvp_mtx_{i}.npy"),
                mvp[i].astype(np.float32))
        np.save(os.path.join(out_dir, f"mv_{i}.npy"),
                mv[i].astype(np.float32))
        np.save(os.path.join(out_dir, f"depth_{i}.npy"),
                depth[i].astype(np.float32))
        np.save(os.path.join(out_dir, f"normal_{i}.npy"),
                np.concatenate([normal[i], rgba[i][..., 3:4]],
                               axis=-1).astype(np.float32))


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m tssplat_torch.tools.raytrace")
    p.add_argument("--mesh", required=True, help="surface OBJ to render")
    p.add_argument("--save_path", required=True)
    p.add_argument("--num_views", type=int, default=120)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--integrator", choices=("lambert", "path"),
                   default="lambert",
                   help="'path' = the reference's Mitsuba transport "
                        "(diffuse + constant env, hide_emitters)")
    p.add_argument("--max_depth", type=int, default=8)
    p.add_argument("--geo_normals", action="store_true",
                   help="write the geometric face normal AOV like the "
                        "reference's nn:geo_normal")
    args = p.parse_args(argv)
    v, f = load_obj(args.mesh)
    write_raytraced_dataset(args.save_path, v, f, n_views=args.num_views,
                            resolution=args.resolution, radius=args.radius,
                            spp=args.spp, shadows=args.shadows,
                            integrator=args.integrator,
                            max_depth=args.max_depth,
                            geo_normal_aov=args.geo_normals, device=device)


if __name__ == "__main__":
    main()
