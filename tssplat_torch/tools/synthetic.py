"""Targets of a fixed surface mesh, rendered by the port's own forward
pass (``tssplat_tpu/tools/synthetic.py``), the dataset writer, and the
scenes built on them:

  render_views_of_mesh          RGBA, depth and normal images (numpy)
  render_alpha_of_mesh          the antialiased alpha (a tensor)
  render_rgb_of_mesh            the Lambertian colour, antialiased
  write_synthetic_dataset       the on-disk layout MitsubaImgDataset reads
  write_multisphere_key_points  the key points of multisphere_scene
  bench_scene                   the benchmark's geometry and bench.py's
                                batch (one sphere, or BENCH_SPHERES)
  multisphere_scene             the production multi-sphere geometry at
                                the size where both capped visibility
                                kernels run

CLI: python -m tssplat_torch.tools.synthetic --mesh model.obj --save_path out/
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.multisphere import TetMeshMultiSphereGeometry
from ..geometry.tet_geometry import TetMeshGeometry, compute_vertex_normals
from ..mesh.io import load_obj
from ..mesh.spheres import icosphere, tet_sphere
from ..mesh.surface import triangle_edge_neighbors
from ..mesh.tetmesh import TetMesh
from ..ops.rasterize import (antialias_color, antialias_silhouette,
                             interpolate, rasterize,
                             rasterize_silhouette_with_rows)
from ..ops.transform import fibonacci_views, transform_pos


def _corner_clip(verts, faces, mvp, dev):
    faces = np.asarray(faces, np.int64)
    corners = torch.as_tensor(np.asarray(verts)[faces.reshape(-1)],
                              dtype=torch.float32, device=dev)
    pos = transform_pos(torch.as_tensor(np.asarray(mvp), dtype=torch.float32,
                                        device=dev), corners)
    return faces, corners, pos


@torch.no_grad()
def render_alpha_of_mesh(verts, faces, mvp, resolution: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Antialiased alpha (B,H,W,1) f32 of surface mesh (verts (N,3), faces
    (F,3)) for the views mvp (B,4,4), on ``device``."""
    dev = resolve_device(device)
    faces, _, pos = _corner_clip(verts, faces, mvp, dev)
    nbrs = torch.as_tensor(triangle_edge_neighbors(faces), device=dev)
    res = (int(resolution), int(resolution))
    ids, z, g6, gaux, _ = rasterize_silhouette_with_rows(pos, nbrs, res)
    return antialias_silhouette(ids, z, g6, gaux)[..., None]


def _vertex_normals_and_shade(verts, faces, pos, rast, light_dir,
                              base_color, dev):
    """Interpolated, normalised vertex normals (B,H,W,3) of the winners of
    ``rast``, and the antialiased Lambertian colour (B,H,W,3) of the JAX
    writer (tools/synthetic.py:60-69): clip(|n . l|, 0.2, 1) x base_color
    at the foreground pixels (l the normalised light direction), then the
    colour antialias."""
    v = torch.as_tensor(np.asarray(verts), dtype=torch.float32, device=dev)
    f = torch.as_tensor(faces, device=dev)
    nrm = interpolate(compute_vertex_normals(v, f)[f.reshape(-1)], rast)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                1e-8)
    ld = np.asarray(light_dir, np.float32)
    ld = torch.as_tensor(ld / np.linalg.norm(ld), device=dev)
    lam = torch.clamp(torch.abs(torch.sum(nrm * ld, dim=-1, keepdim=True)),
                      0.2, 1.0)
    color = lam * torch.tensor(base_color, dtype=torch.float32, device=dev)
    nbrs = torch.as_tensor(triangle_edge_neighbors(faces), device=dev)
    return nrm, antialias_color(color * (rast[..., 3:4] > 0), rast, pos, nbrs)


@torch.no_grad()
def _render_chunk(verts, faces, mvp, campos, resolution, light_dir,
                  base_color, dev):
    """rgba (B,H,W,4), depth (B,H,W) and normal (B,H,W,3) of one chunk of
    views, on ``dev``."""
    alpha = render_alpha_of_mesh(verts, faces, mvp, resolution, device=dev)
    faces, corners, pos = _corner_clip(verts, faces, mvp, dev)
    rast, _ = rasterize(pos, (int(resolution), int(resolution)))
    nrm, rgb = _vertex_normals_and_shade(verts, faces, pos, rast, light_dir,
                                         base_color, dev)
    fg = rast[..., 3:4] > 0
    wp = interpolate(corners, rast)
    cam = torch.as_tensor(np.asarray(campos), dtype=torch.float32, device=dev)
    depth = torch.linalg.norm(wp - cam[:, None, None, :], dim=-1) * fg[..., 0]
    return torch.cat([rgb, alpha], dim=-1), depth, nrm * fg


def render_views_of_mesh(verts, faces, mvp, campos, resolution: int,
                         light_dir=(0.3, 0.4, 0.85),
                         base_color=(0.8, 0.8, 0.8), view_chunk: int = 8,
                         device: DeviceLike = None):
    """RGBA (B,H,W,4), depth ||p - campos|| (B,H,W) and geometric normal
    (B,H,W,3) images of a fixed surface mesh as numpy float32 arrays
    (``render_views_of_mesh``, tools/synthetic.py:30): the RGB is
    ``render_rgb_of_mesh``'s antialiased Lambertian shade, the alpha
    ``render_alpha_of_mesh``'s; alpha, depth and normal are zero on
    background. Rendered on ``device`` ``view_chunk`` views at a time
    (all at once for 0), the last chunk ragged."""
    dev = resolve_device(device)
    B = np.asarray(mvp).shape[0]
    vc = min(view_chunk, B) if view_chunk else B
    outs = []
    for s in range(0, B, vc):
        outs.append([t.cpu().numpy() for t in _render_chunk(
            verts, faces, mvp[s:s + vc], campos[s:s + vc], resolution,
            light_dir, base_color, dev)])
    return tuple(np.concatenate(parts) for parts in zip(*outs))


@torch.no_grad()
def render_rgb_of_mesh(verts, faces, mvp, resolution: int,
                       light_dir=(0.3, 0.4, 0.85),
                       base_color=(0.8, 0.8, 0.8),
                       device: DeviceLike = None) -> torch.Tensor:
    """Lambertian colour (B,H,W,3) of a fixed surface mesh, as the JAX
    writer shades it (tools/synthetic.py:60-69): clip(|n . l|, 0.2, 1) x
    base_color at the foreground pixels (n the interpolated, normalised
    vertex normal, l the normalised light direction), then the colour
    antialias."""
    dev = resolve_device(device)
    faces, _, pos = _corner_clip(verts, faces, mvp, dev)
    rast, _ = rasterize(pos, (int(resolution), int(resolution)))
    return _vertex_normals_and_shade(verts, faces, pos, rast, light_dir,
                                     base_color, dev)[1]


def write_synthetic_dataset(out_dir: str, verts, faces, n_views: int = 120,
                            resolution: int = 512, radius: float = 4.0,
                            write_depth: bool = True,
                            write_normal: bool = True,
                            device: DeviceLike = None) -> None:
    """Write the reference dataset layout MitsubaImgDataset reads
    (``write_synthetic_dataset``, tools/synthetic.py:90; reference
    data/render_dataset.py:264-299) for the surface mesh (verts, faces)
    seen from ``fibonacci_views(n_views, radius)``: ``img_rgba_{i}.png``
    (``render_views_of_mesh``'s RGBA, rendered 8 views at a time as the
    JAX writer renders them, on ``device``), ``mvp_mtx_{i}.npy``,
    ``mv_{i}.npy``, ``depth_{i}.npy`` and ``normal_{i}.npy`` (normal with
    alpha as its 4th channel)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    mvp, mv, campos = fibonacci_views(n_views, radius=radius)
    rgba, depth, normal = render_views_of_mesh(verts, faces, mvp, campos,
                                               resolution, device=device)
    for i in range(n_views):
        img = np.clip(rgba[i] * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir, f"img_rgba_{i}.png"))
        np.save(os.path.join(out_dir, f"mvp_mtx_{i}.npy"),
                mvp[i].astype(np.float32))
        np.save(os.path.join(out_dir, f"mv_{i}.npy"), mv[i].astype(np.float32))
        if write_depth:
            np.save(os.path.join(out_dir, f"depth_{i}.npy"),
                    depth[i].astype(np.float32))
        if write_normal:
            np.save(os.path.join(out_dir, f"normal_{i}.npy"),
                    np.concatenate([normal[i], rgba[i][..., 3:4]],
                                   axis=-1).astype(np.float32))


def main(argv=None, device: DeviceLike = None):
    p = argparse.ArgumentParser(prog="python -m tssplat_torch.tools.synthetic")
    p.add_argument("--mesh", required=True, help="surface OBJ to render")
    p.add_argument("--save_path", required=True)
    p.add_argument("--num_views", type=int, default=120)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--radius", type=float, default=4.0)
    args = p.parse_args(argv)
    v, f = load_obj(args.mesh)
    write_synthetic_dataset(args.save_path, v, f, n_views=args.num_views,
                            resolution=args.resolution, radius=args.radius,
                            device=device)


def _ellipsoid_targets(n_views: int, subdivisions: int = 3):
    """The benchmark's target: ``icosphere(subdivisions) * (0.30, 0.24,
    0.18)`` seen from ``fibonacci_views(n_views)``: (verts, faces, mvp, mv,
    campos)."""
    sv, sf = icosphere(subdivisions=subdivisions)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, mv, campos = fibonacci_views(n_views)
    return sv, sf, mvp, mv, campos


def bench_scene(device: DeviceLike = None, n_views: int = 8,
                resolution: int = 512, edge_length: float = 0.03,
                n_spheres: int = 1, subdivisions: int = 3):
    """The benchmark scene of the repository as ``bench.py:67-106`` builds
    it: one TetSphere ``tet_sphere(edge_length, radius=0.25)`` (0.03: 4,741
    vertices, 26,426 tets, 2,012 faces), or with ``n_spheres`` > 1
    bench.py's BENCH_SPHERES geometry (``multisphere_scene``'s), fitted to
    the ellipsoid ``_ellipsoid_targets(n_views, subdivisions)`` rendered by
    ``render_views_of_mesh``. Returns (geometry, batch) on ``device``,
    batch = {"mvp" (B,4,4), "mv" (B,4,4), "campos" (B,3), "img" (B,H,W,4)
    RGBA, "background" (B,H,W,3) ones, "n" (B,H,W,4) zeros, "d" (B,H,W,1)
    depth}: the geometry stage reads the alpha (the last channel), the
    texture stage the RGB and the background."""
    dev = resolve_device(device)
    if n_spheres > 1:
        geo = _multisphere_geometry(n_spheres, dev)
    else:
        v, t = tet_sphere(edge_length, radius=0.25)
        geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                              tetmesh=TetMesh(v, t), device=dev)
    sv, sf, mvp, mv, campos = _ellipsoid_targets(n_views, subdivisions)
    rgba, depth, _ = render_views_of_mesh(sv, sf, mvp, campos, resolution,
                                          device=dev)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    shape = (n_views, int(resolution), int(resolution))
    return geo, {"mvp": on_dev(mvp), "mv": on_dev(mv),
                 "campos": on_dev(campos), "img": on_dev(rgba),
                 "background": torch.ones(shape + (3,), device=dev),
                 "n": torch.zeros(shape + (4,), device=dev),
                 "d": on_dev(depth[..., None])}


def write_multisphere_key_points(path: str, n_spheres: int = 18) -> None:
    """The key-points JSON {pt, r} of ``multisphere_scene``: ``n_spheres``
    spheres of radius 0.16 centred on ``fibonacci_views(n_spheres,
    radius=0.18)``."""
    _, _, centers = fibonacci_views(n_spheres, radius=0.18)
    with open(path, "w") as fh:
        json.dump({"pt": centers.tolist(), "r": [0.16] * n_spheres}, fh)


def _multisphere_geometry(n_spheres: int, dev: torch.device):
    """``TetMeshMultiSphereGeometry`` init path A on the key points of
    ``write_multisphere_key_points``, its files in a temporary
    directory."""
    with tempfile.TemporaryDirectory(prefix="tss_spheres_") as tmp:
        kp = os.path.join(tmp, "kp.json")
        write_multisphere_key_points(kp, n_spheres)
        return TetMeshMultiSphereGeometry(dict(
            use_smooth_barrier=True, key_points_file_path=kp,
            tetwild_cache_folder=os.path.join(tmp, "cache"),
            output_path=tmp), device=dev)


def multisphere_scene(device: DeviceLike = None, n_spheres: int = 18,
                      n_views: int = 8, resolution: int = 512):
    """The production multi-sphere geometry at benchmark views, as
    ``bench.py:67-108`` builds it with BENCH_SPHERES: ``n_spheres`` spheres
    of radius 0.16 centred on ``fibonacci_views(n_spheres, radius=0.18)``,
    through ``TetMeshMultiSphereGeometry`` init path A (18 spheres: 24,804
    vertices, 132,750 tets, 14,796 faces — the smallest such scene on which
    the JAX package takes the capped layout both with and without winner
    rows at 8 x 512²), fitted to the ellipsoid's alpha, depth and normal
    images. The key points and path A's files live in a temporary
    directory. Returns (geometry, batch) with batch = {"mvp", "campos"
    (B,3), "img" (B,H,W,1) alpha, "d" (B,H,W,1) depth, "n" (B,H,W,3)}."""
    dev = resolve_device(device)
    geo = _multisphere_geometry(n_spheres, dev)
    sv, sf, mvp, _, campos = _ellipsoid_targets(n_views)
    rgba, depth, normal = render_views_of_mesh(sv, sf, mvp, campos,
                                               resolution, device=dev)

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    batch = {"mvp": on_dev(mvp), "campos": on_dev(campos),
             "img": on_dev(rgba[..., 3:4]), "d": on_dev(depth[..., None]),
             "n": on_dev(normal)}
    return geo, batch


if __name__ == "__main__":
    main()
