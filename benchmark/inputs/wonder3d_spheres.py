"""img_to_3D.yaml's inputs in the Wonder3D layout: the spheres' tet mesh in
the geometry's precomputed-mesh layout, Wonder3D's orthographic cameras,
and the ellipsoid's colour and normal maps as Wonder3D emits them (PNGs of
the traffic's ``png`` size), written where the program's
``Wonder3DDataLoader`` reads them:

  <folder>/w3d/mvp/{view}_mvp.npy
  <folder>/w3d/masked_colors1/rgb_{view}.png   colour, alpha the coverage
  <folder>/w3d/normals/normal_{view}.png       (n + 1) / 2, the same alpha
  <folder>/w3d/imgs/                           empty: the image root, whose
                                               parent holds the rest

The problem holds the targets as the dataset holds them once loaded,
computed here a second time from the written PNGs: decoded, resized
bicubically (OpenCV) to the traffic's resolution, the alpha thresholded at
0.8, the normals remapped to [-1, 1]; ``rgba`` and ``normal`` are then
(B,H,W,4) float32, and ``mv`` is ``mvp``, as the dataset has it. The
traffic's first ``views`` names of the configuration's
``data.dataset_config.camera_views`` are written and read. Geometry only:
there are no colour-field weights.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import scene
from ..reference.steps import Problem


def cameras(assumed: dict, n: int) -> np.ndarray:
    """(n,4,4) float64 orthographic mvp of the first ``n`` azimuths:
    ``diag(ortho_diag) @ look_at(eye)``, the eye at ``camera_distance`` on
    the y = 0 circle, +y up."""
    P = np.diag(np.asarray(assumed["ortho_diag"], np.float64))
    d = float(assumed["camera_distance"])
    out = []
    for az in assumed["camera_azimuths"][:n]:
        a = math.radians(float(az))
        eye = np.array([math.sin(a), 0.0, math.cos(a)]) * d
        out.append(P @ scene._look_at(eye, np.zeros(3),
                                      np.array([0.0, 1.0, 0.0])))
    return np.stack(out)


@torch.no_grad()
def render_maps(assumed: dict, ellipsoid, mvp, png: int, device) -> dict:
    """The ellipsoid's Wonder3D maps under the orthographic cameras mvp,
    ray cast in float64: "rgba" (B,png,png,4) uint8 (colour at the hits of
    a pixel's 2 x 2 subsamples, alpha their share) and "normal" (B,png,
    png,4) uint8 (the unit world normal at the pixel centre's hit, z
    negated as the program renders it, 0 where it misses, encoded (n + 1) /
    2; the same alpha). The rays are parallel: through each pixel's NDC
    centre ((c+.5)/W*2-1, (r+.5)/H*2-1), from clip z -1 toward +1, both
    unprojected by inv(mvp)."""
    axes, R, phase = ellipsoid
    dt = torch.float64
    A = torch.as_tensor(axes, dtype=dt, device=device)
    Rt = torch.as_tensor(R, dtype=dt, device=device)
    ph = torch.as_tensor(phase, dtype=dt, device=device)
    light = torch.as_tensor(np.asarray(assumed["light_dir"], np.float64),
                            device=device)
    light = light / torch.linalg.norm(light)
    freq = float(assumed["target_albedo_frequency"])
    invs = torch.linalg.inv(torch.as_tensor(np.asarray(mvp, np.float64),
                                            device=device))
    idx = (torch.arange(png, dtype=dt, device=device) + 0.5) / png * 2 - 1
    sub = torch.tensor([-0.25, 0.25], dtype=dt, device=device) * 2 / png
    y, x = torch.meshgrid(idx, idx, indexing="ij")
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=dt, device=device)

    def cast(inv, x, y):
        """Hit mask, world point and unit world normal of the rays through
        NDC (x, y) of one view."""
        def unproject(z):
            p = torch.stack([x, y, torch.full_like(x, z),
                             torch.ones_like(x)], -1) @ inv.T
            return p[..., :3] / p[..., 3:4]
        o = unproject(-1.0)
        d = unproject(1.0) - o
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        q = (o @ Rt) / A
        e = (d @ Rt) / A
        a2 = torch.sum(e * e, -1)
        b2 = torch.sum(e * q, -1)
        c2 = torch.sum(q * q, -1) - 1.0
        disc = b2 * b2 - a2 * c2
        t = (-b2 - torch.sqrt(torch.clamp_min(disc, 0.0))) / a2
        hit = (disc >= 0) & (t > 0)
        pw = o + t[..., None] * d
        nrm = ((pw @ Rt) / (A * A)) @ Rt.T
        return hit, pw, nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)

    def u8(img):
        return torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8) \
            .cpu()

    out = {"rgba": [], "normal": []}
    for inv in invs:
        rgb = torch.zeros((png, png, 3), dtype=dt, device=device)
        cov = torch.zeros((png, png), dtype=dt, device=device)
        for dy in sub:
            for dx in sub:
                hit, pw, nrm = cast(inv, x + dx, y + dy)
                h = hit.to(dt)
                lam = torch.clamp(torch.abs(nrm @ light), 0.2, 1.0)
                albedo = 0.55 + 0.35 * torch.sin(freq * pw + ph)
                cov = cov + h
                rgb = rgb + lam[..., None] * albedo * h[..., None]
        alpha = (cov / 4.0)[..., None]
        col = rgb / torch.clamp_min(cov, 1.0)[..., None]
        hit, _, nrm = cast(inv, x, y)
        n = nrm * flip * hit.to(dt)[..., None]
        out["rgba"].append(u8(torch.cat([col, alpha], -1)))
        out["normal"].append(u8(torch.cat([(n + 1.0) / 2.0, alpha], -1)))
    return {k: torch.stack(v).numpy() for k, v in out.items()}


def loaded(path: str, res: int) -> np.ndarray:
    """A PNG as the dataset reads it: float32 in [0, 1], resized to res²
    by OpenCV's bicubic filter."""
    import cv2
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im).astype(np.float32) / 255.0
    return cv2.resize(img, (res, res), interpolation=cv2.INTER_CUBIC)


def make(cell, seed: int, folder: str, device):
    """The seed's inputs under ``folder``, seen by the traffic's first
    ``views`` Wonder3D cameras; returns the reference's Problem (without
    the configuration) and the run's overrides."""
    from PIL import Image

    assumed = cell.config["assumed"]
    n = int(cell.traffic["views"])
    names = list(cell.config["data"]["dataset_config"]["camera_views"])
    if n > min(len(names), len(assumed["camera_azimuths"])):
        raise ValueError(f"{n} views asked of a layout of {len(names)}")
    names = names[:n]
    res, png = int(cell.traffic["resolution"]), int(cell.traffic["png"])
    mvp = cameras(assumed, n).astype(np.float32)
    verts, tets, vtx_idx, elem_idx = scene.sphere_mesh(
        assumed, scene.rng_of(seed, 1))
    maps = render_maps(assumed, scene.ellipsoid_of(assumed,
                                                   scene.rng_of(seed, 2)),
                       mvp, png, device)
    root = os.path.join(folder, "w3d")
    for d in ("mvp", "masked_colors1", "normals", "imgs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rgba, normal = [], []
    for i, v in enumerate(names):
        np.save(os.path.join(root, "mvp", f"{v}_mvp.npy"), mvp[i])
        colour = os.path.join(root, "masked_colors1", f"rgb_{v}.png")
        nmap = os.path.join(root, "normals", f"normal_{v}.png")
        Image.fromarray(maps["rgba"][i]).save(colour, compress_level=1)
        Image.fromarray(maps["normal"][i]).save(nmap, compress_level=1)
        img = loaded(colour, res)
        img[..., 3] = np.where(img[..., 3] < 0.8, 0.0, 1.0)
        nrm = loaded(nmap, res)
        nrm[..., :3] = (nrm[..., :3] - 0.5) * 2.0
        rgba.append(img)
        normal.append(nrm)
    scene.write_sphere_cache(os.path.join(folder, "cache"), verts, tets,
                             vtx_idx, elem_idx)
    overrides = {"data.dataset_config.image_root": os.path.join(root,
                                                                "imgs"),
                 "data.dataset_config.camera_mvp_root": os.path.join(root,
                                                                     "mvp"),
                 "data.dataset_config.camera_views": names,
                 "data.dataset_config.resolution": res,
                 "geometry.tetwild_cache_folder": os.path.join(folder,
                                                               "cache"),
                 "output_path": os.path.join(folder, "out")}
    prob = Problem(verts=verts, tets=tets, n_spheres=len(vtx_idx), mvp=mvp,
                   mv=mvp, rgba=np.stack(rgba), depth=None,
                   normal=np.stack(normal), cfg={})
    return prob, overrides
