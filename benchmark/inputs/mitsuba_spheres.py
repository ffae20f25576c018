"""gso.yaml's inputs: the spheres' tet mesh in the geometry's
precomputed-mesh layout, golden-spiral perspective cameras, and the
ellipsoid's targets written in the Mitsuba layout the program's loader
reads; the colour field's weights drawn on the device."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import scene
from ..reference.steps import Problem


def make(cell, seed: int, folder: str, device):
    """The seed's inputs under ``folder``, seen by the traffic's views on
    the golden spiral at the configuration's camera radius; returns the
    reference's Problem (without the configuration) and the run's
    overrides."""
    assumed = cell.config["assumed"]
    mvp, mv, campos = scene.fibonacci_views(
        int(cell.traffic["views"]), radius=float(assumed["camera_radius"]))
    verts, tets, vtx_idx, elem_idx = scene.sphere_mesh(
        assumed, scene.rng_of(seed, 1))
    dn = bool(cell.traffic.get("depth_normal", False))
    targets = scene.render_targets(
        assumed, scene.ellipsoid_of(assumed, scene.rng_of(seed, 2)), mvp,
        campos, int(cell.traffic["resolution"]), dn, device)
    scene.write_dataset(os.path.join(folder, "img"), targets, mvp, mv)
    scene.write_sphere_cache(os.path.join(folder, "cache"), verts, tets,
                             vtx_idx, elem_idx)
    overrides = {"data.dataset_config.image_root": os.path.join(folder,
                                                                "img"),
                 "geometry.tetwild_cache_folder": os.path.join(folder,
                                                               "cache"),
                 "output_path": os.path.join(folder, "out")}
    prob = Problem(verts=verts, tets=tets, n_spheres=len(vtx_idx),
                   mvp=mvp.astype(np.float32), mv=mv.astype(np.float32),
                   rgba=targets["rgba"], depth=targets.get("depth"),
                   normal=targets.get("normal"), cfg={})
    return prob, overrides


@torch.no_grad()
def weights(material: dict, seed: int, device) -> dict:
    """The colour field's starting weights on ``device``, from the seed: the
    table uniform in +-1e-4, the weights He-normal, the biases 0 (the
    initialisation tiny-cuda-nn and the reference trainer use)."""
    gen = torch.Generator(device=device).manual_seed(
        scene.torch_seed_of(seed, 7))
    out = {"encoding": {}, "network": {}}
    for (group, name), shape in scene.field_shapes(material).items():
        if name == "table":
            t = torch.rand(shape, generator=gen, device=device) * 2e-4 - 1e-4
        elif name.endswith("_w"):
            t = torch.randn(shape, generator=gen, device=device) \
                * math.sqrt(2.0 / shape[0])
        else:
            t = torch.zeros(shape, device=device)
        out[group][name] = t
    return out
