"""Image-to-3D SDS driver (port of ``tssplat_tpu/train_sds.py``): fit a
TetSphere geometry under score-distillation guidance instead of
multi-view reconstruction. ``python -m tssplat_torch.train --config
<file>`` comes here when the config has an ``sds:`` block.

One iteration:
  1. sample a camera batch: ``views_per_iter`` distinct ids drawn by
     ``rng.choice`` from a numpy Generator seeded with sds_param.seed,
     among the golden-spiral ring (``ops/transform.fibonacci_views``) or,
     when ``guidance.image_root`` names a dataset (``MitsubaImgDataset``),
     among its cameras, whose alphas are then the target bank;
  2. render the chosen channel under autograd: the antialiased silhouette
     ('alpha') or the masked world normals ('normal'), in [-1, 1];
  3. the host SDS gradient w(t) (eps_hat - eps) of the image from the
     guidance model (``guidance/sds.py``), drawn from the same Generator;
  4. backward of sum(img * g) + the smooth/barrier energy, and an Adam
     step at constant ``lr`` (``optim/adam.py``, optax.adam's update).

The JAX driver renders twice, once for the host and once under jax.grad,
because jit cannot span the host call; here the one render under autograd
serves both, which is the same function. Its ``render: normal`` asks
render_views for the colour path (only_alpha off) without a material, which
raises there; here the normal channel is the shaded path's (the coverage
antialias and the interpolated vertex normals), the function the JAX
driver's comment describes. The capped layout's per-tile capacity is
validated on every camera at the start (JAX keeps its default), so no
candidate is dropped at the start.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from . import geometry as _geometry  # noqa: F401 — registers geometries
from .config import load_geometry, parse_structured
from .device import DeviceLike, resolve_device
from .guidance.sds import SDSConfig, load_guidance, sds_image_grad
from .ops.binning import default_tile_capacity
from .ops.transform import fibonacci_views
from .optim import adam, apply_updates
from .render.pipeline import render_views


class SDSState(NamedTuple):
    params: torch.Tensor       # tet_v (N,3)
    opt_state: Any             # AdamState


def render_channel(tet_v, statics, mvp, it, resolution: int, render: str,
                   tile_k=None):
    """(image in [-1, 1] (B,H,W,C), energy, n_drop (B,)): 'alpha' the
    antialiased silhouette (C = 1), 'normal' the world normals masked by
    the antialiased coverage (C = 3)."""
    if render not in ("alpha", "normal"):
        raise ValueError(f"unknown sds render channel {render!r}")
    out = render_views(tet_v, statics, mvp, it, resolution,
                       fit_normal=render == "normal", tile_k=tile_k)
    img = out.shaded * 2.0 - 1.0 if render == "alpha" \
        else out.normal * out.shaded
    return img, out.geo_regularization, out.n_drop


def sds_step(state: SDSState, statics, update_fn, guidance, sds_cfg, rng,
             mvp_all, n_ring: int, batch: int, it: int, resolution: int,
             render: str, tile_k=None):
    """One iteration (steps 1-4 of the module doc). Returns the new state,
    the image gradient g (numpy) and n_drop."""
    vi = np.sort(rng.choice(n_ring, size=batch, replace=False))
    mvp = mvp_all[torch.as_tensor(vi, device=mvp_all.device)]
    x = state.params.detach().requires_grad_(True)
    img, reg, n_drop = render_channel(x, statics, mvp, it, resolution, render,
                                      tile_k)
    g = sds_image_grad(img.detach().cpu().numpy(), guidance, sds_cfg, rng,
                       cond=vi)
    loss = torch.sum(img * torch.as_tensor(g, device=img.device)) + reg
    grad, = torch.autograd.grad(loss, [x])
    with torch.no_grad():
        updates, opt_state = update_fn(grad, state.opt_state)
        params = apply_updates(state.params, updates)
    return SDSState(params, opt_state), g, n_drop


def train_sds(cfg, device: DeviceLike = None):
    """Run the SDS fit of ``cfg`` (its ``sds`` block; ``geometry_type`` and
    ``geometry`` as in train()) on ``device`` (``cuda`` unless the caller
    asks for the CPU), export ``<output_path>/final``; returns (state,
    geometry)."""
    from .train import validated_tile_k

    dev = resolve_device(device)
    scfg = dict(cfg.get("sds", {}))
    render = scfg.get("render", "alpha")
    resolution = int(scfg.get("resolution", 64))
    n_ring = int(scfg.get("n_cameras", 24))
    batch = int(scfg.get("views_per_iter", 4))
    iters = int(scfg.get("total_num_iter", cfg.get("total_num_iter", 400)))
    lr = float(scfg.get("lr", 1e-2))
    sds_cfg = parse_structured(SDSConfig, scfg.get("sds_param"))
    out_path = cfg.get("output_path", "results/sds")
    os.makedirs(os.path.join(out_path, "final"), exist_ok=True)

    geometry_cfg = dict(cfg.geometry)
    geometry_cfg["optimize_geo"] = True
    geometry_cfg.setdefault("output_path", out_path)
    geometry = load_geometry(cfg.geometry_type)(geometry_cfg, device=dev)
    statics = geometry.statics

    gcfg = dict(scfg.get("guidance", {"type": "target_image"}))
    target_loader = scfg.get("target_loader")
    if gcfg.get("type", "target_image") == "target_image" \
            and "image_root" in gcfg:
        # distil toward a view bank on disk (e.g. Wonder3D generations):
        # the cameras are the dataset's, the targets its alphas in [-1, 1]
        from .data.datasets import MitsubaImgDataset
        ds = MitsubaImgDataset({"image_root": gcfg["image_root"]})
        mvp_np = np.stack(ds.all_mvp_mats)
        resolution = int(ds.resolution)
        bank = np.stack(ds.all_tgt_imgs)[..., 3:4] * 2.0 - 1.0
        target_loader = lambda: bank                       # noqa: E731
    else:
        mvp_np, _, _ = fibonacci_views(n_ring)
    mvp_all = torch.as_tensor(np.asarray(mvp_np), dtype=torch.float32,
                              device=dev)
    n_ring = mvp_all.shape[0]
    guidance = load_guidance(gcfg, sds_cfg, target_loader=target_loader,
                             device=dev)

    tile_k = validated_tile_k(geometry, {"mvp": mvp_all}, resolution)
    F = int(statics.surface_fid.shape[0])
    if tile_k is not None and tile_k > default_tile_capacity(
            F, (resolution, resolution)):
        print(f"tile capacity raised to {tile_k} (measured overlap over the "
              f"{n_ring} cameras)", flush=True)

    init_fn, update_fn = adam(lr)
    params = geometry.tet_v.detach().clone()
    state = SDSState(params, init_fn(params))
    rng = np.random.default_rng(sds_cfg.seed)
    log_every = int(cfg.get("log_every", 50))

    t0 = time.time()
    for it in range(iters):
        state, g, n_drop = sds_step(state, statics, update_fn, guidance,
                                    sds_cfg, rng, mvp_all, n_ring, batch, it,
                                    resolution, render, tile_k)
        if it % log_every == 0:
            print(f"sds iter={it:4d} |g_img|={np.abs(g).mean():.4e} "
                  f"[{(it + 1) / (time.time() - t0):.2f} it/s]", flush=True)
            if int(n_drop.sum()) > 0:
                print(f"WARNING: rasterizer tile-capacity overflow at iter "
                      f"{it}: {int(n_drop.sum())} candidate slots dropped",
                      flush=True)
    print(f"sds: {iters} iterations in {time.time() - t0:.3f} s", flush=True)

    geometry.set_tet_v(state.params)
    geometry.export(os.path.join(out_path, "final"), "final", save_npy=True)
    return state, geometry
