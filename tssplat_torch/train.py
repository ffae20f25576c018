"""Geometry-stage training: the train step and the driver (port of
``tssplat_tpu/train.py``, the geometry stage).

    python -m tssplat_torch.train --config configs/gso.yaml [key.sub=val ...]

One step: render the views' antialiased silhouettes (and, with
``fit_depth`` / ``fit_normal``, their depth and normal images) and the
geometry energy; loss = (MSE(alpha) x 20 [+ 100 MSE(depth x a, target x a)]
[+ normal_weight MSE(normal x a, target x a)]) x 100 + energy, a = the
target alpha (reference trainer.py:98-115, train.py:140-165); backward
through K5 -> K3 -> the screen table (and the shading gathers) -> tet_v;
the optimizer update (AdamUniform, or Adam, ``optim/``); and the best-loss
snapshot taken after the update (reference trainer.py:132-140). With
``view_chunk`` the views go through the loss in chunks whose activations
are recomputed in the backward, all but the visibility pass's outputs
(train.py:270-313).

``train(cfg)`` is the driver of ``tssplat_tpu/train.py:409-861``: the
geometry and the data loader from the config's registries, the optimizer
and its schedule, the permute-surface scheduler, the depth switch, logs,
exports, checkpoints, resume and the SIGTERM/SIGINT finish. Knobs of parts
not yet ported raise ``NotImplementedError`` (``_refuse_unported``).
"""

from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import data as _data  # noqa: F401 — registers the data loaders
from . import geometry as _geometry  # noqa: F401 — registers geometries
from .config import load_config, load_dataloader, load_geometry
from .device import DeviceLike, resolve_device
from .geometry.tet_geometry import (GeometryStatics,
                                    LinearInterpolateScheduler,
                                    geometry_forward,
                                    permute_surface_vertices)
from .ops.binning import default_tile_capacity, validate_tile_capacity
from .ops.transform import transform_pos
from .optim import (adam, adam_uniform, apply_updates, cosine_annealing_lr,
                    cosine_decay_schedule)
from .render.pipeline import render_views, render_visibility
from .utils.checkpoint import (latest_checkpoint_step, restore_checkpoint,
                               save_checkpoint)
from .utils.profiling import ThroughputMeter


class TrainState(NamedTuple):
    params: torch.Tensor               # tet_v (N,3)
    opt_state: Any                     # AdamUniformState or AdamState
    best_loss: torch.Tensor            # scalar f32
    best_iter: torch.Tensor            # scalar int32
    best_params: torch.Tensor


def init_train_state(params: torch.Tensor, init_fn: Callable) -> TrainState:
    params = params.detach().clone()
    return TrainState(
        params=params, opt_state=init_fn(params),
        best_loss=torch.tensor(float("inf"), device=params.device),
        best_iter=torch.zeros((), dtype=torch.int32, device=params.device),
        best_params=params.clone())


# the batch entries the loss reads, all view-major
_VIEW_KEYS = ("mvp", "campos", "img", "d", "n")


def _img_loss(statics: GeometryStatics, tet_v: torch.Tensor, batch: dict,
              it: int, resolution: int, is_ortho: bool, fit_depth: bool,
              fit_normal: bool, normal_weight: float,
              tile_k: Optional[int], vis=None):
    """(img_loss, energy, n_drop) of the views of ``batch``."""
    out = render_views(tet_v, statics, batch["mvp"], it, resolution,
                       campos=batch.get("campos"), fit_depth=fit_depth,
                       fit_normal=fit_normal, is_ortho=is_ortho,
                       tile_k=tile_k, vis=vis)
    img = batch["img"]
    img_loss = torch.mean((out.shaded[..., -1] - img[..., -1]) ** 2) * 20.0
    if fit_depth:
        a = img[..., -1]
        d_err = out.depth[..., -1] * a - batch["d"][..., -1] * a
        img_loss = img_loss + 100.0 * torch.mean(d_err ** 2)
    if fit_normal:
        a = img[..., -1:]
        img_loss = img_loss + normal_weight * torch.mean(
            (out.normal * a - batch["n"][..., :3] * a) ** 2)
    return img_loss, out.geo_regularization, torch.sum(out.n_drop)


def loss_and_grad(statics: GeometryStatics, tet_v: torch.Tensor,
                  batch: dict, it: int, resolution: int,
                  is_ortho: bool = False, *, fit_depth: bool = False,
                  fit_normal: bool = False, normal_weight: float = 10.0,
                  tile_k: Optional[int] = None, view_chunk: int = 0):
    """(loss, img_loss, reg, n_drop, d loss / d tet_v) of one batch.

    With ``view_chunk`` dividing the B views (and smaller than B) the loss
    runs chunk by chunk, as JAX's scan over ``jax.checkpoint``ed chunks
    (train.py:270-313): each chunk's visibility pass (binning and K1, K2a
    or K2b, at B = view_chunk) runs once, outside the checkpoint, and its
    outputs are kept; everything else in the chunk is recomputed in the
    backward (``torch.utils.checkpoint``), so peak memory is one chunk's
    activations. img_loss is the mean of the chunks' losses, n_drop their
    sum, and the energy is added once, outside the chunks."""
    x = tet_v.detach().requires_grad_(True)
    opts = (resolution, is_ortho, fit_depth, fit_normal, normal_weight,
            tile_k)
    B = batch["mvp"].shape[0]
    if view_chunk and B % view_chunk == 0 and B > view_chunk:
        no_energy = statics._replace(energy=None)

        def chunk_loss(x, cb, vis):
            il, _, nd = _img_loss(no_energy, x, cb, it, *opts, vis=vis)
            return il, nd

        total = n_drop = None
        for s in range(0, B, view_chunk):
            cb = {k: batch[k][s:s + view_chunk] for k in _VIEW_KEYS
                  if batch.get(k) is not None}
            vis = render_visibility(x, statics, cb["mvp"], resolution,
                                    shaded=fit_depth or fit_normal,
                                    is_ortho=is_ortho, tile_k=tile_k)
            # nothing in a chunk draws random numbers: no RNG state to keep
            il, nd = checkpoint(chunk_loss, x, cb, vis, use_reentrant=False,
                                preserve_rng_state=False)
            total = il if total is None else total + il
            n_drop = nd if n_drop is None else n_drop + nd
        img_loss = total / (B // view_chunk)
        reg = geometry_forward(x, statics, it).energy
    else:
        img_loss, reg, n_drop = _img_loss(statics, x, batch, it, *opts)
    loss = img_loss * 100.0 + reg
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), img_loss.detach(), reg.detach(), n_drop, grad


def make_train_step(statics: GeometryStatics, update_fn: Callable, *,
                    resolution: int, is_ortho: bool = False,
                    fit_depth: bool = False, fit_normal: bool = False,
                    normal_weight: float = 10.0,
                    tile_k: Optional[int] = None, view_chunk: int = 0):
    """Build ``step(state, batch, it) -> (state, (loss, img_loss, reg,
    n_drop))``. ``batch`` holds "mvp" (B,4,4) and "img" (B,H,W,C) whose
    last channel is the target alpha, plus "campos" (B,3) and "d"
    (B,H,W,1) for ``fit_depth`` and "n" (B,H,W,>=3) for ``fit_normal``, on
    the device of the state. ``tile_k`` is the capped layout's per-tile
    capacity (``validated_tile_k``); ``view_chunk`` as in
    ``loss_and_grad``."""

    def step(state: TrainState, batch: dict, it: int):
        loss, img_loss, reg, n_drop, grads = loss_and_grad(
            statics, state.params, batch, it, resolution, is_ortho,
            fit_depth=fit_depth, fit_normal=fit_normal,
            normal_weight=normal_weight, tile_k=tile_k,
            view_chunk=view_chunk)
        with torch.no_grad():
            updates, opt_state = update_fn(grads, state.opt_state)
            params = apply_updates(state.params, updates)
            better = loss < state.best_loss
            new_state = TrainState(
                params=params, opt_state=opt_state,
                best_loss=torch.where(better, loss, state.best_loss),
                best_iter=torch.where(better, torch.tensor(
                    it, dtype=torch.int32, device=loss.device),
                    state.best_iter),
                best_params=torch.where(better, params, state.best_params))
        return new_state, (loss, img_loss, reg, n_drop)

    return step


def validated_tile_k(geometry, batch: dict, resolution: int,
                     is_ortho: bool = False) -> Optional[int]:
    """A safe per-tile capacity of the capped layout, measured on the
    geometry's current surface in the batch's views: max(heuristic,
    next_pow2(2 x the largest per-tile overlap)). None when the resolution
    does not tile into 8x128."""
    if resolution % 128 or resolution % 8:
        return None
    with torch.no_grad():
        pos_clip = transform_pos(batch["mvp"],
                                 geometry.tet_v[geometry.statics.corner_vid],
                                 is_ortho=is_ortho)
    return validate_tile_capacity(pos_clip, (resolution, resolution))


def _validated_tile_k(geometry, dataloader, resolution: int,
                      is_ortho: bool) -> Optional[int]:
    """``validated_tile_k`` over the loader's rank-0 first batch, saying
    so when the measured overlap raises the capacity above the heuristic
    (``_validated_tile_k``, train.py:371-406)."""
    k = validated_tile_k(geometry, dataloader(0, 0, rank=0), resolution,
                         is_ortho)
    if k is None:
        return None
    F = int(geometry.statics.surface_fid.shape[0])
    k_default = default_tile_capacity(F, (resolution, resolution))
    if k > k_default:
        print(f"tile capacity raised {k_default} -> {k} (measured overlap "
              f"exceeds the density heuristic; capacity overflow would drop "
              f"triangles)", flush=True)
    return int(k)


def _auto_view_chunk(B: int, n_dev: int, resolution: int) -> int:
    """Default view-microbatch size (``_auto_view_chunk``, train.py:355):
    ~8 views per device at 512^2, scaling with 1/resolution^2; 0 when the
    whole batch already fits the target."""
    per_dev = max(1, (8 * 512 * 512) // max(resolution * resolution, 1))
    target = per_dev * n_dev
    if B <= target:
        return 0
    for c in range(target, n_dev - 1, -1):
        if B % c == 0 and c % n_dev == 0:
            return c if c < B else 0
    return 0


def run_steps(step: Callable, state: TrainState, batch: dict, start_it: int,
              n_steps: int, sync_every: int = 8
              ) -> Tuple[TrainState, list]:
    """Take ``n_steps`` steps from iteration ``start_it`` on one batch.
    Every ``sync_every`` iterations the loss is read on the host (a real
    barrier that bounds how far the host runs ahead). Returns the state and
    the per-step (loss, img_loss, reg, n_drop) tensors."""
    outs = []
    for it in range(start_it, start_it + n_steps):
        state, out = step(state, batch, it)
        outs.append(out)
        if sync_every and it % sync_every == 0:
            float(out[0])
    return state, outs


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported (ROADMAP queue 1 item "
                              f"{item})")


def _refuse_unported(cfg) -> None:
    """Raise for every knob whose part of the JAX package is not ported,
    rather than running a different path."""
    stage = cfg.get("fitting_stage", "geometry")
    if stage != "geometry":
        _not_ported(f"fitting_stage: {stage}", 3)
    material = cfg.get("material_type")
    if material not in (None, "", "None", "none"):
        _not_ported(f"material_type: {material}", 3)
    if int(cfg.get("remesh_every", 0) or 0):
        _not_ported("remesh_every", 4)
    if int(cfg.get("spatial", 0) or 0) > 1:
        _not_ported("spatial > 1", 6)
    if int(cfg.get("data", {}).get("world_size", 1)) > 1:
        _not_ported("data.world_size > 1", 6)
    for knob in ("debug_nans", "anomaly"):
        if cfg.get(knob, False):
            _not_ported(knob, 7)
    if cfg.get("sds"):
        _not_ported("sds", 8)


def train(cfg, device: DeviceLike = None):
    """Run the geometry stage of ``cfg`` on ``device`` (``cuda`` unless the
    caller asks for the CPU); returns (state, geometry). ``data_parallel``
    is accepted and has nothing to do on one device."""
    dev = resolve_device(device)
    _refuse_unported(cfg)
    verbose = cfg.get("verbose", False)
    out_path = cfg.output_path
    os.makedirs(os.path.join(out_path, "final"), exist_ok=True)

    geometry_cfg = dict(cfg.geometry)
    geometry_cfg["optimize_geo"] = True
    geometry_cfg.setdefault("output_path", out_path)
    geometry = load_geometry(cfg.geometry_type)(geometry_cfg, device=dev)

    dataloader = load_dataloader(cfg.dataloader_type)(cfg.data, device=dev)
    num_forward_per_iter = dataloader.num_forward_per_iter
    total_iters = int(cfg.total_num_iter)
    resolution = int(dataloader.data_all["resolution"])

    opt_cfg = dict(cfg.get("optimizer", {}))
    opt_type = opt_cfg.pop("type", "adam_uniform")
    # YAML 1.1 reads a number like 2e-3 (no dot) as a string
    lr = float(opt_cfg.pop("lr", 0.1))
    n_updates = total_iters * num_forward_per_iter
    if opt_type == "adam_uniform":
        init_fn, update_fn = adam_uniform(
            cosine_annealing_lr(lr, n_updates, eta_min=1e-4), **opt_cfg)
    elif opt_type == "adam":
        sched = cosine_decay_schedule(
            lr, n_updates,
            alpha=float(opt_cfg.pop("eta_min", 1e-4)) / max(lr, 1e-12))
        init_fn, update_fn = adam(sched, b1=float(opt_cfg.pop("b1", 0.9)),
                                  b2=float(opt_cfg.pop("b2", 0.999)))
    else:
        raise ValueError(f"unknown optimizer type {opt_type!r}")

    permute_scheduler = None
    if cfg.get("use_permute_surface_v", False):
        permute_scheduler = LinearInterpolateScheduler(
            **cfg.permute_surface_v_param)

    state = init_train_state(geometry.tet_v, init_fn)

    fit_depth_cfg = bool(cfg.get("fit_depth", False))
    fit_depth_start = int(cfg.get("fit_depth_starting_iter", 0))
    is_ortho = bool(cfg.get("renderer", {}).get("is_orhto", False))
    log_every = int(cfg.get("log_every", 1))
    export_every = int(cfg.get("export_every", 100))
    sync_every = int(cfg.get("sync_every", 8))
    keep = int(cfg.get("checkpoint_keep", 3))

    checkpoint_every = int(cfg.get("checkpoint_every", 0))
    ckpt_dir = os.path.join(out_path, "ckpt")
    start_iter = 0
    if cfg.get("resume", False) and \
            latest_checkpoint_step(ckpt_dir) is not None:
        start_iter, state = restore_checkpoint(ckpt_dir, state)
        start_iter += 1
        print(f"resumed from checkpoint at iter {start_iter - 1}")

    batch_size = int(cfg.data.get("batch_size", 1))
    steps = {}
    tile_k = _validated_tile_k(geometry, dataloader, resolution, is_ortho)

    vc_cfg = cfg.get("view_chunk", "auto")
    if vc_cfg == "auto":
        view_chunk = _auto_view_chunk(batch_size, 1, resolution)
    else:
        view_chunk = int(vc_cfg)
    if view_chunk and not (batch_size % view_chunk == 0
                           and batch_size > view_chunk):
        print(f"view_chunk={view_chunk} incompatible with batch "
              f"{batch_size} over 1 devices — disabled", flush=True)
        view_chunk = 0
    if view_chunk:
        print(f"view microbatching: {batch_size // view_chunk} chunks of "
              f"{view_chunk} views", flush=True)

    def get_step(fit_depth_on: bool):
        if fit_depth_on not in steps:
            steps[fit_depth_on] = make_train_step(
                geometry.statics, update_fn, resolution=resolution,
                is_ortho=is_ortho, fit_depth=fit_depth_on,
                fit_normal=bool(cfg.get("fit_normal", False)),
                normal_weight=float(cfg.get("fit_normal_weight", 10.0)),
                tile_k=tile_k, view_chunk=view_chunk)
        return steps[fit_depth_on]

    meter = ThroughputMeter()
    rays_per_forward = batch_size * resolution * resolution

    # on SIGTERM/SIGINT: finish the iteration, checkpoint, stop; the run
    # resumes with resume=true (train.py:702-734)
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_term)
        except ValueError:          # not the main thread
            pass

    perm_gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    t0 = time.time()
    n_steps = 0
    try:
        for it in range(start_iter, total_iters):
            if stop_requested["flag"]:
                save_checkpoint(ckpt_dir, it - 1, state, keep=keep)
                print(f"preempted: checkpoint written at iter {it - 1} "
                      f"(resume with resume=true)", flush=True)
                break

            if permute_scheduler is not None:
                dev_val = permute_scheduler(it)
                if dev_val is not None:
                    state = state._replace(params=permute_surface_vertices(
                        state.params, geometry.statics.surface_vid,
                        perm_gen, dev_val))

            step_fn = get_step(fit_depth_cfg and fit_depth_start < it)
            for forw_id in range(num_forward_per_iter):
                batch = {k: v for k, v in dataloader(it, forw_id).items()
                         if k not in ("resolution", "spp")}
                state, (loss, img_loss, reg, n_drop) = step_fn(state, batch,
                                                               it)
                n_steps += 1
                meter.update(1, rays_per_forward)

            # a host read every sync_every iterations bounds how far the
            # host runs ahead with fresh batches pinning device memory
            if sync_every and it % sync_every == 0:
                float(loss)

            if it % log_every == 0:
                print("iter=%4d, img_loss=%.4f, reg_loss=%.4f [%s]"
                      % (it, float(img_loss), float(reg), meter.summary()),
                      flush=True)
                if int(n_drop) > 0:
                    print(f"WARNING: rasterizer tile-capacity overflow at "
                          f"iter {it}: {int(n_drop)} candidate slots dropped "
                          f"— silhouette gradients are wrong; capacity will "
                          f"be revalidated at the next export (raise tile_k "
                          f"/ validate_tile_capacity to fix now)", flush=True)

            if checkpoint_every and it and it % checkpoint_every == 0:
                save_checkpoint(ckpt_dir, it, state, keep=keep)

            if it % export_every == 0:
                geometry.set_tet_v(state.params)
                # the capacity on the deformed geometry: growth rebuilds
                # the steps, shrink is ignored (train.py:812-828)
                if tile_k is not None and it > start_iter:
                    new_k = _validated_tile_k(geometry, dataloader,
                                              resolution, is_ortho)
                    if new_k is not None and new_k > tile_k:
                        print(f"tile capacity revalidated {tile_k} -> "
                              f"{new_k} at iter {it} (deformation outgrew "
                              f"the startup margin)", flush=True)
                        tile_k = new_k
                        steps.clear()
                d = os.path.join(out_path, f"mesh{it:05d}")
                os.makedirs(d, exist_ok=True)
                geometry.export(d, f"{it:05d}")
                if verbose:
                    _dump_images(out_path, it, state, dataloader, geometry,
                                 resolution)
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    dt = time.time() - t0
    print(f"Best rendering loss: {float(state.best_loss)} at iteration "
          f"{int(state.best_iter)}")
    print(f"iters/sec: {n_steps / max(dt, 1e-9):.3f}")

    geometry.set_tet_v(state.params)
    geometry.export(os.path.join(out_path, "final"), "final", save_npy=True)
    return state, geometry


def _dump_images(out_path, it, state, dataloader, geometry, resolution):
    """Verbose GT / prediction images of one view (``_dump_images``,
    train.py:863; reference trainer.py:148-182)."""
    from PIL import Image
    batch = dataloader(it, 0)
    with torch.no_grad():
        out = render_views(state.params, geometry.statics, batch["mvp"], it,
                           resolution)
    idx = np.random.randint(0, batch["img"].shape[0])

    def save(img, name):
        img = img.detach().cpu().numpy()
        if img.shape[-1] == 1:
            img = np.repeat(img, 4, axis=-1)
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_path,
                                               f"a_{name}-{it}.png"))

    save(out.shaded[idx], "ours")
    save(batch["img"][idx], "gt")


def main(argv=None, device: DeviceLike = None):
    """``--config file.yaml`` plus ``key.sub=value`` overrides -> train();
    returns its (state, geometry)."""
    parser = argparse.ArgumentParser(prog="python -m tssplat_torch.train")
    parser.add_argument("--config", required=True, help="path to config file")
    args, extras = parser.parse_known_args(argv)
    cfg = load_config(args.config, cli_args=extras)
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
