"""Training: the train step and the driver (port of
``tssplat_tpu/train.py``: the geometry and the texture stage).

    python -m tssplat_torch.train --config configs/gso.yaml [key.sub=val ...]
    python -m tssplat_torch.train --config configs/gso.yaml \
        fitting_stage=texture material_type=ExplicitMaterial \
        geometry.initial_mesh_path=<final/ of a geometry run>

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

The texture stage (``fitting_stage: texture``) freezes the geometry and
fits a material's parameters (a dict of tensors) to the RGB targets: L1 x
20 on the colour-antialiased render over the background (x 100 in the
loss), by one of three paths, chosen as the JAX package chooses them
(train.py:592-667): the exact path over every view with the visibility
cached once (``materials/exact_stage.py``), the sampled path
(``texture_sample_px`` foreground pixels a view, from a cache or a top-k of
random scores), or the dense path, which renders the batch every step (and
warns).

``train(cfg)`` is the driver of ``tssplat_tpu/train.py:409-861``: the
geometry, the material and the data loader from the config's registries,
the optimizer and its schedule, the permute-surface scheduler, the depth
switch, periodic remeshing (``remesh_every``), logs, exports (the textured
OBJ bake after the texture stage), checkpoints, resume, the SIGTERM/SIGINT
finish and the sanitizers (``debug_nans``, ``anomaly``). ``main`` hands a
config with an ``sds`` block to the image-to-3D driver (``train_sds.py``).

Over W > 1 ranks (processes of one ``torch.distributed`` group, started by
``torchrun`` or ``tools/run_ranks.py``; ``main`` joins the group) the ranks
stand for the JAX package's devices, in its three modes (train.py:514-590):
view data parallelism (each rank takes its share of the batch's views, in
chunks of view_chunk / W where the batch is chunked), per-rank slices of
the loader (``data.world_size`` = W: each rank loads its own slice), and
row-slab spatial sharding (``spatial`` = n_sp: a (view, sp) grid of
ranks, ``parallel/spatial.py``). One collective a step (``parallel/mesh.py
sync_step``) gives every rank the whole batch's gradient and logged
scalars, so every rank applies the same update to the same bits. Rank 0
alone writes exports and checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import data as _data  # noqa: F401 — registers the data loaders
from . import geometry as _geometry  # noqa: F401 — registers geometries
from . import materials as _materials  # noqa: F401 — registers materials
from .config import (load_config, load_dataloader, load_geometry,
                     load_material)
from .device import DeviceLike, resolve_device
from .geometry.tet_geometry import (GeometryStatics,
                                    LinearInterpolateScheduler,
                                    geometry_forward,
                                    permute_surface_vertices)
from .ops.binning import (CAP_TILE_H, CAP_TILE_W, capped_back,
                          default_tile_capacity, validate_tile_capacity)
from .ops.energy import barrier_order, energy_coeff_schedule
from .ops.rasterize import interpolate, rasterize
from .ops.transform import transform_pos
from .optim import (adam, adam_uniform, apply_updates, cosine_annealing_lr,
                    cosine_decay_schedule)
from .parallel.mesh import BROADCAST, MEAN, SUM, shard_batch, sync_step
from .parallel.spatial import (shard_spatial_train_batch, slab_rows,
                               spatial_geometry_loss)
from .render.pipeline import (render_bins, render_front, render_views,
                              render_visibility)
from .step_graph import GraphedStep
from .utils import debug
from .utils.checkpoint import (latest_checkpoint_step, restore_checkpoint,
                               save_checkpoint)
from .utils.env import get_rank, get_world_size, init_distributed
from .utils.profiling import ThroughputMeter, span, trace_profile
from .utils.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any            # tet_v (N,3), or the material's dict of tensors
    opt_state: Any         # AdamUniformState or AdamState
    best_loss: torch.Tensor            # scalar f32
    best_iter: torch.Tensor            # scalar int32
    best_params: Any


def init_train_state(params, init_fn: Callable) -> TrainState:
    params = tree_map(lambda p: p.detach().clone(), params)
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params, opt_state=init_fn(params),
        best_loss=torch.tensor(float("inf"), device=dev),
        best_iter=torch.zeros((), dtype=torch.int32, device=dev),
        best_params=tree_map(torch.clone, params))


# the batch entries the loss reads, all view-major
_VIEW_KEYS = ("mvp", "campos", "img", "d", "n", "background")


def _img_loss(statics: GeometryStatics, tet_v: torch.Tensor, batch: dict,
              it: int, resolution: int, is_ortho: bool, fit_depth: bool,
              fit_normal: bool, normal_weight: float,
              tile_k: Optional[int], vis=None,
              material_fn: Optional[Callable] = None, mat_params=None,
              bins=None, energy_coeffs=None):
    """(img_loss, energy, n_drop) of the views of ``batch``: the MSE of the
    silhouette, or with ``material_fn`` the L1 of the colour against the
    target RGB (and the depth term's L1 instead of its MSE), as
    train.py:131-165. ``vis``, ``bins`` and ``energy_coeffs`` as
    ``render_views`` takes them."""
    texture = material_fn is not None
    out = render_views(tet_v, statics, batch["mvp"], it, resolution,
                       only_alpha=not texture, material_fn=material_fn,
                       material_params=mat_params,
                       background=batch.get("background"),
                       campos=batch.get("campos"), fit_depth=fit_depth,
                       fit_normal=fit_normal, is_ortho=is_ortho,
                       tile_k=tile_k, vis=vis, bins=bins,
                       energy_coeffs=energy_coeffs)
    img = batch["img"]
    if texture:
        img_loss = torch.mean(torch.abs(out.shaded[..., :3]
                                        - img[..., :3])) * 20.0
    else:
        img_loss = torch.mean((out.shaded[..., -1] - img[..., -1]) ** 2) \
            * 20.0
    if fit_depth:
        a = img[..., -1]
        d_err = out.depth[..., -1] * a - batch["d"][..., -1] * a
        img_loss = img_loss + 100.0 * (torch.mean(torch.abs(d_err))
                                       if texture
                                       else torch.mean(d_err ** 2))
    if fit_normal:
        a = img[..., -1:]
        img_loss = img_loss + normal_weight * torch.mean(
            (out.normal * a - batch["n"][..., :3] * a) ** 2)
    return img_loss, out.geo_regularization, torch.sum(out.n_drop)


def loss_and_grad(statics: GeometryStatics, tet_v: torch.Tensor,
                  batch: dict, it: int, resolution: int,
                  is_ortho: bool = False, *, fit_depth: bool = False,
                  fit_normal: bool = False, normal_weight: float = 10.0,
                  tile_k: Optional[int] = None, view_chunk: int = 0,
                  material_fn: Optional[Callable] = None, mat_params=None,
                  bins=None, energy_coeffs=None):
    """(loss, img_loss, reg, n_drop, gradient) of one batch: the gradient
    w.r.t. tet_v, or, with ``material_fn`` and ``mat_params`` (the texture
    stage: the batch's "background" composited under the colour, tet_v
    frozen, no energy), w.r.t. the material's parameters (a dict like
    them). ``bins`` (``render_bins`` of the batch) and ``energy_coeffs``
    as ``render_views`` takes them, for the batch in one piece.

    With ``view_chunk`` dividing the B views (and smaller than B) the loss
    runs chunk by chunk, as JAX's scan over ``jax.checkpoint``ed chunks
    (train.py:270-313): each chunk's visibility pass (binning and K1, K2a
    or K2b, at B = view_chunk) runs once, outside the checkpoint, and its
    outputs are kept; everything else in the chunk is recomputed in the
    backward (``torch.utils.checkpoint``), so peak memory is one chunk's
    activations. img_loss is the mean of the chunks' losses, n_drop their
    sum, and the energy is added once, outside the chunks."""
    texture = material_fn is not None
    if texture:
        statics = statics._replace(energy=None)
        x = tet_v.detach()
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          mat_params)
        wrt = tree_leaves(params)
    else:
        x = tet_v.detach().requires_grad_(True)
        params, wrt = None, [x]
    opts = (resolution, is_ortho, fit_depth, fit_normal, normal_weight,
            tile_k)
    mat = dict(material_fn=material_fn, mat_params=params)
    B = batch["mvp"].shape[0]
    if view_chunk and B % view_chunk == 0 and B > view_chunk:
        no_energy = statics._replace(energy=None)

        def chunk_loss(x, cb, vis):
            # runs again in the backward, where the checkpoint recomputes it
            with span("tssplat.render"):
                il, _, nd = _img_loss(no_energy, x, cb, it, *opts, vis=vis,
                                      **mat)
            return il, nd

        total = n_drop = None
        for s in range(0, B, view_chunk):
            cb = {k: batch[k][s:s + view_chunk] for k in _VIEW_KEYS
                  if batch.get(k) is not None}
            vis = render_visibility(x, statics, cb["mvp"], resolution,
                                    shaded=fit_depth or fit_normal
                                    or texture,
                                    is_ortho=is_ortho, tile_k=tile_k)
            # nothing in a chunk draws random numbers: no RNG state to keep
            il, nd = checkpoint(chunk_loss, x, cb, vis, use_reentrant=False,
                                preserve_rng_state=False)
            total = il if total is None else total + il
            n_drop = nd if n_drop is None else n_drop + nd
        img_loss = total / (B // view_chunk)
        reg = geometry_forward(x, statics, it).energy
    else:
        with span("tssplat.render"):
            img_loss, reg, n_drop = _img_loss(
                statics, x, batch, it, *opts, bins=bins,
                energy_coeffs=energy_coeffs, **mat)
    loss = img_loss * 100.0 + reg
    with span("tssplat.backward"):
        grads = torch.autograd.grad(loss, wrt)
    grad = tree_unflatten(params, list(grads)) if texture else grads[0]
    return loss.detach(), img_loss.detach(), reg.detach(), n_drop, grad


def _step_generator(tag: int, it: int) -> torch.Generator:
    """A CPU generator seeded by (tag, it): the draws of iteration ``it``
    are the same on every device and after a resume (JAX folds ``it``
    into PRNGKey(tag); its bits cannot be reproduced here)."""
    return torch.Generator().manual_seed((int(tag) << 32) + int(it))


def texture_sample_slots(count: torch.Tensor, S: int, it: int
                         ) -> torch.Tensor:
    """(B,S) int64: ``S`` uniform slots below each view's foreground count
    (B,), drawn from the generator of (17, it) (train.py:192-195)."""
    u = torch.rand((count.shape[0], S),
                   generator=_step_generator(17, it)).to(count.device)
    slot = torch.floor(u * count[:, None].to(u.dtype)).to(torch.int64)
    return torch.minimum(slot, torch.clamp_min(count[:, None] - 1, 0))


def texture_sample_scores(B: int, n_px: int, it: int,
                          device: DeviceLike = "cpu") -> torch.Tensor:
    """(B, n_px) uniform scores of the uncached sampled loss, from the
    generator of (17, it) (train.py:218)."""
    return torch.rand((B, n_px), generator=_step_generator(17, it)).to(
        device)


def sampled_texture_loss(material_fn: Callable, mat_params, batch: dict,
                         it: int, S: int, *, cache: Optional[dict] = None,
                         statics: Optional[GeometryStatics] = None,
                         tet_v: Optional[torch.Tensor] = None,
                         resolution: int = 0, is_ortho: bool = False,
                         tile_k: Optional[int] = None, slots=None,
                         scores=None, grad_u=None):
    """(img_loss, 0) of the sampled texture loss (``_sampled_texture_loss``,
    train.py:170-235): L1 x 20 over ``S`` random foreground pixels a view,
    without the antialias term. With ``cache`` (build_texture_sample_cache)
    and the batch's "view_idx" the pixels are cached rows at
    ``texture_sample_slots``; without it the views are rasterized and the
    pixels are the S best of ``texture_sample_scores`` + 10 on background.
    ``slots`` / ``scores`` replace the draws (a test feeds JAX's);
    ``grad_u``, or else the generator of (23, it), drives the encoding's
    stochastic table gradient where the material enables it."""
    if cache is not None and "view_idx" in batch:
        vi = batch["view_idx"].long()
        pos_v, gt_v = cache["positions"][vi], cache["gt"][vi]
        cnt = cache["count"][vi]
        B = vi.shape[0]
        slot = texture_sample_slots(cnt, S, it) if slots is None else slots
        pos_s = torch.take_along_dim(pos_v, slot[..., None], dim=1)
        gt_s = torch.take_along_dim(gt_v, slot[..., None], dim=1)
        m_s = (cnt > 0)[:, None].to(torch.float32).expand(B, S)
    else:
        mvp = batch["mvp"]
        B, res = mvp.shape[0], int(resolution)
        with torch.no_grad():
            v_corner = tet_v[statics.corner_vid]
            pos_clip = transform_pos(mvp, v_corner, is_ortho=is_ortho)
            rast, _ = rasterize(pos_clip, (res, res), k=tile_k)
            positions = interpolate(v_corner, rast)
        mask = (rast[..., 3] > 0).to(torch.float32).reshape(B, -1)
        r = texture_sample_scores(B, res * res, it, mvp.device) \
            if scores is None else scores
        idx = torch.topk(-(r + (1.0 - mask) * 10.0), S).indices   # (B,S)
        pos_s = torch.take_along_dim(positions.reshape(B, -1, 3),
                                     idx[..., None], dim=1)
        img = batch["img"]
        gt_s = torch.take_along_dim(img.reshape(B, -1, img.shape[-1]),
                                    idx[..., None], dim=1)[..., :3]
        m_s = torch.take_along_dim(mask, idx, dim=1)
    if grad_u is None:
        color = material_fn(mat_params, pos_s, it,
                            grad_gen=_step_generator(23, it))
    else:
        color = material_fn(mat_params, pos_s, it, grad_u=grad_u)
    n_fg = torch.clamp_min(torch.sum(m_s), 1.0)
    img_loss = torch.sum(torch.abs(color - gt_s) * m_s[..., None]) \
        / (3.0 * n_fg) * 20.0
    return img_loss, torch.zeros((), device=img_loss.device)


@torch.no_grad()
def build_texture_sample_cache(statics: GeometryStatics, tet_v: torch.Tensor,
                               mvp: torch.Tensor, img: torch.Tensor,
                               resolution: int, is_ortho: bool = False,
                               tile_k: Optional[int] = None) -> dict:
    """The sampled texture stage's frozen-geometry cache
    (``build_texture_sample_cache``, train.py:56): each dataset view
    rasterized once, its foreground pixels' world positions and target
    colours compacted in pixel order. Returns {"positions" (n,P,3), "gt"
    (n,P,3), "count" (n,) int64} with P the largest foreground count;
    rows past a view's count are zero."""
    res = int(resolution)
    v_corner = tet_v[statics.corner_vid]
    pos_l, gt_l = [], []
    for i in range(mvp.shape[0]):
        pc = transform_pos(mvp[i:i + 1], v_corner, is_ortho=is_ortho)
        rast, _ = rasterize(pc, (res, res), k=tile_k)
        fg = torch.nonzero(rast[0, ..., 3].reshape(-1) > 0)[:, 0]
        pos_l.append(interpolate(v_corner, rast)[0].reshape(-1, 3)[fg])
        gt_l.append(img[i].reshape(-1, img.shape[-1])[fg, :3])
    count = torch.tensor([p.shape[0] for p in pos_l], device=tet_v.device)
    P = max(1, int(count.max()))

    def pad(rows):
        return torch.stack([torch.cat([r, r.new_zeros((P - r.shape[0], 3))])
                            for r in rows])
    return {"positions": pad(pos_l), "gt": pad(gt_l), "count": count}


def step_scalars(statics: GeometryStatics, it: int, device: DeviceLike,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The iteration's host values as one int32 (3,) tensor on ``device``:
    the energy ramp's c1 and c2 (``energy_coeff_schedule``, their float32
    bits) and ``it``. On CUDA the copy comes from pinned memory and does not
    wait; ``out`` takes it in place."""
    c1, c2 = energy_coeff_schedule(it, statics.smooth_coeff,
                                   statics.barrier_coeff)
    host = np.array([c1, c2, 0.0], np.float32).view(np.int32)
    host[2] = it
    src = torch.from_numpy(host)
    dev = torch.device(device)
    if dev.type == "cuda":
        src = src.pin_memory()
    if out is None:
        return src.to(dev, non_blocking=True)
    return out.copy_(src, non_blocking=True)


def make_train_step(statics: GeometryStatics, update_fn: Callable, *,
                    resolution: int, is_ortho: bool = False,
                    fit_depth: bool = False, fit_normal: bool = False,
                    normal_weight: float = 10.0,
                    tile_k: Optional[int] = None, view_chunk: int = 0,
                    material_fn: Optional[Callable] = None,
                    tet_v_frozen: Optional[torch.Tensor] = None,
                    texture_sample_px: int = 0,
                    texture_cache: Optional[dict] = None,
                    texture_exact_loss: Optional[Callable] = None,
                    sync: Optional[str] = None,
                    spatial: Optional[Tuple[int, int, int]] = None):
    """Build ``step(state, batch, it) -> (state, (loss, img_loss, reg,
    n_drop))``. ``batch`` holds "mvp" (B,4,4) and "img" (B,H,W,C) whose
    last channel is the target alpha, plus "campos" (B,3) and "d"
    (B,H,W,1) for ``fit_depth`` and "n" (B,H,W,>=3) for ``fit_normal``, on
    the device of the state. ``tile_k`` is the capped layout's per-tile
    capacity (``validated_tile_k``); ``view_chunk`` as in
    ``loss_and_grad``.

    With ``material_fn`` the step is the texture stage's: the state's
    params are the material's, the geometry ``tet_v_frozen`` stays put,
    and the loss is ``texture_exact_loss(params, it)`` (the batch is not
    read), else the sampled loss with ``texture_sample_px``, else the
    dense colour render of the batch (which then needs "background").

    Over ranks, ``batch`` is this rank's share and ``sync`` how the ranks'
    gradients and (img_loss, reg, n_drop) combine before the update
    (``parallel/mesh.py``: MEAN, SUM or BROADCAST); the loss is then
    img_loss x 100 + reg of the combined values, alike on every rank.
    ``spatial`` = (rank, n_view, n_sp) takes the loss of the rank's row
    slab (``parallel/spatial.py spatial_geometry_loss``).

    The geometry step of a whole batch on one rank (no texture, ``sync``,
    ``spatial`` or view chunks) bins its views first and then runs the
    rest, which on a CUDA device a CUDA graph replays
    (``step_graph.GraphedStep``, ``step.graphs``)."""
    texture = material_fn is not None
    shaded = fit_depth or fit_normal

    def texture_grads(params, it, batch):
        x = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if texture_exact_loss is not None:
            il, reg = texture_exact_loss(x, it)
        else:
            il, reg = sampled_texture_loss(
                material_fn, x, batch, it, int(texture_sample_px),
                cache=texture_cache, statics=statics, tet_v=tet_v_frozen,
                resolution=resolution, is_ortho=is_ortho, tile_k=tile_k)
        loss = il * 100.0
        with span("tssplat.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(x))
        zero = torch.zeros((), dtype=torch.int64, device=loss.device)
        return (loss.detach(), il.detach(), reg, zero,
                tree_unflatten(x, list(grads)))

    def spatial_grads(tet_v, it, batch):
        x = tet_v.detach().requires_grad_(True)
        loss, (il, rg, nd) = spatial_geometry_loss(
            x, statics, batch, it, *spatial, resolution, is_ortho=is_ortho,
            tile_k=tile_k, fit_depth=fit_depth, fit_normal=fit_normal,
            normal_weight=normal_weight)
        with span("tssplat.backward"):
            grad, = torch.autograd.grad(loss, [x])
        return loss.detach(), il.detach(), rg.detach(), nd, grad

    def update(state: TrainState, loss, img_loss, reg, n_drop, grads,
               it_t: torch.Tensor):
        """The optimizer's update and the best snapshot, taken after it;
        ``it_t`` the iteration as an int32 0-dim tensor."""
        with torch.no_grad(), span("tssplat.optim"):
            updates, opt_state = update_fn(grads, state.opt_state)
            params = apply_updates(state.params, updates)
            better = loss < state.best_loss
            new_state = TrainState(
                params=params, opt_state=opt_state,
                best_loss=torch.where(better, loss, state.best_loss),
                best_iter=torch.where(better, it_t, state.best_iter),
                best_params=tree_map(lambda c, b: torch.where(better, c, b),
                                     params, state.best_params))
        return new_state, (loss, img_loss, reg, n_drop)

    def body(state: TrainState, batch: dict, bins, scal: torch.Tensor,
             it: int):
        """The geometry step after its binning, on ``bins`` and the host
        values ``scal`` of ``step_scalars``."""
        coeffs = scal.view(torch.float32)
        loss, img_loss, reg, n_drop, grad = loss_and_grad(
            statics, state.params, batch, it, resolution, is_ortho,
            fit_depth=fit_depth, fit_normal=fit_normal,
            normal_weight=normal_weight, tile_k=tile_k, bins=bins,
            energy_coeffs=(coeffs[0], coeffs[1]))
        return update(state, loss, img_loss, reg, n_drop, grad, scal[2])

    def bins_fn(params, batch, front=False):
        fn = render_front if front else render_bins
        return fn(params, statics, batch["mvp"], resolution, shaded=shaded,
                  is_ortho=is_ortho, tile_k=tile_k)

    graphs = None
    if not texture and sync is None and spatial is None:
        graphs = GraphedStep(
            bins_fn, lambda params, batch: bins_fn(params, batch, True),
            capped_back,
            lambda it, dev, out=None: step_scalars(statics, it, dev, out),
            body, ("mvp", "img") + (("campos", "d") if fit_depth else ())
            + (("n",) if fit_normal else ()),
            lambda it: barrier_order(it, statics.increase_order_iter))

    def step(state: TrainState, batch: dict, it: int):
        with span("tssplat.step"):
            B = batch["mvp"].shape[0] if "mvp" in batch else 0
            if graphs is not None and not (view_chunk and B % view_chunk == 0
                                           and B > view_chunk):
                return graphs(state, batch, it)
            return _step(state, batch, it)

    def _step(state: TrainState, batch: dict, it: int):
        if spatial is not None:
            loss, img_loss, reg, n_drop, grads = spatial_grads(
                state.params, it, batch)
        elif texture and (texture_exact_loss is not None
                          or texture_sample_px):
            loss, img_loss, reg, n_drop, grads = texture_grads(
                state.params, it, batch)
        else:
            loss, img_loss, reg, n_drop, grads = loss_and_grad(
                statics, tet_v_frozen if texture else state.params, batch,
                it, resolution, is_ortho, fit_depth=fit_depth,
                fit_normal=fit_normal, normal_weight=normal_weight,
                tile_k=tile_k, view_chunk=view_chunk,
                material_fn=material_fn,
                mat_params=state.params if texture else None)
        if sync is not None:
            leaves, img_loss, reg, n_drop = sync_step(
                tree_leaves(grads), img_loss, reg, n_drop, sync)
            grads = tree_unflatten(grads, leaves)
            loss = img_loss * 100.0 + reg
        it_t = step_scalars(statics, it, loss.device)[2]
        return update(state, loss, img_loss, reg, n_drop, grads, it_t)

    step.graphs = graphs
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


# Device memory a view-pixel of an unchunked step takes above what is
# resident when the chunk rule runs, the capped layout's candidate lists
# apart: the largest over the silhouette, depth + normal and dense colour
# texture steps at 120 views of 512² on an H100 (tools/view_memory.py, the
# 18-sphere scene), depth + normal's 433 B (its peak lies outside the
# binning: the same at capacities 4096 and 16384), with a 25% margin.
BYTES_PER_VIEW_PX = 544
# Device memory a slot of the candidate lists (views x tiles x tile_k)
# takes while bin_faces_capped builds them: 24.9 B measured the same way
# (the silhouette step's peak is the binning's: 108.6 B a view-pixel at
# capacity 4096, 407.6 at 16384), with a margin. A scene can validate to a
# capacity of up to next_pow2(F), 4x the 4096 of gso.yaml's.
BYTES_PER_TILE_SLOT = 32
# the share of the device's free memory one batch of views may take
_FREE_SHARE = 0.5


def _tpu_view_chunk(B: int, n_dev: int, resolution: int) -> int:
    """The JAX package's rule (``_auto_view_chunk``, train.py:355), sized
    for a TPU's memory: ~8 views per device at 512^2, scaling with
    1/resolution^2; 0 when the whole batch already fits the target."""
    per_dev = max(1, (8 * 512 * 512) // max(resolution * resolution, 1))
    target = per_dev * n_dev
    if B <= target:
        return 0
    for c in range(target, n_dev - 1, -1):
        if B % c == 0 and c % n_dev == 0:
            return c if c < B else 0
    return 0


def _bytes_per_view(resolution: int, tile_k: Optional[int]) -> int:
    """The device memory the chunk rule counts for one view of
    resolution²: ``BYTES_PER_VIEW_PX`` a pixel, and ``BYTES_PER_TILE_SLOT``
    a slot of the capped layout's candidate lists at capacity ``tile_k``
    (None: none)."""
    per_view = resolution ** 2 * BYTES_PER_VIEW_PX
    if tile_k:
        tiles = -(-resolution // CAP_TILE_H) * -(-resolution // CAP_TILE_W)
        per_view += tiles * tile_k * BYTES_PER_TILE_SLOT
    return per_view


def _auto_view_chunk(B: int, n_dev: int, resolution: int, *,
                     tile_k: Optional[int] = None,
                     free_bytes: Optional[int] = None,
                     device: DeviceLike = None) -> int:
    """Default view-microbatch size for B views over n_dev devices: 0 (one
    batch) where a device's B / n_dev views of resolution² fit
    ``_FREE_SHARE`` of its free memory, else the largest divisor of B (a
    multiple of n_dev) whose views fit, else n_dev, the smallest chunk. A
    view takes ``BYTES_PER_VIEW_PX`` a pixel plus ``BYTES_PER_TILE_SLOT``
    for each slot of the capped layout's candidate lists at capacity
    ``tile_k`` (None: no lists counted). The free memory is the CUDA
    device's (``device``, or the current one) unless ``free_bytes`` gives
    it; off CUDA the rule is the JAX package's. Over the n_dev > 1 ranks
    of view data parallelism every rank must take the same chunks
    (``shard_batch``), so the rule runs on the least free memory of any
    rank (a MIN all_reduce: every rank calls this)."""
    if free_bytes is None:
        if device is not None and torch.device(device).type != "cuda" \
                or not torch.cuda.is_available():
            return _tpu_view_chunk(B, n_dev, resolution)
        free, _ = torch.cuda.mem_get_info(device)
        # blocks the allocator holds but has not handed out are free too
        free_bytes = free + torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
    if n_dev > 1 and dist.is_available() and dist.is_initialized():
        on = "cuda" if dist.get_backend() == "nccl" else "cpu"
        least = torch.tensor([int(free_bytes)], dtype=torch.int64, device=on)
        dist.all_reduce(least, op=dist.ReduceOp.MIN)
        free_bytes = int(least.item())
    per_view = _bytes_per_view(resolution, tile_k)
    budget = _FREE_SHARE * free_bytes

    def fits(c: int) -> bool:
        return c / n_dev * per_view <= budget

    if fits(B):
        return 0
    for c in range(B - 1, n_dev - 1, -1):
        if B % c == 0 and c % n_dev == 0 and fits(c):
            return c
    return n_dev


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


def _check_stage(cfg) -> None:
    """Raise for a fitting_stage other than geometry or texture, before
    anything is built."""
    stage = cfg.get("fitting_stage", "geometry")
    if stage not in ("geometry", "texture"):
        raise ValueError(f"unknown fitting_stage {stage!r} (geometry or "
                         f"texture)")


def _exact_texture_loss(cfg, geometry, material, dataloader, resolution,
                        is_ortho, tile_k, fit_depth, batch_size,
                        num_forward_per_iter, rank=0, n_shards=1):
    """The exact texture path's loss, or None after the loud warning with
    JAX's reason (train.py:604-666): depth or normal terms, per-rank slices
    of the loader (JAX's multi-host), more than one forward or a batch
    other than every view, an encoding other than a plain HashGrid, or more
    foreground pixels than texture_exact_max_px. ``n_shards`` > 1 caches
    the rank-th of n_shards groups of the views (view-sharded)."""
    from .materials.exact_stage import (build_texture_exact_cache,
                                        build_texture_exact_loss)
    n_views = int(dataloader.data_all["mvp"].shape[0])
    reason = None
    if fit_depth or bool(cfg.get("fit_normal", False)):
        reason = ("the stage fits depth/normal terms (exact path computes "
                  "the color L1 + AA only)")
    elif int(cfg.get("data", {}).get("world_size", 1)) > 1:
        reason = "multi-host runs are not supported by the exact path"
    elif num_forward_per_iter != 1 or batch_size != n_views:
        reason = (f"the exact path needs ONE forward covering every dataset "
                  f"view (batch_size == {n_views} views, "
                  f"num_forward_per_iter == 1; got batch_size={batch_size}, "
                  f"num_forward_per_iter={num_forward_per_iter})")
    else:
        reasons = []
        cache = build_texture_exact_cache(
            geometry, material, dataloader.data_all, resolution,
            is_ortho=is_ortho, tile_k=tile_k,
            max_px=int(cfg.get("texture_exact_max_px", 4_000_000)),
            reason_out=reasons, shard=(rank, n_shards))
        if cache is not None:
            print(f"exact texture fast path: {cache['n']} views, "
                  f"P={cache['P']} fg pixels/view, {cache['xc'].shape[0]} "
                  f"in all; visibility cached, table gradient by "
                  f"scatter-add"
                  + (f", view-sharded over {n_shards} ranks"
                     if n_shards > 1 else ""), flush=True)
            return build_texture_exact_loss(material, geometry.statics,
                                            cache)
        reason = reasons[0] if reasons else "cache build failed"
    print(f"WARNING: exact texture fast path DISABLED — {reason}. Falling "
          f"back to the dense autodiff path (every step renders its views "
          f"again).", flush=True)
    return None


def _rank_check(cfg, rank: int, world: int) -> None:
    """Over W > 1 ranks: the process group must exist, data.world_size must
    be 1 or W, and with per-rank slices data.rank defaults to the rank and
    must not name another (train.py:433-447, 545-553)."""
    if world <= 1:
        return
    if not dist.is_initialized():
        raise RuntimeError(f"{world} ranks but no process group: call "
                           f"tssplat_torch.utils.env.init_distributed() "
                           f"first (main does)")
    data_world = int(cfg.data.get("world_size", 1))
    if data_world not in (1, world):
        raise ValueError(f"data.world_size={data_world} must equal the "
                         f"number of ranks={world} in multi-rank runs")
    if data_world > 1:
        cfg_rank = cfg.data.get("rank", None)
        if cfg_rank is None:
            cfg.data["rank"] = rank
        elif int(cfg_rank) != rank:
            raise ValueError(
                f"data.rank={cfg_rank} != the process's rank={rank}: in a "
                f"multi-rank run each process must load its own rank's "
                f"slice (omit data.rank to default it per process)")


def train(cfg, device: DeviceLike = None):
    """Run the stage ``fitting_stage`` of ``cfg`` (geometry or texture) on
    ``device`` (``cuda`` unless the caller asks for the CPU); returns
    (state, geometry). Over W > 1 ranks (the process group joined first,
    see the module doc) each rank calls it with its own device.

    ``debug_nans: true`` runs it under the NaN trap and ``anomaly: true``
    in anomaly mode (``utils/debug.py``; train.py:411-417), both for this
    run only: the settings before it are restored when it returns or
    raises."""
    dev = resolve_device(device)
    _check_stage(cfg)
    with debug.sanitizers(debug_nans=bool(cfg.get("debug_nans", False)),
                          anomaly=bool(cfg.get("anomaly", False))):
        return _train(cfg, dev)


def _train(cfg, dev: torch.device):
    rank, world = get_rank(), get_world_size()
    _rank_check(cfg, rank, world)
    is_main = rank == 0
    verbose = cfg.get("verbose", False)
    stage = cfg.get("fitting_stage", "geometry")
    texture = stage == "texture"
    out_path = cfg.output_path
    os.makedirs(os.path.join(out_path, "final"), exist_ok=True)

    geometry_cfg = dict(cfg.geometry)
    geometry_cfg["optimize_geo"] = not texture
    geometry_cfg.setdefault("output_path", out_path)
    geometry = load_geometry(cfg.geometry_type)(geometry_cfg, device=dev)

    material = material_fn = None
    if texture:
        # the material's config block may be absent: its defaults
        material = load_material(cfg.material_type)(cfg.get("material"),
                                                    device=dev)
        material_fn = material.apply_fn

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

    state = init_train_state(material.params if texture else geometry.tet_v,
                             init_fn)

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
    data_world = int(cfg.data.get("world_size", 1))
    # the ranks' modes (train.py:514-590): spatial (a (view, sp) grid of
    # ranks), per-rank loader slices (data.world_size = W), view data
    # parallelism; otherwise every rank runs the whole batch
    spatial = None                      # (rank, n_view, n_sp)
    n_sp = int(cfg.get("spatial", 0) or 0)
    if n_sp > 1:
        n_view = max(1, world // n_sp)
        if (not texture and data_world == 1 and world % n_sp == 0
                and batch_size % n_view == 0):
            spatial = (rank, n_view, n_sp)
            print(f"spatial sharding: ('view','sp') = ({n_view},{n_sp}) "
                  f"over {world} ranks (batch {batch_size}, "
                  f"{slab_rows(resolution, n_sp)}-row slabs)", flush=True)
        else:
            print(f"spatial={n_sp} incompatible (stage={stage}, "
                  f"devices={world}, batch={batch_size}, single-host "
                  f"only) — disabled", flush=True)
    view_dp = False
    sync = None
    if world > 1:
        if spatial is not None:
            sync = SUM
        elif data_world == world:
            sync = MEAN
            print(f"data-parallel over {world} ranks (per-rank loader "
                  f"slices, global batch {batch_size * world})", flush=True)
        elif bool(cfg.get("data_parallel", True)) \
                and batch_size % world == 0:
            view_dp, sync = True, MEAN
            print(f"data-parallel over {world} ranks (global batch "
                  f"{batch_size})", flush=True)
        else:
            sync = BROADCAST
            print(f"data-parallel off: batch {batch_size} over {world} "
                  f"ranks — every rank runs the whole batch", flush=True)
    steps = {}
    tile_k = _validated_tile_k(geometry, dataloader, resolution, is_ortho)

    vc_cfg = cfg.get("view_chunk", "auto")
    n_shard = world if view_dp else 1
    if spatial is not None or data_world > 1:
        view_chunk = 0
    elif vc_cfg == "auto":
        view_chunk = _auto_view_chunk(batch_size, n_shard, resolution,
                                      tile_k=tile_k, device=dev)
    else:
        view_chunk = int(vc_cfg)
    if view_chunk and not (batch_size % view_chunk == 0
                           and batch_size > view_chunk
                           and view_chunk % n_shard == 0):
        print(f"view_chunk={view_chunk} incompatible with batch "
              f"{batch_size} over {n_shard} devices — disabled", flush=True)
        view_chunk = 0
    if view_chunk:
        print(f"view microbatching: {batch_size // view_chunk} chunks of "
              f"{view_chunk} views", flush=True)

    # the texture stage's paths (train.py:592-666): the sampled loss with
    # its frozen-geometry cache, else the exact path, else the dense one
    sample_px = int(cfg.get("texture_sample_px", 0))
    texture_cache = texture_exact = None
    if texture and sample_px and bool(cfg.get("texture_cache", True)):
        texture_cache = build_texture_sample_cache(
            geometry.statics, geometry.tet_v, dataloader.data_all["mvp"],
            dataloader.data_all["img"], resolution, is_ortho=is_ortho,
            tile_k=tile_k)
        print(f"texture cache: {texture_cache['positions'].shape[0]} views, "
              f"P={texture_cache['positions'].shape[1]} fg pixels",
              flush=True)
    if texture and sample_px and view_dp:
        # the draws are over the global batch: every rank runs it whole
        view_dp, sync = False, BROADCAST
        print("sampled texture path: every rank runs the whole batch",
              flush=True)
    exact_sync = sync
    if texture and not sample_px and \
            bool(cfg.get("texture_exact_fast", True)):
        n_views = int(dataloader.data_all["mvp"].shape[0])
        n_shards = 1
        if view_dp:
            if n_views % world == 0:
                n_shards, exact_sync = world, SUM
            else:
                exact_sync = BROADCAST
                print(f"exact texture: {n_views} views don't divide "
                      f"{world} devices — running the exact path "
                      f"replicated (no view sharding)", flush=True)
        texture_exact = _exact_texture_loss(
            cfg, geometry, material, dataloader, resolution, is_ortho,
            tile_k, fit_depth_cfg, batch_size, num_forward_per_iter,
            rank=rank if n_shards > 1 else 0, n_shards=n_shards)
        if texture_exact is not None:
            sync = exact_sync

    def get_step(fit_depth_on: bool):
        if fit_depth_on not in steps:
            steps[fit_depth_on] = make_train_step(
                geometry.statics, update_fn, resolution=resolution,
                is_ortho=is_ortho, fit_depth=fit_depth_on,
                fit_normal=bool(cfg.get("fit_normal", False)),
                normal_weight=float(cfg.get("fit_normal_weight", 10.0)),
                tile_k=tile_k,
                view_chunk=view_chunk // world if view_dp else view_chunk,
                material_fn=material_fn, tet_v_frozen=geometry.tet_v,
                texture_sample_px=sample_px, texture_cache=texture_cache,
                texture_exact_loss=texture_exact, sync=sync,
                spatial=spatial)
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

    remesh_every = int(cfg.get("remesh_every", 0) or 0)
    perm_gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    # profile_iters [start, stop]: iterations start..stop-1 under
    # torch.profiler, the spans included, into <output_path>/trace/
    prof_start, prof_stop = (int(i) for i in cfg.get("profile_iters")
                             or (0, 0))
    capture = contextlib.ExitStack()
    t0 = time.time()
    n_steps = 0
    try:
        for it in range(start_iter, total_iters):
            if stop_requested["flag"]:
                if is_main:
                    save_checkpoint(ckpt_dir, it - 1, state, keep=keep)
                    print(f"preempted: checkpoint written at iter {it - 1} "
                          f"(resume with resume=true)", flush=True)
                break
            if it == max(prof_start, start_iter) and it < prof_stop:
                capture.enter_context(trace_profile(
                    os.path.join(out_path, "trace")))

            # periodic remeshing (train.py:738-756): the deformed volume
            # re-tetrahedralised; the optimizer, the best snapshot, the
            # steps and the tile capacity start again on the new topology
            if (remesh_every and it > start_iter and not texture
                    and it % remesh_every == 0):
                geometry.set_tet_v(state.params)
                geometry.tetmesh.update_vtx_pos(
                    state.params.detach().cpu().numpy())
                geometry.remesh(grid_dim=int(cfg.get("remesh_grid_dim", 64)))
                state = init_train_state(geometry.tet_v, init_fn)
                steps.clear()
                tile_k = _validated_tile_k(geometry, dataloader, resolution,
                                           is_ortho)
                print(f"remeshed at iter {it}: "
                      f"{geometry.tetmesh.num_vertices} verts / "
                      f"{geometry.tetmesh.num_tets} tets", flush=True)

            if permute_scheduler is not None and not texture:
                dev_val = permute_scheduler(it)
                if dev_val is not None:
                    state = state._replace(params=permute_surface_vertices(
                        state.params, geometry.statics.surface_vid,
                        perm_gen, dev_val))

            step_fn = get_step(fit_depth_cfg and fit_depth_start < it)
            for forw_id in range(num_forward_per_iter):
                # the exact texture path reads no batch: none is gathered
                batch = {} if texture_exact is not None else {
                    k: v for k, v in dataloader(it, forw_id).items()
                    if k not in ("resolution", "spp")}
                if view_dp:
                    batch = shard_batch(batch, rank, world, view_chunk)
                elif spatial is not None:
                    batch = shard_spatial_train_batch(batch, *spatial)
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

            if is_main and checkpoint_every and it \
                    and it % checkpoint_every == 0:
                save_checkpoint(ckpt_dir, it, state, keep=keep)

            if it % export_every == 0 and not texture:
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
                if is_main:
                    d = os.path.join(out_path, f"mesh{it:05d}")
                    os.makedirs(d, exist_ok=True)
                    geometry.export(d, f"{it:05d}")
                    if verbose:
                        _dump_images(out_path, it, state, dataloader,
                                     geometry, resolution)
            if it == prof_stop - 1:
                capture.close()
    finally:
        capture.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    dt = time.time() - t0
    print(f"Best rendering loss: {float(state.best_loss)} at iteration "
          f"{int(state.best_iter)}")
    print(f"iters/sec: {n_steps / max(dt, 1e-9):.3f}")

    final = os.path.join(out_path, "final")
    if not texture:
        geometry.set_tet_v(state.params)
    if is_main:
        geometry.export(final, "final", save_npy=True)
    if material is not None:
        material.params = state.params
        if is_main:
            # the material and the textured OBJ bake (train.py:850-860;
            # reference trainer.py:187-189)
            from .materials.export import export_textured_obj
            material.export(final, "material")
            export_textured_obj(geometry, material, final, "material",
                                step=total_iters)
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
    """``--config file.yaml`` plus ``key.sub=value`` overrides -> train(),
    or train_sds() when the config has an ``sds`` block (the image-to-3D
    SDS driver, ``train_sds.py``), as the JAX package's main dispatches;
    returns its (state, geometry). Joins the process group first when the
    environment names more than one rank (``torchrun --nproc-per-node N -m
    tssplat_torch.train ...``); each rank then trains on its own card, or
    on ``device``."""
    parser = argparse.ArgumentParser(prog="python -m tssplat_torch.train")
    parser.add_argument("--config", required=True, help="path to config file")
    args, extras = parser.parse_known_args(argv)
    rank_dev = init_distributed(device=device)
    cfg = load_config(args.config, cli_args=extras)
    dev = device if rank_dev is None else rank_dev
    if cfg.get("sds"):
        from .train_sds import train_sds
        return train_sds(cfg, device=dev)
    return train(cfg, device=dev)


if __name__ == "__main__":
    main()
