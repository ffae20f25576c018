"""Geometry-stage train step (port of ``tssplat_tpu/train.py``
``TrainState`` / ``make_train_step`` / ``_validated_tile_k``, the geometry
stage).

One step: render the views' antialiased silhouettes (and, with
``fit_depth`` / ``fit_normal``, their depth and normal images) and the
geometry energy; loss = (MSE(alpha) x 20 [+ 100 MSE(depth x a, target x a)]
[+ normal_weight MSE(normal x a, target x a)]) x 100 + energy, a = the
target alpha (reference trainer.py:98-115, train.py:140-165); backward
through K5 -> K3 -> the screen table (and the shading gathers) -> tet_v;
the optimizer update (AdamUniform, or Adam, ``optim/``); and the best-loss
snapshot taken after the update (reference trainer.py:132-140).
``run_steps`` drives steps on an in-memory batch with a host sync every
``sync_every`` steps, as the JAX trainer's loop does. The YAML CLI and the
data loaders are not part of this module yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .geometry.tet_geometry import GeometryStatics
from .ops.binning import validate_tile_capacity
from .ops.transform import transform_pos
from .optim.adam_uniform import apply_updates
from .render.pipeline import render_views


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


def loss_and_grad(statics: GeometryStatics, tet_v: torch.Tensor,
                  batch: dict, it: int, resolution: int,
                  is_ortho: bool = False, *, fit_depth: bool = False,
                  fit_normal: bool = False, normal_weight: float = 10.0,
                  tile_k: Optional[int] = None):
    """(loss, img_loss, reg, n_drop, d loss / d tet_v) of one batch."""
    x = tet_v.detach().requires_grad_(True)
    out = render_views(x, statics, batch["mvp"], it, resolution,
                       campos=batch.get("campos"), fit_depth=fit_depth,
                       fit_normal=fit_normal, is_ortho=is_ortho,
                       tile_k=tile_k)
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
    reg = out.geo_regularization
    loss = img_loss * 100.0 + reg
    (grad,) = torch.autograd.grad(loss, x)
    return (loss.detach(), img_loss.detach(), reg.detach(),
            torch.sum(out.n_drop), grad)


def make_train_step(statics: GeometryStatics, update_fn: Callable, *,
                    resolution: int, is_ortho: bool = False,
                    fit_depth: bool = False, fit_normal: bool = False,
                    normal_weight: float = 10.0,
                    tile_k: Optional[int] = None):
    """Build ``step(state, batch, it) -> (state, (loss, img_loss, reg,
    n_drop))``. ``batch`` holds "mvp" (B,4,4) and "img" (B,H,W,C) whose
    last channel is the target alpha, plus "campos" (B,3) and "d"
    (B,H,W,1) for ``fit_depth`` and "n" (B,H,W,>=3) for ``fit_normal``, on
    the device of the state. ``tile_k`` is the capped layout's per-tile
    capacity (``validated_tile_k``)."""

    def step(state: TrainState, batch: dict, it: int):
        loss, img_loss, reg, n_drop, grads = loss_and_grad(
            statics, state.params, batch, it, resolution, is_ortho,
            fit_depth=fit_depth, fit_normal=fit_normal,
            normal_weight=normal_weight, tile_k=tile_k)
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
    geometry's current surface in the batch's views (``_validated_tile_k``,
    train.py:371-406, fed a batch instead of a data loader): max(heuristic,
    next_pow2(2 x the largest per-tile overlap)). None when the resolution
    does not tile into 8x128."""
    if resolution % 128 or resolution % 8:
        return None
    with torch.no_grad():
        pos_clip = transform_pos(batch["mvp"],
                                 geometry.tet_v[geometry.statics.corner_vid],
                                 is_ortho=is_ortho)
    return validate_tile_capacity(pos_clip, (resolution, resolution))


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
