"""Geometry-stage train step (port of ``tssplat_tpu/train.py``
``TrainState`` / ``make_train_step``, silhouette fitting).

One step: render the views' antialiased silhouettes and the geometry
energy, loss = MSE(alpha) x 20 x 100 + energy (reference trainer.py:98-115),
backward through K5 -> K3 -> the screen table -> tet_v, AdamUniform
update, and the best-loss snapshot taken after the update (reference
trainer.py:132-140). ``run_steps`` drives steps on an in-memory batch with
a host sync every ``sync_every`` steps, as the JAX trainer's loop does.
The YAML CLI, the data loaders and the texture/depth/normal losses are not
part of this module yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .geometry.tet_geometry import GeometryStatics
from .optim.adam_uniform import AdamUniformState, apply_updates
from .render.pipeline import render_views


class TrainState(NamedTuple):
    params: torch.Tensor               # tet_v (N,3)
    opt_state: AdamUniformState
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
                  is_ortho: bool = False):
    """(loss, img_loss, reg, n_drop, d loss / d tet_v) of one batch."""
    x = tet_v.detach().requires_grad_(True)
    out = render_views(x, statics, batch["mvp"], it, resolution,
                       is_ortho=is_ortho)
    img_loss = torch.mean((out.shaded[..., -1] - batch["img"][..., -1]) ** 2)
    img_loss = img_loss * 20.0
    reg = out.geo_regularization
    loss = img_loss * 100.0 + reg
    (grad,) = torch.autograd.grad(loss, x)
    return (loss.detach(), img_loss.detach(), reg.detach(),
            torch.sum(out.n_drop), grad)


def make_train_step(statics: GeometryStatics, update_fn: Callable, *,
                    resolution: int, is_ortho: bool = False):
    """Build ``step(state, batch, it) -> (state, (loss, img_loss, reg,
    n_drop))``. ``batch`` holds "mvp" (B,4,4) and "img" (B,H,W,C) whose
    last channel is the target alpha, on the device of the state."""

    def step(state: TrainState, batch: dict, it: int):
        loss, img_loss, reg, n_drop, grads = loss_and_grad(
            statics, state.params, batch, it, resolution, is_ortho)
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
