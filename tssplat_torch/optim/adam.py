"""Per-component Adam with cosine decay: the ``optimizer.type: adam`` path
of ``tssplat_tpu/train.py:462-476`` (``optax.adam`` over
``optax.cosine_decay_schedule``), the production choice at multi-sphere
scale, where AdamUniform's global max-normalization starves the sparse
silhouette gradient.

  mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  n = count + 1
  update = -lr(count) * (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
  lr(c) = lr0 * ((1 - alpha) * (1 + cos(pi * min(c, T) / T)) / 2 + alpha)

with alpha = eta_min / lr0 as the JAX trainer sets it, component by
component of every leaf. Functional, like ``adam_uniform``:
``update_fn(grads, state) -> (updates, state)`` on a tensor or a dict of
them; every scalar stays a tensor on the parameter's device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from ..utils.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    count: torch.Tensor        # int32 — completed updates (optax's count)
    mu: Any                    # first moment, like the parameters
    nu: Any                    # second moment


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    T = float(decay_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.clamp_max(count.to(torch.float32), T)
        # divide by a tensor: CUDA division by a Python scalar multiplies
        # by its reciprocal and rounds unlike the CPU and JAX
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / torch.full_like(t, T)))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adam(learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """(init_fn, update_fn) for Adam on a tensor or a dict of them."""

    made = {}

    def constants(dev):
        """(b1, b2, a constant learning rate) as tensors on ``dev``, made
        at its first use."""
        if dev not in made:
            made[dev] = (torch.tensor(b1, device=dev),
                         torch.tensor(b2, device=dev),
                         torch.tensor(float(learning_rate)
                                      if not callable(learning_rate) else 0.0,
                                      device=dev))
        return made[dev]

    def init_fn(params) -> AdamState:
        dev = tree_leaves(params)[0].device
        constants(dev)
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update_fn(grads, state: AdamState):
        dev = tree_leaves(grads)[0].device
        mu = tree_map(lambda m, g: (1.0 - b1) * g + b1 * m, state.mu, grads)
        nu = tree_map(lambda v, g: (1.0 - b2) * (g * g) + b2 * v, state.nu,
                      grads)
        b1_t, b2_t, lr0 = constants(dev)
        count = state.count + 1
        n = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1_t, n)
        c2 = 1.0 - torch.pow(b2_t, n)
        lr = learning_rate(state.count) if callable(learning_rate) else lr0
        updates = tree_map(
            lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)),
            mu, nu)
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return init_fn, update_fn
