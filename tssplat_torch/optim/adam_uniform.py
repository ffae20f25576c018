"""AdamUniform (port of ``tssplat_tpu/optim/adam_uniform.py``; reference
utils/optimizer.py:4-89).

  - first/second moments with standard bias correction, but the update is
    divided by the scalar max of sqrt(m2) (+1e-8) over the whole tensor —
    over each leaf when the parameters are a dict of tensors (the texture
    stage's material);
  - staged grad cap: the cap ``values[ptr]`` is read, then the pointer
    advances once if the step counter reached ``iters[ptr]`` (a new cap takes
    effect the next step); each leaf's update is rescaled so max|update| <=
    cap; the counter advances by the number of leaves a step (the
    reference's per-parameter ``cc``), so a dict of five leaves reaches
    ``iters`` five times sooner than one tensor;
  - cosine-annealed learning rate, eta_min=1e-4 (torch CosineAnnealingLR as
    the reference trainer steps it).

Functional, optax-style: ``update_fn(grads, state) -> (updates, state)``
with updates to add to the parameters: one tensor, or a dict of them whose
leaves are visited in ``jax.tree_util`` order (keys sorted). Every scalar
stays a tensor on the parameter's device, and the constants (the moments'
bases, the grad-limit tables) are made there once, when ``init_fn`` builds
the state: an update copies nothing from the host and never waits for it,
so a CUDA graph can capture it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence, Union

import torch

from ..utils.tree import tree_leaves, tree_map


class AdamUniformState(NamedTuple):
    count: torch.Tensor        # int32 — completed update calls
    g1: Any                    # first moment, like the parameters
    g2: Any                    # second moment
    limit_ptr: torch.Tensor    # int32 — grad-limit stage pointer
    cc: torch.Tensor           # int32 — step counter (reference ``cc``)


ScheduleOrFloat = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def cosine_annealing_lr(lr0: float, total_steps: int, eta_min: float = 1e-4
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """eta_t = eta_min + (lr0 - eta_min) * (1 + cos(pi * t / T)) / 2."""
    lr0 = float(lr0)
    T = max(int(total_steps), 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.clamp_max(count.to(torch.float32), T)
        # divide by a tensor: CUDA division by a Python scalar multiplies
        # by its reciprocal and rounds unlike the CPU and JAX
        phase = math.pi * t / torch.full_like(t, float(T))
        return eta_min + (lr0 - eta_min) * 0.5 * (1.0 + torch.cos(phase))

    return schedule


def adam_uniform(learning_rate: ScheduleOrFloat = 0.1,
                 b1: float = 0.9, b2: float = 0.999,
                 grad_limit: bool = False,
                 grad_limit_values: Sequence[float] = (0.05, 0.01),
                 grad_limit_iters: Sequence[int] = (4000,),
                 eps: float = 1e-8):
    """(init_fn, update_fn) for AdamUniform on a tensor or a dict of
    them."""
    values = tuple(float(v) for v in grad_limit_values)
    iters = tuple(int(i) for i in grad_limit_iters)
    if grad_limit and len(values) < len(iters) + 1:
        values = values + (values[-1],) * (len(iters) + 1 - len(values))
    made = {}

    def constants(dev):
        """(b1, b2, the cap values, the cap iterations, a constant
        learning rate) as tensors on ``dev``, made at its first use."""
        if dev not in made:
            made[dev] = (torch.tensor(b1, device=dev),
                         torch.tensor(b2, device=dev),
                         torch.tensor(values, device=dev),
                         torch.tensor(iters, dtype=torch.int32, device=dev),
                         torch.tensor(float(learning_rate)
                                      if not callable(learning_rate) else 0.0,
                                      device=dev))
        return made[dev]

    def pick(table, ptr):
        """table[min(ptr, len - 1)] as a 0-dim tensor, read on the device
        (indexing by a 0-dim tensor would read ptr on the host)."""
        i = torch.clamp_max(ptr, table.shape[0] - 1).reshape(1)
        return table.index_select(0, i).reshape(())

    def init_fn(params) -> AdamUniformState:
        dev = tree_leaves(params)[0].device
        constants(dev)

        def i32():
            return torch.zeros((), dtype=torch.int32, device=dev)
        return AdamUniformState(count=i32(),
                                g1=tree_map(torch.zeros_like, params),
                                g2=tree_map(torch.zeros_like, params),
                                limit_ptr=i32(), cc=i32())

    def update_fn(grads, state: AdamUniformState):
        leaves = tree_leaves(grads)
        dev = leaves[0].device
        b1_t, b2_t, vals, its, lr0 = constants(dev)
        step = state.count + 1
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(b1_t, stepf)
        b2c = 1.0 - torch.pow(b2_t, stepf)
        g1 = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.g1, grads)
        g2 = tree_map(lambda v, g: b2 * v + (1.0 - b2) * g * g, state.g2,
                      grads)
        lr = learning_rate(state.count) if callable(learning_rate) else lr0

        # the cap is read, and the pointer advanced, once for all leaves,
        # from the counter before this step
        limit_ptr = state.limit_ptr
        cap = None
        if grad_limit:
            cap = pick(vals, state.limit_ptr)
            if iters:
                reached = state.cc >= pick(its, state.limit_ptr)
                advance = (state.limit_ptr < len(iters)) & reached
                limit_ptr = state.limit_ptr + advance.to(torch.int32)

        def leaf_update(m, v):
            m1 = m / b1c
            m2 = v / b2c
            gr = m1 / (eps + torch.sqrt(torch.max(m2)))
            if cap is not None:
                s = torch.max(torch.abs(gr))
                gr = torch.where(s > cap,
                                 gr * (cap / torch.clamp_min(s, 1e-30)), gr)
            return -lr * gr

        updates = tree_map(leaf_update, g1, g2)
        return updates, AdamUniformState(count=step, g1=g1, g2=g2,
                                         limit_ptr=limit_ptr,
                                         cc=state.cc + len(leaves))

    return init_fn, update_fn


def apply_updates(params, updates):
    """params + updates, leaf by leaf."""
    return tree_map(lambda p, u: p + u, params, updates)
