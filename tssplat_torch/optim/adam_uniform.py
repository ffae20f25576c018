"""AdamUniform (port of ``tssplat_tpu/optim/adam_uniform.py``; reference
utils/optimizer.py:4-89).

  - first/second moments with standard bias correction, but the update is
    divided by the scalar max of sqrt(m2) (+1e-8) over the whole tensor;
  - staged grad cap: the cap ``values[ptr]`` is read, then the pointer
    advances once if the step counter reached ``iters[ptr]`` (a new cap takes
    effect the next step); the update is rescaled so max|update| <= cap;
  - cosine-annealed learning rate, eta_min=1e-4 (torch CosineAnnealingLR as
    the reference trainer steps it).

Functional, optax-style: ``update_fn(grads, state) -> (updates, state)``
with updates to add to the parameter tensor. Every scalar stays a tensor on
the parameter's device, so a step never waits for the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Union

import torch


class AdamUniformState(NamedTuple):
    count: torch.Tensor        # int32 — completed update calls
    g1: torch.Tensor           # first moment, like the parameter
    g2: torch.Tensor           # second moment
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
    """(init_fn, update_fn) for AdamUniform on one parameter tensor."""
    values = tuple(float(v) for v in grad_limit_values)
    iters = tuple(int(i) for i in grad_limit_iters)
    if grad_limit and len(values) < len(iters) + 1:
        values = values + (values[-1],) * (len(iters) + 1 - len(values))

    def init_fn(params: torch.Tensor) -> AdamUniformState:
        def i32():
            return torch.zeros((), dtype=torch.int32, device=params.device)
        return AdamUniformState(count=i32(), g1=torch.zeros_like(params),
                                g2=torch.zeros_like(params),
                                limit_ptr=i32(), cc=i32())

    def update_fn(grads: torch.Tensor, state: AdamUniformState):
        dev = grads.device
        step = state.count + 1
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(b1, device=dev), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(b2, device=dev), stepf)
        g1 = b1 * state.g1 + (1.0 - b1) * grads
        g2 = b2 * state.g2 + (1.0 - b2) * grads * grads
        lr = learning_rate(state.count) if callable(learning_rate) \
            else torch.tensor(learning_rate, device=dev)

        limit_ptr = state.limit_ptr
        m1 = g1 / b1c
        m2 = g2 / b2c
        gr = m1 / (eps + torch.sqrt(torch.max(m2)))
        if grad_limit:
            vals = torch.tensor(values, device=dev)
            cap = vals[torch.clamp_max(state.limit_ptr, len(values) - 1)]
            if iters:
                its = torch.tensor(iters, dtype=torch.int32, device=dev)
                reached = state.cc >= its[torch.clamp_max(state.limit_ptr,
                                                          len(iters) - 1)]
                advance = (state.limit_ptr < len(iters)) & reached
                limit_ptr = state.limit_ptr + advance.to(torch.int32)
            s = torch.max(torch.abs(gr))
            gr = torch.where(s > cap, gr * (cap / torch.clamp_min(s, 1e-30)),
                             gr)
        updates = -lr * gr
        return updates, AdamUniformState(count=step, g1=g1, g2=g2,
                                         limit_ptr=limit_ptr, cc=state.cc + 1)

    return init_fn, update_fn


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return params + updates
