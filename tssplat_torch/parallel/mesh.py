"""The view group: data parallelism over ranks (port of
``tssplat_tpu/parallel/mesh.py``).

The JAX package shards a batch's views over a 1-D ``view`` device mesh and
lets XLA insert the gradient psum. Here each rank is a process on a device:
it takes the views that device r of that mesh would hold (``shard_batch``),
computes its loss and gradient on them, and one collective per step
(``sync_step``) makes every rank's gradient and logged scalars those of the
whole batch. Parameters and optimizer state are replicated: every rank
applies the same update to the same bits.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

# batch entries with a leading per-view dimension (mesh.py:28)
VIEW_KEYS = ("mvp", "mv", "campos", "img", "background", "n", "d",
             "view_idx")

# how sync_step combines the ranks' gradients and scalars
MEAN = "mean"            # each rank's loss is a mean over an equal share
SUM = "sum"              # each rank's loss is its part of the global sum
BROADCAST = "broadcast"  # every rank ran the whole batch: take rank 0's


def shard_batch(batch: dict, rank: int, world: int,
                view_chunk: int = 0) -> dict:
    """The views of ``batch`` that device ``rank`` of a ``world``-device
    view mesh holds under ``shard_batch`` (mesh.py:70-94): the contiguous
    ``rank``-th of W equal parts, or with ``view_chunk`` (chunks of
    view_chunk views, the chunk axis sharded) the rank-th part of every
    chunk, in chunk order, so that the rank's own batch runs in chunks of
    view_chunk // world. Needs B % world == 0, and with ``view_chunk`` B %
    view_chunk == 0 and view_chunk % world == 0. Entries without a view
    axis pass through."""
    out = {}
    for k, v in batch.items():
        if k not in VIEW_KEYS or not torch.is_tensor(v):
            out[k] = v
            continue
        B = v.shape[0]
        if view_chunk:
            per = view_chunk // world
            v = v.reshape(B // view_chunk, view_chunk, *v.shape[1:])
            v = v[:, rank * per:(rank + 1) * per].reshape(-1, *v.shape[2:])
        else:
            per = B // world
            v = v[rank * per:(rank + 1) * per]
        out[k] = v
    return out


def sync_step(grads: List[torch.Tensor], img_loss: torch.Tensor,
              reg: torch.Tensor, n_drop: torch.Tensor, how: str
              ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One collective over the flattened gradient and the scalars
    (img_loss, reg, n_drop) of every rank: the sum (``SUM``), the sum over
    the world size (``MEAN``; n_drop is still summed) or rank 0's values
    (``BROADCAST``). Returns them in the shapes given; every rank gets the
    same bits."""
    dt = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([img_loss.to(dt), reg.to(dt),
                                     n_drop.to(dt)])])
    if how == BROADCAST:
        dist.broadcast(flat, src=0)
    else:
        dist.all_reduce(flat)
        if how == MEAN:
            body = flat[:-1]
            # a tensor divisor: CUDA divides by a Python scalar through its
            # reciprocal, which rounds unlike the CPU
            body.div_(torch.full_like(body, float(dist.get_world_size())))
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return (out, flat[at], flat[at + 1],
            flat[at + 2].round().to(n_drop.dtype))
