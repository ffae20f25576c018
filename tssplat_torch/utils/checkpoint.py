"""Full-state checkpoint and resume (the port of
``tssplat_tpu/utils/checkpoint.py``).

The whole ``TrainState`` (params, either optimizer's state, best loss /
iteration / params) and the iteration it was taken at go to
``<dir>/step_{step:08d}.pt``, written to a temporary file and then
``os.replace``d into place, so a kill during the write leaves the previous
checkpoints whole; the newest ``keep`` are kept.

The format is the port's own (the JAX package writes orbax checkpoints):
``torch.save`` of plain dicts of CPU tensors, each NamedTuple stored as
{"type": class name, "fields": {...}}, a dict of tensors (the texture
stage's material parameters and their moments) as a dict. ``torch.load`` reads it with
``weights_only=True``, which refuses arbitrary classes; ``restore_checkpoint``
rebuilds the NamedTuples from the template's types and places every tensor
on the template's device. A tensor whose shape differs from the template's
raises ValueError, as orbax's restore does (a checkpoint written after a
remesh holds another topology than a freshly built geometry).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _plain(node: Any) -> Any:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {"type": type(node).__name__,
                "fields": {k: _plain(v) for k, v in node._asdict().items()}}
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return node


def _rebuild(plain: Any, template: Any) -> Any:
    if isinstance(template, torch.Tensor):
        if not isinstance(plain, torch.Tensor):
            raise ValueError(f"checkpoint holds {type(plain).__name__} "
                             f"where the template has a tensor")
        if plain.shape != template.shape:
            raise ValueError(f"checkpoint holds shape {tuple(plain.shape)} "
                             f"where the template has "
                             f"{tuple(template.shape)}")
        return plain.to(template.device)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        name = type(template).__name__
        if not isinstance(plain, dict) or plain.get("type") != name:
            got = plain.get("type") if isinstance(plain, dict) else plain
            raise ValueError(f"checkpoint holds {got!r} where the template "
                             f"has {name}")
        return type(template)(**{k: _rebuild(plain["fields"][k], v)
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        if not isinstance(plain, dict) or set(plain) != set(template):
            raise ValueError(f"checkpoint holds {plain!r:.80} where the "
                             f"template has a dict of {sorted(template)}")
        return {k: _rebuild(plain[k], v) for k, v in template.items()}
    return plain


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    keep: int = 3) -> None:
    """Write ``state`` as the checkpoint of ``step``; keep the newest
    ``keep``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _path(ckpt_dir, int(step))
    tmp = final + ".tmp"
    torch.save({"step": int(step), "state": _plain(state)}, tmp)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-max(int(keep), 1)]:
        os.remove(_path(ckpt_dir, old))


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(os.path.abspath(ckpt_dir))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[int, Any]:
    """(step, state) of the checkpoint of ``step`` (the newest when None);
    ``template`` is a state of the target structure (an initialised
    TrainState) whose tensors' devices the restored ones take."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    blob = torch.load(_path(ckpt_dir, int(step)), map_location="cpu",
                      weights_only=True)
    return int(blob["step"]), _rebuild(blob["state"], template)
