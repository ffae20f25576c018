"""What every kernel wrapper of the port does around its launch: choose the
plain version for a CPU tensor, check its tensors, launch on PyTorch's
current stream and raise where the launch returns an error."""

from __future__ import annotations

import torch

from . import build


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless ``t`` has ``dtype`` (and ``shape`` and ``device``
    where given) and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (plain version), True for CUDA (kernel)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def launch(fn_name: str, *args) -> None:
    """Call the C entry ``fn_name`` with ``args`` and the current stream;
    raise if it returns a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = build.entry(fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()
