"""Numeric sanitizers (port of ``tssplat_tpu/utils/debug.py``).

The reference gates finiteness assertions on torch's anomaly mode
(reference geometry/tetmesh_geometry.py:63-64, 112-113) and otherwise runs
unchecked. Here:

- ``set_anomaly(True)`` / env ``TSSPLAT_ANOMALY=1``: a process-wide anomaly
  mode, as ``torch.autograd.set_detect_anomaly`` is one; it is also on
  while torch's own is. While it is on, each ``check_finite`` site reads its
  tensor on the host and raises ``RuntimeError("non-finite <name>")``. Off
  (the default), a site returns at once: no launch, no sync.
- ``enable_debug_nans()``: the counterpart of ``jax_debug_nans``. A
  ``TorchDispatchMode`` checks every floating output of every op (forward
  and backward) and raises ``FloatingPointError`` naming the op that made
  the first NaN. The CUDA kernels are launched through ctypes, outside the
  dispatcher, so their wrappers (``ops/raster_kernels.py``) check their own
  outputs with ``check_kernel_outputs`` while the trap is on. Slow:
  every op syncs; for debugging only.
- ``sanitizers(debug_nans, anomaly)``: both for the span of a ``with``
  block, the previous settings restored at its end (the driver's
  ``debug_nans`` and ``anomaly`` keys).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ANOMALY = os.environ.get("TSSPLAT_ANOMALY", "0") not in ("", "0")


def set_anomaly(enabled: bool) -> None:
    """Turn anomaly mode on or off (affects the calls made afterwards)."""
    global _ANOMALY
    _ANOMALY = bool(enabled)


def anomaly_enabled() -> bool:
    return _ANOMALY or torch.is_anomaly_enabled()


def check_finite(x: torch.Tensor, name: str) -> None:
    """Raise ``RuntimeError("non-finite <name>")`` if anomaly mode is on
    and ``x`` holds a NaN or an inf; nothing at all when it is off."""
    if not anomaly_enabled():
        return
    if not bool(torch.isfinite(x.detach()).all()):
        raise RuntimeError(f"non-finite {name}")


# ops whose output is memory not yet written: their bits mean nothing
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_", "set_"})


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and bool(torch.isnan(t).any()))


class NanTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating output
    holds a NaN, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNWRITTEN and any(
                _has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(f"invalid value (nan) encountered in "
                                     f"{func}")
        return out


_TRAP: Optional[NanTrap] = None


def debug_nans_enabled() -> bool:
    return _TRAP is not None


def enable_debug_nans(enabled: bool = True) -> None:
    """Turn the global NaN trap on or off (this thread's ops, and the
    backward passes it runs)."""
    global _TRAP
    if enabled and _TRAP is None:
        _TRAP = NanTrap()
        _TRAP.__enter__()
    elif not enabled and _TRAP is not None:
        trap, _TRAP = _TRAP, None
        trap.__exit__(None, None, None)


def check_kernel_outputs(name: str, *outs) -> None:
    """Under the NaN trap, raise at a kernel (launched outside the
    dispatcher) whose output holds a NaN, as the trap raises at an op."""
    if _TRAP is not None and any(_has_nan(t) for t in outs):
        raise FloatingPointError(f"invalid value (nan) encountered in "
                                 f"kernel {name}")


@contextlib.contextmanager
def sanitizers(debug_nans: bool = False, anomaly: bool = False):
    """The NaN trap and anomaly mode on (where asked) inside the block;
    the settings before it are restored after it."""
    was_anomaly, was_trap = _ANOMALY, _TRAP is not None
    if anomaly:
        set_anomaly(True)
    if debug_nans:
        enable_debug_nans(True)
    try:
        yield
    finally:
        enable_debug_nans(was_trap)
        set_anomaly(was_anomaly)
