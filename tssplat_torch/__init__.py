"""tssplat_torch — TetSphere splatting in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``tssplat_tpu`` (JAX on TPU), which stays beside it as the
reference. This package imports neither JAX nor ``tssplat_tpu``; it keeps
its own copies of the host numpy code it needs.

Layers (mirroring ``tssplat_tpu``):
  mesh      — tet-mesh container, surface topology, sphere meshing (numpy)
  ops       — energy, clip transform, binning, visibility/antialias kernels
  geometry  — optimizable tet geometry state
  render    — multi-view silhouette render
  optim     — AdamUniform + cosine LR
  train     — geometry-stage train step
  kernels   — nvcc build of csrc/*.cu, loaded with ctypes
  convert   — JAX-side arrays -> the port's tensors
"""

__version__ = "0.1.0"
