"""tssplat_torch — TetSphere splatting in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``tssplat_tpu`` (JAX on TPU), which stays beside it as the
reference. This package imports neither JAX nor ``tssplat_tpu``; it keeps
its own copies of the host numpy code it needs.

Layers (mirroring ``tssplat_tpu``):
  train     — the driver (``python -m tssplat_torch.train --config ...``)
              and the train steps: the geometry stage, view-chunked or
              whole, and the texture stage (exact, sampled or dense)
  config    — YAML configs, CLI overrides, registries
  data      — multi-view datasets and the view-batch loader
  utils     — checkpoints, the throughput meter, rank discovery and the
              process group (utils/env.py)
  parallel  — multi-rank training: the view group, row-slab spatial
              sharding
  mesh      — tet-mesh container, surface topology, sphere meshing (numpy)
  ops       — energy, clip transform, binning, visibility/antialias kernels
  geometry  — optimizable tet geometry state
  render    — multi-view silhouette, depth, normal and colour render
  models    — hash-grid and frequency encodings, MLPs
  materials — the colour field (ExplicitMaterial), the exact texture
              stage, the textured-OBJ bake
  optim     — AdamUniform + cosine LR, Adam + cosine decay (on a tensor
              or a dict of them)
  kernels   — nvcc build of csrc/*.cu, loaded with ctypes
  convert   — JAX-side arrays -> the port's tensors
"""

__version__ = "0.1.0"
