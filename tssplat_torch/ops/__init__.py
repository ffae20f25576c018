"""The port's ops API, under the names of ``tssplat_tpu/ops/__init__.py``:
the tet energy, the rasterizer, the camera transforms and the ray and
distance queries, plus ``antialias_color`` and ``visibility_ids``.

The rasterizer takes the corner layout (pos_clip (B,3F,4), face f = rows
3f..3f+2), returns ``(rast, n_drop)`` where JAX fills a ``drops_out``
list, and takes precomputed visibility as ``vis``. JAX's
``rasterize_ids_tiled`` has no counterpart by design: the port's binning
(``ops/binning.py``) and its visibility kernels (``ops/raster_kernels.py``)
replace it. Importing this package builds no kernel.

The function ``rasterize`` shadows the submodule of the same name as an
attribute of this package, as in the JAX package: ``from
tssplat_torch.ops.rasterize import ...`` and ``importlib.import_module(
"tssplat_torch.ops.rasterize")`` reach the module, while ``import
tssplat_torch.ops.rasterize as m`` binds the function.
"""

from .energy import (EnergyOps, barrier_order, build_energy_ops,
                     compute_G_matrix, deformation_gradients,
                     energy_coeff_schedule, laplacian_F,
                     smooth_barrier_energy)
from .rasterize import (antialias, antialias_color, interpolate, rasterize,
                        rasterize_ids, rasterize_silhouette, visibility_ids)
from .transform import fibonacci_views, look_at, perspective, transform_pos
from .queries import ray_mesh_first_hit, signed_distance

__all__ = [
    "EnergyOps", "build_energy_ops", "deformation_gradients",
    "smooth_barrier_energy", "energy_coeff_schedule", "barrier_order",
    "laplacian_F", "compute_G_matrix",
    "rasterize", "rasterize_ids", "rasterize_silhouette", "interpolate",
    "antialias", "antialias_color", "visibility_ids",
    "transform_pos", "look_at", "perspective", "fibonacci_views",
    "ray_mesh_first_hit", "signed_distance",
]
