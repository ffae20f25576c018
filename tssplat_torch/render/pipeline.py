"""Multi-view silhouette render (port of ``tssplat_tpu/render/pipeline.py``
``render_views``, silhouette branch).

corner gather -> clip transform -> binning + K1 visibility with winner
rows -> K4/K5 antialias. Colour, normal and depth outputs are not part of
this branch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.tet_geometry import GeometryStatics, geometry_forward
from ..ops.rasterize import (antialias_silhouette,
                             rasterize_silhouette_with_rows)
from ..ops.transform import transform_pos


class RenderOutput(NamedTuple):
    shaded: torch.Tensor                 # (B,H,W,1) antialiased silhouette
    geo_regularization: torch.Tensor     # scalar energy
    normal: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    # per-view dropped-candidate counts (B,) int32: the binning has no caps,
    # so this is always 0 (the JAX binning's pool cap could drop faces)
    n_drop: Optional[torch.Tensor] = None


def render_views(tet_v: torch.Tensor, geom: GeometryStatics,
                 mvp: torch.Tensor, it: int, resolution: int, *,
                 is_ortho: bool = False) -> RenderOutput:
    """Render the antialiased silhouettes of the current geometry for a
    batch of views mvp (B,4,4), and the geometry energy."""
    fwd = geometry_forward(tet_v, geom, it)
    # corner layout: one gather expands tet_v to per-(face, corner) rows,
    # so every per-face access downstream is a reshape
    v_corner = tet_v[geom.corner_vid]                     # (3F,3)
    pos_clip = transform_pos(mvp, v_corner, is_ortho=is_ortho)
    res = (int(resolution), int(resolution))
    ids, z, g6, gaux, n_drop = rasterize_silhouette_with_rows(
        pos_clip, geom.edge_nbrs, res)
    alpha = antialias_silhouette(ids, z, g6, gaux)[..., None]
    return RenderOutput(shaded=alpha, geo_regularization=fwd.energy,
                        n_drop=n_drop)
