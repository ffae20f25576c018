"""Multi-view render of the geometry stage (port of
``tssplat_tpu/render/pipeline.py`` ``render_views``, pipeline.py:131-242,
the silhouette, depth and normal outputs).

corner gather -> clip transform -> then either
  silhouette only: binning + K1 or K2b visibility with winner rows ->
      K4/K5 antialias;
  with fit_depth / fit_normal: binning + K1 or K2a visibility -> the
      differentiable shading of the winners (u, v, z) -> coverage antialias
      (rows gathered from the face table, K3/K4/K5) -> interpolated vertex
      normals (z flipped for Wonder3D-convention datasets) and
      ||world position - campos||.
The colour (texture-stage) output is not part of this module.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.tet_geometry import (GeometryStatics, compute_vertex_normals,
                                     geometry_forward)
from ..ops.rasterize import (antialias, antialias_silhouette, interpolate,
                             rasterize, rasterize_silhouette_with_rows,
                             silhouette_visibility, visibility_ids)
from ..ops.transform import transform_pos


class RenderOutput(NamedTuple):
    shaded: torch.Tensor                 # (B,H,W,1) antialiased silhouette
    geo_regularization: torch.Tensor     # scalar energy
    normal: Optional[torch.Tensor] = None    # (B,H,W,3) (fit_normal)
    depth: Optional[torch.Tensor] = None     # (B,H,W,1) (fit_depth)
    # per-view dropped-candidate counts (B,) int32: faces cut off by the
    # capped layout's per-tile capacity (0 on K1's uncapped lists);
    # non-zero means a silhouette may be wrong
    n_drop: Optional[torch.Tensor] = None


def render_visibility(tet_v: torch.Tensor, geom: GeometryStatics,
                      mvp: torch.Tensor, resolution: int, *, shaded: bool,
                      is_ortho: bool = False, tile_k: Optional[int] = None):
    """The visibility pass of ``render_views`` alone, without gradient:
    binning and the visibility kernel (K2b or K1 with winner rows for the
    silhouette; K2a or K1 without rows when ``shaded``, i.e. with
    fit_depth or fit_normal). ``render_views(..., vis=...)`` takes what it
    returns instead of running the pass itself."""
    with torch.no_grad():
        pos_clip = transform_pos(mvp, tet_v.detach()[geom.corner_vid],
                                 is_ortho=is_ortho)
    res = (int(resolution), int(resolution))
    if shaded:
        return visibility_ids(pos_clip, res, tile_k)
    return silhouette_visibility(pos_clip, geom.edge_nbrs, res, tile_k)


def render_views(tet_v: torch.Tensor, geom: GeometryStatics,
                 mvp: torch.Tensor, it: int, resolution: int, *,
                 campos: Optional[torch.Tensor] = None,
                 fit_normal: bool = False, fit_depth: bool = False,
                 is_ortho: bool = False, normal_flip_z: bool = True,
                 tile_k: Optional[int] = None, vis=None) -> RenderOutput:
    """Render the antialiased silhouettes of the current geometry for a
    batch of views mvp (B,4,4), the geometry energy and, on request, the
    normal and depth images (depth needs campos (B,3)). ``tile_k`` is the
    capped layout's per-tile capacity (see validated_tile_k); ``vis`` the
    output of ``render_visibility`` for the same arguments, if it was run
    beforehand."""
    fwd = geometry_forward(tet_v, geom, it)
    # corner layout: one gather expands tet_v to per-(face, corner) rows,
    # so every per-face access downstream is a reshape
    v_corner = tet_v[geom.corner_vid]                     # (3F,3)
    pos_clip = transform_pos(mvp, v_corner, is_ortho=is_ortho)
    res = (int(resolution), int(resolution))
    if not (fit_normal or fit_depth):
        ids, z, g6, gaux, n_drop = rasterize_silhouette_with_rows(
            pos_clip, geom.edge_nbrs, res, k=tile_k, vis=vis)
        alpha = antialias_silhouette(ids, z, g6, gaux)[..., None]
        return RenderOutput(shaded=alpha, geo_regularization=fwd.energy,
                            n_drop=n_drop)

    rast, n_drop = rasterize(pos_clip, res, k=tile_k, vis=vis)
    alpha = antialias(rast, pos_clip, geom.edge_nbrs)[..., None]
    normal = depth = None
    if fit_normal:
        tri = fwd.t_pos_idx
        v_nrm = compute_vertex_normals(fwd.v_pos, tri)
        if normal_flip_z:      # Wonder3D/GSO convention (reference :141-144)
            v_nrm = v_nrm * torch.tensor([1.0, 1.0, -1.0], dtype=v_nrm.dtype,
                                         device=v_nrm.device)
        normal = interpolate(v_nrm[tri.reshape(-1)], rast)
    if fit_depth:
        if campos is None:
            raise ValueError("fit_depth needs campos")
        wp = interpolate(v_corner, rast)
        depth = torch.linalg.norm(wp - campos[:, None, None, :], dim=-1,
                                  keepdim=True)
    return RenderOutput(shaded=alpha, geo_regularization=fwd.energy,
                        normal=normal, depth=depth, n_drop=n_drop)
