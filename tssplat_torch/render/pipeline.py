"""Multi-view render (port of ``tssplat_tpu/render/pipeline.py``
``render_views``, pipeline.py:131-242: the silhouette, depth, normal and
colour outputs).

corner gather -> clip transform -> then either
  silhouette only: binning + K1 or K2b visibility with winner rows ->
      K4/K5 antialias;
  with fit_depth / fit_normal: binning + K1 or K2a visibility -> the
      differentiable shading of the winners (u, v, z) -> coverage antialias
      (rows gathered from the face table, K3/K4/K5) -> interpolated vertex
      normals (z flipped for Wonder3D-convention datasets) and
      ||world position - campos||;
  colour (only_alpha=False, the texture stage): binning + K1 or K2a -> the
      shading of the winners -> world positions interpolated at the
      foreground pixels -> the material evaluated there -> composited over
      the background by the mask -> colour antialias (plain PyTorch pairs;
      K3 only when the positions carry a gradient).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import parse_structured
from ..geometry.tet_geometry import (GeometryStatics, compute_vertex_normals,
                                     geometry_forward,
                                     permute_surface_vertices)
from ..ops.rasterize import (antialias, antialias_color,
                             antialias_silhouette, interpolate, rasterize,
                             rasterize_silhouette_with_rows,
                             silhouette_visibility, visibility_ids)
from ..ops.transform import transform_pos
from ..utils.profiling import span


class RenderOutput(NamedTuple):
    shaded: torch.Tensor     # (B,H,W,1) silhouette, or (B,H,W,3) colour
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
    fit_depth, fit_normal or the colour). ``render_views(..., vis=...)`` takes what it
    returns instead of running the pass itself."""
    with torch.no_grad():
        pos_clip = transform_pos(mvp, tet_v.detach()[geom.corner_vid],
                                 is_ortho=is_ortho)
    res = (int(resolution), int(resolution))
    if shaded:
        return visibility_ids(pos_clip, res, tile_k)
    return silhouette_visibility(pos_clip, geom.edge_nbrs, res, tile_k)


def _apply_material_chunked(material_fn: Callable, params,
                            positions: torch.Tensor, it: int,
                            chunk: int = 1 << 17) -> torch.Tensor:
    """The material over a flat point list (…,3) in chunks of ``chunk``
    points (``_apply_material_chunked``, pipeline.py:51), each recomputed
    in the backward (``torch.utils.checkpoint``, as JAX's
    ``jax.checkpoint``) so that one chunk's encoding intermediates are
    alive at a time; the iteration reaches progressive encodings."""
    shp = positions.shape
    flat = positions.reshape(-1, shp[-1])
    n = flat.shape[0]
    if n <= chunk:
        return material_fn(params, flat, it).reshape(*shp[:-1], -1)

    def part(p):
        return material_fn(params, p, it)

    outs = [checkpoint(part, flat[s:s + chunk], use_reentrant=False,
                       preserve_rng_state=False)
            if torch.is_grad_enabled() else part(flat[s:s + chunk])
            for s in range(0, n, chunk)]
    return torch.cat(outs).reshape(*shp[:-1], -1)


def _eval_material_masked(material_fn: Callable, params,
                          positions: torch.Tensor, mask: torch.Tensor,
                          it: int) -> torch.Tensor:
    """The material at the foreground pixels only (mask (B,H,W,1) > 0),
    zero elsewhere (``_eval_material_masked``, pipeline.py:76): the
    foreground is picked by boolean indexing, where JAX compacts 8x8
    subtiles under a static cap. Values and the gradients w.r.t. the
    material parameters equal evaluating the whole grid at every masked
    pixel, and a background position never reaches the material."""
    fg = mask[..., 0] > 0
    vals = _apply_material_chunked(material_fn, params, positions[fg], it)
    out = positions.new_zeros((*fg.shape, vals.shape[-1]))
    out[fg] = vals
    return out


def render_views(tet_v: torch.Tensor, geom: GeometryStatics,
                 mvp: torch.Tensor, it: int, resolution: int, *,
                 only_alpha: bool = True,
                 material_fn: Optional[Callable] = None,
                 material_params=None,
                 background: Optional[torch.Tensor] = None,
                 campos: Optional[torch.Tensor] = None,
                 fit_normal: bool = False, fit_depth: bool = False,
                 is_ortho: bool = False, normal_flip_z: bool = True,
                 tile_k: Optional[int] = None, vis=None) -> RenderOutput:
    """Render a batch of views mvp (B,4,4) of the current geometry: the
    antialiased silhouettes (``only_alpha``) or, with ``material_fn`` /
    ``material_params`` and ``background`` (B,H,W,3), the antialiased
    colour over the background; the geometry energy; on request the normal
    and depth images (depth needs campos (B,3)). ``tile_k`` is the capped
    layout's per-tile capacity (see validated_tile_k); ``vis`` the output
    of ``render_visibility`` for the same arguments, if it was run
    beforehand."""
    fwd = geometry_forward(tet_v, geom, it)
    # corner layout: one gather expands tet_v to per-(face, corner) rows,
    # so every per-face access downstream is a reshape
    v_corner = tet_v[geom.corner_vid]                     # (3F,3)
    pos_clip = transform_pos(mvp, v_corner, is_ortho=is_ortho)
    res = (int(resolution), int(resolution))
    if only_alpha and not (fit_normal or fit_depth):
        ids, z, g6, gaux, n_drop = rasterize_silhouette_with_rows(
            pos_clip, geom.edge_nbrs, res, k=tile_k, vis=vis)
        alpha = antialias_silhouette(ids, z, g6, gaux)[..., None]
        return RenderOutput(shaded=alpha, geo_regularization=fwd.energy,
                            n_drop=n_drop)

    rast, n_drop = rasterize(pos_clip, res, k=tile_k, vis=vis)
    if only_alpha:
        shaded = antialias(rast, pos_clip, geom.edge_nbrs)[..., None]
    else:
        if material_fn is None or background is None:
            raise ValueError("color path needs material_fn and background")
        mask = (rast[..., 3:4] > 0).to(pos_clip.dtype)
        positions = interpolate(v_corner, rast)
        # the iteration reaches progressive encodings
        color = _eval_material_masked(material_fn, material_params,
                                      positions, mask, it)
        gb = background + (color - background) * mask
        shaded = antialias_color(gb, rast, pos_clip, geom.edge_nbrs)
    normal = depth = None
    if fit_normal:
        tri = fwd.t_pos_idx
        v_nrm = compute_vertex_normals(fwd.v_pos, tri)
        if normal_flip_z:      # Wonder3D/GSO convention (reference :141-144)
            with span("tssplat.sync.normals"):   # a host-to-device copy
                flip = torch.tensor([1.0, 1.0, -1.0], dtype=v_nrm.dtype,
                                    device=v_nrm.device)
            v_nrm = v_nrm * flip
        normal = interpolate(v_nrm[tri.reshape(-1)], rast)
    if fit_depth:
        if campos is None:
            raise ValueError("fit_depth needs campos")
        wp = interpolate(v_corner, rast)
        depth = torch.linalg.norm(wp - campos[:, None, None, :], dim=-1,
                                  keepdim=True)
    return RenderOutput(shaded=shaded, geo_regularization=fwd.energy,
                        normal=normal, depth=depth, n_drop=n_drop)


class MeshRasterizer:
    """Object wrapper with the reference's constructor and forward shape
    (``MeshRasterizer``, pipeline.py:245; reference renderers/
    mesh_rasterizer.py:26-163) around ``render_views``. ``context_type``
    is accepted for config compatibility and ignored."""

    @dataclass
    class Config:
        context_type: str = "cuda"
        is_orhto: bool = False          # sic — reference config key spelling

    def __init__(self, geometry, materials=None, cfg=None):
        self.cfg = parse_structured(self.Config, cfg)
        self.geometry = geometry
        self.materials = materials

    def __call__(self, mvp, only_alpha: bool, iter_num, resolution: int,
                 permute_surface_scheduler=None, fit_normal: bool = False,
                 fit_depth: bool = False, background=None, campos=None,
                 generator: Optional[torch.Generator] = None) -> dict:
        """{"shaded", "geo_regularization"[, "n", "d"]} of the views mvp
        (B,4,4). With a permute scheduler that fires at ``iter_num`` the
        geometry's surface vertices are perturbed first, by draws from
        ``generator`` (a CPU generator; seeded by iter_num if None)."""
        geo = self.geometry
        if permute_surface_scheduler is not None:
            dev = permute_surface_scheduler(int(iter_num))
            if dev is not None:
                gen = generator if generator is not None else \
                    torch.Generator().manual_seed(int(iter_num))
                geo.set_tet_v(permute_surface_vertices(
                    geo.tet_v, geo.statics.surface_vid, gen, dev))
        material_fn = material_params = None
        if self.materials is not None:
            material_fn = self.materials.apply_fn
            material_params = self.materials.params
        out = render_views(
            geo.tet_v, geo.statics,
            torch.as_tensor(mvp, dtype=torch.float32, device=geo.device),
            int(iter_num), resolution, only_alpha=only_alpha,
            material_fn=material_fn, material_params=material_params,
            background=background, campos=campos, fit_normal=fit_normal,
            fit_depth=fit_depth, is_ortho=self.cfg.is_orhto)
        d = {"shaded": out.shaded,
             "geo_regularization": out.geo_regularization}
        if out.normal is not None:
            d["n"] = out.normal
        if out.depth is not None:
            d["d"] = out.depth
        return d

    def export(self, path: str, folder: str, texture_res: int = 1024):
        """The textured OBJ (reference :165-241), through the materials'
        bake once a material is fitted."""
        if self.materials is None:
            raise ValueError("export requires a fitted material")
        from ..materials.export import export_textured_obj
        export_textured_obj(self.geometry, self.materials, path, folder,
                            texture_res=texture_res)
