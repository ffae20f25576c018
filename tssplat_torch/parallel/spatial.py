"""Row-slab spatial sharding (port of ``tssplat_tpu/parallel/spatial.py``).

The ranks form a (view, sp) grid, rank = v * n_sp + s: rank (v, s) renders
the v-th of n_view equal groups of the batch's views, and of each of them
the horizontal slab of rows s * H_loc - HALO .. (s + 1) * H_loc + HALO,
where H_loc = ``slab_rows(H, n_sp)`` (rows past H are padding). The 8-row
halo keeps the vertical antialias pairs of the owned rows whole; the slab's
rows outside the image are zeroed and their vertical pairs cut. Each rank
sums its per-pixel losses over its owned rows, divided by the global
B * H * W, so that the sum over ranks (``parallel.mesh.sync_step`` with
``SUM``) is the unsharded loss and gradient; the energy, replicated, is
added on rank 0 only (it must enter the gradient once).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..geometry.tet_geometry import (GeometryStatics,
                                     compute_vertex_normals,
                                     geometry_forward)
from ..ops.rasterize import (antialias, antialias_silhouette, interpolate,
                             rasterize, rasterize_silhouette_with_rows)
from ..ops.transform import transform_pos

HALO = 8  # one 8-row tile: keeps slabs 8-aligned and covers the AA pairs

# batch entries split by pixel row (B,H,...) and by view only (B,...)
PIXEL_KEYS = ("img", "background", "n", "d")
VIEW_ONLY_KEYS = ("mvp", "mv", "campos", "view_idx")


def slab_rows(resolution: int, n_sp: int) -> int:
    """Rows each rank owns: ceil(H / n_sp) rounded up to a multiple of 8;
    H_loc * n_sp >= H, the excess rows are padding (spatial.py:58)."""
    h = -(-int(resolution) // n_sp)
    return -(-h // 8) * 8


def _pad_rows(v: torch.Tensor, n_sp: int, axis: int = 1) -> torch.Tensor:
    """Pad the row axis to n_sp * slab_rows(H) with zeros (spatial.py:252)."""
    H = v.shape[axis]
    H_pad = slab_rows(H, n_sp) * n_sp
    if H_pad == H:
        return v
    shape = list(v.shape)
    shape[axis] = H_pad - H
    return torch.cat([v, v.new_zeros(shape)], dim=axis)


def grid_coords(rank: int, n_sp: int):
    """(view group, slab) of ``rank`` on the (view, sp) grid."""
    return divmod(int(rank), int(n_sp))


def shard_spatial_train_batch(batch: dict, rank: int, n_view: int,
                              n_sp: int) -> dict:
    """What rank (v, s) of the (view, sp) grid holds of a loader batch
    (``shard_spatial_train_batch``, spatial.py:264): the v-th of n_view
    equal groups of the views, and of the image-like arrays (B,H,W,C) the
    owned rows s * H_loc .. (s + 1) * H_loc of the row axis padded to
    n_sp * H_loc. Other entries pass through."""
    v, s = grid_coords(rank, n_sp)
    out = {}
    for k, x in batch.items():
        if torch.is_tensor(x) and k in PIXEL_KEYS + VIEW_ONLY_KEYS:
            per = x.shape[0] // n_view
            x = x[v * per:(v + 1) * per]
            if k in PIXEL_KEYS:
                h = slab_rows(x.shape[1], n_sp)
                x = _pad_rows(x, n_sp)[:, s * h:(s + 1) * h]
        out[k] = x
    return out


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds unlike the CPU and JAX
    return x / torch.full_like(x, float(d))


def spatial_pixel_sums(tet_v: torch.Tensor, statics: GeometryStatics,
                       batch: dict, rank: int, n_sp: int, resolution: int,
                       is_ortho: bool = False, tile_k: Optional[int] = None,
                       fit_depth: bool = False, fit_normal: bool = False,
                       normal_flip_z: bool = True):
    """This rank's per-pixel loss sums over its owned rows of its views
    (``_spatial_pixel_losses``' ``local``, spatial.py:118-180): (sil_se,
    depth_se, normal_se, n_drop), differentiable in tet_v. ``batch`` is
    the rank's ``shard_spatial_train_batch``."""
    H = W = int(resolution)
    _, s = grid_coords(rank, n_sp)
    H_loc = slab_rows(H, n_sp)
    slab_h = H_loc + 2 * HALO
    row0 = s * H_loc - HALO
    vp = (row0, H)
    dev = tet_v.device

    v_corner = tet_v[statics.corner_vid]
    pos_clip = transform_pos(batch["mvp"], v_corner, is_ortho=is_ortho)
    absr = row0 + torch.arange(slab_h, device=dev)
    valid = (absr >= 0) & (absr < H)                     # halo + padding
    vr = valid[:, None]                                  # (slab_h,1)
    if fit_depth or fit_normal:
        rast, n_drop = rasterize(pos_clip, (slab_h, W), k=tile_k,
                                 viewport=vp)
        rast = rast * vr[..., None].to(rast.dtype)
        a = antialias(rast, pos_clip, statics.edge_nbrs, viewport=vp)
    else:
        ids, z, g6, gaux, n_drop = rasterize_silhouette_with_rows(
            pos_clip, statics.edge_nbrs, (slab_h, W), k=tile_k, viewport=vp)
        ids, z = ids * vr, z * vr
        g6, gaux = g6 * vr, gaux * vr
        a = antialias_silhouette(ids, z, g6, gaux, viewport=vp)

    own = a[:, HALO:HALO + H_loc]
    own_valid = valid[HALO:HALO + H_loc].to(own.dtype)[None, :, None]
    tgt_a = batch["img"][..., -1]
    sil = torch.sum(((own - tgt_a) * own_valid) ** 2)
    zero = torch.zeros((), dtype=own.dtype, device=dev)
    depth_se = normal_se = zero
    if fit_depth or fit_normal:
        a_gt = tgt_a * own_valid
    if fit_depth:
        wp = interpolate(v_corner, rast)
        d = torch.linalg.norm(wp - batch["campos"][:, None, None, :], dim=-1)
        depth_se = torch.sum(((d[:, HALO:HALO + H_loc]
                               - batch["d"][..., -1]) * a_gt) ** 2)
    if fit_normal:
        vn = compute_vertex_normals(tet_v[statics.surface_vid],
                                    statics.surface_fid, up=statics.z_up)
        if normal_flip_z:          # Wonder3D/GSO convention (spatial.py:106)
            vn = vn * statics.z_flip
        nr = interpolate(vn[statics.surface_fid.reshape(-1)], rast)
        normal_se = torch.sum(((nr[:, HALO:HALO + H_loc]
                                - batch["n"][..., :3]) * a_gt[..., None])
                              ** 2)
    return sil, depth_se, normal_se, torch.sum(n_drop)


def spatial_geometry_loss(tet_v: torch.Tensor, statics: GeometryStatics,
                          batch: dict, it: int, rank: int, n_view: int,
                          n_sp: int, resolution: int, is_ortho: bool = False,
                          tile_k: Optional[int] = None,
                          fit_depth: bool = False, fit_normal: bool = False,
                          normal_weight: float = 10.0):
    """This rank's share of the geometry-stage loss under (view, sp)
    sharding (``spatial_geometry_loss``, spatial.py:203): (loss,
    (img_loss, reg, n_drop)) with img_loss its pixel sums over the global
    B * H * W (silhouette x 20, depth x 100, normal x normal_weight / 3, as
    train.py's ``_img_loss``) and reg the energy on rank 0, 0 elsewhere.
    Summed over the ranks they are the unsharded loss, img_loss and reg."""
    if fit_depth and ("campos" not in batch or "d" not in batch):
        raise ValueError("spatial fit_depth needs 'campos' and 'd' in the "
                         "batch")
    if fit_normal and "n" not in batch:
        raise ValueError("spatial fit_normal needs 'n' in the batch")
    sil, dep, nrm, n_drop = spatial_pixel_sums(
        tet_v, statics, batch, rank, n_sp, resolution, is_ortho=is_ortho,
        tile_k=tile_k, fit_depth=fit_depth, fit_normal=fit_normal)
    denom = float(batch["mvp"].shape[0] * n_view * resolution * resolution)
    img_loss = _div(sil, denom) * 20.0
    if fit_depth:
        img_loss = img_loss + 100.0 * _div(dep, denom)
    if fit_normal:
        img_loss = img_loss + normal_weight * _div(nrm, denom * 3)
    if rank == 0:
        reg = geometry_forward(tet_v, statics, it).energy
    else:
        reg = torch.zeros((), dtype=img_loss.dtype, device=img_loss.device)
    return img_loss * 100.0 + reg, (img_loss, reg, n_drop)
