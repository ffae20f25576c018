"""The frozen-geometry exact texture stage (port of
``tssplat_tpu/materials/exact_stage.py``).

The texture stage fits the colour field against the reference's full-image
L1 with antialiasing while the geometry stays frozen (reference
trainer.py:44-48, materials/explicit_material.py:86-108). Everything but
the material parameters is static, so the cache built once per stage
holds, for every dataset view: the target and the background, the
foreground pixels' contracted world positions with the map from position
to pixel and from pixel to position, and the colour antialias's pair
weights (the visibility and the winners' rows never change, so neither
the visibility kernel nor K8 is launched inside a step). A step then
evaluates the material at those points only and runs the image-space
tail: the colours put back on the image, composited, antialiased on the
cached weights and compared with the target by the L1 (``ops/aa_l1.py``:
K10 on the card, its plain chain on the CPU).

The JAX package keeps static hash-table buckets here to avoid TPU
scatters; the port does not: on the card the encoding is the kernel pair
K9 (``ops/hash_grid.py``), whose backward adds the table gradient with
atomics, and on the CPU autograd's scatter-add of the gathered table rows
gives the same gradients (tests/test_torch_texture.py holds the loss and
gradients against JAX's exact loss and the port's dense path).

View-sharded over W ranks (``shard=(rank, W)``, JAX's ``mesh``,
exact_stage.py:154-245), each rank caches only its contiguous group of the
views and its loss is its group's L1 sum over the global n·res²·3: summed
over the ranks (the driver's one all_reduce of the loss and the parameter
gradients, ``parallel/mesh.py sync_step``) they are the one-process loss
and gradients. JAX's per-shard hash buckets stay unported, as the
unsharded ones are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.aa_l1 import image_l1_loss, tail_tables
from ..ops.rasterize import color_aa_weights, interpolate, rasterize
from ..ops.transform import transform_pos
from ..utils.profiling import span
from .explicit_material import contract_to_unisphere


# views whose antialias weights the cache makes in one pass
AA_VIEWS = 8


@torch.no_grad()
def build_texture_exact_cache(geometry, material, data_all, resolution: int,
                              is_ortho: bool = False,
                              tile_k: Optional[int] = None,
                              max_px: int = 4_000_000,
                              reason_out: Optional[list] = None,
                              shard: Tuple[int, int] = (0, 1)
                              ) -> Optional[dict]:
    """The static state of the exact texture stage over every view of
    ``data_all`` ("mvp", "img" with the target RGB composited over the
    background, "background"), built view by view (one visibility pass
    each). None, with the reason appended to ``reason_out``, where the JAX
    package refuses too: an encoding other than a plain HashGrid, or more
    foreground pixels than ``max_px`` (the knob and its default are JAX's;
    the port's cache costs ~16 B per foreground pixel and ~20 B per pixel
    of every view, not JAX's ~1 KB per foreground pixel). ``shard`` (rank,
    W) caches the rank-th of W contiguous groups of the views (W must
    divide them); the foreground count that ``max_px`` bounds is summed
    over the ranks (one all_reduce), so every rank decides alike."""
    enc_cfg = dict(material.cfg.pos_encoding_config)
    if enc_cfg.pop("otype", "HashGrid") not in ("HashGrid", "Grid") \
            or enc_cfg.pop("include_xyz", False) \
            or enc_cfg.pop("stochastic_table_grad", False):
        if reason_out is not None:
            reason_out.append(
                "encoding is not a plain HashGrid/Grid (include_xyz and "
                "stochastic_table_grad are unsupported)")
        return None

    statics = geometry.statics
    rank, n_shards = shard
    n_total = int(data_all["mvp"].shape[0])
    if n_total % n_shards:
        raise ValueError(f"n_shards={n_shards} must divide n_views={n_total}")
    n = n_total // n_shards
    views = slice(rank * n, (rank + 1) * n)
    mvp = data_all["mvp"][views]
    res = int(resolution)
    v_corner = geometry.tet_v[statics.corner_vid]
    pix, pts, aa, aa_w, group = [], [], [], [], []
    n_aa = 0
    for i in range(n):
        pc = transform_pos(mvp[i:i + 1], v_corner, is_ortho=is_ortho)
        ra, _ = rasterize(pc, (res, res), k=tile_k)
        fg = torch.nonzero(ra[0, ..., 3].reshape(-1) > 0)[:, 0]
        pts.append(interpolate(v_corner, ra)[0].reshape(-1, 3)[fg])
        pix.append(fg + i * res * res)
        group.append((ra, pc))
        if len(group) == AA_VIEWS or i == n - 1:
            a, w = tail_tables(color_aa_weights(
                torch.cat([g[0] for g in group]),
                torch.cat([g[1] for g in group]), statics.edge_nbrs), n_aa)
            n_aa += int(w.shape[0])
            aa.append(a)
            aa_w.append(w)
            group = []
    counts = [int(p.shape[0]) for p in pix]
    total_fg = sum(counts)
    if n_shards > 1:
        t = torch.tensor([float(total_fg)], device=v_corner.device)
        dist.all_reduce(t)
        total_fg = int(t.item())
    if total_fg > max_px:
        if reason_out is not None:
            reason_out.append(
                f"{total_fg} foreground pixels exceed texture_exact_max_px="
                f"{max_px} (bucket arrays are ~128 x 8 B per pixel)")
        return None
    pix = torch.cat(pix)
    fg = torch.full((n * res * res,), -1, dtype=torch.int32,
                    device=pix.device)
    fg[pix] = torch.arange(pix.shape[0], dtype=torch.int32,
                           device=pix.device)
    return {
        "pix": pix,                                     # (n_fg,) flat px
        "fg": fg.view(n, res, res),                     # (n,H,W) row or -1
        "aa": torch.cat(aa),                            # (n,H,W) row or -1
        "aa_w": torch.cat(aa_w),                        # (n_aa,4)
        "gt": data_all["img"][views, ..., :3].contiguous(),  # (n,H,W,3)
        "bg": data_all["background"][views].contiguous(),    # (n,H,W,3)
        "xc": contract_to_unisphere(torch.cat(pts), material.bbox),
        "n": n, "n_total": n_total, "P": max(1, max(counts)), "res": res,
    }


def build_texture_exact_loss(material, statics, cache: dict):
    """Loss closure (mat_params, it) -> (img_loss, reg) with the
    reference's exact texture semantics over every view of the cache:
    the material at the cached foreground points, the colours put back on
    the image (zero elsewhere), composited over the background by the
    mask, colour-antialiased, and the L1 against the target summed and
    divided by n·res²·3 (n: the views of all shards), × 20
    (``ops/aa_l1.py image_l1_loss``); reg is 0. ``statics`` is unused:
    the cache holds the antialias's weights."""
    xc = cache["xc"]
    enc_apply, net_apply = material.encoding.apply_fn, \
        material.network.apply_fn
    act = material.activation

    def loss_fn(mat_params, it):
        with span("tssplat.encoding"):
            feats = enc_apply(mat_params["encoding"], xc, it)
        with span("tssplat.mlp"):
            colors = act(net_apply(mat_params["network"], feats))  # (n_fg,3)
        with span("tssplat.antialias_color"):
            img_loss = image_l1_loss(colors, cache)
        return img_loss, torch.zeros((), device=img_loss.device)

    return loss_fn
