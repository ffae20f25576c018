"""The plain reference of the Wonder3D-layout, orthographic geometry fit:
img_to_3D.yaml read through ``Wonder3DDataLoader`` and rendered with
``renderer.is_orhto: true``.

The geometry stage of ``steps.py`` (the reference trainer's
trainer.py:98-115), with the departures of this layout, each upstream's
own:

- clip positions are [v, 1] @ mvp^T with z then divided by 6
  (renderers/mesh_rasterizer.py:76-77); w stays 1, so the barycentrics'
  1/w correction is the identity;
- the normal term compares the vertex normals with z negated (Wonder3D's
  convention, mesh_rasterizer.py:137-149), interpolated at each pixel's
  winner, with the target's normals: img_loss = 20 MSE(alpha) + w
  MSE(normal a, target a), a the target alpha, averaged over the views;
  loss = 100 img_loss + the energy of the tets;
- the targets are the dataset's arrays once loaded (float32, the alpha 0
  or 1, the normals in [-1, 1]; ``benchmark/inputs/wonder3d_spheres.py``),
  not 8-bit images;
- there is no depth term: under Wonder3D the dataset's depth target is the
  alpha and ``campos`` a placeholder, so ``fit_depth`` raises rather than
  comparing a distance from a camera position the layout lacks;
- there is no texture stage.

Every product is float32 with TF32 off; ``precision="tf32"`` rounds the
clip transform's operands to TF32 (the control).
"""

from __future__ import annotations

import torch

from . import energy as en
from . import steps
from .mesh import edge_neighbours, surface
from .raster import (antialias, clip_positions, interpolate, pair_counts,
                     shade, vertex_normals, visibility, winner_rows)
from .steps import leaf_names  # noqa: F401  (the reference's contract)

Z_DIV = 6.0
FLIP = (1.0, 1.0, -1.0)


def ortho_clip(points: torch.Tensor, mvp: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """World points (V,3) -> clip space (B,V,4) under the orthographic
    cameras mvp (B,4,4): the product of ``raster.clip_positions``, z / 6."""
    pos = clip_positions(points, mvp, precision)
    return torch.cat([pos[..., :2], pos[..., 2:3] / Z_DIV, pos[..., 3:]],
                     dim=-1)


class Reference(steps.Reference):
    """The reference run of a Problem on ``device``; ``precision`` "f32"
    or "tf32" (the control)."""

    def __init__(self, prob: steps.Problem, device, precision: str = "f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = prob.cfg
        if cfg.get("fitting_stage", "geometry") != "geometry":
            raise ValueError("the orthographic reference fits geometry only")
        if cfg.get("fit_depth", False):
            raise ValueError("no depth term under the Wonder3D layout: its "
                             "depth target is the alpha, campos a "
                             "placeholder")
        super().__init__(prob, device, precision)

    def clip(self, points: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
        return ortho_clip(points, mvp, self.prec)

    def normals(self, x: torch.Tensor) -> torch.Tensor:
        """Unit vertex normals of the surface at tet vertices x, z negated
        (S,3)."""
        return vertex_normals(x[self.surface_vid], self.faces) \
            * torch.tensor(FLIP, device=x.device)

    def _view_data(self, idx):
        p, dev = self.p, self.dev
        out = {"mvp": torch.as_tensor(p.mvp[idx], device=dev),
               "img": torch.as_tensor(p.rgba[idx], dtype=torch.float32,
                                      device=dev)}
        if p.normal is not None:
            out["n"] = torch.as_tensor(p.normal[idx], device=dev)
        return out

    def geometry_loss_grad(self, x: torch.Tensor, it: int):
        """(loss, gradient) of iteration ``it`` at tet vertices x."""
        _, _, fit_normal, nw = steps._flags(self.p.cfg)
        x = x.detach().requires_grad_(True)
        n_chunks = -(-len(self.views) // steps.CHUNK)
        total = torch.zeros((), device=self.dev)
        for idx in self._chunks():
            vd = self._view_data(idx)
            pos = self.clip(x[self.corner], vd["mvp"])
            ids, z = visibility(pos.detach(), self.res)
            g, aux = winner_rows(pos, self.nbrs, ids)
            cov = (ids > 0).to(torch.float32)[..., None]
            a_t = vd["img"][..., 3]
            if fit_normal:
                rast = shade(pos, ids, self.res)
                z = rast[..., 2].detach()
            alpha = antialias(cov, ids, z, g, aux)[..., 0]
            il = torch.mean((alpha - a_t) ** 2) * 20.0
            if fit_normal:
                nrm = interpolate(self.normals(x)[self.faces.reshape(-1)],
                                  rast)
                a = a_t[..., None]
                il = il + nw * torch.mean((nrm * a - vd["n"][..., :3] * a)
                                          ** 2)
            (il * (100.0 / n_chunks)).backward()
            total = total + il.detach()
        c1, c2 = en.coefficients(it, self.smooth, self.barrier)
        e = en.energy(x, self.ops, c1, c2,
                      4 if it > self.order_iter else 2)
        e.backward()
        loss = total / n_chunks * 100.0 + e.detach()
        return loss, x.grad.detach()


@torch.no_grad()
def pair_counts_of(prob: steps.Problem, x: torch.Tensor, shaded: bool,
                   device) -> dict:
    """The silhouette antialias's pair counts over every view at tet
    vertices x under the orthographic projection, in chunks of views as
    the reference projects and bins them, summed (the work
    ``antialias_roofline`` is measured against)."""
    sv, sf = surface(prob.tets)
    corner = torch.as_tensor(sv[sf].reshape(-1), device=device)
    nbrs = torch.as_tensor(edge_neighbours(sf), device=device)
    res = int(prob.rgba.shape[1])
    total: dict = {}
    for s in range(0, prob.mvp.shape[0], steps.CHUNK):
        pos = ortho_clip(x[corner], torch.as_tensor(
            prob.mvp[s:s + steps.CHUNK], device=device))
        ids, z = visibility(pos, res)
        if shaded:
            z = shade(pos, ids, res)[..., 2]
        g, aux = winner_rows(pos, nbrs, ids)
        for k, v in pair_counts(ids, z, g, aux).items():
            total[k] = total.get(k, 0) + v
    return total
