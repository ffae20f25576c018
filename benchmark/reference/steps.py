"""The reference's training steps: the loss and gradient of one iteration
over every view, and three optimizer steps from the seed's start.

Geometry stage (the reference trainer's trainer.py:98-115): over each view
the antialiased silhouette (and, where the cell fits them, the depth
||p - campos|| and the vertex normals, z negated, of each pixel's winner);
img_loss = 20 MSE(alpha) [+ 100 MSE(depth a, target a)] [+ w MSE(normal
a, target a)], a the target alpha, averaged over the views; loss = 100
img_loss + the energy of the tets; gradient w.r.t. the tet vertices.

Texture stage (materials/explicit_material.py:86-108): the colour field at
each foreground pixel's interpolated world point (mapped from [-1,1]^3 to
[0,1]^3), composited over the background by the coverage, antialiased;
img_loss = 20 x the mean L1 against the target RGB over every view's
pixels and channels; loss = 100 img_loss; gradient w.r.t. the field's
leaves. The geometry is frozen.

The views are taken in chunks, each chunk's part of the loss
differentiated at once, so that the reference fits beside nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import energy as en
from . import field as fd
from .mesh import edge_neighbours, surface
from .optim import AdamUniform
from .raster import (antialias, clip_positions, interpolate, pair_counts,
                     shade, vertex_normals, visibility, winner_rows)


@dataclass
class Problem:
    """What the benchmark made for a run, as the reference takes it."""
    verts: np.ndarray            # (N,3) f64 rest vertices
    tets: np.ndarray             # (T,4) int64
    n_spheres: int
    mvp: np.ndarray              # (B,4,4) f32, as written
    mv: np.ndarray               # (B,4,4) f32, as written
    rgba: np.ndarray             # (B,H,W,4) uint8, as written
    depth: Optional[np.ndarray]  # (B,H,W) f32 or None
    normal: Optional[np.ndarray]  # (B,H,W,4) f32 or None
    cfg: dict                    # the run's configuration
    weights: Optional[dict] = None   # the colour field's start (texture)
    views: Optional[np.ndarray] = None   # a subset of the views (faults)


CHUNK = 8          # views a chunk


def _flags(cfg: dict):
    return (bool(cfg.get("fit_depth", False)),
            int(cfg.get("fit_depth_starting_iter", 0)),
            bool(cfg.get("fit_normal", False)),
            float(cfg.get("fit_normal_weight", 10.0)))


class Reference:
    """The reference run of a Problem on ``device``; ``precision`` "f32"
    or "tf32" (the control)."""

    def __init__(self, prob: Problem, device, precision: str = "f32"):
        self.p, self.dev, self.prec = prob, device, precision
        cfg = prob.cfg
        sv, sf = surface(prob.tets)
        self.surface_vid = torch.as_tensor(sv, device=device)
        self.faces = torch.as_tensor(sf, device=device)
        self.corner = self.surface_vid[self.faces.reshape(-1)]
        self.nbrs = torch.as_tensor(edge_neighbours(sf), device=device)
        self.texture = cfg.get("fitting_stage", "geometry") == "texture"
        self.x0 = torch.as_tensor(prob.verts, dtype=torch.float32,
                                  device=device)
        views = np.arange(prob.mvp.shape[0]) if prob.views is None \
            else np.asarray(prob.views)
        self.views = views
        self.res = int(prob.rgba.shape[1])
        sb = cfg["geometry"]["smooth_barrier_param"]
        self.smooth = float(sb["smooth_eng_coeff"]) / max(prob.n_spheres, 1)
        self.barrier = float(sb["barrier_coeff"])
        self.order_iter = int(sb["increase_order_iter"])
        if not self.texture:
            self.ops = en.tets_of(prob.verts, prob.tets, device)
        opt = cfg["optimizer"]
        if opt.get("type", "adam_uniform") != "adam_uniform":
            raise ValueError("the reference follows AdamUniform only")
        limit = float(opt["grad_limit_values"][0]) if opt.get(
            "grad_limit", False) else float("inf")
        self.opt = AdamUniform(float(opt["lr"]), int(cfg["total_num_iter"]),
                               limit)

    # -- inputs ----------------------------------------------------------
    def _chunks(self):
        for s in range(0, len(self.views), CHUNK):
            yield self.views[s:s + CHUNK]

    def _view_data(self, idx):
        p, dev = self.p, self.dev
        mvp = torch.as_tensor(p.mvp[idx], device=dev)
        campos = torch.as_tensor(np.stack(
            [np.linalg.inv(p.mv[i])[:3, 3] for i in idx]).astype(np.float32),
            device=dev)
        img = torch.as_tensor(p.rgba[idx], device=dev).to(torch.float32) \
            / 255.0
        out = {"mvp": mvp, "campos": campos, "img": img}
        if p.depth is not None:
            out["d"] = torch.as_tensor(p.depth[idx], device=dev)
            out["n"] = torch.as_tensor(p.normal[idx], device=dev)
        return out

    # -- geometry --------------------------------------------------------
    def geometry_loss_grad(self, x: torch.Tensor, it: int):
        """(loss, gradient) of iteration ``it`` at tet vertices x."""
        fit_depth, depth_start, fit_normal, nw = _flags(self.p.cfg)
        fit_depth = fit_depth and depth_start < it
        shaded = fit_depth or fit_normal
        x = x.detach().requires_grad_(True)
        n_chunks = -(-len(self.views) // CHUNK)
        total = torch.zeros((), device=self.dev)
        for idx in self._chunks():
            vd = self._view_data(idx)
            pos = clip_positions(x[self.corner], vd["mvp"], self.prec)
            ids, z = visibility(pos.detach(), self.res)
            g, aux = winner_rows(pos, self.nbrs, ids)
            cov = (ids > 0).to(torch.float32)[..., None]
            a_t = vd["img"][..., 3]
            if shaded:
                rast = shade(pos, ids, self.res)
                z = rast[..., 2].detach()
            alpha = antialias(cov, ids, z, g, aux)[..., 0]
            il = torch.mean((alpha - a_t) ** 2) * 20.0
            if fit_depth:
                wp = interpolate(x[self.corner], rast)
                dep = torch.linalg.norm(wp - vd["campos"][:, None, None, :],
                                        dim=-1)
                il = il + 100.0 * torch.mean((dep * a_t - vd["d"] * a_t) ** 2)
            if fit_normal:
                vn = vertex_normals(x[self.surface_vid], self.faces) \
                    * torch.tensor([1.0, 1.0, -1.0], device=self.dev)
                nrm = interpolate(vn[self.faces.reshape(-1)], rast)
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

    # -- texture ---------------------------------------------------------
    @torch.no_grad()
    def _texture_cache(self):
        """Per chunk of views: the winners, the shaded z, the winner rows,
        the foreground pixels and their field inputs, the target and the
        background."""
        cache = []
        x0 = self.x0
        for idx in self._chunks():
            vd = self._view_data(idx)
            # view by view, as the program's cache is built
            pos = torch.cat([clip_positions(
                x0[self.corner], vd["mvp"][i:i + 1], self.prec)
                for i in range(len(idx))])
            ids, _ = visibility(pos, self.res)
            rast = shade(pos, ids, self.res)
            g, aux = winner_rows(pos, self.nbrs, ids)
            fg = ids > 0
            pts = interpolate(x0[self.corner], rast)[fg]
            lo, hi = -torch.ones(3, device=self.dev), torch.ones(
                3, device=self.dev)
            xc = (pts - lo) / (hi - lo) * (1.0 - 0.0) + 0.0
            img = vd["img"]
            bg = torch.ones_like(img[..., :3])
            gt = bg + (img[..., :3] - bg) * img[..., 3:4]
            cache.append(dict(ids=ids, z=rast[..., 2], g=g, aux=aux, fg=fg,
                              xc=xc, gt=gt, bg=bg))
        return cache

    def texture_loss_grad(self, params: dict, it: int):
        """(loss, gradients as a dict like params) of the texture stage."""
        if not hasattr(self, "_tex"):
            self._tex = self._texture_cache()
        enc = self.p.cfg["material"]["pos_encoding_config"]
        leaves = {k: {n: t.detach().requires_grad_(True)
                      for n, t in v.items()} for k, v in params.items()}
        denom = float(len(self.views) * self.res * self.res * 3)
        total = torch.zeros((), device=self.dev)
        for c in self._tex:
            col = fd.colour(leaves, c["xc"], enc, self.prec)
            full = torch.zeros((*c["fg"].shape, 3), device=self.dev)
            full = full.index_put((c["fg"],), col)
            mask = c["fg"][..., None].to(torch.float32)
            gb = c["bg"] + (full - c["bg"]) * mask
            shaded = antialias(gb, c["ids"], c["z"], c["g"], c["aux"])
            s = torch.sum(torch.abs(shaded - c["gt"]))
            (s / denom * 20.0 * 100.0).backward()
            total = total + s.detach()
        loss = total / denom * 20.0 * 100.0
        return loss, {k: {n: t.grad.detach() for n, t in v.items()}
                      for k, v in leaves.items()}

    # -- three steps -----------------------------------------------------
    def follow(self, n_steps: int = 3) -> dict:
        """The losses of iterations 0..n-1, the norms of the first
        gradient's leaves and of the parameters' change after the n steps,
        from the seed's start."""
        if self.texture:
            names = leaf_names(self.p.weights)
            params = [leaf(self.p.weights, k).clone() for k in names]
        else:
            names = [("tet_v",)]
            params = [self.x0.clone()]
        start = [p.clone() for p in params]
        losses, first = [], None
        for it in range(n_steps):
            if self.texture:
                loss, gd = self.texture_loss_grad(
                    unflatten(names, params), it)
                grads = [leaf(gd, k) for k in names]
            else:
                loss, g = self.geometry_loss_grad(params[0], it)
                grads = [g]
            losses.append(float(loss))
            if first is None:
                first = [float(torch.linalg.norm(g)) for g in grads]
            params = self.opt.step(params, grads)
        return {"names": ["/".join(k) for k in names], "losses": losses,
                "grad_norms": first,
                "change_norms": [float(torch.linalg.norm(p - s))
                                 for p, s in zip(params, start)]}


@torch.no_grad()
def pair_counts_of(prob: Problem, x: torch.Tensor, shaded: bool,
                   device) -> dict:
    """The silhouette antialias's pair counts over every view at tet
    vertices x, in chunks of views as the reference projects and bins
    them, summed (the work ``antialias_roofline`` is measured against)."""
    sv, sf = surface(prob.tets)
    corner = torch.as_tensor(sv[sf].reshape(-1), device=device)
    nbrs = torch.as_tensor(edge_neighbours(sf), device=device)
    res = int(prob.rgba.shape[1])
    total: dict = {}
    for s in range(0, prob.mvp.shape[0], CHUNK):
        pos = clip_positions(x[corner], torch.as_tensor(
            prob.mvp[s:s + CHUNK], device=device))
        ids, z = visibility(pos, res)
        if shaded:
            z = shade(pos, ids, res)[..., 2]
        g, aux = winner_rows(pos, nbrs, ids)
        for k, v in pair_counts(ids, z, g, aux).items():
            total[k] = total.get(k, 0) + v
    return total


def leaf_names(tree: dict) -> list:
    """The leaves' key paths of a two-level dict, keys sorted."""
    return [(k, n) for k in sorted(tree) for n in sorted(tree[k])]


def leaf(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def unflatten(names, leaves) -> dict:
    out: dict = {}
    for (k, n), t in zip(names, leaves):
        out.setdefault(k, {})[n] = t
    return out
