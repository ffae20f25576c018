"""The system under test: the port's training run, assembled as
``tssplat_torch.train._train`` assembles it, and one iteration of its loop.

This module is the only one of the benchmark that imports the port. The
run is built from the configuration file and overrides as ``main`` would
load them; the geometry, loader, material, optimizer, tile capacity, view
chunk, texture path and step come from the same registries and private
functions ``_train`` calls, in its order, for the paths these cells take
(AdamUniform, the exact texture path, one rank). An iteration does what
``_train`` does with one forward: the permute-surface scheduler, the step
of the depth switch, the loader's batch (none on the exact texture path),
the step, and a host read of the loss every ``sync_every`` iterations.
Logs, checkpoints, exports, remeshing and ranks are left out.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


def build_kernels() -> None:
    """Build every kernel library of the port that the checkout lacks (its
    CUDA kernels and its native topology passes)."""
    from tssplat_torch import native
    from tssplat_torch.kernels import build

    build.build_all()
    native._library()


class ProgramRun:
    def __init__(self, config_path: str, overrides: list, device,
                 weights: Optional[dict] = None):
        from tssplat_torch import train as tt
        from tssplat_torch.config import (load_config, load_dataloader,
                                          load_geometry, load_material)
        from tssplat_torch.geometry.tet_geometry import (
            LinearInterpolateScheduler, permute_surface_vertices)
        from tssplat_torch.optim import adam_uniform, cosine_annealing_lr

        self._permute = permute_surface_vertices
        cfg = load_config(config_path, cli_args=list(overrides))
        self.cfg = cfg
        dev = torch.device(device)
        stage = cfg.get("fitting_stage", "geometry")
        self.texture = texture = stage == "texture"

        geometry_cfg = dict(cfg.geometry)
        geometry_cfg["optimize_geo"] = not texture
        geometry_cfg.setdefault("output_path", cfg.output_path)
        self.geometry = geometry = load_geometry(cfg.geometry_type)(
            geometry_cfg, device=dev)
        material = material_fn = None
        if texture:
            material = load_material(cfg.material_type)(cfg.get("material"),
                                                        device=dev)
            if weights is not None:
                _check_like(material.params, weights)
                material.params = weights
            material_fn = material.apply_fn
        self.dataloader = dataloader = load_dataloader(cfg.dataloader_type)(
            cfg.data, device=dev)
        if dataloader.num_forward_per_iter != 1:
            raise ValueError("the benchmark drives one forward an iteration")
        self.total_iters = int(cfg.total_num_iter)
        resolution = int(dataloader.data_all["resolution"])

        opt_cfg = dict(cfg.get("optimizer", {}))
        if opt_cfg.pop("type", "adam_uniform") != "adam_uniform":
            raise ValueError("these cells run AdamUniform, gso.yaml's")
        lr = float(opt_cfg.pop("lr", 0.1))
        self.b1 = float(opt_cfg.get("b1", 0.9))
        init_fn, update_fn = adam_uniform(
            cosine_annealing_lr(lr, self.total_iters, eta_min=1e-4),
            **opt_cfg)

        self.permute_scheduler = None
        if cfg.get("use_permute_surface_v", False):
            self.permute_scheduler = LinearInterpolateScheduler(
                **cfg.permute_surface_v_param)
        self.perm_gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        self.state = tt.init_train_state(
            material.params if texture else geometry.tet_v, init_fn)

        self.fit_depth_cfg = bool(cfg.get("fit_depth", False))
        self.fit_depth_start = int(cfg.get("fit_depth_starting_iter", 0))
        is_ortho = bool(cfg.get("renderer", {}).get("is_orhto", False))
        self.sync_every = int(cfg.get("sync_every", 8))
        batch_size = int(cfg.data.get("batch_size", 1))
        if int(cfg.get("remesh_every", 0) or 0):
            raise ValueError("remeshing is not a part of these cells")

        self.tile_k = tile_k = tt._validated_tile_k(geometry, dataloader,
                                                    resolution, is_ortho)
        vc_cfg = cfg.get("view_chunk", "auto")
        view_chunk = tt._auto_view_chunk(batch_size, 1, resolution,
                                         tile_k=tile_k, device=dev) \
            if vc_cfg == "auto" else int(vc_cfg)
        if view_chunk and not (batch_size % view_chunk == 0
                               and batch_size > view_chunk):
            view_chunk = 0
        self.view_chunk = view_chunk

        texture_exact = None
        if texture:
            if int(cfg.get("texture_sample_px", 0)) or not bool(
                    cfg.get("texture_exact_fast", True)):
                raise ValueError("the texture cells run the exact path")
            texture_exact = tt._exact_texture_loss(
                cfg, geometry, material, dataloader, resolution, is_ortho,
                tile_k, self.fit_depth_cfg, batch_size, 1)
            if texture_exact is None:
                raise ValueError("the program fell back from the exact path")
        self.texture_exact = texture_exact
        self._steps = {}

        def get_step(fit_depth_on: bool):
            if fit_depth_on not in self._steps:
                self._steps[fit_depth_on] = tt.make_train_step(
                    geometry.statics, update_fn, resolution=resolution,
                    is_ortho=is_ortho, fit_depth=fit_depth_on,
                    fit_normal=bool(cfg.get("fit_normal", False)),
                    normal_weight=float(cfg.get("fit_normal_weight", 10.0)),
                    tile_k=tile_k, view_chunk=view_chunk,
                    material_fn=material_fn, tet_v_frozen=geometry.tet_v,
                    texture_exact_loss=texture_exact)
            return self._steps[fit_depth_on]

        self.get_step = get_step
        self.resolution = resolution
        self.n_views = int(dataloader.data_all["mvp"].shape[0])
        self.n_faces = int(geometry.statics.surface_fid.shape[0])
        self.loader_s = None          # a list to time the loader into

    def iterate(self, it: int):
        """One iteration of ``_train``'s loop; returns the step's (loss,
        img_loss, reg, n_drop) tensors."""
        if it >= self.total_iters:
            raise ValueError(f"iteration {it} is past total_num_iter")
        state = self.state
        if self.permute_scheduler is not None and not self.texture:
            dev_val = self.permute_scheduler(it)
            if dev_val is not None:
                state = state._replace(params=self._permute(
                    state.params, self.geometry.statics.surface_vid,
                    self.perm_gen, dev_val))
        step_fn = self.get_step(self.fit_depth_cfg
                                and self.fit_depth_start < it)
        if self.texture_exact is not None:
            batch = {}
        else:
            t0 = time.perf_counter()
            batch = {k: v for k, v in self.dataloader(it, 0).items()
                     if k not in ("resolution", "spp")}
            if self.loader_s is not None:
                self.loader_s.append(time.perf_counter() - t0)
        self.state, out = step_fn(state, batch, it)
        if self.sync_every and it % self.sync_every == 0:
            float(out[0])
        return out

    def leaves(self, tree, names):
        """The parameter-shaped leaves of ``tree`` (tet_v, or the
        material's dict) in the order of ``names``."""
        if not self.texture:
            return [tree]
        return [tree[k][n] for k, n in names]


def _check_like(params: dict, weights: dict) -> None:
    for k, group in params.items():
        for n, t in group.items():
            w = weights[k][n]
            if tuple(w.shape) != tuple(t.shape) or w.dtype != t.dtype:
                raise ValueError(f"weights {k}/{n}: {tuple(w.shape)} "
                                 f"{w.dtype} where the program has "
                                 f"{tuple(t.shape)} {t.dtype}")
