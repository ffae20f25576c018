"""Score-distillation (SDS) guidance for image-to-3D (port of
``tssplat_tpu/guidance/sds.py``).

The reference repo ships only the multi-view reconstruction driver (its
img_to_3D config consumes Wonder3D-generated views offline); the SDS loop
here is the driver of ``train_sds.py`` with a pluggable guidance model.
A guidance model is any host function ``(x_t, t_idx, eps, cond) -> eps_hat``
on numpy arrays: a diffusers UNet (``DiffusersGuidance``), or the analytic
target-image score used in tests and on the chip (``TargetImageGuidance``).

The SDS gradient is the DreamFusion estimator (arXiv:2209.14988 eq. 2):
grad_x = w(t) (eps_hat(x_t, t) - eps) with x_t = sqrt(ab_t) x0 +
sqrt(1 - ab_t) eps, without backpropagation through the diffusion model.
The timestep and the noise are drawn on the host from a numpy Generator,
as the JAX package draws them, so both packages draw the same noise from
the same seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass
class SDSConfig:
    t_min: float = 0.02            # timestep sampling range (fraction)
    t_max: float = 0.98
    guidance_scale: float = 7.5    # classifier-free guidance (diffusers)
    n_train_timesteps: int = 1000
    beta_start: float = 0.00085    # StableDiffusion's scaled_linear betas
    beta_end: float = 0.012
    seed: int = 0


def _alphas_cumprod(cfg: SDSConfig) -> np.ndarray:
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.n_train_timesteps) ** 2
    return np.cumprod(1.0 - betas)


def sds_image_grad(x0: np.ndarray, guidance, cfg: SDSConfig,
                   rng: np.random.Generator, cond=None) -> np.ndarray:
    """One SDS sample: the image-space gradient w(t) (eps_hat - eps).

    x0: (B,H,W,C) in [-1, 1]; guidance: callable(x_t, t_idx, eps, cond) ->
    eps_hat, all numpy, never differentiated. One timestep, then the noise,
    from ``rng``. Returns the gradient, shaped as x0, divided by the batch
    size (the caller pulls it back through the render)."""
    ab = _alphas_cumprod(cfg)
    t_idx = int(rng.integers(int(cfg.t_min * cfg.n_train_timesteps),
                             int(cfg.t_max * cfg.n_train_timesteps)))
    a = ab[t_idx]
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    x_t = math.sqrt(a) * x0 + math.sqrt(1.0 - a) * eps
    eps_hat = guidance(x_t, t_idx, eps, cond)
    w = 1.0 - a
    return (w * (eps_hat - eps) / max(x0.shape[0], 1)).astype(np.float32)


class TargetImageGuidance:
    """Analytic 'diffusion' whose score points at a fixed target image:
    eps_hat(x_t, t) = (x_t - sqrt(ab_t) target) / sqrt(1 - ab_t), the exact
    eps-prediction of the degenerate data distribution delta(target). SDS
    under it is, in expectation, w(t) sqrt(ab_t) (x0 - target): descent
    toward the target, so the whole driver (render -> guidance -> update)
    runs with no model weights."""

    def __init__(self, target: np.ndarray, cfg: SDSConfig):
        # (B,H,W,C) in [-1,1]; or a (n_cameras,H,W,C) bank indexed by the
        # driver's sampled view ids (cond)
        self.target = np.asarray(target, np.float32)
        self.ab = _alphas_cumprod(cfg)

    def __call__(self, x_t, t_idx, eps, cond=None):
        tgt = self.target[np.asarray(cond)] if cond is not None \
            else self.target
        a = self.ab[t_idx]
        return ((x_t - math.sqrt(a) * tgt)
                / math.sqrt(1.0 - a)).astype(np.float32)


class DiffusersGuidance:
    """HuggingFace diffusers eps-prediction with classifier-free guidance.
    The weights must be on local disk (``from_pretrained``; nothing is
    downloaded here, and without the ``diffusers`` package construction
    raises ImportError). The adapter targets pixel-space eps-prediction
    UNets (e.g. DeepFloyd-IF stage 1, or any prediction_type='epsilon'
    pixel model); latent models would first encode x0 through their VAE."""

    def __init__(self, model_id: str, prompt: str, cfg: SDSConfig,
                 negative_prompt: str = "", device: DeviceLike = None):
        from diffusers import UNet2DConditionModel, DDPMScheduler
        from transformers import AutoTokenizer, CLIPTextModel

        device = resolve_device(device)
        unet = UNet2DConditionModel.from_pretrained(
            model_id, subfolder="unet").to(device).eval()
        sched = DDPMScheduler.from_pretrained(model_id,
                                              subfolder="scheduler")
        tok = AutoTokenizer.from_pretrained(model_id, subfolder="tokenizer")
        txt = CLIPTextModel.from_pretrained(
            model_id, subfolder="text_encoder").to(device).eval()
        with torch.no_grad():
            def emb(p):
                ids = tok(p, padding="max_length",
                          max_length=tok.model_max_length,
                          return_tensors="pt").input_ids.to(device)
                return txt(ids)[0]
            emb_cond = emb(prompt)
            emb_un = emb(negative_prompt)
        self._init_components(unet, sched, emb_cond, emb_un, cfg, device)

    @classmethod
    def from_components(cls, unet, scheduler, emb_cond, emb_un,
                        cfg: SDSConfig, device: DeviceLike = None):
        """From already-built components: no from_pretrained, no files.
        The call path (the classifier-free guidance combination, NHWC <->
        NCHW, the embeddings broadcast over the batch) is the same."""
        self = cls.__new__(cls)
        self._init_components(unet, scheduler, emb_cond, emb_un, cfg,
                              resolve_device(device))
        return self

    def _init_components(self, unet, sched, emb_cond, emb_un, cfg, device):
        self.cfg = cfg
        self.device = device
        self.unet = unet
        self.sched = sched
        self.emb_cond = emb_cond
        self.emb_un = emb_un

    def __call__(self, x_t, t_idx, eps, cond=None):
        x = torch.from_numpy(np.moveaxis(x_t, -1, 1)).to(self.device)
        t = torch.tensor([t_idx], device=self.device)
        with torch.no_grad():
            e_c = self.unet(x, t, encoder_hidden_states=self.emb_cond
                            .expand(x.shape[0], -1, -1)).sample
            e_u = self.unet(x, t, encoder_hidden_states=self.emb_un
                            .expand(x.shape[0], -1, -1)).sample
        e = e_u + self.cfg.guidance_scale * (e_c - e_u)
        return np.moveaxis(e.cpu().numpy(), 1, -1).astype(np.float32)


def load_guidance(gcfg: dict, cfg: SDSConfig,
                  target_loader: Optional[Callable] = None,
                  device: DeviceLike = None):
    """The guidance of a config block: type 'target_image' (analytic:
    distil the rendered views toward ``target_loader()``'s images) or
    'diffusers' (local model weights, on ``gcfg["device"]``, else
    ``device``)."""
    gtype = gcfg.get("type", "target_image")
    if gtype == "target_image":
        if target_loader is None:
            raise ValueError("target_image guidance needs a target image")
        return TargetImageGuidance(target_loader(), cfg)
    if gtype == "diffusers":
        return DiffusersGuidance(gcfg["model_id"], gcfg.get("prompt", ""),
                                 cfg,
                                 negative_prompt=gcfg.get("negative_prompt",
                                                          ""),
                                 device=gcfg.get("device", device))
    raise ValueError(f"unknown guidance type {gtype!r}")
