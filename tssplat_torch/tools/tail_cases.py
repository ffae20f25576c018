"""K10 (``ops/aa_l1.py``) against its plain versions at a scene's exact
texture cache: the inputs and the comparison that tests/test_torch_cuda.py
and chip_smoke.py phase 6f run on the card.

  tail_inputs(geo, batch, res, seed)  the exact cache of ``geo`` at the
                                      views of ``batch``, a seeded target
                                      and background, and seeded colours
  check_tail(cache, colors, g)        K10 and its plain versions, compared
"""

from __future__ import annotations

import torch

from ..materials import ExplicitMaterial
from ..materials.exact_stage import build_texture_exact_cache
from ..ops import aa_l1 as al


def tail_inputs(geo, batch: dict, res: int, seed: int):
    """(the exact cache, colours (n_fg, 3)) of ``geo`` at the views
    ``batch["mvp"]`` of res², the default material's cache (its encoding
    is not evaluated), a target and a background drawn per pixel and the
    colours drawn per point from ``seed``, all on the views' device."""
    dev = batch["mvp"].device
    B = batch["mvp"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = {"mvp": batch["mvp"],
            "img": torch.rand((B, res, res, 4), generator=gen, device=dev),
            "background": torch.rand((B, res, res, 3), generator=gen,
                                     device=dev)}
    cache = build_texture_exact_cache(geo, ExplicitMaterial(None, device=dev),
                                      data, res)
    if cache is None:
        raise ValueError("the exact cache was refused")
    colors = torch.rand((cache["pix"].shape[0], 3), generator=gen,
                        device=dev)
    return cache, colors


def check_tail(cache: dict, colors: torch.Tensor, g: float = 0.37) -> dict:
    """K10's forward and backward against their plain versions on the
    card, under the gradient ``g`` of the sum: whether the shaded image,
    the sign bytes and d colours equal the plain versions' (``torch.equal``,
    so -0 and +0 alike), the sum's error relative to the plain chain's
    float32 sum (``loss_rel``) and to its float64 sum (``loss_rel64``),
    and d colours' largest error against autograd's gradient of the plain
    chain over that gradient's largest |value| (``grad_rel``)."""
    gt = cache["gt"]
    s, codes, shaded = al.aa_l1(colors, cache, want_shaded=True)
    x = colors.detach().clone().requires_grad_(True)
    s_p, shaded_p = al.aa_l1_plain(x, cache)
    gs = torch.tensor(g, dtype=torch.float32, device=colors.device)
    want, = torch.autograd.grad(s_p * gs, [x])
    s_p, shaded_p = float(s_p.detach()), shaded_p.detach()
    d = al.aa_l1_backward(gs, codes, cache)
    d_p = al.aa_l1_backward_plain(gs, codes, cache)
    s64 = float(torch.sum(torch.abs(shaded_p - gt), dtype=torch.float64))
    scale = float(want.abs().max())
    return {
        "shaded_equal": bool(torch.equal(shaded, shaded_p)),
        "codes_equal": bool(torch.equal(codes, al.sign_codes(shaded_p, gt))),
        "grad_equal": bool(torch.equal(d, d_p)),
        "loss_rel": abs(float(s) - s_p) / abs(s_p),
        "loss_rel64": abs(float(s) - s64) / abs(s64),
        "grad_rel": float((d - want).abs().max()) / scale,
        "scale": scale,
    }
