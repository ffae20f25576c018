"""Where a train step spends its time, on the card.

    python -m tssplat_torch.tools.profile_step [--views 8] [--res 512]
        [--scene bench|multisphere] [--depth-normal] [--layout rule|flat]
        [--view-chunk 0]
    python -m tssplat_torch.tools.profile_step --texture [--sampled]
        [--views 120] [--res 512]

On the benchmark scene (tools/synthetic.py bench_scene, AdamUniform) or
the 18-sphere scene (multisphere_scene with the validated per-tile
capacity; AdamUniform, or Adam lr 2e-3 with --depth-normal, which adds the
depth and normal losses) it prints one "profile" JSON line: torch.profiler
over 5 steps — the step's wall time, the device's busy time (sum of kernel
times on the one stream) and idle share, and the top kernels by device
time (``--layout flat`` keeps K1's uncapped lists where the rule would
cap, to time both visibility paths in the same step on the same scene;
``--view-chunk N`` runs the train step in chunks of N views, as the driver
does at 120 views). The geometry step's layers are the program's
``tssplat.*`` spans: a trace of the driver's run (``profile_iters``) or the
benchmark's per-layer metrics split its time by layer where the host
holds the device back, which a layer timed alone cannot show.
With ``--texture`` the step is the texture stage's at gso.yaml's width
(the 18-sphere scene, ``--views`` views, ExplicitMaterial's default 16 x
2^19 hash grid and 32-64-3 MLP, AdamUniform as gso.yaml sets it, the
ellipsoid's antialiased Lambertian colour as the target): the exact path,
or with ``--sampled`` the sampled path (4,096 pixels a view, cached); the
layers are the cache build (once), the encoding's forward and forward +
backward, the MLP's forward + backward, the colour put back on the image
with the composite and the colour antialias (exact only), the L1, the
optimizer update and the whole step.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..materials.explicit_material import contract_to_unisphere as contract
from ..ops import binning, raster_kernels as rk
from ..ops.binning import uses_capped_layout
from ..optim import (adam, adam_uniform, cosine_annealing_lr,
                     cosine_decay_schedule)
from ..train import init_train_state, make_train_step, validated_tile_k
from .synthetic import bench_scene, multisphere_scene


def _wall_ms(fn, reps=10, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--scene", choices=("bench", "multisphere"),
                    default="bench")
    ap.add_argument("--depth-normal", action="store_true")
    ap.add_argument("--layout", choices=("rule", "flat"), default="rule")
    ap.add_argument("--view-chunk", type=int, default=0)
    ap.add_argument("--texture", action="store_true")
    ap.add_argument("--sampled", action="store_true")
    args = ap.parse_args(argv)
    if args.texture:
        return texture_main(args)
    if args.layout == "flat":
        binning.FLAT_BUDGET_BYTES = 1 << 62    # no scene leaves K1's lists
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    dev = torch.device("cuda")
    res = (args.res, args.res)
    if args.scene == "multisphere":
        geo, batch = multisphere_scene(dev, 18, args.views, args.res)
        k = validated_tile_k(geo, batch, args.res)
    else:
        geo, batch = bench_scene(dev, args.views, args.res)
        k = None
    st = geo.statics
    F = int(st.surface_fid.shape[0])
    dn = args.depth_normal
    fit = dict(fit_depth=dn, fit_normal=dn)
    if dn:
        init_fn, update_fn = adam(cosine_decay_schedule(2e-3, 400, 0.05))
    else:
        init_fn, update_fn = adam_uniform(
            cosine_annealing_lr(0.2, 1500), grad_limit=True,
            grad_limit_values=(0.01, 0.01), grad_limit_iters=(1500,))
    step = make_train_step(st, update_fn, resolution=args.res, tile_k=k,
                           view_chunk=args.view_chunk, **fit)
    state = init_train_state(geo.tet_v, init_fn)
    if uses_capped_layout(F, 11 if dn else 14, args.views, *res):
        vis_name = "K2a_visibility_capped_ids" if dn else \
            "K2b_visibility_capped"
    else:
        vis_name = "K1_visibility"
    it = [0]

    def one_step():
        nonlocal state
        state, _ = step(state, batch, it[0])
        it[0] += 1

    for _ in range(2):              # warm every shape the profile runs
        one_step()
    wall, busy_ms, kernels = _profile(one_step)
    print(json.dumps({
        "profile": "train_step", "scene": args.scene, "depth_normal": dn,
        "visibility": vis_name, "views": args.views,
        "view_chunk": args.view_chunk, **_summary(wall, busy_ms, kernels),
    }), flush=True)


def _profile(one_step, steps: int = 5):
    """torch.profiler over ``steps`` steps: (wall ms a step, device busy ms
    a step, [(device us, kernel, count)] sorted by time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    busy = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        # the program's spans carry the device time of the kernels inside
        # them: a kernel's time is counted on the kernel alone
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA \
                and not evt.key.startswith("tssplat."):
            busy += dev_us
            kernels.append((dev_us, evt.key, evt.count))
    kernels.sort(reverse=True)
    return wall, busy / 1e3 / steps, kernels


def _summary(wall, busy_ms, kernels, steps: int = 5):
    return {
        "steps": steps, "wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall,
        "top_kernels_ms_per_step": [
            [k_, round(us / 1e3 / steps, 5), n // steps]
            for us, k_, n in kernels[:15]],
        "n_kernel_launches_per_step": sum(n for _, _, n in kernels)
        // steps,
    }


def texture_main(args):
    """The texture stage's step (see the module docstring)."""
    from ..materials import ExplicitMaterial
    from ..materials.exact_stage import (build_texture_exact_cache,
                                         build_texture_exact_loss)
    from ..ops.rasterize import antialias_color
    from ..train import build_texture_sample_cache, texture_sample_slots
    from .synthetic import render_rgb_of_mesh, _ellipsoid_targets

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    views, R = args.views, args.res
    geo, batch = multisphere_scene(dev, 18, views, R)
    st = geo.statics
    k = validated_tile_k(geo, batch, R)
    sv, sf, mvp, _, _ = _ellipsoid_targets(views)
    rgb = torch.cat([render_rgb_of_mesh(sv, sf, mvp[s:s + 8], R, device=dev)
                     for s in range(0, views, 8)])
    bg = torch.ones_like(rgb)
    alpha = batch["img"]
    data = {"mvp": batch["mvp"], "background": bg,
            "img": torch.cat([bg + (rgb - bg) * alpha, alpha], dim=-1)}
    mat = ExplicitMaterial(None, device=dev)
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 1500), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(1500,))
    sample_px = 4096 if args.sampled else 0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.sampled:
        cache = build_texture_sample_cache(st, geo.tet_v, data["mvp"],
                                           data["img"], R, tile_k=k)
        exact = None
        data["view_idx"] = torch.arange(views, dtype=torch.int32,
                                        device=dev)
        slots = texture_sample_slots(cache["count"], sample_px, 0)
        pts = torch.take_along_dim(cache["positions"], slots[..., None],
                                   dim=1).reshape(-1, 3)
        xc = contract(pts, mat.bbox)
        n_px = int(cache["count"].sum())
    else:
        cache = build_texture_exact_cache(geo, mat, data, R, tile_k=k)
        exact = build_texture_exact_loss(mat, st, cache)
        xc = cache["xc"]
        n_px = int(xc.shape[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step = make_train_step(st, update_fn, resolution=R, tile_k=k,
                           material_fn=mat.apply_fn, tet_v_frozen=geo.tet_v,
                           texture_sample_px=sample_px, texture_cache=cache,
                           texture_exact_loss=exact)
    state = init_train_state(mat.params, init_fn)
    enc, net, act = mat.encoding, mat.network, mat.activation
    params = {k_: {n: v.detach().requires_grad_(True) for n, v in d.items()}
              for k_, d in mat.params.items()}
    feats = enc.apply_fn(mat.params["encoding"], xc).detach()
    ct_f = torch.randn_like(feats)

    def enc_fwd_bwd():
        y = enc.apply_fn(params["encoding"], xc)
        torch.autograd.grad(y, params["encoding"]["table"], ct_f)

    def mlp_fwd_bwd():
        y = act(net.apply_fn(params["network"], feats))
        torch.autograd.grad(y.sum(), list(params["network"].values()))

    layers = {
        "encoding_fwd": lambda: enc.apply_fn(mat.params["encoding"], xc),
        "encoding_fwd_bwd": enc_fwd_bwd,
        "mlp_fwd_bwd": mlp_fwd_bwd,
    }
    if not args.sampled:
        colors = act(net.apply_fn(mat.params["network"], feats)).detach() \
            .requires_grad_(True)

        def compose():
            full = colors.new_zeros((views * R * R, 3)).index_put(
                (cache["pix"],), colors).view(views, R, R, 3)
            return cache["bg"] + (full - cache["bg"]) * cache["mask"]

        gb = compose().detach()

        def aa():
            return antialias_color(gb, cache["rast"], cache["pos_clip"],
                                   st.edge_nbrs)

        shaded = aa()

        def compose_aa_fwd_bwd():
            out = antialias_color(compose(), cache["rast"],
                                  cache["pos_clip"], st.edge_nbrs)
            torch.autograd.grad(out.sum(), colors)

        layers.update({
            "colour_antialias_fwd": aa,
            "compose_antialias_fwd_bwd": compose_aa_fwd_bwd,
            "l1": lambda: torch.sum(torch.abs(shaded - cache["gt"])),
        })
    layers["optimizer_update"] = lambda: update_fn(
        state.params, state.opt_state)
    print(json.dumps({"texture": "sampled" if args.sampled else "exact",
                      "views": views, "res": R, "points": int(xc.shape[0]),
                      "foreground_px": n_px, "cache_build_s": build_s,
                      "peak_gib_after_build":
                          torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)
    for name, fn in layers.items():
        print(json.dumps({"layer": name, "ms": _wall_ms(fn)}), flush=True)
    del layers, params, feats, ct_f
    it = [0]

    def one_step():
        nonlocal state
        state, _ = step(state, data, it[0])
        it[0] += 1

    torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"layer": "train_step", "ms": _wall_ms(one_step),
                      "peak_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}), flush=True)
    rk.reset_launch_counts()
    wall, busy_ms, kernels = _profile(one_step)
    print(json.dumps({
        "profile": "texture_step",
        "path": "sampled" if args.sampled else "exact", "views": views,
        "repo_kernel_launches_per_step": {
            n: c / 5 for n, c in rk.launch_counts().items()},
        **_summary(wall, busy_ms, kernels)}), flush=True)


if __name__ == "__main__":
    main()
