"""Where a geometry-stage train step spends its time, on the card.

    python -m tssplat_torch.tools.profile_step [--views 8] [--res 512]
        [--scene bench|multisphere] [--depth-normal] [--layout rule|flat]
        [--view-chunk 0]

On the benchmark scene (tools/synthetic.py bench_scene, AdamUniform) or
the 18-sphere scene (multisphere_scene with the validated per-tile
capacity; AdamUniform, or Adam lr 2e-3 with --depth-normal, which adds the
depth and normal losses) it prints, as one JSON line each (``--layout
flat`` keeps K1's uncapped lists where the rule would cap, to time both
visibility paths in the same step on the same scene; ``--view-chunk N``
runs the train step in chunks of N views, as the driver does at 120
views):
  - "layer": each layer of the step run alone, median device-synchronised
    wall time of 10 calls (energy fwd+bwd, clip transform, binning, the
    visibility kernel of the path (K1, K2a or K2b), the rest of the
    render's forward and backward (silhouette: winner rows + K4 + loss
    backward = K5 + K3 + table autograd; depth + normal: the whole loss and
    gradient), the optimizer update) and the whole step;
  - "profile": torch.profiler over 5 steps — the step's wall time, the
    device's busy time (sum of kernel times on the one stream) and idle
    share, and the top kernels by device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..ops import binning, raster_kernels as rk
from ..ops.binning import (bin_faces, bin_faces_capped, capacity,
                           uses_capped_layout)
from ..ops.energy import smooth_barrier_energy
from ..ops.rasterize import (antialias_silhouette, screen_xy_table,
                             winner_screen_rows)
from ..ops.transform import transform_pos
from ..optim import (adam, adam_uniform, cosine_annealing_lr,
                     cosine_decay_schedule)
from ..train import (init_train_state, loss_and_grad, make_train_step,
                     validated_tile_k)
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
    args = ap.parse_args(argv)
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

    x = geo.tet_v.detach().requires_grad_(True)
    pos = transform_pos(batch["mvp"], x[st.corner_vid])
    nbrs = None if dn else st.edge_nbrs
    capped = uses_capped_layout(F, 11 if dn else 14, args.views, *res)
    if capped:
        def bin_step():
            return bin_faces_capped(pos.detach(), nbrs, res,
                                    capacity(k, F, res))
        vis_name, vis = (("K2a_visibility_capped_ids",
                          rk.visibility_capped_ids) if dn else
                         ("K2b_visibility_capped", rk.visibility_capped))
    else:
        def bin_step():
            return bin_faces(pos.detach(), nbrs, res)
        vis_name = "K1_visibility"

        def vis(b, r):
            return rk.visibility(b, r, emit_g=not dn)
    bins = bin_step()
    vis_out = vis(bins, res)

    def energy():
        xe = geo.tet_v.detach().requires_grad_(True)
        smooth_barrier_energy(xe, st.energy, 2e-4, 2e-4, 2).backward()

    def aa_fwd_bwd():
        ids, z, g6k, gaux = vis_out
        g6 = winner_screen_rows(screen_xy_table(pos, F), ids, g6k)
        alpha = antialias_silhouette(ids, z, g6, gaux)
        loss = torch.mean((alpha - batch["img"][..., 0]) ** 2) * 2000.0
        torch.autograd.grad(loss, x, retain_graph=True)

    def update():
        update_fn(state.params * 1e-3, state.opt_state)

    layers = {
        "energy_fwd_bwd": energy,
        "transform": lambda: transform_pos(batch["mvp"],
                                           geo.tet_v[st.corner_vid]),
        "binning": bin_step,
        vis_name: lambda: vis(bins, res),
    }
    if dn:
        layers["loss_and_grad_depth_normal"] = lambda: loss_and_grad(
            st, geo.tet_v, batch, 0, args.res, tile_k=k,
            view_chunk=args.view_chunk, **fit)
    else:
        layers["rows_K4_loss_bwd_K5_K3"] = aa_fwd_bwd
    layers["optimizer_update"] = update
    for name, fn in layers.items():
        print(json.dumps({"layer": name, "ms": _wall_ms(fn)}), flush=True)

    it = [0]

    def one_step():
        nonlocal state
        state, _ = step(state, batch, it[0])
        it[0] += 1

    print(json.dumps({"layer": "train_step", "ms": _wall_ms(one_step)}),
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            one_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    kernels = []
    busy = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += dev_us
            kernels.append((dev_us, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy_ms = busy / 1e3 / 5
    print(json.dumps({
        "profile": "train_step", "scene": args.scene, "depth_normal": dn,
        "visibility": vis_name, "views": args.views,
        "view_chunk": args.view_chunk,
        "steps": 5, "wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall,
        "top_kernels_ms_per_step": [
            [k_, round(us / 1e3 / 5, 5), n // 5] for us, k_, n in kernels[:15]],
        "n_kernel_launches_per_step": sum(n for _, _, n in kernels) // 5,
    }), flush=True)


if __name__ == "__main__":
    main()
