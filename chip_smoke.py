#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (tssplat_torch).

    python3 chip_smoke.py

Needs one CUDA device (it fails without one) and nvcc (CUDA_HOME, PATH or
/usr/local/cuda). Phases, each of which raises on failure:

  1. device  — torch/CUDA versions, the card, nvidia-smi name + power limit
  2. build   — nvcc builds every kernel of tssplat_torch/csrc into build/
  3. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (the bench scene's first step), and timed with
               CUDA events (median of 25 after warm-up); bound_ms is the
               bytes the inputs need (each read once, outputs written once)
               over 3.35 TB/s, or the f32 operations over 67 TFLOP/s
  4. train   — the geometry-stage train step of the bench scene: one
               TetSphere tet_sphere(0.03, radius=0.25) (2,012 faces),
               8 views at 512x512, ellipsoid alpha targets, AdamUniform with
               cosine LR 0.2 over 1500 steps and caps (0.01, 0.01); 3 warm-up
               + 20 timed steps with the host sync inside the window. The
               launch counts are zeroed before and read after this phase.
  5. reference — one step of a small scene (tet_sphere(0.12), 2 views at
               128x128) on the card against the same step on the CPU (the
               plain versions)
Then one JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12         # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
RES = 512
N_VIEWS = 8


def cuda_ms(fn, reps=25, warm=3):
    """Median device time of one call, CUDA events around each call. A
    sleep kernel holds the stream first, so the events time the work and
    not the host's enqueue (unless ``fn`` itself waits for the device)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_b = n_bytes / H100_BYTES_PER_S
    t_o = n_ops / H100_F32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def max_err(got, want):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def main():
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this run "
                 "needs a CUDA device")
    from tssplat_torch.kernels import build
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.ops.binning import bin_faces
    from tssplat_torch.ops.transform import transform_pos
    from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
    from tssplat_torch.tools.synthetic import bench_scene
    from tssplat_torch.train import (init_train_state, loss_and_grad,
                                     make_train_step, run_steps)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"[build] {len(reports)} of {len(build.SOURCES)} kernel libraries "
          f"built in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}",
          flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. kernels at the main path's shapes ----------------------------------
    geo, batch = bench_scene(dev, N_VIEWS, RES)
    F = int(geo.statics.surface_fid.shape[0])
    print(f"[scene] {geo.tetmesh.num_vertices} vertices, "
          f"{geo.tetmesh.num_tets} tets, {F} faces, {N_VIEWS} views at "
          f"{RES}x{RES}", flush=True)
    res = (RES, RES)
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[geo.statics.corner_vid])
    bins = bin_faces(pos, geo.statics.edge_nbrs, res)
    B, P = N_VIEWS, N_VIEWS * RES * RES
    results = []

    def report(name, source, replaces, err, tol, ms, plain_ms, bnd,
               library_ms=None):
        require(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        results.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=0,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=library_ms))
        lib = "" if library_ms is None else f" library_ms={library_ms:.4f}"
        print(f"[kernel] {name}: max_err={err:.3g} (tol {tol:g}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bnd[0]:.4f} "
              f"({bnd[1]}){lib}", flush=True)

    # K1: ids and gaux exact, z and g6 to 1e-6
    got = rk.visibility(bins, res)
    want = rk.visibility_plain(bins, res)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "K1 ids differ from plain")
    require(torch.equal(got[3], want[3]), "K1 gaux differ from plain")
    cnt = bins.tile_count.long()
    k1_bytes = (bins.table.numel() * 4 + bins.faces.numel() * 4
                + 2 * cnt.numel() * 4 + 48 * P)
    k1_ops = 30 * 256 * int(cnt.sum())
    report("visibility", "tssplat_torch/csrc/vis.cu",
           "tssplat_tpu/ops/pallas_raster.py:197", max_err(got, want), 1e-6,
           cuda_ms(lambda: rk.visibility(bins, res)),
           cuda_ms(lambda: rk.visibility_plain(bins, res), warm=1),
           bound_ms(k1_bytes, k1_ops))
    ids, z, g6, gaux = got

    # pixels in at least one pair whose ids differ (the pairs K4/K5 evaluate)
    fg = ids > 0
    dh = (ids[:, :, 1:] != ids[:, :, :-1]) & (fg[:, :, 1:] | fg[:, :, :-1])
    dv = (ids[:, 1:] != ids[:, :-1]) & (fg[:, 1:] | fg[:, :-1])
    sil = torch.zeros_like(fg)
    sil[:, :, 1:] |= dh
    sil[:, :, :-1] |= dh
    sil[:, 1:] |= dv
    sil[:, :-1] |= dv
    n_sil, n_fg = int(sil.sum()), int(fg.sum())
    n_pairs = int(dh.sum() + dv.sum())
    print(f"[kernel] inputs: {n_fg} foreground px, {n_pairs} pixel pairs "
          f"whose ids differ, {n_sil} px in such a pair, "
          f"{int(cnt.sum())} (tile, face) pairs", flush=True)

    # K4
    got = rk.aa_forward(ids, z, g6, gaux)
    want = rk.aa_forward_plain(ids, z, g6, gaux)
    report("aa_forward", "tssplat_torch/csrc/aa_fwd.cu",
           "tssplat_tpu/ops/pallas_raster.py:1171", max_err([got], [want]),
           1e-5, cuda_ms(lambda: rk.aa_forward(ids, z, g6, gaux)),
           cuda_ms(lambda: rk.aa_forward_plain(ids, z, g6, gaux)),
           bound_ms(8 * P + 44 * n_sil, 100 * n_pairs))

    # K5 under a seeded cotangent
    gen = torch.Generator(device=dev).manual_seed(0)
    ct = torch.randn((B, RES, RES), generator=gen, device=dev)
    got = rk.aa_backward(ids, z, g6, gaux, ct)
    want = rk.aa_backward_plain(ids, z, g6, gaux, ct)
    report("aa_backward", "tssplat_torch/csrc/aa_bwd.cu",
           "tssplat_tpu/ops/pallas_raster.py:1200", max_err([got], [want]),
           1e-5, cuda_ms(lambda: rk.aa_backward(ids, z, g6, gaux, ct)),
           cuda_ms(lambda: rk.aa_backward_plain(ids, z, g6, gaux, ct)),
           bound_ms(28 * P + 48 * n_sil, 150 * n_pairs))

    # K3 on the cotangent the main path gives it (K5's d g6), and on seeded
    # cotangents at every foreground pixel; atomics reorder the sums
    ct6 = got
    dense6 = torch.randn((B, 6, RES, RES), generator=gen, device=dev) \
        * fg[:, None]
    err, tol = 0.0, 0.0
    for c6 in (ct6, dense6):
        g3 = rk.wsr_table_grad(ids, c6, F)
        w3 = rk.wsr_table_grad_plain(ids, c6, F)
        scale = float(w3.abs().max())
        require(torch.allclose(g3, w3, rtol=1e-5, atol=1e-6 * scale),
                "K3 differs from plain beyond rtol 1e-5")
        err = max(err, max_err([g3], [w3]))
        tol = max(tol, 1e-5 * scale)
    idx = (torch.arange(B, device=dev)[:, None, None] * (F + 1)
           + torch.where(fg, ids.long() - 1, F)).reshape(-1)
    rows = ct6.permute(0, 2, 3, 1).reshape(-1, 6).contiguous()
    lib_ms = cuda_ms(lambda: torch.zeros((B * (F + 1), 6), device=dev)
                     .index_add_(0, idx, rows))
    n_act = int(((ct6 != 0).any(dim=1) & fg).sum())
    report("wsr_table_grad", "tssplat_torch/csrc/wsr_grad.cu",
           "tssplat_tpu/ops/pallas_raster.py:908", err, tol,
           cuda_ms(lambda: rk.wsr_table_grad(ids, ct6, F)),
           cuda_ms(lambda: rk.wsr_table_grad_plain(ids, ct6, F)),
           bound_ms(4 * P + 24 * n_fg + B * (F + 1) * 24, 6 * n_act),
           library_ms=lib_ms)

    # ---- 4. train ----------------------------------------------------------------
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 1500), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(1500,))
    step = make_train_step(geo.statics, update_fn, resolution=RES)
    state = init_train_state(geo.tet_v, init_fn)
    torch.cuda.reset_peak_memory_stats()
    rk.reset_launch_counts()
    state, warm_outs = run_steps(step, state, batch, 0, 3)
    float(warm_outs[-1][0])
    t0 = time.perf_counter()
    state, outs = run_steps(step, state, batch, 3, 20)
    last = float(outs[-1][0])                  # host sync inside the window
    dt = time.perf_counter() - t0
    counts = rk.launch_counts()
    losses = [float(o[0]) for o in warm_outs + outs]
    n_drop = sum(int(o[3]) for o in warm_outs + outs)
    require(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(n_drop == 0, f"n_drop = {n_drop}")
    require(all(c > 0 for c in counts.values()), f"a kernel never ran: {counts}")
    require(last == losses[-1] and torch.isfinite(state.params).all(),
            "non-finite parameters")
    print(f"[train] {20 / dt:.3f} it/s over 20 steps (8x{RES}^2, {F} faces) "
          f"on {smi}; loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches "
          f"over 23 steps {counts}", flush=True)
    for r in results:
        r["launches"] = counts[r["name"]]

    # ---- 5. reference: the card against the CPU on a small input -------------
    small = {}
    for d in ("cuda", "cpu"):
        g2, b2 = bench_scene(d, n_views=2, resolution=128, edge_length=0.12)
        out = loss_and_grad(g2.statics, g2.tet_v, b2, 1001, 128)
        small[d] = (float(out[0]), out[4].cpu())
    (l_gpu, g_gpu), (l_cpu, g_cpu) = small["cuda"], small["cpu"]
    scale = float(g_cpu.abs().max())
    gerr = float((g_gpu - g_cpu).abs().max())
    require(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu),
            f"reference loss {l_gpu} vs CPU {l_cpu}")
    require(gerr <= 1e-4 * scale, f"reference grad err {gerr} (scale {scale})")
    print(f"[reference] 2x128^2 step at it 1001: loss {l_gpu:.6f} (CPU "
          f"{l_cpu:.6f}), grad max err {gerr:.3g} of max {scale:.3g}",
          flush=True)

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
