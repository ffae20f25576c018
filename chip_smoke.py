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
               (visibility: 30 per pixel test, counting for each
               (tile, face) pair only the tile's pixels in the face's box).
               K4 and K5 equal their plain versions by value, here and on
               every input of tools/aa_cases.py; they are also timed with
               every id 0 (the streaming floor) and with L2 flushed, and
               the pairs whose ids differ and the valid ones are counted.
               K3 agrees with its plain version to rtol 1e-5 on K5's d g6
               and on a cotangent at every foreground pixel, and within
               1e-5 of its rows' sums of |ct| (NaN and inf in place) on
               every input of tools/wsr_cases.py; it is also timed with
               every cotangent 0 (the id stream and the fill) and with L2
               flushed, beside index_add_ and index_put_ (library_ms: the
               faster)
  4. train   — the geometry-stage train step of the bench scene: one
               TetSphere tet_sphere(0.03, radius=0.25) (2,012 faces),
               8 views at 512x512, ellipsoid alpha targets, AdamUniform with
               cosine LR 0.2 over 1500 steps and caps (0.01, 0.01); 3 warm-up
               + 20 timed steps with the host sync inside the window. The
               launch counts are zeroed before and read after this phase.
  5. reference — one step of a small scene (tet_sphere(0.12), 2 views at
               128x128) on the card against the same step on the CPU (the
               plain versions)
  6. capped  — the multi-sphere scene (tools/synthetic.py multisphere_scene:
               18 spheres, 14,796 faces, 8 views at 512x512, where the
               capped layout is taken with and without winner rows) at its
               first step with the validated per-tile capacity k: K2b and
               K2a against the walk that defines them and against the
               plain form of their own search inside each face's pixel box
               (ids and z to the bit, rows equal) and against K1 on the
               same scene (bit-equal, n_drop 0); timed as in phase 3 (the
               plain time is the boxed form's), K1 beside them. Then the
               same comparison with the walk (a) at k = 512, below the
               densest tile's count, where faces drop and K1 is no
               yardstick, (b) on the bench scene's single sphere binned by
               bin_faces_capped directly, (c) on a triangle that fills the
               screen with small ones before and behind it
  6b. antialias at the multi-sphere scene's first step — K4 and K5 on
               the silhouette step's inputs (K2b's outputs) and on the depth
               + normal step's (the shaded winners' rows), and K3 on K5's
               d g6 there, as in phase 3
  7. multi-sphere silhouette training — 3 + 20 steps, AdamUniform as
               configs/gso.yaml sets it (lr 0.2 cosine over 1500, caps
               0.01): K2b, K3, K4, K5 each launched once per step, no drops
  8. multi-sphere depth + normal training — 3 + 20 steps with Adam (lr 2e-3
               cosine over 400), normal weight 10: K2a, K3, K4, K5 each once
               per step
  9. multi-sphere reference — 2 of the views (capped for both table widths
               at B = 2): one silhouette step and one depth + normal step at
               iteration 1001 on the card against the CPU
The launch counts are zeroed just before each main-path phase (4, 7, 8)
and read just after it. Then one JSON line of per-kernel results (launches
of K1, K3, K4, K5 from phase 4, of K2b from 7, of K2a from 8), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import torch

RES = 512
N_VIEWS = 8


def box_tests(table, faces, per_tile, nty, ntx, tile_h, tile_w, res):
    """Pixel tests a visibility search needs on this data: for each
    (tile, face) pair, the pixels of the tile whose centres lie in the
    face's screen box. ``faces`` lists the pairs' face ids tile by tile,
    ``per_tile`` how many each tile has; faces that cover no pixel
    (inverse area 0) need none."""
    H, W = res
    ntiles = nty * ntx
    rows = torch.repeat_interleave(
        torch.arange(per_tile.numel(), device=faces.device), per_tile.long())
    t = rows % ntiles
    ty, tx = t // ntx, t % ntx
    r = table[rows // ntiles, faces.long()]                     # (n,16)
    px = (r[:, 0:5:2] + 1.0) * 0.5 * W - 0.5
    py = (r[:, 1:6:2] + 1.0) * 0.5 * H - 0.5
    nx = (torch.minimum(px.amax(-1).floor(), (tx + 1) * tile_w - 1.0)
          - torch.maximum(px.amin(-1).ceil(), tx * tile_w * 1.0) + 1)
    ny = (torch.minimum(py.amax(-1).floor(), (ty + 1) * tile_h - 1.0)
          - torch.maximum(py.amin(-1).ceil(), ty * tile_h * 1.0) + 1)
    n = nx.clamp(min=0).double() * ny.clamp(min=0).double()
    return int(torch.where(r[:, 9] != 0, n, 0.0).sum())


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
    from tssplat_torch.geometry import statics_to
    from tssplat_torch.kernels import build
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.ops.binning import (CAP_TILE_H, CAP_TILE_W, TILE_H,
                                           TILE_W, bin_faces,
                                           bin_faces_capped, capacity,
                                           uses_capped_layout)
    from tssplat_torch.ops.transform import transform_pos
    from tssplat_torch.optim import (adam, adam_uniform, cosine_annealing_lr,
                                     cosine_decay_schedule)
    from tssplat_torch.tools.aa_cases import aa_cases
    from tssplat_torch.tools.compare_kernels import (aa_bounds,
                                                     multisphere_aa_inputs,
                                                     time_aa, time_wsr,
                                                     wsr_counts,
                                                     wsr_library_ms)
    from tssplat_torch.tools.synthetic import bench_scene, multisphere_scene
    from tssplat_torch.tools.timing import bound_ms, cuda_ms
    from tssplat_torch.tools.vis_cases import fullscreen_triangles
    from tssplat_torch.tools.wsr_cases import rows_agree, wsr_cases
    from tssplat_torch.train import (init_train_state, loss_and_grad,
                                     make_train_step, run_steps,
                                     validated_tile_k)

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
    bench_pos, bench_nbrs = pos, geo.statics.edge_nbrs
    B, P = N_VIEWS, N_VIEWS * RES * RES
    results = []

    def report(name, source, replaces, err, tol, ms, plain_ms, bnd,
               library_ms=None):
        require(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        require(math.isfinite(ms) and math.isfinite(plain_ms),
                f"{name}: no time")
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
    k1_ops = 30 * box_tests(bins.table, bins.faces, cnt, bins.nty, bins.ntx,
                            TILE_H, TILE_W, res)
    report("visibility", "tssplat_torch/csrc/vis.cu",
           "tssplat_tpu/ops/pallas_raster.py:197", max_err(got, want), 1e-6,
           cuda_ms(lambda: rk.visibility(bins, res)),
           cuda_ms(lambda: rk.visibility_plain(bins, res), warm=1),
           bound_ms(k1_bytes, k1_ops))
    ids, z, g6, gaux = got

    def check_aa(label, inp, ct, timed=True):
        """K4 and K5 equal by value to their plain versions on ``inp``; with
        ``timed``, their times (as they are, every id 0, L2 flushed), the
        pair counts and the bounds, printed. Returns (K5's d g6, the max
        abs errors of K4 and K5, times, counts)."""
        got_f, got_b = rk.aa_forward(*inp), rk.aa_backward(*inp, ct)
        want_f, want_b = rk.aa_forward_plain(*inp), \
            rk.aa_backward_plain(*inp, ct)
        require(torch.equal(got_f, want_f), f"{label}: K4 differs from plain")
        require(torch.equal(got_b, want_b), f"{label}: K5 differs from plain")
        errs = (max_err([got_f], [want_f]), max_err([got_b], [want_b]))
        if not timed:
            return got_b, errs, None, None
        times, counts = time_aa(rk.aa_forward, rk.aa_backward, inp, ct), \
            aa_bounds(inp)
        print(f"[aa] {label}: {counts['pairs_differ']} pixel pairs whose ids "
              f"differ, {counts['pairs_valid']} valid; z read at "
              f"{counts['px_z']} px, rows at {counts['px_owner']} owners, "
              f"ct at {counts['px_in_a_valid_pair']} px; "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; bounds K4 {counts['K4_bound'][0]:.4f}, K5 "
              f"{counts['K5_bound'][0]:.4f} ms; K4 and K5 equal to plain",
              flush=True)
        return got_b, errs, times, counts

    # K4 and K5 under a seeded cotangent; first on the corner cases
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = aa_cases(dev)
    for name, inp in cases.items():
        check_aa(name, inp, torch.randn(inp[0].shape, generator=gen,
                                        device=dev), timed=False)
    print(f"[aa] K4 and K5 equal their plain versions on the {len(cases)} "
          f"inputs of tools/aa_cases.py", flush=True)
    inp = (ids, z, g6, gaux)
    ct = torch.randn((B, RES, RES), generator=gen, device=dev)
    got, errs, times, counts = check_aa("bench scene", inp, ct)
    fg = ids > 0
    report("aa_forward", "tssplat_torch/csrc/aa_fwd.cu",
           "tssplat_tpu/ops/pallas_raster.py:1171", errs[0], 0.0,
           times["K4_ms"], cuda_ms(lambda: rk.aa_forward_plain(*inp)),
           counts["K4_bound"])
    report("aa_backward", "tssplat_torch/csrc/aa_bwd.cu",
           "tssplat_tpu/ops/pallas_raster.py:1200", errs[1], 0.0,
           times["K5_ms"], cuda_ms(lambda: rk.aa_backward_plain(*inp, ct)),
           counts["K5_bound"])

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
    wsr = wsr_cases(dev)
    for name, (w_ids, w_ct, w_F) in wsr.items():
        rows_agree(rk.wsr_table_grad(w_ids, w_ct, w_F), w_ids, w_ct, w_F)
    print(f"[wsr] K3 agrees with its plain version on the {len(wsr)} inputs "
          f"of tools/wsr_cases.py", flush=True)
    del wsr

    def check_wsr(label, w_ids, w_ct, w_F):
        """K3 on (w_ids, w_ct) within its rows' tolerance of the plain
        version, timed, its counts and bound printed."""
        w_err = rows_agree(rk.wsr_table_grad(w_ids, w_ct, w_F), w_ids, w_ct,
                           w_F)
        w_times = time_wsr(rk.wsr_table_grad, w_ids, w_ct, w_F)
        w_counts = wsr_counts(w_ids, w_ct, w_F)
        print(f"[wsr] {label}: {w_counts['n_fg']} foreground px, "
              f"{w_counts['n_active']} active, {w_counts['rows_touched']} "
              f"(view, face) rows; max_err {w_err:.3g}; "
              + ", ".join(f"{k}={v:.4f}" for k, v in w_times.items())
              + f"; bound {w_counts['K3_bound'][0]:.4f} ms", flush=True)
        return w_times, w_counts

    times, counts = check_wsr("bench scene", ids, ct6, F)
    lib = wsr_library_ms(ids, ct6, F)
    print(f"[wsr] library: index_add_ {lib['index_add_ms']:.4f} ms, "
          f"index_put_ (accumulate) {lib['index_put_ms']:.4f} ms", flush=True)
    report("wsr_table_grad", "tssplat_torch/csrc/wsr_grad.cu",
           "tssplat_tpu/ops/pallas_raster.py:908", err, tol,
           times["K3_ms"],
           cuda_ms(lambda: rk.wsr_table_grad_plain(ids, ct6, F)),
           counts["K3_bound"], library_ms=min(lib.values()))

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
    path = ("visibility", "wsr_table_grad", "aa_forward", "aa_backward")
    require(all(counts[n] == 23 for n in path),
            f"launches {counts}, expected 23 of each of {path}")
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
    del geo, batch, state, bins, got, want, ids, z, g6, gaux, ct, ct6, dense6
    del inp, cases

    # ---- 6. capped visibility at the multi-sphere scene's first step ----------
    t0 = time.perf_counter()
    ms_geo, ms_batch = multisphere_scene(dev, 18, N_VIEWS, RES)
    st = ms_geo.statics
    Fm = int(st.surface_fid.shape[0])
    k = validated_tile_k(ms_geo, ms_batch, RES)
    print(f"[scene] multi-sphere: {ms_geo.num_spheres} spheres, "
          f"{ms_geo.tetmesh.num_vertices} vertices, {ms_geo.tetmesh.num_tets} "
          f"tets, {Fm} faces, {N_VIEWS} views at {RES}x{RES}, validated "
          f"k = {k}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    require(uses_capped_layout(Fm, 14, N_VIEWS, RES, RES)
            and uses_capped_layout(Fm, 11, N_VIEWS, RES, RES),
            "the multi-sphere scene does not take the capped layout")
    with torch.no_grad():
        pos = transform_pos(ms_batch["mvp"], ms_geo.tet_v[st.corner_vid])
    k1_bins = bin_faces(pos, st.edge_nbrs, res)
    k1_out = rk.visibility(k1_bins, res)
    k1_ids = rk.visibility(bin_faces(pos, None, res), res, emit_g=False)
    k1_ms = cuda_ms(lambda: rk.visibility(k1_bins, res))

    def bits(x):
        return x.contiguous().view(torch.int32)

    def check_capped(label, cb):
        """K2b and K2a on ``cb`` against the walk: ids and z to the bit (the
        sign of a zero included), the winner rows equal."""
        walk = rk.visibility_capped_plain(cb, res)
        got_g, got = rk.visibility_capped(cb, res), \
            rk.visibility_capped_ids(cb, res)
        torch.cuda.synchronize()
        for name, out in (("K2b", got_g), ("K2a", got)):
            require(torch.equal(out[0], walk[0]),
                    f"{label}: {name} ids differ from the walk")
            require(torch.equal(bits(out[1]), bits(walk[1])),
                    f"{label}: {name} z differs from the walk")
        require(torch.equal(got_g[2], walk[2])
                and torch.equal(got_g[3], walk[3]),
                f"{label}: K2b rows differ from the walk")
        return got_g

    for name, nbrs, fn, plain, k1_ref, out_bytes, replaces in (
            ("visibility_capped", st.edge_nbrs, rk.visibility_capped,
             rk.visibility_capped_plain, k1_out, 48, ":113"),
            ("visibility_capped_ids", None, rk.visibility_capped_ids,
             rk.visibility_capped_ids_plain, k1_ids, 8, ":53")):
        rows = nbrs is not None
        cb = bin_faces_capped(pos, nbrs, res, k)
        require(int(cb.n_drop.sum()) == 0, f"{name}: n_drop {cb.n_drop}")
        t0 = time.perf_counter()
        got, want = fn(cb, res), plain(cb, res)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        boxed = rk.visibility_capped_boxed_plain(cb, res, emit_g=rows)
        run_tests = int(rk.boxed_pairs(cb, res)[6].sum())
        for other, what in ((want, "the walk"), (boxed, "the boxed search")):
            require(torch.equal(got[0], other[0]),
                    f"{name}: ids differ from {what}")
            require(torch.equal(bits(got[1]), bits(other[1])),
                    f"{name}: z differs from {what}")
            require(all(torch.equal(a, b)
                        for a, b in zip(got[2:], other[2:])),
                    f"{name}: rows differ from {what}")
        require(all(torch.equal(a, b) for a, b in zip(got, k1_ref)),
                f"{name}: differs from K1 on the same scene")
        sc = int(cb.counts.sum())
        live = torch.arange(cb.cand.shape[1], device=dev)[None] \
            < cb.counts[:, None]
        tests = box_tests(cb.table, cb.cand[live], cb.counts, cb.nty, cb.ntx,
                          CAP_TILE_H, CAP_TILE_W, res)
        report(name, "tssplat_torch/csrc/vis_capped.cu",
               f"tssplat_tpu/ops/pallas_raster.py{replaces}",
               max_err(got, want), 1e-6, cuda_ms(lambda: fn(cb, res)),
               cuda_ms(lambda: rk.visibility_capped_boxed_plain(
                   cb, res, emit_g=rows), reps=3, warm=1),
               bound_ms(cb.table.numel() * 4 + sc * 4 + cb.counts.numel() * 4
                        + out_bytes * P, 30 * tests))
        print(f"[kernel] {name}: {sc} (tile, candidate) pairs in "
              f"{int((cb.counts > 0).sum())} of {cb.counts.numel()} tiles "
              f"(max {int(cb.counts.max())}, k {k}); {tests} pixel tests "
              f"inside the faces' exact boxes, {run_tests} inside the boxes "
              f"the kernel clips (half a pixel of slack and one pixel more), "
              f"{CAP_TILE_H * CAP_TILE_W * sc} as the walk makes them (one "
              f"walk on the card: {walk_s * 1e3:.0f} ms with the kernel's "
              f"launch); equal to the walk, to the boxed search and to K1 "
              f"on the same scene; K1 there: {k1_ms:.4f} ms over "
              f"{int(k1_bins.tile_count.sum())} ({TILE_H}x{TILE_W} tile, "
              f"face) pairs", flush=True)

    # the same kernels where K1 is no yardstick or the faces are other
    cb = bin_faces_capped(pos, st.edge_nbrs, res, 512)
    require(int(cb.n_drop.sum()) > 0 and int(cb.counts.max()) == 512,
            f"k = 512 drops nothing: {cb.n_drop}")
    check_capped("k = 512", cb)
    print(f"[capped] (a) k = 512: n_drop per view {cb.n_drop.tolist()}; K2b "
          f"and K2a equal the walk", flush=True)
    cb = bin_faces_capped(bench_pos, bench_nbrs, res, capacity(None, F, res))
    require(int(cb.n_drop.sum()) == 0, f"bench sphere: n_drop {cb.n_drop}")
    got = check_capped("bench sphere", cb)
    require(all(torch.equal(a, b) for a, b in zip(got, rk.visibility(
        bin_faces(bench_pos, bench_nbrs, res), res))),
        "bench sphere: K2b differs from K1")
    print(f"[capped] (b) the bench scene's sphere, capped directly: "
          f"{int(cb.counts.sum())} pairs, {int((got[0] > 0).sum())} "
          f"foreground px; K2b and K2a equal the walk and K1", flush=True)
    cb = bin_faces_capped(fullscreen_triangles(dev, N_VIEWS), None, res, 128)
    got = check_capped("full-screen triangle", cb)
    require(bool((got[0] > 0).all()) and int((got[0] > 1).sum()) > 1000,
            "full-screen triangle: it does not fill the screen")
    print(f"[capped] (c) a triangle over the whole screen and 40 small ones: "
          f"{int((got[0] == 1).sum())} px of the large face, "
          f"{int((got[0] > 1).sum())} of the small; K2b and K2a equal the "
          f"walk", flush=True)
    del k1_bins, k1_out, k1_ids, cb, got, want, boxed, pos, bench_pos

    # ---- 6b. antialias at the multi-sphere scene's first step ------------
    for name, inp in multisphere_aa_inputs(ms_geo, ms_batch, res, k).items():
        dg6 = check_aa(name, inp, torch.randn(inp[0].shape, generator=gen,
                                              device=dev))[0]
        check_wsr(name, inp[0], dg6, Fm)
    del inp, dg6

    # ---- 7/8. multi-sphere training: silhouette, then depth + normal ---------
    phases = (
        ("silhouette", "visibility_capped",
         adam_uniform(cosine_annealing_lr(0.2, 1500), grad_limit=True,
                      grad_limit_values=(0.01, 0.01),
                      grad_limit_iters=(1500,)), {}),
        ("depth+normal", "visibility_capped_ids",
         adam(cosine_decay_schedule(2e-3, 400, alpha=1e-4 / 2e-3)),
         dict(fit_depth=True, fit_normal=True, normal_weight=10.0)))
    for label, vis_name, (init_fn, update_fn), kw in phases:
        step = make_train_step(st, update_fn, resolution=RES, tile_k=k, **kw)
        state = init_train_state(ms_geo.tet_v, init_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launch_counts()
        state, warm_outs = run_steps(step, state, ms_batch, 0, 3)
        float(warm_outs[-1][0])
        t0 = time.perf_counter()
        state, outs = run_steps(step, state, ms_batch, 3, 20)
        last = float(outs[-1][0])              # host sync inside the window
        dt = time.perf_counter() - t0
        counts = rk.launch_counts()
        losses = [float(o[0]) for o in warm_outs + outs]
        n_drop = sum(int(o[3]) for o in warm_outs + outs)
        require(all(math.isfinite(x) for x in losses),
                f"{label}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
        require(n_drop == 0, f"{label}: n_drop = {n_drop}")
        path = (vis_name, "wsr_table_grad", "aa_forward", "aa_backward")
        require(all(counts[n] == 23 for n in path),
                f"{label}: launches {counts}, expected 23 of each of {path}")
        require(last == losses[-1] and torch.isfinite(state.params).all(),
                f"{label}: non-finite parameters")
        print(f"[train-ms] {label}: {20 / dt:.3f} it/s over 20 steps "
              f"(8x{RES}^2, {Fm} faces, k {k}) on {smi}; loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; n_drop "
              f"{n_drop}; launches over 23 steps {counts}", flush=True)
        for r in results:
            if r["name"] == vis_name:
                r["launches"] = counts[vis_name]
        del state, step, warm_outs, outs

    # ---- 9. multi-sphere reference: the card against the CPU, 2 views -------
    two = {key: v[:2] for key, v in ms_batch.items()}
    require(uses_capped_layout(Fm, 14, 2, RES, RES)
            and uses_capped_layout(Fm, 11, 2, RES, RES),
            "2 views of the multi-sphere scene are not capped")
    st_cpu = statics_to(st, "cpu")
    two_cpu = {key: v.cpu() for key, v in two.items()}
    for label, kw in (("silhouette", {}),
                      ("depth+normal", dict(fit_depth=True, fit_normal=True))):
        t0 = time.perf_counter()
        o_gpu = loss_and_grad(st, ms_geo.tet_v, two, 1001, RES, tile_k=k, **kw)
        o_cpu = loss_and_grad(st_cpu, ms_geo.tet_v.cpu(), two_cpu, 1001, RES,
                              tile_k=k, **kw)
        l_gpu, l_cpu = float(o_gpu[0]), float(o_cpu[0])
        g_cpu = o_cpu[4]
        scale = float(g_cpu.abs().max())
        gerr = float((o_gpu[4].cpu() - g_cpu).abs().max())
        require(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu),
                f"multi-sphere {label} loss {l_gpu} vs CPU {l_cpu}")
        require(gerr <= 1e-4 * scale,
                f"multi-sphere {label} grad err {gerr} (scale {scale})")
        require(int(o_gpu[3]) == 0 and int(o_cpu[3]) == 0,
                f"multi-sphere {label}: dropped candidates")
        print(f"[reference-ms] {label}, 2x{RES}^2 step at it 1001: loss "
              f"{l_gpu:.6f} (CPU {l_cpu:.6f}), grad max err {gerr:.3g} of "
              f"max {scale:.3g} ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    require(len(results) == len(rk.KERNELS), "a kernel is missing a report")
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
