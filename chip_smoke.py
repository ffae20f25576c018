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
  6c. the kernels at gso.yaml's shape: the 18-sphere scene at 120 views
               of 512² in one batch, binned as the unchunked step bins them
               (the capped layout the step takes at B = 120, the validated
               capacity): K2b and K2a against the walk (ids and z to the
               bit, rows equal), K4 and K5 on the silhouette step's and the
               depth + normal step's inputs equal to their plain versions,
               K3 on K5's d g6 within its rows' tolerance; each timed as in
               phase 3 (K2b / K2a's plain time is the boxed form's), with
               its bound, into the kernel's ``gso_120v`` entry by path
  6d. the shaded path's kernels (``shaded_phase``): K6, K7 and K8 on
               6c's scene, at its 120 views (K2a's winners at the
               validated capacity) and at the Wonder3D cell's six
               orthographic views, each against its plain version
               (tools/shade_cases.py check_shaded: the forwards and K7's
               d rast to the bit, the folds within 1e-5 of their rows' sums
               of |values|), timed as in phase 3 with its plain version and
               its bound (bytes over 3.35 TB/s); then one depth + normal
               step of the 120 views (Adam, one batch): its launches (K2a,
               K3, K4, K5, K6, K6's backward and K8 once, K7 and its
               backward twice), time and peak memory
  7. multi-sphere silhouette training — 3 + 20 steps, AdamUniform as
               configs/gso.yaml sets it (lr 0.2 cosine over 1500, caps
               0.01): K2b, K3, K4, K5 each launched once per step, no drops
  8. multi-sphere depth + normal training — 3 + 20 steps with Adam (lr 2e-3
               cosine over 400), normal weight 10: K2a, K3, K4, K5, K6, K6's
               backward and K8 each once per step, K7 and its backward twice
               (the normals and the positions)
  9. multi-sphere reference — 2 of the views (capped for both table widths
               at B = 2): one silhouette step and one depth + normal step at
               iteration 1001 on the card against the CPU
 10. driver  — `python -m tssplat_torch.train --config configs/gso.yaml`
               through tssplat_torch.train.main, in process, at the config's
               120 views of 512²: the ellipsoid's dataset written by the
               port's write_synthetic_dataset into a temporary directory, the
               18 spheres of multisphere_scene as key points. (a) gso.yaml
               (AdamUniform lr 0.2, batch 120) in the JAX package's chunks
               (view_chunk=8) for 24 iterations, logging every 4, exporting and
               checkpointing every 12: the exports of iterations 0 and 12 and
               final/ (with final_vtx.npy / final_elem.npy), no n_drop
               warning, img_loss falling, K2b / K3 / K4 / K5 launched 15 / 15
               / 30 / 15 times an iteration (K4 again in each chunk's
               recomputation, visibility never); (b) gso.yaml as shipped
               (view_chunk auto: one batch on the card) for 8 iterations: no
               chunks, its iteration-0 img_loss that of (a) (rtol 1e-5 of
               the logged value), each kernel once an iteration; (c) the
               normal loss (K2a) and the depth loss from iteration 4 with
               Adam lr 2e-3 for 12 iterations in chunks of 8 (view_chunk=8:
               K2a, K3, K5 15 and K4 30 times an iteration; K6, K8 30, K7
               30 or 60, and their backwards 15 and 15 or 30): the step
               rebuilt there, finite losses; (c2) the same as shipped
               (view_chunk auto: one batch on the card, each kernel once an
               iteration), its iteration-0 img_loss that of (c) (rtol
               1e-5); (b), (c) and (c2) load (a)'s sphere meshes (init path
               B). One line per run: the driver's it/s, peak device memory,
               launches an iteration, seconds. (d) the auto rule's bytes
               (``rule_memory_phase``): tools/view_memory.py's peak per
               view-pixel of the unchunked silhouette, depth + normal and
               dense colour texture steps on the 18-sphere bench scene at
               120 views of 512², at its validated capacity and at
               next_pow2(F), each within what train.py's rule counts there
 11. texture — the texture stage through the same main() on (a)'s final/
               meshes (init path C): gso.yaml plus fitting_stage=texture
               material_type=ExplicitMaterial (the default 16 x 2^19 hash
               grid, 32-64-3 MLP) at 120 views of 512², the ellipsoid's
               antialiased Lambertian colour as the target. (a) the exact
               path, 24 iterations: its line printed and no warning, the
               visibility kernel (K1 or K2a), K6 and K7 launched once per
               view in the cache build and once in the UV bake, K8 once
               inside each step and nothing else,
               img_loss falling (the mean of the last four logged against
               the first four), final/material/{material.npz,
               texture_kd.png, mesh.obj, material.mtl} written and the
               texture not flat grey; (b) the sampled path
               (texture_sample_px=4096, cached), 24 iterations, its cache
               line, no launch inside a step, img_loss falling; (c) the card
               against the CPU on 2 views of 128² (the port's writer, the
               same final/ geometry, the same seeded material): one exact
               step and one dense step, loss within rtol 1e-5, the network's
               gradients within 1e-4 of their max and the table's within
               1e-3 (atomics). One line per run: the driver's it/s, the step
               ms (median of the synchronised steps after the first), peak
               memory, launches an iteration, seconds
 12. pipeline — a new object from its images (``pipeline_phase``), each
               step reading the one before it: (a) the dumbbell (two
               icosphere(3) balls of radius 0.3 at x = +-0.45) ray-traced
               by tools/raytrace.py's main at its defaults (120 views of
               512², spp 4, lambert) and held against the port's rasterized
               write_synthetic_dataset of the same views (alpha IoU > 0.95,
               differing pixels on the silhouette ring but <= 4 of them,
               median depth error < 5e-3, median normal dot > 0.99); (b)
               tools/init_spheres.py's main on (a) at its defaults
               (surf_res 50, num_iter 50): >= 2 spheres, both lobes, radii
               > 0, each stage's seconds; (c) gso.yaml through main() on
               (a) and (b)'s JSON, remesh_every=12, 24 iterations: the
               remesh line, no warning, img_loss falling in each
               12-iteration segment, the same launches in every iteration
               of a segment and none outside the steps, final/'s per-sphere
               artifacts partitioning final.veg; one chunk of the views of
               iteration 11 and of iteration 12 (the first on the new
               topology; all 120 where the step has no chunks) at the
               driver's tile capacity, in the layout the step takes there:
               K1 or K2b, K4, K5 and K3 against their plain versions; the
               visibility kernel and the launches an iteration before and
               after the remesh, the remesh's seconds (its distance
               queries and sliver repair apart), it/s and peak memory; (d)
               mesh_chamfer, volume_iou and silhouette_iou of (c)'s final
               surface against the dumbbell, and what volume_iou rests on:
               the surface's components, pockets and non-manifold edges,
               volume_iou of its outer shell alone, and the occupancy IoU
               by the winding number with the cells where the nearest
               face's sign misfires (winding IoU > 0.35, volume_iou > 0.2,
               silhouette IoU > 0.5); (e) ray_mesh_hit_full,
               signed_distance, one smoothed_sdf_grad step and
               tet_remesh_from_surface on the card against the CPU
 13. ranks  — multi-rank training on the one card. (a) (run after 6b, on
               its scenes) every slab of n_sp = 2 and 3 (256- and
               176-row slabs with 8-row halos; 3 pads past the image) of the
               bench scene (K1), the 18-sphere scene (K2b, K2a) and the
               bench scene through a lens 7x longer (K1, K2b, K2a; its
               silhouette crosses the image's top and bottom rows) at 8 x
               512²: each kernel equal to its plain version with the same
               viewport (K1 as phase 3, K2b/K2a to the bit) and its owned
               rows bit-equal to the whole image's kernel output; K4 and K5
               on each slab's visibility (zeroed outside the image) equal to
               their plain versions, the owned rows' coverage equal to the
               whole image's (on the zoomed scene the image's first and last
               rows hold foreground, so a vertical pair into a row outside
               the image would show); each kernel timed on the first slab
               of n_sp 2, with its bound. (b)-(e) (run after 11, in phase 10's
               directory, ``ranks_phase``): gloo ranks sharing the card,
               started by tools/run_ranks.py under a deadline each, run
               gso.yaml through main() for 4 iterations on phase 10's
               dataset and sphere meshes: (b) view parallelism over 2 ranks
               (view_chunk=12: 10 chunks of 12, each rank 6 of every chunk:
               K2b, K3, K5 10 and K4 20 times an iteration per rank), best
               loss within rtol 1e-4 and tet_v within 2e-6 of one process
               unchunked; (c)
               spatial=2 over 2 ranks and spatial=3 over 3: every
               iteration's loss within rtol 1e-5 and tet_v within 1e-6;
               (d) data.world_size=2 with batch 60 (each rank its slice) at
               (b)'s tolerances against one process summing the batch in
               the same two halves (view_chunk=60; that process's distance
               from the unchunked one printed beside it, with the tet_v row
               that moves most, the step it leaves, and that step's pixels
               and gradient under each change apart); (b2) (b) with
               view_chunk auto, as shipped (the chunk of the ranks' least
               free memory: on the card one batch, each rank one half of
               the views, each kernel once an iteration a rank) at (b)'s
               tolerances against (d)'s reference, one process summing the
               batch in the same halves; (e) the texture
               stage's exact path view-sharded over 2
               ranks on phase 10's final/ (60 views cached a rank): every
               iteration's loss within rtol 1e-5 of one process. Every
               rank's tet_v (material) the same bits; one line per run:
               seconds, peak memory and launches an iteration of each rank
 14. image to 3D, and the rest (``image_to_3d_phase``, run after 13
               (b)-(e) in phase 10's directory, on its 18 sphere meshes):
               (a) the SDS driver through main() on configs/img_to_3D.yaml
               plus an ``sds:`` block (target_image guidance toward phase
               10's 120-view bank of 512², 4 views an iteration, 12
               iterations), render: alpha, then render: normal (the
               one-channel bank broadcast over the normals): its it/s,
               peak memory and launches an iteration (K2b or K1 for alpha,
               K2a or K1 for normal, K3, K4, K5 once each), final/final.veg;
               (b) a Wonder3D-layout directory of phase 10's ellipsoid (six
               named views, tests/test_wonder3d.py's orthographic cameras,
               256² PNGs from the port's rasterizer) fitted by train() with
               Wonder3DDataLoader at 512², renderer.is_orhto, img_to_3D.yaml's
               geometry and optimizer, batch 6, 24 iterations; (c)
               TetMeshSkeletonGeometry (3 capsules along the ellipsoid's
               long axis) through train() at gso.yaml's width for 8
               iterations; after each of (a)-(c) the kernels it launched on
               one batch of its views against their plain versions
               (``_check_chunk``); (d) 2 iterations of phase 10's config
               plain, with anomaly=true and with debug_nans=true: the same
               losses to the bit, and a NaN planted in K3's input trapped
               by the NaN trap, naming the kernel
 15. tetwild (``tetwild_phase``, run after 14 in phase 10's directory):
               (a) phase 10's first 8 images, written by
               write_synthetic_dataset through render_views_of_mesh, equal
               byte for byte the composition that writer used before
               (render_rgb_of_mesh + render_alpha_of_mesh); (b) gso.yaml
               through main() at 120 views of 512² on phase 10's dataset
               and 18 key points with geometry.tetwild_exec naming a
               stand-in TetWild written at run time
               (tools/tetwild_stub.py: a tet cone on each triangle of the
               template icosphere(3)), init path A in a cache folder of its
               own, view_chunk auto, 8 iterations: the stand-in's wall
               seconds (18 processes at once), the mesh's vertices, tets
               and faces (18 cones of 1,280), the layout its faces take (K1
               or K2b), the driver's line (it/s, peak memory, launches an
               iteration), img_loss falling, the launches the layout rule
               predicts; then one chunk of the auto rule's views (all 120 on
               the card) of the final geometry
               (``_check_chunk``): each kernel the run launched against its
               plain version
 16. bench (``bench_phase``, after 12): ``python -m tssplat_torch.bench``
               as subprocesses of the checkout, in each mode of BENCH_RUNS:
               (a) BENCH_SMOKE=1 (every kernel against its plain version
               on 2 views of 128²), (b) the bench scene (8 views
               of 512²), (c) BENCH_SPHERES=18, (d) BENCH_VIEWS=120
               BENCH_SPHERES=18 (gso.yaml's width; one batch), (e)
               BENCH_STAGE=texture, the exact path and BENCH_TEX_SAMPLE=4096,
               (f) BENCH_SCALING=1; then (g) ``python -m
               tssplat_torch.tools.trace capture`` and ``top`` on the bench
               scene. Each exits 0 and prints its one line under its name
               with a finite value > 0; each timed step launches its path's
               kernels (the bench's ``launches_per_step``, counted over its
               timed window); the lines, the bench's stderr and (b)'s rate
               against phase 4's are printed
The launch counts are zeroed just before each main-path phase (4, 7, 8,
10a-c2, 11a-b, 12c, 13b-e, each run of 14, 15b, and in each bench process of
16 before its timed window) and read just after it. Then
one JSON line of per-kernel results (launches of K1, K3, K4, K5 from phase
4, of K2b from 7, of K2a, K6, K7 and K8 from 8; K6-K8's times and bounds
at 120 views from 6d, and at the Wonder3D cell's shape as ``w3d_6v``;
``launches_texture`` from phase 11 (a);
``launches_remesh``, an iteration of 12 (c) before and after the remesh;
``launches_image_to_3d``, each run of 14; ``launches_tetwild``, 15 (b);
``launches_bench``, a step of each timed bench run of 16;
``viewport_max_err``, ``viewport_ms`` and ``viewport_bound_ms`` of 13 (a)
for K1, K2a, K2b, K4 and K5; ``gso_120v`` of 6c for K2b, K2a, K3, K4 and
K5), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Phases 14, 15 and 16 alone, from Python on
the card: ``chip_smoke.image_to_3d_alone(smi)``,
``chip_smoke.tetwild_alone(smi)``, ``chip_smoke.bench_phase(smi)``.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

RES = 512
N_VIEWS = 8
GSO_VIEWS = 120          # configs/gso.yaml's batch


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
    t_script = time.perf_counter()
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
    train_ips = 20 / dt
    print(f"[train] {train_ips:.3f} it/s over 20 steps (8x{RES}^2, {F} faces) "
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

    # ---- 13 (a). the slab form of K1, K2b, K2a, K4 and K5 -----------------
    def report_slab(name, err, ms, bnd):
        r = next(r for r in results if r["name"] == name)
        r["viewport_max_err"] = err
        if ms is not None:
            r["viewport_ms"], r["viewport_bound_ms"] = ms, bnd[0]
            print(f"[slab] {name}: {ms:.4f} ms on the first 272-row slab of "
                  f"n_sp 2 ({N_VIEWS} views x 272 x {RES}), bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}); on {smi}", flush=True)

    slab_phase(report_slab, bench_pos, bench_nbrs, pos, st.edge_nbrs, k, res,
               gen)
    del k1_bins, k1_out, k1_ids, cb, got, want, boxed, pos, bench_pos

    # ---- 6b. antialias at the multi-sphere scene's first step ------------
    for name, inp in multisphere_aa_inputs(ms_geo, ms_batch, res, k).items():
        dg6 = check_aa(name, inp, torch.randn(inp[0].shape, generator=gen,
                                              device=dev))[0]
        check_wsr(name, inp[0], dg6, Fm)
    del inp, dg6

    # ---- 6c. the kernels at gso.yaml's shape: 120 views in one batch ------
    t0 = time.perf_counter()
    g_geo, g_batch = multisphere_scene(dev, 18, GSO_VIEWS, RES)
    g_st, g_F = g_geo.statics, int(g_geo.statics.surface_fid.shape[0])
    g_k = validated_tile_k(g_geo, g_batch, RES)
    g_P = GSO_VIEWS * RES * RES
    require(uses_capped_layout(g_F, 14, GSO_VIEWS, RES, RES)
            and uses_capped_layout(g_F, 11, GSO_VIEWS, RES, RES),
            "the step at 120 views does not take the capped layout")
    with torch.no_grad():
        pos = transform_pos(g_batch["mvp"], g_geo.tet_v[g_st.corner_vid])

    def report_gso(name, path, err, ms, plain_ms, bnd):
        r = next(r for r in results if r["name"] == name)
        r.setdefault("gso_120v", {})[path] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
            bound_by=bnd[1])
        print(f"[gso] {name} ({path}): max_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}); "
              f"{GSO_VIEWS}x{RES}^2, k {g_k}, on {smi}", flush=True)

    for name, nbrs, fn, path, out_bytes in (
            ("visibility_capped", g_st.edge_nbrs, rk.visibility_capped,
             "silhouette", 48),
            ("visibility_capped_ids", None, rk.visibility_capped_ids,
             "depth_normal", 8)):
        rows = nbrs is not None
        cb = bin_faces_capped(pos, nbrs, res, g_k)
        require(int(cb.n_drop.sum()) == 0, f"6c {name}: n_drop {cb.n_drop}")
        got = fn(cb, res)
        want = (rk.visibility_capped_plain if rows
                else rk.visibility_capped_ids_plain)(cb, res)
        require(torch.equal(got[0], want[0])
                and torch.equal(bits(got[1]), bits(want[1]))
                and all(torch.equal(a, b) for a, b in zip(got[2:], want[2:])),
                f"6c {name}: differs from the walk")
        sc = int(cb.counts.sum())
        live = torch.arange(cb.cand.shape[1], device=dev)[None] \
            < cb.counts[:, None]
        tests = box_tests(cb.table, cb.cand[live], cb.counts, cb.nty, cb.ntx,
                          CAP_TILE_H, CAP_TILE_W, res)
        report_gso(name, path, max_err(got, want), cuda_ms(lambda: fn(cb, res)),
                   cuda_ms(lambda: rk.visibility_capped_boxed_plain(
                       cb, res, emit_g=rows), reps=3, warm=1),
                   bound_ms(cb.table.numel() * 4 + sc * 4
                            + cb.counts.numel() * 4 + out_bytes * g_P,
                            30 * tests))
        del cb, got, want, live
    for name, inp in multisphere_aa_inputs(g_geo, g_batch, res,
                                           g_k).items():
        path = name.replace("multisphere_", "")
        ct = torch.randn(inp[0].shape, generator=gen, device=dev)
        dg6, errs, times, counts = check_aa(f"{GSO_VIEWS} views, {path}",
                                            inp, ct)
        report_gso("aa_forward", path, errs[0], times["K4_ms"],
                   cuda_ms(lambda: rk.aa_forward_plain(*inp), reps=5, warm=1),
                   counts["K4_bound"])
        report_gso("aa_backward", path, errs[1], times["K5_ms"],
                   cuda_ms(lambda: rk.aa_backward_plain(*inp, ct), reps=5,
                           warm=1), counts["K5_bound"])
        w_err = rows_agree(rk.wsr_table_grad(inp[0], dg6, g_F), inp[0], dg6,
                           g_F)
        w_times, w_counts = check_wsr(f"{GSO_VIEWS} views, {path}", inp[0],
                                      dg6, g_F)
        report_gso("wsr_table_grad", path, w_err, w_times["K3_ms"],
                   cuda_ms(lambda: rk.wsr_table_grad_plain(inp[0], dg6, g_F),
                           reps=5, warm=1), w_counts["K3_bound"])
    del pos, inp, ct, dg6
    torch.cuda.empty_cache()
    print(f"[gso] phase 6c {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 6d. K6, K7 and K8 at gso.yaml's and the Wonder3D cell's shapes ----
    def report_shaded(name, label, err, ms, plain_ms, bnd):
        if label == "gso_120v":
            exact = name in ("shade", "interp", "winner_rows")
            report(name, f"tssplat_torch/csrc/{SHADED_SOURCES[name]}",
                   "none (XLA code in the JAX package)", err,
                   0.0 if exact else math.inf, ms, plain_ms, bnd)
        else:
            r = next(r for r in results if r["name"] == name)
            r[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd[0], bound_by=bnd[1])
            print(f"[shaded] {name} ({label}): max_err={err:.3g} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bnd[0]:.4f} ({bnd[1]}); on {smi}", flush=True)

    shaded_phase(smi, report_shaded, g_geo, g_batch, g_k)
    del g_geo, g_batch
    torch.cuda.empty_cache()

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
        shaded = dict(shade=23, shade_backward=23, winner_rows=23,
                      interp=46, interp_backward=46) if kw else \
            dict.fromkeys(SHADED_SOURCES, 0)
        require(all(counts[n] == c for n, c in shaded.items()),
                f"{label}: launches {counts}, expected {shaded}")
        require(last == losses[-1] and torch.isfinite(state.params).all(),
                f"{label}: non-finite parameters")
        print(f"[train-ms] {label}: {20 / dt:.3f} it/s over 20 steps "
              f"(8x{RES}^2, {Fm} faces, k {k}) on {smi}; loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; n_drop "
              f"{n_drop}; launches over 23 steps {counts}", flush=True)
        for r in results:
            if r["name"] == vis_name or (kw and r["name"] in shaded):
                r["launches"] = counts[r["name"]]
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

    del ms_geo, ms_batch, two, two_cpu
    texture_counts, i3d_counts, tetwild_counts = driver_phase(smi)
    for r in results:
        r["launches_texture"] = texture_counts.get(r["name"], 0)
        r["launches_image_to_3d"] = {run: c.get(r["name"], 0)
                                     for run, c in i3d_counts.items()}
        r["launches_tetwild"] = tetwild_counts.get(r["name"], 0)
    before, after = pipeline_phase(smi)
    for r in results:
        r["launches_remesh"] = {"before": before[r["name"]],
                                "after": after[r["name"]]}
    bench_counts = bench_phase(smi, train_ips)
    for r in results:
        r["launches_bench"] = {label: c[r["name"]]
                               for label, c in bench_counts.items()}

    require(len(results) == len(rk.KERNELS), "a kernel is missing a report")
    print(f"[done] every phase passed in "
          f"{time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


SHADED_SOURCES = {"shade": "shade.cu", "shade_backward": "shade.cu",
                  "interp": "interp.cu", "interp_backward": "interp.cu",
                  "winner_rows": "winner_rows.cu"}


def shaded_phase(smi, report, geo, batch, k, res=RES):
    """Phase 6d: K6, K7 and K8 on the 18-sphere scene ``geo`` at the
    views of ``batch`` (gso.yaml's 120 of res², visibility K2a at the
    validated capacity ``k``) and at the Wonder3D cell's six orthographic
    views: each against its plain version (tools/shade_cases.py
    check_shaded: forwards and K7's d rast to the bit, the folds within
    1e-5 of their rows' sums of |values|), timed as in phase 3 beside its
    plain version and its bound (shaded_bounds: bytes over 3.35 TB/s), the
    numbers handed to ``report(name, shape, err, ms, plain_ms, bound)``;
    then the launches, time and peak memory of one depth + normal step of
    ``batch`` (Adam, one batch). Returns that step's launch counts."""
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.ops.rasterize import visibility_ids
    from tssplat_torch.ops.transform import transform_pos
    from tssplat_torch.optim import adam, cosine_decay_schedule
    from tssplat_torch.tools.shade_cases import (check_shaded, shaded_bounds,
                                                 shaded_inputs)
    from tssplat_torch.tools.timing import cuda_ms
    from tssplat_torch.train import (init_train_state, make_train_step,
                                     run_steps)

    t0 = time.perf_counter()
    dev = batch["mvp"].device
    st = geo.statics
    gen = torch.Generator(device=dev).manual_seed(6)
    w3d = torch.tensor(wonder3d_mvps(), device=dev)
    for label, mvp, ortho in (("gso_120v", batch["mvp"], False),
                              ("w3d_6v", w3d, True)):
        with torch.no_grad():
            pos = transform_pos(mvp, geo.tet_v[st.corner_vid],
                                is_ortho=ortho)
        ids, n_drop = visibility_ids(pos, (res, res), k)
        require(int(n_drop.sum()) == 0, f"6d {label}: n_drop {n_drop}")
        inp = shaded_inputs(pos, ids, st.edge_nbrs, gen)
        errs = check_shaded(inp, gen)
        bounds = shaded_bounds(inp)
        tbl, tbl6, nbrs, attr = inp["tbl"], inp["tbl6"], inp["nbrs"], \
            inp["attrs"][0]
        rast = rk.shade(ids, tbl)
        ct4 = torch.randn(rast.shape, generator=gen, device=dev)
        ct3 = torch.randn((*ids.shape, 3), generator=gen, device=dev)
        calls = {
            "shade": (lambda: rk.shade(ids, tbl),
                      lambda: rk.shade_plain(ids, tbl)),
            "shade_backward": (lambda: rk.shade_backward(ids, tbl, ct4),
                               lambda: rk.shade_backward_plain(ids, tbl,
                                                               ct4)),
            "interp": (lambda: rk.interp(rast, attr),
                       lambda: rk.interp_plain(rast, attr)),
            "interp_backward": (lambda: rk.interp_backward(rast, attr, ct3),
                                lambda: rk.interp_backward_plain(rast, attr,
                                                                 ct3)),
            "winner_rows": (lambda: rk.winner_rows(rast, tbl6, nbrs),
                            lambda: rk.winner_rows_plain(rast, tbl6, nbrs)),
        }
        for name, (fn, plain) in calls.items():
            report(name, label, errs[name], cuda_ms(fn),
                   cuda_ms(plain, reps=5, warm=1), bounds[name])
        fg = int((ids > 0).sum())
        print(f"[shaded] {label}: {mvp.shape[0]} views of {res}², {fg} "
              f"foreground px ({fg / ids.numel():.3f} of them), k {k}; K6, "
              f"K7 and K8 agree with their plain versions; on {smi}",
              flush=True)
        del pos, ids, inp, tbl, tbl6, nbrs, attr, rast, ct4, ct3, calls
    torch.cuda.empty_cache()

    init_fn, update_fn = adam(cosine_decay_schedule(2e-3, 400,
                                                    alpha=1e-4 / 2e-3))
    step = make_train_step(st, update_fn, resolution=res, tile_k=k,
                           fit_depth=True, fit_normal=True,
                           normal_weight=10.0)
    state = init_train_state(geo.tet_v, init_fn)
    state, outs = run_steps(step, state, batch, 0, 2)
    float(outs[-1][0])
    torch.cuda.reset_peak_memory_stats()
    rk.reset_launch_counts()
    t1 = time.perf_counter()
    state, outs = run_steps(step, state, batch, 2, 1)
    loss = float(outs[-1][0])
    step_ms = (time.perf_counter() - t1) * 1e3
    counts = rk.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(visibility_capped_ids=1, wsr_table_grad=1, aa_forward=1,
                aa_backward=1, shade=1, shade_backward=1, interp=2,
                interp_backward=2, winner_rows=1)
    require(counts == want, f"6d: a depth + normal step launches {counts}, "
            f"expected {want}")
    require(math.isfinite(loss), f"6d: non-finite loss {loss}")
    print(f"[shaded] one depth + normal step of {batch['mvp'].shape[0]} "
          f"views: launches {json.dumps({n: c for n, c in counts.items() if c})}"
          f"; {step_ms:.1f} ms with its host read; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase 6d "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del state, step, outs
    torch.cuda.empty_cache()
    return counts


def shaded_alone(smi=""):
    """Phase 6d by itself (the scene at 120 views of 512², ~10 s to mesh),
    its numbers printed."""
    from tssplat_torch.tools.synthetic import multisphere_scene
    from tssplat_torch.train import validated_tile_k

    geo, batch = multisphere_scene("cuda", 18, GSO_VIEWS, RES)

    def report(name, label, err, ms, plain_ms, bnd):
        print(f"[shaded] {name} ({label}): max_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})",
              flush=True)

    return shaded_phase(smi, report, geo, batch,
                        validated_tile_k(geo, batch, RES))


def slab_phase(report_slab, bench_pos, bench_nbrs, ms_pos, ms_nbrs, k, res,
               gen):
    """Phase 13 (a): every slab of n_sp = 2 and 3 (the latter 176-row
    slabs padded past the image) of the bench scene (K1), of the 18-sphere
    scene (K2b, K2a) and of the bench scene through a lens seven times
    longer (K1, K2b, K2a: its silhouette crosses the image's top and bottom
    rows, so the slabs at the image's edges hold foreground on the image
    row next to the rows outside it), 8 views: each kernel against its
    plain version with the same viewport (K1 as phase 3; K2b and K2a to the
    bit), and its owned rows bit-equal to the whole image's kernel output;
    K4 and K5 on each slab's visibility of K1 and K2b (zeroed outside the
    image, as the spatial loss does) equal to their plain versions, the
    owned rows' coverage equal to the whole image's. Each slab's own
    foreground is counted, and the zoomed scene's on the image's first and
    last rows. Each kernel timed on the first slab of n_sp = 2 of the
    first two scenes, with its bound; ``report_slab(name, err, ms, bound)``
    takes each kernel's largest error over the slabs and that time."""
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.ops.binning import (bin_faces, bin_faces_capped,
                                           capacity)
    from tssplat_torch.parallel.spatial import HALO, slab_rows
    from tssplat_torch.tools.compare_kernels import aa_bounds
    from tssplat_torch.tools.timing import bound_ms, cuda_ms

    H, W = res
    B = bench_pos.shape[0]
    zoomed = bench_pos.clone()
    zoomed[..., :2] *= 7.0
    k_zoom = capacity(None, int(bench_nbrs.shape[0]), res)
    K1, K2B, K2A = "visibility", "visibility_capped", "visibility_capped_ids"
    kernels = {K1: (rk.visibility, rk.visibility_plain),
               K2B: (rk.visibility_capped, rk.visibility_capped_plain),
               K2A: (rk.visibility_capped_ids,
                     rk.visibility_capped_ids_plain)}

    def binned(name, pos, nbrs, kk, rs, vp=None):
        if name == K1:
            return bin_faces(pos, nbrs, rs, vp)
        return bin_faces_capped(pos, nbrs if name == K2B else None, rs, kk,
                                vp)

    # scene: (pos, edge neighbours, tile capacity, its kernels)
    scenes = {"bench": (bench_pos, bench_nbrs, None, (K1,)),
              "18 spheres": (ms_pos, ms_nbrs, k, (K2B, K2A)),
              "bench zoomed": (zoomed, bench_nbrs, k_zoom, (K1, K2B, K2A))}
    full, coverage = {}, {}
    for sn, (pos, nbrs, kk, names) in scenes.items():
        for name in names:
            full[sn, name] = kernels[name][0](binned(name, pos, nbrs, kk,
                                                     res), res)
            if name != K2A:
                coverage[sn, name] = rk.aa_forward(*full[sn, name])
    edge_fg = {r: int((full["bench zoomed", K1][0][:, r] > 0).sum())
               for r in (0, H - 1)}
    require(all(v >= 20 * B for v in edge_fg.values()),
            f"the zoomed scene's first and last rows hold {edge_fg} "
            f"foreground px")
    errs = dict.fromkeys((K1, K2B, K2A, "aa_forward", "aa_backward"), 0.0)
    t0 = time.perf_counter()
    n_slabs, slab_fg = 0, []
    for n_sp in (2, 3):
        h_loc = slab_rows(H, n_sp)
        slab_h = h_loc + 2 * HALO
        rs = (slab_h, W)
        for s in range(n_sp):
            row0 = s * h_loc - HALO
            vp = (row0, H)
            absr = row0 + torch.arange(slab_h, device=bench_pos.device)
            valid = ((absr >= 0) & (absr < H))[:, None]
            lo, hi = max(0, -row0), min(slab_h, H - row0)   # image rows
            o0, o1 = HALO, HALO + min(h_loc, H - s * h_loc)   # owned rows
            label = f"n_sp {n_sp} slab {s} (rows {row0}..{row0 + slab_h})"
            fg = {}
            for sn, (pos, nbrs, kk, names) in scenes.items():
                outs = {}
                for name in names:
                    bins = binned(name, pos, nbrs, kk, rs, vp)
                    fn, plain = kernels[name]
                    require(int(bins.n_drop.sum()) == 0,
                            f"{label}, {sn}: {name} drops "
                            f"{bins.n_drop.tolist()}")
                    got, want = fn(bins, rs), plain(bins, rs)
                    torch.cuda.synchronize()
                    require(torch.equal(got[0], want[0]),
                            f"{label}, {sn}: {name} ids differ from plain")
                    if name == K1:             # as phase 3
                        require(torch.equal(got[3], want[3]),
                                f"{label}, {sn}: K1 gaux differ from plain")
                        err = max_err(got, want)
                        require(err <= 1e-6, f"{label}, {sn}: K1 err {err}")
                    else:                      # as phase 6
                        require(all(torch.equal(a.view(torch.int32),
                                                b.view(torch.int32))
                                    for a, b in zip(got[:2], want[:2]))
                                and all(torch.equal(a, b)
                                        for a, b in zip(got[2:], want[2:])),
                                f"{label}, {sn}: {name} differs from the "
                                f"walk")
                        err = max_err(got, want)
                    for a, b in zip(got, full[sn, name]):
                        rows = (slice(None), slice(o0, o1)) \
                            if a.dim() == 3 else \
                            (slice(None), slice(None), slice(o0, o1))
                        brows = (slice(None), slice(row0 + o0, row0 + o1)) \
                            if a.dim() == 3 else \
                            (slice(None), slice(None),
                             slice(row0 + o0, row0 + o1))
                        require(torch.equal(a[rows], b[brows]),
                                f"{label}, {sn}: {name}'s owned rows differ "
                                f"from the whole image's")
                    errs[name] = max(errs[name], err)
                    outs[name] = (bins, got)
                fg[sn] = int((outs[names[0]][1][0][:, lo:hi] > 0).sum())
                for name in (K1, K2B):
                    if name not in outs:
                        continue
                    inp = tuple(x * valid for x in outs[name][1])
                    ct = torch.randn(inp[0].shape, generator=gen,
                                     device=bench_pos.device)
                    f_got = rk.aa_forward(*inp, viewport=vp)
                    b_got = rk.aa_backward(*inp, ct, viewport=vp)
                    f_want = rk.aa_forward_plain(*inp, viewport=vp)
                    b_want = rk.aa_backward_plain(*inp, ct, viewport=vp)
                    require(torch.equal(f_got, f_want)
                            and torch.equal(b_got, b_want),
                            f"{label}, {sn}: K4/K5 on {name}'s slab differ "
                            f"from plain")
                    require(torch.equal(f_got[:, o0:o1], coverage[sn, name][
                        :, row0 + o0:row0 + o1]),
                        f"{label}, {sn}: K4's owned rows differ from the "
                        f"whole image")
                    errs["aa_forward"] = max(errs["aa_forward"],
                                             max_err([f_got], [f_want]))
                    errs["aa_backward"] = max(errs["aa_backward"],
                                              max_err([b_got], [b_want]))
                if n_sp == 2 and s == 0 and sn != "bench zoomed":
                    P = B * slab_h * W
                    for name, (bins, got) in outs.items():
                        fn = kernels[name][0]
                        if name == K1:
                            nbytes = (bins.table.numel() * 4
                                      + bins.faces.numel() * 4
                                      + 2 * bins.tile_count.numel() * 4
                                      + 48 * P)
                        else:
                            nbytes = (bins.table.numel() * 4
                                      + int(bins.counts.sum()) * 4
                                      + bins.counts.numel() * 4
                                      + (48 if name == K2B else 8) * P)
                        report_slab(name, errs[name],
                                    cuda_ms(lambda: fn(bins, rs)),
                                    bound_ms(nbytes, 0))
                    if K2B in outs:
                        inp = tuple(x * valid for x in outs[K2B][1])
                        ct = torch.randn(inp[0].shape, generator=gen,
                                         device=bench_pos.device)
                        b_aa = aa_bounds(inp, vp)
                        report_slab("aa_forward", errs["aa_forward"],
                                    cuda_ms(lambda: rk.aa_forward(
                                        *inp, viewport=vp)),
                                    b_aa["K4_bound"])
                        report_slab("aa_backward", errs["aa_backward"],
                                    cuda_ms(lambda: rk.aa_backward(
                                        *inp, ct, viewport=vp)),
                                    b_aa["K5_bound"])
            require(fg["bench zoomed"] > 100 * B,
                    f"{label}: the zoomed scene's slab holds "
                    f"{fg['bench zoomed']} foreground px")
            slab_fg.append(fg)
            n_slabs += 1
    for name in errs:
        report_slab(name, errs[name], None, None)
    print(f"[slab] {n_slabs} slabs of n_sp 2 and 3 ({slab_rows(H, 2)} and "
          f"{slab_rows(H, 3)} owned rows, {HALO}-row halos) of 3 scenes: "
          f"K1, K2b, K2a, K4 and K5 equal their plain versions, owned rows "
          f"equal the whole image's; foreground px on the slabs' image rows "
          f"{json.dumps(slab_fg)}; the zoomed scene's on the image's first "
          f"and last rows {edge_fg}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def _rel(steps, ref_steps):
    """Each step's loss off that of ``ref_steps``, relative, as text."""
    return [f"{abs(a[0] / b[0] - 1):.2g}" for a, b in zip(steps, ref_steps)]


def _rank_line(label, res, iters, smi):
    """One line of a multi-rank run: seconds, peak memory and launches an
    iteration of each rank."""
    per = [{k: v / iters for k, v in r["launches"].items() if v}
           for r in res]
    print(f"[ranks] {label}: {len(res)} ranks sharing one card (their rates "
          f"are no scaling figure); seconds "
          f"{[round(r['seconds'], 1) for r in res]}; peak "
          f"{[round(r['peak_gib'], 2) for r in res]} GiB; launches an "
          f"iteration {json.dumps(per)}; on {smi}", flush=True)


def ranks_phase(smi, tmp, gso, base, geo_dir, views, timeout=300.0,
                device=None):
    """Phase 13 (b)-(e) on phase 10's dataset and sphere meshes (init path
    B) and its final/ (the texture stage's geometry): gloo ranks sharing
    the one card, each started by tools/run_ranks.py under ``timeout``
    seconds; any rank's failure fails the phase. (b) view parallelism, 2
    ranks, in chunks of 12; (c) spatial=2 over 2 ranks and spatial=3 over
    3; (d) per-rank slices (data.world_size=2, batch views / 2); (b2) view
    parallelism with view_chunk auto; (e) the exact texture path
    view-sharded over 2 ranks. Each against one process of the same
    iterations on the card ((d) and (b2): summing the batch in the ranks'
    halves). ``device="cpu"`` rehearses it on the CPU (where no kernel
    launches, so the launch checks are skipped)."""
    from tssplat_torch.tools.run_ranks import run_ranks, train_rank
    from tssplat_torch.utils.tree import tree_leaves

    iters = 4
    common = ["--config", gso, *base, f"data.total_num_iter={iters}",
              "geometry.load_precomputed_tetwild_mesh=true",
              "export_every=1000"]

    def ranks(label, world, *over):
        out = f"{tmp}/ranks_{label}"
        res = run_ranks("tssplat_torch.tools.run_ranks:train_rank", dict(
            out=out, argv=[*common, f"output_path={out}", *over],
            device=device), world_size=world, timeout=timeout,
            device=device)
        params = [torch.load(r["params"]) for r in res]
        require(all(torch.equal(a, b) for p in params[1:]
                    for a, b in zip(tree_leaves(p), tree_leaves(params[0]))),
                f"({label}): the ranks' parameters differ")
        require(len({json.dumps(r["steps"]) for r in res}) == 1,
                f"({label}): the ranks logged other losses")
        _rank_line(label, res, iters, smi)
        return res, params[0]

    def one(label, *over, record=None):
        """One process; with ``record`` (a dict) each step's statics,
        options, batch, iteration and parameters before and after."""
        import tssplat_torch.train as tt
        make_step = tt.make_train_step

        def spy(statics, update_fn, **kw):
            step = make_step(statics, update_fn, **kw)
            record.update(statics=statics, kw=kw)

            def recorded(state, batch, it):
                before = state.params.clone()
                state, outs = step(state, batch, it)
                for key, v in (("before", before), ("batch", batch),
                               ("it", it), ("after", state.params.clone())):
                    record.setdefault(key, []).append(v)
                return state, outs
            return recorded

        out = f"{tmp}/one_{label}"
        if record is not None:
            tt.make_train_step = spy
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                r = train_rank(out, argv=[*common, f"output_path={out}",
                                          *over], device=device)
        finally:
            tt.make_train_step = make_step
        return r, torch.load(r["params"])

    t0 = time.perf_counter()
    rec_u, rec_h = {}, {}
    unchunked = one("unchunked", "view_chunk=0", record=rec_u)

    def close(label, res, p, rtol, atol, per_step=False, ref=unchunked,
              what="unchunked"):
        ref, ref_p = ref
        err = float((p - ref_p).abs().max())
        print(f"[ranks] ({label}) against one process, {what}: best loss "
              f"{res[0]['best_loss']:.7g} ({ref['best_loss']:.7g}), tet_v "
              f"max diff {err:.3g}; each iteration's loss off by "
              f"{_rel(res[0]['steps'], ref['steps'])} (relative); n_drop "
              f"{[s[3] for s in res[0]['steps']]} (one process "
              f"{[s[3] for s in ref['steps']]})", flush=True)
        if per_step:
            for a, b in zip(res[0]["steps"], ref["steps"]):
                require(math.isclose(a[0], b[0], rel_tol=rtol),
                        f"({label}): loss {a[0]} vs one process {b[0]}")
        require(math.isclose(res[0]["best_loss"], ref["best_loss"],
                             rel_tol=rtol),
                f"({label}): best loss {res[0]['best_loss']} vs "
                f"{ref['best_loss']}")
        require(err <= atol, f"({label}): tet_v differs by {err}")

    # (b) view parallelism: view_chunk=12 (JAX's pick for 2 devices) = 10
    # chunks of 12, 6 a rank
    res, p = ranks("b_view_dp", 2, "view_chunk=12")
    close("b_view_dp", res, p, 1e-4, 2e-6)
    want = dict(visibility_capped=10, wsr_table_grad=10, aa_forward=20,
                aa_backward=10)
    for r in res:
        got = {k: v / iters for k, v in r["launches"].items() if v}
        require(device is not None or got == want,
                f"(b): launches an iteration {got}, expected {want}")
    # (c) spatial
    for n_sp in (2, 3):
        res, p = ranks(f"c_spatial{n_sp}", n_sp, f"spatial={n_sp}")
        close(f"c_spatial{n_sp}", res, p, 1e-5, 1e-6, per_step=True)
    # (d) per-rank slices of the loader, against one process on the global
    # batch summed in the same halves (two chunks); the halves' one process
    # against the unchunked one shows how far the grouping alone moves tet_v
    halves = one("halves", f"view_chunk={views // 2}", record=rec_h)
    err = float((halves[1] - unchunked[1]).abs().max())
    print(f"[ranks] one process, the batch in halves against unchunked: "
          f"tet_v max diff {err:.3g}; each iteration's loss off by "
          f"{_rel(halves[0]['steps'], unchunked[0]['steps'])}", flush=True)
    _drift_probe(rec_u, rec_h, views // 2)
    del rec_u, rec_h
    res, p = ranks("d_world_size", 2, "data.world_size=2",
                   f"data.batch_size={views // 2}", "data.rank=null")
    close("d_world_size", res, p, 1e-4, 2e-6, ref=halves,
          what="the batch in halves")
    # (b2) view parallelism as shipped (view_chunk auto): every rank reads
    # its own free memory and all take the chunks of the least; on the
    # card one batch, each rank one half of the views (so (d)'s reference),
    # each kernel once an iteration
    res, p = ranks("b2_view_dp_auto", 2)
    close("b2_view_dp_auto", res, p, 1e-4, 2e-6, ref=halves,
          what="the batch in halves")
    want = dict(visibility_capped=1, wsr_table_grad=1, aa_forward=1,
                aa_backward=1)
    for r in res:
        got = {k: v / iters for k, v in r["launches"].items() if v}
        require(device is not None or got == want,
                f"(b2): launches an iteration {got}, expected {want}")
    # (e) the exact texture path, view-sharded
    tex = ["fitting_stage=texture", "material_type=ExplicitMaterial",
           f"geometry.initial_mesh_path={geo_dir}"]
    ref, _ = one("texture", *tex)
    res, _ = ranks("e_texture", 2, *tex)
    for a, b in zip(res[0]["steps"], ref["steps"]):
        require(math.isclose(a[0], b[0], rel_tol=1e-5),
                f"(e): loss {a[0]} vs one process {b[0]}")
    n_vis = [sum(r["launches"][k] for k in ("visibility",
                                            "visibility_capped_ids"))
             for r in res]
    require(device is not None or n_vis == [views // 2 + 1, views // 2],
            f"(e): visibility launches {n_vis}, expected each rank's "
            f"{views // 2} views cached (and rank 0's UV bake)")
    print(f"[ranks] (e) texture, exact path over 2 ranks: losses "
          f"{[round(s[0], 6) for s in res[0]['steps']]} (one process "
          f"{[round(s[0], 6) for s in ref['steps']]}); phase 13 (b)-(e) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _drift_probe(rec_u, rec_h, view_chunk):
    """Where and why the run summing the batch in two chunks of
    ``view_chunk`` leaves the unchunked one (phase 13 (d)'s reference):
    the tet_v row that moves most, the first step at which it is more than
    1e-6 off, and at that step's parameters of both runs: the pixels whose
    winning face differs, those on a face of that vertex, the pixels whose
    coverage differs by more than 1e-3, and the vertex's gradient under
    each change apart (the other run's parameters, the other grouping of
    the sum on the same parameters, every coordinate nudged by one ulp in
    a seeded direction) beside the largest change at every other vertex.
    Prints one line; checks nothing."""
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.render.pipeline import render_visibility
    from tssplat_torch.train import loss_and_grad

    st, kw = rec_u["statics"], rec_u["kw"]
    res, tile_k = kw["resolution"], kw["tile_k"]
    drift = [(a - b).abs().amax(dim=1) for a, b in zip(rec_h["after"],
                                                        rec_u["after"])]
    v = int(drift[-1].argmax())
    first = next((i for i, d in enumerate(drift) if float(d[v]) > 1e-6),
                 None)
    when = ("never more than 1e-6 off; at the last step" if first is None
            else f"first off by more than 1e-6 after step {first + 1} of "
            f"{len(drift)}; before that step")
    first = len(drift) - 1 if first is None else first
    p_u, p_h = rec_u["before"][first], rec_h["before"][first]
    batch, it = rec_u["batch"][first], rec_u["it"][first]
    faces = st.corner_vid.view(-1, 3)
    n_ids = n_on_v = n_cov = 0
    with torch.no_grad():
        for s in range(0, batch["mvp"].shape[0], 12):
            mvp = batch["mvp"][s:s + 12]
            vu = render_visibility(p_u, st, mvp, res, shaded=False,
                                   tile_k=tile_k)
            vh = render_visibility(p_h, st, mvp, res, shaded=False,
                                   tile_k=tile_k)
            iu, ih = vu[0], vh[0]
            diff = iu != ih
            n_ids += int(diff.sum())
            for ids in (iu[diff], ih[diff]):
                f = (ids[ids > 0] - 1).long()
                n_on_v += int((faces[f] == v).any(dim=1).sum())
            cu = rk.aa_forward(*vu[:4])
            ch = rk.aa_forward(*vh[:4])
            n_cov += int(((cu - ch).abs() > 1e-3).sum())
    gen = torch.Generator(device=p_u.device).manual_seed(5)
    away = torch.where(torch.rand(p_u.shape, generator=gen,
                                  device=p_u.device) < 0.5, -1.0, 1.0)
    nudged = torch.nextafter(p_u, p_u + away)

    def grad(p, chunk=0):
        return loss_and_grad(st, p, batch, it, res, tile_k=tile_k,
                             view_chunk=chunk)[4]

    g_u = grad(p_u)
    changes = {"the halves' parameters": grad(p_h) - g_u,
               "the sum in halves": grad(p_u, view_chunk) - g_u,
               "a one-ulp nudge": grad(nudged) - g_u}
    others = torch.ones(g_u.shape[0], dtype=torch.bool, device=g_u.device)
    others[v] = False
    text = "; ".join(
        f"{name}: {float(d[v].abs().max()):.3g} at the vertex, "
        f"{float(d[others].abs().max()):.3g} at any other"
        for name, d in changes.items())
    print(f"[ranks] (d) the drift: tet_v row {v} moves most "
          f"({float(drift[-1][v]):.3g}; the next row "
          f"{float(drift[-1][others].max()):.3g}; per step "
          f"{[f'{float(d[v]):.3g}' for d in drift]}), {when} the "
          f"two runs' parameters differ by "
          f"{float((p_h - p_u).abs().max()):.3g} and give other winning "
          f"faces at {n_ids} px ({n_on_v} on faces of the vertex) and "
          f"coverage off by > 1e-3 at {n_cov} px; the vertex's gradient "
          f"(max |g| {float(g_u[v].abs().max()):.3g}, over all "
          f"{float(g_u.abs().max()):.3g}) changes under {text}", flush=True)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _make_runner(smi, tmp, base, views, res, device=None):
    """``run(label, iters, want, *over, config=gso.yaml, common=base)``:
    tssplat_torch.train.main in process on ``device``, in ``tmp``, each
    run's output in ``tmp/label``, its line printed (see below)."""
    from tssplat_torch.ops import raster_kernels as rk
    import tssplat_torch.train as tt
    from tssplat_torch.utils.tree import tree_leaves

    gso = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "gso.yaml")

    def run(label, iters, want, *over, config=gso, common=None,
            size=f"{views}x{res}^2"):
        """main() on ``config`` (gso.yaml) with ``common`` (``base``)
        and ``over`` for ``iters`` iterations; requires finite losses,
        no warning and, unless ``want`` is None, the launch counts
        ``want`` (every other kernel 0); returns the logged
        (iteration, img_loss) pairs, the output directory and the
        printed text. ``size`` labels the views in the printed line."""
        out = f"{tmp}/{label}"
        argv = ["--config", config, *(base if common is None
                                      else common),
                f"output_path={out}", f"data.total_num_iter={iters}",
                *over]
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            state, _ = tt.main(argv, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = rk.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        text = "".join(tee.text)
        logged = [(int(i), float(x)) for i, x in re.findall(
            r"iter=\s*(\d+), img_loss=([0-9.]+)", text)]
        ips = float(re.search(r"iters/sec: ([0-9.]+)", text).group(1))
        meter = re.findall(r"\[([0-9.]+) iters/s", text)
        print(f"[driver] {label}: {ips:.3f} it/s (the driver's count, "
              f"all {iters} iterations and their exports); "
              f"{meter[-1] if meter else 'n/a'} it/s from iteration 1 to "
              f"the last log (the log's meter); {size}; peak "
              f"{peak:.2f} GiB; launches an iteration "
              f"{json.dumps({k: n / iters for k, n in counts.items()})}"
              f"; {secs:.1f} s; img_loss {logged[0][1]} -> "
              f"{logged[-1][1]}; on {smi}", flush=True)
        require("WARNING" not in text, f"{label}: a warning: {text}")
        require(all(math.isfinite(x) for _, x in logged)
                and all(bool(torch.isfinite(p).all())
                        for p in tree_leaves(state.params)),
                f"{label}: non-finite loss or parameters {logged}")
        if want is not None:
            full = dict.fromkeys(counts, 0)
            full.update(want)
            require(counts == full, f"{label}: launches {counts} over "
                    f"{iters} iterations, expected {full}")
        return logged, out, text

    return run


def driver_phase(smi, views=120, res=512, device=None):
    """Phases 10, 11, 13 (b)-(e), 14 and 15: configs/gso.yaml through
    tssplat_torch.train.main at ``views`` views of res² (120 of 512², see
    the module docstring) on ``device`` (the card unless given), the
    geometry stage, the texture stage on its result, the ranks, image to
    3D, then the TetWild path in the same directory. Returns the launch
    counts of 11 (a), those of 14's runs ({run: counts}) and those of
    15 (b)."""
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.tools.synthetic import (write_multisphere_key_points,
                                               write_synthetic_dataset)
    import tssplat_torch.train as tt

    gso = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "gso.yaml")
    chunks = views // 8
    # the chunks of view_chunk auto: none where the device's free memory
    # holds the views at once (the card), JAX's chunks of 8 off CUDA
    vc = tt._auto_view_chunk(views, 1, res, device=device)
    auto_chunks = views // vc if vc else 1
    with tempfile.TemporaryDirectory(prefix="tss_driver_") as tmp:
        t0 = time.perf_counter()
        v, f = icosphere(subdivisions=3)
        write_synthetic_dataset(os.path.join(tmp, "img"),
                                v * [0.30, 0.24, 0.18], f, n_views=views,
                                resolution=res, device=device)
        write_multisphere_key_points(os.path.join(tmp, "kp.json"), 18)
        print(f"[driver] dataset of {views} views at {res}x{res} (alpha, "
              f"depth, normal) written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        base = [f"data.dataset_config.image_root={tmp}/img",
                f"data.batch_size={views}",                  # gso.yaml's 120
                f"geometry.key_points_file_path={tmp}/kp.json",
                f"geometry.tetwild_cache_folder={tmp}/cache"]

        run = _make_runner(smi, tmp, base, views, res, device)

        # (a) gso.yaml in JAX's chunks of 8, 24 iterations: per chunk one
        # K2b, K3 and K5, and K4 twice (forward and recomputation)
        log_a, out_a, text = run(
            "a_chunked", 24, dict(visibility_capped=24 * chunks,
                                  wsr_table_grad=24 * chunks,
                                  aa_forward=48 * chunks,
                                  aa_backward=24 * chunks),
            "view_chunk=8", "log_every=4", "export_every=12",
            "checkpoint_every=12")
        require(f"view microbatching: {chunks} chunks of 8 views" in text,
                "(a): view_chunk=8 did not run chunks of 8")
        require(log_a[-1][1] < log_a[0][1],
                f"(a): img_loss did not fall {log_a}")
        final = set(os.listdir(f"{out_a}/final"))
        need = {"final.veg", "final_surface_mesh.obj", "final_vtx.npy",
                "final_elem.npy", "spheres_vtx_idx.json",
                "spheres_elem_idx.json"} | {
            f"final_sp{i}_{k}.npy" for i in range(18) for k in ("vtx", "elem")}
        require(need <= final, f"(a): final/ lacks {sorted(need - final)}")
        for path in ("mesh00000/00000.veg", "mesh00012/00012.veg",
                     "ckpt/step_00000012.pt"):
            require(os.path.exists(f"{out_a}/{path}"), f"(a): no {path}")

        # (b) gso.yaml as shipped (view_chunk auto), 8 iterations, on (a)'s
        # sphere meshes: the card's free memory holds the 120 views at once
        log_b, _, text = run(
            "b_unchunked", 8, dict(visibility_capped=8, wsr_table_grad=8,
                                   aa_forward=8, aa_backward=8),
            "log_every=4", "export_every=12",
            "geometry.load_precomputed_tetwild_mesh=true")
        require("view microbatching" not in text,
                "(b): view_chunk auto chunked 120 views of 512² on the card")
        require(math.isclose(log_b[0][1], log_a[0][1], rel_tol=1e-5),
                f"(b): iteration-0 img_loss {log_b[0][1]} != (a)'s "
                f"{log_a[0][1]}")

        # (c) the normal loss throughout (K2a: the shaded path), the depth
        # loss from iteration 4 (the step rebuilt then), Adam lr 2e-3, 12
        # iterations: K7 interpolates the normals 12 times, the positions 8
        built = []
        make_step = tt.make_train_step

        def spy(*args, **kw):
            built.append(kw["fit_depth"])
            return make_step(*args, **kw)

        tt.make_train_step = spy
        dn = ("fit_depth=true", "fit_depth_starting_iter=3",
              "fit_normal=true", "optimizer.type=adam", "optimizer.lr=2e-3",
              "resume=false", "log_every=1", "export_every=12",
              "geometry.load_precomputed_tetwild_mesh=true")
        try:
            # in JAX's chunks of 8: K2a once a chunk, K4 again in each
            # chunk's recomputation
            log_c, _, text = run(
                "c_depth_normal", 12, dict(
                    visibility_capped_ids=12 * chunks,
                    wsr_table_grad=12 * chunks, aa_forward=24 * chunks,
                    aa_backward=12 * chunks,
                    **_shaded_launches(12, 20, chunks)), "view_chunk=8",
                *dn)
            require(f"view microbatching: {chunks} chunks of 8 views"
                    in text, "(c): view_chunk=8 did not run chunks of 8")
            # (c2) as shipped (view_chunk auto): the auto rule's chunks,
            # on the card one batch and no recomputation
            log_c2, _, text = run(
                "c2_depth_normal_auto", 12, dict(
                    visibility_capped_ids=12 * auto_chunks,
                    wsr_table_grad=12 * auto_chunks,
                    aa_forward=(24 if auto_chunks > 1 else 12) * auto_chunks,
                    aa_backward=12 * auto_chunks,
                    **_shaded_launches(12, 20, auto_chunks)), *dn)
            require(("view microbatching" in text) == (auto_chunks > 1),
                    f"(c2): not the auto rule's {auto_chunks} chunks")
        finally:
            tt.make_train_step = make_step
        require(built == [False, True] * 2, f"(c): steps built {built}")
        for label, logged in (("c", log_c), ("c2", log_c2)):
            require(len(logged) == 12, f"({label}): {len(logged)} log lines")
        require(math.isclose(log_c2[0][1], log_c[0][1], rel_tol=1e-5),
                f"(c2): iteration-0 img_loss {log_c2[0][1]} != (c)'s "
                f"{log_c[0][1]}")
        rule_memory_phase(smi)

        counts = texture_phase(smi, tmp, run, f"{out_a}/final", views,
                               device)
        ranks_phase(smi, tmp, gso, base, f"{out_a}/final", views,
                    device=device)
        i3d = image_to_3d_phase(smi, tmp, run, views, res, device)
        tetwild = tetwild_phase(smi, tmp, run, views, res, device)
        return counts, i3d, tetwild


def rule_memory_phase(smi, views=120, res=512):
    """Phase 10 (d): tools/view_memory.py's readings of the unchunked
    silhouette, depth + normal and dense colour texture steps on the
    18-sphere bench scene at ``views`` views of res², at the scene's
    validated capacity and at next_pow2(F), the largest the validator
    returns: each peak per view-pixel within the bytes the chunk rule
    counts there (train.py BYTES_PER_VIEW_PX and BYTES_PER_TILE_SLOT)."""
    from tssplat_torch.tools import view_memory as vm
    from tssplat_torch.tools.synthetic import bench_scene

    t0 = time.perf_counter()
    geo, batch = bench_scene(torch.device("cuda"), views, res, n_spheres=18)
    for k in vm.capacities(geo, batch, res):
        for path in vm.PATHS:
            got = vm.measure(path, geo, batch, res, k)
            print(f"[rule] {path}, k {k}: peak {got['peak_bytes'] / 2**30:.2f}"
                  f" GiB over {got['resident_bytes'] / 2**30:.2f} resident: "
                  f"{got['bytes_per_view_px']:.1f} B a view-pixel, the rule "
                  f"counts {got['rule_bytes_per_view_px']:.1f}; {views}x"
                  f"{res}² on {smi}", flush=True)
            require(got["bytes_per_view_px"] <= got["rule_bytes_per_view_px"],
                    f"(d) {path} at k {k}: {got['bytes_per_view_px']} B a "
                    f"view-pixel, above the rule's "
                    f"{got['rule_bytes_per_view_px']}")
    del geo, batch
    torch.cuda.empty_cache()
    print(f"[rule] phase 10 (d) {time.perf_counter() - t0:.1f} s",
          flush=True)


# phase 16: each mode of the port's bench, its expected metric and the
# kernels its step launches (each at least once a step)
BENCH_RUNS = (
    ("a", {"BENCH_SMOKE": "1"}, "cuda_kernel_smoke", ()),
    ("b", {}, "geometry_train_iters_per_sec_b8_r512",
     ("visibility", "wsr_table_grad", "aa_forward", "aa_backward")),
    ("c", {"BENCH_SPHERES": "18"}, "geometry_train_iters_per_sec_b8_r512_s18",
     ("visibility_capped", "wsr_table_grad", "aa_forward", "aa_backward")),
    ("d", {"BENCH_VIEWS": "120", "BENCH_SPHERES": "18"},
     "geometry_train_iters_per_sec_b120_r512_s18",
     ("visibility_capped", "wsr_table_grad", "aa_forward", "aa_backward")),
    ("e_exact", {"BENCH_STAGE": "texture"},
     "texture_train_iters_per_sec_b8_r512", ()),
    ("e_sampled", {"BENCH_STAGE": "texture", "BENCH_TEX_SAMPLE": "4096"},
     "texture_train_iters_per_sec_b8_r512", ()),
    ("f", {"BENCH_SCALING": "1"}, "weak_scaling_efficiency_d{cards}_r256",
     ()),
)


def _metric_line(label, stdout, name, one_line=True):
    """The JSON line of ``stdout`` parsed (with ``one_line``, the only
    line and bench.py's four keys; else the last line): under ``name``,
    its value finite and > 0."""
    lines = stdout.strip().splitlines()
    require(lines and (len(lines) == 1 or not one_line),
            f"({label}): {len(lines)} stdout lines, not one: {lines}")
    rec = json.loads(lines[-1])
    require(rec.get("metric") == name and (not one_line or list(rec) == [
        "metric", "value", "unit", "vs_baseline"]),
        f"({label}): {lines[-1]} is not a {name} line")
    require(math.isfinite(rec["value"]) and rec["value"] > 0,
            f"({label}): value {rec['value']}")
    return rec


def bench_phase(smi, train_ips=None, timeout=600):
    """Phase 16: ``python -m tssplat_torch.bench`` in each mode of
    BENCH_RUNS, then ``python -m tssplat_torch.tools.trace capture`` and
    ``top`` on the bench scene, each a subprocess of the checkout with no
    other BENCH_* or TRACE_* setting: each exits 0 and prints its line
    under its name with a finite value > 0; each bench run launches the
    kernels of its path in the timed window (its stderr's
    ``launches_per_step``). Prints each line, the bench's diagnostics and
    (b)'s rate against phase 4's ``train_ips``. Returns {label: launches
    a step} of the bench runs that time a step."""
    root = os.path.dirname(os.path.abspath(__file__))
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("BENCH_", "TRACE_"))}
    env0["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env0.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t_phase = time.perf_counter()
    launches, rates = {}, {}

    def sub(label, argv, env):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], env=dict(env0, **env),
                              cwd=root, capture_output=True, text=True,
                              timeout=timeout)
        require(proc.returncode == 0, f"({label}) {argv} exited "
                f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                f"{proc.stderr[-4000:]}")
        return proc, time.perf_counter() - t0

    for label, env, name, path in BENCH_RUNS:
        name = name.format(cards=torch.cuda.device_count())
        proc, secs = sub(label, ["-m", "tssplat_torch.bench"], env)
        rec = _metric_line(label, proc.stdout, name)
        rates[label] = rec["value"]
        for line in proc.stderr.strip().splitlines():
            print(f"[bench] ({label}) {line}", flush=True)
        print(f"[bench] ({label}) {proc.stdout.strip()} in {secs:.1f} s on "
              f"{smi}", flush=True)
        found = re.findall(r"^launches_per_step=(.*)$", proc.stderr, re.M)
        if label not in ("a", "f"):
            require(found, f"({label}): no launches_per_step on stderr")
            launches[label] = json.loads(found[-1])
            require(all(launches[label][n] >= 1 for n in path),
                    f"({label}): launches a step {launches[label]}, each of "
                    f"{path} expected")
    if train_ips is not None:
        print(f"[bench] (b) {rates['b']} it/s against phase 4's "
              f"{train_ips:.4f} it/s on the same scene and step (ratio "
              f"{rates['b'] / train_ips:.3f})", flush=True)

    # (g) the trace tool on the bench scene
    with tempfile.TemporaryDirectory(prefix="tss_trace_") as tmp:
        proc, secs = sub("g capture", ["-m", "tssplat_torch.tools.trace",
                                       "capture", tmp], {})
        require(os.path.exists(os.path.join(tmp, "trace.json")),
                "(g): capture wrote no trace.json")
        proc, secs2 = sub("g top", ["-m", "tssplat_torch.tools.trace", "top",
                                    tmp, "10", "15"], {})
        _metric_line("g", proc.stdout, "trace_device_ms_per_step",
                     one_line=False)
    for line in proc.stdout.strip().splitlines():
        print(f"[bench] (g) {line}", flush=True)
    print(f"[bench] (g) capture {secs:.1f} s, top {secs2:.1f} s; phase 16 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the six named views of the Wonder3D layout and the azimuths of
# tests/test_wonder3d.py's orthographic cameras
W3D_VIEWS = (("front", 0), ("front_right", 45), ("right", 90), ("back", 180),
             ("left", 270), ("front_left", 315))


def wonder3d_mvps():
    """The six orthographic cameras of tests/test_wonder3d.py:35-41,
    ``diag(1.2, -1.2, -0.3, 1) @ look_at(2.5)`` at the azimuths of
    W3D_VIEWS: (6,4,4) float32."""
    import numpy as np
    from tssplat_torch.ops.transform import look_at

    mvps = []
    for _, ang in W3D_VIEWS:
        a = np.radians(ang)
        mv = look_at(np.asarray([np.sin(a), 0.0, np.cos(a)]) * 2.5,
                     [0, 0, 0], [0, 1, 0])
        mvps.append((np.diag([1.2, -1.2, -0.3, 1.0]) @ mv).astype(np.float32))
    return np.stack(mvps)


def write_wonder3d_views(root, verts, faces, res=256, device=None):
    """A Wonder3D-layout directory of the surface (verts, faces) from
    numpy: ``mvp/{view}_mvp.npy`` (tests/test_wonder3d.py:35-41's
    orthographic cameras), ``masked_colors1/rgb_{view}.png`` (a flat
    colour under the port's antialiased silhouette, rendered with the
    orthographic z/6) and ``normals/normal_{view}.png`` at res², and the
    empty ``imgs/`` that image_root names. Returns the mvps (6,4,4)."""
    import numpy as np
    from PIL import Image
    from tssplat_torch.device import resolve_device
    from tssplat_torch.mesh.surface import triangle_edge_neighbors
    from tssplat_torch.ops.rasterize import (antialias_silhouette,
                                             rasterize_silhouette_with_rows)
    from tssplat_torch.ops.transform import transform_pos

    dev = resolve_device(device)
    for d in ("masked_colors1", "normals", "mvp", "imgs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    mvps = wonder3d_mvps()
    faces = np.asarray(faces, np.int64)
    corners = torch.tensor(np.asarray(verts)[faces.reshape(-1)],
                           dtype=torch.float32, device=dev)
    nbrs = torch.as_tensor(triangle_edge_neighbors(faces), device=dev)
    with torch.no_grad():
        pos = transform_pos(torch.tensor(mvps, device=dev), corners,
                            is_ortho=True)
        ids, z, g6, gaux, _ = rasterize_silhouette_with_rows(pos, nbrs,
                                                             (res, res))
        alpha = antialias_silhouette(ids, z, g6, gaux).clamp(0, 1).cpu()
    for (view, _), m, al in zip(W3D_VIEWS, mvps, alpha.numpy()):
        np.save(os.path.join(root, "mvp", f"{view}_mvp.npy"), m)
        rgba = np.stack([al * 0.7, al * 0.5, al * 0.3, al], -1)
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
            os.path.join(root, "masked_colors1", f"rgb_{view}.png"))
        nrm = np.stack([al * 0.5 + 0.5] * 3 + [al], -1)
        Image.fromarray((nrm * 255).astype(np.uint8), "RGBA").save(
            os.path.join(root, "normals", f"normal_{view}.png"))
    return mvps


def _final_geometry(out, device):
    """The statics and tet_v of a run's final/final.veg on ``device``."""
    from tssplat_torch.geometry import TetMeshGeometry
    from tssplat_torch.mesh.tetmesh import TetMesh
    geo = TetMeshGeometry(dict(use_smooth_barrier=False), device=device,
                          tetmesh=TetMesh.from_veg(f"{out}/final/final.veg"))
    return geo


def _path_launches(F, B, res, iters, chunks=1, shaded=False):
    """The launches of ``iters`` iterations of a silhouette (or, with
    ``shaded``, a normal) step over B views in ``chunks`` chunks: the
    visibility kernel the layout rule picks, K3 and K5 once a chunk, K4
    once, or twice where chunks are recomputed; with ``shaded`` K6-K8 as
    ``_shaded_launches`` counts them."""
    from tssplat_torch.ops.binning import uses_capped_layout
    if uses_capped_layout(F, 11 if shaded else 14, B // chunks, res, res):
        vis = "visibility_capped_ids" if shaded else "visibility_capped"
    else:
        vis = "visibility"
    n = iters * chunks
    out = {vis: n, "wsr_table_grad": n,
           "aa_forward": n * (2 if chunks > 1 else 1), "aa_backward": n}
    if shaded:                         # the normals: one interpolation
        out.update(_shaded_launches(iters, iters, chunks))
    return out


def _shaded_launches(renders, interps, chunks=1):
    """The launches of K6, K7 and K8 over ``renders`` shaded renders (each
    in ``chunks`` chunks) that interpolate ``interps`` attributes in all:
    K6 and K8 once a chunk's forward, K7 once an attribute, each forward
    again in a recomputed chunk; the backwards once a chunk."""
    fwd = chunks * (2 if chunks > 1 else 1)
    return dict(shade=renders * fwd, winner_rows=renders * fwd,
                shade_backward=renders * chunks, interp=interps * fwd,
                interp_backward=interps * chunks)


def image_to_3d_phase(smi, tmp, run, views, res, device=None,
                      w3d_png=256, w3d_res=512):
    """Phase 14 (see the module docstring), in phase 10's directory
    ``tmp`` (its dataset, key points and sphere meshes) with driver_phase's
    main() runner ``run``; the Wonder3D views are w3d_png² PNGs loaded at
    w3d_res². Returns {run: launch counts} of its main-path runs."""
    import numpy as np
    from tssplat_torch.config import dump_config, load_config
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.mesh.tetmesh import TetMesh
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.train import validated_tile_k
    from tssplat_torch.utils import debug
    import tssplat_torch.train as tt

    dev = torch.device("cuda") if device is None else torch.device(device)
    here = os.path.dirname(os.path.abspath(__file__))
    i2d = os.path.join(here, "configs", "img_to_3D.yaml")
    gso = os.path.join(here, "configs", "gso.yaml")
    F18 = int(TetMesh(np.load(f"{tmp}/cache/final_tet_v.npy"),
                      np.load(f"{tmp}/cache/final_tet_t.npy"))
              .surface_fid.shape[0])
    spheres = [f"geometry.key_points_file_path={tmp}/kp.json",
               f"geometry.tetwild_cache_folder={tmp}/cache",
               "geometry.load_precomputed_tetwild_mesh=true"]
    t_phase = time.perf_counter()
    out_counts = {}

    # (a) SDS toward phase 10's bank, img_to_3D.yaml's geometry
    bank_mvp = torch.tensor(np.stack([
        np.load(f"{tmp}/img/mvp_mtx_{i}.npy") for i in range(4)]),
        dtype=torch.float32, device=dev)
    for render in ("alpha", "normal"):
        label = f"a_sds_{render}"
        cfg = f"{tmp}/{label}.yaml"
        with open(i2d) as src, open(cfg, "w") as dst:
            dst.write(src.read() + (
                f"\nsds:\n  render: {render}\n  views_per_iter: 4\n"
                f"  total_num_iter: 12\n  guidance:\n"
                f"    type: target_image\n    image_root: {tmp}/img\n"))
        out = f"{tmp}/{label}"
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            state, geo = tt.main(["--config", cfg, *spheres,
                                  f"output_path={out}", "log_every=4"],
                                 device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = rk.launch_counts()
        text = "".join(tee.text)
        loop = float(re.search(r"sds: 12 iterations in ([0-9.]+) s",
                               text).group(1))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = dict.fromkeys(counts, 0)
        want.update(_path_launches(F18, 4, res, 12,
                                   shaded=render == "normal"))
        print(f"[image-to-3d] {label}: {12 / loop:.3f} it/s (12 iterations "
              f"of 4 views of {res}², {F18} faces, the SDS loop alone); "
              f"peak {peak:.2f} GiB; launches an iteration "
              f"{json.dumps({k: n / 12 for k, n in counts.items()})}; "
              f"{secs:.1f} s with the bank's load and the export; on {smi}",
              flush=True)
        require("WARNING" not in text, f"(a) {render}: a warning: {text}")
        require(bool(torch.isfinite(state.params).all()),
                f"(a) {render}: non-finite parameters")
        require(counts == want, f"(a) {render}: launches {counts}, "
                f"expected {want}")
        require(os.path.exists(f"{out}/final/final.veg"),
                f"(a) {render}: no final/final.veg")
        out_counts[label] = counts
        _check_chunk(f"(a) sds {render}, final geometry", geo.statics,
                     geo.tet_v, bank_mvp, res,
                     validated_tile_k(geo, {"mvp": bank_mvp}, res),
                     shaded=render == "normal", tag="image-to-3d")
        del state, geo

    # (b) Wonder3D views of phase 10's ellipsoid, orthographic, 256² PNGs
    # resized to the dataset's 512²
    v, f = icosphere(subdivisions=3)
    w3d = f"{tmp}/w3d"
    mvps = write_wonder3d_views(w3d, v * [0.30, 0.24, 0.18], f, w3d_png,
                                device)
    logged, out, _ = run(
        "b_wonder3d", 24, dict(dict.fromkeys(rk.launch_counts(), 0),
                               **_path_launches(F18, 6, w3d_res, 24)),
        "dataloader_type=Wonder3DDataLoader",
        f"data.dataset_config.image_root={w3d}/imgs",
        f"data.dataset_config.camera_mvp_root={w3d}/mvp",
        f"data.dataset_config.resolution={w3d_res}", "data.batch_size=6",
        "renderer.is_orhto=true", "log_every=4", "export_every=100",
        *spheres[2:], config=i2d, size=f"6x{w3d_res}^2")
    out_counts["b_wonder3d"] = rk.launch_counts()
    require(_falls(logged), f"(b): img_loss did not fall {logged}")
    geo = _final_geometry(out, dev)
    mvp6 = torch.tensor(mvps, device=dev)
    _check_chunk("(b) wonder3d, final geometry", geo.statics, geo.tet_v,
                 mvp6, w3d_res, validated_tile_k(geo, {"mvp": mvp6}, w3d_res,
                                                 is_ortho=True),
                 is_ortho=True, tag="image-to-3d")

    # (c) the skeleton geometry: 3 capsules along the ellipsoid's long
    # axis, gso.yaml with the skeleton's geometry block (its Config has no
    # sphere-mesher keys)
    with open(f"{tmp}/skeleton.json", "w") as fh:
        json.dump({"centers": [[[-0.24, 0, 0], [-0.08, 0, 0]],
                               [[-0.08, 0, 0], [0.08, 0, 0]],
                               [[0.08, 0, 0], [0.24, 0, 0]]],
                   "radii": [[0.08, 0.14], [0.14, 0.14], [0.14, 0.08]]}, fh)
    skel_cfg = load_config(gso)
    for key in ("template_surface_sphere_path", "tetwild_exec",
                "tetwild_cache_folder", "load_precomputed_tetwild_mesh"):
        skel_cfg["geometry"].pop(key)
    skel_cfg["geometry_type"] = "TetMeshSkeletonGeometry"
    skel_cfg["geometry"]["key_points_file_path"] = f"{tmp}/skeleton.json"
    dump_config(f"{tmp}/skeleton.yaml", skel_cfg)
    vc = tt._auto_view_chunk(views, 1, res, device=device)   # auto's pick
    chunks = views // vc if vc else 1
    logged, out, _ = run(
        "c_skeleton", 8, None, "total_num_iter=8", "log_every=1",
        "export_every=100", config=f"{tmp}/skeleton.yaml",
        common=[f"data.dataset_config.image_root={tmp}/img",
                f"data.batch_size={views}"])
    counts = rk.launch_counts()
    out_counts["c_skeleton"] = counts
    geo = _final_geometry(out, dev)
    Fs = int(geo.statics.surface_fid.shape[0])
    want = dict.fromkeys(counts, 0)
    want.update(_path_launches(Fs, views, res, 8, chunks=chunks))
    require(counts == want, f"(c): launches {counts}, expected {want}")
    require(_falls(logged), f"(c): img_loss did not fall {logged}")
    sphere_files = [n for n in os.listdir(f"{out}/final") if "_sp" in n]
    require(len(sphere_files) == 6, f"(c): per-capsule files {sphere_files}")
    # one chunk of the step's views: all of them where auto picks none
    mvp_c = torch.tensor(np.stack([np.load(f"{tmp}/img/mvp_mtx_{i}.npy")
                                   for i in range(vc or views)]), device=dev)
    _check_chunk("(c) skeleton, final geometry", geo.statics, geo.tet_v,
                 mvp_c, res, validated_tile_k(geo, {"mvp": mvp_c}, res),
                 tag="image-to-3d")
    del geo

    # (d) the sanitizers on phase 10's config: the same losses, bit for bit
    make_step = tt.make_train_step
    losses = {}
    for label, knob in (("d_plain", []), ("d_anomaly", ["anomaly=true"]),
                        ("d_debug_nans", ["debug_nans=true"])):
        got = losses.setdefault(label, [])

        def spy(*args, got=got, **kw):
            step = make_step(*args, **kw)

            def recorded(state, batch, it):
                state, out = step(state, batch, it)
                got.append(float(out[0]))
                return state, out
            return recorded

        tt.make_train_step = spy
        try:
            run(label, 2, dict(dict.fromkeys(rk.launch_counts(), 0),
                               **_path_launches(F18, views, res, 2,
                                                chunks=chunks)),
                *knob, "log_every=1", "export_every=100",
                "geometry.load_precomputed_tetwild_mesh=true", config=gso)
        finally:
            tt.make_train_step = make_step
        out_counts[label] = rk.launch_counts()
        require(not debug.anomaly_enabled()
                and not debug.debug_nans_enabled(),
                f"{label}: a sanitizer left on after the run")
    require(len(losses["d_plain"]) == 2
            and losses["d_anomaly"] == losses["d_plain"]
            and losses["d_debug_nans"] == losses["d_plain"],
            f"(d): losses differ {losses}")
    # a NaN planted in K3's input (a cotangent at a foreground pixel) is
    # trapped at the kernel's output, naming it
    bins, rr, F = _bench_bins(dev)
    ids = rk.visibility(bins, rr)[0]
    ct = torch.zeros((ids.shape[0], 6) + tuple(ids.shape[1:]), device=dev)
    fg = torch.nonzero(ids[0] > 0)[0]
    ct[0, 0, fg[0], fg[1]] = float("nan")
    debug.enable_debug_nans(True)
    try:
        rk.wsr_table_grad(ids, ct, F)
        trapped = None
    except FloatingPointError as e:
        trapped = str(e)
    finally:
        debug.enable_debug_nans(False)
    require(trapped is not None and "kernel wsr_table_grad" in trapped,
            f"(d): the NaN in K3's input was not trapped ({trapped})")
    print(f"[image-to-3d] (d) anomaly and debug_nans: losses "
          f"{losses['d_plain']} equal to the run without them; a NaN in "
          f"K3's input trapped: {trapped!r}; phase 14 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out_counts


def image_to_3d_alone(smi, views=120, res=512, device=None, **kw):
    """Phase 14 by itself: phase 10's dataset and key points written into
    a temporary directory, its 18 sphere meshes built into the cache (init
    path A, on the host), then ``image_to_3d_phase``. Smaller arguments
    rehearse it (``device="cpu"`` with the cuda synchronisation and memory
    calls stubbed)."""
    from tssplat_torch.geometry import TetMeshMultiSphereGeometry
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.tools.synthetic import (write_multisphere_key_points,
                                               write_synthetic_dataset)
    with tempfile.TemporaryDirectory(prefix="tss_i3d_") as tmp:
        v, f = icosphere(subdivisions=3)
        write_synthetic_dataset(os.path.join(tmp, "img"),
                                v * [0.30, 0.24, 0.18], f, n_views=views,
                                resolution=res, device=device)
        write_multisphere_key_points(os.path.join(tmp, "kp.json"), 18)
        TetMeshMultiSphereGeometry(dict(
            key_points_file_path=f"{tmp}/kp.json",
            tetwild_cache_folder=f"{tmp}/cache",
            output_path=f"{tmp}/spheres"), device="cpu")
        base = [f"data.dataset_config.image_root={tmp}/img",
                f"data.batch_size={views}",
                f"geometry.key_points_file_path={tmp}/kp.json",
                f"geometry.tetwild_cache_folder={tmp}/cache"]
        return image_to_3d_phase(
            smi, tmp, _make_runner(smi, tmp, base, views, res, device),
            views, res, device, **kw)

def tetwild_phase(smi, tmp, run, views, res, device=None):
    """Phase 15 (see the module docstring), in phase 10's directory
    ``tmp`` (its dataset and key points) with driver_phase's main() runner
    ``run``. Returns the launch counts of its run."""
    import numpy as np
    from PIL import Image
    import tssplat_torch.geometry.multisphere as ms
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.mesh.tetmesh import TetMesh
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.tools.synthetic import (render_alpha_of_mesh,
                                               render_rgb_of_mesh)
    from tssplat_torch.tools.tetwild_stub import write_tetwild_stub
    from tssplat_torch.train import validated_tile_k
    import tssplat_torch.train as tt

    dev = torch.device("cuda") if device is None else torch.device(device)
    t_phase = time.perf_counter()
    # (a) phase 10's images, written through render_views_of_mesh, are the
    # bytes of the composition it replaced
    v, f = icosphere(subdivisions=3)
    v = v * np.asarray([0.30, 0.24, 0.18])
    mvp8 = np.stack([np.load(f"{tmp}/img/mvp_mtx_{i}.npy") for i in range(8)])
    rgba = np.concatenate([
        render_rgb_of_mesh(v, f, mvp8, res, device=dev).cpu().numpy(),
        render_alpha_of_mesh(v, f, mvp8, res, device=dev).cpu().numpy()], -1)
    want = np.clip(rgba * 255.0, 0, 255).astype(np.uint8)
    got = np.stack([np.asarray(Image.open(f"{tmp}/img/img_rgba_{i}.png"))
                    for i in range(8)])
    require(np.array_equal(got, want), "(a): phase 10's images differ from "
            "render_rgb_of_mesh + render_alpha_of_mesh at "
            f"{int((got != want).any(-1).sum())} pixels")
    print(f"[tetwild] (a) phase 10's first 8 images ({res}²) equal the "
          f"bytes of render_rgb_of_mesh + render_alpha_of_mesh", flush=True)

    # (b) gso.yaml with the stand-in TetWild: 8 iterations, view_chunk auto
    stub = write_tetwild_stub(f"{tmp}/tetwild_exec")
    cache = f"{tmp}/cache_tetwild"
    meshed = ms._tetwild_spheres
    took = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        parts = meshed(*args, **kw)
        took.append(time.perf_counter() - t0)
        return parts

    ms._tetwild_spheres = timed
    try:
        logged, out, text = run(
            "tetwild", 8, None, f"geometry.tetwild_exec={stub}",
            f"geometry.tetwild_cache_folder={cache}", "log_every=1",
            "export_every=100")
    finally:
        ms._tetwild_spheres = meshed
    counts = rk.launch_counts()
    n_sp = len(json.load(open(f"{tmp}/kp.json"))["pt"])
    mesh = TetMesh(np.load(f"{cache}/final_tet_v.npy"),
                   np.load(f"{cache}/final_tet_t.npy"))
    F = int(mesh.surface_fid.shape[0])
    n_tri = icosphere(subdivisions=3)[1].shape[0]    # gso.yaml's template
    require(len(took) == 1, f"(b): the TetWild path ran {len(took)} times")
    require(mesh.num_tets == n_sp * n_tri and F == n_sp * n_tri
            and all(os.path.exists(f"{cache}/temp{i}.msh_TO.npy")
                    for i in range(n_sp)),
            f"(b): {mesh.num_tets} tets, {F} faces: not the stand-in's "
            f"{n_sp} cones of {n_tri}")
    vc = tt._auto_view_chunk(views, 1, res, device=device)
    want = dict.fromkeys(counts, 0)
    want.update(_path_launches(F, views, res, 8,
                               chunks=views // vc if vc else 1))
    require(counts == want, f"(b): launches {counts}, expected {want}")
    require(_falls(logged), f"(b): img_loss did not fall {logged}")
    layout = "K2b" if counts.get("visibility_capped") else "K1"
    print(f"[tetwild] (b) {n_sp} spheres meshed by the stand-in in "
          f"{took[0]:.2f} s (wall, {n_sp} processes at once): "
          f"{mesh.num_vertices} vertices, {mesh.num_tets} tets, {F} faces, "
          f"the faces on {layout}'s layout; {views}x{res}² for 8 iterations "
          f"(the driver's line above)", flush=True)
    geo = _final_geometry(out, dev)
    # one chunk of the step's views: all of them where auto picks none
    mvp_t = torch.tensor(np.stack([np.load(f"{tmp}/img/mvp_mtx_{i}.npy")
                                   for i in range(vc or views)]), device=dev)
    _check_chunk("(b) tetwild, final geometry", geo.statics, geo.tet_v,
                 mvp_t, res, validated_tile_k(geo, {"mvp": mvp_t}, res),
                 tag="tetwild")
    print(f"[tetwild] phase 15 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


def tetwild_alone(smi, views=120, res=512, device=None):
    """Phase 15 by itself: phase 10's dataset and key points written into
    a temporary directory, then ``tetwild_phase``. Smaller arguments
    rehearse it (``device="cpu"`` with the cuda synchronisation and memory
    calls stubbed)."""
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.tools.synthetic import (write_multisphere_key_points,
                                               write_synthetic_dataset)
    with tempfile.TemporaryDirectory(prefix="tss_tetwild_") as tmp:
        v, f = icosphere(subdivisions=3)
        write_synthetic_dataset(os.path.join(tmp, "img"),
                                v * [0.30, 0.24, 0.18], f, n_views=views,
                                resolution=res, device=device)
        write_multisphere_key_points(os.path.join(tmp, "kp.json"), 18)
        base = [f"data.dataset_config.image_root={tmp}/img",
                f"data.batch_size={views}",
                f"geometry.key_points_file_path={tmp}/kp.json",
                f"geometry.tetwild_cache_folder={tmp}/cache"]
        return tetwild_phase(
            smi, tmp, _make_runner(smi, tmp, base, views, res, device),
            views, res, device)


def _bench_bins(dev):
    """K1's bins, resolution and face count of the bench scene's first 2
    views at 128² (a small input for the NaN trap's check)."""
    from tssplat_torch.ops.binning import bin_faces
    from tssplat_torch.ops.transform import transform_pos
    from tssplat_torch.tools.synthetic import bench_scene
    geo, batch = bench_scene(dev, 2, 128)
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[geo.statics.corner_vid])
    return (bin_faces(pos, geo.statics.edge_nbrs, (128, 128)), (128, 128),
            int(geo.statics.edge_nbrs.shape[0]))


def _falls(logged):
    """The mean of the last four logged losses below that of the first
    four."""
    first = [x for _, x in logged[:4]]
    last = [x for _, x in logged[-4:]]
    return sum(last) / len(last) < sum(first) / len(first)


def texture_phase(smi, tmp, run, geo_dir, views, device=None):
    """Phase 11 (see the module docstring): the texture stage on the
    geometry of ``geo_dir`` through ``run`` (driver_phase's main() runner);
    returns the launch counts of (a)."""
    import numpy as np
    from PIL import Image
    from tssplat_torch.data import MitsubaImgDataLoader
    from tssplat_torch.geometry import TetMeshMultiSphereGeometry
    from tssplat_torch.materials import ExplicitMaterial
    from tssplat_torch.materials.exact_stage import (
        build_texture_exact_cache, build_texture_exact_loss)
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.tools.synthetic import write_synthetic_dataset
    import tssplat_torch.train as tt

    vis_kernels = ("visibility", "visibility_capped_ids")
    tex = ["fitting_stage=texture", "material_type=ExplicitMaterial",
           f"geometry.initial_mesh_path={geo_dir}", "log_every=1",
           "export_every=12", "checkpoint_every=12"]
    make_step = tt.make_train_step

    def timed(label, iters, want_line, steps_launch, *over):
        """run() with every step synchronised and timed, and the launches
        inside the steps counted apart: ``steps_launch`` in each step."""
        step_ms, in_steps = [], []

        def spy(*args, **kw):
            step = make_step(*args, **kw)

            def timed_step(state, batch, it):
                torch.cuda.synchronize()
                before = rk.launch_counts()
                t0 = time.perf_counter()
                out = step(state, batch, it)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                after = rk.launch_counts()
                in_steps.append({k: after[k] - before[k] for k in after
                                 if after[k] != before[k]})
                return out
            return timed_step

        tt.make_train_step = spy
        try:
            t0 = time.perf_counter()
            logged, out, text = run(label, iters, None, *tex, *over)
            secs = time.perf_counter() - t0
        finally:
            tt.make_train_step = make_step
        counts = rk.launch_counts()
        med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        print(f"[texture] {label}: step {med:.2f} ms (median of "
              f"{len(step_ms) - 1} synchronised steps after the first, "
              f"first {step_ms[0]:.1f} ms); launches inside a step "
              f"{in_steps[-1]}; all launches {counts}; {secs:.1f} s; on "
              f"{smi}", flush=True)
        require(want_line in text, f"{label}: no '{want_line}' line")
        require(all(n == steps_launch for n in in_steps),
                f"{label}: launches inside the steps {in_steps}, expected "
                f"{steps_launch} in each")
        require(_falls(logged), f"{label}: img_loss did not fall {logged}")
        return counts, out, text

    # (a) the exact path: K8 (the colour antialias's rows) in each step
    counts, out, text = timed("tex_a_exact", 24, "exact texture fast path",
                              {"winner_rows": 1})
    n_vis = sum(counts[k] for k in vis_kernels)
    require(n_vis == views + 1, f"(a): {n_vis} visibility launches, "
            f"expected {views} (the cache) + 1 (the UV bake)")
    # the cache and the bake shade their winners and interpolate the
    # positions once a render
    want = dict(shade=views + 1, interp=views + 1, winner_rows=24)
    require(all(counts[k] == want.get(k, 0) for k in counts
                if k not in vis_kernels), f"(a): launches {counts}, "
            f"expected {want} besides the visibility")
    mat_dir = f"{out}/final/material"
    have = set(os.listdir(mat_dir))
    need = {"material.npz", "texture_kd.png", "mesh.obj", "material.mtl"}
    require(need <= have, f"(a): final/material lacks {need - have}")
    img = np.asarray(Image.open(f"{mat_dir}/texture_kd.png"))
    grey = float(np.mean(np.all(img == 128, axis=-1)))
    require(img.shape[:2] == (1024, 1024) and grey < 0.5
            and img.std() > 1.0, f"(a): texture flat (grey {grey})")
    print(f"[texture] (a) {sorted(have)} written; texture 1024², "
          f"{grey:.3f} of its texels 128-grey, std {img.std():.2f}",
          flush=True)

    # (b) the sampled path, cached
    _, _, text = timed("tex_b_sampled", 24, "texture cache:", {},
                       "texture_sample_px=4096")
    require("exact texture" not in text, "(b): took the exact path")

    # (c) the card against the CPU, 2 views of 128²
    v, f = icosphere(subdivisions=3)
    write_synthetic_dataset(f"{tmp}/img128", v * [0.30, 0.24, 0.18], f,
                            n_views=2, resolution=128, device=device)
    ref = {}
    for d in (device or "cuda", "cpu"):
        geo = TetMeshMultiSphereGeometry(dict(
            initial_mesh_path=geo_dir, use_smooth_barrier=False,
            output_path=f"{tmp}/ref"), device=d)
        loader = MitsubaImgDataLoader(dict(
            dataset_config=dict(image_root=f"{tmp}/img128"), batch_size=2,
            total_num_iter=1), device=d)
        mat = ExplicitMaterial(None, device=d)
        cache = build_texture_exact_cache(geo, mat, loader.data_all, 128)
        exact = build_texture_exact_loss(mat, geo.statics, cache)
        p = {k: {n: x.detach().requires_grad_(True) for n, x in g.items()}
             for k, g in mat.params.items()}
        le = exact(p, 3)[0] * 100.0
        ge = torch.autograd.grad(le, [p["encoding"]["table"],
                                      *p["network"].values()])
        batch = {k: x for k, x in loader(0, 0).items()
                 if k not in ("resolution", "spp")}
        ld, _, _, _, gd = tt.loss_and_grad(
            geo.statics, geo.tet_v, batch, 3, 128,
            material_fn=mat.apply_fn, mat_params=mat.params)
        ref[d] = [(float(le.detach()), [g.cpu() for g in ge]),
                  (float(ld), [gd["encoding"]["table"].cpu(),
                               *(g.cpu() for g in gd["network"].values())])]
    for i, label in enumerate(("exact", "dense")):
        (l_g, g_g), (l_c, g_c) = ref[device or "cuda"][i], ref["cpu"][i]
        require(abs(l_g - l_c) <= 1e-5 * abs(l_c),
                f"(c) {label}: loss {l_g} vs CPU {l_c}")
        errs = []
        for j, (a, b) in enumerate(zip(g_g, g_c)):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            require(err <= (1e-3 if j == 0 else 1e-4) * scale,
                    f"(c) {label}: gradient {j} err {err} of max {scale}")
            errs.append(err / scale)
        print(f"[texture] (c) {label} step on 2x128², card vs CPU: loss "
              f"{l_g:.7f} (CPU {l_c:.7f}); gradient errors over their max "
              f"{[f'{e:.2g}' for e in errs]} (table first)", flush=True)
    return counts


DUMBBELL_SPHERES = ((-0.45, 0.0, 0.0), (0.45, 0.0, 0.0))


def _dumbbell():
    """tests/test_init_spheres.py's non-convex object: two icosphere(3)
    balls of radius 0.3 at x = -0.45 and 0.45."""
    import numpy as np
    from tssplat_torch.mesh.spheres import icosphere

    sv, sf = icosphere(subdivisions=3)
    v = np.concatenate([sv * 0.3 + c for c in DUMBBELL_SPHERES])
    return v, np.concatenate([sf, sf + sv.shape[0]])


def _read_views(path, n):
    """(alpha > 0.5, depth, normal) of a dataset directory's n views."""
    import numpy as np
    from PIL import Image

    a = np.stack([np.asarray(Image.open(f"{path}/img_rgba_{i}.png"))[..., 3]
                  for i in range(n)]) > 127
    d = np.stack([np.load(f"{path}/depth_{i}.npy") for i in range(n)])
    nrm = np.stack([np.load(f"{path}/normal_{i}.npy")[..., :3]
                    for i in range(n)])
    return a, d, nrm


def pipeline_phase(smi, views=120, res=512, surf_res=50, num_iter=50,
                   grid_dim=64, device=None):
    """Phase 12: a new object from its images to key points, a fit with a
    remesh, and the metrics, each step reading the one before it:
    (a) the dumbbell ray-traced by tools/raytrace.py's main at its defaults
    (120 views of 512², spp 4, lambert) and held against the rasterized
    dataset of the same views (tests/test_raytrace.py's bars); (b)
    tools/init_spheres.py's main on (a) at its defaults (surf_res 50,
    num_iter 50); (c) gso.yaml through tssplat_torch.train.main on (a) and
    (b)'s key points for 24 iterations with remesh_every=12; (d) the
    metrics of (c)'s final surface against the dumbbell; (e) the queries,
    one skeleton step and a remesh on the card against the CPU. The
    arguments are the CLIs' and train()'s defaults (and gso.yaml's batch);
    smaller ones rehearse the phase. Returns the launches of each kernel
    in iteration 11 and in iteration 23."""
    import numpy as np
    from scipy.ndimage import binary_dilation, binary_erosion
    from tssplat_torch.geometry import TetMeshMultiSphereGeometry
    import tssplat_torch.mesh.remesh as remesh_mod
    from tssplat_torch.mesh.io import load_obj, save_obj
    from tssplat_torch.mesh.tetmesh import TetMesh
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.tools import init_spheres, metrics, raytrace
    from tssplat_torch.tools.synthetic import write_synthetic_dataset
    import tssplat_torch.train as tt

    gso = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "gso.yaml")
    v, f = _dumbbell()
    with tempfile.TemporaryDirectory(prefix="tss_pipeline_") as tmp:
        # (a) the ray-traced dataset against the rasterized one
        save_obj(f"{tmp}/dumbbell.obj", v, f)
        t0 = time.perf_counter()
        raytrace.main(["--mesh", f"{tmp}/dumbbell.obj", "--save_path",
                       f"{tmp}/rt", "--num_views", str(views),
                       "--resolution", str(res)], device=device)
        rt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_synthetic_dataset(f"{tmp}/rs", v, f, n_views=views,
                                resolution=res, device=device)
        rs_s = time.perf_counter() - t0
        a_rt, d_rt, n_rt = _read_views(f"{tmp}/rt", views)
        a_rs, d_rs, n_rs = _read_views(f"{tmp}/rs", views)
        iou = (a_rt & a_rs).sum() / max((a_rt | a_rs).sum(), 1)
        box = np.ones((1, 3, 3), bool)
        away = binary_erosion(a_rs, box) | ~binary_dilation(a_rs, box)
        off = np.argwhere((a_rt != a_rs) & away)
        off_ring = off.shape[0]
        for b, y, x in off[:8]:
            print(f"[pipeline] (a) off the ring: view {b} row {y} col {x}: "
                  f"ray-traced alpha > 0.5 {bool(a_rt[b, y, x])}, depth "
                  f"{d_rt[b, y, x]:.6f}; rasterized {bool(a_rs[b, y, x])}, "
                  f"depth {d_rs[b, y, x]:.6f}", flush=True)
        both = a_rt & a_rs
        d_err = float(np.median(np.abs(d_rt - d_rs)[both]))
        n_dot = float(np.median(np.sum(n_rt * n_rs, axis=-1)[both]))
        print(f"[pipeline] (a) ray-traced {views} views of {res}² (spp 4, "
              f"lambert) in {rt_s:.1f} s, rasterized in {rs_s:.1f} s; "
              f"alpha IoU {iou:.5f}, {off_ring} differing px off the "
              f"silhouette ring, median |depth diff| {d_err:.2e}, median "
              f"normal dot {n_dot:.6f}", flush=True)
        # tests/test_raytrace.py's bars; a pixel may differ off the
        # rasterized silhouette's ring where two silhouette edges pass
        # within a pixel (the gap between the balls seen nearly end on:
        # area sampling sees it, the analytic blend fills it): 2 such
        # pixels of 31.5 M in every run so far, at most 4 allowed
        require(iou > 0.95 and off_ring <= 4
                and d_err < 5e-3 and n_dot > 0.99,
                "(a): the ray tracer disagrees with the rasterizer")
        del a_rt, d_rt, n_rt, a_rs, d_rs, n_rs, away, both

        # (b) key points from (a)'s images
        t0 = time.perf_counter()
        pts, radii = init_spheres.main(
            ["--img_path", f"{tmp}/rt", "--expr_name", "dumbbell",
             "--save_path", f"{tmp}/kp", "--surf_res", str(surf_res),
             "--num_iter", str(num_iter)], device=device)
        print(f"[pipeline] (b) {pts.shape[0]} spheres in "
              f"{time.perf_counter() - t0:.1f} s, radii "
              f"{radii.min():.4f}-{radii.max():.4f}", flush=True)
        require(pts.shape[0] >= 2 and (pts[:, 0] < 0).any()
                and (pts[:, 0] > 0).any() and (radii > 0).all(),
                f"(b): spheres {pts.tolist()} radii {radii.tolist()}")

        # (c) gso.yaml on (a) and (b), remeshed at iteration 12
        out = f"{tmp}/fit"
        argv = ["--config", gso, f"data.dataset_config.image_root={tmp}/rt",
                f"geometry.key_points_file_path={tmp}/kp/dumbbell.json",
                f"geometry.tetwild_cache_folder={tmp}/cache",
                f"output_path={out}", f"data.batch_size={views}",
                "data.total_num_iter=24",
                "remesh_every=12", f"remesh_grid_dim={grid_dim}",
                "log_every=1", "export_every=12"]
        per_step, timing = [], {"sd": 0.0, "repair": 0.0, "remesh": 0.0}
        make_step = tt.make_train_step
        remesh = TetMeshMultiSphereGeometry.remesh
        sd, repair = remesh_mod._sd, remesh_mod.repair_sliver_tets

        def timed(key, fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = fn(*args, **kw)
                torch.cuda.synchronize()
                timing[key] += time.perf_counter() - t
                return res
            return run

        chunks = {}

        def spy(*args, **kw):
            step = make_step(*args, **kw)

            def counted(state, batch, it):
                if it in (11, 12):          # the last step before, the first after
                    # a chunk of the step's views, or all where it has none
                    vc = kw["view_chunk"] or batch["mvp"].shape[0]
                    chunks[it] = (args[0], state.params.detach().clone(),
                                  batch["mvp"][:vc].clone(), kw["tile_k"])
                before = rk.launch_counts()
                res = step(state, batch, it)
                after = rk.launch_counts()
                per_step.append({k: after[k] - before[k] for k in after})
                return res
            return counted

        def remesh_spy(self, *args, **kw):
            timing["before"] = (self.tetmesh.num_vertices,
                                self.tetmesh.num_tets, self.num_spheres)
            return timed("remesh", remesh)(self, *args, **kw)

        tt.make_train_step = spy
        TetMeshMultiSphereGeometry.remesh = remesh_spy
        remesh_mod._sd = timed("sd", sd)
        remesh_mod.repair_sliver_tets = timed("repair", repair)
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                state, geo = tt.main(argv, device=device)
        finally:
            tt.make_train_step = make_step
            TetMeshMultiSphereGeometry.remesh = remesh
            remesh_mod._sd, remesh_mod.repair_sliver_tets = sd, repair
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = rk.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        text = "".join(tee.text)
        logged = [float(x) for _, x in re.findall(
            r"iter=\s*(\d+), img_loss=([0-9.]+)", text)]
        ips = float(re.search(r"iters/sec: ([0-9.]+)", text).group(1))
        found = re.findall(r"remeshed at iter (\d+): (\d+) verts / (\d+) "
                           r"tets", text)
        require(len(found) == 1 and found[0][0] == "12",
                f"(c): remesh lines {found}")
        require("WARNING" not in text, f"(c): a warning: {text}")
        require(len(logged) == 24 and all(math.isfinite(x) for x in logged)
                and bool(torch.isfinite(state.params).all()),
                f"(c): losses {logged}")
        require(logged[11] < logged[0] and logged[23] < logged[12],
                f"(c): img_loss did not fall in a segment {logged}")
        require(len(per_step) == 24, f"(c): {len(per_step)} steps")
        require(all(c == per_step[0] for c in per_step[:12])
                and all(c == per_step[12] for c in per_step[12:]),
                f"(c): launches vary within a segment {per_step}")
        require(sum(counts.values()) == sum(sum(c.values())
                                            for c in per_step),
                f"(c): launches outside the steps {counts}")
        vis = [k for k in ("visibility", "visibility_capped")
               if per_step[13][k]]
        vis_before = [k for k in ("visibility", "visibility_capped")
                      if per_step[11][k]]
        require(len(vis) == 1 and len(vis_before) == 1,
                f"(c): visibility launches {per_step[11]} {per_step[13]}")
        # the final export: every tet in one sphere's list, the per-sphere
        # npy the snapshot's rows of the index JSONs
        snap = TetMesh.from_veg(f"{out}/final/final.veg")
        with open(f"{out}/final/spheres_vtx_idx.json") as fh:
            vtx_idx = json.load(fh)
        rebuilt = []
        for i, vid in enumerate(vtx_idx):
            vid = np.asarray(vid, np.int64)
            vtx = np.load(f"{out}/final/final_sp{i}_vtx.npy")
            elem = np.load(f"{out}/final/final_sp{i}_elem.npy")
            require(vtx.shape == (vid.size, 3) and np.allclose(
                vtx, snap.vtx[vid], atol=1e-6), f"(c): sphere {i}'s npy")
            if elem.size:
                rebuilt.append(vid[elem.reshape(-1, 4)])
        rebuilt = np.sort(np.sort(np.concatenate(rebuilt), 1), 0)
        require(np.array_equal(rebuilt, np.sort(np.sort(snap.elem, 1), 0)),
                "(c): the final tets are not partitioned by the spheres")
        for it, label in ((11, "before"), (12, "after")):
            st_it, p_it, mvp_it, k_it = chunks[it]
            _check_chunk(f"(c) iteration {it}, {label} the remesh", st_it,
                         p_it, mvp_it, res, k_it)
        del chunks
        print(f"[pipeline] (c) gso.yaml, {timing['before'][2]} spheres, 24 "
              f"iterations at {views}x{res}^2, remeshed at iteration 12: "
              f"{found[0][1]} verts / {found[0][2]} tets (before: "
              f"{timing['before'][0]} / {timing['before'][1]}); remesh "
              f"{timing['remesh']:.2f} "
              f"s (distance queries {timing['sd']:.2f} s, sliver repair "
              f"{timing['repair']:.2f} s); visibility {'/'.join(vis_before)}"
              f" before, {'/'.join(vis)} after; launches an iteration before "
              f"{json.dumps(per_step[11])} after {json.dumps(per_step[13])}"
              f"; img_loss {logged[0]} -> {logged[11]} | {logged[12]} -> "
              f"{logged[23]}; {ips:.3f} it/s (the driver's count); peak "
              f"{peak:.2f} GiB; {secs:.1f} s; on {smi}", flush=True)

        # (d) the metrics of the fit against the dumbbell
        fv, ff = load_obj(f"{out}/final/final_surface_mesh.obj")
        got = {}
        for name, fn in (("mesh_chamfer", metrics.mesh_chamfer),
                         ("volume_iou", metrics.volume_iou),
                         ("silhouette_iou", metrics.silhouette_iou)):
            t0 = time.perf_counter()
            got[name] = fn(fv, ff, v, f, device=device)
            got[name + "_s"] = time.perf_counter() - t0
        print(f"[pipeline] (d) final surface ({fv.shape[0]} verts, "
              f"{ff.shape[0]} faces) against the dumbbell: "
              + ", ".join(f"{k} {x:.5f}" for k, x in got.items()),
              flush=True)
        shape = _surface_report(fv, ff, v, f, device)
        # the fit starts from (b)'s balls of radius 0.39 about the
        # dumbbell's of 0.3 and 24 iterations barely move them: a volume
        # IoU near (0.3 / 0.39)^3 = 0.455 by the winding number and a
        # silhouette IoU near (0.3 / 0.39)^2 = 0.59. volume_iou's
        # nearest-face sign misfires on the remeshed surface, far from it
        # too (the cells where it and the winding number disagree): 0.248
        # in every run so far, at least 0.2 allowed
        require(0 <= got["mesh_chamfer"] < 0.05
                and 0.35 < shape["winding_iou"] <= 1
                and 0.2 < got["volume_iou"] <= 1
                and 0.5 < got["silhouette_iou"] <= 1,
                f"(d): {got} {shape}")
    _card_vs_cpu_queries(device)
    return per_step[11], per_step[23]


def _check_chunk(label, statics, tet_v, mvp, res, tile_k, shaded=False,
                 is_ortho=False, tag="pipeline"):
    """The kernels of one view chunk of a driver step, on that step's
    inputs (its statics, params, views and tile capacity, binned as the
    step bins them): K1 or K2b as the layout falls, then K4 and K5 on its
    outputs under a seeded cotangent and K3 on K5's d g6, each against its
    plain version: K2b's ids, z (to the bit), rows and gaux equal; K1's ids
    and gaux equal and its z and rows within 1e-6 (phase 3); K4 and K5
    equal by value; K3 within 1e-5 of its rows' sums of |ct|. With
    ``shaded`` (the path of fit_normal / fit_depth) the visibility is K2a
    or K1 without rows (ids equal; K2a's z to the bit, K1's within 1e-6)
    and K4, K5 and K3 run on the shaded winners' rows (antialias_rows)."""
    from tssplat_torch.ops import raster_kernels as rk
    from tssplat_torch.ops.binning import (bin_faces, bin_faces_capped,
                                           capacity, uses_capped_layout)
    from tssplat_torch.ops.rasterize import (antialias_rows, rasterize,
                                             screen_xy_table)
    from tssplat_torch.ops.transform import transform_pos
    from tssplat_torch.tools.wsr_cases import rows_agree

    rr = (res, res)
    B, F = mvp.shape[0], int(statics.edge_nbrs.shape[0])
    with torch.no_grad():
        pos = transform_pos(mvp, tet_v[statics.corner_vid],
                            is_ortho=is_ortho)
    if shaded:
        if uses_capped_layout(F, 11, B, res, res):
            name = "K2a"
            bins = bin_faces_capped(pos, None, rr, capacity(tile_k, F, rr))
            vis, want = rk.visibility_capped_ids(bins, rr), \
                rk.visibility_capped_ids_plain(bins, rr)
            ok = torch.equal(vis[1].view(torch.int32),
                             want[1].view(torch.int32))
        else:
            name = "K1 (no rows)"
            bins = bin_faces(pos, None, rr)
            vis, want = rk.visibility(bins, rr, emit_g=False), \
                rk.visibility_plain(bins, rr, emit_g=False)
            ok = max_err(vis[1:], want[1:]) <= 1e-6
        require(torch.equal(vis[0], want[0]) and ok,
                f"{label}: {name} differs from plain")
        with torch.no_grad():
            rast, _ = rasterize(pos, rr, vis=(vis[0], bins.n_drop))
            got = antialias_rows(rast, screen_xy_table(pos, F),
                                 statics.edge_nbrs)
    elif uses_capped_layout(F, 14, B, res, res):
        name = "K2b"
        bins = bin_faces_capped(pos, statics.edge_nbrs, rr,
                                capacity(tile_k, F, rr))
        got, want = rk.visibility_capped(bins, rr), \
            rk.visibility_capped_plain(bins, rr)
        require(torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32))
                and all(torch.equal(a, b) for a, b in zip(got, want)),
                f"{label}: K2b differs from the walk")
    else:
        name = "K1"
        bins = bin_faces(pos, statics.edge_nbrs, rr)
        got, want = rk.visibility(bins, rr), rk.visibility_plain(bins, rr)
        require(torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
                and max_err(got, want) <= 1e-6,
                f"{label}: K1 differs from plain")
    require(int(bins.n_drop.sum()) == 0, f"{label}: n_drop {bins.n_drop}")
    ct = torch.randn((B, res, res), device=mvp.device,
                     generator=torch.Generator(device=mvp.device).manual_seed(0))
    fwd, dg6 = rk.aa_forward(*got), rk.aa_backward(*got, ct)
    require(torch.equal(fwd, rk.aa_forward_plain(*got))
            and torch.equal(dg6, rk.aa_backward_plain(*got, ct)),
            f"{label}: K4 or K5 differs from plain")
    k3_err = rows_agree(rk.wsr_table_grad(got[0], dg6, F), got[0], dg6, F)
    print(f"[{tag}] {label}: {B} views, {F} faces, {name} "
          f"(max err {max_err(vis if shaded else got, want):.3g}), K4 and "
          f"K5 equal to plain, "
          f"K3 max err {k3_err:.3g}; {int((got[0] > 0).sum())} foreground "
          f"px", flush=True)


def _winding_occupancy(points, verts, faces, chunk=256):
    """Inside (winding number > 0.5) of points (P,3) against a triangle
    mesh, in f64 on the points' device: the sum of the triangles' solid
    angles (Van Oosterom and Strackee), which no vertex or edge tie
    changes."""
    tri = verts.double()[faces]                                  # (F,3,3)
    out = torch.empty(points.shape[0], dtype=torch.bool,
                      device=points.device)
    for s in range(0, points.shape[0], chunk):
        d = tri[None] - points[s:s + chunk, None, None].double()
        a, b, c = d.unbind(2)
        la, lb, lc = a.norm(dim=-1), b.norm(dim=-1), c.norm(dim=-1)
        det = (a * torch.linalg.cross(b, c)).sum(-1)
        den = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
               + (c * a).sum(-1) * lb)
        out[s:s + chunk] = torch.atan2(det, den).sum(1) > math.pi
    return out


def _surface_report(fv, ff, v, f, device=None):
    """What volume_iou's value rests on, for a fit's surface (fv, ff)
    against the reference (v, f): the surface's edge-connected components
    and those of negative volume (closed pockets), its edges with other
    than two faces, volume_iou of the components of positive volume
    alone (the outer shell), and on volume_iou's own grid the occupancy
    IoU by the winding number and the share of the cells of the union
    where the nearest face's sign (volume_iou's test) disagrees with the
    winding number, with their median distance to the surface."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from tssplat_torch.ops.queries import signed_distance
    from tssplat_torch.tools import metrics

    dev = torch.device(device or "cuda")
    ff = np.asarray(ff, np.int64)
    e = np.sort(np.concatenate([ff[:, [0, 1]], ff[:, [1, 2]],
                                ff[:, [2, 0]]]), axis=1)
    edges, inv, per_edge = np.unique(e, axis=0, return_inverse=True,
                                     return_counts=True)
    fid = np.tile(np.arange(ff.shape[0]), 3)
    inc = coo_matrix((np.ones(fid.size), (fid, inv.reshape(-1))),
                     shape=(ff.shape[0], edges.shape[0])).tocsr()
    n_comp, comp = connected_components(inc @ inc.T, directed=False)
    p = np.asarray(fv, np.float64)[ff]
    vol = np.bincount(comp, weights=np.einsum(
        "ij,ij->i", p[:, 0], np.cross(p[:, 1], p[:, 2])) / 6.0,
        minlength=n_comp)
    shell = vol[comp] > 0
    out = {"components": int(n_comp), "pockets": int((vol < 0).sum()),
           "non_manifold_edges": int((per_edge != 2).sum()),
           "shell_volume_iou": metrics.volume_iou(fv, ff[shell], v, f,
                                                  device=dev)}
    # volume_iou's grid (tools/metrics.py), both occupancies of both meshes
    bound = 1.05 * max(np.abs(fv).max(), np.abs(v).max())
    lin = np.linspace(-bound, bound, 64).astype(np.float32)
    g = torch.as_tensor(np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                                 -1).reshape(-1, 3), device=dev)
    occ = {}
    for name, (mv, mf) in (("fit", (fv, ff)), ("ref", (v, f))):
        tv = torch.as_tensor(np.asarray(mv), dtype=torch.float32, device=dev)
        tf = torch.as_tensor(np.asarray(mf), dtype=torch.int64, device=dev)
        sd = signed_distance(g, tv, tf)
        occ[name] = (sd < 0, _winding_occupancy(g, tv, tf), sd)
    (s_fit, w_fit, sd_fit), (s_ref, w_ref, _) = occ["fit"], occ["ref"]
    union = int((w_fit | w_ref).sum())
    miss = s_fit != w_fit
    out.update(
        winding_iou=int((w_fit & w_ref).sum()) / max(union, 1),
        misfired_share=int(miss.sum()) / max(union, 1),
        misfired_cells=int(miss.sum()),
        misfired_median_distance=float(sd_fit[miss].abs().median())
        if bool(miss.any()) else 0.0,
        reference_misfired_cells=int((s_ref != w_ref).sum()))
    print("[pipeline] (d) the fit's surface: " + ", ".join(
        f"{k} {x:.5g}" if isinstance(x, float) else f"{k} {x}"
        for k, x in out.items()), flush=True)
    return out


def _card_vs_cpu_queries(device=None):
    """Phase 12 (e): ray_mesh_hit_full, signed_distance, one
    smoothed_sdf_grad step and tet_remesh_from_surface on the card against
    the CPU, with the tolerances the CPU tests hold them to against JAX."""
    import numpy as np
    from tssplat_torch.mesh.remesh import tet_remesh_from_surface
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.ops.queries import ray_mesh_hit_full, signed_distance
    from tssplat_torch.tools.init_spheres import smoothed_sdf_grad

    dev = device or "cuda"
    t0 = time.perf_counter()
    v, f = _dumbbell()
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.8, 0.8, size=(20000, 3)).astype(np.float32)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rng.uniform(-0.9, 0.9, size=(20000, 3)).astype(np.float32)
    noise = np.clip(0.003 * rng.standard_normal((2000, 20, 3)), None,
                    0.01).astype(np.float32)
    out = {}
    for where in (dev, "cpu"):
        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=where)
        vt, ft = t(v), t(f, torch.int64)
        hits = [x.cpu().numpy() for x in ray_mesh_hit_full(t(o), t(d), vt,
                                                           ft)]
        sdv = signed_distance(t(p), vt, ft).cpu().numpy()
        grad = smoothed_sdf_grad(t(p[:2000] * 0.5), t(noise), vt, ft) \
            .cpu().numpy()
        sv, sf = icosphere(subdivisions=3)
        sv = sv * 0.4
        cap = sv[:, 2] > 0.28
        sv[cap] -= np.asarray([0, 0, 0.25]) * (sv[cap, 2:3] / 0.4)
        rm = tet_remesh_from_surface(sv, sf, 0.15, grid_dim=20, device=where)
        out[where] = (hits, sdv, grad, rm)
    (hg, sg, gg, rg), (hc, sc, gc, rc) = out[dev], out["cpu"]
    hit = np.isfinite(hg[0]) & np.isfinite(hc[0])
    flips = int((np.isfinite(hg[0]) != np.isfinite(hc[0])).sum())
    require(flips <= 2e-4 * o.shape[0], f"(e): {flips} hit/miss flips")
    require(np.allclose(hg[0][hit], hc[0][hit], rtol=1e-5, atol=0),
            "(e): ray t differs")
    id_differ = int((hit & (hg[1] != hc[1])).sum())
    require(id_differ <= 2e-4 * o.shape[0], f"(e): {id_differ} ids differ")
    require(np.allclose(np.abs(sg), np.abs(sc), rtol=0, atol=1e-5),
            "(e): |signed distance| differs")
    sign_flips = int(((np.sign(sg) != np.sign(sc)) & (np.abs(sc) > 1e-4))
                     .sum())
    require(sign_flips <= 1e-3 * p.shape[0], f"(e): {sign_flips} signs")
    gscale = float(np.abs(gc).max())
    gerr = float(np.abs(gg - gc).max())
    require(gerr <= 1e-4 * gscale, f"(e): skeleton gradient err {gerr}")
    require(abs(rg[0].shape[0] - rc[0].shape[0]) <= 0.02 * rc[0].shape[0]
            and abs(rg[1].shape[0] - rc[1].shape[0])
            <= 0.02 * rc[1].shape[0], "(e): remesh counts differ")
    same = (np.array_equal(hg[0], hc[0]), np.array_equal(sg, sc),
            np.array_equal(rg[1], rc[1]))
    print(f"[pipeline] (e) card against CPU: {int(hit.sum())} hits, "
          f"{flips} hit/miss flips, {id_differ} ids differ, t max rel err "
          f"{float(np.max(np.abs(hg[0][hit] - hc[0][hit]) / hc[0][hit])):.2e}"
          f"; |sd| max err {float(np.abs(np.abs(sg) - np.abs(sc)).max()):.2e}"
          f", {sign_flips} sign flips; skeleton gradient err {gerr:.2e} of "
          f"{gscale:.3g}; remesh {rg[0].shape[0]} / {rg[1].shape[0]} (CPU "
          f"{rc[0].shape[0]} / {rc[1].shape[0]}); bit-equal (t, sd, tets) "
          f"{same}; {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
