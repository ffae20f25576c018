"""The port's benchmark: optimization steps a second of the train step,
the counterpart of the repository's ``bench.py`` under its metric names.

    python -m tssplat_torch.bench                    # geometry, 8 x 512²
    BENCH_SPHERES=18 python -m tssplat_torch.bench   # the 18-sphere scene
    BENCH_STAGE=texture [BENCH_TEX_SAMPLE=4096] python -m tssplat_torch.bench
    BENCH_SCALING=1 python -m tssplat_torch.bench    # weak scaling
    BENCH_SMOKE=1 python -m tssplat_torch.bench      # kernels vs plain

Each mode prints ONE JSON line on stdout, {"metric", "value", "unit",
"vs_baseline"} (``vs_baseline`` null), and its diagnostics on stderr.

The default mode (``main``) times the geometry stage's step (render ->
silhouette loss -> backward -> AdamUniform update, ``train.py
make_train_step``) on bench.py's scene (``tools/synthetic.py
bench_scene``): one TetSphere ``tet_sphere(0.03, radius=0.25)``, or
BENCH_SPHERES > 1 spheres of the multi-sphere geometry, fitted to the
ellipsoid ``icosphere(3) * (0.30, 0.24, 0.18)`` seen from BENCH_VIEWS
views of BENCH_RES². BENCH_STAGE=texture times the texture stage instead
(``ExplicitMaterial`` on the frozen geometry, against the ellipsoid's
shaded RGB): the exact path, or with BENCH_TEX_SAMPLE=N the sampled path
(cached unless BENCH_TEX_CACHE=0; BENCH_TEX_STOCH=1 the stochastic table
gradient), or with BENCH_TEX_DENSE=1 the dense path. 3 warm-up steps, then
BENCH_ITERS steps timed on the host clock with the host read of the last
loss inside the window; the rate is checked against what the card could
give (``_plausibility_guard``) before it is printed.

Knobs (bench.py's names and defaults): BENCH_VIEWS 8, BENCH_RES 512,
BENCH_ITERS 20, BENCH_STAGE geometry|texture, BENCH_SPHERES 1,
BENCH_VIEW_CHUNK auto (``train.py _auto_view_chunk``) or a number,
BENCH_TEX_SAMPLE 0, BENCH_TEX_STOCH 0, BENCH_TEX_CACHE 1, BENCH_TEX_DENSE
0; for ``scaling`` BENCH_RES 256, BENCH_VIEWS_PER_DEV 2, BENCH_ITERS 10.

Runs on the card; without one it raises (``device="cpu"`` runs the plain
versions, as the tests do).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from .device import DeviceLike, resolve_device
from .materials import ExplicitMaterial
from .materials.exact_stage import (build_texture_exact_cache,
                                    build_texture_exact_loss)
from .ops import raster_kernels as rk
from .ops.binning import capacity
from .optim import adam_uniform, cosine_annealing_lr
from .parallel.mesh import MEAN, shard_batch
from .tools.synthetic import bench_scene
from .tools.timing import H100_BYTES_PER_S
from .train import (TrainState, _auto_view_chunk, build_texture_sample_cache,
                    init_train_state, make_train_step)
from .utils.env import get_rank, get_world_size, rank_device

# bytes of visibility output a pixel (ops/raster_kernels.py visibility):
# ids int32, z f32, the winner's 6 screen rows f32 and 4 aux f32
VIS_BYTES_PER_PX = 4 + 4 + 6 * 4 + 4 * 4
WARM = 3


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _plausibility_guard(ips: float, n_views: int, res: int) -> None:
    """Reject a rate that no H100 can give, loudly, before anything is
    recorded. Every step writes the visibility output of every pixel
    (VIS_BYTES_PER_PX = 48 B: ids, z and the winner rows) and reads it
    back at least once; at ``ips`` steps a second that traffic alone must
    fit the card's HBM peak (tools/timing.py H100_BYTES_PER_S, 3.35 TB/s).
    The cap is 16,640 it/s at 8 x 512² and 1,109 it/s at 120 x 512²; an
    honest step moves far more than these bytes, so a rate near the cap is
    a timing fault (a window that ended before the device did)."""
    vis_bytes = 2 * n_views * res * res * VIS_BYTES_PER_PX
    implied = ips * vis_bytes
    if implied > H100_BYTES_PER_S:
        raise SystemExit(
            f"BENCH REJECTED: {ips:.1f} it/s at {n_views}x{res}^2 implies "
            f"{implied / 1e12:.2f} TB/s of visibility output alone (written "
            f"and read once, {VIS_BYTES_PER_PX} B a pixel) > the H100's "
            f"{H100_BYTES_PER_S / 1e12:.2f} TB/s: a timing artifact (the "
            f"window ended before the device did?); no JSON recorded.")


@dataclass(frozen=True)
class Knobs:
    """bench.py's environment knobs (see the module docstring)."""
    views: int = 8
    res: int = 512
    iters: int = 20
    stage: str = "geometry"
    spheres: int = 1
    view_chunk: str = "auto"
    tex_sample: int = 0
    tex_stoch: bool = False
    tex_cache: bool = True
    tex_dense: bool = False

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ
        k = cls(views=int(env.get("BENCH_VIEWS", 8)),
                res=int(env.get("BENCH_RES", 512)),
                iters=int(env.get("BENCH_ITERS", 20)),
                stage=env.get("BENCH_STAGE", "geometry"),
                spheres=int(env.get("BENCH_SPHERES", 1)),
                view_chunk=env.get("BENCH_VIEW_CHUNK", "auto"),
                tex_sample=int(env.get("BENCH_TEX_SAMPLE", 0)),
                tex_stoch=bool(int(env.get("BENCH_TEX_STOCH", 0))),
                tex_cache=bool(int(env.get("BENCH_TEX_CACHE", 1))),
                tex_dense=bool(int(env.get("BENCH_TEX_DENSE", 0))))
        if k.stage not in ("geometry", "texture"):
            raise SystemExit(f"BENCH_STAGE={k.stage!r}: geometry or texture")
        if k.views < 1 or k.res < 1 or k.iters < 1 or k.spheres < 1:
            raise SystemExit(f"bench knobs out of range: {k}")
        return k

    def metric(self) -> str:
        sph = f"_s{self.spheres}" if self.spheres > 1 else ""
        return (f"{self.stage}_train_iters_per_sec_b{self.views}_r{self.res}"
                f"{sph}")


class BenchRun(NamedTuple):
    step: Callable            # step(state, batch, it) -> (state, out)
    state: TrainState
    batch: dict


def _geometry_optimizer():
    """bench.py:109-111: AdamUniform, cosine LR 0.2 over 1500 steps, the
    gradient capped at 0.01."""
    return adam_uniform(cosine_annealing_lr(0.2, 1500), grad_limit=True,
                        grad_limit_values=(0.01, 0.01),
                        grad_limit_iters=(1500,))


def build(knobs: Knobs, device: DeviceLike = None) -> BenchRun:
    """The scene, the train step and its initial state that ``main``
    times, as ``bench.py:51-216`` builds them; the scene, the view chunk
    and the exact path's P are printed on stderr."""
    dev = resolve_device(device)
    geo, batch = bench_scene(dev, knobs.views, knobs.res,
                             n_spheres=knobs.spheres)
    _log(f"spheres={knobs.spheres}: {geo.tetmesh.num_vertices} verts, "
         f"{int(geo.statics.surface_fid.shape[0])} faces")
    init_fn, update_fn = _geometry_optimizer()
    # the capped layout's capacity the step takes (its default heuristic)
    k = capacity(None, int(geo.statics.surface_fid.shape[0]),
                 (knobs.res, knobs.res))
    view_chunk = (_auto_view_chunk(knobs.views, 1, knobs.res, tile_k=k,
                                   device=dev)
                  if knobs.view_chunk == "auto" else int(knobs.view_chunk))
    if view_chunk:
        _log(f"view_chunk={view_chunk}")
    params, kw = geo.tet_v, {}
    if knobs.stage == "texture":
        mat_cfg = {}
        if knobs.tex_stoch:       # the default grid, its stochastic gradient
            mat_cfg = {"pos_encoding_config": dict(
                ExplicitMaterial.Config().pos_encoding_config,
                stochastic_table_grad=True)}
        material = ExplicitMaterial(mat_cfg, device=dev)
        params = material.params
        init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.01, 1500))
        kw = dict(material_fn=material.apply_fn, tet_v_frozen=geo.tet_v,
                  texture_sample_px=knobs.tex_sample)
        if knobs.tex_sample and knobs.tex_cache:
            kw["texture_cache"] = build_texture_sample_cache(
                geo.statics, geo.tet_v, batch["mvp"], batch["img"],
                knobs.res)
            batch["view_idx"] = torch.arange(knobs.views, dtype=torch.int32,
                                             device=dev)
        if not knobs.tex_sample and not knobs.tex_dense:
            cache = build_texture_exact_cache(
                geo, material, {k: batch[k] for k in
                                ("mvp", "img", "background")}, knobs.res)
            if cache is not None:
                kw["texture_exact_loss"] = build_texture_exact_loss(
                    material, geo.statics, cache)
                _log(f"exact texture fast path: P={cache['P']}")
    step = make_train_step(geo.statics, update_fn, resolution=knobs.res,
                           view_chunk=view_chunk, **kw)
    return BenchRun(step, init_train_state(params, init_fn), batch)


def timed_window(step: Callable, state: TrainState, batch: dict,
                 iters: int, warm: int = WARM):
    """``warm`` steps read back on the host, then ``iters`` steps timed on
    the host clock; the host read of the last loss is inside the window
    (the steps chain through the state, so it waits for all of them).
    The launch counts are zeroed before the window. Returns (iters a
    second, the last step's loss and n_drop)."""
    for it in range(warm):
        state, out = step(state, batch, it)
    float(out[0])
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    for it in range(warm, warm + iters):
        state, out = step(state, batch, it)
    last = float(out[0])
    dt = time.perf_counter() - t0
    return iters / dt, last, int(out[3])


def _result_line(metric: str, value: float, unit: str) -> str:
    return json.dumps({"metric": metric, "value": round(value, 4),
                       "unit": unit, "vs_baseline": None})


def main(device: DeviceLike = None) -> None:
    """Time the bench's train step and print its one JSON line."""
    knobs = Knobs.from_env()
    run = build(knobs, device)
    dev = run.state.best_loss.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ips, loss, n_drop = timed_window(run.step, run.state, run.batch,
                                     knobs.iters)
    if not math.isfinite(loss):
        raise SystemExit(f"BENCH FAILED: the last loss is {loss}")
    launches = {n: c / knobs.iters for n, c in rk.launch_counts().items()}
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB"
            if dev.type == "cuda" else "not measured (cpu)")
    _log(f"n_drop={n_drop} (last step); loss={loss:.6f}; peak device "
         f"memory {peak}")
    _log(f"launches_per_step={json.dumps(launches)}")
    _plausibility_guard(ips, knobs.views, knobs.res)
    print(_result_line(knobs.metric(), ips, "iters/s"), flush=True)


def scaling_rank(res: int, per_rank: int, iters: int,
                 device: Optional[str] = None) -> dict:
    """One rank of ``scaling``: bench.py's scaling scene
    (``tet_sphere(0.05)`` on ``icosphere(2)``'s ellipsoid) at per_rank x W
    views of res², this rank's share of them (``parallel/mesh.py
    shard_batch``), one gradient all_reduce a step (``sync_step``, MEAN,
    as train()'s view-parallel mode), timed as ``main``. Returns {"ips",
    "loss"}."""
    rank, world = get_rank(), get_world_size()
    dev = rank_device(device)
    geo, batch = bench_scene(dev, per_rank * world, res, edge_length=0.05,
                             subdivisions=2)
    batch = shard_batch(batch, rank, world)
    init_fn, update_fn = _geometry_optimizer()
    step = make_train_step(geo.statics, update_fn, resolution=res,
                           sync=MEAN if world > 1 else None)
    ips, loss, _ = timed_window(step, init_train_state(geo.tet_v, init_fn),
                                batch, iters)
    return {"ips": ips, "loss": loss}


def scaling(device: DeviceLike = None, world: Optional[int] = None) -> None:
    """Weak scaling (``bench.py:218-317``): the step at BENCH_VIEWS_PER_DEV
    views a rank on 1 rank and on W ranks (``tools/run_ranks.py``), it/s(W)
    / it/s(1). On the card W is the number of cards; one card prints
    ``weak_scaling_efficiency_d1_r{res}`` = 1.0. With ``device="cpu"`` (W
    = ``world`` gloo ranks sharing the host) the ratio is bounded by 1/W,
    so the line is ``weak_scaling_cpu_normalized_d{W}_r{res}`` = W x the
    ratio, as JAX's virtual CPU mesh reports it."""
    from .tools.run_ranks import run_ranks
    dev = resolve_device(device)
    if world is None:
        world = torch.cuda.device_count() if dev.type == "cuda" else 1
    res = int(os.environ.get("BENCH_RES", 256))
    per = int(os.environ.get("BENCH_VIEWS_PER_DEV", 2))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    job = dict(res=res, per_rank=per, iters=iters,
               device="cpu" if dev.type == "cpu" else None)

    def rate(w):
        out = run_ranks("tssplat_torch.bench:scaling_rank", job, world_size=w,
                        timeout=600.0, device=job["device"])
        _log(f"scaling: {w} rank(s), B={per * w}: "
             + ", ".join(f"{r['ips']:.3f} it/s (loss {r['loss']:.6f})"
                         for r in out))
        return out[0]["ips"]

    ips1 = rate(1)
    ipsn = rate(world) if world > 1 else ips1
    eff = ipsn / ips1
    if dev.type == "cpu" and world > 1:
        print(_result_line(
            f"weak_scaling_cpu_normalized_d{world}_r{res}", eff * world,
            f"n*it/s(n)/it/s(1) on gloo ranks sharing one host (raw ratio "
            f"{eff:.4f}, ideal bound {1.0 / world:.4f}; B={per * world} vs "
            f"B={per})"), flush=True)
        return
    print(_result_line(
        f"weak_scaling_efficiency_d{world}_r{res}", eff,
        f"it/s ratio ({world}-rank B={per * world} vs 1-rank B={per})"),
        flush=True)


def _smoke_checks(device: DeviceLike) -> dict:
    """Each kernel against its plain version on
    ``tet_sphere(0.12, radius=0.3)`` from 2 views of 128², with
    ``chip_smoke.py`` phase 3's tolerances: K1's ids and aux rows equal
    and its z and rows within 1e-6; K2b and K2a (the capped layout, built
    by ``bin_faces_capped`` at the default capacity) ids and z to the bit
    and rows equal to the walk; K4 and K5 equal; K3 within rtol 1e-5 (and
    1e-6 of the largest |value|) on K5's d g6 and on a seeded cotangent
    at every foreground pixel; K6-K8 on K1's winners as
    ``tools/shade_cases.py check_shaded`` holds them. Returns {kernel: max
    abs error, or None where a check failed}."""
    from .geometry.tet_geometry import TetMeshGeometry
    from .mesh.spheres import tet_sphere
    from .mesh.tetmesh import TetMesh
    from .ops.binning import bin_faces, bin_faces_capped, capacity
    from .ops.transform import fibonacci_views, transform_pos
    from .tools.shade_cases import check_shaded, shaded_inputs

    dev = resolve_device(device)
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(*tet_sphere(0.12, radius=0.3)),
                          device=dev)
    st = geo.statics
    F, nbrs = int(st.surface_fid.shape[0]), st.edge_nbrs
    mvp = torch.as_tensor(fibonacci_views(2)[0], dtype=torch.float32,
                          device=dev)
    with torch.no_grad():
        pos = transform_pos(mvp, geo.tet_v[st.corner_vid])
    res = (128, 128)
    gen = torch.Generator(device=dev).manual_seed(0)

    def err(got, want):
        return max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(got, want))

    def bits(x):
        return x.contiguous().view(torch.int32)

    out = {}
    bins = bin_faces(pos, nbrs, res)
    got, want = rk.visibility(bins, res), rk.visibility_plain(bins, res)
    e = err(got, want)
    out["visibility"] = e if (torch.equal(got[0], want[0])
                              and torch.equal(got[3], want[3])
                              and e <= 1e-6) else None
    ids, z, g6, gaux = got
    k = capacity(None, F, res)
    for name, fn, plain, nb in (
            ("visibility_capped", rk.visibility_capped,
             rk.visibility_capped_plain, nbrs),
            ("visibility_capped_ids", rk.visibility_capped_ids,
             rk.visibility_capped_ids_plain, None)):
        cb = bin_faces_capped(pos, nb, res, k)
        g, w = fn(cb, res), plain(cb, res)
        same = (torch.equal(g[0], w[0]) and torch.equal(bits(g[1]), bits(w[1]))
                and all(torch.equal(a, b) for a, b in zip(g[2:], w[2:])))
        out[name] = err(g, w) if same else None
    inp = (ids, z, g6, gaux)
    ct = torch.randn((2,) + res, generator=gen, device=dev)
    for name, fn, plain, args in (
            ("aa_forward", rk.aa_forward, rk.aa_forward_plain, inp),
            ("aa_backward", rk.aa_backward, rk.aa_backward_plain,
             inp + (ct,))):
        g, w = fn(*args), plain(*args)
        out[name] = 0.0 if torch.equal(g, w) else None
    dense6 = torch.randn((2, 6) + res, generator=gen, device=dev) \
        * (ids > 0)[:, None]
    e3 = 0.0
    for c6 in (rk.aa_backward(*inp, ct), dense6):
        g, w = rk.wsr_table_grad(ids, c6, F), rk.wsr_table_grad_plain(ids,
                                                                       c6, F)
        scale = float(w.abs().max())
        if not torch.allclose(g, w, rtol=1e-5, atol=1e-6 * scale):
            e3 = None
            break
        e3 = max(e3, err([g], [w]))
    out["wsr_table_grad"] = e3
    try:
        out.update(check_shaded(shaded_inputs(pos, ids, nbrs, gen), gen))
    except AssertionError:
        out.update(dict.fromkeys(("shade", "shade_backward", "interp",
                                  "interp_backward", "winner_rows")))
    return out


def smoke() -> None:
    """Seconds-scale kernel smoke (``bench.py:320-414``): build the
    kernels of ``tssplat_torch/csrc`` and hold each of them against its
    plain version on the card (``_smoke_checks``). Prints
    ``cuda_kernel_smoke`` 1.0 or 0.0 and exits 1 on any mismatch. Unlike
    bench.py, which prints ``skipped-cpu`` there, it raises without a
    card."""
    dev = resolve_device(None)
    from .kernels import build as kernel_build
    t0 = time.perf_counter()
    kernel_build.build_all()
    _log(f"smoke: kernels built in {time.perf_counter() - t0:.1f} s")
    results = _smoke_checks(dev)
    torch.cuda.synchronize(dev)
    for name, e in results.items():
        _log(f"smoke {'ok' if e is not None else 'FAIL'}: {name}"
             + (f" (max abs err {e:.3g})" if e is not None else ""))
    ok = len(results) == len(rk.KERNELS) and all(
        e is not None for e in results.values())
    print(_result_line("cuda_kernel_smoke", 1.0 if ok else 0.0, "pass"),
          flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    if os.environ.get("BENCH_SMOKE"):
        smoke()
    elif os.environ.get("BENCH_SCALING"):
        scaling()
    else:
        main()
