"""The port's bench (tssplat_torch/bench.py) and trace tool
(tssplat_torch/tools/trace.py) on the CPU: its scene against bench.py's
own construction in JAX, its step's first losses against JAX's
make_train_step (geometry; exact and sampled texture, JAX's material
carried across), the one JSON line of each mode, the plausibility guard,
the scaling harness over gloo ranks, the smoke's refusal without a card,
and the trace tool's aggregation. Scene: bench.py's at 2 views of 64²."""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial
from tssplat_tpu.materials import exact_stage as jax_exact
from tssplat_tpu.mesh.spheres import icosphere, tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.tools.synthetic import render_views_of_mesh
import tssplat_tpu.train as jax_train

from tssplat_torch import bench, convert
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import bin_faces
from tssplat_torch.ops.transform import transform_pos
from tssplat_torch.tools import trace
from tssplat_torch.tools.synthetic import bench_scene
import tssplat_torch.train as torch_train
from test_torch_config_data import _jax_corner_rgb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, RES = 2, 64
SMALL = {"BENCH_VIEWS": str(B), "BENCH_RES": str(RES), "BENCH_ITERS": "1"}
ENC = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
       "log2_hashmap_size": 12, "base_resolution": 4,
       "per_level_scale": 1.6}


def _set_env(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith(("BENCH_", "TRACE_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def jax_scene():
    """bench.py:78-106 in JAX at 2 views of 64²: the geometry and the
    batch as numpy arrays."""
    v, t = tet_sphere(0.03, radius=0.25)
    geo = JaxGeometry(dict(use_smooth_barrier=True), tetmesh=JaxTetMesh(v, t))
    sv, sf = icosphere(subdivisions=3)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, mv, campos = fibonacci_views(B)
    rgba, depth, _ = render_views_of_mesh(sv, sf, mvp, campos, RES)
    batch = {"mvp": mvp, "mv": mv, "campos": campos, "img": rgba,
             "background": np.ones((B, RES, RES, 3), np.float32),
             "n": np.zeros((B, RES, RES, 4), np.float32),
             "d": depth[..., None]}
    return geo, {k: np.asarray(a, np.float32) for k, a in batch.items()}, \
        (sv, sf, mvp)


def _jax_state(params, init_fn):
    return jax_train.TrainState(
        params=params, opt_state=init_fn(params),
        best_loss=jnp.asarray(jnp.inf, jnp.float32),
        best_iter=jnp.zeros((), jnp.int32),
        best_params=jax.tree_util.tree_map(jnp.array, params))


def _port_losses(run, n):
    state, losses = run.state, []
    for it in range(n):
        state, out = run.step(state, run.batch, it)
        losses.append(float(out[0]))
    return losses


def test_scene_matches_bench_py(jax_scene):
    """bench_scene at 2 views of 64² is bench.py's scene: the same tet
    vertices and surface, mvp / mv / campos to f32 rounding, the
    background ones and the normal target zeros, and the RGBA and depth
    within test_render_views_rgba_matches_jax's tolerances (alpha and
    depth within 1e-5 but at <= 2 pixels on an edge or a z near-tie; the
    RGB within 1 LSB of JAX's corner-layout chain, and within 1 LSB of
    JAX's own RGB but where JAX's two layouts part by more than 1 LSB, at
    most 0.2 of the foreground, each but at those <= 2 pixels and their 4
    neighbours)."""
    geo_j, want, (sv, sf, mvp) = jax_scene
    geo, got = bench_scene("cpu", B, RES)
    np.testing.assert_array_equal(geo.tet_v.numpy(), np.asarray(geo_j.tet_v))
    np.testing.assert_array_equal(geo.statics.surface_fid.numpy(),
                                  np.asarray(geo_j.statics.surface_fid))
    assert set(got) == set(want)
    for k in ("mvp", "mv", "campos", "background", "n"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-7,
                                   err_msg=k)
    rgba, rgba_j = got["img"].numpy(), want["img"]
    d, d_j = got["d"].numpy()[..., 0], want["d"][..., 0]
    assert rgba.shape == rgba_j.shape == (B, RES, RES, 4)
    fg = rgba_j[..., 3] > 0
    assert fg.sum() > 150                  # the ellipsoid is ~10 px across
    edge = (np.abs(rgba[..., 3] - rgba_j[..., 3]) > 1e-5) \
        | (np.abs(d - d_j) > 1e-5)
    assert edge.sum() <= 2

    def u8(x):
        return np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(int)
    pad = np.pad(edge, ((0, 0), (1, 1), (1, 1)))
    near = edge | pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1] | pad[:, 1:-1, :-2] \
        | pad[:, 1:-1, 2:]
    corner = u8(_jax_corner_rgb(sv, sf, mvp, RES))
    assert np.abs(u8(rgba[..., :3]) - corner).max(-1)[~near].max() <= 1
    layout = np.abs(u8(rgba_j[..., :3]) - corner).max(-1) > 1
    assert layout.sum() <= 0.2 * fg.sum()
    diff = np.abs(u8(rgba[..., :3]) - u8(rgba_j[..., :3])).max(-1)
    assert diff[~layout & ~near].max() <= 1
    assert rgba[..., :3].max() > 0.2


def test_geometry_losses_match_jax(jax_scene, monkeypatch):
    """The first 3 losses of the bench's geometry step (bench.build: the
    port's make_train_step, AdamUniform lr 0.2 cosine, caps 0.01) equal
    JAX's make_train_step built as bench.py builds it, on the same batch,
    at rtol 1e-5."""
    geo_j, _, _ = jax_scene
    _set_env(monkeypatch, SMALL)
    run = bench.build(bench.Knobs.from_env(), "cpu")
    got = _port_losses(run, 3)
    init_fn, update_fn = jax_adam_uniform(
        jax_cos(0.2, 1500), grad_limit=True, grad_limit_values=(0.01, 0.01),
        grad_limit_iters=(1500,))
    step = jax_train.make_train_step(
        geo_j.statics, update_fn, fitting_stage="geometry", resolution=RES,
        fit_depth=False, is_ortho=False,
        view_chunk=jax_train._auto_view_chunk(B, 1, RES))
    batch = {k: jnp.asarray(v.numpy()) for k, v in run.batch.items()}
    state = _jax_state(jnp.array(geo_j.tet_v), init_fn)
    want = []
    for it in range(3):
        state, out = step(state, batch, it)
        want.append(float(out[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]


@pytest.mark.parametrize("sample", [0, 256], ids=["exact", "sampled"])
def test_texture_losses_match_jax(jax_scene, monkeypatch, sample):
    """The first 2 losses of the bench's texture step (AdamUniform lr 0.01
    cosine; the exact path, or the cached sampled path at 256 pixels a
    view) equal JAX's make_train_step built as bench.py builds it, at rtol
    1e-5, from JAX's initial material (the port's draws from a CPU
    generator) and, on the sampled path, JAX's slots (jax.random, fed to
    the port). The material is a 6-level 2^12 hash grid (ENC): JAX's step
    on the default 16 x 2^19 grid is too slow for this suite on the CPU;
    the bench's own material runs in test_main_prints_one_line."""
    geo_j, _, _ = jax_scene
    mat_j = JaxMaterial({"pos_encoding_config": dict(ENC)})

    class FromJax(ExplicitMaterial):
        def __init__(self, cfg=None, device=None):
            assert not cfg                  # the bench's default material
            super().__init__({"pos_encoding_config": dict(ENC)}, device)
            self.params = convert.material_params(mat_j.params, self.device)

    def jax_slots(count, S, it):
        key = jax.random.fold_in(jax.random.PRNGKey(17), it)
        u = np.asarray(jax.random.uniform(key, (count.shape[0], S)))
        cnt = count.numpy()[:, None]
        slot = np.floor(u * cnt.astype(np.float32)).astype(np.int64)
        return torch.from_numpy(np.minimum(slot, np.maximum(cnt - 1, 0)))

    monkeypatch.setattr(bench, "ExplicitMaterial", FromJax)
    monkeypatch.setattr(torch_train, "texture_sample_slots", jax_slots)
    _set_env(monkeypatch, dict(SMALL, BENCH_STAGE="texture",
                               BENCH_TEX_SAMPLE=str(sample)))
    run = bench.build(bench.Knobs.from_env(), "cpu")
    got = _port_losses(run, 2)

    batch = {k: jnp.asarray(v.numpy()) for k, v in run.batch.items()}
    tet_v = jnp.array(geo_j.tet_v)
    kw = dict(texture_sample_px=sample)
    if sample:
        kw["texture_cache"] = jax_train.build_texture_sample_cache(
            geo_j.statics, tet_v, batch["mvp"], batch["img"], RES)
    else:
        cache = jax_exact.build_texture_exact_cache(
            geo_j, mat_j, {k: batch[k] for k in ("mvp", "img",
                                                 "background")}, RES)
        kw["texture_exact_loss"] = jax_exact.build_texture_exact_loss(
            mat_j, geo_j.statics, cache)
    init_fn, update_fn = jax_adam_uniform(jax_cos(0.01, 1500))
    step = jax_train.make_train_step(
        geo_j.statics, update_fn, fitting_stage="texture", resolution=RES,
        fit_depth=False, is_ortho=False, material_fn=mat_j.apply_fn,
        tet_v_frozen=tet_v, **kw)
    state = _jax_state(mat_j.params, init_fn)
    want = []
    for it in range(2):
        state, out = step(state, batch, it)
        want.append(float(out[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] != got[0]


@pytest.mark.parametrize("env, metric, note", [
    ({}, "geometry_train_iters_per_sec_b2_r64", None),
    ({"BENCH_SPHERES": "3"}, "geometry_train_iters_per_sec_b2_r64_s3",
     "spheres=3"),
    ({"BENCH_STAGE": "texture"}, "texture_train_iters_per_sec_b2_r64",
     "exact texture fast path: P="),
    ({"BENCH_STAGE": "texture", "BENCH_TEX_SAMPLE": "256"},
     "texture_train_iters_per_sec_b2_r64", None),
    ({"BENCH_VIEW_CHUNK": "1"}, "geometry_train_iters_per_sec_b2_r64",
     "view_chunk=1"),
], ids=["geometry", "spheres3", "texture_exact", "texture_sampled",
        "chunked"])
def test_main_prints_one_line(monkeypatch, capsys, env, metric, note):
    """main(device="cpu") prints exactly one stdout line, bench.py's four
    keys under bench.py's metric name, a finite rate > 0 in iters/s; its
    diagnostics (the scene, the view chunk, the exact path's P, n_drop,
    the launches a step) go to stderr."""
    _set_env(monkeypatch, dict(SMALL, **env))
    bench.main(device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == metric and rec["unit"] == "iters/s"
    assert rec["vs_baseline"] is None
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert "n_drop=0" in err and "launches_per_step=" in err
    if note is not None:
        assert note in err
    launches = json.loads(err.split("launches_per_step=")[1].splitlines()[0])
    assert set(launches) == {fn.__name__ for fn in rk.KERNELS}


def test_vis_bytes_per_px_counts_the_visibility_output():
    """The guard's 48 B a pixel is what the visibility wrapper returns a
    pixel: ids, z, the winner's 6 rows and its 4 aux rows."""
    geo, batch = bench_scene("cpu", 1, 32, edge_length=0.12)
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[geo.statics.corner_vid])
    out = rk.visibility(bin_faces(pos, geo.statics.edge_nbrs, (32, 32)),
                        (32, 32))
    assert sum(t.numel() * t.element_size() for t in out) \
        == bench.VIS_BYTES_PER_PX * 32 * 32
    assert bench.VIS_BYTES_PER_PX == 48


def test_guard_passes_readings_on_record():
    """The H100 rates on record pass (PERF.md: the bench scene 76.6-158
    it/s, the 18-sphere scene at 120 views ~12 it/s), as does a rate just
    under each cap."""
    for ips, views in ((76.6, 8), (158.0, 8), (11.7, 120), (3.69, 8),
                       (16_600.0, 8), (1_100.0, 120)):
        bench._plausibility_guard(ips, views, 512)


@pytest.mark.parametrize("views", [8, 120])
def test_guard_rejects_one_percent_over_the_cap(views):
    """The cap is the rate at which the visibility output, written and
    read once, fills 3.35 TB/s (16,640 it/s at 8 x 512², 1,109 at 120 x
    512²); 1% over it is rejected with SystemExit."""
    cap = 3.35e12 / (2 * views * 512 * 512 * 48)
    assert cap == pytest.approx({8: 16639.6, 120: 1109.3}[views], rel=1e-4)
    bench._plausibility_guard(cap * 0.999, views, 512)
    with pytest.raises(SystemExit, match="BENCH REJECTED"):
        bench._plausibility_guard(cap * 1.01, views, 512)


def test_main_rejects_an_impossible_rate_and_prints_nothing(monkeypatch,
                                                            capsys):
    """A window that reads 1% over the cap (a clock that says the steps
    took almost no time) ends in SystemExit with no stdout line."""
    _set_env(monkeypatch, SMALL)
    cap = 3.35e12 / (2 * B * RES * RES * 48)
    ticks = iter([0.0, int(SMALL["BENCH_ITERS"]) / (cap * 1.01)])
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    with pytest.raises(SystemExit, match="BENCH REJECTED"):
        bench.main(device="cpu")
    assert capsys.readouterr().out == ""


def test_knobs_are_bench_py_s(monkeypatch):
    """The knobs' defaults are bench.py's code's (BENCH_ITERS 20, view
    chunk auto, the exact texture path); an unknown stage is refused."""
    _set_env(monkeypatch, {})
    k = bench.Knobs.from_env()
    assert (k.views, k.res, k.iters, k.stage, k.spheres, k.view_chunk,
            k.tex_sample, k.tex_stoch, k.tex_cache, k.tex_dense) == (
        8, 512, 20, "geometry", 1, "auto", 0, False, True, False)
    assert k.metric() == "geometry_train_iters_per_sec_b8_r512"
    monkeypatch.setenv("BENCH_STAGE", "shape")
    with pytest.raises(SystemExit, match="geometry or texture"):
        bench.Knobs.from_env()


def test_scaling_over_gloo_ranks(monkeypatch, capsys):
    """scaling(device="cpu", world=2) times the view-sharded step on 1 and
    on 2 gloo ranks (tools/run_ranks.py) and prints JAX's CPU line,
    weak_scaling_cpu_normalized_d2_r{res}: 2 x it/s(2) / it/s(1)."""
    _set_env(monkeypatch, {"BENCH_RES": str(RES), "BENCH_ITERS": "1",
                           "BENCH_VIEWS_PER_DEV": "1"})
    bench.scaling(device="cpu", world=2)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == f"weak_scaling_cpu_normalized_d2_r{RES}"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert "B=2 vs B=1" in rec["unit"]
    assert "scaling: 2 rank(s)" in err


def test_scaling_rank_alone():
    """The scaling job outside a process group (world 1: shard_batch keeps
    every view, no collective) times the whole batch and returns a finite
    rate and loss."""
    out = bench.scaling_rank(RES, 2, 1, device="cpu")
    assert math.isfinite(out["ips"]) and out["ips"] > 0
    assert math.isfinite(out["loss"])


@pytest.mark.parametrize("entry", ["main", "smoke", "scaling"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    """Each mode runs on the card and raises without one: there is no
    quiet fallback to the CPU (unlike bench.py's smoke, which prints
    skipped-cpu there)."""
    assert not torch.cuda.is_available()
    _set_env(monkeypatch, SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(bench, entry)()


def test_smoke_checks_rehearse_on_the_cpu():
    """_smoke_checks runs every comparison on the CPU (where each wrapper
    is its plain version) and names every kernel."""
    out = bench._smoke_checks("cpu")
    assert set(out) == {fn.__name__ for fn in rk.KERNELS}
    assert all(e == 0.0 for e in out.values())


def test_module_run_without_a_card_fails_and_prints_nothing():
    """``python -m tssplat_torch.bench`` exits non-zero with an empty
    stdout where there is no card."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=REPO, **SMALL)
    res = subprocess.run([sys.executable, "-m", "tssplat_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_trace_top_aggregates_a_chrome_trace(tmp_path, capsys):
    """top sums the kernel, memset and memcpy events of a hand-written
    chrome trace by name, divides by n_steps, skips host events and
    non-complete phases, ranks by time and prints the device ms a step."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "vis_kernel", "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "vis_kernel", "dur": 120.0},
        {"ph": "X", "cat": "kernel", "name": "aa_fwd", "dur": 30.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "dur": 6.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 50.0},
        {"ph": "i", "cat": "kernel", "name": "vis_kernel", "dur": 999.0},
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    total = trace.top(str(tmp_path), n_steps=2, top_k=2)
    assert total == pytest.approx((220 + 30 + 6 + 4) / 1e3 / 2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[0] == "0.1100" and "x1" in lines[0] \
        and lines[0].endswith("vis_kernel")
    assert lines[1].split()[0] == "0.0150" and lines[1].endswith("aa_fwd")
    assert lines[2].startswith("(top 2 sum: 0.1250 ms/step of 0.1300)")
    rec = json.loads(lines[-1])
    assert rec["metric"] == "trace_device_ms_per_step"
    assert rec["value"] == 0.13 and rec["ops_per_step"] == 2.5
    assert len(lines) == 4


def test_trace_capture_on_the_cpu(tmp_path, monkeypatch):
    """capture(device="cpu") records the bench's steps after its warm-up
    into DIR/trace.json (host operations only: top finds no device
    operation there and says so)."""
    _set_env(monkeypatch, SMALL)
    path = trace.capture(str(tmp_path), device="cpu", n_steps=1)
    assert path == str(tmp_path / "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert trace.device_ops(path) == ({}, {})
    with pytest.raises(SystemExit, match="no device operation"):
        trace.top(str(tmp_path))
