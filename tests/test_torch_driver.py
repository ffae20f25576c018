"""The port's driver (tssplat_torch.train: train, main, the view-chunked
step) against the JAX package's train() on the same config and the same
dataset on the CPU, and the driver's own contracts: chunking, resume,
SIGTERM, the knobs (the sanitizers and the SDS dispatch among them)."""

import copy
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.config import load_config as jax_load_config
from tssplat_tpu.mesh.io import load_veg as jax_load_veg
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset
from tssplat_tpu.train import _auto_view_chunk as jax_auto_view_chunk
from tssplat_tpu.train import train as jax_train

import tssplat_torch.train as torch_train
from tssplat_torch import convert
from tssplat_torch.config import ConfigDict
from tssplat_torch.data import MitsubaImgDataLoader
from tssplat_torch.geometry import TetMeshMultiSphereGeometry
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.synthetic import write_synthetic_dataset
from tssplat_torch.utils.checkpoint import latest_checkpoint_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 64
# off a multiple of 8: tests/conftest.py gives JAX 8 CPU devices, and JAX's
# train() shards a batch they divide over a data-parallel mesh, whose
# chunking is another path than the one the port copies
N_VIEWS = 6
LOG = re.compile(r"iter=\s*(\d+), img_loss=([0-9.]+)")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The JAX writer's dataset of the ellipsoid icosphere(3) * (0.30, 0.24,
    0.18) at N_VIEWS x 64², and the key points of one sphere at r 0.24."""
    root = tmp_path_factory.mktemp("driver")
    v, f = icosphere(subdivisions=3)
    jax_write_dataset(str(root / "img"), v * np.asarray([0.30, 0.24, 0.18]),
                      f, n_views=N_VIEWS, resolution=RES)
    (root / "kp.json").write_text(json.dumps({"pt": [[0.0, 0.0, 0.0]],
                                              "r": [0.24]}))
    return root


def _cfg(root, out, iters, img="img", n_views=N_VIEWS, **over):
    """A geometry-stage config as configs/gso.yaml lays it out."""
    out = str(root / out)
    cfg = {
        "fitting_stage": "geometry",
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {
            "use_smooth_barrier": True,
            "smooth_barrier_param": {"smooth_eng_coeff": 2e-4,
                                     "barrier_coeff": 2e-4,
                                     "increase_order_iter": 1000},
            "key_points_file_path": str(root / "kp.json"),
            "tetwild_cache_folder": out + "_cache",
        },
        "dataloader_type": "MistubaImgDataLoader",
        "data": {"dataset_config": {"image_root": str(root / img)},
                 "world_size": 1, "rank": 0, "batch_size": n_views,
                 "total_num_iter": iters},
        "renderer": {"is_orhto": False},
        "optimizer": {"lr": 0.2, "grad_limit": True,
                      "grad_limit_values": [0.01, 0.01],
                      "grad_limit_iters": [iters]},
        "output_path": out,
        "total_num_iter": iters,
        "use_permute_surface_v": False,
        "log_every": 1,
        "export_every": 4,
    }
    cfg.update(over)
    return cfg


def _logged(text):
    return [float(m.group(2)) for m in LOG.finditer(text)]


CASES = {
    # gso.yaml's optimizer; view_chunk 2 so that JAX chunks too
    "silhouette_chunked": dict(iters=8, view_chunk=2),
    # the production optimizer with the depth switch and the normal loss,
    # view_chunk auto (no chunks at 6 x 64²). Adam moves every component
    # with a non-zero gradient by ~lr whatever its size, so the energy's
    # rounding-level gradient at the rest shape (~1e-7, computed in
    # another order by each package) moves interior vertices by up to
    # ±lr a step in either package; at lr 3e-3 the two runs part by
    # 0.008 after six steps. lr 2e-5 keeps that drift (≤ 2 lr a step)
    # inside the tolerance, with the depth and normal terms in the loss.
    "adam_depth_normal": dict(
        iters=6, fit_depth=True, fit_depth_starting_iter=2, fit_normal=True,
        optimizer={"type": "adam", "lr": 2e-5}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(root, capsys, case):
    """JAX's train() and the port's train(device="cpu") on one config: the
    logged img_loss within rtol 5e-3 at every iteration (the tolerance of
    test_torch_train_step.py::test_trajectory_matches_jax; the log prints 4
    decimals), params and best_params within atol 5e-4 and best_loss
    within rtol 5e-3 (through convert.train_state), best_iter and the
    optimizer's count equal, and the final export: final.veg's vertices
    and final_vtx.npy within atol 5e-4, the elements and the index JSONs
    identical, the same file set."""
    over = dict(CASES[case])
    iters = over.pop("iters")
    cfg_j = _cfg(root, f"{case}_jax", iters, **over)
    cfg_t = _cfg(root, f"{case}_torch", iters, **over)

    st_j, _ = jax_train(JaxConfigDict(copy.deepcopy(cfg_j)))
    log_j = _logged(capsys.readouterr().out)
    st_t, geo_t = torch_train.train(ConfigDict(copy.deepcopy(cfg_t)),
                                    device="cpu")
    out_t = capsys.readouterr().out
    log_t = _logged(out_t)
    assert len(log_t) == len(log_j) == iters
    np.testing.assert_allclose(log_t, log_j, rtol=5e-3)
    assert "WARNING" not in out_t

    want = convert.train_state(jax.device_get(st_j), "cpu")
    np.testing.assert_allclose(st_t.params.numpy(), want.params.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(st_t.best_params.numpy(),
                               want.best_params.numpy(), atol=5e-4)
    np.testing.assert_allclose(float(st_t.best_loss), float(want.best_loss),
                               rtol=5e-3)
    assert int(st_t.best_iter) == int(want.best_iter)
    assert type(st_t.opt_state) is type(want.opt_state)
    assert int(st_t.opt_state.count) == int(want.opt_state.count) == iters

    fin_j = os.path.join(cfg_j["output_path"], "final")
    fin_t = os.path.join(cfg_t["output_path"], "final")
    assert sorted(os.listdir(fin_t)) == sorted(os.listdir(fin_j))
    assert {"final.veg", "final_vtx.npy", "final_elem.npy",
            "final_surface_mesh.obj"} <= set(os.listdir(fin_t))
    (vj, tj), (vt, tt) = (jax_load_veg(os.path.join(d, "final.veg"))
                          for d in (fin_j, fin_t))
    np.testing.assert_allclose(vt, vj, atol=5e-4)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(np.load(os.path.join(fin_t, "final_vtx.npy")),
                               np.load(os.path.join(fin_j, "final_vtx.npy")),
                               atol=5e-4)
    for name in ("spheres_vtx_idx.json", "spheres_elem_idx.json"):
        with open(os.path.join(fin_t, name)) as a, \
                open(os.path.join(fin_j, name)) as b:
            assert json.load(a) == json.load(b)
    exports = sorted(d for d in os.listdir(cfg_t["output_path"])
                     if d.startswith("mesh"))
    assert exports == [f"mesh{it:05d}" for it in range(0, iters, 4)]


@pytest.fixture(scope="module")
def scene(root):
    geo = TetMeshMultiSphereGeometry(dict(
        key_points_file_path=str(root / "kp.json"),
        tetwild_cache_folder=str(root / "scene_cache"),
        output_path=str(root / "scene")), device="cpu")
    loader = MitsubaImgDataLoader(dict(
        dataset_config=dict(image_root=str(root / "img")),
        batch_size=N_VIEWS, total_num_iter=1), device="cpu")
    return geo, {k: v for k, v in loader(0, 0).items()
                 if k not in ("resolution", "spp")}


@pytest.mark.parametrize("fit", ["silhouette", "depth_normal"])
def test_chunked_step_equals_unchunked(scene, monkeypatch, fit):
    """make_train_step(view_chunk=2) on 6 views: the loss within rtol 1e-6
    of the unchunked step's, tet_v after the update within atol 1e-6, and
    the visibility kernel (K1 at 64²) called once per chunk: the chunks'
    recomputation in the backward does not run it again."""
    geo, batch = scene
    calls = []
    vis = rk.visibility

    def spy(bins, resolution, **kw):
        calls.append(int(bins.table.shape[0]))
        return vis(bins, resolution, **kw)

    monkeypatch.setattr(rk, "visibility", spy)
    dn = fit == "depth_normal"
    outs = {}
    for chunk in (0, 2):
        init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.2, 100),
                                          grad_limit=True)
        step = torch_train.make_train_step(
            geo.statics, update_fn, resolution=RES, fit_depth=dn,
            fit_normal=dn, view_chunk=chunk)
        calls.clear()
        state, out = step(torch_train.init_train_state(geo.tet_v, init_fn),
                          batch, 1)
        outs[chunk] = (out, state.params, list(calls))
    (o0, p0, c0), (o2, p2, c2) = outs[0], outs[2]
    assert c0 == [N_VIEWS] and c2 == [2] * (N_VIEWS // 2)
    np.testing.assert_allclose(float(o2[0]), float(o0[0]), rtol=1e-6)
    np.testing.assert_allclose(float(o2[1]), float(o0[1]), rtol=1e-6)
    assert int(o2[3]) == int(o0[3]) == 0
    np.testing.assert_allclose(p2.numpy(), p0.numpy(), atol=1e-6)
    assert float((p2 - geo.tet_v).abs().max()) > 1e-3


def _free_for(views: int, res: int, tile_k=None) -> int:
    """Free device bytes that hold ``views`` views of res² at capacity
    ``tile_k`` under the chunk rule, and not one view more."""
    return math.ceil(views * torch_train._bytes_per_view(res, tile_k)
                     / torch_train._FREE_SHARE)


@pytest.mark.parametrize("B, n_dev, res, tile_k, free_views, want", [
    (120, 1, 512, None, 120, 0),
    (120, 2, 512, None, 60, 0),
    (120, 1, 512, None, 45, 40),
    (120, 2, 512, None, 45, 60),
    (N_VIEWS, 1, RES, None, 4, 3),
    (120, 1, 512, 4096, 120, 0),
    (120, 1, 512, 16384, 50, 40),
    (120, 1, 512, None, 0, 1),
    (120, 2, 512, None, 0, 2),
], ids=["fits", "fits_per_device", "largest_divisor",
        "largest_divisor_per_device", "largest_divisor_small",
        "fits_with_lists", "largest_divisor_with_lists", "nothing_fits",
        "nothing_fits_per_device"])
def test_auto_view_chunk_by_free_memory(B, n_dev, res, tile_k, free_views,
                                        want):
    """The chunk rule with the device's free bytes given: one batch where a
    device's B / n_dev views fit, else the largest divisor of B (a
    multiple of n_dev) whose views fit, else n_dev, the smallest chunk.
    A view counts its pixels and the slots of the capped layout's
    candidate lists at ``tile_k``."""
    got = torch_train._auto_view_chunk(
        B, n_dev, res, tile_k=tile_k,
        free_bytes=_free_for(free_views, res, tile_k))
    assert got == want


@pytest.mark.parametrize("res, tile_k, tiles", [
    (512, None, 0), (512, 4096, 256), (512, 16384, 256), (64, 128, 8),
    (136, 128, 34),
], ids=["no_lists", "gso_validated", "gso_largest", "narrow",
        "partial_tiles"])
def test_bytes_per_view_counts_candidate_lists(res, tile_k, tiles):
    """A view's bytes under the chunk rule: BYTES_PER_VIEW_PX a pixel and
    BYTES_PER_TILE_SLOT a slot of the capped layout's candidate lists, one
    list of tile_k slots for each 8 x 128 tile (a partial tile counts
    whole)."""
    assert torch_train._bytes_per_view(res, tile_k) == \
        res * res * torch_train.BYTES_PER_VIEW_PX \
        + tiles * (tile_k or 0) * torch_train.BYTES_PER_TILE_SLOT


@pytest.mark.parametrize("B, n_dev, res, device", [
    (2, 1, 64, None), (N_VIEWS, 1, RES, None), (N_VIEWS, 2, RES, None),
    (120, 1, 512, None), (120, 2, 512, None), (120, 1, 512, "cpu"),
], ids=["bench", "driver", "driver_per_device", "gso", "gso_per_device",
        "gso_cpu_device"])
def test_auto_view_chunk_off_cuda_is_jax(monkeypatch, B, n_dev, res,
                                         device):
    """Off CUDA (no card, or a CPU device asked for) the chunk rule is
    JAX's, at the shapes the bench and driver tests run and at gso.yaml's
    120 views of 512²; no free memory is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: device is not None)

    def no_read(*a, **k):
        raise AssertionError("free memory read off CUDA")
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_read)
    assert torch_train._auto_view_chunk(B, n_dev, res, device=device) == \
        jax_auto_view_chunk(B, n_dev, res)


@pytest.fixture(scope="module")
def two_views(root):
    """Two views of the ellipsoid at 64², by the port's own writer, and the
    sphere's mesh in a cache folder that the runs below load (init path B)
    instead of meshing it again."""
    v, f = icosphere(subdivisions=3)
    write_synthetic_dataset(str(root / "img2"),
                            v * np.asarray([0.30, 0.24, 0.18]), f, n_views=2,
                            resolution=RES, device="cpu")
    TetMeshMultiSphereGeometry(dict(
        key_points_file_path=str(root / "kp.json"),
        tetwild_cache_folder=str(root / "mesh_cache"),
        output_path=str(root / "mesh_cache")), device="cpu")
    return root


def _two_view_cfg(root, out, iters, **over):
    cfg = _cfg(root, out, iters, img="img2", n_views=2, export_every=10 ** 6,
               **over)
    cfg["geometry"].update(tetwild_cache_folder=str(root / "mesh_cache"),
                           load_precomputed_tetwild_mesh=True)
    return cfg


def test_resume_matches_straight_run(two_views, capsys):
    """6 iterations with checkpoint_every 4, then resume=true to 8 (from
    the checkpoint of iteration 4), give the state of 8 straight
    iterations (atol 1e-6, every field, both optimizer moments). The
    learning rate equals eta_min, so AdamUniform's cosine schedule is flat
    and does not depend on total_num_iter; the batch holds both views, so
    the shuffle reorders them only."""
    root = two_views

    def cfg(out, iters, **over):
        return ConfigDict(_two_view_cfg(root, out, iters, log_every=100,
                                        optimizer={"lr": 1e-4}, **over))

    torch_train.train(cfg("resume", 6, checkpoint_every=4, verbose=True),
                      device="cpu")
    ckpt = root / "resume" / "ckpt"
    assert latest_checkpoint_step(str(ckpt)) == 4
    assert sorted(os.listdir(ckpt)) == ["step_00000004.pt"]
    assert os.path.exists(root / "resume" / "a_ours-0.png")
    got, _ = torch_train.train(cfg("resume", 8, checkpoint_every=4,
                                   resume=True), device="cpu")
    assert "resumed from checkpoint at iter 4" in capsys.readouterr().out
    want, _ = torch_train.train(cfg("straight", 8), device="cpu")
    for name in ("params", "best_params", "best_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), atol=1e-6)
    assert int(got.best_iter) == int(want.best_iter)
    for a, b in zip(got.opt_state, want.opt_state):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    rest = np.load(root / "mesh_cache" / "final_tet_v.npy")
    assert np.abs(want.params.numpy() - rest).max() > 1e-4


def test_profile_iters_writes_a_trace_of_the_spans(two_views):
    """profile_iters [0, 2] on a two-iteration run writes one Chrome trace,
    <output_path>/trace/trace_<pid>.json, holding each iteration's
    tssplat.step span and its loader's."""
    root = two_views
    torch_train.train(ConfigDict(_two_view_cfg(root, "profiled", 2,
                                               profile_iters=[0, 2])),
                      device="cpu")
    trace = root / "profiled" / "trace"
    assert os.listdir(trace) == [f"trace_{os.getpid()}.json"]
    with open(trace / f"trace_{os.getpid()}.json") as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert names.count("tssplat.step") == 2
    assert names.count("tssplat.loader") == 2


def test_sigterm_checkpoints_and_resumes(two_views, capsys):
    """SIGTERM during train(cfg, device="cpu") in a subprocess: the running
    iteration finishes, a full-state checkpoint is written, the run stops
    (and exports); a second run with resume=true starts from it."""
    root = two_views
    cfg = _two_view_cfg(root, "sigterm", 100000, resume=True)
    script = root / "sigterm.py"
    script.write_text(
        "import json, sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "torch.set_num_threads(1)\n"
        "from tssplat_torch.config import ConfigDict\n"
        "from tssplat_torch.train import train\n"
        f"cfg = ConfigDict(json.loads({json.dumps(cfg)!r}))\n"
        "cfg.total_num_iter = cfg.data.total_num_iter = int(sys.argv[1])\n"
        "train(cfg, device='cpu')\n")
    p = subprocess.Popen([sys.executable, str(script), "100000"],
                         stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        t0, started = time.time(), False
        while time.time() - t0 < 300:
            line = p.stdout.readline()
            if not line:
                break
            if "iter=   2" in line:
                started = True
                break
        assert started, "training never reached iter 2"
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    assert p.returncode == 0, rest[-2000:]
    assert "preempted: checkpoint written" in rest, rest[-2000:]
    saved = latest_checkpoint_step(str(root / "sigterm" / "ckpt"))
    assert saved is not None and saved >= 2
    assert os.path.exists(root / "sigterm" / "final" / "final.veg")

    cfg = ConfigDict(cfg)
    cfg.total_num_iter = cfg.data.total_num_iter = saved + 2
    torch_train.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from checkpoint at iter {saved}" in out
    assert f"iter={saved + 1:4d}" in out
    assert f"iter={saved:4d}" not in out


@pytest.mark.parametrize("knob", [
    dict(debug_nans=True),
    dict(anomaly=True),
    dict(sds=dict(prompt="a dog")),
], ids=["debug_nans", "anomaly", "sds"])
def test_unported_knobs_raise(root, knob, monkeypatch):
    """The knobs that raised "not ported" until their parts were ported now
    run: debug_nans (the NaN trap) and anomaly give the losses and
    parameters of the run without them, bit for bit, and are off again
    after the run; a config with an sds block makes main() run train_sds
    (tests/test_torch_sds.py runs it)."""
    from tssplat_torch.config import dump_config
    from tssplat_torch.utils import debug
    import tssplat_torch.train_sds as sds_driver
    if "sds" in knob:
        seen = []
        monkeypatch.setattr(sds_driver, "train_sds",
                            lambda cfg, device=None: seen.append(
                                (dict(cfg["sds"]), device)))
        path = str(root / "sds_knob.yaml")
        dump_config(path, dict(_cfg(root, "knobs", 2), **knob))
        torch_train.main(["--config", path], device="cpu")
        assert seen == [({"prompt": "a dog"}, "cpu")]
        assert not os.path.exists(root / "knobs")
        return
    make = torch_train.make_train_step
    runs = []
    for tag, over in (("plain", {}), ("knob", knob)):
        losses = []

        def spy(*args, losses=losses, **kw):
            step = make(*args, **kw)

            def recorded(state, batch, it):
                state, out = step(state, batch, it)
                losses.append(float(out[0]))
                return state, out
            return recorded

        monkeypatch.setattr(torch_train, "make_train_step", spy)
        st, _ = torch_train.train(ConfigDict(_cfg(root, f"knob_{tag}", 2,
                                                  **over)), device="cpu")
        runs.append((losses, st))
    (l0, s0), (l1, s1) = runs
    assert len(l0) == 2 and l1 == l0
    assert torch.equal(s1.params, s0.params)
    assert not debug.anomaly_enabled() and not debug.debug_nans_enabled()


@pytest.mark.parametrize("knob", [
    dict(fitting_stage="texture", material_type="ExplicitMaterial"),
    dict(material_type="ExplicitMaterial"),
], ids=["texture", "material"])
def test_texture_knobs_pass_the_knob_check(root, knob):
    """The texture stage and its material, ported, no longer raise
    (tests/test_torch_texture_driver.py runs them)."""
    cfg = _cfg(root, "knobs", 2)
    cfg.update(knob)
    torch_train._check_stage(ConfigDict(cfg))


def test_unknown_stage_raises(root):
    """A fitting_stage other than geometry or texture is refused before
    anything is built."""
    cfg = _cfg(root, "knobs", 2, fitting_stage="shading")
    with pytest.raises(ValueError, match="unknown fitting_stage"):
        torch_train.train(ConfigDict(cfg), device="cpu")
    assert not os.path.exists(root / "knobs")


def test_gso_defaults_pass_the_knob_check():
    """configs/gso.yaml as shipped (material_type None, data_parallel
    unset, world_size 1) sets no knob that raises."""
    cfg = jax_load_config(os.path.join(REPO, "configs", "gso.yaml"))
    torch_train._check_stage(ConfigDict(cfg))


def test_train_and_main_refuse_cpu_fallback(root, monkeypatch):
    """Without device= train() and main() want CUDA and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_train.train(ConfigDict(_cfg(root, "nocuda", 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_train.main(["--config",
                          os.path.join(REPO, "configs", "gso.yaml")])


def test_main_parses_like_jax(monkeypatch):
    """main(["--config", "configs/gso.yaml", overrides...]) hands train()
    the dict JAX's load_config makes of the same file and overrides, the
    interpolations resolved to the same values and types."""
    seen = {}
    monkeypatch.setattr(torch_train, "train",
                        lambda cfg, device=None: seen.update(cfg=cfg,
                                                             device=device))
    gso = os.path.join(REPO, "configs", "gso.yaml")
    over = ["data.total_num_iter=24", "log_every=4", "view_chunk=0",
            "optimizer.lr=2e-3", "data.dataset_config.image_root=/x/img",
            "fit_depth=true", "geometry.tetwild_cache_folder=/x/c"]
    torch_train.main(["--config", gso, *over], device="cpu")
    want = jax_load_config(gso, cli_args=over)
    got = seen["cfg"]
    assert isinstance(got, ConfigDict) and seen["device"] == "cpu"
    assert got == want
    assert got.total_num_iter == 24 and type(got.total_num_iter) is int
    assert got.permute_surface_v_param["end_iter"] == 24
    assert got.fit_depth is True
    # YAML 1.1 reads 2e-3 (no dot) as a string, in both loaders; the
    # driver takes the learning rate as float(lr)
    assert got.optimizer["lr"] == "2e-3"
