"""The port's multi-rank training in the driver (tssplat_torch/train.py's
modes over tssplat_torch.parallel) against the JAX package on the CPU:
view-parallel and per-rank-slice training against JAX's single-device
train() (tests/test_parallel.py, tests/test_multihost.py), chunked view
parallelism against one process unchunked, and data.world_size / spatial
in one process.

Ranks are CPU processes in a gloo group, each started and bounded in time
by ``tools/run_ranks.py``, running ``run_ranks.train_rank``."""

import json
import os

import numpy as np
import pytest
import torch

from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset
from tssplat_tpu.train import train as jax_train

import tssplat_torch.train as torch_train
from tssplat_torch.config import ConfigDict
from tssplat_torch.tools.run_ranks import run_ranks

torch.set_num_threads(1)

TRAIN = "tssplat_torch.tools.run_ranks:train_rank"
TIMEOUT = 80.0


def _ranks(job, kwargs, world=2, **kw):
    return run_ranks(job, kwargs, world_size=world, timeout=TIMEOUT,
                     device="cpu", **kw)


# ---------------------------------------------------------------------------
# training over ranks against JAX's single-device train()
# ---------------------------------------------------------------------------

def _dataset(root, n_views):
    v, f = icosphere(2)
    jax_write_dataset(str(root / "img"), v * np.asarray([0.3, 0.25, 0.2]),
                      f, n_views=n_views, resolution=64)
    (root / "kp.json").write_text(json.dumps({"pt": [[0.0, 0.0, 0.0]],
                                              "r": [0.24]}))
    return root


@pytest.fixture(scope="module")
def dataset8(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("dp8"), 8)


@pytest.fixture(scope="module")
def dataset16(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("dp16"), 16)


def _cfg(root, out, batch, iters=4, **over):
    """tests/test_parallel.py's _train_cfg (JAX's own, data_parallel off:
    its single-device run)."""
    out = str(root / out)
    cfg = {
        "fitting_stage": "geometry",
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {"use_smooth_barrier": True,
                     "smooth_barrier_param": {"smooth_eng_coeff": 2e-4,
                                              "barrier_coeff": 2e-4,
                                              "increase_order_iter": 1000},
                     "key_points_file_path": str(root / "kp.json"),
                     "tetwild_cache_folder": out + "_cache",
                     "output_path": out},
        "dataloader_type": "MistubaImgDataLoader",
        "data": {"dataset_config": {"image_root": str(root / "img")},
                 "world_size": 1, "rank": 0, "batch_size": batch,
                 "total_num_iter": iters},
        "optimizer": {"lr": 0.2, "grad_limit": True,
                      "grad_limit_values": [0.01, 0.01],
                      "grad_limit_iters": [iters]},
        "output_path": out,
        "total_num_iter": iters,
        "use_permute_surface_v": False,
        "log_every": 1000, "export_every": 10 ** 6,
        "data_parallel": False,
    }
    for k, v in over.items():
        if k == "data":
            cfg["data"].update(v)
        else:
            cfg[k] = v
    return cfg


def _train_ranks(root, cfg, world=2):
    """train_rank on ``world`` CPU ranks: their results and parameters."""
    res = _ranks(TRAIN, dict(out=str(root), cfg=cfg, device="cpu"),
                 world=world)
    return res, [torch.load(r["params"]) for r in res]


@pytest.fixture(scope="module")
def jax_ref8(dataset8):
    """JAX's single-device train() on the 8 views, 4 iterations."""
    state, _ = jax_train(JaxConfigDict(_cfg(dataset8, "jax_ref", 8)))
    return float(state.best_loss), np.asarray(state.params)


def _close_to(res, params, best, ref_params, rtol=1e-4, atol=2e-6):
    """tests/test_parallel.py's tolerances, and every rank's parameters
    the same bits."""
    for p in params[1:]:
        assert torch.equal(p, params[0]), "ranks' parameters differ"
    assert len({r["best_loss"] for r in res}) == 1
    np.testing.assert_allclose(res[0]["best_loss"], best, rtol=rtol)
    np.testing.assert_allclose(params[0].numpy(), ref_params, atol=atol)


def test_view_parallel_train_matches_jax(dataset8, jax_ref8):
    """train() over 2 ranks, each on 4 of the 8 views (data_parallel on):
    JAX's single-device train() within rtol 1e-4 / atol 2e-6, the ranks'
    parameters bit-equal, the final meshes written by rank 0 alone."""
    cfg = _cfg(dataset8, "dp", 8, data_parallel=True)
    res, params = _train_ranks(dataset8, cfg)
    _close_to(res, params, *jax_ref8)
    assert os.path.exists(dataset8 / "dp" / "final" / "final.veg")
    assert all(len(r["steps"]) == 4 for r in res)


def test_view_parallel_chunked_matches_unchunked(dataset16):
    """16 views in chunks of 8 over 2 ranks (each rank 4 views of every
    chunk) against one process on the whole batch unchunked."""
    cfg = _cfg(dataset16, "dpc", 16, data_parallel=True, view_chunk=8)
    res, params = _train_ranks(dataset16, cfg)
    state, _ = torch_train.train(ConfigDict(
        _cfg(dataset16, "one", 16, view_chunk=0)), device="cpu")
    _close_to(res, params, float(state.best_loss), state.params.numpy())


def test_per_rank_slices_match_one_process_on_the_global_batch(dataset8,
                                                               jax_ref8):
    """data.world_size=2 over 2 ranks, batch 4, data.rank omitted (each
    rank its own slice): JAX's one process on the global batch of 8
    (tests/test_multihost.py's semantics)."""
    cfg = _cfg(dataset8, "ws", 4, data=dict(world_size=2, rank=None))
    res, params = _train_ranks(dataset8, cfg)
    _close_to(res, params, *jax_ref8)


def test_world_size_in_one_process_trains_rank_0s_slice(dataset8):
    """data.world_size=2 in one process trains rank 0's slice of each
    iteration, as JAX's train() does: the same best loss and parameters
    within tests/test_parallel.py's tolerances."""
    cfg = _cfg(dataset8, "ws1", 4, iters=2, data=dict(world_size=2))
    state, _ = torch_train.train(ConfigDict(cfg), device="cpu")
    state_j, _ = jax_train(JaxConfigDict(_cfg(dataset8, "ws1_jax", 4,
                                              iters=2,
                                              data=dict(world_size=2))))
    np.testing.assert_allclose(float(state.best_loss),
                               float(state_j.best_loss), rtol=1e-4)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(state_j.params), atol=2e-6)


def test_spatial_in_one_process_is_disabled_and_trains_unsharded(dataset8,
                                                                 capsys):
    """spatial=2 in one process prints JAX's "incompatible — disabled"
    line and trains as without it, to the bit."""
    cfg = _cfg(dataset8, "sp1", 8, iters=2, spatial=2)
    state, _ = torch_train.train(ConfigDict(cfg), device="cpu")
    out = capsys.readouterr().out
    assert ("spatial=2 incompatible (stage=geometry, devices=1, batch=8, "
            "single-host only) — disabled") in out
    plain, _ = torch_train.train(ConfigDict(_cfg(dataset8, "sp0", 8,
                                                 iters=2)), device="cpu")
    assert torch.equal(state.params, plain.params)
    assert float(state.best_loss) == float(plain.best_loss)
