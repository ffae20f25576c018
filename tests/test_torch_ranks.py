"""Rank discovery, the rank launcher and the view group of the port
(tssplat_torch/utils/env.py, tools/run_ranks.py, parallel/mesh.py)
against the JAX package on the CPU: rank discovery, each rank's share of a
batch against what JAX's ``shard_batch`` puts on that device, the
launcher's collectives and failure paths, and the view-sharded exact
texture loss against JAX's (tests/test_texture_exact.py).

Ranks are CPU processes in a gloo group, each started and bounded in time
by ``run_ranks``; their jobs are in ``tests/torch_rank_jobs.py``."""

import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial
from tssplat_tpu.materials import exact_stage as jax_exact
from tssplat_tpu.mesh.spheres import icosphere, tet_sphere
from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.parallel import make_device_mesh
from tssplat_tpu.parallel import shard_batch as jax_shard_batch
from tssplat_tpu.tools.synthetic import render_views_of_mesh
from tssplat_tpu.utils.env import get_rank as jax_get_rank
from tssplat_tpu.utils.env import get_world_size as jax_get_world_size

from tssplat_torch import convert
from tssplat_torch.geometry import TetMeshGeometry
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.utils.tree import tree_leaves
from tssplat_torch.parallel import shard_batch
from tssplat_torch.tools.run_ranks import run_ranks
from tssplat_torch.utils.env import (get_rank, get_world_size,
                                     init_distributed)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
JOBS = "torch_rank_jobs:"
ENV = dict(os.environ, PYTHONPATH=TESTS)
TIMEOUT = 80.0


def _ranks(job, kwargs, world=2, **kw):
    return run_ranks(job, kwargs, world_size=world, timeout=TIMEOUT,
                     device="cpu", env=ENV, **kw)


# ---------------------------------------------------------------------------
# rank discovery and the launcher
# ---------------------------------------------------------------------------

def test_env_rank_matches_jax(monkeypatch):
    """tests/test_utils.py::test_env_rank's cases give the JAX package's
    answers; at world size 1 init_distributed does nothing."""
    for k in ("RANK", "LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK",
              "WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert get_rank() == jax_get_rank() == 0
    assert get_world_size() == jax_get_world_size() == 1
    assert init_distributed(device="cpu") is None
    monkeypatch.setenv("RANK", "3")
    assert get_rank() == jax_get_rank() == 3
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert get_world_size() == jax_get_world_size() == 8
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("SLURM_PROCID", "5")
    assert get_rank() == jax_get_rank() == 5


def test_init_distributed_takes_jax_arguments():
    """init_distributed(coordinator_address=, num_processes=,
    process_id=), JAX's arguments, joins two CPU processes whose
    environment names no rank, world or address: each reports its rank
    and the world of 2, and an all_reduce sums both. num_processes=1 is
    a no-op."""
    import socket
    import subprocess
    import sys
    assert init_distributed(device="cpu", num_processes=1) is None
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "from tssplat_torch.utils import get_rank, get_world_size, "
        "init_distributed\n"
        "i = int(sys.argv[1])\n"
        "dev = init_distributed(device='cpu', coordinator_address="
        f"'127.0.0.1:{port}', num_processes=2, process_id=i)\n"
        "x = torch.tensor([i + 1.0])\n"
        "dist.all_reduce(x)\n"
        "print(dev, get_rank(), get_world_size(), float(x))\n"
        "dist.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
        "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")}
    env["PYTHONPATH"] = os.path.dirname(TESTS)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert out.split() == ["cpu", str(i), "2", "3.0"]


def test_run_ranks_all_reduce_and_broadcast():
    """Three gloo ranks: each result is the job's on its rank, the
    all_reduce sums every rank's value and the broadcast is rank 0's."""
    res = _ranks(JOBS + "sums", {"value": 0.5}, world=3)
    assert [r["rank"] for r in res] == [0, 1, 2]
    assert all(r["world"] == 3 and r["sum"] == 4.5 and r["bcast"] == 0.0
               for r in res)


def test_auto_view_chunk_same_on_every_rank():
    """Under view data parallelism each rank reads its own device's free
    memory. Ranks on either side of the chunk rule's threshold (rank 0
    holds its 60 views at once, rank 1 only 20) still take one chunk, that
    of the least free memory: 40 views, 20 a rank."""
    from tssplat_torch.train import (_FREE_SHARE, _auto_view_chunk,
                                     _bytes_per_view)

    def free(views):
        return math.ceil(views * _bytes_per_view(512, 4096) / _FREE_SHARE)
    alone = [_auto_view_chunk(120, 2, 512, tile_k=4096, free_bytes=free(n))
             for n in (60, 20)]
    assert alone == [0, 40]
    res = _ranks(JOBS + "auto_view_chunk", {
        "free": [free(60), free(20)], "B": 120, "res": 512, "tile_k": 4096})
    assert [r["chunk"] for r in res] == [40, 40]


def test_run_ranks_fails_when_a_rank_raises():
    """A rank that raises fails the call at once (its peer, waiting in a
    collective, is killed), with the rank's error in the message."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _ranks(JOBS + "fail_on", {"rank": 1})
    assert time.monotonic() - t0 < 40.0


def test_run_ranks_kills_a_rank_past_the_deadline(tmp_path):
    """A rank that sleeps past the deadline fails the call within it and
    no rank's process is left."""
    env = dict(ENV, TSS_TEST_DIR=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past 15 s"):
        run_ranks(JOBS + "sleep_on", {"rank": 1, "seconds": 600},
                  world_size=2, timeout=15.0, device="cpu", env=env)
    assert time.monotonic() - t0 < 25.0
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# ---------------------------------------------------------------------------
# a rank's share of a batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view_chunk", [0, 4], ids=["plain", "chunked"])
def test_shard_batch_matches_jax(view_chunk):
    """Each rank's views equal what JAX's shard_batch puts on device r of
    a 2-device view mesh: a contiguous half, or the half of every chunk
    (in chunk order) where the batch is pre-chunked."""
    rng = np.random.default_rng(0)
    batch = {"mvp": rng.normal(size=(8, 4, 4)).astype(np.float32),
             "img": rng.normal(size=(8, 3, 5, 4)).astype(np.float32),
             "view_idx": np.arange(8, dtype=np.int32)}
    mesh = make_device_mesh(2)
    sharded = jax_shard_batch(batch, mesh, view_chunk=view_chunk)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for r in range(2):
        mine = shard_batch(tb, r, 2, view_chunk)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == mesh.devices[r])
            want = np.asarray(shard.data)
            want = want.reshape(-1, *want.shape[2:]) if view_chunk else want
            np.testing.assert_array_equal(mine[k].numpy(), want)


# ---------------------------------------------------------------------------
# the view-sharded exact texture loss
# ---------------------------------------------------------------------------

ENC = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
       "log2_hashmap_size": 12, "base_resolution": 4,
       "per_level_scale": 1.6}


def test_view_sharded_exact_loss_matches_jax(tmp_path):
    """The exact texture loss over 2 ranks (one view each, the loss and the
    parameter gradients summed over the ranks) against the port's one
    process (the loss within rtol 1e-6, the gradients within 1e-6 of their
    max), and against JAX's view-sharded build_texture_exact_loss(mesh=...)
    on a 2-device mesh and JAX's unsharded one: the loss within rtol 1e-5,
    the table's gradient within 2e-4 and the network's within 1e-4 of
    their max (the port's exact loss against JAX's,
    tests/test_torch_texture.py)."""
    res = 64
    v, t = tet_sphere(0.08, radius=0.3)
    geo = JaxGeometry(dict(use_smooth_barrier=False),
                      tetmesh=JaxTetMesh(v, t))
    sv, sf = icosphere(subdivisions=2)
    mvp, _, campos = fibonacci_views(2)
    rgba, _, _ = render_views_of_mesh(sv * np.asarray([0.3, 0.24, 0.18]),
                                      sf, mvp, campos, res)
    bg = np.ones((2, res, res, 3), np.float32)
    rgb = bg + (rgba[..., :3] - bg) * rgba[..., 3:4]
    data = {"mvp": mvp.astype(np.float32), "background": bg,
            "img": np.concatenate([rgb, rgba[..., 3:4]], -1)
            .astype(np.float32)}
    mat = JaxMaterial({"pos_encoding_config": dict(ENC)})
    np.savez(tmp_path / "data.npz", **data)
    np.savez(tmp_path / "params.npz", **{
        f"{g}/{n}": np.asarray(x) for g, d in mat.params.items()
        for n, x in d.items()})
    out = _ranks(JOBS + "exact_loss", dict(
        data_npz=str(tmp_path / "data.npz"),
        params_npz=str(tmp_path / "params.npz"), enc=ENC, res=res,
        out=str(tmp_path / "grads.pt")))
    assert [r["views"] for r in out] == [1, 1]
    assert out[0]["img_loss"] == out[1]["img_loss"]
    grads = torch.load(tmp_path / "grads.pt")

    geo_t = TetMeshGeometry(dict(use_smooth_barrier=False),
                            tetmesh=TetMesh(v, t), device="cpu")
    mat_t = ExplicitMaterial({"pos_encoding_config": dict(ENC)},
                             device="cpu")
    p = {g: {n: x.requires_grad_(True) for n, x in d.items()}
         for g, d in convert.material_params(mat.params, "cpu").items()}
    one = build_texture_exact_loss(mat_t, geo_t.statics,
                                   build_texture_exact_cache(
                                       geo_t, mat_t, {
                                           k: torch.from_numpy(x)
                                           for k, x in data.items()}, res))
    il = one(p, 0)[0]
    g1 = torch.autograd.grad(il * 100.0, tree_leaves(p))
    np.testing.assert_allclose(out[0]["img_loss"], float(il.detach()),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(grads), g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=1e-6 * float(b.abs().max()))

    jdata = {k: jnp.asarray(x) for k, x in data.items()}
    losses = {}
    for n_shards in (1, 2):
        cache = jax_exact.build_texture_exact_cache(geo, mat, jdata, res,
                                                    n_shards=n_shards)
        fn = jax_exact.build_texture_exact_loss(
            mat, geo.statics, cache,
            mesh=make_device_mesh(2) if n_shards > 1 else None)
        losses[n_shards] = jax.jit(jax.value_and_grad(
            lambda q: fn(q, 0)[0] * 100.0))(mat.params)
    for l_j, g_j in losses.values():
        np.testing.assert_allclose(out[0]["img_loss"] * 100.0, float(l_j),
                                   rtol=1e-5)
        for grp, rel in (("encoding", 2e-4), ("network", 1e-4)):
            for n, x in g_j[grp].items():
                x = np.asarray(x)
                np.testing.assert_allclose(
                    grads[grp][n].numpy(), x,
                    atol=rel * max(np.abs(x).max(), 1e-30))
