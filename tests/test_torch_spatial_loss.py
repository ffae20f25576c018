"""The port's row-slab sharded geometry loss (tssplat_torch/parallel/
spatial.py spatial_geometry_loss) over 2 and 3 gloo ranks against the JAX
package's on a (view, sp) mesh of its virtual CPU devices and against the
unsharded loss (tests/test_spatial.py:116-330): the silhouette loss, and
the depth + normal loss; 3 ranks split the rows into padded slabs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.parallel.spatial import (shard_spatial_train_batch,
                                          slab_rows, spatial_geometry_loss,
                                          spatial_mesh)

from tssplat_torch import convert
from tssplat_torch.tools.run_ranks import run_ranks
from tssplat_torch.train import loss_and_grad

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
CASES = [(2, 64, False), (2, 64, True), (3, 56, False), (3, 56, True)]


@pytest.mark.parametrize("n_sp, res, shaded", CASES,
                         ids=[f"sp{n}_{r}_{'depth_normal' if s else 'sil'}"
                              for n, r, s in CASES])
def test_spatial_loss_matches_jax_and_unsharded(tmp_path, n_sp, res,
                                                shaded):
    """n_sp ranks on a (1, n_sp) grid against the port's unsharded
    loss_and_grad (the loss within rtol 1e-5, the gradient within 1e-5 of
    its largest entry) and against JAX's spatial_geometry_loss on a (1,
    n_sp) mesh (the loss within rtol 1e-5, the gradient within 1e-4 of its
    largest entry: the port's unsharded gradient is that far from JAX's
    unsharded one, 1.2e-5 on the silhouette case, tests/
    test_torch_train_step.py's tolerance; ROADMAP queue 3)."""
    v, t = tet_sphere(0.12, radius=0.3)
    geo = JaxGeometry(dict(use_smooth_barrier=True, smooth_barrier_param={
        "smooth_eng_coeff": 1e-3, "barrier_coeff": 1e-3,
        "increase_order_iter": 100}), tetmesh=JaxTetMesh(v, t))
    B = 2
    mvp, _, campos = fibonacci_views(B)
    rng = np.random.default_rng(5)
    batch = {"mvp": mvp.astype(np.float32),
             "campos": campos.astype(np.float32),
             "img": rng.uniform(0, 1, (B, res, res, 4)).astype(np.float32),
             "d": rng.uniform(3, 5, (B, res, res, 1)).astype(np.float32),
             "n": rng.uniform(-1, 1, (B, res, res, 4)).astype(np.float32)}
    np.savez(tmp_path / "batch.npz", **batch)
    it = 3
    out = run_ranks("torch_rank_jobs:spatial_loss", dict(
        batch_npz=str(tmp_path / "batch.npz"), out=str(tmp_path / "g.pt"),
        n_sp=n_sp, res=res, fit_depth=shaded, fit_normal=shaded, it=it),
        world_size=n_sp, timeout=80.0, device="cpu",
        env=dict(os.environ, PYTHONPATH=TESTS))
    assert len({r["loss"] for r in out}) == 1
    assert slab_rows(res, n_sp) * n_sp >= res
    g = torch.load(tmp_path / "g.pt").numpy()

    mesh = spatial_mesh(1, n_sp)
    jb = shard_spatial_train_batch({k: jnp.asarray(x)
                                    for k, x in batch.items()}, mesh)

    def jl(tv):
        return spatial_geometry_loss(tv, geo.statics, jb, it, mesh, res,
                                     fit_depth=shaded, fit_normal=shaded)[0]
    l_j, g_j = jax.jit(jax.value_and_grad(jl))(jnp.asarray(geo.tet_v))
    st = convert.geometry_statics(geo.statics, "cpu")
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    l_u, _, _, _, g_u = loss_and_grad(
        st, torch.from_numpy(np.asarray(geo.tet_v)), tb, it, res,
        fit_depth=shaded, fit_normal=shaded)
    for l_ref, g_ref, tol in ((float(l_u), g_u.numpy(), 1e-5),
                              (float(l_j), np.asarray(g_j), 1e-4)):
        np.testing.assert_allclose(out[0]["loss"], l_ref, rtol=1e-5)
        np.testing.assert_allclose(g, g_ref, atol=tol * np.abs(g_ref).max())
