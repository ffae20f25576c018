"""The port's smoothness + barrier energy (tssplat_torch/ops/energy.py)
against the JAX package's: value and gradient from the same numpy inputs,
with the operator tables carried across by tssplat_torch.convert."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.ops import energy as jax_energy

from tssplat_torch import convert
from tssplat_torch.mesh.tetmesh import TetMesh as TorchTetMesh
from tssplat_torch.ops import energy as torch_energy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    v, t = tet_sphere(0.12, radius=0.3)
    return TetMesh(v, t)


def _torch_value_and_grad(x_np, ops, c1, c2, order):
    x = torch.tensor(x_np, dtype=torch.float32, requires_grad=True)
    e = torch_energy.smooth_barrier_energy(x, ops, c1, c2, order)
    e.backward()
    return float(e.detach()), x.grad.numpy()


@pytest.mark.parametrize("weighting", ["uniform", "volume"])
@pytest.mark.parametrize("order", [2, 4])
def test_energy_matches_jax(mesh, weighting, order):
    """Value and gradient at orders 2 and 4 on a state with inverted tets.
    Tolerances: the sums run in another order (value rtol 1e-5); the
    gradient's closed form matches to atol 5e-5 of its largest entry, the
    bound the JAX package holds its own custom VJP to."""
    ops = jax_energy.build_energy_ops(mesh, laplacian_weighting=weighting)
    rng = np.random.default_rng(order)
    x_np = (mesh.vtx_init + rng.normal(scale=0.2, size=mesh.vtx_init.shape)
            ).astype(np.float32)
    c1, c2 = 0.7, 1.3
    x = jnp.asarray(x_np)
    F = jax_energy.deformation_gradients(x, ops.tets, ops.dX_inv)
    assert int(jnp.sum(jax_energy._det3(F) < 0)) > 10     # inverted tets
    e_j, g_j = jax.value_and_grad(lambda xx: jax_energy.smooth_barrier_energy(
        xx, ops, c1, c2, jnp.int32(order)))(x)
    e_t, g_t = _torch_value_and_grad(x_np, convert.energy_ops(ops, "cpu"),
                                     c1, c2, order)
    np.testing.assert_allclose(e_t, float(e_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g_t, g_j, atol=5e-5 * scale)


def test_port_builds_the_same_operators(mesh):
    """The port's own numpy operator build equals the JAX package's."""
    ops_j = convert.energy_ops(jax_energy.build_energy_ops(mesh), "cpu")
    ops_t = torch_energy.build_energy_ops(
        TorchTetMesh(mesh.vtx_init, mesh.elem), "cpu")
    for name in ("dX_inv", "nbr_mask", "degree", "fold_src", "fold_sv",
                 "fold_last"):
        torch.testing.assert_close(getattr(ops_t, name),
                                   getattr(ops_j, name), rtol=0, atol=0)
    # neighbour slot order may differ between the two builds; sets may not
    torch.testing.assert_close(torch.sort(ops_t.nbrs, dim=1).values,
                               torch.sort(ops_j.nbrs, dim=1).values)


def test_unreferenced_vertex_gets_zero_gradient():
    """A vertex no tet references gets an exactly-zero gradient (the fold's
    -1 sentinel; tests/test_energy.py:323 on the JAX side)."""
    v, t = tet_sphere(0.2, radius=0.3)
    v2 = np.concatenate([v, np.asarray([[9.0, 9.0, 9.0]])], axis=0)
    ops = torch_energy.build_energy_ops(TorchTetMesh(v2, t), "cpu")
    assert int(ops.fold_last[-1]) == -1
    x = torch.tensor(v2 * 1.03, dtype=torch.float32, requires_grad=True)
    torch_energy.smooth_barrier_energy(x, ops, 1.0, 1.0, 2).backward()
    assert float(x.grad[-1].abs().max()) == 0.0
    assert float(x.grad[:-1].abs().max()) > 0.0


@pytest.mark.parametrize("it", [0, 1, 299, 600, 1200, 5000])
def test_coeff_schedule_matches_jax(it):
    c1_j, c2_j = jax_energy.energy_coeff_schedule(it, 2e-4, 3e-4)
    c1_t, c2_t = torch_energy.energy_coeff_schedule(it, 2e-4, 3e-4)
    np.testing.assert_allclose([c1_t, c2_t], [float(c1_j), float(c2_j)],
                               rtol=1e-6)
    assert torch_energy.barrier_order(it, 1000) == \
        int(jax_energy.barrier_order(it, 1000))
