"""The port's colour-field modules (tssplat_torch/models/networks.py,
tssplat_torch/materials/explicit_material.py) and its optimizers over a
dict of leaves, against the JAX package's on the same numpy inputs.

Encodings are small (4-6 levels, log2_hashmap_size 10-12) so that dense
and hashed levels both occur."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial
from tssplat_tpu.materials import contract_to_unisphere as jax_contract
from tssplat_tpu.models import networks as jn
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos

from tssplat_torch import convert
from tssplat_torch.materials import ExplicitMaterial, contract_to_unisphere
from tssplat_torch.models import networks as tn
from tssplat_torch.ops import hash_grid as hg
from tssplat_torch.optim import (adam, adam_uniform, apply_updates,
                                 cosine_annealing_lr, cosine_decay_schedule)
from tssplat_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

GRIDS = {
    # levels 4, 7 dense; 14, 27, 52 hashed in a 2^10 table
    "mixed": dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=10,
                  base_resolution=4, per_level_scale=1.9),
    # every level dense but the last two of six, F = 4
    "wide": dict(n_levels=6, n_features_per_level=4, log2_hashmap_size=12,
                 base_resolution=3, per_level_scale=1.6),
}


def _x(n, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_hash_grid_matches_jax(grid):
    """Forward within rtol 1e-6 (the same corner order and product order as
    JAX); the table and position gradients under a seeded cotangent within
    1e-5 of their max (autograd's scatter-add sums in another order than
    XLA's)."""
    cfg = GRIDS[grid]
    res, dense, _ = jn._grid_levels(cfg["n_levels"], cfg["base_resolution"],
                                    cfg["per_level_scale"],
                                    cfg["log2_hashmap_size"])
    assert any(dense) and not all(dense)
    je, te = jn.hash_grid_encoding(3, **cfg), tn.hash_grid_encoding(3, **cfg)
    table = np.asarray(je.init_fn(jax.random.PRNGKey(1))["table"]) * 1e3
    x = _x(700)
    ct = np.random.default_rng(2).normal(size=(700, te.n_output_dims)) \
        .astype(np.float32)

    def f(t, xx):
        return jnp.sum(je.apply_fn({"table": t}, xx) * ct)

    y_j = np.asarray(je.apply_fn({"table": jnp.asarray(table)},
                                 jnp.asarray(x)))
    gt_j, gx_j = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x)))

    tt = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y_t = te.apply_fn({"table": tt}, xt)
    (y_t * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-6,
                               atol=1e-7 * np.abs(y_j).max())
    for got, want in ((tt.grad, gt_j), (xt.grad, gx_j)):
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


def test_hash_coords_wrap_like_uint32():
    """The int64 hash equals numpy's uint32 arithmetic with wraparound on
    coordinates up to 2^13."""
    c = np.random.default_rng(3).integers(0, 1 << 13, (4096, 3))
    cu = c.astype(np.uint32)
    p = jn._HASH_PRIMES
    want = ((cu[:, 0] * p[0]) ^ (cu[:, 1] * p[1]) ^ (cu[:, 2] * p[2])) \
        % np.uint32(1 << 12)
    got = hg.hash_coords(torch.from_numpy(c), 1 << 12)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_stochastic_table_grad_unbiased_given_jax_draws():
    """With JAX's uniforms u fed in, the stochastic table gradient of one
    draw equals JAX's (within 1e-5 of its max); over 400 of JAX's draws
    its mean approaches the exact 8-corner gradient (within 0.15 of its
    max, the bound of tests/test_texture_stage.py:317); the forward and
    the position gradient stay exact."""
    cfg = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=8,
               base_resolution=4, per_level_scale=1.7,
               stochastic_table_grad=True)
    je, te = jn.hash_grid_encoding(3, **cfg), tn.hash_grid_encoding(3, **cfg)
    params = je.init_fn(jax.random.PRNGKey(0))
    table = np.asarray(params["table"])
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (64, 3)))
    w = np.arange(te.n_output_dims, dtype=np.float32)

    def loss_t(u=None):
        tt = torch.tensor(table, requires_grad=True)
        xt = torch.tensor(x, requires_grad=True)
        y = te.apply_fn({"table": tt}, xt, grad_u=u)
        v = torch.sum(torch.sin(3.0 * y) * torch.from_numpy(w))
        v.backward()
        return float(v.detach()), tt.grad.numpy(), xt.grad.numpy()

    def loss_j(p, xx, gk=None):
        y = je.apply_fn(p, xx, grad_key=gk)
        return jnp.sum(jnp.sin(3.0 * y) * w)

    v_exact, g_exact, gx_exact = loss_t()
    scale = np.abs(g_exact).max()
    acc = np.zeros_like(g_exact)
    K = 400
    for i in range(K):
        key = jax.random.PRNGKey(100 + i)
        u = np.asarray(jax.random.uniform(key, (64, 3)))
        v, g, gx = loss_t(torch.tensor(u))
        if i < 3:
            g_j = np.asarray(jax.grad(loss_j)(params, jnp.asarray(x),
                                              key)["table"])
            np.testing.assert_allclose(g, g_j, atol=1e-5 * scale)
            assert v == v_exact
            np.testing.assert_allclose(gx, gx_exact, rtol=1e-6,
                                       atol=1e-9)
        acc += g
    acc /= K
    assert np.abs(acc - g_exact).max() / scale < 0.15


@pytest.mark.parametrize("otype", ["ProgressiveBandHashGrid",
                                   "ProgressiveBandFrequency"])
def test_progressive_encodings_match_jax(otype):
    """get_encoding of a progressive hash grid (2 levels at step 0, one
    more every 10) and of masked frequencies (n_masking_step 20, xyz
    included) at several steps: rtol 1e-6."""
    if otype == "ProgressiveBandHashGrid":
        cfg = dict(otype=otype, start_level=2, start_step=0,
                   update_steps=10, **GRIDS["mixed"])
    else:
        cfg = dict(otype=otype, n_frequencies=6, n_masking_step=20,
                   include_xyz=True)
    je, te = jn.get_encoding(3, cfg), tn.get_encoding(3, cfg)
    assert je.n_output_dims == te.n_output_dims
    p_j = je.init_fn(jax.random.PRNGKey(0))
    p_t = convert.material_params({"e": p_j}, "cpu")["e"] if p_j else {}
    x = _x(300, seed=4)
    for step in (0, 5, 10, 17, 35, 1000):
        want = np.asarray(je.apply_fn(p_j, jnp.asarray(x), step))
        got = te.apply_fn(p_t, torch.from_numpy(x), step).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mlp", ["VanillaMLP", "SphereInitVanillaMLP"])
def test_mlps_match_jax(mlp):
    """get_mlp with JAX's initial weights carried across: the output and the
    weight gradients under a seeded cotangent within rtol 1e-5 (the
    matmuls' summation order differs)."""
    cfg = dict(otype=mlp, n_neurons=32, n_hidden_layers=2,
               activation="ReLU", output_activation="sigmoid")
    mj, mt = jn.get_mlp(10, 3, cfg), tn.get_mlp(10, 3, cfg)
    p_j = mj.init_fn(jax.random.PRNGKey(5))
    p_t = {k: v.requires_grad_(True) for k, v in
           convert.material_params({"n": p_j}, "cpu")["n"].items()}
    x = np.random.default_rng(6).normal(size=(200, 10)).astype(np.float32)
    ct = np.random.default_rng(7).normal(size=(200, 3)).astype(np.float32)
    y_j = np.asarray(mj.apply_fn(p_j, jnp.asarray(x)))
    g_j = jax.grad(lambda p: jnp.sum(mj.apply_fn(p, jnp.asarray(x)) * ct))(
        p_j)
    y_t = mt.apply_fn(p_t, torch.from_numpy(x))
    (y_t * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-5,
                               atol=1e-6)
    for k in p_t:
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(p_t[k].grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_contract_to_unisphere_matches_jax():
    """Bounded and unbounded contraction of points inside and outside the
    box: rtol 1e-6."""
    x = np.random.default_rng(8).uniform(-2.0, 2.0, (500, 3)) \
        .astype(np.float32)
    bbox = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)
    for unbounded in (False, True):
        want = np.asarray(jax_contract(jnp.asarray(x), jnp.asarray(bbox),
                                       unbounded))
        got = contract_to_unisphere(torch.from_numpy(x),
                                    torch.from_numpy(bbox), unbounded)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_material_matches_jax_and_npz_roundtrips(tmp_path):
    """ExplicitMaterial (default MLP, a small grid): with JAX's parameters
    carried across, colours at world points within rtol 1e-5; the port's
    initial parameters have JAX's names and shapes; a material.npz written
    by either package loads in the other, leaf for leaf."""
    cfg = {"pos_encoding_config": dict(otype="HashGrid", **GRIDS["mixed"]),
           "seed": 3}
    mj, mt = JaxMaterial(cfg), ExplicitMaterial(cfg, device="cpu")
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(mj.params)] \
        == [tuple(a.shape) for a in tree_leaves(mt.params)]
    mt.params = convert.material_params(mj.params, "cpu")
    pts = np.random.default_rng(9).uniform(-0.4, 0.4, (400, 3)) \
        .astype(np.float32)
    want = np.asarray(mj.apply_fn(mj.params, jnp.asarray(pts)))
    got = mt.apply_fn(mt.params, torch.from_numpy(pts))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)

    mj.export(str(tmp_path), "jax")
    back = ExplicitMaterial(cfg, device="cpu")
    back.load(str(tmp_path / "jax" / "material.npz"))
    for a, b in zip(tree_leaves(back.params),
                    jax.tree_util.tree_leaves(mj.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    fresh = ExplicitMaterial(dict(cfg, seed=4), device="cpu")
    fresh.export(str(tmp_path), "torch")
    with np.load(tmp_path / "torch" / "material.npz") as f, \
            np.load(tmp_path / "jax" / "material.npz") as g:
        assert sorted(f.files) == sorted(g.files)
    mj.load(str(tmp_path / "torch" / "material.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(mj.params),
                    tree_leaves(fresh.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _material_grads(rng, scale):
    """Gradients shaped like a small material's leaves, keys unsorted."""
    return {"network": {"l1_w": rng.normal(size=(8, 3)) * scale,
                        "l0_b": rng.normal(size=(8,)) * scale * 0.1,
                        "l0_w": rng.normal(size=(6, 8)) * scale,
                        "l1_b": rng.normal(size=(3,)) * scale},
            "encoding": {"table": rng.normal(size=(40, 2)) * scale * 1e-3}}


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("opt", ["adam_uniform", "adam"])
def test_optimizers_over_a_dict_match_jax(opt):
    """AdamUniform (caps 0.05 / 0.01, pointer at 12) and Adam (optax) over a
    five-leaf dict, nine updates: each leaf's update within rtol 1e-5. For
    AdamUniform each leaf is normalised by its own max and capped alone,
    and the counter advances by 5 a step, so the pointer moves at the
    fourth step (cc 15 >= 12), as JAX's state shows too."""
    import optax
    rng = np.random.default_rng(10)
    p = _f32(_material_grads(rng, 1.0))
    if opt == "adam_uniform":
        kw = dict(grad_limit=True, grad_limit_values=(0.05, 0.01),
                  grad_limit_iters=(12,))
        init_j, upd_j = jax_adam_uniform(jax_cos(0.2, 20), **kw)
        init_t, upd_t = adam_uniform(cosine_annealing_lr(0.2, 20), **kw)
    else:
        sched = optax.cosine_decay_schedule(2e-3, 20, alpha=0.05)
        o = optax.adam(sched)
        init_j = o.init

        def upd_j(g, s, p):
            return o.update(g, s, p)
        init_t, upd_t = adam(cosine_decay_schedule(2e-3, 20, alpha=0.05))
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = convert.material_params(p, "cpu")
    st_j, st_t = init_j(pj), init_t(pt)
    ptrs = []
    for k in range(9):
        g = _f32(_material_grads(rng, 10.0 ** rng.uniform(-3, 1)))
        u_j, st_j = upd_j(jax.tree_util.tree_map(jnp.asarray, g), st_j, pj)
        u_t, st_t = upd_t(convert.material_params(g, "cpu"), st_t)
        for a, b in zip(tree_leaves(u_t), jax.tree_util.tree_leaves(u_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-9)
        pt = apply_updates(pt, u_t)
        pj = jax.tree_util.tree_map(lambda a, b: a + b, pj, u_j)
        if opt == "adam_uniform":
            ref = convert.adam_state(st_j, "cpu")
            assert int(st_t.cc) == int(ref.cc) == 5 * (k + 1)
            assert int(st_t.limit_ptr) == int(ref.limit_ptr)
            ptrs.append(int(st_t.limit_ptr))
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    if opt == "adam_uniform":
        assert ptrs == [0, 0, 0, 1, 1, 1, 1, 1, 1]
