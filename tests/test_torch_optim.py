"""The port's optimizers against the JAX package's, step by step from the
same seeded gradients: AdamUniform (tssplat_torch/optim/adam_uniform.py)
across an advance of the grad-cap pointer, and Adam with cosine decay
(tssplat_torch/optim/adam.py) against optax."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tssplat_tpu.optim import adam_uniform as jax_adam
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos

from tssplat_torch import convert
from tssplat_torch.optim import (adam, adam_uniform, apply_updates,
                                 cosine_annealing_lr, cosine_decay_schedule)

torch.set_num_threads(1)


@pytest.mark.parametrize("grad_limit", [True, False])
def test_adam_uniform_matches_jax(grad_limit):
    """Eight updates with caps (0.05, 0.01) switching at step 3: the cap is
    read before the pointer advances, so the new cap acts from the next
    step. Gradient scales vary so the cap binds on some steps and not
    others. float32 on both sides; pow/cos round differently: rtol 1e-5."""
    kw = dict(grad_limit=grad_limit, grad_limit_values=(0.05, 0.01),
              grad_limit_iters=(3,))
    init_j, upd_j = jax_adam(jax_cos(0.2, 20), **kw)
    init_t, upd_t = adam_uniform(cosine_annealing_lr(0.2, 20), **kw)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    st_j = init_j(jnp.asarray(p))
    st_t = init_t(torch.from_numpy(p.copy()))
    ptrs = []
    for k in range(8):
        g = (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-4, 1)
             ).astype(np.float32)
        u_j, st_j = upd_j(jnp.asarray(g), st_j, None)
        u_t, st_t = upd_t(torch.from_numpy(g), st_t)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5,
                                   atol=1e-9)
        ref = convert.adam_state(st_j, "cpu")
        for name in ("count", "limit_ptr", "cc"):
            assert int(getattr(st_t, name)) == int(getattr(ref, name))
        np.testing.assert_allclose(st_t.g2.numpy(), ref.g2.numpy(),
                                   rtol=1e-5)
        ptrs.append(int(st_t.limit_ptr))
    assert ptrs == ([0, 0, 0, 1, 1, 1, 1, 1] if grad_limit else [0] * 8)


def test_cosine_lr_matches_jax():
    s_j, s_t = jax_cos(0.2, 1500), cosine_annealing_lr(0.2, 1500)
    for c in (0, 1, 7, 750, 1499, 1500, 4000):
        np.testing.assert_allclose(
            float(s_t(torch.tensor(c, dtype=torch.int32))),
            float(s_j(jnp.int32(c))), rtol=1e-6)


def test_adam_matches_optax():
    """(f) optimizer.type adam: ten updates of the port's Adam against
    optax.adam over optax.cosine_decay_schedule (lr 2e-3 over 400 steps,
    alpha = eta_min / lr, the JAX trainer's setting), from the same seeded
    gradients; the state carried across by convert.optax_adam_state.
    Parameters to rtol 1e-6."""
    import optax
    sched = (2e-3, 400, 1e-4 / 2e-3)
    opt = optax.adam(optax.cosine_decay_schedule(*sched))
    init_t, upd_t = adam(cosine_decay_schedule(*sched))
    rng = np.random.default_rng(0)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    p_j, p_t = jnp.asarray(p), torch.from_numpy(p.copy())
    st_j, st_t = opt.init(p_j), init_t(p_t)
    for _ in range(10):
        g = (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-4, 1)
             ).astype(np.float32)
        u_j, st_j = opt.update(jnp.asarray(g), st_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u_t, st_t = upd_t(torch.from_numpy(g), st_t)
        p_t = apply_updates(p_t, u_t)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
        ref = convert.optax_adam_state(st_j, "cpu")
        assert int(st_t.count) == int(ref.count)
        np.testing.assert_allclose(st_t.nu.numpy(), ref.nu.numpy(), rtol=1e-6)
    assert int(st_t.count) == 10


@pytest.mark.parametrize("count", [0, 1, 7, 200, 399, 400, 4000])
def test_cosine_decay_matches_optax(count):
    import optax
    s_j = optax.cosine_decay_schedule(2e-3, 400, 0.05)
    s_t = cosine_decay_schedule(2e-3, 400, 0.05)
    np.testing.assert_allclose(
        float(s_t(torch.tensor(count, dtype=torch.int32))),
        float(s_j(jnp.int32(count))), rtol=1e-6)
