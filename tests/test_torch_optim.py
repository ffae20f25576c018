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


def _adam_uniform_per_step_constants(lr, b1=0.9, b2=0.999, values=(),
                                     iters=(), eps=1e-8):
    """AdamUniform's update as it was written before its constants were
    made once: every constant copied to the device in each update, the
    grad-limit tables indexed by 0-dim tensors."""
    def update(grads, st):
        dev = grads.device
        step = st.count + 1
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(b1, device=dev), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(b2, device=dev), stepf)
        g1 = b1 * st.g1 + (1.0 - b1) * grads
        g2 = b2 * st.g2 + (1.0 - b2) * grads * grads
        rate = lr(st.count)
        vals = torch.tensor(values, device=dev)
        cap = vals[torch.clamp_max(st.limit_ptr, len(values) - 1)]
        its = torch.tensor(iters, dtype=torch.int32, device=dev)
        reached = st.cc >= its[torch.clamp_max(st.limit_ptr, len(iters) - 1)]
        ptr = st.limit_ptr + ((st.limit_ptr < len(iters)) & reached).to(
            torch.int32)
        gr = (g1 / b1c) / (eps + torch.sqrt(torch.max(g2 / b2c)))
        s = torch.max(torch.abs(gr))
        gr = torch.where(s > cap, gr * (cap / torch.clamp_min(s, 1e-30)), gr)
        return -rate * gr, st._replace(count=step, g1=g1, g2=g2,
                                       limit_ptr=ptr, cc=st.cc + 1)
    return update


def _adam_per_step_constants(lr, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's update as it was written before its constants were made
    once."""
    def update(grads, st):
        dev = grads.device
        mu = (1.0 - b1) * grads + b1 * st.mu
        nu = (1.0 - b2) * (grads * grads) + b2 * st.nu
        count = st.count + 1
        n = count.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), n)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), n)
        rate = lr(st.count) if callable(lr) else torch.tensor(lr, device=dev)
        return -rate * ((mu / c1) / (torch.sqrt(nu / c2) + eps)), \
            st._replace(count=count, mu=mu, nu=nu)
    return update


@pytest.mark.parametrize("kind", ["adam_uniform", "adam", "adam_const_lr"])
def test_constants_made_once_give_the_same_bits(kind):
    """Twenty updates from seeded gradients of varying scale, the state fed
    back each step: the optimizers, their constants made once on the
    device, give the bits of their former per-step copies; AdamUniform's
    cap pointer advances twice on the way (tables (0.05, 0.01, 0.002) at
    counters (6, 13))."""
    if kind == "adam_uniform":
        sched = cosine_annealing_lr(0.2, 20)
        values, iters = (0.05, 0.01, 0.002), (6, 13)
        init, upd = adam_uniform(sched, grad_limit=True,
                                 grad_limit_values=values,
                                 grad_limit_iters=iters)
        before = _adam_uniform_per_step_constants(sched, values=values,
                                                  iters=iters)
    else:
        sched = cosine_decay_schedule(0.2, 20, alpha=5e-4) \
            if kind == "adam" else 0.05
        init, upd = adam(sched)
        before = _adam_per_step_constants(sched)
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    st_a = st_b = init(p)
    ptrs = []
    for _ in range(20):
        g = torch.from_numpy((rng.normal(size=p.shape)
                              * 10.0 ** rng.uniform(-4, 1)).astype(
                                  np.float32))
        u_a, st_a = upd(g, st_a)
        u_b, st_b = before(g, st_b)
        assert torch.equal(u_a.view(torch.int32), u_b.view(torch.int32))
        for a, b in zip(st_a, st_b):
            assert torch.equal(a, b)
        if kind == "adam_uniform":
            ptrs.append(int(st_a.limit_ptr))
    if kind == "adam_uniform":
        assert ptrs == [0] * 6 + [1] * 7 + [2] * 7
