"""The port's AdamUniform (tssplat_torch/optim/adam_uniform.py) against the
JAX package's, step by step from the same seeded gradients, across an
advance of the grad-cap pointer."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tssplat_tpu.optim import adam_uniform as jax_adam
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos

from tssplat_torch import convert
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr

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
