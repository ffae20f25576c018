"""The antialias pair math on the inputs that corner K4/K5's tiles, runs and
pair list (tssplat_torch/tools/aa_cases.py): the port's plain K4/K5 against
the JAX package on the same numpy inputs. The reference is
``antialias_silhouette_halo`` (its Pallas kernels in interpret mode plus the
XLA border pass) where H and W fill whole 8x128 tiles, else the dense
``antialias`` chain. Tolerances are those of tests/test_torch_kernels.py.
The kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.ops.rasterize import antialias, antialias_silhouette_halo

from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.tools.aa_cases import CASE_NAMES, aa_cases
from tssplat_torch.tools.compare_kernels import aa_pair_counts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases():
    return {name: tuple(t.numpy() for t in inp)
            for name, inp in aa_cases("cpu").items()}


def _coverage_and_rast(ids, z):
    alpha = jnp.clip(ids.astype(jnp.float32), 0.0, 1.0)[..., None]
    rast = jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z,
                      ids.astype(jnp.float32)], axis=-1)
    return alpha, rast


@jax.jit
def _halo_value_and_vjp(ids, z, g6, gaux, ct):
    alpha, rast = _coverage_and_rast(ids, z)
    y, vjp = jax.vjp(lambda g: antialias_silhouette_halo(
        alpha, rast, (g, gaux), interpret=True)[..., 0], g6)
    return y, vjp(ct)[0]


def _jax_aa(ids, z, g6, gaux, ct):
    """JAX's silhouette antialias of the coverage on one case: the dense
    chain's value, the halo path's value (None where H and W do not fill
    8x128 tiles), and jax.vjp w.r.t. g6 under ct of the reference (the halo
    path where it runs, else the dense chain)."""
    B, H, W = ids.shape
    ids, z, g6, gaux, ct = map(jnp.asarray, (ids, z, g6, gaux, ct))
    alpha, rast = _coverage_and_rast(ids, z)
    unused = jnp.zeros((B, 3, 4), jnp.float32)
    no_tris = jnp.zeros((1, 3), jnp.int32)
    # the dense chain op by op: under jit XLA rounds some of its divisions
    # otherwise (up to 3.7e-5 on these cases)
    y_dense, vjp = jax.vjp(lambda g: antialias(
        alpha, rast, unused, no_tris, no_tris, corner=True,
        g_precomputed=(g, gaux))[..., 0], g6)
    if H % 8 or W % 128:
        return np.asarray(y_dense), None, np.asarray(vjp(ct)[0])
    y, dg = _halo_value_and_vjp(ids, z, g6, gaux, ct)
    return np.asarray(y_dense), np.asarray(y), np.asarray(dg)


@pytest.fixture(scope="module")
def jax_refs(cases):
    out = {}
    for name, (ids, z, g6, gaux) in cases.items():
        ct = np.random.default_rng(7).normal(size=ids.shape) \
            .astype(np.float32)
        out[name] = (ct, *_jax_aa(ids, z, g6, gaux, ct))
    return out


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_aa_forward_case_matches_jax(cases, jax_refs, name):
    """Plain K4 against JAX's dense antialias chain (atol 1e-6) and, where
    H and W fill 8x128 tiles, against antialias_silhouette_halo: no further
    from the halo path than JAX's own dense chain is, plus 1e-6. (The halo
    path's interpreted kernels differ from the dense chain by up to 2.4e-6
    on these cases, where a crossing's two edge values nearly cancel.)"""
    ids, z, g6, gaux = cases[name]
    _, want, halo, _ = jax_refs[name]
    got = rk.aa_forward(*map(_torch, (ids, z, g6, gaux))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    if halo is not None:
        assert np.abs(got - halo).max() <= np.abs(want - halo).max() + 1e-6
    if name == "half_step":
        # every crossing at t = 0.5 blends nothing
        assert int((got != (ids > 0)).sum()) <= 4
    else:
        assert int((got != (ids > 0)).sum()) > 100


@pytest.mark.parametrize("name", CASE_NAMES)
def test_aa_backward_case_matches_jax_vjp(cases, jax_refs, name):
    """Plain K5 (hand-derived backward) against jax.vjp of JAX's function
    (the halo path where it runs, else the dense chain): atol 1e-5 of the
    largest gradient entry. At t = 0.5 both take the step's derivative as
    1/2."""
    ids, z, g6, gaux = cases[name]
    ct, _, _, want = jax_refs[name]
    got = rk.aa_backward(*map(_torch, (ids, z, g6, gaux, ct))).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)


def test_pair_counts_on_a_case(cases):
    """aa_pair_counts: the pairs whose ids differ, the pixels whose z decides
    an owner and the owners, counted by hand; the valid pairs fewer
    (interior edges of a mesh differ and are not valid), and their pixels
    at least those that K4 blends."""
    ids, z, g6, gaux = cases["interior_edges"]
    c = aa_pair_counts(*map(_torch, (ids, z, g6, gaux)))
    fg = ids > 0
    need_z, owner = np.zeros_like(fg), np.zeros_like(fg)
    n_differ = 0
    for ax in (2, 1):
        n = ids.shape[ax] - 1
        ida, idb = ids.take(range(n), ax), ids.take(range(1, n + 1), ax)
        za, zb = z.take(range(n), ax), z.take(range(1, n + 1), ax)
        d = (ida != idb) & ((ida > 0) | (idb > 0))
        n_differ += int(d.sum())
        both = d & (ida > 0) & (idb > 0)
        own_a = (ida != 0) & ((idb == 0) | (za <= zb))
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(0, n), slice(1, n + 1)
        lo, hi = tuple(lo), tuple(hi)
        need_z[lo] |= both
        need_z[hi] |= both
        owner[lo] |= d & own_a
        owner[hi] |= d & ~own_a
    assert c["pairs_differ"] == n_differ
    assert c["px_z"] == int(need_z.sum()) > 0
    assert c["px_owner"] == int(owner.sum()) > 0
    assert 0 < c["pairs_valid"] < n_differ
    blended = rk.aa_forward(*map(_torch, (ids, z, g6, gaux))).numpy() != fg
    assert int(blended.sum()) <= c["px_in_a_valid_pair"] \
        <= 2 * c["pairs_valid"]