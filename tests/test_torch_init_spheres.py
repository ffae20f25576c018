"""The port's sphere initialisation (``tssplat_torch.tools.init_spheres``)
against the JAX package's, stage by stage, on the CPU: the dumbbell of
tests/test_init_spheres.py (two icosphere(3) balls of radius 0.3 at
x = +-0.45) seen by JAX's writer at 8 views of 64². Each stage is fed the
JAX package's output of the stage before it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops.queries import signed_distance as jax_sd
from tssplat_tpu.tools import init_spheres as J
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset

from tssplat_torch.mesh.io import load_obj
from tssplat_torch.tools import init_spheres as T

torch.set_num_threads(1)

SURF_RES, NUM_ITER = 24, 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("init_spheres")
    sv, sf = icosphere(subdivisions=3)
    v = np.concatenate([sv * 0.3 + [-0.45, 0, 0], sv * 0.3 + [0.45, 0, 0]])
    f = np.concatenate([sf, sf + sv.shape[0]])
    jax_write_dataset(str(root / "img"), v, f, n_views=8, resolution=64)
    imgs, mvps = J.load_data(str(root / "img"))
    occ, origin, spacing = J.visual_hull(imgs, mvps, SURF_RES)
    hv, hf = J.hull_surface_mesh(occ, origin, spacing)
    return dict(root=root, imgs=imgs, mvps=mvps, hull=(hv, hf))


def _near_pixel_border(mvps, res, pts, tol=1e-4):
    """(n,) bool: the point lands within ``tol`` px of a pixel border in
    some view (float64 projection)."""
    p4 = np.concatenate([pts, np.ones_like(pts[:, :1])], 1)
    near = np.zeros(pts.shape[0], bool)
    for m in mvps:
        p = p4 @ m.astype(np.float64).T
        c = (p[:, :2] / p[:, 3:4] * 0.5 + 0.5) * res
        near |= (np.abs(c - np.round(c)) < tol).any(1)
    return near


@pytest.mark.parametrize("dim", [24, 50])
def test_visual_hull_matches_jax(data, dim):
    """load_data reads what JAX's reads; the occupancy equals JAX's but at
    cells that land within 1e-4 px of a pixel border in some view (none
    here)."""
    imgs, mvps = T.load_data(str(data["root"] / "img"))
    assert all(np.array_equal(a, b) for a, b in zip(imgs, data["imgs"]))
    assert all(np.array_equal(a, b) for a, b in zip(mvps, data["mvps"]))
    oj, oo, sp = J.visual_hull(imgs, mvps, dim)
    ot, oo2, sp2 = T.visual_hull(imgs, mvps, dim, device="cpu")
    assert np.array_equal(oo, oo2) and sp == sp2
    assert 0 < ot.sum() < ot.size
    lin = np.linspace(-1.2, 1.2, dim).astype(np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    differ = (oj != ot).reshape(-1)
    assert np.all(_near_pixel_border(mvps, 64, g.reshape(-1, 3)[differ]
                                     .astype(np.float64)))
    print(f"hull {dim}³: {int(ot.sum())} cells in, {int(differ.sum())} "
          f"differ at pixel borders")


def test_local_shape_diameter_matches_jax(data):
    """The LSD of JAX's hull mesh within rtol 1e-4 of JAX's."""
    hv, hf = data["hull"]
    nrm = J._vertex_normals(hv, hf)
    assert np.array_equal(nrm, T._vertex_normals(hv, hf))
    lj = J.local_shape_diameter(hv, nrm, hv, hf)
    lt = T.local_shape_diameter(hv, nrm, hv, hf, device="cpu")
    assert lt.shape == (hv.shape[0], 1)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


def _jax_grad(x, noise, hv, hf):
    """JAX's smoothed_sdf_grad (init_spheres.py:177-191), outside its
    closure: jax.grad through the Gaussian weights, the neighbours'
    distances held constant."""
    mv, mf = jnp.asarray(hv, jnp.float32), jnp.asarray(hf, jnp.int32)

    def f(xq, noise):
        neighbs = jax.lax.stop_gradient(xq)[:, None, :] + noise
        sd = jax_sd(neighbs.reshape(-1, 3), mv, mf)
        sd = jax.lax.stop_gradient(sd.reshape(xq.shape[0], -1))
        d = jnp.linalg.norm(xq[:, None, :] - neighbs, axis=-1)
        w = jnp.exp(-d ** 2 / 0.002)
        w = w / jnp.sum(w, axis=1, keepdims=True)
        return jnp.sum(sd * w)
    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x), jnp.asarray(noise)))


def test_skeleton_step_gradient_matches_jax(data):
    """One skeleton step's gradient on the hull's first skeleton points and
    the JAX package's noise draw, within 1e-4 of its largest component."""
    hv, hf = data["hull"]
    nrm = J._vertex_normals(hv, hf)
    x = (hv - 0.5 * J.local_shape_diameter(hv, nrm, hv, hf) * nrm) \
        .astype(np.float32)
    rng = np.random.default_rng(1)
    noise = np.clip(0.003 * rng.standard_normal((x.shape[0], 20, 3)),
                    None, 0.01).astype(np.float32)
    gj = _jax_grad(x, noise, hv, hf)
    gt = T.smoothed_sdf_grad(torch.tensor(x), torch.tensor(noise),
                             torch.tensor(hv, dtype=torch.float32),
                             torch.tensor(hf)).numpy()
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("num_iter", [1, NUM_ITER])
def test_skeleton_matches_jax(data, num_iter):
    """min_sdf_skeleton of JAX's hull after 1 and 6 iterations within 1e-5
    of JAX's (the same numpy draws, the freeze rule of iteration 10 not yet
    reached)."""
    hv, hf = data["hull"]
    sj = J.min_sdf_skeleton(hv, hf, num_iter=num_iter)
    times = {}
    st = T.min_sdf_skeleton(hv, hf, num_iter=num_iter, device="cpu",
                            times=times)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    assert np.abs(st - hv).max() > 1e-3 and set(times) == {"lsd",
                                                           "skeleton"}


def test_cover_from_jax_skeleton_is_bit_equal(data):
    """The MILP cover of JAX's skeleton (select_spheres) equals JAX's
    generate_spheres bit for bit."""
    hv, hf = data["hull"]
    skel = J.min_sdf_skeleton(hv, hf, num_iter=NUM_ITER)
    pj, rj = J.generate_spheres(hv, hf, 1.1, 0.06, "", num_iter=NUM_ITER)
    pt, rt = T.select_spheres(skel, hv, 1.1, 0.06)
    assert pj.shape[0] >= 2
    assert np.array_equal(pt, pj) and np.array_equal(rt, rj)


def test_main_pipeline_matches_jax(data, tmp_path):
    """The CLI end to end at surf_res 24, num_iter 6: the same sphere count,
    key points and radii within 1e-4, the JSON and the OBJs written, both
    lobes covered."""
    pj, rj = J.main_pipeline(str(data["root"] / "img"), "db",
                             str(tmp_path / "jax"), surf_res=SURF_RES,
                             num_iter=NUM_ITER)
    pt, rt = T.main(["--img_path", str(data["root"] / "img"), "--expr_name",
                     "db", "--save_path", str(tmp_path / "torch"),
                     "--surf_res", str(SURF_RES), "--num_iter",
                     str(NUM_ITER)], device="cpu")
    assert pt.shape == pj.shape and pt.shape[0] >= 2
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-4)
    kp = json.loads((tmp_path / "torch" / "db.json").read_text())
    np.testing.assert_allclose(kp["pt"], pt)
    np.testing.assert_allclose(kp["r"], rt[:, 0])
    assert (pt[:, 0] < 0).any() and (pt[:, 0] > 0).any() and (rt > 0).all()
    sv, sf = load_obj(str(tmp_path / "torch" / "db_surf.obj"))
    jv, jf = load_obj(str(tmp_path / "jax" / "db_surf.obj"))
    assert np.array_equal(sf, jf) and np.allclose(sv, jv, atol=1e-7)
