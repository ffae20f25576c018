"""The rest of the geometry layer against the JAX package on the CPU:
vertex tangents, the tet capsule and the template sphere, the skeleton
geometry (statics, exports, one train step), the energy's autodiff oracle
(value, reverse and forward mode, the dense G operator), the silhouette-
only rasterizer and the MeshRasterizer wrapper."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.geometry.multisphere import \
    TetMeshSkeletonGeometry as JaxSkeleton
from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.geometry.tet_geometry import \
    compute_vertex_tangents as jax_tangents
from tssplat_tpu.mesh import spheres as jax_spheres
from tssplat_tpu.mesh.io import save_obj as jax_save_obj
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops import energy as jax_energy
from tssplat_tpu.ops.rasterize import \
    rasterize_silhouette as jax_rasterize_silhouette
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.ops.transform import transform_pos as jax_transform_pos
from tssplat_tpu.optim import adam_uniform as jax_adam
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.render.pipeline import MeshRasterizer as JaxRasterizer
from tssplat_tpu.train import TrainState as JaxTrainState
from tssplat_tpu.train import make_train_step as jax_make_train_step

from tssplat_torch import config, convert
from tssplat_torch.geometry import (TetMeshGeometry, TetMeshSkeletonGeometry,
                                    compute_vertex_tangents)
from tssplat_torch.mesh import spheres
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops import energy
from tssplat_torch.ops.rasterize import rasterize_silhouette
from tssplat_torch.ops.transform import transform_pos
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.render import MeshRasterizer
from tssplat_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# tangents
# --------------------------------------------------------------------------

def _uv_sphere():
    """An icosphere with spherical UVs (faces as their own UV faces)."""
    v, f = jax_spheres.icosphere(2)
    uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 2], -1, 1)) / np.pi], -1)
    return v.astype(np.float32), f, uv.astype(np.float32)


@pytest.mark.parametrize("given_normals", [False, True])
def test_tangents_match_jax(given_normals):
    """compute_vertex_tangents within 1e-6 of JAX's, with the normals
    computed inside or passed in; unit length and orthogonal to them."""
    v, f, uv = _uv_sphere()
    n = None
    if given_normals:
        n = v / np.linalg.norm(v, axis=1, keepdims=True)
    want = np.asarray(jax_tangents(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(uv), jnp.asarray(f),
        None if n is None else jnp.asarray(n)))
    got = compute_vertex_tangents(
        torch.tensor(v), torch.tensor(f), torch.tensor(uv), torch.tensor(f),
        None if n is None else torch.tensor(n)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_tangents_denominator_clamp():
    """A triangle with a degenerate UV map (every corner at one UV) takes
    the 1e-6 clamp and stays finite, as in JAX."""
    v, f, uv = _uv_sphere()
    uv[f[0]] = uv[f[0, 0]]
    want = np.asarray(jax_tangents(jnp.asarray(v), jnp.asarray(f),
                                   jnp.asarray(uv), jnp.asarray(f)))
    got = compute_vertex_tangents(torch.tensor(v), torch.tensor(f),
                                  torch.tensor(uv), torch.tensor(f)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


# --------------------------------------------------------------------------
# capsule, template sphere
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h, p0, p1, r0, r1", [
    (0.03, (0, 0, 0), (0.3, 0, 0), 0.1, 0.08),
    (0.03, (-0.05, 0.02, 0.0), (0.1, -0.03, 0.1), 0.09, 0.12),
    (0.03, (0, 0, 0), (0, 0, 0.01), 0.1, 0.1),           # shorter than h/2
])
def test_tet_capsule_bit_equal(h, p0, p1, r0, r1):
    v, t = spheres.tet_capsule(h, p0, p1, r0, r1)
    vj, tj = jax_spheres.tet_capsule(h, p0, p1, r0, r1)
    assert v.dtype == vj.dtype and t.dtype == tj.dtype
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(t, tj)


@pytest.mark.parametrize("source", ["icosphere", "icosphere2", "obj"])
def test_load_template_sphere_bit_equal(tmp_path, source):
    path = None
    kw = {"subdivisions": 2} if source == "icosphere2" else {}
    if source == "obj":
        sv, sf = jax_spheres.icosphere(1)
        path = str(tmp_path / "s.1.obj")
        jax_save_obj(path, sv, sf)
    v, f = spheres.load_template_sphere(path, **kw)
    vj, fj = jax_spheres.load_template_sphere(path, **kw)
    assert v.dtype == vj.dtype and f.dtype == fj.dtype
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)


# --------------------------------------------------------------------------
# the skeleton geometry
# --------------------------------------------------------------------------

SKELETON = {"centers": [[[-0.15, 0.0, 0.0], [0.0, 0.0, 0.0]],
                        [[0.0, 0.0, 0.0], [0.15, 0.03, 0.0]]],
            "radii": [[0.10, 0.12], [0.12, 0.10]]}


@pytest.fixture(scope="module")
def skeletons(tmp_path_factory):
    root = tmp_path_factory.mktemp("skel")
    kp = root / "skel.json"
    kp.write_text(json.dumps(SKELETON))
    cfg = {"key_points_file_path": str(kp), "output_path": str(root)}
    return (TetMeshSkeletonGeometry(dict(cfg), device="cpu"),
            JaxSkeleton(dict(cfg)), root)


def test_skeleton_registered_under_both_names():
    for name in ("TetMeshSkeletonGeometry", "TetMeshFish"):
        assert config.load_geometry(name) is TetMeshSkeletonGeometry


def test_skeleton_statics_equal_jax(skeletons):
    """The same capsules, partition and statics as JAX's: every index
    array, the energy's operator tables and the coefficients (smoothness
    scaled by 1/num_spheres)."""
    geo, jgeo, _ = skeletons
    assert geo.num_spheres == jgeo.num_spheres == 2
    assert geo.all_spheres_vtx_idx == jgeo.all_spheres_vtx_idx
    assert geo.all_spheres_elem_idx == jgeo.all_spheres_elem_idx
    np.testing.assert_array_equal(geo.tetmesh.vtx, jgeo.tetmesh.vtx)
    np.testing.assert_array_equal(geo.tetmesh.elem, jgeo.tetmesh.elem)
    want = convert.geometry_statics(jgeo.statics, "cpu")
    for name in ("surface_vid", "surface_fid", "edge_nbrs", "corner_vid"):
        assert torch.equal(getattr(geo.statics, name), getattr(want, name))
    for name in ("tets", "nbrs", "nbr_mask", "degree", "fold_src", "fold_sv",
                 "fold_last"):
        assert torch.equal(getattr(geo.statics.energy, name),
                           getattr(want.energy, name)), name
    np.testing.assert_allclose(geo.statics.energy.dX_inv.numpy(),
                               want.energy.dX_inv.numpy(), rtol=1e-6)
    assert geo.statics.smooth_coeff == want.smooth_coeff
    assert geo.statics.barrier_coeff == want.barrier_coeff
    np.testing.assert_array_equal(geo.tet_v.numpy(), np.asarray(jgeo.tet_v))


def test_skeleton_export_equals_jax(skeletons, tmp_path):
    """The per-sphere exports: the same files, arrays and index JSONs."""
    geo, jgeo, _ = skeletons
    geo.export(str(tmp_path / "t"), "final", save_npy=True)
    jgeo.export(str(tmp_path / "j"), "final", save_npy=True)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert {"final_sp0_vtx.npy", "final_sp1_elem.npy",
            "spheres_vtx_idx.json"} <= set(names)
    for n in names:
        a, b = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif n.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())


def _ellipse_targets(B, res):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:res, 0:res]
    x = (x + 0.5) / res * 2 - 1
    y = (y + 0.5) / res * 2 - 1
    img = np.zeros((B, res, res, 4), np.float32)
    for b in range(B):
        a, c = rng.uniform(0.25, 0.4, 2)
        img[b, ..., 3] = ((x / a) ** 2 + (y / c) ** 2 < 1.0)
    return img


def test_skeleton_train_step_matches_jax(skeletons):
    """One geometry-stage step of each package on its own skeleton
    geometry, 2 views of 128² at iteration 1001, held to tests/
    test_torch_train_step.py's tolerances (loss rtol 1e-5, the gradient
    from AdamUniform's first moment within 1e-4 of its max) apart from
    edge ties: the two clip transforms (torch.einsum, XLA's dot) differ in
    the last bit, which can move an antialias crossing at a pixel on an
    edge. On a longer skeleton (edges of 0.25) one pixel's alpha differed
    by 0.023 and the gradient at 7 vertices by up to 2.3% of the max
    (ROADMAP queue 3); this one has no such pixel. So: at most 2 pixels a
    view whose rendered alpha differs by > 1e-5, the loss within rtol 1e-5
    once those pixels' terms are swapped for JAX's, and the gradient
    within 1e-4 of its max at all but 8 vertices."""
    from tssplat_tpu.render.pipeline import render_views as jax_render
    from tssplat_torch.render.pipeline import render_views
    geo, jgeo, _ = skeletons
    B, res, it = 2, 128, 1001
    opt = dict(grad_limit=True, grad_limit_values=(0.01, 0.01),
               grad_limit_iters=(1500,))
    mvp, _, campos = fibonacci_views(B)
    img = _ellipse_targets(B, res)
    batch_j = {"mvp": jnp.asarray(mvp, jnp.float32),
               "campos": jnp.asarray(campos, jnp.float32),
               "img": jnp.asarray(img),
               "background": jnp.ones((B, res, res, 3), jnp.float32)}
    init_j, update_j = jax_adam(jax_cos(0.2, 1500), **opt)
    step_j = jax_make_train_step(jgeo.statics, update_j,
                                 fitting_stage="geometry", resolution=res,
                                 fit_depth=False, is_ortho=False)
    p = jnp.array(jgeo.tet_v)
    st_j, out_j = step_j(JaxTrainState(p, init_j(p),
                                       jnp.asarray(jnp.inf, jnp.float32),
                                       jnp.zeros((), jnp.int32),
                                       jnp.array(p)), batch_j, it)

    init_t, update_t = adam_uniform(cosine_annealing_lr(0.2, 1500), **opt)
    step_t = make_train_step(geo.statics, update_t, resolution=res)
    st_t, out_t = step_t(init_train_state(geo.tet_v, init_t),
                         {"mvp": torch.tensor(mvp, dtype=torch.float32),
                          "img": torch.from_numpy(img)}, it)
    assert int(out_t[3]) == 0

    a_t = render_views(geo.tet_v, geo.statics, torch.tensor(
        mvp, dtype=torch.float32), it, res).shaded[..., 0].detach().numpy()
    a_j = np.asarray(jax_render(jgeo.tet_v, jgeo.statics,
                                jnp.asarray(mvp, jnp.float32), it,
                                res).shaded[..., 0])
    tie = np.abs(a_t - a_j) > 1e-5
    assert (tie.sum(axis=(1, 2)) <= 2).all(), tie.sum(axis=(1, 2))
    tgt = img[..., 3]
    swap = (((a_t - tgt) ** 2 - (a_j - tgt) ** 2) * tie).sum() \
        / a_t.size * 20.0 * 100.0
    np.testing.assert_allclose(float(out_t[0]) - swap, float(out_j[0]),
                               rtol=1e-5)

    g_j = np.asarray(st_j.opt_state.g1) / 0.1
    g_t = st_t.opt_state.g1.numpy() / 0.1
    scale = np.abs(g_j).max()
    assert scale > 0
    off = np.abs(g_t - g_j).max(axis=1) > 1e-4 * scale
    assert off.sum() <= 8, (np.nonzero(off)[0],
                            np.abs(g_t - g_j).max() / scale)


# --------------------------------------------------------------------------
# the energy's autodiff oracle
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def energy_mesh():
    v, t = jax_spheres.tet_sphere(0.55, radius=1.0)
    return v, t


def _ops(mesh, weighting):
    v, t = mesh
    jops = jax_energy.build_energy_ops(JaxTetMesh(v, t),
                                       laplacian_weighting=weighting)
    return jops, energy.build_energy_ops(TetMesh(v, t), "cpu",
                                         laplacian_weighting=weighting)


@pytest.mark.parametrize("weighting", ["uniform", "volume"])
@pytest.mark.parametrize("order", [2, 4])
def test_energy_oracle_matches_jax_and_closed_form(energy_mesh, weighting,
                                                   order):
    """smooth_barrier_energy_ref: the value within rtol 1e-6 of JAX's
    oracle and of the port's closed form; its autograd gradient within
    5e-5 of the closed form's largest entry (tests/test_energy.py:287-310's
    contract), on a state with inverted tets."""
    jops, ops = _ops(energy_mesh, weighting)
    v, _ = energy_mesh
    rng = np.random.default_rng(1)
    x_np = (v + rng.normal(scale=0.2, size=v.shape)).astype(np.float32)
    e_j = float(jax_energy.smooth_barrier_energy_ref(
        jnp.asarray(x_np), jops, 0.7, 1.3, order))
    x = torch.tensor(x_np, requires_grad=True)
    e_ref = energy.smooth_barrier_energy_ref(x, ops, 0.7, 1.3, order)
    g_ref, = torch.autograd.grad(e_ref, [x])
    x2 = torch.tensor(x_np, requires_grad=True)
    e_cf = energy.smooth_barrier_energy(x2, ops, 0.7, 1.3, order)
    g_cf, = torch.autograd.grad(e_cf, [x2])
    assert float(energy._det3(energy.deformation_gradients(
        x.detach(), ops.tets, ops.dX_inv)).min()) < 0
    np.testing.assert_allclose(float(e_ref), e_j, rtol=1e-6)
    np.testing.assert_allclose(float(e_ref), float(e_cf), rtol=1e-6)
    scale = float(g_cf.abs().max())
    np.testing.assert_allclose(g_ref.numpy() / scale, g_cf.numpy() / scale,
                               atol=5e-5)


@pytest.mark.parametrize("order", [2, 4])
def test_energy_oracle_forward_mode(energy_mesh, order):
    """The oracle works in forward mode (torch.func.jvp), as JAX's does:
    the directional derivative equals JAX's jvp and the reverse gradient's
    dot with the direction."""
    jops, ops = _ops(energy_mesh, "uniform")
    v, _ = energy_mesh
    rng = np.random.default_rng(2)
    x_np = (v + rng.normal(scale=0.2, size=v.shape)).astype(np.float32)
    d_np = rng.normal(size=v.shape).astype(np.float32)

    def f(x):
        return energy.smooth_barrier_energy_ref(x, ops, 0.7, 1.3, order)

    _, tangent = torch.func.jvp(f, (torch.tensor(x_np),),
                                (torch.tensor(d_np),))
    _, t_j = jax.jvp(lambda x: jax_energy.smooth_barrier_energy_ref(
        x, jops, 0.7, 1.3, order), (jnp.asarray(x_np),), (jnp.asarray(d_np),))
    x = torch.tensor(x_np, requires_grad=True)
    g, = torch.autograd.grad(f(x), [x])
    np.testing.assert_allclose(float(tangent), float(t_j), rtol=1e-5)
    np.testing.assert_allclose(float(tangent), float((g * torch.tensor(d_np))
                                                     .sum()), rtol=1e-5)


def test_compute_G_matrix_matches_jax():
    """The dense (T,9,12) operator within 1e-6 of JAX's (relative to its
    largest entry) and reproducing the gather-form F of a deformed state."""
    v, t = jax_spheres.tet_sphere(0.12, radius=0.3)
    G = energy.compute_G_matrix(v, t)
    G_j = np.asarray(jax_energy.compute_G_matrix(v, t))
    assert G.shape == G_j.shape == (t.shape[0], 9, 12)
    scale = np.abs(G_j).max()
    np.testing.assert_allclose(G.numpy() / scale, G_j / scale, atol=1e-6)
    ops = energy.build_energy_ops(TetMesh(v, t), "cpu")
    x = torch.tensor(v + np.random.default_rng(0).normal(
        scale=0.01, size=v.shape), dtype=torch.float32)
    F_dense = (G @ x[torch.as_tensor(t)].reshape(-1, 12, 1))[..., 0]
    F_gather = energy.deformation_gradients(x, ops.tets, ops.dX_inv)
    np.testing.assert_allclose(F_dense.reshape(-1, 3, 3).numpy(),
                               F_gather.numpy(), atol=2e-4)


# --------------------------------------------------------------------------
# rasterize_silhouette, MeshRasterizer
# --------------------------------------------------------------------------

def test_rasterize_silhouette_matches_jax():
    """u = v = 0, no gradient, and z and ids those of JAX's (ids exact but
    at <= 2 pixels on an edge; z within 1e-5)."""
    sv, sf = jax_spheres.icosphere(2)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, _, _ = fibonacci_views(2)
    corner = sv[sf.reshape(-1)].astype(np.float32)
    pos_j = jax_transform_pos(jnp.asarray(mvp, jnp.float32),
                              jnp.asarray(corner))
    tri_c = jnp.arange(3 * sf.shape[0], dtype=jnp.int32).reshape(-1, 3)
    want = np.asarray(jax_rasterize_silhouette(pos_j, tri_c, (64, 64),
                                               corner=True))
    x = torch.tensor(corner, requires_grad=True)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32), x)
    rast, n_drop = rasterize_silhouette(pos, (64, 64))
    assert not rast.requires_grad and int(n_drop.sum()) == 0
    got = rast.numpy()
    assert (got[..., 0:2] == 0).all() and (want[..., 0:2] == 0).all()
    assert (got[..., 3] > 0).sum() > 150
    assert (got[..., 3] != want[..., 3]).sum() <= 2
    same = got[..., 3] == want[..., 3]
    np.testing.assert_allclose(got[..., 2][same], want[..., 2][same],
                               atol=1e-5)


@pytest.mark.parametrize("kw", [dict(only_alpha=True),
                                dict(only_alpha=True, fit_normal=True,
                                     fit_depth=True)],
                         ids=["alpha", "normal_depth"])
def test_mesh_rasterizer_matches_jax(kw):
    """The reference-shaped wrapper on one geometry: the same keys, and
    the shaded alpha, normals and depth of JAX's within 1e-4 but at <= 2
    edge pixels a view, and the energy within rtol 1e-5."""
    v, t = jax_spheres.tet_sphere(0.12, radius=0.3)
    jgeo = JaxGeometry(dict(use_smooth_barrier=True),
                       tetmesh=JaxTetMesh(v, t))
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(v, t), device="cpu")
    mvp, _, campos = fibonacci_views(2)
    extra = {}
    if kw.get("fit_depth"):
        extra["campos"] = campos
    want = JaxRasterizer(jgeo)(jnp.asarray(mvp), iter_num=3, resolution=64,
                               campos=None if not extra else
                               jnp.asarray(campos, jnp.float32), **kw)
    got = MeshRasterizer(geo, cfg={"context_type": "cuda"})(
        mvp, iter_num=3, resolution=64,
        campos=None if not extra else torch.tensor(campos,
                                                   dtype=torch.float32),
        **kw)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(got["geo_regularization"]),
                               float(want["geo_regularization"]), rtol=1e-5)
    for key in ("shaded", "n", "d"):
        if key not in want:
            continue
        a = got[key].detach().numpy()
        b = np.asarray(want[key])
        bad = (np.abs(a - b) > 1e-4).any(-1).sum(axis=(1, 2))
        assert (bad <= 2).all(), (key, bad)
