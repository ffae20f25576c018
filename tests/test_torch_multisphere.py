"""The slice as a whole: the port's multi-sphere geometry (init paths A, B
and C) and its geometry-stage steps on the capped visibility layout —
silhouette only, and with the depth and normal losses — against the JAX
package on the CPU, from the same numpy inputs."""

import json
import os
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from tssplat_tpu.geometry.multisphere import (
    TetMeshMultiSphereGeometry as JaxMultiSphere)
from tssplat_tpu.geometry.tet_geometry import (
    TetMeshGeometry as JaxGeometry, compute_vertex_normals as jax_normals,
    geometry_forward as jax_forward)
from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.ops.rasterize import rasterize_ids
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.train import TrainState as JaxTrainState
from tssplat_tpu.train import make_train_step as jax_make_train_step

from tssplat_torch import convert
from tssplat_torch.geometry import (TetMeshMultiSphereGeometry,
                                    compute_vertex_normals, geometry_forward)
from tssplat_torch.ops import binning
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import bin_faces_capped, uses_capped_layout
from tssplat_torch.ops.transform import transform_pos
from tssplat_torch.optim import (adam, adam_uniform, cosine_annealing_lr,
                                 cosine_decay_schedule)
from tssplat_torch.train import (init_train_state, make_train_step,
                                 validated_tile_k)

torch.set_num_threads(1)

KEY_POINTS = {"pt": [[0.0, 0.0, 0.0], [0.15, 0.05, 0.0], [-0.05, 0.15, 0.1]],
              "r": [0.1, 0.12, 0.11]}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Path A of both packages from one key-points JSON, each in its own
    directories."""
    root = tmp_path_factory.mktemp("spheres")
    kp = root / "kp.json"
    kp.write_text(json.dumps(KEY_POINTS))
    out = {}
    for name, cls, kw in (("jax", JaxMultiSphere, {}),
                          ("torch", TetMeshMultiSphereGeometry,
                           {"device": "cpu"})):
        cfg = dict(use_smooth_barrier=True, key_points_file_path=str(kp),
                   tetwild_cache_folder=str(root / name / "cache"),
                   output_path=str(root / name))
        out[name] = (cls(cfg, **kw), cfg)
    return root, out


def _compare(gj, gt, x):
    """Mesh, statics, smoothness coefficient and the energy at iterations
    0 and 1001 on the perturbed vertices x."""
    np.testing.assert_array_equal(gt.tetmesh.vtx, gj.tetmesh.vtx)
    np.testing.assert_array_equal(gt.tetmesh.elem, gj.tetmesh.elem)
    np.testing.assert_array_equal(gt.tetmesh.surface_fid,
                                  gj.tetmesh.surface_fid)
    np.testing.assert_array_equal(gt.statics.surface_vid.numpy(),
                                  np.asarray(gj.statics.surface_vid))
    np.testing.assert_array_equal(gt.statics.edge_nbrs.numpy(),
                                  np.asarray(gj.statics.edge_nbrs))
    assert gt.statics.smooth_coeff == gj.statics.smooth_coeff == \
        pytest.approx(2e-4 / 3)
    assert gt.all_spheres_vtx_idx == gj.all_spheres_vtx_idx
    assert gt.all_spheres_elem_idx == gj.all_spheres_elem_idx
    for it in (0, 1001):
        e_t = float(geometry_forward(torch.from_numpy(x), gt.statics,
                                     it).energy)
        e_j = float(jax_forward(jnp.asarray(x), gj.statics, it).energy)
        assert e_j > 0
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5)


@pytest.mark.parametrize("path", ["A", "B", "C"])
def test_multisphere_init_paths_match_jax(built, path):
    """(d) TetMeshMultiSphereGeometry init paths A (key points), B
    (precomputed arrays) and C (resume from final.veg) build what the JAX
    class builds from the same files."""
    root, out = built
    gj, cfg_j = out["jax"]
    gt, cfg_t = out["torch"]
    if path == "B":
        gj = JaxMultiSphere(dict(cfg_j, load_precomputed_tetwild_mesh=True))
        gt = TetMeshMultiSphereGeometry(
            dict(cfg_t, load_precomputed_tetwild_mesh=True), device="cpu")
    elif path == "C":
        run = root / "resume"
        gt.export(str(run), "final")
        for f in ("spheres_vtx_idx.json", "spheres_elem_idx.json"):
            assert os.path.exists(run / f)
        assert os.path.exists(run / "final_sp2_vtx.npy")
        gj = JaxMultiSphere(dict(use_smooth_barrier=True,
                                 initial_mesh_path=str(run)))
        gt = TetMeshMultiSphereGeometry(dict(use_smooth_barrier=True,
                                             initial_mesh_path=str(run)),
                                        device="cpu")
    assert gt.num_spheres == 3
    rng = np.random.default_rng(3)
    x = (gt.tetmesh.vtx + rng.normal(scale=0.01, size=gt.tetmesh.vtx.shape)
         ).astype(np.float32)
    _compare(gj, gt, x)


def test_vertex_normals_match_jax(built):
    _, out = built
    gj, _ = out["jax"]
    v = np.asarray(gj.tet_v)[np.asarray(gj.statics.surface_vid)]
    f = np.asarray(gj.statics.surface_fid)
    want = np.asarray(jax_normals(jnp.asarray(v), jnp.asarray(f)))
    got = compute_vertex_normals(torch.tensor(v), torch.tensor(f).long())
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# (e) one train step on the capped layout against JAX's jitted step
# ---------------------------------------------------------------------------

RES = 128
B = 2


def _scene():
    """Three disjoint tet_sphere(0.12, radius=0.3) balls (534 faces) and
    seeded alpha, depth and normal targets at 2 x 128². A scene in which
    no pixel's winner is a depth near-tie: there XLA's arithmetic can pick
    the other face (tests/test_torch_capped.py pins such ties), whose
    barycentrics send the depth and normal gradients to other vertices."""
    parts = [tet_sphere(0.12, radius=0.3, center=c)
             for c in ((0.0, 0.0, 0.0), (0.7, 0.0, 0.0), (0.0, 0.7, 0.0))]
    offs = np.cumsum([0] + [p[0].shape[0] for p in parts])[:-1]
    mesh = TetMesh(np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] + o for p, o in zip(parts, offs)]))
    geo = JaxGeometry(dict(use_smooth_barrier=True), tetmesh=mesh)
    mvp, _, campos = fibonacci_views(B)
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:RES, 0:RES]
    x = (x + 0.5) / RES * 2 - 1
    y = (y + 0.5) / RES * 2 - 1
    img = np.zeros((B, RES, RES, 4), np.float32)
    nrm = np.zeros((B, RES, RES, 3), np.float32)
    for b in range(B):
        a, c = rng.uniform(0.25, 0.4, 2)
        img[b, ..., 3] = (x / a) ** 2 + (y / c) ** 2 < 1.0
        n = np.stack([x, y, np.ones_like(x)], -1) + rng.normal(
            scale=0.1, size=(RES, RES, 3))
        nrm[b] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    depth = (3.8 + 0.1 * x[None] + rng.normal(scale=0.01, size=(B, RES, RES))
             )[..., None].astype(np.float32)
    arrays = dict(mvp=mvp.astype(np.float32),
                  campos=campos.astype(np.float32), img=img, d=depth, n=nrm)
    batch_j = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch_j["background"] = jnp.ones((B, RES, RES, 3), jnp.float32)
    batch_t = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in arrays.items()}
    return geo, batch_j, batch_t


@pytest.fixture(scope="module")
def step_scene():
    return _scene()


@pytest.mark.parametrize("fit", ["silhouette", "depth_normal"])
def test_capped_train_step_matches_jax(step_scene, monkeypatch, fit):
    """One step at iteration 1001 with the capped layout forced on the
    port (K2b without, K2a with depth and normal), against JAX's jitted
    make_train_step(fit_depth=..., fit_normal=..., tile_k=k), whose CPU
    visibility (the XLA-tiled search) keeps every face at this k: loss rtol
    1e-5, the gradient (recovered from the first moment) to 1e-4 of its
    largest entry, no drops. The silhouette step uses AdamUniform, the
    depth + normal step optax's adam with cosine decay."""
    geo, batch_j, batch_t = step_scene
    monkeypatch.setattr(binning, "FLAT_BUDGET_BYTES", 0)
    F = int(geo.statics.surface_fid.shape[0])
    assert uses_capped_layout(F, 14, B, RES, RES)
    statics = convert.geometry_statics(geo.statics, "cpu")
    geo_t = SimpleNamespace(statics=statics,
                            tet_v=convert.tet_v(geo.tet_v, "cpu"))
    k = validated_tile_k(geo_t, batch_t, RES)
    # the precondition: the port's capped visibility equals JAX's
    # brute-force oracle at every pixel of this scene
    pos = transform_pos(batch_t["mvp"], geo_t.tet_v[statics.corner_vid])
    ids = rk.visibility_capped_ids(bin_faces_capped(pos, None, (RES, RES), k),
                                   (RES, RES))[0].numpy()
    brute = rasterize_ids(jnp.asarray(pos.numpy()),
                          jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3),
                          (RES, RES))
    np.testing.assert_array_equal(ids, np.asarray(brute))
    dn = fit == "depth_normal"
    if dn:
        sched_kw = (2e-3, 400, 1e-4 / 2e-3)
        opt = optax.adam(optax.cosine_decay_schedule(*sched_kw))
        init_j = opt.init

        def upd_j(g, s, p=None):
            return opt.update(g, s, p)
        init_t, upd_t = adam(cosine_decay_schedule(*sched_kw))
    else:
        kw = dict(grad_limit=True, grad_limit_values=(0.01, 0.01),
                  grad_limit_iters=(1500,))
        init_j, upd_j = jax_adam_uniform(jax_cos(0.2, 1500), **kw)
        init_t, upd_t = adam_uniform(cosine_annealing_lr(0.2, 1500), **kw)

    step_j = jax_make_train_step(geo.statics, upd_j, fitting_stage="geometry",
                                 resolution=RES, fit_depth=dn, fit_normal=dn,
                                 is_ortho=False, tile_k=k)
    params = jnp.array(geo.tet_v)
    st_j = JaxTrainState(params=params, opt_state=init_j(params),
                         best_loss=jnp.asarray(jnp.inf, jnp.float32),
                         best_iter=jnp.zeros((), jnp.int32),
                         best_params=jnp.array(params))
    st_j, out_j = step_j(st_j, batch_j, 1001)

    step_t = make_train_step(statics, upd_t, resolution=RES, fit_depth=dn,
                             fit_normal=dn, tile_k=k)
    st_t, out_t = step_t(init_train_state(geo_t.tet_v, init_t), batch_t, 1001)

    np.testing.assert_allclose(float(out_t[0]), float(out_j[0]), rtol=1e-5)
    assert int(out_t[3]) == int(out_j[3]) == 0
    if dn:
        g_j = np.asarray(st_j.opt_state[0].mu) / 0.1
        g_t = st_t.opt_state.mu.numpy() / 0.1
    else:
        g_j = np.asarray(st_j.opt_state.g1) / 0.1
        g_t = st_t.opt_state.g1.numpy() / 0.1
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * scale)
