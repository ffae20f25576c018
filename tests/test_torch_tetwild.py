"""The TetWild path of the multi-sphere geometry (init path A with an
existing ``tetwild_exec``) against the JAX package's, both driving the same
stand-in executable (``tssplat_torch/tools/tetwild_stub.py``, written into
the test's directory): the same files and meshes to the bit, the same first
train step, and a failing executable that makes the port raise."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tssplat_tpu.geometry.multisphere import (
    TetMeshMultiSphereGeometry as JaxMultiSphere)
from tssplat_tpu.mesh.io import save_obj
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.train import TrainState as JaxTrainState
from tssplat_tpu.train import make_train_step as jax_make_train_step

from tssplat_torch import convert
from tssplat_torch.geometry import TetMeshMultiSphereGeometry
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.tetwild_stub import write_tetwild_stub
from tssplat_torch.train import (init_train_state, make_train_step,
                                 validated_tile_k)

torch.set_num_threads(1)

# three disjoint spheres: no pixel's winner is a depth near-tie between
# two spheres (tests/test_torch_multisphere.py)
KEY_POINTS = {"pt": [[0.0, 0.0, 0.0], [0.32, 0.05, 0.0], [-0.05, 0.32, 0.1]],
              "r": [0.1, 0.12, 0.11]}
RES = 128
B = 2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The stand-in executable, the key points and a template sphere OBJ
    (icosphere(2), 320 triangles) in one directory."""
    root = tmp_path_factory.mktemp("tetwild")
    write_tetwild_stub(str(root / "tetwild"))
    (root / "kp.json").write_text(json.dumps(KEY_POINTS))
    v, f = icosphere(subdivisions=2)
    save_obj(str(root / "template.obj"), v, f)
    return root


def _build(root, name, template, exe="tetwild"):
    """Path A through ``exe`` in ``root/name`` (its own cache folder and
    output directory); JAX's geometry for ``name`` "jax", else the
    port's on the CPU."""
    cfg = dict(use_smooth_barrier=True,
               key_points_file_path=str(root / "kp.json"),
               template_surface_sphere_path=template,
               tetwild_exec=str(root / exe),
               tetwild_cache_folder=str(root / name / "cache"),
               output_path=str(root / name))
    if name.startswith("jax"):
        return JaxMultiSphere(cfg)
    return TetMeshMultiSphereGeometry(cfg, device="cpu")


@pytest.fixture(scope="module")
def built(root):
    """Both packages' geometries through the stand-in on the OBJ template."""
    tmpl = str(root / "template.obj")
    return _build(root, "jax", tmpl), _build(root, "torch", tmpl)


@pytest.mark.parametrize("template", ["obj", "default"])
def test_tetwild_spheres_match_jax(root, built, template):
    """Vertices, tets, surface, the per-sphere index lists and every file
    of the cache folder and final/ (the template OBJs, the executable's
    arrays, final_tet_{v,t}.npy and the index JSONs) equal JAX's to the
    bit; every tet is positive. ``default`` is gso.yaml's empty template
    path (icosphere(3))."""
    if template == "obj":
        gj, gt = built
        tag_j, tag_t = "jax", "torch"
    else:
        tag_j, tag_t = "jax_default", "torch_default"
        gj, gt = _build(root, tag_j, ""), _build(root, tag_t, "")
    n_tri = 320 if template == "obj" else 1280
    assert gt.num_spheres == 3
    assert gt.tetmesh.num_tets == 3 * n_tri      # a cone on each triangle
    np.testing.assert_array_equal(gt.tetmesh.vtx, gj.tetmesh.vtx)
    np.testing.assert_array_equal(gt.tetmesh.elem, gj.tetmesh.elem)
    np.testing.assert_array_equal(gt.tetmesh.surface_fid,
                                  gj.tetmesh.surface_fid)
    assert gt.all_spheres_vtx_idx == gj.all_spheres_vtx_idx
    assert gt.all_spheres_elem_idx == gj.all_spheres_elem_idx
    assert (gt.tetmesh.rest_matrices()[1] > 0).all()
    for sub in ("cache", "final"):
        names = sorted(os.listdir(root / tag_t / sub))
        assert names == sorted(os.listdir(root / tag_j / sub))
        for n in names:
            assert filecmp.cmp(root / tag_t / sub / n, root / tag_j / sub / n,
                               shallow=False), n
    want = {f"temp{i}{s}" for i in range(3)
            for s in (".obj", ".msh_VO.npy", ".msh_TO.npy")}
    assert want <= set(os.listdir(root / tag_t / "cache"))


def _batch():
    """Seeded ellipse silhouettes at B x RES², both packages' batches."""
    mvp, _, campos = fibonacci_views(B)
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:RES, 0:RES]
    x = (x + 0.5) / RES * 2 - 1
    y = (y + 0.5) / RES * 2 - 1
    img = np.zeros((B, RES, RES, 4), np.float32)
    for b in range(B):
        a, c = rng.uniform(0.25, 0.4, 2)
        img[b, ..., 3] = (x / a) ** 2 + (y / c) ** 2 < 1.0
    arrays = dict(mvp=mvp.astype(np.float32),
                  campos=campos.astype(np.float32), img=img)
    batch_j = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch_j["background"] = jnp.ones((B, RES, RES, 3), jnp.float32)
    return batch_j, {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("it", [0, 1001])
def test_tetwild_train_step_matches_jax(built, it):
    """One geometry-stage step of each package's TetWild geometry on the
    same views (gso.yaml's AdamUniform, lr 0.2 cosine over 1500, caps
    0.01), at the first iteration and after the barrier's order switch:
    loss rtol 1e-5, the gradient (from the first moment) within 1e-4 of
    its largest entry, no drops (tests/test_torch_multisphere.py's
    tolerances)."""
    gj, gt = built
    batch_j, batch_t = _batch()
    kw = dict(grad_limit=True, grad_limit_values=(0.01, 0.01),
              grad_limit_iters=(1500,))
    init_j, upd_j = jax_adam_uniform(jax_cos(0.2, 1500), **kw)
    init_t, upd_t = adam_uniform(cosine_annealing_lr(0.2, 1500), **kw)
    k = validated_tile_k(gt, batch_t, RES)

    step_j = jax_make_train_step(gj.statics, upd_j, fitting_stage="geometry",
                                 resolution=RES, fit_depth=False,
                                 fit_normal=False, is_ortho=False, tile_k=k)
    params = jnp.array(gj.tet_v)
    st_j = JaxTrainState(params=params, opt_state=init_j(params),
                         best_loss=jnp.asarray(jnp.inf, jnp.float32),
                         best_iter=jnp.zeros((), jnp.int32),
                         best_params=jnp.array(params))
    st_j, out_j = step_j(st_j, batch_j, it)

    statics = convert.geometry_statics(gj.statics, "cpu")
    np.testing.assert_array_equal(statics.edge_nbrs.numpy(),
                                  gt.statics.edge_nbrs.numpy())
    step_t = make_train_step(gt.statics, upd_t, resolution=RES, tile_k=k)
    st_t, out_t = step_t(init_train_state(gt.tet_v, init_t), batch_t, it)

    assert float(out_j[0]) > 0
    np.testing.assert_allclose(float(out_t[0]), float(out_j[0]), rtol=1e-5)
    assert int(out_t[3]) == int(out_j[3]) == 0
    g_j = np.asarray(st_j.opt_state.g1) / 0.1
    g_t = st_t.opt_state.g1.numpy() / 0.1
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * scale)


@pytest.mark.parametrize("mode", ["fail", "no_tets"])
def test_failing_tetwild_raises(root, mode):
    """An executable that exits 1, or one that writes no tets, makes the
    port raise, naming the command; no native sphere stands in and no
    mesh is cached."""
    write_tetwild_stub(str(root / f"tetwild_{mode}"), mode=mode)
    match = "exited with 1" if mode == "fail" else "wrote no .*msh_TO.npy"
    with pytest.raises(RuntimeError, match=match) as err:
        _build(root, f"torch_{mode}", "", exe=f"tetwild_{mode}")
    assert "--input" in str(err.value) and "--is-quiet" in str(err.value)
    assert not os.path.exists(root / f"torch_{mode}" / "cache" /
                              "final_tet_v.npy")
