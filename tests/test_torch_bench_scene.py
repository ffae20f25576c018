"""The bench scene (tssplat_torch/tools/synthetic.py bench_scene) on the
CPU: its geometry and batch against bench.py's own construction in JAX,
and the first losses of the port's make_train_step on it (geometry; exact
and sampled texture, JAX's material carried across) against JAX's
make_train_step built as bench.py builds it. Scene: bench.py's at 2 views
of 64²."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial
from tssplat_tpu.materials import exact_stage as jax_exact
from tssplat_tpu.mesh.spheres import icosphere, tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.tools.synthetic import render_views_of_mesh
import tssplat_tpu.train as jax_train

from tssplat_torch import convert
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.synthetic import bench_scene
import tssplat_torch.train as torch_train
from test_torch_config_data import _jax_corner_rgb

torch.set_num_threads(1)

B, RES = 2, 64
ENC = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
       "log2_hashmap_size": 12, "base_resolution": 4,
       "per_level_scale": 1.6}


@pytest.fixture(scope="module")
def jax_scene():
    """bench.py:78-106 in JAX at 2 views of 64²: the geometry and the
    batch as numpy arrays."""
    v, t = tet_sphere(0.03, radius=0.25)
    geo = JaxGeometry(dict(use_smooth_barrier=True), tetmesh=JaxTetMesh(v, t))
    sv, sf = icosphere(subdivisions=3)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, mv, campos = fibonacci_views(B)
    rgba, depth, _ = render_views_of_mesh(sv, sf, mvp, campos, RES)
    batch = {"mvp": mvp, "mv": mv, "campos": campos, "img": rgba,
             "background": np.ones((B, RES, RES, 3), np.float32),
             "n": np.zeros((B, RES, RES, 4), np.float32),
             "d": depth[..., None]}
    return geo, {k: np.asarray(a, np.float32) for k, a in batch.items()}, \
        (sv, sf, mvp)


def _jax_state(params, init_fn):
    return jax_train.TrainState(
        params=params, opt_state=init_fn(params),
        best_loss=jnp.asarray(jnp.inf, jnp.float32),
        best_iter=jnp.zeros((), jnp.int32),
        best_params=jax.tree_util.tree_map(jnp.array, params))


def _losses(step, state, batch, n):
    """The first ``n`` losses of either package's step."""
    losses = []
    for it in range(n):
        state, out = step(state, batch, it)
        losses.append(float(out[0]))
    return losses


def test_scene_matches_bench_py(jax_scene):
    """bench_scene at 2 views of 64² is bench.py's scene: the same tet
    vertices and surface, mvp / mv / campos to f32 rounding, the
    background ones and the normal target zeros, and the RGBA and depth
    within test_render_views_rgba_matches_jax's tolerances (alpha and
    depth within 1e-5 but at <= 2 pixels on an edge or a z near-tie; the
    RGB within 1 LSB of JAX's corner-layout chain, and within 1 LSB of
    JAX's own RGB but where JAX's two layouts part by more than 1 LSB, at
    most 0.2 of the foreground, each but at those <= 2 pixels and their 4
    neighbours)."""
    geo_j, want, (sv, sf, mvp) = jax_scene
    geo, got = bench_scene("cpu", B, RES)
    np.testing.assert_array_equal(geo.tet_v.numpy(), np.asarray(geo_j.tet_v))
    np.testing.assert_array_equal(geo.statics.surface_fid.numpy(),
                                  np.asarray(geo_j.statics.surface_fid))
    assert set(got) == set(want)
    for k in ("mvp", "mv", "campos", "background", "n"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-7,
                                   err_msg=k)
    rgba, rgba_j = got["img"].numpy(), want["img"]
    d, d_j = got["d"].numpy()[..., 0], want["d"][..., 0]
    assert rgba.shape == rgba_j.shape == (B, RES, RES, 4)
    fg = rgba_j[..., 3] > 0
    assert fg.sum() > 150                  # the ellipsoid is ~10 px across
    edge = (np.abs(rgba[..., 3] - rgba_j[..., 3]) > 1e-5) \
        | (np.abs(d - d_j) > 1e-5)
    assert edge.sum() <= 2

    def u8(x):
        return np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(int)
    pad = np.pad(edge, ((0, 0), (1, 1), (1, 1)))
    near = edge | pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1] | pad[:, 1:-1, :-2] \
        | pad[:, 1:-1, 2:]
    corner = u8(_jax_corner_rgb(sv, sf, mvp, RES))
    assert np.abs(u8(rgba[..., :3]) - corner).max(-1)[~near].max() <= 1
    layout = np.abs(u8(rgba_j[..., :3]) - corner).max(-1) > 1
    assert layout.sum() <= 0.2 * fg.sum()
    diff = np.abs(u8(rgba[..., :3]) - u8(rgba_j[..., :3])).max(-1)
    assert diff[~layout & ~near].max() <= 1
    assert rgba[..., :3].max() > 0.2


def test_geometry_losses_match_jax(jax_scene):
    """The first 3 losses of the port's geometry step on the bench scene
    (make_train_step, AdamUniform lr 0.2 cosine, caps 0.01, the view
    chunk rule's chunks) equal JAX's make_train_step built as bench.py
    builds it, on the same batch, at rtol 1e-5."""
    geo_j, _, _ = jax_scene
    geo, batch = bench_scene("cpu", B, RES)
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 1500), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(1500,))
    step = torch_train.make_train_step(
        geo.statics, update_fn, resolution=RES,
        view_chunk=torch_train._auto_view_chunk(B, 1, RES, device="cpu"))
    got = _losses(step, torch_train.init_train_state(geo.tet_v, init_fn),
                  batch, 3)

    init_j, update_j = jax_adam_uniform(
        jax_cos(0.2, 1500), grad_limit=True, grad_limit_values=(0.01, 0.01),
        grad_limit_iters=(1500,))
    step_j = jax_train.make_train_step(
        geo_j.statics, update_j, fitting_stage="geometry", resolution=RES,
        fit_depth=False, is_ortho=False,
        view_chunk=jax_train._auto_view_chunk(B, 1, RES))
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = _losses(step_j, _jax_state(jnp.array(geo_j.tet_v), init_j),
                   batch_j, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]


@pytest.mark.parametrize("sample", [0, 256], ids=["exact", "sampled"])
def test_texture_losses_match_jax(jax_scene, monkeypatch, sample):
    """The first 2 losses of the port's texture step on the bench scene
    (AdamUniform lr 0.01 cosine; the exact path, or the cached sampled
    path at 256 pixels a view) equal JAX's make_train_step built as
    bench.py builds it, at rtol 1e-5, from JAX's initial material (the
    port's draws from a CPU generator) and, on the sampled path, JAX's
    slots (jax.random, fed to the port). The material is a 6-level 2^12
    hash grid (ENC): JAX's step on the default 16 x 2^19 grid is too slow
    for this suite on the CPU."""
    geo_j, _, _ = jax_scene
    mat_j = JaxMaterial({"pos_encoding_config": dict(ENC)})

    def jax_slots(count, S, it):
        key = jax.random.fold_in(jax.random.PRNGKey(17), it)
        u = np.asarray(jax.random.uniform(key, (count.shape[0], S)))
        cnt = count.numpy()[:, None]
        slot = np.floor(u * cnt.astype(np.float32)).astype(np.int64)
        return torch.from_numpy(np.minimum(slot, np.maximum(cnt - 1, 0)))

    monkeypatch.setattr(torch_train, "texture_sample_slots", jax_slots)
    geo, batch = bench_scene("cpu", B, RES)
    material = ExplicitMaterial({"pos_encoding_config": dict(ENC)}, "cpu")
    material.params = convert.material_params(mat_j.params, material.device)
    kw = dict(material_fn=material.apply_fn, tet_v_frozen=geo.tet_v,
              texture_sample_px=sample)
    if sample:
        kw["texture_cache"] = torch_train.build_texture_sample_cache(
            geo.statics, geo.tet_v, batch["mvp"], batch["img"], RES)
        batch["view_idx"] = torch.arange(B, dtype=torch.int32)
    else:
        cache = build_texture_exact_cache(
            geo, material, {k: batch[k] for k in ("mvp", "img",
                                                  "background")}, RES)
        assert cache is not None
        kw["texture_exact_loss"] = build_texture_exact_loss(
            material, geo.statics, cache)
    init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.01, 1500))
    step = torch_train.make_train_step(
        geo.statics, update_fn, resolution=RES,
        view_chunk=torch_train._auto_view_chunk(B, 1, RES, device="cpu"),
        **kw)
    got = _losses(step, torch_train.init_train_state(material.params,
                                                     init_fn), batch, 2)

    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    tet_v = jnp.array(geo_j.tet_v)
    kw_j = dict(texture_sample_px=sample)
    if sample:
        kw_j["texture_cache"] = jax_train.build_texture_sample_cache(
            geo_j.statics, tet_v, batch_j["mvp"], batch_j["img"], RES)
    else:
        cache_j = jax_exact.build_texture_exact_cache(
            geo_j, mat_j, {k: batch_j[k] for k in ("mvp", "img",
                                                   "background")}, RES)
        kw_j["texture_exact_loss"] = jax_exact.build_texture_exact_loss(
            mat_j, geo_j.statics, cache_j)
    init_j, update_j = jax_adam_uniform(jax_cos(0.01, 1500))
    step_j = jax_train.make_train_step(
        geo_j.statics, update_j, fitting_stage="texture", resolution=RES,
        fit_depth=False, is_ortho=False, material_fn=mat_j.apply_fn,
        tet_v_frozen=tet_v, **kw_j)
    want = _losses(step_j, _jax_state(mat_j.params, init_j), batch_j, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] != got[0]
