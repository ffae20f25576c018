"""The port's texture stage, module by module, against the JAX package on
the same numpy inputs: the colour antialias (tssplat_torch/ops/
rasterize.py antialias_color), the colour branch of render_views, the
exact loss (tssplat_torch/materials/exact_stage.py) against JAX's and
against the port's own dense path, the sampled loss from the same draws,
the sampled-loss cache, the UV atlases and the textured-OBJ bake.

Scene: tet_sphere(0.08, radius=0.3) seen from 2 views of 64², fitted to
the ellipsoid of tests/test_texture_exact.py; a 6-level encoding with a
2^12 table (dense and hashed levels)."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry as JaxGeometry
from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial
from tssplat_tpu.materials import exact_stage as jax_exact
from tssplat_tpu.materials.export import export_textured_obj as jax_export
from tssplat_tpu.mesh.spheres import icosphere, tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.mesh.tetmesh import trivial_uv_atlas as jax_trivial
from tssplat_tpu.mesh.uv import chart_uv_atlas as jax_charts
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.ops.transform import transform_pos as jax_transform
from tssplat_tpu.optim import adam_uniform as jax_adam_uniform
from tssplat_tpu.render.pipeline import render_views as jax_render
from tssplat_tpu.tools.synthetic import render_views_of_mesh
import tssplat_tpu.train as jax_train

from tssplat_torch import convert
from tssplat_torch.geometry import TetMeshGeometry
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.materials.export import export_textured_obj
from tssplat_torch.mesh.tetmesh import TetMesh, trivial_uv_atlas
from tssplat_torch.mesh.uv import chart_uv_atlas
from tssplat_torch.ops.transform import transform_pos
from tssplat_torch.optim import adam_uniform
from tssplat_torch.render.pipeline import _eval_material_masked, render_views
from tssplat_torch.utils.tree import tree_leaves
import tssplat_torch.train as torch_train

jr = importlib.import_module("tssplat_tpu.ops.rasterize")
tr = importlib.import_module("tssplat_torch.ops.rasterize")

torch.set_num_threads(1)

RES = 64
ENC = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
       "log2_hashmap_size": 12, "base_resolution": 4,
       "per_level_scale": 1.6}


def _leaves_close(got, want, rel, what=""):
    """Each leaf within ``rel`` of the largest |value| of its JAX twin."""
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b,
                                   atol=rel * max(np.abs(b).max(), 1e-30),
                                   err_msg=what)


@pytest.fixture(scope="module")
def scene():
    """Both packages' geometry, material (JAX's parameters carried into the
    port) and the 2-view batch, the GT composited over a white
    background as the loaders do."""
    v, t = tet_sphere(0.08, radius=0.3)
    geo_j = JaxGeometry(dict(use_smooth_barrier=False),
                        tetmesh=JaxTetMesh(v, t))
    geo_t = TetMeshGeometry(dict(use_smooth_barrier=False),
                            tetmesh=TetMesh(v, t), device="cpu")
    sv, sf = icosphere(subdivisions=2)
    sv = sv * np.asarray([0.3, 0.24, 0.18])
    mvp, _, campos = fibonacci_views(2)
    rgba, _, _ = render_views_of_mesh(sv, sf, mvp, campos, RES)
    bg = np.ones((2, RES, RES, 3), np.float32)
    rgb = bg + (rgba[..., :3] - bg) * rgba[..., 3:4]
    img = np.concatenate([rgb, rgba[..., 3:4]], -1).astype(np.float32)
    mat_j = JaxMaterial({"pos_encoding_config": dict(ENC)})
    mat_t = ExplicitMaterial({"pos_encoding_config": dict(ENC)},
                             device="cpu")
    mat_t.params = convert.material_params(mat_j.params, "cpu")
    np_batch = {"mvp": mvp.astype(np.float32), "img": img, "background": bg,
                "campos": campos.astype(np.float32)}
    return geo_j, geo_t, mat_j, mat_t, np_batch


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _jax_batch(np_batch):
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


def test_antialias_color_matches_jax(scene):
    """antialias_color against JAX's dense ``antialias`` (corner layout) on
    a seeded colour: values within 1e-6, the colour gradient within 1e-6 of
    its max and the pos_clip gradient (through K3's plain version) within
    1e-5 of its max, under a seeded cotangent; the rasters' ids equal."""
    geo_j, geo_t, _, _, b = scene
    st = geo_j.statics
    F = st.surface_fid.shape[0]
    tri_c = jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3)
    vc = np.asarray(geo_j.tet_v)[np.asarray(st.corner_vid)]
    rng = np.random.default_rng(0)
    col = rng.uniform(0, 1, (2, RES, RES, 3)).astype(np.float32)
    ct = rng.normal(size=col.shape).astype(np.float32)

    def f(c, pc):
        ra = jr.rasterize(pc, tri_c, (RES, RES), corner=True)
        return jr.antialias(c, ra, pc, tri_c, st.edge_nbrs, corner=True)

    pc_j = jax_transform(jnp.asarray(b["mvp"]), jnp.asarray(vc))
    out_j = np.asarray(jax.jit(f)(jnp.asarray(col), pc_j))
    g_col, g_pc = (np.asarray(g) for g in jax.jit(jax.grad(
        lambda c, p: jnp.sum(f(c, p) * ct), argnums=(0, 1)))(
        jnp.asarray(col), pc_j))

    pc_t = transform_pos(torch.from_numpy(b["mvp"]), torch.from_numpy(vc)) \
        .detach().requires_grad_(True)
    ra_t, _ = tr.rasterize(pc_t, (RES, RES))
    ids_j = np.asarray(jr.rasterize(pc_j, tri_c, (RES, RES),
                                    corner=True)[..., 3])
    np.testing.assert_array_equal(ra_t[..., 3].detach().numpy(), ids_j)
    col_t = torch.tensor(col, requires_grad=True)
    out_t = tr.antialias_color(col_t, ra_t, pc_t, geo_t.statics.edge_nbrs)
    (out_t * torch.from_numpy(ct)).sum().backward()
    assert np.abs(out_j - col).max() > 0.1          # edges were blended
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=1e-6)
    np.testing.assert_allclose(col_t.grad.numpy(), g_col,
                               atol=1e-6 * np.abs(g_col).max())
    np.testing.assert_allclose(pc_t.grad.numpy(), g_pc,
                               atol=1e-5 * np.abs(g_pc).max())


def test_render_color_branch_matches_jax(scene):
    """render_views(only_alpha=False) at iteration 3: the shaded colour
    within 1e-5 and the L1 loss's gradients w.r.t. the material within
    1e-5 of each leaf's max, JAX's subtile-compacted evaluation against
    the port's boolean indexing."""
    geo_j, geo_t, mat_j, mat_t, b = scene
    bj, bt = _jax_batch(b), _torch_batch(b)

    def loss_j(p):
        out = jax_render(geo_j.tet_v, geo_j.statics, bj["mvp"], 3, RES,
                         only_alpha=False, material_fn=mat_j.apply_fn,
                         material_params=p, background=bj["background"])
        return jnp.mean(jnp.abs(out.shaded - bj["img"][..., :3])), \
            out.shaded

    (l_j, sh_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        mat_j.params)
    p_t = {k: {n: x.clone().requires_grad_(True) for n, x in d.items()}
           for k, d in mat_t.params.items()}
    out = render_views(geo_t.tet_v, geo_t.statics, bt["mvp"], 3, RES,
                       only_alpha=False, material_fn=mat_t.apply_fn,
                       material_params=p_t, background=bt["background"])
    l_t = torch.mean(torch.abs(out.shaded - bt["img"][..., :3]))
    l_t.backward()
    np.testing.assert_allclose(out.shaded.detach().numpy(),
                               np.asarray(sh_j), atol=1e-5)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    _leaves_close({k: {n: x.grad for n, x in d.items()}
                   for k, d in p_t.items()}, g_j, 1e-5)


def test_masked_material_eval_matches_dense(scene):
    """_eval_material_masked equals the material over the whole grid at
    every masked pixel, gradients w.r.t. the material included (the
    contract of tests/test_texture_stage.py:208), and is zero elsewhere."""
    _, _, _, mat_t, _ = scene
    rng = np.random.default_rng(3)
    pos = torch.tensor(rng.uniform(-0.5, 0.5, (2, 32, 32, 3)),
                       dtype=torch.float32)
    mask = torch.zeros((2, 32, 32, 1))
    mask[0, 8:16, 8:24] = 1.0
    mask[1, 20:30, 0:5] = 1.0
    outs = []
    for masked in (True, False):
        p = {k: {n: x.clone().requires_grad_(True) for n, x in d.items()}
             for k, d in mat_t.params.items()}
        c = _eval_material_masked(mat_t.apply_fn, p, pos, mask, 0) \
            if masked else mat_t.apply_fn(p, pos, 0)
        torch.sum((c * mask) ** 2).backward()
        outs.append((c.detach(), [x.grad for x in tree_leaves(p)]))
    (c1, g1), (c2, g2) = outs
    m = mask[..., 0] > 0
    np.testing.assert_allclose(c1[m].numpy(), c2[m].numpy(), atol=1e-6)
    assert float(c1[~m].abs().max()) == 0.0
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_exact_loss_matches_jax_and_dense(scene):
    """The exact loss at iteration 0 against JAX's exact loss (its bucketed
    table gradient) and against the port's dense path (render_views +
    L1 x 20): the loss within rtol 1e-6 and 1e-5, the table gradient
    within 2e-4 of its max (JAX's own bound between its exact and dense
    paths, tests/test_texture_exact.py:48) and the network gradients
    within 1e-4 of their max."""
    geo_j, geo_t, mat_j, mat_t, b = scene
    bj, bt = _jax_batch(b), _torch_batch(b)
    cache_j = jax_exact.build_texture_exact_cache(geo_j, mat_j, bj, RES)
    l_j, g_j = jax.jit(jax.value_and_grad(
        lambda q: jax_exact.build_texture_exact_loss(
            mat_j, geo_j.statics, cache_j)(q, 0)[0]))(mat_j.params)

    cache_t = build_texture_exact_cache(geo_t, mat_t, bt, RES)
    assert cache_t["P"] == cache_j["P"] and cache_t["n"] == 2
    loss_t = build_texture_exact_loss(mat_t, geo_t.statics, cache_t)

    def grads(fn):
        p = {k: {n: x.clone().requires_grad_(True) for n, x in d.items()}
             for k, d in mat_t.params.items()}
        val = fn(p)
        val.backward()
        return float(val), {k: {n: x.grad for n, x in d.items()}
                            for k, d in p.items()}

    l_t, g_t = grads(lambda p: loss_t(p, 0)[0])
    l_d, g_d = grads(lambda p: torch.mean(torch.abs(render_views(
        geo_t.tet_v, geo_t.statics, bt["mvp"], 0, RES, only_alpha=False,
        material_fn=mat_t.apply_fn, material_params=p,
        background=bt["background"]).shaded - bt["img"][..., :3])) * 20.0)
    np.testing.assert_allclose(l_t, float(l_j), rtol=1e-6)
    np.testing.assert_allclose(l_t, l_d, rtol=1e-5)
    for other in (g_j, {k: {n: x.numpy() for n, x in d.items()}
                        for k, d in g_d.items()}):
        _leaves_close({"encoding": g_t["encoding"]},
                      {"encoding": other["encoding"]}, 2e-4, "table")
        _leaves_close({"network": g_t["network"]},
                      {"network": other["network"]}, 1e-4, "network")


def test_exact_cache_refuses_as_jax_does(scene):
    """The same refusals and reason strings as JAX's: more foreground
    pixels than max_px, and an encoding that is not a plain HashGrid."""
    geo_j, geo_t, mat_j, mat_t, b = scene
    bj, bt = _jax_batch(b), _torch_batch(b)
    for kw in (dict(max_px=1), {}):
        if not kw:
            for m in (mat_j, mat_t):
                m.cfg.pos_encoding_config = dict(
                    ENC, otype="ProgressiveBandHashGrid")
        r_j, r_t = [], []
        try:
            assert jax_exact.build_texture_exact_cache(
                geo_j, mat_j, bj, RES, reason_out=r_j, **kw) is None
            assert build_texture_exact_cache(
                geo_t, mat_t, bt, RES, reason_out=r_t, **kw) is None
        finally:
            for m in (mat_j, mat_t):
                m.cfg.pos_encoding_config = dict(ENC)
        assert r_t == r_j and len(r_t) == 1


def _jax_step(geo_j, mat_j, S, cache):
    init_fn, update_fn = jax_adam_uniform(0.01)
    step = jax_train.make_train_step(
        geo_j.statics, update_fn, fitting_stage="texture", resolution=RES,
        fit_depth=False, is_ortho=False, material_fn=mat_j.apply_fn,
        tet_v_frozen=geo_j.tet_v, texture_sample_px=S, texture_cache=cache)
    p = jax.tree_util.tree_map(jnp.array, mat_j.params)
    st = jax_train.TrainState(params=p, opt_state=init_fn(p),
                              best_loss=jnp.asarray(jnp.inf, jnp.float32),
                              best_iter=jnp.zeros((), jnp.int32),
                              best_params=jax.tree_util.tree_map(
                                  jnp.array, p))
    return step, st


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "top_k"])
def test_sampled_loss_matches_jax_from_the_same_draws(scene, cached):
    """One step of the sampled texture loss (512 pixels a view) at
    iteration 7, with JAX's draws fed to the port (the slots of the cached
    path, the scores of the top-k path): the loss within rtol 1e-5 and
    the first AdamUniform update (lr 0.01: each leaf's gradient over its
    max, times lr) within 1e-4 of lr; the caches equal."""
    geo_j, geo_t, mat_j, mat_t, b = scene
    S, it = 512, 7
    bj, bt = _jax_batch(b), _torch_batch(b)
    bj["view_idx"] = jnp.asarray([1, 0], jnp.int32)
    bt["view_idx"] = torch.tensor([1, 0], dtype=torch.int32)
    for k in ("mvp", "img", "background", "campos"):
        bj[k], bt[k] = bj[k][::-1], bt[k].flip(0)
    cache_j = cache_t = None
    if cached:
        cache_j = jax_train.build_texture_sample_cache(
            geo_j.statics, jnp.asarray(geo_j.tet_v), jnp.asarray(b["mvp"]),
            jnp.asarray(b["img"]), RES)
        cache_t = torch_train.build_texture_sample_cache(
            geo_t.statics, geo_t.tet_v, torch.from_numpy(b["mvp"]),
            torch.from_numpy(b["img"]), RES)
        cnt = np.asarray(cache_j["count"])
        np.testing.assert_array_equal(cache_t["count"].numpy(), cnt)
        for i, c in enumerate(cnt):
            for key in ("positions", "gt"):
                np.testing.assert_allclose(
                    cache_t[key][i, :c].numpy(),
                    np.asarray(cache_j[key][i, :c]), atol=1e-6)
    step_j, st_j = _jax_step(geo_j, mat_j, S, cache_j)
    st_j, (loss_j, *_) = step_j(st_j, bj, it)

    key = jax.random.fold_in(jax.random.PRNGKey(17), it)
    draws = {}
    if cached:
        u = np.asarray(jax.random.uniform(key, (2, S)))
        cnt = cache_t["count"][bt["view_idx"].long()]
        slot = np.floor(u * cnt.numpy()[:, None].astype(np.float32))
        draws["slots"] = torch.from_numpy(np.minimum(
            slot, np.maximum(cnt.numpy()[:, None] - 1, 0)).astype(np.int64))
    else:
        draws["scores"] = torch.from_numpy(np.array(
            jax.random.uniform(key, (2, RES * RES))))
    p = {k: {n: x.clone().requires_grad_(True) for n, x in d.items()}
         for k, d in mat_t.params.items()}
    il, _ = torch_train.sampled_texture_loss(
        mat_t.apply_fn, p, bt, it, S, cache=cache_t, statics=geo_t.statics,
        tet_v=geo_t.tet_v, resolution=RES, **draws)
    np.testing.assert_allclose(float(il) * 100.0, float(loss_j), rtol=1e-5)
    (il * 100.0).backward()
    init_t, upd_t = adam_uniform(0.01)
    grads = {k: {n: x.grad for n, x in d.items()} for k, d in p.items()}
    upd, _ = upd_t(grads, init_t(mat_t.params))
    upd_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   st_j.params, mat_j.params)
    for a, b in zip(tree_leaves(upd), jax.tree_util.tree_leaves(upd_j)):
        assert np.abs(b).max() > 1e-3
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


def test_uv_atlases_match_jax(scene):
    """chart_uv_atlas and trivial_uv_atlas of the sphere's surface equal
    JAX's (float32 uv to the bit, faces and vertex maps identical)."""
    geo_j, geo_t, _, _, _ = scene
    m = geo_j.tetmesh
    sv, sf = m.vtx[m.surface_vid], m.surface_fid
    for got, want in ((chart_uv_atlas(sv, sf), jax_charts(sv, sf)),
                      (trivial_uv_atlas(sf), jax_trivial(sf))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(geo_t.tetmesh.uv_atlas(), m.uv_atlas()):
        np.testing.assert_array_equal(a, b)


def test_textured_obj_bake_matches_jax(tmp_path):
    """export_textured_obj on tests/test_texture_stage.py:134's mesh and
    material at texture_res 128 against JAX's: the UV raster's coverage
    equal, every texel of the PNG within 1 LSB, mesh.obj and material.mtl
    identical."""
    v, t = tet_sphere(0.1, radius=0.3)
    enc = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4,
           "per_level_scale": 1.6}
    geo_j = JaxGeometry(dict(use_smooth_barrier=False),
                        tetmesh=JaxTetMesh(v, t))
    geo_t = TetMeshGeometry(dict(use_smooth_barrier=False),
                            tetmesh=TetMesh(v, t), device="cpu")
    mat_j = JaxMaterial({"pos_encoding_config": enc})
    mat_t = ExplicitMaterial({"pos_encoding_config": enc}, device="cpu")
    # a material with visible structure: JAX's initial table x 1e4
    mat_j.params["encoding"]["table"] = mat_j.params["encoding"]["table"] \
        * 1e4
    mat_t.params = convert.material_params(mat_j.params, "cpu")
    jax_export(geo_j, mat_j, str(tmp_path), "jax", texture_res=128)
    export_textured_obj(geo_t, mat_t, str(tmp_path), "torch",
                        texture_res=128)

    uv, uvf, _ = geo_t.tetmesh.uv_atlas()
    corner = uvf.reshape(-1)
    clip = np.concatenate([uv * 2 - 1, np.zeros_like(uv[:, :1]),
                           np.ones_like(uv[:, :1])], 1).astype(np.float32)
    ra_j = jr.rasterize(jnp.asarray(clip)[None], jnp.asarray(uvf, jnp.int32),
                        (128, 128))
    ra_t, _ = tr.rasterize(torch.from_numpy(clip[corner])[None], (128, 128))
    np.testing.assert_array_equal(ra_t[..., 3].numpy() > 0,
                                  np.asarray(ra_j[..., 3]) > 0)

    a, b = (np.asarray(Image.open(tmp_path / d / "texture_kd.png"))
            .astype(int) for d in ("jax", "torch"))
    assert a.shape == b.shape == (128, 128, 3)
    assert np.abs(a - b).max() <= 1
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 100
    for name in ("mesh.obj", "material.mtl"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_frozen_geometry_builds_no_energy():
    """A geometry built for the texture stage (optimize_geo false) has no
    energy operators, so a fitted mesh with an inverted tet loads; the
    geometry stage still refuses it."""
    v, t = tet_sphere(0.12, radius=0.3)
    t = t.copy()
    t[0, [1, 2]] = t[0, [2, 1]]                        # invert one tet
    frozen = TetMeshGeometry(dict(optimize_geo=False), tetmesh=TetMesh(v, t),
                             device="cpu")
    assert frozen.statics.energy is None
    with pytest.raises(ValueError, match="inverted"):
        TetMeshGeometry({}, tetmesh=TetMesh(v, t), device="cpu")


def test_dense_texture_chunked_equals_unchunked(scene):
    """loss_and_grad of the dense texture path with view_chunk 1 on the 2
    views: the loss within rtol 1e-6 and the material gradients within
    1e-6 of their max of the unchunked call (each chunk's visibility runs
    once; the material and the colour antialias are recomputed in the
    backward)."""
    _, geo_t, _, mat_t, b = scene
    bt = _torch_batch(b)
    outs = [torch_train.loss_and_grad(
        geo_t.statics, geo_t.tet_v, bt, 2, RES, view_chunk=c,
        material_fn=mat_t.apply_fn, mat_params=mat_t.params)
        for c in (0, 1)]
    np.testing.assert_allclose(float(outs[1][0]), float(outs[0][0]),
                               rtol=1e-6)
    for a, b_ in zip(tree_leaves(outs[1][4]), tree_leaves(outs[0][4])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(),
                                   atol=1e-6 * float(b_.abs().max()))
