"""The port's SDS guidance and image-to-3D driver (tssplat_torch.guidance,
tssplat_torch.train_sds) against the JAX package's (tests/test_sds.py):
the same draws from the same seed, the mock-UNet call path, train_sds
iteration by iteration, the normal channel, and main()'s dispatch."""

import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tssplat_tpu.train_sds as jax_sds_driver
from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.guidance import sds as jax_sds
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops.rasterize import rasterize_silhouette
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.ops.transform import transform_pos as jax_transform_pos

import tssplat_torch.train_sds as sds_driver
from tssplat_torch.config import ConfigDict
from tssplat_torch.guidance import sds

torch.set_num_threads(1)


@pytest.mark.parametrize("shape, cond", [((2, 8, 8, 1), None),
                                         ((3, 16, 16, 3), [0, 2, 5])],
                         ids=["batch", "bank"])
def test_draws_and_guidance_bit_equal(shape, cond):
    """_alphas_cumprod, TargetImageGuidance and sds_image_grad equal JAX's
    bit for bit from the same seed, over five successive draws (the
    timestep, then the noise, from one Generator), with and without a
    target bank indexed by the sampled views."""
    cfg = sds.SDSConfig(seed=3)
    jcfg = jax_sds.SDSConfig(seed=3)
    np.testing.assert_array_equal(sds._alphas_cumprod(cfg),
                                  jax_sds._alphas_cumprod(jcfg))
    rng0 = np.random.default_rng(5)
    x0 = rng0.uniform(-1, 1, shape).astype(np.float32)
    n_tgt = shape[0] if cond is None else 6
    tgt = rng0.uniform(-1, 1, (n_tgt,) + shape[1:3] + (1,)).astype(
        np.float32)
    g = sds.TargetImageGuidance(tgt, cfg)
    gj = jax_sds.TargetImageGuidance(tgt, jcfg)
    eps = rng0.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(g(x0, 117, eps, cond),
                                  gj(x0, 117, eps, cond))
    rng, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        a = sds.sds_image_grad(x0, g, cfg, rng, cond=cond)
        b = jax_sds.sds_image_grad(x0, gj, jcfg, rng_j, cond=cond)
        assert a.dtype == b.dtype == np.float32 and a.shape == shape
        np.testing.assert_array_equal(a, b)


def test_sds_estimator_is_unbiased_toward_target():
    """E[SDS grad] under TargetImageGuidance = w(t) sqrt(ab_t) (x0 - tgt)
    (tests/test_sds.py's first test, on the port): the Monte-Carlo mean
    is aligned with (x0 - tgt) and of the predicted size."""
    cfg = sds.SDSConfig(seed=3)
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    g = sds.TargetImageGuidance(tgt, cfg)
    acc = np.zeros_like(x0)
    K = 400
    for _ in range(K):
        acc += sds.sds_image_grad(x0, g, cfg, rng)
    acc /= K
    d = (x0 - tgt) / 2.0
    cos = (acc * d).sum() / (np.linalg.norm(acc) * np.linalg.norm(d))
    assert cos > 0.95, f"cosine {cos}"
    ab = sds._alphas_cumprod(cfg)
    lo, hi = int(cfg.t_min * cfg.n_train_timesteps), \
        int(cfg.t_max * cfg.n_train_timesteps)
    w = np.mean([(1 - ab[t]) * math.sqrt(ab[t] / (1 - ab[t]))
                 for t in range(lo, hi)])
    np.testing.assert_allclose(np.abs(acc).mean(), w * np.abs(d).mean(),
                               rtol=0.25)


def test_diffusers_adapter_call_path_with_mock_unet():
    """tests/test_sds.py:105-149 on the port: classifier-free guidance,
    NHWC <-> NCHW and the embeddings broadcast over the batch, through a
    contract-mock UNet (unet(x, t, encoder_hidden_states=e).sample,
    NCHW); the result equals JAX's adapter on the same mock."""

    class Out:
        def __init__(self, sample):
            self.sample = sample

    calls = []

    class MockUNet:
        def __call__(self, x, t, encoder_hidden_states=None):
            calls.append((x.shape, int(t[0]), encoder_hidden_states.shape))
            k = encoder_hidden_states.mean()
            return Out(x * 0.1 + k)

    cfg = sds.SDSConfig(guidance_scale=7.5)
    emb_c = torch.full((1, 4, 8), 2.0)
    emb_u = torch.full((1, 4, 8), -1.0)
    g = sds.DiffusersGuidance.from_components(MockUNet(), None, emb_c, emb_u,
                                              cfg, device="cpu")
    B, H, W, C = 3, 8, 8, 3
    x_t = np.random.default_rng(0).standard_normal((B, H, W, C)).astype(
        np.float32)
    eps_hat = g(x_t, 117, None)
    assert eps_hat.shape == (B, H, W, C) and eps_hat.dtype == np.float32
    assert calls[0][0] == (B, C, H, W) and calls[1][0] == (B, C, H, W)
    assert calls[0][1] == 117
    assert calls[0][2][0] == B and calls[1][2][0] == B
    want = (0.1 * x_t - 1.0) + 7.5 * ((0.1 * x_t + 2.0) - (0.1 * x_t - 1.0))
    np.testing.assert_allclose(eps_hat, want, rtol=1e-5, atol=1e-5)
    gj = jax_sds.DiffusersGuidance.from_components(
        MockUNet(), None, emb_c, emb_u, jax_sds.SDSConfig(guidance_scale=7.5))
    np.testing.assert_array_equal(eps_hat, gj(x_t, 117, None))


def test_diffusers_weights_constructor_needs_diffusers():
    """The from_pretrained constructor is JAX's; without the diffusers
    package (absent on both machines) it raises ImportError before
    anything is read or fetched."""
    assert importlib.util.find_spec("diffusers") is None
    with pytest.raises(ImportError):
        sds.DiffusersGuidance("some/model", "a dog", sds.SDSConfig(),
                              device="cpu")


def test_load_guidance():
    cfg = sds.SDSConfig()
    bank = np.zeros((2, 4, 4, 1), np.float32)
    g = sds.load_guidance({"type": "target_image"}, cfg, lambda: bank)
    assert isinstance(g, sds.TargetImageGuidance)
    np.testing.assert_array_equal(g.target, bank)
    with pytest.raises(ValueError, match="needs a target image"):
        sds.load_guidance({}, cfg)
    with pytest.raises(ValueError, match="unknown guidance type"):
        sds.load_guidance({"type": "clip"}, cfg, lambda: bank)
    with pytest.raises(ImportError):
        sds.load_guidance({"type": "diffusers", "model_id": "m"}, cfg,
                          device="cpu")


RES, N_CAM = 64, 8


def _silhouette_bank(v, f, mvp, res):
    """tests/test_sds.py's target bank: JAX's silhouettes of (v, f)."""
    pos = jax_transform_pos(jnp.asarray(mvp, jnp.float32),
                            jnp.asarray(v[f.reshape(-1)], jnp.float32))
    tri_c = jnp.arange(3 * f.shape[0], dtype=jnp.int32).reshape(-1, 3)
    rast = rasterize_silhouette(pos, tri_c, (res, res), corner=True)
    return np.asarray(jnp.clip(rast[..., 3:4], 0, 1))


@pytest.fixture(scope="module")
def bank():
    mvp, _, _ = fibonacci_views(N_CAM)
    v_t, f_t = icosphere(subdivisions=3)
    v_t = (v_t * np.asarray([0.34, 0.22, 0.22])).astype(np.float32)
    return _silhouette_bank(v_t, f_t, mvp, RES) * 2.0 - 1.0   # (n,H,W,1)


def _sds_cfg(tmp_path, tag, bank, iters, **sds_over):
    kp = os.path.join(str(tmp_path), "kp.json")
    with open(kp, "w") as fh:
        json.dump({"pt": [[0.0, 0.0, 0.0]], "r": [0.26]}, fh)
    sds_block = {"render": "alpha", "resolution": RES, "n_cameras": N_CAM,
                 "views_per_iter": 4, "total_num_iter": iters, "lr": 4e-3,
                 "target_loader": lambda: bank, "sds_param": {"seed": 11}}
    sds_block.update(sds_over)
    return {
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {"use_smooth_barrier": True,
                     "smooth_barrier_param": {"smooth_eng_coeff": 2e-4,
                                              "barrier_coeff": 2e-4,
                                              "increase_order_iter": 1000},
                     "key_points_file_path": kp,
                     "tetwild_cache_folder": os.path.join(str(tmp_path),
                                                          tag + "_cache")},
        "output_path": os.path.join(str(tmp_path), tag),
        "log_every": 100,
        "sds": sds_block,
    }


def _recorder(module, grads):
    """Wrap ``module.sds_image_grad`` so every iteration's image gradient
    is kept."""
    inner = module.sds_image_grad

    def spy(*args, **kw):
        g = inner(*args, **kw)
        grads.append(g.copy())
        return g
    return spy


def test_train_sds_steps_match_jax(tmp_path, bank):
    """train_sds's iteration (``sds_step``) against JAX's, step by step
    for 6 iterations (tests/test_sds.py's sphere distilled toward an
    ellipsoid's silhouettes, 8 cameras at 64², 4 views an iteration, the
    energy on): each iteration starts both packages from JAX's state
    (tet_v and optax.adam's moments, through convert.sds_state) and from
    generators in the same state; JAX's side is its driver's loop
    (train_sds.py:
    _render_channel, sds_image_grad, jax.grad of sum(img * g) + energy,
    optax.adam). The camera ids and the image gradient g within 1e-4 of
    its max; the updated tet_v within 1e-4 of the step's largest motion
    at every component whose gradient is above 1e-5 of the largest. Below
    that the gradient is rounding noise (the energy at the rest shape, the
    SDS noise's residue at background pixels) summed in another order by
    XLA's fused program, and Adam moves each such component by about lr
    either way on its first steps (ROADMAP queue 3)."""
    import copy

    import jax
    import optax
    from tssplat_tpu.config import load_geometry as jax_load_geometry

    from tssplat_torch import convert
    from tssplat_torch.geometry import TetMeshMultiSphereGeometry
    from tssplat_torch.optim import adam

    cfg = _sds_cfg(tmp_path, "steps", bank, 6)
    lr, batch = cfg["sds"]["lr"], 4
    jgeo = jax_load_geometry(cfg["geometry_type"])(dict(
        cfg["geometry"], output_path=str(tmp_path / "j")))
    geo = TetMeshMultiSphereGeometry(dict(
        cfg["geometry"], output_path=str(tmp_path / "t")), device="cpu")
    mvp_np, _, _ = fibonacci_views(N_CAM)
    mvp_j = jnp.asarray(mvp_np, jnp.float32)
    mvp_t = torch.tensor(mvp_np, dtype=torch.float32)
    scfg, scfg_j = sds.SDSConfig(seed=11), jax_sds.SDSConfig(seed=11)
    guide = sds.TargetImageGuidance(bank, scfg)
    guide_j = jax_sds.TargetImageGuidance(bank, scfg_j)
    opt = optax.adam(lr)
    _, update_fn = adam(lr)

    @jax.jit
    def render_j(p, mvp, it):
        return jax_sds_driver._render_channel(p, jgeo.statics, mvp, it, RES,
                                              "alpha")[0]

    @jax.jit
    def update_j(p, opt_state, mvp, it, g):
        def f(q):
            img, reg = jax_sds_driver._render_channel(
                q, jgeo.statics, mvp, it, RES, "alpha")
            return jnp.sum(img * g) + reg
        grads = jax.grad(f)(p)
        upd, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, upd), opt_state, grads

    p_j = jnp.array(jgeo.tet_v)
    o_j = opt.init(p_j)
    rng_j = np.random.default_rng(scfg_j.seed)
    for it in range(6):
        rng_t = copy.deepcopy(rng_j)
        state_t = convert.sds_state(jax.device_get(
            jax_sds_driver.SDSState(p_j, o_j)), "cpu")
        vi = np.sort(rng_j.choice(N_CAM, size=batch, replace=False))
        img = np.asarray(render_j(p_j, mvp_j[vi], it))
        g_j = jax_sds.sds_image_grad(img, guide_j, scfg_j, rng_j, cond=vi)
        p_next, o_j, grads = update_j(p_j, o_j, mvp_j[vi], it,
                                      jnp.asarray(g_j))
        state_t, g_t, n_drop = sds_driver.sds_step(
            state_t, geo.statics, update_fn, guide, scfg, rng_t, mvp_t,
            N_CAM, batch, it, RES, "alpha")
        assert int(n_drop.sum()) == 0
        assert rng_t.bit_generator.state == rng_j.bit_generator.state
        np.testing.assert_allclose(g_t, g_j, atol=1e-4 * np.abs(g_j).max(),
                                   err_msg=f"iteration {it}")
        step = np.asarray(p_next) - np.asarray(p_j)
        grads = np.asarray(grads)
        real = np.abs(grads) > 1e-5 * np.abs(grads).max()
        assert real.sum() > 100
        got = state_t.params.numpy() - np.asarray(p_j)
        np.testing.assert_allclose(got[real], step[real],
                                   atol=1e-4 * np.abs(step).max(),
                                   err_msg=f"iteration {it}")
        p_j = p_next


def test_train_sds_matches_jax(tmp_path, bank, monkeypatch):
    """JAX's train_sds and the port's train_sds(device="cpu") on one
    config, each running free, as test_train_sds_steps_match_jax's: the
    first iteration's image gradient within 1e-4 of its max; later ones
    part where Adam's first steps move rounding-noise components by +-lr
    in either package (see that test), so they are held within 1e-4 of
    their max at all but 2% of their pixels, and the final tet_v within 2
    lr a step of JAX's (ROADMAP queue 3); final/ is exported alike."""
    gj, gt = [], []
    monkeypatch.setattr(jax_sds_driver, "sds_image_grad",
                        _recorder(jax_sds_driver, gj))
    monkeypatch.setattr(sds_driver, "sds_image_grad",
                        _recorder(sds_driver, gt))
    iters, lr = 6, 4e-3
    st_j, geo_j = jax_sds_driver.train_sds(
        JaxConfigDict(_sds_cfg(tmp_path, "jax", bank, iters)))
    st_t, geo_t = sds_driver.train_sds(
        ConfigDict(_sds_cfg(tmp_path, "torch", bank, iters)), device="cpu")
    assert len(gt) == len(gj) == iters
    for it, (a, b) in enumerate(zip(gt, gj)):
        assert a.shape == b.shape == (4, RES, RES, 1)
        off = np.abs(a - b) > 1e-4 * np.abs(b).max()
        assert off.sum() <= (0 if it == 0 else 0.02 * off.size), \
            (it, off.sum())
    p_j = np.asarray(st_j.params)
    assert np.abs(p_j - geo_j.tetmesh.vtx_init).max() > 1e-3
    np.testing.assert_allclose(st_t.params.numpy(), p_j,
                               atol=2 * lr * iters)
    fin_j = os.path.join(str(tmp_path), "jax", "final")
    fin_t = os.path.join(str(tmp_path), "torch", "final")
    assert sorted(os.listdir(fin_t)) == sorted(os.listdir(fin_j))
    assert "final.veg" in os.listdir(fin_t)


def test_train_sds_normal_channel(tmp_path, bank):
    """render: normal distils the coverage-masked normals (C = 3, the
    one-channel bank broadcast over them). JAX's driver asks render_views
    for the colour path with no material there and raises; the port's
    image is JAX's render_views(only_alpha=True, fit_normal=True) normal x
    alpha, and two iterations run and export."""
    from tssplat_tpu.geometry.multisphere import \
        TetMeshMultiSphereGeometry as JaxMulti
    from tssplat_tpu.render.pipeline import render_views as jax_render
    with pytest.raises(ValueError, match="color path needs material_fn"):
        jax_sds_driver.train_sds(JaxConfigDict(
            _sds_cfg(tmp_path, "jax_n", bank, 1, render="normal")))
    cfg = _sds_cfg(tmp_path, "torch_n", bank, 2, render="normal")
    st, geo = sds_driver.train_sds(ConfigDict(cfg), device="cpu")
    assert bool(torch.isfinite(st.params).all())
    assert os.path.exists(os.path.join(cfg["output_path"], "final",
                                       "final.veg"))

    jgeo = JaxMulti(dict(cfg["geometry"], output_path=str(tmp_path / "j")))
    mvp, _, _ = fibonacci_views(N_CAM)
    out_j = jax_render(jgeo.tet_v, jgeo.statics,
                       jnp.asarray(mvp[:2], jnp.float32), 0, RES,
                       only_alpha=True, fit_normal=True)
    want = np.asarray(out_j.normal * out_j.shaded)
    geo0 = type(geo)(dict(cfg["geometry"], output_path=str(tmp_path / "t")),
                     device="cpu")
    img, _, _ = sds_driver.render_channel(
        geo0.tet_v, geo0.statics, torch.tensor(mvp[:2], dtype=torch.float32),
        0, RES, "normal")
    assert img.shape == (2, RES, RES, 3)
    bad = (np.abs(img.detach().numpy() - want) > 1e-4).any(-1)
    assert bad.sum() <= 4, bad.sum()


def test_main_dispatches_to_train_sds(tmp_path, monkeypatch):
    """A config with an sds block makes main() run train_sds (as the JAX
    package's main does); without one, train()."""
    import tssplat_torch.train as torch_train
    seen = []
    monkeypatch.setattr(sds_driver, "train_sds",
                        lambda cfg, device=None: seen.append(("sds", device))
                        or ("state", "geometry"))
    monkeypatch.setattr(torch_train, "train",
                        lambda cfg, device=None: seen.append(("train",
                                                              device)))
    path = tmp_path / "cfg.yaml"
    path.write_text("geometry_type: TetMeshMultiSphereGeometry\n"
                    "sds:\n  render: alpha\n  total_num_iter: 2\n")
    assert torch_train.main(["--config", str(path)], device="cpu") == \
        ("state", "geometry")
    torch_train.main(["--config", str(path), "sds=null"], device="cpu")
    assert seen == [("sds", "cpu"), ("train", "cpu")]
