"""The slice as a whole: the port's geometry-stage train step against one
jitted step of the JAX package's make_train_step on the CPU, from the same
geometry, targets and optimizer state (carried across by
tssplat_torch.convert); then a 10-step trajectory. Last, run_steps over
each kind of step against the same steps taken one at a time."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._pytree import tree_leaves, tree_map

from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.optim import adam_uniform as jax_adam
from tssplat_tpu.optim import cosine_annealing_lr as jax_cos
from tssplat_tpu.train import make_train_step as jax_make_train_step
from tssplat_tpu.train import TrainState as JaxTrainState

from tssplat_torch import convert
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.synthetic import bench_scene
from tssplat_torch.train import (build_texture_sample_cache,
                                 init_train_state, make_train_step,
                                 run_steps)

torch.set_num_threads(1)

RES = 128
B = 2
OPT = dict(grad_limit=True, grad_limit_values=(0.01, 0.01),
           grad_limit_iters=(1500,))


def _targets():
    """Seeded ellipse silhouettes (B,H,W,4), alpha in the last channel."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:RES, 0:RES]
    x = (x + 0.5) / RES * 2 - 1
    y = (y + 0.5) / RES * 2 - 1
    img = np.zeros((B, RES, RES, 4), np.float32)
    for b in range(B):
        a, c = rng.uniform(0.2, 0.35, 2)
        img[b, ..., 3] = ((x / a) ** 2 + (y / c) ** 2 < 1.0)
    return img


@pytest.fixture(scope="module")
def setup():
    v, t = tet_sphere(0.12, radius=0.3)
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(v, t))
    mvp, _, campos = fibonacci_views(B)
    img = _targets()
    batch_j = {"mvp": jnp.asarray(mvp, jnp.float32),
               "campos": jnp.asarray(campos, jnp.float32),
               "img": jnp.asarray(img),
               "background": jnp.ones((B, RES, RES, 3), jnp.float32)}
    batch_t = {"mvp": torch.tensor(mvp, dtype=torch.float32),
               "img": torch.from_numpy(img)}
    return geo, batch_j, batch_t


def _jax_run(geo, batch, n_steps, start_it):
    init_fn, update_fn = jax_adam(jax_cos(0.2, 1500), **OPT)
    step = jax_make_train_step(geo.statics, update_fn,
                               fitting_stage="geometry", resolution=RES,
                               fit_depth=False, is_ortho=False)
    params = jnp.array(geo.tet_v)
    state = JaxTrainState(params=params, opt_state=init_fn(params),
                          best_loss=jnp.asarray(jnp.inf, jnp.float32),
                          best_iter=jnp.zeros((), jnp.int32),
                          best_params=jnp.array(params))
    losses = []
    for it in range(start_it, start_it + n_steps):
        state, out = step(state, batch, it)
        losses.append(float(out[0]))
    return state, losses


def _torch_run(geo, batch, n_steps, start_it):
    init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.2, 1500), **OPT)
    statics = convert.geometry_statics(geo.statics, "cpu")
    step = make_train_step(statics, update_fn, resolution=RES)
    state = init_train_state(convert.tet_v(geo.tet_v, "cpu"), init_fn)
    state, outs = run_steps(step, state, batch, start_it, n_steps)
    return state, [float(o[0]) for o in outs], outs


def test_one_step_matches_jax(setup):
    """Loss, gradient (recovered from the first moment, g1 = (1-b1) g) and
    the updated tet_v after one step at iteration 1001 (barrier order 4).
    Tolerances: loss rtol 1e-5 (sums in another order); the gradient is
    dominated by a few silhouette vertices, so atol 1e-4 of its largest
    entry; tet_v atol 1e-6 (updates are capped at 0.01)."""
    geo, batch_j, batch_t = setup
    st_j, loss_j = _jax_run(geo, batch_j, 1, 1001)
    st_t, loss_t, outs = _torch_run(geo, batch_t, 1, 1001)
    np.testing.assert_allclose(loss_t[0], loss_j[0], rtol=1e-5)
    assert int(outs[0][3]) == 0                          # n_drop
    g_j = np.asarray(st_j.opt_state.g1) / 0.1
    g_t = st_t.opt_state.g1.numpy() / 0.1
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * scale)
    np.testing.assert_allclose(st_t.params.numpy(), np.asarray(st_j.params),
                               atol=1e-6)
    np.testing.assert_allclose(float(st_t.best_loss), float(st_j.best_loss),
                               rtol=1e-5)
    assert int(st_t.best_iter) == int(st_j.best_iter) == 1001


def test_trajectory_matches_jax(setup):
    """Ten steps from iteration 0: the losses stay within rtol 5e-3 of the
    JAX trajectory and fall. The two clip transforms (torch.einsum, XLA's
    dot) differ in the last bit of ~10% of coordinates; once the vertices
    have moved, that flips the winner or the AA crossing at a few edge
    pixels, and each such pixel moves the loss by up to ~0.1%."""
    geo, batch_j, batch_t = setup
    st_j, loss_j = _jax_run(geo, batch_j, 10, 0)
    st_t, loss_t, _ = _torch_run(geo, batch_t, 10, 0)
    np.testing.assert_allclose(loss_t, loss_j, rtol=5e-3)
    assert loss_t[-1] < loss_t[0]
    # the vertices move at most lr x cap = 0.002 per step; the two
    # trajectories stay within a quarter of one step of each other
    np.testing.assert_allclose(st_t.params.numpy(), np.asarray(st_j.params),
                               atol=5e-4)


KINDS = ["silhouette", "silhouette_3_spheres", "silhouette_chunked",
         "depth_normal", "texture_exact", "texture_sampled"]
ENC = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
       "log2_hashmap_size": 10, "base_resolution": 4,
       "per_level_scale": 1.6}


def _kind(kind):
    """(step, state, batch) of one kind of step on the bench scene at 2
    views of 64²: the silhouette step on one sphere, on 3 spheres and in
    chunks of one view, the depth + normal step, and the texture step on
    the exact and on the cached sampled path (64 pixels a view) with a
    small hash grid (ENC)."""
    views, res = 2, 64
    geo, batch = bench_scene("cpu", views, res,
                             n_spheres=3 if kind.endswith("3_spheres") else 1)
    if kind.startswith("texture"):
        mat = ExplicitMaterial({"pos_encoding_config": dict(ENC)}, "cpu")
        init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.01, 1500))
        if kind == "texture_exact":
            cache = build_texture_exact_cache(geo, mat, batch, res)
            assert cache is not None
            kw = dict(texture_exact_loss=build_texture_exact_loss(
                mat, geo.statics, cache))
        else:
            kw = dict(texture_sample_px=64,
                      texture_cache=build_texture_sample_cache(
                          geo.statics, geo.tet_v, batch["mvp"],
                          batch["img"], res))
            batch["view_idx"] = torch.arange(views, dtype=torch.int32)
        step = make_train_step(geo.statics, update_fn, resolution=res,
                               material_fn=mat.apply_fn,
                               tet_v_frozen=geo.tet_v, **kw)
        return step, init_train_state(mat.params, init_fn), batch
    init_fn, update_fn = adam_uniform(cosine_annealing_lr(0.2, 1500), **OPT)
    dn = kind == "depth_normal"
    step = make_train_step(geo.statics, update_fn, resolution=res,
                           fit_depth=dn, fit_normal=dn,
                           view_chunk=1 if kind.endswith("chunked") else 0)
    return step, init_train_state(geo.tet_v, init_fn), batch


@pytest.mark.parametrize("kind", KINDS)
def test_run_steps_equals_single_steps(kind):
    """run_steps over 3 steps from iteration 1, with a host read every 2,
    returns the outputs of each step and the final state, bit-equal to the
    same steps taken one at a time from the same state."""
    step, state, batch = _kind(kind)
    start = tree_map(torch.clone, state)
    got_state, got = run_steps(step, state, batch, 1, 3, sync_every=2)
    want = []
    for it in range(1, 4):
        start, out = step(start, batch, it)
        want.append(out)
    assert len(got) == 3
    got_leaves = tree_leaves((got_state, got))
    want_leaves = tree_leaves((start, want))
    assert len(got_leaves) == len(want_leaves) > 8
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
    assert all(torch.isfinite(o[0]) for o in got)


@pytest.mark.parametrize("kind", KINDS)
def test_step_off_the_card_runs_its_body_eagerly(kind):
    """A geometry step of one batch holds a GraphedStep (the texture
    steps none); off CUDA it replays no graph, and its result is bit-equal
    to ``graphs.eager``, the binning and the body the graph would replay
    (the chunked step takes the chunk loop instead, the same bits as
    before it)."""
    step, state, batch = _kind(kind)
    graphs = step.graphs
    assert (graphs is None) == kind.startswith("texture")
    got = step(tree_map(torch.clone, state), batch, 1)
    if graphs is None or kind.endswith("chunked"):
        return
    want = graphs.eager(tree_map(torch.clone, state), batch, 1)
    assert graphs.replays == 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
