"""train() with periodic remeshing (``remesh_every``) against the JAX
package's train(), on the CPU: tests/test_remesh.py's scene (the JAX
writer's ellipsoid icosphere(2) x (0.3, 0.25, 0.2) at 3 views of 64², two
overlapping spheres) with smaller spheres and a coarser grid (r 0.1 and a
16³ grid against r 0.2 and 28³: JAX's own run of that test takes 86 s on
the CPU), remeshed at iteration 4 of 8, with gso.yaml's optimizer (AdamUniform,
lr 0.2 cosine, update caps 0.01).

The remesh is a discontinuous function of the surface: its grid signs
and tet filters follow the nearest face's sign, which at a tie between
faces of both signs (the crease where the spheres meet) turns on the last
bit, and XLA:CPU rounds otherwise than PyTorch (tests/test_torch_queries.py).
So the run held against JAX's keeps the vertices where they start up to
the remesh (each step's params are put back after it, in both packages:
lr 0 in effect) and feeds JAX's signed distances to the port's remesh;
the remesh then gets the same input and answers. After it both train,
with the optimizer restarted on the new topology, and the losses and the
vertices' motion are held against JAX's. A second run trains throughout
on the port's own queries.
"""

import collections
import contextlib
import copy
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tssplat_tpu.train as jax_train_mod
from tssplat_tpu.ops.queries import signed_distance as jax_sd
from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset

import tssplat_torch.mesh.remesh as remesh
import tssplat_torch.train as torch_train
from tssplat_torch.config import ConfigDict
from tssplat_torch.mesh.tetmesh import TetMesh

torch.set_num_threads(1)

ITERS, REMESH_AT = 8, 4
REMESHED = re.compile(r"remeshed at iter (\d+): (\d+) verts / (\d+) tets")
# a train() run: its final state and geometry, the (loss, img_loss) of each
# step, its stdout, the params at the start of each step from the remesh on
# and at the end, the optimizer state after each of those steps, and the
# (statics, make_train_step keywords, batch, it) of the step after the
# remesh's
Run = collections.namedtuple(
    "Run", "state geo losses out params opt second_step")


def _cfg(root, out, **over):
    out = str(root / out)
    cfg = {
        "fitting_stage": "geometry",
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {"use_smooth_barrier": True,
                     "smooth_barrier_param": {"smooth_eng_coeff": 2e-4,
                                              "barrier_coeff": 2e-4,
                                              "increase_order_iter": 1000},
                     "key_points_file_path": str(root / "kp.json"),
                     "tetwild_cache_folder": out + "_cache",
                     "output_path": out},
        "dataloader_type": "MistubaImgDataLoader",
        "data": {"dataset_config": {"image_root": str(root / "img")},
                 "world_size": 1, "rank": 0, "batch_size": 3,
                 "total_num_iter": ITERS},
        "optimizer": {"lr": 0.2, "grad_limit": True,
                      "grad_limit_values": [0.01, 0.01],
                      "grad_limit_iters": [ITERS]},
        "output_path": out, "total_num_iter": ITERS,
        "use_permute_surface_v": False,
        "remesh_every": REMESH_AT, "remesh_grid_dim": 16,
        "log_every": 1, "export_every": 6, "checkpoint_every": 6,
    }
    cfg.update(over)
    return cfg


def _run(module, train, cfg, config_cls, hold_until=0):
    """train(cfg) with each step's (loss, img_loss) recorded and, from
    iteration ``hold_until`` on, its input params and output optimizer
    state (on the host: JAX's step donates its input state), and the
    inputs of the step of iteration ``hold_until + 1``. Before
    ``hold_until`` each step's params are put back after it."""
    losses, params, opt, second = [], [], [], []
    make = module.make_train_step

    def spy(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch, it):
            kept = np.array(state.params)
            if int(it) == hold_until + 1:
                second.append((args[0], kw, batch, int(it)))
            if int(it) >= hold_until:
                params.append(kept)
            state, out = step(state, batch, it)
            losses.append((float(out[0]), float(out[1])))
            if int(it) >= hold_until:
                opt.append({k: np.array(x) for k, x in
                            state.opt_state._asdict().items()})
            else:
                state = state._replace(params=torch.as_tensor(kept)
                                       if isinstance(state.params,
                                                     torch.Tensor)
                                       else jnp.asarray(kept))
            return state, out
        return recorded

    module.make_train_step = spy
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            state, geo = train(config_cls(copy.deepcopy(cfg)))
    finally:
        module.make_train_step = make
    params.append(np.array(state.params))
    return Run(state, geo, np.asarray(losses), buf.getvalue(), params, opt,
               second[0] if second else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("remesh_driver")
    v, f = icosphere(2)
    jax_write_dataset(str(root / "img"), v * np.asarray([0.3, 0.25, 0.2]), f,
                      n_views=3, resolution=64)
    (root / "kp.json").write_text(json.dumps(
        {"pt": [[-0.04, 0, 0], [0.04, 0, 0]], "r": [0.1, 0.1]}))
    jax_run = _run(jax_train_mod, jax_train_mod.train, _cfg(root, "jax"),
                   JaxConfigDict, hold_until=REMESH_AT)
    saved = remesh._sd
    remesh._sd = _jax_distances
    try:
        torch_run = _run(torch_train,
                         lambda c: torch_train.train(c, device="cpu"),
                         _cfg(root, "torch"), ConfigDict,
                         hold_until=REMESH_AT)
    finally:
        remesh._sd = saved
    return root, jax_run, torch_run


def _jax_distances(points, verts, faces, dev):
    return np.asarray(jax_sd(jnp.asarray(points, jnp.float32),
                             jnp.asarray(verts, jnp.float32),
                             jnp.asarray(faces, jnp.int32)))


def test_losses_match_jax_across_the_remesh(runs):
    """Every step's loss and img_loss within rtol 1e-5 of JAX's up to and
    including the first step on the new topology, and within rtol 1e-3 in
    the three trained steps after it: the first update moves the vertices
    onto a silhouette tie that f32 rounding decides
    (test_the_second_step_on_the_new_topology_sits_on_a_tie)."""
    _, jax_run, run = runs
    lj, lt = jax_run.losses, run.losses
    assert lt.shape == lj.shape == (ITERS, 2)
    np.testing.assert_allclose(lt[:REMESH_AT + 1], lj[:REMESH_AT + 1],
                               rtol=1e-5)
    np.testing.assert_allclose(lt[REMESH_AT + 1:], lj[REMESH_AT + 1:],
                               rtol=1e-3)
    assert np.isfinite(lt).all() and "WARNING" not in run.out
    assert abs(lt[REMESH_AT, 1] - lt[REMESH_AT - 1, 1]) > 1e-4
    assert lt[-1, 1] < lt[REMESH_AT, 1]


def test_optimizer_restart_matches_jax(runs):
    """The vertices the remesh gives JAX's, bit for bit (the same input
    and distances); the first update on the new topology, from a fresh
    AdamUniform state (lr 0.2 cosine, update cap 0.01), within 1e-7 of
    JAX's per coordinate (a few f32 ulps at |x| ~ 0.3), and the optimizer
    state after it JAX's: the count, cap pointer and step counter equal,
    the moments within 1e-5 of their largest entry (the gradient's tiny
    entries differ in their last bits)."""
    _, jax_run, run = runs
    assert np.array_equal(run.params[0], jax_run.params[0])
    moved = run.params[1] - run.params[0]
    np.testing.assert_allclose(moved, jax_run.params[1] - jax_run.params[0],
                               rtol=0, atol=1e-7)
    assert np.abs(moved).max() > 1e-3
    got, want = run.opt[0], jax_run.opt[0]
    assert got.keys() == want.keys()
    for k in ("count", "limit_ptr", "cc"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("g1", "g2"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert int(got["count"]) == 1


def test_the_second_step_on_the_new_topology_sits_on_a_tie(runs):
    """Why the later losses are held to 1e-3: at the second step on the
    new topology a move of the vertices by 1e-8 (f32 rounding there)
    changes the port's own img_loss by more than 1e-5 of it, as far as
    its difference from JAX's; the loss is discontinuous at that point."""
    _, jax_run, run = runs
    statics, kw, batch, it = run.second_step
    p = run.params[1]

    def img_loss(x):
        return float(torch_train.loss_and_grad(
            statics, torch.as_tensor(x), batch, it, kw["resolution"],
            tile_k=kw.get("tile_k"), view_chunk=kw.get("view_chunk", 0))[1])

    here = img_loss(p)
    assert here == run.losses[REMESH_AT + 1, 1]
    nudged = img_loss(p + np.random.default_rng(0).normal(
        size=p.shape).astype(np.float32) * 1e-8)
    assert abs(nudged - here) > 1e-5 * here
    assert abs(nudged - here) >= 0.5 * abs(
        here - jax_run.losses[REMESH_AT + 1, 1])


def test_vertex_motion_after_the_remesh_matches_jax(runs):
    """The motion over the four trained steps on the new topology within
    10% of its largest coordinate of JAX's everywhere, and within 1e-6 of
    JAX's on 99% of the coordinates: the tie of the second step moves a
    few vertices otherwise."""
    _, jax_run, run = runs
    want = jax_run.params[-1] - jax_run.params[0]
    got = run.params[-1] - run.params[0]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1 * scale)
    assert (np.abs(got - want) > 1e-6).mean() <= 0.01


def test_remeshed_counts_match_jax(runs):
    """The remesh line, its vertex and tet counts JAX's; the state's
    params, the geometry's tet_v and statics on the new topology; the
    1/num_spheres smoothness scale kept."""
    _, jax_run, run = runs
    want = REMESHED.findall(jax_run.out)
    assert want and REMESHED.findall(run.out) == want
    assert int(want[0][0]) == REMESH_AT
    st, geo = run.state, run.geo
    n = geo.tetmesh.num_vertices
    assert n == jax_run.geo.tetmesh.num_vertices == int(want[0][1])
    assert st.params.shape == (n, 3) == st.best_params.shape
    assert int(geo.statics.surface_vid.max()) < n
    assert geo.statics.smooth_coeff == pytest.approx(2e-4 / 2)
    assert int(st.best_iter) >= REMESH_AT


def _assert_sphere_artifacts_consistent(path, name):
    """Every tet of <name>.veg in exactly one sphere's elem list (in local
    indices of its vertex list), each per-sphere npy the snapshot's rows of
    its list (tests/test_remesh.py's check)."""
    snap = TetMesh.from_veg(os.path.join(path, f"{name}.veg"))
    with open(os.path.join(path, "spheres_vtx_idx.json")) as fh:
        vtx_idx = json.load(fh)
    rebuilt = []
    for i, vid in enumerate(vtx_idx):
        vid = np.asarray(vid, np.int64)
        vtx = np.load(os.path.join(path, f"{name}_sp{i}_vtx.npy"))
        elem = np.load(os.path.join(path, f"{name}_sp{i}_elem.npy"))
        np.testing.assert_allclose(vtx, snap.vtx[vid], rtol=0, atol=1e-6)
        if elem.size:
            assert elem.min() >= 0 and elem.max() < vid.shape[0]
            rebuilt.append(vid[elem.reshape(-1, 4)])
    rebuilt = np.sort(np.sort(np.concatenate(rebuilt), axis=1), axis=0)
    assert np.array_equal(rebuilt, np.sort(np.sort(snap.elem, axis=1),
                                           axis=0))


@pytest.mark.parametrize("snap", ["mesh00006/00006", "final/final"])
def test_exports_after_the_remesh_match_jax(runs, snap):
    """The exports after the remesh: the per-sphere elem npy and index
    JSONs JAX's, the per-sphere vertices within the motion's bound
    (test_vertex_motion_after_the_remesh_matches_jax), and the partition
    consistent with the snapshot's own tets."""
    root, jax_run, _ = runs
    atol = 0.1 * np.abs(jax_run.params[-1] - jax_run.params[0]).max()
    d, name = snap.split("/")
    pj, pt = root / "jax" / d, root / "torch" / d
    for js in ("spheres_vtx_idx.json", "spheres_elem_idx.json"):
        assert json.loads((pj / js).read_text()) == \
            json.loads((pt / js).read_text())
    n = len(json.loads((pt / "spheres_vtx_idx.json").read_text()))
    assert n == 2
    for i in range(n):
        assert np.array_equal(np.load(pj / f"{name}_sp{i}_elem.npy"),
                              np.load(pt / f"{name}_sp{i}_elem.npy"))
        np.testing.assert_allclose(np.load(pt / f"{name}_sp{i}_vtx.npy"),
                                   np.load(pj / f"{name}_sp{i}_vtx.npy"),
                                   rtol=0, atol=atol)
    _assert_sphere_artifacts_consistent(str(pt), name)


def test_resume_after_remesh_raises_like_jax(runs):
    """Resuming from the checkpoint of iteration 6 (after the remesh) into
    a freshly built geometry: JAX's orbax restore refuses the params' new
    shape with ValueError, and so does the port, before any step."""
    root, _, _ = runs
    for module, train, cls, out in (
            (jax_train_mod, jax_train_mod.train, JaxConfigDict, "jax"),
            (torch_train, lambda c: torch_train.train(c, device="cpu"),
             ConfigDict, "torch")):
        cfg = _cfg(root, out, resume=True, total_num_iter=ITERS + 2)
        cfg["data"]["total_num_iter"] = ITERS + 2
        with pytest.raises(ValueError, match="shape"):
            with contextlib.redirect_stdout(io.StringIO()):
                train(cls(cfg))


def test_train_with_remesh_on_own_queries(runs):
    """gso.yaml's optimizer throughout and the port's own queries: the
    remesh line, finite losses falling in each segment before and after
    the remesh, the tile capacity revalidated, and a consistent final
    export."""
    root, _, _ = runs
    run = _run(torch_train, lambda c: torch_train.train(c, device="cpu"),
               _cfg(root, "own"), ConfigDict)
    (it, nv, nt), = REMESHED.findall(run.out)
    assert int(it) == REMESH_AT and int(nv) == run.geo.tetmesh.num_vertices
    img = run.losses[:, 1]
    assert np.isfinite(img).all() and "WARNING" not in run.out
    assert img[REMESH_AT - 1] < img[0] and img[-1] < img[REMESH_AT]
    assert run.state.params.shape == (int(nv), 3)
    _assert_sphere_artifacts_consistent(str(root / "own" / "final"),
                                        "final")
