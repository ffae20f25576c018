"""The port's texture stage through its driver (tssplat_torch.train.train,
fitting_stage: texture) against the JAX package's train() on the same
config and dataset on the CPU: the dataset of tests/test_texture_stage.py
(4 views of 48², position-coded colours over tet_sphere(0.08, radius=0.3)),
JAX's initial material carried into the port through material.npz."""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

import tssplat_tpu.train as jax_train
from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.materials import ExplicitMaterial as JaxMaterial

import tssplat_torch.train as torch_train
from tssplat_torch.config import MATERIALS, ConfigDict
from tssplat_torch.materials import ExplicitMaterial

torch.set_num_threads(1)

RES = 48
N_VIEWS = 4
ENC = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
       "log2_hashmap_size": 13, "base_resolution": 4, "per_level_scale": 1.5}


@pytest.fixture(scope="module")
def tex_root(tmp_path_factory):
    """tests/test_texture_stage.py:21's dataset and frozen geometry, and
    JAX's initial material as material.npz."""
    root = tmp_path_factory.mktemp("tex_driver")
    from tssplat_tpu.geometry.tet_geometry import TetMeshGeometry
    from tssplat_tpu.mesh.spheres import tet_sphere
    from tssplat_tpu.mesh.surface import triangle_edge_neighbors
    from tssplat_tpu.mesh.tetmesh import TetMesh
    from tssplat_tpu.ops.rasterize import antialias, interpolate, rasterize
    from tssplat_tpu.ops.transform import fibonacci_views, transform_pos

    v, t = tet_sphere(0.08, radius=0.3)
    mesh = TetMesh(v, t)
    sv = mesh.vtx[mesh.surface_vid]
    sf = mesh.surface_fid
    mvp, mv, _ = fibonacci_views(N_VIEWS)
    pos_clip = transform_pos(jnp.asarray(mvp, jnp.float32),
                             jnp.asarray(sv, jnp.float32))
    tri = jnp.asarray(sf, jnp.int32)
    nbrs = jnp.asarray(triangle_edge_neighbors(sf), jnp.int32)
    rast = rasterize(pos_clip, tri, (RES, RES))
    alpha = antialias(jnp.clip(rast[..., 3:4], 0, 1), rast, pos_clip, tri,
                      nbrs)
    wp = interpolate(jnp.asarray(sv, jnp.float32), rast, tri)
    color = jnp.clip(wp / 0.6 + 0.5, 0, 1)
    img_dir = root / "img"
    os.makedirs(img_dir)
    rgba = np.concatenate([np.asarray(color), np.asarray(alpha)], axis=-1)
    for i in range(N_VIEWS):
        img = np.clip(rgba[i] * 255, 0, 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(img_dir / f"img_rgba_{i}.png")
        np.save(img_dir / f"mvp_mtx_{i}.npy", mvp[i].astype(np.float32))
        np.save(img_dir / f"mv_{i}.npy", mv[i].astype(np.float32))
    final = root / "geo" / "final"
    geo = TetMeshGeometry(dict(use_smooth_barrier=False), tetmesh=mesh)
    geo.export(str(final), "final")
    (final / "spheres_vtx_idx.json").write_text(
        json.dumps([list(range(mesh.num_vertices))]))
    (final / "spheres_elem_idx.json").write_text(
        json.dumps([mesh.elem.tolist()]))
    JaxMaterial({"pos_encoding_config": ENC}).export(str(root), "init")
    return root


def _cfg(root, out, iters, **over):
    cfg = {
        "fitting_stage": "texture",
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {"use_smooth_barrier": False,
                     "initial_mesh_path": str(root / "geo" / "final")},
        "material_type": "ExplicitMaterial",
        "material": {"pos_encoding_config": dict(ENC)},
        "dataloader_type": "MistubaImgDataLoader",
        "data": {"dataset_config": {"image_root": str(root / "img")},
                 "world_size": 1, "rank": 0, "batch_size": N_VIEWS,
                 "total_num_iter": iters},
        "renderer": {"is_orhto": False},
        "optimizer": {"lr": 0.01, "grad_limit": True,
                      "grad_limit_values": [0.01, 0.005],
                      "grad_limit_iters": [10]},
        "output_path": str(root / out),
        "total_num_iter": iters,
        "use_permute_surface_v": False,
        "log_every": 1, "export_every": 100000,
    }
    cfg.update(over)
    return cfg


def _run_both(root, monkeypatch, capsys, name, iters, **over):
    """JAX's train() and the port's train(device="cpu") on one config, the
    port's material starting from JAX's; returns each one's losses of every
    step (read off the train step), printed text and output directory."""
    runs = {}
    init = str(root / "init" / "material.npz")

    class FromJax(ExplicitMaterial):
        def __init__(self, cfg=None, device=None):
            super().__init__(cfg, device=device)
            self.load(init)

    monkeypatch.setitem(MATERIALS._entries, "ExplicitMaterial", FromJax)
    for pkg, mod, train, cdict in (
            ("jax", jax_train, jax_train.train, JaxConfigDict),
            ("torch", torch_train,
             lambda c: torch_train.train(c, device="cpu"), ConfigDict)):
        losses = []
        make = mod.make_train_step

        def spy(*a, **kw):
            step = make(*a, **kw)

            def logged(state, batch, it):
                state, out = step(state, batch, it)
                losses.append(float(out[0]))
                return state, out
            return logged

        monkeypatch.setattr(mod, "make_train_step", spy)
        cfg = _cfg(root, f"{name}_{pkg}", iters, **over)
        train(cdict(copy.deepcopy(cfg)))
        runs[pkg] = (losses, capsys.readouterr().out, cfg["output_path"])
        monkeypatch.setattr(mod, "make_train_step", make)
    return runs


def _updates_close(root, npz_j, npz_t, rel):
    """Each leaf's change from the initial material in the port's npz
    within ``rel`` of JAX's change, in the 2-norm."""
    with np.load(root / "init" / "material.npz") as i, \
            np.load(npz_j) as a, np.load(npz_t) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(i.files)
        for k in a.files:
            step = np.linalg.norm(a[k] - i[k])
            assert step > 0 and np.linalg.norm(b[k] - a[k]) <= rel * step, k


def test_exact_texture_stage_matches_jax(tex_root, monkeypatch, capsys):
    """The exact path, 4 iterations: both packages print the fast-path line
    with the same P and no warning, the loss of every step within rtol
    1e-5 of JAX's and falling, and the final artifacts: the same files,
    mesh.obj and material.mtl identical, final.veg written, each leaf's
    change from the initial material within 5e-2 of JAX's (2-norm) and
    texture_kd.png within 2 LSB.

    The material's bound is the scene's: its target colour clip(p / 0.6 +
    0.5) is 0.5 on the planes x, y, z = 0, where the initial material
    predicts 0.5 + O(1e-5), so the L1's sign there, and with it a few
    per cent of each gradient, turns on the last bit. JAX's own jitted
    gradients differ from its eager ones by up to 5e-2 of their max
    here, and its exact path's from its dense path's by 1.4e-2, while the
    port's equal JAX's eager ones within 6e-7 of their max (ROADMAP
    queue 3)."""
    runs = _run_both(tex_root, monkeypatch, capsys, "exact", 4)
    (l_j, out_j, dir_j), (l_t, out_t, dir_t) = runs["jax"], runs["torch"]
    p_j = re.search(r"exact texture fast path: 4 views, P=(\d+)", out_j)
    p_t = re.search(r"exact texture fast path: 4 views, P=(\d+)", out_t)
    assert p_j and p_t and p_j.group(1) == p_t.group(1)
    assert "WARNING" not in out_t and "WARNING" not in out_j
    assert len(l_t) == len(l_j) == 4
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert l_t[-1] < l_t[0]

    fin_j = os.path.join(dir_j, "final", "material")
    fin_t = os.path.join(dir_t, "final", "material")
    assert sorted(os.listdir(fin_t)) == sorted(os.listdir(fin_j)) == [
        "material.mtl", "material.npz", "mesh.obj", "texture_kd.png"]
    _updates_close(tex_root, os.path.join(fin_j, "material.npz"),
                   os.path.join(fin_t, "material.npz"), 5e-2)
    ta, tb = (np.asarray(Image.open(os.path.join(d, "texture_kd.png")))
              .astype(int) for d in (fin_j, fin_t))
    assert np.abs(ta - tb).max() <= 2
    for name in ("mesh.obj", "material.mtl"):
        with open(os.path.join(fin_j, name)) as a, \
                open(os.path.join(fin_t, name)) as b:
            assert a.read() == b.read()
    assert os.path.exists(os.path.join(dir_t, "final", "final.veg"))


def test_dense_texture_fallback_matches_jax(tex_root, monkeypatch, capsys):
    """batch_size 2 of 4 views: both packages refuse the exact path with
    the same loud warning and take the dense path (two forwards an
    iteration, in the loader's batch order); the loss of every step within
    rtol 1e-5 of JAX's, each leaf's change from the initial material within
    5e-2 of JAX's (the bound of test_exact_texture_stage_matches_jax, for
    the same reason)."""
    runs = _run_both(tex_root, monkeypatch, capsys, "dense", 2,
                     data={"dataset_config": {
                         "image_root": str(tex_root / "img")},
                         "world_size": 1, "rank": 0, "batch_size": 2,
                         "total_num_iter": 2})
    (l_j, out_j, dir_j), (l_t, out_t, dir_t) = runs["jax"], runs["torch"]
    warn = re.compile(r"WARNING: exact texture fast path DISABLED — (.*?)\. ")
    assert warn.search(out_j).group(1) == warn.search(out_t).group(1)
    assert "needs ONE forward" in out_t
    assert len(l_t) == len(l_j) == 4
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    npz = os.path.join("final", "material", "material.npz")
    _updates_close(tex_root, os.path.join(dir_j, npz),
                   os.path.join(dir_t, npz), 5e-2)


def test_sampled_texture_stage_takes_the_cache(tex_root, monkeypatch,
                                               capsys):
    """texture_sample_px 512 with the cache: both packages build the
    sampled-loss cache with the same P and take no exact path; the port's
    losses are finite and its material artifacts written. (The draws are
    each package's own; tests/test_torch_texture.py holds the loss to
    JAX's from JAX's draws.)"""
    runs = _run_both(tex_root, monkeypatch, capsys, "sampled", 2,
                     texture_sample_px=512)
    (_, out_j, _), (l_t, out_t, dir_t) = runs["jax"], runs["torch"]
    line = re.compile(r"texture cache: 4 views, P=(\d+) fg pixels")
    assert line.search(out_j).group(1) == line.search(out_t).group(1)
    assert "exact texture" not in out_t and "WARNING" not in out_t
    assert len(l_t) == 2 and all(np.isfinite(l_t))
    assert os.path.exists(os.path.join(dir_t, "final", "material",
                                       "texture_kd.png"))

