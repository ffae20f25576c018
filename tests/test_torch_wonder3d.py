"""The port's Wonder3D layout (tssplat_torch.data Wonder3DImgDataset and
Wonder3DDataLoader) against the JAX package's on tests/test_wonder3d.py's
fixture layout: the dataset's arrays, the loader's batches, and an
orthographic train() of 3 iterations."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tssplat_tpu.train as jax_train_mod
from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.config import load_dataloader as jax_load_dataloader
from tssplat_tpu.data import Wonder3DImgDataset as JaxWonder3D
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops.rasterize import rasterize as jax_rasterize
from tssplat_tpu.ops.transform import look_at
from tssplat_tpu.ops.transform import transform_pos as jax_transform_pos

import tssplat_torch.train as torch_train_mod
from tssplat_torch.config import ConfigDict, load_dataloader
from tssplat_torch.data import Wonder3DDataLoader, Wonder3DImgDataset

torch.set_num_threads(1)

VIEWS = ["front", "front_right", "right", "back", "left", "front_left"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """tests/test_wonder3d.py's layout: the six named views of an
    icosphere(2) of radius 0.4, 64² RGBA under masked_colors1/ and normals
    under normals/, each view's orthographic mvp under mvp/."""
    from PIL import Image
    root = tmp_path_factory.mktemp("w3d")
    for d in ("masked_colors1", "normals", "mvp", "imgs"):
        (root / d).mkdir()
    sv, sf = icosphere(subdivisions=2)
    sv = sv * 0.4
    res = 64
    for view, ang in zip(VIEWS, [0, 45, 90, 180, 270, 315]):
        a = np.radians(ang)
        eye = np.asarray([np.sin(a), 0.0, np.cos(a)]) * 2.5
        mv = look_at(eye, [0, 0, 0], [0, 1, 0])
        P = np.diag([1.2, -1.2, -0.3, 1.0]).astype(np.float64)
        mvp = (P @ mv).astype(np.float32)
        np.save(root / "mvp" / f"{view}_mvp.npy", mvp)
        pos = jax_transform_pos(jnp.asarray(mvp[None]),
                                jnp.asarray(sv, jnp.float32))
        rast = jax_rasterize(pos, jnp.asarray(sf, jnp.int32), (res, res))
        alpha = np.asarray(rast[0, ..., 3] > 0).astype(np.float32)
        rgba = np.stack([alpha * 0.7, alpha * 0.5, alpha * 0.3, alpha], -1)
        Image.fromarray((np.clip(rgba, 0, 1) * 255).astype(np.uint8),
                        "RGBA").save(root / "masked_colors1" /
                                     f"rgb_{view}.png")
        nrm = np.stack([alpha * 0.5 + 0.5] * 3 + [alpha], -1) * 255
        Image.fromarray(nrm.astype(np.uint8), "RGBA").save(
            root / "normals" / f"normal_{view}.png")
    return root


def _ds_cfg(root, res):
    return {"camera_mvp_root": str(root / "mvp"),
            "image_root": str(root / "imgs"), "resolution": res}


@pytest.mark.parametrize("res", [64, 96, 48])
def test_dataset_equals_jax(root, res):
    """Every array of the dataset equals JAX's bit for bit, at the images'
    own size and through the bicubic resize up and down; alpha in {0, 1},
    normals in [-1, 1] at the images' own size (the cubic kernel rings
    past the range when it resizes, in both packages), mv == mvp, campos
    the (0,0,1) placeholder."""
    ds = Wonder3DImgDataset(_ds_cfg(root, res))
    jds = JaxWonder3D(_ds_cfg(root, res))
    assert len(ds) == len(jds) == 6 and ds.resolution == jds.resolution == res
    for name in ("all_tgt_imgs", "all_tgt_ns", "all_tgt_ds", "all_mvp_mats",
                 "all_mv_mats", "all_campos", "bgs"):
        for a, b in zip(getattr(ds, name), getattr(jds, name)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
    img = ds.all_tgt_imgs[0]
    assert img.shape == (res, res, 4)
    assert set(np.unique(img[..., 3])) <= {0.0, 1.0}
    n = ds.all_tgt_ns[0][..., :3]
    if res == 64:
        assert n.min() >= -1.0 - 1e-6 and n.max() <= 1.0 + 1e-6
    np.testing.assert_array_equal(ds.all_mv_mats[3], ds.all_mvp_mats[3])
    np.testing.assert_array_equal(ds.all_campos[2], [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(ds.camera_p, jds.camera_p)


def test_longest_view_name_wins(root):
    """With a view list of 'front_left', 'front' and 'front_right' the
    files are matched as JAX matches them (the longest view name in the
    file name wins, so 'front' does not claim the others' files)."""
    cfg = dict(_ds_cfg(root, 64), camera_views=["front_left", "front",
                                                "front_right"])
    ds = Wonder3DImgDataset(cfg)
    jds = JaxWonder3D(cfg)
    assert len(ds) == 3
    for a, b in zip(ds.all_mvp_mats, jds.all_mvp_mats):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ds.all_tgt_imgs, jds.all_tgt_imgs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("it", [0, 2])
def test_loader_batches_equal_jax(root, it):
    """The registered loader resolves to the port's class and gives JAX's
    batches: the same views in the same order, every array equal, GT
    composited over white by alpha."""
    cfg = {"dataset_config": _ds_cfg(root, 64), "batch_size": 4,
           "total_num_iter": 3, "world_size": 1, "rank": 0}
    assert load_dataloader("Wonder3DDataLoader") is Wonder3DDataLoader
    loader = load_dataloader("Wonder3DDataLoader")(copy.deepcopy(cfg),
                                                  device="cpu")
    jloader = jax_load_dataloader("Wonder3DDataLoader")(copy.deepcopy(cfg))
    assert loader.num_forward_per_iter == jloader.num_forward_per_iter == 2
    for fw in range(2):
        b, jb = loader(it, fw), jloader(it, fw)
        assert b["img"].shape[0] == 4      # the rank slice, every forward
        for k in ("mv", "mvp", "campos", "img", "n", "d", "background"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        img = b["img"].numpy()
        np.testing.assert_allclose(img[..., :3][img[..., 3] == 0], 1.0,
                                   atol=1e-6)


def _train_cfg(root, tmp_path, tag):
    import json
    kp = tmp_path / "kp.json"
    kp.write_text(json.dumps({"pt": [[0.0, 0.0, 0.0]], "r": [0.35]}))
    out = str(tmp_path / tag)
    return {
        "fitting_stage": "geometry",
        "geometry_type": "TetMeshMultiSphereGeometry",
        "geometry": {"use_smooth_barrier": False,
                     "key_points_file_path": str(kp),
                     "tetwild_cache_folder": str(tmp_path / "c"),
                     "output_path": out},
        "dataloader_type": "Wonder3DDataLoader",
        "data": {"dataset_config": _ds_cfg(root, 64),
                 "world_size": 1, "rank": 0, "batch_size": 6,
                 "total_num_iter": 3},
        "renderer": {"context_type": "cuda", "is_orhto": True},
        "optimizer": {"type": "adam", "lr": 3e-3},
        "output_path": out, "total_num_iter": 3,
        "use_permute_surface_v": False,
        "log_every": 1000, "export_every": 10 ** 6,
    }


def _recording(module, losses):
    """Wrap ``module.make_train_step`` so every step's loss is kept."""
    make = module.make_train_step

    def spy(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch, it):
            state, out = step(state, batch, it)
            losses.append(float(out[0]))
            return state, out
        return recorded
    return spy


def test_ortho_train_matches_jax(root, tmp_path, monkeypatch):
    """train() on the Wonder3D loader with the orthographic projection
    (renderer.is_orhto: z / 6, reference renderers/mesh_rasterizer.py:
    76-77), 3 iterations of Adam: every iteration's loss within rtol 1e-5
    of JAX's train() on the same config, and the best loss."""
    lj, lt = [], []
    monkeypatch.setattr(jax_train_mod, "make_train_step",
                        _recording(jax_train_mod, lj))
    monkeypatch.setattr(torch_train_mod, "make_train_step",
                        _recording(torch_train_mod, lt))
    st_j, _ = jax_train_mod.train(JaxConfigDict(_train_cfg(root, tmp_path,
                                                           "jax")))
    st_t, geo = torch_train_mod.train(ConfigDict(_train_cfg(root, tmp_path,
                                                            "torch")),
                                      device="cpu")
    assert len(lt) == len(lj) == 3
    assert all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(float(st_t.best_loss), float(st_j.best_loss),
                               rtol=1e-5)
    assert (tmp_path / "torch" / "final" / "final.veg").exists()
