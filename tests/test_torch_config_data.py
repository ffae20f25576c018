"""What the port's driver reads, against the JAX package on the same
inputs: the config loader and registries, the datasets and loaders, the
dataset writer, the geometry hooks and exports; and the port's own
checkpoint format."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tssplat_tpu import config as jax_config
from tssplat_tpu.data import ArrayDataLoader as JaxArrayDataLoader
from tssplat_tpu.data import MitsubaImgDataset as JaxMitsubaImgDataset
from tssplat_tpu.geometry import TetMeshGeometry as JaxTetMeshGeometry
from tssplat_tpu.geometry import \
    TetMeshMultiSphereGeometry as JaxMultiSphereGeometry
from tssplat_tpu.geometry.tet_geometry import \
    LinearInterpolateScheduler as JaxScheduler
from tssplat_tpu.mesh.spheres import icosphere, tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views as jax_views
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset

from tssplat_torch import config
from tssplat_torch.data import (ArrayDataLoader, MitsubaImgDataset,
                                MitsubaImgDataLoader)
from tssplat_torch.geometry import (LinearInterpolateScheduler,
                                    TetMeshGeometry,
                                    TetMeshMultiSphereGeometry,
                                    permute_surface_vertices)
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.optim import adam, adam_uniform, apply_updates
from tssplat_torch.tools.synthetic import (render_rgb_of_mesh,
                                           render_views_of_mesh,
                                           write_synthetic_dataset)
from tssplat_torch.train import TrainState, init_train_state
from tssplat_torch.utils.tree import tree_leaves, tree_map
from tssplat_torch.utils import (ThroughputMeter, latest_checkpoint_step,
                                 restore_checkpoint, save_checkpoint)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 128
N_VIEWS = 3


def _same(a, b):
    """Equal values of equal types, recursively."""
    assert type(a) is type(b) or (isinstance(a, dict)
                                   and isinstance(b, dict)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


OVERRIDES = ["data.total_num_iter=24", "log_every=4", "export_every=12",
             "output_path=/tmp/o", "geometry.key_points_file_path=/tmp/kp",
             "view_chunk=0", "fit_depth=true", "optimizer.type=adam",
             "optimizer.lr=0.002", "renderer.is_orhto=True", "seed=~",
             "new.nested.key=[1, 2.5, on]"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["shipped", "overrides"])
@pytest.mark.parametrize("name", ["gso.yaml", "img_to_3D.yaml"])
def test_load_config_matches_jax(name, overrides):
    """Both shipped configs, as shipped and under CLI overrides: the same
    nested dict, key order and value types (interpolations that are the
    whole string keep the referent's type)."""
    path = os.path.join(REPO, "configs", name)
    got = config.load_config(path, cli_args=overrides)
    want = jax_config.load_config(path, cli_args=overrides)
    assert isinstance(got, config.ConfigDict)
    _same(dict(got), dict(want))
    assert got.total_num_iter == got.data.total_num_iter
    assert got.permute_surface_v_param.end_iter == got.total_num_iter
    assert got.get("missing", 7) == 7
    with pytest.raises(AttributeError):
        got.missing
    if overrides:
        assert got.total_num_iter == 24 and got.output_path == "/tmp/o"
        assert got.new.nested.key == [1, 2.5, True] and got.seed is None
    with pytest.raises(ValueError, match="key=value"):
        config.load_config(path, cli_args=["log_every"])


def test_interpolation_merge_and_dump(tmp_path):
    """``${a.b}`` inside a string and cycles; merge_dicts as JAX's;
    dump_config then load_config round-trips the resolved config."""
    text = ("a: {b: 3, c: 'x${a.b}y'}\nd: ${a.b}\ne: ${a}\n")
    for load in (config.load_config, jax_config.load_config):
        got = load(text, from_string=True)
        _same(dict(got), {"a": {"b": 3, "c": "x3y"}, "d": 3,
                          "e": {"b": 3, "c": "x3y"}})
    with pytest.raises(ValueError, match="cycle"):
        config.load_config("a: ${b}\nb: ${a}\n", from_string=True)
    base = {"a": {"b": 1, "c": [1]}, "d": 2}
    over = {"a": {"c": [2], "e": {"f": 3}}, "g": None}
    _same(config.merge_dicts(base, over), jax_config.merge_dicts(base, over))
    assert base == {"a": {"b": 1, "c": [1]}, "d": 2}

    cfg = config.load_config(os.path.join(REPO, "configs", "gso.yaml"),
                             cli_args=OVERRIDES)
    path = str(tmp_path / "dump.yaml")
    config.dump_config(path, cfg)
    _same(dict(config.load_config(path)), dict(cfg))


def test_registries():
    """The names the shipped configs use resolve to the port's classes;
    unknown names raise with the known ones; the Wonder3D loader's name
    resolves to its loader (tests/test_torch_wonder3d.py runs it)."""
    from tssplat_torch.data import Wonder3DDataLoader, Wonder3DImgDataset
    from tssplat_torch.materials import ExplicitMaterial
    assert config.load_geometry("TetMeshMultiSphereGeometry") \
        is TetMeshMultiSphereGeometry
    assert config.load_geometry("TetMeshGeometry") is TetMeshGeometry
    for name in ("MistubaImgDataLoader", "MitsubaImgDataLoader"):
        assert config.load_dataloader(name) is MitsubaImgDataLoader
    assert set(config.DATALOADERS.names()) == {
        "MistubaImgDataLoader", "MitsubaImgDataLoader",
        "BlenderImgDataLoader", "ArrayDataLoader", "Wonder3DDataLoader"}
    with pytest.raises(KeyError, match="TetMeshGeometry"):
        config.load_geometry("NoSuchGeometry")
    assert config.load_material("ExplicitMaterial") is ExplicitMaterial
    assert config.MATERIALS.names() == ["ExplicitMaterial"]
    with pytest.raises(KeyError, match="unknown material.*ExplicitMaterial"):
        config.load_material("None")
    loader = config.load_dataloader("Wonder3DDataLoader")
    assert loader is Wonder3DDataLoader
    assert loader.dataset_cls is Wonder3DImgDataset


def _arrays(n, res=8):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (n, res, res, 4)).astype(np.float32)
    mv = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    mv[:, :3, 3] = rng.normal(size=(n, 3))
    mvp = rng.normal(size=(n, 4, 4)).astype(np.float32)
    return dict(imgs=imgs, mvp=mvp, mv=mv)


@pytest.mark.parametrize("world_size", [1, 3])
def test_loader_batches_match_jax(world_size):
    """7 views, batch 3 (no divisor of 7), 5 iterations: the batch indices
    of every (iteration, forward, rank) are JAX's (the same Python-random
    stream, warm-up shuffle included), and every batch entry equals JAX's
    (RGB composited over white by alpha, alpha kept)."""
    arrays = _arrays(7)
    cfg = dict(batch_size=3, total_num_iter=5, world_size=world_size, rank=0)
    got = ArrayDataLoader(cfg, device="cpu", **arrays)
    want = JaxArrayDataLoader(cfg, **arrays)
    assert got.num_forward_per_iter == want.num_forward_per_iter \
        == -(-7 // (3 * world_size))
    for it in range(5):
        for fw in range(got.num_forward_per_iter):
            for r in range(world_size):
                np.testing.assert_array_equal(got.batch_indices(it, fw, r),
                                              want.batch_indices(it, fw, r))
            b_t, b_j = got(it, fw), want(it, fw)
            assert set(b_t) == set(b_j)
            for k, v in b_j.items():
                if k in ("resolution", "spp"):
                    assert b_t[k] == v
                else:
                    np.testing.assert_allclose(b_t[k].numpy(), np.asarray(v),
                                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch_size, world_size", [(3, 1), (3, 3), (7, 1),
                                                     (2, 2)])
def test_loader_device_ids_are_the_batch_indices(batch_size, world_size):
    """The loader's device table gives ``batch_indices(it, fw, r)`` for
    every iteration, forward and rank; a call gathers into buffers it
    reuses (marked REUSED) and returns those ids' views of ``data_all``."""
    from tssplat_torch.data.loader import REUSED

    cfg = dict(batch_size=batch_size, total_num_iter=6,
               world_size=world_size, rank=0)
    loader = ArrayDataLoader(cfg, device="cpu", **_arrays(7))
    assert loader.ids.shape == (6, 7) and loader.ids.dtype == torch.int64
    for it in range(6):
        for fw in range(loader.num_forward_per_iter):
            for r in range(world_size):
                np.testing.assert_array_equal(
                    loader.device_ids(it, fw, r).numpy(),
                    loader.batch_indices(it, fw, r))
    first = loader(0, 0)
    img0 = first["img"].clone()
    again = loader(1, 0)
    ids = torch.as_tensor(loader.batch_indices(1, 0)).long()
    for k in ("mv", "mvp", "campos", "img", "background", "n", "d"):
        assert again[k] is first[k] and getattr(again[k], REUSED)
        assert torch.equal(again[k], loader.data_all[k][ids])
    assert torch.equal(again["view_idx"], ids.to(torch.int32))
    assert torch.equal(loader(0, 0)["img"], img0)
    with pytest.raises(IndexError):
        loader.device_ids(0, loader.num_forward_per_iter)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The ellipsoid icosphere(3) * (0.30, 0.24, 0.18) at N_VIEWS x 128²,
    written by JAX's writer and by the port's."""
    root = tmp_path_factory.mktemp("writers")
    v, f = icosphere(subdivisions=3)
    v = v * np.asarray([0.30, 0.24, 0.18])
    jax_write_dataset(str(root / "jax"), v, f, n_views=N_VIEWS,
                      resolution=RES)
    write_synthetic_dataset(str(root / "torch"), v, f, n_views=N_VIEWS,
                            resolution=RES, device="cpu")
    return root


def test_mitsuba_dataset_matches_jax(datasets):
    """MitsubaImgDataset on the JAX writer's files: every array of JAX's."""
    cfg = {"image_root": str(datasets / "jax")}
    got, want = MitsubaImgDataset(cfg), JaxMitsubaImgDataset(cfg)
    assert len(got) == len(want) == N_VIEWS
    assert got.resolution == want.resolution == RES and got.spp == 1
    for name in ("all_tgt_imgs", "all_mvp_mats", "all_mv_mats", "all_campos",
                 "all_tgt_ns", "all_tgt_ds", "bgs"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.camera_p, want.camera_p)
    assert got.camera_dist == want.camera_dist
    with pytest.raises(ValueError, match="not a directory"):
        MitsubaImgDataset({"image_root": str(datasets / "none")})


def test_writer_matches_jax(datasets):
    """The port's write_synthetic_dataset against JAX's on the same mesh:
    the same files; matrices equal; the alpha bytes equal, and depth and
    normal within 1e-5 where both are foreground, at all but 0.5% of the
    foreground pixels (z near-ties between faces, where the two packages'
    clip transforms, a last bit apart, pick different winners; ROADMAP
    queue 3); the normal's
    4th channel the alpha; the RGB the bytes of render_rgb_of_mesh (the
    antialiased Lambertian shade; test_writer_rgb_matches_jax holds it to
    JAX's writer)."""
    jd, td = datasets / "jax", datasets / "torch"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for i in range(N_VIEWS):
        for name in (f"mvp_mtx_{i}.npy", f"mv_{i}.npy"):
            np.testing.assert_array_equal(np.load(td / name),
                                          np.load(jd / name))
        img_t = np.asarray(Image.open(td / f"img_rgba_{i}.png"))
        img_j = np.asarray(Image.open(jd / f"img_rgba_{i}.png"))
        assert img_t.shape == img_j.shape == (RES, RES, 4)
        d_t, d_j = np.load(td / f"depth_{i}.npy"), np.load(jd / f"depth_{i}.npy")
        n_t = np.load(td / f"normal_{i}.npy")
        n_j = np.load(jd / f"normal_{i}.npy")
        assert n_t.shape == n_j.shape == (RES, RES, 4)
        fg = (d_t > 0) & (d_j > 0)
        assert fg.sum() > 200
        ties = 0.005 * int(fg.sum())
        assert int(np.sum(img_t[..., 3] != img_j[..., 3])) <= ties
        off = (np.abs(d_t - d_j) > 1e-5) \
            | (np.abs(n_t[..., :3] - n_j[..., :3]).max(-1) > 1e-5)
        assert int(np.sum(off & fg)) <= ties
        np.testing.assert_allclose(np.clip(n_t[..., 3] * 255, 0, 255)
                                   .astype(np.uint8), img_t[..., 3])
        v, f = icosphere(subdivisions=3)
        rgb = render_rgb_of_mesh(v * np.asarray([0.30, 0.24, 0.18]), f,
                                 np.load(td / f"mvp_mtx_{i}.npy")[None], RES,
                                 device="cpu")[0].numpy()
        np.testing.assert_array_equal(
            img_t[..., :3], np.clip(rgb * 255.0, 0, 255).astype(np.uint8))


def _jax_corner_rgb(v, f, mvp, res, light_dir=(0.3, 0.4, 0.85),
                    base_color=(0.8, 0.8, 0.8)):
    """JAX's writer's colour chain (tools/synthetic.py:60-69) in the
    corner layout: (B,res,res,3) float32."""
    import jax.numpy as jnp
    from tssplat_tpu.mesh.surface import triangle_edge_neighbors
    from tssplat_tpu.ops.rasterize import antialias, interpolate, rasterize
    from tssplat_tpu.ops.transform import transform_pos
    from tssplat_tpu.geometry.tet_geometry import compute_vertex_normals

    mvp = jnp.asarray(mvp, jnp.float32)
    F = f.shape[0]
    tri_c = jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3)
    vc = jnp.asarray(v[f.reshape(-1)], jnp.float32)
    pc = transform_pos(mvp, vc)
    rast = rasterize(pc, tri_c, (res, res), corner=True)
    nrm = interpolate(compute_vertex_normals(
        jnp.asarray(v, jnp.float32), jnp.asarray(f, jnp.int32))[f.reshape(-1)],
        rast, tri_c, corner=True)
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True),
                            1e-8)
    ld = np.asarray(light_dir, np.float32)
    lam = jnp.clip(jnp.abs(jnp.sum(nrm * (ld / np.linalg.norm(ld)), -1,
                                   keepdims=True)), 0.2, 1.0)
    col = antialias(lam * jnp.asarray(base_color, jnp.float32)
                    * (rast[..., 3:4] > 0), rast, pc, tri_c,
                    jnp.asarray(triangle_edge_neighbors(f), jnp.int32),
                    corner=True)
    return np.asarray(col)


def test_render_views_rgba_matches_jax():
    """render_views_of_mesh keeps JAX's contract: (rgba (B,H,W,4), depth
    (B,H,W), normal (B,H,W,3)) float32 numpy arrays, here with a light
    direction and base colour of its own. Unpacked as JAX's callers unpack
    it (tests/test_texture_exact.py:35-43: the RGB composited over a
    white background by the alpha), against JAX's render_views_of_mesh
    on 3 views of 128² of the ellipsoid (the port two views a chunk):
    alpha within 1e-5, depth 1e-5 and normal 1e-4, but at <= 2 pixels
    whose centre lies on an edge or whose winner is a z near-tie
    (tests/test_torch_package.py's tolerances); as the writer's bytes,
    the RGB within 1 LSB of JAX's corner-layout chain, and the composite
    within 1 LSB of JAX's but where JAX's two layouts part by more than 1
    LSB, at most 0.2 of the foreground (test_writer_rgb_matches_jax's
    allowance), each but at those <= 2 pixels and their 4 neighbours
    (one winner flip at a z near-tie, 1e-6 apart, on view 2 here: its
    right neighbour's colour, antialiased with it, is 2 LSB off)."""
    from tssplat_tpu.tools.synthetic import render_views_of_mesh as jax_rv
    v, f = icosphere(subdivisions=3)
    v = v * np.asarray([0.30, 0.24, 0.18])
    mvp, _, campos = jax_views(3)
    kw = dict(light_dir=(-0.5, 0.2, 0.6), base_color=(0.9, 0.5, 0.3))
    got = render_views_of_mesh(v, f, mvp, campos, 128, view_chunk=2,
                               device="cpu", **kw)
    want = jax_rv(v, f, mvp, campos, 128, **kw)
    for a, b, shape in zip(got, want, ((4,), (), (3,))):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == b.shape == (3, 128, 128) + shape
    (rgba, d_t, n_t), (rgba_j, d_j, n_j) = got, want

    def composite(rgba):
        bg = np.ones(rgba.shape[:-1] + (3,), np.float32)
        return bg + (rgba[..., :3] - bg) * rgba[..., 3:4]

    fg = rgba_j[..., 3] > 0
    assert fg.sum() > 500
    edge = (np.abs(rgba[..., 3] - rgba_j[..., 3]) > 1e-5) \
        | (np.abs(d_t - d_j) > 1e-5) | (np.abs(n_t - n_j).max(-1) > 1e-4)
    assert edge.sum() <= 2
    def u8(x):                                         # the writer's bytes
        return np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(int)

    # a winner taken at a z near-tie shades its pixel from the other face,
    # and the colour antialias carries that into the 4 pixels paired
    # with it
    pad = np.pad(edge, ((0, 0), (1, 1), (1, 1)))
    near = edge | pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1] | pad[:, 1:-1, :-2] \
        | pad[:, 1:-1, 2:]
    corner = u8(_jax_corner_rgb(v, f, mvp, 128, **kw))
    assert np.abs(u8(rgba[..., :3]) - corner).max(-1)[~near].max() <= 1
    layout = np.abs(u8(rgba_j[..., :3]) - corner).max(-1) > 1
    assert layout.sum() <= 0.2 * fg.sum()
    diff = np.abs(u8(composite(rgba)) - u8(composite(rgba_j))).max(-1)
    assert diff[~layout & ~near].max() <= 1
    assert rgba[..., :3].max() > 0.2                   # shaded, not black


@pytest.mark.parametrize("view_chunk", [1, 3])
def test_render_views_chunks_agree(view_chunk):
    """Chunks of 1 or 3 views (a ragged tail of 2) render the bits of one
    chunk of all 5."""
    v, f = icosphere(subdivisions=2)
    mvp, _, campos = jax_views(5)
    want = render_views_of_mesh(v * 0.3, f, mvp, campos, 48, view_chunk=8,
                                device="cpu")
    got = render_views_of_mesh(v * 0.3, f, mvp, campos, 48,
                               view_chunk=view_chunk, device="cpu")
    assert want[0][..., 3].sum() > 100
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_writer_bytes_equal_the_composition_it_replaces(tmp_path):
    """write_synthetic_dataset, now through render_views_of_mesh, writes
    every file byte for byte as the writer before it did: in chunks of 8
    views, the PNG from render_rgb_of_mesh and render_alpha_of_mesh, the
    depth and normal from the rasterized winners (10 views: a ragged
    second chunk)."""
    import filecmp
    from tssplat_torch.geometry import compute_vertex_normals
    from tssplat_torch.ops import interpolate, rasterize, transform_pos
    from tssplat_torch.tools.synthetic import render_alpha_of_mesh
    v, f = icosphere(subdivisions=2)
    v = v * np.asarray([0.30, 0.24, 0.18])
    n, res = 10, 32
    write_synthetic_dataset(str(tmp_path / "new"), v, f, n_views=n,
                            resolution=res, device="cpu")
    old = tmp_path / "old"
    old.mkdir()
    mvp, mv, campos = jax_views(n)
    ft = torch.as_tensor(f)
    corners = torch.as_tensor(v[f.reshape(-1)], dtype=torch.float32)
    vn = compute_vertex_normals(torch.as_tensor(v, dtype=torch.float32),
                                ft)[ft.reshape(-1)]
    for s in range(0, n, 8):
        m = mvp[s:s + 8]
        alpha = render_alpha_of_mesh(v, f, m, res, device="cpu").numpy()
        rgb = render_rgb_of_mesh(v, f, m, res, device="cpu").numpy()
        with torch.no_grad():
            rast, _ = rasterize(transform_pos(torch.as_tensor(
                m, dtype=torch.float32), corners), (res, res))
            nrm = interpolate(vn, rast)
            nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1,
                                                          keepdim=True), 1e-8)
            fg = rast[..., 3:4] > 0
            cam = torch.as_tensor(campos[s:s + 8], dtype=torch.float32)
            depth = (torch.linalg.norm(interpolate(corners, rast)
                                       - cam[:, None, None, :], dim=-1)
                     * fg[..., 0]).numpy()
            normal = (nrm * fg).numpy()
        rgba = np.concatenate([rgb, alpha], axis=-1)
        for j in range(alpha.shape[0]):
            i = s + j
            Image.fromarray(np.clip(rgba[j] * 255.0, 0, 255).astype(
                np.uint8)).save(old / f"img_rgba_{i}.png")
            np.save(old / f"mvp_mtx_{i}.npy", mvp[i].astype(np.float32))
            np.save(old / f"mv_{i}.npy", mv[i].astype(np.float32))
            np.save(old / f"depth_{i}.npy", depth[j].astype(np.float32))
            np.save(old / f"normal_{i}.npy", np.concatenate(
                [normal[j], alpha[j]], axis=-1).astype(np.float32))
    names = sorted(os.listdir(old))
    assert names == sorted(os.listdir(tmp_path / "new")) and len(names) == 50
    for name in names:
        assert filecmp.cmp(old / name, tmp_path / "new" / name,
                           shallow=False), name


def test_writer_rgb_matches_jax(tmp_path):
    """The two writers' img_rgba_*.png at 4 views of 64² of the ellipsoid:
    every byte within 1 LSB, but at the pixels where JAX's writer disagrees
    with JAX's own corner-layout colour antialias (ROADMAP queue 3: its
    clip transform of the 642 shared vertices and of the 3,840 corners
    differ in the last bit, which moves the AA of a few interior pixel
    pairs: 12 of view 0's 112 foreground pixels); the port's RGB equals
    the corner-layout chain within 1 LSB everywhere."""
    v, f = icosphere(subdivisions=3)
    v = v * np.asarray([0.30, 0.24, 0.18])
    n, res = 4, 64
    jax_write_dataset(str(tmp_path / "jax"), v, f, n_views=n, resolution=res)
    write_synthetic_dataset(str(tmp_path / "torch"), v, f, n_views=n,
                            resolution=res, device="cpu")
    corner = np.clip(_jax_corner_rgb(v, f, jax_views(n)[0], res) * 255.0,
                     0, 255).astype(np.uint8)
    for i in range(n):
        a, b = (np.asarray(Image.open(tmp_path / d / f"img_rgba_{i}.png"))
                .astype(int) for d in ("jax", "torch"))
        assert np.abs(a[..., 3] - b[..., 3]).max() <= 1
        layout = np.abs(a[..., :3] - corner[i]).max(-1) > 1
        assert layout.sum() <= 0.2 * (a[..., 3] > 0).sum()
        assert np.abs(a - b)[~layout].max() <= 1
        assert np.abs(b[..., :3] - corner[i]).max() <= 1


def test_exports_match_jax(tmp_path):
    """export(..., save_npy=True) of both geometries writes JAX's file set
    with JAX's arrays: .veg, surface .obj, _vtx / _elem npys (and, for
    the multi-sphere geometry, the per-sphere npys and index JSONs)."""
    v, t = tet_sphere(0.12, radius=0.3)
    kp = tmp_path / "kp.json"
    kp.write_text(json.dumps({"pt": [[0, 0, 0], [0.3, 0, 0]],
                              "r": [0.2, 0.15]}))
    for name, make_t, make_j in (
            ("tet", lambda: TetMeshGeometry(
                dict(use_smooth_barrier=False), tetmesh=TetMesh(v, t),
                device="cpu"),
             lambda: JaxTetMeshGeometry(dict(use_smooth_barrier=False),
                                        tetmesh=JaxTetMesh(v, t))),
            ("multi", lambda: TetMeshMultiSphereGeometry(dict(
                use_smooth_barrier=False, key_points_file_path=str(kp),
                tetwild_cache_folder=str(tmp_path / "cache_t"),
                output_path=str(tmp_path / "out_t")), device="cpu"),
             lambda: JaxMultiSphereGeometry(dict(
                 use_smooth_barrier=False, key_points_file_path=str(kp),
                 tetwild_cache_folder=str(tmp_path / "cache_j"),
                 output_path=str(tmp_path / "out_j"))))):
        geo_t, geo_j = make_t(), make_j()
        rng = np.random.default_rng(1)
        tet_v = np.asarray(geo_j.tet_v) + rng.normal(
            0, 1e-3, geo_j.tet_v.shape).astype(np.float32)
        geo_t.set_tet_v(tet_v)
        geo_j.set_tet_v(tet_v)
        dt, dj = tmp_path / f"{name}_t", tmp_path / f"{name}_j"
        geo_t.export(str(dt), "final", save_npy=True)
        geo_j.export(str(dj), "final", save_npy=True)
        files = sorted(os.listdir(dj))
        assert sorted(os.listdir(dt)) == files
        assert {"final.veg", "final_surface_mesh.obj", "final_vtx.npy",
                "final_elem.npy"} <= set(files)
        for f in files:
            if f.endswith(".npy"):
                a, b = np.load(dt / f), np.load(dj / f)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert (dt / f).read_bytes() == (dj / f).read_bytes(), f
        geo_t.export(str(tmp_path / f"{name}_plain"), "x")
        assert "x_vtx.npy" not in os.listdir(tmp_path / f"{name}_plain")


def test_scheduler_matches_jax():
    """LinearInterpolateScheduler fires where JAX's does with its value,
    the unclamped extrapolation past end_iter included."""
    kw = dict(start_iter=30, end_iter=70, start_val=0.01, end_val=0.001,
              freq=10)
    got, want = LinearInterpolateScheduler(**kw), JaxScheduler(**kw)
    for it in range(0, 200):
        assert got(it) == want(it)
    assert got(100) is not None and got(100) < 0.001
    assert LinearInterpolateScheduler(1500, 24, 0.01, 0.001, 1000)(1000) \
        is None


def test_permute_surface_vertices_contract():
    """Only surface vertices move, each coordinate by less than dev/2; the
    same noise for the same generator seed (CPU draws)."""
    mesh = TetMesh(*tet_sphere(0.12, radius=0.3))
    tet_v = torch.as_tensor(mesh.vtx, dtype=torch.float32)
    sv = torch.as_tensor(mesh.surface_vid)
    dev = 0.01

    def run(seed):
        return permute_surface_vertices(
            tet_v, sv, torch.Generator().manual_seed(seed), dev)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    moved = (a - tet_v).abs()
    inner = torch.ones(tet_v.shape[0], dtype=torch.bool)
    inner[sv] = False
    assert float(moved[inner].max()) == 0.0
    assert float(moved[sv].max()) < dev / 2 + 1e-7
    assert float(moved[sv].min(dim=0).values.max()) < dev / 4
    assert int((moved[sv] > 0).sum()) > 0.9 * moved[sv].numel()


def _leaves(state):
    return [leaf for part in (state.params, *state.opt_state,
                              state.best_loss, state.best_iter,
                              state.best_params)
            for leaf in tree_leaves(part)]


@pytest.mark.parametrize("opt", ["adam_uniform", "adam", "adam_uniform_dict",
                                 "adam_dict"])
def test_checkpoint_round_trip(tmp_path, opt):
    """The full TrainState with either optimizer's state, of one tensor (the
    geometry stage) or of a material's dict of them (the texture stage):
    the file loads with weights_only=True; restore gives every field back
    on the template's device, the newest by default or a given step; the
    newest ``keep`` stay; a template of another optimizer is refused."""
    init_fn, update_fn = (adam_uniform(0.1, grad_limit=True) if
                          opt.startswith("adam_uniform") else adam(1e-3))
    rng = np.random.default_rng(0)

    def like(x):
        t = torch.as_tensor(x, dtype=torch.float32)
        if opt.endswith("_dict"):
            return {"encoding": {"table": t[:2]},
                    "network": {"l0_b": t[2], "l0_w": t[3:]}}
        return t
    params = like(rng.normal(size=(5, 3)))
    states = {}
    state = init_train_state(params, init_fn)
    d = str(tmp_path / "ckpt")
    for step in (2, 4, 6, 8):
        upd, opt_state = update_fn(tree_map(lambda p: p * step, params),
                                   state.opt_state)
        state = TrainState(params=apply_updates(state.params, upd),
                           opt_state=opt_state,
                           best_loss=torch.tensor(1.0 / step),
                           best_iter=torch.tensor(step, dtype=torch.int32),
                           best_params=tree_map(torch.clone, state.params))
        states[step] = state
        save_checkpoint(d, step, state, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000006.pt", "step_00000008.pt"]
    assert latest_checkpoint_step(d) == 8
    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    blob = torch.load(os.path.join(d, "step_00000008.pt"), weights_only=True)
    assert blob["step"] == 8 and isinstance(blob["state"], dict)

    template = init_train_state(like(np.zeros((5, 3))), init_fn)
    for step in (None, 6):
        got_step, got = restore_checkpoint(d, template, step=step)
        want = states[got_step]
        assert got_step == (step or 8)
        assert type(got) is TrainState
        assert type(got.opt_state) is type(want.opt_state)
        for a, b in zip(_leaves(got), _leaves(want)):
            assert a.device == _leaves(template)[0].device
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = adam(1e-3)[0] if opt.startswith("adam_uniform") else \
        adam_uniform(0.1)[0]
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(d, init_train_state(like(np.zeros((5, 3))),
                                               other))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), template)


def test_throughput_meter():
    m = ThroughputMeter()
    assert m.summary() == "n/a"
    m.update()
    m.update(2, 1000)
    assert m.iters_per_sec > 0 and m.rays_per_sec > 0
    assert "iters/s" in m.summary()


def test_writer_cli(tmp_path):
    """python -m tssplat_torch.tools.synthetic --mesh X.obj --save_path D:
    the layout MitsubaImgDataset reads, from an OBJ."""
    from tssplat_torch.mesh.io import save_obj
    from tssplat_torch.tools.synthetic import main
    v, f = icosphere(subdivisions=2)
    save_obj(str(tmp_path / "m.obj"), v * 0.3, f)
    main(["--mesh", str(tmp_path / "m.obj"), "--save_path",
          str(tmp_path / "d"), "--num_views", "2", "--resolution", "64"],
         device="cpu")
    ds = MitsubaImgDataset({"image_root": str(tmp_path / "d")})
    assert len(ds) == 2 and ds.resolution == 64
    assert 0.02 < ds.all_tgt_imgs[0][..., 3].mean() < 0.9
    assert ds.all_tgt_ds[0].shape == (64, 64, 1)
    assert abs(np.linalg.norm(ds.all_campos[0]) - 4.0) < 1e-3
