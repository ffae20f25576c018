"""Row-slab rendering and spatial training of the port against the JAX
package on the CPU (tests/test_spatial.py's scenes): a slab with a
viewport (row0, full_h) against the full image's rows and against JAX's
slab rasterizers, the shading and the antialias under a viewport against
JAX's ``antialias(viewport=, row_valid=)``, and train() with spatial=2
over two gloo ranks against JAX's single-device train(). The sharded loss
itself is in tests/test_torch_spatial_loss.py."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.config import ConfigDict as JaxConfigDict
from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.mesh.spheres import tet_sphere as jax_tet_sphere
from tssplat_tpu.mesh.surface import triangle_edge_neighbors
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.pallas_raster import rasterize_ids_pallas
from tssplat_tpu.ops.rasterize import antialias as jax_antialias
from tssplat_tpu.ops.rasterize import rasterize as jax_rasterize
from tssplat_tpu.ops.rasterize import rasterize_ids as jax_rasterize_ids
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.ops.transform import transform_pos as jax_transform
from tssplat_tpu.tools.synthetic import \
    write_synthetic_dataset as jax_write_dataset
from tssplat_tpu.train import train as jax_train

from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import bin_faces, bin_faces_capped, capacity
from tssplat_torch.ops.rasterize import antialias, rasterize
from tssplat_torch.tools.run_ranks import run_ranks

torch.set_num_threads(1)

H = W = 128
SLABS = [(r, h) for r in (-8, 0, 40, 96) for h in (32, 64)]
ZOOM = 6.0


@pytest.fixture(scope="module")
def scene():
    """tests/test_spatial.py's _scene: tet_sphere(0.06, radius=0.3) from 2
    views (corner layout), as numpy, with the port's full-image K1 output
    (its plain version) at 128²."""
    v, t = jax_tet_sphere(0.06, radius=0.3)
    mesh = JaxTetMesh(v, t)
    vc = np.asarray(mesh.vtx[mesh.surface_vid[mesh.surface_fid]
                             .reshape(-1)], np.float32)
    F = mesh.surface_fid.shape[0]
    nbrs = np.asarray(triangle_edge_neighbors(mesh.surface_fid), np.int32)
    mvp, _, _ = fibonacci_views(2)
    pos = np.asarray(jax_transform(jnp.asarray(mvp, jnp.float32),
                                   jnp.asarray(vc)))
    tri_c = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    tp, tn = torch.from_numpy(pos), torch.from_numpy(nbrs).long()
    full = rk.visibility(bin_faces(tp, tn, (H, W)), (H, W))
    return dict(pos=pos, tri_c=tri_c, nbrs=nbrs, tp=tp, tn=tn, F=F,
                full=[x.numpy() for x in full])


def _rows(x, lo, hi):
    return x[:, lo:hi] if x.ndim == 3 else x[:, :, lo:hi]


@pytest.fixture(scope="module")
def border_scene(scene):
    """The scene seen through a lens ZOOM times longer (its clip x and y
    scaled): the sphere, about 1.26 wide in NDC, crosses the image's top
    and bottom rows, so a slab at an edge of the image has foreground on
    its first or last image row, next to the zeroed rows outside it."""
    pos = scene["pos"].copy()
    pos[..., :2] *= ZOOM
    tp = torch.from_numpy(pos)
    full = rk.visibility(bin_faces(tp, scene["tn"], (H, W)), (H, W))
    return dict(scene, pos=pos, tp=tp, full=[x.numpy() for x in full])


def _check_slab_visibility(sc, row0, h, outside_empty=True):
    tp, tn = sc["tp"], sc["tn"]
    vp, res = (row0, H), (h, W)
    lo, hi = max(0, -row0), min(h, H - row0)
    k1 = [x.numpy() for x in rk.visibility(bin_faces(tp, tn, res, vp), res)]
    cb = bin_faces_capped(tp, tn, res, capacity(None, sc["F"], (H, W)), vp)
    assert int(cb.n_drop.sum()) == 0
    walk = [x.numpy() for x in rk.visibility_capped(cb, res)]
    for got in (k1, walk):
        for a, b in zip(got, sc["full"]):
            np.testing.assert_array_equal(_rows(a, lo, hi),
                                          _rows(b, row0 + lo, row0 + hi))
        if outside_empty:               # a centred scene
            np.testing.assert_array_equal(got[0][:, :lo], 0)
            np.testing.assert_array_equal(got[0][:, hi:], 0)
    for a, b in zip(k1, walk):
        np.testing.assert_array_equal(a, b)

    pos, tri_c = jnp.asarray(sc["pos"]), jnp.asarray(sc["tri_c"])
    brute = np.asarray(jax_rasterize_ids(pos, tri_c, res, viewport=vp))
    np.testing.assert_array_equal(k1[0], brute)
    ids_j, _, g_j, aux_j = (np.asarray(a) for a in rasterize_ids_pallas(
        pos, tri_c, res, corner=True, with_g=jnp.asarray(sc["nbrs"]),
        interpret=True, row0=jnp.int32(row0), full_h=H))
    np.testing.assert_array_equal(k1[0] > 0, ids_j > 0)
    same = k1[0] == ids_j
    assert (~same).sum() <= 0.005 * (sc["full"][0] > 0).sum()
    for a, b in ((k1[2], g_j), (k1[3], aux_j)):
        s = np.broadcast_to(same[:, None], b.shape)
        np.testing.assert_allclose(a[s], b[s], atol=1e-6)
    return k1


@pytest.mark.parametrize("row0, h", SLABS,
                         ids=[f"row0_{r}_h{h}" for r, h in SLABS])
def test_slab_visibility_matches_full_rows_and_jax(scene, row0, h):
    """K1's plain version and the capped walk on a slab of h rows at row0:
    the slab's rows inside the image equal the full image's, ids and z
    exactly (rows equal too); ids equal JAX's brute-force
    ``rasterize_ids(viewport=)`` everywhere, and JAX's interpreted
    ``rasterize_ids_pallas(row0=, full_h=)`` but at depth near-ties (<=
    0.5% of the image's foreground, tests/test_torch_kernels.py), the
    winner rows within 1e-6 where the ids agree (JAX's test_spatial.py)."""
    _check_slab_visibility(scene, row0, h)


def _check_slab_aa(sc, row0, h, jit_forward=True):
    import jax
    wrap = jax.jit if jit_forward else (lambda f: f)
    vp, res = (row0, H), (h, W)
    absr = row0 + np.arange(h)
    valid = (absr >= 0) & (absr < H)
    tp = sc["tp"].clone().requires_grad_(True)
    rast, _ = rasterize(tp, res, viewport=vp)
    rast = rast * torch.from_numpy(valid)[:, None, None].float()
    a = antialias(rast, tp, sc["tn"], viewport=vp)
    ct = np.random.default_rng(2).normal(size=a.shape).astype(np.float32)
    g, = torch.autograd.grad(a, [tp], torch.from_numpy(ct))

    tri_c, nbrs = jnp.asarray(sc["tri_c"]), jnp.asarray(sc["nbrs"])
    vmask = jnp.asarray(valid)

    def jax_cov(pos):
        r = jax_rasterize(pos, tri_c, res, method="chunked", corner=True,
                          viewport=(jnp.int32(row0), H))
        r = r * vmask.astype(r.dtype)[None, :, None, None]
        return r, jax_antialias(jnp.clip(r[..., 3:4], 0.0, 1.0), r, pos,
                                tri_c, nbrs, corner=True,
                                viewport=(jnp.int32(row0), H),
                                row_valid=vmask)[..., 0]

    pos = jnp.asarray(sc["pos"])
    r_j, a_j = wrap(jax_cov)(pos)
    np.testing.assert_allclose(rast.detach().numpy(), np.asarray(r_j),
                               atol=1e-6)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_j),
                               atol=1e-6)
    g_j = np.asarray(jax.jit(jax.grad(
        lambda p: jnp.sum(jax_cov(p)[1] * ct)))(pos))
    np.testing.assert_allclose(g.numpy(), g_j,
                               atol=1e-5 * np.abs(g_j).max())
    lo, hi = max(valid.argmax(), 1), min(valid.sum() + valid.argmax(), h - 1)
    full, _ = rasterize(sc["tp"], (H, W))
    a_full = antialias(full, sc["tp"], sc["tn"])
    np.testing.assert_allclose(a.detach().numpy()[:, lo:hi],
                               a_full.detach().numpy()[:, row0 + lo:
                                                       row0 + hi], atol=1e-6)
    assert float(a.detach()[:, ~torch.from_numpy(valid)].abs().sum()) == 0
    return rast.detach()


@pytest.mark.parametrize("row0, h", [(-8, 48), (32, 64), (88, 48)],
                         ids=["top_halo", "interior", "bottom_pad"])
def test_slab_shading_and_antialias_match_jax(scene, row0, h):
    """``rasterize`` and the coverage ``antialias`` of a slab, its rows
    outside the image zeroed as the spatial loss does, against JAX's
    chunked ``rasterize(viewport=)`` and ``antialias(viewport=,
    row_valid=)``: rast within 1e-6, coverage within 1e-6 and its gradient
    w.r.t. the clip positions (K5 -> K3 -> the face table) within 1e-5 of
    its max under a seeded cotangent; inside the image and away from the
    slab's edges the coverage equals the full image's."""
    _check_slab_aa(scene, row0, h)


EDGE_SLABS = [(-8, 48), (88, 48)]


@pytest.mark.parametrize("row0, h", EDGE_SLABS,
                         ids=["top_halo", "bottom_pad"])
def test_border_slab_matches_full_rows_and_jax(border_scene, row0, h):
    """The slabs at the image's top (row0 -8) and bottom (rows past the
    image) of a scene whose silhouette crosses both edges: visibility and
    the antialias as the two tests above hold them (against the whole
    image's rows and JAX's slab rasterizers and ``antialias(viewport=,
    row_valid=)``). The rows outside the image are drawn as the camera
    sees them (JAX's brute force does the same) and zeroed before the
    antialias; the slab's image row next to them holds foreground, so a
    vertical pair into a row outside the image, which JAX's ``row_valid``
    cuts, would change that row's coverage. JAX's forward runs eagerly
    here: under jit XLA:CPU contracts multiply-adds into FMAs (ROADMAP
    queue 3), which moves the barycentrics of faces reaching far off the
    screen by up to 2e-6, where eager JAX equals the port to the bit."""
    edge = -row0 if row0 < 0 else H - 1 - row0  # the image's first / last row
    out = slice(0, edge) if row0 < 0 else slice(edge + 1, h)
    k1 = _check_slab_visibility(border_scene, row0, h, outside_empty=False)
    assert ((k1[0][:, edge] > 0).sum(axis=-1) >= 20).all()
    assert ((k1[0][:, out] > 0).sum(axis=(1, 2)) >= 20).all()
    rast = _check_slab_aa(border_scene, row0, h, jit_forward=False)
    assert bool(((rast[:, edge, :, 3] > 0).sum(-1) >= 20).all())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    v, f = icosphere(2)
    jax_write_dataset(str(root / "img"), v * np.asarray([0.3, 0.25, 0.2]),
                      f, n_views=4, resolution=64)
    (root / "kp.json").write_text(json.dumps({"pt": [[0.0, 0.0, 0.0]],
                                              "r": [0.24]}))
    return root


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
                 "world_size": 1, "rank": 0, "batch_size": 4,
                 "total_num_iter": 4},
        "optimizer": {"lr": 0.2, "grad_limit": True,
                      "grad_limit_values": [0.01, 0.01],
                      "grad_limit_iters": [4]},
        "output_path": out, "total_num_iter": 4,
        "use_permute_surface_v": False, "log_every": 1,
        "export_every": 10 ** 6, "data_parallel": False,
    }
    cfg.update(over)
    return cfg


def test_spatial_train_matches_jax(dataset):
    """train() with spatial=2 over two gloo ranks (a (1, 2) grid: each rank
    renders a 48-row slab of every view), 4 iterations, against one
    process of the port (each iteration's loss within rtol 1e-5) and
    against JAX's single-device train() (best loss within rtol 1e-5, the
    parameters within atol 1e-6: tests/test_spatial.py:213-215); the
    ranks' parameters are the same bits."""
    job = "tssplat_torch.tools.run_ranks:train_rank"
    env = dict(os.environ)
    sp = run_ranks(job, dict(out=str(dataset), device="cpu",
                             cfg=_cfg(dataset, "sp2", spatial=2)),
                   world_size=2, timeout=80.0, device="cpu", env=env)
    one = run_ranks(job, dict(out=str(dataset / "one"), device="cpu",
                              cfg=_cfg(dataset, "one")),
                    world_size=1, timeout=80.0, device="cpu", env=env)[0]
    params = [torch.load(r["params"]) for r in sp]
    assert torch.equal(params[0], params[1])
    assert sp[0]["steps"] == sp[1]["steps"]
    for a, b in zip(sp[0]["steps"], one["steps"]):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
    state, _ = jax_train(JaxConfigDict(_cfg(dataset, "jax")))
    np.testing.assert_allclose(sp[0]["best_loss"], float(state.best_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(params[0].numpy(), np.asarray(state.params),
                               atol=1e-6)
