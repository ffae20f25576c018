"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Needs a CUDA device and nvcc; skips without a device. Imports no JAX,
so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from tssplat_torch.mesh.spheres import tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import bin_faces, bin_faces_capped, capacity
from tssplat_torch.ops.transform import fibonacci_views, transform_pos
from tssplat_torch.tools.synthetic import bench_scene, multisphere_scene
from tssplat_torch.tools.aa_cases import CASE_NAMES as AA_CASE_NAMES, aa_cases
from tssplat_torch.tools.shade_cases import (CASE_NAMES as SHADE_CASE_NAMES,
                                             check_shaded, shade_cases)
from tssplat_torch.tools.vis_cases import CASE_NAMES, capped_cases
from tssplat_torch.tools.wsr_cases import (CASE_NAMES as WSR_CASE_NAMES,
                                           rows_agree, wsr_cases)
from tssplat_torch.train import validated_tile_k

torch.set_num_threads(1)

@pytest.fixture(scope="module", params=[(128, 128), (72, 100)],
                ids=["128x128", "72x100"])
def scene(request):
    """1 sphere (178 faces), 2 views, corner layout, on the card; 72x100
    leaves partial 16x16 tiles at the image edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = TetMesh(*tet_sphere(0.12, radius=0.3))
    corners = torch.tensor(mesh.vtx[mesh.surface_vid[mesh.surface_fid]
                                    .reshape(-1)], dtype=torch.float32,
                           device=dev)
    mvp, _, _ = fibonacci_views(2)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32, device=dev),
                        corners)
    nbrs = torch.tensor(mesh.surface_edge_neighbors(), device=dev)
    res = request.param
    bins = bin_faces(pos, nbrs, res)
    return dict(bins=bins, F=int(nbrs.shape[0]), res=res,
                vis=rk.visibility_plain(bins, res),
                gen=torch.Generator(device=dev).manual_seed(0))


@pytest.mark.cuda
def test_visibility_kernel_matches_plain(scene):
    """K1: ids, z, g6 and gaux bit-identical (both built without FMA
    contraction)."""
    got = rk.visibility(scene["bins"], scene["res"])
    for a, b in zip(got, scene["vis"]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert int((got[0] > 0).sum()) > 100


@pytest.mark.cuda
def test_table_grad_kernel_matches_plain(scene):
    """K3: atomics reorder the float32 sums — rtol 1e-5."""
    ids = scene["vis"][0]
    ct = torch.randn((2, 6) + scene["res"], generator=scene["gen"],
                     device=ids.device)
    ct = ct * (ids > 0)[:, None]
    got = rk.wsr_table_grad(ids, ct, scene["F"])
    want = rk.wsr_table_grad_plain(ids, ct, scene["F"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not got[:, -1].any()


@pytest.fixture(scope="module")
def wsr_corner_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return wsr_cases(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WSR_CASE_NAMES)
def test_table_grad_kernel_on_corner_cases(wsr_corner_cases, name):
    """K3 against its plain version on the inputs that corner its tiles,
    runs and per-warp sums: each entry within 1e-5 of the sum of |ct| its
    row adds, NaN and inf where the plain version has them, row F zero
    (tools/wsr_cases.py rows_agree). Also where the pointers are not
    16-byte aligned, which takes the scalar loads."""
    ids, ct, F = wsr_corner_cases[name]
    rows_agree(rk.wsr_table_grad(ids, ct, F), ids, ct, F)
    ids1 = torch.empty(ids.numel() + 1, dtype=ids.dtype,
                       device=ids.device)[1:].view(ids.shape)
    ct1 = torch.empty(ct.numel() + 1, dtype=ct.dtype,
                      device=ct.device)[1:].view(ct.shape)
    ids1.copy_(ids)
    ct1.copy_(ct)
    rows_agree(rk.wsr_table_grad(ids1, ct1, F), ids, ct, F)


@pytest.mark.cuda
def test_antialias_kernels_match_plain(scene):
    """K4 and K5 against their plain versions: same arithmetic in the same
    order, equal by value."""
    ids, z, g6, gaux = scene["vis"]
    ct = torch.randn((2,) + scene["res"], generator=scene["gen"],
                     device=ids.device)
    torch.testing.assert_close(rk.aa_forward(ids, z, g6, gaux),
                               rk.aa_forward_plain(ids, z, g6, gaux),
                               atol=0, rtol=0)
    torch.testing.assert_close(rk.aa_backward(ids, z, g6, gaux, ct),
                               rk.aa_backward_plain(ids, z, g6, gaux, ct),
                               atol=0, rtol=0)
    assert rk.launch_counts()["aa_backward"] > 0


@pytest.fixture(scope="module")
def aa_corner_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return aa_cases(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", AA_CASE_NAMES)
def test_antialias_kernels_on_corner_cases(aa_corner_cases, name):
    """K4 and K5 equal by value to their plain versions on the inputs that
    corner their tiles, runs and pair list: pairs along and across the
    tiles' borders, on the image's border, ragged sizes (a width that is no
    multiple of four takes the scalar loads), empty and full tiles,
    interior edges, faces meeting at a vertex, equal depths, crossings at
    t = 0.5 exactly and one-pixel faces."""
    ids, z, g6, gaux = aa_corner_cases[name]
    ct = torch.randn(ids.shape, generator=torch.Generator(
        device=ids.device).manual_seed(3), device=ids.device)
    assert torch.equal(rk.aa_forward(ids, z, g6, gaux),
                       rk.aa_forward_plain(ids, z, g6, gaux))
    assert torch.equal(rk.aa_backward(ids, z, g6, gaux, ct),
                       rk.aa_backward_plain(ids, z, g6, gaux, ct))


@pytest.fixture(scope="module", params=[(128, 128), (64, 384)],
                ids=["128x128", "64x384"])
def capped_scene(request):
    """The same sphere on the capped layout's 8x128 tiles; 64x384 is
    aligned but its width is no power of two (where a reciprocal in place
    of a division would show)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = TetMesh(*tet_sphere(0.12, radius=0.3))
    corners = torch.tensor(mesh.vtx[mesh.surface_vid[mesh.surface_fid]
                                    .reshape(-1)], dtype=torch.float32,
                           device=dev)
    mvp, _, _ = fibonacci_views(2)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32, device=dev),
                        corners)
    nbrs = torch.tensor(mesh.surface_edge_neighbors(), device=dev)
    return dict(pos=pos, nbrs=nbrs, res=request.param)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 8], ids=["default_k", "k8_drops"])
def test_capped_visibility_kernels_match_plain(capped_scene, k):
    """K2b and K2a against their plain versions, bit for bit (built without
    FMA contraction), with the default capacity (no drops: both equal K1)
    and with k = 8, where tiles overflow and drop faces."""
    pos, nbrs, res = capped_scene["pos"], capped_scene["nbrs"], \
        capped_scene["res"]
    F = int(nbrs.shape[0])
    kk = capacity(k, F, res)
    k1 = rk.visibility_plain(bin_faces(pos, nbrs, res), res)
    for rows in (nbrs, None):
        bins = bin_faces_capped(pos, rows, res, kk)
        fn, plain = (rk.visibility_capped, rk.visibility_capped_plain) \
            if rows is not None else \
            (rk.visibility_capped_ids, rk.visibility_capped_ids_plain)
        got, want = fn(bins, res), plain(bins, res)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        assert int((got[0] > 0).sum()) > 100
        if k is None:
            assert int(bins.n_drop.sum()) == 0
            for a, b in zip(got, k1):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        else:
            assert int(bins.n_drop.sum()) > 0
    counts = rk.launch_counts()
    assert counts["visibility_capped"] > 0
    assert counts["visibility_capped_ids"] > 0


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_capped_kernels_equal_plain(bins, res):
    """K2b and K2a on ``bins`` against the walk and against the boxed
    search in its plain form: ids and z bit for bit (z to the sign of
    zero), the winner rows equal."""
    walk = rk.visibility_capped_plain(bins, res)
    boxed = rk.visibility_capped_boxed_plain(bins, res)
    got_g = rk.visibility_capped(bins, res)
    got = rk.visibility_capped_ids(bins, res)
    torch.cuda.synchronize()
    for want in (walk, boxed):
        for a, b in zip(got_g[:2] + got, want[:2] * 2):
            assert torch.equal(_bits(a), _bits(b))
        for a, b in zip(got_g[2:], want[2:]):     # background rows: +-0.0
            assert torch.equal(a, b)
    return got_g


@pytest.fixture(scope="module")
def corner_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return capped_cases(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASE_NAMES)
def test_capped_kernels_on_corner_cases(corner_cases, name):
    """K2b and K2a on the inputs that corner the search inside the box:
    drops, twin faces, signed zeros, a face that fills every tile, rows
    with NaN, infinite and huge coordinates, padding, empty tiles, thin
    faces with their vertices on pixel centres."""
    bins, res = corner_cases[name]
    ids = _assert_capped_kernels_equal_plain(bins, res)[0]
    if name == "all_tiles_empty":
        assert not bool(ids.any())
    elif name == "fullscreen":
        assert bool((ids > 0).all())
    else:
        assert int((ids > 0).sum()) > 100


@pytest.fixture(scope="module")
def multisphere():
    """The 18-sphere scene (14,796 faces, 8 views at 512x512) at its first
    step: clip positions, edge neighbours and the validated capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    geo, batch = multisphere_scene(torch.device("cuda"), 18, 8, 512)
    k = validated_tile_k(geo, batch, 512)
    with torch.no_grad():
        pos = transform_pos(batch["mvp"],
                            geo.tet_v[geo.statics.corner_vid])
    return dict(pos=pos, nbrs=geo.statics.edge_nbrs, k=k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 512], ids=["validated_k", "k512_drops"])
def test_capped_kernels_on_the_multisphere_scene(multisphere, k):
    """K2b and K2a at the main path's shape against both plain versions:
    at the validated capacity (nothing drops, so they also equal K1) and at
    k = 512, below the densest tile's count, where faces drop and K1 is no
    yardstick."""
    res = (512, 512)
    pos, nbrs = multisphere["pos"], multisphere["nbrs"]
    bins = bin_faces_capped(pos, nbrs, res, k or multisphere["k"])
    got = _assert_capped_kernels_equal_plain(bins, res)
    if k is None:
        assert int(bins.n_drop.sum()) == 0
        for a, b in zip(got, rk.visibility(bin_faces(pos, nbrs, res), res)):
            assert torch.equal(_bits(a), _bits(b))
    else:
        assert int(bins.counts.max()) == k and int(bins.n_drop.sum()) > 0


@pytest.mark.cuda
def test_capped_kernels_on_the_bench_sphere():
    """K2b and K2a on the bench scene's single sphere (2,012 faces, larger
    on screen than the multi-sphere scene's), binned by bin_faces_capped
    directly: the layout rule keeps this scene on K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = (512, 512)
    geo, batch = bench_scene(torch.device("cuda"), 8, 512)
    st = geo.statics
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[st.corner_vid])
    F = int(st.surface_fid.shape[0])
    bins = bin_faces_capped(pos, st.edge_nbrs, res, capacity(None, F, res))
    assert int(bins.n_drop.sum()) == 0
    got = _assert_capped_kernels_equal_plain(bins, res)
    for a, b in zip(got, rk.visibility(bin_faces(pos, st.edge_nbrs, res),
                                       res)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_train_on_the_card_matches_cpu(tmp_path, capsys):
    """train() with the default device (the card) on a 2-view 128² dataset
    of the ellipsoid for 3 iterations, one sphere at r 0.24: the logged
    img_loss of every iteration and the best loss within rtol 1e-5 of the
    same run with device="cpu" (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import re

    import numpy as np

    from tssplat_torch.config import ConfigDict
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.tools.synthetic import write_synthetic_dataset
    from tssplat_torch.train import train

    v, f = icosphere(subdivisions=3)
    write_synthetic_dataset(str(tmp_path / "img"),
                            v * np.asarray([0.30, 0.24, 0.18]), f, n_views=2,
                            resolution=128)
    (tmp_path / "kp.json").write_text(json.dumps({"pt": [[0, 0, 0]],
                                                  "r": [0.24]}))

    def run(out, device):
        cfg = ConfigDict({
            "geometry_type": "TetMeshMultiSphereGeometry",
            "geometry": {"key_points_file_path": str(tmp_path / "kp.json"),
                         "tetwild_cache_folder": str(tmp_path / out)},
            "dataloader_type": "MistubaImgDataLoader",
            "data": {"dataset_config": {"image_root": str(tmp_path / "img")},
                     "batch_size": 2, "total_num_iter": 3},
            "optimizer": {"lr": 0.2, "grad_limit": True,
                          "grad_limit_values": [0.01, 0.01],
                          "grad_limit_iters": [3]},
            "output_path": str(tmp_path / out), "total_num_iter": 3,
            "log_every": 1, "export_every": 100})
        state, _ = train(cfg, device=device)
        logged = [float(x) for x in re.findall(r"img_loss=([0-9.]+)",
                                               capsys.readouterr().out)]
        return state, logged

    st_gpu, log_gpu = run("gpu", None)
    st_cpu, log_cpu = run("cpu", "cpu")
    assert st_gpu.params.device.type == "cuda" and len(log_gpu) == 3
    np.testing.assert_allclose(log_gpu, log_cpu, rtol=1e-5)
    np.testing.assert_allclose(float(st_gpu.best_loss),
                               float(st_cpu.best_loss), rtol=1e-5)


@pytest.mark.cuda
def test_hash_grid_on_the_card_matches_cpu():
    """ExplicitMaterial's default encoding (16 levels x 2^19, dense and
    hashed levels) and MLP at 200k seeded points, with a seeded cotangent:
    the colours within 1e-6, the position gradient within 1e-4 of its max
    and the table's within 1e-3 (autograd's scatter-add runs on atomics on
    the card), the MLP's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tssplat_torch.materials import ExplicitMaterial
    from tssplat_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((200_000, 3), generator=gen) * 1.6 - 0.8
    ct = torch.randn((200_000, 3), generator=gen)
    out = {}
    for d in ("cuda", "cpu"):
        mat = ExplicitMaterial(None, device=d)
        p = {k: {n: x.requires_grad_(True) for n, x in g.items()}
             for k, g in mat.params.items()}
        x = pts.to(d).requires_grad_(True)
        y = mat.apply_fn(p, x)
        (y * ct.to(d)).sum().backward()
        out[d] = [y.detach().cpu(), x.grad.cpu()] + [
            q.grad.cpu() for q in tree_leaves(p)]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = float(b.abs().max())
        tol = 1e-6 if i == 0 else (1e-3 if i == 2 else 1e-4) * scale
        assert float((a - b).abs().max()) <= tol, (i, scale)


@pytest.mark.cuda
def test_exact_texture_step_on_the_card_matches_cpu(tmp_path):
    """One exact texture step (tssplat_torch/materials/exact_stage.py) of
    tet_sphere(0.12) on 2 views of 128² of the ellipsoid's colour, the
    default material: the loss within rtol 1e-5 of the CPU's, the table's
    gradient within 1e-3 of its max, the MLP's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tssplat_torch.data import MitsubaImgDataLoader
    from tssplat_torch.geometry import TetMeshGeometry
    from tssplat_torch.materials import ExplicitMaterial
    from tssplat_torch.materials.exact_stage import (
        build_texture_exact_cache, build_texture_exact_loss)
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.tools.synthetic import write_synthetic_dataset
    from tssplat_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    v, f = icosphere(subdivisions=3)
    write_synthetic_dataset(str(tmp_path / "img"),
                            v * np.asarray([0.30, 0.24, 0.18]), f, n_views=2,
                            resolution=128)
    mesh = TetMesh(*tet_sphere(0.12, radius=0.3))
    out = {}
    for d in ("cuda", "cpu"):
        geo = TetMeshGeometry(dict(use_smooth_barrier=False), tetmesh=mesh,
                              device=d)
        loader = MitsubaImgDataLoader(dict(
            dataset_config=dict(image_root=str(tmp_path / "img")),
            batch_size=2, total_num_iter=1), device=d)
        mat = ExplicitMaterial(None, device=d)
        cache = build_texture_exact_cache(geo, mat, loader.data_all, 128)
        p = {k: {n: x.requires_grad_(True) for n, x in g.items()}
             for k, g in mat.params.items()}
        loss = build_texture_exact_loss(mat, geo.statics, cache)(p, 0)[0]
        loss.backward()
        out[d] = (float(loss.detach()), [q.grad.cpu() for q in tree_leaves(p)])
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c)
    for i, (a, b) in enumerate(zip(g_g, g_c)):
        scale = float(b.abs().max())
        assert scale > 0
        tol = (1e-3 if i == 0 else 1e-4) * scale
        assert float((a - b).abs().max()) <= tol, (i, scale)


def _dumbbell_and_dent():
    import numpy as np
    from tssplat_torch.mesh.spheres import icosphere

    sv, sf = icosphere(subdivisions=3)
    v = np.concatenate([sv * 0.3 + [-0.45, 0, 0], sv * 0.3 + [0.45, 0, 0]])
    f = np.concatenate([sf, sf + sv.shape[0]])
    dent = sv * 0.4
    cap = dent[:, 2] > 0.28
    dent[cap] -= np.asarray([0, 0, 0.25]) * (dent[cap, 2:3] / 0.4)
    return (v, f), (dent, sf)


@pytest.mark.cuda
def test_queries_on_the_card_match_cpu():
    """ray_mesh_hit_full and signed_distance (tssplat_torch/ops/queries.py)
    on the card against the CPU on the dumbbell, 20,000 seeded rays and
    points: hit and miss and ids agree but on <= 0.02% of the rays, t to
    rtol 1e-5, |sd| to 1e-5, signs but on <= 0.1% of the points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tssplat_torch.ops.queries import ray_mesh_hit_full, signed_distance

    (v, f), _ = _dumbbell_and_dent()
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.8, 0.8, size=(20000, 3)).astype(np.float32)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rng.uniform(-0.9, 0.9, size=(20000, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        vt = torch.tensor(v, dtype=torch.float32, device=dev)
        ft = torch.tensor(f, device=dev)
        hits = [x.cpu().numpy() for x in ray_mesh_hit_full(
            torch.tensor(o, device=dev), torch.tensor(d, device=dev), vt, ft)]
        out[dev] = hits, signed_distance(torch.tensor(p, device=dev), vt,
                                         ft).cpu().numpy()
    (hg, sg), (hc, sc) = out["cuda"], out["cpu"]
    both = np.isfinite(hg[0]) & np.isfinite(hc[0])
    assert (np.isfinite(hg[0]) != np.isfinite(hc[0])).sum() <= 4
    assert (both & (hg[1] != hc[1])).sum() <= 4 and both.sum() > 2000
    np.testing.assert_allclose(hg[0][both], hc[0][both], rtol=1e-5)
    np.testing.assert_allclose(np.abs(sg), np.abs(sc), rtol=0, atol=1e-5)
    assert ((np.sign(sg) != np.sign(sc)) & (np.abs(sc) > 1e-4)).sum() <= 20


@pytest.mark.cuda
def test_skeleton_step_and_remesh_on_the_card_match_cpu():
    """One smoothed_sdf_grad step (tools/init_spheres.py) within 1e-4 of
    its max and tet_remesh_from_surface (mesh/remesh.py) of the dented
    sphere (edge 0.15, 20³) with counts within 2% of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tssplat_torch.mesh.remesh import tet_remesh_from_surface
    from tssplat_torch.tools.init_spheres import smoothed_sdf_grad

    (v, f), (dent, df) = _dumbbell_and_dent()
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.6, 0.6, size=(2000, 3)).astype(np.float32)
    noise = np.clip(0.003 * rng.standard_normal((2000, 20, 3)), None,
                    0.01).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        g = smoothed_sdf_grad(
            torch.tensor(x, device=dev), torch.tensor(noise, device=dev),
            torch.tensor(v, dtype=torch.float32, device=dev),
            torch.tensor(f, device=dev)).cpu().numpy()
        out[dev] = g, tet_remesh_from_surface(dent, df, 0.15, grid_dim=20,
                                              device=dev)
    (gg, (vg, tg)), (gc, (vc, tc)) = out["cuda"], out["cpu"]
    assert np.abs(gg - gc).max() <= 1e-4 * np.abs(gc).max()
    assert abs(vg.shape[0] - vc.shape[0]) <= 0.02 * vc.shape[0]
    assert abs(tg.shape[0] - tc.shape[0]) <= 0.02 * tc.shape[0]


# ---------------------------------------------------------------------------
# the slab form (row-slab spatial sharding): (row0, full_h) in every kernel
# ---------------------------------------------------------------------------

SLABS = [(-8, 56), (32, 56), (88, 56), (40, 32)]


@pytest.fixture(scope="module")
def slab_scene():
    """tet_sphere(0.06) (722 faces), 2 views at 128x128 on the card, with
    the full image's K1 and K2b outputs; slabs of 56 rows end in a partial
    16-row tile of K1. ``border``: the same sphere through a lens six times
    longer (clip x and y scaled), which crosses the image's top and bottom
    rows, so the slabs at the image's edges hold foreground on the image row
    next to the rows outside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = TetMesh(*tet_sphere(0.06, radius=0.3))
    corners = torch.tensor(mesh.vtx[mesh.surface_vid[mesh.surface_fid]
                                    .reshape(-1)], dtype=torch.float32,
                           device=dev)
    mvp, _, _ = fibonacci_views(2)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32, device=dev),
                        corners)
    nbrs = torch.tensor(mesh.surface_edge_neighbors(), device=dev)
    res = (128, 128)
    k = capacity(None, int(nbrs.shape[0]), res)

    def scene(pos):
        return dict(pos=pos, nbrs=nbrs, res=res, k=k,
                    full=rk.visibility(bin_faces(pos, nbrs, res), res),
                    full_c=rk.visibility_capped(
                        bin_faces_capped(pos, nbrs, res, k), res))

    zoomed = pos.clone()
    zoomed[..., :2] *= 6.0
    return dict(scene(pos), border=scene(zoomed))


def _rows(t, lo, hi):
    """Rows lo:hi of (B,H,W) or channel-major (B,C,H,W)."""
    return t[:, lo:hi] if t.dim() == 3 else t[:, :, lo:hi]


@pytest.mark.cuda
@pytest.mark.parametrize("row0, h", SLABS,
                         ids=[f"row0_{r}_h{h}" for r, h in SLABS])
def test_slab_visibility_kernels_match_plain_and_full_rows(slab_scene, row0,
                                                           h):
    """K1 (with and without rows), K2b and K2a on a slab: equal to their
    plain versions with the same viewport (ids and z to the bit), and its
    rows inside the image equal to the whole image's kernel output; on the
    centred sphere and on the border scene, whose silhouette crosses the
    image's top and bottom rows."""
    fg = 0
    for sc in (slab_scene, slab_scene["border"]):
        pos, nbrs, (H, W), k = (sc[n] for n in ("pos", "nbrs", "res", "k"))
        vp, res = (row0, H), (h, W)
        lo, hi = max(0, -row0), min(h, H - row0)
        bins = bin_faces(pos, nbrs, res, vp)
        cb = bin_faces_capped(pos, nbrs, res, k, vp)
        cb_ids = bin_faces_capped(pos, None, res, k, vp)
        runs = ((rk.visibility(bins, res), rk.visibility_plain(bins, res),
                 sc["full"]),
                (rk.visibility(bin_faces(pos, None, res, vp), res,
                               emit_g=False),
                 rk.visibility_plain(bin_faces(pos, None, res, vp), res,
                                     emit_g=False), sc["full"][:2]),
                (rk.visibility_capped(cb, res),
                 rk.visibility_capped_plain(cb, res), sc["full_c"]),
                (rk.visibility_capped_ids(cb_ids, res),
                 rk.visibility_capped_ids_plain(cb_ids, res),
                 sc["full_c"][:2]))
        torch.cuda.synchronize()
        assert int(cb.n_drop.sum()) == 0
        for got, plain, full in runs:
            assert torch.equal(got[0], plain[0])
            assert torch.equal(_bits(got[1]), _bits(plain[1]))
            for a, b in zip(got[2:], plain[2:]):
                assert torch.equal(a, b)
            for a, b in zip(got, full):
                assert torch.equal(_rows(a, lo, hi), _rows(b, row0 + lo,
                                                           row0 + hi))
        fg += int((runs[0][0][0][:, lo:hi] > 0).sum())
    assert fg > 1000                    # the slab's own foreground


@pytest.mark.cuda
@pytest.mark.parametrize("row0, h", SLABS,
                         ids=[f"row0_{r}_h{h}" for r, h in SLABS])
def test_slab_antialias_kernels_match_plain_and_full_rows(slab_scene, row0,
                                                          h):
    """K4 and K5 on a slab's visibility (zeroed on the rows outside the
    image, as the spatial loss does): equal to their plain versions with
    the same viewport; K4's rows whose vertical neighbours lie in the slab
    equal the whole image's coverage. On the border scene the slab's first
    or last image row (next to the zeroed rows) holds foreground and is
    held to the whole image too: a vertical pair into a row outside the
    image (JAX's ``row_valid`` cut) would change its coverage."""
    for sc in (slab_scene, slab_scene["border"]):
        pos, nbrs, (H, W) = sc["pos"], sc["nbrs"], sc["res"]
        vp, res = (row0, H), (h, W)
        lo, hi = max(0, -row0), min(h, H - row0)
        valid = torch.zeros(h, dtype=torch.bool, device=pos.device)
        valid[lo:hi] = True
        ids, z, g6, gaux = rk.visibility(bin_faces(pos, nbrs, res, vp), res)
        inp = (ids * valid[:, None], z * valid[:, None],
               g6 * valid[:, None], gaux * valid[:, None])
        ct = torch.randn(ids.shape, generator=torch.Generator(
            device=pos.device).manual_seed(1), device=pos.device)
        got_f, got_b = rk.aa_forward(*inp, viewport=vp), \
            rk.aa_backward(*inp, ct, viewport=vp)
        assert torch.equal(got_f, rk.aa_forward_plain(*inp, viewport=vp))
        assert torch.equal(got_b, rk.aa_backward_plain(*inp, ct,
                                                       viewport=vp))
        full = rk.aa_forward(*sc["full"])
        i0, i1 = max(lo, 1), min(hi, h - 1)
        assert torch.equal(got_f[:, i0:i1], full[:, row0 + i0:row0 + i1])
        assert float(got_f[:, :lo].abs().sum()
                     + got_f[:, hi:].abs().sum()) == 0
        if sc is slab_scene["border"]:       # foreground next to the cut
            assert int((inp[0][:, lo:hi] > 0).sum()) > 1000
            for r in {0, H - 1} & set(range(row0, row0 + h)):
                assert bool(((inp[0][:, r - row0] > 0).sum(-1) >= 20).all())


@pytest.mark.cuda
def test_whole_image_viewport_is_the_default(slab_scene):
    """Each kernel with the viewport (0, H) gives the bits of the call
    without one."""
    pos, nbrs, res, k = (slab_scene[n] for n in ("pos", "nbrs", "res", "k"))
    vp = (0, res[0])
    for a, b in zip(rk.visibility(bin_faces(pos, nbrs, res, vp), res),
                    slab_scene["full"]):
        assert torch.equal(a, b)
    for a, b in zip(rk.visibility_capped(
            bin_faces_capped(pos, nbrs, res, k, vp), res),
            slab_scene["full_c"]):
        assert torch.equal(a, b)
    a, b = rk.visibility_capped_ids(bin_faces_capped(pos, None, res, k, vp),
                                    res), \
        rk.visibility_capped_ids(bin_faces_capped(pos, None, res, k), res)
    assert torch.equal(a[0], b[0]) and torch.equal(_bits(a[1]), _bits(b[1]))
    inp = slab_scene["full"]
    ct = torch.ones_like(inp[1])
    assert torch.equal(rk.aa_forward(*inp, viewport=vp), rk.aa_forward(*inp))
    assert torch.equal(rk.aa_backward(*inp, ct, viewport=vp),
                       rk.aa_backward(*inp, ct))


@pytest.mark.cuda
def test_sds_iteration_on_the_card_matches_cpu():
    """One train_sds iteration (``sds_step``: render, the host SDS
    gradient, backward, Adam) on the card and on the CPU from the same
    sphere, cameras and seeded generator: the same camera ids, the image
    gradient within 1e-4 of its max, tet_v after the step within 1e-4 of
    the step's largest motion wherever the gradient is above 1e-5 of its
    max (below it Adam moves rounding noise by ~lr either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tssplat_torch.geometry import TetMeshGeometry
    from tssplat_torch.guidance.sds import SDSConfig, TargetImageGuidance
    from tssplat_torch.optim import adam
    from tssplat_torch.tools.synthetic import render_alpha_of_mesh
    from tssplat_torch.mesh.spheres import icosphere
    from tssplat_torch.train_sds import SDSState, sds_step

    res, n_cam = 128, 8
    mvp, _, _ = fibonacci_views(n_cam)
    sv, sf = icosphere(3)
    bank = render_alpha_of_mesh(sv * np.asarray([0.34, 0.22, 0.22]), sf,
                                mvp, res).cpu().numpy() * 2.0 - 1.0
    cfg = SDSConfig(seed=11)
    guide = TargetImageGuidance(bank, cfg)
    v, t = tet_sphere(0.05, radius=0.26)
    out = {}
    for dev in ("cuda", "cpu"):
        geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                              tetmesh=TetMesh(v, t), device=dev)
        init_fn, update_fn = adam(4e-3)
        state = SDSState(geo.tet_v.clone(), init_fn(geo.tet_v))
        rng = np.random.default_rng(cfg.seed)
        state, g, n_drop = sds_step(
            state, geo.statics, update_fn, guide, cfg, rng,
            torch.tensor(mvp, dtype=torch.float32, device=dev), n_cam, 4, 0,
            res, "alpha")
        # Adam's first moment after one step is 0.1 x the gradient
        out[dev] = (g, state.params.cpu().numpy() - v,
                    state.opt_state.mu.cpu().numpy() / 0.1,
                    int(n_drop.sum()), rng.bit_generator.state)
    (g_c, d_c, _, nd_c, s_c), (g_p, d_p, gr_p, nd_p, s_p) = \
        out["cuda"], out["cpu"]
    assert nd_c == nd_p == 0 and s_c == s_p
    np.testing.assert_allclose(g_c, g_p, atol=1e-4 * np.abs(g_p).max())
    assert np.abs(d_p).max() > 1e-3
    real = np.abs(gr_p) > 1e-5 * np.abs(gr_p).max()
    assert real.sum() > 100
    np.testing.assert_allclose(d_c[real], d_p[real],
                               atol=1e-4 * np.abs(d_p).max())


@pytest.mark.cuda
def test_nan_trap_fires_on_a_kernel_output():
    """Under the NaN trap a CUDA kernel (launched through ctypes, which the
    trap cannot see) checks its own outputs: a NaN cotangent at a
    foreground pixel reaches K3's table row and raises, naming the
    kernel; clean input runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tssplat_torch.utils import debug

    geo, batch = bench_scene(torch.device("cuda"), 2, 128)
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[geo.statics.corner_vid])
    bins = bin_faces(pos, geo.statics.edge_nbrs, (128, 128))
    ids = rk.visibility(bins, (128, 128))[0]
    F = int(geo.statics.edge_nbrs.shape[0])
    fg = torch.nonzero(ids[0] > 0)[0]
    ct = torch.zeros((2, 6, 128, 128), device="cuda")
    ct[0, :, fg[0], fg[1]] = 1.0
    bad = ct.clone()
    bad[0, 0, fg[0], fg[1]] = float("nan")
    debug.enable_debug_nans(True)
    try:
        before = rk.wsr_table_grad.launches
        rk.wsr_table_grad(ids, ct, F)
        with pytest.raises(FloatingPointError,
                           match="encountered in kernel wsr_table_grad"):
            rk.wsr_table_grad(ids, bad, F)
        assert rk.wsr_table_grad.launches == before + 2
    finally:
        debug.enable_debug_nans(False)


@pytest.mark.cuda
def test_native_topology_matches_numpy_on_the_card_machine():
    """The host topology library, built on the card's machine, agrees with
    the numpy paths on tet_sphere(0.02): the same boundary surface, tet
    neighbour sets and degrees, and (a manifold surface) edge table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tssplat_torch.mesh import surface

    _, t = tet_sphere(0.02, radius=0.3)
    for a, b in zip(surface.get_surface_vf(t),
                    surface.get_surface_vf(t, use_native=False)):
        np.testing.assert_array_equal(a, b)
    n, d = surface.tet_face_neighbors(t)
    n_np, d_np = surface.tet_face_neighbors(t, use_native=False)
    np.testing.assert_array_equal(d, d_np)
    np.testing.assert_array_equal(np.sort(n, axis=1), np.sort(n_np, axis=1))
    _, faces = surface.get_surface_vf(t)
    np.testing.assert_array_equal(
        surface.triangle_edge_neighbors(faces),
        surface.triangle_edge_neighbors(faces, use_native=False))


@pytest.fixture(scope="module")
def shaded_corner_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return shade_cases(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHADE_CASE_NAMES)
def test_shaded_path_kernels_match_plain(shaded_corner_cases, name):
    """K6, K7 and K8 against their plain versions on the inputs that corner
    their runs and viewports (tools/shade_cases.py): the sphere with
    16-byte and with scalar runs, every pixel background, one face over
    whole tiles, slabs with rows above and below the image, per-view
    attributes of 5 channels. The forwards and K7's d rast equal their
    plain versions to the bit (the same operations in the same order,
    built without FMA contraction); the table gradients each within 1e-5
    of the sum of |values| its row adds (float32 atomics in any order)."""
    before = rk.launch_counts()
    errs = check_shaded(shaded_corner_cases[name],
                        torch.Generator(device="cuda").manual_seed(4))
    after = rk.launch_counts()
    assert set(errs) == {"shade", "shade_backward", "interp",
                         "interp_backward", "winner_rows"}
    assert all(after[k] > before[k] for k in errs)
