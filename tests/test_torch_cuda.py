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
