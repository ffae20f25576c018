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
from tssplat_torch.ops.binning import bin_faces
from tssplat_torch.ops.transform import fibonacci_views, transform_pos

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


@pytest.mark.cuda
def test_antialias_kernels_match_plain(scene):
    """K4 and K5 against their plain versions: same arithmetic, atol 1e-5."""
    ids, z, g6, gaux = scene["vis"]
    ct = torch.randn((2,) + scene["res"], generator=scene["gen"],
                     device=ids.device)
    torch.testing.assert_close(rk.aa_forward(ids, z, g6, gaux),
                               rk.aa_forward_plain(ids, z, g6, gaux),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(rk.aa_backward(ids, z, g6, gaux, ct),
                               rk.aa_backward_plain(ids, z, g6, gaux, ct),
                               atol=1e-5, rtol=0)
    assert rk.launch_counts()["aa_backward"] > 0
