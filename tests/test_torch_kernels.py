"""The port's rasterizer kernels (tssplat_torch/ops/raster_kernels.py)
against the JAX package: K1 visibility, K3 table gradient, K4/K5
antialias forward/backward. On the CPU the wrappers run their plain
PyTorch versions; the JAX side runs its Pallas kernels in interpret mode
and its plain oracles. Same numpy inputs on both sides. The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.mesh.surface import triangle_edge_neighbors
from tssplat_tpu.ops.transform import fibonacci_views, transform_pos
from tssplat_tpu.ops.pallas_raster import (rasterize_ids_pallas,
                                           wsr_table_grad_pallas)
from tssplat_tpu.ops.rasterize import (rasterize_ids, antialias,
                                       antialias_silhouette_halo)
from tssplat_tpu.ops.rasterize import interpolate as jax_interpolate
from tssplat_tpu.ops.rasterize import rasterize as jax_rasterize

from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import bin_faces
from tssplat_torch.ops.rasterize import interpolate as torch_interpolate
from tssplat_torch.ops.rasterize import rasterize_ids as torch_rasterize_ids

torch.set_num_threads(1)

RES = (128, 128)


@pytest.fixture(scope="module")
def scene():
    """1 sphere (178 faces), 2 views at 128^2, corner layout; the port's
    visibility outputs feed the AA and table-gradient comparisons."""
    v, t = tet_sphere(0.12, radius=0.3)
    mesh = TetMesh(v, t)
    corner_vid = mesh.surface_vid[mesh.surface_fid].reshape(-1)
    F = mesh.surface_fid.shape[0]
    nbrs = triangle_edge_neighbors(mesh.surface_fid)
    mvp, _, _ = fibonacci_views(2)
    pos = np.array(transform_pos(jnp.asarray(mvp, jnp.float32),
                                   jnp.asarray(mesh.vtx[corner_vid],
                                               jnp.float32)))
    bins = bin_faces(torch.from_numpy(pos.copy()), torch.from_numpy(nbrs),
                     RES)
    ids, z, g6, gaux = rk.visibility(bins, RES)
    rng = np.random.default_rng(0)
    return dict(pos=pos, F=F, nbrs=nbrs, bins=bins,
                tri_c=np.arange(3 * F, dtype=np.int32).reshape(F, 3),
                ids=ids.numpy(), z=z.numpy(), g6=g6.numpy(),
                gaux=gaux.numpy(), rng=rng)


def test_visibility_matches_brute_force(scene):
    """K1's plain version + binning equals the JAX brute-force oracle
    rasterize_ids pixel for pixel (both evaluate the edge functions with
    separately rounded float32 multiplies and adds)."""
    brute = np.asarray(rasterize_ids(jnp.asarray(scene["pos"]),
                                     jnp.asarray(scene["tri_c"]), RES))
    assert (brute > 0).sum() > 1000
    np.testing.assert_array_equal(scene["ids"], brute)
    # the port's own brute-force oracle agrees too
    ours = torch_rasterize_ids(torch.from_numpy(scene["pos"]),
                               torch.from_numpy(scene["tri_c"]), RES)
    np.testing.assert_array_equal(ours.numpy(), brute)


@pytest.mark.parametrize("row0", [40, -8, 100])
def test_rasterize_ids_slab_matches_jax(scene, row0):
    """The port's brute-force oracle on a 48-row slab,
    viewport=(row0, 128): inside the image, with a halo above it (row0
    -8) and past its bottom (row0 100), on the scene seen through a 3x
    lens so that its silhouette crosses the image's first and last rows.
    In each package the slab's rows inside the image equal the whole
    image's winners to the bit, and the rows outside it are empty. The
    port's slab equals JAX's but at the pixels where the two packages'
    whole images already differ: z near-ties between neighbouring faces
    on this zoomed scene (ROADMAP, pinned disagreements), <= 0.5% of the
    foreground."""
    h, vp = 48, (row0, RES[0])
    pos = scene["pos"] * np.asarray([3.0, 3.0, 1.0, 1.0], np.float32)
    tri_j = jnp.asarray(scene["tri_c"])
    tri_t = torch.from_numpy(scene["tri_c"])
    got = torch_rasterize_ids(torch.from_numpy(pos), tri_t, (h, RES[1]),
                              viewport=vp).numpy()
    want = np.asarray(rasterize_ids(jnp.asarray(pos), tri_j, (h, RES[1]),
                                    viewport=vp))
    whole_t = torch_rasterize_ids(torch.from_numpy(pos), tri_t, RES).numpy()
    whole_j = np.asarray(rasterize_ids(jnp.asarray(pos), tri_j, RES))
    lo, hi = max(row0, 0), min(row0 + h, RES[0])
    rows = slice(lo - row0, hi - row0)
    np.testing.assert_array_equal(got[:, rows], whole_t[:, lo:hi])
    np.testing.assert_array_equal(want[:, rows], whole_j[:, lo:hi])
    for ids in (got, want):
        assert (ids[:, :lo - row0] == 0).all()
        assert (ids[:, hi - row0:] == 0).all()
    fg = got[:, rows] > 0
    assert fg.sum() > 100
    off = got[:, rows] != want[:, rows]
    np.testing.assert_array_equal(off, (whole_t != whole_j)[:, lo:hi])
    assert off.sum() <= 0.005 * fg.sum()


def test_interpolate_per_view_matches_jax(scene):
    """interpolate with per-view attributes (B,3F,C) in the corner layout
    against JAX's (B,V,C) branch (corner=True) on JAX's rast, to 1e-6;
    one view's attributes shared by both views give what that table
    repeated per view gives, to the bit."""
    F = scene["F"]
    attr = scene["rng"].normal(size=(2, 3 * F, 5)).astype(np.float32)
    rast = np.array(jax_rasterize(jnp.asarray(scene["pos"]),
                                    jnp.asarray(scene["tri_c"]), RES,
                                    corner=True))
    want = np.asarray(jax_interpolate(jnp.asarray(attr), jnp.asarray(rast),
                                      jnp.asarray(scene["tri_c"]),
                                      corner=True))
    rast_t = torch.from_numpy(rast)
    got = torch_interpolate(torch.from_numpy(attr), rast_t).numpy()
    assert got.shape == want.shape == (2,) + RES + (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[0] - got[1]).max() > 0.1        # the views differ
    shared = torch_interpolate(torch.from_numpy(attr[0]), rast_t)
    stacked = torch_interpolate(torch.from_numpy(np.stack([attr[0]] * 2)),
                                rast_t)
    assert torch.equal(shared, stacked)


@pytest.mark.parametrize("case", ["ragged", "behind_camera"])
def test_visibility_edge_cases_match_brute_force(case):
    """K1's plain version + binning equals JAX's rasterize_ids on a
    resolution that is no multiple of the 16x16 tile (partial tiles), and
    on a scene pushed through the camera plane (faces with a vertex at
    w <= 1e-9 are discarded, and huge screen coordinates must not break
    the binning)."""
    v, t = tet_sphere(0.12, radius=0.3)
    mesh = TetMesh(v, t)
    corners = mesh.vtx[mesh.surface_vid[mesh.surface_fid].reshape(-1)]
    F = mesh.surface_fid.shape[0]
    res = (72, 100) if case == "ragged" else (64, 64)
    mvp, _, _ = fibonacci_views(2)
    if case == "behind_camera":
        # move the sphere onto the first camera: part of it lies behind
        eye = np.linalg.inv(mvp[0])[:3, 3] / np.linalg.inv(mvp[0])[3, 3]
        corners = corners * 4.0 + eye * 0.999
    pos = np.array(transform_pos(jnp.asarray(mvp, jnp.float32),
                                 jnp.asarray(corners, jnp.float32)))
    if case == "behind_camera":
        assert (pos[0, :, 3] <= 0).any() and (pos[0, :, 3] > 0).any()
    nbrs = triangle_edge_neighbors(mesh.surface_fid)
    bins = bin_faces(torch.from_numpy(pos), torch.from_numpy(nbrs), res)
    ids = rk.visibility(bins, res)[0].numpy()
    brute = np.asarray(rasterize_ids(
        jnp.asarray(pos), jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3),
        res))
    np.testing.assert_array_equal(ids, brute)
    assert (brute > 0).sum() > 100


def test_visibility_matches_pallas_interpret(scene):
    """K1's plain version against _vis_kernel_flat (interpret mode) with
    winner rows. Coverage must be identical. The interpreted kernel's z
    differs from plain float32 arithmetic by a few ulps, which flips the
    winner at a handful of pixels where two faces meet at depths within
    1e-6 (3 of ~2.2k foreground pixels here; the port agrees with the
    brute-force oracle there). Everywhere else ids and gaux match exactly,
    z and g6 within 1e-6."""
    F = scene["F"]
    ids, z, g6, gaux = (np.asarray(a) for a in rasterize_ids_pallas(
        jnp.asarray(scene["pos"]), jnp.asarray(scene["tri_c"]), RES,
        corner=True, with_g=jnp.asarray(scene["nbrs"], jnp.int32),
        interpret=True))
    mine = scene["ids"]
    np.testing.assert_array_equal(mine > 0, ids > 0)
    same = mine == ids
    assert (~same).sum() <= 0.005 * (ids > 0).sum()
    # a flip is a depth near-tie between the two winners
    np.testing.assert_allclose(scene["z"][~same], z[~same], atol=1e-6)
    assert (mine[~same] <= F).all() and (ids[~same] <= F).all()
    s4 = np.broadcast_to(same[:, None], gaux.shape)
    np.testing.assert_array_equal(scene["gaux"][s4], gaux[s4])
    np.testing.assert_allclose(scene["z"][same], z[same], atol=1e-6)
    s6 = np.broadcast_to(same[:, None], g6.shape)
    np.testing.assert_allclose(scene["g6"][s6], g6[s6], atol=1e-6)


def test_binning_has_no_drops_and_lists_every_covering_face(scene):
    """Every (pixel, winner) pair is in the pixel's tile list, and n_drop
    is 0 (the binning has no capacity caps)."""
    bins = scene["bins"]
    assert int(bins.n_drop.sum()) == 0
    ids = scene["ids"]
    B, H, W = ids.shape
    nt = bins.nty * bins.ntx
    faces = bins.faces.numpy()
    start = bins.tile_start.numpy().reshape(B, nt)
    count = bins.tile_count.numpy().reshape(B, nt)
    for b, r, c in np.argwhere(ids > 0):
        t = (r // 16) * bins.ntx + c // 16
        lst = faces[start[b, t]:start[b, t] + count[b, t]]
        assert ids[b, r, c] - 1 in lst


def test_table_grad_matches_pallas_interpret(scene):
    """K3's plain version against wsr_table_grad_pallas (interpret mode):
    seeded cotangents on every foreground pixel plus zeros elsewhere.
    rtol 1e-5: the two sum each face's pixels in different orders."""
    ids = scene["ids"]
    ct = scene["rng"].normal(size=(2, 6) + RES).astype(np.float32)
    ct *= (ids > 0)[:, None]
    ct[:, :, ::3] = 0.0                    # some all-zero foreground pixels
    want = np.asarray(wsr_table_grad_pallas(jnp.asarray(ids),
                                            jnp.asarray(ct), scene["F"],
                                            interpret=True))
    got = rk.wsr_table_grad(torch.from_numpy(ids), torch.from_numpy(ct),
                            scene["F"]).numpy()
    assert got.shape == want.shape == (2, scene["F"] + 1, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, -1].any()            # row F is never written


@pytest.fixture(scope="module", params=["halo", "dense"])
def jax_aa(scene, request):
    """The JAX silhouette antialias on the port's visibility outputs — the
    halo kernels (interpret mode) or the dense chain — as (mode, ct,
    forward value, jax.vjp w.r.t. g6 under the seeded cotangent ct)."""
    mode = request.param
    ids = jnp.asarray(scene["ids"])
    z = jnp.asarray(scene["z"])
    gaux = jnp.asarray(scene["gaux"])
    alpha = jnp.clip(ids.astype(jnp.float32), 0.0, 1.0)[..., None]
    rast = jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z,
                      ids.astype(jnp.float32)], axis=-1)

    def f(g6):
        if mode == "halo":
            out = antialias_silhouette_halo(alpha, rast, (g6, gaux),
                                            interpret=True)
        else:
            out = antialias(alpha, rast, jnp.asarray(scene["pos"]),
                            jnp.asarray(scene["tri_c"]),
                            jnp.asarray(scene["nbrs"], jnp.int32),
                            corner=True, g_precomputed=(g6, gaux))
        return out[..., 0]

    @jax.jit
    def value_and_vjp(g6, ct):
        y, vjp = jax.vjp(f, g6)
        return y, vjp(ct)[0]

    ct = np.random.default_rng(1).normal(size=(2,) + RES).astype(np.float32)
    y, dg = value_and_vjp(jnp.asarray(scene["g6"]), jnp.asarray(ct))
    return mode, ct, np.asarray(y), np.asarray(dg)


def _torch_inputs(scene):
    return (torch.from_numpy(scene["ids"]), torch.from_numpy(scene["z"]),
            torch.from_numpy(scene["g6"]), torch.from_numpy(scene["gaux"]))


def test_aa_forward_matches_jax(scene, jax_aa):
    """K4's plain version against antialias_silhouette_halo (Pallas
    interior kernel in interpret mode + the XLA border pass) and against
    the dense antialias chain. atol 1e-6: the halo kernel places pixel b at
    a + 2/W instead of b's own centre (a last-bit difference in t)."""
    _, _, want, _ = jax_aa
    got = rk.aa_forward(*_torch_inputs(scene)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the scene antialiases something
    assert np.abs(got - (scene["ids"] > 0)).sum() > 1


def test_aa_backward_matches_jax_vjp(scene, jax_aa):
    """K5's plain version (hand-derived backward) against jax.vjp of the
    same JAX function under a seeded cotangent. The two chain rules round
    differently: atol 1e-5 of the largest gradient entry."""
    _, ct, _, want = jax_aa
    got = rk.aa_backward(*_torch_inputs(scene), torch.from_numpy(ct)).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)


def test_aa_backward_is_gradient_of_forward(scene):
    """The hand-derived K5 equals torch autograd of the plain K4 (the
    pixels where a tie makes the two conventions differ are not in this
    scene)."""
    ids, z, g6, gaux = _torch_inputs(scene)
    ct = torch.from_numpy(scene["rng"].normal(size=(2,) + RES)
                          .astype(np.float32))
    g = g6.clone().requires_grad_(True)
    (rk.aa_forward_plain(ids, z, g, gaux) * ct).sum().backward()
    got = rk.aa_backward(ids, z, g6, gaux, ct)
    scale = g.grad.abs().max()
    torch.testing.assert_close(got, g.grad, atol=1e-5 * scale, rtol=0)
