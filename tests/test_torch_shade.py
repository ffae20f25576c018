"""The shaded path's per-pixel work (K6 shading, K7 interpolation, K8 the
antialias rows) in its plain versions (tssplat_torch/ops/raster_kernels.py)
against the JAX package and against the autograd of the chains they
replace, on the CPU. Each backward's per-face fold (float64) is held
against autograd's, the autograd.Functions that carry the kernels on the
card (``rasterize._Shade``, ``rasterize._Interp``, run here on the plain
versions) against the CPU path, and every value against JAX's rasterize,
interpolate and antialias row gather. The kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.

Scene: one tet_sphere(0.12) (178 faces), 2 views of 64x128; cases:
perspective, orthographic (z/6), a 48-row slab at row0 -8 of the 64-row
image, and corner cases (a face of zero screen area and one whose 1/w sum
is below W_EPS, both given pixels by hand, one of them on a row above the
image)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.surface import triangle_edge_neighbors
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.ops.rasterize import _gather_tri_screen
from tssplat_tpu.ops.rasterize import interpolate as jax_interpolate
from tssplat_tpu.ops.rasterize import rasterize as jax_rasterize
from tssplat_tpu.ops.rasterize import rasterize_ids as jax_rasterize_ids
from tssplat_tpu.ops.transform import fibonacci_views, transform_pos

from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.rasterize import (_Interp, _Shade, _shade_rast,
                                         _shade_table, antialias_rows,
                                         interpolate, screen_xy_table)

torch.set_num_threads(1)

H, W = 64, 128
SLAB = (48, (-8, H))                # 48 rows from absolute row -8
CASES = ["perspective", "orthographic", "slab", "corner"]


def _ortho_mvp():
    """Two orthographic views: a y-flip scale and z squash after a turn
    about y (tests/test_wonder3d.py's camera form)."""
    out = []
    for a in (0.3, 2.0):
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                        [0, 0, 0, 1]])
        out.append(np.diag([2.2, -2.2, -0.3, 1.0]) @ rot)
    return np.asarray(out, np.float32)


@pytest.fixture(scope="module")
def scene():
    v, t = tet_sphere(0.12, radius=0.3)
    mesh = TetMesh(v, t)
    corner_vid = mesh.surface_vid[mesh.surface_fid].reshape(-1)
    F = mesh.surface_fid.shape[0]
    mvp, _, _ = fibonacci_views(2)
    return dict(corners=jnp.asarray(mesh.vtx[corner_vid], jnp.float32),
                mvp=jnp.asarray(mvp, jnp.float32), F=F,
                nbrs=triangle_edge_neighbors(mesh.surface_fid),
                tri_c=jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3))


@pytest.fixture(scope="module", params=CASES)
def case(request, scene):
    """(name, pos (B,3F,4) float32, ids (B,h,W) int32, viewport) as numpy;
    ids from JAX's brute-force rasterizer, and in the corner case face 0
    made degenerate (two of its corners one) and face 1 given a 1/w sum
    below W_EPS (its clip rows scaled by 1e10), each winning pixels set by
    hand, among them pixels of slab row 0, absolute row -8."""
    name = request.param
    if name == "orthographic":
        pos = transform_pos(jnp.asarray(_ortho_mvp()), scene["corners"],
                            is_ortho=True)
    else:
        pos = transform_pos(scene["mvp"], scene["corners"])
    pos = np.array(pos)
    h, vp = SLAB if name in ("slab", "corner") else (H, None)
    if name == "corner":
        pos[:, 2] = pos[:, 0]                           # face 0: area 0
        pos[:, 3:6] *= 1e10                             # face 1: 1/w ~ 1e-10
    ids = np.array(jax_rasterize_ids(jnp.asarray(pos), scene["tri_c"],
                                     (h, W), viewport=vp))
    if name == "corner":
        ids[:, 0, 10:20] = 1
        ids[:, 12, 40:44] = 1
        ids[:, 0, 60:70] = 2
        ids[:, 14, 50:53] = 2
    assert (ids > 0).sum() > 200
    return name, pos, ids.astype(np.int32), vp


def _cotangent(shape, seed):
    """A seeded cotangent, non-zero on the background too."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _shade_cpu_path(pos, ids, vp):
    """The CPU path's rast and, under a seeded cotangent, d pos_clip."""
    p = torch.from_numpy(pos).requires_grad_(True)
    rast = _shade_rast(p, torch.from_numpy(ids), vp)
    ct = torch.from_numpy(_cotangent(rast.shape, 1))
    (g,) = torch.autograd.grad(rast, p, ct)
    return rast.detach(), ct, g


def test_shade_matches_jax(scene, case):
    """rast of the plain version (the CPU path) equals JAX's rasterize on
    the same winners (ids=, corner layout, viewport) to 1e-6 of its
    largest value, and d pos_clip JAX's VJP under the same cotangent to
    1e-4 of its largest (XLA contracts multiply-adds, PyTorch does not)."""
    _, pos, ids, vp = case
    rast, ct, g = _shade_cpu_path(pos, ids, vp)

    def f(p):
        return jax_rasterize(p, scene["tri_c"], ids.shape[1:],
                             ids=jnp.asarray(ids), corner=True, viewport=vp)

    want, vjp = jax.vjp(f, jnp.asarray(pos))
    (want_g,) = vjp(jnp.asarray(ct.numpy()))
    want, want_g = np.asarray(want), np.asarray(want_g)
    np.testing.assert_array_equal(rast[..., 3].numpy(), want[..., 3])
    np.testing.assert_allclose(rast.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4,
                               atol=1e-4 * np.abs(want_g).max())
    assert np.abs(want_g).max() > 0


def test_shade_backward_fold_matches_autograd(case):
    """K6's plain backward (the per-pixel gradient in the kernel's order,
    folded per face in float64) equals autograd through the plain forward,
    whose row gather folds in float32, to 1e-5 of the largest entry; the
    background's cotangent reaches no row."""
    _, pos, ids, vp = case
    tbl = _shade_table(torch.from_numpy(pos)).requires_grad_(True)
    ids_t = torch.from_numpy(ids)
    rast = rk.shade_plain(ids_t, tbl, vp)
    ct = torch.from_numpy(_cotangent(rast.shape, 2))
    (want,) = torch.autograd.grad(rast, tbl, ct)
    got = rk.shade_backward_plain(ids_t, tbl.detach(), ct, vp)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    # the wrapper is its plain version on the CPU
    torch.testing.assert_close(rk.shade_backward(ids_t, tbl.detach(), ct, vp),
                               got, rtol=0, atol=0)
    seen = torch.zeros(tbl.shape[:2], dtype=torch.bool)
    seen[torch.arange(2)[:, None, None].expand_as(ids_t)[ids_t > 0],
         ids_t[ids_t > 0].long() - 1] = True
    assert bool((got[~seen] == 0).all()) and bool((got[seen] != 0).any())


def test_shade_function_matches_cpu_path(case):
    """rasterize._Shade, the Function that carries K6 on the card, run on
    the plain wrappers: the same rast, and d pos_clip within 1e-5 of the
    largest of the CPU path's."""
    _, pos, ids, vp = case
    rast, ct, want = _shade_cpu_path(pos, ids, vp)
    p = torch.from_numpy(pos).requires_grad_(True)
    got_rast = _Shade.apply(_shade_table(p), torch.from_numpy(ids), vp)
    (got,) = torch.autograd.grad(got_rast, p, ct)
    assert torch.equal(got_rast.detach(), rast)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("per_view", [False, True], ids=["shared", "per_view"])
def test_interp_matches_jax(scene, case, per_view):
    """interpolate (the CPU path: K7's plain version) on JAX's rast, with
    attributes (3F,C) shared by the views or (B,3F,C) one per view, equals
    JAX's interpolate to 1e-6, and its VJP w.r.t. attr and rast to 1e-5
    (of the largest entry)."""
    name, pos, ids, vp = case
    rast = np.array(jax_rasterize(jnp.asarray(pos), scene["tri_c"],
                                  ids.shape[1:], ids=jnp.asarray(ids),
                                  corner=True, viewport=vp))
    rng = np.random.default_rng(3)
    F = scene["F"]
    attr = rng.normal(size=((2,) if per_view else ()) + (3 * F, 3)) \
        .astype(np.float32)
    ct = _cotangent(ids.shape + (3,), 4)
    want, vjp = jax.vjp(lambda a, r: jax_interpolate(a, r, scene["tri_c"],
                                                     corner=True),
                        jnp.asarray(attr), jnp.asarray(rast))
    want_a, want_r = (np.asarray(x) for x in vjp(jnp.asarray(ct)))
    a_t = torch.from_numpy(attr).requires_grad_(True)
    r_t = torch.from_numpy(rast).requires_grad_(True)
    got = interpolate(a_t, r_t)
    got_a, got_r = torch.autograd.grad(got, (a_t, r_t), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=1e-5,
                               atol=1e-5 * np.abs(want_a).max())
    # JAX's rast cotangent has the id channel's too; the port's is zero
    np.testing.assert_allclose(got_r[..., :3].numpy(), want_r[..., :3],
                               rtol=1e-5, atol=1e-5 * np.abs(want_r).max())
    assert not got_r[..., 2:].any()


@pytest.mark.parametrize("per_view", [False, True], ids=["shared", "per_view"])
def test_interp_backward_fold_matches_autograd(case, per_view):
    """K7's plain backward: d tbl (one row per view, folded in float64;
    summed over the views where the table is shared) and d rast (d u, d v;
    0 in z and the id) equal autograd through the plain forward to 1e-5
    of the largest entry; the Function rasterize._Interp on the plain
    wrappers gives the same values and gradients."""
    name, pos, ids, vp = case
    rast = _shade_rast(torch.from_numpy(pos), torch.from_numpy(ids), vp)
    F = pos.shape[1] // 3
    rng = np.random.default_rng(5)
    tbl = torch.from_numpy(rng.normal(size=(2 if per_view else 1, F, 6))
                           .astype(np.float32)).requires_grad_(True)
    r_t = rast.detach().requires_grad_(True)
    out = rk.interp_plain(r_t, tbl)
    ct = torch.from_numpy(_cotangent(out.shape, 6))
    want_t, want_r = torch.autograd.grad(out, (tbl, r_t), ct)
    got_t, got_r = rk.interp_backward_plain(r_t.detach(), tbl.detach(), ct)
    if not per_view:
        got_t = got_t.sum(0, keepdim=True)
    for got, want in ((got_t, want_t), (got_r, want_r)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    assert not got_r[..., 2:].any()
    f_out = _Interp.apply(tbl, r_t)
    f_t, f_r = torch.autograd.grad(f_out, (tbl, r_t), ct)
    assert torch.equal(f_out, out.detach())
    assert torch.equal(f_t, got_t) and torch.equal(f_r, got_r)


def test_kernel_functions_carry_the_chain(scene, case):
    """The card's composition on the plain wrappers, _Shade then _Interp
    twice (normals shared by the views, positions per view) under one
    loss, gives d pos_clip and d attr within 1e-5 of the largest entry of
    the CPU path's: K7's d rast reaches K6's backward."""
    _, pos, ids, vp = case
    rng = np.random.default_rng(7)
    F = pos.shape[1] // 3
    nrm = rng.normal(size=(3 * F, 3)).astype(np.float32)
    wp = rng.normal(size=(2, 3 * F, 3)).astype(np.float32)
    ct = [torch.from_numpy(_cotangent(ids.shape + (3,), s)) for s in (8, 9)]

    def grads(kernel_path):
        p = torch.from_numpy(pos).requires_grad_(True)
        a = torch.from_numpy(nrm).requires_grad_(True)
        b = torch.from_numpy(wp).requires_grad_(True)
        ids_t = torch.from_numpy(ids)
        if kernel_path:
            rast = _Shade.apply(_shade_table(p), ids_t, vp)
            outs = [_Interp.apply(x.reshape(-1, F, 9), rast) for x in (a, b)]
        else:
            rast = _shade_rast(p, ids_t, vp)
            outs = [interpolate(x, rast) for x in (a, b)]
        loss = sum((o * c).sum() for o, c in zip(outs, ct))
        return torch.autograd.grad(loss, (p, a, b))

    for got, want in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_winner_rows_match_jax(scene, case):
    """The antialias rows (the CPU path: K8's plain version, through the
    wrapper) on the shaded rast: ids and z of rast, and g6 / gaux equal to
    JAX's 16-channel row gather of its screen table (xy rows, edge
    neighbours, the area's sign) at the winners, channel-major, to 1e-6;
    zero on background."""
    name, pos, ids, vp = case
    F = scene["F"]
    rast = _shade_rast(torch.from_numpy(pos), torch.from_numpy(ids), vp)
    nbrs = torch.from_numpy(scene["nbrs"])
    got = antialias_rows(rast, screen_xy_table(torch.from_numpy(pos), F),
                         nbrs)
    g16 = np.moveaxis(np.asarray(_gather_tri_screen(
        jnp.asarray(pos), scene["tri_c"], jnp.asarray(ids),
        edge_nbrs=jnp.asarray(scene["nbrs"]), corner=True)), -1, 1)
    assert torch.equal(got[0], torch.from_numpy(ids))
    assert torch.equal(got[1], rast[..., 2])
    np.testing.assert_allclose(got[2].numpy(), g16[:, :6], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), g16[:, 12:16])
    bg = torch.from_numpy(ids == 0)[:, None]
    assert not got[2].masked_select(bg).any()
    assert not got[3].masked_select(bg).any()
    for a, b in zip(got, rk.winner_rows_plain(rast, screen_xy_table(
            torch.from_numpy(pos), F), nbrs)):
        assert torch.equal(a, b)
