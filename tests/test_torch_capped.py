"""The capped visibility layout of the port (ops/binning.py
bin_faces_capped, uses_capped_layout, the capacity helpers; the plain
versions of K2a/K2b in ops/raster_kernels.py) against the JAX package's
_vis_kernel / _vis_kernel_g (Pallas, interpret mode) in both of JAX's
candidate layouts, shared table and per-tile pre-gather, from the same
numpy inputs. The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tssplat_tpu.mesh.spheres import tet_sphere
from tssplat_tpu.mesh.tetmesh import TetMesh
from tssplat_tpu.ops import pallas_raster as PR
from tssplat_tpu.ops.rasterize import (rasterize_ids,
                                       tile_overlap_counts as
                                       jax_overlap_counts,
                                       validate_tile_capacity as
                                       jax_validate)
from tssplat_tpu.ops.transform import fibonacci_views, transform_pos

from tssplat_torch.ops import binning
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.binning import (bin_faces, bin_faces_capped, capacity,
                                       tile_overlap_counts,
                                       uses_capped_layout,
                                       validate_tile_capacity)

torch.set_num_threads(1)

RES = (64, 128)


def _three_spheres():
    """Three overlapping tet_sphere(0.12, radius=0.3) balls (534 faces) as
    one disjoint mesh: (TetMesh, corner-layout positions of 2 views)."""
    parts = [tet_sphere(0.12, radius=0.3, center=c)
             for c in ((0.0, 0.0, 0.0), (0.2, 0.05, 0.0), (-0.1, 0.2, 0.1))]
    v = np.concatenate([p[0] for p in parts])
    offs = np.cumsum([0] + [p[0].shape[0] for p in parts])[:-1]
    t = np.concatenate([p[1] + o for p, o in zip(parts, offs)])
    mesh = TetMesh(v, t)
    corner_vid = mesh.surface_vid[mesh.surface_fid].reshape(-1)
    mvp, _, _ = fibonacci_views(2)
    pos = np.array(transform_pos(jnp.asarray(mvp, jnp.float32),
                                 jnp.asarray(mesh.vtx[corner_vid],
                                             jnp.float32)))
    return mesh, pos


@pytest.fixture(scope="module")
def scene():
    mesh, pos = _three_spheres()
    F = mesh.surface_fid.shape[0]
    tri_c = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    brute = np.asarray(rasterize_ids(jnp.asarray(pos), jnp.asarray(tri_c),
                                     RES))
    return dict(pos=pos, F=F, nbrs=mesh.surface_edge_neighbors(),
                tri_c=tri_c, brute=brute)


def _jax_choice_is_capped(F, B, rows, res=(512, 512)):
    """JAX's layout choice, read from its trace-time warning while
    jax.eval_shape traces rasterize_ids_pallas (nothing runs)."""
    PR._rasterize_ids_pallas_jit.clear_cache()
    tri = jnp.arange(3 * F, dtype=jnp.int32).reshape(F, 3)
    nbrs = jnp.zeros((F, 3), jnp.int32) if rows else None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.eval_shape(lambda p: PR.rasterize_ids_pallas(
            p, tri, res, corner=True, with_g=nbrs, with_z=True),
            jax.ShapeDtypeStruct((B, 3 * F, 4), jnp.float32))
    return "exceeds the flat-binning SMEM budget" in buf.getvalue()


@pytest.mark.parametrize("rows", [True, False], ids=["R14", "R11"])
@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("F", [9864, 13152, 14796, 16440])
def test_layout_rule_matches_jax(F, B, rows):
    """(a) The port caps its candidates in exactly the scenes where JAX
    leaves its flat layout: 12, 16, 18 and 20 spheres of the multi-sphere
    scene at 512², with winner rows (R = 14) and without (R = 11)."""
    want = _jax_choice_is_capped(F, B, rows)
    assert uses_capped_layout(F, 14 if rows else 11, B, 512, 512) == want
    # the 18-sphere scene is the smallest that caps both kernels
    if F == 14796:
        assert want


@pytest.mark.parametrize("F, R, B", [
    (14796, 14, 120), (14796, 11, 120), (14796, 11, 6), (2012, 14, 8),
], ids=["sil_120v", "dn_120v", "w3d_6v", "bench_scene"])
def test_layout_rule_at_the_cells_shapes(F, R, B):
    """The port's layout rule against JAX's choice at the benchmark's
    shapes at 512² (PERF.md §4): the 18 spheres' 14,796 faces at 120 views
    with winner rows (silhouette) and without (depth + normal), at the
    Wonder3D cell's 6 views without, all capped; and the bench scene's
    single sphere (2,012 faces) at 8 views, left to the flat layout."""
    want = _jax_choice_is_capped(F, B, R == 14)
    assert uses_capped_layout(F, R, B, 512, 512) == want
    assert want == (F == 14796)


def test_layout_rule_budget_patch_matches_jax(monkeypatch):
    """A patched budget moves the port's rule as JAX's, and unaligned
    resolutions never cap."""
    monkeypatch.setattr(PR, "_SMEM_TBL_BUDGET", 0)
    monkeypatch.setattr(binning, "FLAT_BUDGET_BYTES", 0)
    assert _jax_choice_is_capped(534, 2, True, RES)
    assert uses_capped_layout(534, 14, 2, *RES)
    assert not uses_capped_layout(534, 14, 2, 72, 100)
    PR._rasterize_ids_pallas_jit.clear_cache()


def _winner_z64(table, ids, res):
    """z of each pixel's winner evaluated in float64 from the float32 face
    table (B,F,16), in the kernels' formula; 0 on background."""
    H, W = res
    B = ids.shape[0]
    rows = table[np.arange(B)[:, None, None], np.maximum(ids - 1, 0)] \
        .astype(np.float64)
    px = (np.arange(W) + 0.5) / W * 2 - 1
    py = ((np.arange(H) + 0.5) / H * 2 - 1)[:, None]
    ax, ay, bx, by, cx, cy, z0, z1, z2, ia = np.moveaxis(rows[..., :10], -1,
                                                         0)
    e0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * ia
    e1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * ia
    e2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * ia
    return (e0 * z0 + e1 * z1 + e2 * z2) * (ids > 0)


_PLAIN = {}


def _port_capped(scene, rows, k, boxed=False):
    """The port's capped bins and plain K2b (rows) / K2a outputs, numpy:
    the walk, or with ``boxed`` the search inside each face's pixel box."""
    key = (rows, k, boxed)
    if key not in _PLAIN:
        pos = torch.from_numpy(scene["pos"])
        nbrs = torch.from_numpy(scene["nbrs"]) if rows else None
        bins = bin_faces_capped(pos, nbrs, RES,
                                capacity(k, scene["F"], RES))
        if boxed:
            out = rk.visibility_capped_boxed_plain(bins, RES, emit_g=rows)
        else:
            out = rk.visibility_capped(bins, RES) if rows \
                else rk.visibility_capped_ids(bins, RES)
        _PLAIN[key] = (bins, [o.numpy() for o in out])
    return _PLAIN[key]


_JAX = {}


def _jax_capped(scene, monkeypatch, variant, rows, k):
    """JAX's _vis_kernel_g (rows) / _vis_kernel outputs (interpret mode) in
    the given layout variant, and its per-view drops, numpy."""
    F = scene["F"]
    R = 14 if rows else 11
    # JAX's shared table fits a budget between its table and its flat size
    budget = {"shared": (F + 1) * R * 4 + 1024, "pregather": 0}[variant]
    monkeypatch.setattr(PR, "_SMEM_TBL_BUDGET", budget)
    monkeypatch.setattr(binning, "FLAT_BUDGET_BYTES", budget)
    assert uses_capped_layout(F, R, 2, *RES)
    key = (variant, rows, k)
    if key not in _JAX:
        PR._rasterize_ids_pallas_jit.clear_cache()
        kk = capacity(k, F, RES)
        pos = jnp.asarray(scene["pos"])
        tri = jnp.asarray(scene["tri_c"])
        for b in range(2):                       # JAX's tier-2 pool is empty
            n_pool = PR.bin_triangles(pos[b], tri, RES, 8, 128, kk,
                                      corner=True, flat=True)[4]
            assert int(n_pool) == 0
        drops = []
        out = PR.rasterize_ids_pallas(
            pos, tri, RES, k=k, interpret=True, corner=True, with_z=True,
            with_g=jnp.asarray(scene["nbrs"], jnp.int32) if rows else None,
            drops_out=drops)
        PR._rasterize_ids_pallas_jit.clear_cache()
        _JAX[key] = ([np.asarray(a) for a in out], np.asarray(drops[0]))
    return _JAX[key]


def _assert_matches_jax(scene, bins, got, want, drops, rows, k):
    """The allowances of test_capped_visibility_matches_jax (see there)."""
    np.testing.assert_array_equal(bins.n_drop.numpy(), drops)
    assert (int(bins.n_drop.sum()) > 0) == (k == 8)
    ids, jids = got[0], want[0]
    np.testing.assert_array_equal(ids > 0, jids > 0)
    assert (jids > 0).sum() > (500 if k is None else 50)
    same = ids == jids
    assert (~same).sum() <= 0.005 * (jids > 0).sum()
    explained = np.abs(got[1] - want[1]) <= 1e-6
    if k is None:
        explained |= ids == scene["brute"]
    assert explained[~same].all()
    # z where the winners agree: to 1e-6, except where the face's screen
    # area is tiny (|inv_area| in the thousands) and XLA's rounding is
    # amplified; there the port's z lies within 1e-6 of the float64 value
    # and JAX's within 1e-5
    z64 = _winner_z64(bins.table.numpy(), ids, RES)
    off = same & (np.abs(got[1] - want[1]) > 1e-6)
    assert off.sum() <= 0.01 * (jids > 0).sum()
    np.testing.assert_allclose(got[1][off], z64[off], atol=1e-6)
    np.testing.assert_allclose(want[1][off], z64[off], atol=1e-5)
    if rows:
        s6 = np.broadcast_to(same[:, None], want[2].shape)
        np.testing.assert_allclose(got[2][s6], want[2][s6], atol=1e-6)
        s4 = np.broadcast_to(same[:, None], want[3].shape)
        np.testing.assert_array_equal(got[3][s4], want[3][s4])


@pytest.mark.parametrize("k", [None, 8], ids=["default_k", "k8"])
@pytest.mark.parametrize("rows", [True, False], ids=["K2b", "K2a"])
@pytest.mark.parametrize("variant", ["shared", "pregather"])
def test_capped_visibility_matches_jax(scene, monkeypatch, variant, rows, k):
    """(b) Plain K2b / K2a against JAX's _vis_kernel_g / _vis_kernel
    (interpret mode) in the shared-table and the pre-gather variant, with
    the default capacity and with k = 8, where tiles overflow. The scene's
    JAX tier-2 pool is empty, so both keep each tile's k smallest ids:
    n_drop per view is equal, coverage is equal, and the winners are equal
    except at <= 0.5% of foreground pixels, each of which is a depth
    near-tie (XLA's z is a few ulps off plain float32: z within 1e-6) or,
    without drops, a pixel where the port agrees with JAX's own
    brute-force rasterize_ids and the interpreted kernel does not (an edge
    function a few ulps off zero where one sphere's face edge crosses
    another's). z to 1e-6 and the rows equal where the winners agree."""
    want, drops = _jax_capped(scene, monkeypatch, variant, rows, k)
    bins, got = _port_capped(scene, rows, k)
    _assert_matches_jax(scene, bins, got, want, drops, rows, k)


@pytest.mark.parametrize("k", [None, 8], ids=["default_k", "k8"])
@pytest.mark.parametrize("rows", [True, False], ids=["K2b", "K2a"])
@pytest.mark.parametrize("variant", ["shared", "pregather"])
def test_boxed_visibility_matches_jax(scene, monkeypatch, variant, rows, k):
    """The search the CUDA kernels run (each candidate tested inside its
    pixel box, winners by the minimum of a packed (z, id) key), in its
    plain form, against the same JAX kernels under the same allowances as
    test_capped_visibility_matches_jax."""
    want, drops = _jax_capped(scene, monkeypatch, variant, rows, k)
    bins, got = _port_capped(scene, rows, k, boxed=True)
    _assert_matches_jax(scene, bins, got, want, drops, rows, k)


@pytest.mark.parametrize("res", [RES, (128, 128)], ids=["64x128", "128x128"])
def test_capped_equals_uncapped_without_drops(scene, res):
    """(c) With no drops, plain K2b equals plain K1 and plain K2a equals
    plain K1's ids and z, bit for bit (the same test over another tiling
    of the same faces)."""
    pos = torch.from_numpy(scene["pos"])
    nbrs = torch.from_numpy(scene["nbrs"])
    k = capacity(None, scene["F"], res)
    k1 = rk.visibility(bin_faces(pos, nbrs, res), res)
    k1_ids = rk.visibility(bin_faces(pos, None, res), res, emit_g=False)
    cb = bin_faces_capped(pos, nbrs, res, k)
    ca = bin_faces_capped(pos, None, res, k)
    assert int(cb.n_drop.sum()) == int(ca.n_drop.sum()) == 0
    for a, b in zip(rk.visibility_capped(cb, res), k1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(rk.visibility_capped_ids(ca, res), k1_ids):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert int((k1[0] > 0).sum()) > 500


def test_capped_bins_keep_the_smallest_ids(scene):
    """Each tile keeps the k smallest ids of its faces, ascending, with
    counts = min(count, k) and n_drop = the sum of count - k."""
    pos = torch.from_numpy(scene["pos"])
    full = bin_faces_capped(pos, None, RES, capacity(None, scene["F"], RES))
    cut = bin_faces_capped(pos, None, RES, 8)
    assert int(full.n_drop.sum()) == 0
    cnt = full.counts.long()
    np.testing.assert_array_equal(cut.counts.numpy(),
                                  torch.clamp(cnt, max=8).numpy())
    np.testing.assert_array_equal(
        cut.n_drop.numpy(),
        torch.clamp(cnt - 8, min=0).view(2, -1).sum(1).numpy())
    for t in range(cnt.numel()):
        n = int(cut.counts[t])
        np.testing.assert_array_equal(cut.cand[t, :n], full.cand[t, :n])
        assert (cut.cand[t, n:] == scene["F"]).all()
        assert (np.diff(full.cand[t, :int(cnt[t])].numpy()) > 0).all()


@pytest.mark.parametrize("res", [RES, (128, 128)], ids=["64x128", "128x128"])
def test_tile_capacity_matches_jax(scene, res):
    """(g) tile_overlap_counts and validate_tile_capacity equal JAX's on
    the test scene."""
    pos_j = jnp.asarray(scene["pos"])
    tri = jnp.asarray(scene["tri_c"])
    pos = torch.from_numpy(scene["pos"])
    need = jax_overlap_counts(pos_j, tri, res)
    assert tile_overlap_counts(pos, res) == need > 100
    assert validate_tile_capacity(pos, res) == jax_validate(pos_j, tri, res)
