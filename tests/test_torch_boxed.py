"""The search K2a/K2b run on the card — each candidate tested only inside
its pixel box, winners taken as the minimum of a packed (z, id) key — in
its plain PyTorch form (ops/raster_kernels.py visibility_capped_boxed_plain)
against the walk that defines the result (visibility_capped_plain), bit for
bit, on the inputs where the two could part (tools/vis_cases.py). The
kernels are held against both on the card by tests/test_torch_cuda.py.
"""

import pytest
import torch

from tssplat_torch.ops import binning
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.tools.vis_cases import (CASE_NAMES, capped_cases,
                                           three_spheres)

torch.set_num_threads(1)

NEG_ZERO = -2 ** 31                      # the int32 bits of -0.0


@pytest.fixture(scope="module")
def cases():
    return capped_cases("cpu")


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("rows", [True, False], ids=["K2b", "K2a"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_boxed_search_equals_walk(cases, name, rows):
    """ids, z (to the sign of zero) and, for K2b, g6 and gaux of the boxed
    search equal the walk's bit for bit, and each case shows what it is
    there to show."""
    bins, res = cases[name]
    if rows:
        want = rk.visibility_capped_plain(bins, res)
    else:
        want = rk.visibility_capped_ids_plain(bins, res)
    got = rk.visibility_capped_boxed_plain(bins, res, emit_g=rows)
    tests = int(rk.boxed_pairs(bins, res)[6].sum())
    assert len(got) == len(want) == (4 if rows else 2)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))
    ids, z = got[:2]
    F = bins.table.shape[1]
    walked = int(bins.counts.sum()) * 1024
    assert tests <= walked                # never more tests than the walk
    n_fg = int((ids > 0).sum())
    if name.startswith("spheres"):
        assert n_fg > 100 and tests < walked // 8
        assert (int(bins.n_drop.sum()) > 0) == ("drops" in name)
        assert bool((bins.counts == 0).any())     # and tiles with no face
    elif name == "twin_faces":
        assert n_fg > 500 and int(ids.max()) <= F // 2
    elif name == "signed_zero":
        zb = _bits(z)
        for b in range(2):                # both zeros are written, and the
            both = (zb[b] == NEG_ZERO) | ((zb[b] == 0) & (ids[b] > 0))
            assert set(ids[b][both].tolist()) == {1, 2}
            assert bool((zb[b] == NEG_ZERO).any())
        # ... overlap goes to face 0: +0.0 in view 0, -0.0 in view 1
        overlap = (ids[0] == 1) & (ids[1] == 1)
        assert overlap.sum() > 200
        assert bool((zb[0][ids[0] == 1] == 0).all())
        assert bool((zb[1][ids[1] == 1] == NEG_ZERO).all())
    elif name == "fullscreen":
        assert n_fg == ids.numel()        # the large face covers every pixel
        assert int((ids == 1).sum()) > ids.numel() // 2
        assert int((ids > 1).sum()) > 50  # the near small faces show
    elif name == "nan_and_behind_eye":
        assert n_fg > 100
        assert not bool((ids[0] == 6).any())      # the NaN face (view 0)
        assert not bool((ids == 10).any())        # the face behind the eye
    elif name in ("listed_everywhere", "more_than_a_pass"):
        assert (F > 4096) == (name == "more_than_a_pass")
        assert n_fg > 100 and int(bins.counts.min()) == F
        assert int(bins.cand.max()) == F          # padded past the count
        for f in (7, 11, 12, 13, 14, 15):
            assert not bool((ids == f + 1).any())
    elif name == "vertices_on_pixel_centres":
        assert n_fg > 1000 and len(torch.unique(ids)) > 100
        assert int(bins.n_drop.sum()) == 0
    elif name == "all_tiles_empty":
        assert tests == 0 and n_fg == 0 and int(bins.counts.max()) == 0
        assert all(not bool(o.any()) for o in got)


def test_key_order_is_the_winner_order():
    """The packed key orders by z, folds -0.0 onto +0.0, breaks ties by id,
    and unpacks to the bits it was given."""
    z = torch.tensor([-1.0, -1e-30, -0.0, 0.0, 0.0, 1e-38, 0.5, 1.0])
    id1 = torch.tensor([9, 8, 7, 6, 5, 4, 3, 2])
    key = rk._pack_key(z, id1)
    order = torch.argsort(key).tolist()
    assert order == [0, 1, 4, 3, 2, 5, 6, 7]      # the zeros tie: ids 5, 6, 7
    back_id, back_z = rk._unpack_key(key)
    assert torch.equal(back_id, id1.to(torch.int32))
    assert torch.equal(_bits(back_z), _bits(z))
    assert bool((key < rk._KEY_BACKGROUND).all())
    bg_id, bg_z = rk._unpack_key(torch.tensor([rk._KEY_BACKGROUND]))
    assert int(bg_id) == 0 and _bits(bg_z).item() == 0


def test_box_is_conservative_on_the_sphere_scene(cases):
    """Every pixel the walk gives to a face lies inside that face's clipped
    box (so no winner is lost to the box rule), and a face whose box misses
    the tile or whose coordinates are not finite has an empty one."""
    bins, res = cases["spheres_128x128"]
    H, W = res
    ids, _ = rk.visibility_capped_ids_plain(bins, res)
    b, r, c = (ids > 0).nonzero(as_tuple=True)
    rows = bins.table[b, ids[b, r, c].long() - 1]
    origin_x = (c // 128) * 128
    origin_y = (r // 8) * 8
    x0, x1, ex = rk._clip_axis(rows[:, 0:5:2], W, origin_x, 128)
    y0, y1, ey = rk._clip_axis(rows[:, 1:6:2], H, origin_y, 8)
    assert not bool(ex.any() or ey.any())
    assert bool(((x0 <= c) & (c <= x1) & (y0 <= r) & (r <= y1)).all())
    v = torch.tensor([[0.1, 0.2, 0.3], [float("nan"), 0.0, 0.1],
                      [0.0, float("inf"), 0.1], [1e30, 0.0, 0.1],
                      [-5.0, -4.0, -3.0], [-3e38, 0.0, 0.5]])
    p0, p1, empty = rk._clip_axis(v, 128, torch.zeros(6, dtype=torch.int64),
                                  128)
    # (-3e38 overflows the pixel coordinate: not finite, so empty)
    assert empty.tolist() == [False, True, True, False, True, True]
    assert (p0[0], p1[0]) == (69, 84)     # 69.9..82.7, slack and a pixel
    assert (p0[3], p1[3]) == (62, 127)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_tile_counts_equal_bincount(cases, name):
    """The binning's fixed-length count of each tile's pairs
    (``binning.tile_counts``) equals ``torch.bincount``'s, and the pair
    total of the front is the expansion's length, on every case's face
    table on the capped layout's 8x128 tiles and on K1's 16x16; every face
    live, and only the finite ones."""
    bins, res = cases[name]
    B, F = bins.table.shape[:2]
    for live in (torch.ones((B, F), dtype=torch.bool),
                 torch.isfinite(bins.table).all(-1)):
        for th, tw in ((binning.CAP_TILE_H, binning.CAP_TILE_W),
                       (binning.TILE_H, binning.TILE_W)):
            front = binning._pair_front(bins.table, live, res, th, tw)
            code = binning._pair_codes(front)
            n = B * front.nty * front.ntx
            assert int(front.total) == code.numel()
            assert torch.equal(binning.tile_counts(code, F, n),
                               torch.bincount(code // F, minlength=n))


@pytest.mark.parametrize("k", [None, 8], ids=["default_k", "k8_drops"])
@pytest.mark.parametrize("rows", [True, False], ids=["K2b", "K2a"])
def test_capped_bins_into_out_buffers(k, rows):
    """``bin_faces_capped`` is ``capped_front`` then ``capped_back``; the
    back with ``out`` (bins made for other positions) writes the same bits
    as a fresh binning into out's tensors, with the front's table."""
    pos, nbrs = three_spheres("cpu")
    nb = nbrs if rows else None
    res = (64, 128)
    k = binning.capacity(k, nbrs.shape[0], res)
    want = binning.bin_faces_capped(pos, nb, res, k)
    out = binning.bin_faces_capped(pos * 0.9, nb, res, k)
    front = binning.capped_front(pos, nb, res, k)
    got = binning.capped_back(front, out=out)
    assert got.table is front.table
    for name in ("counts", "cand", "n_drop"):
        assert getattr(got, name) is getattr(out, name)
    for name in ("table", "counts", "cand", "n_drop"):
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name))), name
    assert (got.nty, got.ntx) == (want.nty, want.ntx)
