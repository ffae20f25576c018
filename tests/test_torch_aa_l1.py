"""The exact texture loss's image-space tail on the exact cache's tables
(tssplat_torch/ops/aa_l1.py, K10's plain versions) against the chain it
replaces: the colours put on the image, composited, ``antialias_color``
on the frozen raster and the L1 with autograd's gradient. The shaded image
and the sum to the bit, d colours within 1e-6 of their largest |value|,
and K10's backward as the plain version takes it (the blend's transpose
per point) against autograd; on views whose pairs touch the image border,
a view with no foreground, and over two view shards. The card runs the
kernels against these plain versions (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import tssplat_torch.materials.exact_stage as exact_stage
from tssplat_torch.geometry import TetMeshGeometry
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.mesh.spheres import tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops import aa_l1 as al
from tssplat_torch.ops.rasterize import antialias_color, rasterize
from tssplat_torch.ops.transform import fibonacci_views, transform_pos
from tssplat_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

RES = 48
ENC = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
       "log2_hashmap_size": 10, "base_resolution": 4,
       "per_level_scale": 1.6}
ZOOM = np.diag([5.0, 5.0, 1.0, 1.0]).astype(np.float32)
AWAY = np.eye(4, dtype=np.float32)
AWAY[0, 3] = 6.0                   # x_clip += 6 w: off the image


def _views(case):
    """The views (B,4,4) of a case: two fibonacci views; the same zoomed
    so the silhouette crosses the image border; and four views, the
    second off the image (no foreground), the fourth zoomed."""
    mvp, _, _ = fibonacci_views(4)
    mvp = mvp.astype(np.float32)
    if case == "two_views":
        return mvp[:2]
    if case == "border":
        return ZOOM @ mvp[:2]
    return np.stack([mvp[0], AWAY @ mvp[1], mvp[2], ZOOM @ mvp[3]])


@pytest.fixture(scope="module")
def sphere():
    v, t = tet_sphere(0.12, radius=0.3)
    geo = TetMeshGeometry(dict(use_smooth_barrier=False),
                          tetmesh=TetMesh(v, t), device="cpu")
    mat = ExplicitMaterial({"pos_encoding_config": dict(ENC)}, device="cpu")
    return geo, mat


def _data(mvp, seed):
    """A batch over ``mvp``: a seeded target and background per pixel."""
    g = torch.Generator().manual_seed(seed)
    B = mvp.shape[0]
    img = torch.rand((B, RES, RES, 4), generator=g)
    bg = torch.rand((B, RES, RES, 3), generator=g)
    return {"mvp": torch.from_numpy(mvp), "img": img, "background": bg}


def _old_chain(geo, data, cache, colors):
    """The L1 sum and the shaded image as the exact loss took them before
    the cache held the weights: the colours put on the image, composited
    by the raster's mask and ``antialias_color`` on the frozen raster."""
    v_corner = geo.tet_v[geo.statics.corner_vid]
    with torch.no_grad():
        pc = transform_pos(data["mvp"], v_corner)
        rast, _ = rasterize(pc, (RES, RES))
    n = pc.shape[0]
    full = colors.new_zeros((n * RES * RES, 3))
    full = full.index_put((cache["pix"],), colors).view(n, RES, RES, 3)
    mask = (rast[..., 3:4] > 0).to(torch.float32)
    bg = data["background"]
    gb = bg + (full - bg) * mask
    shaded = antialias_color(gb, rast, pc, geo.statics.edge_nbrs)
    return torch.sum(torch.abs(shaded - data["img"][..., :3])), shaded


def _colors(cache, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((cache["pix"].shape[0], 3), generator=g)


def _pair_pixels(cache):
    """Per pixel (n,H,W): whether it is in a horizontal pair that blends,
    and whether in a vertical one (its own weights or its neighbour's
    toward it)."""
    w = al._dense_weights(cache)
    h = (w[..., 0] != 0) | (w[..., 1] != 0)
    h[:, :, 1:] |= w[:, :, :-1, 0] != 0
    h[:, :, :-1] |= w[:, :, 1:, 1] != 0
    v = (w[..., 2] != 0) | (w[..., 3] != 0)
    v[:, 1:] |= w[:, :-1, :, 2] != 0
    v[:, :-1] |= w[:, 1:, :, 3] != 0
    return h, v


@pytest.mark.parametrize("case", ["two_views", "border", "empty_view"])
def test_tail_matches_the_antialias_color_chain(sphere, case, monkeypatch):
    """The tail on a case's views (the empty-view case's weights made in
    groups of 3 views, so its rows are numbered across two groups)."""
    if case == "empty_view":
        monkeypatch.setattr(exact_stage, "AA_VIEWS", 3)
    geo, mat = sphere
    data = _data(_views(case), 7)
    cache = build_texture_exact_cache(geo, mat, data, RES)
    n_fg = int(cache["pix"].shape[0])
    fg = cache["fg"].reshape(-1)
    assert torch.equal(fg[cache["pix"]], torch.arange(n_fg,
                                                      dtype=torch.int32))
    assert int((fg >= 0).sum()) == n_fg
    h, v = _pair_pixels(cache)
    assert bool((h & v).any())           # a pixel in both kinds of pair
    counts = (cache["fg"] >= 0).sum((1, 2))
    if case == "border":
        edge = h | v
        assert bool(edge[:, :, [0, -1]].any() and edge[:, [0, -1]].any())
    if case == "empty_view":
        assert int(counts[1]) == 0 and bool((counts[[0, 2, 3]] > 0).all())
        assert not bool((h | v)[1].any())
    colors = _colors(cache, 11).requires_grad_(True)
    s_old, shaded_old = _old_chain(geo, data, cache, colors)
    s_new, shaded_new = al.aa_l1_plain(colors, cache)
    assert torch.equal(shaded_new, shaded_old)
    assert torch.equal(s_new, s_old)
    want, = torch.autograd.grad(s_old * 0.37, [colors])
    scale = float(want.abs().max())
    assert scale > 0
    got, = torch.autograd.grad(s_new * 0.37, [colors])
    assert torch.equal(got, want)
    # K10's backward as its plain version takes it: the transpose per point
    codes = al.sign_codes(shaded_new, cache["gt"])
    g = torch.tensor(0.37)
    d = al.aa_l1_backward_plain(g, codes, cache)
    assert float((d - want).abs().max()) <= 1e-6 * scale
    # the Function on CPU tensors: the plain forward and backward
    c2 = colors.detach().clone().requires_grad_(True)
    s_fn = al._AaL1.apply(c2, cache)
    assert torch.equal(s_fn, s_new.detach())
    got_fn, = torch.autograd.grad(s_fn * 0.37, [c2])
    assert torch.equal(got_fn, d)


def test_sign_codes_round_trip():
    """The sign byte of a pixel: 2 bits a channel, torch.sgn's values back
    (NaN and both zeros give 0, as abs's gradient takes them)."""
    shaded = torch.tensor([[0.5, -0.0, 2.0], [float("nan"), 1.0, -3.0],
                           [0.0, 0.25, 0.75]])
    gt = torch.tensor([[0.25, 0.0, 2.5], [0.0, 1.0, 1.0],
                       [0.0, 0.5, 0.5]])
    codes = al.sign_codes(shaded, gt)
    assert codes.dtype == torch.uint8
    assert codes.tolist() == [1 + 0 + 32, 0 + 0 + 32, 0 + 8 + 16]
    assert torch.equal(al._signs(codes), torch.sgn(
        torch.nan_to_num(shaded - gt, nan=0.0)))


def test_view_sharded_tails_sum_to_one_process(sphere, monkeypatch):
    """shard=(r, 2) over the four views of the empty-view case, the
    foreground count summed without a process group: each rank's tail on
    its own two views; their losses sum to the one process's (rtol 1e-6),
    their colour gradients are the one process's rows to the bit, and the
    material's gradients summed over the ranks within 1e-5 of their
    largest |value| (each rank adds its points' table rows in its own
    float32 order)."""
    monkeypatch.setattr(exact_stage.dist, "all_reduce", lambda t: None)
    geo, mat = sphere
    data = _data(_views("empty_view"), 3)
    one = build_texture_exact_cache(geo, mat, data, RES)
    monkeypatch.setattr(exact_stage, "AA_VIEWS", 1)
    ranks = [build_texture_exact_cache(geo, mat, data, RES, shard=(r, 2))
             for r in range(2)]
    assert [c["n"] for c in ranks] == [2, 2]
    assert all(c["n_total"] == 4 for c in ranks)
    colors = _colors(one, 5).requires_grad_(True)
    loss = al.image_l1_loss(colors, one)
    want, = torch.autograd.grad(loss, [colors])
    parts, got = [], []
    start = 0
    for c in ranks:
        n_fg = int(c["pix"].shape[0])
        x = colors.detach()[start:start + n_fg].clone().requires_grad_(True)
        start += n_fg
        lr = al.image_l1_loss(x, c)
        parts.append(float(lr.detach()))
        got.append(torch.autograd.grad(lr, [x])[0])
    assert start == colors.shape[0]
    np.testing.assert_allclose(sum(parts), float(loss.detach()), rtol=1e-6)
    assert torch.equal(torch.cat(got), want)

    def grads(cache):
        p = {k: {n: t.detach().clone().requires_grad_(True)
                 for n, t in d.items()} for k, d in mat.params.items()}
        il = build_texture_exact_loss(mat, geo.statics, cache)(p, 0)[0]
        return float(il.detach()), torch.autograd.grad(il, tree_leaves(p))

    l1, g1 = grads(one)
    lr = [grads(c) for c in ranks]
    np.testing.assert_allclose(lr[0][0] + lr[1][0], l1, rtol=1e-6)
    for a, b, w in zip(lr[0][1], lr[1][1], g1):
        assert float((a + b - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_tail_check_of_the_card_runs_on_the_cpu(sphere):
    """tools/tail_cases.py, which the card runs at the texture cell's
    shape, on the CPU (where K10's wrappers take their plain versions):
    every comparison equal, the sum's error 0 against the float32 chain."""
    from tssplat_torch.tools.tail_cases import check_tail, tail_inputs

    geo, _ = sphere
    cache, colors = tail_inputs(
        geo, {"mvp": torch.from_numpy(_views("empty_view"))}, RES, 9)
    got = check_tail(cache, colors)
    assert got["shaded_equal"] and got["codes_equal"] and got["grad_equal"]
    assert got["loss_rel"] == 0.0 and got["loss_rel64"] <= 1e-6
    assert got["grad_rel"] <= 1e-6 and got["scale"] > 0
