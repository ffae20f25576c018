"""The hash-grid encoding's kernel pair K9 (tssplat_torch/ops/hash_grid.py)
on the CPU: its plain versions against the plain chain ``grid_exact`` and
autograd, its autograd.Function on the plain versions, and the dispatch
and checks of its wrappers, on the inputs of tools/grid_cases.py (dense
and hashed levels, F in 1, 2, 4, points on cell faces and on the bounds,
coordinates whose hash products wrap 32 bits). Imports no JAX."""

import pytest
import torch

from tssplat_torch.ops import hash_grid as hg
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.tools.grid_cases import (CASE_NAMES, grid_cases,
                                            table_rows_err)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases():
    return grid_cases("cpu", n=1024)


def _autograd(table, x, ct, grid):
    t = table.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    y = hg.grid_exact(t, xx, *grid)
    y.backward(ct)
    return y.detach(), t.grad, xx.grad


@pytest.mark.parametrize("name", CASE_NAMES)
def test_forward_plain_is_the_chain(cases, name):
    """A CPU tensor takes the plain version, which is grid_exact to the
    bit, and launches nothing."""
    table, x, ct, grid = cases[name]
    before = rk.launch_counts()
    got = hg.hash_grid(table, x, grid)
    assert rk.launch_counts() == before
    assert torch.equal(got, hg.grid_exact(table, x, *grid))
    assert got.shape == (x.shape[0], len(grid[0]) * table.shape[1])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_backward_plain_matches_autograd(cases, name):
    """The plain backward's table gradient (an index_add_ of w·ct) within
    1e-5 of each row's sum of |terms| of autograd's scatter-add, and its
    d x (the weights' derivatives, levels summed pairwise) within 1e-5 of
    autograd's largest |d x|; rows no point touches stay 0."""
    table, x, ct, grid = cases[name]
    _, g_table, g_x = _autograd(table, x, ct, grid)
    d_table, d_x = hg.hash_grid_backward(table, x, ct, grid, need_table=True,
                                         need_x=True)
    assert table_rows_err(g_table, table, x, ct, grid) <= 1e-5
    assert table_rows_err(d_table, table, x, ct, grid) == 0.0
    scale = float(g_x.abs().max())
    assert scale > 0
    assert float((d_x - g_x).abs().max()) <= 1e-5 * scale
    idx, _ = hg.grid_corners(x, *grid)
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[idx.reshape(-1)] = False
    assert not d_table[untouched].any()


@pytest.mark.parametrize("name", CASE_NAMES)
def test_function_on_the_plain_versions(cases, name):
    """_HashGrid (the card's autograd.Function) on CPU tensors: its
    forward is grid_exact's, its gradients the plain backward's, both to
    the bit; with x frozen it asks for the table's gradient only."""
    table, x, ct, grid = cases[name]
    t = table.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    y = hg._HashGrid.apply(t, xx, grid)
    y.backward(ct)
    d_table, d_x = hg.hash_grid_backward_plain(table, x, ct, grid, True,
                                               True)
    assert torch.equal(y, hg.grid_exact(table, x, *grid))
    assert torch.equal(t.grad, d_table)
    assert torch.equal(xx.grad, d_x)
    t2 = table.clone().requires_grad_(True)
    hg._HashGrid.apply(t2, x, grid).backward(ct)
    assert torch.equal(t2.grad, d_table)


def test_grid_lookup_on_the_cpu_is_the_chain(cases):
    """grid_lookup on CPU tensors (…,3) is grid_exact with autograd's
    gradients, to the bit, and launches nothing; a device that is neither
    the CPU nor CUDA raises."""
    table, x, ct, grid = cases["mixed_f2"]
    xs = x[:1000].reshape(10, 100, 3)
    cts = ct[:1000].reshape(10, 100, -1)
    t1 = table.clone().requires_grad_(True)
    x1 = xs.clone().requires_grad_(True)
    before = rk.launch_counts()
    y1 = hg.grid_lookup(t1, x1, grid)
    (y1 * cts).sum().backward()
    assert rk.launch_counts() == before
    t2 = table.clone().requires_grad_(True)
    x2 = xs.clone().requires_grad_(True)
    y2 = hg.grid_exact(t2, x2, *grid)
    (y2 * cts).sum().backward()
    assert y1.shape == (10, 100, ct.shape[1])
    assert torch.equal(y1, y2)
    assert torch.equal(t1.grad, t2.grad) and torch.equal(x1.grad, x2.grad)
    with pytest.raises(ValueError, match="unsupported device"):
        hg.grid_lookup(table.to("meta"), xs.to("meta"), grid)


def _bad(cases, kind):
    table, x, _, grid = cases["mixed_f2"]
    res, dense, H = grid
    if kind == "width_3":
        return torch.zeros((table.shape[0], 3)), x, grid
    if kind == "levels_33":
        return table, x, ([4] * 33, [True] * 33, H)
    if kind == "rows_not_pow2":
        return torch.zeros((len(res) * 1000, 2)), x, (res, dense, 1000)
    if kind == "dense_overflows":
        return table, x, (res, [True] * len(res), H)
    if kind == "x_strided":
        return table, torch.zeros((x.shape[0], 4))[:, :3], grid
    if kind == "x_float64":
        return table, x.double(), grid
    raise AssertionError(kind)


_REASONS = {"width_3": "table must be", "levels_33": "levels",
            "rows_not_pow2": "power of two", "dense_overflows": "not fit",
            "x_strided": "contiguous", "x_float64": "expected torch.float32"}


@pytest.mark.parametrize("kind", list(_REASONS))
def test_kernel_checks_raise(cases, kind):
    """What K9 does not take raises before a launch, each for its reason:
    a width outside 1, 2, 4, 8, more than 32 levels, rows per level not a
    power of two, a dense level whose grid overflows its rows, x strided
    or not float32."""
    table, x, grid = _bad(cases, kind)
    with pytest.raises((ValueError, TypeError), match=_REASONS[kind]):
        hg._check_grid(table, x, grid)
