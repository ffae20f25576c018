"""Inputs that corner the hash-grid kernel pair K9 (``ops/hash_grid.py``)
and the check of its table gradient, for the CPU tests, the card tests and
``chip_smoke.py``.

  grid_cases(device, n=2048) -> {name: (table, x, ct, grid)}
  table_rows_err(got, table, x, ct, grid) -> float

Every case is seeded; ``n`` points a case (the bounds case has fewer).
"""

from __future__ import annotations

import torch

from ..ops.hash_grid import grid_corners, grid_levels, \
    hash_grid_backward_plain

# (n_levels, F, log2_hashmap_size, base_resolution, per_level_scale)
_GRIDS = {
    "gso_layout": (16, 2, 19, 16, 1.447269237440378),   # gso.yaml's grid
    "mixed_f1": (5, 1, 10, 4, 1.9),      # levels 4, 7 dense; 14-52 hashed
    "mixed_f2": (5, 2, 10, 4, 1.9),
    "wide_f4": (6, 4, 12, 3, 1.6),       # all but the last two dense
    "cell_faces": (5, 2, 10, 4, 1.9),
    "bounds": (5, 2, 10, 4, 1.9),
    # coordinates up to ~4.9 M: every hash product wraps 32 bits
    "hash_wrap": (3, 2, 12, 100_000, 7.0),
}
CASE_NAMES = tuple(_GRIDS)


def _points(name: str, grid, n: int, gen: torch.Generator) -> torch.Tensor:
    res = grid[0]
    if name == "cell_faces":
        # each axis on a face of a cell of one of the levels: k / r
        r = torch.tensor(res, dtype=torch.float32)[
            torch.randint(len(res), (n, 3), generator=gen)]
        k = torch.floor(torch.rand((n, 3), generator=gen) * (r + 1.0))
        return k / r
    if name == "bounds":
        # every combination of 0, 1 and a fraction per axis, where the
        # clamp to r - 1 acts (x = 1) or the lower corner is 0
        v = torch.tensor([0.0, 1.0, 0.37, 0.999999])
        g = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), -1)
        return g.reshape(-1, 3)
    return torch.rand((n, 3), generator=gen)


def grid_cases(device, n: int = 2048) -> dict:
    """{name: (table (L·H, F), x (N,3), ct (N, L·F), grid)} on ``device``:
    a table drawn in [-1, 1), points in [0,1]^3 (on the cell faces, on
    the bounds, or uniform) and a normal cotangent, all from CPU
    generators seeded by the case's index."""
    out = {}
    for i, (name, (L, F, log2h, base, scale)) in enumerate(_GRIDS.items()):
        gen = torch.Generator().manual_seed(90 + i)
        grid = grid_levels(L, base, scale, log2h)
        table = torch.rand((L * grid[2], F), generator=gen) * 2.0 - 1.0
        x = _points(name, grid, n, gen)
        ct = torch.randn((x.shape[0], L * F), generator=gen)
        out[name] = (table.to(device), x.to(device), ct.to(device), grid)
    return out


def table_rows_err(got: torch.Tensor, table: torch.Tensor, x: torch.Tensor,
                   ct: torch.Tensor, grid) -> float:
    """The largest distance of a row of the table gradient ``got`` from
    the plain version's (``hash_grid_backward_plain``) over the sum of the
    |terms| the row adds (inf where a row with no terms is not 0): float32
    sums in any order agree to a few units of that sum's last place."""
    want, _ = hash_grid_backward_plain(table, x, ct, grid)
    idx, wgt = grid_corners(x, *grid)
    N, L, F = x.shape[0], len(grid[0]), table.shape[1]
    mag = torch.zeros_like(table).index_add_(
        0, idx.reshape(-1),
        (wgt.abs()[..., None] * ct.abs().reshape(N, L, 1, F)).reshape(-1, F))
    err = (got - want).abs()
    ratio = torch.where(mag > 0, err / mag.clamp_min(1e-38),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max())
