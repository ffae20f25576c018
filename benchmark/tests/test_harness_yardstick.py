"""The yardstick's counts, held to hand counts on tiny scenes."""

import math

import pytest
import torch

from benchmark import yardstick as ys
from benchmark.reference.raster import (_pack, _unpack, pair_counts, tf32,
                                        visibility, winner_rows)
from benchmark.tracing import Trace


def test_least_seconds_takes_the_larger_bound():
    assert ys.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert ys.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert ys.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


@pytest.mark.parametrize("rows,per_px", [(True, 48), (False, 4)])
def test_visibility_work_by_hand(rows, per_px):
    # 2 views of 8x8, 5 faces: 128 pixels' outputs, 10 face-views' rows
    n_bytes, ops = ys.visibility_work(2, 8, 5, rows)
    assert n_bytes == 128 * per_px + 10 * 48
    assert ops == 20 * 128


def test_antialias_work_by_hand():
    counts = {"pairs_differ": 10, "pairs_valid": 6, "px_z": 4,
              "px_owner": 7, "px_in_a_valid_pair": 9}
    fwd, bwd = ys.antialias_work(counts, 100)
    rows = 4 * 4 + 40 * 7
    assert fwd == (8 * 100 + rows, 1000)
    assert bwd == (28 * 100 + rows + 4 * 9, 1500)


def _one_triangle(res=8):
    # a triangle in clip space (w = 1) over the lower-left of the image
    pos = torch.tensor([[[-0.9, -0.9, 0.0, 1.0], [0.5, -0.9, 0.0, 1.0],
                         [-0.9, 0.5, 0.0, 1.0]]])
    return pos, res


def test_visibility_covers_the_pixels_inside_by_hand():
    pos, res = _one_triangle()
    ids, z = visibility(pos, res)
    c = (torch.arange(res) + 0.5) / res * 2 - 1
    x, y = c[None, :], c[:, None]
    inside = (x >= -0.9) & (y >= -0.9) & (x + y <= -0.4)
    assert torch.equal(ids[0] > 0, inside)
    assert torch.all(z[0][inside] == 0)


def test_pair_counts_of_one_triangle_by_hand():
    pos, res = _one_triangle()
    ids, z = visibility(pos, res)
    g, aux = winner_rows(pos, torch.full((1, 3), -1), ids)
    c = pair_counts(ids, z, g, aux)
    fg = ids[0] > 0
    differ = int((fg[:, 1:] != fg[:, :-1]).sum()
                 + (fg[1:] != fg[:-1]).sum())
    assert c["pairs_differ"] == differ
    # against background z decides no owner; every owner is foreground
    assert c["px_z"] == 0
    assert 0 < c["px_owner"] <= int(fg.sum())
    assert c["pairs_valid"] <= c["pairs_differ"]


def test_nearer_face_wins_and_ties_go_to_the_smaller_id():
    near = [[-1, -1, -0.5, 1], [1, -1, -0.5, 1], [-1, 1, -0.5, 1]]
    far = [[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [-1, 1, 0.5, 1]]
    ids, _ = visibility(torch.tensor([far + near]), 4)
    assert int(ids[0, 0, 0]) == 2
    ids, _ = visibility(torch.tensor([near + near]), 4)
    assert int(ids[0, 0, 0]) == 1


def test_packed_keys_order_and_round_trip():
    z = torch.tensor([-0.5, -0.0, 0.0, 0.25, 0.25])
    i = torch.tensor([3, 2, 1, 9, 4])
    k = _pack(z, i)
    assert torch.equal(torch.argsort(k), torch.tensor([0, 2, 1, 4, 3]))
    ids, zz = _unpack(k)
    assert torch.equal(ids, i.int()) and torch.equal(zz.abs(), z.abs())


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    assert tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "vis_capped_kernel<true>",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "aa_fwd_kernel", "ts": 25,
           "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 60,
           "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 40, "dur": 15},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 34,
           "dur": 22},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 150,
           "dur": 5}]
    return Trace(ev, steps=2)


def test_trace_busy_union_gaps_and_totals_by_hand():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    # [10, 35] and [60, 65]: 30 us busy
    assert t.busy_s() == pytest.approx(30e-6)
    assert len(t.device) == 3
    gaps = t.idle_gaps(2)
    assert [round(g[1] * 1e6) for g in gaps] == [35, 25]
    assert gaps[1][0] == "aten::nonzero"
    tot = t.totals(("vis_capped_kernel",))
    assert list(tot.values()) == [[pytest.approx(20e-6), 1]]
    assert math.isclose(sum(v[0] for v in t.totals().values()), 35e-6)
