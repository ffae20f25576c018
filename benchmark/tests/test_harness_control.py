"""The control — the reference computed with TF32 matrix products in the
program's place — and half of the views come out as not correct under the
cells' limits, while the program comes out correct (tiny size, CPU)."""

import pytest
import torch

from benchmark.calibrate import readings_of
from benchmark.manifest import Cell
from benchmark.reference.compare import verdict
from benchmark.tests.tiny import cells, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", cells())
def test_control_and_half_batch_fail_the_limits(cell, root):
    c = Cell(cell, root)
    rows = {r["kind"]: r for r in readings_of(c, 4242, torch.device("cpu"),
                                              control=True)}
    assert verdict(rows["program"], c.limits), rows["program"]
    assert not verdict(rows["control_tf32"], c.limits), rows["control_tf32"]
    assert not verdict(rows["fault_half_batch"], c.limits)
