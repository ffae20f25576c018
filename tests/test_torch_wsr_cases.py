"""The table gradient K3 on the inputs that corner its tiles, runs and
per-warp sums (tssplat_torch/tools/wsr_cases.py): the port's plain K3
against JAX's ``wsr_table_grad_pallas`` (its Pallas kernel in interpret
mode) where H and W fill its tiles, and against a float64 numpy sum on
every case. The kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tssplat_tpu.ops.pallas_raster import wsr_table_grad_pallas

from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.tools.wsr_cases import CASE_NAMES, rows_agree, wsr_cases

torch.set_num_threads(1)

NONFINITE = ("nan_pixel", "inf_pixel")
# the finite cases whose H and W are whole numbers of the Pallas kernel's
# tiles (H % 8, W % 128); the ragged ones are held against numpy only
PALLAS_CASES = tuple(n for n in CASE_NAMES
                     if n not in NONFINITE and not n.startswith("ragged"))


@pytest.fixture(scope="module")
def cases():
    return {name: (ids.numpy(), ct.numpy(), F)
            for name, (ids, ct, F) in wsr_cases("cpu").items()}


def _numpy_sum(ids, ct, F):
    """Per (view, face) float64 sums of the counted pixels' cotangents."""
    B, C = ct.shape[:2]
    rows = ct.transpose(0, 2, 3, 1).reshape(-1, C).astype(np.float64)
    idv = ids.reshape(-1).astype(np.int64)
    b = np.repeat(np.arange(B), ids[0].size)
    on = (idv > 0) & (rows != 0).any(axis=1)
    out = np.zeros((B * (F + 1), C))
    np.add.at(out, b[on] * (F + 1) + idv[on] - 1, rows[on])
    return out.reshape(B, F + 1, C)


def _plain(ids, ct, F):
    return rk.wsr_table_grad(torch.from_numpy(ids), torch.from_numpy(ct),
                             F).numpy()


@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_table_grad_matches_numpy(cases, name):
    """Plain K3 against a float64 numpy sum per face: the same rows to
    float32 rounding, NaN and inf at the same places, row F zero."""
    ids, ct, F = cases[name]
    got, want = _plain(ids, ct, F), _numpy_sum(ids, ct, F)
    assert got.shape == (ids.shape[0], F + 1, 6)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6,
                               atol=0)
    assert not got[:, F].any()
    if name == "all_background":
        assert not got.any()
    elif name in NONFINITE:
        bad = ~np.isfinite(got)
        assert bad.sum() == 1 and bad[1, 16, 4]    # face 17, channel 4
    elif name == "cancels_to_zero":
        assert not got[:, 2].any() and got[:, 3:5].any()
    elif name == "signed_zeros":
        assert not got[:, 6].any()
    elif name == "single_channel":
        assert not np.delete(got, 2, axis=2).any() and got[..., 2].any()


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_plain_table_grad_matches_pallas_on_case(cases, name):
    """Plain K3 against wsr_table_grad_pallas (interpret mode) on every
    finite case whose H is a multiple of 8 and W of 128 (the Pallas
    kernel's tiles), at tests/test_torch_kernels.py's rtol/atol 1e-5."""
    ids, ct, F = cases[name]
    B, H, W = ids.shape
    assert H % 8 == 0 and W % 128 == 0
    want = np.asarray(wsr_table_grad_pallas(jnp.asarray(ids),
                                            jnp.asarray(ct), F,
                                            interpret=True))
    np.testing.assert_allclose(_plain(ids, ct, F), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", [math.nan, math.inf], ids=["nan", "inf"])
def test_plain_table_grad_keeps_nonfinite_in_its_row(bad):
    """ids [1, 1, 2, 3], every ct 1, one non-finite channel at a pixel of
    face 1: only face 1's row gets it (a running sum over the sorted
    pixels once spread it into every face sorted after)."""
    ids = torch.tensor([[[1, 1, 2, 3]]], dtype=torch.int32)
    ct = torch.ones((1, 6, 1, 4))
    ct[0, 0, 0, 0] = bad
    got = rk.wsr_table_grad(ids, ct, 3)[0]
    want = torch.tensor([[bad] + [2.0] * 5, [1.0] * 6, [1.0] * 6, [0.0] * 6])
    torch.testing.assert_close(got, want, equal_nan=True, rtol=0, atol=0)


def test_rows_agree_refuses_what_differs(cases):
    """The kernel's check (rows_agree) passes the plain version itself and
    refuses a row moved by more than its tolerance, a NaN moved to another
    row, and a write into row F."""
    ids, ct, F = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in cases["nan_pixel"])
    want = rk.wsr_table_grad_plain(ids, ct, F)
    assert rows_agree(want.clone(), ids, ct, F) == 0.0
    for edit in ("shift", "nan", "row_F"):
        got = want.clone()
        if edit == "shift":
            got[0, 10, 1] += 1e-3 * float(got[0, 10, 1].abs()) + 1e-3
        elif edit == "nan":
            got[1, 16, 4], got[1, 17, 4] = 0.0, math.nan
        else:
            got[0, F, 0] = 1.0
        with pytest.raises(AssertionError):
            rows_agree(got, ids, ct, F)
