"""The numbers that decide ``correct``, from two runs' readings (each as
``Reference.follow`` returns them): each is a gap between the two runs'
numbers, as a share of the reference's.

  loss_gap    the largest |loss - reference loss| / |reference loss| over
              the first three iterations
  grad_gap    over the leaves, the largest gap between the norms of the
              first gradient, over the reference's norm of that leaf or of
              the median leaf, whichever is larger
  change_gap  the same of the parameters' change after three steps, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's (a leaf whose gradient is rounding noise
              moves by rounding under the uniform step)

A cell's ``benchmark/limits/<cell>.yaml`` holds the limit of each.
"""

from __future__ import annotations

import statistics


def _worst_leaf(prog, ref, keep):
    floor = statistics.median(ref)
    gaps = [abs(p - r) / max(r, floor) for p, r, k in zip(prog, ref, keep)
            if k and max(r, floor) > 0]
    return max(gaps) if gaps else 0.0


def readings(prog: dict, ref: dict) -> dict:
    if prog["names"] != ref["names"]:
        raise ValueError(f"leaves differ: {prog['names']} {ref['names']}")
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    g_med = statistics.median(ref["grad_norms"])
    moved = [g >= 1e-3 * g_med for g in ref["grad_norms"]]
    return {"loss_gap": max(gaps),
            "grad_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                    [True] * len(moved)),
            "change_gap": _worst_leaf(prog["change_norms"],
                                      ref["change_norms"], moved)}


def verdict(values: dict, limits: dict) -> bool:
    """Every number within its limit (a missing or non-finite number is
    not)."""
    return all(k in values and values[k] == values[k]
               and values[k] <= float(v) for k, v in limits.items())
