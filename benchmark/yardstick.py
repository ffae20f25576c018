"""The yardstick: the card's published peaks and the work the kernels'
rooflines are measured against.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM3 and
67 TFLOP/s in float32 outside the tensor cores, at the card's 700 W
limit; a run reports the limit its card is set to beside them.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time one card could take: the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOP_PER_S)


def visibility_work(views: int, res: int, faces: int, rows: bool):
    """(bytes, operations) of one step's visibility over ``views`` views of
    res²: each face's clip rows read once (3 corners x 4 floats a view),
    each pixel's outputs the step needs written once — with winner rows
    (the silhouette path) the id, z, six screen coordinates and four
    neighbour/sign values, 48 B; without (the shaded path) the id, 4 B —
    and one coverage test of 20 operations at every pixel (its least
    work: three edge functions and the z interpolation)."""
    px = views * res * res
    return px * (48 if rows else 4) + views * faces * 48, 20 * px


def antialias_work(counts: dict, pixels: int):
    """(bytes, operations) of the silhouette antialias's forward and
    backward on inputs with ``counts`` (``reference.raster.pair_counts``)
    over ``pixels`` pixels: the forward reads the ids and writes the
    coverage at every pixel (8 B), reads z where it decides an owner (4 B)
    and the owner's rows (40 B); the backward reads the ids and writes the
    six row gradients at every pixel (28 B), reads the same z and rows and
    the cotangent at the pixels of a valid pair (4 B); 100 and 150 float32
    operations per differing pair."""
    rows = 4 * counts["px_z"] + 40 * counts["px_owner"]
    fwd = (8 * pixels + rows, 100 * counts["pairs_differ"])
    bwd = (28 * pixels + rows + 4 * counts["px_in_a_valid_pair"],
           150 * counts["pairs_differ"])
    return fwd, bwd
