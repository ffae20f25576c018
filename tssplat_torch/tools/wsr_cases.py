"""Inputs that corner the table-gradient kernel K3 (``wsr_table_grad``):
its 8x128 tiles, its runs of four pixels read with one 16-byte load (or
scalar loads where W % 4 != 0), the sums inside a run and across the lanes
of a warp that carry the same face, and the rule for which pixels count
(``id > 0`` and a cotangent != 0, where -0.0 counts as zero). Each case is
(ids+1 (B,H,W) int32, ct6 (B,6,H,W) f32, F), made from a seeded
``torch.Generator`` on the CPU and moved to ``device``, so the CPU and the
card get the same values. The CPU tests hold the plain K3 against JAX and
against a float64 numpy sum on them; the CUDA tests and ``chip_smoke.py``
hold the kernel against the plain version (``rows_agree``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops import raster_kernels as rk

Case = Tuple[torch.Tensor, torch.Tensor, int]

CASE_NAMES = ("all_background", "background_ct", "one_face_dense",
              "distinct_per_pixel", "only_id_1", "only_id_F",
              "single_channel", "signed_zeros", "cancels_to_zero",
              "nan_pixel", "inf_pixel", "ragged_72x100_b1",
              "ragged_72x100_b3", "ragged_37x102")


def _blocky_ids(gen, B, H, W, F, p_bg, bh=2, bw=3):
    """Faces in 1..F over blocks of bh x bw pixels (3 wide, so runs of
    four hold two or three faces), background with probability p_bg."""
    h, w = -(-H // bh), -(-W // bw)
    ids = torch.randint(1, F + 1, (B, h, w), generator=gen)
    ids[torch.rand((B, h, w), generator=gen) < p_bg] = 0
    ids = ids.repeat_interleave(bh, 1).repeat_interleave(bw, 2)
    return ids[:, :H, :W].to(torch.int32).contiguous()


def _ct(gen, B, H, W, density):
    """Seeded normal cotangents at a share ``density`` of the pixels, all
    six channels zero elsewhere."""
    ct = torch.randn((B, 6, H, W), generator=gen)
    return ct * (torch.rand((B, 1, H, W), generator=gen) < density)


def wsr_cases(device) -> Dict[str, Case]:
    """name -> (ids, ct6, F), one per name of CASE_NAMES."""
    gen = torch.Generator().manual_seed(5)
    cases = {}

    # every id 0, a cotangent everywhere: nothing counts
    cases["all_background"] = (torch.zeros((2, 64, 256), dtype=torch.int32),
                               _ct(gen, 2, 64, 256, 1.0), 50)

    # faces over 60% of the pixels, a cotangent at half of all pixels:
    # the background ones are ignored, the foreground ones without one
    # add nothing
    F = 300
    cases["background_ct"] = (_blocky_ids(gen, 2, 64, 256, F, 0.4),
                              _ct(gen, 2, 64, 256, 0.5), F)

    # one face over the whole image with a cotangent everywhere: every lane
    # of every warp adds into the same row. Uniform in [0, 1), not normal:
    # a signed sum of 32,768 terms nearly cancels, and the Pallas kernel's
    # float32 sum then lands 3e-5 (relative) from the float64 one
    cases["one_face_dense"] = (torch.full((2, 128, 256), 5, dtype=torch.int32),
                               torch.rand((2, 6, 128, 256), generator=gen), 8)

    # a face of its own at every pixel (4,096 per view, more than 32 in
    # every warp), one view's ids the reverse of the other's
    F = 16 * 256
    perm = torch.randperm(F, generator=gen).view(16, 256) + 1
    ids = torch.stack([perm, F + 1 - perm]).to(torch.int32)
    cases["distinct_per_pixel"] = (ids, _ct(gen, 2, 16, 256, 0.9), F)

    # only the first and only the last face row of the table
    for name, face in (("only_id_1", 1), ("only_id_F", 40)):
        ids = torch.where(torch.rand((2, 64, 128), generator=gen) < 0.5,
                          face, 0).to(torch.int32)
        cases[name] = (ids, _ct(gen, 2, 64, 128, 0.7), 40)

    # one non-zero channel: the other five rows' entries stay zero
    F = 60
    ct = torch.zeros((2, 6, 64, 128))
    ct[:, 2] = _ct(gen, 2, 64, 128, 0.6)[:, 0]
    cases["single_channel"] = (_blocky_ids(gen, 2, 64, 128, F, 0.3), ct, F)

    # -0.0 counts as zero: pixels whose six cotangents are all -0.0 add
    # nothing, -0.0 beside non-zero channels adds as zero, and face 7's
    # only cotangents are -0.0
    ids = _blocky_ids(gen, 2, 64, 128, F, 0.3)
    ct = _ct(gen, 2, 64, 128, 0.5)
    neg = torch.rand((2, 1, 64, 128), generator=gen) < 0.3
    ct = torch.where(neg, torch.full_like(ct, -0.0), ct)
    half = torch.rand((2, 6, 64, 128), generator=gen) < 0.5
    ct = torch.where(half & ~neg, torch.full_like(ct, -0.0), ct)
    ct = torch.where((ids == 7)[:, None], torch.full_like(ct, -0.0), ct)
    cases["signed_zeros"] = (ids, ct, F)

    # face 3 over the left half of each view with +1 and -1 in equal
    # numbers on every channel: its sum is exactly 0 in any order; faces
    # 4 and 5 on the right with small integers (exact sums)
    ids = torch.zeros((2, 64, 128), dtype=torch.int32)
    ids[:, :, :64] = 3
    ids[:, :32, 64:] = 4
    ids[:, 32:, 64:] = 5
    sign = torch.ones((2, 6, 64, 64))
    sign[:, :, :, 1::2] = -1.0
    ct = torch.cat([sign, torch.randint(-3, 4, (2, 6, 64, 64),
                                        generator=gen).float()], dim=3)
    cases["cancels_to_zero"] = (ids, ct, 6)

    # a NaN and an inf at one foreground pixel: they reach that face's row
    # and no other (other faces share its tile and its warp)
    F = 300
    for name, bad in (("nan_pixel", float("nan")), ("inf_pixel", float("inf"))):
        ids = _blocky_ids(gen, 2, 64, 256, F, 0.2)
        ct = _ct(gen, 2, 64, 256, 0.8)
        ids[1, 20, 130] = 17
        ct[1, 4, 20, 130] = bad
        cases[name] = (ids, ct, F)

    # partial tiles: 72x100 (9 tile rows of 8; 100 of a tile's 128
    # columns) with one view and with three; 37x102, where rows and
    # columns leave partial tiles and W % 4 != 0 takes the scalar loads
    for name, (B, H, W) in (("ragged_72x100_b1", (1, 72, 100)),
                            ("ragged_72x100_b3", (3, 72, 100)),
                            ("ragged_37x102", (2, 37, 102))):
        cases[name] = (_blocky_ids(gen, B, H, W, 200, 0.3),
                       _ct(gen, B, H, W, 0.6), 200)

    if set(cases) != set(CASE_NAMES):
        raise AssertionError("CASE_NAMES is out of date")
    return {name: (ids.to(device).contiguous(), ct.to(device).contiguous(), F)
            for name, (ids, ct, F) in cases.items()}


def rows_agree(got: torch.Tensor, ids: torch.Tensor, ct6: torch.Tensor,
               F: int) -> float:
    """Hold K3's output ``got`` (B,F+1,6) against the plain version on the
    same inputs: each entry within 1e-5 of the sum of |ct| that its row
    adds (float32 atomics in any order), NaN and inf at the same places
    with the same sign, row F zero. Returns the largest finite
    difference; raises AssertionError where they disagree."""
    want = rk.wsr_table_grad_plain(ids, ct6, F)
    tol = 1e-5 * rk.wsr_table_grad_plain(ids, ct6.abs(), F)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    if bool(got[:, F].any()):
        raise AssertionError("row F is not zero")
    finite = torch.isfinite(want)
    if not torch.equal(torch.isnan(got), torch.isnan(want)) or \
            not torch.equal(got[torch.isinf(want)], want[torch.isinf(want)]) \
            or not bool(torch.isfinite(got[finite]).all()):
        raise AssertionError("NaN or inf at other places than the plain "
                             "version's")
    diff = (got[finite].double() - want[finite].double()).abs()
    if bool((diff > tol[finite].double()).any()):
        raise AssertionError(f"differs from plain by up to "
                             f"{float(diff.max())} beyond 1e-5 of its rows' "
                             f"sums of |ct|")
    return float(diff.max()) if diff.numel() else 0.0
