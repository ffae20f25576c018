"""Kernels of this tree against another commit's, in one process on one
card: the capped-candidate visibility kernels K2a/K2b (with K1), the
antialias kernels K4/K5 and the table gradient K3.

    python -m tssplat_torch.tools.compare_kernels [--parent DIR]
        [--kernels vis,aa,wsr] [--views 8] [--res 512]

``vis``: builds ``csrc/vis_capped.cu``, runs it on the 18-sphere scene's
first-step candidates (tools/synthetic.py multisphere_scene, validated k)
and on the bench scene's single sphere, holds its outputs against the walk
(ids and z to the bit) and times it with sleep-held CUDA events (K2b and
K2a, median of 25): on the scene, with every tile's count set to 0 (the
zeros alone), and one view at a time (one wave of CTAs, so placement across
waves plays no part).

``aa``: builds ``csrc/aa_fwd.cu`` and ``csrc/aa_bwd.cu`` and runs K4 and K5
on the inputs of every main-path step that launches them, at its first
step: the bench scene (K1's outputs), the 18-sphere silhouette step (K2b's)
and the 18-sphere depth + normal step (``ops/rasterize.py antialias_rows``
of the shaded winners), under a seeded cotangent. Per input it prints the
pairs whose ids differ, the valid ones among them, the pixels whose z,
row or cotangent the kernels read (``aa_pair_counts``) and the bounds; per
tree it holds K4 and K5 equal by value to
their plain versions and times them as they are, with every id 0 (nothing
to antialias: the streaming floor) and with L2 flushed before each call.

``wsr``: builds ``csrc/wsr_grad.cu`` and runs K3 on the cotangent each of
those three steps hands it (K5's d g6 under a seeded cotangent) and on
``dense6``, a seeded cotangent at every foreground pixel of the bench
scene. Per input it prints the foreground pixels, the active ones (a
cotangent != 0), the (view, face) rows they touch, the bound, the fill of
the table alone (``torch.zeros``) and two one-call PyTorch yardsticks
(``index_add_``, ``index_put_`` with accumulate); per tree it holds K3 to
its plain version (``tools/wsr_cases.py rows_agree``) and times it as it
is, with every cotangent 0 (the id stream alone), with every id 0 and
with L2 flushed, and for a tree whose C entry does not zero the table
itself, the kernel alone on a table zeroed beforehand.

All parts print the builds' ptxas resource lines. With ``--parent DIR`` (a
checkout of another commit of this repository, for example unpacked by
``git archive`` into an ignored directory) each part also builds that
tree's sources and times both trees in the order parent, this, this,
parent, with the outputs' equality across the trees (K3's to rtol 1e-5;
for ``vis`` also K1, and the parent's K2a and K2b one view at a time). One JSON line per
measurement. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..ops import raster_kernels as rk
from ..ops.binning import CappedBins, bin_faces, bin_faces_capped, capacity
from ..ops.rasterize import antialias_rows, rasterize, screen_xy_table
from ..ops.transform import transform_pos
from ..train import validated_tile_k
from .synthetic import bench_scene, multisphere_scene
from .timing import bound_ms, cuda_ms
from .wsr_cases import rows_agree


def build_library(source: Path, tag: str):
    """nvcc ``source`` with the port's flags into build/kernels/compare/;
    returns (ctypes library, ptxas resource lines)."""
    out_dir = build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{tag}.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(out), str(source)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}"
                           f"{res.stderr}")
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(out)), report


def entry(lib, fn_name: str):
    fn = getattr(lib, fn_name)
    fn.argtypes = build.SIGNATURES[fn_name][1]
    fn.restype = ctypes.c_int
    return fn


def run_capped(lib, bins: CappedBins, res, emit_g: bool):
    """K2b (emit_g) or K2a of ``lib`` on ``bins``, as the wrappers launch
    them."""
    H, W = res
    B, F, _ = bins.table.shape
    dev = bins.table.device
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (bins.table.data_ptr(), bins.counts.data_ptr(),
            bins.cand.data_ptr(), B, F, H, W, bins.cand.shape[1],
            ids.data_ptr(), z.data_ptr())
    if emit_g:
        g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
        gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
        err = entry(lib, "tss_vis_capped_g_launch")(
            *args, g6.data_ptr(), gaux.data_ptr(), stream)
        out = (ids, z, g6, gaux)
    else:
        err = entry(lib, "tss_vis_capped_launch")(*args, stream)
        out = (ids, z)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def run_k1(lib, bins, res):
    H, W = res
    B, F, _ = bins.table.shape
    dev = bins.table.device
    ids = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    g6 = torch.empty((B, 6, H, W), dtype=torch.float32, device=dev)
    gaux = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    err = entry(lib, "tss_vis_launch")(
        bins.table.data_ptr(), bins.tile_start.data_ptr(),
        bins.tile_count.data_ptr(), bins.faces.data_ptr(), B, F, H, W,
        bins.nty, bins.ntx, 1, ids.data_ptr(), z.data_ptr(), g6.data_ptr(),
        gaux.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")
    return ids, z, g6, gaux


def same_bits(got, want) -> bool:
    """ids and z to the bit (the sign of a zero included), the winner rows
    by value (the plain version's background rows are zeros of either
    sign)."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got[:2], want[:2])) \
        and all(torch.equal(a, b) for a, b in zip(got[2:], want[2:]))


def view_slice(bins: CappedBins, b: int) -> CappedBins:
    nt = bins.nty * bins.ntx
    return bins._replace(table=bins.table[b:b + 1].contiguous(),
                         counts=bins.counts[b * nt:(b + 1) * nt].contiguous(),
                         cand=bins.cand[b * nt:(b + 1) * nt].contiguous(),
                         n_drop=bins.n_drop[b:b + 1])


def run_aa(libs, inp, ct=None):
    """K4 (ct None) or K5 of ``libs`` = (K4 library, K5 library) on
    ``inp`` = (ids, z, g6, gaux), as the wrappers launch them."""
    ids, z, g6, gaux = inp
    B, H, W = ids.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in inp]
    if ct is None:
        out = torch.empty((B, H, W), dtype=torch.float32, device=ids.device)
        err = entry(libs[0], "tss_aa_fwd_launch")(*ptrs, B, H, W,
                                                  out.data_ptr(), stream)
    else:
        out = torch.empty((B, 6, H, W), dtype=torch.float32,
                          device=ids.device)
        err = entry(libs[1], "tss_aa_bwd_launch")(
            *ptrs, ct.data_ptr(), B, H, W, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def time_aa(fwd, bwd, inp, ct) -> dict:
    """K4 ``fwd(ids, z, g6, gaux)`` and K5 ``bwd(ids, z, g6, gaux, ct)``
    timed as they are, with every id 0 (no pair to evaluate: what the
    streaming alone costs) and with L2 flushed before each call."""
    zero = (torch.zeros_like(inp[0]),) + tuple(inp[1:])
    return {
        "K4_ms": cuda_ms(lambda: fwd(*inp)),
        "K5_ms": cuda_ms(lambda: bwd(*inp, ct)),
        "K4_zero_ids_ms": cuda_ms(lambda: fwd(*zero)),
        "K5_zero_ids_ms": cuda_ms(lambda: bwd(*zero, ct)),
        "K4_flushed_ms": cuda_ms(lambda: fwd(*inp), flush=True),
        "K5_flushed_ms": cuda_ms(lambda: bwd(*inp, ct), flush=True)}


def aa_pair_counts(ids, z, g6, gaux) -> dict:
    """What K4 and K5 read beyond the ids, over both axes' pairs (host
    reads): the pairs whose ids differ and the valid ones among them; the
    pixels whose z decides an owner (both sides of a differing pair
    foreground); the pixels that own a differing pair, whose row (g6 and
    gaux) decides it; and the pixels of a valid pair, whose cotangent K5
    reads."""
    n_differ = n_valid = 0
    need_z, owner, in_valid = (torch.zeros_like(ids, dtype=torch.bool)
                               for _ in range(3))
    for axis in (2, 1):
        ops = rk._pairs(ids, z, g6, gaux, axis)
        ida, idb = ops[0], ops[1]
        d = (ida != idb) & ((ida > 0) | (idb > 0))
        P = rk._pair_eval(*ops)
        n_differ += int(d.sum())
        n_valid += int(P["valid"].sum())
        n = ids.shape[axis] - 1
        both = d & (ida > 0) & (idb > 0)
        # (mask, its pixels a, its pixels b)
        for mask, on_a, on_b in ((need_z, both, both),
                                 (owner, d & P["owner_a"], d & ~P["owner_a"]),
                                 (in_valid, P["valid"], P["valid"])):
            mask.narrow(axis, 0, n).logical_or_(on_a)
            mask.narrow(axis, 1, n).logical_or_(on_b)
    return {"pairs_differ": n_differ, "pairs_valid": n_valid,
            "px_z": int(need_z.sum()), "px_owner": int(owner.sum()),
            "px_in_a_valid_pair": int(in_valid.sum())}


def aa_bounds(inp) -> dict:
    """Pair counts of ``inp`` and K4's and K5's bounds on them: bytes of the
    ids and the output at every pixel (K4 8 B/px, K5 28 B/px), z where it
    decides an owner (4 B), the owner's row (40 B), and for K5 the
    cotangent at the pixels of a valid pair (4 B); f32 operations 100 (K4)
    and 150 (K5) per differing pair."""
    c = aa_pair_counts(*inp)
    P = inp[0].numel()
    rows = 4 * c["px_z"] + 40 * c["px_owner"]
    return {"pixels": P, **c,
            "K4_bound": bound_ms(8 * P + rows, 100 * c["pairs_differ"]),
            "K5_bound": bound_ms(28 * P + rows + 4 * c["px_in_a_valid_pair"],
                                 150 * c["pairs_differ"])}


def multisphere_aa_inputs(geo, batch, res, k) -> dict:
    """K4/K5's inputs at the first step of the multi-sphere silhouette step
    (K2b's outputs) and depth + normal step (the rows of the shaded
    winners, ``antialias_rows``)."""
    st = geo.statics
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[st.corner_vid])
        sil = rk.visibility_capped(
            bin_faces_capped(pos, st.edge_nbrs, res, k), res)
        rast, _ = rasterize(pos, res, k)
        dn = antialias_rows(rast, screen_xy_table(
            pos, int(st.edge_nbrs.shape[0])), st.edge_nbrs)
    return {"multisphere_silhouette": sil, "multisphere_depth_normal": dn}


def compare_aa(args, smi, inputs):
    """The ``aa`` part: pair counts and bounds per input, then each tree's
    K4 and K5 against the plain versions and timed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    trees = {"this": build.CSRC}
    if args.parent is not None:
        trees["parent"] = args.parent / "tssplat_torch" / "csrc"
    libs, reports = {}, {}
    for tree, src in trees.items():
        f, rf = build_library(src / "aa_fwd.cu", f"aa_fwd_{tree}")
        b, rb = build_library(src / "aa_bwd.cu", f"aa_bwd_{tree}")
        libs[tree], reports[tree] = (f, b), rf + rb
    print(json.dumps({"part": "aa", "card": smi, "ptxas": reports}),
          flush=True)
    order = ["parent", "this", "this", "parent"] if len(trees) > 1 \
        else ["this", "this"]
    for name, inp in inputs.items():
        ct = torch.randn(inp[0].shape, generator=gen, device="cuda")
        want_f = rk.aa_forward_plain(*inp)
        want_b = rk.aa_backward_plain(*inp, ct)
        ids = inp[0]
        print(json.dumps({
            "inputs": name, **aa_bounds(inp),
            # one-kernel PyTorch yardsticks of the streaming alone
            "ids_to_f32_ms": cuda_ms(lambda: ids.float()),
            "zeros_like_dg6_ms": cuda_ms(lambda: torch.zeros_like(inp[2]))}),
            flush=True)
        outs = {}
        for tree in order:
            lib = libs[tree]
            outs[tree] = (run_aa(lib, inp), run_aa(lib, inp, ct))
            print(json.dumps({
                "inputs": name, "tree": tree, "card": smi,
                "K4_equals_plain": bool(torch.equal(outs[tree][0], want_f)),
                "K5_equals_plain": bool(torch.equal(outs[tree][1], want_b)),
                **time_aa(lambda *a: run_aa(lib, a),
                          lambda *a: run_aa(lib, a[:4], a[4]), inp, ct)}),
                flush=True)
        if len(trees) > 1:
            print(json.dumps({"inputs": name, "equal_across_trees": all(
                torch.equal(a, b)
                for a, b in zip(outs["this"], outs["parent"]))}), flush=True)


def run_wsr(lib, ids, ct6, F, fills=True, out=None):
    """K3 of ``lib`` on (ids, ct6), as the wrapper launches it: into a
    ``torch.empty`` table where the C entry zeroes it (``fills``), else into
    ``torch.zeros``; or into ``out`` as it is."""
    B, _, H, W = ct6.shape
    if out is None:
        out = (torch.empty if fills else torch.zeros)(
            (B, F + 1, 6), dtype=torch.float32, device=ct6.device)
    err = entry(lib, "tss_wsr_grad_launch")(
        ids.data_ptr(), ct6.data_ptr(), B, H, W, F, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def time_wsr(fn, ids, ct6, F) -> dict:
    """K3 ``fn(ids, ct6, F)`` timed as it is, with every cotangent 0 (no
    pixel counts: the id stream and the fill), with every id 0 (nothing is
    foreground) and with L2 flushed before each call."""
    zero_ct, zero_ids = torch.zeros_like(ct6), torch.zeros_like(ids)
    return {"K3_ms": cuda_ms(lambda: fn(ids, ct6, F)),
            "K3_zero_ct_ms": cuda_ms(lambda: fn(ids, zero_ct, F)),
            "K3_zero_ids_ms": cuda_ms(lambda: fn(zero_ids, ct6, F)),
            "K3_flushed_ms": cuda_ms(lambda: fn(ids, ct6, F), flush=True)}


def wsr_counts(ids, ct6, F) -> dict:
    """What K3 must read and write on (ids, ct6): every id (4 B/px), the
    six cotangents of each foreground pixel (24 B), the table (24 B a
    row); one add per channel of each active pixel. Also the active
    pixels' distinct (view, face) rows."""
    B = ids.shape[0]
    fg = ids > 0
    act = fg & (ct6 != 0).any(dim=1)
    key = (torch.arange(B, device=ids.device)[:, None, None] * (F + 1)
           + ids.long() - 1)[act]
    n_fg, n_act = int(fg.sum()), int(act.sum())
    return {"pixels": ids.numel(), "n_fg": n_fg, "n_active": n_act,
            "rows_touched": int(torch.unique(key).numel()),
            "K3_bound": bound_ms(4 * ids.numel() + 24 * n_fg
                                 + 24 * B * (F + 1), 6 * n_act)}


def wsr_library_ms(ids, ct6, F) -> dict:
    """One-call PyTorch yardsticks of K3 on (ids, ct6): ``index_add_`` of
    every pixel's row (background into row F, active or not), and
    ``index_put_`` with accumulate of the active pixels' rows."""
    B, C, H, W = ct6.shape
    dev = ct6.device
    fg = ids > 0
    idx = (torch.arange(B, device=dev)[:, None, None] * (F + 1)
           + torch.where(fg, ids.long() - 1, F)).reshape(-1)
    rows = ct6.permute(0, 2, 3, 1).reshape(-1, C).contiguous()
    act = (fg & (ct6 != 0).any(dim=1)).reshape(-1)
    a_idx, a_rows = idx[act], rows[act]
    return {
        "index_add_ms": cuda_ms(lambda: torch.zeros(
            (B * (F + 1), C), device=dev).index_add_(0, idx, rows)),
        "index_put_ms": cuda_ms(lambda: torch.zeros(
            (B * (F + 1), C), device=dev).index_put_(
                (a_idx,), a_rows, accumulate=True))}


def wsr_inputs(bench_inp, bench_F, ms_inputs, ms_F) -> dict:
    """name -> (ids, ct6, F): K3's inputs on the three main-path steps (K5's
    d g6 under a seeded cotangent, as the steps' backward hands it over)
    and ``dense6``, a seeded cotangent at every foreground pixel of the
    bench scene."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, inp, F in (("bench", bench_inp, bench_F),
                         *((n, i, ms_F) for n, i in ms_inputs.items())):
        ct = torch.randn(inp[0].shape, generator=gen, device="cuda")
        out[name] = (inp[0], rk.aa_backward(*inp, ct), F)
    ids = bench_inp[0]
    out["dense6"] = (ids, torch.randn(
        (ids.shape[0], 6) + tuple(ids.shape[1:]), generator=gen,
        device="cuda") * (ids > 0)[:, None], bench_F)
    return out


def compare_wsr(args, smi, inputs):
    """The ``wsr`` part: counts, bound, fill and library times per input,
    then each tree's K3 against the plain version and timed."""
    trees = {"this": build.CSRC}
    if args.parent is not None:
        trees["parent"] = args.parent / "tssplat_torch" / "csrc"
    libs, fills, reports = {}, {}, {}
    for tree, src in trees.items():
        libs[tree], reports[tree] = build_library(src / "wsr_grad.cu",
                                                  f"wsr_grad_{tree}")
        fills[tree] = "cudaMemsetAsync" in (src / "wsr_grad.cu").read_text()
    print(json.dumps({"part": "wsr", "card": smi, "ptxas": reports,
                      "c_entry_zeroes_table": fills}), flush=True)
    order = ["parent", "this", "this", "parent"] if len(trees) > 1 \
        else ["this", "this"]
    for name, (ids, ct6, F) in inputs.items():
        B = ids.shape[0]
        print(json.dumps({
            "inputs": name, "F": F, **wsr_counts(ids, ct6, F),
            "fill_ms": cuda_ms(lambda: torch.zeros(
                (B, F + 1, 6), dtype=torch.float32, device="cuda")),
            **wsr_library_ms(ids, ct6, F)}), flush=True)
        outs = {}
        for tree in order:
            lib, fl = libs[tree], fills[tree]
            outs[tree] = run_wsr(lib, ids, ct6, F, fl)
            rec = {"inputs": name, "tree": tree, "card": smi,
                   "max_abs_err_vs_plain": rows_agree(outs[tree], ids, ct6,
                                                      F),
                   **time_wsr(lambda *a: run_wsr(lib, *a, fills=fl), ids,
                              ct6, F)}
            if not fl:
                zeroed = torch.zeros((B, F + 1, 6), device="cuda")
                rec["K3_kernel_only_ms"] = cuda_ms(
                    lambda: run_wsr(lib, ids, ct6, F, out=zeroed))
            print(json.dumps(rec), flush=True)
        if len(trees) > 1:
            a, b = outs["this"], outs["parent"]
            print(json.dumps({"inputs": name, "close_across_trees": bool(
                torch.allclose(a, b, rtol=1e-5,
                               atol=1e-6 * float(b.abs().max())))}),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--kernels", default="vis,aa,wsr",
                    help="comma-separated parts: vis, aa, wsr")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    args = ap.parse_args(argv)
    parts = set(args.kernels.split(","))
    if not parts <= {"vis", "aa", "wsr"}:
        raise SystemExit(f"unknown parts in --kernels {args.kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = (args.res, args.res)
    geo, batch = multisphere_scene(dev, 18, args.views, args.res)
    k = validated_tile_k(geo, batch, args.res)
    st = geo.statics
    with torch.no_grad():
        pos = transform_pos(batch["mvp"], geo.tet_v[st.corner_vid])
    # the bench scene's single sphere, which the layout rule leaves to K1
    geo1, batch1 = bench_scene(dev, args.views, args.res)
    with torch.no_grad():
        pos1 = transform_pos(batch1["mvp"],
                             geo1.tet_v[geo1.statics.corner_vid])
    inputs = {"bench": rk.visibility(
        bin_faces(pos1, geo1.statics.edge_nbrs, res), res)}
    inputs.update(multisphere_aa_inputs(geo, batch, res, k))
    if "aa" in parts:
        compare_aa(args, smi, inputs)
    if "wsr" in parts:
        ms = {n: v for n, v in inputs.items() if n != "bench"}
        compare_wsr(args, smi, wsr_inputs(
            inputs["bench"], int(geo1.statics.surface_fid.shape[0]), ms,
            int(st.surface_fid.shape[0])))
    if "vis" in parts:
        compare_vis(args, smi, res, k, st, pos, pos1,
                    geo1.statics.edge_nbrs)


def compare_vis(args, smi, res, k, st, pos, pos1, nbrs1):
    """The ``vis`` part: K2b/K2a (and K1 against the parent)."""
    cb = bin_faces_capped(pos, st.edge_nbrs, res, k)
    walk = rk.visibility_capped_plain(cb, res)
    cb1 = bin_faces_capped(pos1, nbrs1, res,
                           capacity(None, int(pos1.shape[1]) // 3, res))
    walk1 = rk.visibility_capped_plain(cb1, res)
    print(json.dumps({
        "card": smi, "faces": int(cb.table.shape[1]), "k": k,
        "pairs": int(cb.counts.sum()),
        "tiles_with_candidates": int((cb.counts > 0).sum()),
        "tiles": cb.counts.numel(), "max_count": int(cb.counts.max()),
        "box_tests": int(rk.boxed_pairs(cb, res)[6].sum()),
        "walk_tests": int(cb.counts.sum()) * 1024,
        "bench_sphere_pairs": int(cb1.counts.sum()),
        "bench_sphere_box_tests": int(rk.boxed_pairs(cb1, res)[6].sum())}),
        flush=True)

    new_k2, report = build_library(build.CSRC / "vis_capped.cu",
                                   "vis_capped_this")
    none = cb._replace(counts=torch.zeros_like(cb.counts))
    print(json.dumps({
        "tree": "this", "card": smi,
        "K2b_equals_walk": same_bits(run_capped(new_k2, cb, res, True), walk),
        "K2a_equals_walk": same_bits(run_capped(new_k2, cb, res, False),
                                     walk[:2]),
        "K2b_ms": cuda_ms(lambda: run_capped(new_k2, cb, res, True)),
        "K2a_ms": cuda_ms(lambda: run_capped(new_k2, cb, res, False)),
        "no_candidates_K2b_ms": cuda_ms(
            lambda: run_capped(new_k2, none, res, True)),
        "no_candidates_K2a_ms": cuda_ms(
            lambda: run_capped(new_k2, none, res, False)),
        "bench_sphere_equals_walk": same_bits(
            run_capped(new_k2, cb1, res, True), walk1),
        "bench_sphere_K2b_ms": cuda_ms(
            lambda: run_capped(new_k2, cb1, res, True)),
        "bench_sphere_K2a_ms": cuda_ms(
            lambda: run_capped(new_k2, cb1, res, False)),
        "ptxas": report}), flush=True)

    def one_view_at_a_time(tree, lib):
        # 256 CTAs, all resident at once
        for b in range(args.views):
            one = view_slice(cb, b)
            print(json.dumps({
                "tree": tree, "view": b, "pairs": int(one.counts.sum()),
                "K2b_ms": cuda_ms(lambda: run_capped(lib, one, res, True)),
                "K2a_ms": cuda_ms(lambda: run_capped(lib, one, res, False))}),
                flush=True)

    one_view_at_a_time("this", new_k2)
    if args.parent is None:
        return
    old_src = args.parent / "tssplat_torch" / "csrc"
    old_k2, old_report = build_library(old_src / "vis_capped.cu",
                                       "vis_capped_parent")
    new_k1 = build_library(build.CSRC / "vis.cu", "vis_this")[0]
    old_k1 = build_library(old_src / "vis.cu", "vis_parent")[0]
    fb = bin_faces(pos, st.edge_nbrs, res)
    order = (("parent", old_k2, old_k1), ("this", new_k2, new_k1),
             ("this", new_k2, new_k1), ("parent", old_k2, old_k1))
    for tree, k2, k1 in order:
        print(json.dumps({
            "tree": tree, "card": smi,
            "K2b_ms": cuda_ms(lambda: run_capped(k2, cb, res, True)),
            "K2a_ms": cuda_ms(lambda: run_capped(k2, cb, res, False)),
            "K1_ms": cuda_ms(lambda: run_k1(k1, fb, res))}), flush=True)
    print(json.dumps({
        "K1_equal_across_trees": same_bits(run_k1(old_k1, fb, res),
                                           run_k1(new_k1, fb, res)),
        "K2b_equal_across_trees": same_bits(run_capped(old_k2, cb, res, True),
                                            run_capped(new_k2, cb, res, True)),
        "K2a_equal_across_trees": same_bits(
            run_capped(old_k2, cb, res, False),
            run_capped(new_k2, cb, res, False)),
        "parent_ptxas": old_report}), flush=True)
    one_view_at_a_time("parent", old_k2)



if __name__ == "__main__":
    main()
