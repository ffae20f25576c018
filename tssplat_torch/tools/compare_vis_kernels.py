"""The capped-candidate visibility kernels K2a/K2b on the 18-sphere scene,
commit against commit, in one process on one card.

    python -m tssplat_torch.tools.compare_vis_kernels [--parent DIR]
        [--views 8] [--res 512]

Builds ``csrc/vis_capped.cu``, runs it on the scene's first-step candidates
(tools/synthetic.py multisphere_scene, validated k) and on the bench
scene's single sphere, holds its outputs against the walk (ids and z to the
bit) and times it with sleep-held CUDA events (K2b and K2a, median of 25):
on the scene, with every tile's count set to 0 (the zeros alone), and one
view at a time (one wave of CTAs, so placement across waves plays no
part). It prints the build's ptxas resource lines.

With ``--parent DIR`` (a checkout of another commit of this repository,
for example unpacked by ``git archive`` into an ignored directory) it also
builds that tree's ``vis_capped.cu`` and ``vis.cu`` and times K2b, K2a and
K1 of both trees in the order parent, this, this, parent, with the
outputs' equality, and the parent's K2a and K2b one view at a time. One
JSON line per measurement. Needs a CUDA device and nvcc.
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
from ..ops.transform import transform_pos
from ..train import validated_tile_k
from .synthetic import bench_scene, multisphere_scene
from .timing import cuda_ms

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_vis_kernels needs a CUDA device")
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
    cb = bin_faces_capped(pos, st.edge_nbrs, res, k)
    walk = rk.visibility_capped_plain(cb, res)
    # the bench scene's single sphere, which the layout rule leaves to K1
    geo1, batch1 = bench_scene(dev, args.views, args.res)
    with torch.no_grad():
        pos1 = transform_pos(batch1["mvp"],
                             geo1.tet_v[geo1.statics.corner_vid])
    cb1 = bin_faces_capped(pos1, geo1.statics.edge_nbrs, res,
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
