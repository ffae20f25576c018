"""Device memory a view-pixel of the unchunked train step, on the card,
against what the ``view_chunk: auto`` rule counts for it.

    python -m tssplat_torch.tools.view_memory [--views 120] [--res 512]
        [--tile-k K ...]

The paths that honour ``view_chunk`` (the silhouette and the depth +
normal geometry steps, AdamUniform as gso.yaml sets it, and the texture
stage's dense colour path, ExplicitMaterial at its defaults) on the
18-sphere bench scene (``tools/synthetic.py bench_scene``), each run
unchunked for two steps at each capacity of the capped layout (by default
the scene's validated one and next_pow2(F), the largest the validator
returns). For each it prints one JSON line: the bytes allocated before the
first step (the scene, the batch, the optimizer state), the allocator's
peak over the steps, the peak's excess over the resident bytes per
view-pixel, and the bytes per view-pixel the rule counts at that capacity
(``train.py _bytes_per_view``), which the reading must not pass. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..materials import ExplicitMaterial
from ..ops.binning import next_pow2
from ..optim import adam_uniform, cosine_annealing_lr
from ..train import (_bytes_per_view, init_train_state, make_train_step,
                     validated_tile_k)
from .synthetic import bench_scene

PATHS = ("silhouette", "depth_normal", "texture_dense")


def _step_and_state(path: str, geo, k: int, res: int):
    dev = geo.tet_v.device
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 1500), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(1500,))
    if path == "texture_dense":
        mat = ExplicitMaterial(None, device=dev)
        step = make_train_step(geo.statics, update_fn, resolution=res,
                               tile_k=k, material_fn=mat.apply_fn,
                               tet_v_frozen=geo.tet_v, view_chunk=0)
        return step, init_train_state(mat.params, init_fn)
    dn = path == "depth_normal"
    step = make_train_step(geo.statics, update_fn, resolution=res, tile_k=k,
                           view_chunk=0, fit_depth=dn, fit_normal=dn)
    return step, init_train_state(geo.tet_v, init_fn)


def capacities(geo, batch, res: int) -> list:
    """The scene's validated capacity and the largest the validator
    returns for its faces, next_pow2(F)."""
    k = validated_tile_k(geo, batch, res)
    return sorted({k, next_pow2(int(geo.statics.surface_fid.shape[0]))})


def measure(path: str, geo, batch, res: int, tile_k: int) -> dict:
    """Resident bytes, peak bytes, the peak's excess per view-pixel of two
    unchunked steps of ``path`` on (geo, batch) at capacity ``tile_k``,
    and the rule's bytes per view-pixel there."""
    views = int(batch["mvp"].shape[0])
    torch.cuda.empty_cache()
    step, state = _step_and_state(path, geo, tile_k, res)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for it in range(2):
        state, out = step(state, batch, it)
    float(out[0])
    peak = torch.cuda.max_memory_allocated()
    del step, state, out
    return {"path": path, "views": views, "res": res, "tile_k": tile_k,
            "resident_bytes": resident, "peak_bytes": peak,
            "bytes_per_view_px": (peak - resident) / (views * res * res),
            "rule_bytes_per_view_px": _bytes_per_view(res, tile_k)
            / (res * res)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=120)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--tile-k", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("view_memory needs a CUDA device")
    geo, batch = bench_scene(torch.device("cuda"), args.views, args.res,
                             n_spheres=18)
    for k in args.tile_k or capacities(geo, batch, args.res):
        for path in PATHS:
            print(json.dumps(measure(path, geo, batch, args.res, k)),
                  flush=True)


if __name__ == "__main__":
    main()
