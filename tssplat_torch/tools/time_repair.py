"""Times ``mesh/spheres.py repair_sliver_tets`` of this tree against that
of another tree on one input, in turns (parent, this, this, parent), and
checks that both give the same vertices to the bit.

    python -m tssplat_torch.tools.time_repair --parent build/parent

``--parent`` is another commit unpacked into an ignored directory (only
its ``tssplat_torch/mesh/spheres.py`` is read). The input is the sliver
repair's input of chip_smoke.py phase 12's remesh in kind and size: the
surface of two tet_sphere balls at phase 12's key points (radius 0.39 at
x = -0.45 and 0.45, ``target_edge_length``'s edge) re-tetrahedralised by
``mesh/remesh.py`` at grid_dim 64 and the balls' median tet edge, its
distance queries on ``--device``. The repair itself runs on the host
(numpy, f64). Prints one JSON line per run, then one with the medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np

from ..device import resolve_device


def repair_input(grid_dim: int = 64, device=None) -> dict:
    """(pts, tets, n_fixed, h) that ``tet_remesh_from_surface`` hands the
    sliver repair for phase 12's two balls."""
    from ..geometry.multisphere import target_edge_length
    from ..mesh import remesh
    from ..mesh.spheres import tet_sphere
    from ..mesh.tetmesh import TetMesh

    r = 0.39
    parts = [tet_sphere(target_edge_length(r), radius=r, center=(x, 0, 0))
             for x in (-0.45, 0.45)]
    verts = np.concatenate([p[0] for p in parts])
    tets = np.concatenate([parts[0][1], parts[1][1] + parts[0][0].shape[0]])
    h = float(np.median(np.linalg.norm(verts[tets[:, 0]] - verts[tets[:, 1]],
                                       axis=1)))
    sv, sf = TetMesh(verts, tets).surface_mesh()
    got = {}

    def capture(pts, tets, n_fixed, h):
        got.update(pts=pts, tets=tets, n_fixed=n_fixed, h=h)
        return pts

    saved = remesh.repair_sliver_tets
    remesh.repair_sliver_tets = capture
    try:
        remesh.tet_remesh_from_surface(sv, sf, h, grid_dim=grid_dim,
                                       device=resolve_device(device))
    finally:
        remesh.repair_sliver_tets = saved
    return got


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--grid_dim", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    from ..mesh import spheres

    spec = importlib.util.spec_from_file_location(
        "parent_spheres", args.parent / "tssplat_torch" / "mesh" / "spheres.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)

    inp = repair_input(args.grid_dim, args.device)
    print(json.dumps({"input": {"verts": int(inp["pts"].shape[0]),
                                "tets": int(inp["tets"].shape[0]),
                                "n_fixed": int(inp["n_fixed"]),
                                "h": inp["h"]},
                      "host_cpus": os.cpu_count()}), flush=True)
    secs, outs = {"parent": [], "this": []}, []
    for tree in ("parent", "this", "this", "parent"):
        fn = (parent if tree == "parent" else spheres).repair_sliver_tets
        t0 = time.perf_counter()
        outs.append(fn(inp["pts"], inp["tets"], n_fixed=inp["n_fixed"],
                       h=inp["h"]))
        secs[tree].append(time.perf_counter() - t0)
        print(json.dumps({"tree": tree, "seconds": secs[tree][-1]}),
              flush=True)
    same = all(np.array_equal(o, outs[0]) for o in outs[1:])
    print(json.dumps({"parent_s": float(np.median(secs["parent"])),
                      "this_s": float(np.median(secs["this"])),
                      "bit_equal": same}), flush=True)
    if not same:
        raise SystemExit("repair_sliver_tets: the trees disagree")


if __name__ == "__main__":
    main()
