"""A stand-in for the TetWild executable that ``tetwild_exec`` names: it
takes TetWild's command line (``--input temp{i}.obj --output temp{i}.msh
...``) and writes what the TetWild fork of the reference writes,
``temp{i}.msh_VO.npy`` (vertices, f64) and ``temp{i}.msh_TO.npy`` (tets,
int64). Its tets are scipy's Delaunay of the OBJ's vertices and their
centroid, each turned positive (two indices swapped where the volume is
negative): on a convex template sphere, one tet from the centroid to each
surface triangle. It lets the subprocess path of the multi-sphere geometry
run without a TetWild binary.

    write_tetwild_stub(path)               the working stand-in
    write_tetwild_stub(path, mode="fail")  exits 1 and writes nothing
    write_tetwild_stub(path, mode="no_tets")  writes no _TO.npy

The script's first line names the interpreter that runs this module.
"""

from __future__ import annotations

import os
import sys

MODES = ("ok", "fail", "no_tets")

_BODY = '''
import sys

import numpy as np
from scipy.spatial import Delaunay

MODE = {mode!r}
args = sys.argv[1:]
src = args[args.index("--input") + 1]
out = args[args.index("--output") + 1]
if MODE == "fail":
    sys.exit(1)
with open(src) as fh:
    v = np.asarray([[float(x) for x in line.split()[1:4]] for line in fh
                    if line.startswith("v ")], np.float64)
pts = np.concatenate([v, v.mean(axis=0, keepdims=True)])
tets = Delaunay(pts).simplices.astype(np.int64)
p = pts[tets]
vol = np.einsum("ij,ij->i", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                p[:, 3] - p[:, 0])
tets[vol < 0] = tets[vol < 0][:, [0, 2, 1, 3]]
np.save(out + "_VO.npy", pts)
if MODE != "no_tets":
    np.save(out + "_TO.npy", tets)
'''


def write_tetwild_stub(path: str, mode: str = "ok") -> str:
    """Write the stand-in executable at ``path`` (mode 0o755) and return
    the path. ``mode``: ``ok``, ``fail`` or ``no_tets`` (see above)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    with open(path, "w") as fh:
        fh.write(f"#!{sys.executable}\n" + _BODY.format(mode=mode))
    os.chmod(path, 0o755)
    return path
