"""The readings the limits of ``benchmark/limits/<cell>.yaml`` are set
from; the benchmark's own runs never run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e]

For every seed: set-up as a run makes it, the program's first three
iterations, then the configuration's plain reference, and the numbers
that decide ``correct`` (the lower readings). For every control seed besides: the
reference computed with TF32 matrix products in the program's place (the
control), and the reference over half of the views, the mean taken over
them (a fault a step can have), each held against the reference. A step
that returns its state unchanged reads 1 by the change gap and needs no
run. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile

import numpy as np

from .manifest import ROOT, Cell
from .run import build_program, first_steps, make_inputs


def readings_of(cell: Cell, seed: int, device, control: bool) -> list:
    import torch

    from .reference.compare import readings

    Reference = cell.reference().Reference
    folder = tempfile.mkdtemp(prefix="bench_cal_")
    try:
        prob, overrides = make_inputs(cell, seed, folder, device)
        run, names = build_program(cell, prob, overrides, seed, device)
        prog = first_steps(run, names)
        del run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = Reference(prob, device).follow(3)
        out = [{"seed": seed, "kind": "program",
                **readings(prog, ref)}]
        if control:
            tf = Reference(prob, device, precision="tf32").follow(3)
            out.append({"seed": seed, "kind": "control_tf32",
                        **readings(tf, ref)})
            prob.views = np.arange(prob.mvp.shape[0] // 2)
            half = Reference(prob, device).follow(3)
            out.append({"seed": seed, "kind": "fault_half_batch",
                        **readings(half, ref)})
        return out
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def main(argv=None, root=ROOT, device=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    cell = Cell(a.workload, root)
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    for s in [int(s) for s in a.seeds.split(",")]:
        for row in readings_of(cell, s, dev, s in controls):
            print(json.dumps({"workload": cell.name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
