"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed from the start of this module to the first timed step): the
inputs from the seed, by the configuration's inputs writer (by default the
spheres' tet mesh, the cameras, the ellipsoid's targets written as the
dataset the program's loader reads, the colour field's weights), the
program's run assembled as its driver assembles it, and its first three
iterations, which warm every shape the window uses and are held against
the configuration's plain reference once the window has closed. The
kernels' build is timed on its own (``build_s``, nought once the checkout
holds them) and is a part of set-up. The window then drives the same run
from iteration 3 for ``--seconds`` and ends on a host read; its rate is
the iterations over the whole window. Where the window would reach the
traffic's ``replay_until`` (or the configuration's last iteration) it
starts again from iteration 3's state, so its work does not depend on its
speed. The garbage collector leaves set-up's heap alone while the window
runs. The card's clocks around the window, the window's rate in each of
its quarters and ``build_s`` go into the result line's ``diagnostics``.
With ``--trace 1`` the window also times the loader and each step, and a
further stretch of the cell's ``trace_steps`` iterations is profiled; the
per-layer metrics are read from those.

The last line on standard output is the JSON result; the numbers compared
with the reference are the last lines on standard error. Without a CUDA
device (or with fewer than the cell asks for) it exits 2 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager, redirect_stdout  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from .manifest import ROOT, Cell, env_dirs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tssplat_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_state() -> dict:
    """The card's clocks (MHz), power draw and limit (W) and temperature
    (C) as nvidia-smi reads them now, or {} without it."""
    keys = ("clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw",
            "power.limit", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        vals = [float(v) for v in out.stdout.splitlines()[0].split(",")]
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return {}
    return dict(zip(keys, vals))


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def make_inputs(cell: Cell, seed: int, folder: str, device):
    """The seed's inputs, written where the program reads them by the
    configuration's inputs writer; returns the reference's Problem
    (without the configuration) and the run's overrides."""
    return cell.inputs().make(cell, seed, folder, device)


def _arg(v) -> str:
    return v if isinstance(v, str) else json.dumps(v)


def build_program(cell: Cell, prob, overrides: dict, seed: int, device):
    """The program's run and the names of its parameter leaves; sets the
    Problem's configuration and, for the texture stage, its weights."""
    from .program import ProgramRun

    import torch

    cfg = cell.resolved_config(overrides)
    prob.cfg = cfg
    weights = None
    if cfg.get("fitting_stage", "geometry") == "texture":
        prob.weights = cell.inputs().weights(cfg["material"], seed, device)
        weights = {k: {n: t.clone() for n, t in v.items()}
                   for k, v in prob.weights.items()}
        names = cell.reference().leaf_names(prob.weights)
    else:
        names = [("tet_v",)]
    args = [f"{k}={_arg(v)}" for k, v in {**cell.overrides(),
                                           **overrides}.items()]
    with redirect_stdout(sys.stderr):
        run = ProgramRun(str(cell.config_path), args, torch.device(device),
                         weights=weights)
    return run, names


def first_steps(run, names, n: int = 3) -> dict:
    """Iterations 0..n-1 through the window's own call; the program's
    losses, its first gradient as the optimizer's first moment holds it,
    and its parameters' change after the n steps, as the reference reports
    them."""
    import torch

    start = [t.detach().clone() for t in run.leaves(run.state.params, names)]
    losses, grads = [], None
    for it in range(n):
        out = run.iterate(it)
        losses.append(out[0].detach().clone())
        if it == 0:
            # the first moment after one step is (1 - b1) g
            grads = [torch.linalg.norm(g / (1.0 - run.b1))
                     for g in run.leaves(run.state.opt_state.g1, names)]
    change = [torch.linalg.norm(p - s) for p, s in
              zip(run.leaves(run.state.params, names), start)]

    def num(t):
        v = float(t)
        return v if math.isfinite(v) else float("inf")
    return {"names": ["/".join(k) for k in names],
            "losses": [num(t) for t in losses],
            "grad_norms": [num(t) for t in grads],
            "change_norms": [num(t) for t in change]}


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Replay:
    """Iterations of ``run`` from ``it0``; where the next would reach
    ``end`` the run's state goes back to what it was at ``it0`` and the
    count starts again there. Every step of a window then does the work of
    one of the same iterations from the same state, however many the
    window holds, and no iteration passes the configuration's last."""

    def __init__(self, run, it0: int, end: int):
        if end <= it0:
            raise ValueError(f"nothing to replay: iterations {it0}..{end}")
        self.run, self.it0, self.end, self.it = run, it0, end, it0
        self.start = _cloned(run.state)
        self.wraps = 0

    def __call__(self):
        if self.it >= self.end:
            self.run.state = _cloned(self.start)
            self.it = self.it0
            self.wraps += 1
        out = self.run.iterate(self.it)
        self.it += 1
        return out


def _cloned(tree):
    from torch.utils._pytree import tree_map
    import torch

    return tree_map(lambda t: t.detach().clone() if torch.is_tensor(t)
                    else t, tree)


@contextmanager
def frozen_heap():
    """What set-up left on the heap frozen out of the garbage collector's
    passes while the window runs."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def window(step, seconds: float, sync, events: bool = False):
    """Steps until ``seconds`` have passed, then a host read of the last
    loss. Returns (outputs, elapsed seconds, step-start CUDA events or
    None, host seconds at each step's start)."""
    import torch

    outs, evs, starts = [], ([] if events else None), []
    sync()
    t0 = time.perf_counter()
    while True:
        starts.append(time.perf_counter() - t0)
        if evs is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs.append(e)
        outs.append(step())
        if time.perf_counter() - t0 >= seconds:
            break
    float(outs[-1][0])
    return outs, time.perf_counter() - t0, evs, starts


def quarter_rates(starts: list, elapsed: float) -> list:
    """Steps started in each quarter of the window, a second."""
    q = elapsed / 4
    counts = [0, 0, 0, 0]
    for t in starts:
        counts[min(int(t / q), 3)] += 1
    return [c / q for c in counts]


def failures(outs) -> int:
    """Steps whose loss is not finite or whose visibility dropped
    candidates."""
    import torch

    loss = torch.stack([o[0].detach().float() for o in outs])
    drop = torch.stack([torch.as_tensor(o[3]).to(loss.device).long()
                        .reshape(()) for o in outs])
    return int(((~torch.isfinite(loss)) | (drop > 0)).sum())


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``device``
    "cpu" rehearses the run on the CPU with the kernels' plain versions and
    reports no metric."""
    import torch

    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = 0.0
    if on_card:
        from .program import build_kernels
        t_build = time.perf_counter()
        build_kernels()
        build_s = time.perf_counter() - t_build
    reference = cell.reference()
    folder = tempfile.mkdtemp(prefix="bench_run_")
    try:
        prob, overrides = make_inputs(cell, seed, folder, dev)
        run, names = build_program(cell, prob, overrides, seed, dev)
        prog = first_steps(run, names)
        sync()
        setup_s = time.perf_counter() - T_START
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        texture = run.texture
        tile_k, view_chunk = run.tile_k, run.view_chunk
        if trace and not texture:
            run.loader_s = []
        step = Replay(run, 3, min(int(cell.traffic.get("replay_until",
                                                       run.total_iters)),
                                  run.total_iters))
        card0 = card_state() if on_card else {}
        with frozen_heap():
            outs, elapsed, evs, starts = window(step, seconds, sync,
                                                events=trace and on_card)
        card1 = card_state() if on_card else {}
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        attempted, failed = len(outs), failures(outs)
        rate = attempted / elapsed
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card
                       else "cpu", "count": cell.chips,
                       "memory_peak_bytes": int(max(setup_peak,
                                                    window_peak))}
        metrics, breakdown = {}, None
        if on_card and not trace:
            for m in cell.end_to_end:
                value = setup_s if m["name"] == "setup_s" else rate
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if on_card and trace:
            from .tracing import record
            step_ms = [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]
            last = {}

            def iterate(i):
                last["out"] = step()

            tr = record(iterate, int(cell.traffic["trace_steps"]),
                        lambda: float(last["out"][0]))
            shaded = bool(cell.traffic.get("depth_normal", False))
            ctx = SimpleNamespace(
                trace=tr, steps=tr.steps, loader_ms=[
                    1e3 * s for s in (run.loader_s or [])],
                step_ms=step_ms, window_peak_bytes=window_peak,
                views=run.n_views, res=run.resolution, faces=run.n_faces,
                shaded=shaded, aa_counts=None if texture else
                reference.pair_counts_of(prob, run.state.params.detach(),
                                         shaded, dev))
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            ops = sorted(tr.totals().items(), key=lambda kv: -kv[1][0])
            breakdown = {"device_ops": [[n, t[0]] for n, t in ops[:10]],
                         "idle_gaps": tr.idle_gaps(10)}
        wraps = step.wraps
        # the program's state goes before the reference runs
        del run, outs, evs, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        from .reference.compare import readings, verdict
        t_ref = time.perf_counter()
        ref = reference.Reference(prob, dev).follow(3)
        print(f"seconds: setup {setup_s:.3f} (build {build_s:.3f}) window "
              f"{elapsed:.3f} reference {time.perf_counter() - t_ref:.3f} "
              f"tile_k {tile_k} view_chunk {view_chunk}", file=sys.stderr)
        values = readings(prog, ref)
        correct = verdict(values, cell.limits)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["diagnostics"] = {
        "build_s": build_s, "replays": wraps,
        "quarter_steps_per_s": quarter_rates(starts, elapsed),
        "card_before": card0, "card_after": card1}
    out["readings"] = {"program": prog, "reference": ref}
    out["checks"] = {k: {"value": values[k], "limit": float(cell.limits[k])}
                     for k in cell.limits}
    return out


def main(argv=None, root: Path = ROOT, device=None) -> int:
    args = parse(argv)
    cell = Cell(args.workload, root)
    if device is None:
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s);"
                  f" torch.cuda.is_available()="
                  f"{torch.cuda.is_available()}, device_count="
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    os.environ.update(env_dirs(root))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
