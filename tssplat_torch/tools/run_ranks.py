"""Start W rank processes, each under a deadline, and collect their results.

    run_ranks("package.module:function", {"arg": ...}, world_size=2,
              timeout=300)

starts W processes with RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR (127.0.0.1) and MASTER_PORT (a free port of the OS) set, as
``torchrun`` does on one host; each runs ``function(**kwargs)`` inside a
process group (``utils/env.py init_distributed``, collectives timing out
after 60 s), and the call returns each rank's JSON-serialisable result,
rank 0 first. When one rank fails or the deadline passes, every rank's
process group is killed and the call raises with the end of each rank's
output: a rank that hangs cannot hang the caller. ``train_rank`` is the
job the tests and ``chip_smoke.py`` run: ``train()`` on each rank,
reporting what the ranks are compared on.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on the local host that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def launch(cmd: Sequence[str], world_size: int, timeout: float,
           log_dir: Path, env: Optional[dict] = None,
           cwd: Optional[str] = None) -> None:
    """Run ``cmd`` as ranks 0 .. world_size - 1 (each in its own process
    group, its output in ``log_dir/rank<r>.log``) and wait for all of them.
    Raises RuntimeError when a rank exits other than 0 and TimeoutError
    after ``timeout`` seconds; either way every rank is killed first."""
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in base.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    base.update(WORLD_SIZE=str(world_size), LOCAL_WORLD_SIZE=str(world_size),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs, logs = [], []
    try:
        for r in range(world_size):
            logs.append(log_dir / f"rank{r}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    list(cmd), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                _kill(procs)
                what = (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                        if bad else f"the ranks ran past {timeout:.0f} s")
                err = RuntimeError if bad else TimeoutError
                raise err(what + "; every rank killed\n" + "\n".join(
                    f"--- rank {r} ---\n{_tail(lg)}"
                    for r, lg in enumerate(logs)))
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited "
                               f"{procs[bad[0]].returncode}\n"
                               + _tail(logs[bad[0]]))
    finally:
        _kill(procs)


def run_ranks(target: str, kwargs: Optional[dict] = None,
              world_size: int = 2, timeout: float = 300.0,
              device: Optional[str] = None,
              env: Optional[dict] = None) -> List[dict]:
    """``target`` ("module:function") called with ``kwargs`` on each of
    ``world_size`` ranks inside a process group on ``device`` (each rank's
    card unless given, ``utils/env.py rank_device``); returns the ranks'
    results. Raises as ``launch`` does."""
    with tempfile.TemporaryDirectory(prefix="tss_ranks_") as tmp:
        tmp = Path(tmp)
        spec = tmp / "spec.json"
        spec.write_text(json.dumps(dict(target=target, kwargs=kwargs or {},
                                        device=device, out=str(tmp))))
        launch([sys.executable, "-m", "tssplat_torch.tools.run_ranks",
                "--worker", str(spec)], world_size, timeout, tmp, env=env)
        return [json.loads((tmp / f"result{r}.json").read_text())
                for r in range(world_size)]


def _worker(spec_path: str) -> None:
    """One rank of ``run_ranks``: join the group, run the job, write its
    result."""
    import torch
    import torch.distributed as dist

    from ..utils.env import get_rank, init_distributed

    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    init_distributed(timeout=datetime.timedelta(seconds=60),
                     device=spec["device"])
    module, _, fn = spec["target"].partition(":")
    result = getattr(importlib.import_module(module), fn)(**spec["kwargs"])
    Path(spec["out"], f"result{get_rank()}.json").write_text(
        json.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()


def train_rank(out: str, argv: Optional[List[str]] = None,
               cfg: Optional[dict] = None,
               device: Optional[str] = None) -> dict:
    """``train.main(argv)`` or ``train.train(cfg)`` on this rank's device
    (``device``, else the rank's card); the final parameters are saved to
    ``out/params_rank<r>.pt``. Returns the rank's per-step (loss,
    img_loss, reg, n_drop), best loss and iteration, kernel launches, peak
    device memory (0 on the CPU), seconds and the parameters' path."""
    import torch

    import tssplat_torch.train as tt
    from ..ops import raster_kernels as rk
    from ..utils.env import get_rank, rank_device

    dev = rank_device(device)
    steps = []
    make_step = tt.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def recorded(state, batch, it):
            state, out_ = step(state, batch, it)
            steps.append([float(out_[0]), float(out_[1]), float(out_[2]),
                          int(out_[3])])
            return state, out_
        return recorded

    tt.make_train_step = recording
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        if argv is not None:
            state, _ = tt.main(argv, device=dev)
        else:
            from ..config import ConfigDict
            state, _ = tt.train(ConfigDict(cfg), device=dev)
    finally:
        tt.make_train_step = make_step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"params_rank{get_rank()}.pt")
    torch.save(state.params, path)
    return dict(steps=steps, best_loss=float(state.best_loss),
                best_iter=int(state.best_iter), launches=rk.launch_counts(),
                peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else 0.0),
                seconds=secs, params=path)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="one rank of run_ranks")
    p.add_argument("--worker", required=True, help="the job's spec (JSON)")
    _worker(p.parse_args().worker)
