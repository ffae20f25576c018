"""Build and load the hand-written CUDA kernels (``tssplat_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>_<hash>.so

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them (a contracted edge function flips
winner ids at pixels on an edge); fast-math is never used. Libraries build
at first CUDA use into ``build/kernels/`` at the repository root, all
missing sources at once in parallel, named by a hash of the sources and
flags so an edited source is rebuilt. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# kernel library name -> source file in csrc/
SOURCES = {
    "vis": "vis.cu",
    "vis_capped": "vis_capped.cu",
    "wsr_grad": "wsr_grad.cu",
    "aa_fwd": "aa_fwd.cu",
    "aa_bwd": "aa_bwd.cu",
    "shade": "shade.cu",
    "interp": "interp.cu",
    "winner_rows": "winner_rows.cu",
    "hash_grid": "hash_grid.cu",
    "aa_l1": "aa_l1.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

# C entry points: name -> (library, argument types); all return cudaError_t
SIGNATURES = {
    "tss_vis_launch": ("vis", [_VOID] * 4 + [_INT] * 9 + [_VOID] * 5),
    "tss_vis_capped_launch": ("vis_capped",
                              [_VOID] * 3 + [_INT] * 7 + [_VOID] * 3),
    "tss_vis_capped_g_launch": ("vis_capped",
                                [_VOID] * 3 + [_INT] * 7 + [_VOID] * 5),
    "tss_wsr_grad_launch": ("wsr_grad", [_VOID] * 2 + [_INT] * 4 + [_VOID] * 2),
    "tss_aa_fwd_launch": ("aa_fwd", [_VOID] * 4 + [_INT] * 5 + [_VOID] * 2),
    "tss_aa_bwd_launch": ("aa_bwd", [_VOID] * 5 + [_INT] * 5 + [_VOID] * 2),
    "tss_shade_launch": ("shade", [_VOID] * 2 + [_INT] * 6 + [_VOID] * 2),
    "tss_shade_grad_launch": ("shade", [_VOID] * 3 + [_INT] * 6 + [_VOID] * 2),
    "tss_interp_launch": ("interp", [_VOID] * 2 + [_INT] * 6 + [_VOID] * 2),
    "tss_interp_grad_launch": ("interp",
                               [_VOID] * 3 + [_INT] * 6 + [_VOID] * 3),
    "tss_winner_rows_launch": ("winner_rows",
                               [_VOID] * 3 + [_INT] * 4 + [_VOID] * 5),
    "tss_hash_grid_launch": ("hash_grid",
                             [_VOID] * 2 + [_INT] * 4 + [_VOID] * 3),
    "tss_hash_grid_grad_launch": ("hash_grid",
                                  [_VOID] * 3 + [_INT] * 4 + [_VOID] * 4),
    "tss_aa_l1_launch": ("aa_l1", [_VOID] * 6 + [_INT] * 3 + [_VOID] * 5),
    "tss_aa_l1_grad_launch": ("aa_l1",
                              [_VOID] * 5 + [_INT] * 3 + [_VOID] * 2),
}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Build output of kernel ``name``, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def compile_all(jobs: Dict[str, Tuple[List[str], Path]]) -> Dict[str, str]:
    """Run the compile commands ``{name: (command, output)}`` all at once;
    each command's ``-o`` target is a temporary beside its output, renamed
    into place when the command succeeds. Returns ``{name: its log}``;
    raises with every failed command's log."""
    procs = {}
    for n, (cmd, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.Popen([*cmd, "-o", str(tmp)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"build of {n} failed: {e}") from e
        procs[n] = (proc, tmp, out)
    reports, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: {proc.args[0]} exited {proc.returncode}"
                          f"\n{log}")
            continue
        os.replace(tmp, out)         # atomic: a concurrent loader sees all
        reports[n] = log
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return reports


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns ``{name: ptxas report}`` for what was built
    (resource usage per kernel, from ``-Xptxas -v``); raises on failure."""
    names = list(SOURCES if names is None else names)
    nvcc = nvcc_path()
    return compile_all({
        n: ([nvcc, *NVCC_FLAGS, str(CSRC / SOURCES[n])], library_path(n))
        for n in names if not library_path(n).exists()})


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def entry(fn_name: str):
    """The typed ctypes function ``fn_name`` (building its library first)."""
    lib_name, argtypes = SIGNATURES[fn_name]
    fn = getattr(_library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn

