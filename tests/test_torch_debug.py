"""The port's sanitizers and profiling helpers (tssplat_torch/utils/
debug.py, utils/profiling.py) beside the JAX package's (tests/
test_debug.py): the anomaly gate in the geometry code, the NaN trap at the
op (or kernel wrapper) that makes the first NaN, their scoping to a run,
PrintExecTime's line and trace_profile's trace."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.geometry.tet_geometry import \
    compute_vertex_normals as jax_normals
from tssplat_tpu.mesh.spheres import icosphere

from tssplat_torch.geometry import compute_vertex_normals
from tssplat_torch.mesh.spheres import tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops import raster_kernels as rk
from tssplat_torch.ops.energy import build_energy_ops, smooth_barrier_energy
from tssplat_torch.utils import PrintExecTime, debug, trace_profile

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def anomaly():
    debug.set_anomaly(True)
    yield
    debug.set_anomaly(False)


@pytest.fixture
def trap():
    debug.enable_debug_nans(True)
    yield
    debug.enable_debug_nans(False)


def _sphere(overflow=False):
    v, f = icosphere(1)
    v = torch.tensor(v, dtype=torch.float32)
    if overflow:
        # NaN coordinates are swallowed by the +z fallback (nan > 1e-20 is
        # False); an overflow passes the guard and NaNs at normalization
        v[0] = 1e38
    return v, torch.tensor(f, dtype=torch.int64)


def test_anomaly_gate_catches_nonfinite_normals(anomaly):
    v, f = _sphere(overflow=True)
    with pytest.raises(RuntimeError, match="non-finite vertex_normals"):
        compute_vertex_normals(v, f)


def test_anomaly_gate_passes_finite_normals(anomaly):
    """Finite input passes the gate, and the normals are JAX's."""
    v, f = _sphere()
    n = compute_vertex_normals(v, f)
    want = np.asarray(jax_normals(jnp.asarray(v.numpy()),
                                  jnp.asarray(f.numpy())))
    np.testing.assert_allclose(n.numpy(), want, atol=1e-6)


def test_anomaly_off_is_a_no_op(monkeypatch):
    """Off, a site reads nothing: no isfinite, no sync; the NaNs pass."""
    assert not debug.anomaly_enabled()

    def boom(*a, **k):
        raise AssertionError("check_finite ran with anomaly off")

    monkeypatch.setattr(torch, "isfinite", boom)
    v, f = _sphere(overflow=True)
    n = compute_vertex_normals(v, f)
    assert bool(torch.isnan(n).any())


def test_torch_anomaly_mode_turns_the_gate_on():
    """The gate also follows torch.autograd.set_detect_anomaly, which the
    reference gates on."""
    v, f = _sphere(overflow=True)
    with torch.autograd.set_detect_anomaly(True):
        assert debug.anomaly_enabled()
        with pytest.raises(RuntimeError, match="non-finite vertex_normals"):
            compute_vertex_normals(v, f)
    assert not debug.anomaly_enabled()


@pytest.mark.parametrize("value, want", [("1", True), ("0", False),
                                         ("", False)])
def test_env_switch(value, want):
    """TSSPLAT_ANOMALY turns anomaly mode on at import."""
    env = dict(os.environ, PYTHONPATH=REPO, TSSPLAT_ANOMALY=value)
    res = subprocess.run(
        [sys.executable, "-c", "from tssplat_torch.utils import debug; "
         "print(debug.anomaly_enabled())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(want)


@pytest.fixture(scope="module")
def energy_ops():
    tv, tt = tet_sphere(0.55, radius=1.0)
    return tv, build_energy_ops(TetMesh(tv, tt), "cpu")


def test_nan_trap_catches_the_energy(energy_ops):
    """A NaN planted in the vertices (before the trap is on) is trapped at
    the first op that outputs it (the vertex gather), named; clean input
    runs forward and backward under the trap."""
    tv, ops = energy_ops
    bad = torch.tensor(tv, dtype=torch.float32)
    bad[0, 0] = float("nan")
    x = torch.tensor(tv, dtype=torch.float32, requires_grad=True)
    debug.enable_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) "
                           r"encountered in aten\.index"):
            smooth_barrier_energy(bad, ops, 2e-4, 2e-4, 2)
        e = smooth_barrier_energy(x, ops, 2e-4, 2e-4, 2)
        e.backward()
    finally:
        debug.enable_debug_nans(False)
    assert bool(torch.isfinite(x.grad).all())


def _aa_inputs():
    """K4/K5/K3 inputs of a small silhouette: the plain visibility of an
    icosphere in one view."""
    from tssplat_torch.ops.binning import bin_faces
    from tssplat_torch.ops.transform import fibonacci_views, transform_pos
    from tssplat_torch.mesh.surface import triangle_edge_neighbors
    sv, sf = icosphere(2)
    mvp, _, _ = fibonacci_views(1)
    corner = torch.tensor((sv * 0.3)[sf.reshape(-1)], dtype=torch.float32)
    pos = transform_pos(torch.tensor(mvp, dtype=torch.float32), corner)
    nbrs = torch.tensor(triangle_edge_neighbors(sf))
    bins = bin_faces(pos, nbrs, (32, 32))
    return rk.visibility(bins, (32, 32)), sf.shape[0]


@pytest.mark.parametrize("kernel", ["aa_forward", "aa_backward",
                                    "wsr_table_grad"])
def test_nan_trap_catches_a_kernel_wrapper(kernel):
    """A NaN planted in a kernel's input (before the trap is on) is trapped
    inside the wrapper, whose plain version runs on the CPU, at the op that
    makes it, named; without the trap the call runs (K3 sums the NaN into
    its face's row; K4 and K5's pair tests are false on a NaN, so it leaves
    no trace in their outputs, while the trap stops at the first
    intermediate NaN, as JAX's debug_nans does op by op)."""
    (ids, z, g6, gaux), F = _aa_inputs()
    # a foreground pixel whose right neighbour is background: a silhouette
    # pair reads its rows
    fg = torch.nonzero((ids[0, :, :-1] > 0) & (ids[0, :, 1:] == 0))[0]
    g6 = g6.clone()
    g6[0, :, fg[0], fg[1]] = float("nan")
    ct = torch.ones_like(z)
    ct6 = torch.zeros_like(g6)
    ct6[0, :, fg[0], fg[1]] = float("nan")

    def run():
        if kernel == "aa_forward":
            return rk.aa_forward(ids, z, g6, gaux)
        if kernel == "aa_backward":
            return rk.aa_backward(ids, z, g6, gaux, ct)
        return rk.wsr_table_grad(ids, ct6, F)

    out = run()
    assert bool(torch.isnan(out).any()) == (kernel == "wsr_table_grad")
    debug.enable_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError,
                           match=r"encountered in aten\."):
            run()
    finally:
        debug.enable_debug_nans(False)


def test_kernel_output_check():
    """check_kernel_outputs, the wrappers' own check on the card (where a
    ctypes launch is not seen by the trap): it raises, naming the kernel,
    only under the trap and only for a NaN in a floating output."""
    nan = torch.tensor([1.0, float("nan")])
    debug.check_kernel_outputs("aa_forward", nan)          # trap off
    debug.enable_debug_nans(True)
    try:
        debug.check_kernel_outputs("aa_forward", torch.ones(2),
                                   torch.zeros(2, dtype=torch.int32), None)
        with pytest.raises(FloatingPointError,
                           match="encountered in kernel aa_forward"):
            debug.check_kernel_outputs("aa_forward", torch.ones(2), nan)
    finally:
        debug.enable_debug_nans(False)


def test_trap_ignores_unwritten_memory(trap):
    """torch.empty's bits are not data: the kernel wrappers allocate their
    outputs with it under the trap."""
    for _ in range(4):
        torch.empty(4096).fill_(1.0)
    torch.empty_like(torch.ones(64))
    torch.ones(3).new_empty(5)


@pytest.mark.parametrize("raise_inside", [False, True])
def test_sanitizers_restore_the_settings(raise_inside):
    """sanitizers() turns both on inside the block and restores what was
    there before, also when the block raises."""
    assert not debug.anomaly_enabled() and not debug.debug_nans_enabled()
    with pytest.raises(KeyError) if raise_inside else _null():
        with debug.sanitizers(debug_nans=True, anomaly=True):
            assert debug.anomaly_enabled() and debug.debug_nans_enabled()
            if raise_inside:
                raise KeyError("inside")
    assert not debug.anomaly_enabled() and not debug.debug_nans_enabled()
    debug.set_anomaly(True)
    try:
        with debug.sanitizers(debug_nans=False, anomaly=False):
            assert debug.anomaly_enabled()
        assert debug.anomaly_enabled()
    finally:
        debug.set_anomaly(False)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_print_exec_time(capsys):
    """The same printout as the JAX package's: '[name] <ms> ms'; none when
    disabled, and the seconds kept in elapsed."""
    with PrintExecTime("block a") as t:
        sum(range(1000))
    out = capsys.readouterr().out
    assert out.startswith("[block a] ") and out.endswith(" ms\n")
    assert t.elapsed >= 0
    with PrintExecTime("quiet", enabled=False) as t:
        pass
    assert capsys.readouterr().out == "" and t.elapsed >= 0


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    """trace_profile writes a Chrome trace of the block's ops to log_dir;
    disabled, it writes nothing."""
    with trace_profile(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with trace_profile(str(tmp_path / "on")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "on")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "on" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
