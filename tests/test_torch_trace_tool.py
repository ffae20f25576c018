"""The port's trace reader (tssplat_torch/tools/trace.py top) on the CPU:
its aggregation of a chrome trace's device operations, and the command
``python -m tssplat_torch.tools.trace top DIR`` on a written trace, on a
directory without one and with arguments it refuses."""

import json
import os
import subprocess
import sys

import pytest

from tssplat_torch.tools import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device events (kernel, memset, memcpy) and what top must skip: host
# events and a phase other than complete
EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "vis_kernel", "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "vis_kernel", "dur": 120.0},
    {"ph": "X", "cat": "kernel", "name": "aa_fwd", "dur": 30.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 6.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 4.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 900.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "dur": 50.0},
    {"ph": "i", "cat": "kernel", "name": "vis_kernel", "dur": 999.0},
]


def _write_trace(path):
    path.write_text(json.dumps({"traceEvents": EVENTS}))


def _run(*argv):
    """``python -m tssplat_torch.tools.trace *argv`` from the checkout."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "tssplat_torch.tools.trace", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_trace_top_aggregates_a_chrome_trace(tmp_path, capsys):
    """top sums the kernel, memset and memcpy events of a hand-written
    chrome trace by name, divides by n_steps, skips host events and
    non-complete phases, ranks by time and prints the device ms a step."""
    _write_trace(tmp_path / "trace.json")
    total = trace.top(str(tmp_path), n_steps=2, top_k=2)
    assert total == pytest.approx((220 + 30 + 6 + 4) / 1e3 / 2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[0] == "0.1100" and "x1" in lines[0] \
        and lines[0].endswith("vis_kernel")
    assert lines[1].split()[0] == "0.0150" and lines[1].endswith("aa_fwd")
    assert lines[2].startswith("(top 2 sum: 0.1250 ms/step of 0.1300)")
    rec = json.loads(lines[-1])
    assert rec["metric"] == "trace_device_ms_per_step"
    assert rec["value"] == 0.13 and rec["ops_per_step"] == 2.5
    assert len(lines) == 4


def test_module_top_prints_the_json_line_last(tmp_path):
    """``python -m tssplat_torch.tools.trace top DIR 2`` on the driver's
    file name (trace/trace_<pid>.json) exits 0, and its last stdout line
    is the JSON line of the device ms a step."""
    _write_trace(tmp_path / f"trace_{os.getpid()}.json")
    res = _run("top", str(tmp_path), "2")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 6            # 4 operations, the sum, the JSON line
    rec = json.loads(lines[-1])
    assert rec["metric"] == "trace_device_ms_per_step"
    assert rec["value"] == 0.13 and rec["unit"] == "ms/step"


def test_module_top_without_a_trace_fails_and_prints_no_line(tmp_path):
    """On a directory with no trace the command exits non-zero, says so on
    stderr and prints no JSON line."""
    res = _run("top", str(tmp_path))
    assert res.returncode != 0
    assert res.stdout == ""
    assert f"no trace under {tmp_path}" in res.stderr


@pytest.mark.parametrize("argv", [["capture", "DIR"], ["top"]],
                         ids=["capture", "no_dir"])
def test_module_refuses_other_arguments(argv):
    """Any verb but ``top``, or ``top`` without a directory, exits
    non-zero with the usage line and prints nothing on stdout."""
    res = _run(*argv)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "usage: python -m tssplat_torch.tools.trace top DIR" \
        in res.stderr
