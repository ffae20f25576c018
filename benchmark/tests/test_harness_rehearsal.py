"""Every cell's harness path end to end at a tiny size on the CPU (the
kernels' plain versions): the last line parses to the contract's keys and
the run is correct; without a card the measuring path reports no device
metric, and the command refuses to run at all."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.tiny import REPO, cells, make_root

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", cells())
def test_cell_rehearses_on_the_cpu(cell, root, capsys):
    rc = run.main(["--workload", cell, "--seed", "2147483711", "--seconds",
                   "0.5", "--trace", "0"], root=root, device="cpu")
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # no card: no device metric is reported
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_the_command_refuses_without_a_card(root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cells()[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_the_command_fails_beside_the_benchmark_alone(tmp_path):
    # a directory holding BENCHMARK.json and benchmark/ only: no program
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c",
                        "import sys; from benchmark import run; "
                        "sys.exit(run.main(device='cpu'))", "--workload",
                        cells()[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.cuda
def test_a_traced_run_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cells()[0], "--seed", "5", "--seconds", "3",
                        "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and line["correct"] is True
    assert line["device"]["busy_s"] > 0 and line["metrics"]
