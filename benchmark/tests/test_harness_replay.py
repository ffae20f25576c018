"""The window's work does not depend on its speed: where it would pass the
traffic's ``replay_until`` or the configuration's last iteration, it starts
again from iteration 3's state and does the same steps again."""

import json

import pytest
import torch
import yaml

from benchmark import run
from benchmark.manifest import Cell
from benchmark.tests.tiny import cells, make_root

LAST = 5            # the tiny configurations' total_num_iter


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("root"))
    for f in (root / "benchmark" / "configs").glob("*.yaml"):
        c = yaml.safe_load(f.read_text())
        c["data"]["total_num_iter"] = LAST
        f.write_text(yaml.safe_dump(c, sort_keys=False))
    return root


@pytest.mark.parametrize("cell", cells())
def test_the_replay_repeats_the_same_steps(cell, root, tmp_path):
    c = Cell(cell, root)
    dev = torch.device("cpu")
    prob, overrides = run.make_inputs(c, 77, str(tmp_path), dev)
    prog_run, names = run.build_program(c, prob, overrides, 77, dev)
    run.first_steps(prog_run, names)
    with pytest.raises(ValueError):
        prog_run.iterate(LAST)
    step = run.Replay(prog_run, 3, min(int(c.traffic["replay_until"]),
                                       prog_run.total_iters))
    losses = [float(step()[0]) for _ in range(3 * (LAST - 3))]
    assert step.wraps == 2
    n = LAST - 3
    assert losses[:n] == losses[n:2 * n] == losses[2 * n:]


def test_a_window_past_the_last_iteration(root, capsys):
    # half a second a step at most on the CPU: the window wraps
    rc = run.main(["--workload", cells()[0], "--seed", "4040", "--seconds",
                   "6", "--trace", "0"], root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["attempted"] > LAST - 3
    assert line["diagnostics"]["replays"] == (line["attempted"] - 1) // (LAST - 3)
