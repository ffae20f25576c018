"""A run whose timed path is broken underneath comes out not correct: a
step that returns its state unchanged, half of the batch left out (the
mean over the rest), and a loss altered where it is produced. The look
for a card is skipped (the CPU rehearsal); the rest of the run is the
benchmark's own."""

import json

import pytest
import torch

from benchmark import program, run
from benchmark.tests.tiny import cells, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _unchanged(monkeypatch):
    orig = program.ProgramRun.iterate

    def iterate(self, it):
        before = self.state
        out = orig(self, it)
        self.state = before
        return out
    monkeypatch.setattr(program.ProgramRun, "iterate", iterate)


def _half_batch(monkeypatch):
    from tssplat_torch.data.loader import ViewDataLoader
    orig = ViewDataLoader.__call__

    def call(self, it, forward_id, rank=None):
        b = orig(self, it, forward_id, rank)
        n = b["mvp"].shape[0] // 2
        return {k: v[:n] if torch.is_tensor(v) and v.dim() else v
                for k, v in b.items()}
    monkeypatch.setattr(ViewDataLoader, "__call__", call)


def _loss_altered(monkeypatch):
    orig = program.ProgramRun.iterate

    def iterate(self, it):
        out = orig(self, it)
        return (out[0] * 1.001,) + tuple(out[1:])
    monkeypatch.setattr(program.ProgramRun, "iterate", iterate)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "loss_altered": _loss_altered}
CASES = [(c, f) for c in cells() for f in FAULTS
         # the exact texture path reads no batch: no half of one to drop
         if not (f == "half_batch" and "tex" in c)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_step_is_not_correct(cell, fault, root, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    rc = run.main(["--workload", cell, "--seed", "31337", "--seconds", "0.2",
                   "--trace", "0"], root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["correct"] is False, line["checks"]
