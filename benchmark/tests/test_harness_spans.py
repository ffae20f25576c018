"""The readers of the program's spans, on a hand-built trace of two steps
whose spans, device gaps and sync calls are known."""

from types import SimpleNamespace

import pytest

from benchmark.manifest import Cell
from benchmark.tracing import Trace

LAYERS = ("loader", "visibility", "binning", "render", "energy", "backward",
          "optim")

# one step's host spans, relative to its start (microseconds); the second
# render is the backward's recompute, on autograd's thread
SPANS = [("tssplat.loader", 10, 30), ("tssplat.step", 40, 480),
         ("tssplat.visibility", 50, 150), ("tssplat.binning", 60, 120),
         ("tssplat.sync.binning", 100, 110), ("tssplat.render", 160, 260),
         ("tssplat.sync.row_gather", 200, 210), ("tssplat.energy", 270, 300),
         ("tssplat.backward", 310, 420), ("tssplat.render", 330, 380),
         ("tssplat.optim", 430, 470), ("tssplat.sync.optim", 440, 445)]
# the device's kernels: the gaps between them start in loader (25-70),
# binning (90-112), visibility (130-140), glue inside the step (155-215),
# render (250-275), energy (290-295), the recompute's render (335-350,
# 360-400), backward (410-435) and optim (440-450, and to the next step)
KERNELS = [(20, 25), (70, 90), (112, 130), (140, 155), (215, 250),
           (275, 290), (295, 335), (350, 360), (400, 410), (435, 440),
           (450, 460)]
# waits: in the harness (5), at the three named sites, and one unnamed (455)
SYNCS = [5, 101, 205, 442, 455]

# per step: gap microseconds by layer over the two steps / 2 / 1e3
EXPECTED = {
    "loader.span_ms_per_step.geometry": 0.020,
    "binning.syncs_per_step.geometry": 1.0,
    "row_gather.syncs_per_step.geometry": 1.0,
    "step.wait_ms_per_step.geometry": 0.025,
    "step.unnamed_syncs_per_step.geometry": 1.0,
    "loader.idle_ms_per_step.geometry": 0.045,
    "visibility.idle_ms_per_step.geometry": 0.010,
    "binning.idle_ms_per_step.geometry": 0.022,
    "render.idle_ms_per_step.geometry": 0.080,
    "energy.idle_ms_per_step.geometry": 0.005,
    "backward.idle_ms_per_step.geometry": 0.025,
    # 10 + 60 (to the next step), then 10 + 40 (to the window's end)
    "optim.idle_ms_per_step.geometry": 0.060,
    # 20 before the first kernel, 60 of glue in each step
    "device.unattributed_idle_ms_per_step.geometry": 0.070,
}


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(spans: bool = True) -> Trace:
    ev = [_x("user_annotation", "bench.window", 0, 1000)]
    for o in (0, 500):
        ev.append(_x("user_annotation", "bench.step", o, 500))
        ev += [_x("kernel", "k", o + a, b - a) for a, b in KERNELS]
        ev += [_x("cuda_runtime", "cudaStreamSynchronize", o + t, 1)
               for t in SYNCS]
        ev += [_x("cuda_runtime", "cudaLaunchKernel", o + a - 3, 2)
               for a, _ in KERNELS]
        if spans:
            ev += [_x("user_annotation", n, o + a, b - a)
                   for n, a, b in SPANS]
    return Trace(ev, 2)


def _read(metric, trace):
    return Cell("gso_geo_120v_dn").reader(metric)(
        SimpleNamespace(trace=trace, steps=trace.steps))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_gives_its_value_and_none_without_spans(metric):
    assert _read(metric, _trace()) == pytest.approx(EXPECTED[metric],
                                                    rel=1e-12)
    assert _read(metric, _trace(spans=False)) is None


def test_the_new_metrics_are_the_manifests():
    cell = Cell("gso_geo_120v_dn")
    assert set(EXPECTED) <= {m["name"] for m in cell.per_layer}
    sil = {m["name"] for m in Cell("gso_geo_120v_sil").per_layer}
    assert set(EXPECTED) - sil == {"row_gather.syncs_per_step.geometry"}


def test_idle_by_layer_sums_to_the_windows_idle_time():
    tr = _trace()
    idle = [_read(f"{layer}.idle_ms_per_step.geometry", tr)
            for layer in LAYERS]
    idle.append(_read("device.unattributed_idle_ms_per_step.geometry", tr))
    window_idle = (tr.window_s - tr.busy_s()) * 1e3 / tr.steps
    share = _read("device.idle_share.geometry", tr)
    assert sum(idle) == pytest.approx(window_idle, rel=1e-12)
    assert sum(idle) == pytest.approx(
        share / 100 * tr.window_s * 1e3 / tr.steps, rel=1e-12)


def test_a_layer_without_spans_reads_none_beside_the_others():
    tr = _trace()
    tr.host = [r for r in tr.host if r[0] != "tssplat.energy"]
    assert _read("energy.idle_ms_per_step.geometry", tr) is None
    # its gap (290-295) goes to the step's glue
    assert _read("device.unattributed_idle_ms_per_step.geometry", tr) == \
        pytest.approx(0.075, rel=1e-12)
