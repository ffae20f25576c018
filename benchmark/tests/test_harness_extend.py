"""A cell, a traffic mix, a configuration, its inputs writer and its
reference, and a per-layer metric are added by new files and new
BENCHMARK.json entries alone."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark import run
from benchmark.calibrate import readings_of
from benchmark.manifest import (DEFAULT_INPUTS, DEFAULT_REFERENCE,
                                Cell)
from benchmark.reference.compare import verdict
from benchmark.tests.tiny import cells, make_root


def test_a_throwaway_cell_runs_from_new_files_only(tmp_path, capsys):
    root = make_root(tmp_path)
    b = root / "benchmark"
    shutil.copy(b / "configs" / "gso_multisphere_geometry.yaml",
                b / "configs" / "new_config.yaml")
    (b / "traffic" / "new_mix.yaml").write_text(
        (b / "traffic" / "sil_120v_512.yaml").read_text()
        .replace("views: 4", "views: 2"))
    shutil.copy(b / "limits" / "gso_geo_120v_sil.yaml",
                b / "limits" / "new_cell.yaml")
    (b / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "new_config", "source": "https://x.org",
                         "file": "benchmark/configs/new_config.yaml",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "new_cell", "config": "new_config",
                           "traffic": "new_mix", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "new.metric", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "step", "moves": "geometry_steps_per_s",
                           "workloads": ["new_cell"]})
    for e in m["end_to_end"]:
        if e["name"] == "geometry_steps_per_s":
            e["workloads"].append("new_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    # batch 2 of the config's views: the traffic's override
    cfg = b / "configs" / "new_config.yaml"
    cfg.write_text(cfg.read_text().replace("batch_size: 4",
                                            "batch_size: 2"))

    cell = Cell("new_cell", root)
    assert cell.traffic["views"] == 2
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert cell.reader("new.metric")(None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"geometry_steps_per_s",
                                                    "setup_s"}
    rc = run.main(["--workload", "new_cell", "--seed", "9", "--seconds",
                   "0.2", "--trace", "0"], root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True


# a configuration that brings its own inputs writer and reference as new
# files: the default writer seen by a ring of cameras, and the default
# reference imported relatively (or a copy of it that leaves a view out)
RING_INPUTS = '''"""The default inputs seen by a ring of cameras round the z axis."""
import math
import os

import numpy as np

from .. import scene
from ..reference.steps import Problem
from .mitsuba_spheres import weights  # noqa: F401


def make(cell, seed, folder, device):
    assumed, n = cell.config["assumed"], int(cell.traffic["views"])
    eyes = np.array([[3.5 * math.cos(a), 3.5 * math.sin(a), 0.5]
                     for a in 2 * math.pi * np.arange(n) / n])
    mv = np.stack([scene._look_at(e, np.zeros(3), np.array([0.0, 0.0, 1.0]))
                   for e in eyes])
    mvp = scene._perspective(39.3077, 1e-3, 10.0) @ mv
    verts, tets, vtx_idx, elem_idx = scene.sphere_mesh(
        assumed, scene.rng_of(seed, 1))
    targets = scene.render_targets(
        assumed, scene.ellipsoid_of(assumed, scene.rng_of(seed, 2)), mvp,
        eyes, int(cell.traffic["resolution"]), False, device)
    scene.write_dataset(os.path.join(folder, "img"), targets, mvp, mv)
    scene.write_sphere_cache(os.path.join(folder, "cache"), verts, tets,
                             vtx_idx, elem_idx)
    prob = Problem(verts=verts, tets=tets, n_spheres=len(vtx_idx),
                   mvp=mvp.astype(np.float32), mv=mv.astype(np.float32),
                   rgba=targets["rgba"], depth=None, normal=None, cfg={})
    return prob, {"data.dataset_config.image_root": os.path.join(folder,
                                                                 "img"),
                  "geometry.tetwild_cache_folder": os.path.join(folder,
                                                                "cache"),
                  "output_path": os.path.join(folder, "out")}
'''
OWN_REFERENCE = '''"""The default reference, imported relatively."""
from .steps import Reference, leaf_names, pair_counts_of  # noqa: F401
'''
WRONG_REFERENCE = '''"""A copy of the default reference that leaves the first view out."""
from . import steps
from .steps import leaf_names, pair_counts_of  # noqa: F401


class Reference(steps.Reference):
    def __init__(self, prob, device, precision="f32"):
        super().__init__(prob, device, precision)
        self.views = self.views[1:]
'''


def _own_cell(root, name: str, inputs: str, reference: str) -> str:
    """Adds the cell ``name`` whose configuration names the inputs writer
    and the reference given as source; returns the cell's name."""
    b = root / "benchmark"
    (b / "inputs").mkdir(exist_ok=True)
    (b / "reference").mkdir(exist_ok=True)
    (b / "inputs" / f"{name}_in.py").write_text(inputs)
    (b / "reference" / f"{name}_ref.py").write_text(reference)
    cfg = yaml.safe_load((b / "configs" / "gso_multisphere_geometry.yaml")
                         .read_text())
    cfg["harness"] = {"inputs": f"{name}_in", "reference": f"{name}_ref"}
    (b / "configs" / f"{name}.yaml").write_text(
        yaml.safe_dump(cfg, sort_keys=False))
    shutil.copy(b / "limits" / "gso_geo_120v_sil.yaml",
                b / "limits" / f"{name}.yaml")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": name, "source": "https://x.org",
                         "file": f"benchmark/configs/{name}.yaml",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": name, "config": name,
                           "traffic": "sil_120v_512", "chips": 1,
                           "why": "test"})
    for e in m["end_to_end"]:
        if e["name"] == "geometry_steps_per_s":
            e["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return name


@pytest.fixture(scope="module")
def own_root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("own"))
    _own_cell(root, "ring", RING_INPUTS, OWN_REFERENCE)
    _own_cell(root, "wrong", RING_INPUTS, WRONG_REFERENCE)
    return root


def _line(root, cell, seed, capsys):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", "0"], root=root, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_configuration_brings_its_own_inputs_and_reference(own_root,
                                                             tmp_path,
                                                             capsys):
    from tssplat_torch.config import load_config

    cell = Cell("ring", own_root)
    assert load_config(str(cell.config_path))["harness"] == {
        "inputs": "ring_in", "reference": "ring_ref"}
    for mod, kind in ((cell.inputs(), "inputs"),
                      (cell.reference(), "reference")):
        assert Path(mod.__file__) == own_root / "benchmark" / kind / (
            f"ring_{'in' if kind == 'inputs' else 'ref'}.py")
    dev = torch.device("cpu")
    ring, _ = run.make_inputs(cell, 5, str(tmp_path / "ring"), dev)
    spiral, _ = run.make_inputs(Cell("gso_geo_120v_sil", own_root), 5,
                                str(tmp_path / "spiral"), dev)
    assert ring.mvp.shape == spiral.mvp.shape
    assert not np.allclose(ring.mvp, spiral.mvp)
    np.testing.assert_array_equal(ring.verts, spiral.verts)
    line = _line(own_root, "ring", 2147483711, capsys)
    assert line["correct"] is True, line["checks"]
    # the limits' readings go through the same reference
    rows = {r["kind"]: r for r in readings_of(cell, 4242, dev, control=True)}
    assert verdict(rows["program"], cell.limits), rows["program"]
    assert not verdict(rows["control_tf32"], cell.limits)
    assert not verdict(rows["fault_half_batch"], cell.limits)


def test_the_named_reference_decides_correct(own_root, capsys):
    line = _line(own_root, "wrong", 2147483711, capsys)
    assert line["correct"] is False, line["checks"]


def _takes_its_modules(c: Cell) -> None:
    """The cell's inputs writer and reference are those its configuration
    names, or the defaults where it names none."""
    block = c.config.get("harness") or {}
    for kind, default, mod in (("inputs", DEFAULT_INPUTS, c.inputs()),
                               ("reference", DEFAULT_REFERENCE,
                                c.reference())):
        assert mod.__name__ == f"benchmark.{kind}.{block.get(kind, default)}"


@pytest.mark.parametrize("cell", [c for c in cells()
                                  if "harness" not in Cell(c).config])
def test_without_a_harness_block_the_defaults(cell):
    c = Cell(cell)
    assert (c.inputs_name, c.reference_name) == ("mitsuba_spheres", "steps")
    _takes_its_modules(c)


def test_cells_with_a_block_beside_cells_without(own_root):
    """A configuration with its own block, added beside the others, leaves
    theirs at the defaults."""
    names = [w["name"] for w in json.loads(
        (own_root / "BENCHMARK.json").read_text())["workloads"]]
    blocks = {n: "harness" in Cell(n, own_root).config for n in names}
    assert blocks["ring"] and blocks["wrong"]
    assert not all(blocks.values())
    for n in names:
        _takes_its_modules(Cell(n, own_root))
