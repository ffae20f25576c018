"""A cell, a traffic mix, a configuration and a per-layer metric are added
by new files and new BENCHMARK.json entries alone."""

import json
import shutil

from benchmark import run
from benchmark.manifest import Cell
from benchmark.tests.tiny import make_root


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
