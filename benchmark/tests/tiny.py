"""A throwaway checkout root holding the benchmark's data files at a size
the CPU runs in seconds: 2 spheres, 4 views of 64² (the code is the
repository's; only the data is shrunk, and the modules a cell names by
file, metrics, inputs writers and references, are copied beside it so
that a test can add its own)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[2]


def make_root(dst: Path, spheres: int = 2, views: int = 4,
              res: int = 64) -> Path:
    dst = Path(dst)
    (dst / "benchmark").mkdir(parents=True, exist_ok=True)
    for d in ("configs", "traffic", "limits", "metrics", "inputs",
              "reference"):
        shutil.copytree(REPO / "benchmark" / d, dst / "benchmark" / d)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "benchmark" / "configs").glob("*.yaml"):
        c = yaml.safe_load(f.read_text())
        c["assumed"]["spheres"] = spheres
        c["data"]["batch_size"] = views
        f.write_text(yaml.safe_dump(c, sort_keys=False))
    for f in (dst / "benchmark" / "traffic").glob("*.yaml"):
        t = yaml.safe_load(f.read_text())
        t["views"], t["resolution"] = views, res
        f.write_text(yaml.safe_dump(t, sort_keys=False))
    return dst


def cells() -> list:
    return [w["name"] for w in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
