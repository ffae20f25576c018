"""Finding a cell's parts by the names in ``BENCHMARK.json``.

  BENCHMARK.json                      the cells, configurations, metrics
  benchmark/configs/<config>.yaml     a configuration as it is run (the
                                      entry's ``file``)
  benchmark/traffic/<traffic>.yaml    a traffic mix: views, resolution,
                                      targets, configuration overrides,
                                      traced steps
  benchmark/limits/<cell>.yaml        the limits of the numbers that decide
                                      ``correct``
  benchmark/metrics/<metric>.py       a per-layer metric's reader
  benchmark/inputs/<name>.py          a configuration's inputs writer: the
                                      seed's dataset and mesh, written
                                      where the program reads them
                                      (``make``), and the colour field's
                                      weights (``weights``)
  benchmark/reference/<name>.py       a configuration's plain reference
                                      (``Reference``, ``leaf_names``,
                                      ``pair_counts_of``)

A configuration names its inputs writer and its reference in a block of
its own, ``harness: {inputs: <name>, reference: <name>}``; without it
they are ``mitsuba_spheres`` and ``steps``. A cell, configuration,
traffic mix, inputs writer, reference or metric is added by adding its
files and its entries; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_INPUTS = "mitsuba_spheres"
DEFAULT_REFERENCE = "steps"


def _read_yaml(path: Path) -> dict:
    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def _get(tree: dict, dotted: str):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def resolve(node, root=None):
    """``${a.b}`` interpolations of a loaded YAML tree, the whole string
    taking the value's type, a part of one its text."""
    root = node if root is None else root
    if isinstance(node, dict):
        return {k: resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve(v, root) for v in node]
    if isinstance(node, str):
        m = re.fullmatch(r"\$\{([^}]+)\}", node)
        if m:
            return resolve(_get(root, m.group(1)), root)
        return re.sub(r"\$\{([^}]+)\}",
                      lambda g: str(resolve(_get(root, g.group(1)), root)),
                      node)
    return node


def set_dotted(tree: dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


class Cell:
    """One cell of the manifest under ``root`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        self.root = root
        with open(root / "BENCHMARK.json") as fh:
            self.manifest = json.load(fh)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                           f" (has {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config_path = root / self.config_entry["file"]
        self.config = _read_yaml(self.config_path)
        harness = self.config.get("harness") or {}
        self.inputs_name = harness.get("inputs", DEFAULT_INPUTS)
        self.reference_name = harness.get("reference", DEFAULT_REFERENCE)
        bench = root / "benchmark"
        self.traffic = _read_yaml(bench / "traffic"
                                  / f"{self.workload['traffic']}.yaml")
        self.limits = _read_yaml(bench / "limits" / f"{name}.yaml")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in self.manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]

    def overrides(self) -> dict:
        """The traffic's configuration overrides, {dotted key: value}."""
        return dict(self.traffic.get("overrides") or {})

    def resolved_config(self, run_overrides: dict) -> dict:
        """The configuration with the traffic's and the run's overrides,
        interpolations resolved, as plain data."""
        cfg = json.loads(json.dumps(self.config))
        for k, v in {**self.overrides(), **run_overrides}.items():
            set_dotted(cfg, k, v)
        return resolve(cfg)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
        return load("metrics", metric, self.root).read

    def inputs(self):
        """The configuration's inputs writer, ``benchmark/inputs/<name>.py``
        (``benchmark/inputs/__init__.py`` states what it provides)."""
        return load("inputs", self.inputs_name, self.root)

    def reference(self):
        """The configuration's plain reference, ``benchmark/reference/
        <name>.py`` (``benchmark/reference/__init__.py`` states what it
        provides)."""
        return load("reference", self.reference_name, self.root)


def load(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` under ``root`` as the module
    ``benchmark.<kind>.<name>``, each character of the name that Python's
    names lack as ``_``, so that it imports the package's modules
    relatively. It is loaded once a process: the first root to ask for a
    name serves it, and a module the package already imported is that
    module."""
    full = f"{__package__}.{kind}." + re.sub(r"\W", "_", name)
    if full not in sys.modules:
        path = Path(root) / "benchmark" / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
    return sys.modules[full]


def env_dirs(root: Path = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = Path(root) / "build" / "bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}

