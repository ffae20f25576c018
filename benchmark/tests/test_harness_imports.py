"""No module of the benchmark imports JAX or the JAX package, and neither
the reference, the inputs writers nor their shared helpers import anything
of the port or of the harness around them: each import, relative ones
resolved against the module's package, is compared by whole names (the
port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path, root: Path = BENCH.parent) -> set:
    """The full names of the modules ``path`` imports, relative imports
    resolved against its package under ``root``."""
    package = list(path.relative_to(root).parts[:-1])
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - (node.level - 1)]
            if node.module:
                names.add(".".join(base + node.module.split(".")))
            else:
                names |= {".".join(base + [a.name]) for a in node.names}
    return names


def top_names(path: Path) -> set:
    return {n.split(".")[0] for n in imported(path)}


def outside(names: set, allowed: tuple) -> set:
    """The names of the port, or of the harness outside ``allowed`` (full
    names, or packages ending in ``.``)."""
    return {n for n in names if n.split(".")[0] == "tssplat_torch"
            or (n.split(".")[0] == "benchmark"
                and not any(n == a or (a.endswith(".") and n.startswith(a))
                            for a in allowed))}


REFERENCE_MAY = ("benchmark.reference", "benchmark.reference.")
INPUTS_MAY = ("benchmark.scene", "benchmark.inputs", "benchmark.inputs.",
              *REFERENCE_MAY)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "tssplat_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not outside(imported(path), REFERENCE_MAY)


@pytest.mark.parametrize("path", sorted((BENCH / "inputs").rglob("*.py")),
                         ids=lambda p: p.name)
def test_inputs_import_nothing_of_the_port(path):
    assert not outside(imported(path), INPUTS_MAY)


def test_scene_imports_nothing_of_the_port():
    assert not outside(imported(BENCH / "scene.py"), ())


def test_relative_imports_are_resolved(tmp_path):
    """A writer that reaches the program or the run relatively is caught;
    one that takes the shared helpers is not."""
    f = tmp_path / "benchmark" / "inputs" / "w.py"
    f.parent.mkdir(parents=True)
    f.write_text("from ..program import ProgramRun\nfrom .. import run\n"
                 "from .. import scene\nfrom ..reference.steps import "
                 "Problem\nfrom . import mitsuba_spheres\n")
    names = imported(f, tmp_path)
    assert names == {"benchmark.program", "benchmark.run", "benchmark.scene",
                     "benchmark.reference.steps",
                     "benchmark.inputs.mitsuba_spheres"}
    assert outside(names, INPUTS_MAY) == {"benchmark.program",
                                          "benchmark.run"}
    g = tmp_path / "benchmark" / "reference" / "__init__.py"
    g.parent.mkdir()
    g.write_text("from . import steps\nfrom .. import scene\n")
    assert outside(imported(g, tmp_path), REFERENCE_MAY) == {
        "benchmark.scene"}


def test_the_names_compare_whole():
    assert "tssplat_torch".split(".")[0] != "tssplat_tpu"
    assert top_names(BENCH / "program.py") >= {"torch"}
