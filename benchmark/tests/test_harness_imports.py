"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "tssplat_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "tssplat_torch" not in top_names(path)
    assert "benchmark" not in top_names(path)


def test_the_names_compare_whole():
    assert "tssplat_torch".split(".")[0] != "tssplat_tpu"
    assert top_names(BENCH / "program.py") >= {"torch"}
