"""Nothing under ``ttsbench/`` imports JAX, Flax, Optax or the JAX package
(top-level names compared whole: ``spev_tpu_torch`` is not ``spev_tpu``), and
nothing under ``ttsbench/reference/`` imports the program either."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "spev_tpu"}


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package_import(path):
    roots = set(_roots(path))
    bad = roots & FORBIDDEN
    if path.relative_to(BENCH).parts[0] == "reference":
        bad |= roots & {"spev_tpu_torch"}
    assert not bad, f"{path.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_check_compares_whole_names():
    assert "spev_tpu_torch" not in FORBIDDEN and "spev_tpu_torch".split(".")[0] != "spev_tpu"
