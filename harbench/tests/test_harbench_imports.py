"""Nothing in the benchmark imports JAX, jaxlib, flax or the JAX package (compared by
the top-level name: ``tpuhar_torch`` is another name than ``tpuhar``), and the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from harbench import run

HARBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuhar"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    return sorted(p for p in HARBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(HARBENCH)))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((HARBENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "tpuhar_torch" not in tops and "harbench" not in tops, tops


def test_the_walk_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom jax import numpy\nimport tpuhar.ops as x\nimport tpuhar_torch\n")
    assert {n.split(".")[0] for n in _imports(bad)} & FORBIDDEN == {"jax", "tpuhar"}


def test_the_end_of_run_check_compares_whole_top_level_names():
    assert run.forbidden_modules({"tpuhar_torch": 0, "tpuhar_torch.ops": 0, "torch": 0}) == []
    assert run.forbidden_modules({"jax.numpy": 0, "flax": 0, "tpuhar.ops": 0}) == ["flax", "jax", "tpuhar"]
