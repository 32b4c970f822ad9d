"""The benchmark stands apart: no module under cfbench/ imports JAX or the
JAX package (top-level names compared whole, so ``repro_torch`` is not
``repro``), the reference imports nothing of the port, and no module reads
the JAX-era ``benchmarks/`` folder."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_reference_package(path):
    assert not set(roots(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(roots(path)), path


@pytest.mark.parametrize("path", [p for p in MODULES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_era_benchmark_is_read(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "BENCH_" not in text, path


@pytest.mark.parametrize("line,flagged", [
    ("import repro_torch.core.facade", False),
    ("from repro_torch import obs", False),
    ("import repro.core", True),
    ("from jax import numpy", True),
    ("import importlib; importlib.import_module('flax.linen')", True)])
def test_names_are_compared_whole(tmp_path, line, flagged):
    probe = tmp_path / "probe.py"
    probe.write_text(line + "\n")
    assert bool(set(roots(probe)) & FORBIDDEN) == flagged


def test_forbidden_modules_by_whole_name(monkeypatch):
    """``run.py`` checks ``sys.modules`` once the window has closed: a
    module named like the port is not the JAX package."""
    import sys
    from cfbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert "jaxlib" in harness.forbidden_modules()
