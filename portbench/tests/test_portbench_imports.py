"""What the benchmark may load: no module of ``portbench/`` imports JAX
or the JAX package ``repro`` (top-level names compared whole, since the
port's ``repro_torch`` begins with ``repro``), the plain references
import nothing of the port, and nothing reads the JAX package's
``benchmarks/``."""
import ast
from pathlib import Path

import pytest

import smoke  # noqa: F401  (puts the repository root on the path)
from portbench import spec as spec_mod

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec_mod.HERE.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec_mod.HERE)))
def test_no_jax_and_no_reference_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_references_import_nothing_of_the_port():
    refs = sorted((spec_mod.HERE / "reference").glob("*.py"))
    assert refs
    for path in refs:
        tops = set(_imports(path))
        assert "repro_torch" not in tops and not tops & FORBIDDEN, path


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                parts = node.value.replace("\\", "/").split("/")
                assert "benchmarks" not in parts, path


def test_the_run_refuses_whole_forbidden_names_only():
    run = spec_mod.load_module(spec_mod.HERE / "run.py", "portbench_run_entry")
    names = ["repro_torch", "repro_torch.serving", "jaxtyping", "reprox", "numpy"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["repro.core", "jax", "flax.linen"]) == [
        "flax.linen", "jax", "repro.core"]
