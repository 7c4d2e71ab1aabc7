"""The port stands alone, and its entry points default to the card.

An AST scan shows that no file under ``src/repro_torch/`` and no line of
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``; without a
card, the entry points refuse to run unless asked for the CPU.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, make_smoke
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference_package():
    bad = []
    for path in _port_files():
        for lineno, mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{lineno} imports {mod}")
    assert not bad, "\n".join(bad)


def test_import_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.core import knapsack\n"
                     "import jax.numpy as jnp\nfrom .sibling import x\n")
    mods = [m for _, m in _imported_modules(probe)]
    assert mods == ["os", "repro.core", "jax.numpy"]


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_smoke(get_config("qwen1.5-0.5b"), n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg)
    assert ServingEngine(params, cfg, device="cpu").device.type == "cpu"


def test_unported_archs_and_mixers_raise():
    with pytest.raises(KeyError):
        get_config("mixtral-8x7b")
    cfg = make_smoke(get_config("qwen1.5-0.5b"), mixer_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="mamba"):
        init_params(cfg, device="cpu")
    cfg = make_smoke(get_config("granite-moe-1b-a400m"), moe_impl="alltoall")
    with pytest.raises(NotImplementedError, match="alltoall"):
        init_params(cfg, device="cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.data import LMPipeline, TokenTask
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMPipeline(TokenTask(vocab=16), 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())          # nothing ran, nothing written
