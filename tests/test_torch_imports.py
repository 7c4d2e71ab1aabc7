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
from repro_torch.models import init_caches, init_params
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
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _port_files()[:-1]}
    assert {"models/cnn.py", "data/synthetic.py", "core/resource_model.py",
            "paper/fpga_repro.py", "paper/table2_jets.py", "paper/table3_svhn.py",
            "paper/table5_lenet.py", "paper/__main__.py", "paper/quickstart.py",
            "paper/prune_jets.py", "models/mamba.py", "models/xlstm.py",
            "configs/jamba_v0_1_52b.py", "configs/xlstm_350m.py",
            "configs/whisper_tiny.py", "configs/qwen2_vl_2b.py",
            "configs/mixtral_8x7b.py", "configs/command_r_plus_104b.py",
            "distributed/__init__.py", "distributed/sharding.py",
            "distributed/spawn.py", "models/moe_alltoall.py",
            "optim/compression.py", "launch/mesh.py",
            "analysis/__init__.py", "analysis/__main__.py", "analysis/lint.py",
            "analysis/runtime.py", "analysis/rules/__init__.py",
            "analysis/rules/host_sync.py", "analysis/rules/prng.py",
            "analysis/rules/recompile.py", "analysis/rules/kernels.py",
            "paper/serve_pruned.py", "paper/train_lm_pruned.py"} <= scanned
    for path in _port_files():
        for lineno, mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{lineno} imports {mod}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("module", ["models/mamba.py", "models/xlstm.py"])
def test_recurrent_modules_import_neither_jax_nor_reference(module):
    path = ROOT / "src" / "repro_torch" / module
    mods = [m for _, m in _imported_modules(path)]
    assert "torch" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


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
    from repro_torch.launch import serve
    whisper = make_smoke(get_config("whisper-tiny"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(whisper, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "whisper-tiny", "--smoke", "--pruned", "0.75"])


def test_unported_archs_and_mixers_raise():
    """Nothing of the model stack raises any more.  The zero mixer
    ("none") matches the reference's ``lm_forward`` and ``lm_decode`` on
    bridged params; granite with ``moe_impl="alltoall"`` builds and, with
    no mesh installed, runs ``moe_apply`` (as the reference does); M-RoPE,
    encoder-decoder stacks, logit softcap, every registered arch and the
    recurrent and hybrid archs build on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config as jget_config
    from repro.configs import make_smoke as jmake_smoke
    from repro.models import init_caches as jinit_caches
    from repro.models import init_params as jinit_params
    from repro.models import lm_decode as jlm_decode
    from repro.models import lm_forward as jlm_forward
    from repro_torch.bridge import params_from_reference
    from repro_torch.models import lm_decode, lm_forward
    from repro_torch.models.moe import moe_apply

    qwen = make_smoke(get_config("qwen1.5-0.5b"))
    none = qwen.replace(mixer_pattern=("none",))
    jnone = jmake_smoke(jget_config("qwen1.5-0.5b")).replace(mixer_pattern=("none",))
    jparams = jinit_params(jax.random.PRNGKey(0), jnone)
    params = params_from_reference(jparams, "cpu")
    assert all(set(lp) == {"pre_norm", "post_norm", "mlp"} for lp in params["layers"])
    tokens = np.random.default_rng(0).integers(0, none.vocab, size=(2, 6))
    want, _ = jlm_forward(jparams, {"tokens": jnp.asarray(tokens)}, jnone)
    with torch.no_grad():
        got, _ = lm_forward(params, {"tokens": torch.from_numpy(tokens)}, none)
        caches = init_caches(none, 2, 8, torch.float32, "cpu")
        assert caches == [{}] * none.n_layers
        dgot, _ = lm_decode(params, caches, {"tokens": torch.from_numpy(tokens[:, :1])},
                            3, none)
    dwant, _ = jlm_decode(jparams, jinit_caches(jnone, 2, 8, jnp.float32),
                          {"tokens": jnp.asarray(tokens[:, :1])},
                          jnp.asarray(3, jnp.int32), jnone)
    for g, w in ((got, want), (dgot, dwant)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())

    cfg = make_smoke(get_config("granite-moe-1b-a400m"), moe_impl="alltoall")
    gparams = init_params(cfg, device="cpu")
    toks = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got, aux = lm_forward(gparams, toks, cfg)
        want, waux = lm_forward(gparams, toks, cfg.replace(moe_impl="gspmd"))
        lp = gparams["layers"][0]
        x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(0))
        y, _ = moe_apply(lp["moe"], x, num_experts=cfg.moe_experts,
                         top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
    assert torch.equal(got, want) and torch.equal(aux["moe_aux"], waux["moe_aux"])
    assert y.shape == x.shape
    for over, key in ((dict(mrope_sections=(4, 6, 6)), "layers"),
                      (dict(enc_layers=2), "encoder"),
                      (dict(logits_softcap=30.0), "layers")):
        assert key in init_params(qwen.replace(**over), device="cpu")
    for arch in ("mixtral-8x7b", "deepseek-7b", "deepseek-67b",
                 "command-r-plus-104b", "whisper-tiny", "qwen2-vl-2b"):
        assert get_config(arch).name == arch
        init_params(make_smoke(get_config(arch)), device="cpu")
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        assert get_config(arch).n_layers in (32, 24)
        init_params(make_smoke(get_config(arch), n_layers=8), device="cpu")
    with pytest.raises(KeyError):
        get_config("llama-7b")


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


def test_paper_entry_points_raise_without_a_card(monkeypatch, capsys):
    from repro_torch.paper import __main__ as paper_main
    from repro_torch.paper import prune_jets, quickstart, table5_lenet
    from repro_torch.paper.fpga_repro import run_prune_experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: paper_main.main(["--quick"]),
                 lambda: quickstart.main([]),
                 lambda: prune_jets.main(["--rf", "4"]),
                 lambda: run_prune_experiment(
                     **table5_lenet.experiments(quick=True)[0][1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert "name,us_per_call" not in capsys.readouterr().out   # nothing ran
    with pytest.raises(NotImplementedError, match="knapsack.*not ported"):
        paper_main.main(["--only", "table2,knapsack", "--device", "cpu"])
