"""A whole run of each serving cell at smoke size on the CPU (the look
for a card skipped): sound, it reads ``correct``; with each fault of
``portbench/faults.py`` planted in the timed path, it reads not correct;
the fp8 control, put through the same comparison, reads not correct."""
import os
import subprocess
import sys

import pytest
import torch

import smoke
from portbench import faults
from portbench import spec as spec_mod

SECONDS = {"qwen-chat": 2.0, "granite-backlog": 1.5}
LIMIT = 0.02        # above the smoke models' widest gap (0.0 on this seed), below the faults'


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, seed=2**31 + 11, hooks=None):
    spec = smoke.cell(cell)
    spec["limits"] = {"served_gap": LIMIT}
    drv = spec_mod.driver(spec["traffic"]["driver"])
    return drv.run(spec, seed, SECONDS[cell], False, torch.device("cpu"), hooks)


@pytest.mark.parametrize("cell", ["qwen-chat", "granite-backlog"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["judged_tokens"]["value"] >= \
        out["checks"]["judged_tokens"]["limit"]
    for v in out["end_to_end"].values():
        assert v > 0
    rec = out["record"]
    assert rec["flops_in"]["decode_tokens"] > 0 and rec["window_s"] > 0
    if cell == "qwen-chat":
        assert rec["prefix"]["tokens_mapped"] > 0


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("cell", ["qwen-chat", "granite-backlog"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    vocab = smoke.cell(cell)["config"]["vocab_size"]
    out = _run(cell, hooks={"fault": lambda: faults.SERVING[fault](
        monkeypatch.setattr, vocab)})
    assert not out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] > LIMIT


@pytest.mark.parametrize("fault", sorted(faults.SAMPLING))
def test_planted_sampler_fault_is_not_correct(fault, monkeypatch):
    vocab = smoke.cell("qwen-chat")["config"]["vocab_size"]
    out = _run("qwen-chat", hooks={"fault": lambda: faults.SAMPLING[fault](
        monkeypatch.setattr, vocab)})
    assert out["judge"]["sampled"] > 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["qwen-chat", "granite-backlog"])
def test_control_is_not_correct(cell):
    out = _run(cell, hooks={"control": True})
    assert out["correct"], out["checks"]
    ctl = out["control"]
    assert ctl["checks"]["served_gap"]["value"] == max(out["judge"]["control_gaps"])
    assert not ctl["correct"], ctl["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(spec_mod.HERE / "run.py"),
                        "--workload", "qwen-chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=str(spec_mod.ROOT), timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
