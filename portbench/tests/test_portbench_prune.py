"""A whole run of the Algorithm 2 cell at smoke size on the CPU (the
look for a card skipped): sound, it reads ``correct``; with each
training fault of ``portbench/faults.py`` planted in the port's step, it
reads not correct; the fp8 control, put through the same comparison,
reads not correct."""
import pytest
import torch

import smoke
from portbench import faults
from portbench import spec as spec_mod

# the smoke run's readings sit at 9e-5 (loss), 4.9e-4 (gradient) and
# 6.5e-3 (change); the fp8 control's gradient at 6.2e-3; the faults' at
# 8e-3 to 1.0
LIMITS = {"loss_gap": 0.005, "grad_gap": 0.002, "change_gap": 0.01}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(hooks=None):
    spec = smoke.cell("qwen-prune")
    spec["limits"] = LIMITS
    return spec_mod.driver("prune").run(spec, 2**31 + 99, 2.0, False,
                                        torch.device("cpu"), hooks)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["steps"] % 10 == 0 and rec["steps"] >= 10 and rec["knapsack_s"]
    assert out["end_to_end"]["train_tok_s"] > 0
    assert out["judge"]["leaves"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    out = _run({"fault": lambda: faults.TRAINING[fault](monkeypatch.setattr, 512)})
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    out = _run({"control": True})
    assert out["correct"], out["checks"]
    ctl = out["control"]
    assert ctl["checks"]["grad_gap"]["value"] == out["judge"]["control"]["grad_gap"]["value"]
    assert not ctl["correct"], ctl["checks"]
