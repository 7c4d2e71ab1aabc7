"""The port's last two examples, ``repro_torch.paper.serve_pruned`` and
``repro_torch.paper.train_lm_pruned``, on the CPU through their
``main(argv)``: the reference's widths and checks (``examples/``), with
the training steps cut for the second.  Without a card they refuse to
run unless asked for the CPU."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.paper import serve_pruned, train_lm_pruned


@pytest.fixture(autouse=True)
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_serve_pruned_as_written(capsys):
    """Its own assertions (packed == masked dense within 1e-6 at
    reconstruction, one decode step within atol 1e-3 / rtol 1e-4) pass,
    and it prints the knapsack's kept/total line."""
    assert serve_pruned.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    kept = re.search(r"knapsack kept (\d+)/(\d+) structures", out)
    assert kept and 0 < int(kept.group(1)) < int(kept.group(2))
    assert "BSR density" in out
    assert out.strip().endswith("BSR path == masked dense. done.")


def test_train_lm_pruned_short(capsys):
    """A few training steps: the loss falls, Algorithm 2's iterations
    print, and the temporary checkpoint directory is gone."""
    assert train_lm_pruned.main(["--device", "cpu", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"training: loss ([\d.]+) -> ([\d.]+) \(4 steps, ckpts in (\S+)\)", out)
    assert m, out
    assert float(m.group(2)) < float(m.group(1))
    assert not Path(m.group(3)).exists()
    assert re.search(r"prune iter 0: val loss=[\d.]+ structures pruned=[\d.]+%", out)
    assert out.strip().endswith("done.")


@pytest.mark.parametrize("module", [serve_pruned, train_lm_pruned],
                         ids=["serve_pruned", "train_lm_pruned"])
def test_examples_refuse_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
