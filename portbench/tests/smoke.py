"""Smoke-size cells for the CPU tests of the harness: the benchmark's
configuration and traffic files with widths, depths, lengths and
counts cut down, run through the same drivers on the CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec as spec_mod  # noqa: E402

CONFIG_CUT = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=256, vocab_size=512)
MOE_CUT = dict(num_key_value_heads=2, intermediate_size=64, num_local_experts=4,
               num_experts_per_tok=2)
PRUNING = {"sparsity": 0.75, "block": [32, 32], "min_size": 1024}


# Algorithm 2 prunes 128 x 128 tiles whatever the configuration states
# (launch/train.py PRUNE_BLOCK), so its smoke keeps them: one layer of
# width 256 holds 48 tiles with the embedding, of which the 5 % step
# drops 3 (one "least" tile in each of wq, wk and w_up)
PRUNE_CUT = dict(hidden_size=256, num_hidden_layers=1, num_attention_heads=4,
                 num_key_value_heads=4, intermediate_size=512, vocab_size=512)
PRUNE_LEAST = {"wq": 1, "wk": 1, "w_up": 1}


def cell(name: str, seconds_rate: float = 4.0):
    """The spec of cell ``name`` at smoke size (a dict like
    ``spec.load_cell``'s)."""
    spec = copy.deepcopy(spec_mod.load_cell(name))
    cfg = spec["config"]
    if spec["traffic"]["driver"] == "prune":
        cfg.update(PRUNE_CUT)
        cfg["pruning"] = dict(cfg["pruning"], block=[128, 128], min_size=4096)
        cfg["weights"] = dict(cfg["weights"], least_tiles=PRUNE_LEAST)
        spec["traffic"].update(batch=2, seq=32)
        return spec
    cfg.update(CONFIG_CUT)
    if cfg.get("num_local_experts"):
        cfg.update(MOE_CUT)
    cfg["pruning"] = dict(cfg["pruning"], **PRUNING)
    tr = spec["traffic"]
    tr["engine"].update(num_slots=4)
    tr["prompt"].update(median=24, min=8, max=48, grid=4)
    tr["output"].update(median=10, min=4, max=20)
    if tr.get("shared_prefix"):
        tr["shared_prefix"]["length"] = 16
    tr["engine"]["max_seq_len"] = 16 + 48 + 20
    if tr["arrivals"]["kind"] == "poisson":
        tr["arrivals"].update(rate_per_s=seconds_rate, lead_in_s=0.5)
        tr["greedy_share"] = 0.5
        tr["check"] = {"requests": 3, "min_tokens": 10, "sampled": 3}
    else:
        tr["arrivals"].update(requests=400, lead_in_retired=4)
        tr["check"] = {"requests": 3, "min_tokens": 10}
    return spec
