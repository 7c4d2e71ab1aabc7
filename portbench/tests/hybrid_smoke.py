"""A test-local reference for ``hybrid-smoke.json``, which the CPU tests
register as ``portbench.reference.hybrid_smoke``: the harness's counts
are what these tests check, not the model, so its weights are the
port's own ``init_params`` of ``make_smoke(jamba-v0.1-52b)`` at the
file's depth, laid out as the port's params tree already, and its
forward is the port's eager ``lm_forward``.  The tile selection keeps
the ``1 - sparsity`` share of the packed matrices' tiles with the
largest norms, each leaf's norms over its largest."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from portbench import program
from portbench.reference.decoder import tile_norms

program.import_port()
from repro_torch.configs import get_config, make_smoke  # noqa: E402
from repro_torch.models import init_params, lm_forward  # noqa: E402

_FAMILIES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_up", "w_gate", "w_down"),
             "moe": ("experts_up", "experts_gate", "experts_down")}


def model(cfg: Dict):
    return make_smoke(get_config(cfg["port_arch"]), n_layers=cfg["num_hidden_layers"])


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    return init_params(model(cfg), seed=int(seed), device=device)


def params_tree(w: Dict, cfg: Dict) -> Dict:
    return w


def dense_weights_per_token(cfg: Dict) -> int:
    return 0


def other_flops_per_token(cfg: Dict) -> int:
    return 0


def _leaves(w: Dict) -> Iterator[Tuple[str, Dict, str]]:
    """(kind, the dict that holds it, its key there) of every packed
    matrix, layer by layer."""
    for layer in w["layers"]:
        for family, kinds in _FAMILIES.items():
            for kind in kinds if family in layer else ():
                box = layer[family] if family == "moe" else layer[family][kind]
                yield kind, box, kind if family == "moe" else "kernel"


def select_tiles(w: Dict, cfg: Dict) -> Dict[str, torch.Tensor]:
    pr = cfg["pruning"]
    tile = int(pr["block"][0])
    norms: Dict[str, list] = {}
    for kind, box, key in _leaves(w):
        t = tile_norms(box[key], tile)
        norms.setdefault(kind, []).append(t / t.max())
    stacked = {k: torch.stack(v) for k, v in norms.items()}
    v = torch.cat([t.reshape(-1) for t in stacked.values()])
    k = int(math.floor((1.0 - float(pr["sparsity"])) * v.numel() + 1e-9))
    keep = torch.zeros(v.numel(), dtype=torch.bool)
    keep[torch.argsort(v, descending=True, stable=True)[:k]] = True
    out, off = {}, 0
    for name, t in stacked.items():
        out[name] = keep[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out


def masked(w: Dict, keep: Dict[str, torch.Tensor], cfg: Dict) -> Dict:
    tile = int(cfg["pruning"]["block"][0])
    out = {"embed": w["embed"], "final_norm": w["final_norm"],
           "layers": [{name: ({k: dict(v) if isinstance(v, dict) else v
                               for k, v in part.items()} if isinstance(part, dict)
                              else part)
                       for name, part in layer.items()} for layer in w["layers"]]}
    seen: Dict[str, int] = {}
    for kind, box, key in _leaves(out):
        i = seen.get(kind, 0)
        seen[kind] = i + 1
        flags = keep[kind][i].repeat_interleave(tile, -2).repeat_interleave(tile, -1)
        box[key] = box[key] * flags.to(box[key].dtype)
    return out


def forward(w: Dict, tokens: torch.Tensor, cfg: Dict) -> torch.Tensor:
    with torch.no_grad():
        logits, _ = lm_forward(w, {"tokens": tokens[None].to(torch.int32)}, model(cfg))
    return logits[0].to(torch.float32)
