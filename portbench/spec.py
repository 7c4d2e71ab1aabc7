"""What a run reads: ``BENCHMARK.json`` at the checkout's root and the
files it names, each found by name.

* :func:`load_cell` gives one cell's entry with its configuration file,
  its traffic file, its limits file and the metrics it reports;
* :func:`load_module` imports a file of the benchmark by path (metric
  names hold dots, so they are not importable by name);
* :func:`reference` imports the configuration's plain reference;
* :func:`layer_plan` and :func:`plan_counts` read each layer's mixer and
  MLP from a configuration file, which every count of layers follows.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell``
    reports: those listing it under ``workloads``, and those without the
    key whose ``moves`` metric the cell reports (per-layer) or all of
    them (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """Everything one run of cell ``name`` needs, read from files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return {
        "cell": cell,
        "config": read_json(root / entry["file"]),
        "config_entry": entry,
        "traffic": read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": read_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": metrics_of(bench, name, "end_to_end"),
        "per_layer": metrics_of(bench, name, "per_layer"),
    }


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return load_module(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def reference(cfg: Dict) -> ModuleType:
    """The configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


# the layer that holds each weight kind the port prunes and packs (its
# attention, MLP and expert matrices: ``sparse.knapsack_prune``'s families)
KIND_LAYER = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
              "w_up": "dense", "w_gate": "dense", "w_down": "dense",
              "experts_up": "moe", "experts_gate": "moe", "experts_down": "moe"}


def num_experts(cfg: Dict) -> int:
    """Experts of an MoE layer: ``num_local_experts``, or Jamba's
    ``num_experts``; 0 without either."""
    return int(cfg.get("num_local_experts") or cfg.get("num_experts") or 0)


# the keys :func:`layer_plan` reads (Jamba's)
PLAN_KEYS = ("attn_layer_period", "attn_layer_offset",
             "expert_layer_period", "expert_layer_offset")


def layer_plan(cfg: Dict) -> List[Tuple[str, str]]:
    """Each layer's ``(mixer, mlp)`` as configuration file ``cfg`` states
    it, with Jamba's keys: attention at the layers ``i`` with ``i %
    attn_layer_period == attn_layer_offset`` and Mamba at the others; the
    MoE at ``i % expert_layer_period == expert_layer_offset`` and a dense
    MLP at the others.  Without a period key every layer is attention,
    or every layer has the MoE.  A layer has the MoE only where the file
    states more than one expert (Jamba's rule)."""
    def at(i: int, kind: str) -> bool:
        period = cfg.get(f"{kind}_layer_period")
        return period is None or i % period == cfg[f"{kind}_layer_offset"]

    moe = num_experts(cfg) > 1
    return [("attn" if at(i, "attn") else "mamba",
             "moe" if moe and at(i, "expert") else "dense")
            for i in range(cfg["num_hidden_layers"])]


def plan_counts(cfg: Dict) -> Dict[str, int]:
    """The plan's layers of each kind (``attn``, ``mamba``, ``dense``,
    ``moe``), all ``layers`` and each MoE layer's ``experts``."""
    out = {"layers": cfg["num_hidden_layers"], "attn": 0, "mamba": 0, "dense": 0,
           "moe": 0, "experts": num_experts(cfg)}
    for mixer, mlp in layer_plan(cfg):
        out[mixer] += 1
        out[mlp] += 1
    return out


def matrices(kind: str, counts: Dict[str, int]) -> int:
    """Matrices of weight kind ``kind`` in the stack: one in each layer
    that holds it, one per expert in an MoE layer."""
    layer = KIND_LAYER[kind]
    return counts[layer] * (counts["experts"] if layer == "moe" else 1)
