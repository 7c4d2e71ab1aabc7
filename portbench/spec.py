"""What a run reads: ``BENCHMARK.json`` at the checkout's root and the
files it names, each found by name.

* :func:`load_cell` gives one cell's entry with its configuration file,
  its traffic file, its limits file and the metrics it reports;
* :func:`load_module` imports a file of the benchmark by path (metric
  names hold dots, so they are not importable by name).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

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
