#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's traffic file names the driver
(``portbench/drivers/<driver>.py``) that sets the system up from the
seed, measures the window and judges what it produced.  With ``--trace
0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read from the traced run's
record by its own reader (``portbench/metrics/<name>.py``), the
device's busy and traced seconds, and beside ``breakdown`` the device's
idle by the program's own spans (``program_idle``), which the port's
tracer records over the window of a traced run only.

The last line of standard output is the result (one JSON object); the
last lines of standard error are each compared number beside its limit.
A run with no CUDA card, or fewer cards than the cell asks for, or one
that loaded JAX or the JAX package, prints no result and exits non-zero.
``setup_s`` runs from the first statement of this file to the window's
start (interpreter start-up before it is not counted).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def eprint(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """Loaded modules (``names``: default ``sys.modules``) whose top-level
    name, before the first dot, is a forbidden one, compared whole:
    ``repro_torch`` is not ``repro``."""
    return sorted({name for name in (sys.modules if names is None else names)
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def metrics(spec, out, setup_s, trace):
    """The result's metrics: end-to-end ones, or with ``trace`` the
    per-layer ones whose readers found something to read."""
    from portbench import spec as spec_mod
    res = {}
    if not trace:
        for m in spec["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else out["end_to_end"][m["name"]]
            if not math.isfinite(v):
                raise RuntimeError(f"{m['name']} is {v}: more requests failed "
                                   "than its percentile leaves out")
            res[m["name"]] = {"value": v, "unit": m["unit"]}
        return res
    for m in spec["per_layer"]:
        v = spec_mod.metric_reader(m["name"]).read(out["record"])
        if v is None:
            eprint(f"metric {m['name']}: nothing to read in this run")
            continue
        res[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return res


def main(argv=None, keep=None) -> int:
    """One run; ``keep`` (a dict) receives the driver's output."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import programspans
    from portbench import spec as spec_mod

    if not torch.cuda.is_available():
        eprint("no CUDA device: the benchmark runs on the card only")
        return 2
    spec = spec_mod.load_cell(args.workload)
    need = int(spec["cell"]["chips"])
    if torch.cuda.device_count() < need:
        eprint(f"{args.workload} needs {need} cards, "
               f"{torch.cuda.device_count()} visible")
        return 2
    device = torch.device("cuda", 0)
    driver = spec_mod.driver(spec["traffic"]["driver"])
    out = driver.run(spec, args.seed, args.seconds, bool(args.trace), device)
    if keep is not None:
        keep.update(out)
    setup_s = out["t_open"] - T_START
    found = forbidden_modules()
    if found:
        eprint(f"forbidden modules loaded in this process: {found}")
        return 3
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics(spec, out, setup_s, bool(args.trace))}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": need,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    reduced = out["record"].get("trace")
    if args.trace:
        if not reduced or reduced["busy_s"] <= 0:
            eprint("the trace recorded no device time")
            return 4
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result["device"] = dev
    if args.trace:
        result["breakdown"] = reduced["breakdown"]
        result["program_idle"] = reduced.get("program_idle")
        out["notes"].extend(programspans.notes(programspans.summary(out["record"])))
    card = power_limit()
    result["card"] = card
    result["setup"] = {"setup_s": setup_s, "kernel_build_s": out.get("build_s")}
    result["checks"] = out["checks"]
    for note in out["notes"]:
        eprint(note)
    eprint(f"card: {card}; setup {setup_s:.3f} s; correct {result['correct']}")
    for name, c in out["checks"].items():
        eprint(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
