#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card::

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 30 \
        [--faults name,...]

Each seed is one whole run of the cell in this process (set-up, window,
judgement), whose judgement also reads the control: the plain reference
with every matrix in fp8 e4m3 (one scale per matrix), the precision
below the configurations' bf16 (a served model: at each position of the
same prompts and served tokens; training: its three steps).  With
``--faults`` each seed also runs once with each named fault of
``portbench/faults.py`` planted.  Prints one JSON line per run: the
checks' numbers and ``correct`` (lower readings, or a fault's), and the
control's numbers put through the same comparison against the cell's
limits, with its own ``correct`` (upper readings: a sound limit reads
it false).  Not run by the benchmark's own runs.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="", help="comma-separated fault names")
    args = ap.parse_args(argv)

    import torch
    from portbench import faults
    from portbench import spec as spec_mod
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = spec_mod.load_cell(args.workload)
    drv = spec_mod.driver(spec["traffic"]["driver"])
    table = {**faults.SERVING, **faults.SAMPLING, **faults.TRAINING}
    vocab = spec["config"]["vocab_size"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in [None] + [f for f in args.faults.split(",") if f]:
            patch = faults.Patcher()
            hooks = ({"control": True} if fault is None else
                     {"fault": lambda f=fault: table[f](patch, vocab)})
            try:
                out = drv.run(spec, seed, args.seconds, False,
                              torch.device("cuda", 0), hooks)
            finally:
                patch.restore()
            judge = {k: v for k, v in out["judge"].items() if k != "live"}
            print(json.dumps({"seed": seed, "fault": fault, "correct": out["correct"],
                              "checks": out["checks"], "control": out.get("control"),
                              "judge": judge, **out["end_to_end"]}, default=str),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
