#!/usr/bin/env python3
"""Find an open-loop cell's knee once, on the card: one set-up, then the
cell's window (after its lead-in) at each of several fixed rates, each
from a released prefix cache and drained before the next::

    python3 portbench/knee.py --workload qwen-chat --seed <n> --seconds 30 --rates 4,6,8

For each rate it prints the waiting queue sampled each second of the
window, the queue at the close, the drain, and the tails.  The knee is
the highest rate whose queue does not grow across the window; the cell's
traffic file then states a rate below it as a number.  ``--streams``
repeats each rate over the traffic of other seeds, and ``--iid`` draws
plain Poisson gaps and sizes instead of the stratified ones (to compare
what the stratification smooths).  Not run by the benchmark's own runs.
"""
import argparse
import copy
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True, help="comma-separated req/s")
    ap.add_argument("--streams", default="", help="comma-separated traffic seeds "
                    "(default: --seed)")
    ap.add_argument("--iid", action="store_true", help="plain Poisson draws")
    args = ap.parse_args(argv)

    import torch
    from portbench import generate, serving
    from portbench import spec as spec_mod
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = spec_mod.load_cell(args.workload)
    drv = spec_mod.driver(spec["traffic"]["driver"])
    state = serving.setup(spec, args.seed, device)
    eng = state["engine"]
    streams = [int(s) for s in args.streams.split(",") if s] or [args.seed]
    for rate in (float(r) for r in args.rates.split(",")):
        for stream_seed in streams:
            traffic = copy.deepcopy(spec["traffic"])
            traffic["arrivals"]["rate_per_s"] = rate
            traffic["iid"] = args.iid
            reqs = generate.stream(traffic, spec["config"]["vocab_size"],
                                   stream_seed, args.seconds)
            eng.release_prefix_cache()
            meter = serving.Meter(eng, spec["config"], events=False)
            out = functools.partial(drv.window, traffic=traffic)(
                eng, meter, reqs, args.seconds, None)
            meter.detach()
            print(json.dumps({"rate_per_s": rate, "stream": stream_seed,
                              "iid": args.iid, "requests": out["attempted"],
                              "queue": [q for q in out["queue"] if q[0] >= 0],
                              "drain_s": out["drain_s"], **out["end_to_end"],
                              "failed": out["failed"], "notes": out["notes"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
