#!/usr/bin/env python3
"""Where the serving engine's host time goes, pass by pass, on the card.

    python3 scripts/serving_split.py [--src DIR] [--label NAME] [--out FILE]

qwen1.5-0.5b and granite-moe-1b-a400m (capacity factor 4.0) at full
width, fp32, knapsack 0.75 at 128x128 and BSR-packed, on the chip
smoke's phase-3 traffic (8 requests over 4 slots, 16 tokens each, 4
ticks per sync), through two engines: one with eager steps (a warm-up
pass, a timed pass, then a split pass whose eager admission prefills
each run under torch.profiler, so their device time shows) and one with
CUDA graphs (three passes: the first captures, the second's prefix hits
on the first's prompts are new prefill variants, the third is steady).
Each pass prints its tok/s, TTFT p50 and ``chip_smoke.HostSplit``: host
ms per admission and per decode chunk outside the chunk call, the device
ms of prefills and chunk replays, and the capture seconds kept apart
from the wall; the eager timed pass and the graphed pass 3 also the
card's busy share (``chip_smoke.device_busy`` over one more pass).
``--src`` puts another tree's ``src`` first on the path (a commit
unpacked with ``git archive`` into a git-ignored directory), so that one
call can measure two trees; the kernels build from that tree's sources.
One JSON object per arch and engine goes to ``--out`` (default
``build/serving_split.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "serving_split.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serving_split: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    gpu = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"{args.label}: {args.src}; {gpu}; built the kernels in "
          f"{_build.build_all():.1f}s", flush=True)
    dev, gen, report = torch.device("cuda"), 16, []
    for arch, cf in (("qwen1.5-0.5b", None), ("granite-moe-1b-a400m", 4.0)):
        cfg = get_config(arch).replace(param_dtype="float32", activ_dtype="float32")
        if cf is not None:
            cfg = cfg.replace(capacity_factor=cf)
        params, _ = serve.build_params(cfg, seed=0, device=dev, pruned=0.75,
                                       block=(128, 128), min_size=4096)
        prompts = cs.traffic(cfg.vocab, 0)
        for graphed in (False, True):
            eng = ServingEngine(params, cfg, num_slots=4, page_size=8,
                                max_seq_len=max(len(p) for p in prompts) + gen,
                                ticks_per_sync=4, device=dev, cuda_graphs=graphed)
            runs = [cs.serve_pass(torch, eng, prompts, gen)
                    for _ in range(3 if graphed else 2)]
            if not graphed:
                runs = runs[1:]               # after a warm-up pass
            busy = cs.device_busy(torch, lambda: cs.serve_pass(
                torch, eng, prompts, gen), runs[-1]["seconds"])
            if not graphed:
                runs.append(cs.serve_pass(torch, eng, prompts, gen,
                                          profile_prefill=True))
            mode = "graphed" if graphed else "eager"
            share = busy["busy_share"]
            print(f"  {args.label} {arch} {mode}: card busy "
                  + (f"{100 * share:.1f}% of pass {len(runs) if graphed else 1}"
                     if isinstance(share, float) else f"not measured ({busy})"),
                  flush=True)
            for i, run in enumerate(runs):
                name = ("split pass (prefills profiled)" if not graphed and i
                        else f"pass {i + 1}")
                print(f"  {args.label} {arch} {mode} {name}: "
                      f"{run['tok_per_s']:.1f} tok/s, TTFT p50 "
                      f"{run['ttft_ms_p50']:.2f} ms, {run['seconds']:.3f} s "
                      f"({run['seconds_less_captures']:.3f} s less captures); "
                      f"{cs.split_line(run)}", flush=True)
            report.append(dict(label=args.label, src=str(args.src), gpu=gpu,
                               arch=arch, mode=mode, device=busy,
                               passes=[cs.public(r) for r in runs]))
            del eng
        del params
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1, default=str))
    print(f"{args.label}: done at {time.strftime('%H:%M:%S')}; {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
