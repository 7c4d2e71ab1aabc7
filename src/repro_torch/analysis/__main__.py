"""CLI: `python -m repro_torch.analysis` — lint the port for torch and
CUDA hazards.

    python -m repro_torch.analysis [--fail-on-new] [--json] [--rules a,b]
        [--write-baseline] [--list-rules] [--root DIR] [--baseline FILE]
        [paths ...]

Exit codes: 0 clean vs baseline, 1 new findings (with --fail-on-new),
2 usage error.  The baseline is `src/repro_torch/analysis/baseline.json`;
`--write-baseline` rewrites it from the current findings, keeping the
notes of the entries that survive (a new entry's note must be written by
hand: the tests refuse a `TODO`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .lint import (
    BASELINE_NAME,
    DEFAULT_SCAN_PATHS,
    find_root,
    load_baseline,
    run_project,
    write_baseline,
)
from .rules import rule_names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint for torch/CUDA hazards: host syncs in hot paths, "
        "PRNG reuse, CUDA-graph recapture hazards, kernel launch constraints.",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"paths to scan (default: {' '.join(DEFAULT_SCAN_PATHS)})")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 if any finding is not in the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                    "(preserves existing notes)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names to run (default: all)")
    ap.add_argument("--list-rules", action="store_true", help="list rule names and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in rule_names():
            print(name)
        return 0

    root = (args.root or find_root(Path.cwd())).resolve()
    baseline_path = args.baseline or (root / BASELINE_NAME)
    enabled = None
    if args.rules:
        enabled = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = enabled - set(rule_names())
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    report = run_project(root, paths=args.paths or None,
                         baseline_path=baseline_path, enabled=enabled)
    elapsed_ms = (time.perf_counter() - t0) * 1e3

    if args.write_baseline:
        old = load_baseline(baseline_path)
        notes = {k: v.get("note", "") for k, v in old.items() if v.get("note")}
        write_baseline(baseline_path, report.findings, notes=notes)
        print(f"wrote {baseline_path} with {len(report.findings)} entries")
        return 0

    if args.as_json:
        payload = {
            "runtime_ms": round(elapsed_ms, 2),
            "files_scanned": report.files_scanned,
            "findings": len(report.findings),
            "new": len(report.diff.new),
            "baselined": len(report.diff.known),
            "inline_suppressed": report.inline_suppressed,
            "stale_baseline_entries": len(report.diff.stale),
            "by_rule": report.by_rule(),
            "new_findings": [f.format() for f in report.diff.new],
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in report.diff.new:
            print(f"NEW  {f.format()}")
        if not args.fail_on_new:
            for f in report.diff.known:
                print(f"BASE {f.format()}")
        for k in report.diff.stale:
            print(f"STALE baseline entry (finding fixed — prune it): {k}", file=sys.stderr)
        print(
            f"{report.files_scanned} files, {len(report.findings)} findings "
            f"({len(report.diff.new)} new, {len(report.diff.known)} baselined, "
            f"{report.inline_suppressed} inline-suppressed, "
            f"{len(report.diff.stale)} stale) in {elapsed_ms:.0f} ms"
        )

    if args.fail_on_new and report.diff.new:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
