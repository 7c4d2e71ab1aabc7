"""The paper tables of the torch port (``benchmarks/run.py``'s table
entries):

    python -m repro_torch.paper [--only table2,table3,table5] [--quick] \\
        [--device cpu]

Prints ``name,us_per_call,derived`` CSV, one line per row; ``--quick``
(or QUICK=1) trims the sweeps.  Runs on the card unless ``--device cpu``
is given; without a card it fails rather than fall back.  Exits 1 if a
table fails.  The reference's ``knapsack``, ``kernels`` and ``serving``
benches are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Optional, Sequence

NOT_PORTED = ("knapsack", "kernels", "serving")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    default=os.environ.get("QUICK") == "1")
    ap.add_argument("--only", default=None,
                    help="comma list: table2,table3,table5")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    from . import table2_jets, table3_svhn, table5_lenet

    tables = {"table2": table2_jets.main, "table3": table3_svhn.main,
              "table5": table5_lenet.main}
    selected = args.only.split(",") if args.only else list(tables)
    unported = [n for n in selected if n in NOT_PORTED]
    if unported:
        raise NotImplementedError(
            f"{','.join(unported)}: not ported to torch yet; the port runs "
            f"{','.join(tables)}")
    unknown = [n for n in selected if n not in tables]
    if unknown:
        ap.error(f"unknown table(s) {unknown}; choose from {list(tables)}")
    device = resolve_device(args.device)

    print("name,us_per_call,derived")
    failures = 0
    for name in selected:
        try:
            for line in tables[name](quick=args.quick, device=device):
                print(line, flush=True)
        except Exception:       # report the table's failure, run the next
            failures += 1
            traceback.print_exc()
            print(f"{name},0,FAILED: {traceback.format_exc().splitlines()[-1]}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
