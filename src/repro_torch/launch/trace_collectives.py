"""Collective-traffic trace for one dry-run cell: aggregates the
per-device result bytes of every collective by (op kind, where it was
issued) — torch port of ``src/repro/launch/trace_collectives.py``.

The reference groups by the HLO ``op_name``; here the per-rank counter
records each collective's origin, the chain of ``repro_torch`` functions
on the Python stack (``backward/<node>`` for the backward pass).

  PYTHONPATH=src python -m repro_torch.launch.trace_collectives --arch X \\
      --shape train_4k [--multi-pod] [--overrides k=v,...] [--top 20]
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--overrides", default="")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import cost_analysis
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh
    from repro_torch.launch.roofline import collectives_from_trace

    cfg = get_config(args.arch)
    ov = dr._parse_overrides(args.overrides)
    if ov:
        cfg = cfg.replace(**ov)
    cell = SHAPES[args.shape]
    shape, _ = make_mesh_shape(multi_pod=args.multi_pod)
    world = 1
    for n in shape:
        world *= n
    dr.fake_world(world)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    counter, _ = dr.trace_cell(cfg, cell, mesh, multi_pod=args.multi_pod,
                               origins=True)

    agg = Counter()
    for c in counter.collectives:
        agg[(c.kind, c.origin[-100:])] += c.result_bytes
    ops = collectives_from_trace(counter)
    wire = sum(o.wire_bytes for o in ops)
    print(f"total collective result bytes/dev: "
          f"{sum(agg.values())/1e9:.2f} GB; modeled wire: {wire/1e9:.2f} GB")
    for (op, name), nb in agg.most_common(args.top):
        print(f"{nb/1e9:8.3f}GB {op:18s} {name}")
    ca = cost_analysis(counter)
    print(f"flops/dev={ca['flops']:.3e} bytes/dev={ca.get('bytes accessed', 0):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
