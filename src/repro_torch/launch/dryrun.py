"""Dry-run of the sharded program: trace one step of every (arch x shape
x mesh) cell on a fake process group — torch port of
``src/repro/launch/dryrun.py``.

For each cell the dry-run:
  1. starts a fake process group of 256 ranks (16 x 16 ("data", "model"))
     or 512 (2 x 16 x 16 ("pod", "data", "model")) and builds the
     production mesh over it (``launch/mesh.py``);
  2. builds the full train or serve state under ``FakeTensorMode``
     (shapes and dtypes only: nothing is allocated, not even 104B at full
     width) and places it, the batch and the caches by
     ``launch.specs.cell_shardings`` (DTensor placements);
  3. installs the mesh and ``rules_for_cell`` and traces one train,
     prefill or decode step under the per-rank counter
     (``distributed/cost.py``), the counterpart of ``lower().compile()``
     and ``cost_analysis``;
  4. writes the roofline record (``launch/roofline.py``) to one JSON file
     per cell, incrementally (existing results are skipped).

The record has the reference's keys.  ``lower_s`` is the time to build
and place the state, ``compile_s`` the time to trace the step.  A cell
that fails is recorded with ``"status": "error"`` and the run goes on.
The fake process group belongs to the whole process: ``--fresh-process``
runs each cell in its own.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out results/dryrun_torch [--fresh-process] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

__all__ = ["run_cell", "trace_cell", "count_cell", "fake_world", "main"]


def _cell_id(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    base = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    return f"{base}__{tag}" if tag else base


def _parse_overrides(spec: str) -> Dict[str, Any]:
    """'seq_sharded_acts=true,row_accum_dtype=bfloat16,attn_chunk=256'"""
    out: Dict[str, Any] = {}
    for item in filter(None, (spec or "").split(",")):
        k, v = item.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def fake_world(world_size: int) -> None:
    """This process's fake process group of ``world_size`` ranks (rank 0
    traced), started once; a group of another size already started
    raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is running; "
                f"the dry-run needs {world_size} (run the cell with "
                "--fresh-process)")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _materialize(tree, device):
    """Zero tensors (fake under FakeTensorMode) of the meta stand-ins'
    shapes and dtypes on ``device``."""
    import torch

    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, device) for v in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def trace_cell(cfg, cell, mesh, *, multi_pod: bool = False, device: str = "cpu",
               origins: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """Build the cell's state and inputs under ``FakeTensorMode``, place
    them on ``mesh`` and trace one step under the counter.  Returns (the
    ``CostCounter``, {"lower_s", "compile_s", "output_bytes"})."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import input_specs
    from repro_torch.distributed.cost import CostCounter, local_bytes
    from repro_torch.distributed.sharding import axis_rules, distribute_tree, use_mesh
    from repro_torch.launch.specs import cell_shardings, rules_for_cell
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.train_step import (init_train_state, make_decode_step,
                                              make_prefill_step, make_train_step)

    t0 = time.time()
    opt_cfg = AdamWConfig(use_master=cfg.param_dtype != "float32")
    specs = input_specs(cfg, cell)
    with FakeTensorMode():
        params = init_params(cfg, device=device)
        if cell.kind == "train":
            state = init_train_state(params, opt_cfg)
        else:
            state = {"params": params}
        sh = cell_shardings(cfg, cell, mesh, multi_pod, specs, state_shapes=state)
        batch = distribute_tree(_materialize(specs["batch"], device), sh["batch"], mesh)
        if cell.kind == "train":
            state = distribute_tree(state, sh["state"], mesh)
            args: Tuple[Any, ...] = (state, batch)
            step = make_train_step(cfg, opt_cfg, warmup_cosine(3e-4, 100, 10000))
        elif cell.kind == "prefill":
            args = (distribute_tree(params, sh["params"], mesh), batch)
            step = make_prefill_step(cfg)
        else:
            caches = distribute_tree(_materialize(specs["caches"], device),
                                     sh["caches"], mesh)
            args = (distribute_tree(params, sh["params"], mesh), caches, batch,
                    torch.zeros((), dtype=torch.int32, device=device))
            step = make_decode_step(cfg)
        del params, state
        lower_s = time.time() - t0
        with use_mesh(mesh), axis_rules(rules_for_cell(cell, mesh, multi_pod)):
            with CostCounter(live=args, origins=origins) as counter:
                out = step(*args)
        compile_s = time.time() - t0 - lower_s
        info = {"lower_s": lower_s, "compile_s": compile_s,
                "output_bytes": local_bytes(out)}
    return counter, info


def count_cell(cfg, cell, mesh_shape, *, device: str = "cpu") -> Dict[str, Any]:
    """The counter's summary (``CostCounter.summary``) of one step of
    ``cell`` traced on a fake group of ``prod(mesh_shape)`` ranks over a
    ("data", "model") mesh of that shape, and the trace's seconds."""
    from repro_torch.launch.mesh import make_test_mesh

    world = 1
    for n in mesh_shape:
        world *= n
    fake_world(world)
    mesh = make_test_mesh(tuple(mesh_shape), ("data", "model"),
                          device_type="cuda" if device == "cuda" else "cpu")
    counter, info = trace_cell(cfg, cell, mesh, device=device)
    return {**counter.summary(), "lower_s": info["lower_s"],
            "compile_s": info["compile_s"]}


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trace one cell on the production mesh; returns the JSON-able
    record."""
    from repro_torch.configs import SHAPES, cell_applicable, get_config
    from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh
    from repro_torch.launch.roofline import analyze_trace
    from repro_torch.launch.supplements import supplements_for

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = SHAPES[shape]
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "cell": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    mesh_shape, _ = make_mesh_shape(multi_pod=multi_pod)
    chips = 1
    for n in mesh_shape:
        chips *= n
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model = mesh.size(mesh.mesh_dim_names.index("model"))
    counter, info = trace_cell(cfg, cell, mesh, multi_pod=multi_pod)
    supp = supplements_for(cfg, cell, model_size=model, dp_size=chips // model)
    record = analyze_trace(
        counter, cfg, cell,
        mesh_name="2x16x16" if multi_pod else "16x16",
        chips=chips, output_bytes=info["output_bytes"], supplements=supp)
    out = record.to_dict()
    out.update({
        "status": "ok",
        "multi_pod": multi_pod,
        "lower_s": round(info["lower_s"], 1),
        "compile_s": round(info["compile_s"], 1),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fresh-process", action="store_true",
                    help="run each cell in a subprocess (crash isolation)")
    ap.add_argument("--overrides", default="",
                    help="config overrides, e.g. seq_sharded_acts=true")
    ap.add_argument("--tag", default="", help="suffix for result files")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    # a process holds one fake group: without --fresh-process both meshes
    # cannot run in it
    fresh = args.fresh_process or len(pods) > 1

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi_pod in pods:
                cid = _cell_id(arch, shape, multi_pod, args.tag)
                path = os.path.join(args.out, cid + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {cid}")
                    continue
                print(f"[run] {cid}", flush=True)
                if fresh:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", "multi" if multi_pod else "single",
                           "--out", args.out, "--overrides", args.overrides,
                           "--tag", args.tag] + (["--force"] if args.force else [])
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=3600)
                    if r.returncode != 0 and not os.path.exists(path):
                        failures += 1
                        err = {"arch": arch, "cell": shape, "multi_pod": multi_pod,
                               "status": "error",
                               "error": (r.stderr or r.stdout)[-4000:]}
                        with open(path, "w") as f:
                            json.dump(err, f, indent=2)
                        print("  FAILED (subprocess)", flush=True)
                    else:
                        failures += r.returncode != 0
                        print((r.stdout or "").strip().splitlines()[-1]
                              if (r.stdout or "").strip() else "", flush=True)
                    continue
                try:
                    rec = run_cell(arch, shape, multi_pod,
                                   _parse_overrides(args.overrides))
                except Exception as e:  # record, keep going
                    failures += 1
                    rec = {"arch": arch, "cell": shape, "multi_pod": multi_pod,
                           "status": "error", "error": traceback.format_exc()[-4000:]}
                    print(f"  FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                if rec.get("status") == "ok":
                    print(f"  ok: trace={rec['compile_s']}s "
                          f"dominant={rec['dominant']} "
                          f"compute={rec['compute_s']:.3e}s "
                          f"memory={rec['memory_s']:.3e}s "
                          f"coll={rec['collective_s']:.3e}s "
                          f"useful={rec['useful_ratio']:.3f} "
                          f"peak={rec['memory_stats']['peak_gb']:.2f}GB", flush=True)
                elif rec.get("status") == "skipped":
                    print(f"  skipped: {rec['reason']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
