"""The port's dry-run on fake process groups, each in a subprocess of its
own (a fake group belongs to its whole process, and the test workers run
other files afterwards):

* the reference's four archs of ``tests/test_sharding_dryrun.py`` at its
  smoke widths on a (4, 2) ("data", "model") mesh of 8 fake ranks: a
  train and a decode cell trace, and count FLOPs;
* qwen1.5-0.5b at those widths: 8 x the per-rank matmul FLOPs of the
  train cell is within 5 % of the count on a (1, 1) mesh, so no rank
  repeats work the specs give to another;
* a "pod" axis only adds data-parallel ranks: granite's train cell on a
  (2, 4, 2) ("pod", "data", "model") mesh peaks as far above its state
  as on an (8, 2) mesh, whose ranks hold the same share of the batch (a
  vocab that does not divide "model", as granite's and whisper's do not
  at full width, once made the loss's backward gather the batch over
  "data" there);
* on the 256-rank production mesh (qwen1.5-0.5b decode_32k at full
  width, cut to 2 layers): ``run_cell``'s record has the reference's
  keys, and ``trace_collectives`` prints its total line.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1.5-0.5b", "granite-moe-1b-a400m", "jamba-v0.1-52b", "xlstm-350m"]

_SMALL = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    shape, archs = %(shape)r, %(archs)r
    dryrun.fake_world(shape[0] * shape[1])
    mesh = make_test_mesh(shape, ("data", "model"), device_type="cpu")
    out = {}
    for arch in archs:
        cfg = make_smoke(get_config(arch), d_model=256, n_heads=4, kv_heads=2,
                         head_dim=64, vocab=512)
        for cell in (ShapeCell("t", "train", 64, 8), ShapeCell("d", "decode", 64, 8)):
            counter, info = dryrun.trace_cell(cfg, cell, mesh)
            out[f"{arch}/{cell.kind}"] = {"flops": counter.flops,
                                          "collectives": len(counter.collectives)}
    print(json.dumps(out))
""")

_PEAK = textwrap.dedent("""
    import json
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    shape = %(shape)r
    dryrun.fake_world(16)
    mesh = make_test_mesh(shape, ("pod", "data", "model")[-len(shape):],
                          device_type="cpu")
    cfg = make_smoke(get_config("granite-moe-1b-a400m"), d_model=256, n_heads=4,
                     kv_heads=2, head_dim=64, vocab=8191)
    counter, _ = dryrun.trace_cell(cfg, ShapeCell("t", "train", 64, 16), mesh,
                                   multi_pod=len(shape) == 3)
    print(json.dumps({"above_state": counter.peak_bytes - counter.baseline_bytes}))
""")

_PRODUCTION = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun, trace_collectives

    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False, {"n_layers": 2})
    trace_collectives.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                            "--overrides", "n_layers=2", "--top", "3"])
    print(json.dumps(rec, default=str))
""")

# the reference's RooflineRecord fields plus run_cell's own keys
RECORD_KEYS = {
    "arch", "cell", "mesh", "chips", "flops_per_dev", "bytes_per_dev",
    "wire_per_dev", "compute_s", "memory_s", "collective_s", "dominant",
    "model_flops_total", "useful_ratio", "collectives", "memory_stats",
    "supplements", "status", "multi_pod", "lower_s", "compile_s",
    "param_count", "active_param_count",
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    scripts = {
        "small": _SMALL % {"shape": (4, 2), "archs": ARCHS},
        "one": _SMALL % {"shape": (1, 1), "archs": ARCHS[:1]},
        "pod": _PEAK % {"shape": (2, 4, 2)},
        "flat": _PEAK % {"shape": (8, 2)},
        "production": _PRODUCTION,
    }
    procs = {k: subprocess.Popen([sys.executable, "-c", s], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, s in scripts.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out[k] = stdout
    return out


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_cells_trace(runs, arch):
    got = _last_json(runs["small"])
    for kind in ("train", "decode"):
        assert got[f"{arch}/{kind}"]["flops"] > 0
        assert got[f"{arch}/{kind}"]["collectives"] > 0


def test_no_rank_repeats_work(runs):
    per_rank = _last_json(runs["small"])["qwen1.5-0.5b/train"]["flops"]
    whole = _last_json(runs["one"])["qwen1.5-0.5b/train"]["flops"]
    assert abs(8 * per_rank - whole) <= 0.05 * whole


def test_pod_axis_adds_no_temporaries(runs):
    pod = _last_json(runs["pod"])["above_state"]
    flat = _last_json(runs["flat"])["above_state"]
    assert 0 < pod <= 1.01 * flat


def test_run_cell_record_has_the_reference_keys(runs):
    rec = _last_json(runs["production"])
    assert set(rec) == RECORD_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_dev"] > 0 and rec["memory_stats"]["peak_gb"] > 0
    assert set(rec["memory_stats"]) == {"argument_gb", "output_gb", "temp_gb",
                                        "alias_gb", "peak_gb"}


def test_trace_collectives_prints_its_total_line(runs):
    lines = runs["production"].splitlines()
    assert any(line.startswith("total collective result bytes/dev: ")
               and "modeled wire: " in line for line in lines)
    assert any(line.startswith("flops/dev=") for line in lines)
