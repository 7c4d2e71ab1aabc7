"""``BENCHMARK.json`` against the rules its runs are held to: keys,
names and units, files under ``paths``, what each cell reports, and the
time a full check of 24 cells would take at ``run_seconds``."""
import re

import pytest

import smoke  # noqa: F401  (puts the repository root on the path)
from portbench import spec as spec_mod

BENCH = spec_mod.benchmark()
TEXT = re.compile(r"^[^\t\n]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert len((spec_mod.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_just_their_keys(group):
    extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
    for e in BENCH[group]:
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]


def test_names_units_and_text():
    for group in KEYS:
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert "unit" not in e or UNIT.match(e["unit"]), e["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for group in KEYS:
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert e["better"] in ("lower", "higher")
    for e in BENCH["per_layer"]:
        assert TEXT.match(e["layer"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.match(e["why"])


def test_configs_and_cells_resolve_to_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(cells) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used and TEXT.match(c["source"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = spec_mod.read_json(spec_mod.ROOT / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (spec_mod.HERE / "reference" / f"{body['reference']}.py").exists()
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        spec = spec_mod.load_cell(w["name"])        # traffic, limits, driver
        assert (spec_mod.HERE / "drivers" / f"{spec['traffic']['driver']}.py").exists()


def test_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in spec_mod.metrics_of(
                BENCH, cell, "end_to_end")}, (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        rep = [m["name"] for m in spec_mod.metrics_of(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in rep and len(rep) >= 2
        per = spec_mod.metrics_of(BENCH, w["name"], "per_layer")
        assert per
        moved = {m["moves"] for m in per}
        # a kernel's roofline is reported beside the whole step's share of the peak
        for m in per:
            if "_roofline" in m["name"]:
                assert any("mfu" in x["name"] and x["moves"] == m["moves"] for x in per)
        assert moved <= set(rep)


def test_a_full_check_of_24_cells_fits():
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


def test_layers_name_one_layer_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
