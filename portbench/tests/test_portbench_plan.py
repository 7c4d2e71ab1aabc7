"""The layer plan that every count of layers follows.

Held fixed: for today's two configuration files the plan-based code
gives the trees and numbers of the formulas it replaced, kept here as
they were (``_frozen_*``: each layer attention plus the same MLP or
MoE), at smoke size and on a synthetic record.  A hybrid stack (a
test-local file and reference, ``hybrid-smoke.json`` and
``hybrid_smoke.py``: one attention layer in eight, the MoE on every
other one) runs through the backlog driver traced, and the counts
follow its plan: the kernels the port calls in the traced span are the
calls the harness counts.  ``port_config`` refuses a plan or a Mamba
size that the port does not run."""
import copy
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import smoke
from portbench import program, readers, roofline, serving
from portbench import spec as spec_mod
from portbench import trace as trace_mod
from portbench.reference import decoder
from test_portbench_metrics import _Engine, _Req

HYBRID = smoke.HERE / "hybrid-smoke.json"
CELLS = ("qwen-chat", "granite-backlog")
PAGED_DECODE_CALL = roofline.paged_decode_call


# -- the formulas as they were -------------------------------------------------

def _frozen_params_tree(w, cfg):
    layers = []
    for l in range(cfg["num_hidden_layers"]):
        attn = {name: {"kernel": w[name][l]} for name in ("wq", "wk", "wv", "wo")}
        for name in ("q", "k", "v"):
            if f"b{name}" in w:
                attn[f"w{name}"]["bias"] = w[f"b{name}"][l]
        layer = {"pre_norm": {"scale": w["pre_norm"][l]}, "attn": attn,
                 "post_norm": {"scale": w["post_norm"][l]}}
        if "router" in w:
            layer["moe"] = {"router": {"kernel": w["router"][l]},
                            **{k: w[k][l] for k in ("experts_up", "experts_gate",
                                                    "experts_down")}}
        else:
            layer["mlp"] = {k: {"kernel": w[k][l]}
                            for k in ("w_up", "w_gate", "w_down")}
        layers.append(layer)
    return {"embed": {"embedding": w["embed"]}, "layers": layers,
            "final_norm": {"scale": w["final_norm"]}}


def _frozen_live(live_tiles, cfg):
    tile = int(cfg["pruning"]["block"][0])
    layers = cfg["num_hidden_layers"]
    experts = max(cfg.get("num_local_experts", 0), 1)
    return {k: n * tile * tile / (layers * (experts if k.startswith("experts") else 1))
            for k, n in live_tiles.items()}


def _frozen_model_flops(cfg, live, tokens, contexts):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // h
    layers = cfg["num_hidden_layers"]
    topk = cfg.get("num_experts_per_tok", 0)
    per_layer = 2 * d * cfg.get("num_local_experts", 0)
    for kind, n in live.items():
        per_layer += 2 * n * (topk if kind.startswith("experts") else 1)
    fixed = layers * per_layer + 2 * d * cfg["vocab_size"]
    return float(fixed * tokens + 4 * h * dh * layers * contexts)


def _frozen_planes(rec):
    """(calls counted, least seconds), or None where the cell has no MoE."""
    cfg, tr = rec["cfg"], rec["traced"]
    if not cfg.get("num_local_experts"):
        return None
    layers, e_n, k = (cfg["num_hidden_layers"], cfg["num_local_experts"],
                      cfg["num_experts_per_tok"])
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    tile = int(cfg["pruning"]["block"][0])
    act = cfg["activ_dtype"]
    live = {kind: n // (layers * e_n) for kind, n in rec["live_tiles"].items()
            if kind.startswith("experts")}
    rows_per_call = [rec["num_slots"] * k] * tr["ticks"] + \
        [length * k for length, _ in tr["admissions"]]
    least = 0.0
    for rows in rows_per_call:
        for kind, kk, nn, extra in (("experts_up", d, f, 0),
                                    ("experts_gate", d, f, rows * f),
                                    ("experts_down", f, d, 0)):
            nb, fl = roofline.planes_call(rows, kk, nn, live[kind], e_n, tile=tile,
                                          act=act, weight=cfg["param_dtype"],
                                          extra_in=extra)
            least += layers * roofline.least_seconds(nb, fl, act)
    return 3 * layers * len(rows_per_call), least


def _frozen_decode(calls, cfg):
    """(decode calls, least seconds) of the decode ticks whose cached
    lengths are ``calls``."""
    layers = cfg["num_hidden_layers"]
    attn = dict(heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
                page_size=8, act=cfg["activ_dtype"], pool="float32")
    least = 0.0
    for lens in calls:
        nb, fl = PAGED_DECODE_CALL(lens, **attn)
        least += layers * roofline.least_seconds(nb, fl, "float32")
    return layers * len(calls), least


# -- today's two files -----------------------------------------------------------

def _file(name):
    return spec_mod.read_json(spec_mod.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name, mlp", [("qwen1.5-0.5b", "dense"),
                                       ("granite-moe-1b-a400m", "moe")])
def test_todays_files_plan_attention_everywhere(name, mlp):
    cfg = _file(name)
    plan = spec_mod.layer_plan(cfg)
    assert plan == [("attn", mlp)] * cfg["num_hidden_layers"] == [("attn", mlp)] * 24
    counts = spec_mod.plan_counts(cfg)
    assert counts["attn"] == counts[mlp] == counts["layers"] == 24
    assert counts["mamba"] == counts["dense" if mlp == "moe" else "moe"] == 0
    assert counts["experts"] == cfg.get("num_local_experts", 0)
    layers = program.port_config(cfg)
    assert (layers.n_layers, layers.use_rope, layers.head_dim_()) == (24, True, 64)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke_weights(cell):
    cfg = smoke.cell(cell)["config"]
    return cfg, decoder.make_weights(cfg, 2**31 + 5, "cpu")


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.data_ptr() == b.data_ptr() and a.shape == b.shape \
            and a.stride() == b.stride()


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_params_tree_and_live_weights_are_held(cell):
    cfg, w = _smoke_weights(cell)
    _same_tree(spec_mod.reference(cfg).params_tree(w, cfg), _frozen_params_tree(w, cfg))
    tiles = {k: int(v.sum()) for k, v in decoder.select_tiles(w, cfg).items()}
    plan = spec_mod.plan_counts(cfg)
    tile = cfg["pruning"]["block"][0]
    assert serving.live_per_matrix(tiles, plan, tile) == _frozen_live(tiles, cfg)


def _record(cfg, tiles):
    """A synthetic serving record over live tiles ``tiles``."""
    plan = spec_mod.plan_counts(cfg)
    return {"cfg": cfg, "plan": plan, "num_slots": 4, "live_tiles": tiles,
            "live": serving.live_per_matrix(tiles, plan, cfg["pruning"]["block"][0]),
            "per_token": serving.per_token(cfg), "window_s": 2.5,
            "traced": {"ticks": 7, "admissions": [(24, 0), (40, 8), (9, 16)]},
            "flops_in": {"decode_tokens": 130, "decode_contexts": 5100,
                         "prefill_tokens": 73, "prefill_contexts": 2900}}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("size", ["smoke", "published"])
def test_the_model_flops_and_the_planes_count_are_held(cell, size):
    """At smoke size over the reference's own selection, and at the
    published widths over a made-up one."""
    if size == "smoke":
        cfg, w = _smoke_weights(cell)
        tiles = {k: int(v.sum()) for k, v in decoder.select_tiles(w, cfg).items()}
    else:
        cfg = spec_mod.load_cell(cell)["config"]
        plan = spec_mod.plan_counts(cfg)
        tiles = {k: 3 * spec_mod.matrices(k, plan) for k in decoder.prunable_kinds(cfg)}
    rec = _record(cfg, tiles)
    f = rec["flops_in"]
    _close(roofline.model_flops(cfg, rec["plan"], rec["live"], 203, 8000,
                                **rec["per_token"]),
           _frozen_model_flops(cfg, _frozen_live(tiles, cfg), 203, 8000))
    want = _frozen_model_flops(cfg, _frozen_live(tiles, cfg),
                               f["decode_tokens"] + f["prefill_tokens"],
                               f["decode_contexts"] + f["prefill_contexts"])
    _close(readers.serve_mfu(rec),
           100.0 * want / (2.5 * roofline.PEAK_FLOPS[cfg["param_dtype"]]))
    frozen = _frozen_planes(rec)
    if frozen is None:
        assert rec["plan"]["moe"] == 0
        assert readers.planes_roofline(dict(rec, trace={"ops": {}})) is None
    else:
        assert readers.planes_calls(rec) == frozen


@pytest.mark.parametrize("cell", CELLS)
def test_the_decode_count_is_held(cell, monkeypatch):
    cfg = smoke.cell(cell)["config"]
    seen = []

    def kept(lens, **kw):
        seen.append(np.array(lens))
        return PAGED_DECODE_CALL(lens, **kw)

    monkeypatch.setattr(roofline, "paged_decode_call", kept)
    eng = _Engine([_Req(0, 10, 6), _Req(1, 20, 9), _Req(2, 5, 3)])
    meter = serving.Meter(eng, cfg, events=False)
    meter.trace = SimpleNamespace(running=True)
    meter.open_window()
    for _ in range(4):
        eng.step()
    meter.close_window()
    meter.detach()
    assert seen and meter.program is None
    calls, least = _frozen_decode(seen, cfg)
    assert meter.traced["decode_calls"] == calls
    assert meter.traced["decode_least_s"] == least
    assert meter.traced["ticks"] == len(seen)


# -- port_config refuses what the port does not run ---------------------------------

def _hybrid():
    return spec_mod.read_json(HYBRID)


@pytest.mark.parametrize("change, says", [
    ({"attn_layer_offset": 3}, "differ at layers [3, 4]"),
    ({"mamba_expand": 3}, "mamba_expand at 2"),
    ({"mamba_dt_rank": 128}, "mamba_dt_rank at 8"),
    ({"expert_layer_offset": 0}, "differ at layers [0, 1, 2, 3, 4, 5, 6, 7]"),
    ({"num_hidden_layers": 12, "attn_layer_period": 6, "attn_layer_offset": 4},
     "differ at layers [10]"),
    ({"mamba_n_groups": 1}, "no field for ['mamba_n_groups']"),
    ({"assumed": {"kv_lora_rank": 512}}, "no field for ['kv_lora_rank']"),
])
def test_port_config_refuses_a_plan_or_size_the_port_does_not_run(change, says):
    with pytest.raises(ValueError) as err:
        program.port_config({**_hybrid(), **change})
    assert says in str(err.value)


def test_port_config_follows_the_hybrid_file():
    cfg = _hybrid()
    plan = spec_mod.layer_plan(cfg)
    assert [i for i, (m, _) in enumerate(plan) if m == "attn"] == [4]
    assert [i for i, (_, m) in enumerate(plan) if m == "moe"] == [1, 3, 5, 7]
    counts = spec_mod.plan_counts(cfg)
    assert (counts["attn"], counts["mamba"], counts["moe"], counts["dense"],
            counts["experts"]) == (1, 7, 4, 4, 4)
    mcfg = program.port_config(cfg)
    smoke_cfg = _shim().model(cfg)
    for field in ("d_model", "n_layers", "n_heads", "kv_heads", "head_dim", "d_ff",
                  "vocab", "moe_experts", "moe_top_k", "d_state", "d_conv",
                  "mixer_pattern", "mlp_pattern", "use_rope"):
        assert getattr(mcfg, field) == getattr(smoke_cfg, field), field
    assert program.port_config({**cfg, "use_rope": False}).use_rope is False
    # the catalog's Jamba keys that are no size of the port pass: flags, null,
    # the numbers the harness reads itself, and a size stated as 0
    extra = {"mamba_conv_bias": True, "mamba_proj_bias": False,
             "use_mamba_kernels": True, "sliding_window": None,
             "max_position_embeddings": 262144, "num_logits_to_keep": 1,
             "n_shared_experts": 0, "model_type": "jamba"}
    assert program.port_config({**cfg, **extra}) == mcfg


def _shim():
    import hybrid_smoke
    return hybrid_smoke


# -- a hybrid stack through the harness ---------------------------------------------

def test_a_hybrid_stack_counts_by_its_plan(monkeypatch):
    program.import_port()
    from repro_torch.kernels import ops
    monkeypatch.setitem(sys.modules, "portbench.reference.hybrid_smoke", _shim())
    spec = copy.deepcopy(smoke.cell("granite-backlog"))
    spec["config"] = _hybrid()
    spec["limits"] = {"served_gap": 1e9}
    spec["traffic"]["trace_from"] = 0.0     # the whole window: a slow step can't skip it

    # the port's kernels (their plain versions on the CPU), counted while traced
    traced, calls = [False], {"decode": 0, "planes": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += traced[0]
            return fn(*a, **kw)
        return call

    for name, attr in (("decode", "paged_attention_decode_plain"),
                       ("planes", "bsr_planes_matmul_plain")):
        monkeypatch.setattr(ops, attr, counted(name, getattr(ops, attr)))
    start, stop = trace_mod.Trace.start, trace_mod.Trace.stop

    def traced_start(self):
        start(self)
        traced[0] = True

    def traced_stop(self):
        traced[0] = False
        stop(self)

    monkeypatch.setattr(trace_mod.Trace, "start", traced_start)
    monkeypatch.setattr(trace_mod.Trace, "stop", traced_stop)

    drv = spec_mod.driver(spec["traffic"]["driver"])
    out = drv.run(spec, 2**31 + 17, 1.5, True, torch.device("cpu"))
    rec = out["record"]
    plan, tr = rec["plan"], rec["traced"]
    assert (plan["attn"], plan["moe"], plan["experts"]) == (1, 4, 4)
    assert tr["ticks"] > 0 and tr["admissions"]
    # one paged decode a tick: the one attention layer
    assert tr["decode_calls"] == 1 * tr["ticks"] == calls["decode"]
    # up, gate and down in each of 4 MoE layers, at each tick and admission
    groups = tr["ticks"] + len(tr["admissions"])
    assert readers.planes_calls(rec)[0] == 3 * 4 * groups == calls["planes"]
    # each expert kind's live weights over 4 MoE layers of 4 experts each
    tile = spec["config"]["pruning"]["block"][0]
    over = {"attn": 1, "dense": 4, "moe": 4 * 4}
    for kind, n in rec["live_tiles"].items():
        assert rec["live"][kind] == n * tile * tile / over[spec_mod.KIND_LAYER[kind]]
    assert set(rec["live"]) == set(spec_mod.KIND_LAYER)
    assert readers.serve_mfu(rec) > 0
    assert any(s[0] == "engine.step" for s in rec["program"]["spans"])
    assert rec["trace"]["program_idle"]
