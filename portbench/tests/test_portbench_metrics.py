"""The harness's metric arithmetic on synthetic timestamps and records:
tails over every request (a failure counts as missing), rates over the
whole window, the meter's counts from an engine's slots, the readers."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

import smoke  # noqa: F401  (puts the repository root on the path)
from portbench import readers, roofline, serving
from portbench import spec as spec_mod
from portbench import trace as trace_mod


def test_p95_is_the_nearest_rank():
    assert serving.p95(range(1, 101)) == 95
    assert serving.p95(range(1, 21)) == 19
    assert serving.p95([5.0]) == 5.0
    assert serving.p95([1.0] * 95 + [math.inf] * 5) == 1.0
    assert serving.p95([1.0] * 94 + [math.inf] * 6) == math.inf


def test_tails_count_every_request_and_failures_as_missing():
    rows = []
    for i in range(100):          # first token 10 + i ms after the send
        sched = float(i)
        first = sched + 0.010 + i * 1e-3
        rows.append((sched, first, first + 0.020 * 9, 10, True))   # 20 ms/token
    tails, failed = serving.open_loop_tails(rows)
    assert failed == 0
    assert tails["ttft_p95_ms"] == pytest.approx(10 + 94)
    assert tails["tpot_p95_ms"] == pytest.approx(20.0)
    # failures are inf, not left out: 6 of 100 push the p95 past every number
    bad = rows[:94] + [(float(i), None, None, 0, False) for i in range(6)]
    tails, failed = serving.open_loop_tails(bad)
    assert failed == 6 and tails["ttft_p95_ms"] == math.inf
    # a late first token is measured from the schedule, not the submission
    tails, _ = serving.open_loop_tails([(0.0, 0.5, 0.5, 1, True)])
    assert tails["ttft_p95_ms"] == pytest.approx(500.0)
    assert tails["tpot_p95_ms"] == 0.0


class _Req:
    def __init__(self, rid, prompt_len, max_new, hit_pages=0):
        self.rid, self.prompt_len, self.max_new = rid, prompt_len, max_new
        self.prefix_hit_pages = hit_pages
        self.tokens = None

    @property
    def terminal(self):
        return self.tokens is not None


class _Engine:
    """The parts of ``ServingEngine`` the meter reads: ``slots`` with
    ``req`` and ``emitted``, ``step`` calling ``_admit`` then
    ``_run_chunk``, ``num_slots`` and the pool's page size."""

    def __init__(self, reqs, slots=2, ticks=4):
        self.queue, self.num_slots, self.ticks = list(reqs), slots, ticks
        self.slots = [None] * slots
        self.pool = SimpleNamespace(page_size=8)

    def _admit(self):
        n = 0
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = SimpleNamespace(req=self.queue.pop(0), emitted=[7])
                n += 1
        return n

    def _run_chunk(self, packed, ticks, sampled):
        return None

    def step(self):
        n = self._admit()
        self._run_chunk(None, self.ticks, False)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.emitted.extend([1] * min(self.ticks, s.req.max_new - len(s.emitted)))
            if len(s.emitted) >= s.req.max_new:
                s.req.tokens = np.asarray(s.emitted)
                self.slots[i] = None
        return n


def _cfg():
    return {"num_attention_heads": 4, "num_key_value_heads": 2, "hidden_size": 64,
            "num_hidden_layers": 3, "activ_dtype": "bfloat16"}


def test_meter_counts_tokens_contexts_and_last_tokens():
    reqs = [_Req(0, 10, 6), _Req(1, 20, 6), _Req(2, 5, 3)]
    eng = _Engine(reqs)
    meter = serving.Meter(eng, _cfg(), events=False)
    meter.open_window()
    eng.step()          # admits 0 and 1, each emits 1 + 4
    eng.step()          # 0 and 1 emit 1 more each and finish
    meter.close_window()
    eng.step()          # outside the window: 2 is admitted and finishes
    assert meter.emitted == 2 + 8 + 2
    assert [r.rid for r in meter.admitted] == [0, 1]
    assert meter.decode_ctx[0] == 10
    # request 0 attends over 11..14 then 15, request 1 over 21..24 then 25
    assert meter.decode_ctx[1] == (11 + 12 + 13 + 14 + 15) + (21 + 22 + 23 + 24 + 25)
    assert set(meter.last_token) == {0, 1, 2}
    assert meter.window_chunks == 2 and meter.slot_share() == 1.0
    meter.detach()
    assert eng.step.__self__ is eng


def test_prefix_share_counts_the_windows_admissions_only():
    reqs = [_Req(0, 40, 6, hit_pages=4), _Req(1, 24, 6), _Req(2, 48, 3, hit_pages=2)]
    eng = _Engine(reqs, slots=1)
    meter = serving.Meter(eng, _cfg(), events=False)
    eng.step()          # before the window (a lead-in): request 0, 4 pages hit
    meter.open_window()
    for _ in range(4):
        eng.step()      # 1 (no hit), then 2 (2 pages hit)
    meter.close_window()
    assert [r.rid for r in meter.admitted] == [1, 2]
    assert serving.prefix_counts(meter.admitted, 8) == {"tokens_mapped": 16,
                                                        "prompt_tokens": 72}
    meter.detach()


def test_readers_on_a_synthetic_record():
    cfg = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
           "vocab_size": 100, "param_dtype": "bfloat16", "activ_dtype": "bfloat16",
           "pruning": {"block": [32, 32]}}
    rec = {"cfg": cfg, "window_s": 2.0,
           "trace": {"window_s": 4.0, "busy_s": 3.0,
                     "ops": {"void paged_decode_kernel<f>": {"seconds": 0.5, "calls": 6}}},
           "traced": {"decode_calls": 6, "decode_least_s": 0.25, "ticks": 3,
                      "admissions": []},
           "prefix": {"tokens_mapped": 30, "prompt_tokens": 120},
           "flops_in": {"decode_tokens": 10, "decode_contexts": 100,
                        "prefill_tokens": 5, "prefill_contexts": 15},
           "live": {"wq": 1000.0}, "host": {"admit_host_ms": 1.5},
           "plan": spec_mod.plan_counts(cfg),
           "per_token": {"dense_weights": 0, "other_flops": 0}}
    assert readers.idle_share(rec) == pytest.approx(25.0)
    assert readers.prefix_hit_share(rec) == pytest.approx(25.0)
    assert readers.paged_decode_roofline(rec) == pytest.approx(50.0)
    assert readers.host(rec, "admit_host_ms") == 1.5
    flops = (2 * (2 * 1000) + 2 * 64 * 100) * 15 + 4 * 4 * 16 * 2 * 115
    assert readers.serve_mfu(rec) == pytest.approx(
        100 * flops / (2.0 * roofline.PEAK_FLOPS["bfloat16"]))
    # a kernel count that disagrees with the counted calls reads nothing
    rec["traced"]["decode_calls"] = 7
    assert readers.paged_decode_roofline(rec) is None
    assert readers.idle_share(dict(rec, trace=None)) is None
    assert readers.host(dict(rec, host=None), "admit_host_ms") is None


def test_planes_reader_counts_every_call():
    cfg = {"hidden_size": 256, "num_attention_heads": 4, "num_hidden_layers": 2,
           "intermediate_size": 128, "num_local_experts": 4, "num_experts_per_tok": 2,
           "vocab_size": 100, "param_dtype": "bfloat16", "activ_dtype": "bfloat16",
           "pruning": {"block": [128, 128]}}
    live = {"experts_up": 2 * 4 * 1, "experts_gate": 2 * 4 * 1, "experts_down": 2 * 4 * 1}
    rec = {"cfg": cfg, "num_slots": 8, "live_tiles": live,
           "plan": spec_mod.plan_counts(cfg),
           "trace": {"ops": {"bsr_planes_kernel<x>": {"seconds": 1.0, "calls": 3 * 2 * 3}}},
           "traced": {"ticks": 2, "admissions": [(5, 0)]}}
    least = 0.0
    for rows in (16, 16, 10):
        for kk, nn, extra in ((256, 128, 0), (256, 128, rows * 128), (128, 256, 0)):
            nb, fl = roofline.planes_call(rows, kk, nn, 1, 4, tile=128, act="bfloat16",
                                          weight="bfloat16", extra_in=extra)
            least += 2 * roofline.least_seconds(nb, fl, "bfloat16")
    assert readers.planes_roofline(rec) == pytest.approx(100 * least)


def test_idle_gaps_go_to_the_innermost_host_span():
    merged = [[0, 10], [20, 30], [100, 110]]
    host = [(0, 200, "engine.step"), (15, 35, "engine._admit")]
    gaps = trace_mod._attribute_gaps(merged, host)
    assert gaps == {"engine._admit": pytest.approx(10e-9),
                    "engine.step": pytest.approx(70e-9)}
    assert trace_mod._attribute_gaps([[0, 1], [5, 6]], []) == {
        trace_mod.OUTSIDE: pytest.approx(4e-9)}


def test_every_per_layer_metric_has_a_reader():
    bench = spec_mod.benchmark()
    for m in bench["per_layer"]:
        mod = spec_mod.metric_reader(m["name"])
        assert callable(mod.read), m["name"]


def test_training_readers_on_a_synthetic_record():
    cfg = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
           "num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 100,
           "param_dtype": "bfloat16"}
    job = {"batch": 2, "seq": 8}
    rec = {"cfg": cfg, "job": job, "window_s": 4.0, "steps": 10, "traced_steps": 4,
           "knapsack_s": [0.5, 0.7],
           "trace": {"window_s": 2.0, "busy_s": 1.5,
                     "ops": {"Memcpy DtoD (Device -> Device)": {"seconds": 0.02,
                                                                "calls": 9}}}}
    assert readers.knapsack_s(rec) == pytest.approx(0.6)
    assert readers.train_copy_ms(rec) == pytest.approx(5.0)
    assert readers.idle_share(rec) == pytest.approx(25.0)
    # 6 per product weight per token: q, o (64 x 64), k, v (64 x 32),
    # up, gate, down (64 x 128) in 2 layers and the 100 x 64 head, plus
    # 12 * 4 * 16 per attended position per layer over 8 * 9 / 2 positions
    n = 2 * (2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128) + 100 * 64
    flops = 6 * n * 16 + 12 * 2 * 64 * 2 * 36
    assert roofline.train_step_flops(cfg, 2, 8) == pytest.approx(flops)
    assert readers.train_mfu(rec) == pytest.approx(
        100 * 10 * flops / (4.0 * roofline.PEAK_FLOPS["bfloat16"]))
    assert readers.train_copy_ms(dict(rec, traced_steps=0)) is None
    assert readers.knapsack_s(dict(rec, knapsack_s=[])) is None


def test_paged_decode_and_bsr_counts_from_shapes():
    nb, fl = roofline.paged_decode_call([0, 7, 8], heads=4, kv_heads=2, head_dim=16,
                                        page_size=8, act="bfloat16", pool="float32")
    q = 3 * 4 * 16 * 2
    new_kv = 2 * 3 * 2 * 16 * 2
    cached = (0 + 7 + 8) * 2 * 16 * 4 * 2
    pages = (0 + 1 + 1) * 4
    out = 3 * 4 * 16 * 4
    assert nb == q + new_kv + cached + pages + 3 * 4 + out
    assert fl == 4 * 4 * 16 * (1 + 8 + 9)
    nb, fl = roofline.bsr_call(5, 256, 128, 3, tile=128, act="bfloat16",
                               weight="bfloat16", extra_in=5 * 128)
    assert nb == 3 * 128 * 128 * 2 + 5 * 256 * 2 + 5 * 128 * 2 + 5 * 128 * 2
    assert fl == 2 * 5 * 3 * 128 * 128
    nb, fl = roofline.planes_call(10, 256, 128, 2, 4, tile=128, act="bfloat16",
                                  weight="bfloat16")
    assert nb == 4 * 2 * 128 * 128 * 2 + 10 * 256 * 2 + 10 * 128 * 2
    assert fl == 2 * 10 * 2 * 128 * 128
    # bytes bound unless the operations are: 1 GB over 3.35 TB/s
    assert roofline.least_seconds(1e9, 1.0, "bfloat16") == pytest.approx(1e9 / 3.35e12)
    assert roofline.least_seconds(1.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert roofline.prefill_contexts(3, 5) == 6 + 7 + 8


def test_trace_reduction_leaves_annotations_out():
    s = 10**9
    events = [
        ("ProfilerStep#1", 0, 4 * s, True),            # the profiler's own range
        ("portbench.engine.step", 0, 4 * s, False),
        ("portbench.engine.step", 0, 4 * s, True),     # its device-side copy
        ("portbench.engine._admit", int(1.5 * s), int(2.5 * s), False),
        ("kernel_a", 0, 1 * s, True),
        ("kernel_b", int(0.5 * s), int(1.5 * s), True),
        ("kernel_a", 3 * s, 4 * s, True),
        ("aten::mm", 0, 4 * s, False),                 # host op, not device time
    ]
    out = trace_mod.reduce_events(events, 4.0)
    assert out["busy_s"] == pytest.approx(2.5)
    assert out["ops"]["kernel_a"] == {"seconds": pytest.approx(2.0), "calls": 2}
    assert set(out["ops"]) == {"kernel_a", "kernel_b"}
    assert dict((k, v) for k, v in out["breakdown"]["idle_gaps"]) == {
        "engine._admit": pytest.approx(1.5)}
    assert out["breakdown"]["device_ops"][0] == ["kernel_a", pytest.approx(2.0)]
