"""What the serving cells share: set-up, warm-up, the meter around the
engine, and the judgement after the window.

Set-up makes the weights from the seed on the card, hands them to the
port in the layout the configuration's reference gives
(``params_tree``), which prunes and packs them and builds its engine,
then warms up every variant the traffic can reach: each admission
prefill ``(L, start)`` (twice: the capture, then a replay) and each
decode-chunk variant, and releases the prefix cache, so the window's
hits are its own.

:class:`Meter` is ``chip_smoke.HostSplit``'s arithmetic, applied from
outside to one engine instance: host wall of ``step``, ``_admit`` and
``_run_chunk`` (``perf_counter``), with ``--trace 1`` CUDA events around
every ``CUDAGraph.replay`` (the admission's when inside ``_admit``) and
``record_function`` spans for the trace.  It also stamps each chunk's
return, which is when the host sees the chunk's tokens, and counts the
work of every step from the engine's slots: tokens emitted, the
prefills admitted, and each decode tick's cached lengths, over the
attention layers of the configuration's layer plan.  In a traced run it
turns the port's own tracer on at the window's open and off at its
close, so the window's spans and counters of the program land in the
run's record (``record["program"]``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import generate, program, roofline
from .reference import judge
from .spec import matrices, plan_counts, reference

__all__ = ["Meter", "setup", "judge_served", "p95"]


def p95(values) -> float:
    """The 95th percentile by nearest rank: the ``ceil(0.95 n)``-th
    smallest (a failed request is ``inf``)."""
    v = sorted(values)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def open_loop_tails(rows):
    """``ttft_p95_ms`` and ``tpot_p95_ms`` over every request sent, from
    rows ``(scheduled send, first-token time, last-token time, tokens,
    finished)``: TTFT is first-token time less the scheduled send, TPOT
    (last - first) / (tokens - 1); a request that did not finish counts
    as missing (``inf``) in both.  Returns (the two, failed requests)."""
    ttft, tpot, failed = [], [], 0
    for sched, first, last, k, ok in rows:
        if not ok or first is None:
            failed += 1
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        ttft.append(first - sched)
        tpot.append((last - first) / (k - 1) if k > 1 else 0.0)
    return ({"ttft_p95_ms": p95(ttft) * 1e3, "tpot_p95_ms": p95(tpot) * 1e3},
            failed)


class Meter:
    """Wraps one engine's ``step``, ``_admit`` and ``_run_chunk``.

    ``window`` (bool) says whether a step counts for the window's
    totals; ``trace`` (a :class:`portbench.trace.Trace` or None) whether
    the step's work is recorded for the rooflines.  With ``program`` the
    port's tracer records over the window, and ``self.program`` holds
    what it recorded once the window has closed."""

    def __init__(self, eng, cfg: Dict, *, events: bool, program: bool = False):
        self.eng, self.cfg, self.events = eng, cfg, events
        self.traced_program, self.program = program, None
        self.window = False
        self.trace = None
        self.wall = {"step": 0.0, "admit": 0.0, "chunk": 0.0}
        self.chunks = 0
        self.replays = {"admission": [], "chunk": []}
        self.in_admit = False
        self.last_token: Dict[int, float] = {}
        self.emitted = 0                      # tokens, window steps
        self.admitted: List = []              # requests admitted in window steps
        self.decode_ctx = [0, 0]              # emitted decode tokens, sum of contexts
        self.traced = {"ticks": 0, "decode_least_s": 0.0, "decode_calls": 0,
                       "admissions": []}
        self.occupied = [0, 0]                # slots in use, slots, over window chunks
        self._chunk = None
        self._orig = (eng.step, eng._admit, eng._run_chunk)
        eng.step, eng._admit, eng._run_chunk = self._step, self._admit, self._run_chunk
        self.ps = eng.pool.page_size
        self.attn_layers = plan_counts(cfg)["attn"]
        self._attn = dict(heads=cfg["num_attention_heads"],
                          kv_heads=cfg["num_key_value_heads"],
                          head_dim=(cfg.get("head_dim")
                                    or cfg["hidden_size"] // cfg["num_attention_heads"]),
                          page_size=self.ps, act=cfg["activ_dtype"],
                          pool="float32")

    def slot_share(self) -> float:
        return self.occupied[0] / max(self.occupied[1], 1)

    def detach(self) -> None:
        self.eng.step, self.eng._admit, self.eng._run_chunk = self._orig

    def _span(self, name):
        if self.trace is not None and self.trace.running:
            return torch.profiler.record_function("portbench." + name)
        return contextlib.nullcontext()

    # -- the wrappers ------------------------------------------------------

    def _admit(self):
        eng = self.eng
        before = {id(s.req) for s in eng.slots if s is not None}
        self.in_admit = True
        t0 = time.perf_counter()
        try:
            with self._span("engine._admit"):
                n = self._orig[1]()
        finally:
            self.in_admit = False
            self.wall["admit"] += time.perf_counter() - t0
        new = [s.req for s in eng.slots if s is not None and id(s.req) not in before]
        if self.window:
            self.emitted += len(new)
            self.admitted.extend(new)
        if self.trace is not None and self.trace.running:
            self.traced["admissions"].extend(
                (r.prompt_len - r.prefix_hit_pages * self.ps,
                 r.prefix_hit_pages * self.ps) for r in new)
        return n

    def _run_chunk(self, packed, ticks, sampled):
        rows = [(i, s.req, len(s.emitted)) for i, s in enumerate(self.eng.slots)
                if s is not None]
        t0 = time.perf_counter()
        with self._span("engine._run_chunk"):
            out = self._orig[2](packed, ticks, sampled)
        t1 = time.perf_counter()
        self.wall["chunk"] += t1 - t0
        self.chunks += 1
        if self.window:
            self.occupied[0] += len(rows)
            self.occupied[1] += self.eng.num_slots
        self._chunk = (ticks, rows, t1)
        return out

    def _step(self):
        t0 = time.perf_counter()
        with self._span("engine.step"):
            n = self._orig[0]()
        self.wall["step"] += time.perf_counter() - t0
        if self._chunk is not None:
            self._after_chunk(*self._chunk)
            self._chunk = None
        return n

    def _after_chunk(self, ticks, rows, t_ret) -> None:
        eng = self.eng
        lens = np.zeros((ticks, eng.num_slots), np.int64)
        for i, req, e0 in rows:
            if req.terminal:
                e1 = len(req.tokens)
                self.last_token[req.rid] = t_ret
            else:
                e1 = len(eng.slots[i].emitted)
            n = e1 - e0
            c0 = req.prompt_len + e0 - 1           # cached positions at the start
            lens[:, i] = c0 + np.minimum(np.arange(ticks), n)
            if self.window:
                self.emitted += n
                self.decode_ctx[0] += n
                self.decode_ctx[1] += n * (c0 + 1) + n * (n - 1) // 2
        if self.trace is not None and self.trace.running:
            layers = self.attn_layers
            for t in range(ticks):
                nb, fl = roofline.paged_decode_call(lens[t], **self._attn)
                self.traced["decode_least_s"] += layers * roofline.least_seconds(
                    nb, fl, "float32")
            self.traced["decode_calls"] += layers * ticks
            self.traced["ticks"] += ticks

    # -- CUDA events around graph replays (HostSplit) ------------------------

    @contextlib.contextmanager
    def replay_events(self):
        """Inside the block every ``CUDAGraph.replay`` is timed on the
        card by a pair of CUDA events."""
        if not self.events:
            yield
            return
        replay = torch.cuda.CUDAGraph.replay
        meter = self

        def timed(graph):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            replay(graph)
            ev[1].record()
            if meter.window:
                meter.replays["admission" if meter.in_admit else "chunk"].append(ev)

        torch.cuda.CUDAGraph.replay = timed
        try:
            yield
        finally:
            torch.cuda.CUDAGraph.replay = replay

    def host_split(self, captures_s: float) -> Dict:
        """ms per admission and per chunk, host and device, over the
        window's steps (after a synchronise)."""
        def spans(evs):
            return [a.elapsed_time(b) for a, b in evs]
        adm = spans(self.replays["admission"])
        chk = spans(self.replays["chunk"])
        n_adm = max(len(self.admitted), 1)
        w = {k: v * 1e3 for k, v in self.window_wall.items()}
        return {
            "admissions": len(self.admitted), "chunks": self.window_chunks,
            "admit_host_ms": (w["admit"] - captures_s * 1e3 - sum(adm)) / n_adm,
            "chunk_host_ms": (w["step"] - w["admit"] - w["chunk"])
            / max(self.window_chunks, 1),
            "prefill_device_ms": float(np.mean(adm)) if adm else None,
            "chunk_device_ms": float(np.mean(chk)) if chk else None,
        }

    def open_window(self) -> None:
        self.window = True
        self._wall0 = dict(self.wall)
        self._chunks0 = self.chunks
        self.t_open = time.perf_counter()
        if self.traced_program:
            program.tracer_on()

    def close_window(self) -> None:
        if self.traced_program:
            self.program = program.tracer_off()
        self.window = False
        self.t_close = time.perf_counter()
        self.window_wall = {k: self.wall[k] - self._wall0[k] for k in self.wall}
        self.window_chunks = self.chunks - self._chunks0


def prefix_counts(admitted, page_size: int) -> Dict:
    """Prompt tokens the window's admissions mapped from the prefix
    cache (each request's ``prefix_hit_pages``), and their prompt
    tokens: what the lead-in's admissions hit is not counted."""
    return {"tokens_mapped": int(sum(r.prefix_hit_pages for r in admitted)) * page_size,
            "prompt_tokens": int(sum(r.prompt_len for r in admitted))}


def _drain(eng, limit_s: float = 300.0) -> None:
    t0 = time.perf_counter()
    while eng.scheduler.pending or any(s is not None for s in eng.slots):
        eng.step()
        if time.perf_counter() - t0 > limit_s:
            raise RuntimeError("warm-up did not drain")


def warm_up(eng, traffic: Dict, vocab: int, seed: int) -> Dict:
    """Capture every prefill variant the mix can reach and replay it
    once, and every decode-chunk variant (greedy; sampled where the mix
    samples), then release the prefix cache.  Returns what was warmed."""
    rng = np.random.default_rng(generate.subseed(seed, "warm-up"))
    ps = eng.pool.page_size
    todo = generate.variants(traffic, ps)
    sampling = traffic.get("sampling") or {}
    shortest = min(length for length, start in todo if start == 0)

    def serve(prompt, max_new=1, **kw):
        eng.submit(prompt, max_new, arrival=eng.tick, **kw)
        _drain(eng)

    for _ in range(2):                               # capture, then a replay
        cached: List[np.ndarray] = []                # cold prompts, now cached
        for length, start in sorted(todo, key=lambda v: v[1]):
            if start == 0:                           # fresh tokens: no hit
                cached.append(rng.integers(0, vocab, size=length))
                serve(cached[-1])
                continue
            # behind the page-aligned blocks of a cached longer prompt
            head = next(p for p in cached if len(p) > start)[:start]
            serve(np.concatenate([head, rng.integers(0, vocab, size=length)]))
        for sampled in ([False, True] if sampling and
                        traffic.get("greedy_share", 1.0) < 1.0 else [False]):
            kw = dict(sampling) if sampled else {"temperature": 0.0}
            serve(rng.integers(0, vocab, size=shortest),
                  2 * eng.ticks_per_sync + 1, **kw)
    eng.release_prefix_cache()
    an = eng.analysis_stats()
    return {"prefill_variants": an["prefill_captures"],
            "chunk_variants": an["captures"],
            "capture_s": _capture_seconds(an)}


def _capture_seconds(an) -> float:
    return (sum(an.get("capture_seconds", {}).values())
            + sum(an.get("prefill_capture_seconds", {}).values()))


def setup(spec: Dict, seed: int, device) -> Dict:
    """Weights, the port's packed params and engine, warmed up."""
    cfg, traffic = spec["config"], spec["traffic"]
    built_s = program.build_kernels(device)
    weights = reference(cfg).make_weights(cfg, seed, device)
    model_cfg = program.port_config(cfg)
    packed, summ = program.pack(reference(cfg).params_tree(weights, cfg), cfg)
    eng = program.engine(packed, model_cfg, traffic, seed, device)
    warmed = warm_up(eng, traffic, cfg["vocab_size"], seed)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"weights": weights, "packed": packed, "summary": summ,
            "engine": eng, "warmed": warmed, "build_s": built_s}



def captures_in_window(eng, warmed: Dict) -> Dict:
    an = eng.analysis_stats()
    return {"prefill": an["prefill_captures"] - warmed["prefill_variants"],
            "chunk": an["captures"] - warmed["chunk_variants"],
            "seconds": _capture_seconds(an) - warmed["capture_s"],
            "variants": an["prefill_variants"]}


def served(req, top_k: Optional[int] = None) -> Optional[Dict]:
    """A finished request as the judgement reads it: greedy when
    ``top_k`` is None, else sampled from the ``top_k`` best."""
    if req.tokens is None or len(req.tokens) == 0:
        return None
    return {"rid": req.rid, "prompt": np.asarray(req.prompt, np.int64),
            "served": np.asarray(req.tokens, np.int64), "greedy": top_k is None,
            "top_k": top_k}


def judge_served(done: List[Dict], cfg: Dict, traffic: Dict, weights: Dict,
                 seed: int, device, *, control: bool = False) -> Dict:
    """The reference's widest gaps over a seeded sample of the finished
    requests, greedy and sampled (and, with ``control``, the fp8
    control's on the same positions).  Returns the readings, the
    selection's live tiles and the sample's size."""
    check = traffic["check"]
    rng = np.random.default_rng(generate.subseed(seed, "judge"))
    sample = judge.sample_requests(done, rng, count=int(check["requests"]),
                                   min_tokens=int(check["min_tokens"]),
                                   sampled=int(check.get("sampled", 0)))
    decoder = reference(cfg)
    keep = decoder.select_tiles(weights, cfg)
    live = {k: int(v.sum()) for k, v in keep.items()}
    w32 = decoder.masked(weights, keep, cfg)
    del keep

    def ref(ids):
        return decoder.forward(w32, ids, cfg)

    out = {"requests": len(sample),
           "sampled": int(sum(not r["greedy"] for r in sample)),
           "tokens": int(sum(len(r["served"]) for r in sample)),
           "gaps": judge.served_gaps(ref, sample, device), "live": live}
    if control:
        w8 = decoder.quantized(w32)
        out["control_gaps"] = judge.control_gaps(
            ref, lambda ids: decoder.forward(w8, ids, cfg), sample, device)
    return out


def run_serving(spec: Dict, seed: int, seconds: float, trace: bool, device,
                window, hooks: Optional[Dict] = None) -> Dict:
    """One run of a serving cell.  ``window(eng, meter, reqs, seconds,
    tracer)`` is the driver's measured window; it returns its requests'
    records (``done``: served requests to judge) and its end-to-end
    numbers.  ``hooks["fault"]()`` plants a fault (``portbench.faults``)
    before set-up; with ``hooks["control"]`` the judgement also reads
    the control."""
    from .trace import Trace
    cfg, traffic = spec["config"], spec["traffic"]
    if hooks and "fault" in hooks:
        hooks["fault"]()
    state = setup(spec, seed, device)
    build_s, state_summary = state["build_s"], state["summary"]
    eng = state["engine"]
    reqs = generate.stream(traffic, cfg["vocab_size"], seed, seconds)
    meter = Meter(eng, cfg, events=trace, program=trace)
    tracer = Trace(device) if trace else None
    meter.trace = tracer
    gc.collect()
    gc.freeze()
    with meter.replay_events():
        out = window(eng, meter, reqs, seconds, tracer)
    gc.unfreeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    captured = captures_in_window(eng, state["warmed"])
    host = meter.host_split(captured["seconds"]) if trace else None
    reduced = (tracer.reduce(meter.program["spans"])
               if tracer is not None and tracer.t_stop else None)
    if reduced is not None:
        out.setdefault("notes", []).append(f"profiler: {reduced['costs']}")
    ps = eng.pool.page_size
    plan = plan_counts(cfg)
    record = {
        "cfg": cfg, "traffic": traffic, "window_s": meter.t_close - meter.t_open,
        "host": host, "trace": reduced, "traced": meter.traced,
        "program": meter.program, "plan": plan,
        "per_token": per_token(cfg),
        "num_slots": eng.num_slots,
        "prefix": prefix_counts(meter.admitted, ps),
        "flops_in": {"decode_tokens": meter.decode_ctx[0],
                     "decode_contexts": meter.decode_ctx[1],
                     "prefill_tokens": int(sum(
                         r.prompt_len - r.prefix_hit_pages * ps for r in meter.admitted)),
                     "prefill_contexts": int(sum(roofline.prefill_contexts(
                         r.prompt_len - r.prefix_hit_pages * ps, r.prefix_hit_pages * ps)
                         for r in meter.admitted))},
    }
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    meter.detach()
    weights = state.pop("weights")
    state.clear()
    del eng, meter
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge_served(out["done"], cfg, traffic, weights, seed, device,
                           control=bool(hooks and hooks.get("control")))
    record["live"] = live_per_matrix(verdict["live"], plan,
                                     int(cfg["pruning"]["block"][0]))
    record["live_tiles"] = verdict["live"]
    limits = spec["limits"]
    checks = {
        "served_gap": {"value": max(verdict["gaps"]) if verdict["gaps"] else None,
                       "limit": limits["served_gap"]},
        "judged_tokens": {"value": verdict["tokens"],
                          "limit": int(traffic["check"]["min_tokens"])},
        "failed_requests": {"value": out["failed"], "limit": 0},
    }
    notes = [f"packed {state_summary['kept']} of {state_summary['total']} tiles, "
             f"BSR density {state_summary['density']:.4f}",
             f"judged {verdict['requests']} requests ({verdict['sampled']} sampled), "
             f"{verdict['tokens']} served tokens; widest gap per request "
             f"{verdict['gaps']}",
             f"captures inside the window: {captured}"]
    control = None
    if "control_gaps" in verdict:
        # the control in the program's place, through the same comparison
        ctl = dict(checks, served_gap={"value": max(verdict["control_gaps"]),
                                       "limit": limits["served_gap"]})
        control = {"checks": ctl, "correct": passed(ctl)}
    if captured["prefill"] or captured["chunk"]:
        notes.append(f"WARNING: {captured['prefill']} prefill and "
                     f"{captured['chunk']} chunk graphs were captured inside the "
                     f"window ({captured['seconds']:.3f} s)")
    return {"end_to_end": out["end_to_end"], "record": record,
            "attempted": out["attempted"], "failed": out["failed"],
            "checks": checks, "correct": passed(checks), "memory_peak_bytes": peak,
            "t_open": out["t_open"], "build_s": build_s, "notes": notes + out.get("notes", []),
            "judge": verdict, "control": control}


def live_per_matrix(live_tiles: Dict[str, int], plan: Dict[str, int],
                    tile: int) -> Dict[str, float]:
    """Live weights of one matrix of each kind (one expert's, for an
    expert kind), from each kind's live tiles over the stack."""
    return {k: n * tile * tile / matrices(k, plan) for k, n in live_tiles.items()}


def per_token(cfg: Dict) -> Dict[str, int]:
    """The model FLOPs' terms a token has that only the configuration's
    reference knows (``roofline.model_flops``)."""
    ref = reference(cfg)
    return {"dense_weights": ref.dense_weights_per_token(cfg),
            "other_flops": ref.other_flops_per_token(cfg)}


def passed(checks: Dict) -> bool:
    """``judged_tokens`` is a floor (at least that many tokens judged);
    every other check a ceiling.  A number that could not be read
    (None) fails."""
    for name, c in checks.items():
        if c["value"] is None:
            return False
        ok = c["value"] >= c["limit"] if name == "judged_tokens" else \
            c["value"] <= c["limit"]
        if not ok:
            return False
    return True
