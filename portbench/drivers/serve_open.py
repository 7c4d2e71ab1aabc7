"""Open-loop serving: requests are sent on the traffic file's Poisson
schedule whether or not earlier ones have finished.  The schedule starts
a lead-in (``arrivals.lead_in_s``, part of set-up) before the window, so
the window opens on an engine already loaded; it runs ``--seconds``,
then the run drains what it sent.

End to end, over every request sent inside the window (a failed one
counts as missing; the lead-in's requests load the engine and are not
counted):
``ttft_p95_ms``, first-token time less the scheduled send time, and
``tpot_p95_ms``, (last-token time - first-token time) / (tokens - 1).
The first token's time is ``Request.first_token_time`` (set when its
admission's prefill returns); every later token's is the return of the
``_run_chunk`` that produced it, stamped by the meter.  The traced span
of a ``--trace 1`` run runs from ``trace_from`` of the window (a
fraction) to its close.
"""
from __future__ import annotations

import functools
import time

import numpy as np

from portbench import generate, serving


def window(eng, meter, reqs, seconds, tracer, *, traffic):
    sampling = traffic.get("sampling") or {}
    lead = generate.lead_in_s(traffic)
    t_from = lead + traffic["trace_from"] * seconds
    n = len(reqs)
    sent = {}                                 # rid -> (scheduled, index, submitted)
    i = 0
    opened = closed = False
    ts = time.perf_counter()                  # the schedule's start
    queue_at_close = None
    queue = []                                # (seconds into the window, waiting)
    while True:
        now = time.perf_counter()
        el = now - ts
        if not opened and el >= lead:
            meter.open_window()
            opened = True
        while i < n and reqs[i]["t"] <= el:
            r = reqs[i]
            kw = {"temperature": 0.0} if r["greedy"] else dict(sampling)
            rid = eng.submit(r["prompt"], r["max_new"], arrival=eng.tick, **kw)
            sent[rid] = (ts + r["t"], i, time.perf_counter())
            i += 1
        if tracer is not None and tracer.t_start is None and el >= t_from:
            tracer.start()
        if not closed and len(queue) < el:
            queue.append((round(el - lead, 3), eng.scheduler.pending))
        if not closed and el >= lead + seconds:
            meter.close_window()
            closed = True
            queue_at_close = eng.scheduler.pending
            if tracer is not None and tracer.running:
                tracer.stop()
        if eng.scheduler.pending or any(s is not None for s in eng.slots):
            eng.step()
        elif i < n:
            time.sleep(min(2e-4, max(0.0, reqs[i]["t"] - el)))
        elif closed:
            break
        if el > lead + seconds + 300:
            raise RuntimeError(f"the drain did not end: {eng.scheduler.pending} "
                               "requests still waiting")
    t_drained = time.perf_counter()

    rows, late, done = [], [], []
    top_k = sampling.get("top_k")
    for rid, (t_sched, idx, t_sub) in sent.items():
        req = eng.requests[rid]
        ok = req.status.value == "finished"
        if ok:
            done.append(serving.served(req, None if reqs[idx]["greedy"] else top_k))
        if reqs[idx]["t"] < lead:             # the lead-in's: loads, not counted
            continue
        late.append(t_sub - t_sched)
        k = len(req.tokens) if ok else 0
        rows.append((t_sched, req.first_token_time,
                     meter.last_token.get(rid, req.first_token_time), k, ok))
    tails, failed = serving.open_loop_tails(rows)
    fin = [first - sched for sched, first, _, _, ok in rows if ok]
    notes = [f"sent {len(rows)} requests over the {seconds} s window after {n - len(rows)} "
             f"over the {lead} s lead-in; drained {t_drained - meter.t_close:.2f} s "
             f"after the window; queue at the close {queue_at_close}; generator late "
             f"p50 {1e3 * float(np.median(late)):.3f} ms max {1e3 * max(late):.3f} ms; "
             f"TTFT p50 {1e3 * float(np.median(fin)):.2f} ms; chunk slots in use "
             f"{meter.slot_share():.3f}"]
    return {"end_to_end": tails,
            "attempted": len(rows), "failed": failed, "done": done,
            "t_open": meter.t_open, "notes": notes, "queue": queue,
            "drain_s": t_drained - meter.t_close}


def run(spec, seed, seconds, trace, device, hooks=None):
    return serving.run_serving(
        spec, seed, seconds, trace, device,
        functools.partial(window, traffic=spec["traffic"]), hooks)
