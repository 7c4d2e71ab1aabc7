"""Offline backlog: every request of the traffic file's backlog is due
at once, so every slot stays full.  Set-up fills the slots and runs the
engine until ``arrivals.lead_in_retired`` requests have finished, so the
window opens on slots of mixed ages, as in a long job; the window then
runs whole engine steps for ``--seconds`` and stops.

End to end: ``serve_tok_s``, every token the steps of the window
emitted (first tokens at admission and decoded ones), over the window's
seconds (its start to the end of its last step).  Requests still queued
or active at the close are left: the judgement samples the requests
that finished inside the window.  A run whose backlog ran dry measured
something else and ends with an error.
"""
from __future__ import annotations

import functools
import time

from portbench import serving


def window(eng, meter, reqs, seconds, tracer, *, traffic):
    t_from = traffic["trace_from"] * seconds
    rids = [eng.submit(r["prompt"], r["max_new"], arrival=eng.tick,
                       temperature=0.0) for r in reqs]
    lead = int(traffic["arrivals"].get("lead_in_retired", 0))
    while lead and sum(eng.requests[r].status.value == "finished" for r in rids) < lead:
        eng.step()
    t0 = time.perf_counter()
    meter.open_window()
    while True:
        el = time.perf_counter() - t0
        if el >= seconds:
            break
        if tracer is not None and tracer.t_start is None and el >= t_from:
            tracer.start()
        eng.step()
    meter.close_window()
    if tracer is not None and tracer.running:
        tracer.stop()
    if not eng.scheduler.pending:
        raise RuntimeError(f"the backlog of {len(reqs)} requests ran dry inside "
                           "the window: raise arrivals.requests")
    window_s = meter.t_close - t0
    done, failed = [], 0
    for rid in rids:
        req = eng.requests[rid]
        status = req.status.value
        if status == "finished":
            done.append(serving.served(req))
        elif status not in ("queued", "active"):
            failed += 1
    notes = [f"{len(done)} requests finished by the close (at least {lead} of them "
             f"before the window), {eng.scheduler.pending} of {len(reqs)} still queued; chunk slots "
             f"in use {meter.slot_share():.4f}"]
    return {"end_to_end": {"serve_tok_s": meter.emitted / window_s},
            "attempted": len(meter.admitted), "failed": failed, "done": done,
            "t_open": t0, "notes": notes}


def run(spec, seed, seconds, trace, device, hooks=None):
    return serving.run_serving(
        spec, seed, seconds, trace, device,
        functools.partial(window, traffic=spec["traffic"]), hooks)
