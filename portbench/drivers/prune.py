"""Algorithm 2 at full width: the port's ``IterativePruner`` run as
``launch/train.py prune`` builds it (``program.algorithm2``), its
fine-tunes through the port's graphed train step.

Set-up makes the weights and the token batches from the seed on the
card, builds the pruner and the step, and drives that same step through
its first steps: the first iteration's knapsack, then three fine-tune
steps on fresh state (the first captures the step's graph), whose
losses, first gradient and change of the params are the run's readings
against the reference; then one eval forward.  The window runs
``pruner.run`` from the weights as made (its baseline eval, then
iterations of knapsack, fresh state, ``FINETUNE_STEPS`` steps and eval)
and closes at the end of the first iteration that ends past
``--seconds``, so it holds whole iterations.

End to end: ``train_tok_s``, the tokens of every fine-tune step of the
window over the window's seconds (knapsack, eval and fresh state
inside).  The traced span of a ``--trace 1`` run runs from
``trace_from`` of the window (at a step's boundary) to its close, and
the port's own tracer records over the whole of ``pruner.run`` into the
record's ``"program"``.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generate, program, serving
from portbench.reference import train as train_ref
from portbench.spec import reference


class _Closed(Exception):
    """The window's last iteration has ended."""


def make_batches(job: Dict, vocab: int, seed: int, device) -> List[Dict]:
    """The fine-tune's batches and the eval's last: uniform token ids from
    the seed, drawn on the card in one call, labels the next tokens."""
    gen = torch.Generator(device=device).manual_seed(
        generate.subseed(seed, "batches"))
    n, b, s = job["finetune_steps"] + 1, job["batch"], job["seq"]
    x = torch.randint(0, vocab, (n, b, s + 1), generator=gen, device=device,
                      dtype=torch.int64).to(torch.int32)
    return [{"tokens": x[i, :, :-1].contiguous(), "labels": x[i, :, 1:].contiguous()}
            for i in range(n)]


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict:
    """Worst leaf's |program - reference| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[k] for k in keep]))
    worst, leaf = 0.0, None
    for k in keep:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if g > worst:
            worst, leaf = g, k
    return {"value": worst, "leaf": leaf}


def readings(prog: Dict, ref: Dict) -> Dict:
    """The three numbers compared: the steps' losses (worst relative
    gap), the first gradient and the params' change (worst leaf).  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (nought to rounding, such as a key bias under softmax)."""
    ref_grad = ref["grad"]
    med = float(np.median(list(ref_grad.values())))
    keep = sorted(k for k, v in ref_grad.items() if v >= 1e-3 * med)
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss,
            "grad_gap": _gap(prog["grad"], ref["grad"], keep),
            "change_gap": _gap(prog["change"], ref["change"], keep),
            "leaves": len(keep), "left_out": sorted(set(ref_grad) - set(keep))}


def _value(got: Dict, name: str) -> float:
    return got[name] if name == "loss_gap" else got[name]["value"]


def _program_readings(a2, params, masks, batches, n: int) -> Dict:
    """The first ``n`` fine-tune steps through the port's step on fresh
    state: each step's loss, the first gradient as AdamW got it (its
    ``m`` after one step over ``1 - b1``) and the change of the fp32
    masters from the weights, by leaf."""
    st = a2["fresh_state"](params, masks)
    out = {"losses": []}
    for k in range(n):
        st, met = a2["fstep"](st, batches[k])
        out["losses"].append(float(met["loss"]))
        if k == 0:
            b1 = a2["opt"].b1
            out["grad"] = {name: v / (1.0 - b1)
                           for name, v in program.leaf_norms(st["opt"]["m"]).items()}
    out["change"] = program.leaf_norms(params, st["opt"]["master"])
    return out


def _reference_readings(ref_out: Dict, weights: Dict) -> Dict:
    change = {k: ref_out["master"][k] - weights[k].to(torch.float32)
              for k in ref_out["master"]}
    return {"losses": ref_out["losses"],
            "grad": train_ref.leaf_norms(ref_out["first_grad"]),
            "change": train_ref.leaf_norms(change)}


def run(spec, seed, seconds, trace, device, hooks=None):
    from portbench.trace import Trace
    hooks = hooks or {}
    cfg, job = spec["config"], spec["traffic"]
    ref = reference(cfg)
    build_s = program.build_kernels(device)
    weights = ref.make_weights(cfg, seed, device)
    params = ref.params_tree(weights, cfg)
    model_cfg = program.port_config(cfg)
    batches = make_batches(job, cfg["vocab_size"], seed, device)
    if "fault" in hooks:
        hooks["fault"]()
    a2 = program.algorithm2(params, model_cfg, job, batches, device)
    pruner = a2["pruner"]
    first_s = np.full(2, float(job["schedule_step"]))
    masks0, _ = pruner.prune_step(params, first_s)
    n_read = int(job["check"]["steps"])
    prog = _program_readings(a2, params, masks0, batches, n_read)
    a2["eval"](params, masks0)
    del masks0
    tracer = Trace(device) if trace else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()

    tok_per_step = job["batch"] * job["seq"]
    clock = {"steps": 0, "traced_steps": 0, "evals": 0, "knapsack_s": [],
             "t_end": None, "closed": False}
    t_from = job["trace_from"] * seconds
    orig_prune_step = pruner.prune_step

    def timed_prune_step(p, s):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = orig_prune_step(p, s)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock["knapsack_s"].append(time.perf_counter() - t)
        return out

    def finetune_fn(p, masks):
        st = a2["fresh_state"](p, masks)
        for s in range(a2["steps"]):
            if tracer is not None and tracer.t_start is None and \
                    time.perf_counter() - t0 >= t_from:
                tracer.start()
            st, _ = a2["fstep"](st, batches[s])
            clock["steps"] += 1
            if tracer is not None and tracer.running:
                clock["traced_steps"] += 1
        return st["params"]

    def eval_fn(p, masks):
        v = a2["eval"](p, masks)
        clock["evals"] += 1
        if clock["evals"] > 1 and time.perf_counter() - t0 >= seconds:
            clock["t_end"] = time.perf_counter()
            clock["closed"] = True
            raise _Closed
        return v

    pruner.prune_step = timed_prune_step
    recorded = None
    gc.freeze()
    t0 = time.perf_counter()
    if trace:
        program.tracer_on()
    try:
        pruner.run(params, finetune_fn, eval_fn)
    except _Closed:
        pass
    finally:
        if trace:
            recorded = program.tracer_off()
    if clock["t_end"] is None:
        clock["t_end"] = time.perf_counter()
    gc.unfreeze()
    if tracer is not None and tracer.running:
        tracer.stop()
    window_s = clock["t_end"] - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    reduced = (tracer.reduce(recorded["spans"])
               if tracer is not None and tracer.t_stop else None)
    stats = a2["fstep"].stats() if hasattr(a2["fstep"], "stats") else {}
    pool = a2["fstep"].pool_bytes() if hasattr(a2["fstep"], "pool_bytes") else None
    del a2, pruner, params, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    keep = ref.select_tiles(weights, cfg, sparsity=float(job["schedule_step"]),
                            embedding=True)
    opt, lr = job["adamw"], job["finetune_schedule"]
    ref_out = _reference_readings(train_ref.fine_tune(
        weights, keep, cfg, batches[:n_read], opt, lr), weights)
    got = readings(prog, ref_out)
    lim = spec["limits"]
    checks = {k: {"value": _value(got, k), "limit": lim[k]}
              for k in ("loss_gap", "grad_gap", "change_gap")}
    notes = [f"window {window_s:.3f} s: {clock['steps']} fine-tune steps, "
             f"{len(clock['knapsack_s'])} knapsacks, {clock['evals']} evals, closed "
             f"by the clock: {clock['closed']}; graph captures {stats.get('captures')}, "
             f"pool {pool} B",
             f"losses program {prog['losses']} reference {ref_out['losses']}; worst "
             f"leaves: grad {got['grad_gap']}, change {got['change_gap']}; "
             f"{got['leaves']} leaves compared, left out {got['left_out']}"]
    if reduced is not None:
        notes.append(f"profiler: {reduced['costs']}")
    control = None
    if hooks.get("control"):
        ctl = _reference_readings(train_ref.fine_tune(
            weights, keep, cfg, batches[:n_read], opt, lr, fp8=True), weights)
        got["control"] = readings(ctl, ref_out)
        # the control in the program's place, through the same comparison
        ctl_checks = {k: {"value": _value(got["control"], k), "limit": lim[k]}
                      for k in checks}
        control = {"checks": ctl_checks, "correct": serving.passed(ctl_checks)}
    record = {"cfg": cfg, "job": job, "window_s": window_s, "trace": reduced,
              "steps": clock["steps"], "traced_steps": clock["traced_steps"],
              "knapsack_s": clock["knapsack_s"], "program": recorded}
    return {"end_to_end": {"train_tok_s": clock["steps"] * tok_per_step / window_s},
            "record": record, "attempted": clock["steps"], "failed": 0,
            "checks": checks, "correct": serving.passed(checks),
            "memory_peak_bytes": peak, "t_open": t0, "build_s": build_s,
            "notes": notes, "judge": got, "control": control}
