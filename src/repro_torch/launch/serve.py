"""Serving launcher of the torch port.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --stream \\
        --pruned 0.75 --shared-prefix

runs on the card (``--device cpu`` runs the plain versions on the CPU,
``--smoke`` the reduced config).  ``--pruned`` knapsack-prunes the
model at ``--block`` tiles and packs it to BSR, so every projection
runs the BSR kernel.  Without ``--stream`` a fixed batch is prefilled
and decoded on contiguous caches, greedy or sampled (``--temperature``,
``--top-k``, ``--top-p``); for whisper-tiny, frame embeddings drawn from
the seed go through the encoder first and fill the cross-attention K/V
(the engine refuses encoder-decoder archs, as the reference's does); on
the card the prefill and the whole generation each run as one CUDA graph
(``FixedBatch``), captured in the warm-up call and replayed in the timed
one.  With ``--stream`` ragged requests arrive
every ``--arrive-every`` ticks and flow through the continuous-batching
engine (paged KV pool, paged prefill and decode kernels,
``--ticks-per-sync`` decode steps per host sync, each chunk a CUDA graph
on the card); ``--request-temperatures`` cycles per-request
temperatures through the stream.  Every stream is then verified
token-identical to its solo decode through ``lm_prefill`` +
``lm_generate`` on contiguous caches, a sampled one with the engine's
key for its request.  The run exits 1 on any divergence or, with
``--shared-prefix``, on zero prefix hits (where prefix caching is on: it
is off for stacks with recurrent layers, jamba-v0.1-52b and xlstm-350m).
``--pruned`` prunes the attention, MLP and MoE weights, as the
reference's serving pruner does; on xlstm-350m, which has none of them,
it raises the reference's ``ValueError``.

``--adaptive`` picks each chunk's length with the SLO-aware policy over
the levels 1, 2, 4, .. up to ``--ticks-per-sync``, with alternating
priority classes and a TTFT target on the interactive one; it fails
unless a chunk shrank and every stream verifies.  ``--chaos`` serves
under a seeded plan of every injected fault plus a cancel, a deadline
and rejects from a full queue; it fails unless every request ends in a
terminal status, the streams without a fault match their solo decode
(the others are solo-decode prefixes) and the page pool drains exactly.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_params", "stream_prompts", "static_inputs", "FixedBatch",
           "solo_decode", "solo_decode_for",
           "verify_streams", "chaos_plan", "serve_chaos", "check_chaos", "main"]


def build_params(cfg, *, seed: int, device, pruned: Optional[float] = None,
                 block: Tuple[int, int] = (128, 128), min_size: int = 4096
                 ) -> Tuple[Dict, Optional[Dict]]:
    """Seeded random params, knapsack-pruned and BSR-packed when
    ``pruned`` is a sparsity.  Returns (params, summary or None)."""
    from repro_torch.core import BlockingSpec
    from repro_torch.models import init_params
    from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary

    params = init_params(cfg, seed=seed, device=device)
    if pruned is None:
        return params, None
    sel = knapsack_prune(params, sparsity=pruned,
                         blocking=BlockingSpec(bk=block[0], bn=block[1]),
                         min_size=min_size)
    params = pack_params(params, sel.masks, sel.structures)
    summ = sparsity_summary(params)
    summ.update(kept=sel.kept, total=sel.total, method=sel.result.method,
                feasible=sel.result.feasible)
    return params, summ


def stream_prompts(vocab: int, *, requests: int, prompt_len: int,
                   shared_prefix: bool, seed: int) -> List[np.ndarray]:
    """The stream's prompts, as the reference launcher draws them: ragged
    lengths in [prompt_len/2, prompt_len], or with ``shared_prefix`` a
    common prefix plus short unique tails, requests 0 and 1 identical."""
    plen = max(prompt_len, 1)
    rng = np.random.default_rng(seed)
    if shared_prefix:
        tail = max(plen // 4, 1)
        prefix = rng.integers(0, vocab, size=max(plen - tail, 0)).astype(np.int32)
        prompts = [np.concatenate([
            prefix, rng.integers(0, vocab, size=tail).astype(np.int32)])
            for _ in range(requests)]
        if requests >= 2:
            prompts[1] = prompts[0].copy()
        return prompts
    lens = rng.integers(max(1, plen // 2), plen + 1, size=requests)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


@torch.no_grad()
def solo_decode(params, cfg, prompt: np.ndarray, gen: int, *, device,
                eos_id: Optional[int] = None, temperature: float = 0.0,
                top_k: Optional[int] = None, top_p: Optional[float] = None,
                key: Optional[torch.Tensor] = None) -> np.ndarray:
    """Decode of one prompt alone on contiguous caches: ``lm_prefill``
    then ``lm_generate``, greedy or sampled from ``key``.  Returns (gen,)
    int32 tokens."""
    from repro_torch.models import init_caches, lm_generate, lm_prefill

    caches = init_caches(cfg, 1, len(prompt) + gen, torch.float32, device)
    toks = torch.as_tensor(prompt[None], device=device)
    logits, caches = lm_prefill(params, caches, {"tokens": toks}, cfg)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    want, _ = lm_generate(params, caches, first, len(prompt), gen, cfg,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          eos_id=eos_id, key=key)
    return want[0].cpu().numpy()


def solo_decode_for(engine, params, cfg, req, gen: int, *, device,
                    eos_id: Optional[int] = None) -> np.ndarray:
    """The solo decode of an engine request: its effective sampling
    params and the engine's key for its rid."""
    t, k, p = engine.sampling_for(req)
    return solo_decode(params, cfg, req.prompt, gen, device=device,
                       eos_id=eos_id, temperature=t, top_k=k, top_p=p,
                       key=engine.request_key(req.rid))


def verify_streams(params, cfg, done: Dict, gen: int, *, device,
                   eos_id: Optional[int] = None, engine=None) -> List[int]:
    """rids whose stream differs from its solo decode (or is short of
    ``gen`` without having hit EOS).  With ``engine`` each request is
    replayed with its own sampling params and key; without, greedily."""
    bad = []
    for rid, req in sorted(done.items()):
        if engine is not None:
            want = solo_decode_for(engine, params, cfg, req, gen,
                                   device=device, eos_id=eos_id)
        else:
            want = solo_decode(params, cfg, req.prompt, gen, device=device,
                               eos_id=eos_id)
        want = want[:len(req.tokens)]
        short_ok = (eos_id is not None and len(req.tokens) >= 1
                    and req.tokens[-1] == eos_id)
        if not np.array_equal(req.tokens, want) or (
                len(req.tokens) != gen and not short_ok):
            bad.append(rid)
            print(f"  request {rid}: MISMATCH vs solo decode (got "
                  f"{len(req.tokens)} toks {req.tokens[:8]}.. want "
                  f"{want[:8]}..)")
    return bad


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_stream(args, cfg, params, device) -> int:
    from repro_torch.serving import AdaptiveChunkPolicy, ServingEngine

    prompts = stream_prompts(cfg.vocab, requests=args.requests,
                             prompt_len=args.prompt_len,
                             shared_prefix=args.shared_prefix, seed=args.seed)
    lens = np.asarray([len(p) for p in prompts])
    gen = args.gen
    req_temps = None
    if args.request_temperatures:
        req_temps = [float(t) for t in args.request_temperatures.split(",")]
    policy = None
    if args.adaptive:      # a geometric ladder topped at --ticks-per-sync
        top = args.ticks_per_sync
        policy = AdaptiveChunkPolicy(levels=tuple(sorted(
            {1, top} | {2 ** k for k in range(10) if 2 ** k < top})))

    def build():
        eng = ServingEngine(
            params, cfg, num_slots=args.batch, page_size=args.page_size,
            max_seq_len=int(lens.max()) + gen,
            ticks_per_sync=args.ticks_per_sync, chunk_policy=policy,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            eos_id=args.eos_id, seed=args.seed, device=device)
        for i, p in enumerate(prompts):
            kw = {}
            if req_temps is not None:
                kw["temperature"] = req_temps[i % len(req_temps)]
            if args.adaptive:
                kw["priority"] = i % 2
                if i % 2 == 0:
                    kw["ttft_target_ticks"] = 2 * args.ticks_per_sync
            eng.submit(p, gen, arrival=i * args.arrive_every, **kw)
        return eng

    build().run()          # warm-up: kernel builds, allocator, libraries
    engine = build()
    _sync(device)
    t0 = time.perf_counter()
    done = engine.run()
    _sync(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    emitted = sum(len(r.tokens) for r in done.values())
    ttft = [engine.ttft_seconds(r) for r in done]
    ttft = [t for t in ttft if t is not None]
    print(f"streamed {len(done)} requests (prompts {int(lens.min())}.."
          f"{int(lens.max())}, arrivals every {args.arrive_every} ticks, "
          f"{args.ticks_per_sync} ticks/sync) on {device} in {dt:.3f}s: "
          f"{emitted} tokens, {emitted / dt:.1f} tok/s aggregate, "
          f"TTFT p50 {1e3 * float(np.median(ttft)):.2f} ms, slot "
          f"utilization {engine.slot_utilization:.2f}")
    st = engine.prefix_stats
    if st["enabled"]:
        print(f"  prefix cache: {st['hit_requests']}/{st['lookups']} admissions "
              f"hit, {st['pages_shared']} pages mapped instead of prefilled, "
              f"{st['cow_copies']} COW copies; pool free pages after drain: "
              f"{engine.pool.free_pages}")
    else:
        print(f"  prefix cache: off (recurrent layers); pool free pages after "
              f"drain: {engine.pool.free_pages}")
    an = engine.analysis_stats()
    if an["cuda_graphs"]:
        print(f"  CUDA graphs: {an['captures']} captured variants "
              f"{an['variants']}, replays {an['replays']}")
    if args.adaptive:
        slo = engine.slo_stats()
        print(f"  slo: chunks_by_ticks={slo['chunks_by_ticks']} "
              f"shrinks={slo['chunk_shrinks']} grows={slo['chunk_grows']} "
              f"ttft_misses={slo['ttft_target_misses']} "
              f"by_priority={slo['by_priority']}")
        if slo["chunk_shrinks"] < 1:
            print("stream verify FAILED: adaptive run never shrank a chunk "
                  "(policy inert)")
            return 1
        extra = set(slo["chunks_by_ticks"]) - set(slo["chunk_levels"])
        if extra:
            print(f"stream verify FAILED: undeclared chunk lengths "
                  f"{sorted(extra)} ran")
            return 1
    if args.shared_prefix and st["enabled"] and st["hit_requests"] == 0:
        print("stream verify FAILED: shared-prefix run produced no "
              "prefix-cache hits")
        return 1
    bad = verify_streams(params, cfg, done, gen, device=device,
                         eos_id=args.eos_id, engine=engine)
    if bad:
        print(f"stream verify FAILED: {len(bad)}/{len(done)} requests diverged")
        return 1
    n_sampled = sum(1 for r in done.values() if engine.sampling_for(r)[0] > 0)
    print(f"  verify OK: all {len(done)} streams token-identical to solo "
          f"decode ({n_sampled} sampled, {len(done) - n_sampled} greedy)")
    return 0


def chaos_plan(requests: int):
    """The seeded fault plan of ``--chaos`` and the rid it poisons:
    an allocation failure, an index corruption, NaN in one request's
    pages and a chunk exception."""
    from repro_torch.serving import (alloc_failure, chunk_exception,
                                     index_corruption, nan_logit)
    victim = 1 % requests
    return [alloc_failure(0), index_corruption(3), nan_logit(6, rid=victim),
            chunk_exception(9)], victim


def serve_chaos(engine, prompts, gen: int):
    """Add the chaos run's lifecycle extras to a built engine: a request
    cancelled while queued, one that cannot finish inside its deadline,
    and three submits past the full queue.  Returns (rid cancelled, rid
    expiring, rids rejected)."""
    rid_cancel = engine.submit(prompts[0], gen, arrival=10_000)
    rid_expire = engine.submit(prompts[-1], gen, arrival=0,
                               deadline_ticks=max(3, gen // 2))
    rejected = [engine.submit(prompts[0], gen, arrival=0) for _ in range(3)]
    engine.cancel(rid_cancel)
    return rid_cancel, rid_expire, rejected


def check_chaos(engine, injector, done, params, cfg, gen: int, *, device,
                victim: int, rid_cancel: int, rid_expire: int,
                rejected: Sequence[int], eos_id=None) -> List[str]:
    """The chaos run's contract; returns the failures (empty if it held).
    Every request terminal with its planned fate, every fault counter
    tripped and every planned fault fired, FINISHED streams equal to
    their solo decode and the partial ones solo-decode prefixes, and the
    pool drained exactly."""
    from repro_torch.serving import RequestStatus
    stats = engine.fault_stats
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    check(len(done) == len(engine.requests),
          f"{len(engine.requests) - len(done)} requests not terminal")
    check(all(r.terminal for r in engine.requests.values()),
          "non-terminal request status")
    check(done[rid_cancel].status is RequestStatus.CANCELLED,
          f"cancel victim ended {done[rid_cancel].status}")
    check(done[rid_expire].status is RequestStatus.EXPIRED,
          f"deadline victim ended {done[rid_expire].status}")
    for r in rejected:
        check(done[r].status is RequestStatus.REJECTED,
              f"overflow submit {r} ended {done[r].status}")
    check(done[victim].status is RequestStatus.FAILED,
          f"NaN victim ended {done[victim].status}")
    for counter in ("guard_trips", "chunk_failures", "alloc_failures",
                    "index_drops", "rejected", "cancelled", "expired",
                    "degraded"):
        check(stats[counter] >= 1, f"counter {counter} never tripped")
    check(not injector.pending, f"faults never fired: {injector.pending}")
    for rid, req in sorted(done.items()):
        if req.status is RequestStatus.REJECTED or len(req.tokens) == 0:
            continue
        want = solo_decode_for(engine, params, cfg, req, gen, device=device,
                               eos_id=eos_id)
        if req.status is RequestStatus.FINISHED:
            check(np.array_equal(req.tokens, want),
                  f"rid {rid}: non-faulted stream diverged from solo")
        else:
            check(np.array_equal(req.tokens, want[:len(req.tokens)]),
                  f"rid {rid} ({req.status.value}): partial tokens are not "
                  f"a solo-decode prefix")
    engine.release_prefix_cache()
    check(engine.pool.free_pages == engine.pool.num_pages - 1,
          f"pool did not drain: {engine.pool.free_pages}/"
          f"{engine.pool.num_pages - 1}")
    check(engine.pool.live_refs() == 0, "dangling page references")
    return failures


def _run_chaos(args, cfg, params, device) -> int:
    """Serve a stream under every injected fault, a cancel, a deadline and
    queue-overflow rejects, then hold the engine to its fault contract."""
    from repro_torch.serving import FaultInjector, ServingEngine

    plen, gen = max(args.prompt_len, 2), max(args.gen, 12)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(max(2, plen // 2), plen + 1, size=args.requests)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]

    def build(injector=None, max_queue=None):
        eng = ServingEngine(
            params, cfg, num_slots=args.batch, page_size=args.page_size,
            max_seq_len=plen + gen, ticks_per_sync=args.ticks_per_sync,
            eos_id=args.eos_id, seed=args.seed, max_queue=max_queue,
            fault_injector=injector, device=device)
        for i, p in enumerate(prompts):
            eng.submit(p, gen, arrival=i * args.arrive_every)
        return eng

    build().run()          # warm-up: kernel builds, allocator, libraries
    plan, victim = chaos_plan(args.requests)
    inj = FaultInjector(plan, seed=args.seed)
    engine = build(injector=inj, max_queue=args.requests + 2)
    rid_cancel, rid_expire, rejected = serve_chaos(engine, prompts, gen)
    t0 = time.perf_counter()
    done = engine.run()
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"chaos: {len(done)} requests terminal in {dt:.2f}s on {device} "
          f"under {len(plan)} injected faults + cancel/deadline/overflow")
    print(f"  statuses: {sorted((r.rid, r.status.value) for r in done.values())}")
    print(f"  fault counters: {engine.fault_stats}")
    print(f"  injector fired: {[(k, t) for k, t, _ in inj.fired]}")
    failures = check_chaos(engine, inj, done, params, cfg, gen, device=device,
                           victim=victim, rid_cancel=rid_cancel,
                           rid_expire=rid_expire, rejected=rejected,
                           eos_id=args.eos_id)
    if failures:
        for f in failures:
            print(f"  chaos verify FAILED: {f}")
        return 1
    print("  verify OK: streams without a fault token-identical to solo "
          "decode, faulted/cancelled/expired partials are clean prefixes, "
          "pool drained exactly")
    return 0


def static_inputs(cfg, *, batch: int, prompt_len: int, seed: int, device):
    """The fixed batch's prompt (B, S) and, for an encoder-decoder arch,
    its frame embeddings (B, enc_frames, D), standard normals, both
    drawn from ``seed`` with numpy (frames after the prompt).  Returns
    (prompt, frames or None)."""
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(batch, prompt_len)),
                             device=device)
    frames = None
    if cfg.enc_layers:
        frames = torch.as_tensor(rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model), dtype=np.float32), device=device)
    return prompt, frames


class FixedBatch:
    """The fixed-batch launcher's two compiled calls — the counterpart of
    the reference's jitted ``prefill`` (``lm_prefill`` and the argmax)
    and ``generate`` (the whole ``lm_generate`` as one ``lax.scan``).

    ``prompt`` (B, S) and, for an encoder-decoder arch, ``frames`` are
    fixed; the sampling (``temperature``, ``top_k``, ``top_p``,
    ``eos_id``) and the key are fixed per object.  The caches are
    allocated once and reset in place at every call.  With
    ``cuda_graphs`` (default: on a CUDA device) the first call captures
    one CUDA graph of the prefill + argmax (per (B, S)) and one of the
    whole ``lm_generate`` (per (B, start, gen)), as the reference warms
    both calls, and later calls replay them; the start length and the
    key are device tensors made before the captures.  Whisper's encoder
    and cross K/V stay eager, as the reference does not jit them: they
    are written into the caches in place, where the generate graph reads
    them.  ``lm_generate`` itself stays the plain loop.  A call returns
    (tokens (B, gen) on the host, prefill seconds, decode seconds)."""

    def __init__(self, params, cfg, prompt, frames, gen: int, *, key,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_id: Optional[int] = None,
                 device, cuda_graphs: Optional[bool] = None):
        from repro_torch.models import init_caches
        self.device = torch.device(device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs needs a CUDA device, not {self.device}")
        self.params, self.cfg, self.prompt, self.frames = params, cfg, prompt, frames
        self.gen = gen
        self.sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                             eos_id=eos_id)
        b, plen = prompt.shape
        alloc = max(plen + gen, 1)
        self.caches = init_caches(cfg, b, alloc, torch.float32, self.device)
        self._fresh = init_caches(cfg, 1, alloc, torch.float32, self.device)
        self.tok = torch.zeros((b, 1), dtype=torch.int32, device=self.device)
        self.start = torch.full((b,), plen, dtype=torch.int64, device=self.device)
        self.key = key.to(device=self.device, dtype=torch.int64)
        self.pool = torch.cuda.graph_pool_handle() if cuda_graphs else None
        self.graphs: Dict[str, object] = {}

    @torch.no_grad()
    def __call__(self) -> Tuple[np.ndarray, float, float]:
        from repro_torch.models import encode_kv_caches, encoder_forward
        for cache, fresh in zip(self.caches, self._fresh):
            for k, t in cache.items():
                t.copy_(fresh[k])
        if self.frames is not None:      # whisper: encode once, cross K/V
            enc = encoder_forward(self.params, self.frames, self.cfg)
            cross = encode_kv_caches(self.params, enc, self.cfg,
                                     [dict(c) for c in self.caches])
            for cache, new in zip(self.caches, cross):
                for k in ("cross_k", "cross_v"):
                    if k in cache:
                        cache[k].copy_(new[k])
        _sync(self.device)
        t0 = time.perf_counter()
        if self.prompt.shape[1] > 0:
            self._step("prefill", self._prefill)
        else:
            # empty prompt: generation starts from token 0 (a stand-in
            # BOS) at cache length 0, as in the reference
            self.tok.zero_()
        _sync(self.device)
        t1 = time.perf_counter()
        toks = self._step("generate", self._generate).cpu().numpy()
        return toks, t1 - t0, time.perf_counter() - t1

    def _prefill(self) -> torch.Tensor:
        from repro_torch.models import lm_prefill
        logits, _ = lm_prefill(self.params, self.caches, {"tokens": self.prompt},
                               self.cfg)
        return self.tok.copy_(torch.argmax(logits[:, -1], -1)[:, None])

    def _generate(self) -> torch.Tensor:
        from repro_torch.models import lm_generate
        toks, _ = lm_generate(self.params, self.caches, self.tok, self.start,
                              self.gen, self.cfg, key=self.key, **self.sampling)
        return toks

    def _step(self, name: str, fn):
        """``fn()`` eagerly, or its graph: captured at the first call
        (whose eager run on a side stream is the result), then replayed."""
        from repro_torch.serving.graphs import capture
        if self.pool is None:
            return fn()
        graph = self.graphs.get(name)
        if graph is None:
            first, self.graphs[name] = capture(
                fn, self.device, self.pool, f"fixed-batch {name}")
            return first
        return graph.replay()

    def stats(self) -> Dict[str, object]:
        """Each graph's capture seconds (warm-up run included), replays
        and kernel launches per replay."""
        return {name: dict(capture_seconds=g.capture_seconds, replays=g.replays,
                           launches_per_replay=dict(g.launches))
                for name, g in self.graphs.items()}


def _run_static(args, cfg, params, device) -> int:
    from repro_torch import prng

    b, plen = args.batch, args.prompt_len
    prompt, frames = static_inputs(cfg, batch=b, prompt_len=plen,
                                   seed=args.seed, device=device)
    # the reference draws its sampling key as the last of four splits
    key = prng.split(prng.PRNGKey(args.seed), 4)[3]
    run = FixedBatch(params, cfg, prompt, frames, args.gen, key=key,
                     temperature=args.temperature, top_k=args.top_k,
                     top_p=args.top_p, eos_id=args.eos_id, device=device)
    run()                  # warm-up (on the card: captures both graphs)
    t0 = time.perf_counter()
    gen, dt_pre, dt_dec = run()
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"generated {gen.shape} tokens on {device} in {dt:.3f}s (prefill "
          f"{dt_pre * 1e3:.1f}ms, decode "
          f"{args.gen * b / max(dt_dec, 1e-9):.1f} tok/s aggregate)")
    if gen.shape[1]:
        print("sample:", gen[0][:16])
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--pruned", type=float, default=None, metavar="SPARSITY",
                    help="knapsack-prune to this structure sparsity and "
                         "serve through the BSR kernel")
    ap.add_argument("--block", type=str, default="128,128", metavar="BK,BN",
                    help="pruning tile shape")
    ap.add_argument("--min-size", type=int, default=4096,
                    help="smallest weight (elements) eligible for pruning")
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching over a streamed arrival pattern")
    ap.add_argument("--requests", type=int, default=6,
                    help="[--stream] number of requests")
    ap.add_argument("--arrive-every", type=int, default=2,
                    help="[--stream] ticks between request arrivals")
    ap.add_argument("--page-size", type=int, default=8,
                    help="[--stream] tokens per physical KV page")
    ap.add_argument("--ticks-per-sync", type=int, default=4,
                    help="[--stream] decode steps per host sync")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="[--stream] requests share a long prompt prefix "
                         "(the first two the whole prompt); fails on zero "
                         "prefix-cache hits")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch, or decode slots with --stream")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=None,
                    help="sample from the k most probable tokens")
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling probability mass")
    ap.add_argument("--request-temperatures", type=str, default=None,
                    metavar="T0,T1,...",
                    help="[--stream] per-request temperatures cycled over "
                         "the stream (0 = greedy)")
    ap.add_argument("--adaptive", action="store_true",
                    help="[--stream] SLO-aware adaptive chunk lengths up to "
                         "--ticks-per-sync; fails unless a chunk shrank")
    ap.add_argument("--chaos", action="store_true",
                    help="serve under a seeded plan of injected faults, a "
                         "cancel, a deadline and queue rejects; fails unless "
                         "the engine keeps its fault contract")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)
    block = tuple(int(t) for t in args.block.split(","))
    params, summ = build_params(cfg, seed=args.seed, device=device,
                                pruned=args.pruned, block=block,
                                min_size=args.min_size)
    if summ is not None:
        path = "CUDA kernels" if device.type == "cuda" else "plain (CPU)"
        print(f"pruned: kept {summ['kept']}/{summ['total']} structures "
              f"({summ['method']}, feasible={summ['feasible']}); BSR density "
              f"{summ['density']:.2f} ({summ['nnz_blocks']}/"
              f"{summ['total_blocks']} blocks), dispatch={path}")
    if args.chaos:
        return _run_chaos(args, cfg, params, device)
    if args.stream:
        return _run_stream(args, cfg, params, device)
    return _run_static(args, cfg, params, device)


if __name__ == "__main__":
    sys.exit(main())
