"""Serving launcher of the torch port.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --stream \\
        --pruned 0.75 --shared-prefix

runs on the card (``--device cpu`` runs the plain versions on the CPU,
``--smoke`` the reduced config).  ``--pruned`` knapsack-prunes the
model at ``--block`` tiles and packs it to BSR, so every projection
runs the BSR kernel.  Without ``--stream`` a fixed batch is prefilled
and decoded greedily on contiguous caches.  With ``--stream`` ragged
requests arrive every ``--arrive-every`` ticks and flow through the
continuous-batching engine (paged KV pool, paged prefill and decode
kernels, ``--ticks-per-sync`` decode steps per host sync); every stream
is then verified token-identical to its solo greedy decode through
``lm_prefill`` + ``lm_generate`` on contiguous caches.  The run exits 1
on any divergence or, with ``--shared-prefix``, on zero prefix hits.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_params", "stream_prompts", "solo_decode", "verify_streams",
           "main"]


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
                eos_id: Optional[int] = None) -> np.ndarray:
    """Greedy decode of one prompt alone on contiguous caches:
    ``lm_prefill`` then ``lm_generate``.  Returns (gen,) int32 tokens."""
    from repro_torch.models import init_caches, lm_generate, lm_prefill

    caches = init_caches(cfg, 1, len(prompt) + gen, torch.float32, device)
    toks = torch.as_tensor(prompt[None], device=device)
    logits, caches = lm_prefill(params, caches, {"tokens": toks}, cfg)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    want, _ = lm_generate(params, caches, first, len(prompt), gen, cfg,
                          eos_id=eos_id)
    return want[0].cpu().numpy()


def verify_streams(params, cfg, done: Dict, gen: int, *, device,
                   eos_id: Optional[int] = None) -> List[int]:
    """rids whose stream differs from its solo decode (or is short of
    ``gen`` without having hit EOS)."""
    bad = []
    for rid, req in sorted(done.items()):
        want = solo_decode(params, cfg, req.prompt, gen, device=device,
                           eos_id=eos_id)[:len(req.tokens)]
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
    from repro_torch.serving import ServingEngine

    prompts = stream_prompts(cfg.vocab, requests=args.requests,
                             prompt_len=args.prompt_len,
                             shared_prefix=args.shared_prefix, seed=args.seed)
    lens = np.asarray([len(p) for p in prompts])
    gen = args.gen

    def build():
        eng = ServingEngine(
            params, cfg, num_slots=args.batch, page_size=args.page_size,
            max_seq_len=int(lens.max()) + gen,
            ticks_per_sync=args.ticks_per_sync, eos_id=args.eos_id,
            device=device)
        for i, p in enumerate(prompts):
            eng.submit(p, gen, arrival=i * args.arrive_every)
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
    print(f"  prefix cache: {st['hit_requests']}/{st['lookups']} admissions "
          f"hit, {st['pages_shared']} pages mapped instead of prefilled, "
          f"{st['cow_copies']} COW copies; pool free pages after drain: "
          f"{engine.pool.free_pages}")
    if args.shared_prefix and st["hit_requests"] == 0:
        print("stream verify FAILED: shared-prefix run produced no "
              "prefix-cache hits")
        return 1
    bad = verify_streams(params, cfg, done, gen, device=device,
                         eos_id=args.eos_id)
    if bad:
        print(f"stream verify FAILED: {len(bad)}/{len(done)} requests diverged")
        return 1
    print(f"  verify OK: all {len(done)} streams token-identical to solo decode")
    return 0


def _run_static(args, cfg, params, device) -> int:
    from repro_torch.models import init_caches, lm_generate, lm_prefill

    b, plen = args.batch, max(args.prompt_len, 1)
    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, plen)),
                             device=device)

    def once():
        caches = init_caches(cfg, b, plen + args.gen, torch.float32, device)
        with torch.no_grad():
            logits, caches = lm_prefill(params, caches, {"tokens": prompt}, cfg)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            _sync(device)
            t1 = time.perf_counter()
            toks, _ = lm_generate(params, caches, tok, plen, args.gen, cfg,
                                  eos_id=args.eos_id)
            out = toks.cpu().numpy()
        return out, time.perf_counter() - t1

    once()                 # warm-up
    t0 = time.perf_counter()
    gen, dt_dec = once()
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"generated {gen.shape} tokens on {device} in {dt:.3f}s (decode "
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
    if args.stream:
        return _run_stream(args, cfg, params, device)
    return _run_static(args, cfg, params, device)


if __name__ == "__main__":
    sys.exit(main())
