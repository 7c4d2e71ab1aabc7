#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, any failure ends the run with a non-zero exit code:

1. the card's name and power limit, torch and CUDA versions; build the
   five hand-written CUDA kernels (one nvcc per source, in parallel);
2. every kernel against its plain PyTorch version on the card, fp32 and
   bf16, with the tolerances below (BSR matmul: M 1/4/64/200, qwen's
   weight shapes and an odd one at 128x128 and 32x32 blocks, jamba's
   (4096 -> 4096/1024/14336, 14336 -> 4096) and qwen2-vl's (1536 ->
   1536/256/8960, 8960 -> 1536) at 128x128, an all-pruned column, every
   epilogue the models use, and whisper's (384 -> 384/1536, 1536 -> 384)
   with the gelu epilogue alone at M 4 and 6000, also fp32 weights under
   bf16 activations; BSR planes: E
   1/3/32, M 1/8/47/200, granite's expert shapes and an odd one, and
   jamba's 16 experts (4096<->14336, M 2/10/64, 128x128 tiles), a dead
   and a fully dense plane, and with row counts of 0, C and ragged ones,
   one and two segments per plane, a live plane whose counts are all 0,
   rows past the count held to epilogue(0); paged decode and prefill:
   head_dim 64 at page sizes 4/8/16, GQA 16/16, 16/8, 8/2, 4/1, and
   head_dim 128 at jamba's GQA 32/8 and qwen2-vl's 12/2 (G 6), page size
   8, ragged lengths
   including 0, NaN in every page no row owns, q_offset 0/ps/3ps, and
   decode at an exact chunk boundary and past 8 chunks (1500 cached
   positions) in all four (q, pool) dtype pairs; structure norms: qwen's
   and granite's expert weights and an odd one, 128 and 32 tiles; BSR
   also a fully dense 88-slot column and a 1000-slot column; planes also
   at the all-to-all's expert buffers of phase 9, (32, 512) and (16,
   1024) at granite's 1024 -> 512 and 512 -> 1024 experts 0.75 pruned,
   fp32 and bf16, with and without row counts, rows past the fill held
   to epilogue(0)), the MoE
   router's logits held to be the same for a token alone and in a batch
   (reported), and batch invariance in fp32 (gated): a BSR row is
   bit-identical alone and inside M 4/47/200 (the wide-column layouts
   here, qwen's knapsack-pruned layouts after its main path), a prefill
   position bit-identical in a full, a tail (q_offset 3 ps) and a
   ragged-batch call, a planes row bit-identical at M 1/8/47 and with
   and without row counts, a decode row bit-identical alone, inside a
   ragged batch of 5 and with a 4x wider page table (both paged gates
   also at qwen2-vl's G 6, head_dim 128); and the BSR matmul
   in fp32 at the paper models' packed FC layouts (``PAPER_LAYOUTS``:
   tiles (2..16, 1), (27, 1) over K 96, (50, 1), (24, 1), (1, 1) and
   (8, 8), ~40 % live, an all-pruned column) at M 1/64/256/2048, a row
   bit-identical alone and in M 4/47/200 on each;
3. two main paths, each served through ``ServingEngine`` at full width
   from a seeded generator, knapsack-pruned at 0.75 with 128x128 blocks
   and BSR-packed, on the same traffic: qwen1.5-0.5b (24 layers, d_model
   1024, 16 heads, d_ff 2816, vocab 151936) and granite-moe-1b-a400m (24
   layers, d_model 1024, 16 heads / 8 KV heads, 32 experts top-8 of
   d_ff 512, vocab 49155).  For each, (a) in fp32 every stream is
   token-identical to its solo decode with at least one prefix-cache hit
   (granite at capacity factor E/k = 4.0, where no slot can drop; the
   config's 1.25 drops slots by design, so a prefix-hit tail would route
   unlike the solo prompt); (b) in the config's bf16 (granite at its own
   1.25) every stream reaches full length with finite logits.  Launch
   counts are zeroed just before each run (a) and read just after it;
   every kernel of the path must have run, and each BSR kernel exactly
   once per weight per forward pass (granite: 3 planes launches per MoE
   layer per decode tick and per prefill, so no loop over experts), and
   paged decode once per layer per tick.  The decode chunks and the
   admission prefills of runs (a) and (b) are CUDA graphs (the engine's
   default on the card; a prefill graph per ``(L, start)``, gated to
   equal the variants admitted): a replay counts the launches its
   capture recorded, so the counts stay exact.  Run (a) is a fresh
   engine's pass, so its wall includes every capture; its host split
   (``HostSplit``: host ms per admission and per chunk outside the
   chunk's call, the replays' device ms) and the chunk and prefill
   capture seconds are reported apart;
   3b. on run (a)'s fp32 params: (c) qwen1.5-0.5b on run (a)'s traffic
   with every other request sampled (temperature 0.8, top-k 50, top-p
   0.9), alternating priority classes, a TTFT target on class 0 and the
   adaptive chunk policy (levels 1/2/4/8/16); (d) granite-moe-1b-a400m
   greedy at capacity factor 4.0; each served by an engine with eager
   steps and by one with CUDA graphs (a capturing pass; a second whose
   prefix hits on the first's prompts capture new ``(L, start)``
   prefills; a steady third), gated on exact launch counts in every
   pass, graphed pass 1 streams equal to eager ones and passes 2 and 3
   to solo decode (sampled ones with the engine's key), chunk captures
   within 2 x the levels and none new in pass 2, nothing captured in
   pass 3, every admitted ``(L, start)`` captured once and prefix hits at
   ``start > 0`` in passes 2 and 3, at least one chunk shrink (c), and
   every replay under ``torch.cuda.set_sync_debug_mode("error")``; (e) qwen1.5-0.5b,
   graphed, under the launcher's chaos plan (NaN poisoning, an
   allocation failure, index corruption, a chunk exception, a cancel, a
   deadline, queue-full rejects), gated on every request terminal with
   its planned fate, the streams without a fault equal to solo decode,
   each fault counted once, the engine degraded to 1-tick graphs and
   serving on, and the pool drained exactly.  Wall per tick, tok/s,
   TTFT p50, the card's busy share (profiled pass), each pass's host
   split, the capture seconds per variant and the graph pool's bytes
   are reported for eager and graphed (steady: graphed pass 3);
4. one ``kernels`` JSON line with all five kernels: launches over the
   two runs (a) and phase 5 (rows of their own for the paper models'
   fc_1, launches over phase 6, for jamba's four kernels at its shapes,
   launches over phase 7's graphed fp32 pass, for phase 8's BSR
   kernel at whisper's encoder w_up and qwen2-vl's decode up/gate and its
   G 6 paged attention, and for the planes kernel at phase 9's expert
   buffers, launches over (a)'s and (b) rank 0's counted calls), error
   against the plain version at every captured shape of phases 3, 5, 6,
   7, 8 and 9 (held
   to the phase-2 tolerances), the card's busy share over
   each run (a) from ``torch.profiler``, and the kernel's, the plain
   version's and one PyTorch library call's time at the main paths'
   shapes beside the least time the card could take (``bound_ms``), the
   planes kernel with and without the engine's row counts, the launch
   geometry (grid, cluster, shared memory) of the redesigned kernels and
   their ``-Xptxas -v`` lines, prefill at two longer prompts (qwen's
   heads, S 512 and S 256 after 256 cached tokens), decode at longer
   contexts (qwen's heads, B 4, page sizes 8 and 16, cache_len 512 and
   2048), and the timer's floor (a one-element add).

5. (run before phase 4) the training entry point's code
   (``repro_torch.launch.train``) on full-width qwen1.5-0.5b in its own
   dtypes (bf16 params and activations, fp32 AdamW master weights, its
   config's remat "dots": each layer's projections kept in fp32 for the
   backward pass, the rest recomputed): 20 steps at B 8, S 128 under
   ``warmup_cosine(3e-4, 3, 20)``, gated on finite losses whose last 5
   average below the first 5; then 3 steps under remat "full" and 3
   under "dots" from the trained state on the same batches, the losses
   within 1e-2 relative (ms per step, the card's busy share and
   ``max_memory_allocated`` reported for each); an asynchronous
   checkpoint at step 10 and a fresh trainer resumed from it, its
   step-11 loss within 1e-2 relative of the uninterrupted run's;
   Algorithm 2 (constant steps of 0.1 to 0.5, tolerance 0.05, 128x128
   tiles over the reference launcher's structures: the attention and
   MLP weights and the embedding, 10 fine-tune steps per iteration),
   gated on an iteration with pruned structures; the attention and MLP
   survivors packed to BSR (the masked embedding dense) and
   ``lm_forward`` on them held against the masked dense params (an fp32
   copy within 1e-3 of the largest |logit|, bf16 reported) with exactly
   7 x 24 BSR launches per forward; 4 requests served from the packed
   fp32 params through ``ServingEngine``, every stream equal to solo
   ``lm_generate``, with exact launch counts.  Reported: ms per step,
   tok/s, the card's busy share over two profiled steps,
   ``torch.cuda.max_memory_allocated``, seconds per pruner iteration
   (knapsack, fine-tune), and in phase 4 the BSR kernel at the packed
   forward's M = B * S = 1024 (fp32 and bf16) beside ``torch.matmul`` on
   the masked dense weight.  The launch counts of this path are zeroed
   before each of its segments and summed after.

6. (run before phase 4) the paper's own experiments through
   ``repro_torch.paper`` (seed 0, fp32, TF32 off): the quickstart (BSR
   against dense within fp32 ``TOL``, exactly 1 BSR launch); Tables II
   (jets MLP, RF 2/4/8/16 DSP-aware and BP-MD at RF 2 and 8), III (SVHN
   CNN, RF 3/9/27) and V (LeNet, heterogeneous MD) at full settings, each
   row's CSV line printed beside the paper's figure and gated on finite
   losses and accuracies, at least one Algorithm 2 iteration, a DSP
   reduction above 1, the pruned accuracy within the pruner's tolerance
   of the baseline and (jets) a baseline above 0.85 (where the last
   iteration broke the tolerance and was rolled back, the row, as the
   reference's, reports that iteration; the kept masks' reductions are
   reported beside it); §III-C on Table II
   RF 4 DSP and RF 2 MD, Table III RF 27 and Table V: every pruned FC
   kernel packed to BSR, the model's own forward over the validation
   batch within fp32 ``TOL`` of the masked dense one with exactly one
   BSR launch per packed layer (3 per model); per model, ms per train
   step and the card's busy share over a profiled fine-tune; the image
   models' fp32 forward on the card against the CPU's (TF32 on
   reported).  Phase 4 then times the BSR kernel at the three models'
   packed fc_1.

7. (run before phase 4) the recurrent and hybrid stacks through
   ``ServingEngine`` on phase 3's traffic (8 requests over 4 slots,
   17-64-token prompts, 16 tokens each, page size 8), with prefix caching
   gated to be reported off: jamba-v0.1-52b cut to one period of its
   layer pattern (8 layers: 7 Mamba + 1 attention, 4 dense MLPs + 4 MoE
   of 16 experts top-2) at full width, built in bf16, knapsack-pruned at
   0.75 with 128x128 tiles, packed, the dense tree freed; (a) an fp32
   copy at capacity factor E/k = 8.0, (b) bf16 at the config's 1.25;
   xlstm-350m whole (24 layers) and dense, (a) fp32, (b) bf16.  The tied
   embedding is scaled by ``EMBED_SCALE`` (0.01) after init, so that
   greedy streams follow the layers' state (gated: at least half of each
   stream's tokens distinct).  Each is served by an eager engine and a
   graphed one (capturing, steady and profiled passes; the admission
   prefills graphs too, one per prompt length, whose recurrent rows land
   in their slot on the device: gated to be captured once per length
   admitted, nothing captured in the steady pass, admissions in every
   slot), gated on exact launch counts in every pass (jamba:
   each BSR kernel once per packed weight per forward, planes once per
   packed expert weight per forward, paged decode once per attention
   layer per tick, paged prefill once per attention layer per
   admission; xlstm: no kernel at all), every stream finished at full
   length with finite logits, the graphed streams equal to the eager
   ones, and in fp32 to their solo decode on a fresh graphed engine:
   xlstm over 4 slots, jamba over 2 slots (decode routes at
   ``moe_decode``'s fixed capacity factor 2.0, so an expert holds
   max(ceil(4 x 2 x 2 / 16), 2) = 2 of 4 rows and a third row routed to
   it drops, as in the reference; 2 rows never drop).  An eager pass of
   jamba (a) keeps the kernels' inputs for phase 4, which holds each
   kernel against its plain version at jamba's shapes.  Reported: tok/s,
   wall per tick
   (admissions included), TTFT p50, the card's busy share, the build
   and pruning seconds, ``torch.cuda.max_memory_allocated`` and the
   phase's seconds.

8. (run before phase 4) the encoder-decoder and multimodal families, each
   knapsack-pruned at 0.75 with 128x128 tiles and packed: (a)
   whisper-tiny whole (4 encoder + 4 decoder layers, d_model 384, vocab
   51865, fp32 params) on the launcher's fixed batch (B 4, prompt 16, 32
   tokens, frames (4, 1500, 384) from the seed): with fp32 activations,
   ``lm_prefill`` + ``lm_generate`` equal to per-token greedy decode and
   to each row decoded alone, prefill logits equal to ``lm_forward``'s
   with frames, the packed forward within fp32 ``TOL`` of the masked
   dense one, teacher-forced decode logits within ``DECODE_TOL`` of
   ``lm_forward`` over the whole sequence, exact BSR launches (one per
   packed weight per encoder pass and per decoder forward; the cross
   projections stay dense, as the reference's pruner leaves them) and no
   other kernel; greedy streams of these random weights repeat a token
   (the decoder has no positional signal, as in the reference), so their
   distinct tokens are reported, not gated; then bf16 activations (full
   length, finite logits), the launcher's graphed path
   (``fixed_batch_run``: ``serve.FixedBatch`` at prompt lengths 0 and
   16, greedy and sampled, the prefill and the whole ``lm_generate``
   each one CUDA graph; gated: tokens equal the eager prefill +
   generate's, one replay of each graph, launches equal the eager
   call's; decode tok/s and, at 16 greedy, the busy share reported) and
   ``python -m repro_torch.launch.serve --arch whisper-tiny --pruned
   0.75``; (c) qwen1.5-0.5b's fixed batch the same way on phase 3's
   fp32 params.  (b) qwen2-vl-2b whole (28
   layers, d_model 1536, 12/2 heads of 128, M-RoPE (16, 24, 24)), built
   in bf16 with the tied embedding scaled by ``EMBED_SCALE``: (i) an fp32
   copy prefills B 2 on contiguous caches, 1024 stub patch embeddings on
   a 32 x 32 grid at (0, i // 32, i % 32) and 64 text tokens at 32 + j,
   then 16 greedy tokens, gated on prefill == ``lm_forward``,
   ``lm_generate`` == per-token decode and 7 BSR launches per layer per
   forward (greedy streams of these random weights repeat a token even
   with the embedding scaled: reported); (ii) phase 3's text-only
   traffic through ``ServingEngine``, every request sampled (temperature
   0.8, top-k 50, top-p 0.9, keys from the rids), eager and graphed,
   prefix caching on with a hit in every pass (the graphed engine takes a
   second capturing pass, for its prefix hits' new ``(L, start)``
   prefills, before the steady one), gated as phase 7's runs
   are (exact launches: BSR 7 x 28 per forward, paged decode 28 per
   tick, paged prefill 28 per admission; graphed == eager; the
   distinct-token floor), fp32 also == solo decode, then bf16.  An
   eager pass of each keeps the kernels' inputs for phase 4 (rows of
   their own in the ``kernels`` line).  Reported: tok/s, wall per tick,
   TTFT p50, the busy share, build seconds, ``max_memory_allocated`` and
   the phase's seconds.

9. (run before phase 4) the expert-parallel MoE through the all-to-all
   (``models/moe_alltoall.py``), in child processes through
   ``distributed.run_ranks``: granite-moe-1b-a400m at full width from
   seed 0, knapsack 0.75 at 128x128, packed, fp32, ``moe_impl=
   "alltoall"`` at capacity factor 4.0 = E/k (no slot drops at m = 1 or
   2), B 4 x S 128 tokens, under ``make_train_rules(False)`` on a
   ("data", "model") mesh.  (a) m = 1 over NCCL, mesh (1, 1): the
   expert buffers are (32, 512, 1024); ``lm_forward`` and ``lm_prefill``
   within fp32 ``TOL`` of the same calls with no mesh (``moe_apply``),
   aux within 1e-6, exactly 96 BSR and 72 planes launches per call and
   3 all-to-alls per MoE layer per call; one backward pass of
   ``cross_entropy_loss`` on the dense (unpacked) params, every gradient
   within 1e-4 of its leaf's largest against the no-mesh pass.  (b) m =
   2 as two processes sharing the card over gloo (NCCL refuses two ranks
   on one device), mesh (1, 2), 16 experts a rank, (16, 1024, 1024)
   buffers: both ranks' logits and aux equal (a)'s, the same exact
   launches, and at granite's own capacity factor 1.25, where slots may
   drop, both ranks' logits are equal (each takes model rank 0's MoE
   output); gloo stages the collective through the host, so (b)'s times
   are no NCCL figure.  (c) at m = 1 under
   ``make_decode_rules(False, shard_cache_seq=False)``: phase 3's first
   4 requests through a graphed ``ServingEngine``, every stream equal
   to the same engine's with no mesh and to solo decode, a prefix-cache
   hit (the tail prefill also routes through the all-to-all), exact
   launches, every admission a prefill graph (captured or replayed) and
   3 all-to-alls per MoE layer in the warm-up and in the capture of each
   prefill graph (the replays run theirs inside the graph).  Reported:
   ms per forward through the all-to-all and through ``moe_apply``, the
   all-to-all's share (a forward with each collective timed between
   synchronisations), the card's busy share, peak memory, tok/s with and
   without the mesh and the phase's seconds; phase 4 times the planes
   kernel at the captured expert buffers of (a) and of (b)'s rank 0.

10. (run before phase 4) the sharded program and its dry-run, in child
   processes: (a) one NCCL rank, mesh (1, 1): full-width qwen1.5-0.5b in
   phase 5's dtypes (bf16, fp32 master, remat "dots"), B 8 x S 128, 3 train
   steps on plain state and 3 on DTensor state placed by
   ``launch.specs.cell_shardings`` under the train rules, the losses
   within phase 5's resume tolerance, and the per-rank counter over one
   DTensor step equal, FLOPs, bytes and collectives, to the dry-run's
   fake trace of the same cell (a child process on a fake group of one
   rank); ms per step both ways, the card's busy share, peak memory
   against the trace's; (b) two gloo ranks sharing the card, mesh (1, 2)
   (tensor parallelism over "model"), one fp32 step of (a)'s params with
   AdamW in its linear regime, the loss within 1e-5 and every updated
   leaf within 1e-4 of its max of the plain step's (every collective
   staged through the host: gloo's CPU path); (c) ``launch.dryrun`` of
   qwen1.5-0.5b and granite-moe-1b-a400m, train_4k and decode_32k, on
   the 256-rank fake group at full width under their configs' remat
   "dots" (CPU only, started first and overlapping (a) and (b)), every
   record "ok".

11. (run after phase 3b) the analysis package: (a) the port's lint,
   ``python -m repro_torch.analysis --fail-on-new --json`` in a child
   process, exit 0 (files, findings and its milliseconds reported); (b)
   the host-sync meter at full width: qwen1.5-0.5b, knapsack 0.75 at
   128x128, fp32, on the graphed engine (phase 3's params), phase 3's
   8 requests over 4 slots (shared prefix, every other one sampled), 4
   ticks per sync: two warm-up streams (the second's prefix hits capture
   new ``(L, start)`` prefills) then a steady one on each of two
   engines, the second engine's steady stream under
   ``analysis.runtime.no_host_sync(strict=True)`` (every Python pull
   hook patched and CUDA's sync-debug mode "error").  Gated: no
   ``HostSyncError`` and no sync-debug error; pulls only under the
   ``admission`` and ``decode_chunk`` tags; ``decode_chunk`` regions
   equal to the chunks and ``admission`` regions to the admitted
   requests (the engine's counters and the process-wide ones);
   ``compile_caches`` and ``compile_events`` unchanged over the steady
   stream; every admission a prefill graph replay; exact launch counts;
   every stream equal to the unmetered engine's.  tok/s with and without
   the meter reported; (c) the two
   remaining examples on the card: ``paper.serve_pruned`` (its own
   checks: packed == masked dense within 1e-6 at reconstruction, one
   decode step within atol 1e-3 / rtol 1e-4; ``bsr_matmul`` launched)
   and ``paper.train_lm_pruned`` at its default size (the loss falls,
   Algorithm 2's iterations print).

The last line is ``{"ok": true, "device": {...}}``.  Without a card, or
without the repository beside it, the script exits non-zero and prints
no result.  Details go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms divisors
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# normalized error max|kernel - plain| / max(1, max|plain|) allowed: fp32
# sums differ only in order; bf16 outputs may differ by one bf16 rounding
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ATTN_TOL = 2e-5            # attention is fp32 inside for every input dtype

OUT = ROOT / "build"                  # listed in .gitignore
REPORT: dict = {"checks": [], "shapes": []}


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def held(name, got, want, tol) -> float:
    """Max abs error of a kernel's output against its plain version at a
    main-path shape; raises past the same normalized tolerance as
    phase 2."""
    err = rel_err(got, want)
    if err > tol:
        raise AssertionError(f"{name} at a main-path shape: normalized "
                             f"error {err:.3g} > {tol}")
    return float((got.float() - want.float()).abs().max())


class Timer:
    """Median time of ``fn`` over ``reps`` launches, each after an L2
    flush (the main path streams far more than the 50 MB L2 between two
    calls of one kernel, so it finds the cache cold), with CUDA events.

    ``device_only=True`` (kernels and library calls, which never wait for
    the host): a spin kernel queued first keeps the card busy while the
    host enqueues every launch, so each event pair times the device's
    work and not the Python wrapper in front of it.  Were the card to run
    dry before the last launch is queued, the spin grows and the timing
    is redone.  ``device_only=False`` (the plain versions, some of which
    read lengths back to the host): each call is timed alone, host gaps
    included, as it runs in place of the kernel."""

    SPIN_CYCLES = 20_000_000        # ~10 ms at the H100's boost clock

    def __init__(self, device):
        import torch
        self.torch = torch
        self.flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 25, warmup: int = 3,
                 device_only: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        spin = self.SPIN_CYCLES
        while True:
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            spun = torch.cuda.Event()
            if device_only:
                torch.cuda._sleep(spin)
                spun.record()
            for start, end in pairs:
                self.flush_buf.zero_()
                start.record()
                fn()
                end.record()
                if not device_only:
                    end.synchronize()
            ran_dry = device_only and spun.query()
            torch.cuda.synchronize()
            if not ran_dry:
                break
            if spin >= 64 * self.SPIN_CYCLES:
                raise RuntimeError("timer: the host could not keep ahead of "
                                   "the card; device time not measured")
            spin *= 4
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def ptxas_lines(text: str):
    """(kernel instance, line) for each register / spill line of an
    ``nvcc -Xptxas -v`` log, the instance demangled where ``c++filt``
    exists."""
    import re
    import shutil
    pairs, entry = [], "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line:
            pairs.append((entry, line.replace("ptxas info    :", "").strip()))
    if pairs and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(e for e, _ in pairs),
                               capture_output=True, text=True).stdout.split("\n")
        if len(names) >= len(pairs):
            pairs = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                      .replace("void ", ""), l) for n, (_, l) in zip(names, pairs)]
    return pairs


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the models use none, bias, silu+mult, res and (whisper) gelu; the rest
# covers the table
EPIS = ["none", "bias", "silu+mult", "res", "bias+silu+mult",
        "bias+gelu+mult+res"]


def make_epilogue(torch, spec, m, n, dtype, g, dev):
    from repro_torch.kernels import Epilogue
    if spec == "none":
        return None
    kw = {}
    if "bias" in spec:
        kw["bias"] = torch.randn(n, generator=g, device=dev).to(dtype)
    if "mult" in spec:
        kw["multiplier"] = torch.randn((m, n), generator=g, device=dev).to(dtype)
    if "res" in spec:
        kw["residual"] = torch.randn((m, n), generator=g, device=dev).to(dtype)
    act = next((a for a in ("silu", "gelu") if a in spec), None)
    return Epilogue(activation=act, **kw)


def check_bsr(torch, dev) -> float:
    from repro_torch.core import BlockingSpec, pack_bsr
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import bsr_matmul_plain

    worst = 0.0
    i = 0

    def run(g, bsr, dtype, ms=(1, 4, 64, 200), spec=None, **info):
        """M 1/4/64/200 against the plain version, epilogues in turn (or
        ``spec`` at every M)."""
        nonlocal i, worst
        k, n = bsr.shape
        for m in ms:
            epi_spec = spec or EPIS[i % len(EPIS)]
            i += 1
            x = torch.randn((m, k), generator=g, device=dev).to(dtype)
            epi = make_epilogue(torch, epi_spec, m, n, dtype, g, dev)
            got = ops.bsr_matmul(x, bsr, epilogue=epi)
            want = bsr_matmul_plain(x, bsr, epilogue=epi)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            ok = err <= TOL[dname(dtype)] and got.dtype == dtype
            REPORT["checks"].append(dict(
                kernel="bsr_matmul", m=m, k=k, n=n, dtype=dname(dtype),
                epilogue=epi_spec, rel_err=err, ok=ok, **info))
            if not ok:
                raise AssertionError(
                    f"bsr_matmul M={m} K={k} N={n} {info} {dname(dtype)} "
                    f"{epi_spec}: error {err:.3g} > {TOL[dname(dtype)]}")
            worst = max(worst, err)

    for shapes, blocks in BSR_SWEEPS:
        for (k, n), (bk, bn) in itertools.product(shapes, blocks):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(1000 + i)
                w = torch.randn((k, n), generator=g, device=dev).to(dtype)
                gk, gn = -(-k // min(bk, k)), -(-n // min(bn, n))
                alive = torch.rand((gk, gn), generator=g, device=dev) < 0.3
                alive[:, 0] = False              # an all-pruned column
                alive[0, -1] = True              # columns of unequal depth
                ebk, ebn = min(bk, k), min(bn, n)
                mask = alive.repeat_interleave(ebk, 0).repeat_interleave(ebn, 1)
                bsr = pack_bsr(w, BlockingSpec(bk, bn), mask=mask[:k, :n])
                run(g, bsr, dtype, bk=bk, bn=bn,
                    padding_slots=int((bsr.indices < 0).sum()))
    # a column spanning several slot groups, and one near the slot cap
    for name, (k, n, bk, bn, dense, p_live) in BSR_WIDE_COLUMNS.items():
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(3000 + i)
            bsr = bsr_layout(torch, g, dev, k, n, bk, bn, dense, p_live, dtype)
            run(g, bsr, dtype, case=name, bk=bk, bn=bn, max_nnz=bsr.max_nnz)
    # whisper's weights, the gelu epilogue alone, about a quarter live;
    # also fp32 weights under bf16 activations, as its config runs them
    shapes, ms = WHISPER_BSR
    f32, bf16 = torch.float32, torch.bfloat16
    for k, n in shapes:
        for wdtype, dtype in ((f32, f32), (bf16, bf16), (f32, bf16)):
            g = torch.Generator(device=dev).manual_seed(4000 + i)
            bsr = bsr_layout(torch, g, dev, k, n, 128, 128, 0, 0.25, wdtype)
            run(g, bsr, dtype, ms=ms, spec="gelu", case="whisper", bk=128, bn=128,
                weight_dtype=dname(wdtype))
    log(f"  bsr_matmul: {i} cases OK (with a dense column, a near-cap "
        f"column and whisper's gelu alone at M {list(ms)}), worst normalized "
        f"error {worst:.3g} (tolerance fp32 {TOL['float32']}, bf16 "
        f"{TOL['bfloat16']})")
    return worst


# BSR sweeps: (K, N) and tiles; qwen's weights and an odd shape at 128x128
# and 32x32, then jamba-v0.1-52b's wq/wo, wk/wv, up/gate and down and
# qwen2-vl-2b's wq/wo, wk/wv, up/gate and down at the 128x128 tiles they
# are served with
BSR_SWEEPS = ((((1024, 1024), (1024, 2816), (2816, 1024), (100, 36)),
               ((128, 128), (32, 32))),
              (((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)),
               ((128, 128),)),
              (((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)),
               ((128, 128),)))
# whisper-tiny's weights (q/k/v/o, w_up, w_down) at 128x128 with the gelu
# epilogue alone (its non-gated w_up), at the decoder's M 4 and the
# encoder's M = 4 x 1500
WHISPER_BSR = (((384, 384), (384, 1536), (1536, 384)), (4, 6000))

# (K, N, bk, bn, dense block column, live share): qwen's down projection
# at 32x32 tiles with one fully dense column (88 live slots, several slot
# groups), and a column of 1000 live slots, near the slot cap of one
# group (1024)
BSR_WIDE_COLUMNS = {
    "down_32x32_dense_column": (2816, 1024, 32, 32, 5, 0.25),
    "near_cap_column": (32000, 64, 32, 32, 1, 0.02),
}


def bsr_layout(torch, g, dev, k, n, bk, bn, dense, p_live, dtype):
    from repro_torch.core import BlockingSpec, pack_bsr
    w = torch.randn((k, n), generator=g, device=dev).to(dtype)
    alive = torch.rand((-(-k // bk), -(-n // bn)), generator=g, device=dev) < p_live
    alive[:, dense] = True
    mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
    return pack_bsr(w, BlockingSpec(bk, bn), mask=mask)


# the paper experiments' packed FC layouts (K, N, bk, bn): the jets MLP's
# 16->64, 64->32 and 32->32 at the DSP-aware tiles (RF, 1) of RF 2/4/8/16
# (the BRAM-aware (RF * C, 1) tiles of RF 2 and 8 are (4, 1) and (16, 1)
# with consecutive 2: C changes the knapsack's costs, not the packing)
# and the quickstart's (8, 8); SVHN's fc_1 96->42 at (27, 1) (K padded to
# 4 tiles) and (3, 1), fc_2 42->64 at (9, 1); LeNet's fc_1 400->120 at
# (50, 1), fc_2 120->84 at (24, 1) and fc_3 84->10 at (1, 1)
PAPER_LAYOUTS = (
    [(k, n, bk, bn) for k, n in ((16, 64), (64, 32), (32, 32))
     for bk, bn in ((2, 1), (4, 1), (8, 1), (16, 1), (8, 8))]
    + [(96, 42, 27, 1), (96, 42, 3, 1), (42, 64, 9, 1), (400, 120, 50, 1),
       (120, 84, 24, 1), (84, 10, 1, 1)])
PAPER_M = (1, 64, 256, 2048)


def check_bsr_paper(torch, dev):
    """fp32 ``bsr_matmul`` against its plain version at the paper's
    layouts, ~40 % of the tiles live and block column 0 all pruned, at M
    1/64/256/2048 with the epilogues in turn.  Returns the (name,
    BSRWeight) layouts for the bit-identity gate."""
    from repro_torch.core import BlockingSpec, pack_bsr
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import bsr_matmul_plain
    layouts, worst, i = [], 0.0, 0
    for j, (k, n, bk, bn) in enumerate(PAPER_LAYOUTS):
        g = torch.Generator(device=dev).manual_seed(5000 + j)
        w = torch.randn((k, n), generator=g, device=dev)
        alive = torch.rand((-(-k // bk), -(-n // bn)), generator=g, device=dev) < 0.4
        alive[:, 0] = False                      # an all-pruned column
        alive[0, -1] = True
        mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
        bsr = pack_bsr(w, BlockingSpec(bk, bn), mask=mask)
        for m in PAPER_M:
            spec = EPIS[i % len(EPIS)]
            i += 1
            x = torch.randn((m, k), generator=g, device=dev)
            epi = make_epilogue(torch, spec, m, n, torch.float32, g, dev)
            got = ops.bsr_matmul(x, bsr, epilogue=epi)
            want = bsr_matmul_plain(x, bsr, epilogue=epi)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            ok = err <= TOL["float32"]
            REPORT["checks"].append(dict(
                kernel="bsr_matmul", case="paper", m=m, k=k, n=n, bk=bk, bn=bn,
                dtype="float32", epilogue=spec, nnz_blocks=bsr.nnz_blocks,
                rel_err=err, ok=ok))
            if not ok:
                raise AssertionError(
                    f"bsr_matmul paper layout M={m} K={k} N={n} ({bk},{bn}) "
                    f"{spec}: error {err:.3g} > {TOL['float32']}")
            worst = max(worst, err)
        layouts.append((f"paper {k}->{n} ({bk},{bn})", bsr))
    log(f"  bsr_matmul at the paper's {len(PAPER_LAYOUTS)} packed FC layouts "
        f"x M {list(PAPER_M)}: {i} cases OK, worst normalized error "
        f"{worst:.3g} (tolerance {TOL['float32']})")
    return layouts


def check_bsr_invariance(torch, dev, weights) -> int:
    """Gated: in fp32 a row's BSR output is bit-identical computed alone
    (M 1) and inside M 4, 47 and 200, for each (name, BSRWeight)."""
    from repro_torch.kernels import Epilogue, ops
    n_rows = 0
    for name, bsr in weights:
        k, n = bsr.shape
        g = torch.Generator(device=dev).manual_seed(k + n)
        x = torch.randn((200, k), generator=g, device=dev)
        mult = torch.randn((200, n), generator=g, device=dev)

        def run(lo, hi):
            return ops.bsr_matmul(x[lo:hi], bsr, epilogue=Epilogue(
                activation="silu", multiplier=mult[lo:hi]))

        full = run(0, 200)
        same = {m: bool(torch.equal(run(0, m), full[:m])) for m in (4, 47)}
        same["alone"] = all(bool(torch.equal(run(r, r + 1), full[r:r + 1]))
                            for r in (0, 1, 3, 46, 199))
        REPORT["checks"].append(dict(kernel="bsr_matmul", invariance=name,
                                     k=k, n=n, max_nnz=bsr.max_nnz,
                                     bit_identical=same, ok=all(same.values())))
        if not all(same.values()):
            raise AssertionError(f"bsr_matmul {name}: rows differ across M "
                                 f"(bit-identical: {same})")
        n_rows += 1
    return n_rows


def check_prefill_invariance(torch, dev) -> int:
    """Gated: in fp32 a query position's prefill output is bit-identical
    in a full prefill (q_offset 0, S = L), a tail prefill (q_offset 3 ps)
    and a ragged batch of 3 rows, at ``ATTN_INVARIANCE``'s heads."""
    from repro_torch.kernels import ops
    n = 0
    L = 75
    for dh, ps, h, kvh in ATTN_INVARIANCE:
        g = torch.Generator(device=dev).manual_seed(ps + h + kvh)
        lens = torch.tensor([L + 9, L, 11], dtype=torch.int32, device=dev)
        kp, vp, tbl = poisoned_pools(torch, g, dev, 3, kvh, dh, ps,
                                     -(-(L + 9) // ps), lens, torch.float32)
        q = torch.randn((3, L + 9, h, dh), generator=g, device=dev)
        one = lens[1:2].contiguous()
        t1 = tbl[1:2].contiguous()
        full = ops.paged_attention_prefill(q[1:2, :L].contiguous(), kp, vp,
                                           t1, one)
        off = 3 * ps
        tail = ops.paged_attention_prefill(q[1:2, off:L].contiguous(), kp,
                                           vp, t1, one, q_offset=off)
        batch = ops.paged_attention_prefill(q, kp, vp, tbl, lens)
        same = {"tail": bool(torch.equal(tail, full[:, off:])),
                "ragged_batch": bool(torch.equal(batch[1, :L], full[0]))}
        REPORT["checks"].append(dict(kernel="paged_attention_prefill",
                                     invariance=f"dh {dh} ps {ps} H {h} K {kvh}",
                                     bit_identical=same,
                                     ok=all(same.values())))
        if not all(same.values()):
            raise AssertionError(f"paged prefill ps={ps} H={h} K={kvh}: "
                                 f"positions differ across calls {same}")
        n += 1
    return n


def poisoned_pools(torch, g, dev, b, kvh, dh, ps, max_pages, lens, pool_dtype):
    """Shuffled page ids per row (length-0 rows park on the null page 0);
    NaN in every slot no row owns, the null page included."""
    n_pages = b * max_pages + 1
    tbl = (torch.randperm(n_pages - 1, generator=g, device=dev)[: b * max_pages]
           .reshape(b, max_pages) + 1)
    lens_l = [int(v) for v in lens]
    for r, ln in enumerate(lens_l):
        if ln == 0:
            tbl[r] = 0
    kp = torch.full((n_pages, ps, kvh, dh), float("nan"), device=dev)
    vp = kp.clone()
    for r, ln in enumerate(lens_l):
        t = torch.arange(ln, device=dev)
        pid, off = tbl[r, t // ps], t % ps
        kp[pid, off] = torch.randn((ln, kvh, dh), generator=g, device=dev)
        vp[pid, off] = torch.randn((ln, kvh, dh), generator=g, device=dev)
    return kp.to(pool_dtype), vp.to(pool_dtype), tbl.to(torch.int32)


# paged attention sweeps: head_dim, page sizes, (heads, KV heads); qwen's
# and granite's head_dim 64 over GQA 1:1 to 4:1, then jamba-v0.1-52b's
# head_dim 128 at its 32/8 heads and qwen2-vl-2b's at 12/2 (G 6, the one
# group size that is not a power of two) at the page size they are
# served with
ATTN_SWEEPS = ((64, (4, 8, 16), ((16, 16), (16, 8), (8, 2), (4, 1))),
               (128, (8,), ((32, 8), (12, 2))))
# the fp32 batch-invariance gates of the paged kernels: (head_dim, page
# size, heads, KV heads) at qwen's and granite's heads, and qwen2-vl's G 6
ATTN_INVARIANCE = [(64, ps, h, kvh) for ps in (8, 16)
                   for h, kvh in ((16, 16), (16, 8))] + [(128, 8, 12, 2)]


def check_attention(torch, dev) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (
        paged_attention_decode_plain, paged_attention_prefill_plain)

    worst = 0.0
    n_dec = n_pre = 0
    for dh, page_sizes, heads in ATTN_SWEEPS:
        for ps, (h, kvh) in itertools.product(page_sizes, heads):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(ps * 100 + h + kvh)
                # decode: ragged cache_len including 0
                b, mp = 5, 9
                clen = torch.tensor([0, 1, ps + 3, 5 * ps, mp * ps - 1],
                                    dtype=torch.int32, device=dev)
                kp, vp, tbl = poisoned_pools(torch, g, dev, b, kvh, dh, ps, mp,
                                             clen, torch.float32)
                q = torch.randn((b, h, dh), generator=g, device=dev).to(dtype)
                kn = torch.randn((b, kvh, dh), generator=g, device=dev).to(dtype)
                vn = torch.randn((b, kvh, dh), generator=g, device=dev).to(dtype)
                got = ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen)
                want = paged_attention_decode_plain(q, kn, vn, kp, vp, tbl, clen)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                REPORT["checks"].append(dict(
                    kernel="paged_attention_decode", dh=dh, ps=ps, h=h, kvh=kvh,
                    dtype=dname(dtype), rel_err=err, ok=err <= ATTN_TOL))
                if err > ATTN_TOL:
                    raise AssertionError(
                        f"paged decode dh={dh} ps={ps} H={h} K={kvh} {dname(dtype)}: "
                        f"error {err:.3g} > {ATTN_TOL}")
                worst = max(worst, err)
                n_dec += 1
                # prefill: q_offset 0 / ps / 3ps, rows past their length
                for q_offset in (0, ps, 3 * ps):
                    s = 37
                    total = q_offset + s
                    lens = torch.tensor([total, q_offset + 5, total - 9],
                                        dtype=torch.int32, device=dev)
                    mp2 = -(-total // ps) + 1
                    kp2, vp2, tbl2 = poisoned_pools(torch, g, dev, 3, kvh, dh,
                                                    ps, mp2, lens, torch.float32)
                    qp = torch.randn((3, s, h, dh), generator=g, device=dev).to(dtype)
                    got = ops.paged_attention_prefill(qp, kp2, vp2, tbl2, lens,
                                                      q_offset=q_offset)
                    want = paged_attention_prefill_plain(qp, kp2, vp2, tbl2, lens,
                                                         q_offset=q_offset)
                    torch.cuda.synchronize()
                    err = rel_err(got, want)
                    dead_ok = bool((got[1, 5:] == 0).all())
                    ok = err <= ATTN_TOL and dead_ok
                    REPORT["checks"].append(dict(
                        kernel="paged_attention_prefill", dh=dh, ps=ps, h=h,
                        kvh=kvh,
                        q_offset=q_offset, dtype=dname(dtype), rel_err=err,
                        ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"paged prefill dh={dh} ps={ps} H={h} K={kvh} q_offset="
                            f"{q_offset} {dname(dtype)}: error {err:.3g}, rows "
                            f"past length zero: {dead_ok}")
                    worst = max(worst, err)
                    n_pre += 1
    log(f"  paged_attention_decode: {n_dec} cases, paged_attention_prefill: "
        f"{n_pre} cases OK (NaN-poisoned pools), worst normalized error "
        f"{worst:.3g} (tolerance {ATTN_TOL})")
    return worst


def random_planes(torch, g, dev, e, k, n, bk, bn, dtype, p_live=0.3):
    """A BSRPlanes stack of E random planes: with E > 1 plane 0 is dead
    and plane 1 fully dense, the rest about ``p_live`` live with an
    all-pruned block column."""
    from repro_torch.core import BlockingSpec, BSRPlanes, pack_bsr
    ebk, ebn = min(bk, k), min(bn, n)
    gk, gn = -(-k // ebk), -(-n // ebn)
    planes = []
    for p in range(e):
        w = torch.randn((k, n), generator=g, device=dev).to(dtype)
        alive = torch.rand((gk, gn), generator=g, device=dev) < p_live
        alive[:, 0] = False
        alive[0, -1] = True
        if e > 1 and p == 0:
            alive[:] = False
        if e > 1 and p == 1:
            alive[:] = True
        mask = alive.repeat_interleave(ebk, 0).repeat_interleave(ebn, 1)
        planes.append(pack_bsr(w, BlockingSpec(bk, bn), mask=mask[:k, :n]))
    return BSRPlanes.from_planes(tuple(planes), shape=(e, k, n))


# the expert FFN uses none and silu+mult; bias and res cover the rest
PLANE_EPIS = ["none", "silu+mult", "res", "bias"]
# planes sweeps: E, M, (K, N), blocks; granite's experts_up/gate and
# experts_down and a ragged one, then jamba-v0.1-52b's 16 experts up/gate
# and down at 128x128 tiles, M its decode capacity (2 rows over 4 slots),
# its prefill capacity at capacity factor 1.25 and at 8.0 (64-token prompt)
PLANE_SWEEPS = (((1, 3, 32), (1, 8, 47, 200),
                 ((1024, 512), (512, 1024), (100, 36)), ((128, 128), (32, 32))),
                ((16,), (2, 10, 64), ((4096, 14336), (14336, 4096)),
                 ((128, 128),)))
# norms sweep: qwen's gate projection, granite's experts_up as (E * K, N)
# (with bk | K its tiles are the per-plane tiles), a ragged shape; tiles
NORMS_SWEEP = (((1024, 2816), (32 * 1024, 512), (100, 36)), (128, 32))


def check_planes(torch, dev) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import bsr_planes_matmul_plain

    worst = 0.0
    i = 0
    for es, ms, shapes, blocks in PLANE_SWEEPS:
        for e, (k, n), (bk, bn) in itertools.product(es, shapes, blocks):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(5000 + i)
                planes = random_planes(torch, g, dev, e, k, n, bk, bn, dtype)
                for m in ms:
                    spec = PLANE_EPIS[i % len(PLANE_EPIS)]
                    i += 1
                    x = torch.randn((e, m, k), generator=g, device=dev).to(dtype)
                    epi = make_epilogue(torch, spec, m, n, dtype, g, dev)
                    if epi is not None:
                        epi = epi.map_operands(lambda a: torch.randn(
                            (e, m, n), generator=g, device=dev).to(dtype))
                    got = ops.bsr_planes_matmul(x, planes, epilogue=epi)
                    want = bsr_planes_matmul_plain(x, planes, epilogue=epi)
                    torch.cuda.synchronize()
                    err = rel_err(got, want)
                    ok = err <= TOL[dname(dtype)] and got.dtype == dtype
                    REPORT["checks"].append(dict(
                        kernel="bsr_planes_matmul", e=e, m=m, k=k, n=n,
                        bk=bk, bn=bn, dtype=dname(dtype), epilogue=spec,
                        plane_nnz=list(planes.plane_nnz), rel_err=err,
                        ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"bsr_planes_matmul E={e} M={m} K={k} N={n} "
                            f"blocks {bk}x{bn} {dname(dtype)} {spec}: "
                            f"error {err:.3g} > {TOL[dname(dtype)]}")
                    worst = max(worst, err)
    log(f"  bsr_planes_matmul: {i} cases OK (dead and fully dense planes), "
        f"worst normalized error {worst:.3g}")
    return worst


# planes with row counts: (segments, C) and each plane's counts per segment
# (0, C, ragged); plane 3 has live tiles but every count 0
PLANE_COUNTS = {(1, 8): [[0], [8], [3], [0]], (1, 47): [[47], [1], [16], [0]],
                (2, 15): [[0, 15], [15, 1], [7, 0], [0, 0]]}


def check_planes_counts(torch, dev) -> float:
    """The planes kernel with row counts against the plain version with
    the same counts: counts of 0, C and ragged ones, one and two segments
    per plane, a plane with live tiles whose counts are all 0, every
    epilogue; and every row past its count equal to epilogue(0)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import (
        bsr_planes_matmul_plain, live_rows)
    worst = 0.0
    i = 0
    for (segs, c), per_plane in PLANE_COUNTS.items():
        for (k, n) in ((1024, 512), (512, 1024)):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(8000 + i)
                planes = random_planes(torch, g, dev, 4, k, n, 128, 128, dtype)
                m = segs * c
                counts = torch.tensor(per_plane, dtype=torch.int32, device=dev)
                for spec in ("none", "silu+mult", "bias+gelu+mult+res"):
                    i += 1
                    x = torch.randn((4, m, k), generator=g, device=dev).to(dtype)
                    epi = make_epilogue(torch, spec, m, n, dtype, g, dev)
                    if epi is not None:
                        epi = epi.map_operands(lambda a: torch.randn(
                            (4, m, n), generator=g, device=dev).to(dtype))
                    got = ops.bsr_planes_matmul(x, planes, epilogue=epi,
                                                row_counts=counts)
                    want = bsr_planes_matmul_plain(x, planes, epilogue=epi,
                                                   row_counts=counts)
                    zero = bsr_planes_matmul_plain(torch.zeros_like(x), planes,
                                                   epilogue=epi)
                    torch.cuda.synchronize()
                    dead = ~live_rows(counts, m)
                    err = rel_err(got, want)
                    err0 = rel_err(got[dead], zero[dead])
                    tol = TOL[dname(dtype)]
                    ok = err <= tol and err0 <= tol
                    REPORT["checks"].append(dict(
                        kernel="bsr_planes_matmul", row_counts=per_plane,
                        segments=segs, c=c, k=k, n=n, dtype=dname(dtype),
                        epilogue=spec, rel_err=err, dead_rows_err=err0, ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"bsr_planes_matmul counts {per_plane} K={k} N={n} "
                            f"{dname(dtype)} {spec}: error {err:.3g}, rows past "
                            f"their count vs epilogue(0) {err0:.3g} > {tol}")
                    worst = max(worst, err, err0)
    log(f"  bsr_planes_matmul with row counts: {i} cases OK (counts 0, C, "
        f"ragged; 1 and 2 segments; a live plane with all counts 0; rows past "
        f"the count = epilogue(0)), worst normalized error {worst:.3g}")
    return worst


# the expert buffers of phase 9's all-to-all on granite (B 4 x S 128
# tokens, cf 4.0): (E_loc, c_exp) = (32, 512) at m = 1, (16, 1024) at m = 2;
# its up/gate (1024 -> 512) and down (512 -> 1024) experts, 0.75 pruned
A2A_BUFFERS = ((32, 512), (16, 1024))


def check_planes_a2a(torch, dev) -> float:
    """The planes kernel against its plain version at the all-to-all's
    expert buffers, fp32 and bf16, with and without row counts (random
    fills in [0, C], rows past them zero as the dispatch leaves them),
    with the path's epilogues; rows past the fill held to epilogue(0)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import (
        bsr_planes_matmul_plain, live_rows)
    worst = 0.0
    i = 0
    for (e, c), (k, n) in itertools.product(A2A_BUFFERS, ((1024, 512), (512, 1024))):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(9000 + i)
            planes = random_planes(torch, g, dev, e, k, n, 128, 128, dtype,
                                   p_live=0.25)
            counts = torch.randint(0, c + 1, (e, 1), generator=g, device=dev,
                                   dtype=torch.int32)
            live = live_rows(counts, c).reshape(e, c, 1)
            x = torch.randn((e, c, k), generator=g, device=dev).to(dtype) * live
            for spec in (("none", "silu+mult") if k == 1024 else ("none",)):
                for rc in (counts, None):
                    i += 1
                    epi = make_epilogue(torch, spec, c, n, dtype, g, dev)
                    if epi is not None:
                        epi = epi.map_operands(lambda a: torch.randn(
                            (e, c, n), generator=g, device=dev).to(dtype))
                    got = ops.bsr_planes_matmul(x, planes, epilogue=epi,
                                                row_counts=rc)
                    want = bsr_planes_matmul_plain(x, planes, epilogue=epi,
                                                   row_counts=rc)
                    zero = bsr_planes_matmul_plain(torch.zeros_like(x), planes,
                                                   epilogue=epi)
                    torch.cuda.synchronize()
                    dead = ~live_rows(counts, c)
                    err = rel_err(got, want)
                    err0 = rel_err(got[dead], zero[dead])
                    tol = TOL[dname(dtype)]
                    ok = err <= tol and err0 <= tol
                    REPORT["checks"].append(dict(
                        kernel="bsr_planes_matmul", a2a_buffer=[e, c], k=k, n=n,
                        dtype=dname(dtype), epilogue=spec,
                        row_counts=rc is not None, rel_err=err,
                        dead_rows_err=err0, ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"bsr_planes_matmul at the all-to-all buffer ({e}, "
                            f"{c}) K={k} N={n} {dname(dtype)} {spec} counts="
                            f"{rc is not None}: error {err:.3g}, rows past the "
                            f"fill vs epilogue(0) {err0:.3g} > {tol}")
                    worst = max(worst, err, err0)
    log(f"  bsr_planes_matmul at the all-to-all buffers {list(A2A_BUFFERS)}: "
        f"{i} cases OK (fp32/bf16, with and without row counts, rows past the "
        f"fill = epilogue(0)), worst normalized error {worst:.3g}")
    return worst


def check_planes_invariance(torch, dev) -> int:
    """Gated: in fp32 a row of plane e is bit-identical at M 1, 8 and 47
    (decode and prefill row tiles), and with and without row counts for
    rows below the count, at granite's expert shapes."""
    from repro_torch.kernels import Epilogue, ops
    n_cases = 0
    for (k, n) in ((1024, 512), (512, 1024)):
        g = torch.Generator(device=dev).manual_seed(k)
        planes = random_planes(torch, g, dev, 8, k, n, 128, 128, torch.float32)
        x = torch.randn((8, 47, k), generator=g, device=dev)
        mult = torch.randn((8, 47, n), generator=g, device=dev)
        counts = torch.tensor([[c] for c in (47, 0, 5, 16, 17, 1, 33, 8)],
                              dtype=torch.int32, device=dev)

        def run(m, rc=None):
            return ops.bsr_planes_matmul(
                x[:, :m].contiguous(), planes, row_counts=rc,
                epilogue=Epilogue(activation="silu",
                                  multiplier=mult[:, :m].contiguous()))

        full = run(47)
        with_counts = run(47, counts)
        same = {f"M {m}": bool(torch.equal(run(m), full[:, :m])) for m in (1, 8)}
        same["counts"] = all(bool(torch.equal(with_counts[p, :int(c)],
                                              full[p, :int(c)]))
                             for p, c in enumerate(counts[:, 0].tolist()))
        REPORT["checks"].append(dict(kernel="bsr_planes_matmul",
                                     invariance=f"{k}x{n}", bit_identical=same,
                                     ok=all(same.values())))
        if not all(same.values()):
            raise AssertionError(f"bsr_planes_matmul {k}x{n}: rows differ "
                                 f"across M or counts (bit-identical: {same})")
        n_cases += 1
    return n_cases


def check_decode_chunks(torch, dev) -> float:
    """Paged decode over context chunks: cache_len 0, 1, an exact chunk
    boundary, two chunks and more than 8 chunks (1500); page sizes 4, 8,
    16; every GQA pair of phase 2; NaN in every slot no row owns; all four
    (q, pool) dtype pairs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (
        decode_chunk, paged_attention_decode_plain)
    worst = 0.0
    i = 0
    dh = 64
    for ps in (4, 8, 16):
        chunk = decode_chunk(ps, dh)
        for h, kvh in ((16, 16), (16, 8), (8, 2), (4, 1)):
            g = torch.Generator(device=dev).manual_seed(9000 + ps * 100 + h + kvh)
            clen = torch.tensor([0, 1, chunk, 2 * chunk, 1500], dtype=torch.int32,
                                device=dev)
            mp = -(-1500 // ps) + 1
            kp, vp, tbl = poisoned_pools(torch, g, dev, 5, kvh, dh, ps, mp, clen,
                                         torch.float32)
            q = torch.randn((5, h, dh), generator=g, device=dev)
            kn = torch.randn((5, kvh, dh), generator=g, device=dev)
            vn = torch.randn((5, kvh, dh), generator=g, device=dev)
            for qd in (torch.float32, torch.bfloat16):
                for pd in (torch.float32, torch.bfloat16):
                    i += 1
                    a = (q.to(qd), kn.to(qd), vn.to(qd), kp.to(pd), vp.to(pd),
                         tbl, clen)
                    got = ops.paged_attention_decode(*a)
                    want = paged_attention_decode_plain(*a)
                    torch.cuda.synchronize()
                    err = rel_err(got, want)
                    REPORT["checks"].append(dict(
                        kernel="paged_attention_decode", ps=ps, h=h, kvh=kvh,
                        chunk=chunk, cache_len=[int(v) for v in clen],
                        dtype=dname(qd), pool_dtype=dname(pd), rel_err=err,
                        ok=err <= ATTN_TOL))
                    if err > ATTN_TOL:
                        raise AssertionError(
                            f"paged decode chunks ps={ps} H={h} K={kvh} "
                            f"{dname(qd)}/{dname(pd)}: error {err:.3g} > {ATTN_TOL}")
                    worst = max(worst, err)
    log(f"  paged_attention_decode over chunks: {i} cases OK (cache_len 0, 1, "
        f"a chunk boundary, 2 chunks, 1500; ps 4/8/16; 4 GQA pairs; 4 dtype "
        f"pairs; NaN-poisoned pools), worst normalized error {worst:.3g}")
    return worst


def check_decode_invariance(torch, dev) -> int:
    """Gated: in fp32 a decode row's output is bit-identical computed
    alone (its own table), inside a ragged batch of 5 and with a table 4x
    wider, at ``ATTN_INVARIANCE``'s heads and page sizes."""
    from repro_torch.kernels import ops
    n = 0
    lens = [61, 0, 1500, 7, 300]
    for dh, ps, h, kvh in ATTN_INVARIANCE:
        g = torch.Generator(device=dev).manual_seed(9500 + ps + kvh)
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        mp = -(-1500 // ps) + 1
        kp, vp, tbl = poisoned_pools(torch, g, dev, 5, kvh, dh, ps, mp, clen,
                                     torch.float32)
        q = torch.randn((5, h, dh), generator=g, device=dev)
        kn = torch.randn((5, kvh, dh), generator=g, device=dev)
        vn = torch.randn((5, kvh, dh), generator=g, device=dev)
        batch = ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen)
        same = {}
        for r in (0, 2, 4):
            one = [t[r:r + 1].contiguous() for t in (q, kn, vn)]
            own = tbl[r:r + 1, :max(-(-lens[r] // ps), 1)].contiguous()
            wide = torch.zeros((1, 4 * mp), dtype=torch.int32, device=dev)
            wide[0, :mp] = tbl[r]
            alone = ops.paged_attention_decode(*one, kp, vp, own, clen[r:r + 1])
            wider = ops.paged_attention_decode(*one, kp, vp, wide, clen[r:r + 1])
            same[f"row {r} alone"] = bool(torch.equal(alone, batch[r:r + 1]))
            same[f"row {r} wide table"] = bool(torch.equal(wider,
                                                           batch[r:r + 1]))
        REPORT["checks"].append(dict(kernel="paged_attention_decode",
                                     invariance=f"dh {dh} ps {ps} H {h} K {kvh}",
                                     bit_identical=same,
                                     ok=all(same.values())))
        if not all(same.values()):
            raise AssertionError(f"paged decode ps={ps} H={h} K={kvh}: rows "
                                 f"differ across calls {same}")
        n += 1
    return n


def check_norms(torch, dev) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.structure_norms import structure_norms_plain

    worst = 0.0
    i = 0
    shapes, tiles = NORMS_SWEEP
    for (k, n) in shapes:
        for blk in tiles:
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(7000 + i)
                i += 1
                w = torch.randn((k, n), generator=g, device=dev).to(dtype)
                got = ops.structure_norms(w, blk, blk)
                want = structure_norms_plain(w, blk, blk)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                ok = err <= TOL["float32"] and got.dtype == torch.float32
                REPORT["checks"].append(dict(
                    kernel="structure_norms", k=k, n=n, bk=blk, bn=blk,
                    dtype=dname(dtype), rel_err=err, ok=ok))
                if not ok:
                    raise AssertionError(
                        f"structure_norms ({k}, {n}) tiles {blk} "
                        f"{dname(dtype)}: error {err:.3g} > {TOL['float32']}")
                worst = max(worst, err)
    log(f"  structure_norms: {i} cases OK, worst normalized error "
        f"{worst:.3g} (fp32 sums in both input dtypes, tolerance "
        f"{TOL['float32']})")
    return worst


def check_router(torch, dev) -> dict:
    """Whether a token's router logits are bit-identical alone, in a
    decode batch of 4 and in a 64-token prompt (granite's widths).
    Reported, not gated: run (a)'s stream == solo check is the gate."""
    from repro_torch.models.moe import router_logits
    g = torch.Generator(device=dev).manual_seed(9)
    w = torch.randn((1024, 32), generator=g, device=dev) / 32
    x = torch.randn((64, 1024), generator=g, device=dev)
    full = router_logits(x[None], w)[0]
    same = {t: bool(torch.equal(router_logits(x[None, :t], w)[0], full[:t]))
            for t in (1, 4, 17)}
    same["1_each"] = all(bool(torch.equal(router_logits(x[None, j:j + 1], w)[0],
                                          full[j:j + 1])) for j in range(8))
    REPORT["router_batch_independent"] = same
    log(f"  router logits bit-identical alone and in batches of 4/17/64: "
        f"{same} (reported)")
    return same


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def epilogue_kind(epilogue) -> str:
    if epilogue is None:
        return "none"
    return "+".join(name for name, v in (
        ("bias", epilogue.bias), (epilogue.activation, epilogue.activation),
        ("mult", epilogue.multiplier), ("res", epilogue.residual))
        if v is not None)


class Capture:
    """Keeps copies of the kernels' inputs at a main path's shapes while
    a warm-up run of the engine goes through ``kernels.ops`` (the
    counted run goes through the untouched functions)."""

    NAMES = ("bsr_matmul", "bsr_planes_matmul", "paged_attention_decode",
             "paged_attention_prefill")

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.bsr = {}
        self.planes = {}
        self.decode = None
        self.prefill = {}
        self.phase = "prefill"        # of the last BSR or attention call

    def __enter__(self):
        torch, ops, orig = self.torch, self.ops, self.orig

        def clone(t):
            return None if t is None else t.detach().clone()

        def bsr_matmul(x, bsr, *, epilogue=None):
            # one decode-shaped call (B, 1, D) and the longest prompt per
            # weight shape and epilogue
            phase = "decode" if x.ndim == 3 and x.shape[1] == 1 else "prefill"
            self.phase = phase
            key = (phase, bsr.shape, epilogue_kind(epilogue))
            if key not in self.bsr or x.numel() > self.bsr[key][0].numel():
                self.bsr[key] = (clone(x), bsr, None if epilogue is None else
                                 epilogue.map_operands(clone))
            return orig["bsr_matmul"](x, bsr, epilogue=epilogue)

        def bsr_planes_matmul(x, planes, *, epilogue=None, row_counts=None):
            # the MoE layer runs after a BSR or attention call of the same
            # forward pass (its layer's attention, or jamba's dense MLP
            # one layer below)
            key = (self.phase, tuple(planes.shape), epilogue_kind(epilogue))
            if key not in self.planes or x.numel() > self.planes[key][0].numel():
                self.planes[key] = (clone(x), planes, None if epilogue is None
                                    else epilogue.map_operands(clone),
                                    clone(row_counts))
            return orig["bsr_planes_matmul"](x, planes, epilogue=epilogue,
                                             row_counts=row_counts)

        def decode(q, k_new, v_new, k_pool, v_pool, page_table, cache_len):
            self.phase = "decode"
            ctx = int(torch.as_tensor(cache_len).sum())
            if self.decode is None or ctx > self.decode[0]:
                self.decode = (ctx, tuple(clone(t) for t in (
                    q, k_new, v_new, k_pool, v_pool, page_table,
                    torch.as_tensor(cache_len))))
            return orig["paged_attention_decode"](
                q, k_new, v_new, k_pool, v_pool, page_table, cache_len)

        def prefill(q, k_pool, v_pool, page_table, lengths, *, q_offset=0):
            self.phase = "prefill"
            key = q_offset > 0
            if key not in self.prefill or q.shape[1] > self.prefill[key][0].shape[1]:
                self.prefill[key] = (clone(q), clone(k_pool), clone(v_pool),
                                     clone(page_table), clone(torch.as_tensor(lengths)),
                                     q_offset)
            return orig["paged_attention_prefill"](
                q, k_pool, v_pool, page_table, lengths, q_offset=q_offset)

        ops.bsr_matmul = bsr_matmul
        ops.bsr_planes_matmul = bsr_planes_matmul
        ops.paged_attention_decode = decode
        ops.paged_attention_prefill = prefill
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)
        return False


def traffic(vocab: int, seed: int):
    """8 requests, ragged 17..64-token prompts over a shared 16-token
    prefix; request 1 repeats request 0 (a full-prompt prefix hit)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=16)
    tails = rng.integers(1, 49, size=8)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, size=int(t))])
               .astype(np.int32) for t in tails]
    prompts[1] = prompts[0].copy()
    return prompts


def serve_once(params, cfg, prompts, gen, dev, cuda_graphs=True):
    """Run (a)'s traffic through a fresh engine (4 ticks per sync); see
    ``serve_pass``.  Returns (engine, the pass)."""
    import torch
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(params, cfg, num_slots=4, page_size=8,
                        max_seq_len=max(len(p) for p in prompts) + gen,
                        ticks_per_sync=4, device=dev, cuda_graphs=cuda_graphs)
    return eng, serve_pass(torch, eng, prompts, gen)


def device_busy(torch, run, wall_s):
    """Where a run's time goes: ``run()`` (the same run again) under
    torch.profiler, recording the card's activity only.  The kernels' and
    copies' summed device time (one stream, so no overlap) over the
    unprofiled run's wall time is the card's busy share; the rest is host
    time (Python, launches, syncs).  The device events are summed straight
    from the profiler's raw results: building its per-op tables takes
    tens of seconds over a run of ~60k kernels.  Reported, not gated: a
    profiler that cannot start or stop, or shows no device time, gives
    "not measured".  A failure of the engine run itself ends the script."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as exc:                    # the profiler's own failure
        return {"busy_share": "not measured", "error": repr(exc)}
    stop_error = None
    try:
        run()
    finally:
        try:
            prof.stop()
        except Exception as exc:                # the profiler's own failure
            stop_error = exc
    if stop_error is not None:
        return {"busy_share": "not measured", "error": repr(stop_error)}
    by_name = {}
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ms, calls = by_name.get(e.name(), (0.0, 0))
                by_name[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    except Exception as exc:                    # the profiler's own failure
        return {"busy_share": "not measured", "error": repr(exc)}
    kern = sorted(((ms, calls, name) for name, (ms, calls) in by_name.items()),
                  reverse=True)
    busy_ms = sum(t for t, _, _ in kern)
    if busy_ms <= 0:
        return {"busy_share": "not measured",
                "error": "the profiler recorded no device time"}
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "busy_share": busy_ms / (wall_s * 1e3),
            "top": [{"ms": t, "calls": c, "name": k[:90]}
                    for t, c, k in kern[:10] if t > 0]}


# launches of each BSR kernel per layer per forward pass
PER_LAYER = {
    "qwen1.5-0.5b": {"bsr_matmul": 7},                     # q k v o up gate down
    "granite-moe-1b-a400m": {"bsr_matmul": 4,               # q k v o
                             "bsr_planes_matmul": 3},       # up gate down
}


def main_path(torch, dev, gpu_line, arch: str, cf_a=None):
    """Serve ``arch`` at full width: run (a) in fp32 (at capacity factor
    ``cf_a`` for MoE) gated on stream == solo decode, run (b) in the
    config's dtypes.  Returns (stats_a, stats_b, capture, launches, (fp32
    params, fp32 config, prompts, gen)) — run (a)'s inputs, for phase 3b."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve

    gen, seed = 16, 0
    base = get_config(arch)
    cfg_a = base.replace(param_dtype="float32", activ_dtype="float32")
    if cf_a is not None:
        cfg_a = cfg_a.replace(capacity_factor=cf_a)
    prompts = traffic(base.vocab, seed)

    t0 = time.perf_counter()
    params, summ = serve.build_params(cfg_a, seed=seed, device=dev, pruned=0.75,
                                      block=(128, 128), min_size=4096)
    torch.cuda.synchronize()
    log(f"  (a) fp32: init + knapsack + pack {time.perf_counter() - t0:.2f}s; "
        f"kept {summ['kept']}/{summ['total']} structures "
        f"({summ['method']}), BSR density {summ['density']:.4f} "
        f"({summ['nnz_blocks']}/{summ['total_blocks']} blocks)")

    # warm-up run with eager chunks (the capture of the kernels' inputs
    # reads lengths back to the host, which a CUDA graph cannot hold)
    with Capture(torch, ops) as cap:
        serve_once(params, cfg_a, prompts, gen, dev, cuda_graphs=False)
    _build.reset_launch_counts()
    eng, run_a = serve_once(params, cfg_a, prompts, gen, dev)
    done, dt = run_a["done"], run_a["seconds"]
    launches = dict(_build.launch_counts)
    graphs_a = eng.analysis_stats()
    prefill_gates(f"{arch} run (a)", eng, [run_a])
    emitted = sum(len(r.tokens) for r in done.values())
    ttft = sorted(eng.ttft_seconds(r) * 1e3 for r in done)
    st = eng.prefix_stats
    passes = eng.decode_ticks + len(done)        # decode ticks + prefills
    stats_a = dict(capacity_factor=cfg_a.capacity_factor, tokens=emitted,
                   seconds=dt, tok_per_s=emitted / dt,
                   ttft_ms_p50=statistics.median(ttft), ttft_ms_max=ttft[-1],
                   prefix_hit_requests=st["hit_requests"],
                   pages_shared=st["pages_shared"], launches=launches,
                   decode_ticks=eng.decode_ticks, forward_passes=passes,
                   slot_utilization=eng.slot_utilization,
                   density=summ["density"], nnz_blocks=summ["nnz_blocks"],
                   total_blocks=summ["total_blocks"], cuda_graphs=graphs_a,
                   seconds_less_captures=run_a["seconds_less_captures"],
                   split=run_a["split"], graph_pool_bytes=eng.graph_pool_bytes())
    log(f"  (a) fp32: {len(done)} requests, {emitted} tokens in {dt:.3f}s = "
        f"{emitted / dt:.1f} tok/s, TTFT p50 {stats_a['ttft_ms_p50']:.2f} ms "
        f"max {ttft[-1]:.2f} ms, {st['hit_requests']} prefix-hit requests "
        f"({st['pages_shared']} pages mapped), {eng.decode_ticks} decode "
        f"ticks + {len(done)} prefills, launches {launches}; CUDA graphs "
        f"{graphs_a['variants']} and prefills {graphs_a['prefill_variants']} "
        f"(captured in this run: its wall includes them, "
        f"{run_a['seconds_less_captures']:.3f} s without), replays "
        f"{graphs_a['replays']}")
    log(f"  (a) fp32: {split_line(run_a)}")
    log(f"  {arch} (a) on {gpu_line}: {emitted / dt:.1f} tok/s, TTFT p50 "
        f"{stats_a['ttft_ms_p50']:.2f} ms")
    if st["hit_requests"] < 1:
        raise AssertionError(f"{arch} run (a): no prefix-cache hit")
    used = {"bsr_matmul", "paged_attention_decode", "paged_attention_prefill",
            *PER_LAYER[arch]}
    for name in used:
        if launches[name] < 1:
            raise AssertionError(f"{arch} run (a): kernel {name} never launched")
    for name, per in PER_LAYER[arch].items():
        want = per * base.n_layers * passes
        if launches[name] != want:
            raise AssertionError(
                f"{arch} run (a): {name} launched {launches[name]} times, "
                f"not {per} x {base.n_layers} layers x {passes} passes = {want}")
    # paged attention: one launch per layer per decode tick / per prefill
    for name, calls in (("paged_attention_decode", eng.decode_ticks),
                        ("paged_attention_prefill", len(done))):
        if launches[name] != base.n_layers * calls:
            raise AssertionError(
                f"{arch} run (a): {name} launched {launches[name]} times, "
                f"not {base.n_layers} layers x {calls}")
    bad = serve.verify_streams(params, cfg_a, done, gen, device=dev)
    if bad:
        raise AssertionError(f"{arch} run (a): streams {bad} differ from solo "
                             "decode")
    log(f"  (a) fp32: all {len(done)} streams token-identical to solo decode; "
        + ", ".join(f"{name} {launches[name]} = {per} x {base.n_layers} x "
                    f"{passes} passes" for name, per in PER_LAYER[arch].items()))
    busy = device_busy(
        torch, lambda: serve_once(params, cfg_a, prompts, gen, dev), dt)
    stats_a["device"] = busy
    if isinstance(busy["busy_share"], float):
        log(f"  (a) fp32: card busy {busy['device_busy_ms']:.1f} of "
            f"{busy['wall_ms']:.1f} ms wall ({100 * busy['busy_share']:.1f}%), "
            f"{dt / max(eng.decode_ticks, 1) * 1e3:.2f} ms wall per tick; "
            f"top kernels:")
        for row in busy["top"][:6]:
            log(f"    {row['ms']:9.3f} ms {row['calls']:6d} calls  {row['name']}")
    else:
        log(f"  (a) fp32: card busy share not measured ({busy['error']})")
    first_a = {rid: int(r.tokens[0]) for rid, r in done.items()}
    del eng

    # (b) the config's own dtypes (and capacity factor), same seed and traffic
    params_b, _ = serve.build_params(base, seed=seed, device=dev, pruned=0.75,
                                     block=(128, 128), min_size=4096)
    serve_once(params_b, base, prompts, gen, dev)          # warm-up
    eng_b, run_b = serve_once(params_b, base, prompts, gen, dev)
    done_b, dt_b = run_b["done"], run_b["seconds"]
    emitted_b = sum(len(r.tokens) for r in done_b.values())
    agree = sum(first_a[rid] == int(r.tokens[0]) for rid, r in done_b.items())
    ttft_b = sorted(eng_b.ttft_seconds(r) * 1e3 for r in done_b)
    stats_b = dict(capacity_factor=base.capacity_factor, tokens=emitted_b,
                   seconds=dt_b, tok_per_s=emitted_b / dt_b,
                   ttft_ms_p50=statistics.median(ttft_b),
                   first_token_agreement=f"{agree}/{len(done_b)}")
    log(f"  (b) {base.param_dtype}: {len(done_b)} streams at full length, "
        f"finite logits; {emitted_b} tokens in {dt_b:.3f}s = "
        f"{emitted_b / dt_b:.1f} tok/s, TTFT p50 {stats_b['ttft_ms_p50']:.2f} "
        f"ms; first tokens equal to (a) in {agree}/{len(done_b)} requests "
        f"(reported, not gated)")
    del params_b, eng_b
    torch.cuda.empty_cache()
    return stats_a, stats_b, cap, launches, (params, cfg_a, prompts, gen)


# ---------------------------------------------------------------------------
# phase 3b: sampled, adaptive and chaos serving; eager chunks vs CUDA graphs
# ---------------------------------------------------------------------------

LEVELS = (1, 2, 4, 8, 16)                 # the adaptive policy's chunk lengths
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
TTFT_TARGET = 8                           # ticks, on the interactive class


def submit_traffic(eng, prompts, gen, *, sampled=False, adaptive=False):
    """Run (a)'s traffic from the engine's current tick (arrivals every 2
    ticks).  ``sampled``: every other request samples (temperatures
    cycled 0, 0.8; top-k 50, top-p 0.9).  ``adaptive``: alternating
    priority classes, a TTFT target on class 0."""
    base = eng.tick
    for i, p in enumerate(prompts):
        kw = dict(SAMPLING) if sampled and i % 2 else {}
        if adaptive:
            kw["priority"] = i % 2
            if i % 2 == 0:
                kw["ttft_target_ticks"] = TTFT_TARGET
        eng.submit(p, gen, arrival=base + 2 * i, **kw)


def profiled_device_ms(torch, fn):
    """``fn()`` under torch.profiler recording the card's activity only:
    (its result, the summed device time of its kernels and copies in ms,
    or None where the profiler recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA) / 1e6
    return out, (ms if ms > 0 else None)


class HostSplit:
    """Where a serving pass's host time goes, for any engine of the port:
    the wall of ``ServingEngine.step``, ``_admit`` and ``_run_chunk``
    (perf_counter), and CUDA events around every ``CUDAGraph.replay``
    (its span on the card is its device time: one launch enqueues the
    whole graph), attributed to the admission when it runs inside
    ``_admit``.  With ``profile_prefill`` each eager admission prefill
    (``engine._paged_prefill_step``) runs under torch.profiler, which
    gives its device time (and slows its host).  The capture seconds a
    pass spent (read from ``analysis_stats`` before and after) are taken
    out of the walls they fell in.  Reported per pass by ``summary``."""

    def __init__(self, torch, profile_prefill=False):
        self.torch, self.profile_prefill = torch, profile_prefill
        self.wall = {"step": 0.0, "_admit": 0.0, "_run_chunk": 0.0}
        self.events = {"admission": [], "chunk": []}
        self.profiled = []                  # device ms of eager prefills
        self.in_admit = False

    def __enter__(self):
        torch = self.torch
        from repro_torch.serving import engine as em
        cls = em.ServingEngine
        self.saved = [(cls, n, getattr(cls, n)) for n in self.wall]
        self.saved.append((torch.cuda.CUDAGraph, "replay",
                           torch.cuda.CUDAGraph.replay))
        if self.profile_prefill:
            self.saved.append((em, "_paged_prefill_step", em._paged_prefill_step))
        split = self

        def timed(name, fn):
            admit = name == "_admit"

            def wrapper(eng, *a, **kw):
                t0 = time.perf_counter()
                split.in_admit = split.in_admit or admit
                try:
                    return fn(eng, *a, **kw)
                finally:
                    if admit:
                        split.in_admit = False
                    split.wall[name] += time.perf_counter() - t0
            return wrapper

        for owner, name, fn in self.saved[:3]:
            setattr(owner, name, timed(name, fn))
        replay = torch.cuda.CUDAGraph.replay

        def replay_timed(graph):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            replay(graph)
            ev[1].record()
            split.events["admission" if split.in_admit else "chunk"].append(ev)

        torch.cuda.CUDAGraph.replay = replay_timed
        if self.profile_prefill:
            prefill = em._paged_prefill_step

            def profiled(*a, **kw):
                out, ms = profiled_device_ms(torch, lambda: prefill(*a, **kw))
                split.profiled.append(ms)
                return out

            em._paged_prefill_step = profiled
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False

    def summary(self, admissions, chunks, captures):
        """ms per admission and per chunk (host and device), after the
        pass synchronised.  ``captures``: {"chunk": s, "prefill": s}
        spent capturing in the pass."""
        def mean_span(evs):
            return (sum(a.elapsed_time(b) for a, b in evs) / len(evs)
                    if evs else None)

        w = {k: v * 1e3 for k, v in self.wall.items()}
        cap = {k: v * 1e3 for k, v in captures.items()}
        device = mean_span(self.events["admission"])
        measured = [ms for ms in self.profiled if ms is not None]
        if measured:
            device = sum(measured) / len(measured)
        return dict(
            admissions=admissions, chunks=chunks, capture_s=dict(captures),
            admit_host_ms=(w["_admit"] - cap["prefill"]) / max(admissions, 1),
            chunk_call_ms=(w["_run_chunk"] - cap["chunk"]) / max(chunks, 1),
            chunk_host_ms=(w["step"] - w["_admit"] - w["_run_chunk"])
            / max(chunks, 1),
            chunk_device_ms=mean_span(self.events["chunk"]),
            prefill_replays=len(self.events["admission"]),
            prefill_profiled=len(measured), prefill_device_ms=device)


def capture_seconds(an):
    """Seconds spent capturing so far: {"chunk": s, "prefill": s}."""
    return {"chunk": sum(an.get("capture_seconds", {}).values()),
            "prefill": sum(an.get("prefill_capture_seconds", {}).values())}


def serve_pass(torch, eng, prompts, gen, profile_prefill=False, **traffic_kw):
    """One pass of the traffic through ``eng`` (which may have served
    passes before).  Launch counts are zeroed just before it and read
    just after.  Returns a dict: this pass's requests by rid, seconds,
    decode ticks, admissions, launches, tok/s, TTFT p50, wall ms per
    tick, the prefill variants admitted (``(L, start)`` from each
    request's prefix hit) and the host split (``HostSplit``; with
    ``profile_prefill`` the eager prefills' device time)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import RequestStatus
    first = eng._next_rid
    ticks0 = eng.decode_ticks
    chunks0 = sum(eng.chunks_by_ticks.values())
    caps0 = capture_seconds(eng.analysis_stats())
    submit_traffic(eng, prompts, gen, **traffic_kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with HostSplit(torch, profile_prefill) as split:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    mine = {rid: r for rid, r in done.items() if rid >= first}
    if len(mine) != len(prompts) or any(
            r.status is not RequestStatus.FINISHED or len(r.tokens) != gen
            for r in mine.values()):
        raise AssertionError(f"{eng.cfg.name}: a stream failed (non-finite "
                             "logits) or ended short")
    ticks = eng.decode_ticks - ticks0
    emitted = sum(len(r.tokens) for r in mine.values())
    caps1 = capture_seconds(eng.analysis_stats())
    caps = {k: caps1[k] - caps0[k] for k in caps1}
    ps = eng.pool.page_size
    variants = sorted({(len(r.prompt) - r.prefix_hit_pages * ps,
                        r.prefix_hit_pages * ps) for r in mine.values()})
    return dict(done=mine, seconds=dt, decode_ticks=ticks,
                admissions=len(mine), launches=launches,
                tok_per_s=emitted / dt, wall_ms_per_tick=dt / ticks * 1e3,
                ttft_ms_p50=statistics.median(
                    eng.ttft_seconds(r) * 1e3 for r in mine),
                prefill_variants=variants,
                seconds_less_captures=dt - sum(caps.values()),
                split=split.summary(len(mine), sum(eng.chunks_by_ticks.values())
                                    - chunks0, caps))


def gate_launches(arch, label, n_layers, run):
    """Run (a)'s exact launch counts for one pass: each BSR kernel once
    per weight per forward pass, paged decode once per layer per tick,
    paged prefill once per layer per admission."""
    passes = run["decode_ticks"] + run["admissions"]
    want = {name: per * n_layers * passes
            for name, per in PER_LAYER[arch].items()}
    want["paged_attention_decode"] = n_layers * run["decode_ticks"]
    want["paged_attention_prefill"] = n_layers * run["admissions"]
    got = {name: run["launches"][name] for name in want}
    if got != want:
        raise AssertionError(f"{arch} {label}: launches {got} != {want}")
    return want


def same_streams(label, a, b):
    diff = [rid for rid in a if not (a[rid].tokens.shape == b[rid].tokens.shape
                                     and (a[rid].tokens == b[rid].tokens).all())]
    if sorted(a) != sorted(b) or diff:
        raise AssertionError(f"{label}: streams {diff} differ")


def public(run):
    """A pass's numbers for the report (no request objects)."""
    return {k: v for k, v in run.items() if k != "done"}


def captured(eng):
    """(chunk, prefill) variants an engine has captured."""
    an = eng.analysis_stats()
    return an["captures"], an["prefill_captures"]


def prefill_gates(label, eng, runs, before_last=None):
    """The graphed prefill's gates over an engine's passes: every
    admitted ``(L, start)`` captured once (``compile_caches`` equals the
    distinct variants), the last pass captured nothing new, chunk or
    prefill (with ``before_last``, ``captured`` before it), and each
    pass after the first admitted prefix hits at ``start > 0``."""
    an = eng.analysis_stats()
    seen = {f"{n}@{st}" for run in runs for n, st in run["prefill_variants"]}
    if set(an["prefill_variants"]) != seen or \
            an["compile_caches"]["_paged_prefill_step"] != len(seen):
        raise AssertionError(f"{label}: prefill graphs {an['prefill_variants']} "
                             f"(cache {an['compile_caches']}) != the admitted "
                             f"variants {sorted(seen)}")
    if before_last is not None and captured(eng) != before_last:
        raise AssertionError(f"{label}: the last pass captured: (chunk, "
                             f"prefill) variants {before_last} -> {captured(eng)}")
    for i, run in enumerate(runs[1:], start=2):
        if not any(st > 0 for _, st in run["prefill_variants"]):
            raise AssertionError(f"{label} pass {i}: no prefix hit at start > 0")


def split_line(run):
    """One pass's host split for the log."""
    sp = run["split"]

    def ms(v):
        return f"{v:.2f}" if isinstance(v, float) else str(v)
    return (f"admission host {ms(sp['admit_host_ms'])} ms (prefill device "
            f"{ms(sp['prefill_device_ms'])} ms), chunk host outside the call "
            f"{ms(sp['chunk_host_ms'])} ms + call {ms(sp['chunk_call_ms'])} ms "
            f"(replay device {ms(sp['chunk_device_ms'])} ms), captures "
            f"chunk {sp['capture_s']['chunk']:.3f} s prefill "
            f"{sp['capture_s']['prefill']:.3f} s")


def eager_vs_graphed(torch, dev, gpu_line, arch, params, cfg, prompts, gen, *,
                     sampled, adaptive):
    """Serve the traffic through an engine with eager steps and one with
    CUDA graphs: eager one timed pass and one profiled; graphed a first
    pass (captures), a second (its prefix hits on pass 1's prompts capture
    new ``(L, start)`` prefills), a third (steady: nothing new captured)
    and a profiled fourth.  Gated: exact launch counts in every pass
    (through replays), the chunk captures within the declared variants,
    ``prefill_gates``, graphed pass 1 streams equal to the eager ones
    (same rids, same keys), graphed passes 2 and 3 token-identical to
    their solo decode (sampled ones with the engine's key; pass 3's
    greedy streams through pass 2's) and their greedy streams equal to
    pass 1's.  Replays run under sync-debug
    "error" in the engine itself, so a hidden sync fails the run.  Each
    pass reports its host split (``HostSplit``)."""
    from repro_torch.launch import serve
    from repro_torch.serving import AdaptiveChunkPolicy, ServingEngine
    kw = dict(sampled=sampled, adaptive=adaptive)
    out, passes, engines, secs = {}, {}, {}, {}
    for graphed in (False, True):
        t0 = time.perf_counter()
        eng = ServingEngine(
            params, cfg, num_slots=4, page_size=8,
            max_seq_len=max(len(p) for p in prompts) + gen,
            ticks_per_sync=LEVELS[-1] if adaptive else 4,
            chunk_policy=AdaptiveChunkPolicy(LEVELS) if adaptive else None,
            device=dev, cuda_graphs=graphed)
        mode = "graphed" if graphed else "eager"
        runs = [serve_pass(torch, eng, prompts, gen, **kw)]
        if graphed:
            caps1 = captured(eng)
            runs.append(serve_pass(torch, eng, prompts, gen, **kw))
            caps2 = captured(eng)
            runs.append(serve_pass(torch, eng, prompts, gen, **kw))
        an = eng.analysis_stats()
        steady = runs[-1]
        t1 = time.perf_counter()
        busy = device_busy(torch, lambda: serve_pass(torch, eng, prompts, gen,
                                                     **kw), steady["seconds"])
        secs[mode] = dict(passes=t1 - t0, profile=time.perf_counter() - t1)
        for i, run in enumerate(runs):
            gate_launches(arch, f"{mode} pass {i + 1}", cfg.n_layers, run)
        slo = eng.slo_stats()
        if adaptive and slo["chunk_shrinks"] < 1:
            raise AssertionError(f"{arch} {mode}: no chunk shrank")
        if graphed:
            limit = 2 * len(LEVELS) if adaptive else 2
            if an["captures"] > limit:
                raise AssertionError(f"{arch}: {an['captures']} captured "
                                     f"variants > {limit}")
            if caps2[0] != caps1[0]:
                raise AssertionError(f"{arch}: the second pass captured "
                                     f"{caps2[0] - caps1[0]} new chunk variants")
            prefill_gates(f"{arch} graphed", eng, runs, caps2)
        passes[mode] = runs
        engines[mode] = eng
        out[mode] = dict(passes=[public(r) for r in runs], device=busy,
                         chunks_by_ticks=slo["chunks_by_ticks"],
                         chunk_shrinks=slo["chunk_shrinks"],
                         chunk_grows=slo["chunk_grows"],
                         variants=an["variants"],
                         capture_seconds=an.get("capture_seconds", {}),
                         replays=an.get("replays", {}),
                         prefill_variants=an.get("prefill_variants", []),
                         prefill_capture_seconds=an.get(
                             "prefill_capture_seconds", {}),
                         capture_split={k: an.get(k) for k in (
                             "capture_split", "prefill_capture_split")},
                         graph_pool_bytes=eng.graph_pool_bytes())
        share = busy["busy_share"]
        share = (f"busy {busy['device_busy_ms']:.1f} ms = {100 * share:.1f}% "
                 "of wall" if isinstance(share, float) else
                 f"busy share not measured ({busy.get('error')})")
        log(f"  {arch} {mode}: {steady['wall_ms_per_tick']:.2f} ms wall per "
            f"tick over {steady['decode_ticks']} ticks, {steady['tok_per_s']:.1f}"
            f" tok/s, TTFT p50 {steady['ttft_ms_p50']:.2f} ms, {share}; "
            f"chunks {slo['chunks_by_ticks']} ({slo['chunk_shrinks']} shrinks)"
            + (f"; chunk captures {an.get('capture_seconds')}; "
               f"{an['prefill_captures']} prefill captures "
               f"({sum(an['prefill_capture_seconds'].values()):.2f} s, split "
               f"{ {k: round(v, 3) for k, v in an['prefill_capture_split'].items()} }"
               f"); graph pool {out[mode]['graph_pool_bytes']} bytes"
               if graphed else ""))
        for i, run in enumerate(runs):
            log(f"    {mode} pass {i + 1}: {run['tok_per_s']:.1f} tok/s, "
                f"{run['seconds']:.3f} s ({run['seconds_less_captures']:.3f} s "
                f"less captures); {split_line(run)}")
    g = passes["graphed"]
    same_streams(f"{arch} graphed pass 1 vs eager", g[0]["done"],
                 passes["eager"][0]["done"])
    greedy = {r: q for r, q in g[0]["done"].items()
              if not (q.temperature or 0) > 0}
    t2 = time.perf_counter()
    for i in (1, 2):
        shift = min(g[i]["done"]) - min(g[0]["done"])
        same_streams(f"{arch} greedy streams, graphed pass {i + 1} vs pass 1",
                     greedy, {r: g[i]["done"][r + shift] for r in greedy})
        # pass 2's streams against solo decode; pass 3's greedy ones equal
        # pass 2's (both equal pass 1's), so its sampled ones (other rids,
        # other keys) are the ones left to decode alone
        check = {r: q for r, q in g[i]["done"].items()
                 if i == 1 or r - shift not in greedy}
        bad = serve.verify_streams(params, cfg, check, gen, device=dev,
                                   engine=engines["graphed"])
        if bad:
            raise AssertionError(f"{arch} graphed pass {i + 1}: streams {bad} "
                                 "differ from solo decode")
    secs["verify"] = time.perf_counter() - t2
    n_s = len(g[0]["done"]) - len(greedy)
    out["seconds"] = secs
    log(f"  {arch}: graphed pass 1 streams == eager streams; graphed passes 2 "
        f"and 3 streams token-identical to solo decode ({n_s} of "
        f"{len(prompts)} sampled) and their greedy ones to pass 1's; exact "
        f"launch counts through replays; pass 3 captured nothing; seconds "
        f"{secs}; on {gpu_line}")
    return out


def chaos_run(torch, dev, gpu_line, params, cfg):
    """Run (e): qwen at full width, graphed, under the launcher's chaos
    plan (NaN poisoning, an allocation failure, index corruption, a
    chunk exception) plus a cancel, a deadline and rejects from a full
    queue.  Gated by ``serve.check_chaos`` (every request terminal with
    its planned fate, streams without a fault equal to solo decode, the
    others solo prefixes, the pool drained exactly), each planned fault
    counted once, and the degraded engine serving on in 1-tick graphs."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.serving import FaultInjector, ServingEngine
    requests, plen, gen = 6, 16, 12
    rng = np.random.default_rng(0)
    lens = rng.integers(plen // 2, plen + 1, size=requests)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    plan, victim = serve.chaos_plan(requests)
    inj = FaultInjector(plan, seed=0)
    eng = ServingEngine(params, cfg, num_slots=4, page_size=8,
                        max_seq_len=plen + gen, ticks_per_sync=4, seed=0,
                        max_queue=requests + 2, fault_injector=inj, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(p, gen, arrival=2 * i)
    rid_cancel, rid_expire, rejected = serve.serve_chaos(eng, prompts, gen)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    failures = serve.check_chaos(eng, inj, done, params, cfg, gen, device=dev,
                                 victim=victim, rid_cancel=rid_cancel,
                                 rid_expire=rid_expire, rejected=rejected)
    st = eng.fault_stats
    once = dict(guard_trips=1, failed=1, chunk_failures=1, alloc_failures=1,
                index_drops=1, cancelled=1, expired=1, rejected=3, degraded=1)
    failures += [f"fault_stats[{k}] = {st[k]}, not {v}"
                 for k, v in once.items() if st[k] != v]
    an = eng.analysis_stats()
    if "1/greedy" not in an["variants"] or not eng.chunks_by_ticks.get(1):
        failures.append(f"the degraded engine served no 1-tick graph: "
                        f"{an['variants']}, chunks {eng.chunks_by_ticks}")
    if failures:
        raise AssertionError("chaos run (e): " + "; ".join(failures))
    log(f"  chaos (e), graphed: {len(done)} requests terminal in {dt:.3f}s "
        f"(checks {time.perf_counter() - t1:.1f}s) "
        f"({sorted((r.rid, r.status.value) for r in done.values())}); fault "
        f"counters {st}; fired {[(k, t) for k, t, _ in inj.fired]}; graphs "
        f"{an['variants']}; pool drained exactly; on {gpu_line}")
    return dict(seconds=dt, fault_stats=st, fired=[(k, t) for k, t, _ in inj.fired],
                variants=an["variants"], chunks_by_ticks=dict(eng.chunks_by_ticks),
                statuses={rid: r.status.value for rid, r in done.items()})


def serving_runs(torch, dev, gpu_line, paths):
    """Phase 3b on run (a)'s fp32 params: (c) qwen sampled + adaptive,
    eager vs graphed; (d) granite greedy at capacity factor 4.0, eager vs
    graphed; (e) qwen chaos, graphed."""
    t0 = time.perf_counter()
    params, cfg, prompts, gen = paths["qwen1.5-0.5b"][4]
    log("phase 3b: (c) qwen1.5-0.5b sampled + adaptive, eager vs CUDA graphs")
    runs = {"c": eager_vs_graphed(torch, dev, gpu_line, "qwen1.5-0.5b", params,
                                  cfg, prompts, gen, sampled=True, adaptive=True)}
    log("phase 3b: (e) qwen1.5-0.5b chaos, CUDA graphs")
    runs["e"] = chaos_run(torch, dev, gpu_line, params, cfg)
    params, cfg, prompts, gen = paths["granite-moe-1b-a400m"][4]
    log("phase 3b: (d) granite-moe-1b-a400m greedy at capacity factor 4.0, "
        "eager vs CUDA graphs")
    runs["d"] = eager_vs_graphed(torch, dev, gpu_line, "granite-moe-1b-a400m",
                                 params, cfg, prompts, gen, sampled=False,
                                 adaptive=False)
    runs["seconds"] = time.perf_counter() - t0
    log(f"  phase 3b took {runs['seconds']:.1f}s")
    return runs


# ---------------------------------------------------------------------------
# phase 5: train, knapsack-prune (Algorithm 2), pack and serve qwen1.5-0.5b
# ---------------------------------------------------------------------------

TRAIN = dict(arch="qwen1.5-0.5b", steps=20, batch=8, seq=128, lr=3e-4,
             seed=0, ckpt_every=10, target=0.5)
# phase 5's remat sub-step: steps under each policy from the trained state
REMAT_STEPS = 3
REMAT_LOSS_TOL = 1e-2      # "full" vs "dots" losses: phase 5's resume gate


def counted(segments, name, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read
    just after; the counts go to ``segments[name]``."""
    from repro_torch.kernels import _build
    import torch
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    segments[name] = dict(_build.launch_counts)
    return out


def training_busy(torch, step_fn, state, pipe, steps=(10, 11)):
    """Wall ms per step and the card's busy share over two more training
    steps run from the trained state (the step is functional: the
    trainer's state is not advanced)."""
    def run():
        st = state
        for s in steps:
            st, m = step_fn(st, pipe.batch_at(s))
        float(m["total_loss"])
    run()                                           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = device_busy(torch, run, wall)
    busy["wall_ms_per_step"] = wall * 1e3 / len(steps)
    return busy


def graph_copies(torch, step, state, batch, reps=3):
    """What a graphed train step's functional contract costs on the card:
    the input state and batch copied into the static tensors and the
    result cloned out, as a replay does them, without the replay: the
    device time of ``reps`` such calls summed by the profiler
    (``device_busy``; a timer behind a spin kernel cannot hold them, as
    the clone's allocations wait for the card), per call, beside the
    bytes they move (each byte read once and written once, twice) and
    the least time for them at ``HBM_BYTES_PER_S``."""
    from repro_torch.core.masks import copy_tree_, tree_leaves
    v = next(iter(step.variants.values()))

    def copies():
        for _ in range(reps):
            copy_tree_(v.state, state)
            copy_tree_(v.batch, batch)
            step._result(v.state, state)
        torch.cuda.synchronize()

    copies()                                        # warm
    t0 = time.perf_counter()
    copies()
    busy = device_busy(torch, copies, time.perf_counter() - t0)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    moved = 4 * nbytes
    ms = busy.get("device_busy_ms")
    return dict(device_ms=ms / reps if ms is not None else "not measured",
                top=busy.get("top", [])[:3], state_bytes=nbytes,
                bytes_moved=moved, bound_ms=moved / HBM_BYTES_PER_S * 1e3)


def graph_line(stats, pool, copies=None) -> str:
    """One log line's worth of a graphed step's captures, pool and copies."""
    split = ", ".join(f"{k} {v:.2f}s" for k, v in stats["capture_split"].items())
    line = (f"{stats['captures']} capture(s) of {[round(x, 2) for x in stats['capture_seconds']]}s "
            f"({split}), replays {stats['replays']}, launches per replay "
            f"{stats['launches_per_replay']}; graph pool "
            + (f"{pool / 2**30:.3f} GiB" if isinstance(pool, int) else "not measured"))
    if copies is not None:
        ms = copies["device_ms"]
        line += (f"; copies in and out "
                 + (f"{ms:.2f} ms" if isinstance(ms, float) else ms)
                 + f" of device time a step ({copies['bytes_moved'] / 2**30:.2f} GiB "
                 f"moved, bound {copies['bound_ms']:.2f} ms; "
                 + ", ".join(f"{r['calls']} x {r['name'][:40]}" for r in copies["top"])
                 + ")")
    return line


def remat_compare(torch, dev, cfg, state, pipe, opt_cfg, gpu_line):
    """Phase 5's remat sub-step: ``REMAT_STEPS`` train steps under "full"
    (only each layer's inputs kept) and under "dots" (the projections'
    fp32 outputs kept too) from the same trained state on the same
    batches, each eagerly (``make_train_step``, twice: the second run is
    eager against eager, the card's own spread) and graphed
    (``GraphedTrainStep``: the first run's step 0 captures, the second
    run replays), each graphed loss gated within ``REMAT_LOSS_TOL``
    relative of the eager one, and "dots" against "full" likewise.  For
    each: ms per step, the card's busy share over the second run again
    under the profiler, and ``torch.cuda.max_memory_allocated`` from a
    reset just before the first (the trained state, held throughout,
    included); then one forward and backward of the loss on the trained
    params alone: the bytes still allocated after the forward (what the
    backward keeps) and the peak, both above what was allocated before.
    Each graph is dropped before the next is built."""
    from repro_torch.core.masks import map_tree
    from repro_torch.models import cross_entropy_loss, lm_forward
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import GraphedTrainStep, make_train_body, make_train_step
    sched = warmup_cosine(TRAIN["lr"], TRAIN["steps"] // 10 + 1, TRAIN["steps"])
    out = {}

    def forward_backward(c):
        p = map_tree(lambda t: t.detach().requires_grad_(True), state["params"])
        batch = pipe.batch_at(30_000)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits, _ = lm_forward(p, batch, c)
        loss = cross_entropy_loss(logits, batch["labels"])
        kept = torch.cuda.memory_allocated() - base
        loss.backward()
        torch.cuda.synchronize()
        return kept, torch.cuda.max_memory_allocated() - base

    def run(step):
        st, losses, ms = state, [], []
        for s in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, pipe.batch_at(30_000 + s))
            losses.append(float(m["total_loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    for remat in ("full", "dots"):
        c = cfg.replace(remat=remat)
        row = {}
        for mode in ("eager", "graphed"):
            step = (make_train_step(c, opt_cfg, sched) if mode == "eager" else
                    GraphedTrainStep(make_train_body(c, opt_cfg, sched), dev,
                                     what=f"train step ({remat})"))
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = run(step)
            peak = torch.cuda.max_memory_allocated()
            again, ms2 = run(step)
            busy = device_busy(torch, lambda: run(step), sum(ms2) / 1e3)
            r = dict(losses=losses, losses_again=again, ms=ms, ms_again=ms2,
                     ms_per_step_median=statistics.median(ms2), peak_bytes=peak,
                     peak_above_state=peak - base,
                     device={k: v for k, v in busy.items() if k != "top"})
            if mode == "graphed":
                r["graph"] = dict(stats=step.stats(), pool_bytes=step.pool_bytes())
            row[mode] = r
            del step
            torch.cuda.empty_cache()
        kept, fb_peak = forward_backward(c)
        row.update(after_forward_bytes=kept, forward_backward_peak_bytes=fb_peak)
        e, g = row["eager"], row["graphed"]
        row["graphed_vs_eager"] = rel(g["losses"] + g["losses_again"],
                                      e["losses"] + e["losses"])
        row["eager_vs_eager"] = rel(e["losses_again"], e["losses"])
        if max(row["graphed_vs_eager"]) > REMAT_LOSS_TOL:
            raise AssertionError(f"phase 5 remat {remat!r}: graphed losses "
                                 f"{g['losses']} {g['losses_again']} vs eager "
                                 f"{e['losses']} (relative {row['graphed_vs_eager']})")
        out[remat] = row
    errs = rel(out["dots"]["eager"]["losses"], out["full"]["eager"]["losses"])
    errs_graphed = rel(out["dots"]["graphed"]["losses"], out["full"]["graphed"]["losses"])
    out["loss_rel_err"] = errs
    out["loss_rel_err_graphed"] = errs_graphed
    if max(errs + errs_graphed) > REMAT_LOSS_TOL:
        raise AssertionError(f"phase 5 remat: dots vs full losses, eager {errs}, "
                             f"graphed {errs_graphed} (relative)")
    for remat in ("full", "dots"):
        row = out[remat]
        for mode in ("eager", "graphed"):
            r = row[mode]
            share = r["device"]["busy_share"]
            log(f"  remat {remat!r} {mode}: {REMAT_STEPS} steps from the trained "
                f"state, losses {[round(x, 6) for x in r['losses']]}; ms per step "
                f"{[round(x, 1) for x in r['ms']]}, again "
                f"{[round(x, 1) for x in r['ms_again']]} (median {r['ms_per_step_median']:.1f}); "
                f"card busy "
                + (f"{100 * share:.1f}% ({r['device']['device_busy_ms'] / REMAT_STEPS:.1f} "
                   f"ms of device time a step)" if isinstance(share, float) else
                   f"not measured ({r['device'].get('error')})")
                + f"; torch.cuda.max_memory_allocated {r['peak_bytes'] / 2**30:.3f} GiB "
                f"({r['peak_above_state'] / 2**30:.3f} GiB above the held state); on "
                f"{gpu_line}")
        log(f"  remat {remat!r} graphed: " + graph_line(row["graphed"]["graph"]["stats"],
                                                        row["graphed"]["graph"]["pool_bytes"]))
        log(f"  remat {remat!r}: graphed vs eager losses within "
            f"{max(row['graphed_vs_eager']):.2e} relative (gate {REMAT_LOSS_TOL}), "
            f"eager vs eager {max(row['eager_vs_eager']):.2e}; one forward + backward "
            f"of the loss: {row['after_forward_bytes'] / 2**30:.3f} GiB held after the "
            f"forward, peak {row['forward_backward_peak_bytes'] / 2**30:.3f} GiB")
    log(f"  remat: dots vs full losses within {max(errs):.2e} relative eager, "
        f"{max(errs_graphed):.2e} graphed (gate {REMAT_LOSS_TOL}); eager step peak "
        f"dots - full {(out['dots']['eager']['peak_bytes'] - out['full']['eager']['peak_bytes']) / 2**30:+.3f} GiB; "
        f"held after the forward dots - full "
        f"{(out['dots']['after_forward_bytes'] - out['full']['after_forward_bytes']) / 2**30:+.3f} GiB")
    return out


def train_path(torch, dev, gpu_line):
    """The training entry point's code (``repro_torch.launch.train``) on
    full-width qwen1.5-0.5b in its own dtypes (bf16 params and
    activations, fp32 AdamW master, its config's remat "dots"): 20 steps
    at B 8, S 128 through ``build_trainer``'s graphed step (one CUDA graph
    captured in step 0, replayed after; its captures, pool and the copies
    of its functional contract reported) with an asynchronous checkpoint
    at step 10; the remat sub-step (``remat_compare``: eager and graphed
    under "full" and "dots"); a fresh graphed trainer resumed from the
    checkpoint; Algorithm 2 (its fine-tunes through one graphed step) at 128x128 tiles over the reference
    launcher's structures (the embedding too); the survivors packed
    (``launch.train.pack_pruned``); ``lm_forward`` packed against masked
    dense (fp32 copy gated, bf16 reported) with exact BSR launch counts;
    4 requests served from the fp32 packed params through
    ``ServingEngine``, each stream equal to solo ``lm_generate``.
    Returns (report, {dtype: Capture of the packed forward}, launches)."""
    import math
    import shutil
    import types

    import numpy as np
    from repro_torch.analysis import runtime as analysis_runtime
    from repro_torch.configs import get_config
    from repro_torch.core import count_zero_structures
    from repro_torch.core.masks import map_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm_forward
    from repro_torch.serving import ServingEngine
    from repro_torch.sparse import sparsity_summary

    t_phase = time.perf_counter()
    arch = TRAIN["arch"]
    cfg = get_config(arch)
    n_layers = cfg.n_layers
    ckpt_dir = OUT / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    segments, rep = {}, {"arch": arch, "config": {
        k: getattr(cfg, k) for k in ("param_dtype", "activ_dtype", "remat")},
        "train": dict(TRAIN)}

    def build():
        return launch_train.build_trainer(
            cfg, steps=TRAIN["steps"], batch=TRAIN["batch"], seq=TRAIN["seq"],
            lr=TRAIN["lr"], seed=TRAIN["seed"], device=dev,
            ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN["ckpt_every"], log_every=1)

    # --- 1. training --------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    trainer, pipe, opt_cfg = build()
    t0 = time.perf_counter()
    res = counted(segments, "train", trainer.run)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["total_loss"] for r in res["metrics"]]
    dts = [r["dt"] for r in res["metrics"]]
    if len(losses) != TRAIN["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: losses {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < first5:
        raise AssertionError(f"training: mean of the last 5 losses {last5:.4f} "
                             f"is not below the first 5's {first5:.4f}")
    step_ms = statistics.median(dts[1:]) * 1e3
    tok = TRAIN["batch"] * TRAIN["seq"]
    busy = training_busy(torch, trainer.step_fn, trainer.state, pipe)
    rep["training"] = dict(losses=losses, step_seconds=dts, seconds=train_s,
                           ms_per_step_median=step_ms,
                           tok_per_s=tok / (step_ms / 1e3),
                           peak_bytes=peak, device=busy,
                           stragglers=res["stragglers"])
    share = busy["busy_share"]
    log(f"  training: {TRAIN['steps']} steps at B {TRAIN['batch']} S "
        f"{TRAIN['seq']}, loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
        f"first 5 {first5:.4f}, last 5 {last5:.4f}); {step_ms:.1f} ms per "
        f"step (median, steps 1-19) = {tok / (step_ms / 1e3):.0f} tok/s; "
        f"step 0 {dts[0]:.2f}s; card busy "
        + (f"{100 * share:.1f}% of {busy['wall_ms_per_step']:.1f} ms per "
           f"profiled step" if isinstance(share, float) else
           f"not measured ({busy.get('error')})")
        + f"; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; on "
        f"{gpu_line}")
    if isinstance(share, float):
        for row in busy["top"][:5]:
            log(f"    {row['ms']:9.3f} ms {row['calls']:6d} calls  {row['name']}")
    gstep = trainer.step_fn
    copies = graph_copies(torch, gstep, trainer.state, pipe.batch_at(0))
    rep["training"]["graph"] = dict(stats=gstep.stats(), pool_bytes=gstep.pool_bytes(),
                                    copies=copies)
    log(f"  training, graphed: " + graph_line(gstep.stats(), gstep.pool_bytes(), copies))
    trainer.step_fn = gstep = None          # the trainer's graph is dropped here
    torch.cuda.empty_cache()
    rep["remat"] = counted(segments, "remat", lambda: remat_compare(
        torch, dev, cfg, trainer.state, pipe, opt_cfg, gpu_line))

    # --- 2. checkpoint at 10 and resume -------------------------------------
    steps_saved = trainer.ckpt.committed_steps()
    if 10 not in steps_saved:
        raise AssertionError(f"no committed checkpoint at step 10: {steps_saved}")
    for s in steps_saved:                   # resume from step 10 alone
        if s != 10:
            shutil.rmtree(trainer.ckpt._step_dir(s))
    t0 = time.perf_counter()
    again, _, _ = build()
    again.cfg.total_steps = 11
    res2 = counted(segments, "resume", again.run)
    resume_s = time.perf_counter() - t0
    got = res2["metrics"][0]["total_loss"] if res2["metrics"] else float("nan")
    rel = abs(got - losses[10]) / abs(losses[10])
    rep["resume"] = dict(step=res2["metrics"][0]["step"] if res2["metrics"] else None,
                         loss=got, uninterrupted=losses[10], rel_diff=rel,
                         seconds=resume_s)
    if not (res2["metrics"] and res2["metrics"][0]["step"] == 10 and rel <= 1e-2):
        raise AssertionError(f"resume: step-11 loss {got} vs uninterrupted "
                             f"{losses[10]} (relative {rel:.3g} > 1e-2)")
    log(f"  checkpoint: written asynchronously at step 10 (committed "
        f"{steps_saved}); a fresh trainer resumed from it: step-11 loss "
        f"{got:.6f} vs {losses[10]:.6f} uninterrupted (relative {rel:.2e}); "
        f"{resume_s:.1f}s")
    del again
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # --- 3. Algorithm 2 -------------------------------------------------------
    t0 = time.perf_counter()
    events = analysis_runtime.compile_events()
    params, masks, logs, structures, pruner = counted(
        segments, "prune", lambda: launch_train.prune(
            trainer.state["params"], cfg, pipe, opt_cfg, lr=TRAIN["lr"],
            target=TRAIN["target"]))
    prune_s = time.perf_counter() - t0
    prune_captures = analysis_runtime.compile_events() - events
    del trainer
    if not any(lg.structure_sparsity > 0 for lg in logs):
        raise AssertionError("Algorithm 2 logged no iteration with "
                             "structure_sparsity > 0")
    rolled_back = count_zero_structures(masks, structures)[0] == 0
    note = ""
    if rolled_back:
        s0 = pruner.config.schedule(np.zeros(2), 0)
        masks, _ = pruner.prune_step(params, s0)
        note = (f"; the run rolled back to no pruning, so the pack uses "
                f"prune_step at the first scheduled sparsity {s0.tolist()}")
    iters = [dict(iteration=lg.iteration, sparsity=lg.sparsity.tolist(),
                  metric=lg.metric, structure_sparsity=lg.structure_sparsity,
                  weight_sparsity=lg.weight_sparsity, seconds=lg.seconds,
                  knapsack_seconds=lg.knapsack_seconds,
                  finetune_seconds=lg.finetune_seconds,
                  knapsack_method=lg.knapsack_method,
                  reduction=lg.reduction().tolist()) for lg in logs]
    rep["prune"] = dict(iterations=iters, seconds=prune_s, rolled_back=rolled_back,
                        structures=structures.total_structures,
                        captures=prune_captures)
    for it in iters:
        log(f"  prune it={it['iteration']} s={it['sparsity']} metric "
            f"{it['metric']:.4f} structs={100 * it['structure_sparsity']:.1f}% "
            f"mxu_red={it['reduction'][0]:.2f}x hbm_red={it['reduction'][1]:.2f}x "
            f"({it['knapsack_method']}): {it['seconds']:.2f}s = knapsack "
            f"{it['knapsack_seconds']:.3f}s + fine-tune "
            f"{it['finetune_seconds']:.2f}s + eval/report")
    log(f"  Algorithm 2 over {structures.total_structures} tiles of 128x128 "
        f"({len(structures.infos)} weights, the embedding's "
        f"{sum(i.num_structures for i in structures.infos if i.path.startswith('embed'))} "
        f"among them): {len(logs)} iterations in {prune_s:.1f}s{note}; "
        f"{prune_captures} graph capture(s) over the fine-tunes; on {gpu_line}")

    # --- 4. packed against masked dense ---------------------------------------
    ev = pipe.batch_at(10_000)
    cfg32 = cfg.replace(param_dtype="float32", activ_dtype="float32")
    p32 = map_tree(lambda t: t.float(), params)
    m32 = map_tree(lambda t: None if t is None else t.float(), masks)
    packed32 = launch_train.pack_pruned(p32, m32)
    packed16 = launch_train.pack_pruned(params, masks)
    summ = sparsity_summary(packed32)
    want_bsr = PER_LAYER[arch]["bsr_matmul"] * n_layers
    forwards = {}
    for name, pk, dense_p, mk, c in (("fp32", packed32, p32, m32, cfg32),
                                     ("bf16", packed16, params, masks, cfg)):
        # the masked dense forward runs no BSR kernel: the segment's
        # bsr_matmul launches are the packed forward's
        err = counted(segments, f"packed_forward_{name}",
                      lambda: launch_train.packed_forward_error(
                          pk, dense_p, mk, ev, c))
        n = segments[f"packed_forward_{name}"]["bsr_matmul"]
        if n != want_bsr:
            raise AssertionError(f"packed lm_forward ({name}): bsr_matmul "
                                 f"launched {n} times, not {want_bsr}")
        forwards[name] = dict(err, bsr_launches=n)
        if not err["finite"]:
            raise AssertionError(f"packed lm_forward ({name}): non-finite logits")
    if forwards["fp32"]["max_abs_diff"] > 1e-3 * forwards["fp32"]["max_abs_logit"]:
        raise AssertionError(f"packed vs masked dense lm_forward (fp32): "
                             f"{forwards['fp32']}")
    rep["packed"] = dict(summary={k: v for k, v in summ.items() if k != "per_path"},
                         forward=forwards)
    log(f"  packed: {summ['nnz_blocks']}/{summ['total_blocks']} tiles live "
        f"(density {summ['density']:.4f}); lm_forward packed vs masked dense at "
        f"B {TRAIN['batch']} S {TRAIN['seq']}: fp32 max |diff| "
        f"{forwards['fp32']['max_abs_diff']:.3g} of max |logit| "
        f"{forwards['fp32']['max_abs_logit']:.4g} (gate 1e-3 of it), bf16 "
        f"{forwards['bf16']['max_abs_diff']:.3g} of "
        f"{forwards['bf16']['max_abs_logit']:.4g} (reported); bsr_matmul "
        f"{want_bsr} = 7 x {n_layers} launches per forward in each")

    # --- 5. serve the packed result -------------------------------------------
    prompts, gen = traffic(cfg.vocab, TRAIN["seed"])[:4], 16
    eng = ServingEngine(packed32, cfg32, num_slots=4, page_size=8,
                        max_seq_len=max(len(p) for p in prompts) + gen,
                        ticks_per_sync=4, device=dev)
    run = serve_pass(torch, eng, prompts, gen)
    segments["serve"] = run["launches"]
    gate_launches(arch, "trained+pruned serve", n_layers, run)
    solo = {rid: types.SimpleNamespace(tokens=serve.solo_decode(
        packed32, cfg32, r.prompt, gen, device=dev)) for rid, r in run["done"].items()}
    same_streams(f"{arch} trained+pruned: served vs solo lm_generate",
                 run["done"], solo)
    rep["serve"] = public(run)
    log(f"  served {len(prompts)} requests from the packed fp32 params: "
        f"{run['tok_per_s']:.1f} tok/s, {run['decode_ticks']} ticks, every "
        f"stream equal to solo lm_generate; exact launch counts; on {gpu_line}")
    del eng

    # the kernels' inputs at the packed forward's shapes (M = B * S), for
    # phase 4; these launches are not counted
    caps = {}
    for name, pk, c in (("fp32", packed32, cfg32), ("bf16", packed16, cfg)):
        with Capture(torch, ops) as cap, torch.no_grad():
            lm_forward(pk, ev, c)
        caps[name] = cap
    launches = {}
    for counts in segments.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for name in ("bsr_matmul", "paged_attention_decode", "paged_attention_prefill"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"phase 5: kernel {name} never launched")
    rep["launches"] = launches
    rep["launches_by_segment"] = segments
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 5 launches {launches}; took {rep['seconds']:.1f}s")
    del params, masks, p32, m32, packed32, packed16
    torch.cuda.empty_cache()
    return rep, caps, launches


# ---------------------------------------------------------------------------
# phase 6: the paper's own experiments (Tables II, III and V), then §III-C
# ---------------------------------------------------------------------------

# the paper's figure beside each row
PAPER_FIGURES = {
    "table2_jets_rf2_dsp": "paper: DSP 12.2x", "table2_jets_rf4_dsp": "paper: DSP 11.9x",
    "table2_jets_rf8_dsp": "paper: DSP 7.9x", "table2_jets_rf16_dsp": "paper: DSP 5.8x",
    "table2_jets_rf2_md": "paper: BP-MD trades DSP for BRAM",
    "table2_jets_rf8_md": "paper: BP-MD trades DSP for BRAM",
    "table3_svhn_rf3": "paper: DSP 3.9x", "table3_svhn_rf9": "paper: DSP 3.6x",
    "table3_svhn_rf27": "paper: DSP 2.2x",
    "table5_lenet_md": "paper: DSP 4.7x, BRAM 1.2-2.1x",
}
# rows whose pruned model is packed and run through the BSR kernel (§III-C)
PAPER_PACKED = ("table2_jets_rf4_dsp", "table2_jets_rf2_md", "table3_svhn_rf27",
                "table5_lenet_md")
# phase 4 times bsr_matmul at each model's packed fc_1: (row, K, N)
PAPER_TIMED = (("table2_jets_rf4_dsp", 16, 64), ("table3_svhn_rf27", 96, 42),
               ("table5_lenet_md", 400, 120))
# the card's fp32 convolutions (cuDNN, TF32 off) against the CPU's, over
# the image models' six layers: the sums differ in order only
PAPER_CPU_TOL = 1e-4


def jsonable(row: dict) -> dict:
    """inf (a Latency-strategy model's BRAM reduction) as the string
    "inf": strict JSON readers reject ``Infinity``."""
    import math
    return {k: "inf" if isinstance(v, float) and math.isinf(v) else v
            for k, v in row.items()}


def packed_forward(torch, name, run, segments):
    """§III-C on one pruned model: every pruned FC kernel packed to BSR at
    its structures' blocking (convolutions stay masked dense), the model's
    own forward over the validation batch, gated against the masked dense
    forward (fp32 ``TOL``) with exactly one ``bsr_matmul`` launch per
    packed layer.  Returns (report, Capture of the kernel's inputs)."""
    from repro_torch.core import apply_masks, pack_bsr
    from repro_torch.kernels import ops
    params, masks = run.params, run.masks
    packed = apply_masks(params, masks)
    layers = []
    for info in run.structures.infos:
        layer = info.path.split("/")[0]
        if layer.startswith("fc_"):
            bsr = pack_bsr(params[layer]["kernel"], info.blocking,
                           mask=masks[layer]["kernel"])
            packed[layer] = {**packed[layer], "kernel": bsr}
            layers.append(dict(layer=layer, shape=list(bsr.shape),
                               blocking=[bsr.blocking.bk, bsr.blocking.bn,
                                         bsr.blocking.consecutive],
                               nnz_blocks=bsr.nnz_blocks, max_nnz=bsr.max_nnz,
                               density=bsr.density()))
    x = run.val_batch[0]
    seg = f"packed {name}"
    with torch.no_grad():
        got = counted(segments, seg, lambda: run.forward(packed, x))
        want = run.forward(apply_masks(params, masks), x)
    n = segments[seg].get("bsr_matmul", 0)
    err = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).to(torch.float32).mean())
    rep = dict(layers=layers, m=x.shape[0], rel_err=err, bsr_launches=n,
               argmax_agreement=agree)
    if n != len(layers) or len(layers) != 3:
        raise AssertionError(f"{name} packed forward: bsr_matmul launched {n} "
                             f"times for {len(layers)} packed layers (want 3)")
    if err > TOL["float32"]:
        raise AssertionError(f"{name} packed forward vs masked dense: "
                             f"normalized error {err:.3g} > {TOL['float32']}")
    with Capture(torch, ops) as cap, torch.no_grad():
        run.forward(packed, x)
    return rep, cap


PAPER_GRAPH_TOL = 1e-5     # graphed vs eager classifier params, relative


def train_timing(torch, run, kw, steps=20):
    """ms per masked AdamW step (the fine-tune's settings, on the pruned
    model) and the card's busy share over the same steps profiled, for
    ``train_classifier`` eager (``cuda_graphs=False``) and graphed (one
    capture per call, then replays), each from the same params; the
    final params of the two held within ``PAPER_GRAPH_TOL`` relative
    (each leaf's max |diff| over its max |value|)."""
    from repro_torch.core.structures import iter_leaves
    from repro_torch.paper.fpga_repro import train_classifier

    def tune(graphs, log=None):
        p = train_classifier(run.params, run.masks, run.forward, kw["batch_fn"],
                             steps, lr=2e-3, seed0=10_000, cuda_graphs=graphs,
                             graph_log=log)
        torch.cuda.synchronize()
        return p

    out, final = {"steps": steps}, {}
    for mode, graphs in (("eager", False), ("graphed", True)):
        warm = tune(graphs)
        log = []
        t0 = time.perf_counter()
        final[mode] = tune(graphs, log)
        wall = time.perf_counter() - t0
        busy = device_busy(torch, lambda: tune(graphs), wall)
        r = dict(ms_per_step=wall * 1e3 / steps, device=busy)
        if graphs:
            cap = log[0]
            r.update(capture_seconds=cap["capture_seconds"], capture_split=cap["split"],
                     replays=cap["replays"],
                     replay_ms_per_step=(wall - cap["capture_seconds"]) * 1e3
                     / max(steps - 1, 1))
        out[mode] = r
        if not graphs:
            final["eager again"] = warm

    def rel(a, b):
        return {path: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for (path, g), (_, w) in zip(iter_leaves(a), iter_leaves(b))}
    errs = rel(final["graphed"], final["eager"])
    out["graphed_vs_eager"] = max(errs.values())
    out["eager_vs_eager"] = max(rel(final["eager again"], final["eager"]).values())
    if out["graphed_vs_eager"] > PAPER_GRAPH_TOL:
        raise AssertionError(f"train_classifier graphed vs eager params: {errs} "
                             f"(relative, tolerance {PAPER_GRAPH_TOL})")
    out["ms_per_step"] = out["graphed"]["ms_per_step"]
    out["device"] = out["graphed"]["device"]
    return out


def tf32_check(torch, run):
    """The trained image model's fp32 forward on the card (TF32 off, as
    set for the whole run) held against the CPU's; reported: the same
    with ``torch.backends.cudnn.allow_tf32`` on (PyTorch's default for
    convolutions)."""
    from repro_torch.core import apply_masks
    from repro_torch.core.masks import map_tree
    p = apply_masks(run.params, run.masks)
    x = run.val_batch[0]
    with torch.no_grad():
        cpu = run.forward(map_tree(lambda t: t.cpu(), p), x.cpu())
        off = rel_err(run.forward(p, x).cpu(), cpu)
        torch.backends.cudnn.allow_tf32 = True
        try:
            on = rel_err(run.forward(p, x).cpu(), cpu)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    if off > PAPER_CPU_TOL:
        raise AssertionError(f"fp32 forward on the card vs the CPU: "
                             f"normalized error {off:.3g} > {PAPER_CPU_TOL}")
    return dict(tf32_off=off, tf32_on=on, tolerance=PAPER_CPU_TOL)


def kept_iteration(run):
    """The log of the masks the run kept, or None (no pruning kept).
    ``IterativePruner.run`` rolls back past an iteration below
    ``baseline * (1 - tolerance)``, and only the last can be such, while
    the summary row reports the last log regardless (as the
    reference's ``run_prune_experiment`` does)."""
    if not run.logs:
        return None
    bound = run.baseline_acc * (1 - run.pruner.config.tolerance)
    if run.logs[-1].metric >= bound:
        return run.logs[-1]
    return run.logs[-2] if len(run.logs) > 1 else None


def paper_row_gates(name, row, run, val_loss) -> None:
    """Finite losses and accuracies, at least one Algorithm 2 iteration,
    a DSP reduction above 1, the accuracy bound the pruner enforces, and
    the jets baseline the reference's own test asks for."""
    import math
    nums = [val_loss, row["baseline_acc"], row["pruned_acc"]] + \
        [lg.metric for lg in run.logs]
    if not all(math.isfinite(v) for v in nums):
        raise AssertionError(f"{name}: non-finite loss or accuracy {nums}")
    if row["iterations"] < 1:
        raise AssertionError(f"{name}: Algorithm 2 ran no iteration")
    if not row["dsp_reduction"] > 1.0:
        raise AssertionError(f"{name}: DSP reduction {row['dsp_reduction']}")
    tol = run.pruner.config.tolerance
    if row["pruned_acc"] < row["baseline_acc"] * (1 - tol):
        raise AssertionError(f"{name}: pruned accuracy {row['pruned_acc']} < "
                             f"{1 - tol} x {row['baseline_acc']}")
    if name.startswith("table2") and not row["baseline_acc"] > 0.85:
        raise AssertionError(f"{name}: jets baseline accuracy "
                             f"{row['baseline_acc']} <= 0.85")


def paper_path(torch, dev, gpu_line):
    """The paper's flow on the card through ``repro_torch.paper`` (seed
    0, fp32, TF32 off): the quickstart; Tables II, III and V at full
    settings, each row gated (``paper_row_gates``); §III-C on four rows
    (``packed_forward``); per model ms per step and busy share over a
    profiled fine-tune; the image models' forward against the CPU's.
    Returns (report, {row: Capture}, launches summed over the phase)."""
    import math

    import torch.nn.functional as F
    from repro_torch.core import apply_masks
    from repro_torch.paper import quickstart, table2_jets, table3_svhn, table5_lenet
    from repro_torch.paper.fpga_repro import prune_experiment, summarize

    t_phase = time.perf_counter()
    segments, caps = {}, {}
    rep = {"rows": [], "packed": {}, "models": {}}

    # --- 1. the quickstart ----------------------------------------------------
    t0 = time.perf_counter()
    qs = counted(segments, "quickstart", lambda: quickstart.run(
        device=dev, log=lambda line: log(f"  quickstart: {line}")))
    err = rel_err(qs["y_sparse"], qs["y_dense"])
    n = segments["quickstart"].get("bsr_matmul", 0)
    rep["quickstart"] = dict(rel_err=err, max_abs_err=qs["max_abs_err"],
                             density=qs["density"], bsr_launches=n,
                             iterations=len(qs["logs"]),
                             seconds=time.perf_counter() - t0)
    if err > TOL["float32"] or n != 1:
        raise AssertionError(f"quickstart: BSR vs dense normalized error "
                             f"{err:.3g} (tolerance {TOL['float32']}), "
                             f"{n} bsr_matmul launches (want 1)")
    log(f"  quickstart: {rep['quickstart']['seconds']:.1f}s, BSR vs dense "
        f"normalized error {err:.3g}, 1 bsr_matmul launch")

    # --- 2. Tables II, III and V at full settings ----------------------------
    for mod, model in ((table2_jets, "jets-mlp"), (table3_svhn, "svhn-cnn"),
                       (table5_lenet, "lenet-fmnist")):
        t_table = time.perf_counter()
        graph_log = []
        for i, (labels, kw) in enumerate(mod.experiments(quick=False, device=dev)):
            t0 = time.perf_counter()
            run = counted(segments, f"{model} row {i}",
                          lambda: prune_experiment(**kw, graph_log=graph_log))
            row = summarize(run)
            row.update(labels)
            line = mod.lines([row])[0]
            name = line.split(",")[0]
            with torch.no_grad():
                x, y = run.val_batch
                val_loss = float(F.cross_entropy(
                    run.forward(apply_masks(run.params, run.masks), x), y.long()))
            paper_row_gates(name, row, run, val_loss)
            iters = [dict(iteration=lg.iteration, sparsity=lg.sparsity.tolist(),
                          metric=lg.metric, structure_sparsity=lg.structure_sparsity,
                          reduction=[float(v) if math.isfinite(v) else "inf"
                                     for v in lg.reduction()],
                          knapsack_seconds=lg.knapsack_seconds,
                          finetune_seconds=lg.finetune_seconds,
                          seconds=lg.seconds, method=lg.knapsack_method)
                     for lg in run.logs]
            kept = kept_iteration(run)
            kept_red = kept.reduction() if kept else [1.0, 1.0]
            rep["rows"].append(jsonable(dict(
                row, name=name, csv=line, paper=PAPER_FIGURES[name],
                rolled_back=kept is not run.logs[-1],
                kept_dsp_reduction=float(kept_red[0]),
                kept_bram_reduction=float(kept_red[1]),
                kept_structure_sparsity=kept.structure_sparsity if kept else 0.0,
                val_loss=val_loss, row_seconds=time.perf_counter() - t0,
                pretrain_seconds=run.pretrain_seconds,
                pretrain_steps=kw["pretrain_steps"],
                finetune_steps=kw["finetune_steps"], iteration_logs=iters)))
            log(f"  {line}   [{PAPER_FIGURES[name]}]")
            if kept is not run.logs[-1]:
                log(f"    the last iteration broke the tolerance and was rolled "
                    f"back: the kept masks give dsp_red={kept_red[0]:.2f}x "
                    f"bram_red={kept_red[1]:.2f}x sparsity="
                    f"{kept.structure_sparsity if kept else 0.0:.2f}")
            log(f"    {time.perf_counter() - t0:.2f}s: pretrain "
                f"{kw['pretrain_steps']} steps {run.pretrain_seconds:.2f}s, "
                f"{len(iters)} iterations: knapsack "
                f"{[round(i['knapsack_seconds'], 3) for i in iters]}s, "
                f"fine-tune ({kw['finetune_steps']} steps) "
                f"{[round(i['finetune_seconds'], 2) for i in iters]}s")
            if name in PAPER_PACKED:
                rep["packed"][name], caps[name] = packed_forward(
                    torch, name, run, segments)
                p = rep["packed"][name]
                log(f"    §III-C: {[(l['layer'], l['shape'], l['blocking'], l['nnz_blocks']) for l in p['layers']]} "
                    f"packed; forward at M {p['m']} vs masked dense: normalized "
                    f"error {p['rel_err']:.3g}, {p['bsr_launches']} bsr_matmul "
                    f"launches, argmax agreement {p['argmax_agreement']:.4f}")
        # the last row's pruned model: step time and busy share; the image
        # models' forward against the CPU
        table_s = time.perf_counter() - t_table
        timing = train_timing(torch, run, kw)
        timing["table_seconds"] = table_s
        caps_s = [r["capture_seconds"] for r in graph_log]
        timing["table_graphs"] = dict(
            calls=len(graph_log), steps=sum(r["steps"] for r in graph_log),
            capture_seconds=sum(caps_s),
            capture_seconds_per_call=sum(caps_s) / max(len(caps_s), 1),
            seconds_in_calls=sum(r["seconds"] for r in graph_log))
        if model != "jets-mlp":
            timing["cpu_parity"] = tf32_check(torch, run)
        rep["models"][model] = timing
        tg = timing["table_graphs"]
        for mode in ("eager", "graphed"):
            r = timing[mode]
            share = r["device"]["busy_share"]
            log(f"  {model} {mode}: {r['ms_per_step']:.2f} ms per train step over "
                f"{timing['steps']} steps"
                + (f" (capture {r['capture_seconds']:.3f}s = "
                   + ", ".join(f"{k} {v:.3f}s" for k, v in r["capture_split"].items())
                   + f"; {r['replays']} replays at {r['replay_ms_per_step']:.2f} ms)"
                   if mode == "graphed" else "")
                + "; card busy "
                + (f"{100 * share:.1f}% ({r['device']['device_busy_ms'] / timing['steps']:.3f} "
                   f"ms of device time a step)" if isinstance(share, float) else
                   f"not measured ({r['device'].get('error')})") + f"; on {gpu_line}")
        log(f"  {model}: table {table_s:.1f}s, {tg['calls']} train_classifier calls "
            f"({tg['steps']} steps) graphed, capture {tg['capture_seconds']:.2f}s in all "
            f"({tg['capture_seconds_per_call']:.3f}s a call) of {tg['seconds_in_calls']:.1f}s "
            f"in the calls; graphed vs eager params within "
            f"{timing['graphed_vs_eager']:.2e} relative (gate {PAPER_GRAPH_TOL}), eager "
            f"vs eager {timing['eager_vs_eager']:.2e}"
            + (f"; fp32 forward vs CPU {timing['cpu_parity']['tf32_off']:.3g} "
               f"(TF32 on: {timing['cpu_parity']['tf32_on']:.3g})"
               if "cpu_parity" in timing else "") + f"; on {gpu_line}")

    launches = {}
    for counts in segments.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    rep["launches"] = launches
    rep["launches_by_segment"] = segments
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6 launches {launches}; took {rep['seconds']:.1f}s")
    return rep, caps, launches


# ---------------------------------------------------------------------------
# phase 7: the recurrent and hybrid stacks through the paged engine
# ---------------------------------------------------------------------------

# jamba's depth cut: one whole period of its layer pattern (7 Mamba + 1
# attention, 4 dense MLPs + 4 MoE) at full width; the 32-layer model (~52 B
# parameters, ~104 GB in bf16) does not fit on one 80 GB card
JAMBA_LAYERS = 8
JAMBA_PATH = f"jamba-v0.1-52b {JAMBA_LAYERS} layers (phase 7)"
# the tied embedding is scaled by this after init: at its init scale the
# residual stream is the token's own embedding and a greedy stream repeats
# the prompt's last token, whatever the recurrent state holds (the CPU
# tests of these stacks scale it by the same constant)
EMBED_SCALE = 0.01
# the least share of distinct tokens in every greedy stream of these
# stacks (gated here and in the CPU tests): a stream that repeats a token
# or two would equal its solo decode whatever the engine did to its state
MIN_DISTINCT_SHARE = 0.5


def distinct_enough(tokens) -> bool:
    return len(set(tokens)) >= MIN_DISTINCT_SHARE * len(tokens)


def cast_tree(tree, dtype):
    """A copy of a (packed) params tree with every floating leaf in
    ``dtype``; packed leaves keep their layout."""
    import dataclasses
    from repro_torch.core import BSRPlanes, BSRWeight
    from repro_torch.core.masks import map_tree

    def leaf(t):
        if isinstance(t, (BSRWeight, BSRPlanes)):
            return dataclasses.replace(t, blocks=t.blocks.to(dtype))
        return t.to(dtype) if t.is_floating_point() else t
    return map_tree(leaf, tree)


def packed_counts(params):
    """(2-D BSR leaves, planes leaves) of a packed tree: the BSR and
    planes kernels' launches per forward pass."""
    from repro_torch.core import BSRPlanes, BSRWeight
    from repro_torch.core.structures import iter_leaves
    leaves = [leaf for _, leaf in iter_leaves(params)]
    return (sum(isinstance(x, BSRWeight) for x in leaves),
            sum(isinstance(x, BSRPlanes) for x in leaves))


def gated_engine(dev, params, cfg, prompts, gen, slots, graphed, **sampling):
    from repro_torch.serving import ServingEngine
    return ServingEngine(params, cfg, num_slots=slots, page_size=8,
                         max_seq_len=max(len(p) for p in prompts) + gen,
                         ticks_per_sync=4, device=dev, cuda_graphs=graphed,
                         **sampling)


def serve_gated(torch, dev, gpu_line, label, params, cfg, prompts, gen, *,
                want, solo_slots=None, prefix=False, sampling=None):
    """Serve the traffic over 4 slots through an eager engine (one pass)
    and a graphed one (a capturing pass, a steady pass, a profiled pass;
    with ``prefix``, a second capturing pass first: its prefix hits on
    the first pass's prompts are new ``(L, start)`` prefills), greedy or
    with the engine-level ``sampling`` (temperature, top-k, top-p; each
    request's key from its rid).  Gated: prefix caching reported off
    (``prefix``: on, with a hit in every pass), every stream FINISHED at
    full length (``serve_pass``) with at least ``MIN_DISTINCT_SHARE`` of
    its tokens distinct, every pass's launches equal to ``want(run)``,
    the graphed engine's admissions in every slot, its prefills
    ``prefill_gates``, the graphed first pass's streams equal to the
    eager ones (same rids, so same keys) and, greedy, the steady pass's
    too.  With ``solo_slots`` a fresh graphed engine of that many slots
    serves the traffic once more, and its streams must equal their solo
    decode (with the engine's key for each request).  Returns the
    report."""
    sampling = sampling or {}
    from repro_torch.launch import serve
    out, done = {}, {}

    def gated(eng, label):
        hits = eng.prefix_stats["hit_requests"]
        run = serve_pass(torch, eng, prompts, gen)
        run["prefix_hits"] = eng.prefix_stats["hit_requests"] - hits
        if prefix and run["prefix_hits"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
        got = {k: run["launches"].get(k, 0) for k in SOURCES}
        if got != want(run):
            raise AssertionError(f"{label}: launches {got} != {want(run)}")
        few = [rid for rid, r in run["done"].items()
               if not distinct_enough(r.tokens.tolist())]
        if few:
            raise AssertionError(f"{label}: streams {few} have fewer than "
                                 f"{MIN_DISTINCT_SHARE} of their tokens distinct")
        return run

    for graphed in (False, True):
        mode = "graphed" if graphed else "eager"
        eng = gated_engine(dev, params, cfg, prompts, gen, 4, graphed, **sampling)
        if eng.prefix_stats["enabled"] != prefix:
            raise AssertionError(f"{label}: prefix caching is "
                                 f"{'off' if prefix else 'on'}")
        n_passes = (3 if prefix else 2) if graphed else 1
        runs = []
        for i in range(n_passes):
            before = captured(eng) if graphed else None
            runs.append(gated(eng, f"{label} {mode} pass {i + 1}"))
        steady = runs[-1]
        busy = None
        if graphed:
            prefill_gates(f"{label} graphed", eng, runs if prefix else runs[:1],
                          before_last=before)
            slots = eng.analysis_stats()["admissions_by_slot"]
            if min(slots) < 1:
                raise AssertionError(f"{label}: admissions by slot {slots}")
            busy = device_busy(torch, lambda: serve_pass(torch, eng, prompts, gen),
                               steady["seconds"])
            out["captures"] = {k: eng.analysis_stats().get(k) for k in
                               ("variants", "capture_seconds", "replays",
                                "prefill_variants", "prefill_capture_seconds",
                                "admissions_by_slot")}
            out["graph_pool_bytes"] = eng.graph_pool_bytes()
        done[mode] = [r["done"] for r in runs]
        distinct = sorted(len(set(r.tokens.tolist()))
                          for r in steady["done"].values())
        out[mode] = dict(passes=[public(r) for r in runs], device=busy,
                         distinct_tokens=distinct)
        share = ("" if busy is None else
                 f", card busy {100 * busy['busy_share']:.1f}%"
                 if isinstance(busy["busy_share"], float) else
                 f", busy share not measured ({busy.get('error')})")
        log(f"  {label} {mode}: {steady['wall_ms_per_tick']:.2f} ms wall per "
            f"tick over {steady['decode_ticks']} ticks, {steady['tok_per_s']:.1f}"
            f" tok/s, TTFT p50 {steady['ttft_ms_p50']:.2f} ms{share}; launches "
            f"{ {k: v for k, v in steady['launches'].items() if v} }; distinct "
            f"tokens per stream {distinct} of {gen}")
        log(f"    {label} {mode} steady pass: {split_line(steady)}")
    eager = done["eager"][0]
    same_streams(f"{label} graphed pass 1 vs eager", done["graphed"][0], eager)
    graphed = done["graphed"][-1]
    if not sampling:           # the steady pass's rids (and keys) differ
        shift = min(graphed) - min(eager)
        same_streams(f"{label} graphed vs eager",
                     {r - shift: q for r, q in graphed.items()}, eager)
    if solo_slots is not None:
        eng = gated_engine(dev, params, cfg, prompts, gen, solo_slots, True,
                           **sampling)
        run = gated(eng, f"{label} {solo_slots} slots")
        out[f"graphed_{solo_slots}_slots"] = public(run)
        t0 = time.perf_counter()
        bad = serve.verify_streams(params, cfg, run["done"], gen, device=dev,
                                   engine=eng)
        if bad:
            raise AssertionError(f"{label}, {solo_slots} slots: streams {bad} "
                                 "differ from solo decode")
        out["verify_seconds"] = time.perf_counter() - t0
    log(f"  {label}: graphed streams == eager streams"
        + ("" if solo_slots is None else
           f"; over {solo_slots} slots, graphed streams == solo decode")
        + f" ({len(graphed)} requests); on {gpu_line}")
    return out


def recurrent_path(torch, dev, gpu_line):
    """Phase 7: jamba-v0.1-52b (one period, full width, knapsack 0.75 at
    128x128 and packed) and xlstm-350m (whole, dense), each served in
    fp32 (streams equal eager, graphed and solo; exact launch counts) and
    in bf16 (full-length streams, finite logits).  Returns (report,
    launches of jamba's graphed fp32 steady pass, the kernels' inputs
    captured from an eager pass of jamba (a))."""
    from repro_torch.configs import get_config
    from repro_torch.core import BlockingSpec
    from repro_torch.kernels import ops
    from repro_torch.core.structures import iter_leaves
    from repro_torch.models import init_params
    from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen, seed, rep = 16, 0, {}

    # jamba: build in bf16, prune, pack, free the dense tree
    base = get_config("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    prompts = traffic(base.vocab, seed)
    t0 = time.perf_counter()
    params = init_params(base, seed=seed, device=dev)
    params["embed"]["embedding"].mul_(EMBED_SCALE)
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sel = knapsack_prune(params, sparsity=0.75, blocking=BlockingSpec(128, 128),
                         min_size=4096)
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0 - t_init
    packed = pack_params(params, sel.masks, sel.structures)
    summ = sparsity_summary(packed)
    kept, total = sel.kept, sel.total
    del params, sel
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build = dict(init_s=t_init, knapsack_s=t_prune,
                 pack_s=time.perf_counter() - t0 - t_init - t_prune,
                 seconds=time.perf_counter() - t0, params=n_params,
                 kept=kept, structures=total, density=summ["density"],
                 memory_gb=torch.cuda.memory_allocated() / 1e9)
    n_bsr, n_planes = packed_counts(packed)
    n_attn = sum(m == "attn" for m in base.mixer_pattern)
    log(f"  jamba-v0.1-52b, {JAMBA_LAYERS} layers at full width: {n_params} "
        f"params in {base.param_dtype}; init {t_init:.1f}s, knapsack {t_prune:.1f}s, pack "
        f"{build['pack_s']:.1f}s ({build['seconds']:.1f}s); kept {kept}/{total}"
        f" structures, BSR density {summ['density']:.4f}; {n_bsr} BSR weights "
        f"+ {n_planes} planes per forward; {build['memory_gb']:.1f} GB on the "
        f"card after freeing the dense tree")

    def jamba_launches(run):
        passes = run["decode_ticks"] + run["admissions"]
        return {"bsr_matmul": n_bsr * passes,
                "bsr_planes_matmul": n_planes * passes,
                "paged_attention_decode": n_attn * run["decode_ticks"],
                "paged_attention_prefill": n_attn * run["admissions"],
                "structure_norms": 0}

    # prefills route at capacity factor E/k, where no slot drops; decode
    # routes at moe_decode's fixed 2.0: capacity max(ceil(n k 2 / E), k) =
    # 2 rows per expert, so over 4 slots a third row routed to one expert
    # drops (as in the reference) and only 2 slots decode as solo does
    moe = base.moe_experts / base.moe_top_k
    cfg_a = base.replace(param_dtype="float32", activ_dtype="float32",
                         capacity_factor=moe)
    params_a = cast_tree(packed, torch.float32)
    # the kernels' inputs at jamba's shapes for phase 4, from an eager
    # pass (the capture reads lengths back to the host)
    with Capture(torch, ops) as cap:
        serve_pass(torch, gated_engine(dev, params_a, cfg_a, prompts, gen,
                                           4, False), prompts, gen)
    rep["jamba_a"] = serve_gated(
        torch, dev, gpu_line, f"jamba (a) fp32, capacity factor {moe}", params_a,
        cfg_a, prompts, gen, want=jamba_launches, solo_slots=2)
    launches = rep["jamba_a"]["graphed"]["passes"][-1]["launches"]
    del params_a
    torch.cuda.empty_cache()
    rep["jamba_b"] = serve_gated(
        torch, dev, gpu_line, f"jamba (b) bf16, capacity factor "
        f"{base.capacity_factor}", packed, base, prompts, gen,
        want=jamba_launches)
    rep["jamba_build"] = build
    del packed
    torch.cuda.empty_cache()

    # xlstm-350m: whole, dense (the serving pruner matches none of it)
    base = get_config("xlstm-350m")
    prompts = traffic(base.vocab, seed)
    none = lambda run: {k: 0 for k in SOURCES}          # no kernel on its path
    for key, cfg, solo_slots in (
            ("xlstm_fp32", base.replace(param_dtype="float32",
                                        activ_dtype="float32"), 4),
            ("xlstm_bf16", base, None)):
        params = init_params(cfg, seed=seed, device=dev)
        params["embed"]["embedding"].mul_(EMBED_SCALE)
        rep[key] = serve_gated(torch, dev, gpu_line,
                                   f"xlstm-350m {cfg.param_dtype}", params, cfg,
                                   prompts, gen, want=none,
                                   solo_slots=solo_slots)
        del params
        torch.cuda.empty_cache()
    rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 7: jamba build + knapsack + pack {build['seconds']:.1f}s; "
        f"max memory allocated {rep['max_memory_allocated_gb']:.1f} GB; took "
        f"{rep['seconds']:.1f}s; on {gpu_line}")
    return rep, launches, cap


# ---------------------------------------------------------------------------
# phase 8: the encoder-decoder and multimodal families
# ---------------------------------------------------------------------------

WHISPER_PATH = "whisper-tiny (phase 8)"
VLM_PATH = "qwen2-vl-2b (phase 8)"
# whisper's fixed batch: the launcher's defaults (B 4, prompt 16, 32 tokens)
WHISPER_B, WHISPER_PROMPT, WHISPER_GEN = 4, 16, 32
# qwen2-vl's image: a 32 x 32 grid of stub patch embeddings (its config's
# 1024), then 64 text tokens; 16 greedy tokens after them
VLM_GRID, VLM_TEXT, VLM_GEN = (32, 32), 64, 16
DECODE_TOL = 1e-4  # decode against a whole-sequence forward, of max |logit|


def vlm_batch(cfg, b, text, seed, grid):
    """Qwen2-VL's layout, drawn from ``seed`` with numpy: rows x cols
    stub patch embeddings (normals of std 0.5) at positions (0, i // cols,
    i % cols), then ``text`` tokens at max(rows, cols) + j in all three
    components.  Returns numpy (tokens (B, P + text) int32, patch_embeds
    (B, P, D) fp32, positions (B, P + text, 3) int32)."""
    import numpy as np
    rows, cols = grid
    p = rows * cols
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, p + text)).astype(np.int32)
    patches = (0.5 * rng.standard_normal((b, p, cfg.d_model))).astype(np.float32)
    i = np.arange(p)
    img = np.stack([np.zeros(p, np.int64), i // cols, i % cols], axis=-1)
    txt = np.repeat((max(rows, cols) + np.arange(text))[:, None], 3, axis=-1)
    pos = np.broadcast_to(np.concatenate([img, txt])[None], (b, p + text, 3))
    return tokens, patches, np.ascontiguousarray(pos).astype(np.int32)


def clone_caches(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def greedy_decode(torch, params, caches, first, start, n, cfg):
    """n per-token greedy ``lm_decode`` steps from ``first`` (B, 1):
    (B, n) tokens, ``tokens[:, 0] == first`` as ``lm_generate`` emits."""
    from repro_torch.models import lm_decode
    tok, out = first, []
    for i in range(n):
        out.append(tok[:, 0])
        logits, caches = lm_decode(params, caches, {"tokens": tok}, start + i, cfg)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return torch.stack(out, dim=1)


def fixed_batch_run(torch, dev, gpu_line, label, params, cfg):
    """The fixed-batch launcher's path (``serve.FixedBatch``, B 4, 32
    tokens, the launcher's key) at prompt lengths 0 and 16, greedy and
    sampled (``SAMPLING``), through a graphed object: its first call
    runs the prefill and the whole ``lm_generate`` eagerly (each on a
    side stream, then captures it), its second call replays both graphs.
    Gated: the second call's tokens equal the first's (the eager
    ``lm_prefill`` + ``lm_generate``), each graph replayed once, and the
    launches counted through the replays equal the eager run's; at
    prompt length 16, greedy, also equal to an eager object's
    (``cuda_graphs=False``).  Decode tok/s reported (the eager object's
    beside it at 16 greedy, with the card's busy share over a third,
    profiled graphed call)."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    b, gen = WHISPER_B, WHISPER_GEN
    key = prng.split(prng.PRNGKey(0), 4)[3]
    rep = {}
    for plen, (mode, sampling) in itertools.product(
            (0, WHISPER_PROMPT), (("greedy", {}), ("sampled", SAMPLING))):
        prompt, frames = serve.static_inputs(cfg, batch=b, prompt_len=plen,
                                             seed=0, device=dev)

        def make(graphed):
            return serve.FixedBatch(params, cfg, prompt, frames, gen, key=key,
                                    device=dev, cuda_graphs=graphed, **sampling)

        graphed = make(True)
        _build.reset_launch_counts()
        want, _, _ = graphed()                  # eager runs, then captures
        e_launches = dict(_build.launch_counts)
        _build.reset_launch_counts()
        got, g_pre, g_dec = graphed()
        g_launches = dict(_build.launch_counts)
        name = f"{label} prompt {plen} {mode}"
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: graphed tokens != eager lm_prefill + "
                                 "lm_generate")
        replays = {k: v["replays"] for k, v in graphed.stats().items()}
        if replays != ({"prefill": 1, "generate": 1} if plen else {"generate": 1}):
            raise AssertionError(f"{name}: replays {replays}")
        if g_launches != e_launches:
            raise AssertionError(f"{name}: graphed launches {g_launches} != "
                                 f"eager {e_launches}")
        row = dict(prefill_ms=g_pre * 1e3, tok_per_s=b * gen / g_dec,
                   graphs=graphed.stats())
        if plen and not sampling:
            eager, e_pre, e_dec = make(False)()
            if not np.array_equal(eager, want):
                raise AssertionError(f"{name}: the eager object's tokens differ")
            row.update(eager_prefill_ms=e_pre * 1e3,
                       eager_tok_per_s=b * gen / e_dec,
                       device=device_busy(torch, graphed, g_pre + g_dec))
        rep[f"prompt{plen}_{mode}"] = row
        busy = row.get("device", {}).get("busy_share")
        log(f"  {name}: graphed == eager tokens, one replay of each graph, "
            f"launches {g_launches['bsr_matmul']} BSR as eager; decode "
            f"{row['tok_per_s']:.1f} tok/s graphed, prefill "
            f"{row['prefill_ms']:.2f} ms"
            + (f" (eager object {row['eager_tok_per_s']:.1f} tok/s, prefill "
               f"{row['eager_prefill_ms']:.2f} ms)" if "eager_tok_per_s" in row
               else "")
            + (f", card busy {100 * busy:.1f}%" if isinstance(busy, float)
               else "") + f"; on {gpu_line}")
    return rep


def whisper_run(torch, dev, gpu_line):
    """Phase 8 (a): whisper-tiny at full width (fp32 params), knapsack
    0.75 at 128x128, packed; the launcher's fixed batch (B 4, prompt 16,
    32 tokens, frames (4, 1500, 384) from the seed).  fp32 activations,
    gated: ``lm_prefill`` + ``lm_generate`` tokens equal per-token greedy
    ``lm_decode`` and each row decoded alone; prefill logits equal
    ``lm_forward``'s with frames; the packed forward within fp32 ``TOL``
    of the masked dense one; teacher-forced decode logits within
    ``DECODE_TOL`` of ``lm_forward`` over the whole sequence (greedy streams
    of these random weights repeat one token: the decoder has no
    positional signal, as in the reference, so the distinct-token floor
    is reported, not gated); exact BSR launches, one per packed weight
    per encoder pass and per decoder forward (the cross projections stay
    dense: no pruner include substring matches them), no other kernel.
    Then the config's bf16 activations (full length, finite logits) and
    the launcher's own run.  Returns (report, launches of the fp32 run,
    the kernels' inputs captured from an eager pass)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve
    from repro_torch.models import (encode_kv_caches, encoder_forward, init_caches,
                                    lm_decode, lm_forward, lm_generate, lm_prefill)
    from repro_torch.sparse import unpack_params
    b, plen, gen = WHISPER_B, WHISPER_PROMPT, WHISPER_GEN
    base = get_config("whisper-tiny")
    cfg_a = base.replace(activ_dtype="float32")
    t0 = time.perf_counter()
    params, summ = serve.build_params(base, seed=0, device=dev, pruned=0.75,
                                      block=(128, 128), min_size=4096)
    torch.cuda.synchronize()
    rep = dict(build_s=time.perf_counter() - t0, kept=summ["kept"],
               structures=summ["total"], density=summ["density"])
    n_enc = packed_counts(params["encoder"])[0]
    n_dec = packed_counts(params["layers"])[0]
    prompt, frames = serve.static_inputs(base, batch=b, prompt_len=plen, seed=0,
                                         device=dev)

    def generate(cfg, rows=slice(None), timed=None):
        """Encoder, cross K/V, prefill, ``lm_generate``.  Returns (tokens,
        prefill logits, the caches as the prefill left them)."""
        t = time.perf_counter()
        n = prompt[rows].shape[0]
        caches = init_caches(cfg, n, plen + gen, torch.float32, dev)
        enc = encoder_forward(params, frames[rows], cfg)
        caches = encode_kv_caches(params, enc, cfg, caches)
        logits, caches = lm_prefill(params, caches, {"tokens": prompt[rows]}, cfg)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        snap = clone_caches(caches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, _ = lm_generate(params, caches, first, plen, gen, cfg)
        torch.cuda.synchronize()
        if timed is not None:
            timed.update(prefill_ms=(t1 - t) * 1e3, decode_s=time.perf_counter() - t1)
        return toks, logits, snap

    with torch.no_grad():
        with Capture(torch, ops) as cap:             # warm-up, eager: inputs kept
            generate(cfg_a)
        times = {}
        _build.reset_launch_counts()
        toks, logits, snap = generate(cfg_a, timed=times)
        launches = dict(_build.launch_counts)
        want = {k: 0 for k in SOURCES}
        want["bsr_matmul"] = n_enc + n_dec * (1 + gen)
        if {k: launches.get(k, 0) for k in SOURCES} != want:
            raise AssertionError(f"whisper fp32: launches {launches} != {want} "
                                 f"({n_enc} encoder + {n_dec} decoder weights)")
        steps = greedy_decode(torch, params, clone_caches(snap), toks[:, :1], plen,
                              gen, cfg_a)
        if not torch.equal(steps, toks):
            raise AssertionError("whisper fp32: lm_generate != per-token lm_decode")
        for r in range(b):
            if not torch.equal(generate(cfg_a, rows=slice(r, r + 1))[0], toks[r:r + 1]):
                raise AssertionError(f"whisper fp32: row {r} alone != in the batch")
        fwd = lm_forward(params, {"tokens": prompt, "frames": frames}, cfg_a)[0]
        err_fwd = rel_err(logits, fwd)
        if err_fwd > TOL["float32"]:
            raise AssertionError(f"whisper fp32: lm_prefill vs lm_forward {err_fwd:.3g}")
        masked = lm_forward(unpack_params(params), {"tokens": prompt, "frames": frames},
                            cfg_a)[0]
        err_dense = rel_err(fwd, masked)
        if err_dense > TOL["float32"]:
            raise AssertionError(f"whisper fp32: packed vs masked dense {err_dense:.3g}")
        del masked
        forced = torch.as_tensor(np.random.default_rng(1).integers(
            0, base.vocab, size=(b, gen)), device=dev).to(torch.int32)
        full = lm_forward(params, {"tokens": torch.cat([prompt, forced], 1),
                                   "frames": frames}, cfg_a)[0]
        caches, err_tf = clone_caches(snap), 0.0
        for i in range(gen - 1):
            step, caches = lm_decode(params, caches, {"tokens": forced[:, i:i + 1]},
                                     plen + i, cfg_a)
            err_tf = max(err_tf, rel_err(step[:, 0], full[:, plen + i]))
        if err_tf > DECODE_TOL:
            raise AssertionError(f"whisper fp32: teacher-forced decode vs "
                                 f"lm_forward {err_tf:.3g} > {DECODE_TOL}")
        del full, caches, snap
        distinct = [len(set(r)) for r in toks.tolist()]
        busy = device_busy(torch, lambda: generate(cfg_a), times["prefill_ms"] / 1e3
                           + times["decode_s"])
        toks_b, logits_b, _ = generate(base)
        if toks_b.shape != (b, gen) or not torch.isfinite(logits_b).all():
            raise AssertionError("whisper bf16: short stream or non-finite logits")
        agree = int((toks_b[:, 0] == toks[:, 0]).sum())
    rep.update(launches=want, encoder_weights=n_enc, decoder_weights=n_dec,
               prefill_ms=times["prefill_ms"], decode_s=times["decode_s"],
               tok_per_s=b * gen / times["decode_s"], device=busy,
               err_prefill_vs_forward=err_fwd, err_packed_vs_masked=err_dense,
               err_teacher_forced=err_tf, distinct_tokens=distinct,
               bf16_first_token_agreement=f"{agree}/{b}")
    share = busy["busy_share"]
    log(f"  whisper (a) fp32: kept {summ['kept']}/{summ['total']} structures, "
        f"BSR density {summ['density']:.4f}; {n_enc} encoder + {n_dec} decoder "
        f"packed weights, launches {launches['bsr_matmul']} = {n_enc} + {n_dec} x "
        f"{1 + gen}; encoder + cross K/V + prefill {times['prefill_ms']:.2f} ms, "
        f"decode {b * gen / times['decode_s']:.1f} tok/s; card busy "
        + (f"{100 * share:.1f}%" if isinstance(share, float) else
           f"not measured ({busy.get('error')})")
        + f"; tokens == per-token decode == rows alone; prefill vs forward "
        f"{err_fwd:.3g}, packed vs masked dense {err_dense:.3g}, teacher-forced "
        f"decode vs forward {err_tf:.3g}; distinct tokens per stream {distinct} "
        f"of {gen} (reported); bf16: full length, finite, first tokens equal "
        f"to fp32 in {agree}/{b}; on {gpu_line}")
    rep["fixed_batch"] = fixed_batch_run(torch, dev, gpu_line, "whisper-tiny",
                                         params, base)
    t1 = time.perf_counter()
    if serve.main(["--arch", "whisper-tiny", "--pruned", "0.75"]) != 0:
        raise AssertionError("whisper: the launcher failed")
    rep["launcher_s"] = time.perf_counter() - t1
    return rep, launches, cap


def vlm_run(torch, dev, gpu_line):
    """Phase 8 (b): qwen2-vl-2b at full width, built in bf16 (tied
    embedding scaled by ``EMBED_SCALE``), knapsack 0.75 at 128x128,
    packed, the dense tree freed.  (i) an fp32 copy prefills B 2 on
    contiguous caches: 1024 stub patches on a 32 x 32 grid, then 64 text
    tokens (``vlm_batch``), then 16 greedy tokens; gated: prefill logits
    equal ``lm_forward``'s, ``lm_generate`` equal per-token decode, 7 BSR
    launches per layer per forward.  (ii) text-only requests on phase
    3's traffic through ``serve_gated`` (eager and graphed, prefix
    caching on with a hit in every pass, exact launches, graphed ==
    eager, the distinct floor): fp32 with streams == solo decode, then
    bf16.  Greedy streams of these random weights repeat a token even
    with the embedding scaled (phase (i) reports theirs), so (ii) samples
    every request (``SAMPLING``, keys from the rids): the distinct floor
    then means something, and each stream still has to equal its solo
    decode token for token.  Returns (report, launches of the fp32
    graphed steady pass, the kernels' inputs captured from an eager fp32
    pass)."""
    from repro_torch.configs import get_config
    from repro_torch.core import BlockingSpec
    from repro_torch.core.structures import iter_leaves
    from repro_torch.kernels import _build, ops
    from repro_torch.models import (init_caches, init_params, lm_forward,
                                    lm_generate, lm_prefill)
    from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary
    base = get_config("qwen2-vl-2b")
    n_layers, gen = base.n_layers, VLM_GEN
    t0 = time.perf_counter()
    params = init_params(base, seed=0, device=dev)
    params["embed"]["embedding"].mul_(EMBED_SCALE)
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    sel = knapsack_prune(params, sparsity=0.75, blocking=BlockingSpec(128, 128),
                         min_size=4096)
    packed = pack_params(params, sel.masks, sel.structures)
    summ = sparsity_summary(packed)
    kept, total = sel.kept, sel.total
    del params, sel
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rep = dict(build_s=time.perf_counter() - t0, params=n_params, kept=kept,
               structures=total, density=summ["density"],
               memory_gb=torch.cuda.memory_allocated() / 1e9)
    n_bsr = packed_counts(packed)[0]
    if n_bsr != 7 * n_layers:
        raise AssertionError(f"qwen2-vl: {n_bsr} packed weights, not 7 x {n_layers}")
    log(f"  qwen2-vl-2b: {n_params} params in {base.param_dtype}, init + knapsack "
        f"+ pack {rep['build_s']:.1f}s; kept {kept}/{total} structures, BSR "
        f"density {summ['density']:.4f}; {rep['memory_gb']:.1f} GB on the card")
    cfg_a = base.replace(param_dtype="float32", activ_dtype="float32")
    params_a = cast_tree(packed, torch.float32)

    # (i) the patch prefill with Qwen2-VL's 3-D positions, then decode
    tokens, patches, pos = vlm_batch(cfg_a, 2, VLM_TEXT, 0, VLM_GRID)
    batch = {"tokens": torch.as_tensor(tokens, device=dev),
             "patch_embeds": torch.as_tensor(patches, device=dev),
             "positions": torch.as_tensor(pos, device=dev)}
    s = tokens.shape[1]
    with torch.no_grad():
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        logits, caches = lm_prefill(params_a, init_caches(cfg_a, 2, s + gen,
                                                          torch.float32, dev),
                                    batch, cfg_a)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        pre = _build.launch_counts["bsr_matmul"]
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        snap = clone_caches(caches)
        _build.reset_launch_counts()
        toks, _ = lm_generate(params_a, caches, first, s, gen, cfg_a)
        dec = _build.launch_counts["bsr_matmul"]
        if (pre, dec) != (n_bsr, n_bsr * gen):
            raise AssertionError(f"qwen2-vl patch prefill: BSR launches {pre}, "
                                 f"{dec} != {n_bsr}, {n_bsr * gen}")
        err_fwd = rel_err(logits, lm_forward(params_a, batch, cfg_a)[0])
        if err_fwd > TOL["float32"]:
            raise AssertionError(f"qwen2-vl: lm_prefill vs lm_forward {err_fwd:.3g}")
        del logits, caches
        steps = greedy_decode(torch, params_a, snap, first, s, gen, cfg_a)
        if not torch.equal(steps, toks):
            raise AssertionError("qwen2-vl: lm_generate != per-token lm_decode")
        del snap
    distinct = [len(set(r)) for r in toks.tolist()]
    rep["patch_prefill"] = dict(b=2, s=s, patches=patches.shape[1], prefill_ms=prefill_ms,
                                launches_per_forward=n_bsr, err_vs_forward=err_fwd,
                                distinct_tokens=distinct)
    log(f"  qwen2-vl (i) fp32 patch prefill B 2 x S {s} ({patches.shape[1]} "
        f"patches on a {VLM_GRID[0]}x{VLM_GRID[1]} grid, 3-D positions) "
        f"{prefill_ms:.1f} ms, vs lm_forward {err_fwd:.3g}; {gen} greedy tokens "
        f"== per-token decode (decode resumes at position {s} in every "
        f"component, as in the reference); BSR {n_bsr} per forward; distinct "
        f"tokens {distinct} of {gen}")

    # (ii) text-only serving through the paged engine, eager and graphed
    prompts = traffic(base.vocab, 0)

    def want(run):
        passes = run["decode_ticks"] + run["admissions"]
        return {"bsr_matmul": n_bsr * passes, "bsr_planes_matmul": 0,
                "paged_attention_decode": n_layers * run["decode_ticks"],
                "paged_attention_prefill": n_layers * run["admissions"],
                "structure_norms": 0}

    with Capture(torch, ops) as cap:
        serve_pass(torch, gated_engine(dev, params_a, cfg_a, prompts, gen, 4, False),
                   prompts, gen)
    rep["serve_a"] = serve_gated(torch, dev, gpu_line, "qwen2-vl-2b (a) fp32",
                                 params_a, cfg_a, prompts, gen, want=want,
                                 solo_slots=4, prefix=True, sampling=SAMPLING)
    launches = rep["serve_a"]["graphed"]["passes"][-1]["launches"]
    del params_a
    torch.cuda.empty_cache()
    rep["serve_b"] = serve_gated(torch, dev, gpu_line, "qwen2-vl-2b (b) bf16",
                                 packed, base, prompts, gen, want=want, prefix=True,
                                 sampling=SAMPLING)
    del packed
    torch.cuda.empty_cache()
    return rep, launches, cap


def family_path(torch, dev, gpu_line, qwen=None):
    """Phase 8: (a) whisper-tiny, (b) qwen2-vl-2b, (c) qwen1.5-0.5b's
    fixed batch through ``fixed_batch_run`` (on ``qwen`` = phase 3's
    (params, config, ...) when given).  Returns (report, {path: launches
    of its counted run}, {path: captured inputs})."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep, launches, caps = {}, {}, {}
    rep["whisper"], launches[WHISPER_PATH], caps[WHISPER_PATH] = whisper_run(
        torch, dev, gpu_line)
    if qwen is None:
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        cfg = get_config("qwen1.5-0.5b").replace(param_dtype="float32",
                                                 activ_dtype="float32")
        qwen = (serve.build_params(cfg, seed=0, device=dev, pruned=0.75,
                                   block=(128, 128), min_size=4096)[0], cfg)
    rep["qwen_fixed_batch"] = fixed_batch_run(torch, dev, gpu_line,
                                              "qwen1.5-0.5b", *qwen[:2])
    rep["qwen2_vl"], launches[VLM_PATH], caps[VLM_PATH] = vlm_run(torch, dev, gpu_line)
    rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8: max memory allocated {rep['max_memory_allocated_gb']:.1f} GB; "
        f"took {rep['seconds']:.1f}s; on {gpu_line}")
    return rep, launches, caps


# ---------------------------------------------------------------------------
# phase 9: the expert-parallel MoE through the all-to-all
# ---------------------------------------------------------------------------

# granite at full width, knapsack 0.75 at 128x128, packed, fp32, at cf
# E/k = 4.0 (no slot drops at m = 1 or 2); B 4 x S 128 = 512 tokens
A2A = dict(arch="granite-moe-1b-a400m", smoke=False, batch=4, seq=128, cf=4.0,
           block=(128, 128), min_size=4096, requests=4, gen=16, reps=3)
A2A_PATHS = {1: "granite-moe-1b-a400m all-to-all m=1 (phase 9)",
             2: "granite-moe-1b-a400m all-to-all m=2 (phase 9)"}
A2A_GRAD_TOL = 1e-4        # gradients, of each leaf's max |grad|


class CollectiveClock:
    """Counts ``torch.distributed.all_to_all_single`` calls and, with
    ``timed``, the wall seconds inside them (the card synchronised before
    and after each, so the time is the collective's own)."""

    def __init__(self, torch, timed=False):
        import torch.distributed as dist
        self.torch, self.dist = torch, dist
        self.timed = timed
        self.calls, self.seconds = 0, 0.0
        self.orig = None

    def __enter__(self):
        torch = self.torch
        a2a = self.orig = self.dist.all_to_all_single

        def all_to_all_single(out, inp, *a, **kw):
            self.calls += 1
            if self.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            r = a2a(out, inp, *a, **kw)
            if self.timed:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
            return r

        self.dist.all_to_all_single = all_to_all_single
        return self

    def __exit__(self, *exc):
        self.dist.all_to_all_single = self.orig
        return False


def a2a_build(torch, dev, spec):
    """(cfg, packed params, summary, tokens, labels) of phase 9: the arch
    in fp32 at ``spec["cf"]`` with ``moe_impl="alltoall"``, from seed 0,
    knapsack-pruned and packed; tokens and labels from a numpy seed."""
    import numpy as np
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch import serve
    cfg = get_config(spec["arch"])
    if spec["smoke"]:
        cfg = make_smoke(cfg)
    cfg = cfg.replace(param_dtype="float32", activ_dtype="float32",
                      capacity_factor=spec["cf"], moe_impl="alltoall")
    params, summ = serve.build_params(cfg, seed=0, device=dev, pruned=0.75,
                                      block=spec["block"],
                                      min_size=spec["min_size"])
    rng = np.random.default_rng(1)
    shape = (spec["batch"], spec["seq"])
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=shape), device=dev)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, size=shape), device=dev)
    return cfg, params, summ, tokens, labels


def a2a_forwards(torch, params, cfg, tokens, dev, counted=False):
    """``lm_forward`` and ``lm_prefill`` (contiguous caches) on the
    tokens, under whatever mesh and rules are installed.  With
    ``counted`` the launch counts are zeroed just before each call and
    read just after.  Returns (logits, aux, prefill logits, [launches of
    each call])."""
    from repro_torch.kernels import _build
    from repro_torch.models import init_caches, lm_forward, lm_prefill
    launches = []
    with torch.no_grad():
        caches = init_caches(cfg, *tokens.shape, torch.float32, dev)
        torch.cuda.synchronize()
        if counted:
            _build.reset_launch_counts()
        logits, aux = lm_forward(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        launches.append(dict(_build.launch_counts))
        if counted:
            _build.reset_launch_counts()
        plog, _ = lm_prefill(params, caches, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        launches.append(dict(_build.launch_counts))
    return logits, aux["moe_aux"], plog, launches


def a2a_timed(torch, params, cfg, tokens, reps):
    """Median wall ms of ``lm_forward`` (synchronised) over ``reps``."""
    from repro_torch.models import lm_forward
    times = []
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_forward(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def a2a_measure(torch, params, cfg, tokens, spec, profile=False):
    """ms per forward, the all-to-all's share of it (a forward with each
    collective timed alone), peak memory and, with ``profile``, the
    card's busy share over one forward."""
    from repro_torch.models import lm_forward
    torch.cuda.reset_peak_memory_stats()
    ms = a2a_timed(torch, params, cfg, tokens, spec["reps"])
    peak = torch.cuda.max_memory_allocated()
    with CollectiveClock(torch, timed=True) as clock, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_forward(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = dict(ms_per_forward=ms, peak_bytes=peak,
               all_to_all_calls=clock.calls, all_to_all_ms=clock.seconds * 1e3,
               all_to_all_share=clock.seconds / wall)
    if profile:
        def run():
            with torch.no_grad():
                lm_forward(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
        out["device"] = device_busy(torch, run, ms / 1e3)
    return out


def a2a_grads(torch, params, cfg, tokens, labels):
    """Gradients of ``cross_entropy_loss`` over ``lm_forward`` on the
    dense (unpacked, masked) params, under whatever mesh is installed
    (the backward runs inside it: each layer's recomputation routes as
    its forward did).  Returns {path: grad} of the float leaves."""
    from repro_torch.core.structures import iter_leaves
    from repro_torch.models import cross_entropy_loss, lm_forward
    from repro_torch.sparse import unpack_params
    dense = unpack_params(params)
    leaves = {path: leaf for path, leaf in iter_leaves(dense)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()}
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    logits, _ = lm_forward(dense, {"tokens": tokens}, cfg)
    cross_entropy_loss(logits, labels).backward()
    torch.cuda.synchronize()
    return {path: leaf.grad for path, leaf in leaves.items()}


def a2a_capture(torch, params, cfg, tokens, dev):
    """One forward and prefill under ``Capture``: the BSR kernel's inputs
    at granite's attention (M 512) and the planes kernel's at the
    all-to-all's expert buffers, for phase 4."""
    from repro_torch.kernels import ops
    with Capture(torch, ops) as cap:
        a2a_forwards(torch, params, cfg, tokens, dev)
    return {"bsr": cap.bsr, "planes": cap.planes}


def a2a_single(rank, spec):
    """Phase 9 (a) and (c), one rank over NCCL, mesh (1, 1).  (a):
    ``lm_forward`` / ``lm_prefill`` through the all-to-all against the
    same calls with no mesh (``moe_apply``), exact launches, one backward
    pass; (c): the engine on phase 3's traffic under the decode rules
    against the same engine with no mesh."""
    import torch
    from repro_torch.distributed import (axis_rules, make_decode_rules,
                                         make_mesh, make_train_rules, use_mesh)
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, params, summ, tokens, labels = a2a_build(torch, dev, spec)
    build_s = time.perf_counter() - t0
    n_bsr, n_planes = packed_counts(params)
    plain = a2a_forwards(torch, params, cfg, tokens, dev)
    measured_plain = a2a_measure(torch, params, cfg, tokens, spec, profile=True)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    rules = make_train_rules(False)
    with use_mesh(mesh), axis_rules(rules):
        cap = a2a_capture(torch, params, cfg, tokens, dev)
        with CollectiveClock(torch) as clock:
            got = a2a_forwards(torch, params, cfg, tokens, dev, counted=True)
        measured = a2a_measure(torch, params, cfg, tokens, spec, profile=True)
        grads = a2a_grads(torch, params, cfg, tokens, labels)
    grads_plain = a2a_grads(torch, params, cfg, tokens, labels)
    grad_err = {path: float((grads[path] - g).abs().max() / g.abs().max())
                for path, g in grads_plain.items()
                if g is not None and float(g.abs().max()) > 0}
    del grads, grads_plain
    torch.cuda.empty_cache()

    # (c) the engine, no mesh then under the mesh and the decode rules
    prompts = traffic(cfg.vocab, 0)[:spec["requests"]]
    gen = spec["gen"]

    def engine():
        return ServingEngine(params, cfg, num_slots=4, page_size=8,
                             max_seq_len=max(len(q) for q in prompts) + gen,
                             ticks_per_sync=4, device=dev, cuda_graphs=True)

    eng0 = engine()
    run0 = serve_pass(torch, eng0, prompts, gen)
    with use_mesh(mesh), axis_rules(make_decode_rules(False, shard_cache_seq=False)):
        eng1 = engine()
        with CollectiveClock(torch) as engine_clock:
            run1 = serve_pass(torch, eng1, prompts, gen)
    same_streams("phase 9 (c): the engine under the mesh vs without it",
                 run0["done"], run1["done"])
    solo = serve.verify_streams(params, cfg, run0["done"], gen, device=dev)
    return dict(
        build_s=build_s, summary=summ, n_layers=cfg.n_layers,
        per_forward={"bsr_matmul": n_bsr, "bsr_planes_matmul": n_planes},
        plain=[t.cpu() if isinstance(t, torch.Tensor) else t for t in plain[:3]],
        got=[t.cpu() for t in got[:3]], launches=got[3],
        all_to_all_calls=clock.calls, moe_layers=sum(
            1 for lp in params["layers"] if "moe" in lp),
        measured=measured, measured_plain=measured_plain, grad_err=grad_err,
        engine=dict(requests=len(run1["done"]), solo_bad=solo,
                    launches=run1["launches"],
                    decode_ticks=run1["decode_ticks"],
                    admissions=run1["admissions"],
                    prefix_hits=eng1.prefix_stats["hit_requests"],
                    all_to_all_calls=engine_clock.calls,
                    tok_per_s=run1["tok_per_s"],
                    tok_per_s_no_mesh=run0["tok_per_s"],
                    graphs=eng1.analysis_stats()),
        capture=cap)


def a2a_pair(rank, spec):
    """Phase 9 (b), one of two ranks sharing the card over gloo, mesh
    (1, 2): ``lm_forward`` / ``lm_prefill`` with 16 experts each, then
    one ``lm_forward`` at the config's own capacity factor, where slots
    may drop and both ranks must still hold the same logits."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import (axis_rules, make_mesh, make_train_rules,
                                         use_mesh)
    from repro_torch.models import lm_forward
    dev = torch.device("cuda")
    mesh = make_mesh((1, 2), ("data", "model"), device_type="cuda")
    cfg, params, _, tokens, _ = a2a_build(torch, dev, spec)
    n_bsr, n_planes = packed_counts(params)
    own = cfg.replace(capacity_factor=get_config(spec["arch"]).capacity_factor)
    with use_mesh(mesh), axis_rules(make_train_rules(False)):
        # both ranks capture, so that their collectives pair up
        cap = a2a_capture(torch, params, cfg, tokens, dev)
        got = a2a_forwards(torch, params, cfg, tokens, dev, counted=True)
        measured = a2a_measure(torch, params, cfg, tokens, spec)
        with torch.no_grad():
            own_logits, _ = lm_forward(params, {"tokens": tokens}, own)
    return dict(got=[t.cpu() for t in got[:3]], launches=got[3],
                per_forward={"bsr_matmul": n_bsr, "bsr_planes_matmul": n_planes},
                backend=dist.get_backend(), measured=measured,
                own_cf=own.capacity_factor, own_logits=own_logits.cpu(),
                capture=cap["planes"] if rank == 0 else None)


def a2a_gate_launches(label, got, per_forward):
    """Each of lm_forward and lm_prefill launched each BSR kernel once per
    packed weight (planes: once per packed expert weight, 3 per MoE layer)."""
    for name, run in zip(("lm_forward", "lm_prefill"), got):
        for kernel, want in per_forward.items():
            if run[kernel] != want:
                raise AssertionError(f"phase 9 {label} {name}: {kernel} "
                                     f"launched {run[kernel]} times, not {want}")


def a2a_path(torch, dev, gpu_line, spec=A2A):
    """Phase 9: (a) and (c) in one NCCL rank, (b) in two gloo ranks on the
    same card, each a child process through ``run_ranks`` (the kernels
    were built in phase 1, so the children load them).  Returns (report,
    {path: launches}, {path: capture for phase 4})."""
    import tempfile
    from types import SimpleNamespace
    from repro_torch.distributed import run_ranks
    t0 = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        (a,) = run_ranks(a2a_single, 1, backend="nccl", device_type="cuda",
                         init_file=Path(d) / "init_a", args=(spec,))
        log(f"  (a)+(c) rank done at {time.perf_counter() - t0:.1f}s of the phase")
        b = run_ranks(a2a_pair, 2, backend="gloo", device_type="cuda",
                      init_file=Path(d) / "init_b", args=(spec,))
    n_layers = a["n_layers"]

    # (a) m = 1 over NCCL: the same logits as moe_apply, exact launches
    (lf, aux, lp), (pf, paux, pp) = a["got"], a["plain"]
    errs = {"lm_forward": rel_err(lf, pf), "lm_prefill": rel_err(lp, pp)}
    aux_err = abs(float(aux) - float(paux))
    if max(errs.values()) > TOL["float32"] or aux_err > 1e-6:
        raise AssertionError(f"phase 9 (a): all-to-all vs moe_apply logits "
                             f"{errs}, aux {aux_err:.3g}")
    a2a_gate_launches("(a)", a["launches"], a["per_forward"])
    want_calls = 3 * a["moe_layers"] * 2
    if a["all_to_all_calls"] != want_calls:
        raise AssertionError(f"phase 9 (a): {a['all_to_all_calls']} all-to-alls, "
                             f"not 3 per MoE layer per call = {want_calls}")
    worst_grad = max(a["grad_err"].values())
    if worst_grad > A2A_GRAD_TOL:
        bad = sorted(a["grad_err"].items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"phase 9 (a): gradients off by {bad}")
    ma, mp = a["measured"], a["measured_plain"]
    log(f"  (a) m=1 NCCL mesh (1, 1), {n_layers} layers, B {spec['batch']} x S "
        f"{spec['seq']}: logits vs moe_apply {errs} (tolerance "
        f"{TOL['float32']}), aux err {aux_err:.3g}; launches per call "
        f"{a['launches'][0]} (= {a['per_forward']}); {a['all_to_all_calls']} "
        f"all-to-alls; gradients (dense params) worst rel err {worst_grad:.3g} "
        f"over {len(a['grad_err'])} leaves")
    def busy(m):
        share = m["device"]["busy_share"]
        return f"{100 * share:.1f}%" if isinstance(share, float) else share

    log(f"  (a) on {gpu_line}: {ma['ms_per_forward']:.2f} ms per forward "
        f"through the all-to-all vs {mp['ms_per_forward']:.2f} ms through "
        f"moe_apply; all-to-all {ma['all_to_all_ms']:.2f} ms = "
        f"{100 * ma['all_to_all_share']:.1f}% of a forward; card busy "
        f"{busy(ma)} ({busy(mp)} for moe_apply)"
        + f"; peak memory {ma['peak_bytes'] / 2**30:.2f} GiB "
        f"(moe_apply {mp['peak_bytes'] / 2**30:.2f} GiB); build "
        f"{a['build_s']:.1f}s")

    # (b) m = 2, two ranks sharing the card over gloo
    for r, out in enumerate(b):
        (bf, baux, bp) = out["got"]
        berrs = {"lm_forward": rel_err(bf, lf), "lm_prefill": rel_err(bp, lp)}
        baux_err = abs(float(baux) - float(aux))
        if max(berrs.values()) > TOL["float32"] or baux_err > 1e-6:
            raise AssertionError(f"phase 9 (b) rank {r}: logits vs (a) {berrs}, "
                                 f"aux {baux_err:.3g}")
        a2a_gate_launches(f"(b) rank {r}", out["launches"], out["per_forward"])
    # at the config's own cf the replicas hold model rank 0's y: equal logits
    if not torch.equal(b[0]["own_logits"], b[1]["own_logits"]):
        raise AssertionError(f"phase 9 (b): at cf {b[0]['own_cf']} the two "
                             f"ranks' logits differ")
    own_vs_a = rel_err(b[0]["own_logits"], lf)
    mb = b[0]["measured"]
    log(f"  (b) m=2 two ranks sharing the card over {b[0]['backend']} (the "
        f"collective staged through the host by gloo; not an NCCL figure): "
        f"logits and aux == (a) on both ranks; at cf {b[0]['own_cf']} both "
        f"ranks' logits equal (rel err vs cf {spec['cf']}: {own_vs_a:.3g}, "
        f"nonzero where slots dropped); "
        f"launches per call {b[0]['launches'][0]} (= {b[0]['per_forward']}); "
        f"{mb['ms_per_forward']:.2f} ms per forward, all-to-all "
        f"{mb['all_to_all_ms']:.2f} ms = {100 * mb['all_to_all_share']:.1f}%, "
        f"peak memory {mb['peak_bytes'] / 2**30:.2f} GiB per rank")

    # (c) the engine under the mesh and the decode rules
    c = a["engine"]
    if c["requests"] != spec["requests"]:
        raise AssertionError(f"phase 9 (c): {c['requests']} streams, not "
                             f"{spec['requests']}")
    if c["solo_bad"]:
        raise AssertionError(f"phase 9 (c): no-mesh streams {c['solo_bad']} "
                             "differ from solo decode")
    if c["prefix_hits"] < 1:
        raise AssertionError("phase 9 (c): no prefix-cache hit")
    run = dict(launches=c["launches"], decode_ticks=c["decode_ticks"],
               admissions=c["admissions"])
    gate_launches(spec["arch"], "phase 9 (c)", n_layers, run)
    # each admission's prefill is a graph: its all-to-alls run in Python
    # twice per captured (L, start) (the warm-up and the capture) and
    # inside the replays of the rest
    pre = c["graphs"]
    captures = pre["prefill_captures"]
    if captures + sum(pre["prefill_replays"].values()) != c["admissions"]:
        raise AssertionError(f"phase 9 (c): {captures} prefill captures + "
                             f"replays {pre['prefill_replays']} != "
                             f"{c['admissions']} admissions")
    if c["all_to_all_calls"] != 3 * a["moe_layers"] * 2 * captures:
        raise AssertionError(f"phase 9 (c): {c['all_to_all_calls']} all-to-alls,"
                             f" not 3 per MoE layer per prefill warm-up and "
                             f"capture ({captures} captured)")
    log(f"  (c) engine under the mesh and decode rules, {spec['requests']} "
        f"requests, graphed: streams == the no-mesh engine's == solo decode; "
        f"{c['prefix_hits']} prefix-hit requests; launches {c['launches']}; "
        f"{c['all_to_all_calls']} all-to-alls in Python (3 per MoE layer in "
        f"the warm-up and the capture of each of {captures} prefill graphs; "
        f"{c['admissions']} admissions); {c['tok_per_s']:.1f} tok/s vs "
        f"{c['tok_per_s_no_mesh']:.1f} without the mesh")
    secs = time.perf_counter() - t0
    log(f"  phase 9 took {secs:.1f}s on {gpu_line}")
    caps = {A2A_PATHS[1]: SimpleNamespace(decode=None, prefill={},
                                          **a["capture"]),
            A2A_PATHS[2]: SimpleNamespace(bsr={}, planes=b[0]["capture"],
                                          decode=None, prefill={})}
    launches = {A2A_PATHS[1]: {k: sum(run[k] for run in a["launches"])
                               for k in a["launches"][0]},
                A2A_PATHS[2]: {k: sum(run[k] for run in b[0]["launches"])
                               for k in b[0]["launches"][0]}}
    rep = dict(a=dict(logits_rel_err=errs, aux_err=aux_err,
                      launches=a["launches"], grad_worst_rel_err=worst_grad,
                      measured=ma, measured_moe_apply=mp, build_s=a["build_s"],
                      density=float(a["summary"]["density"]),
                      nnz_blocks=int(a["summary"]["nnz_blocks"])),
               b=[dict(launches=o["launches"], measured=o["measured"],
                       backend=o["backend"]) for o in b],
               own_cf=dict(cf=b[0]["own_cf"], ranks_equal=True,
                           rel_err_vs_a=own_vs_a),
               c=c, seconds=secs)
    return rep, launches, caps


# ---------------------------------------------------------------------------
# phase 10: the sharded program (DTensor) and its dry-run
# ---------------------------------------------------------------------------

# phase 5's cell: full-width qwen1.5-0.5b in its own dtypes (bf16, fp32
# master, remat "dots"), B 8 x S 128, 3 steps each way; (b) one fp32 step
MESH = dict(arch="qwen1.5-0.5b", batch=8, seq=128, steps=3, seed=0,
            smoke=False, device="cuda")
MESH_LOSS_TOL = 1e-2       # (a), DTensor vs plain losses: phase 5's resume gate
MESH_TP_LOSS_TOL = 1e-5    # (b), relative, the first step's loss
MESH_TP_PARAM_TOL = 1e-4   # (b), each leaf's max |diff| over its max |value|
# (c): the dry-run's cells, on the 256-rank fake group, single pod
MESH_DRYRUN = dict(archs=("qwen1.5-0.5b", "granite-moe-1b-a400m"),
                   shapes=("train_4k", "decode_32k"))


def mesh_config(spec):
    from repro_torch.configs import get_config, make_smoke
    cfg = get_config(spec["arch"])
    if spec["smoke"]:          # a CPU rehearsal at smoke widths, its dtypes kept
        cfg = make_smoke(cfg, remat=cfg.remat, param_dtype=cfg.param_dtype,
                         activ_dtype=cfg.activ_dtype)
    return cfg


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def mesh_cell(torch, cfg, dev, mesh):
    """The train cell of ``MESH`` as the dry-run builds it
    (``dryrun.trace_cell``), on real tensors: the seeded state placed by
    ``cell_shardings`` on ``mesh``, the step, and the pipeline placing
    each batch over "data".  Returns (cell, state, step, pipeline)."""
    from repro_torch.configs.base import ShapeCell, input_specs
    from repro_torch.data import LMPipeline, TokenTask
    from repro_torch.distributed import distribute_tree
    from repro_torch.launch.specs import cell_shardings
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    cell = ShapeCell("mesh_phase", "train", MESH["seq"], MESH["batch"])
    opt = AdamWConfig(use_master=cfg.param_dtype != "float32")
    state = init_train_state(init_params(cfg, seed=MESH["seed"], device=dev), opt)
    if mesh is not None:
        sh = cell_shardings(cfg, cell, mesh, False, input_specs(cfg, cell),
                            state_shapes=state)
        state = distribute_tree(state, sh["state"], mesh)
    step = make_train_step(cfg, opt, warmup_cosine(3e-4, 100, 10000))
    pipe = LMPipeline(TokenTask(vocab=cfg.vocab, seed=MESH["seed"]),
                      MESH["batch"], MESH["seq"], device=dev, mesh=mesh,
                      prefetch=0)
    return cell, state, step, pipe


def mesh_steps(torch, state, step, pipe, n):
    """``n`` steps from ``state``: (losses, wall ms per step, state)."""
    losses, ms = [], []
    for s in range(n):
        batch = pipe.batch_at(s)
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"]
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor")
                            else loss))
        sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, state


def mesh_single(rank, spec):
    """Phase 10 (a), one NCCL rank on a (1, 1) mesh: ``MESH["steps"]``
    plain steps, the same steps on DTensor state under the train rules
    (one more counted by the per-rank counter and profiled), peak memory.
    The plain baseline stays the eager ``make_train_step``, as the
    DTensor step it is held against stays eager (a captured DTensor step
    is not supported)."""
    import faulthandler

    import torch
    from repro_torch.distributed import axis_rules, make_mesh, make_train_rules, use_mesh
    from repro_torch.distributed.cost import CostCounter
    faulthandler.enable()
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    cfg = mesh_config(spec)
    _, state, step, pipe = mesh_cell(torch, cfg, dev, None)
    plain, plain_ms, last = mesh_steps(torch, state, step, pipe, spec["steps"])
    del state, last
    if cuda:
        torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    _, dstate, step, pipe = mesh_cell(torch, cfg, dev, mesh)
    with use_mesh(mesh), axis_rules(make_train_rules(False)):
        sharded, sharded_ms, last = mesh_steps(torch, dstate, step, pipe,
                                               spec["steps"])
        del last                  # the counted step holds one state, as traced
        batch = pipe.batch_at(0)
        sync(torch)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with CostCounter(live=(dstate, batch)) as counter:
            step(dstate, batch)
        sync(torch)
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        def run():
            step(dstate, batch)
            sync(torch)
        busy = device_busy(torch, run, statistics.median(sharded_ms[1:]) / 1e3)
    return dict(plain=plain, plain_ms=plain_ms, sharded=sharded,
                sharded_ms=sharded_ms, counts=counter.summary(),
                peak_bytes=peak, device=busy)


def mesh_pair(rank, spec):
    """Phase 10 (b), one of two gloo ranks sharing the card on a (1, 2)
    mesh (tensor parallelism over "model"): one fp32 train step from
    (a)'s params (bf16 init, widened) with AdamW in its linear regime (eps
    1, no weight decay, lr 1: an update carries its gradient's precision);
    rank 0 also takes the same step unsharded.  Every collective runs on
    host copies (``staged_collectives``)."""
    import faulthandler

    import torch
    from repro_torch.core.masks import map_tree
    from repro_torch.core.structures import iter_leaves
    from repro_torch.data import LMPipeline, TokenTask
    from repro_torch.distributed import (axis_rules, distribute_tree, gather_tree,
                                         make_mesh, make_train_rules, use_mesh)
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.launch.specs import state_pspecs
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, constant_lr
    from repro_torch.train import init_train_state, make_train_step
    faulthandler.enable()
    dev = torch.device(spec["device"])
    mesh = make_mesh((1, 2), ("data", "model"), device_type=dev.type)
    cfg = mesh_config(spec)
    params = map_tree(lambda t: t.float(),
                      init_params(cfg, seed=spec["seed"], device=dev))
    cfg = cfg.replace(param_dtype="float32", activ_dtype="float32")
    opt = AdamWConfig(use_master=False, eps=1.0, weight_decay=0.0)
    step = make_train_step(cfg, opt, constant_lr(1.0))
    state = init_train_state(params, opt)
    dstate = distribute_tree(state, state_pspecs(state, mesh), mesh)
    if rank != 0:                      # rank 0 alone takes the plain step
        del state, params
    pipe = LMPipeline(TokenTask(vocab=cfg.vocab, seed=spec["seed"]),
                      spec["batch"], spec["seq"], device=dev, prefetch=0)
    batch = pipe.batch_at(0)
    dbatch = distribute_tree(batch, {k: ("data", None) for k in batch}, mesh)
    with use_mesh(mesh), axis_rules(make_train_rules(False)), \
            staged_collectives(torch) as staged:
        with CostCounter() as counter:                        # warm, counted
            step(dstate, dbatch)
        sync(torch)
        staged.seconds = 0.0
        t0 = time.perf_counter()
        new, metrics = step(dstate, dbatch)
        loss = float(metrics["loss"].full_tensor())
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        collective_ms = staged.seconds * 1e3
        got = gather_tree(new["params"])
    cuda = dev.type == "cuda"
    out = dict(loss=loss, ms=ms, collective_ms=collective_ms,
               collectives=counter.collective_counts(),
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    if rank == 0:
        del dstate, new
        if cuda:
            torch.cuda.empty_cache()
        want_state, want_metrics = step(state, batch)
        out["plain_loss"] = float(want_metrics["loss"])
        errs = {}
        want = dict(iter_leaves(want_state["params"]))
        for path, g in iter_leaves(got):
            w = want[path]
            errs[path] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        out["param_err"] = errs
    return out


def staged_collectives(torch):
    """A dispatch mode for phase 10 (b): every functional collective of
    the code under it (DTensor's) runs on host copies of its card inputs
    and its result goes back to the card, as gloo must run it for two
    ranks on one card (its CPU path; gloo does not take every collective
    on CUDA tensors), and is timed from a synchronised card to the
    result back on it (``.seconds``, ``.calls``)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    wait = torch.ops._c10d_functional.wait_tensor

    class Staged(TorchDispatchMode):
        seconds, calls = 0.0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = getattr(func, "_overloadpacket", func).__name__
            if getattr(func, "namespace", "") not in (
                    "_c10d_functional", "c10d_functional") or name == "wait_tensor":
                return func(*args, **kwargs)
            devs = [a.device for a in args if isinstance(a, torch.Tensor)]
            sync(torch)
            t0 = time.perf_counter()
            host = tree_map(lambda a: a.cpu() if isinstance(a, torch.Tensor) else a,
                            args)
            out = tree_map(lambda t: wait(t).to(devs[0]) if isinstance(
                t, torch.Tensor) else t, func(*host, **kwargs))
            sync(torch)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

    return Staged()


def mesh_fake_counts(spec):
    """The dry-run's trace of (a)'s cell on a fake group of one rank
    ((1, 1) mesh, fake CUDA tensors) in a child process: its counter's
    summary."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from chip_smoke import MESH, mesh_config\n"
        "from repro_torch.configs.base import ShapeCell\n"
        "from repro_torch.launch.dryrun import count_cell\n"
        f"spec = {dict(spec)!r}\n"
        "cell = ShapeCell('mesh_phase', 'train', spec['seq'], spec['batch'])\n"
        "out = count_cell(mesh_config(spec), cell, (1, 1), device=spec['device'])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"phase 10 (a): the dry-run's trace failed:\n"
                             f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def mesh_gate_single(a, fake, spec, gpu_line):
    """Phase 10 (a)'s gates and report: DTensor losses within phase 5's
    resume tolerance of the plain ones, the counter on the card equal to
    the dry-run's fake trace."""
    errs = [abs(x - y) / abs(y) for x, y in zip(a["sharded"], a["plain"])]
    if max(errs) > MESH_LOSS_TOL:
        raise AssertionError(f"phase 10 (a): DTensor losses {a['sharded']} vs "
                             f"plain {a['plain']} (relative {errs})")
    real = a["counts"]
    for key in ("flops", "bytes_accessed", "collectives"):
        if real[key] != fake[key]:
            raise AssertionError(f"phase 10 (a): the counter on the card "
                                 f"({key} {real[key]}) differs from the "
                                 f"dry-run's fake trace ({fake[key]})")
    share = a["device"]["busy_share"]
    log(f"  (a) {spec['arch']} full width (bf16, fp32 master, remat "
        f"{mesh_config(spec).remat!r}), B "
        f"{spec['batch']} x S {spec['seq']}, one NCCL rank, mesh (1, 1): "
        f"losses DTensor {[round(x, 6) for x in a['sharded']]} vs plain "
        f"{[round(x, 6) for x in a['plain']]} (worst relative {max(errs):.2e}, "
        f"gate {MESH_LOSS_TOL}); counter == dry-run trace: flops "
        f"{real['flops']:.6e}, bytes {real['bytes_accessed']:.6e}, "
        f"collectives {real['collectives']}")
    log(f"  (a) on {gpu_line}: ms per step (steps 2-{spec['steps']}) DTensor "
        f"{statistics.median(a['sharded_ms'][1:]):.1f} vs plain "
        f"{statistics.median(a['plain_ms'][1:]):.1f} (first step "
        f"{a['sharded_ms'][0]:.0f} / {a['plain_ms'][0]:.0f}); card busy "
        + (f"{100 * share:.1f}% of a DTensor step" if isinstance(share, float)
           else f"not measured ({a['device'].get('error')})")
        + f"; peak memory of a step {a['peak_bytes'] / 1e9:.2f} GB vs the "
        f"dry-run's predicted {fake['peak_bytes'] / 1e9:.2f} GB; the trace "
        f"took {fake['compile_s']:.1f}s")


def mesh_gate_pair(b):
    """Phase 10 (b)'s gates and report.  Returns (loss error, worst
    param error)."""
    b0 = b[0]
    loss_err = abs(b0["loss"] - b0["plain_loss"]) / abs(b0["plain_loss"])
    worst = max(b0["param_err"].values())
    if loss_err > MESH_TP_LOSS_TOL or worst > MESH_TP_PARAM_TOL:
        bad = sorted(b0["param_err"].items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"phase 10 (b): loss relative {loss_err:.3g}, "
                             f"params {bad}")
    if b[1]["loss"] != b0["loss"]:
        raise AssertionError(f"phase 10 (b): the ranks' losses differ: "
                             f"{b0['loss']} vs {b[1]['loss']}")
    log(f"  (b) fp32 step, two gloo ranks sharing the card, mesh (1, 2): loss "
        f"{b0['loss']:.6f} vs plain {b0['plain_loss']:.6f} (relative "
        f"{loss_err:.2e}, gate {MESH_TP_LOSS_TOL}); updated params worst "
        f"{worst:.2e} of a leaf's max over {len(b0['param_err'])} leaves (gate "
        f"{MESH_TP_PARAM_TOL}); collectives {b0['collectives']}; "
        f"{b0['ms']:.0f} ms per step, {b0['collective_ms']:.0f} ms of it in the "
        f"collectives ({100 * b0['collective_ms'] / b0['ms']:.1f}%; each staged "
        f"through the host for gloo, no NCCL figure); peak "
        f"{b0['peak_bytes'] / 1e9:.2f} GB a rank")
    return loss_err, worst


def mesh_path(torch, dev, gpu_line, spec=MESH):
    """Phase 10: (c) the dry-run of two archs on the 256-rank fake group
    (CPU only, child processes started first), (a) one NCCL rank, (b) two
    gloo ranks on the card; the gates and the report."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.distributed import run_ranks
    t0 = time.perf_counter()
    for arch in {spec["arch"], *MESH_DRYRUN["archs"]}:
        if get_config(arch).remat != "dots":
            raise AssertionError(f"phase 10: {arch} trains under remat "
                                 f"{get_config(arch).remat!r}, not 'dots'")
    OUT.mkdir(exist_ok=True)
    dry_out = OUT / "dryrun_phase10"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    dry = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", ",".join(MESH_DRYRUN["shapes"]), "--mesh", "single",
         "--out", str(dry_out), "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for arch in MESH_DRYRUN["archs"]}
    try:
        fake = mesh_fake_counts(spec)
        cuda = spec["device"] == "cuda"
        with tempfile.TemporaryDirectory(dir=OUT) as d:
            (a,) = run_ranks(mesh_single, 1, backend="nccl" if cuda else "gloo",
                             device_type=spec["device"],
                             init_file=Path(d) / "init_a", args=(spec,))
            mesh_gate_single(a, fake, spec, gpu_line)
            b = run_ranks(mesh_pair, 2, backend="gloo", device_type=spec["device"],
                          init_file=Path(d) / "init_b", args=(spec,))
            loss_err, worst = mesh_gate_pair(b)
        for arch, proc in dry.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"phase 10 (c): the dry-run of {arch} "
                                     f"failed:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    # (c) the dry-run's records
    cells = {}
    for arch in MESH_DRYRUN["archs"]:
        for shape in MESH_DRYRUN["shapes"]:
            rec = json.loads((dry_out / f"{arch}__{shape}__pod1.json").read_text())
            if rec.get("status") != "ok":
                raise AssertionError(f"phase 10 (c): {arch} {shape}: {rec}")
            cells[f"{arch}/{shape}"] = {k: rec[k] for k in (
                "dominant", "useful_ratio", "compute_s", "memory_s",
                "collective_s", "lower_s", "compile_s", "memory_stats")}
            log(f"  (c) dry-run {arch} {shape} on 256 fake ranks (16 x 16), "
                f"remat {get_config(arch).remat!r}: "
                f"dominant {rec['dominant']}, useful_ratio "
                f"{rec['useful_ratio']:.3f}, per-device peak "
                f"{rec['memory_stats']['peak_gb']:.2f} GB of the card's 80 GB, "
                f"trace {rec['compile_s']}s (state built and placed in "
                f"{rec['lower_s']}s)")
    secs = time.perf_counter() - t0
    log(f"  phase 10 took {secs:.1f}s on {gpu_line}")
    return dict(a={k: a[k] for k in ("plain", "plain_ms", "sharded", "sharded_ms",
                                     "counts", "peak_bytes", "device")},
                fake=fake, b=[{k: v for k, v in o.items() if k != "param_err"}
                              for o in b],
                b_worst_param_err=worst, b_loss_err=loss_err, c=cells,
                seconds=secs)


# ---------------------------------------------------------------------------
# phase 11: the analysis package — the lint, the host-sync meter, examples
# ---------------------------------------------------------------------------

def lint_run() -> dict:
    """(a) ``python -m repro_torch.analysis --fail-on-new --json`` in a
    child process from the repository root; it must exit 0."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--fail-on-new", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"phase 11 (a): the lint exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    rep = json.loads(proc.stdout)
    rep["wall_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  (a) lint: {rep['files_scanned']} files, {rep['findings']} findings "
        f"({rep['new']} new, {rep['baselined']} baselined, "
        f"{rep['inline_suppressed']} inline-suppressed, "
        f"{rep['stale_baseline_entries']} stale) {rep['by_rule']} in "
        f"{rep['runtime_ms']:.0f} ms ({rep['wall_ms']:.0f} ms with the child "
        "process)")
    return rep


def metered_pass(torch, eng, prompts, gen):
    """``serve_pass`` with the engine's run under
    ``no_host_sync(strict=True)`` and ``measure_pulls()``: the card is
    synchronised before and after the meter, never inside it."""
    from repro_torch.analysis import runtime as art
    from repro_torch.kernels import _build
    from repro_torch.serving import RequestStatus
    first = eng._next_rid
    ticks0, chunks0 = eng.decode_ticks, sum(eng.chunks_by_ticks.values())
    submit_traffic(eng, prompts, gen, sampled=True)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    regions0 = art.region_counts()
    t0 = time.perf_counter()
    with art.no_host_sync(strict=True), art.measure_pulls() as pulls:
        done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    regions = {k: v - regions0.get(k, 0) for k, v in art.region_counts().items()
               if v != regions0.get(k, 0)}
    mine = {rid: r for rid, r in done.items() if rid >= first}
    if len(mine) != len(prompts) or any(
            r.status is not RequestStatus.FINISHED or len(r.tokens) != gen
            for r in mine.values()):
        raise AssertionError("phase 11 (b): a metered stream failed or ended "
                             "short")
    emitted = sum(len(r.tokens) for r in mine.values())
    return dict(done=mine, seconds=dt, decode_ticks=eng.decode_ticks - ticks0,
                chunks=sum(eng.chunks_by_ticks.values()) - chunks0,
                admissions=len(mine), launches=dict(_build.launch_counts),
                tok_per_s=emitted / dt, pulls=dict(pulls), regions=regions)


def meter_run(torch, dev, gpu_line, qwen=None) -> dict:
    """(b) full-width qwen on the graphed engine: an unmetered engine
    (two warm-up streams, steady stream) and a metered one (two warm-up
    streams, steady stream under the meter), the same rids and keys in
    both.  Two warm-ups: the second stream's prefix hits on the first's
    prompts capture new ``(L, start)`` prefills; the third captures
    nothing, and every admission of it is a graph replay (gated)."""
    from repro_torch.serving import ServingEngine
    if qwen is None:
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        base = get_config("qwen1.5-0.5b")
        cfg = base.replace(param_dtype="float32", activ_dtype="float32")
        params, _ = serve.build_params(cfg, seed=0, device=dev, pruned=0.75,
                                       block=(128, 128), min_size=4096)
        qwen = (params, cfg, traffic(base.vocab, 0), 16)
    params, cfg, prompts, gen = qwen

    def engine():
        return ServingEngine(params, cfg, num_slots=4, page_size=8,
                             max_seq_len=max(len(p) for p in prompts) + gen,
                             ticks_per_sync=4, device=dev, cuda_graphs=True)

    plain = engine()
    for _ in range(2):                                          # captures
        serve_pass(torch, plain, prompts, gen, sampled=True)
    steady = serve_pass(torch, plain, prompts, gen, sampled=True)
    eng = engine()
    for _ in range(2):                                          # captures
        serve_pass(torch, eng, prompts, gen, sampled=True)
    before = eng.analysis_stats()
    run = metered_pass(torch, eng, prompts, gen)
    after = eng.analysis_stats()
    gate_launches("qwen1.5-0.5b", "phase 11 metered pass", cfg.n_layers, run)
    same_streams("phase 11 (b): metered vs unmetered streams", run["done"],
                 steady["done"])
    d_regions = {k: after["sync_regions"][k] - before["sync_regions"][k]
                 for k in after["sync_regions"]}
    failures = []
    if set(run["pulls"]) - {"admission", "decode_chunk"}:
        failures.append(f"pulls under other tags: {run['pulls']}")
    want = {"decode_chunk": run["chunks"], "admission": run["admissions"]}
    if d_regions != want:
        failures.append(f"engine regions {d_regions} != {want}")
    if run["regions"] != want:
        failures.append(f"process regions {run['regions']} != {want}")
    for key in ("compile_caches", "compile_events"):
        if after[key] != before[key]:
            failures.append(f"{key} {before[key]} -> {after[key]}")
    prefill_replays = (sum(after["prefill_replays"].values())
                       - sum(before["prefill_replays"].values()))
    if prefill_replays != run["admissions"]:
        failures.append(f"{prefill_replays} prefill replays for "
                        f"{run['admissions']} admissions")
    if failures:
        raise AssertionError("phase 11 (b): " + "; ".join(failures))
    rep = dict(tok_per_s_unmetered=steady["tok_per_s"],
               tok_per_s_metered=run["tok_per_s"],
               seconds_unmetered=steady["seconds"], seconds_metered=run["seconds"],
               chunks=run["chunks"], admissions=run["admissions"],
               decode_ticks=run["decode_ticks"], pulls=run["pulls"],
               regions=d_regions, compile_caches=after["compile_caches"],
               compile_events=after["compile_events"],
               variants=after["variants"], prefill_replays=prefill_replays,
               launches=run["launches"])
    log(f"  (b) meter: {run['admissions']} requests, {run['chunks']} chunks "
        f"({run['decode_ticks']} ticks) under no_host_sync(strict=True) + "
        f"sync-debug 'error': 0 stray pulls; pulls by tag {run['pulls']}; "
        f"regions {d_regions}; compile caches {after['compile_caches']} and "
        f"{after['compile_events']} compile events, unchanged; "
        f"{prefill_replays} admissions as prefill graph replays; streams == "
        f"unmetered; {run['tok_per_s']:.1f} tok/s metered vs "
        f"{steady['tok_per_s']:.1f} unmetered on {gpu_line}")
    return rep


def examples_run(torch, dev, gpu_line) -> dict:
    """(c) ``paper.serve_pruned`` and ``paper.train_lm_pruned`` (default
    size) on the card."""
    from repro_torch.kernels import _build
    from repro_torch.paper import serve_pruned, train_lm_pruned
    out = {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sp = serve_pruned.run(dev, log=lambda line: log(f"    {line}"))
    launches = dict(_build.launch_counts)
    if launches["bsr_matmul"] < 1:
        raise AssertionError("phase 11 (c): serve_pruned never launched "
                             "bsr_matmul")
    out["serve_pruned"] = dict(seconds=time.perf_counter() - t0,
                               launches=launches, kept=sp["kept"],
                               total=sp["total"],
                               recon_max_abs_err=sp["recon_max_abs_err"],
                               decode_max_abs_err=sp["decode_max_abs_err"])
    log(f"  (c) serve_pruned: kept {sp['kept']}/{sp['total']}, reconstruction "
        f"max |diff| {sp['recon_max_abs_err']:.3g}, decode step max |diff| "
        f"{sp['decode_max_abs_err']:.3g}, launches {launches}, "
        f"{out['serve_pruned']['seconds']:.1f}s")
    t0 = time.perf_counter()
    tr = train_lm_pruned.run(device=dev, log=lambda line: log(f"    {line}"))
    m = tr["result"]["metrics"]
    first, last = m[0]["total_loss"], m[-1]["total_loss"]
    if not last < first or not tr["logs"]:
        raise AssertionError(f"phase 11 (c): train_lm_pruned loss {first} -> "
                             f"{last}, {len(tr['logs'])} prune iterations")
    out["train_lm_pruned"] = dict(
        seconds=time.perf_counter() - t0, loss_first=first, loss_last=last,
        prune=[dict(iteration=it.iteration, metric=it.metric,
                    structure_sparsity=it.structure_sparsity)
               for it in tr["logs"]])
    log(f"  (c) train_lm_pruned: loss {first:.3f} -> {last:.3f}, "
        f"{len(tr['logs'])} prune iterations, "
        f"{out['train_lm_pruned']['seconds']:.1f}s on {gpu_line}")
    return out


def analysis_path(torch, dev, gpu_line, qwen=None) -> dict:
    """Phase 11: (a) the lint, (b) the meter at full width (on ``qwen`` =
    phase 3's (params, config, prompts, gen) when given), (c) the two
    examples."""
    t0 = time.perf_counter()
    rep = {"lint": lint_run()}
    t1 = time.perf_counter()
    rep["meter"] = meter_run(torch, dev, gpu_line, qwen)
    t2 = time.perf_counter()
    rep["examples"] = examples_run(torch, dev, gpu_line)
    rep["seconds"] = dict(lint=t1 - t0, meter=t2 - t1,
                          examples=time.perf_counter() - t2,
                          total=time.perf_counter() - t0)
    log(f"  phase 11 took {rep['seconds']['total']:.1f}s "
        f"(lint {rep['seconds']['lint']:.1f}, meter {rep['seconds']['meter']:.1f}, "
        f"examples {rep['seconds']['examples']:.1f})")
    return rep


# ---------------------------------------------------------------------------
# phase 4: times at the main paths' shapes
# ---------------------------------------------------------------------------

def report_row(row) -> None:
    REPORT["shapes"].append(row)
    desc = {k: row[k] for k in row if k not in (
        "name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err")}
    lib = row["library_ms"]
    log(f"  {row['name']} {desc}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max abs err "
        f"{row['max_abs_err']:.3g}")


def live_elems(flat_rows, flat_cols, z, k, n, bk, bn) -> int:
    """Weight elements inside (K, N) of the first z live tiles."""
    rr, cc = flat_rows[:z].long(), flat_cols[:z].long()
    return int(((k - rr * bk).clamp(max=bk) * (n - cc * bn).clamp(max=bn)).sum())


def epilogue_bytes(epi) -> int:
    if epi is None:
        return 0
    return sum(t.numel() * t.element_size() for t in
               (epi.bias, epi.multiplier, epi.residual) if t is not None)


def time_bsr(torch, timer, path, cap):
    from repro_torch.core import bsr_to_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import bsr_grid, bsr_matmul_plain
    rows = []
    for (phase, shape, kind), (x, bsr, epi) in sorted(cap.bsr.items()):
        m = x.numel() // shape[0]
        es = x.element_size()
        x2 = x.reshape(-1, shape[0])          # the plain version takes (M, K)
        epi2 = None if epi is None else epi.map_operands(
            lambda a: a.reshape(-1, a.shape[-1]))
        ms = timer(lambda: ops.bsr_matmul(x, bsr, epilogue=epi))
        plain = timer(lambda: bsr_matmul_plain(x2, bsr, epilogue=epi2),
                      reps=10, device_only=False)
        dense = bsr_to_dense(bsr)
        lib = timer(lambda: torch.matmul(x, dense))
        err = held("bsr_matmul",
                   ops.bsr_matmul(x, bsr, epilogue=epi).reshape(-1, shape[1]),
                   bsr_matmul_plain(x2, bsr, epilogue=epi2), TOL[dname(x.dtype)])
        bk, bn = bsr.blocking.bk, bsr.blocking.bn
        z = bsr.nnz_blocks
        grid, _, bm = bsr_grid(m, bsr, x.dtype)
        live = live_elems(bsr.flat_rows, bsr.flat_cols, z, *shape, bk, bn)
        nbytes = (m * shape[0] * es + z * bk * bn * es + bsr.indices.numel() * 8
                  + m * shape[1] * es + epilogue_bytes(epi))
        bnd, by = bound_ms(nbytes, 2.0 * m * live, dname(x.dtype))
        row = dict(name="bsr_matmul", path=path, phase=phase, m=m, k=shape[0],
                   n=shape[1], epilogue=kind, nnz_blocks=z, max_nnz=bsr.max_nnz,
                   grid=list(grid), ctas=grid[0] * grid[1] * grid[2], bm=bm, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                   max_abs_err=err)
        rows.append(row)
        report_row(row)
    return rows


def time_planes(torch, timer, path, cap):
    """Each captured planes call with the engine's row counts (the main
    path) and without them (every capacity row computed, as the reference
    does); the bound of each counts only what its rows need."""
    from repro_torch.core import bsr_to_dense
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.block_sparse_matmul import (
        bsr_planes_grid, bsr_planes_matmul_plain)
    smem = _build.library("bsr_planes_matmul").bsr_planes_smem_bytes
    smem.restype = ctypes.c_longlong
    dtype_code = {torch.float32: 0, torch.bfloat16: 1}
    rows = []
    for (phase, shape, kind), (x, planes, epi, counts) in sorted(cap.planes.items()):
        e, k, n = shape
        x3 = x.reshape(e, -1, k)              # the plain version takes (E, M, K)
        m = x3.shape[1]
        es = x.element_size()
        epi3 = None if epi is None else epi.map_operands(
            lambda a: a.reshape(e, -1, a.shape[-1]))
        cnt = counts.reshape(e, -1)
        ms = timer(lambda: ops.bsr_planes_matmul(x, planes, epilogue=epi,
                                                 row_counts=counts))
        ms_all = timer(lambda: ops.bsr_planes_matmul(x, planes, epilogue=epi))
        plain = timer(lambda: bsr_planes_matmul_plain(x3, planes, epilogue=epi3,
                                                      row_counts=cnt),
                      reps=10, device_only=False)
        dense = torch.stack([bsr_to_dense(p) for p in planes.planes])
        lib = timer(lambda: torch.bmm(x3, dense))
        err = held("bsr_planes_matmul",
                   ops.bsr_planes_matmul(x, planes, epilogue=epi,
                                         row_counts=counts).reshape(e, m, n),
                   bsr_planes_matmul_plain(x3, planes, epilogue=epi3,
                                           row_counts=cnt), TOL[dname(x.dtype)])
        held("bsr_planes_matmul (no counts)",
             ops.bsr_planes_matmul(x, planes, epilogue=epi).reshape(e, m, n),
             bsr_planes_matmul_plain(x3, planes, epilogue=epi3),
             TOL[dname(x.dtype)])
        bk, bn = planes.blocking.bk, planes.blocking.bn
        live = [live_elems(planes.flat_rows[p], planes.flat_cols[p],
                           planes.plane_nnz[p], k, n, bk, bn) for p in range(e)]
        rows_live = [int(v) for v in cnt.sum(dim=1)]
        fixed = planes.indices.numel() * 8 + e * m * n * es + epilogue_bytes(epi)

        def bound(rows_of, tiles_of):
            nbytes = (sum(rows_of) * k * es + fixed + sum(
                planes.plane_nnz[p] for p in range(e) if tiles_of[p])
                * bk * bn * es)
            return bound_ms(nbytes, 2.0 * sum(r * v for r, v in zip(rows_of, live)),
                            dname(x.dtype))
        bnd, by = bound(rows_live, rows_live)
        bnd_all, _ = bound([m] * e, [1] * e)
        grid, _, bm = bsr_planes_grid(m, cnt.shape[1], planes, x.dtype)
        row = dict(name="bsr_planes_matmul", path=path, phase=phase, e=e, m=m,
                   k=k, n=n, epilogue=kind, nnz_blocks=planes.nnz_blocks,
                   live_planes=sum(1 for v in planes.plane_nnz if v),
                   routed_planes=sum(1 for v in rows_live if v),
                   live_rows=sum(rows_live), segments=cnt.shape[1],
                   grid=list(grid), ctas=grid[0] * grid[1] * grid[2], bm=bm,
                   smem_bytes=smem(dtype_code[x.dtype], bm), ms=ms,
                   ms_no_counts=ms_all, plain_ms=plain, library_ms=lib,
                   bound_ms=bnd, bound_ms_no_counts=bnd_all, bound_by=by,
                   max_abs_err=err)
        rows.append(row)
        report_row(row)
    return rows


def time_decode(torch, timer, path, inputs):
    """One decode call: inputs (q, k_new, v_new, pools, page_table,
    cache_len), against SDPA on the gathered K/V."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.paged_attention import (
        decode_chunk, decode_grid, paged_attention_decode_plain)
    q, kn, vn, kp, vp, tbl, clen = inputs
    dev = q.device
    clen = clen.to(torch.int32)
    ms = timer(lambda: ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen))
    plain = timer(lambda: paged_attention_decode_plain(q, kn, vn, kp, vp, tbl, clen),
                  reps=10, device_only=False)
    err = held("paged_attention_decode",
               ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen),
               paged_attention_decode_plain(q, kn, vn, kp, vp, tbl, clen),
               ATTN_TOL)
    b, h, dh = q.shape
    kvh, ps = kn.shape[1], kp.shape[1]
    L = int(clen.max()) + 1
    pos = torch.arange(L, device=dev)
    pid = tbl.long()[:, (pos // ps).clamp(max=tbl.shape[1] - 1)]
    kc = kp[pid, (pos % ps)[None]].float()              # (B, L, K, dh)
    vc = vp[pid, (pos % ps)[None]].float()
    rows_b = torch.arange(b, device=dev)
    kc[rows_b, clen.long()] = kn.float()
    vc[rows_b, clen.long()] = vn.float()
    g = h // kvh
    kq = kc.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vq = vc.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    del kc, vc
    mask = (pos[None, :] <= clen[:, None].long())[:, None, None, :]
    q4 = q.float()[:, :, None, :]
    lib = timer(lambda: F.scaled_dot_product_attention(q4, kq, vq, attn_mask=mask))
    del kq, vq
    ctx = int(clen.long().sum())
    es_q, es_p = q.element_size(), kp.element_size()
    nbytes = (b * h * dh * es_q + 2 * b * kvh * dh * es_q + 2 * ctx * kvh * dh * es_p
              + 4 * (b + int(((clen + ps - 1) // ps).sum())) + b * h * dh * 4)
    bnd, by = bound_ms(nbytes, 4.0 * (ctx + b) * h * dh, "float32")
    grid = decode_grid(b, kvh, ps, dh, tbl.shape[1])
    smem = _build.library("paged_attention_decode").paged_decode_smem_bytes
    smem.restype = ctypes.c_longlong
    row = dict(name="paged_attention_decode", path=path, b=b, h=h, kvh=kvh,
               dh=dh, ps=ps, dtype=dname(q.dtype), pool_dtype=dname(kp.dtype),
               cache_len=[int(v) for v in clen], max_pages=tbl.shape[1],
               chunk=decode_chunk(ps, dh), grid=list(grid),
               cluster=grid[0], ctas=grid[0] * grid[1] * grid[2],
               smem_bytes=smem(h // kvh, decode_chunk(ps, dh), dh, es_p, grid[0]),
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               max_abs_err=err)
    report_row(row)
    return [row]


def long_contexts(torch, dev):
    """Decode at contexts users reach beyond the smoke traffic: B 4 rows
    of cache_len 512 and 2048 at qwen's heads (16/16, head_dim 64), page
    sizes 8 and 16, fp32, NaN in every slot no row owns."""
    out = []
    for ps in (8, 16):
        for ctx in (512, 2048):
            g = torch.Generator(device=dev).manual_seed(ps + ctx)
            clen = torch.full((4,), ctx, dtype=torch.int32, device=dev)
            kp, vp, tbl = poisoned_pools(torch, g, dev, 4, 16, 64, ps,
                                         ctx // ps + 1, clen, torch.float32)
            q, kn, vn = (torch.randn((4, 16, 64), generator=g, device=dev)
                         for _ in range(3))
            out.append((q, kn, vn, kp, vp, tbl, clen))
    return out


def time_prefill(torch, timer, path, cap):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (
        paged_attention_prefill_plain, prefill_grid)
    rows = []
    for hit, (qp, kp2, vp2, tbl2, lens, q_offset) in sorted(cap.prefill.items()):
        dev = qp.device
        lens = lens.to(torch.int32)
        ms = timer(lambda: ops.paged_attention_prefill(qp, kp2, vp2, tbl2, lens,
                                                       q_offset=q_offset))
        plain = timer(lambda: paged_attention_prefill_plain(
            qp, kp2, vp2, tbl2, lens, q_offset=q_offset), reps=10,
            device_only=False)
        err = held("paged_attention_prefill",
                   ops.paged_attention_prefill(qp, kp2, vp2, tbl2, lens,
                                               q_offset=q_offset),
                   paged_attention_prefill_plain(qp, kp2, vp2, tbl2, lens,
                                                 q_offset=q_offset), ATTN_TOL)
        b, s, h, dh = qp.shape
        kvh, ps = kp2.shape[2], kp2.shape[1]
        tot = int(lens.max())
        pos = torch.arange(tot, device=dev)
        pid = tbl2.long()[:, pos // ps]
        kc = kp2[pid, (pos % ps)[None]].float()
        vc = vp2[pid, (pos % ps)[None]].float()
        g = h // kvh
        kq = kc.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vq = vc.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        qpos = q_offset + torch.arange(s, device=dev)
        mask = ((pos[None, None, :] <= qpos[None, :, None])
                & (pos[None, None, :] < lens.long()[:, None, None]))[:, None]
        q4 = qp.float().transpose(1, 2).contiguous()
        lib = timer(lambda: F.scaled_dot_product_attention(q4, kq, vq, attn_mask=mask))
        lens_l = [int(v) for v in lens]
        pairs = sum(min(q_offset + i, ln - 1) + 1
                    for ln in lens_l for i in range(s) if q_offset + i < ln)
        nbytes = (qp.numel() * qp.element_size()
                  + 2 * sum(lens_l) * kvh * dh * kp2.element_size()
                  + qp.numel() * 4 + 4 * (tbl2.numel() + b))
        bnd, by = bound_ms(nbytes, 4.0 * pairs * h * dh, "float32")
        grid = prefill_grid(b, s, h, kvh)
        row = dict(name="paged_attention_prefill", path=path, b=b, s=s, h=h,
                   kvh=kvh, dh=dh, ps=ps, q_offset=q_offset, lengths=lens_l,
                   ctas=grid[0] * grid[1] * grid[2], ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bound_by=by, max_abs_err=err)
        rows.append(row)
        report_row(row)
    return rows


def long_prompts(torch, dev):
    """Prompt lengths users send beyond the smoke traffic, at qwen's heads
    (16/16, head_dim 64, page size 8), fp32: S 512 at q_offset 0 and S 256
    at q_offset 256 (the tail of a 512-token context after a prefix hit).
    Shaped like ``Capture.prefill`` for ``time_prefill``."""
    from types import SimpleNamespace
    g = torch.Generator(device=dev).manual_seed(13)
    pre = {}
    for q_offset, s in ((0, 512), (256, 256)):
        lens = torch.tensor([q_offset + s], dtype=torch.int32, device=dev)
        kp, vp, tbl = poisoned_pools(torch, g, dev, 1, 16, 64, 8, 65, lens,
                                     torch.float32)
        q = torch.randn((1, s, 16, 64), generator=g, device=dev)
        pre[q_offset > 0] = (q, kp, vp, tbl, lens, q_offset)
    return SimpleNamespace(prefill=pre)


def time_norms(torch, timer, dev):
    """Off every path (as in the reference): timed at granite's
    experts_up as (E * K, N) = (32768, 512) with 128x128 tiles (the
    knapsack's per-expert-tile norms), fp32 as in run (a)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.structure_norms import structure_norms_plain
    g = torch.Generator(device=dev).manual_seed(11)
    k, n, bk, bn = 32 * 1024, 512, 128, 128
    w = torch.randn((k, n), generator=g, device=dev)
    ms = timer(lambda: ops.structure_norms(w, bk, bn))
    plain = timer(lambda: structure_norms_plain(w, bk, bn), reps=10,
                  device_only=False)
    view = w.view(k // bk, bk, n // bn, bn)
    lib = timer(lambda: torch.linalg.vector_norm(view, dim=(1, 3)))
    err = held("structure_norms", ops.structure_norms(w, bk, bn),
               structure_norms_plain(w, bk, bn), TOL["float32"])
    gk, gn = k // bk, n // bn
    bnd, by = bound_ms(k * n * 4 + gk * gn * 4, 2.0 * k * n, "float32")
    row = dict(name="structure_norms", path="none (pruning-time kernel)", k=k,
               n=n, bk=bk, bn=bn, dtype="float32", ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)
    report_row(row)
    return row


SOURCES = {
    "bsr_matmul": ("src/repro_torch/csrc/bsr_matmul.cu",
                   "src/repro/kernels/block_sparse_matmul.py:77"),
    "paged_attention_decode": ("src/repro_torch/csrc/paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:146"),
    "paged_attention_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_attention.py:324"),
    "bsr_planes_matmul": ("src/repro_torch/csrc/bsr_planes_matmul.cu",
                          "src/repro/kernels/block_sparse_matmul.py:178"),
    "structure_norms": ("src/repro_torch/csrc/structure_norms.cu",
                        "src/repro/kernels/structure_norms.py:20"),
}


def timings(torch, dev, caps, launches, paper_launches, jamba_launches,
            family_launches, a2a_launches):
    """Every kernel at the captured shapes of each path; returns the
    ``kernels`` line (one headline shape per kernel, launches summed
    over the paths' runs (a) and phase 5; then ``bsr_matmul`` at the
    paper models' packed fc_1, launches over phase 6; then the four
    kernels of jamba's path at its shapes, launches over its graphed
    fp32 pass in phase 7; then phase 8's: the BSR kernel at whisper's
    encoder w_up (gelu alone, M 6000), launches over its fp32 run, and
    qwen2-vl's BSR decode up/gate, paged decode and prefill at G 6,
    launches over its graphed fp32 steady pass; then phase 9's planes
    kernel at the all-to-all's expert buffers, (32, 512) at m = 1 and
    (16, 1024) at m = 2, granite's up projection (1024 -> 512), launches
    over the counted lm_forward + lm_prefill of (a) and of (b)'s rank 0)."""
    from repro_torch.kernels import _build
    timer = Timer(dev)
    one = torch.zeros(1, device=dev)
    floor = timer(lambda: one.add_(1))
    REPORT["timer_floor_ms"] = floor
    log(f"  timer floor (a one-element add_ after the L2 flush): {floor:.4f} ms")
    rows = []
    for path, cap in caps.items():
        rows += time_bsr(torch, timer, path, cap)
        rows += time_planes(torch, timer, path, cap)
        if cap.decode is not None:
            rows += time_decode(torch, timer, path, cap.decode[1])
        rows += time_prefill(torch, timer, path, cap)
    rows += time_prefill(torch, timer, "qwen1.5-0.5b, long prompts",
                         long_prompts(torch, dev))
    for inputs in long_contexts(torch, dev):
        rows += time_decode(torch, timer, "qwen1.5-0.5b heads, long contexts",
                            inputs)
    rows.append(time_norms(torch, timer, dev))
    # the redesigned kernels' registers, spills and static shared memory
    logs = _build.build_logs()
    REPORT["ptxas"] = {}
    for name in ("bsr_planes_matmul", "paged_attention_decode"):
        lines = [f"{entry}: {line}" for entry, line in ptxas_lines(logs[name])]
        REPORT["ptxas"][name] = lines
        for line in lines:
            log(f"  ptxas {name}: {line}")

    def pick(name, **want):
        cands = [r for r in rows if r["name"] == name
                 and r.get("path") == want.get("path", r.get("path"))]
        for r in cands:
            if all(r.get(k) == v for k, v in want.items()):
                return r
        return max(cands, key=lambda r: r["ms"])

    def longest_prefill(path):
        return max((r for r in rows if r["name"] == "paged_attention_prefill"
                    and r["path"] == path), key=lambda r: r["s"])

    heads = [
        # the largest decode call of each path's BSR kernels
        pick("bsr_matmul", path="qwen1.5-0.5b", phase="decode", k=1024, n=2816,
             epilogue="silu+mult"),
        pick("paged_attention_decode", path="granite-moe-1b-a400m"),
        longest_prefill("granite-moe-1b-a400m"),
        pick("bsr_planes_matmul", phase="decode", k=1024, n=512, epilogue="none"),
        pick("structure_norms"),
    ]
    # jamba's decode-tick calls of the up/gate shapes, its attention layer
    jamba_heads = [
        pick("bsr_matmul", path=JAMBA_PATH, phase="decode", k=4096, n=14336,
             epilogue="silu+mult"),
        pick("bsr_planes_matmul", path=JAMBA_PATH, phase="decode", k=4096,
             n=14336, epilogue="none"),
        pick("paged_attention_decode", path=JAMBA_PATH),
        longest_prefill(JAMBA_PATH),
    ]
    # phase 8: whisper's encoder w_up, qwen2-vl's decode up/gate and its
    # G 6 attention
    family_heads = [
        pick("bsr_matmul", path=WHISPER_PATH, phase="prefill", k=384, n=1536,
             epilogue="gelu"),
        pick("bsr_matmul", path=VLM_PATH, phase="decode", k=1536, n=8960,
             epilogue="silu+mult"),
        pick("paged_attention_decode", path=VLM_PATH),
        longest_prefill(VLM_PATH),
    ]
    a2a_heads = [pick("bsr_planes_matmul", path=path, k=1024, n=512,
                      epilogue="none") for path in A2A_PATHS.values()]
    paper_heads = []
    for path, k, n in PAPER_TIMED:
        found = [r for r in rows if r["name"] == "bsr_matmul"
                 and r["path"] == path and (r["k"], r["n"]) == (k, n)]
        if not found:
            raise AssertionError(f"phase 4: no bsr_matmul captured at {path} "
                                 f"{k}->{n}")
        paper_heads.append(found[0])
    out = []
    for r, counts in ([(r, launches) for r in heads]
                      + [(r, {"paper (phase 6)": paper_launches})
                         for r in paper_heads]
                      + [(r, {JAMBA_PATH: jamba_launches})
                         for r in jamba_heads]
                      + [(r, {r["path"]: family_launches[r["path"]]})
                         for r in family_heads]
                      + [(r, {r["path"]: a2a_launches[r["path"]]})
                         for r in a2a_heads]):
        src, rep = SOURCES[r["name"]]
        by_path = {p: n.get(r["name"], 0) for p, n in counts.items()}
        out.append(dict(name=r["name"], route="cuda", source=src, replaces=rep,
                        launches=sum(by_path.values()),
                        launches_by_path=by_path, path=r.get("path"),
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=r["library_ms"]))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from the repository root", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 parity: no TF32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    gpu_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    log(gpu_line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"phase 1: built {len(_build.SOURCES)} CUDA kernels in {secs:.1f}s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in _build.build_logs().items():
        for entry, line in ptxas_lines(text):
            log(f"  {name}: {entry}: {line}")

    log("phase 2: kernels against their plain versions")
    check_bsr(torch, dev)
    check_planes(torch, dev)
    check_planes_counts(torch, dev)
    check_planes_a2a(torch, dev)
    check_attention(torch, dev)
    check_decode_chunks(torch, dev)
    check_norms(torch, dev)
    check_router(torch, dev)
    wide = [(name, bsr_layout(torch, torch.Generator(device=dev).manual_seed(j),
                              dev, *spec, torch.float32))
            for j, (name, spec) in enumerate(BSR_WIDE_COLUMNS.items())]
    n_bsr = check_bsr_invariance(torch, dev, wide)
    n_pre = check_prefill_invariance(torch, dev)
    n_pl = check_planes_invariance(torch, dev)
    n_dec = check_decode_invariance(torch, dev)
    paper_layouts = check_bsr_paper(torch, dev)
    n_paper = check_bsr_invariance(torch, dev, paper_layouts)
    log(f"  batch invariance (fp32, gated): bsr_matmul rows bit-identical "
        f"alone and in M 4/47/200 on the {n_paper} paper layouts")
    log(f"  batch invariance (fp32, gated): bsr_matmul rows bit-identical "
        f"alone and in M 4/47/200 on {n_bsr} layouts {[n for n, _ in wide]}; "
        f"paged prefill positions bit-identical in full, tail (q_offset 3 ps) "
        f"and ragged-batch calls in {n_pre} cases; bsr_planes_matmul rows "
        f"bit-identical at M 1/8/47 and with/without row counts on {n_pl} "
        f"expert shapes; paged decode rows bit-identical alone, in a ragged "
        f"batch of 5 and with a 4x wider table in {n_dec} cases")
    log(f"  phase 2 done at {time.perf_counter() - t_start:.1f}s")

    paths = {}
    for arch, cf_a in (("qwen1.5-0.5b", None), ("granite-moe-1b-a400m", 4.0)):
        log(f"phase 3: main path, {arch} full width, knapsack 0.75, BSR 128x128")
        paths[arch] = list(main_path(torch, dev, gpu_line, arch, cf_a=cf_a))
        log(f"  {arch} done at {time.perf_counter() - t_start:.1f}s")
        if arch == "qwen1.5-0.5b":
            # the batch-invariance gate of phase 2 on the real pruned layouts
            real = [(f"{arch} {shape[0]}x{shape[1]} {kind}", bsr)
                    for (phase, shape, kind), (_, bsr, _) in
                    sorted(paths[arch][2].bsr.items()) if phase == "decode"]
            check_bsr_invariance(torch, dev, real)
            log(f"  batch invariance (fp32, gated): bsr_matmul rows "
                f"bit-identical alone and in M 4/47/200 on qwen's {len(real)} "
                f"knapsack-pruned layouts "
                f"{[(b.shape, b.max_nnz) for _, b in real]}")

    serving = serving_runs(torch, dev, gpu_line, paths)
    log("phase 11: the analysis package: (a) the lint, (b) the host-sync "
        "meter on qwen1.5-0.5b full width, graphed, (c) the two remaining "
        "examples")
    analysis_rep = analysis_path(torch, dev, gpu_line,
                                 paths["qwen1.5-0.5b"][4])
    log(f"  phase 11 done at {time.perf_counter() - t_start:.1f}s")
    qwen_fixed = paths["qwen1.5-0.5b"][4][:2]     # for phase 8's fixed batch
    for p in paths.values():
        del p[4]
    torch.cuda.empty_cache()

    log(f"phase 5: train, knapsack-prune (Algorithm 2), pack and serve "
        f"{TRAIN['arch']} at full width")
    train_rep, train_caps, train_launches = train_path(torch, dev, gpu_line)
    log(f"  phase 5 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 6: the paper's experiments (Tables II, III and V at full "
        "settings) and the packed models through the BSR kernel")
    paper_rep, paper_caps, paper_launches = paper_path(torch, dev, gpu_line)
    log(f"  phase 6 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 7: the recurrent and hybrid stacks through the paged engine: "
        f"jamba-v0.1-52b ({JAMBA_LAYERS} layers, one period, full width, "
        "knapsack 0.75 at 128x128) and xlstm-350m (whole, dense)")
    recurrent_rep, recurrent_launches, recurrent_cap = recurrent_path(
        torch, dev, gpu_line)
    log(f"  phase 7 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 8: the encoder-decoder and multimodal families: whisper-tiny "
        "(fixed batch, encoder + cross-attention) and qwen2-vl-2b (M-RoPE, "
        "1024 patch embeddings, then the paged engine), full width, knapsack "
        "0.75 at 128x128")
    family_rep, family_launches, family_caps = family_path(torch, dev, gpu_line,
                                                           qwen_fixed)
    del qwen_fixed
    log(f"  phase 8 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 9: the expert-parallel MoE through the all-to-all: "
        "granite-moe-1b-a400m full width, knapsack 0.75 at 128x128, fp32, "
        "cf 4.0; (a) m=1 over NCCL, (b) m=2 as two ranks on the card over "
        "gloo, (c) the engine under the mesh")
    a2a_rep, a2a_launches, a2a_caps = a2a_path(torch, dev, gpu_line)
    log(f"  phase 9 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 10: the sharded program (DTensor placements over a (data, "
        "model) mesh) and its dry-run: (a) qwen1.5-0.5b train steps on one "
        "NCCL rank, (b) a tensor-parallel fp32 step on two gloo ranks, (c) "
        "the dry-run on a 256-rank fake group")
    mesh_rep = mesh_path(torch, dev, gpu_line)
    log(f"  phase 10 done at {time.perf_counter() - t_start:.1f}s")

    log("phase 4: kernel times at the main paths' shapes (CUDA events)")
    caps = {a: p[2] for a, p in paths.items()}
    launches = {a: p[3] for a, p in paths.items()}
    train_name = f"{TRAIN['arch']} trained+pruned"
    launches[train_name] = train_launches
    for dtype, cap in train_caps.items():
        caps[f"{train_name}, lm_forward {dtype}"] = cap
    caps.update(paper_caps)
    caps[JAMBA_PATH] = recurrent_cap
    caps.update(family_caps)
    caps.update(a2a_caps)
    kernels = timings(torch, dev, caps, launches, paper_launches,
                      recurrent_launches, family_launches, a2a_launches)

    REPORT.update(gpu=gpu_line, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=secs,
                  main_paths={a: {"fp32": p[0], "config_dtype": p[1]}
                              for a, p in paths.items()},
                  serving=serving, train_path=train_rep, paper_path=paper_rep,
                  recurrent_path=recurrent_rep, family_path=family_rep,
                  a2a_path=a2a_rep, mesh_path=mesh_rep,
                  analysis_path=analysis_rep,
                  kernels=kernels, seconds=time.perf_counter() - t_start)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    log(f"done in {time.perf_counter() - t_start:.1f}s; details in "
        f"{(OUT / 'chip_smoke.json').relative_to(ROOT)}")
    log(gpu_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
