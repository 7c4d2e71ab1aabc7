"""How a served model's tokens are judged against a plain reference,
and the control's reading on the same tokens.

For each request in the judged sample the reference runs once over its
prompt and its served tokens.  The logits at the position before each
served token are the reference's view of that choice.  A token's gap is
how far its logit there lies below the edge of what the request may
pick: the reference's best logit for a greedy token (and for the first
token of any request, which admission picks by argmax), the ``top_k``-th
best for a sampled one (temperature and top-p only narrow that set
further, so a sound sampler never picks below it).  A run reads the
widest gap over every compared token.  The control reads, at the same
positions, the gap below the best of the token that the lower-precision
weights put first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["served_gaps", "control_gaps", "sample_requests"]


def _positions(prompt: np.ndarray, served: np.ndarray):
    seq = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    first = len(prompt) - 1                 # logits there pick served[0]
    return seq, first


@torch.no_grad()
def served_gaps(forward: Callable[[torch.Tensor], torch.Tensor],
                requests: Sequence[Dict], device) -> List[float]:
    """Widest gap of each request's served tokens under ``forward``
    (token ids (S,) -> fp32 logits (S, V)): below the best logit for a
    greedy request and every first token, below the ``top_k``-th best
    (``r["top_k"]``) for a sampled request's later tokens."""
    out = []
    for r in requests:
        seq, first = _positions(r["prompt"], r["served"])
        logits = forward(torch.as_tensor(seq, device=device))[first:]
        tok = torch.as_tensor(np.asarray(r["served"], np.int64), device=device)
        edge = logits.max(dim=-1).values
        k = r.get("top_k")
        if k and len(edge) > 1:
            edge[1:] = torch.topk(logits[1:], int(k), dim=-1).values[:, -1]
        gap = (edge - logits.gather(1, tok[:, None])[:, 0]).clamp_min(0.0)
        out.append(float(gap.max()))
        del logits
    return out


@torch.no_grad()
def control_gaps(forward: Callable[[torch.Tensor], torch.Tensor],
                 lower: Callable[[torch.Tensor], torch.Tensor],
                 requests: Sequence[Dict], device) -> List[float]:
    """Widest gap, in ``forward``'s logits, of the tokens that ``lower``
    puts first at the same positions of each request."""
    out = []
    for r in requests:
        seq, first = _positions(r["prompt"], r["served"])
        ids = torch.as_tensor(seq, device=device)
        want = forward(ids)[first:]
        pick = lower(ids)[first:].argmax(dim=-1)
        gap = want.max(dim=-1).values - want.gather(1, pick[:, None])[:, 0]
        out.append(float(gap.max()))
        del want
    return out


def _draw(pool: List[Dict], rng: np.random.Generator, count: int,
          min_tokens: int) -> List[Dict]:
    """The request with the most served tokens, then others drawn by
    ``rng`` until ``count`` requests and ``min_tokens`` served tokens are
    reached (or none are left)."""
    if not pool or count <= 0:
        return []
    longest = max(range(len(pool)), key=lambda i: (len(pool[i]["served"]), -i))
    rest = [pool[i] for i in rng.permutation(len(pool)) if i != longest]
    picked = [pool[longest]]
    for r in rest:
        if len(picked) >= count and sum(len(p["served"]) for p in picked) >= min_tokens:
            break
        picked.append(r)
    return picked


def sample_requests(done: Sequence[Dict], rng: np.random.Generator, *,
                    count: int, min_tokens: int, sampled: int = 0) -> List[Dict]:
    """The finished requests to judge: ``count`` greedy ones holding at
    least ``min_tokens`` served tokens, and ``sampled`` sampled ones, each
    group led by its longest request and the rest drawn by ``rng``."""
    greedy = _draw([r for r in done if r["greedy"]], rng, count, min_tokens)
    return greedy + _draw([r for r in done if not r["greedy"]], rng, sampled, 0)
