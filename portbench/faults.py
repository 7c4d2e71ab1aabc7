"""Faults planted in the port's timed path, each where it would arise,
to show that a run's judgement reads them as not correct.  Each fault is
``fault(patch, vocab)`` where ``patch(owner, name, value)`` replaces an
attribute until the caller restores it (pytest's ``monkeypatch.setattr``,
or :class:`Patcher`).

Serving: a decode token or a prefill's first token altered where it is
produced, and a decode step that leaves the cache unchanged (its K/V
never written); where the mix samples, a sampler that ignores
``top_k``.  Training: a step that returns its state unchanged, half
of the batch left out of the loss (the mean over the rest), and the
answers (labels) altered.  One card holds no exchange between cards to
leave out.
"""
from __future__ import annotations

from . import program


def _port():
    program.import_port()
    import repro_torch.models.transformer as tm
    import repro_torch.serving.engine as em
    import repro_torch.train.train_step as ts
    return tm, em, ts


def decode_token_altered(patch, vocab):
    _, em, _ = _port()
    orig = em._decode_chunk

    def bad(*a, **kw):
        toks, counts, flags, tok, clen, rngs = orig(*a, **kw)
        return (toks + 1) % vocab, counts, flags, tok, clen, rngs

    patch(em, "_decode_chunk", bad)


def first_token_altered(patch, vocab):
    _, em, _ = _port()
    orig = em._paged_prefill_step

    def bad(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0] = (out[0] + 1) % vocab
        return out

    patch(em, "_paged_prefill_step", bad)


def cache_left_unchanged(patch, vocab):
    tm, _, _ = _port()
    orig = tm.attention_decode

    def bad(p, x, cache, *a, **kw):
        copy = {k: v.clone() for k, v in cache.items()}
        out, _ = orig(p, x, copy, *a, **kw)
        return out, cache

    patch(tm, "attention_decode", bad)


def sampler_ignores_top_k(patch, vocab):
    _, em, _ = _port()
    orig = em._select_token_rows

    def bad(logits, rngs, temperature, top_k, top_p):
        return orig(logits, rngs, temperature, top_k.new_zeros(top_k.shape), top_p)

    patch(em, "_select_token_rows", bad)


def state_unchanged(patch, vocab):
    _, _, ts = _port()
    patch(ts, "adamw_update_", lambda *a, **kw: None)
    patch(ts, "adamw_update", lambda params, grads, state, *a, **kw: (params, state))


def half_batch(patch, vocab):
    _, _, ts = _port()
    orig = ts.cross_entropy_loss

    def bad(logits, labels, **kw):
        half = logits.shape[0] // 2
        return orig(logits[:half], labels[:half], **kw)

    patch(ts, "cross_entropy_loss", bad)


def labels_altered(patch, vocab):
    _, _, ts = _port()
    orig = ts.cross_entropy_loss
    patch(ts, "cross_entropy_loss",
          lambda logits, labels, **kw: orig(logits, (labels + 1) % vocab, **kw))


SERVING = {"decode_token_altered": decode_token_altered,
           "first_token_altered": first_token_altered,
           "cache_left_unchanged": cache_left_unchanged}
SAMPLING = {"sampler_ignores_top_k": sampler_ignores_top_k}
TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "labels_altered": labels_altered}


class Patcher:
    """``patch(owner, name, value)`` that :meth:`restore` undoes."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)
