"""The port's engine on recurrent and hybrid stacks, against the JAX
package, on the CPU.

The jamba and xLSTM smoke models at 8 layers (so jamba has its attention
layer and xLSTM its sLSTM layer), with JAX-initialised params carried
over by ``repro_torch.bridge``:

* ``ServingEngine`` streams, join ticks and statuses equal the JAX
  engine's on the same requests (jamba dense and knapsack-pruned, xLSTM
  dense), with prefix caching reported off in both;
* at jamba's published 16 experts, a decode row past an expert's
  capacity drops over 4 slots (so a stream leaves its solo decode) the
  same in both engines, and over 2 slots none does;
* a cancel mid-stream and a chunk failure (snapshot restore, degraded
  single-tick chunks) leave every other stream equal to its solo decode;
* a prefill quarantined for non-finite logits leaves NaN in its slot's
  recurrent row, and the next request admitted to that slot starts from
  the initial state;
* a chunk that raises after it started is unrecoverable on a recurrent
  stack (its state advanced in place);
* the launcher serves both archs, and ``--pruned`` on xlstm-350m raises
  the reference's ``ValueError``.

The JAX engine's pools are copied before it serves xLSTM: the
reference's ``init_slstm_cache`` returns one buffer for ``c`` and ``h``,
which its engine then donates twice (``ROADMAP.md`` §3, finding 4).
Greedy tokens are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.models import init_params as jinit_params
from repro.serving import ServingEngine as JServingEngine
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.launch import serve
from repro_torch.serving import (FaultInjector, RequestStatus, ServingEngine,
                                 chunk_exception)

from chip_smoke import EMBED_SCALE, distinct_enough

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow the engine runs here many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(arch, packed=False):
    """(jax cfg, torch cfg, jax params, torch params); jamba at capacity
    factor E/k = 2.0, where no slot drops, so streams equal solo decode.
    The tied embedding is scaled by the chip smoke's ``EMBED_SCALE``: at
    its init scale the residual stream is the token's own embedding and
    every greedy stream repeats one token, whatever the recurrent state
    holds."""
    key = (arch, packed)
    if key not in _CACHE:
        kw = {"capacity_factor": 2.0} if arch.startswith("jamba") else {}
        jcfg = jmake_smoke(jget_config(arch), n_layers=8, **kw)
        cfg = make_smoke(get_config(arch), n_layers=8, **kw)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"] * EMBED_SCALE}}
        if packed:
            sel = jknapsack_prune(jp, sparsity=0.5, blocking=JBlockingSpec(bk=32, bn=32),
                                  min_size=1024)
            jp = jpack_params(jp, sel.masks, sel.structures)
        _CACHE[key] = (jcfg, cfg, jp, params_from_reference(jp))
    return _CACHE[key]


def _prompts(vocab, seed, lens=(5, 9, 5, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _jax_engine(jp, jcfg, **kw):
    eng = JServingEngine(jp, jcfg, **kw)
    # distinct buffers for every cache leaf (the sLSTM cache aliases c/h)
    eng.caches = jax.tree_util.tree_map(lambda t: jnp.array(t, copy=True),
                                        eng.caches)
    return eng


@pytest.mark.parametrize("arch,packed,ticks", [("jamba-v0.1-52b", True, 4),
                                               ("jamba-v0.1-52b", False, 1),
                                               ("xlstm-350m", False, 3)])
def test_engine_streams_match_reference_engine(arch, packed, ticks):
    jcfg, cfg, jp, tp = _pair(arch, packed)
    prompts = _prompts(cfg.vocab, ticks)
    prompts[1] = prompts[0].copy()            # a repeated prompt: no hit here
    gens, arrivals = [6, 4, 5, 6], [0, 0, 2, 5]
    kw = dict(num_slots=2, page_size=4, max_seq_len=20, ticks_per_sync=ticks)
    runs = {}
    for name, eng in (("jax", _jax_engine(jp, jcfg, **kw)),
                      ("torch", ServingEngine(tp, cfg, device="cpu", **kw))):
        for p, g, a in zip(prompts, gens, arrivals):
            eng.submit(p, g, arrival=a)
        done = eng.run()
        runs[name] = ([done[i].tokens.tolist() for i in range(4)],
                      [done[i].admitted_at for i in range(4)],
                      eng.prefix_stats["enabled"], eng.prefix_stats["hit_requests"])
        assert all(r.status.value == "finished" for r in done.values())
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][2:] == (0, 0)                 # prefix caching off
    assert [len(s) for s in runs["torch"][0]] == gens
    assert all(distinct_enough(s) for s in runs["torch"][0])


def test_decode_capacity_drops_a_row_as_the_reference_engine_does():
    """jamba's experts at their published count, 16 top-2: decode routes
    at ``moe_decode``'s fixed capacity factor 2.0, so each expert holds
    max(ceil(n 2 2 / 16), 2) = 2 of the decode rows.  Over 4 slots a
    third row routed to one expert drops and its stream leaves its solo
    decode, the same in both engines; over 2 slots no row can drop."""
    kw = dict(moe_experts=16, capacity_factor=8.0)
    jcfg = jmake_smoke(jget_config("jamba-v0.1-52b"), n_layers=8, **kw)
    cfg = make_smoke(get_config("jamba-v0.1-52b"), n_layers=8, **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"] * EMBED_SCALE}}
    tp = params_from_reference(jp)
    prompts = _prompts(cfg.vocab, 4, lens=(5, 9, 5, 9, 6, 7))
    solo = [serve.solo_decode(tp, cfg, p, 8, device="cpu").tolist() for p in prompts]
    streams = {}
    for name, slots in (("jax", 4), ("torch", 4), ("torch", 2)):
        kw = dict(num_slots=slots, page_size=4, max_seq_len=20, ticks_per_sync=4)
        eng = (_jax_engine(jp, jcfg, **kw) if name == "jax"
               else ServingEngine(tp, cfg, device="cpu", **kw))
        for i, p in enumerate(prompts):
            eng.submit(p, 8, arrival=i)
        done = eng.run()
        streams[name, slots] = [done[i].tokens.tolist() for i in range(len(prompts))]
    assert streams["torch", 4] == streams["jax", 4]
    assert [i for i, s in enumerate(streams["torch", 4]) if s != solo[i]] == [2]
    assert streams["torch", 2] == solo
    assert all(distinct_enough(s) for s in solo)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cancel_and_restore_keep_other_streams_equal_to_solo(arch):
    """Request 1 is cancelled after its first chunk; a chunk exception
    (the injector raises before the chunk runs) restores the snapshot
    and degrades the engine.  The finished streams equal their solo
    decode, the cancelled one is a solo-decode prefix, the pool drains."""
    _, cfg, _, tp = _pair(arch)
    prompts = _prompts(cfg.vocab, 17, lens=(6, 8, 5, 7, 6))
    gen = 7
    inj = FaultInjector([chunk_exception(4)], seed=0)
    eng = ServingEngine(tp, cfg, num_slots=2, page_size=4, max_seq_len=16,
                        ticks_per_sync=3, fault_injector=inj, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, gen, arrival=i)
    while not (eng.requests[1].status is RequestStatus.ACTIVE
               and eng.requests[1].admitted_at < eng.tick):
        eng.step()
    assert eng.cancel(1) is RequestStatus.ACTIVE
    done = eng.run()
    assert done[1].status is RequestStatus.CANCELLED
    assert eng.fault_stats["chunk_failures"] == 1 and eng.degraded
    assert all(distinct_enough(r.tokens.tolist()) for rid, r in done.items()
               if rid != 1)
    for rid, req in done.items():
        want = serve.solo_decode(tp, cfg, req.prompt, gen, device="cpu")
        if rid == 1:
            assert 1 <= len(req.tokens) < gen
            np.testing.assert_array_equal(req.tokens, want[:len(req.tokens)])
        else:
            assert req.status is RequestStatus.FINISHED
            np.testing.assert_array_equal(req.tokens, want)
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert eng.pool.live_refs() == 0


def test_quarantined_prefill_slot_restarts_from_the_initial_state():
    """Untied embeddings, token 0's input row NaN: the request ending in
    token 0 fails at admission and leaves NaN in slot 0's Mamba rows; the
    next requests admitted to slot 0 decode as they would alone.
    Statuses and streams equal the JAX engine's on the same params."""
    key = "quarantine"
    if key not in _CACHE:
        jcfg = jmake_smoke(jget_config("jamba-v0.1-52b"), n_layers=8,
                           capacity_factor=2.0, tie_embeddings=False)
        cfg = make_smoke(get_config("jamba-v0.1-52b"), n_layers=8,
                         capacity_factor=2.0, tie_embeddings=False)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        emb = jp["embed"]["embedding"] * EMBED_SCALE
        jp = {**jp, "embed": {"embedding": emb.at[0].set(jnp.nan)}}
        _CACHE[key] = (jcfg, cfg, jp, params_from_reference(jp))
    jcfg, cfg, jp, tp = _CACHE[key]
    prompts = [np.where(p == 0, 1, p).astype(np.int32)
               for p in _prompts(cfg.vocab, 23, lens=(6, 7, 5))]
    prompts[0][-1] = 0
    kw = dict(num_slots=1, page_size=4, max_seq_len=16, ticks_per_sync=2)
    runs = {}
    for name, eng in (("jax", _jax_engine(jp, jcfg, **kw)),
                      ("torch", ServingEngine(tp, cfg, device="cpu", **kw))):
        for i, p in enumerate(prompts):
            eng.submit(p, 5, arrival=i)
            if name == "torch" and i == 0:
                eng.step()                      # request 0 fails here
                rows = [c for c, attn in zip(eng.caches, eng._attn) if not attn]
                assert all(torch.isnan(c["ssm"][0]).any() for c in rows)
        done = eng.run()
        runs[name] = [(done[i].status.value, done[i].tokens.tolist())
                      for i in range(3)]
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == ("failed", [])
    assert eng.fault_stats["guard_trips"] == 1
    for rid in (1, 2):
        want = serve.solo_decode(tp, cfg, prompts[rid], 5, device="cpu")
        assert runs["torch"][rid] == ("finished", want.tolist())
    assert all(torch.isfinite(t).all() for c in rows for t in c.values())


def test_chunk_failure_mid_chunk_is_unrecoverable_on_recurrent_stacks():
    _, cfg, _, tp = _pair("xlstm-350m")
    eng = ServingEngine(tp, cfg, num_slots=2, page_size=4, max_seq_len=16,
                        ticks_per_sync=2, device="cpu")
    eng.submit(_prompts(cfg.vocab, 3, lens=(5,))[0], 4)

    def broken(packed, ticks, sampled):
        raise RuntimeError("device fault inside the chunk")

    eng._chunk_fn = broken
    with pytest.raises(RuntimeError, match="unrecoverable"):
        eng.run()


def test_launcher_serves_both_archs_and_rejects_pruning_xlstm(capsys):
    for argv in (["--arch", "jamba-v0.1-52b", "--pruned", "0.75", "--block", "32,32",
                  "--min-size", "1024", "--shared-prefix"],
                 ["--arch", "xlstm-350m"]):
        assert serve.main([*argv, "--smoke", "--device", "cpu", "--stream",
                           "--requests", "3", "--gen", "5"]) == 0
        out = capsys.readouterr().out
        assert "verify OK" in out and "prefix cache: off" in out
    jcfg = jmake_smoke(jget_config("xlstm-350m"))
    with pytest.raises(ValueError) as want:
        jknapsack_prune(jinit_params(jax.random.PRNGKey(0), jcfg), sparsity=0.75,
                        blocking=JBlockingSpec(bk=128, bn=128), min_size=4096)
    with pytest.raises(ValueError) as got:
        serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
                    "--stream", "--pruned", "0.75"])
    assert str(got.value) == str(want.value)
    assert "no prunable weights matched include=('mlp', 'attn', 'moe')" in str(got.value)
