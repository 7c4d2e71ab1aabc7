"""The port's training substrate against the JAX package, on the CPU.

The qwen1.5-0.5b smoke config (fp32, d_model 128, 4 layers, vocab 256)
and one granite-moe-1b-a400m smoke case for the MoE branch are
initialised in JAX and carried over with ``repro_torch.bridge``; both
sides get the same numpy inputs.  Held: ``lm_forward`` logits within
1e-4 and ``moe_aux`` within 1e-5 (with and without per-layer remat),
``cross_entropy_loss`` within 1e-6, gradients within 1e-4 of each
leaf's largest entry (with remat "none", "dots" and "full"), the prefill and decode steps' tokens equal, ``adamw_update`` fed the same numpy gradients
within 1e-6 (with and without masks and master weights), the schedules,
the 5-step loss trajectory of ``make_train_step`` within 1e-4 (masked
with microbatches, and with the group-lasso ``reg_fn``), and
``TokenTask`` batches bit-equal.  Adam's first step is ~sign(g), so the
params after a JAX step and a torch step are not compared element-wise:
gradients, the update on equal gradients and the loss trajectory are
held separately.

Port-only: the checkpointer's atomic commits, GC and bf16 round trip;
the trainer's resume after an interrupt (bit-exact on the CPU), its
preemption hook and straggler log; the pipeline's determinism and
prefetch.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import apply_masks as japply_masks
from repro.core import build_structures as jbuild_structures
from repro.core import make_regularizer as jmake_regularizer
from repro.data import TokenTask as JTokenTask
from repro.models import cross_entropy_loss as jcross_entropy_loss
from repro.models.attention import attention_apply as jattention_apply
from repro.models.attention import full_attention as jfull_attention
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_forward as jlm_forward
from repro.models import lm_prefill as jlm_prefill
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import constant_lr as jconstant_lr
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import linear_decay as jlinear_decay
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.train import init_train_state as jinit_train_state
from repro.train import make_decode_step as jmake_decode_step
from repro.train import make_prefill_step as jmake_prefill_step
from repro.train import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_reference
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import BlockingSpec, apply_masks, build_structures, make_regularizer
from repro_torch.core.structures import iter_leaves
from repro_torch.data import LMPipeline, TokenTask
from repro_torch.models import cross_entropy_loss, init_caches, lm_forward, lm_prefill
from repro_torch.models.attention import (
    attention_apply,
    chunked_causal_attention,
    full_attention,
)
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    constant_lr,
    init_opt_state,
    linear_decay,
    warmup_cosine,
)
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow these runs many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params), smoke size."""
    if arch not in _CACHE:
        jcfg = jmake_smoke(jget_config(arch))
        cfg = make_smoke(get_config(arch))
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
        _CACHE[arch] = (jcfg, cfg, jparams, params_from_reference(jparams))
    return _CACHE[arch]


def _batch(vocab, b=2, s=16, step=0):
    host = JTokenTask(vocab=vocab, seed=3).batch(step, b, s)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in host.items()})


def _leaf_pairs(jtree, ttree):
    """(path, jax leaf as numpy, torch leaf) in pytree order."""
    jl = dict(iter_leaves(params_from_reference(jtree)))
    out = []
    for path, t in iter_leaves(ttree):
        out.append((path, jl.pop(path).float().numpy(), t.detach().float().numpy()))
    assert not jl, f"leaves only in the reference: {sorted(jl)}"
    return out


def _qwen_masks(jparams):
    sel = jknapsack_prune(jparams, sparsity=0.5,
                          blocking=JBlockingSpec(bk=32, bn=32), min_size=1024)
    return sel.masks, params_from_reference(sel.masks)


@pytest.mark.parametrize("arch,remat", [("qwen1.5-0.5b", "none"),
                                        ("qwen1.5-0.5b", "dots"),
                                        ("granite-moe-1b-a400m", "none"),
                                        ("qwen1.5-0.5b", "full"),
                                        ("granite-moe-1b-a400m", "dots")])
def test_lm_forward_matches_reference(arch, remat):
    jcfg, cfg, jparams, tparams = _model(arch)
    cfg = cfg.replace(remat=remat)
    jb, tb = _batch(cfg.vocab)
    jlogits, jaux = jax.jit(jlm_forward, static_argnums=2)(jparams, jb, jcfg)
    logits, aux = lm_forward(tparams, tb, cfg)
    assert logits.shape == (2, 16, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               atol=1e-5, rtol=1e-5)
    if arch.startswith("granite"):
        assert float(aux["moe_aux"]) > 0


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("chunk", [1, 4])
def test_attention_apply_chunks_match_full_attention(chunk, window):
    """Attention in chunks shorter than the sequence (S 9) equals the
    unchunked oracle, and ``attention_apply`` equals the reference's at
    the same chunk."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 9, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    full = full_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    got = chunked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                   window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6, rtol=1e-6)
    want = jfull_attention(*map(jnp.asarray, (q, k, v)), window=window)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    jcfg, cfg, jparams, tparams = _model("qwen1.5-0.5b")
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    kw = dict(num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
              head_dim=cfg.head_dim_(), window=window, chunk=chunk,
              rope_theta=cfg.rope_theta)
    out = attention_apply(tparams["layers"][0]["attn"], torch.from_numpy(x), **kw)
    ref = jattention_apply(jparams["layers"][0]["attn"], jnp.asarray(x), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 301)) * 4).astype(np.float32)
    labels = rng.integers(0, 301, size=(3, 7)).astype(np.int32)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             z_loss=z_loss)
    want = jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def _jloss(jcfg, aux_weight):
    def loss(params, masks, batch):
        p = japply_masks(params, masks) if masks is not None else params
        logits, aux = jlm_forward(p, batch, jcfg)
        return jcross_entropy_loss(logits, batch["labels"]) + aux_weight * aux["moe_aux"]
    return loss


@pytest.mark.parametrize("arch,masked,remat", [
    pytest.param("qwen1.5-0.5b", False, "none", id="qwen1.5-0.5b-False"),
    pytest.param("qwen1.5-0.5b", True, "none", id="qwen1.5-0.5b-True"),
    pytest.param("granite-moe-1b-a400m", False, "none",
                 id="granite-moe-1b-a400m-False"),
    pytest.param("qwen1.5-0.5b", False, "dots", id="qwen1.5-0.5b-False-dots"),
    pytest.param("qwen1.5-0.5b", True, "dots", id="qwen1.5-0.5b-True-dots"),
    pytest.param("qwen1.5-0.5b", False, "full", id="qwen1.5-0.5b-False-full"),
    pytest.param("granite-moe-1b-a400m", False, "dots",
                 id="granite-moe-1b-a400m-False-dots"),
])
def test_gradients_match_reference(arch, masked, remat):
    """Both packages under the same ``remat`` policy (the masked case is
    the pruner's masked fine-tune)."""
    jcfg, cfg, jparams, tparams = _model(arch)
    jcfg, cfg = jcfg.replace(remat=remat), cfg.replace(remat=remat)
    jmasks, tmasks = _qwen_masks(jparams) if masked else (None, None)
    jb, tb = _batch(cfg.vocab)
    jgrads = jax.jit(jax.grad(_jloss(jcfg, 0.01)))(jparams, jmasks, jb)
    leaves = []

    def fresh(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    from repro_torch.core.masks import map_tree
    live = map_tree(fresh, tparams)
    p = apply_masks(live, tmasks) if masked else live
    logits, aux = lm_forward(p, tb, cfg)
    total = cross_entropy_loss(logits, tb["labels"]) + 0.01 * aux["moe_aux"]
    total.backward()
    tgrads = map_tree(lambda t: t.grad, live)
    n = 0
    for path, want, got in _leaf_pairs(jgrads, tgrads):
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= 1e-4 * scale, path
        n += 1
    assert n >= 4 * 7


@pytest.mark.parametrize("use_master", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_adamw_update_matches_reference_on_equal_grads(use_master, masked):
    rng = np.random.default_rng(7)
    shapes = {"a": {"kernel": (64, 48), "bias": (48,)}, "b": [(32, 16), (16,)]}
    params = {"a": {k: rng.normal(size=s).astype(np.float32)
                    for k, s in shapes["a"].items()},
              "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]}
    masks = {"a": {"kernel": (rng.uniform(size=(64, 48)) < 0.5).astype(np.float32),
                   "bias": None},
             "b": [(rng.uniform(size=(32, 16)) < 0.5).astype(np.float32), None]}
    jcfg = JAdamWConfig(use_master=use_master)
    cfg = AdamWConfig(use_master=use_master)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_reference(params)
    jm = jax.tree.map(jnp.asarray, masks) if masked else None
    tm = params_from_reference(masks) if masked else None
    jst, tst = jinit_opt_state(jp, jcfg), init_opt_state(tp, cfg)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 10 ** rng.uniform(-3, 1)
                       ).astype(np.float32), params)
        lr = 1e-2 * (step + 1)
        jp, jst = jadamw_update(jp, jax.tree.map(jnp.asarray, grads), jst, jcfg,
                                jnp.float32(lr), masks=jm)
        tp, tst = adamw_update(tp, params_from_reference(grads), tst, cfg,
                               torch.tensor(lr, dtype=torch.float32), masks=tm)
        for _, want, got in _leaf_pairs({"p": jp, "m": jst["m"], "v": jst["v"]},
                                        {"p": tp, "m": tst["m"], "v": tst["v"]}):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        assert ("master" in tst) == use_master
        if use_master:
            for _, want, got in _leaf_pairs(jst["master"], tst["master"]):
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if masked:          # pruned entries stay exactly zero, moments too
        for t, m in ((tp["a"]["kernel"], tm["a"]["kernel"]),
                     (tst["m"]["b"][0], tm["b"][0])):
            assert float(t[m == 0].abs().max()) == 0.0


def test_lr_schedules_match_reference():
    pairs = [(warmup_cosine(3e-4, 3, 20), jwarmup_cosine(3e-4, 3, 20)),
             (warmup_cosine(1e-4, 2, 20, final_frac=0.0),
              jwarmup_cosine(1e-4, 2, 20, final_frac=0.0)),
             (linear_decay(1e-3, 7), jlinear_decay(1e-3, 7)),
             (constant_lr(5e-4), jconstant_lr(5e-4))]
    for fn, jfn in pairs:
        for step in range(25):
            got = fn(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            want = jfn(jnp.int32(step))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
            assert float(fn(step)) == float(got)


@pytest.mark.parametrize("arch,masked,micro,reg", [
    ("qwen1.5-0.5b", False, 1, False), ("qwen1.5-0.5b", True, 2, False),
    ("qwen1.5-0.5b", False, 1, True), ("granite-moe-1b-a400m", False, 1, False)])
def test_train_step_loss_trajectory_matches_reference(arch, masked, micro, reg):
    jcfg, cfg, jparams, tparams = _model(arch)
    jmasks, tmasks = _qwen_masks(jparams) if masked else (None, None)
    sched, jsched = warmup_cosine(1e-3, 2, 5), jwarmup_cosine(1e-3, 2, 5)
    jreg = treg = None
    if reg:             # the group lasso on unpruned (non-zero) tiles
        kw = dict(include=("mlp", "attn"), min_size=1024)
        jreg = jmake_regularizer(jbuild_structures(
            jparams, JBlockingSpec(bk=32, bn=32), **kw), strength=1e-2)
        treg = make_regularizer(build_structures(
            tparams, BlockingSpec(bk=32, bn=32), **kw), strength=1e-2)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(), jsched, reg_fn=jreg,
                                     microbatches=micro))
    tstep = make_train_step(cfg, AdamWConfig(), sched, reg_fn=treg,
                            microbatches=micro)
    jst = jinit_train_state(jparams, JAdamWConfig(), masks=jmasks)
    tst = init_train_state(tparams, AdamWConfig(), masks=tmasks)
    jl, tl = [], []
    for s in range(5):
        jb, tb = _batch(cfg.vocab, b=4, s=16, step=s)
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        jl.append([float(jm[k]) for k in ("total_loss", "loss", "moe_aux", "lr")])
        tl.append([float(tm[k]) for k in ("total_loss", "loss", "moe_aux", "lr")])
    np.testing.assert_allclose(np.array(tl), np.array(jl), rtol=1e-4, atol=1e-4)
    assert int(tst["step"]) == 5
    if masked:          # pruned tiles stay exactly zero through training
        k = tst["params"]["layers"][0]["mlp"]["w_up"]["kernel"]
        m = tst["masks"]["layers"][0]["mlp"]["w_up"]["kernel"]
        assert float(k[m == 0].abs().max()) == 0.0 and float((m == 0).sum()) > 0


def test_train_step_leaves_its_input_state_unchanged():
    _, cfg, _, tparams = _model("qwen1.5-0.5b")
    cfg = cfg.replace(n_layers=1)
    params = {"embed": tparams["embed"], "final_norm": tparams["final_norm"],
              "layers": tparams["layers"][:1]}
    st = init_train_state(params, AdamWConfig())
    before = [t.clone() for _, t in iter_leaves(st)]
    make_train_step(cfg, AdamWConfig(), constant_lr(1e-3))(st, _batch(cfg.vocab)[1])
    for b, (_, a) in zip(before, iter_leaves(st)):
        assert torch.equal(a, b)


def test_prefill_and_decode_steps_match_reference():
    jcfg, cfg, jparams, tparams = _model("qwen1.5-0.5b")
    jb, tb = _batch(cfg.vocab)
    got = make_prefill_step(cfg)(tparams, {"tokens": tb["tokens"]})
    want = jax.jit(jmake_prefill_step(jcfg))(jparams, {"tokens": jb["tokens"]})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jc = jinit_caches(jcfg, 2, 18, jnp.float32)
    _, jc = jax.jit(jlm_prefill, static_argnames=("cfg",))(
        jparams, jc, {"tokens": jb["tokens"]}, cfg=jcfg)
    tc = init_caches(cfg, 2, 18, torch.float32, device="cpu")
    with torch.no_grad():
        lm_prefill(tparams, tc, {"tokens": tb["tokens"]}, cfg)
    first = np.asarray(want)[:, None].astype(np.int32)
    jtok, _ = jax.jit(jmake_decode_step(jcfg))(
        jparams, jc, {"tokens": jnp.asarray(first)}, jnp.int32(16))
    ttok, _ = make_decode_step(cfg)(tparams, tc, {"tokens": torch.from_numpy(first)}, 16)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("step,b,s", [(0, 2, 16), (20_000, 3, 9), (7, 1, 1)])
def test_token_task_batches_equal_reference(step, b, s):
    for vocab, seed in ((256, 0), (151936, 4)):
        got = TokenTask(vocab=vocab, seed=seed).batch(step, b, s)
        want = JTokenTask(vocab=vocab, seed=seed).batch(step, b, s)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# port only: pipeline, checkpointer, trainer
# ---------------------------------------------------------------------------

def test_pipeline_is_deterministic_and_prefetch_keeps_order():
    task = TokenTask(vocab=97, seed=2)
    a = LMPipeline(task, 3, 5, device="cpu")
    b = LMPipeline(task, 3, 5, device="cpu", prefetch=0)
    for s in (0, 4, 4, 9):
        assert torch.equal(a.batch_at(s)["tokens"], b.batch_at(s)["tokens"])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    got = list(a.run(3, 4))
    assert len(got) == 4
    for i, batch in enumerate(got):
        assert torch.equal(batch["tokens"], b.batch_at(3 + i)["tokens"])
        assert torch.equal(batch["labels"], b.batch_at(3 + i)["labels"])
    assert [x["tokens"].tolist() for x in b.run(3, 4)] == \
        [x["tokens"].tolist() for x in got]
    assert a._thread is not None and not a._thread.is_alive()
    a.close()


def _toy_state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((4, 3), generator=g),
                       "h": torch.randn((5,), generator=g).to(torch.bfloat16),
                       "layers": [{"k": torch.randn((2, 2), generator=g)}]},
            "masks": {"w": torch.ones((4, 3)), "h": None,
                      "layers": [{"k": None}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpointer_bf16_round_trip_and_restore_onto_target(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    state = _toy_state()
    ck.save(3, state)
    back = ck.restore(3, target=state)
    assert back["masks"]["h"] is None and back["masks"]["layers"][0]["k"] is None
    pairs = list(zip(iter_leaves(state), iter_leaves(back)))
    assert len(pairs) == 5
    for (p1, a), (p2, b) in pairs:
        assert p1 == p2 and a.dtype == b.dtype and torch.equal(a, b)
    assert back["params"]["h"].dtype == torch.bfloat16
    raw = ck.restore(3)
    assert raw["step"] == 3 and len(raw["leaves"]) == 5
    bad = _toy_state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="params/w"):
        ck.restore(3, target=bad)
    del bad["params"]["w"]
    with pytest.raises(ValueError, match="paths differ"):
        ck.restore(3, target=bad)


def test_checkpointer_commits_atomically_and_keeps_the_newest(tmp_path):
    d = tmp_path / "ck"
    ck = Checkpointer(str(d), keep=2)
    state = _toy_state()
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for s in (1, 2, 3):
        ck.save_async(s, state)
    ck.wait()
    assert ck.committed_steps() == [2, 3]
    # a crashed writer's .tmp and a dir without the commit marker are
    # not checkpoints
    (d / "step_0000000009.tmp").mkdir()
    (d / "step_0000000008").mkdir()
    assert ck.latest_step() == 3
    with pytest.raises(FileNotFoundError, match="not committed"):
        ck.restore(8)
    ck.save(9, state)                    # replaces the stale .tmp
    assert ck.committed_steps() == [3, 9]
    assert not (d / "step_0000000009.tmp").exists()
    assert sorted(os.listdir(d / "step_0000000009"))[:2] == ["COMMITTED", "leaf_00000.npy"]


def _small_training(tmp_path, name, total, ckpt_every):
    _, cfg, _, tparams = _model("qwen1.5-0.5b")
    cfg = cfg.replace(n_layers=2)
    params = {"embed": tparams["embed"], "final_norm": tparams["final_norm"],
              "layers": tparams["layers"][:2]}
    opt = AdamWConfig()
    pipe = LMPipeline(TokenTask(vocab=cfg.vocab, seed=1), 2, 8, device="cpu")
    return Trainer(make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 6)),
                   init_train_state(params, opt), pipe.batch_at,
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmp_path / name), log_every=1))


def test_trainer_resume_after_interrupt_is_bit_exact(tmp_path):
    full = _small_training(tmp_path, "full", 6, 100)
    res_full = full.run()
    assert res_full["final_step"] == 6 and len(res_full["metrics"]) == 6
    first = _small_training(tmp_path, "cut", 3, 3)
    assert first.run()["final_step"] == 3
    again = _small_training(tmp_path, "cut", 6, 3)      # a fresh process
    res = again.run()
    assert res["final_step"] == 6
    assert [r["step"] for r in res["metrics"]] == [3, 4, 5]
    assert [r["total_loss"] for r in res["metrics"]] == \
        [r["total_loss"] for r in res_full["metrics"][3:]]
    for (p, a), (_, b) in zip(iter_leaves(full.state), iter_leaves(again.state)):
        assert torch.equal(a, b), p


def test_trainer_preemption_signal_checkpoints_and_stops(tmp_path):
    tr = _small_training(tmp_path, "pre", 6, 100)
    inner = tr.step_fn

    def step_fn(state, batch):
        out = inner(state, batch)
        if int(out[0]["step"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.step_fn = step_fn
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        res = tr.run()
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert res["preempted"] and res["final_step"] == 2
    assert tr.ckpt.latest_step() == 2


def test_trainer_logs_stragglers():
    delays = [0.01] * 6 + [0.2] + [0.01] * 3

    def step_fn(state, batch):
        time.sleep(delays[int(state["step"])])
        return {"step": state["step"] + 1}, {"total_loss": torch.tensor(1.0)}

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step_fn, {"step": torch.tensor(0)}, lambda s: {},
                     TrainerConfig(total_steps=10, ckpt_every=0, ckpt_dir=d,
                                   log_every=5))
        res = tr.run()
    assert [e["step"] for e in res["stragglers"]] == [6]
    ev = res["stragglers"][0]
    assert ev["dt"] > 2.5 * ev["ewma"]
    assert [r["step"] for r in res["metrics"]] == [0, 5]


@pytest.mark.parametrize("fails", [False, True])
def test_trainer_puts_back_the_signal_handlers(tmp_path, fails):
    """``run`` hooks SIGTERM/SIGINT only while it trains: afterwards, and
    after a step that raises, the process's own handlers are back."""
    def step_fn(state, batch):
        if fails:
            raise RuntimeError("step failed")
        return {"step": state["step"] + 1}, {"total_loss": torch.tensor(1.0)}

    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    seen = {}

    def batch_fn(step):
        seen.update({s: signal.getsignal(s) for s in before})
        return {}

    tr = Trainer(step_fn, {"step": torch.tensor(0)}, batch_fn,
                 TrainerConfig(total_steps=2, ckpt_every=0,
                               ckpt_dir=str(tmp_path / "ck"), log_every=0))
    if fails:
        with pytest.raises(RuntimeError, match="step failed"):
            tr.run()
    else:
        assert tr.run()["final_step"] == 2
    assert all(seen[s] is not before[s] for s in before)    # hooked in run
    assert {s: signal.getsignal(s) for s in before} == before
