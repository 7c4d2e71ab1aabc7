"""The plain reference against the port's CPU path at smoke size: the
same tile selection as the port's knapsack, and the same logits as the
port's forward over the masked dense and the packed params."""
import copy

import numpy as np
import pytest
import torch

import smoke
from portbench import program
from portbench.reference import decoder, judge

program.import_port()
from repro_torch.models import lm_forward  # noqa: E402


def _cfg(cell, dtype):
    cfg = copy.deepcopy(smoke.cell(cell)["config"])
    cfg.update(param_dtype=dtype, activ_dtype=dtype)
    return cfg


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["qwen-chat", "granite-backlog"])
def test_selection_matches_the_ports_knapsack(cell):
    cfg = _cfg(cell, "bfloat16")
    w = decoder.make_weights(cfg, 2**32 + 9, "cpu")
    keep = decoder.select_tiles(w, cfg)
    from repro_torch.core import BlockingSpec
    from repro_torch.sparse import knapsack_prune
    pr = cfg["pruning"]
    sel = knapsack_prune(decoder.params_tree(w, cfg), sparsity=pr["sparsity"],
                         blocking=BlockingSpec(*pr["block"]), min_size=pr["min_size"])
    tile = pr["block"][0]
    for kind, flags in keep.items():
        # exactly a quarter of each matrix's tiles, those drawn at the larger scale
        per = flags.reshape(flags.shape[0], -1) if "experts" not in kind else \
            flags.reshape(-1, flags.shape[-2] * flags.shape[-1])
        assert torch.all(per.sum(dim=1) == per.shape[1] // 4), kind
        for layer in range(cfg["num_hidden_layers"]):
            lp = sel.masks["layers"][layer]
            m = (lp["moe"][kind] if kind.startswith("experts") else
                 lp["attn"][kind]["kernel"] if kind in ("wq", "wk", "wv", "wo") else
                 lp["mlp"][kind]["kernel"])
            got = m.to(torch.float32).unfold(-2, tile, tile).unfold(-2, tile, tile)
            got = got.amax(dim=(-2, -1)) > 0
            assert torch.equal(got, flags[layer]), (kind, layer)


@pytest.mark.parametrize("cell", ["qwen-chat", "granite-backlog"])
def test_reference_logits_match_the_port(cell):
    cfg = _cfg(cell, "float32")
    w = decoder.make_weights(cfg, 77, "cpu")
    keep = decoder.select_tiles(w, cfg)
    ref = decoder.forward(decoder.masked(w, keep, cfg),
                          torch.arange(40) % cfg["vocab_size"], cfg)
    params = decoder.params_tree(w, cfg)
    packed, _ = program.pack(params, cfg)
    mcfg = program.port_config(cfg)
    tokens = (torch.arange(40) % cfg["vocab_size"])[None]
    scale = float(ref.abs().max())
    got, _ = lm_forward(packed, {"tokens": tokens}, mcfg)
    assert float((got[0] - ref).abs().max()) <= 1e-4 * scale
    from repro_torch.sparse import unpack_params
    dense, _ = lm_forward(unpack_params(packed), {"tokens": tokens}, mcfg)
    assert float((dense[0] - ref).abs().max()) <= 1e-4 * scale


def test_judge_reads_the_gap_below_the_best_logit():
    cfg = _cfg("qwen-chat", "float32")
    w = decoder.make_weights(cfg, 5, "cpu")
    w32 = decoder.masked(w, decoder.select_tiles(w, cfg), cfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg["vocab_size"], size=30)

    def ref(ids):
        return decoder.forward(w32, ids, cfg)

    # greedy continuation of the reference itself: every gap is 0
    seq = list(prompt)
    for _ in range(8):
        seq.append(int(ref(torch.as_tensor(seq))[-1].argmax()))
    greedy = np.asarray(seq[30:])
    assert judge.served_gaps(ref, [{"prompt": prompt, "served": greedy}], "cpu") == [0.0]
    # one altered token reads the gap of its logit below the best
    bad = greedy.copy()
    bad[3] = (bad[3] + 1) % cfg["vocab_size"]
    logits = ref(torch.as_tensor(np.concatenate([prompt, bad[:-1]])))[29 + 3]
    want = float(logits.max() - logits[bad[3]])
    got = judge.served_gaps(ref, [{"prompt": prompt, "served": bad}], "cpu")[0]
    assert got == pytest.approx(want) and got > 0
    # the control reads, at the same positions, the gap of its own first choice
    w8 = decoder.quantized(w32)
    ctrl = judge.control_gaps(ref, lambda ids: decoder.forward(w8, ids, cfg),
                              [{"prompt": prompt, "served": greedy}], "cpu")[0]
    ids = torch.as_tensor(np.concatenate([prompt, greedy[:-1]]))
    want_l, low = ref(ids)[29:], decoder.forward(w8, ids, cfg)[29:]
    pick = low.argmax(-1)
    assert ctrl == pytest.approx(float(
        (want_l.max(-1).values - want_l.gather(1, pick[:, None])[:, 0]).max()))
    # fp8 e4m3 keeps 3 mantissa bits: the weights move by up to 1/16
    rel = (w8["wq"] - w32["wq"]).abs().max() / w32["wq"].abs().max()
    assert 0 < float(rel) <= 1 / 16


def test_judge_reads_sampled_tokens_below_the_top_k_edge():
    cfg = _cfg("qwen-chat", "float32")
    w = decoder.make_weights(cfg, 6, "cpu")
    w32 = decoder.masked(w, decoder.select_tiles(w, cfg), cfg)
    prompt = np.random.default_rng(1).integers(0, cfg["vocab_size"], size=20)

    def ref(ids):
        return decoder.forward(w32, ids, cfg)

    k = 5
    served = [int(ref(torch.as_tensor(prompt))[-1].argmax())]
    # each later token the k-th best of the reference: inside the top-k set
    for _ in range(5):
        lg = ref(torch.as_tensor(np.concatenate([prompt, served])))[-1]
        served.append(int(torch.topk(lg, k).indices[-1]))
    req = {"prompt": prompt, "served": np.asarray(served), "greedy": False, "top_k": k}
    assert judge.served_gaps(ref, [req], "cpu") == [0.0]
    # judged as greedy, the same tokens read their gap below the best
    assert judge.served_gaps(ref, [dict(req, top_k=None)], "cpu")[0] > 0
    # the last token ranked k + 1 reads its gap below the k-th best
    bad = np.asarray(served)
    lg = ref(torch.as_tensor(np.concatenate([prompt, bad[:-1]])))[-1]
    top = torch.topk(lg, k + 1)
    bad[-1] = int(top.indices[-1])
    got = judge.served_gaps(ref, [dict(req, served=bad)], "cpu")[0]
    assert got == pytest.approx(float(top.values[-2] - top.values[-1]))
    # the first token is admission's argmax, judged below the best
    first = np.asarray(served)
    first[0] = int(torch.topk(ref(torch.as_tensor(prompt))[-1], 2).indices[-1])
    assert judge.served_gaps(ref, [dict(req, served=first)], "cpu")[0] > 0


def test_sample_takes_greedy_and_sampled_requests():
    def r(i, n, greedy):
        return {"rid": i, "served": np.zeros(n, np.int64), "greedy": greedy}
    done = [r(i, 10 + i, i % 2 == 0) for i in range(20)]
    got = judge.sample_requests(done, np.random.default_rng(0), count=3,
                                min_tokens=10, sampled=4)
    greedy = [x for x in got if x["greedy"]]
    samp = [x for x in got if not x["greedy"]]
    assert len(greedy) == 3 and len(samp) == 4
    assert greedy[0]["rid"] == 18 and samp[0]["rid"] == 19   # each led by its longest
    assert judge.sample_requests(done, np.random.default_rng(0), count=3,
                                 min_tokens=10) == greedy


def test_ambiguous_selection_raises():
    cfg = _cfg("qwen-chat", "float32")
    cfg["weights"] = dict(cfg["weights"], tile_scales={"kept": [1.0, 1.0],
                                                       "pruned": [1.0, 1.0]})
    w = decoder.make_weights(cfg, 3, "cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        decoder.select_tiles(w, cfg)
