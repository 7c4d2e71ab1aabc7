"""The traffic generator: seeded, deterministic, on its grids, with the
same multiset of sizes and gaps for every seed."""
import math

import numpy as np
import pytest

import smoke  # noqa: F401  (puts the repository root on the path)
from portbench import generate
from portbench import spec as spec_mod


def _traffic(name):
    return spec_mod.read_json(spec_mod.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["chat", "backlog"])
def test_same_seed_same_stream(name):
    tr = _traffic(name)
    a = generate.stream(tr, 1000, 2**33 + 7, 4.0)
    b = generate.stream(tr, 1000, 2**33 + 7, 4.0)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["t"] == y["t"] and x["max_new"] == y["max_new"]
        assert x["greedy"] == y["greedy"] and np.array_equal(x["prompt"], y["prompt"])


@pytest.mark.parametrize("name", ["chat", "backlog"])
def test_seeds_share_sizes_not_order(name):
    tr = _traffic(name)
    a = generate.stream(tr, 1000, 11, 10.0)
    b = generate.stream(tr, 1000, 12, 10.0)
    for key in ("tail", "max_new", "greedy", "prefix"):
        assert sorted(r[key] for r in a) == sorted(r[key] for r in b)
    assert sorted(np.diff([0.0] + [r["t"] for r in a])) == pytest.approx(
        sorted(np.diff([0.0] + [r["t"] for r in b])))
    assert [r["tail"] for r in a] != [r["tail"] for r in b]
    assert not np.array_equal(a[0]["prompt"], b[0]["prompt"])


def test_lengths_follow_the_grid_and_the_lognormal():
    tr = _traffic("chat")
    grid = generate.lognormal_grid(tr["prompt"])
    assert len(grid) == 16 and list(grid) == sorted(grid)
    assert grid[0] >= tr["prompt"]["min"] and grid[-1] <= tr["prompt"]["max"]
    assert np.median(grid) == pytest.approx(tr["prompt"]["median"], rel=0.05)
    reqs = generate.stream(tr, 1000, 3, 100.0)
    tails = np.array([r["tail"] for r in reqs])
    assert set(tails) <= set(grid)
    # each grid point n / 16 times (the stratified quantiles)
    counts = np.array([np.sum(tails == g) for g in grid])
    assert counts.max() - counts.min() <= 1
    outs = np.array([r["max_new"] for r in reqs])
    assert outs.min() >= tr["output"]["min"] and outs.max() <= tr["output"]["max"]
    assert np.median(outs) == pytest.approx(tr["output"]["median"], rel=0.05)
    sl = tr["shared_prefix"]["length"]
    for r in reqs[:50]:
        assert len(r["prompt"]) == sl + r["tail"]


def test_poisson_gaps_and_shares():
    tr = _traffic("chat")
    seconds = 50.0
    reqs = generate.stream(tr, 1000, 5, seconds)
    rate = tr["arrivals"]["rate_per_s"]
    span = generate.lead_in_s(tr) + seconds       # the lead-in, then the window
    assert len(reqs) == round(rate * span)
    t = np.array([r["t"] for r in reqs])
    assert np.all(np.diff(t) >= 0) and 0 < t[-1] <= span
    gaps = np.diff(np.concatenate([[0.0], t]))
    # exponential: mean 1/rate, standard deviation about the mean
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.05)
    assert gaps.std() == pytest.approx(1 / rate, rel=0.15)
    pop = tr["shared_prefix"]["popularity"]
    share = np.bincount([r["prefix"] for r in reqs], minlength=len(pop)) / len(reqs)
    assert share == pytest.approx(pop, abs=1.0 / len(reqs))
    greedy = np.mean([r["greedy"] for r in reqs])
    assert greedy == pytest.approx(tr["greedy_share"], abs=1.0 / len(reqs))
    # the same shared prefix for every request that names it
    heads = {}
    for r in reqs:
        heads.setdefault(r["prefix"], r["prompt"][:tr["shared_prefix"]["length"]])
        assert np.array_equal(heads[r["prefix"]],
                              r["prompt"][:tr["shared_prefix"]["length"]])


def test_backlog_blocks_hold_the_same_mix():
    tr = _traffic("backlog")
    a = generate.stream(tr, 1000, 21, 30.0)
    b = generate.stream(tr, 1000, 22, 30.0)
    assert len(a) == tr["arrivals"]["requests"] and all(r["t"] == 0 for r in a)
    blk = tr["block"]
    for j in range(0, len(a), blk):
        # each block holds one of each stratum: the prompt grid's lengths
        # exactly, the outputs' quantiles to within neighbouring values
        assert sorted(r["tail"] for r in a[j:j + blk]) == \
            sorted(r["tail"] for r in b[j:j + blk])
        assert sum(r["max_new"] for r in a[j:j + blk]) == pytest.approx(
            sum(r["max_new"] for r in b[j:j + blk]), rel=0.01)


def test_lead_in_loads_before_the_window():
    tr = _traffic("chat")
    lead = generate.lead_in_s(tr)
    assert lead > 0
    reqs = generate.stream(tr, 1000, 8, 30.0)
    t = np.array([r["t"] for r in reqs])
    rate = tr["arrivals"]["rate_per_s"]
    # the lead-in's share of the requests is its share of the schedule
    assert np.sum(t < lead) == pytest.approx(rate * lead, rel=0.15)
    assert np.sum(t >= lead) == pytest.approx(rate * 30.0, rel=0.15)
    bl = _traffic("backlog")
    assert bl["arrivals"]["lead_in_retired"] >= bl["engine"]["num_slots"]


def test_iid_draws_plain_poisson():
    tr = dict(_traffic("chat"), iid=True)
    a = generate.stream(tr, 1000, 31, 200.0)
    b = generate.stream(tr, 1000, 31, 200.0)
    c = generate.stream(tr, 1000, 32, 200.0)
    assert [r["t"] for r in a] == [r["t"] for r in b]
    # the seed changes the work itself, not only its order
    assert sorted(r["max_new"] for r in a) != sorted(r["max_new"] for r in c)
    rate = tr["arrivals"]["rate_per_s"]
    gaps = np.diff([0.0] + [r["t"] for r in a])
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.1)
    assert gaps.std() == pytest.approx(1 / rate, rel=0.15)
    grid = set(generate.lognormal_grid(tr["prompt"]))
    assert set(r["tail"] for r in a) <= grid
    # unstratified: some 16-request stretch carries far more output than another
    sums = [sum(r["max_new"] for r in a[j:j + 16]) for j in range(0, len(a) - 16, 16)]
    strat = generate.stream(_traffic("chat"), 1000, 31, 200.0)
    sums_s = [sum(r["max_new"] for r in strat[j:j + 16])
              for j in range(0, len(strat) - 16, 16)]
    assert np.std(sums) > 2 * np.std(sums_s)


def test_blocked_is_a_permutation():
    rng = np.random.default_rng(0)
    vals = np.sort(rng.integers(0, 100, size=103))
    out = generate.blocked(vals, 16, np.random.default_rng(1))
    assert sorted(out) == sorted(vals)


def test_variants_cover_cold_and_hit_prefills():
    tr = _traffic("chat")
    ps = 8
    v = generate.variants(tr, ps)
    grid = sorted(set(generate.lognormal_grid(tr["prompt"])))
    sl = tr["shared_prefix"]["length"]
    assert sorted(v) == sorted([(sl + g, 0) for g in grid] + [(g, sl) for g in grid])
    # the longest request fits a slot: prefix, longest tail, longest output
    assert sl + tr["prompt"]["max"] + tr["output"]["max"] <= tr["engine"]["max_seq_len"]
    bl = _traffic("backlog")
    assert generate.variants(bl, ps) == [(g, 0) for g in sorted(set(
        generate.lognormal_grid(bl["prompt"])))]
    assert bl["prompt"]["max"] + bl["output"]["max"] <= bl["engine"]["max_seq_len"]


def test_subseed_takes_large_seeds():
    a = generate.subseed(2**31 + 5, "x")
    assert a != generate.subseed(2**31 + 6, "x") != generate.subseed(2**31 + 5, "y")
    assert 0 <= a < 2**63 and not math.isnan(a)
