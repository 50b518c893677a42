"""The closed-loop generator: the same seed gives the same requests, every
seed serves the same sizes, every request fits the mix's cache."""
from __future__ import annotations

import pytest

from perfbench import loadgen

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


@pytest.mark.parametrize("name", ["chat", "longdoc"])
def test_same_seed_same_requests(name):
    mix = loadgen.load_mix(name)
    a = loadgen.ClosedLoop(mix, 1000, SEEDS[2])
    b = loadgen.ClosedLoop(mix, 1000, SEEDS[2])
    for n in (0, 1, mix["clients"], mix["pool"] + 5):
        assert a.request(n) == b.request(n)
    c = loadgen.ClosedLoop(mix, 1000, SEEDS[3])
    assert [a.request(n) for n in range(4)] != [c.request(n) for n in range(4)]


@pytest.mark.parametrize("name", ["chat", "longdoc"])
def test_every_seed_serves_the_same_sizes(name):
    mix = loadgen.load_mix(name)
    M, clients = mix["pool"], mix["clients"]
    sets = []
    for seed in SEEDS:
        loop = loadgen.ClosedLoop(mix, 1000, seed)
        # one whole pass after the first clients' requests
        sets.append(sorted(loop.size(n) for n in range(M, 2 * M)))
        firsts = sorted(sum(loop.size(n)) for n in range(clients))
        assert len(firsts) == clients
    assert all(s == sets[0] for s in sets)


@pytest.mark.parametrize("name", ["chat", "longdoc"])
def test_requests_fit_and_stay_in_range(name):
    mix = loadgen.load_mix(name)
    loop = loadgen.ClosedLoop(mix, 50, SEEDS[1])
    for n in range(mix["clients"] + mix["pool"]):
        prompt, new = loop.size(n)
        assert prompt + new <= mix["cache_len"]
        assert new >= 1
        if n >= mix["clients"]:
            assert mix["prompt"]["min"] <= prompt <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= new <= mix["output"]["max"]
    ids, new = loop.request(3)
    assert len(ids) == loop.size(3)[0] and all(0 <= i < 50 for i in ids)


def test_pool_follows_the_distributions():
    mix = loadgen.load_mix("chat")
    sizes = loadgen.pool_sizes(mix)
    prompts = sorted(p for p, _ in sizes)
    outs = [o for _, o in sizes]
    # log-uniform 256..2048: the median near sqrt(256 * 2048) = 724
    assert 680 <= prompts[len(prompts) // 2] <= 770
    assert min(prompts) >= 256 and max(prompts) <= 2048
    # uniform 64..384: mean near 224
    assert abs(sum(outs) / len(outs) - 224) < 3


def test_first_requests_are_conversations_under_way():
    mix = loadgen.load_mix("chat")
    loop = loadgen.ClosedLoop(mix, 50, 5)
    clients = mix["clients"]
    left = sorted(loop.size(n)[1] for n in range(clients))
    # a spread of ages: some nearly done, some just begun
    assert left[0] < 20 and left[-1] > 250


def test_any_strata_requests_in_a_row_span_the_prompt_sizes():
    mix = loadgen.load_mix("chat")
    loop = loadgen.ClosedLoop(mix, 50, 123)
    S, M = mix["strata"], mix["pool"]
    edges = sorted(p for p, _ in loadgen.pool_sizes(mix))[::M // S]
    for start in range(M, 2 * M - S, S):
        prompts = sorted(loop.size(n)[0] for n in range(start, start + S))
        # one from each stratum: the k-th smallest at least the k-th edge
        assert all(p >= e for p, e in zip(prompts, edges))
