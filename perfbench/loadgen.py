"""The general generator of closed-loop traffic, driven by a mix file
(``mixes/<traffic>.json``).

A mix states its clients (one a slot: each submits its next request as
soon as its last one is done), the slots and the cache, and the
distributions of prompt and output lengths.  The run's requests come
from a pool of ``pool`` (prompt, output) sizes that does not depend on
the seed: the prompt sizes at the midpoints of ``pool`` equal
quantiles of their distribution, each paired with an output size at a
golden-ratio step through the output quantiles.  The seed only orders
the pool and draws the token ids, so that every seed serves the same
work in another order.  The order is stratified: the pool sorted by
prompt size falls into ``strata`` equal strata, and the requests take
one from each stratum in turn (the strata in a fresh order each round,
each stratum's requests shuffled), so that any ``strata`` requests in a
row span the prompt sizes and a window's work hardly depends on the
seed.

The first request of each client stands for a conversation already
under way when the window opens: of its output it still has a share
``u`` to go (the shares are the midpoints of ``clients`` equal steps,
dealt out by the seed), and the part already served is in its prompt.
The pool therefore starts in its steady mix of ages instead of all at
once.  Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def load_mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def quantile(dist, u):
    """The u-quantile (0 < u < 1) of a length distribution."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        return min(hi, lo + int(u * (hi - lo + 1)))
    if dist["dist"] == "loguniform":
        return min(hi, max(lo, round(math.exp(
            math.log(lo) + u * (math.log(hi) - math.log(lo))))))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def pool_sizes(mix):
    M = mix["pool"]
    return [(quantile(mix["prompt"], (i + 0.5) / M),
             quantile(mix["output"], ((i + 0.5) * GOLDEN) % 1.0))
            for i in range(M)]


class ClosedLoop:
    """The n-th request of a run, for any n: ``request(n)`` -> (token
    ids, new tokens)."""

    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        self.sizes = pool_sizes(mix)
        self._orders = {}
        clients = mix["clients"]
        self._share = np.random.default_rng([self.seed, 1]).permutation(
            clients)

    def _order(self, cycle):
        """Pool indices in the order of pass ``cycle`` through it."""
        if cycle not in self._orders:
            rng = np.random.default_rng([self.seed, 2, cycle])
            S = self.mix["strata"]
            by_prompt = np.argsort([p for p, _ in self.sizes], kind="stable")
            strata = [rng.permutation(s) for s in
                      np.array_split(by_prompt, S)]
            rounds = len(strata[0])
            self._orders[cycle] = np.array(
                [strata[k][r] for r in range(rounds)
                 for k in rng.permutation(S)])
        return self._orders[cycle]

    def size(self, n):
        """(prompt tokens, new tokens) of the n-th request."""
        cycle, j = divmod(n, len(self.sizes))
        prompt, out = self.sizes[int(self._order(cycle)[j])]
        if n < self.mix["clients"]:
            u = (self._share[n] + 0.5) / self.mix["clients"]
            left = max(1, math.ceil(out * u))
            prompt, out = prompt + out - left, left
        return prompt, out

    def request(self, n):
        prompt, out = self.size(n)
        ids = np.random.default_rng([self.seed, 3, n]).integers(
            0, self.vocab, prompt)
        return ids.tolist(), out

    def longest_prompt(self):
        return self.mix["prompt"]["max"]
