"""Synthetic language-model data: a sparse random Markov chain over the
vocabulary (numpy only: the port's copy of ``repro.data.lm``, whose
batches it gives exactly). The chain has low per-state entropy, so next-token loss has
real learnable structure (loss drops well below ln(V) within a few
hundred steps) -- used by the end-to-end ~100M-param training example
and the LM integration tests.
"""
from __future__ import annotations

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size, branching=4, seed=0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.next_states = rng.integers(0, vocab_size,
                                        (vocab_size, branching))
        probs = rng.dirichlet(np.ones(branching) * 0.5, vocab_size)
        self.cum_probs = np.cumsum(probs, axis=1)

    def sample(self, rng, batch, seq_len):
        toks = np.empty((batch, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq_len):
            u = rng.uniform(size=batch)
            cur = toks[:, t]
            choice = (u[:, None] > self.cum_probs[cur]).sum(axis=1)
            toks[:, t + 1] = self.next_states[cur, choice]
        return toks


def markov_lm_batches(vocab_size, batch, seq_len, seed=0, branching=4):
    """Infinite iterator of {'tokens', 'labels'} next-token batches."""
    lm = MarkovLM(vocab_size, branching, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = lm.sample(rng, batch, seq_len)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
