"""Vertical (feature-wise) data partitioning -- De-VertiFL section III.

MNIST-style: image rows are dealt to participants round-robin (Fig. 2).
Tabular: features are distributed randomly (Titanic) or round-robin.
The port's copy of ``repro.data.vertical``'s partition helpers.
"""
from __future__ import annotations

import numpy as np


def round_robin_rows(n_clients, side=28):
    """Deal image rows round-robin; returns list of flat feature indices
    per client (paper Fig. 2: client i gets rows i, i+n, i+2n, ...)."""
    out = []
    for c in range(n_clients):
        rows = np.arange(c, side, n_clients)
        idx = (rows[:, None] * side + np.arange(side)[None, :]).reshape(-1)
        out.append(np.sort(idx))
    return out


def round_robin_features(n_features, n_clients):
    return [np.arange(c, n_features, n_clients) for c in range(n_clients)]


def random_features(n_features, n_clients, seed=0):
    """Random disjoint assignment (paper: Titanic features 'randomly
    distributed among the participants')."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_features)
    return [np.sort(perm[c::n_clients]) for c in range(n_clients)]


def feature_mask(idx, n_features, dtype=np.float32):
    m = np.zeros(n_features, dtype=dtype)
    m[idx] = 1
    return m
