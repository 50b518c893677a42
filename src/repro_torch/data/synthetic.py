"""Structured synthetic stand-ins for the paper's datasets: a copy of
the JAX package's ``repro.data.synthetic`` generators, so the port's
draws are bit-identical to the reference's (the seed-stacking helpers
for sweeps are not ported yet).

The container is offline, so MNIST/FMNIST/Titanic/Bank-Marketing cannot
be downloaded. These generators match each dataset's shape, class
cardinality, and -- critically for De-VertiFL -- its *information
geometry*: class-discriminative signal is spread across ALL features
(MNIST prototypes span every image row; tabular labels depend on every
column), so a vertical slice held by one client carries only partial
information and the paper's qualitative claims (federated >>
non-federated, gap grows with participants) are reproducible.

Shapes/cardinalities:
  mnist   70000 x 784, 10 classes (paper uses 60k train / 10k test)
  fmnist  70000 x 784, 10 classes (harder: more within-class variance)
  titanic 891 x 9 (post-preprocessing feature count), binary
  bank    ~45211 x 51 (post one-hot), binary (we scale n down for CI)
"""
from __future__ import annotations

import numpy as np


def _image_like(n, n_classes, side, noise, proto_scale, seed, blobs=6):
    """Class prototypes made of smooth Gaussian blobs covering the whole
    image; samples = prototype + pixel noise, quantized to [0,255]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    protos = np.zeros((n_classes, side, side))
    for c in range(n_classes):
        for _ in range(blobs):
            cx, cy = rng.uniform(2, side - 2, 2)
            sx, sy = rng.uniform(1.5, 5.0, 2)
            amp = rng.uniform(0.4, 1.0) * rng.choice([-1, 1])
            protos[c] += amp * np.exp(-(((xx - cx) / sx) ** 2
                                        + ((yy - cy) / sy) ** 2))
    protos = protos / np.abs(protos).max(axis=(1, 2), keepdims=True)
    labels = rng.integers(0, n_classes, n)
    imgs = protos[labels] * proto_scale + rng.normal(0, noise,
                                                     (n, side, side))
    imgs = np.clip((imgs + 1) * 127.5, 0, 255).astype(np.float32)
    return imgs.reshape(n, side * side) / 255.0, labels.astype(np.int32)


def synthetic_mnist(n=8000, seed=0):
    # noise calibrated so a single client's row-slice is weakly
    # informative but the union of slices is highly separable -- the
    # regime where the paper's collaboration gain appears (Fig. 3).
    return _image_like(n, 10, 28, noise=1.2, proto_scale=1.0, seed=seed)


def synthetic_fmnist(n=8000, seed=1):
    # harder: weaker prototypes, more noise (paper's FMNIST F1 < MNIST F1)
    return _image_like(n, 10, 28, noise=1.6, proto_scale=0.9,
                       seed=seed + 100, blobs=9)


def _tabular(n, n_features, seed, flip=0.08, sparsity=1.0):
    """Binary labels from a dense logistic ground truth over ALL features
    (every vertical slice is informative but insufficient alone)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, n_features))
    w = rng.normal(0, 1, n_features) * sparsity
    logits = x @ w / np.sqrt(n_features)
    p = 1 / (1 + np.exp(-2.5 * logits))
    y = (rng.uniform(size=n) < p).astype(np.int32)
    noise_mask = rng.uniform(size=n) < flip
    y = np.where(noise_mask, 1 - y, y)
    return x.astype(np.float32), y


def synthetic_titanic(n=891, seed=2):
    return _tabular(n, 9, seed, flip=0.10)


def synthetic_bank(n=8000, seed=3):
    return _tabular(n, 51, seed, flip=0.12)


_GENS = {
    "mnist": synthetic_mnist,
    "fmnist": synthetic_fmnist,
    "titanic": synthetic_titanic,
    "bank": synthetic_bank,
}

N_CLASSES = {"mnist": 10, "fmnist": 10, "titanic": 2, "bank": 2}


def split_train_test(x, y, test_frac=0.2):
    """THE train/test split rule for every dataset (registry-routed
    custom loaders included): the first ``test_frac`` of the draw is
    the test set.  Single implementation so the bit-for-bit parity
    between registry and direct loads cannot drift."""
    n_test = int(len(x) * test_frac)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def stack_splits(make_fn, seeds, n=None, test_frac=0.2):
    """Per-seed ``make_fn(n, seed=s, test_frac=...)`` 4-tuples stacked
    on a leading seed axis (rectangular), for seed-stacked sweeps."""
    splits = [make_fn(n, seed=s, test_frac=test_frac) for s in seeds]
    return tuple(np.stack(parts) for parts in zip(*splits))


def make_dataset(name, n=None, seed=None, test_frac=0.2):
    """Returns (x_train, y_train, x_test, y_test)."""
    kw = {}
    if n is not None:
        kw["n"] = n
    if seed is not None:
        kw["seed"] = seed
    return split_train_test(*_GENS[name](**kw), test_frac=test_frac)


def make_dataset_stack(name, seeds, n=None, test_frac=0.2):
    """Per-seed dataset draws stacked on a leading seed axis:
    (x_train, y_train, x_test, y_test), each [n_seeds, ...].  Seed s's
    slice is ``make_dataset(name, n, seed=s)``."""
    def mk(n, seed=None, test_frac=0.2):
        return make_dataset(name, n, seed=seed, test_frac=test_frac)
    return stack_splits(mk, seeds, n=n, test_frac=test_frac)
