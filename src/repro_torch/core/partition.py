"""Vertical partitioning (Algorithm 1 line 3) and the canonical
slice-aware layout the protocol engine trains on: the port of
``repro.core.partition``.

Partitioning distributes dataset features across participants: image
datasets are dealt row-by-row round-robin (Fig. 2); tabular datasets
round-robin or random.

``canonicalize`` permutes the dataset columns once at setup so client i
owns the contiguous slice ``[offset_i, offset_i + F_i)`` of the
reordered feature axis.  Reordering columns of x while keeping W's row
init order is semantics-preserving -- the first layer is a sum over
feature columns -- so random partitions (titanic) remain the same
experiment.  ``perm`` maps canonical column j back to original feature
``perm[j]``; ``Layout.apply`` re-expresses raw [..., F] data in
canonical order.

``Layout.pad(max_clients)`` appends dead client slots (empty slice,
all-zero mask); ``LayoutArrays.client_mask`` is the runtime 0/1 view of
which slots are live, and the protocol multiplies it into the exchange
sum, the FedAvg weighting and every loss mean, so dead slots contribute
exact zeros and a padded federation's live clients train bit-for-bit
like the unpadded run.

Everything here is numpy except ``Layout.arrays``, which builds the
torch view on the federation's device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data import registry as DR
from repro_torch.data import vertical as V


def make_partition(dataset: str, n_features: int, n_clients: int, seed=0):
    """Returns list of per-client sorted feature-index arrays, by the
    dataset registry entry's partition strategy ("image_rows",
    "random", "round_robin" or a callable)."""
    kind = DR.get_dataset(dataset).partition
    if callable(kind):
        return kind(n_features, n_clients, seed)
    if kind == "image_rows":
        side = int(round(n_features ** 0.5))
        return V.round_robin_rows(n_clients, side)
    if kind == "random":
        return V.random_features(n_features, n_clients, seed)
    return V.round_robin_features(n_features, n_clients)


def skewed_partition(n_features: int, sizes: Sequence[int], seed=0):
    """A partition with EXPLICIT unequal per-client feature counts: a
    seeded permutation of the feature ids split at the cumulative
    ``sizes`` (each client's ids sorted).  ``sizes`` must be positive
    and sum to ``n_features``."""
    sizes = tuple(int(s) for s in sizes)
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"sizes must be positive ints, got {sizes}")
    if sum(sizes) != n_features:
        raise ValueError(f"sizes {sizes} sum to {sum(sizes)}, not "
                         f"n_features={n_features}")
    ids = np.random.default_rng(seed).permutation(n_features)
    return [np.sort(p) for p in
            np.split(ids, np.cumsum(sizes)[:-1])]


def masks_for(partition, n_features, dtype=np.float32):
    """[n_clients, n_features] 0/1 masks (the zero-padding operators)."""
    return np.stack([V.feature_mask(idx, n_features, dtype)
                     for idx in partition])


class LayoutArrays(NamedTuple):
    """The tensor view of a Layout on the federation's device:

      masks        [n_clients, n_features] float32 contiguous-slab
                   zeropad masks (canonical order) -- the masked lane
      offsets      [n_clients] int32 slice starts (dead clients: 0)
      sizes        [n_clients] int32 slice lengths (dead clients: 0)
      client_mask  [n_clients] float32, 1.0 = live, 0.0 = padding
    """
    masks: torch.Tensor
    offsets: torch.Tensor
    sizes: torch.Tensor
    client_mask: torch.Tensor


@dataclass(frozen=True, eq=False)
class Layout:
    """Canonical feature layout for one federation.

    partition   per-client ORIGINAL feature ids (what each client owns)
    perm        [F] canonical column j holds original feature perm[j]
    inv_perm    [F] original feature f lives at canonical column
                inv_perm[f]
    offsets     per-client canonical slice starts (python ints)
    sizes       per-client slice lengths F_i (0 for dead padding slots)
    block       largest bk <= 128 dividing every live size -- the Pallas
                kernel's alignment rule, kept for parity with the JAX
                package; the port's kernel takes any offsets and sizes
    n_real      number of LIVE participants
    """
    partition: Tuple[np.ndarray, ...]
    perm: np.ndarray
    inv_perm: np.ndarray
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    block: int
    n_features: int
    n_real: int

    @property
    def n_clients(self) -> int:
        """Padded client-axis length (== n_real for unpadded layouts)."""
        return len(self.sizes)

    def apply(self, x):
        """Re-express raw [..., F] data in canonical column order."""
        return x[..., self.perm]

    def masks(self, dtype=np.float32):
        """Contiguous-slab zeropad masks in canonical column order.
        Dead (padded) clients get all-zero rows."""
        m = np.zeros((self.n_clients, self.n_features), dtype)
        for i, (off, sz) in enumerate(zip(self.offsets, self.sizes)):
            m[i, off:off + sz] = 1
        return m

    def client_mask(self, dtype=np.float32):
        """[n_clients] 1.0 for live participants, 0.0 for padding."""
        return (np.arange(self.n_clients) < self.n_real).astype(dtype)

    def pad(self, max_clients: int) -> "Layout":
        """Append dead client slots (empty slice at offset 0) until the
        client axis has length ``max_clients``."""
        if max_clients < self.n_clients:
            raise ValueError(f"max_clients={max_clients} < existing "
                             f"client axis {self.n_clients}")
        k = max_clients - self.n_clients
        if k == 0:
            return self
        empty = tuple(np.empty((0,), self.partition[0].dtype)
                      for _ in range(k))
        return dataclasses.replace(
            self, partition=self.partition + empty,
            offsets=self.offsets + (0,) * k,
            sizes=self.sizes + (0,) * k)

    def arrays(self, device) -> LayoutArrays:
        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=device)
        return LayoutArrays(masks=t(self.masks(), torch.float32),
                            offsets=t(self.offsets, torch.int32),
                            sizes=t(self.sizes, torch.int32),
                            client_mask=t(self.client_mask(),
                                          torch.float32))


def _block_of(sizes: Sequence[int], cap: int = 128) -> int:
    g = 0
    for s in sizes:
        g = math.gcd(g, int(s))
    if g == 0:
        return 1
    return max(d for d in range(1, min(g, cap) + 1) if g % d == 0)


def canonicalize(partition, n_features: int) -> Layout:
    """Build the canonical contiguous layout for a partition: column j
    of the canonical order is original feature ``perm[j]``, client i's
    features occupy ``[offset_i, offset_i + F_i)``."""
    parts = tuple(np.asarray(p) for p in partition)
    perm = np.concatenate(parts).astype(np.int64)
    if perm.size != n_features or np.unique(perm).size != n_features:
        raise ValueError("partition must be disjoint and cover all "
                         f"{n_features} features (got {perm.size} ids, "
                         f"{np.unique(perm).size} unique)")
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_features)
    sizes = tuple(int(len(p)) for p in parts)
    offsets = tuple(int(o) for o in
                    np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    return Layout(partition=parts, perm=perm, inv_perm=inv_perm,
                  offsets=offsets, sizes=sizes,
                  block=_block_of(sizes), n_features=n_features,
                  n_real=len(parts))


def make_layout(dataset: str, n_features: int, n_clients: int,
                seed=0, max_clients=None, sizes=None) -> Layout:
    """Partition + canonicalize (+ optional padding) in one call.
    ``sizes`` overrides the registry partition strategy with a skewed
    split of explicit per-client feature counts."""
    if sizes is not None:
        if len(sizes) != n_clients:
            raise ValueError(f"sizes has {len(sizes)} entries for "
                             f"n_clients={n_clients}")
        part = skewed_partition(n_features, sizes, seed=seed)
    else:
        part = make_partition(dataset, n_features, n_clients, seed=seed)
    lay = canonicalize(part, n_features)
    return lay if max_clients is None else lay.pad(max_clients)
