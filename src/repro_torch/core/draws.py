"""Counter-based coins and noise for the round engine's schedule, fault
and wire layers.

The JAX package folds tags into a threefry round key: participation
coins from ``fold_in(fold_in(rkey, 0x5EED), i)``, fault coins from
``fold_in(fold_in(fold_in(rkey, 0xFA17), kind), i)``, ``dp`` noise from
``normal(fold_in(fold_in(fold_in(rkey, 0xC0DE), step), i))``, and a
retried round from ``fold_in(fold_in(rkey, RESEED_TAG), attempt)``.  It
always draws per client, so padding leaves the live clients' draws
unchanged.

The port's round stream is ``round_generator(seed, r)``, so there is no
round key to fold into.  Every draw here is instead a hash of its
coordinates ``(seed, round, [RESEED_TAG, attempt], tag, kind or step,
client slot, element)``: a 32-bit mixer applied in int64 tensor ops,
each product kept below 2^63 (the multipliers are under 2^31), so it is
exact on any device.  Three properties follow:

  * a client's coins and noise depend on its seed and slot alone, not
    on the client count or on padding;
  * a sweep lane, whose slots carry its own seed and slot numbers,
    draws bitwise what its standalone federation draws;
  * one step's noise for every slot of every lane is a fixed handful of
    elementwise launches, whatever the number of clients.

A coin is ``u < p`` for a uniform ``u`` in [0, 1) on a 2^-24 grid (so
``p = 1.0`` is always heads); noise is Box-Muller over two uniforms.
The impls take their draws through one object a round,
:class:`RoundDraws` (``CounterDraws.round(r, attempt)``); a test can
hand them another with the same three methods.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.faults.recovery import RESEED_TAG

_MASK = 0xFFFFFFFF
# odd multipliers under 2^31: x * C stays below 2^63 for x < 2^32
_C1, _C2 = 0x7FEB352D, 0x5BD1E995
_SALT = 0x9E3779B9
_U24 = 2.0 ** -24


def _fmix(x):
    """A bijective 32-bit mixer over python ints, uint64 numpy arrays or
    int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _C2) & _MASK
    return x ^ (x >> 16)


def _mix(h, v: int):
    """``h`` keyed further by the integer ``v`` (any size)."""
    v = int(v)
    for word in (v & _MASK, (v >> 32) & _MASK):
        h = _fmix(h ^ _fmix(word ^ _SALT))
    return h


def _unit(h):
    """[0, 1) float32 uniforms from 32-bit hashes (their top 24 bits)."""
    return (h >> 8).to(torch.float32) * _U24


class RoundDraws:
    """One round's draws for ``n`` client slots: per-slot keys on the
    host, drawn from on the device."""

    def __init__(self, base: np.ndarray, slots: np.ndarray, lanes, device):
        self._base = base               # [n] uint64 keys after (seed, r)
        self._slots = slots             # [n] slot index within its lane
        self._lanes = lanes             # lanes of n // lanes slots, or None
        self._device = device
        self._noise_keys = {}
        self._elements = {}

    def _keys(self, *fields) -> np.ndarray:
        h = self._base
        for f in fields:
            h = _mix(h, f)
        return _fmix(h ^ _fmix(self._slots ^ np.uint64(_SALT)))

    def _tensor(self, keys) -> torch.Tensor:
        return torch.from_numpy(keys.astype(np.int64)).to(self._device)

    def coins(self, tag: int, kind: int, p) -> torch.Tensor:
        """[n] float32 0/1 coins, heads with probability ``p`` (a float
        or an [n] tensor: each slot's own)."""
        u = _unit(self._tensor(self._keys(tag, kind)))
        return (u < p).to(torch.float32)

    def normal(self, tag: int, step: int, shape) -> torch.Tensor:
        """[n, *shape] standard normals for in-round step ``step``."""
        keys = self._noise_keys.get(tag)
        if keys is None:
            keys = self._noise_keys[tag] = self._tensor(self._keys(tag))
        numel = math.prod(shape)
        elems = self._elements.get(numel)
        if elems is None:
            e = torch.arange(numel, dtype=torch.int64, device=self._device)
            elems = self._elements[numel] = (_fmix(2 * e), _fmix(2 * e + 1))
        k = _fmix(keys ^ (_fmix(int(step) ^ _SALT) & _MASK))[:, None]
        u1 = ((_fmix(k ^ elems[0]) >> 8) + 1).to(torch.float32) * _U24
        u2 = _unit(_fmix(k ^ elems[1]))
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
        return z.reshape((len(self._slots),) + tuple(shape))

    def lane_key(self, tag: int) -> np.ndarray:
        """The round's key for ``tag`` as uint32 words, [2] (or [L, 2]
        for a lane batch): what the wire layer's ``wkey`` leaf holds."""
        per_slot = self._keys(tag)
        step = len(per_slot) // (self._lanes or 1)
        h = per_slot[::step]
        words = np.stack([h, _fmix(h ^ np.uint64(_SALT))], -1)
        words = words.astype(np.uint32)
        return words if self._lanes else words[0]


class CounterDraws:
    """The draw source of a federation (one seed, ``n`` slots) or of a
    lane batch (``lanes`` lanes of ``n // lanes`` slots, each lane its
    own seed): ``round(r, attempt)`` gives round r's draws, reseeded by
    ``(RESEED_TAG, attempt)`` when ``attempt > 0``."""

    def __init__(self, seeds, n_slots: int, device, lanes=None):
        per_lane = n_slots // (lanes or 1)
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        self._seeds = np.repeat(seeds, per_lane)
        self._slots = np.tile(np.arange(per_lane, dtype=np.uint64),
                              len(seeds))
        self._lanes = lanes
        self._device = torch.device(device)

    def round(self, r: int, attempt: int = 0) -> RoundDraws:
        base = np.zeros(len(self._seeds), np.uint64)
        base = _fmix(base ^ np.uint64(_SALT))
        for i, s in enumerate(self._seeds):
            base[i] = _mix(int(base[i]), int(s))
        base = _mix(base, r)
        if attempt > 0:
            base = _mix(_mix(base, RESEED_TAG), attempt)
        return RoundDraws(base, self._slots, self._lanes, self._device)
