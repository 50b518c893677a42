"""Divergence recovery: the port of ``repro.faults.recovery``, the
watchdog policy ``Session.run`` drives when a fault plan is active (or
when handed an explicit policy).

The watchdog inspects each round's loss stream on the host; a
non-finite value or a magnitude past ``loss_threshold`` trips it.  On a
trip the session rolls the carried training state back to its last good
snapshot (taken after every successful round) and retries the round
from a RESEEDED stream: its batches from ``round_generator(seed, r,
attempt)`` and its coins and noise from ``CounterDraws.round(r,
attempt)``, both keyed further by ``(RESEED_TAG, attempt)``, so the
retry's draws are fresh but deterministic and the whole recovery is
bitwise reproducible.  Consecutive failures of one round back off
exponentially (``backoff * 2**(attempt-1)``, capped) and exhaust into
:class:`DivergenceError` with the knobs to turn.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the draw tag of a retry's reseeded stream (disjoint from
# PARTICIPATION_TAG = 0x5EED and FAULT_TAG = 0xFA17)
RESEED_TAG = 0x0DD5


class DivergenceError(RuntimeError):
    """A round kept diverging through every reseeded retry the policy
    allowed.  The message names the round, the trip condition, and the
    recovery knobs (RetryPolicy.max_retries / loss_threshold, the fault
    rate, the learning rate)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Divergence-watchdog policy for ``Session.run(retry=...)``.

    ``max_retries`` bounds reseeded retries PER ROUND (consecutive
    failures; the counter resets on any successful round).  ``backoff``
    is the base sleep in seconds before retry ``a`` (``backoff *
    2**(a-1)``, capped at ``backoff_cap``; 0 disables sleeping -- the
    default, since simulated faults don't heal with time).
    ``loss_threshold`` trips the watchdog on any round loss with
    magnitude above it; non-finite losses always trip."""
    max_retries: int = 2
    backoff: float = 0.0
    backoff_cap: float = 30.0
    loss_threshold: float = 1e4

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff < 0 or self.backoff_cap < 0:
            raise ValueError("backoff and backoff_cap must be >= 0")
        if not self.loss_threshold > 0:
            raise ValueError(f"loss_threshold must be > 0, got "
                             f"{self.loss_threshold}")

    def sleep_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        if self.backoff <= 0:
            return 0.0
        return min(self.backoff * 2.0 ** (attempt - 1),
                   self.backoff_cap)


def diverged(losses, loss_threshold: float) -> bool:
    """Host-side watchdog predicate over a round's loss stream."""
    a = np.asarray(losses)
    return bool((~np.isfinite(a)).any()
                or (np.abs(a) > loss_threshold).any())
