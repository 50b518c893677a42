"""The fault-injection side of the round engine: the port of
``repro.faults.engine``, a wrapper impl on the schedule four-hook
contract, so injected adversity is carried as round state (per lane in
a sweep, like staleness depth).

:class:`FaultImpl` wraps any resolved schedule impl (literal sync is
handed over as a depth-0 ``LaneScheduleImpl``) and layers, per round:

  crash      fail-stop outages drawn at ``round_start`` from per-client
             coins; a down client leaves the round's eff_mask (exact
             zero exchange and FedAvg terms, as a dead padded slot) and
             rejoins after ``dur`` rounds by a carried countdown.
  straggle   drawn clients' consumed stacks are served ``d`` steps late
             from a ring of their own past stacks (cold start:
             exchange-free zeros).
  corrupt    drawn clients' payloads are poisoned each step (NaN or a
             x1e9 explosion) BEFORE the guard screen, which must catch
             them.

After injection every consumed stack passes
``repro_torch.core.exchange.screen_exchange``: non-finite or
over-magnitude slices are replaced by that client's last good stack and
the client is quarantined out of the round's FedAvg (``fedavg_mask``).
Event counters (crash / straggle / corruption / quarantine
client-rounds) accumulate in the carried state and surface through
``telemetry``.

Coins come from the round's draws under FAULT_TAG and the fault kind,
one a client slot (``repro_torch.core.draws``), so they are bitwise
reproducible and padding-invariant.  A lane batch carries the plan's
parameters (rates, duration, delay, corruption kind) per lane.
"""
from __future__ import annotations

import torch

from repro_torch.core.exchange import screen_exchange
from repro_torch.schedule.engine import over_rows, per_slot, ring_read

# the draw tag of the fault coins (disjoint from PARTICIPATION_TAG)
FAULT_TAG = 0xFA17
_CRASH, _STRAGGLE, _CORRUPT = 1, 2, 3

# exchange-guard magnitude threshold: hidden stacks in every shipped
# config sit orders of magnitude below this, scale-corrupted ones
# orders of magnitude above
GUARD_MAX = 1e6
# the "scale" corruption factor -- finite, but far past GUARD_MAX
CORRUPT_SCALE = 1e9

_PLAN_SCALARS = ("crash_p", "crash_dur", "strag_p", "strag_d", "corrupt_p",
                 "corrupt_nan", "crash_events", "strag_events",
                 "corrupt_events", "quar_events")
_PER_CLIENT = ("crash_left", "strag_mask", "corrupt_mask", "quar", "live",
               "last_good")


def _alive_or(masked, fallback):
    """``masked`` unless it kills every client of its lane, else
    ``fallback`` (``masked``/``fallback`` [n] or [L, n])."""
    # reference: tag(masked.sum(), "declass", "fault"), the liveness bit
    return torch.where(masked.sum(-1, keepdim=True) > 0, masked, fallback)


def _per_lane_sum(v, like):
    """Sum of a per-slot [N] value within each lane, in the shape of the
    per-lane leaf ``like`` (0-d, or [L])."""
    return v.reshape(like.shape + (-1,)).sum(-1)


class FaultImpl:
    """Fault layers over an inner schedule impl.  ``max_delay`` sizes
    the straggler ring (a sweep's largest delay); ``corrupts`` is
    whether any lane may corrupt (False skips the poison, which is then
    never selected)."""

    def __init__(self, plan, inner, n_clients, batch_size, width,
                 device=None, max_delay=None, corrupts=None):
        self.plan = plan
        self.inner = inner
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        self.width = int(width)
        self.device = torch.device(device or "cpu")
        self.max_delay = max(plan.max_delay, int(max_delay or 0))
        self.corrupts = (plan.corrupt is not None if corrupts is None
                         else bool(corrupts))

    def init_state(self, sched, plan=None):
        plan = self.plan if plan is None else plan
        if plan.max_delay > self.max_delay:
            raise ValueError(f"fault plan {plan.spec!r} needs a "
                             f"straggler ring of {plan.max_delay} "
                             f"slots but this impl holds "
                             f"{self.max_delay}")
        if plan.corrupt is not None and not self.corrupts:
            raise ValueError(f"fault plan {plan.spec!r} corrupts but "
                             "this impl was built without corruption")
        n, b, w, dev = (self.n_clients, self.batch_size, self.width,
                        self.device)

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)
        f32, i32 = torch.float32, torch.int32
        st = {
            "inner": self.inner.init_state(sched),
            "crash_p": scalar(plan.crash_p, f32),
            "crash_dur": scalar(plan.max_dur, i32),
            "strag_p": scalar(plan.straggle_p, f32),
            "strag_d": scalar(plan.max_delay, i32),
            "corrupt_p": scalar(plan.corrupt_p, f32),
            "corrupt_nan": scalar(1.0 if plan.corrupt_kind == "nan"
                                  else 0.0, f32),
            "crash_left": torch.zeros(n, dtype=i32, device=dev),
            "strag_mask": torch.zeros(n, dtype=f32, device=dev),
            "corrupt_mask": torch.zeros(n, dtype=f32, device=dev),
            "quar": torch.zeros(n, dtype=f32, device=dev),
            "live": torch.zeros(n, dtype=f32, device=dev),
            "last_good": torch.zeros((n, b, w), dtype=f32, device=dev),
            "crash_events": scalar(0, i32),
            "strag_events": scalar(0, i32),
            "corrupt_events": scalar(0, i32),
            "quar_events": scalar(0, i32),
        }
        if self.max_delay > 0:
            st["ring"] = torch.zeros((self.max_delay, n, b, w), dtype=f32,
                                     device=dev)
        return st

    def lane_axes(self):
        return {"inner": None, "ring": 1,
                **{k: None for k in _PLAN_SCALARS},
                **{k: 0 for k in _PER_CLIENT}}

    def round_start(self, state, lay, draws, round_idx):
        # the inner schedule draws under its own tag, so its
        # participation stream is bit for bit the fault-free one
        inner, eff = self.inner.round_start(state["inner"], lay, draws,
                                            round_idx)
        cm = lay.client_mask
        live = cm.reshape(-1)
        n = live.shape[0]

        def coins(kind, p):
            return draws.coins(FAULT_TAG, kind, per_slot(p, n))
        # crash countdowns: tick down, then draw fresh outages among the
        # clients that are up
        left = (state["crash_left"] - 1).clamp(min=0)
        new_crash = coins(_CRASH, state["crash_p"]) * (left == 0).float()
        left = torch.where(new_crash > 0,
                           per_slot(state["crash_dur"], n), left)
        down = (left > 0).to(cm.dtype).reshape(cm.shape)
        eff = _alive_or(eff * (1.0 - down), eff)
        strag = coins(_STRAGGLE, state["strag_p"]) * live
        corrupt = coins(_CORRUPT, state["corrupt_p"]) * live

        def count(name, v):
            return state[name] + _per_lane_sum(v, state[name]).to(
                torch.int32)
        state = {
            **state, "inner": inner, "crash_left": left,
            "strag_mask": strag, "corrupt_mask": corrupt,
            "quar": torch.zeros_like(state["quar"]), "live": live,
            "crash_events": count("crash_events", new_crash * live),
            "strag_events": count("strag_events", strag),
            "corrupt_events": count("corrupt_events", corrupt),
        }
        return state, eff

    def select(self, state, h_now):
        h_ref, inner = self.inner.select(state["inner"], h_now)
        st = {**state, "inner": inner}
        n, nd = h_now.shape[0], h_now.dim()
        if self.max_delay > 0:
            # stragglers' consumed stacks are their own, d steps old
            # (ring read before push, the LaneScheduleImpl idiom)
            ring, d = st["ring"], st["strag_d"]
            old = ring_read(ring, (self.max_delay - d).clamp(
                0, self.max_delay - 1))
            sm = st["strag_mask"] * per_slot((d > 0).float(), n)
            h_ref = torch.where(over_rows(sm, nd) > 0, old, h_ref)
            st["ring"] = torch.cat([ring[1:], h_now[None]])
        if self.corrupts:
            # transport corruption of the consumed payload (pre-screen)
            nan = over_rows(per_slot(st["corrupt_nan"], n), nd)
            poison = torch.where(nan > 0, torch.full_like(h_ref, float("nan")),
                                 h_ref * CORRUPT_SCALE)
            h_ref = torch.where(over_rows(st["corrupt_mask"], nd) > 0,
                                poison, h_ref)
        # the guard: screen every consumed stack, quarantine bad slots
        h_ref, bad = screen_exchange(h_ref, st["last_good"], GUARD_MAX)
        st["last_good"] = h_ref
        st["quar"] = torch.maximum(st["quar"], bad.to(torch.float32))
        return h_ref, st

    def round_end(self, state):
        quar = _per_lane_sum(state["quar"] * state["live"],
                             state["quar_events"])
        return {**state, "inner": self.inner.round_end(state["inner"]),
                "quar_events": state["quar_events"] + quar.to(torch.int32)}

    def fedavg_mask(self, state, eff_mask):
        """Drop this round's quarantined clients from the FedAvg
        weighting -- exact-zero terms, like dead padded slots."""
        quar = state["quar"].reshape(eff_mask.shape)
        return _alive_or(eff_mask * (1.0 - quar), eff_mask)

    def telemetry(self, state):
        """Cumulative client-round event counts (per lane in a lane
        batch), as numpy arrays."""
        return {"crashes": state["crash_events"].cpu().numpy(),
                "straggles": state["strag_events"].cpu().numpy(),
                "corruptions": state["corrupt_events"].cpu().numpy(),
                "quarantined": state["quar_events"].cpu().numpy()}


def make_fault_impl(plan, inner, n_clients, batch_size, width, device=None,
                    max_delay=None, corrupts=None):
    """The fault layer of a parsed FaultPlan over a resolved schedule
    impl.  ``max_delay`` and ``corrupts`` size it for a sweep's lanes.
    Custom plans delegate to their registered factory."""
    if plan.custom is not None:
        _, make, args = plan.custom
        return make(inner=inner, n_clients=n_clients,
                    batch_size=batch_size, width=width, args=args)
    return FaultImpl(plan, inner, n_clients, batch_size, width, device,
                     max_delay=max_delay, corrupts=corrupts)
