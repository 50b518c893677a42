"""Metric taps: the port of ``repro.obs.taps``, a wrapper impl on the
schedule four-hook contract that records per-round series ON THE
DEVICE, in the round's carried state -- no host sync a step, and the
obs level is a lane axis of a sweep like staleness depth, fault rate
and wire transform.

:class:`ObsImpl` wraps any resolved schedule / fault / wire impl
(literal sync is handed over as a depth-0 ``LaneScheduleImpl``) and
sits OUTERMOST in the engine chain -- schedule -> fault -> wire -> obs
-- so it observes exactly what the inner machinery releases:

  select(state, h_now):
      h_ref, inner = inner.select(inner_state, h_now)
      record ||h_ref||_2 per client      # the released stack's norms

plus a fifth, optional hook the scheduled step calls once a step
(``make_sched_step_fn``):

  tap_step(state, losses, grads, lay) -> state
      accumulate the masked-mean loss and per-client gradient norms

The taps only read: every value they record is one the round already
computed, and nothing they write feeds back into the parameters, the
exchange or the draws -- which is why ``obs="full"`` trajectories are
BITWISE ``obs="none"`` trajectories (tests/test_torch_obs.py) and why
``obs`` is excluded from spec_hash.  Level gates (``tap_on`` for basic
and up, ``full_on`` for the per-client series) ride the state as
float32 scalars ([L] in a lane batch); a "none" lane records exact
zeros.  ``round_end`` folds the round's accumulators -- and the inner
layers' cumulative counters (guard quarantines, encoded bytes,
staleness depth), found by walking the nested ``"inner"`` chain --
into row r of the series by a scatter, which needs no host sync;
``obs_series`` copies them to the host as numpy.

Lane batches (``repro_torch.core.sweep``): per-lane leaves are [L] and
[L, R], the per-client ones [L*n] and [R, L*n] (``lane_axes``), as the
schedule, fault and wire impls lay theirs out.
"""
from __future__ import annotations

import inspect

import torch

from repro_torch.core.exchange import by_lane
from repro_torch.schedule.engine import per_slot
from repro_torch.tree import tree_leaves

# obs_series key -> carried series slot (all [rounds] or [rounds, n])
SERIES_KEYS = ("loss", "exchange_norm", "grad_norm", "quarantined",
               "encoded_bytes", "staleness")

_PER_LANE = ("tap_on", "full_on", "o_round", "o_loss", "o_steps",
             "s_loss", "s_quar", "s_bytes", "s_stale")


def _find(state, key):
    """Walk the nested impl state (outer dict, then its ``"inner"``
    chain) for a carried slot; None when no layer carries it (no fault
    plan: no quarantine counter)."""
    while isinstance(state, dict):
        if key in state:
            return state[key]
        state = state.get("inner")
    return None


def _row_sums(x):
    """Each row's sum of ``x`` [N, K] by a pairwise tree of elementwise
    adds over K (zero-padded to a power of two), so a row's bits do not
    depend on N: a GPU reduction kernel picks its summation order by the
    number of rows it reduces, and a lane batch's rows must be bitwise
    its federations' (``repro_torch.core.sweep``)."""
    k = x.shape[1]
    width = 1 << max(k - 1, 0).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _put_row(series, row, r, per_client=False):
    """``series`` with row ``r`` (its round) replaced by ``row``, by a
    scatter on the device.  One federation: ``series`` [R] or, per
    client, [R, n], ``r`` 0-d.  A lane batch: ``r`` [L], and a per-lane
    series [L, R] with ``row`` [L], or a per-client one [R, L*n] with
    ``row`` [L*n]."""
    row = row.to(series.dtype)
    if r.dim() == 0:
        idx = r.reshape((1,) * series.dim()).expand((1,) + series.shape[1:])
        return series.scatter(0, idx, row.reshape((1,) + series.shape[1:]))
    if per_client:
        return series.scatter(0, per_slot(r, row.shape[0])[None], row[None])
    return series.scatter(1, r[:, None], row[:, None])


class ObsImpl:
    """Metric taps layered over an inner schedule/fault/wire impl,
    carried as round state.  Per-lane level gates select what is
    recorded; ``rounds`` sizes the series."""

    def __init__(self, plan, inner, n_clients, batch_size, width,
                 rounds, device=None):
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        self.plan = plan
        self.inner = inner
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        self.width = int(width)
        self.rounds = int(rounds)
        self.device = torch.device(device or "cpu")
        # tap work ABOVE this level is not computed at all (a basic-only
        # session never takes stack or grad norms); a sweep of mixed
        # levels builds the impl at the highest one and the gates
        # select per lane
        self.static_level = int(plan.level)
        # WireImpl.init_state takes plan= and wire=; FaultImpl's takes
        # plan=; LaneScheduleImpl's takes neither
        self._inner_kws = {
            k for k in ("plan", "wire")
            if k in inspect.signature(inner.init_state).parameters}

    def init_state(self, sched, plan=None, wire=None, obs=None):
        obs = self.plan if obs is None else obs
        if obs.custom is not None:
            raise ValueError(
                f"custom obs plan {obs.spec!r} cannot ride an obs "
                "lane state; it provides its own impl")
        if obs.level > self.static_level:
            raise ValueError(
                f"obs level {obs.spec!r} exceeds the level this impl "
                f"was compiled for ({self.plan.spec!r}); build the "
                "impl from the highest stacked level")
        kw = {}
        for name, val in (("plan", plan), ("wire", wire)):
            if val is not None:
                if name not in self._inner_kws:
                    raise ValueError(
                        f"{name}= given but the inner impl's "
                        f"init_state does not take it")
                kw[name] = val
        n, R, dev = self.n_clients, self.rounds, self.device
        f32, i32 = torch.float32, torch.int32

        def zeros(shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return {
            "inner": self.inner.init_state(sched, **kw),
            # the level gates
            "tap_on": torch.tensor(1.0 if obs.level >= 1 else 0.0,
                                   dtype=f32, device=dev),
            "full_on": torch.tensor(1.0 if obs.level >= 2 else 0.0,
                                    dtype=f32, device=dev),
            # the round index (round_start stores it; round_end writes
            # the series row)
            "o_round": zeros((), i32),
            # per-round accumulators, zeroed every round_start
            "o_loss": zeros(()),
            "o_steps": zeros(()),
            "o_exn": zeros((n,)),
            "o_gn": zeros((n,)),
            # per-round series (the obs_series payload)
            "s_loss": zeros((R,)),
            "s_exn": zeros((R, n)),
            "s_gn": zeros((R, n)),
            "s_quar": zeros((R,), i32),
            "s_bytes": zeros((R,), i32),
            "s_stale": zeros((R,), i32),
        }

    def lane_axes(self):
        return {"inner": None, **{k: None for k in _PER_LANE},
                "o_exn": 0, "o_gn": 0, "s_exn": 1, "s_gn": 1}

    def round_start(self, state, lay, draws, round_idx):
        # the inner engine sees the untouched draws, so its
        # participation/fault/wire streams are bit for bit the obs-free
        # ones
        inner, eff = self.inner.round_start(state["inner"], lay, draws,
                                            round_idx)
        z = torch.zeros_like
        state = {**state, "inner": inner,
                 "o_round": torch.full_like(state["o_round"], round_idx),
                 "o_loss": z(state["o_loss"]),
                 "o_steps": z(state["o_steps"]),
                 "o_exn": z(state["o_exn"]),
                 "o_gn": z(state["o_gn"])}
        return state, eff

    def select(self, state, h_now):
        st = dict(state)
        h_ref, st["inner"] = self.inner.select(st["inner"], h_now)
        # per-client L2 norm of the RELEASED stack (post-wire,
        # post-schedule): what crossed to peers this step
        if self.static_level >= 2:
            # reference: tag(sqrt(sum(h_ref^2)), "declass", "obs")
            exn = torch.sqrt(_row_sums((h_ref * h_ref).flatten(1)))
            st["o_exn"] = st["o_exn"] + \
                per_slot(st["full_on"], exn.shape[0]) * exn
        return h_ref, st

    def tap_step(self, state, losses, grads, lay):
        """The fifth (optional) hook: called by the scheduled step once a
        step with the per-client loss vector [N] and the per-client
        gradient tree the step computed, before ``opt.update`` can touch
        them.  Pure recording -- the returned state differs only in
        accumulators."""
        st = dict(state)
        m = lay.client_mask
        loss = (by_lane(losses, m) * m).sum(-1) / m.sum(-1).clamp(min=1.0)
        # reference: tag(loss, "declass", "obs")
        st["o_loss"] = st["o_loss"] + st["tap_on"] * loss
        st["o_steps"] = st["o_steps"] + st["tap_on"]
        if self.static_level >= 2:
            flat = torch.cat([g.flatten(1) for g in tree_leaves(grads)], 1)
            gn2 = _row_sums(flat * flat)
            # reference: tag(sqrt(gn2), "declass", "obs")
            st["o_gn"] = st["o_gn"] + \
                per_slot(st["full_on"], gn2.shape[0]) * torch.sqrt(gn2)
        return st

    def round_end(self, state):
        st = dict(state)
        # inner FIRST: the fault layer folds this round's quarantine
        # events into its cumulative counter in round_end, and the
        # series row must include them
        st["inner"] = self.inner.round_end(st["inner"])
        r = st["o_round"].clamp(0, self.rounds - 1)
        steps = st["o_steps"].clamp(min=1.0)
        on = st["tap_on"] > 0
        n = st["o_exn"].shape[0]
        st["s_loss"] = _put_row(st["s_loss"], st["o_loss"] / steps, r)
        for skey, okey in (("s_exn", "o_exn"), ("s_gn", "o_gn")):
            st[skey] = _put_row(st[skey], st[okey] / per_slot(steps, n), r,
                                per_client=True)
        # the inner layers' cumulative counters, read from the nested
        # state: absent layers record zeros
        zero = torch.zeros((), dtype=torch.int32, device=r.device)
        for skey, ikey in (("s_quar", "quar_events"),
                           ("s_bytes", "enc_bytes"),
                           ("s_stale", "k")):     # staleness: ring lanes
            v = _find(st["inner"], ikey)
            v = zero if v is None else v
            st[skey] = _put_row(st[skey], torch.where(on, v, zero), r)
        return st

    @property
    def identity_select(self):
        """The taps only READ ``h_ref``; whether select is the identity
        is the inner engine's property."""
        return getattr(self.inner, "identity_select", False)

    # ------------------------------------------------------------------
    # pass-through hooks: the obs layer is observation-only, so the
    # inner machinery's aggregation mask and telemetry surface
    # unchanged through the outermost wrapper
    def fedavg_mask(self, state, eff_mask):
        fam = getattr(self.inner, "fedavg_mask", None)
        return eff_mask if fam is None else fam(state["inner"], eff_mask)

    def telemetry(self, state):
        tel = getattr(self.inner, "telemetry", None)
        return None if tel is None else tel(state["inner"])

    def wire_telemetry(self, state):
        tel = getattr(self.inner, "wire_telemetry", None)
        return None if tel is None else tel(state["inner"])

    # ------------------------------------------------------------------
    def obs_series(self, state):
        """The recorded per-round series of a carried state as numpy
        arrays keyed by :data:`SERIES_KEYS`: [R] and [R, n] for one
        federation, [L, R] and [L, R, n] for a lane batch."""
        out = {k: state[s].cpu().numpy() for k, s in (
            ("loss", "s_loss"), ("exchange_norm", "s_exn"),
            ("grad_norm", "s_gn"), ("quarantined", "s_quar"),
            ("encoded_bytes", "s_bytes"), ("staleness", "s_stale"))}
        if out["loss"].ndim == 2:                   # a lane batch
            n_lanes, rounds = out["loss"].shape
            for k in ("exchange_norm", "grad_norm"):
                out[k] = out[k].reshape(rounds, n_lanes, -1).transpose(
                    1, 0, 2)
        return out


def make_obs_impl(plan, inner, n_clients, batch_size, width, rounds,
                  device=None):
    """The obs layer of a parsed ObsPlan over a resolved
    schedule/fault/wire impl.  Custom plans delegate to their registered
    factory."""
    if plan.custom is not None:
        _, make, args = plan.custom
        return make(inner=inner, n_clients=n_clients,
                    batch_size=batch_size, width=width, rounds=rounds,
                    args=args)
    return ObsImpl(plan, inner, n_clients, batch_size, width, rounds,
                   device)
