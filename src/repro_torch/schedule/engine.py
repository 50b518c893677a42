"""The schedule-aware side of the round engine: the port of
``repro.schedule.engine``.  Schedule impls (the state machines a round
carries) and the devertifl step that consumes them.

Every impl implements the four-hook contract the round drives:

  init_state(sched) -> dict
      The schedule's carried state.  Buffers are float32 zeros, so the
      first consumed exchanges of a cold start are exact-zero "no peers
      yet" terms.
  round_start(state, lay, draws, round_idx) -> (state, eff_mask)
      Called once a round with the round's draws
      (``repro_torch.core.draws.RoundDraws``).  eff_mask is
      ``lay.client_mask`` composed with the round's participation, and
      weights both the exchange sum and the FedAvg.
  select(state, h_now) -> (h_ref, state)
      Called once a step with the detached CURRENT stack ``h_now [n,
      B, W]``: returns the reference stack whose masked sum peers
      consume this step, and the advanced state.
  round_end(state) -> state
      Called after the round's steps (double_buffer's swap).

A fifth hook is optional: ``tap_step(state, losses, grads, lay) ->
state``, the obs taps (``repro_torch.obs.taps``), called once a step
with the per-client losses and gradients the step computed.

Lane batches (``repro_torch.core.sweep``): the client axis holds L lanes
of ``n_clients`` slots and ``lay.client_mask`` is [L, n_clients]; a
per-client leaf carries every slot ([L*n, ...] on its client axis), a
per-lane plan scalar is [L] and applies to its lane's slots.  Each
impl's ``lane_axes()`` names the client axis of every leaf (None for a
per-lane scalar), which is how ``stack_lane_states`` builds a lane
batch's state from single-lane ones.

One forward a step.  The reference's ring formulation pays a second
forward pass to get ``h_now`` before ``jax.grad``.  The port takes the
per-client stack once, with its graph, and hands ``h_all.detach()`` to
``select``: the values are the same bits, and the kernel lane keeps one
``vfl_matmul`` launch a step under every schedule.  The masked and
slice/kernel families keep the sync step's reduction orders, which is
what makes ``stale_k:0`` and ``partial:1.0`` bitwise sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exchange import by_lane, scheduled_exchange

# the draw tag of the per-round participation coins
PARTICIPATION_TAG = 0x5EED


def lane_value(v, client_mask):
    """A per-lane value (0-d, or [L] in a lane batch) shaped to
    broadcast against ``client_mask`` ([n] or [L, n])."""
    return v if client_mask.dim() == 1 else v.reshape(v.shape + (1,))


def per_slot(v, n_slots):
    """A per-lane value on every client slot: 0-d stays 0-d (it
    broadcasts), [L] becomes [n_slots] (lane-major)."""
    return v if v.dim() == 0 else v.repeat_interleave(n_slots // v.shape[0])


def over_rows(v, ndim):
    """A 0-d or per-slot [n] value shaped to broadcast over an [n, ...]
    stack of ``ndim`` dims."""
    return v if v.dim() == 0 else v.reshape(v.shape + (1,) * (ndim - 1))


def ring_read(buf, idx):
    """``buf[idx]`` of a ring [k, n, ...] for a 0-d index, or each
    slot's own ``buf[idx[i], i]`` for a per-lane [L] index."""
    if idx.dim() == 0:
        return torch.index_select(buf, 0, idx.reshape(1)).squeeze(0)
    n = buf.shape[1]
    slot = torch.arange(n, device=buf.device)
    return buf[per_slot(idx, n), slot]


def participation_mask(sched_state, lay, draws, round_idx):
    """The round's effective participation mask: ``client_mask``
    composed with a Bernoulli(p) coin a client (or a deterministic
    rotating keep-set), guarded so at least one live client always
    participates.  With p == 1.0 every value is ``lay.client_mask``'s
    bits (x * 1.0 keeps them; the uniform is strictly < 1.0)."""
    cm = lay.client_mask
    p, det = lane_value(sched_state["p"], cm), sched_state["det"]
    n = cm.shape[-1]
    bern = draws.coins(PARTICIPATION_TAG, 0,
                       p.expand(cm.shape).reshape(-1))
    bern = bern.reshape(cm.shape).to(cm.dtype)
    n_live = cm.sum(-1, keepdim=cm.dim() > 1).to(torch.int32)
    keep = torch.round(p * n_live.to(cm.dtype)).to(torch.int32).clamp(min=1)
    rank = torch.remainder(
        torch.arange(n, dtype=torch.int32, device=cm.device)
        + int(round_idx), n_live.clamp(min=1))
    rot = (rank < keep).to(cm.dtype)
    part = torch.where(lane_value(det, cm) > 0, rot, bern)
    eff = cm * part
    return torch.where(eff.sum(-1, keepdim=True) > 0, eff, cm)


class LaneScheduleImpl:
    """The sync / stale_k / partial family, its depth ``k``,
    participation ``p`` and deterministic flag carried in the state (per
    lane in a sweep), so lanes of different (k, p) share one round.
    ``max_k`` sizes the ring; a lane reads ``k <= max_k`` steps back.
    ``fixed_k``: every state has ``k == max_k`` (one federation), so the
    read is the ring's oldest slot, a view.

    Ring semantics, the reference's layout: ``select`` at step t sees
    ``buf[max_k - j]`` as the stack pushed j steps ago, consumes
    ``buf[max_k - k]`` (k = 0 consumes ``h_now`` itself), then pushes
    ``h_now`` at the end."""

    def __init__(self, max_k, n_clients, batch_size, width, device=None,
                 fixed_k=False):
        if max_k < 0:
            raise ValueError(f"max_k must be >= 0, got {max_k}")
        self.max_k = int(max_k)
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        self.width = int(width)
        self.device = torch.device(device or "cpu")
        self.fixed_k = bool(fixed_k)

    def init_state(self, sched):
        if sched.k > self.max_k:
            raise ValueError(f"schedule {sched.spec!r} needs a ring of "
                             f"{sched.k} slots but this impl holds "
                             f"{self.max_k}")
        if self.fixed_k and sched.k != self.max_k:
            raise ValueError(f"schedule {sched.spec!r} reads {sched.k} "
                             f"steps back; this impl reads {self.max_k}")
        dev = self.device
        st = {"k": torch.tensor(sched.k, dtype=torch.int32, device=dev),
              "p": torch.tensor(sched.p, dtype=torch.float32, device=dev),
              "det": torch.tensor(float(sched.deterministic),
                                  dtype=torch.float32, device=dev)}
        if self.max_k > 0:
            st["buf"] = torch.zeros(
                (self.max_k, self.n_clients, self.batch_size, self.width),
                dtype=torch.float32, device=dev)
        return st

    def lane_axes(self):
        return {"k": None, "p": None, "det": None, "buf": 1}

    def round_start(self, state, lay, draws, round_idx):
        return state, participation_mask(state, lay, draws, round_idx)

    def select(self, state, h_now):
        if self.max_k == 0:
            return h_now, state
        buf = state["buf"]
        if self.fixed_k:
            h_ref = buf[0]
        else:
            k = state["k"]
            stale = ring_read(buf, (self.max_k - k).clamp(0, self.max_k - 1))
            k_rows = over_rows(per_slot(k, h_now.shape[0]), h_now.dim())
            h_ref = torch.where(k_rows > 0, stale, h_now)
        return h_ref, {**state, "buf": torch.cat([buf[1:], h_now[None]])}

    def round_end(self, state):
        return state


class DoubleBufferImpl:
    """Round-granularity pipelining: every step of round t consumes the
    ``front`` slot -- the stack captured at the end of round t-1 (zeros
    in round 0) -- while each step overwrites ``back`` with its current
    stack; ``round_end`` promotes back to front."""

    def __init__(self, n_clients, batch_size, width, device=None):
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        self.width = int(width)
        self.device = torch.device(device or "cpu")

    def init_state(self, sched):
        z = torch.zeros((self.n_clients, self.batch_size, self.width),
                        dtype=torch.float32, device=self.device)
        return {"front": z, "back": z}

    def lane_axes(self):
        return {"front": 0, "back": 0}

    def round_start(self, state, lay, draws, round_idx):
        return state, lay.client_mask

    def select(self, state, h_now):
        return state["front"], {**state, "back": h_now}

    def round_end(self, state):
        return {"front": state["back"], "back": state["back"]}


def make_schedule_impl(sched, n_clients, batch_size, width, device=None,
                       max_k=None):
    """The impl of a parsed Schedule.  ``max_k`` sizes the ring for
    lanes of several depths (a sweep's largest k); without it the ring
    is the schedule's own depth and every read its oldest slot."""
    if sched.custom is not None:
        _, make, args = sched.custom
        return make(n_clients=n_clients, batch_size=batch_size,
                    width=width, args=args)
    if sched.double_buffer:
        return DoubleBufferImpl(n_clients, batch_size, width, device)
    return LaneScheduleImpl(sched.k if max_k is None else max_k,
                            n_clients, batch_size, width, device,
                            fixed_k=max_k is None)


def promote_sync(impl, n_clients, batch_size, width, device=None):
    """The impl a fault or wire layer wraps: ``impl``, or for literal
    sync (None) the depth-0 ring, ``stale_k:0``, bitwise sync."""
    return impl if impl is not None else LaneScheduleImpl(
        0, n_clients, batch_size, width, device)


def stack_lane_states(impl, states):
    """One lane batch's state from per-lane-block states (each built by
    ``impl.init_state``, a block being the lanes of one (schedule,
    fault, transform) value: ``(state, n_lanes)`` pairs, in lane
    order): per-client leaves concatenated on their client axis, one
    block repeated ``n_lanes`` times; per-lane leaves stacked to [L,
    ...]."""
    def stack(axes, leaves):
        if isinstance(axes, dict):
            return {k: stack(axes[k], [(s[k], n) for s, n in leaves])
                    for k in axes if k in leaves[0][0]}
        first = leaves[0][0]
        if axes is None:
            if isinstance(first, np.ndarray):
                return np.concatenate([np.broadcast_to(
                    v, (n,) + v.shape) for v, n in leaves])
            return torch.cat([v.expand((n,) + v.shape) for v, n in leaves])
        return torch.cat([v for v, n in leaves for _ in range(n)],
                         dim=axes)

    return stack(lane_axes(impl), states)


def lane_axes(impl):
    """``impl.lane_axes()`` with each wrapper's ``inner`` resolved."""
    axes = impl.lane_axes()
    if "inner" in axes:
        axes = {**axes, "inner": lane_axes(impl.inner)}
    return axes


def make_sched_step_fn(model, opt, pcfg, impl, layout, device,
                       first_layer_fn=None):
    """One schedule-aware devertifl optimizer step:

      step(params, opt_state, lay, eff_mask, sstate, xb, yb, step_idx)
        -> (params, opt_state, sstate, loss)

    The current stack ``h_all`` is computed once with its graph; the
    impl picks the reference stack from ``h_all.detach()`` (current,
    stale or front buffer); each client trains on its OWN hidden output
    plus the eff_mask-weighted sum of the reference stack less its own
    reference term.  The loss is the mean over LIVE clients (dropped
    participants keep training locally); only the exchange sum and the
    FedAvg honour eff_mask.  ``first_layer_fn`` is make_step_fn's.
    """
    from repro_torch.core import protocol as P
    if pcfg.mode != "devertifl":
        raise ValueError(f"schedules beyond 'sync' require "
                         f"mode='devertifl', got {pcfg.mode!r}")
    fl = P.resolve_first_layer(pcfg, device)
    k = pcfg.exchange_at
    # the fifth (optional) impl hook: the obs taps record the loss vector
    # and grads the step already computed; None for every tap-free impl
    tap = getattr(impl, "tap_step", None)

    def update(params, opt_state, sstate, losses, grads, lay, step_idx):
        # the taps read the raw grads BEFORE opt.update, which may clip
        # them; they only record, so the reference's call after its
        # (functional) update sees the same values
        if tap is not None:
            sstate = tap(sstate, losses, grads, lay)
        params, opt_state, _ = opt.update(grads, opt_state, params,
                                          step_idx)
        return params, opt_state, sstate

    if fl == "masked":
        def step(params, opt_state, lay, eff_mask, sstate, xb, yb,
                 step_idx):
            ps = P._leaf_copies(params)
            h_all = P.client_hidden(model, k, ps, P._masked_input(xb, lay))
            h_ref, sstate = impl.select(sstate, h_all.detach())
            # the sync masked step's order: client i consumes h_i +
            # (masked total) - (own reference term)
            h_sum = P._to_clients(P._masked_hidden_sum(h_ref, eff_mask),
                                  eff_mask)
            own = h_ref * eff_mask.reshape(-1, 1, 1)
            losses = P._ce(P.rest(model, k, ps, h_all + h_sum - own), yb)
            losses, grads = losses.detach(), P._grads(losses.sum(), ps)
            params, opt_state, sstate = update(params, opt_state, sstate,
                                               losses, grads, lay, step_idx)
            return (params, opt_state, sstate,
                    P._masked_mean(losses, lay.client_mask))
        return step

    first = first_layer_fn or P.make_first_layer_fn(model, pcfg, layout,
                                                    device)

    def step(params, opt_state, lay, eff_mask, sstate, xb, yb, step_idx):
        ps = P._leaf_copies(params)
        h_all = P.client_hidden_from(model, k, ps, first(ps, xb, lay))
        h_ref, sstate = impl.select(sstate, h_all.detach())
        h = scheduled_exchange(h_all, h_ref, eff_mask)
        losses = P._ce(P.rest(model, k, ps, h), yb)
        cm = lay.client_mask
        grads = P._grads(by_lane(losses, cm) * cm, ps)
        losses = losses.detach()
        params, opt_state, sstate = update(params, opt_state, sstate,
                                           losses, grads, lay, step_idx)
        return (params, opt_state, sstate, P._masked_mean(losses, cm))
    return step
