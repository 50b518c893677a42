"""The exchange-transform side of the round engine: the port of
``repro.wire.engine``, a wrapper impl on the schedule four-hook
contract, so every payload crossing the (simulated) wire passes one
encode-decode round trip inside the round.

:class:`WireImpl` wraps any resolved schedule or fault impl (literal
sync is handed over as a depth-0 ``LaneScheduleImpl``) and sits
OUTERMOST in the engine chain -- schedule -> fault -> wire --
transforming the CURRENT stack before the inner machinery sees it:

  select(state, h_now):
      h_tx = decode(encode(h_now))        # topk -> int8 -> dp
      h_ref, inner = inner.select(inner_state, h_tx)

so stale rings buffer what was SENT, transport corruption poisons the
encoded payload, and the guard screens what a receiver would decode.
Each client's own hidden output in the loss is untouched: only the
released stack is transformed.

dp noise comes from the round's draws under WIRE_TAG and the in-round
step, one stream a client slot.  The state carries the plan's keep
fraction, quantize flag and noise scale (per lane in a sweep), the
round's wire key ``wkey`` (uint32 words, rewritten every round_start),
the step counter ``wstep``, the sender count ``live_n`` and the
cumulative integer bytes-on-wire, ``raw_bytes`` and ``enc_bytes``:
every step of a round ships the same bytes, so round_end adds the
round's steps times one step's bytes.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from repro_torch.analysis.barrier import tag
from repro_torch.schedule.engine import per_slot
from repro_torch.wire.codecs import WIRE_TAG, wire_apply, wire_bytes

_LANE_LEAVES = ("topk_on", "topk_p", "int8_on", "dp_on", "dp_sigma", "wkey",
                "wstep", "live_n", "raw_bytes", "enc_bytes")


class WireImpl:
    """Wire transform layered over an inner schedule/fault impl.
    ``lanes``: the WirePlans of a sweep's lanes (None: one federation
    running ``plan``, whose components are then resolved statically);
    a component no lane uses is not computed."""

    def __init__(self, plan, inner, n_clients, batch_size, width,
                 device=None, lanes=None):
        self.plan = plan
        self.inner = inner
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        self.width = int(width)
        self.device = torch.device(device or "cpu")
        self.lanes = None if lanes is None else tuple(lanes)
        plans = self.lanes or (plan,)
        self._uses = {"topk": any(w.topk is not None for w in plans),
                      "int8": any(w.int8 for w in plans),
                      "dp": any(w.dp is not None for w in plans)}
        # FaultImpl.init_state takes plan=; LaneScheduleImpl's doesn't
        self._inner_takes_plan = "plan" in inspect.signature(
            inner.init_state).parameters
        self._draws, self._step = None, 0

    def init_state(self, sched, plan=None, wire=None):
        wire = self.plan if wire is None else wire
        if wire.custom is not None:
            raise ValueError(
                f"custom transform {wire.spec!r} cannot ride a wire "
                "lane state; it provides its own impl")
        kw = {}
        if plan is not None:
            if not self._inner_takes_plan:
                raise ValueError(
                    "fault plan given but the inner impl is not a "
                    "fault impl")
            kw["plan"] = plan
        dev = self.device

        def scalar(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=dev)
        return {
            "inner": self.inner.init_state(sched, **kw),
            "topk_on": scalar(1.0 if wire.topk is not None else 0.0),
            "topk_p": scalar(wire.topk_p),
            "int8_on": scalar(1.0 if wire.int8 else 0.0),
            "dp_on": scalar(1.0 if wire.dp is not None else 0.0),
            "dp_sigma": scalar(wire.dp_sigma),
            # the round's wire key (the reference's PRNGKey leaf)
            "wkey": np.zeros(2, np.uint32),
            "wstep": scalar(0, torch.int32),
            "live_n": scalar(0.0),
            "raw_bytes": scalar(0, torch.int32),
            "enc_bytes": scalar(0, torch.int32),
        }

    def lane_axes(self):
        return {"inner": None, **{k: None for k in _LANE_LEAVES}}

    def round_start(self, state, lay, draws, round_idx):
        # the inner engine draws under its own tags, so its
        # participation/fault streams are bit for bit the wire-free ones
        inner, eff = self.inner.round_start(state["inner"], lay, draws,
                                            round_idx)
        self._draws, self._step = draws, 0
        state = {**state, "inner": inner,
                 "wkey": draws.lane_key(WIRE_TAG),
                 "wstep": torch.zeros_like(state["wstep"]),
                 "live_n": eff.sum(-1).to(torch.float32)}
        return state, eff

    def _gates(self, state, n):
        """Each component's gate and parameter: the plan's python values
        for one federation, per-slot tensors for a lane batch."""
        if self.lanes is None:
            w = self.plan
            return dict(topk_on=w.topk is not None, topk_p=w.topk_p,
                        int8_on=w.int8, dp_on=w.dp is not None,
                        dp_sigma=w.dp_sigma)
        out = {}
        for on, arg in (("topk_on", "topk_p"), ("int8_on", None),
                        ("dp_on", "dp_sigma")):
            used = self._uses[on[:-3]]
            out[on] = per_slot(state[on], n) if used else False
            if arg:
                out[arg] = per_slot(state[arg], n) if used else 0.0
        return out

    def select(self, state, h_now):
        st = dict(state)
        h_tx = wire_apply(h_now, self._draws, self._step,
                          **self._gates(st, h_now.shape[0]))
        # the declared release point: everything downstream (rings, guards,
        # the exchange sum) consumes wire data, never a raw hidden
        h_tx = tag(h_tx, "declass", "wire")
        self._step += 1
        h_ref, st["inner"] = self.inner.select(st["inner"], h_tx)
        return h_ref, st

    def round_end(self, state):
        raw_b, enc_b = wire_bytes(
            state["live_n"], self.batch_size, self.width,
            topk_on=state["topk_on"], topk_p=state["topk_p"],
            int8_on=state["int8_on"])
        steps = self._step
        return {**state, "inner": self.inner.round_end(state["inner"]),
                "wstep": torch.full_like(state["wstep"], steps),
                "raw_bytes": state["raw_bytes"] + raw_b * steps,
                "enc_bytes": state["enc_bytes"] + enc_b * steps}

    def fedavg_mask(self, state, eff_mask):
        """Delegate to the inner impl's hook (the fault layer's
        quarantine drop); identity when the inner has none."""
        fam = getattr(self.inner, "fedavg_mask", None)
        return eff_mask if fam is None else fam(state["inner"], eff_mask)

    def telemetry(self, state):
        """The inner impl's counters (fault events), surfaced through
        the outermost layer; None when the inner has none."""
        tel = getattr(self.inner, "telemetry", None)
        return None if tel is None else tel(state["inner"])

    def wire_telemetry(self, state):
        """Cumulative integer bytes-on-wire (per lane in a lane batch),
        as numpy arrays."""
        return {"raw_bytes": state["raw_bytes"].cpu().numpy(),
                "encoded_bytes": state["enc_bytes"].cpu().numpy()}


def make_wire_impl(plan, inner, n_clients, batch_size, width, device=None,
                   lanes=None):
    """The wire layer of a parsed WirePlan over a resolved
    schedule/fault impl (``lanes``: a sweep's WirePlans).  Custom plans
    delegate to their registered factory."""
    if plan.custom is not None:
        _, make, args = plan.custom
        return make(inner=inner, n_clients=n_clients,
                    batch_size=batch_size, width=width, args=args)
    return WireImpl(plan, inner, n_clients, batch_size, width, device,
                    lanes=lanes)
