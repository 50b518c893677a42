"""The fault-plan registry (the port of ``repro.faults.registry``;
canonical strings and errors are the reference's): which deterministic adversity the
federation trains under.

A fault plan is named by a compact spec string -- ``name[:args]``
components joined with ``+`` -- parsed against the ``FAULTS`` registry
into a frozen :class:`FaultPlan` record:

  none               no injected faults; the engine runs its untouched
                     legacy code path, bit-for-bit (the protocol never
                     wraps the schedule impl for it) and the spec hash
                     is unchanged.
  crash:p[:dur]      fail-stop: each round every live client crashes
                     with probability p and stays down for ``dur``
                     rounds (default 1) before rejoining.  A down
                     client contributes exact-zero terms to the
                     exchange sum and the FedAvg weighting -- the same
                     structural zeros as a dead padded slot -- but
                     keeps its local state and receives the broadcast
                     when it rejoins.
  straggle:p:d       each round every live client straggles with
                     probability p: its hidden outputs arrive ``d``
                     steps late, served from a ring buffer of its own
                     past stacks (cold start = exchange-free zeros,
                     the stale_k idiom).
  corrupt:p[:kind]   transport corruption: each round every live
                     client's exchanged payload is poisoned with
                     probability p -- ``kind`` is ``nan`` (default,
                     non-finite payload) or ``scale`` (finite but
                     magnitude-exploded).  The exchange guard screens
                     and quarantines these (repro_torch.core.exchange
                     ``screen_exchange``).

All draws are per-client/per-round counter hashes
(``repro_torch.core.draws``) under a tag disjoint from the
participation tag, so fault realizations are bitwise
reproducible and padding-invariant (a padded federation crashes the
same live clients as its unpadded twin).  ``crash``, ``straggle`` and
``corrupt`` compose ("crash:0.2+corrupt:0.05"); ``none`` stands alone.
Custom fault impls register via :func:`register_fault` and, like
custom schedules, are refused in multi-fault sweep lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.registry import Registry

FAULTS = Registry("fault")


@dataclass(frozen=True)
class FaultPlan:
    """Parsed, canonical fault plan.  ``spec`` is the canonical string
    (components in crash/straggle/corrupt order, numbers normalized)
    -- the identity that spec hashes, checkpoint stamps, and sweep
    cell keys use."""
    spec: str
    crash: Optional[float] = None       # None = no crash component
    crash_dur: int = 1                  # rounds a crashed client is down
    straggle: Optional[float] = None    # None = no straggle component
    straggle_d: int = 0                 # delay in steps
    corrupt: Optional[float] = None     # None = no corrupt component
    corrupt_kind: str = "nan"           # "nan" | "scale"
    custom: Optional[Tuple] = None      # (name, make_factory, args)

    @property
    def is_none(self) -> bool:
        """True only for the literal "none" plan -- the engine keeps
        its fault-free code path for it.  Degenerate members of other
        families (crash:0 is refused by the parser; a "none" LANE
        inside a fault sweep runs the fault engine with p=0 traced and
        is proven bitwise-equal by test, not by aliasing)."""
        return (self.crash is None and self.straggle is None
                and self.corrupt is None and self.custom is None)

    @property
    def crash_p(self) -> float:
        return self.crash or 0.0

    @property
    def straggle_p(self) -> float:
        return self.straggle or 0.0

    @property
    def corrupt_p(self) -> float:
        return self.corrupt or 0.0

    @property
    def max_dur(self) -> int:
        """Crash outage length in rounds (0 = no crash component)."""
        return self.crash_dur if self.crash is not None else 0

    @property
    def max_delay(self) -> int:
        """Straggler delay in steps = the ring depth this plan needs."""
        return self.straggle_d if self.straggle is not None else 0


@dataclass(frozen=True)
class FaultEntry:
    """Registry entry: ``parse(args) -> dict`` of FaultPlan field
    updates for built-ins; ``make`` is the custom impl factory."""
    name: str
    parse: Callable
    make: Optional[Callable] = None


def _prob(name, text):
    try:
        p = float(text)
    except ValueError:
        raise ValueError(f"{name} wants a float probability, got "
                         f"{text!r}") from None
    if not 0.0 < p <= 1.0:
        raise ValueError(f"{name} wants 0 < p <= 1, got {p}")
    return p


def _parse_none(args):
    if args:
        raise ValueError(f"none takes no arguments, got {args}")
    return {}


def _parse_crash(args):
    if not 1 <= len(args) <= 2:
        raise ValueError(
            "crash wants a probability and an optional outage length, "
            f"e.g. 'crash:0.2' or 'crash:0.2:3'; got args {args}")
    p = _prob("crash", args[0])
    try:
        dur = int(args[1]) if len(args) > 1 else 1
    except ValueError:
        raise ValueError(f"crash wants an int dur, got {args[1]!r}") \
            from None
    if dur < 1:
        raise ValueError(f"crash wants dur >= 1, got {dur}")
    return {"crash": p, "crash_dur": dur}


def _parse_straggle(args):
    if len(args) != 2:
        raise ValueError(
            "straggle wants a probability and a delay in steps, e.g. "
            f"'straggle:0.5:2'; got args {args}")
    p = _prob("straggle", args[0])
    try:
        d = int(args[1])
    except ValueError:
        raise ValueError(f"straggle wants an int delay, got "
                         f"{args[1]!r}") from None
    if d < 1:
        raise ValueError(f"straggle wants delay >= 1, got {d}")
    return {"straggle": p, "straggle_d": d}


def _parse_corrupt(args):
    if not 1 <= len(args) <= 2:
        raise ValueError(
            "corrupt wants a probability and an optional kind, e.g. "
            f"'corrupt:0.05' or 'corrupt:0.05:scale'; got args {args}")
    p = _prob("corrupt", args[0])
    kind = args[1] if len(args) > 1 else "nan"
    if kind not in ("nan", "scale"):
        raise ValueError(f"corrupt kind must be 'nan' or 'scale', "
                         f"got {kind!r}")
    return {"corrupt": p, "corrupt_kind": kind}


FAULTS.register("none", FaultEntry("none", _parse_none))
FAULTS.register("crash", FaultEntry("crash", _parse_crash))
FAULTS.register("straggle", FaultEntry("straggle", _parse_straggle))
FAULTS.register("corrupt", FaultEntry("corrupt", _parse_corrupt))


def register_fault(name, make, overwrite=False) -> FaultEntry:
    """Register a custom fault impl for ``ExperimentSpec.fault = name``
    (or ``"name:arg1:arg2"``).

    ``make(inner, n_clients, batch_size, width, args)`` must return an
    impl providing the schedule four-hook contract
    (docs/ARCHITECTURE.md section 9); ``inner`` is the resolved
    schedule impl the fault layer wraps (never None -- literal sync is
    handed over as a depth-0 ring impl).  The impl may additionally
    provide ``fedavg_mask(state, eff_mask)`` (round-end averaging
    mask) and ``telemetry(state)`` (counter dict) hooks.

    Custom faults stand alone (no ``+`` composition), run
    devertifl-mode federations only, and are refused in multi-fault
    sweep lanes (same constraint as custom schedules)."""
    def parse(args, _name=name, _make=make):
        return {"custom": (_name, _make, tuple(args))}

    return FAULTS.register(name, FaultEntry(name, parse, make),
                           overwrite=overwrite)


def fault_names() -> list:
    """Registered fault family names."""
    return FAULTS.names()


def _canonical(fields, custom_spec=None) -> str:
    if custom_spec is not None:
        return custom_spec
    parts = []
    if fields.get("crash") is not None:
        dur = fields.get("crash_dur", 1)
        parts.append(f"crash:{fields['crash']:g}"
                     + (f":{dur}" if dur != 1 else ""))
    if fields.get("straggle") is not None:
        parts.append(f"straggle:{fields['straggle']:g}"
                     f":{fields['straggle_d']}")
    if fields.get("corrupt") is not None:
        kind = fields.get("corrupt_kind", "nan")
        parts.append(f"corrupt:{fields['corrupt']:g}"
                     + (f":{kind}" if kind != "nan" else ""))
    return "+".join(parts) or "none"


def get_fault_plan(spec) -> FaultPlan:
    """Parse a fault spec string (or pass a FaultPlan through) into
    the canonical :class:`FaultPlan` record.  Unknown family names
    raise with the registered options listed."""
    if isinstance(spec, FaultPlan):
        return spec
    text = str(spec).strip()
    comps = [c.strip() for c in text.split("+")]
    if not all(comps):
        raise ValueError(f"malformed fault spec {text!r}")
    fields, seen = {}, []
    for comp in comps:
        name, *args = comp.split(":")
        entry = FAULTS.get(name)        # unknown names raise w/ options
        if name in seen:
            raise ValueError(f"duplicate fault component {name!r} "
                             f"in {text!r}")
        seen.append(name)
        upd = entry.parse(args)
        if (name == "none" or entry.make is not None) and len(comps) > 1:
            raise ValueError(
                f"fault component {name!r} does not compose; only "
                "crash, straggle and corrupt may be '+'-joined")
        fields.update(upd)
    custom = fields.get("custom")
    canon = _canonical(fields, custom_spec=text if custom else None)
    return FaultPlan(spec=canon, **fields)
