"""The exchange-schedule registry (the port of
``repro.schedule.registry``; canonical strings and errors are the
reference's, letter for letter): which exchange tensor each client
consumes at each step of the round.

A schedule is named by a compact spec string -- ``name[:arg[:flag]]``
components joined with ``+`` -- parsed against the ``SCHEDULES``
registry into a frozen :class:`Schedule` record:

  sync             the paper-literal schedule: every client consumes
                   every live peer's CURRENT hidden outputs, fully
                   synchronously.  Bit-for-bit the legacy engine (the
                   protocol keeps its original code path for it).
  stale_k[:k]      clients consume exchange buffers k steps old (a
                   ring buffer carried as round state; k defaults to 1,
                   k=0 is bitwise sync).  Models overlapping the
                   HiddenOutputExchange with local compute.
  double_buffer    round-granularity two-slot pipeline: every step of
                   round t consumes the hidden outputs captured at the
                   END of round t-1 (zeros in round 0) while filling
                   the back slot for round t+1.
  partial:p[:det]  per-round participation: each round a client takes
                   part with probability p (a per-client coin from
                   ``repro_torch.core.draws``; ``:det`` rotates a deterministic keep-set
                   instead).  Dropped clients contribute exact-zero
                   terms to the exchange sum and the FedAvg weighting
                   -- composed with the padded-axis ``client_mask`` --
                   but keep training locally and still receive the
                   broadcast (the straggler model: their update missed
                   the round, the round did not miss them).
                   ``partial:1.0`` is bitwise sync.

``stale_k`` and ``partial`` compose ("stale_k:4+partial:0.8"); ``sync``
and ``double_buffer`` stand alone.  Custom schedules register via
:func:`register_schedule` (see docs/ARCHITECTURE.md section 7 for the
impl contract) and, like custom first layers, are refused in
multi-schedule sweep lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.registry import Registry

SCHEDULES = Registry("schedule")


@dataclass(frozen=True)
class Schedule:
    """Parsed, canonical exchange schedule.  ``spec`` is the canonical
    string (components in stale-before-partial order, numbers
    normalized) -- the identity that spec hashes, checkpoint stamps,
    and sweep cell keys use."""
    spec: str
    stale_k: Optional[int] = None       # None = no stale component
    participation: Optional[float] = None   # None = no partial component
    deterministic: bool = False         # partial: rotate, don't draw
    double_buffer: bool = False
    custom: Optional[Tuple] = None      # (name, make_factory, args)

    @property
    def is_sync(self) -> bool:
        """True only for the literal "sync" spec.  Degenerate members
        of other families (stale_k:0, partial:1.0) run through the
        schedule engine and are proven bitwise-equal by test, not by
        aliasing."""
        return (self.stale_k is None and self.participation is None
                and not self.double_buffer and self.custom is None)

    @property
    def k(self) -> int:
        """Staleness depth in steps (0 = consume current outputs)."""
        return self.stale_k or 0

    @property
    def p(self) -> float:
        """Per-round participation probability (1.0 = everyone)."""
        return 1.0 if self.participation is None else self.participation


@dataclass(frozen=True)
class ScheduleEntry:
    """Registry entry: ``parse(args) -> dict`` of Schedule field
    updates for built-ins; ``make`` is the custom impl factory."""
    name: str
    parse: Callable
    make: Optional[Callable] = None


def _parse_sync(args):
    if args:
        raise ValueError(f"sync takes no arguments, got {args}")
    return {}


def _parse_stale(args):
    if len(args) > 1:
        raise ValueError(f"stale_k takes one argument (k), got {args}")
    try:
        k = int(args[0]) if args else 1
    except ValueError:
        raise ValueError(f"stale_k wants an int k, got {args[0]!r}") \
            from None
    if k < 0:
        raise ValueError(f"stale_k wants k >= 0, got {k}")
    return {"stale_k": k}


def _parse_double(args):
    if args:
        raise ValueError(f"double_buffer takes no arguments, got {args}")
    return {"double_buffer": True}


def _parse_partial(args):
    det = False
    if args and args[-1] == "det":
        det, args = True, args[:-1]
    if len(args) != 1:
        raise ValueError(
            "partial wants a participation probability, e.g. "
            f"'partial:0.8' or 'partial:0.8:det'; got args {args}")
    try:
        p = float(args[0])
    except ValueError:
        raise ValueError(f"partial wants a float p, got {args[0]!r}") \
            from None
    if not 0.0 < p <= 1.0:
        raise ValueError(f"partial wants 0 < p <= 1, got {p}")
    return {"participation": p, "deterministic": det}


SCHEDULES.register("sync", ScheduleEntry("sync", _parse_sync))
SCHEDULES.register("stale_k", ScheduleEntry("stale_k", _parse_stale))
SCHEDULES.register("double_buffer",
                   ScheduleEntry("double_buffer", _parse_double))
SCHEDULES.register("partial", ScheduleEntry("partial", _parse_partial))


def register_schedule(name, make, overwrite=False) -> ScheduleEntry:
    """Register a custom exchange schedule for
    ``ExperimentSpec.schedule = name`` (or ``"name:arg1:arg2"``).

    ``make(n_clients, batch_size, width, args)`` must return an impl
    providing the four-hook contract the round engine drives
    (docs/ARCHITECTURE.md section 7):

      init_state(sched) -> dict             the carried state
      round_start(state, lay, draws, round_idx) -> (state, eff_mask)
      select(state, h_now) -> (h_ref, state)    per-step buffer choice
      round_end(state) -> state

    Custom schedules stand alone (no ``+`` composition), run
    devertifl-mode federations only, and are refused in multi-schedule
    sweep lanes (same constraint as custom first layers)."""
    def parse(args, _name=name, _make=make):
        return {"custom": (_name, _make, tuple(args))}

    return SCHEDULES.register(name, ScheduleEntry(name, parse, make),
                              overwrite=overwrite)


def schedule_names() -> list:
    """Registered schedule family names."""
    return SCHEDULES.names()


def _canonical(fields, custom_spec=None) -> str:
    if custom_spec is not None:
        return custom_spec
    parts = []
    if fields.get("double_buffer"):
        parts.append("double_buffer")
    if fields.get("stale_k") is not None:
        parts.append(f"stale_k:{fields['stale_k']}")
    if fields.get("participation") is not None:
        parts.append(f"partial:{fields['participation']:g}"
                     + (":det" if fields.get("deterministic") else ""))
    return "+".join(parts) or "sync"


def get_schedule(spec) -> Schedule:
    """Parse a schedule spec string (or pass a Schedule through) into
    the canonical :class:`Schedule` record.  Unknown family names raise
    with the registered options listed."""
    if isinstance(spec, Schedule):
        return spec
    text = str(spec).strip()
    comps = [c.strip() for c in text.split("+")]
    if not all(comps):
        raise ValueError(f"malformed schedule spec {text!r}")
    fields, seen = {}, []
    for comp in comps:
        name, *args = comp.split(":")
        entry = SCHEDULES.get(name)     # unknown names raise w/ options
        if name in seen:
            raise ValueError(f"duplicate schedule component {name!r} "
                             f"in {text!r}")
        seen.append(name)
        upd = entry.parse(args)
        if (name in ("sync", "double_buffer") or entry.make is not None) \
                and len(comps) > 1:
            raise ValueError(
                f"schedule component {name!r} does not compose; only "
                "stale_k and partial may be '+'-joined")
        fields.update(upd)
    custom = fields.get("custom")
    canon = _canonical(fields, custom_spec=text if custom else None)
    return Schedule(spec=canon, **fields)
