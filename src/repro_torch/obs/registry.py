"""The obs-level registry (the port of ``repro.obs.registry``; canonical
strings and errors are the reference's): how much the federation
records about itself while it trains.

An obs level is named by a compact spec string parsed against the
``OBS`` registry into a frozen :class:`ObsPlan` record:

  none    no taps; the engine runs its untouched code path, bit for bit
          (the protocol never wraps the engine impl for it), the host
          tracer is a no-op NullTracer, and the spec hash is unchanged
          -- ``obs`` lives in ``HASH_EXCLUDE`` because taps never change
          trajectories.
  basic   cheap per-round series recorded on the device in the carried
          state: masked-mean loss, guard-quarantine counts,
          bytes-on-wire, staleness depth.  The host span tracer is
          armed.
  full    everything basic records plus the per-client series: L2 norms
          of the released exchange stacks and per-client gradient
          norms.

Levels are observation-only: the taps read values the round already
computes and write them into carried series tensors -- no training
value is touched, so ``obs="full"`` trajectories are bitwise
``obs="none"`` trajectories (tests/test_torch_obs.py pins it).  Levels
ride a sweep's lane batch as a lane axis like staleness depth, fault
rate and wire transform: the level gates are per-lane scalars in the
carried state.  Custom obs impls register via :func:`register_obs` and,
like custom schedules, are refused in multi-obs sweep lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.registry import Registry

OBS = Registry("obs")

# level numbers (what the gates derive from)
LEVEL_NONE, LEVEL_BASIC, LEVEL_FULL = 0, 1, 2


@dataclass(frozen=True)
class ObsPlan:
    """Parsed, canonical obs plan.  ``spec`` is the canonical string --
    the identity checkpoint stamps and sweep cell keys use (never
    spec_hash: obs is hash-excluded)."""
    spec: str
    level: int = LEVEL_NONE
    custom: Optional[Tuple] = None      # (name, make_factory, args)

    @property
    def is_none(self) -> bool:
        """True only for the literal "none" plan -- the engine keeps its
        tap-free code path for it.  A "none" LANE inside an obs sweep
        runs the obs engine with the gates at 0 and is held bitwise
        equal by test, not aliased."""
        return self.level == LEVEL_NONE and self.custom is None


@dataclass(frozen=True)
class ObsEntry:
    """Registry entry: ``parse(args) -> dict`` of ObsPlan field updates
    for built-ins; ``make`` is the custom impl factory."""
    name: str
    parse: Callable
    make: Optional[Callable] = None


def _parse_level(level):
    def parse(args, _level=level):
        if args:
            raise ValueError(
                f"obs levels take no arguments, got {args}")
        return {"level": _level}
    return parse


OBS.register("none", ObsEntry("none", _parse_level(LEVEL_NONE)))
OBS.register("basic", ObsEntry("basic", _parse_level(LEVEL_BASIC)))
OBS.register("full", ObsEntry("full", _parse_level(LEVEL_FULL)))


def register_obs(name, make, overwrite=False) -> ObsEntry:
    """Register a custom obs impl for ``ExperimentSpec.obs = name`` (or
    ``"name:arg1:arg2"``).

    ``make(inner, n_clients, batch_size, width, rounds, args)`` must
    return an impl providing the schedule four-hook contract
    (``repro_torch.schedule.engine``); ``inner`` is the resolved
    schedule/fault/wire impl the obs layer wraps (never None -- literal
    sync is handed over as a depth-0 ring impl).  The impl may also
    provide the ``tap_step`` / ``obs_series`` hooks and must forward
    ``fedavg_mask`` / ``telemetry`` / ``wire_telemetry`` to its inner
    impl.

    Custom obs plans run devertifl-mode federations only and are
    refused in multi-obs sweep lanes (as custom schedules are)."""
    def parse(args, _name=name, _make=make):
        return {"custom": (_name, _make, tuple(args))}

    return OBS.register(name, ObsEntry(name, parse, make),
                        overwrite=overwrite)


def obs_names() -> list:
    """Registered obs level names."""
    return OBS.names()


def get_obs_plan(spec) -> ObsPlan:
    """Parse an obs spec string (or pass an ObsPlan through) into the
    canonical :class:`ObsPlan` record.  Unknown names raise with the
    registered options listed."""
    if isinstance(spec, ObsPlan):
        return spec
    text = str(spec).strip()
    if not text:
        raise ValueError("malformed obs spec '' (empty)")
    name, *args = text.split(":")
    entry = OBS.get(name)           # unknown names raise w/ options
    fields = entry.parse(args)
    custom = fields.get("custom")
    canon = text if custom else name
    return ObsPlan(spec=canon, **fields)
