"""The exchange-transform registry (the port of
``repro.wire.registry``; canonical strings and errors are the
reference's): what the exchanged hidden stacks
look like on the (simulated) wire.

A wire transform is named by a compact spec string -- ``name[:args]``
components joined with ``+`` -- parsed against the ``TRANSFORMS``
registry into a frozen :class:`WirePlan` record:

  none           payloads cross the wire as raw fp32; the engine runs
                 its untouched legacy code path, bit-for-bit (the
                 protocol never wraps the engine impl for it) and the
                 spec hash is unchanged.
  topk:p         magnitude sparsification: each client keeps the
                 ceil(p * B * W) largest-|.| entries of its exchanged
                 stack and sends exact zeros for the rest (plus the
                 kept entries' indices on the wire).  ``p = 1.0`` is a
                 bitwise identity -- proven by test, not aliased.
  int8           symmetric 8-bit quantization with a per-client
                 power-of-two scale (2^ceil(log2(max|h|)) / 128), so
                 the decode is exact float arithmetic and the
                 encode-decode pair is idempotent bit-for-bit: an
                 already round-tripped stack re-encodes to the same
                 wire bytes and decodes to the same floats.
  dp:sigma       Gaussian release noise, N(0, sigma^2) added to every
                 released entry.  Draws are per-client/per-step counter
                 hashes (``repro_torch.core.draws``) under a tag
                 disjoint from the participation and fault tags, so the noise stream is bitwise
                 reproducible and padding-invariant.

Components compose left-to-right in the canonical order
topk -> int8 -> dp ("topk:0.25+int8+dp:0.1": sparsify, quantize the
kept values, noise the released result); ``none`` stands alone.
Custom transforms register via :func:`register_transform` and, like
custom schedules and faults, are refused in multi-transform sweep
lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.registry import Registry

TRANSFORMS = Registry("transform")


@dataclass(frozen=True)
class WirePlan:
    """Parsed, canonical wire transform.  ``spec`` is the canonical
    string (components in topk/int8/dp order, numbers normalized) --
    the identity that spec hashes, checkpoint stamps, and sweep cell
    keys use."""
    spec: str
    topk: Optional[float] = None        # None = no sparsify component
    int8: bool = False                  # quantize component present
    dp: Optional[float] = None          # None = no noise component
    custom: Optional[Tuple] = None      # (name, make_factory, args)

    @property
    def is_none(self) -> bool:
        """True only for the literal "none" transform -- the engine
        keeps its transform-free code path for it.  Degenerate members
        of other families (topk:1.0 runs the wire engine and reduces
        bitwise; a "none" LANE inside a wire sweep runs it with every
        component gated off) are proven bitwise-equal by test, not by
        aliasing."""
        return (self.topk is None and not self.int8
                and self.dp is None and self.custom is None)

    @property
    def topk_p(self) -> float:
        return 1.0 if self.topk is None else self.topk

    @property
    def dp_sigma(self) -> float:
        return self.dp or 0.0


@dataclass(frozen=True)
class WireEntry:
    """Registry entry: ``parse(args) -> dict`` of WirePlan field
    updates for built-ins; ``make`` is the custom impl factory."""
    name: str
    parse: Callable
    make: Optional[Callable] = None


def _parse_none(args):
    if args:
        raise ValueError(f"none takes no arguments, got {args}")
    return {}


def _parse_topk(args):
    if len(args) != 1:
        raise ValueError(
            "topk wants a keep fraction, e.g. 'topk:0.25'; got args "
            f"{args}")
    try:
        p = float(args[0])
    except ValueError:
        raise ValueError(f"topk wants a float keep fraction, got "
                         f"{args[0]!r}") from None
    if not 0.0 < p <= 1.0:
        raise ValueError(f"topk wants 0 < p <= 1, got {p}")
    return {"topk": p}


def _parse_int8(args):
    if args:
        raise ValueError(f"int8 takes no arguments, got {args}")
    return {"int8": True}


def _parse_dp(args):
    if len(args) != 1:
        raise ValueError(
            "dp wants a noise scale, e.g. 'dp:0.1'; got args "
            f"{args}")
    try:
        sigma = float(args[0])
    except ValueError:
        raise ValueError(f"dp wants a float noise scale, got "
                         f"{args[0]!r}") from None
    if sigma <= 0.0:
        raise ValueError(f"dp wants sigma > 0, got {sigma}")
    return {"dp": sigma}


TRANSFORMS.register("none", WireEntry("none", _parse_none))
TRANSFORMS.register("topk", WireEntry("topk", _parse_topk))
TRANSFORMS.register("int8", WireEntry("int8", _parse_int8))
TRANSFORMS.register("dp", WireEntry("dp", _parse_dp))


def register_transform(name, make, overwrite=False) -> WireEntry:
    """Register a custom exchange transform for
    ``ExperimentSpec.transform = name`` (or ``"name:arg1:arg2"``).

    ``make(inner, n_clients, batch_size, width, args)`` must return an
    impl providing the schedule four-hook contract
    (docs/ARCHITECTURE.md section 11); ``inner`` is the resolved
    schedule/fault impl the wire layer wraps (never None -- literal
    sync is handed over as a depth-0 ring impl).  The impl may
    additionally provide ``fedavg_mask(state, eff_mask)``,
    ``telemetry(state)`` and ``wire_telemetry(state)`` hooks.

    Custom transforms stand alone (no ``+`` composition), run
    devertifl-mode federations only, and are refused in
    multi-transform sweep lanes (same constraint as custom schedules
    and faults)."""
    def parse(args, _name=name, _make=make):
        return {"custom": (_name, _make, tuple(args))}

    return TRANSFORMS.register(name, WireEntry(name, parse, make),
                               overwrite=overwrite)


def transform_names() -> list:
    """Registered transform family names."""
    return TRANSFORMS.names()


def _canonical(fields, custom_spec=None) -> str:
    if custom_spec is not None:
        return custom_spec
    parts = []
    if fields.get("topk") is not None:
        parts.append(f"topk:{fields['topk']:g}")
    if fields.get("int8"):
        parts.append("int8")
    if fields.get("dp") is not None:
        parts.append(f"dp:{fields['dp']:g}")
    return "+".join(parts) or "none"


def get_wire_plan(spec) -> WirePlan:
    """Parse a transform spec string (or pass a WirePlan through) into
    the canonical :class:`WirePlan` record.  Unknown family names
    raise with the registered options listed."""
    if isinstance(spec, WirePlan):
        return spec
    text = str(spec).strip()
    comps = [c.strip() for c in text.split("+")]
    if not all(comps):
        raise ValueError(f"malformed transform spec {text!r}")
    fields, seen = {}, []
    for comp in comps:
        name, *args = comp.split(":")
        entry = TRANSFORMS.get(name)    # unknown names raise w/ options
        if name in seen:
            raise ValueError(f"duplicate transform component {name!r} "
                             f"in {text!r}")
        seen.append(name)
        upd = entry.parse(args)
        if (name == "none" or entry.make is not None) and len(comps) > 1:
            raise ValueError(
                f"transform component {name!r} does not compose; only "
                "topk, int8 and dp may be '+'-joined")
        fields.update(upd)
    custom = fields.get("custom")
    canon = _canonical(fields, custom_spec=text if custom else None)
    return WirePlan(spec=canon, **fields)
