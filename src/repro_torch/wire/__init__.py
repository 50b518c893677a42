"""repro_torch.wire -- registry-backed exchange transforms, the port of
``repro.wire``: what the federation's hidden stacks look like on the
(simulated) wire.

Spec strings ("int8", "topk:0.25", "dp:0.1", "topk:0.5+int8+dp:0.1",
...) parse into :class:`WirePlan` records; :func:`make_wire_impl` wraps
the resolved schedule/fault impl so the encode-decode round trip rides
the round and integer bytes-on-wire counters surface through
``RunResult.timings["wire"]``; the codecs (and the packed form a
serving cache stores) are :mod:`repro_torch.wire.codecs`.
``transform="none"`` never touches the engine.
"""
from repro_torch.wire.codecs import (WIRE_TAG, WirePayload, dp_noise,
                                     int8_roundtrip, pack, topk_select,
                                     unpack, wire_apply, wire_apply_static,
                                     wire_bytes)
from repro_torch.wire.engine import WireImpl, make_wire_impl
from repro_torch.wire.registry import (TRANSFORMS, WireEntry, WirePlan,
                                       get_wire_plan, register_transform,
                                       transform_names)

__all__ = [
    "TRANSFORMS", "WIRE_TAG", "WireEntry", "WireImpl", "WirePayload",
    "WirePlan", "dp_noise", "get_wire_plan", "int8_roundtrip",
    "make_wire_impl", "pack", "register_transform", "topk_select",
    "transform_names", "unpack", "wire_apply", "wire_apply_static",
    "wire_bytes",
]
