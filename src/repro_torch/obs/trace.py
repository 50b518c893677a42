"""Host-side span tracing: the port of ``repro.obs.trace``'s
:class:`NullTracer`, the ``obs="none"`` stand-in whose every method is
a no-op, so an instrumented call site costs an attribute lookup when
tracing is off.  ``SpanTracer`` is not ported yet (ROADMAP.md, Queue 1
item 4d, ``obs/``), so ``obs`` runs only at "none".
"""
from __future__ import annotations

import contextlib
from typing import List


class NullTracer:
    """The ``obs="none"`` tracer: every method is a no-op.  ``span``
    hands back one shared nullcontext."""

    active = False
    _null = contextlib.nullcontext()

    def span(self, name: str, cat: str = "run", **args):
        return self._null

    def profile_to(self, profile_dir):
        return self._null

    def instant(self, name: str, cat: str = "run", **args):
        pass

    def to_records(self) -> List[dict]:
        return []

    def export(self, path: str):
        raise ValueError(
            "tracing is off (obs='none' builds a NullTracer); span "
            "recording is not ported yet (ROADMAP.md, Queue 1 item 4d, "
            "obs/)")

    def summary(self) -> str:
        return "tracing off (obs='none')"
