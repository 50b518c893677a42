"""The audit barrier: an identity op that marks the declared
cross-client channels (and the maskable terms) in a traced round of the
port; the port of ``repro.analysis.barrier``.

De-VertiFL's privacy claim is relational: client i's raw features may
reach client j only through the first-layer hidden-output exchange and
the FedAvg mean.  The auditor (``repro_torch.analysis``) needs those
channels visible in the graph it reads, so the round calls :func:`tag`
at each of them:

  tag(x, "declass", "exchange")   the masked hidden-output sum
  tag(x, "declass", "fedavg")     the masked parameter mean
  tag(x, "term", channel, client_axis=k)
                                  a mask-weighted per-client term whose
                                  dead padded slots (along axis k) the
                                  deadness pass must prove zero

Outside an :func:`audit_tracing` context ``tag`` returns its argument
itself: no op is issued, so a production step's kernels and bits are
those of a build without the auditor.  Inside the context it calls
``torch.ops.repro_torch.audit_tag``, a ``torch.library.custom_op``
identity that returns a clone (a custom op may not return an alias of
its input) and so lands in the traced graph as one node.  Its backward
re-tags the cotangent of a ``"declass"`` tag -- the transpose of the
declared forward exchange is the declared backward exchange of the
verticomb baseline -- and passes a ``"term"`` tag's cotangent through
untagged: the cotangent of a mask-weighted term is not itself
mask-weighted.

The context is thread-local and wraps tracing only (``ir.trace_round``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

TAG_OP_NAME = "audit_tag"


@torch.library.custom_op("repro_torch::audit_tag", mutates_args=())
def _audit_tag(x: torch.Tensor, kind: str, channel: str,
               client_axis: Optional[int]) -> torch.Tensor:
    return x.clone()


@_audit_tag.register_fake
def _(x, kind, channel, client_axis):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    ctx.params = inputs[1:]


def _backward(ctx, grad):
    kind, channel, client_axis = ctx.params
    if kind == "declass":
        grad = _audit_tag(grad, kind, channel, client_axis)
    return grad, None, None, None


_audit_tag.register_autograd(_backward, setup_context=_setup)

_STATE = threading.local()


def auditing() -> bool:
    """True inside an :func:`audit_tracing` context (this thread)."""
    return getattr(_STATE, "depth", 0) > 0


@contextmanager
def audit_tracing():
    """Enable tag emission for the duration (re-entrant, thread-local)."""
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def tag(x, kind: str, channel: str, client_axis=None):
    """``x`` itself, plus a graph marker when an audit trace is active.

    kind="declass"  x is a declared cross-client channel value: the
                    taint pass clears client-source taint here.
    kind="term"     x is a mask-weighted per-client term (client axis
                    ``client_axis`` of x): the deadness pass proves its
                    dead padded slots are zero.
    """
    if not auditing():
        return x
    return _audit_tag(x, kind, channel, client_axis)
