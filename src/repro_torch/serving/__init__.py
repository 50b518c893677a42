"""Serving engines of the port.  ``engine`` is the LM token-decoding
engine (prefill splicing into running decode batches).  The federated
serving path of the reference (``repro.serving.federated``) is not
ported yet (ROADMAP.md, Queue 1 item 5)."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
