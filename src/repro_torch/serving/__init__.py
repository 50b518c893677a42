"""Serving engines of the port.

``federated`` is the De-VertiFL product path: continuous-batched
vertical inference over a fixed predict-slot pool with split-feature
assembly and a hot-entity exchange cache (behind
``repro_torch.api.Session.serve()``).  ``engine`` is the LM
token-decoding engine (prefill splicing into running decode batches).
"""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.federated import (  # noqa: F401
    SERVE_SCHEMA_VERSION, ExchangeCache, FederatedServer, ServeReport,
    ServeRequest, make_serve_step_fn, split_features,
)
