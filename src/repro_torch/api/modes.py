"""The mode registry behind ``repro_torch.api``, the port of
``repro.api.modes``: which training topology an ``ExperimentSpec.mode``
selects.

Built-in modes:

  devertifl          the paper's protocol -- forward-pass
                     HiddenOutputExchange, local backward, P2P FedAvg
  non_federated      isolated per-client training (no exchange); the
                     paper's lower baseline
  verticomb          VertiComb-style backward exchange: gradients flow
                     to every contributor (alias: backward_exchange)
  splitnn            centralized split learning -- client bottoms, a
                     server top over concatenated embeddings (Table II
                     literature rows)

The federated modes are thin descriptors over
``repro_torch.core.protocol.DeVertiFL`` (``internal`` is the
ProtocolConfig mode string); ``splitnn`` wraps
``repro_torch.core.baselines.SplitNN``.  Register a custom mode with
:func:`register_mode` by supplying a ``runner`` factory ``(spec) ->
runner`` where the runner implements ``run() -> (metrics, history,
params, timings)`` and optionally ``predict(params, x)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.registry import Registry

MODES = Registry("mode")


@dataclass(frozen=True)
class ModeEntry:
    name: str
    kind: str                       # "federated" | "splitnn" | "custom"
    internal: Optional[str] = None  # ProtocolConfig.mode for federated
    runner: Optional[Callable] = None   # custom: (spec) -> runner


def register_mode(name, runner=None, *, kind="custom", internal=None,
                  aliases=(), overwrite=False) -> ModeEntry:
    """Register a mode for ``ExperimentSpec.mode=name``.  Custom modes
    pass a ``runner`` factory; the built-in kinds are registered by
    this module itself."""
    if kind == "custom" and runner is None:
        raise ValueError("custom modes need a runner factory "
                         "(spec) -> runner")
    entry = ModeEntry(name=name, kind=kind, internal=internal,
                      runner=runner)
    MODES.register(name, entry, overwrite=overwrite)
    for alias in aliases:
        MODES.register(alias, entry, overwrite=overwrite)
    return entry


def get_mode(name) -> ModeEntry:
    return MODES.get(name)


def mode_names() -> list:
    return MODES.names()


register_mode("devertifl", kind="federated", internal="devertifl")
register_mode("non_federated", kind="federated", internal="non_federated")
register_mode("verticomb", kind="federated", internal="verticomb",
              aliases=("backward_exchange",))
register_mode("splitnn", kind="splitnn")
