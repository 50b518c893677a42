"""``ExperimentSpec`` -- the one declarative record that names a
De-VertiFL experiment: the port of ``repro.api.spec``.

The same fields, defaults, order, ``to_dict``, ``HASH_EXCLUDE``,
``spec_hash`` and ``resume_hash`` as the reference, so a spec that runs
the same lane in both packages carries the same id, letter for letter:

  frozen + hashable   specs are dataclass-frozen with tuple fields, so
                      they key caches and dedupe grids.
  stable spec_hash    a sha256 over the canonical JSON of the
                      result-determining fields -- stable across
                      processes.  Observation/execution knobs
                      (``eval_every``, ``checkpoint_dir``,
                      ``checkpoint_every``, ``shard``, ``obs``) are
                      excluded.  Mode aliases resolve to their
                      registered name and ``first_layer="auto"`` to the
                      lane this machine runs -- ``"kernel"`` where CUDA
                      is available, else ``"slice"`` -- so one hash
                      never labels two numerically different
                      executions.  ``"kernel"`` is the port's name for
                      the reference's ``"pallas"`` lane; the two are
                      different executions and keep different hashes.

No pytree registration: nothing here is traced.  ``schedule``,
``fault``, ``transform`` and ``obs`` are validated against their
registries and canonicalized as the reference does (``"stale_k"`` ->
``"stale_k:1"``), so a spec hashes as the reference's; the first three
drop their defaults from the hash, and ``obs`` is excluded from it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.api.modes import get_mode
from repro_torch.configs import get_config
from repro_torch.core.protocol import (AXIS_DEFAULTS, FIRST_LAYERS,
                                       auto_first_layer)
from repro_torch.data import registry as DR
from repro_torch.faults import get_fault_plan
from repro_torch.obs import get_obs_plan
from repro_torch.schedule import get_schedule
from repro_torch.wire import get_wire_plan

# knobs that change what is *recorded*, not what is *computed* -- kept
# out of spec_hash so observation settings don't fork experiment ids
# ("obs" by construction: obs="full" trajectories are bitwise obs="none"
# trajectories)
HASH_EXCLUDE = ("eval_every", "checkpoint_dir", "checkpoint_every",
                "shard", "obs")

ENGINES = ("scan", "python")


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively.  ``build(spec)`` turns it into a
    runnable :class:`repro_torch.api.Session`."""
    dataset: str = "mnist"
    mode: str = "devertifl"
    n_clients: int = 3
    seeds: Tuple[int, ...] = (0,)
    rounds: int = 5
    epochs: int = 5
    batch_size: int = 64
    lr: float = 1e-3
    exchange_at: int = -1           # -1 logits | 0 raw input | k hidden k
    fedavg: bool = True
    engine: str = "scan"            # scan | python: the same loop here
    first_layer: str = "auto"       # auto | kernel | slice | masked | custom
    # the round engine's layers (repro_torch.schedule / .faults /
    # .wire spec strings, canonicalized); non-default values run
    # devertifl federations only
    schedule: str = "sync"
    fault: str = "none"
    transform: str = "none"
    # the obs level (repro_torch.obs): "none" | "basic" | "full" | a
    # register_obs name; non-none levels arm the metric taps and the
    # host span tracer, devertifl federations only
    obs: str = "none"
    max_clients: Optional[int] = None   # pad client axis with dead slots
    shard: Union[str, bool, int] = "auto"   # grid lanes: "auto"|False|int
    n_samples: Optional[int] = None     # dataset size override (speed)
    # eval cadence in rounds; 0 = final metrics only
    eval_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # rounds between checkpoints; 0 = off

    # ------------------------------------------------------------------
    def __post_init__(self):
        # normalize seeds for hashability/UX: int -> (int,), list -> tuple
        seeds = self.seeds
        if isinstance(seeds, int):
            seeds = (seeds,)
        object.__setattr__(self, "seeds", tuple(int(s) for s in seeds))
        self._validate()

    def _validate(self):
        entry = DR.get_dataset(self.dataset)     # raises w/ options
        mode = get_mode(self.mode)               # raises w/ options
        # canonicalize aliases (backward_exchange -> verticomb) so the
        # alias cannot fork spec_hash: same experiment, same id
        object.__setattr__(self, "mode", mode.name)
        FIRST_LAYERS.get(self.first_layer)       # raises w/ options
        sched = get_schedule(self.schedule)      # raises w/ options
        # canonicalize ("stale_k" -> "stale_k:1") so formatting cannot
        # fork spec_hash; stale_k:0 and partial:1.0 keep their identity
        object.__setattr__(self, "schedule", sched.spec)
        if not sched.is_sync and mode.internal != "devertifl":
            raise ValueError(
                f"schedule {sched.spec!r} requires mode='devertifl' "
                f"(the scheduled dataflow is the forward "
                f"HiddenOutputExchange); mode {self.mode!r} supports "
                "schedule='sync' only")
        plan = get_fault_plan(self.fault)        # raises w/ options
        object.__setattr__(self, "fault", plan.spec)
        if not plan.is_none and mode.internal != "devertifl":
            raise ValueError(
                f"fault plan {plan.spec!r} requires mode='devertifl' "
                "(faults are injected into the forward "
                f"HiddenOutputExchange); mode {self.mode!r} supports "
                "fault='none' only")
        wire = get_wire_plan(self.transform)     # raises w/ options
        object.__setattr__(self, "transform", wire.spec)
        if not wire.is_none and mode.internal != "devertifl":
            raise ValueError(
                f"transform {wire.spec!r} requires mode='devertifl' "
                "(the transformed dataflow is the forward "
                f"HiddenOutputExchange); mode {self.mode!r} supports "
                "transform='none' only")
        op = get_obs_plan(self.obs)              # raises w/ options
        object.__setattr__(self, "obs", op.spec)
        if not op.is_none and mode.internal != "devertifl":
            raise ValueError(
                f"obs level {op.spec!r} requires mode='devertifl' "
                "(the taps ride the exchange engine's scan carry); "
                f"mode {self.mode!r} supports obs='none' only")
        if self.first_layer == "auto":
            # resolve "auto" NOW so the spec (and its hash) records the
            # lane that actually runs
            object.__setattr__(self, "first_layer", auto_first_layer())
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; pick one "
                             f"of {ENGINES}")
        for name in ("n_clients", "rounds", "epochs", "batch_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if not self.seeds:
            raise ValueError("seeds must be a non-empty tuple of ints")
        if self.lr <= 0:
            raise ValueError(f"lr must be > 0, got {self.lr}")
        n_hidden = get_config(entry.arch).n_hidden
        if not -1 <= self.exchange_at <= n_hidden:
            raise ValueError(
                f"exchange_at={self.exchange_at} out of range for "
                f"{self.dataset!r}: -1 (logits), 0 (raw input), or "
                f"1..{n_hidden} (after hidden layer k)")
        if self.max_clients is not None and \
                self.max_clients < self.n_clients:
            raise ValueError(f"max_clients={self.max_clients} < "
                             f"n_clients={self.n_clients}")
        if not (self.shard == "auto" or self.shard is False or
                (isinstance(self.shard, int)
                 and not isinstance(self.shard, bool)
                 and self.shard >= 1)):
            raise ValueError(f"shard must be 'auto', False, or a "
                             f"positive int, got {self.shard!r}")
        if self.eval_every < 0 or self.checkpoint_every < 0:
            raise ValueError("eval_every / checkpoint_every must be >= 0")
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError("checkpoint_every > 0 needs checkpoint_dir")
        if len(self.seeds) > 1:
            if self.engine != "scan":
                raise ValueError(
                    "multi-seed sessions run on the vmapped sweep "
                    "engine, which only supports engine='scan'")
            if self.max_clients is not None:
                raise ValueError(
                    "max_clients is a single-session / grid knob; "
                    "multi-seed cells pad automatically via "
                    "repro_torch.api.run_grid")
            if self.checkpoint_every:
                raise ValueError("checkpointing is only supported for "
                                 "single-seed sessions")
        if mode.kind == "splitnn" and self.checkpoint_every:
            raise ValueError("checkpointing is only supported for "
                             "federated modes")

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ExperimentSpec":
        """A new validated spec with fields replaced."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def seed(self) -> int:
        """The single-session seed (first of ``seeds``)."""
        return self.seeds[0]

    def _hash(self, extra_exclude=()) -> str:
        d = {k: v for k, v in self.to_dict().items()
             if k not in HASH_EXCLUDE and k not in extra_exclude}
        # the schedule, fault and wire axes arrived after spec_hash
        # shipped: their defaults are dropped so every spec keeps the
        # id it had before them, as in the reference
        for name in ("schedule", "fault", "transform"):
            if d.get(name) == AXIS_DEFAULTS[name]:
                del d[name]
        blob = json.dumps(d, sort_keys=True, default=list)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @property
    def spec_hash(self) -> str:
        """Process-stable 16-hex-char id of the result-determining
        fields (see module docstring for what is excluded)."""
        return self._hash()

    @property
    def resume_hash(self) -> str:
        """Identity of the training STREAM a checkpoint belongs to:
        ``spec_hash`` minus ``rounds``, because extending a run to more
        rounds is the one legitimate cross-spec resume."""
        return self._hash(extra_exclude=("rounds",))
