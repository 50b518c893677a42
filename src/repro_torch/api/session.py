"""``build(spec) -> Session`` -- the runnable side of the front door:
the port of ``repro.api.session``.

A Session wraps one mode implementation (resolved from the mode
registry) behind a uniform surface:

  session.run()      train, return a versioned :class:`RunResult`
  session.predict()  class predictions from the trained params
  session.resume()   continue from the latest intact checkpoint in
                     ``spec.checkpoint_dir``
  session.server()   a ``FederatedServer`` over the trained params
  session.serve()    serve a batch of requests through it

``device`` is an execution argument, not a spec field: None means
CUDA (``resolve_device``), and nothing falls back to the CPU.

Contract (tests/test_torch_api.py on the CPU, chip_smoke.py's ``api``
phase on the card):

  * a single-seed federated Session reproduces
    ``DeVertiFL(ProtocolConfig(...)).train()`` bit for bit -- the same
    init generator, round r's batches from ``round_generator(seed, r)``,
    the same history entries -- in every mode, lane and padding;
  * a ``resume()`` after a checkpoint is bit for bit the uninterrupted
    run (round r consumes only the carried state and its own
    generator), and its checkpoints carry the reference's keys and
    stamps, so a checkpoint crosses between the packages;
  * ``spec_hash`` is the reference's for equal fields;
  * a multi-seed federated Session runs its seeds as unpadded lanes of
    one round (``core.sweep.run_cell``), and a spec grid
    (``spec_grid`` -> ``run_grid``) one lane batch a (dataset, mode)
    (``core.sweep.run_padded_cells``), with the reference's validation
    errors, keys and per-cell ``spec_hash``.

A spec's schedule, fault plan and transform run through the round
engine's layers (``core.protocol.resolve_engine``); their state rides
the checkpoints under the reference's ``sched/...`` keys, and the
stream stamp (``_stream_stamp``) refuses a checkpoint of another
stream.  With a fault plan, ``run(retry="auto")`` arms the divergence
watchdog (``repro_torch.faults.RetryPolicy``): a round whose losses
diverge is rolled back and retried from a reseeded stream.

A spec's ``obs`` level other than "none" arms the metric taps (their
series land in ``RunResult.telemetry.series``) and a ``SpanTracer``
(``session.tracer``) with spans for build, round, eval and checkpoint,
and for a server's request lifecycle.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import time
import warnings
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.api.modes import get_mode
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import (CheckpointCorruptError,
                                    checkpoint_steps, load_checkpoint,
                                    load_entry, save_checkpoint)
from repro_torch.core import sweep as SW
from repro_torch.core.baselines import SplitNN, SplitNNConfig
from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                       resolve_device, round_generator,
                                       train_generators)
from repro_torch.faults import DivergenceError, RetryPolicy, diverged
from repro_torch.obs import NullTracer, SpanTracer, Telemetry
from repro_torch.tree import tree_map

# the reference's schema: 5 adds the unified ``telemetry`` record, from
# which the legacy ``timings`` dict is derived
RESULT_SCHEMA_VERSION = 5
_CKPT_NAME = "session"


def _hash_array(hex_hash: str) -> np.ndarray:
    """16-hex-char hash -> uint8[8], checkpointable alongside params."""
    return np.frombuffer(bytes.fromhex(hex_hash), np.uint8)


def _copy_state(state):
    """A deep copy of a (nested) state: tensors cloned, numpy arrays
    copied.  Training updates the parameters in place, so the
    watchdog's rollback snapshot must not alias them."""
    if isinstance(state, dict):
        return {k: _copy_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_copy_state(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, np.ndarray):
        return state.copy()
    return state


def _schedule_hash(schedule: str) -> str:
    """Process-stable 16-hex-char id of a canonical schedule spec
    string -- the checkpoint stamp resume() verifies."""
    return hashlib.sha256(
        ("schedule:" + schedule).encode()).hexdigest()[:16]


def _stream_stamp(spec) -> str:
    """The schedule(+fault)(+wire)(+obs) identity stamped into
    checkpoints, the reference's.  At ``fault="none"``,
    ``transform="none"`` and ``obs="none"`` it is the schedule stamp; a
    non-none plan, transform or obs level extends the stamped string,
    so a checkpoint written under one stream never continues under
    another (its crash countdowns, straggler rings and byte counters
    belong to its own stream)."""
    ident = spec.schedule if spec.fault == "none" else \
        f"{spec.schedule}|fault={spec.fault}"
    if spec.transform != "none":
        ident = f"{ident}|wire={spec.transform}"
    if spec.obs != "none":
        ident = f"{ident}|obs={spec.obs}"
    return _schedule_hash(ident)


# obs series slots in the carried sched state (ObsImpl sits outermost,
# so they live at the top level) -- all [rounds, ...]: their leading
# axis is the WRITING spec's rounds, which a resume may change
_OBS_SERIES = ("s_loss", "s_exn", "s_gn", "s_quar", "s_bytes",
               "s_stale")


def _obs_series_like(sched_like, directory, step):
    """A like-tree whose obs series leaves take the CHECKPOINT's round
    capacity (axis 0) so the structured load accepts them; any other
    shape difference is left for load_checkpoint's own error."""
    out = dict(sched_like)
    for k in _OBS_SERIES:
        if k not in out:
            continue
        saved = load_entry(directory, step, f"sched/{k}", name=_CKPT_NAME)
        have = out[k]
        if saved is not None and saved.shape != tuple(have.shape) \
                and saved.shape[1:] == tuple(have.shape)[1:]:
            out[k] = torch.zeros(saved.shape, dtype=have.dtype,
                                 device=have.device)
    return out


def _obs_series_refit(sched, sched_like):
    """Refit restored series rows to this spec's rounds: zero-pad the
    tail (rows the resumed run will write) or drop trailing rows that
    were never written (a checkpoint at round r has rows [0, r), and
    resume refuses r > spec.rounds)."""
    out = dict(sched)
    for k in _OBS_SERIES:
        if k not in out:
            continue
        arr, rows = out[k], sched_like[k].shape[0]
        if arr.shape[0] > rows:
            out[k] = arr[:rows]
        elif arr.shape[0] < rows:
            out[k] = torch.cat([arr, arr.new_zeros(
                (rows - arr.shape[0],) + tuple(arr.shape[1:]))])
    return out


@lru_cache(maxsize=1)
def git_sha() -> str:
    """`git describe --always --dirty` of this checkout ("unknown"
    outside a repo; cached -- constant per process)."""
    try:
        return subprocess.check_output(
            ["git", "describe", "--always", "--dirty"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            text=True, stderr=subprocess.DEVNULL).strip()
    except Exception:
        return "unknown"


def _clean(v):
    """JSON-safe: arrays and tensors -> lists, numpy scalars -> python."""
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


@dataclass
class RunResult:
    """Versioned result record.  ``params`` (the trained per-client
    param stack, or the SplitNN param dict) is carried for programmatic
    use but excluded from ``to_dict()`` so results serialize small."""
    spec: ExperimentSpec
    spec_hash: str
    git_sha: str
    metrics: dict                   # final metrics ("f1", "acc", ...)
    history: List[dict] = field(default_factory=list)
    # DEPRECATED alias derived from ``telemetry.to_timings()``
    timings: dict = field(default_factory=dict)
    params: Any = None
    resumed_from: Optional[int] = None
    telemetry: Optional[Telemetry] = None
    schema_version: int = RESULT_SCHEMA_VERSION

    def to_dict(self) -> dict:
        """JSON-safe dict (the bench schema embeds this shape)."""
        return {
            "schema_version": self.schema_version,
            "spec": self.spec.to_dict(),
            "spec_hash": self.spec_hash,
            "git_sha": self.git_sha,
            "metrics": _clean(self.metrics),
            "history": _clean(self.history),
            "timings": _clean(self.timings),
            "resumed_from": self.resumed_from,
            "telemetry": (None if self.telemetry is None
                          else self.telemetry.to_dict()),
        }


def _protocol_config(spec: ExperimentSpec, internal: str) -> ProtocolConfig:
    """The thin internal config a spec lowers to (field for field; the
    spec's extra knobs -- eval cadence, checkpointing, shard -- live at
    the Session layer)."""
    return ProtocolConfig(
        dataset=spec.dataset, n_clients=spec.n_clients,
        rounds=spec.rounds, epochs=spec.epochs,
        batch_size=spec.batch_size, lr=spec.lr,
        exchange_at=spec.exchange_at, mode=internal, fedavg=spec.fedavg,
        seed=spec.seed, n_samples=spec.n_samples, engine=spec.engine,
        first_layer=spec.first_layer, schedule=spec.schedule,
        fault=spec.fault, transform=spec.transform, obs=spec.obs,
        max_clients=spec.max_clients)


def _sweep_config(spec: ExperimentSpec, client_counts, schedules=None,
                  faults=None, transforms=None) -> SW.SweepConfig:
    """The SweepConfig of ``spec``'s cells at ``client_counts`` and the
    given schedule, fault and transform axes (default: the spec's
    own)."""
    return SW.SweepConfig(
        client_counts=tuple(client_counts), seeds=spec.seeds,
        rounds=spec.rounds, epochs=spec.epochs,
        batch_size=spec.batch_size, lr=spec.lr,
        exchange_at=spec.exchange_at, fedavg=spec.fedavg,
        n_samples=spec.n_samples, first_layer=spec.first_layer,
        schedules=tuple(schedules or (spec.schedule,)),
        faults=tuple(faults or (spec.fault,)),
        transforms=tuple(transforms or (spec.transform,)),
        obs=(spec.obs,))


class Session:
    """One runnable experiment on ``device`` (CUDA unless the caller
    names another).  Construct via :func:`build`."""

    def __init__(self, spec: ExperimentSpec, device=None):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"build() takes an ExperimentSpec, got "
                            f"{type(spec).__name__}")
        self.spec = spec
        self.device = resolve_device(device)
        self.mode = get_mode(spec.mode)
        self._fed = None
        self._runner = None
        self._last_params = None
        # host-side span tracer: armed with the taps (obs != "none"),
        # the no-op NullTracer otherwise
        self.tracer = SpanTracer() if spec.obs != "none" else NullTracer()

    # ------------------------------------------------------------------
    @property
    def federation(self) -> DeVertiFL:
        """The underlying DeVertiFL engine (federated modes only) --
        built lazily, shared by run/resume/predict."""
        if self.mode.kind != "federated":
            raise ValueError(f"mode {self.spec.mode!r} has no DeVertiFL "
                             "federation (it is not a federated mode)")
        if self._fed is None:
            with self.tracer.span("build", cat="setup",
                                  dataset=self.spec.dataset):
                self._fed = DeVertiFL(
                    _protocol_config(self.spec, self.mode.internal),
                    device=self.device)
        return self._fed

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _result(self, metrics, history, params, telemetry,
                resumed_from=None) -> RunResult:
        """The one RunResult construction path; a custom runner's
        legacy timings dict is lifted through
        ``Telemetry.from_timings``."""
        self._last_params = params
        if not isinstance(telemetry, Telemetry):
            telemetry = Telemetry.from_timings(telemetry)
        if self.tracer.active:
            telemetry.spans = self.tracer.to_records()
        return RunResult(spec=self.spec, spec_hash=self.spec.spec_hash,
                         git_sha=git_sha(), metrics=metrics,
                         history=history,
                         timings=telemetry.to_timings(), params=params,
                         resumed_from=resumed_from,
                         telemetry=telemetry)

    # ------------------------------------------------------------------
    def run(self, key=None, retry="auto") -> RunResult:
        """Train from scratch.  ``key`` is an int seed that overrides
        the spec's (single-seed federated sessions only); it is refused
        with checkpointing, since resume() would continue on the spec
        seed's stream.

        ``retry`` is the divergence-watchdog policy
        (``repro_torch.faults``): "auto" arms a default
        :class:`RetryPolicy` when the spec carries a fault plan and
        nothing otherwise; pass a RetryPolicy to arm it, or None/False
        to disable.  On a trip the round is rolled back to the last good
        state and retried from a reseeded stream; trip and retry counts
        land in ``RunResult.timings["fault"]``.  Single-seed federated
        sessions only."""
        spec = self.spec
        if retry not in ("auto", None, False) and \
                (self.mode.kind != "federated" or len(spec.seeds) > 1):
            raise ValueError(
                "retry= applies to single-seed federated sessions: the "
                "divergence watchdog drives the per-round host loop")
        if key is not None and (self.mode.kind != "federated"
                                or len(spec.seeds) > 1):
            raise ValueError(
                "key= applies to single-seed federated sessions; other "
                "modes and multi-seed cells derive keys from the spec "
                "seeds")
        if key is not None and spec.checkpoint_every:
            raise ValueError(
                "key= cannot be combined with checkpointing: the "
                "custom key is not recorded, so resume() would "
                "continue the run on the spec-seed key stream instead "
                "-- a silent hybrid trajectory")
        if self.mode.kind == "custom":
            runner = self.mode.runner(spec)
            self._runner = runner
            return self._result(*runner.run())
        if self.mode.kind == "splitnn":
            return self._run_splitnn()
        if len(spec.seeds) > 1:
            return self._run_cell()
        return self._run_federated(key=key, retry=retry)

    def resume(self, retry="auto") -> RunResult:
        """Continue from the newest INTACT checkpoint in
        ``spec.checkpoint_dir`` (a fresh ``run()`` if none exists).
        Corrupt or truncated files are skipped with a RuntimeWarning.
        Rounds after the checkpoint are bit for bit the uninterrupted
        run's."""
        spec = self.spec
        if not spec.checkpoint_dir:
            raise ValueError("resume() needs spec.checkpoint_dir")
        if self.mode.kind != "federated" or len(spec.seeds) > 1:
            raise ValueError("resume() supports single-seed federated "
                             "sessions")
        steps = checkpoint_steps(spec.checkpoint_dir, name=_CKPT_NAME)
        if not steps:
            return self.run(retry=retry)
        fed = self.federation
        want_sched = _hash_array(_stream_stamp(spec))
        params_like = fed.model.params()
        like_base = {"params": params_like,
                     "opt_state": fed.opt.init(params_like),
                     "step_idx": np.zeros((), np.int32),
                     "sched": fed.init_sched_state(),
                     "resume_hash": _hash_array(spec.resume_hash)}
        state, step = None, None
        for cand in reversed(steps):
            try:
                if cand > spec.rounds:
                    raise ValueError(
                        f"latest intact checkpoint in "
                        f"{spec.checkpoint_dir!r} is at round {cand}, "
                        f"beyond spec.rounds={spec.rounds}: resuming "
                        "would return a longer run's params under "
                        "this spec's hash; raise rounds or point at a "
                        "different checkpoint_dir")
                # the stream stamp first: a checkpoint written under
                # another schedule / fault plan / transform / obs level
                # carries other scan state
                got_sched = load_entry(spec.checkpoint_dir, cand,
                                       "schedule_hash", name=_CKPT_NAME)
                if got_sched is None:
                    if spec.schedule != "sync" or \
                            spec.fault != "none" or \
                            spec.transform != "none" or \
                            spec.obs != "none":
                        raise ValueError(
                            f"checkpoint in {spec.checkpoint_dir!r} "
                            "carries no schedule stamp (written by a "
                            "pre-schedule writer, i.e. under "
                            "schedule='sync', fault='none', "
                            "transform='none', obs='none'); it cannot "
                            f"resume under schedule={spec.schedule!r} "
                            f"/ fault={spec.fault!r} / "
                            f"transform={spec.transform!r} / "
                            f"obs={spec.obs!r} -- the saved state has "
                            "no schedule, fault, wire or obs buffers "
                            "to restore")
                elif not np.array_equal(got_sched, want_sched):
                    raise ValueError(
                        f"checkpoint in {spec.checkpoint_dir!r} was "
                        "written under a different exchange schedule, "
                        "fault plan or wire transform (or obs level) "
                        f"than this spec's (schedule={spec.schedule!r}, "
                        f"fault={spec.fault!r}, "
                        f"transform={spec.transform!r}, "
                        f"obs={spec.obs!r}): resuming would splice "
                        "mismatched scan state into this run; rebuild "
                        "the spec with the original "
                        "schedule+fault+transform+obs or use a fresh "
                        "checkpoint_dir")
                like = dict(like_base)
                if got_sched is not None:
                    like["schedule_hash"] = want_sched
                if spec.obs != "none":
                    # the series' capacity is the WRITER's rounds:
                    # load into the saved shape and refit below -- a
                    # series row a round is not trajectory state
                    like["sched"] = _obs_series_like(
                        like["sched"], spec.checkpoint_dir, cand)
                state = load_checkpoint(spec.checkpoint_dir, cand, like,
                                        name=_CKPT_NAME)
                if spec.obs != "none":
                    state["sched"] = _obs_series_refit(
                        state["sched"], like_base["sched"])
                step = cand
                break
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"resume(): skipping corrupt checkpoint at round "
                    f"{cand} ({e}); falling back to the next older "
                    "step", RuntimeWarning, stacklevel=2)
        if state is None:
            warnings.warn(
                f"resume(): every checkpoint in "
                f"{spec.checkpoint_dir!r} is corrupt; training from "
                "scratch", RuntimeWarning, stacklevel=2)
            return self.run(retry=retry)
        if not np.array_equal(state["resume_hash"],
                              _hash_array(spec.resume_hash)):
            raise ValueError(
                f"checkpoint in {spec.checkpoint_dir!r} belongs to a "
                "different experiment (resume_hash mismatch): resuming "
                "it under this spec would splice another run's params "
                "into this spec's RunResult")
        return self._run_federated(
            start_round=step,
            state=(state["params"], state["opt_state"],
                   int(state["step_idx"]), state["sched"]),
            resumed_from=step, retry=retry)

    def predict(self, x, params=None):
        """Class predictions on raw (original-column-order) inputs.
        Federated modes return the LIVE per-client [n_clients, B]
        stack (a tensor on the device; dead padded slots trimmed);
        splitnn returns numpy [B].  ``params`` defaults to the last
        run's."""
        params = params if params is not None else self._last_params
        if params is None:
            if len(self.spec.seeds) > 1:
                raise ValueError(
                    "multi-seed cells do not retain per-seed params; "
                    "run a single-seed session (seeds=(s,)) for "
                    "predict(), or pass params= explicitly")
            raise ValueError("predict() before run()/resume(): pass "
                             "params= or train first")
        if self.mode.kind == "federated":
            return self.federation.predict(params, x)[:self.spec.n_clients]
        if self.mode.kind == "splitnn":
            return self._splitnn().predict(params, x)
        if self._runner is None:    # predict with explicit params=
            self._runner = self.mode.runner(self.spec)
        return self._runner.predict(params, x)

    def server(self, params=None, *, max_slots=8, queue_cap=None,
               cache=128, overflow="reject"):
        """A :class:`repro_torch.serving.FederatedServer` over this
        spec's trained params on the Session's device:
        continuous-batched vertical inference where each request's
        features arrive split across clients (``submit``/``offer``),
        batched into ``max_slots`` predict slots advanced by one step,
        with a hot-entity exchange cache (LRU of ``cache`` entries keyed
        by spec_hash + entity id; pass an ExchangeCache to share one
        across servers, or ``None`` to disable) and bounded-queue
        admission (``queue_cap`` + ``overflow``: "reject" |
        "evict_oldest").

        Serving is bit for bit ``predict()`` per request -- invariant to
        arrival order, slot count, batch composition and cache state
        (tests/test_torch_federated_serving.py).  Like ``evaluate``,
        serving uses the synchronous evaluation exchange whatever the
        training ``schedule``/``fault`` plan."""
        from repro_torch.serving.federated import FederatedServer
        if self.mode.kind != "federated":
            raise ValueError(
                f"serve() runs federated modes; mode {self.spec.mode!r}"
                " has no multi-party inference path")
        params = params if params is not None else self._last_params
        if params is None:
            if len(self.spec.seeds) > 1:
                raise ValueError(
                    "multi-seed cells do not retain per-seed params; "
                    "run a single-seed session (seeds=(s,)) for "
                    "serve(), or pass params= explicitly")
            raise ValueError("serve() before run()/resume(): pass "
                             "params= or train first")
        fed = self.federation
        return FederatedServer(fed.model, fed.pcfg, fed.layout, params,
                               spec_hash=self.spec.spec_hash,
                               max_slots=max_slots, queue_cap=queue_cap,
                               cache=cache, overflow=overflow,
                               tracer=self.tracer, device=self.device)

    def serve(self, requests, params=None, **server_kw):
        """Batch convenience over :meth:`server`: submit every
        :class:`repro_torch.serving.ServeRequest` in arrival order,
        drain the slot pool, and return the
        :class:`repro_torch.serving.ServeReport` (per-request
        predictions + latency/cache/scheduler telemetry)."""
        srv = self.server(params, **server_kw)
        for req in requests:
            srv.submit(req)
        return srv.run()

    # ------------------------------------------------------------------
    def _retry_policy(self, retry) -> Optional[RetryPolicy]:
        """Resolve the run()/resume() ``retry`` argument: "auto" arms
        the default policy exactly when the spec carries a fault plan
        (fault-free runs keep the loop without snapshots)."""
        if retry == "auto":
            return RetryPolicy() if self.spec.fault != "none" else None
        if retry is None or retry is False:
            return None
        if isinstance(retry, RetryPolicy):
            return retry
        raise TypeError(
            f"retry must be 'auto', None/False, or a RetryPolicy; got "
            f"{type(retry).__name__}")

    def _run_federated(self, key=None, start_round=0, state=None,
                       resumed_from=None, retry="auto") -> RunResult:
        spec = self.spec
        fed = self.federation
        policy = self._retry_policy(retry)
        seed = spec.seed if key is None else key
        if state is None:
            init_gen, _ = train_generators(seed)
            params, opt_state = fed.start(fed.init_params(init_gen))
            step_idx, sched_state = 0, fed.init_sched_state()
        else:
            params, opt_state, step_idx, sched_state = state
            params, opt_state = fed.start(params, opt_state)
        draws = fed.draws(seed)
        history = []
        trips = retries = attempt = 0
        snapshot = None if policy is None else _copy_state(
            (params, opt_state, step_idx, sched_state))
        self._sync()
        t0 = time.perf_counter()
        r = start_round
        while r < spec.rounds:
            # a retried round draws its batches, coins and noise from a
            # reseeded stream; attempt 0 keeps the canonical one, so a
            # run that never trips is the watchdog-free run bit for bit
            with self.tracer.span("round", cat="train", round=r,
                                  attempt=attempt):
                params, opt_state, step_idx, sched_state, losses = \
                    fed.run_round(params, opt_state, step_idx,
                                  fed.perms(round_generator(seed, r,
                                                            attempt)),
                                  sched_state, draws.round(r, attempt))
            round_losses = None
            if policy is not None:
                round_losses = losses.cpu().numpy()
                if diverged(round_losses, policy.loss_threshold):
                    trips += 1
                    if attempt >= policy.max_retries:
                        raise DivergenceError(
                            f"round {r} of spec {spec.spec_hash} "
                            f"(fault={spec.fault!r}, "
                            f"schedule={spec.schedule!r}) diverged "
                            f"(non-finite loss or |loss| > "
                            f"{policy.loss_threshold:g}) and stayed "
                            f"diverged after {policy.max_retries} "
                            "reseeded retries from the last good state; "
                            "the run is not recoverable under this plan "
                            "-- lower the fault rate / lr, raise "
                            "RetryPolicy(max_retries=...), or inspect "
                            "the exchange guard telemetry of a "
                            "retry=None run")
                    attempt += 1
                    retries += 1
                    pause = policy.sleep_s(attempt)
                    if pause > 0:
                        time.sleep(pause)
                    # roll back: restore COPIES, so the snapshot survives
                    # the next attempt's in-place updates
                    p, o, step_idx, sched_state = _copy_state(snapshot)
                    params, opt_state = fed.start(p, o)
                    continue
                attempt = 0
                snapshot = _copy_state(
                    (params, opt_state, step_idx, sched_state))
            if spec.eval_every and (r + 1) % spec.eval_every == 0:
                with self.tracer.span("eval", cat="eval", round=r):
                    ev = fed.evaluate(params)
                ev["round"] = r
                ev["round_losses"] = (losses.cpu().numpy()
                                      if round_losses is None
                                      else round_losses)
                ev["loss"] = float(ev["round_losses"][-1])
                history.append(ev)
            if spec.checkpoint_every and \
                    (r + 1) % spec.checkpoint_every == 0:
                with self.tracer.span("checkpoint", cat="ckpt", round=r):
                    save_checkpoint(
                        spec.checkpoint_dir, r + 1,
                        {"params": params, "opt_state": opt_state,
                         "step_idx": np.asarray(step_idx, np.int32),
                         "sched": sched_state,
                         "resume_hash": _hash_array(spec.resume_hash),
                         "schedule_hash": _hash_array(
                             _stream_stamp(spec))},
                        name=_CKPT_NAME)
            r += 1
        self._sync()
        wall = time.perf_counter() - t0
        with self.tracer.span("eval", cat="eval", round=-1):
            final = fed.evaluate(params)
        steps = (spec.rounds - start_round) * spec.epochs * fed.n_batches
        telemetry = Telemetry(wall_s=wall, steps=steps,
                              steps_per_sec=steps / max(wall, 1e-9))
        tel = fed.fault_telemetry(sched_state)
        if tel is not None or policy is not None:
            telemetry.fault = {
                **({k: int(v) for k, v in tel.items()} if tel else {}),
                "watchdog_trips": trips, "retries": retries}
        wtel = fed.wire_telemetry(sched_state)
        if wtel is not None:
            # cumulative since round 0: the counters ride the carried
            # state, which a checkpoint restores
            raw, enc = int(wtel["raw_bytes"]), int(wtel["encoded_bytes"])
            telemetry.wire = {
                "raw_bytes": raw, "encoded_bytes": enc,
                "raw_bytes_per_round": raw // max(spec.rounds, 1),
                "encoded_bytes_per_round": enc // max(spec.rounds, 1)}
        telemetry.series = fed.obs_series(sched_state)
        return self._result(final, history,
                            tree_map(lambda p: p.detach().clone(), params),
                            telemetry, resumed_from=resumed_from)

    def _run_cell(self) -> RunResult:
        """The spec's seeds as unpadded lanes of one round
        (``core.sweep.run_cell``); keeps no params."""
        spec = self.spec
        cell = SW.run_cell(spec.dataset, self.mode.internal,
                           spec.n_clients,
                           _sweep_config(spec, (spec.n_clients,)),
                           device=self.device)
        metrics = {"f1": cell["f1_mean"], "acc": cell["acc_mean"],
                   "f1_std": cell["f1_std"],
                   "f1_per_seed": cell["f1_per_seed"],
                   "acc_per_seed": cell["acc_per_seed"],
                   "final_loss_mean": cell["final_loss_mean"],
                   "seeds": cell["seeds"]}
        telemetry = Telemetry(wall_s=cell["wall_s"],
                              steps_per_sec=cell["steps_per_sec"],
                              fault=cell.get("fault_telemetry"),
                              wire=cell.get("wire"),
                              series=cell.get("obs_series"))
        return self._result(metrics, [], None, telemetry)

    def _splitnn_config(self, seed) -> SplitNNConfig:
        spec = self.spec
        return SplitNNConfig(
            dataset=spec.dataset, n_clients=spec.n_clients,
            rounds=spec.rounds, epochs=spec.epochs,
            batch_size=spec.batch_size, lr=spec.lr, seed=seed,
            n_samples=spec.n_samples)

    def _splitnn(self) -> SplitNN:
        if self._runner is None:
            self._runner = SplitNN(self._splitnn_config(self.spec.seed),
                                   device=self.device)
        return self._runner

    def _run_splitnn(self) -> RunResult:
        spec = self.spec
        self._sync()
        t0 = time.perf_counter()
        if len(spec.seeds) == 1:
            sn = self._splitnn()
            metrics, params = sn.train(return_state=True)
            steps = spec.rounds * spec.epochs * sn.n_batches
        else:
            # params stay None: a multi-seed run keeps no single model
            # for predict() to silently pick
            params, f1s, accs, steps = None, [], [], 0
            for s in spec.seeds:
                sn = SplitNN(self._splitnn_config(s), device=self.device)
                m = sn.train()
                f1s.append(m["f1"]), accs.append(m["acc"])
                steps += spec.rounds * spec.epochs * sn.n_batches
            metrics = {"f1": float(np.mean(f1s)),
                       "acc": float(np.mean(accs)),
                       "f1_std": float(np.std(f1s)),
                       "f1_per_seed": f1s, "acc_per_seed": accs,
                       "seeds": list(spec.seeds)}
        wall = time.perf_counter() - t0     # predict() ends on the host
        return self._result(metrics, [], params,
                            Telemetry(wall_s=wall, steps=steps,
                                      steps_per_sec=steps / max(wall,
                                                                1e-9)))


def build(spec: ExperimentSpec, device=None) -> Session:
    """The front door: one validated spec -> one runnable Session on
    ``device`` (CUDA unless the caller names another)."""
    return Session(spec, device=device)


# ---------------------------------------------------------------------------
# spec grids
# ---------------------------------------------------------------------------
# grid cells must agree on everything but (dataset, mode, transform,
# fault, schedule, n_clients): a (dataset, mode) group is one lane batch
_GRID_COMMON = ("seeds", "rounds", "epochs", "batch_size", "lr",
                "exchange_at", "fedavg", "engine", "first_layer",
                "n_samples", "shard", "obs")


def spec_grid(datasets=("mnist", "fmnist", "titanic", "bank"),
              modes=("devertifl", "non_federated", "verticomb"),
              client_counts=(2, 3, 5), seeds=(0, 1, 2),
              schedules=("sync",), faults=("none",),
              transforms=("none",), **common):
    """The cartesian datasets x modes x transforms x faults x schedules
    x client_counts spec grid, as the reference builds it (staleness-,
    fault- and compression-tolerance grids are spec grids too).
    ``common`` forwards to every ExperimentSpec (rounds=, epochs=,
    first_layer=, ...)."""
    return tuple(
        ExperimentSpec(dataset=ds, mode=mode, n_clients=nc, seeds=seeds,
                       schedule=sched, fault=f, transform=t, **common)
        for ds in datasets for mode in modes for t in transforms
        for f in faults for sched in schedules for nc in client_counts)


def _grid_groups(specs):
    """Group a spec sequence by (dataset, mode) preserving order, after
    validating grid homogeneity.  Returns [((ds, mode), [spec, ...])]."""
    specs = list(specs)
    if not specs:
        raise ValueError("empty spec grid")
    for s in specs:
        if not isinstance(s, ExperimentSpec):
            raise TypeError(f"spec grids hold ExperimentSpec items, got "
                            f"{type(s).__name__}")
        for f in _GRID_COMMON:
            if getattr(s, f) != getattr(specs[0], f):
                raise ValueError(
                    f"grid specs must agree on {f!r} (they share one "
                    f"compiled round per dataset x mode): "
                    f"{getattr(s, f)!r} != {getattr(specs[0], f)!r}")
        if s.engine != "scan":
            raise ValueError("grids run on the vmapped sweep engine "
                             "(engine='scan')")
        if s.max_clients is not None:
            raise ValueError("grids pad the client axis automatically; "
                             "leave max_clients=None")
        if get_mode(s.mode).kind != "federated":
            raise ValueError(f"mode {s.mode!r} is not a federated mode; "
                             "grids run federated cells (run splitnn "
                             "rows as standalone sessions)")
    groups = {}
    for s in specs:
        g = groups.setdefault((s.dataset, s.mode), [])
        if any(p.n_clients == s.n_clients and p.schedule == s.schedule
               and p.fault == s.fault and p.transform == s.transform
               for p in g):
            raise ValueError(f"duplicate grid cell {s.dataset}/{s.mode}/"
                             f"{s.transform}/{s.fault}/{s.schedule}/"
                             f"{s.n_clients}")
        g.append(s)
    return list(groups.items())


def _group_axes(group):
    """Ordered-unique (client_counts, schedules, faults, transforms) of
    one (dataset, mode) spec group; the group must cover the full
    transform x fault x schedule x count cartesian."""
    counts, schedules, faults, transforms = [], [], [], []
    for s in group:
        for axis, v in ((counts, s.n_clients), (schedules, s.schedule),
                        (faults, s.fault), (transforms, s.transform)):
            if v not in axis:
                axis.append(v)
    want = {(t, f, sc, nc) for t in transforms for f in faults
            for sc in schedules for nc in counts}
    got = {(s.transform, s.fault, s.schedule, s.n_clients)
           for s in group}
    if got != want or len(group) != len(want):
        raise ValueError(
            f"spec grid group {group[0].dataset}/{group[0].mode} must "
            f"cover the full transform x fault x schedule x "
            f"client-count cartesian {sorted(want)}; got {sorted(got)}")
    return (tuple(counts), tuple(schedules), tuple(faults),
            tuple(transforms))


def sweep_config_for_specs(specs):
    """One (dataset, mode) spec group -> (dataset, internal_mode,
    SweepConfig) for ``core.sweep.run_padded_cells``."""
    groups = _grid_groups(specs)
    if len(groups) != 1:
        raise ValueError(
            f"expected one (dataset, mode) group, got "
            f"{[f'{ds}/{m}' for (ds, m), _ in groups]}; use "
            "repro_torch.api.run_grid for multi-group spec grids")
    (ds, mode), group = groups[0]
    return ds, get_mode(mode).internal, _sweep_config(group[0],
                                                      *_group_axes(group))


def run_grid(specs, shard=None, device=None):
    """Run a spec grid on ``device`` (CUDA unless the caller names
    another): one lane batch a (dataset, mode) group, exactly
    ``core.sweep.run_grid``'s execution and schema ({"cells":
    {"ds/mode/n": cell}, "compare": ...}), each cell stamped with the
    ``spec_hash`` of the spec that produced it.  As in the reference, a
    non-default schedule axis inserts the schedule into the keys
    ("ds/mode/sched/n"), a non-default fault axis prepends the plan
    ("ds/mode/fault/sched/n") and a non-default transform axis the
    transform ("ds/mode/transform/fault/sched/n").  A grid at an obs
    level other than "none" keys its cells as the sweep does
    ("ds/mode/obs/transform/fault/sched/n"; the reference's lookup
    misses those keys).  ``shard`` overrides the specs' shard policy."""
    cells, compare = {}, {}
    for (ds, mode), group in _grid_groups(specs):
        counts, schedules, faults, transforms = _group_axes(group)
        out = SW.run_padded_cells(
            ds, get_mode(mode).internal,
            _sweep_config(group[0], counts, schedules, faults, transforms),
            shard=group[0].shard if shard is None else shard,
            device=device)
        for s in group:
            if s.obs != "none":
                ck = (f"{s.obs}/{s.transform}/{s.fault}/{s.schedule}/"
                      f"{s.n_clients}")
            elif transforms != ("none",):
                ck = (f"{s.transform}/{s.fault}/{s.schedule}/"
                      f"{s.n_clients}")
            elif faults != ("none",):
                ck = f"{s.fault}/{s.schedule}/{s.n_clients}"
            elif schedules != ("sync",):
                ck = f"{s.schedule}/{s.n_clients}"
            else:
                ck = s.n_clients
            cell = out["cells"][ck]
            cell["spec_hash"] = s.spec_hash
            cells[f"{ds}/{mode}/{ck}"] = cell
            compare.setdefault(f"{ds}/{ck}", {})[mode] = cell["f1_mean"]
    return {"cells": cells, "compare": compare}
