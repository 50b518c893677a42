"""Federated serving: continuous-batched vertical inference, the port of
``repro.serving.federated``.

De-VertiFL inference is multi-party -- a prediction for one entity needs
EVERY client's feature slice plus the hidden-output exchange -- so the
serving path is built around three ideas:

  slot pool    a fixed pool of ``max_slots`` predict slots advanced by
               ONE batched step.  Free slots run padding and are gated
               out by a ``slot_mask`` (client_mask style), so occupancy
               can vary every step while the step keeps one shape and
               one function, built once per (max_slots, spec)
               configuration (``step_traces`` records it).  On the card
               the first layer of every slot is one ``vfl_matmul``
               launch a step.
  assembly     a request's features *arrive split across clients*:
               ``submit`` announces the request, ``offer(uid, client,
               payload)`` delivers one client's canonical column slice
               (``Layout.sizes[i]`` wide; ``split_features`` produces
               them from raw rows).  The request becomes admissible only
               when every live client has delivered -- or the
               hot-entity cache already holds its exchange stack, in
               which case NO client needs to compute or send anything.
  hot cache    an LRU keyed by ``(spec_hash, entity_id)`` holding the
               [n_clients, W] exchange-point activation stack captured
               bitwise from a previous step.  A hit is spliced into the
               slot batch by an exact select
               (``exchange.select_cached_exchange``), so cached and
               recomputed requests produce bit-identical predictions.

Admission is FIFO over readiness order and therefore deterministic for a
fixed call sequence.  The ready queue is bounded by ``queue_cap``; under
declared pressure (queue at cap -- never otherwise) the overflow policy
either rejects the incoming request or evicts the oldest queued one.
Every request carries wall-clock telemetry (submit -> ready -> admit ->
done) and :meth:`FederatedServer.report` folds it into a versioned
:class:`ServeReport` (p50/p99 latency, throughput, cache and scheduler
counters).

The staging buffers (the slot batch, the cached stacks and the two
gates) live in one host array, so a step copies them to the device in
one transfer, and the predictions and the post-select stacks come back
in one transfer each.

The parity contract -- ``Session.serve()`` == ``Session.predict()`` bit
for bit, invariant to arrival order, slot count, batch composition and
cache state -- is pinned in tests/test_torch_federated_serving.py and,
on the card, by chip_smoke.py's ``serve_fed`` phase.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.exchange import (hidden_output_exchange,
                                       select_cached_exchange)
from repro_torch.core.protocol import (exchange_width, make_h_all_fn,
                                       resolve_device, rest)
from repro_torch.obs import NullTracer, Telemetry
from repro_torch.wire import (WirePayload, get_wire_plan, pack, unpack,
                              wire_apply_static)

# 1: initial schema -- results/latency/throughput/cache/counters,
# spec_hash-stamped (the serving analog of RunResult's versioning)
# 2: reports carry an ``obs`` field -- the unified Telemetry record
# (serve counters + latency + tracer spans) as a JSON-safe dict; every
# schema-1 key is unchanged.  (The record is named ``obs`` because
# ``telemetry`` has been the per-request timing log since schema 1.)
SERVE_SCHEMA_VERSION = 2


def split_features(layout, x) -> Dict[int, np.ndarray]:
    """Raw original-column-order features (``[F]`` or ``[B, F]``) ->
    per-client payloads ``{i: x[..., partition[i]]}`` for the LIVE
    clients -- exactly the slice each feature party owns, in the order
    the canonical layout concatenates them."""
    x = np.asarray(x)
    return {i: x[..., np.asarray(p)]
            for i, p in enumerate(layout.partition[:layout.n_real])}


@dataclass
class ServeRequest:
    """One vertical inference request.

    uid        unique request id (results/telemetry key)
    entity_id  identity of the ROW being predicted -- the hot-entity
               cache key (with the spec hash).  Defaults to uid; repeat
               lookups of the same entity should share it.
    slices     optional per-client payloads ``{client: [F_i] slice}``
               (canonical column slices; ``split_features`` makes
               them).  Omitted slices arrive later via ``offer`` -- or
               never, if the entity is already cached.
    """
    uid: Any
    entity_id: Any = None
    slices: Optional[Dict[int, Any]] = None

    def __post_init__(self):
        if self.entity_id is None:
            self.entity_id = self.uid


class ExchangeCache:
    """LRU cache of hot entities' exchange-point activation stacks.

    Keys are ``(spec_hash, entity_id)`` -- the spec hash is part of the
    key so a cache (which may be shared across servers) can never serve
    one experiment's activations under another's params.  Values are
    the bitwise [n_clients, W] stacks captured from the serve step (or
    their packed ``WirePayload``); ``lookup`` counts hits/misses and
    refreshes recency, ``put`` evicts least-recently-used entries beyond
    ``capacity``.
    """

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        return len(self._store)

    def __contains__(self, key):
        return key in self._store

    def lookup(self, key):
        """The cached stack for ``key`` (refreshed to most-recent), or
        None; counts the hit/miss."""
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key, value):
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._store),
                "capacity": self.capacity}


@dataclass
class ServeReport:
    """Versioned serving record -- the RunResult analog for
    ``Session.serve()``.  ``results`` maps uid -> the live per-client
    prediction vector (bitwise what ``Session.predict`` returns for that
    row); ``telemetry`` is the per-request timing log; ``obs`` is the
    unified Telemetry record (JSON-safe dict: wall, serve counters,
    latency stats, tracer spans)."""
    spec_hash: str
    results: Dict[Any, np.ndarray]
    telemetry: List[dict] = field(default_factory=list)
    latency_ms: dict = field(default_factory=dict)
    throughput_rps: float = 0.0
    cache: Optional[dict] = None
    counters: dict = field(default_factory=dict)
    waiting: List[Any] = field(default_factory=list)
    rejected: List[Any] = field(default_factory=list)
    evicted: List[Any] = field(default_factory=list)
    obs: Optional[dict] = None
    schema_version: int = SERVE_SCHEMA_VERSION

    def to_dict(self) -> dict:
        """JSON-safe dict."""
        return {
            "schema_version": self.schema_version,
            "spec_hash": self.spec_hash,
            "results": {str(k): np.asarray(v).tolist()
                        for k, v in self.results.items()},
            "telemetry": [{k: v for k, v in t.items()}
                          for t in self.telemetry],
            "latency_ms": dict(self.latency_ms),
            "throughput_rps": self.throughput_rps,
            "cache": None if self.cache is None else dict(self.cache),
            "counters": dict(self.counters),
            "waiting": [str(u) for u in self.waiting],
            "rejected": [str(u) for u in self.rejected],
            "evicted": [str(u) for u in self.evicted],
            "obs": None if self.obs is None else dict(self.obs),
        }


def make_serve_step_fn(model, pcfg, layout, device, first_layer_fn=None):
    """The ONE batched predict step behind the slot pool.

    step(params, x, h_cached, use_cached, slot_mask, lay) ->
    (preds [n_clients, S], h_all [n_clients, S, W]), on ``device``:

      x           [S, F] canonical-order slot batch (free / cached
                  slots hold zeros)
      h_cached    [n_clients, S, W] cached exchange stacks (zeros for
                  fresh slots)
      use_cached  [S] 0/1 gate: 1 = splice ``h_cached`` in place of the
                  freshly computed stack (exact select)
      slot_mask   [S] 0/1 gate: 0 = dead (free) slot; its prediction is
                  forced to -1 so stale reads are loud

    The gates are tensors -- occupancy and cache state never change
    the function or its shapes -- and every op after the per-client
    forward is per-row, so each slot's prediction equals predict()'s
    row bitwise whatever shares the batch.  ``h_all`` returns the
    POST-select stack: what the cache should hold for each slot's
    entity (fresh slots' recompute, cached slots' unchanged bits).

    Under a non-none ``pcfg.transform`` (``repro_torch.wire``) the fresh
    stack passes the deterministic codec components (topk/int8) before
    the cache select, so what crosses the serving wire -- and what the
    cache stores -- is the encoded release, as in training; dp noise is
    a training-time release control and is not applied at serving.
    Codec idempotence keeps cached and recomputed requests
    bit-identical: a cached (already round-tripped) stack re-encodes to
    itself.
    """
    k = pcfg.exchange_at
    h_all_fn = make_h_all_fn(model, pcfg, layout, device,
                             first_layer_fn=first_layer_fn)
    exchange = pcfg.mode in ("devertifl", "verticomb")
    plan = get_wire_plan(getattr(pcfg, "transform", "none"))
    if plan.custom is not None:
        raise ValueError(
            f"custom transform {plan.spec!r} has no serving codec; "
            "serve with a built-in transform composition or "
            "transform='none'")

    @torch.no_grad()
    def step(params, x, h_cached, use_cached, slot_mask, lay):
        h_fresh = h_all_fn(params, x, lay)
        if not plan.is_none:
            h_fresh = wire_apply_static(plan, h_fresh)
        h_all = select_cached_exchange(h_fresh, h_cached, use_cached)
        h_ex = hidden_output_exchange(
            h_all, differentiable=False,
            client_mask=lay.client_mask) if exchange else h_all
        preds = torch.argmax(rest(model, k, params, h_ex), dim=-1)
        preds = torch.where(slot_mask[None, :] != 0, preds, -1)
        return preds, h_all

    return step


class FederatedServer:
    """Continuous-batched vertical inference over a fixed slot pool, on
    ``device`` (CUDA unless the caller names another).

    Construct via :meth:`repro_torch.api.Session.server` (or directly
    from a federation's model/pcfg/layout + trained param stack).  Drive
    it either as a batch -- ``submit`` everything, then ``run()`` -- or
    as a stream: interleave ``submit``/``offer`` with ``step()`` calls
    and collect ``report()`` at the end.
    """

    OVERFLOW = ("reject", "evict_oldest")

    def __init__(self, model, pcfg, layout, params, *, spec_hash="",
                 max_slots: int = 8, queue_cap: Optional[int] = None,
                 cache=128, overflow: str = "reject",
                 first_layer_fn=None, tracer=None, device=None):
        # request-lifecycle instants + step spans; the NullTracer
        # default keeps the serving path instrument-free
        self.tracer = tracer if tracer is not None else NullTracer()
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1 or None, got "
                             f"{queue_cap}")
        if overflow not in self.OVERFLOW:
            raise ValueError(f"unknown overflow policy {overflow!r}; "
                             f"pick one of {self.OVERFLOW}")
        self.device = resolve_device(device)
        self.params = params
        self.layout = layout
        self.spec_hash = spec_hash
        self.max_slots = max_slots
        self.queue_cap = queue_cap
        self.overflow = overflow
        self.n_live = layout.n_real
        self.n_clients = layout.n_clients      # padded client axis
        self.width = exchange_width(model, pcfg.exchange_at)
        # non-none wire plan: the step encodes the fresh exchange stack
        # and the cache stores the PACKED payload (WirePayload -- sparse
        # indices / int8 values / per-row scales), unpacked on
        # admission; codec idempotence makes the round trip bitwise
        self._plan = get_wire_plan(getattr(pcfg, "transform", "none"))
        self._lay = layout.arrays(self.device)
        self._sizes = tuple(layout.sizes)
        self._offsets = tuple(layout.offsets)
        self._F = layout.n_features

        if cache is None or cache is False or cache == 0:
            self.cache: Optional[ExchangeCache] = None
        elif isinstance(cache, ExchangeCache):
            self.cache = cache
        elif isinstance(cache, int) and not isinstance(cache, bool):
            self.cache = ExchangeCache(cache)
        elif cache is True:
            self.cache = ExchangeCache()
        else:
            raise TypeError(
                "cache must be an int capacity, an ExchangeCache, "
                f"True, or None/False/0 to disable; got {cache!r}")

        # host-side slot state: fixed-shape staging buffers, views of
        # ONE array so a step copies them to the device in one transfer
        S, n, W, F = max_slots, self.n_clients, self.width, self._F
        self._stage = np.zeros((S * F + n * S * W + 2 * S,), np.float32)
        cuts = np.cumsum([S * F, n * S * W, S])
        self._xbuf = self._stage[:cuts[0]].reshape(S, F)
        self._hbuf = self._stage[cuts[0]:cuts[1]].reshape(n, S, W)
        self._ubuf = self._stage[cuts[1]:cuts[2]]   # use_cached gates
        self._mbuf = self._stage[cuts[2]:]          # slot_mask gates
        self._cuts = tuple(int(c) for c in cuts)
        self._slots: List[Optional[Any]] = [None] * S

        self._assembly: Dict[Any, dict] = {}   # uid -> request record
        self._ready: deque = deque()
        self._info: Dict[Any, dict] = {}
        self.results: Dict[Any, np.ndarray] = {}
        self.telemetry: List[dict] = []
        self.admission_log: List[Any] = []
        self.rejected: List[Any] = []
        self.evicted: List[Any] = []
        # queue length observed at each eviction/rejection -- the
        # "declared pressure" witness (every entry equals queue_cap)
        self.pressure_log: List[int] = []
        self.steps = 0
        self.submitted = 0
        self.completed = 0
        self.max_occupancy = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

        self._step_fn = make_serve_step_fn(model, pcfg, layout, self.device,
                                           first_layer_fn=first_layer_fn)
        self._traces = 1

    # ------------------------------------------------------------------
    @property
    def step_traces(self) -> int:
        """Builds of the batched step: 1 for the server's life at one
        (max_slots, spec) configuration.  The step is one eager
        function, built once; the reference counts jit traces here, and
        the port has no compile to count (no ``torch.compile``, no CUDA
        graph)."""
        return self._traces

    @property
    def occupancy(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queued(self) -> int:
        return len(self._ready)

    @property
    def pending(self) -> List[Any]:
        """Uids still assembling (not all clients delivered, entity not
        cached)."""
        return list(self._assembly)

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest):
        """Announce a request (optionally with some or all slices
        attached).  Probes the hot-entity cache ONCE, here: a hit makes
        the request admissible with no feature delivery at all -- the
        cached exchange stack stands in for every client's
        computation."""
        if not isinstance(req, ServeRequest):
            raise TypeError(f"submit() takes a ServeRequest, got "
                            f"{type(req).__name__}")
        if req.uid in self._info:
            raise ValueError(f"duplicate request uid {req.uid!r}")
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        rec = {"uid": req.uid, "entity_id": req.entity_id,
               "t_submit": now, "status": "assembling",
               "cached": False, "slices": {}}
        self._info[req.uid] = rec
        self._assembly[req.uid] = rec
        self.submitted += 1
        self.tracer.instant("submit", cat="serve", uid=str(req.uid))
        if self.cache is not None:
            h = self.cache.lookup((self.spec_hash, req.entity_id))
            if h is not None:
                rec["cached"] = True
                rec["_h"] = h
                del self._assembly[req.uid]
                self._to_ready(rec)
                return req.uid
        for client, payload in (req.slices or {}).items():
            self.offer(req.uid, client, payload)
        return req.uid

    def offer(self, uid, client: int, payload):
        """Deliver one client's canonical column slice for a pending
        request.  Order is free -- readiness fires when the LAST live
        client delivers, whoever that is."""
        rec = self._info.get(uid)
        if rec is None:
            raise KeyError(f"offer() for unknown request uid {uid!r}; "
                           "submit() it first")
        if rec["status"] != "assembling":
            # cache-hit / queued / in-flight requests need no slices;
            # late deliveries are dropped silently (a straggler's
            # payload arriving after the request was served)
            return
        if not 0 <= client < self.n_live:
            raise ValueError(f"client {client} out of range for "
                             f"{self.n_live} live clients")
        payload = np.asarray(payload, np.float32).reshape(-1)
        want = self._sizes[client]
        if payload.shape != (want,):
            raise ValueError(
                f"request {uid!r}: client {client}'s slice must have "
                f"{want} features (Layout.sizes[{client}]), got "
                f"{payload.shape}")
        rec["slices"][client] = payload
        self.tracer.instant("offer", cat="serve", uid=str(uid),
                            client=client)
        if len(rec["slices"]) == self.n_live:
            x = np.zeros((self._F,), np.float32)
            for i, sl in rec["slices"].items():
                x[self._offsets[i]:self._offsets[i] + self._sizes[i]] = sl
            rec["_x"] = x
            del rec["slices"]
            del self._assembly[uid]
            self._to_ready(rec)

    def _to_ready(self, rec):
        """Move an assembled (or cache-hit) request to the bounded
        admission queue, applying the overflow policy under declared
        pressure (queue at cap) only."""
        rec["t_ready"] = time.perf_counter()
        if self.queue_cap is not None and \
                len(self._ready) >= self.queue_cap:
            self.pressure_log.append(len(self._ready))
            if self.overflow == "reject":
                rec["status"] = "rejected"
                self.rejected.append(rec["uid"])
                return
            old = self._ready.popleft()          # evict_oldest
            self._info[old]["status"] = "evicted"
            self.evicted.append(old)
        rec["status"] = "ready"
        self._ready.append(rec["uid"])
        self.tracer.instant("ready", cat="serve", uid=str(rec["uid"]),
                            cached=bool(rec["cached"]))

    # ------------------------------------------------------------------
    def _admit(self):
        """FIFO-fill free slots from the ready queue."""
        for s in range(self.max_slots):
            if not self._ready:
                break
            if self._slots[s] is not None:
                continue
            uid = self._ready.popleft()
            rec = self._info[uid]
            rec["t_admit"] = time.perf_counter()
            rec["status"] = "in_flight"
            self.admission_log.append(uid)
            self.tracer.instant("admit", cat="serve", uid=str(uid), slot=s)
            self._slots[s] = uid
            self._mbuf[s] = 1.0
            if rec["cached"]:
                self._ubuf[s] = 1.0
                self._xbuf[s] = 0.0
                h = rec.pop("_h")
                if isinstance(h, WirePayload):
                    h = unpack(h)
                self._hbuf[:, s, :] = h
            else:
                self._ubuf[s] = 0.0
                self._hbuf[:, s, :] = 0.0
                self._xbuf[s] = rec.pop("_x")
        self.max_occupancy = max(self.max_occupancy, self.occupancy)

    def _device_step(self):
        """One step on the device: the staging array in one copy, the
        predictions back in one, the post-select stacks in one (only
        when a cache will store them)."""
        S, n, W = self.max_slots, self.n_clients, self.width
        stage = torch.from_numpy(self._stage).to(self.device)
        c0, c1, c2 = self._cuts
        preds, h_all = self._step_fn(
            self.params, stage[:c0].view(S, self._F),
            stage[c0:c1].view(n, S, W), stage[c1:c2], stage[c2:],
            self._lay)
        preds = preds.cpu().numpy()
        return preds, (None if self.cache is None else h_all.cpu().numpy())

    def step(self) -> int:
        """Admit what fits, advance every occupied slot by the one
        batched step, complete and free them.  Returns the number of
        requests completed (0 when nothing was admissible)."""
        self._admit()
        if self.occupancy == 0:
            return 0
        with self.tracer.span("serve_step", cat="serve",
                              occupancy=self.occupancy):
            preds, h_all = self._device_step()
        self.steps += 1
        done = 0
        now = time.perf_counter()
        for s, uid in enumerate(self._slots):
            if uid is None:
                continue
            rec = self._info[uid]
            self.results[uid] = preds[:self.n_live, s].copy()
            rec["t_done"] = now
            rec["latency_s"] = now - rec["t_submit"]
            rec["queue_s"] = rec["t_admit"] - rec["t_ready"]
            rec["status"] = "done"
            self.tracer.instant("complete", cat="serve", uid=str(uid),
                                latency_ms=rec["latency_s"] * 1e3)
            if self.cache is not None and not rec["cached"]:
                h_slot = h_all[:, s, :].copy()
                if not self._plan.is_none:
                    h_slot = pack(self._plan, h_slot)
                self.cache.put((self.spec_hash, rec["entity_id"]), h_slot)
            self.telemetry.append(rec)
            self.completed += 1
            done += 1
            self._slots[s] = None
            self._mbuf[s] = 0.0
            self._ubuf[s] = 0.0
            self._xbuf[s] = 0.0
            self._hbuf[:, s, :] = 0.0
        self._t_last = now
        return done

    def run(self) -> "ServeReport":
        """Drain every admissible request (ready or in flight) and
        return the report.  Requests still assembling -- a client never
        delivered and the entity is not cached -- are left pending and
        listed in ``report().waiting``."""
        while self._ready or self.occupancy:
            if self.step() == 0:
                break
        return self.report()

    # ------------------------------------------------------------------
    def report(self) -> ServeReport:
        lat = np.asarray([t["latency_s"] for t in self.telemetry])
        latency_ms = {}
        if lat.size:
            latency_ms = {
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
                "mean": float(lat.mean() * 1e3),
                "max": float(lat.max() * 1e3)}
        wall = (self._t_last - self._t0) if (
            self._t0 is not None and self._t_last is not None) else 0.0
        thr = self.completed / wall if wall > 0 else 0.0
        unified = Telemetry(
            wall_s=wall, steps=self.steps, steps_per_sec=(
                self.steps / wall if wall > 0 else 0.0),
            serve={"submitted": self.submitted,
                   "completed": self.completed,
                   "rejected": len(self.rejected),
                   "evicted": len(self.evicted),
                   "throughput_rps": thr, **{
                       f"latency_{k}_ms": v for k, v in (
                           latency_ms or {}).items()}},
            spans=(self.tracer.to_records()
                   if self.tracer.active else None))
        return ServeReport(
            spec_hash=self.spec_hash,
            results=dict(self.results),
            telemetry=[{k: v for k, v in t.items()
                        if not k.startswith("_") and k != "slices"}
                       for t in self.telemetry],
            latency_ms=latency_ms,
            throughput_rps=thr,
            cache=None if self.cache is None else self.cache.stats,
            counters={"submitted": self.submitted,
                      "completed": self.completed,
                      "rejected": len(self.rejected),
                      "evicted": len(self.evicted),
                      "waiting": len(self._assembly),
                      "steps": self.steps,
                      "step_traces": self.step_traces,
                      "max_occupancy": self.max_occupancy,
                      "max_slots": self.max_slots},
            waiting=list(self._assembly),
            rejected=list(self.rejected),
            evicted=list(self.evicted),
            obs=unified.to_dict())

    @property
    def stats(self) -> dict:
        return {"active": self.occupancy, "queued": self.queued,
                "assembling": len(self._assembly),
                "done": self.completed}
