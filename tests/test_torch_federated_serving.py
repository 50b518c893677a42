"""The port's federated serving (``repro_torch.serving.federated`` behind
``Session.server``/``serve``) against the JAX package's
``repro.serving.federated``, and the reference's own pins inside the port
(``tests/test_serving.py``, case by case).

The load-bearing pin: **serving is predict, bit for bit** -- for any
slot count, request arrival order, per-client slice delivery order,
batch composition, queue pressure and cache state, every completed
request's per-client predictions equal the corresponding column of
``Session.predict()`` exactly.  Plus the slot scheduler's invariants on
randomized serialized workloads (fixed seeds): admitted requests
complete exactly once, occupancy never exceeds the pool, eviction
happens only under declared queue pressure, and a fixed plan replays
its admission order.

Cross-package: the reference's trained params carried across
(``repro_torch.interop``); port ``serve()`` equals the reference's
``FederatedServer`` results and reference ``predict`` exactly, in the
masked, slice and kernel lanes (the kernel lane through its plain
version on the CPU), at 1, 4 and 8 slots, in shuffled arrival orders,
with the cache on and off, and under a topk+int8 transform whose cache
holds packed payloads; the error texts and the request lifecycle's
spans equal the reference's.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.api import (ExchangeCache, ExperimentSpec, FederatedServer,
                             ServeReport, ServeRequest, build,
                             split_features)
from repro_torch.interop import params_from_numpy
from repro_torch.serving import SERVE_SCHEMA_VERSION, make_serve_step_fn
from repro_torch.wire import WirePayload
from test_torch_support import reference, to_np

SPEC = dict(dataset="mnist", mode="devertifl", n_clients=3, rounds=1,
            epochs=1, n_samples=512, eval_every=0)
N_REF = 24


def _cpu(spec):
    return build(spec, device="cpu")


@pytest.fixture(scope="module")
def trained():
    """One trained tiny session + raw test rows + the predict()
    reference block every parity test compares against."""
    sess = _cpu(ExperimentSpec(**SPEC))
    sess.run()
    xte = np.asarray(sess.federation.xte)[:N_REF]
    ref = sess.predict(xte).cpu().numpy()          # [n_live, N_REF]
    return sess, xte, ref


def make_requests(sess, xte, rows, uids=None, entities=None):
    lay = sess.federation.layout
    uids = uids if uids is not None else list(rows)
    entities = entities if entities is not None else \
        [f"e{r}" for r in rows]
    return [ServeRequest(uid=u, entity_id=e,
                         slices=split_features(lay, xte[r]))
            for u, e, r in zip(uids, entities, rows)]


def assert_parity(report, ref, uid_to_row):
    for uid, row in uid_to_row.items():
        got = report.results[uid]
        assert np.array_equal(got, ref[:, row]), \
            f"request {uid} (row {row}): {got} != {ref[:, row]}"


# ---------------------------------------------------------------------------
# parity pins
# ---------------------------------------------------------------------------
def test_serve_matches_predict_bitwise(trained):
    sess, xte, ref = trained
    reqs = make_requests(sess, xte, range(N_REF))
    report = sess.serve(reqs, max_slots=4)
    assert report.counters["completed"] == N_REF
    assert_parity(report, ref, {r: r for r in range(N_REF)})


@pytest.mark.parametrize("max_slots", [1, 2, 7, 32])
def test_slot_count_invariance(trained, max_slots):
    """The slot-pool size changes batching and padding (dead slots run
    garbage behind the slot_mask gate) but not one bit of any result."""
    sess, xte, ref = trained
    rows = list(range(10))
    report = sess.serve(make_requests(sess, xte, rows),
                        max_slots=max_slots)
    assert report.counters["max_occupancy"] <= max_slots
    assert report.counters["step_traces"] == 1
    assert_parity(report, ref, {r: r for r in rows})


@pytest.mark.parametrize("cache", [None, 2, 128])
def test_cache_state_invariance(trained, cache):
    """Cache off, thrashing (capacity 2), or ample -- and a second pass
    full of repeat entities -- all produce identical bits."""
    sess, xte, ref = trained
    rows = [0, 1, 2, 3, 4, 1, 2, 0, 5, 1]
    uids = list(range(len(rows)))
    reqs = make_requests(sess, xte, rows, uids=uids,
                         entities=[f"e{r}" for r in rows])
    report = sess.serve(reqs, max_slots=3, cache=cache)
    assert_parity(report, ref, dict(zip(uids, rows)))
    if cache is None:
        assert report.cache is None
    else:
        assert report.cache["hits"] + report.cache["misses"] == len(rows)


def test_arrival_order_invariance(trained):
    """Shuffled submit order + per-request shuffled, globally interleaved
    per-client slice delivery: results match predict() row for row no
    matter who sends last."""
    sess, xte, ref = trained
    lay = sess.federation.layout
    rows = list(range(12))
    rng = np.random.default_rng(0)
    for trial in range(3):
        srv = sess.server(max_slots=4)
        order = rng.permutation(rows)
        offers = []
        for r in order:
            srv.submit(ServeRequest(uid=int(r), entity_id=f"t{trial}-{r}"))
            sl = split_features(lay, xte[r])
            offers += [(int(r), c, sl[c]) for c in sl]
        rng.shuffle(offers)
        for uid, c, payload in offers:
            srv.offer(uid, c, payload)
        report = srv.run()
        assert report.counters["completed"] == len(rows)
        assert_parity(report, ref, {r: r for r in rows})


def test_partial_assembly_never_admits(trained):
    """A request missing one client's slice stays out of the slot pool;
    delivering the last slice (mid-stream, after steps already ran)
    completes it with the same bits."""
    sess, xte, ref = trained
    lay = sess.federation.layout
    srv = sess.server(max_slots=2)
    sl = split_features(lay, xte[0])
    srv.submit(ServeRequest(uid="slow", entity_id="slow"))
    srv.offer("slow", 0, sl[0])
    srv.offer("slow", 1, sl[1])
    assert srv.step() == 0                  # nothing admissible
    assert srv.pending == ["slow"]
    # a complete request overtakes the stuck one
    srv.submit(make_requests(sess, xte, [3], uids=["fast"])[0])
    assert srv.step() == 1
    assert np.array_equal(srv.results["fast"], ref[:, 3])
    srv.offer("slow", 2, sl[2])             # last slice arrives late
    report = srv.run()
    assert report.counters["waiting"] == 0
    assert np.array_equal(report.results["slow"], ref[:, 0])


def test_cache_hit_serves_without_any_slices(trained):
    """After one fresh serve, a repeat entity is served from the
    hot-entity cache with NO feature delivery from any client --
    bitwise the same prediction."""
    sess, xte, ref = trained
    srv = sess.server(max_slots=2, cache=16)
    srv.submit(make_requests(sess, xte, [5], uids=[0],
                             entities=["hot"])[0])
    srv.run()
    srv.submit(ServeRequest(uid=1, entity_id="hot"))    # no slices
    report = srv.run()
    assert report.cache["hits"] == 1
    assert np.array_equal(report.results[1], ref[:, 5])
    assert np.array_equal(report.results[1], report.results[0])
    cached_rec = [t for t in report.telemetry if t["uid"] == 1][0]
    assert cached_rec["cached"] is True


def test_cache_keyed_by_spec_hash(trained):
    """A cache shared across servers can never leak one spec's
    activations into another's predictions: the spec hash is part of the
    key, so the same entity_id under a different spec misses."""
    sess, xte, ref = trained
    other = _cpu(ExperimentSpec(**{**SPEC, "seeds": (1,)}))
    other.run()
    assert other.spec.spec_hash != sess.spec.spec_hash
    shared = ExchangeCache(capacity=64)
    srv_a = sess.server(max_slots=2, cache=shared)
    srv_a.submit(make_requests(sess, xte, [4], uids=["a"],
                               entities=["shared-entity"])[0])
    srv_a.run()
    assert shared.hits == 0 and len(shared) == 1
    xte_o = np.asarray(other.federation.xte)[:N_REF]
    srv_b = other.server(max_slots=2, cache=shared)
    srv_b.submit(ServeRequest(
        uid="b", entity_id="shared-entity",
        slices=split_features(other.federation.layout, xte_o[4])))
    rep_b = srv_b.run()
    assert shared.hits == 0 and len(shared) == 2
    ref_b = other.predict(xte_o).cpu().numpy()
    assert np.array_equal(rep_b.results["b"], ref_b[:, 4])


def test_padded_client_axis_parity(trained):
    """A padded federation (max_clients > n_clients: dead client slots
    ride the stack) serves the same bits as the unpadded one."""
    sess, xte, ref = trained
    padded = _cpu(ExperimentSpec(**SPEC, max_clients=5))
    padded.run()
    reqs = make_requests(padded, xte, range(8))
    report = padded.serve(reqs, max_slots=3)
    ref_p = padded.predict(xte[:8]).cpu().numpy()
    assert ref_p.shape[0] == SPEC["n_clients"]      # live prefix only
    for r in range(8):
        assert np.array_equal(report.results[r], ref_p[:, r])
        assert np.array_equal(report.results[r], ref[:, r])


@pytest.mark.parametrize("first_layer", ["masked", "slice", "kernel"])
def test_first_layer_lane_parity(trained, first_layer):
    """Serving rides whatever first-layer lane the spec trains --
    including the paper-literal masked reference and the kernel lane."""
    _, xte, _ = trained
    sess = _cpu(ExperimentSpec(**{**SPEC, "first_layer": first_layer}))
    sess.run()
    ref = sess.predict(xte[:6]).cpu().numpy()
    report = sess.serve(make_requests(sess, xte, range(6)), max_slots=4)
    assert_parity(report, ref, {r: r for r in range(6)})


@pytest.mark.parametrize("transform", ["topk:0.5+int8", "int8", "topk:0.25"])
def test_transform_cache_holds_packed_payloads(trained, transform):
    """Under a codec transform the cache stores the packed wire payload;
    a hit unpacks it to the bits of a fresh serve."""
    _, xte, _ = trained
    sess = _cpu(ExperimentSpec(**{**SPEC, "transform": transform}))
    sess.run()
    srv = sess.server(max_slots=4, cache=64)
    for r in make_requests(sess, xte, range(8)):
        srv.submit(r)
    fresh = srv.run()
    entry = srv.cache.lookup((sess.spec.spec_hash, "e3"))
    assert isinstance(entry, WirePayload)
    for r in range(8):
        srv.submit(ServeRequest(uid=f"hit{r}", entity_id=f"e{r}"))
    hits = srv.run()
    assert hits.cache["hits"] == 9     # the lookup above and 8 serves
    for r in range(8):
        assert np.array_equal(hits.results[f"hit{r}"], fresh.results[r])


def test_serve_step_is_built_once_per_server(trained):
    sess, xte, _ = trained
    srv = sess.server(max_slots=4)
    step = srv._step_fn
    for batch in ([0], [1, 2, 3], [4, 5, 6, 7]):
        for r in make_requests(sess, xte, batch,
                               uids=[f"{len(srv.results)}-{r}"
                                     for r in batch]):
            srv.submit(r)
        srv.run()
    assert srv._step_fn is step and srv.step_traces == 1
    fed = sess.federation
    fn = make_serve_step_fn(fed.model, fed.pcfg, fed.layout, fed.device)
    lay = fed.layout.arrays(fed.device)
    x = torch.zeros((3, fed.layout.n_features))
    preds, h_all = fn(sess._last_params, x, torch.zeros((3, 3, 10)),
                      torch.zeros(3), torch.tensor([1.0, 0.0, 1.0]), lay)
    assert preds.shape == (3, 3) and (preds[:, 1] == -1).all()
    assert h_all.shape == (3, 3, 10)


# ---------------------------------------------------------------------------
# admission / eviction under load
# ---------------------------------------------------------------------------
def test_rejection_only_under_declared_pressure(trained):
    sess, xte, ref = trained
    srv = sess.server(max_slots=1, queue_cap=2, overflow="reject")
    reqs = make_requests(sess, xte, range(6))
    for r in reqs:
        srv.submit(r)
    report = srv.run()
    # queue admits 2; everything beyond was rejected at full queue
    assert report.counters["completed"] == 2
    assert sorted(report.rejected) == [2, 3, 4, 5]
    assert all(p == 2 for p in srv.pressure_log)
    assert len(srv.pressure_log) == len(report.rejected)
    assert_parity(report, ref, {r: r for r in report.results})


def test_evict_oldest_sheds_the_head(trained):
    sess, xte, ref = trained
    srv = sess.server(max_slots=1, queue_cap=2, overflow="evict_oldest")
    for r in make_requests(sess, xte, range(5)):
        srv.submit(r)
    report = srv.run()
    # each overflow evicts the then-oldest queued request
    assert sorted(report.evicted) == [0, 1, 2]
    assert sorted(report.results) == [3, 4]
    assert all(p == 2 for p in srv.pressure_log)
    assert_parity(report, ref, {r: r for r in report.results})


def test_no_pressure_without_cap(trained):
    sess, xte, _ = trained
    srv = sess.server(max_slots=1)          # queue_cap=None: unbounded
    for r in make_requests(sess, xte, range(10)):
        srv.submit(r)
    report = srv.run()
    assert report.counters["completed"] == 10
    assert srv.pressure_log == []
    assert report.rejected == [] and report.evicted == []


# ---------------------------------------------------------------------------
# telemetry / report / build-once
# ---------------------------------------------------------------------------
def test_one_build_across_occupancies(trained):
    """Occupancy 1, partial, and full pools all run the SAME step: the
    gates are tensors, never Python branches."""
    sess, xte, _ = trained
    srv = sess.server(max_slots=4, cache=8)
    for batch in ([0], [1, 2, 3], [4, 5, 6, 7], [0, 1]):  # incl repeats
        for r in make_requests(sess, xte, batch,
                               uids=[f"{len(srv.results)}-{r}"
                                     for r in batch]):
            srv.submit(r)
        srv.run()
    assert srv.step_traces == 1
    assert srv.steps >= 4


def test_telemetry_and_report_schema(trained):
    sess, xte, _ = trained
    report = sess.serve(make_requests(sess, xte, range(5)), max_slots=2)
    assert isinstance(report, ServeReport)
    assert report.schema_version == SERVE_SCHEMA_VERSION == 2
    for t in report.telemetry:
        assert t["t_submit"] <= t["t_ready"] <= t["t_admit"] <= t["t_done"]
        assert t["latency_s"] >= 0 and t["queue_s"] >= 0
    assert report.latency_ms["p50"] <= report.latency_ms["p99"] \
        <= report.latency_ms["max"]
    assert report.throughput_rps > 0
    assert report.spec_hash == sess.spec.spec_hash
    json.dumps(report.to_dict())            # JSON-safe end to end
    assert report.obs["serve"]["completed"] == 5
    assert report.obs["spans"] is None      # obs="none": no tracer


def test_exchange_cache_lru_semantics():
    cache = ExchangeCache(capacity=2)
    a, b, c = (np.full((3, 4), v, np.float32) for v in (1, 2, 3))
    cache.put(("s", "a"), a)
    cache.put(("s", "b"), b)
    assert cache.lookup(("s", "a")) is a    # refreshes recency
    cache.put(("s", "c"), c)                # evicts LRU == "b"
    assert ("s", "b") not in cache
    assert cache.lookup(("s", "b")) is None
    assert cache.lookup(("s", "a")) is a
    assert cache.stats["evictions"] == 1
    assert cache.stats["size"] == 2
    with pytest.raises(ValueError, match="capacity"):
        ExchangeCache(0)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------
def _serve_error_cases(mod, sess, lay):
    """The reference's error cases, each a thunk (``mod`` holds the
    ServeRequest of the package under test)."""
    srv = sess.server(max_slots=2)
    srv.submit(mod.ServeRequest(uid=0, entity_id="x"))
    return [
        lambda: srv.offer("nope", 0, np.zeros(lay.sizes[0])),
        lambda: srv.submit(mod.ServeRequest(uid=0)),
        lambda: srv.offer(0, 99, np.zeros(4)),
        lambda: srv.offer(0, 0, np.zeros(lay.sizes[0] + 1)),
        lambda: srv.submit("not a request"),
        lambda: sess.server(overflow="drop-all"),
        lambda: sess.server(cache=1.5),
        lambda: sess.server(max_slots=0),
        lambda: sess.server(queue_cap=0),
    ]


def _any_error(fn):
    try:
        fn()
    except (ValueError, TypeError, KeyError) as e:
        return type(e).__name__, str(e).replace("repro_torch.", "repro.")
    return None


def test_serve_errors(trained):
    sess, xte, _ = trained
    lay = sess.federation.layout
    fresh = _cpu(ExperimentSpec(**SPEC))
    with pytest.raises(ValueError, match="before run"):
        fresh.server()
    nonfed = _cpu(ExperimentSpec(**{**SPEC, "mode": "splitnn"}))
    with pytest.raises(ValueError, match="federated"):
        nonfed.server(params={})
    multi = _cpu(ExperimentSpec(**{**SPEC, "seeds": (0, 1)}))
    with pytest.raises(ValueError, match="multi-seed"):
        multi.serve([])
    srv = sess.server(max_slots=2)
    with pytest.raises(KeyError, match="unknown request"):
        srv.offer("nope", 0, np.zeros(lay.sizes[0]))
    srv.submit(ServeRequest(uid=0, entity_id="x"))
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(ServeRequest(uid=0))
    with pytest.raises(ValueError, match="out of range"):
        srv.offer(0, 99, np.zeros(4))
    with pytest.raises(ValueError, match="features"):
        srv.offer(0, 0, np.zeros(lay.sizes[0] + 1))
    with pytest.raises(ValueError, match="overflow"):
        sess.server(overflow="drop-all")
    with pytest.raises(TypeError, match="cache"):
        sess.server(cache=1.5)
    with pytest.raises(ValueError, match="max_slots"):
        sess.server(max_slots=0)


def test_server_needs_cuda_unless_told_otherwise(trained):
    sess, _, _ = trained
    fed = sess.federation
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FederatedServer(fed.model, fed.pcfg, fed.layout,
                            sess._last_params)
    srv = FederatedServer(fed.model, fed.pcfg, fed.layout,
                          sess._last_params, device="cpu")
    assert srv.device.type == "cpu" and srv.step() == 0


# ---------------------------------------------------------------------------
# property tests: the slot scheduler, on fixed seeds
# ---------------------------------------------------------------------------
def build_plan(rng):
    """A randomized but fully serialized serving workload: admission
    order is a deterministic function of the plan, and the plan of the
    seed."""
    n_reqs = int(rng.integers(2, 11))
    max_slots = int(rng.integers(1, 5))
    queue_cap = None if rng.random() < 0.4 else int(rng.integers(1, 4))
    overflow = ("reject", "evict_oldest")[int(rng.integers(0, 2))]
    rows = rng.integers(0, 8, n_reqs)
    events = []
    for uid, row in enumerate(rows):
        events.append(("submit", uid, int(row)))
        for c in range(SPEC["n_clients"]):
            events.append(("offer", uid, int(row), c))
    shuffled = [events[i] for i in rng.permutation(len(events))]
    # submit must precede its offers: hold early offers, flush on submit
    fixed, held, seen = [], {}, set()
    for ev in shuffled:
        if ev[0] == "offer" and ev[1] not in seen:
            held.setdefault(ev[1], []).append(ev)
            continue
        fixed.append(ev)
        if ev[0] == "submit":
            seen.add(ev[1])
            fixed.extend(held.pop(ev[1], []))
    for _ in range(int(rng.integers(0, 5))):   # sprinkle step() calls
        fixed.insert(int(rng.integers(0, len(fixed) + 1)), ("step",))
    return (max_slots, queue_cap, overflow, tuple(fixed))


def _drive(sess, xte, plan, mod=None):
    """Execute a serialized event plan against a fresh server and return
    (server, report).  ``mod`` holds the ServeRequest and split_features
    of the package whose server ``sess`` builds (default: the port)."""
    req_cls = ServeRequest if mod is None else mod.ServeRequest
    split = split_features if mod is None else mod.split_features
    max_slots, queue_cap, overflow, events = plan
    srv = sess.server(max_slots=max_slots, queue_cap=queue_cap,
                      overflow=overflow, cache=16)
    lay = sess.federation.layout
    for ev in events:
        if ev[0] == "submit":
            _, uid, row = ev
            srv.submit(req_cls(uid=uid, entity_id=f"row{row}"))
        elif ev[0] == "offer":
            _, uid, row, client = ev
            srv.offer(uid, client, split(lay, xte[row])[client])
        else:                               # ("step",)
            srv.step()
    return srv, srv.run()


@pytest.mark.parametrize("seed", range(10))
def test_scheduler_invariants(trained, seed):
    """Every admitted request completes exactly once; occupancy never
    exceeds the pool; eviction/rejection happen only at declared
    pressure (ready queue exactly at cap)."""
    sess, xte, ref = trained
    plan = build_plan(np.random.default_rng(seed))
    max_slots, queue_cap, overflow, events = plan
    srv, report = _drive(sess, xte, plan)
    assert len(srv.admission_log) == len(set(srv.admission_log))
    assert sorted(report.results) == sorted(srv.admission_log)
    assert report.counters["completed"] == len(srv.admission_log)
    assert report.counters["max_occupancy"] <= max_slots
    shed = set(report.rejected) | set(report.evicted)
    assert shed.isdisjoint(report.results)
    assert len(srv.pressure_log) == len(shed)
    if queue_cap is None:
        assert srv.pressure_log == []
    else:
        assert all(p == queue_cap for p in srv.pressure_log)
    row_of = {ev[1]: ev[2] for ev in events if ev[0] == "submit"}
    for uid, preds in report.results.items():
        assert np.array_equal(preds, ref[:, row_of[uid]])


@pytest.mark.parametrize("seed", range(5))
def test_fixed_seed_admission_deterministic(trained, seed):
    """The same plan replayed on a fresh server reproduces the admission
    order, the shed set, and every result bitwise."""
    sess, xte, _ = trained
    plan = build_plan(np.random.default_rng(seed))
    srv1, rep1 = _drive(sess, xte, plan)
    srv2, rep2 = _drive(sess, xte, plan)
    assert srv1.admission_log == srv2.admission_log
    assert rep1.rejected == rep2.rejected
    assert rep1.evicted == rep2.evicted
    assert sorted(rep1.results) == sorted(rep2.results)
    for uid in rep1.results:
        assert np.array_equal(rep1.results[uid], rep2.results[uid])


# ---------------------------------------------------------------------------
# against the reference: its trained params carried across
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def ref_trained(ref):
    """The reference's tiny session trained in the slice lane, its
    params as numpy, and its test rows."""
    sess = ref.api.build(ref.api.ExperimentSpec(**SPEC, first_layer="slice"))
    res = sess.run()
    xte = np.asarray(sess.federation.xte)[:N_REF]
    return to_np(res.params), xte


def _pair(ref, params, lane, **extra):
    """(port Session, reference Session) of SPEC in ``lane`` (the port's
    name; the reference's ``pallas`` for ``kernel``) over ``params``."""
    kw = dict(SPEC, **extra)
    ours = _cpu(ExperimentSpec(**kw, first_layer=lane))
    theirs = ref.api.build(ref.api.ExperimentSpec(
        **kw, first_layer="pallas" if lane == "kernel" else lane))
    return ours, theirs, params_from_numpy(params, "cpu")


def _shuffled_offers(srv, mod, lay, xte, rows, rng, base):
    """Submit ``rows`` (uids ``base + row``, entities ``e{row}``) in a
    shuffled order with no slices, then deliver every client's slice in
    one globally shuffled interleaving; a request already served from
    the cache drops its slices."""
    offers = []
    for r in rng.permutation(rows):
        srv.submit(mod.ServeRequest(uid=base + int(r), entity_id=f"e{r}"))
        sl = mod.split_features(lay, xte[r])
        offers += [(base + int(r), c, sl[c]) for c in sl]
    for i in rng.permutation(len(offers)):
        uid, c, payload = offers[i]
        srv.offer(uid, c, payload)
    return srv.run()


@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
@pytest.mark.parametrize("max_slots", [1, 4, 8])
@pytest.mark.parametrize("cache", [None, 4])
def test_serve_is_the_references(ref, ref_trained, lane, max_slots, cache):
    """Port serve() == reference FederatedServer == reference predict ==
    port predict, exactly, for the same requests in the same shuffled
    arrival orders, over two passes of the same entities (the second
    hits the cache where it is on)."""
    params, xte = ref_trained
    ours, theirs, p = _pair(ref, params, lane)
    want = np.asarray(theirs.predict(xte, params=_ref_params(ref, params)))
    np.testing.assert_array_equal(ours.predict(xte, params=p).numpy(), want)
    rows = list(range(12))
    srv_o = ours.server(p, max_slots=max_slots, cache=cache)
    srv_t = theirs.server(_ref_params(ref, params), max_slots=max_slots,
                          cache=cache)
    for base in (0, 100):
        rep_o = _shuffled_offers(srv_o, _PORT, ours.federation.layout, xte,
                                 rows, np.random.default_rng(base), base)
        rep_t = _shuffled_offers(srv_t, ref.federated,
                                 theirs.federation.layout, xte, rows,
                                 np.random.default_rng(base), base)
        assert srv_o.admission_log == srv_t.admission_log
        assert set(rep_o.results) == set(rep_t.results)
        for r in rows:
            np.testing.assert_array_equal(rep_o.results[base + r],
                                          want[:, r])
            np.testing.assert_array_equal(
                np.asarray(rep_t.results[base + r]), want[:, r])
        assert rep_o.counters == rep_t.counters
        assert rep_o.cache == rep_t.cache
    if cache:
        assert rep_o.cache["hits"] > 0


class _PORT:
    ServeRequest = ServeRequest
    split_features = split_features


def _ref_params(ref, params):
    return ref.jax.tree.map(ref.jnp.asarray, params)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_replays_the_references(ref, ref_trained, seed):
    """A randomized serialized workload against both packages' servers:
    the same admission log, shed sets, pressure log, counters and
    results."""
    params, xte = ref_trained
    ours, theirs, p = _pair(ref, params, "slice")
    ours._last_params = p
    theirs._last_params = _ref_params(ref, params)
    plan = build_plan(np.random.default_rng(seed))
    srv_o, rep_o = _drive(ours, xte, plan)
    srv_t, rep_t = _drive(theirs, xte, plan, ref.federated)
    assert srv_o.admission_log == srv_t.admission_log
    assert srv_o.pressure_log == srv_t.pressure_log
    assert (rep_o.rejected, rep_o.evicted) == (rep_t.rejected, rep_t.evicted)
    assert rep_o.counters == rep_t.counters
    assert set(rep_o.results) == set(rep_t.results)
    for uid in rep_o.results:
        np.testing.assert_array_equal(rep_o.results[uid],
                                      np.asarray(rep_t.results[uid]))


@pytest.mark.parametrize("transform", ["topk:0.5+int8", "int8"])
def test_transform_serving_is_the_references(ref, ref_trained, transform):
    """Under a codec transform both packages encode the fresh stack, cache
    the packed payload and serve hits to the same bits."""
    params, xte = ref_trained
    ours, theirs, p = _pair(ref, params, "slice", transform=transform)
    reps = []
    for sess, mod, prm in ((ours, _PORT, p),
                           (theirs, ref.federated, _ref_params(ref, params))):
        srv = sess.server(prm, max_slots=4, cache=32)
        for r in range(8):
            srv.submit(mod.ServeRequest(uid=r, entity_id=f"e{r}",
                                        slices=mod.split_features(
                                            sess.federation.layout, xte[r])))
        srv.run()
        key = (sess.spec.spec_hash, "e2")
        entry = srv.cache.lookup(key)
        for r in range(8):
            srv.submit(mod.ServeRequest(uid=f"hit{r}", entity_id=f"e{r}"))
        reps.append((srv.run(), entry))
    (rep_o, ent_o), (rep_t, ent_t) = reps
    assert ent_o.nbytes == ent_t.nbytes
    assert ent_o.shape == tuple(ent_t.shape)
    for (io, vo, so), (it, vt, st) in zip(ent_o.entries, ent_t.entries,
                                          strict=True):
        assert (io is None) == (it is None)
        if io is not None:
            np.testing.assert_array_equal(io, it)
        np.testing.assert_array_equal(vo, np.asarray(vt))
        assert so == st
    for uid in rep_t.results:
        np.testing.assert_array_equal(rep_o.results[uid],
                                      np.asarray(rep_t.results[uid]))
    assert rep_o.cache == rep_t.cache


def test_serve_errors_are_the_references(ref, ref_trained, trained):
    params, xte = ref_trained
    ours, theirs, p = _pair(ref, params, "slice")
    ours._last_params = p
    theirs._last_params = _ref_params(ref, params)
    got = [_any_error(f) for f in _serve_error_cases(
        _PORT, ours, ours.federation.layout)]
    want = [_any_error(f) for f in _serve_error_cases(
        ref.federated, theirs, theirs.federation.layout)]
    assert got == want and all(got)
    fresh = (_cpu(ExperimentSpec(**SPEC)),
             ref.api.build(ref.api.ExperimentSpec(**SPEC)))
    assert _any_error(fresh[0].server) == _any_error(fresh[1].server)
    nonfed = (_cpu(ExperimentSpec(**{**SPEC, "mode": "splitnn"})),
              ref.api.build(ref.api.ExperimentSpec(**{**SPEC,
                                                      "mode": "splitnn"})))
    assert _any_error(lambda: nonfed[0].server(params={})) == \
        _any_error(lambda: nonfed[1].server(params={}))


def test_serving_spans_are_the_references(ref, ref_trained):
    """An obs Session's server records the reference's request
    lifecycle: the same instants and spans, names, categories, depths and
    arguments (timings aside)."""
    params, xte = ref_trained
    ours, theirs, p = _pair(ref, params, "slice", obs="basic")
    shapes = []
    for sess, mod, prm in ((ours, _PORT, p),
                           (theirs, ref.federated, _ref_params(ref, params))):
        srv = sess.server(prm, max_slots=2, cache=8)
        for r in [0, 1, 2, 1]:
            srv.submit(mod.ServeRequest(uid=len(srv._info), entity_id=f"e{r}",
                                        slices=mod.split_features(
                                            sess.federation.layout, xte[r])))
            srv.step()
        srv.run()
        shapes.append([(r["name"], r["cat"], r["ph"], r["depth"],
                        {k: v for k, v in r["args"].items()
                         if k != "latency_ms"})
                       for r in sess.tracer.to_records()])
    assert shapes[0] == shapes[1]
    assert {"submit", "offer", "ready", "admit", "serve_step",
            "complete"} <= {s[0] for s in shapes[0]}
