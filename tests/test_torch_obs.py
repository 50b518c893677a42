"""The port's obs layer (``repro_torch.obs``: the registry, the metric
taps, ``SpanTracer``, the telemetry record, ``prometheus_text`` and the
CLI) against the JAX package's ``repro.obs``, and the reference's own
invariants inside the port (``tests/test_obs.py``, case by case).

Cross-package: the parser's canonical strings and error texts, spec
hashes; titanic and mnist federations at ``obs="full"``, with and
without the schedule + fault + wire combination, replayed from the
reference's inits, batches, coins and noise: the loss and norm series
within ``LOSS_RTOL``, the quarantine, bytes and staleness series equal;
the Session's spans (names, nesting, categories, arguments; not the
timestamps) equal the reference ``SpanTracer``'s; ``prometheus_text`` of
equal reports byte-equal.

Inside the port: ``obs="full"`` and ``"basic"`` runs are bitwise
``obs="none"`` runs in every lane, also behind the combination; an obs
sweep's lanes are bitwise their standalone runs, series included;
tracer nesting and export; the telemetry record; the checkpoint stamp
and the series' refit on resume; ``profile_to`` and the CLI.
"""
import json
import re

import numpy as np
import pytest
import torch

from repro_torch.api import (ExperimentSpec, ServeRequest, build,
                             run_grid, spec_grid, split_features)
from repro_torch.configs import get_config
from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig, arch_for,
                                       resolve_engine)
from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                    run_cell, run_padded_cells)
from repro_torch.models.mlp_model import PaperMLP
from repro_torch.obs import (LATENCY_BUCKETS_S, SERIES_KEYS, NullTracer,
                             ObsImpl, SpanTracer, Telemetry,
                             TELEMETRY_SCHEMA_VERSION, get_obs_plan,
                             metrics_table, obs_names, prometheus_text,
                             register_obs)
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.schedule import LaneScheduleImpl
from repro_torch.tree import tree_leaves
from test_torch_support import (LOSS_RTOL, assert_engine_replays,
                                engine_traj, port_engine_run, reference,
                                reference_engine_run)

TINY = dict(dataset="titanic", n_clients=3, rounds=2, epochs=2,
            seeds=(0,))
# taps chained behind the engine stack (the reference's test stack)
STACK = dict(schedule="stale_k:1", fault="crash:0.5", transform="int8")
# every layer at once (chip_smoke.py's adversity combination)
COMBO = dict(schedule="stale_k:2", fault="crash:0.2+corrupt:0.05",
             transform="topk:0.5+int8+dp:0.1")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        # the tests below register these custom names; both registries
        # get them here, so both list the same options
        for name in ("test_tap", "test_tap2"):
            ns.obs.register_obs(name, lambda **kw: None, overwrite=True)
            if name not in obs_names():
                register_obs(name, lambda **kw: None)
        yield ns


def _cpu(spec):
    return build(spec, device="cpu")


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e).replace("repro_torch.", "repro.")
    return None


# ---------------------------------------------------------------------------
# registry + spec parsing
# ---------------------------------------------------------------------------
def test_obs_plan_parsing_and_registry_errors():
    assert get_obs_plan("none").level == 0
    assert get_obs_plan("basic").level == 1
    full = get_obs_plan("full")
    assert full.level == 2 and full.spec == "full"
    assert not full.is_none and get_obs_plan("none").is_none
    assert {"none", "basic", "full"} <= set(obs_names())
    with pytest.raises(ValueError, match="basic"):   # options listed
        get_obs_plan("nope")
    with pytest.raises(ValueError, match="no arguments"):
        get_obs_plan("full:3")
    with pytest.raises(ValueError, match="malformed"):
        get_obs_plan("  ")


@pytest.mark.parametrize("spec", ["none", "basic", "full", " full ",
                                  "nope", "full:3", "  ", ""])
def test_obs_parse_is_the_references(ref, spec):
    ours = _error(lambda: get_obs_plan(spec))
    theirs = _error(lambda: ref.obs.get_obs_plan(spec))
    assert ours == theirs
    if ours is None:
        a, b = get_obs_plan(spec), ref.obs.get_obs_plan(spec)
        assert (a.spec, a.level, a.is_none) == (b.spec, b.level, b.is_none)


@pytest.mark.parametrize("obs", ["none", "basic", "full"])
def test_obs_spec_hashes_are_the_references(ref, obs):
    kw = dict(dataset="titanic", first_layer="slice", obs=obs, **COMBO)
    assert ExperimentSpec(**kw).spec_hash == \
        ref.api.ExperimentSpec(**kw).spec_hash
    assert _error(lambda: ExperimentSpec(
        dataset="titanic", mode="verticomb", obs=obs)) == _error(
        lambda: ref.api.ExperimentSpec(dataset="titanic", mode="verticomb",
                                       obs=obs))


def test_register_obs_custom_plan_parses_and_is_refused_in_lanes():
    def make(inner, n_clients, batch_size, width, rounds, args):
        return ObsImpl(get_obs_plan("full"), inner, n_clients,
                       batch_size, width, rounds)

    register_obs("test_tap", make, overwrite=True)
    plan = get_obs_plan("test_tap:7")
    assert plan.custom[0] == "test_tap" and plan.custom[2] == ("7",)
    assert not plan.is_none
    impl = ObsImpl(get_obs_plan("full"), LaneScheduleImpl(0, 3, 16, 8), 3,
                   16, 8, rounds=2)
    with pytest.raises(ValueError, match="custom obs plan"):
        impl.init_state(None, obs=plan)
    # a custom plan runs as a standalone federation, bitwise "none"
    a = engine_traj(dataset="titanic", n_clients=3, rounds=2, epochs=1)
    b = engine_traj(dataset="titanic", n_clients=3, rounds=2, epochs=1,
                    obs="test_tap:7")
    np.testing.assert_array_equal(a[0], b[0])
    assert b[2].obs_series(b[3])["grad_norm"].shape == (2, 3)


# ---------------------------------------------------------------------------
# obs="none" is the sync engine; obs is hash-excluded
# ---------------------------------------------------------------------------
def _engine_args(pcfg):
    return PaperMLP(get_config(arch_for(pcfg.dataset)), 3), 500, "cpu"


def test_obs_none_leaves_engine_unwrapped_and_hash_is_shared():
    base = ExperimentSpec(**TINY)
    hashes = {base.replace(obs=o).spec_hash
              for o in ("none", "basic", "full")}
    assert len(hashes) == 1     # an obs level is NOT a new experiment
    pcfg = ProtocolConfig(dataset="titanic", n_clients=3, rounds=2)
    _, impl = resolve_engine(pcfg, *_engine_args(pcfg))
    assert impl is None          # the untouched sync path
    _, impl = resolve_engine(pcfg.replace(obs="basic"),
                             *_engine_args(pcfg))
    assert isinstance(impl, ObsImpl)
    assert isinstance(impl.inner, LaneScheduleImpl) and impl.inner.max_k == 0


def test_obs_requires_devertifl_mode():
    with pytest.raises(ValueError, match="devertifl"):
        ExperimentSpec(**{**TINY, "mode": "non_federated"}, obs="basic")
    with pytest.raises(ValueError, match="devertifl"):
        DeVertiFL(ProtocolConfig(dataset="titanic", mode="verticomb",
                                 obs="full"), device="cpu")


# ---------------------------------------------------------------------------
# bitwise parity + recorded series
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
@pytest.mark.parametrize("extra", [{}, STACK, COMBO],
                         ids=["sync", "sched+fault+wire", "combination"])
def test_obs_full_is_bitwise_none_and_records_series(extra, lane):
    a = _cpu(ExperimentSpec(**TINY, **extra, first_layer=lane)).run()
    b = _cpu(ExperimentSpec(**TINY, **extra, first_layer=lane,
                            obs="full")).run()
    assert _leaves_equal(a.params, b.params)
    assert a.metrics == b.metrics
    for ha, hb in zip(a.history, b.history, strict=True):
        np.testing.assert_array_equal(ha["round_losses"],
                                      hb["round_losses"])
    assert a.timings.get("fault") == b.timings.get("fault")
    assert a.timings.get("wire") == b.timings.get("wire")
    ser = b.telemetry.series
    assert set(ser) == set(SERIES_KEYS)
    R, n = TINY["rounds"], TINY["n_clients"]
    assert ser["loss"].shape == (R,)
    assert ser["exchange_norm"].shape == (R, n)
    assert ser["grad_norm"].shape == (R, n)
    assert (ser["loss"] > 0).all()
    assert (ser["exchange_norm"] > 0).any()
    assert (ser["grad_norm"] > 0).any()
    if extra:
        # staleness, bytes and quarantines are the inner layers' own
        # counters, cumulative
        assert (ser["staleness"] == int(extra["schedule"][-1])).all()
        assert (ser["encoded_bytes"] > 0).all()
        assert ser["encoded_bytes"][-1] == b.telemetry.wire["encoded_bytes"]
        assert ser["quarantined"][-1] == b.telemetry.fault["quarantined"]
    # the obs-free run records nothing but keeps the unified record
    assert a.telemetry.series is None
    assert a.timings == a.telemetry.to_timings()


def test_obs_basic_skips_per_client_series():
    res = _cpu(ExperimentSpec(**TINY, obs="basic")).run()
    full = _cpu(ExperimentSpec(**TINY, obs="full")).run()
    ser = res.telemetry.series
    assert (ser["loss"] > 0).all()
    np.testing.assert_array_equal(ser["loss"], full.telemetry.series["loss"])
    # basic never computes the norm taps: the per-client series stay
    # exact zeros
    assert (ser["exchange_norm"] == 0).all()
    assert (ser["grad_norm"] == 0).all()


def test_obs_series_identical_across_scan_and_python_engines():
    a = _cpu(ExperimentSpec(**TINY, **STACK, obs="full")).run()
    b = _cpu(ExperimentSpec(**TINY, **STACK, obs="full",
                            engine="python")).run()
    assert _leaves_equal(a.params, b.params)
    for k in SERIES_KEYS:
        np.testing.assert_array_equal(a.telemetry.series[k],
                                      b.telemetry.series[k])


@pytest.mark.parametrize("extra", [{}, COMBO], ids=["sync", "combination"])
def test_padded_obs_series_are_unpadded_bitwise(extra):
    kw = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1,
              first_layer="kernel", obs="full", **extra)
    a, fa, fed_a, sa = engine_traj(**kw)
    b, fb, fed_b, sb = engine_traj(max_clients=5, **kw)
    np.testing.assert_array_equal(a, b)
    sera, serb = fed_a.obs_series(sa), fed_b.obs_series(sb)
    for k in SERIES_KEYS:
        got = serb[k][:, :3] if serb[k].ndim == 2 else serb[k]
        np.testing.assert_array_equal(sera[k], got)


# ---------------------------------------------------------------------------
# the reference's federations, replayed
# ---------------------------------------------------------------------------
LANES = [("slice", "slice"), ("masked", "masked"), ("pallas", "kernel")]


def _assert_series_replay(ours, theirs):
    for k in ("loss", "exchange_norm", "grad_norm"):
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    for k in ("quarantined", "encoded_bytes", "staleness"):
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]),
                                      err_msg=k)


@pytest.mark.parametrize("ref_lane,lane", LANES)
@pytest.mark.parametrize("extra", [{}, COMBO], ids=["sync", "combination"])
def test_obs_federation_replays_reference(ref, extra, ref_lane, lane):
    kw = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1,
              obs="full", **extra)
    r = reference_engine_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer=lane,
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL
    _assert_series_replay(fed.obs_series(sched), r.fed.obs_series(r.sched))


@pytest.mark.parametrize("extra", [{}, COMBO], ids=["sync", "combination"])
def test_obs_replays_reference_on_mnist(ref, extra):
    kw = dict(dataset="mnist", n_samples=600, n_clients=4, rounds=2,
              epochs=1, obs="full", **extra)
    r = reference_engine_run(ref, first_layer="slice", **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer="kernel",
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL
    _assert_series_replay(fed.obs_series(sched), r.fed.obs_series(r.sched))


# ---------------------------------------------------------------------------
# sweep lanes: every lane bitwise its standalone run, series included
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "kernel"])
def test_every_obs_lane_is_its_standalone_run(lane):
    obs = ("none", "basic", "full")
    transforms = ("none", "int8")
    lb = build_lane_batch("titanic", "devertifl", SweepConfig(
        client_counts=(2, 3), seeds=(0,), rounds=2, epochs=1,
        first_layer=lane, obs=obs, transforms=transforms), device="cpu")
    assert lb.n_lanes == 12
    params, opt, step, sched, out = (lb.params, lb.opt_state, 0,
                                     lb.sched_state, [])
    for r in range(2):
        params, opt, step, sched, lr = lb.round_fn(
            params, opt, step, lb.round_indices(r), lb.xtr, lb.ytr, lb.lay,
            sched, lb.round_draws(r))
        out.append(lr)
    losses = torch.cat(out, dim=1).numpy()
    series = lb.impl.obs_series(sched)
    assert series["loss"].shape == (12, 2)
    assert series["exchange_norm"].shape == (12, 2, 3)
    for li, (nc, s) in enumerate(lb.lanes):
        level, t = obs[li // 4], transforms[li // 2 % 2]
        want, _, fed, st = engine_traj(
            dataset="titanic", n_clients=nc, seed=s, rounds=2, epochs=1,
            first_layer=lane, transform=t, obs=level, max_clients=3)
        np.testing.assert_array_equal(losses[li], want)
        mine = {k: v[li] for k, v in series.items()}
        if level == "none":
            assert all((v == 0).all() for v in mine.values())
            continue
        theirs = fed.obs_series(st)
        if t == "none":
            # a "none" lane of a wire batch ships raw fp32 bytes, which
            # the wire layer counts; a standalone run has no wire layer
            assert mine["encoded_bytes"][-1] == \
                lb.impl.wire_telemetry(sched)["encoded_bytes"][li] > 0
            theirs["encoded_bytes"] = mine["encoded_bytes"]
        for k, v in theirs.items():
            np.testing.assert_array_equal(mine[k], v, err_msg=(li, k))


def test_obs_grid_runs_once_with_none_lanes_bitwise():
    scfg = SweepConfig(datasets=("titanic",), modes=("devertifl",),
                       client_counts=(2, 3), seeds=(0,), rounds=2,
                       epochs=1, schedules=("sync", "stale_k:1"),
                       transforms=("none", "int8"),
                       obs=("none", "basic", "full"), first_layer="slice")
    out = run_padded_cells("titanic", "devertifl", scfg, device="cpu")
    assert out["round_traces"] == 1
    assert out["obs"] == ["none", "basic", "full"]
    cells = out["cells"]
    assert len(cells) == 3 * 2 * 2 * 2
    for key, cell in cells.items():
        level = key.split("/")[0]
        assert cell["obs"] == level
        if level == "none":
            continue
        twin = cells["none/" + key.split("/", 1)[1]]
        assert cell["acc_per_seed"] == twin["acc_per_seed"]
        assert cell["f1_per_seed"] == twin["f1_per_seed"]
        ser = cell["obs_series"]
        # leading seed axis, then rounds (and the padded client axis)
        assert ser["loss"].shape == (1, 2)
        assert ser["exchange_norm"].shape == (1, 2, 3)
        if level == "full":
            assert (ser["grad_norm"] > 0).any()
        else:
            assert (ser["grad_norm"] == 0).all()
    # a multi-seed cell and an obs spec grid carry the series too
    cell = run_cell("titanic", "devertifl", 2, SweepConfig(
        client_counts=(2,), seeds=(0, 1), rounds=2, epochs=1,
        first_layer="slice", obs=("full",)), device="cpu")
    assert cell["obs"] == "full"
    assert cell["obs_series"]["grad_norm"].shape == (2, 2, 2)
    grid = run_grid(spec_grid(datasets=("titanic",), modes=("devertifl",),
                              client_counts=(2,), seeds=(0, 1), rounds=2,
                              epochs=1, first_layer="slice", obs="full"),
                    device="cpu")
    got = grid["cells"]["titanic/devertifl/full/none/none/sync/2"]
    for k in SERIES_KEYS:
        np.testing.assert_array_equal(got["obs_series"][k],
                                      cell["obs_series"][k])
    rr = _cpu(ExperimentSpec(dataset="titanic", n_clients=2, rounds=2,
                             epochs=1, seeds=(0, 1), first_layer="slice",
                             obs="full")).run()
    for k in SERIES_KEYS:
        np.testing.assert_array_equal(rr.telemetry.series[k],
                                      cell["obs_series"][k])


def test_obs_sweep_refuses_custom_plans_and_non_devertifl(ref):
    register_obs("test_tap2", lambda **kw: None, overwrite=True)
    base = dict(datasets=("titanic",), client_counts=(2,), seeds=(0,),
                rounds=1, epochs=1)
    cases = [("devertifl", dict(obs=("none", "test_tap2"))),
             ("verticomb", dict(obs=("basic",))),
             ("devertifl", dict(obs=()))]
    for mode, axes in cases:
        ours = _error(lambda: run_padded_cells(
            "titanic", mode, SweepConfig(**base, **axes), device="cpu"))
        theirs = _error(lambda: ref.sweep.run_padded_cells(
            "titanic", mode, ref.sweep.SweepConfig(**base, **axes)))
        assert ours == theirs and ours is not None, (mode, axes)
    with pytest.raises(ValueError, match="custom obs"):
        run_padded_cells("titanic", "devertifl", SweepConfig(
            **base, obs=("none", "test_tap2")), device="cpu")
    axes = dict(obs=("none", "full"))
    assert _error(lambda: run_cell("titanic", "devertifl", 2, SweepConfig(
        **base, **axes), device="cpu")) == _error(
        lambda: ref.sweep.run_cell("titanic", "devertifl", 2,
                                   ref.sweep.SweepConfig(**base, **axes)))


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------
def test_span_tracer_nesting_export_and_summary(tmp_path):
    tr = SpanTracer()
    assert tr.active
    with tr.span("outer", cat="t"):
        with tr.span("inner", cat="t", round=1):
            tr.instant("tick", x=2)
    recs = tr.to_records()
    by = {r["name"]: r for r in recs}
    assert by["outer"]["depth"] == 0 and by["inner"]["depth"] == 1
    assert by["inner"]["args"]["round"] == 1
    assert by["tick"]["ph"] == "i"
    assert by["outer"]["dur"] >= by["inner"]["dur"] >= 0
    path = tr.export(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i"}
    for e in evs:                       # Perfetto-required fields
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        assert ("dur" in e) == (e["ph"] == "X")
    text = tr.summary()
    assert "outer" in text and "inner" in text


def test_span_tracer_records_as_the_references(ref):
    def drive(tr):
        with tr.span("outer", cat="t", n=3):
            with tr.span("inner", cat="t", round=1, obj=object):
                tr.instant("tick", cat="serve", x=2.5)
        tr.instant("after")
        return [{k: v for k, v in r.items() if k not in ("ts", "dur")}
                for r in tr.to_records()]
    assert drive(SpanTracer()) == drive(ref.obs.SpanTracer())
    assert SpanTracer().summary() == ref.obs.SpanTracer().summary()


def test_null_tracer_is_inert_and_refuses_export(tmp_path):
    tr = NullTracer()
    assert not tr.active
    with tr.span("x"):
        tr.instant("y")
    with tr.profile_to(str(tmp_path / "never")):
        pass
    assert tr.to_records() == []
    assert not (tmp_path / "never").exists()
    with pytest.raises(ValueError, match="obs"):
        tr.export(str(tmp_path / "never.json"))
    assert tr.summary() == NullTracer().summary()


def test_span_tracer_origin_puts_records_on_perf_counter():
    import time
    tr = SpanTracer()
    t0 = time.perf_counter()
    with tr.span("outer"):
        t1 = time.perf_counter()
        with tr.span("inner"):
            pass
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    by = {r["name"]: r for r in tr.records}
    outer, inner = by["outer"], by["inner"]
    start = tr.origin + outer["ts"] / 1e6
    assert t0 <= start <= t1
    assert t2 <= start + outer["dur"] / 1e6 <= t3
    assert t1 <= tr.origin + inner["ts"] / 1e6 <= t2


def test_span_tracer_counters_keep_running_totals(tmp_path):
    tr = SpanTracer()
    tr.count("prefills")
    tr.count("prompt_tokens", 300)
    tr.count("prefills")
    tr.count("prompt_tokens", 12)
    assert tr.counters == {"prefills": 2, "prompt_tokens": 312}
    recs = [r for r in tr.to_records() if r["ph"] == "C"]
    assert [(r["name"], r["args"]["value"]) for r in recs] == [
        ("prefills", 1), ("prompt_tokens", 300), ("prefills", 2),
        ("prompt_tokens", 312)]
    doc = json.load(open(tr.export(str(tmp_path / "c.json"))))
    last = [e for e in doc["traceEvents"] if e["ph"] == "C"][-1]
    assert last["args"] == {"prompt_tokens": 312}


def test_span_tracer_keeps_the_newest_records(monkeypatch):
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "MAX_RECORDS", 8)
    tr = SpanTracer()
    for i in range(13):
        with tr.span("s", i=i):
            pass
    assert tr.dropped == 5
    assert [r["args"]["i"] for r in tr.records] == list(range(5, 13))
    assert SpanTracer().dropped == NullTracer().dropped == 0


def test_device_spans_are_host_spans_on_the_cpu():
    tr = SpanTracer()
    tr.arm("cpu")
    with tr.span("step", cat="serve", device=True, n=1):
        torch.ones(8).sum()
    tr.resolve()
    (rec,) = tr.to_records()
    assert "dev_ts" not in rec and rec["args"] == {"n": 1}
    assert set(rec) == {"name", "cat", "ph", "ts", "dur", "depth", "args"}


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host's clock."""

    def record(self, stream=None):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_spans_resolve_onto_the_host_clock_and_export_a_track(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _HostEvent())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    tr = SpanTracer()
    tr.arm("cuda")
    with tr.span("step", cat="serve", device=True):
        with tr.span("decode.dispatch", cat="serve"):
            pass
    with tr.span("step", cat="serve", device=True):
        pass
    recs = tr.to_records()
    steps = [r for r in recs if r["name"] == "step"]
    assert len(steps) == 2 and len(tr._pool) == 4
    for r in steps:
        # the events bracket the host span, both ends read early by the
        # time the anchor took to record (here µs; 1 ms of slack)
        end, dev_end = r["ts"] + r["dur"], r["dev_ts"] + r["dev_dur"]
        assert r["ts"] - 1e3 <= r["dev_ts"] <= r["ts"]
        assert end - 1e3 <= dev_end <= end
    doc = json.load(open(tr.export(str(tmp_path / "d.json"))))
    evs = doc["traceEvents"]
    tracks = {e["args"]["name"]: e["tid"] for e in evs if e["ph"] == "M"}
    assert tracks == {"host": 1, "device": 2}
    on_device = [e for e in evs if e["ph"] == "X" and e["tid"] == 2]
    assert [e["name"] for e in on_device] == ["step", "step"]
    assert [e["ts"] for e in on_device] == [r["dev_ts"] for r in steps]
    assert {e["name"] for e in evs if e["ph"] == "X" and e["tid"] == 1} \
        == {"step", "decode.dispatch"}


def test_profile_to_writes_a_torch_profiler_trace(tmp_path):
    tr = SpanTracer()
    with tr.profile_to(None):       # the caller asked for nothing
        torch.ones(3).sum()
    assert tr.records == []
    d = tmp_path / "prof"
    with tr.profile_to(str(d), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.load(open(d / "trace.json"))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    (span,) = tr.to_records()
    assert (span["name"], span["cat"]) == ("torch_profile", "profiler")
    assert span["args"]["dir"] == str(d)


def test_session_tracer_spans_cover_the_run(tmp_path):
    sess = _cpu(ExperimentSpec(**TINY, obs="basic"))
    sess.run()
    recs = sess.tracer.to_records()
    names = [r["name"] for r in recs]
    assert names.count("round") == TINY["rounds"]
    assert "build" in names and "eval" in names
    path = sess.tracer.export(str(tmp_path / "t.json"))
    assert json.load(open(path))["traceEvents"]
    # obs="none" sessions carry the no-op tracer
    assert not _cpu(ExperimentSpec(**TINY)).tracer.active


def _span_shape(recs):
    """What two packages' spans must share: everything but the clock."""
    return [(r["name"], r["cat"], r["ph"], r["depth"], r["args"])
            for r in recs]


def test_session_spans_are_the_references(ref, tmp_path):
    kw = dict(TINY, obs="full", first_layer="slice", eval_every=1,
              checkpoint_every=1)
    ours = _cpu(ExperimentSpec(**kw, checkpoint_dir=str(tmp_path / "a")))
    theirs = ref.api.build(ref.api.ExperimentSpec(
        **kw, checkpoint_dir=str(tmp_path / "b")))
    ra, rb = ours.run(), theirs.run()
    assert _span_shape(ra.telemetry.spans) == \
        _span_shape(rb.telemetry.spans)
    assert _span_shape(ours.tracer.to_records()) == \
        _span_shape(theirs.tracer.to_records())
    assert [r["name"] for r in ra.telemetry.spans].count("checkpoint") == 2


# ---------------------------------------------------------------------------
# unified telemetry record
# ---------------------------------------------------------------------------
def test_telemetry_record_and_legacy_timings_alias():
    res = _cpu(ExperimentSpec(**TINY, **STACK, obs="full")).run()
    tel = res.telemetry
    assert tel.schema_version == TELEMETRY_SCHEMA_VERSION
    assert res.schema_version == 5
    assert res.timings == tel.to_timings()
    assert res.timings["fault"] == tel.fault
    assert res.timings["wire"] == tel.wire
    d = res.to_dict()
    json.dumps(d)                        # JSON-safe end to end
    assert d["telemetry"]["series"]["loss"] == \
        list(tel.series["loss"])
    assert [s["name"] for s in d["telemetry"]["spans"]].count("round") == 2
    # custom runners lift legacy dicts into the record
    lifted = Telemetry.from_timings({"wall_s": 2.0, "fault": {"x": 1}})
    assert lifted.wall_s == 2.0 and lifted.fault == {"x": 1}
    assert "obs=" not in metrics_table(res)      # renders, no crash
    assert "steps/sec" in metrics_table(res)
    assert "[series] rounds=2" in metrics_table(res)


# ---------------------------------------------------------------------------
# serving: ServeReport.obs + prometheus exposition
# ---------------------------------------------------------------------------
_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
                   r'(\{[a-zA-Z_]+="[^"]*"(,[a-zA-Z_]+="[^"]*")*\})?'
                   r" -?[0-9.e+Inf-]+$")


@pytest.fixture(scope="module")
def served():
    spec = ExperimentSpec(dataset="titanic", n_clients=3, rounds=1,
                          epochs=1, seeds=(0,), eval_every=0,
                          obs="basic")
    sess = _cpu(spec)
    sess.run()
    lay = sess.federation.layout
    xte = np.asarray(sess.federation.xte)
    reqs = [ServeRequest(uid=f"u{i}", entity_id=f"e{i}",
                         slices=split_features(lay, xte[i]))
            for i in range(6)]
    return sess, sess.serve(reqs, max_slots=3)


def test_serve_report_carries_unified_obs_record(served):
    sess, rep = served
    assert rep.schema_version == 2
    obs = rep.obs
    assert obs["schema_version"] == TELEMETRY_SCHEMA_VERSION
    assert obs["serve"]["submitted"] == rep.counters["submitted"]
    assert obs["serve"]["completed"] == rep.counters["completed"]
    assert obs["serve"]["throughput_rps"] == rep.throughput_rps
    json.dumps(rep.to_dict())
    # request lifecycle shows up on the session tracer
    names = {r["name"] for r in sess.tracer.to_records()}
    assert {"submit", "admit", "complete", "serve_step"} <= names


def _prom_ok(text, rep):
    assert text.endswith("\n")
    for ln in text.splitlines():
        if ln.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) repro_serve_\w+ ", ln)
        else:
            assert _LINE.match(ln), ln
    assert f"repro_serve_submitted_total {rep.counters['submitted']}" \
        in text
    # cumulative latency histogram: monotone, +Inf equals _count
    buckets = re.findall(
        r'repro_serve_latency_seconds_bucket\{le="([^"]+)"\} (\d+)', text)
    assert buckets[-1][0] == "+Inf"
    assert [float(b[0]) for b in buckets[:-1]] == list(LATENCY_BUCKETS_S)
    counts = [int(b[1]) for b in buckets]
    assert counts == sorted(counts)
    total = int(re.search(
        r"repro_serve_latency_seconds_count (\d+)", text).group(1))
    assert counts[-1] == total == rep.counters["completed"]


def test_prometheus_text_is_a_valid_exposition(served):
    _, rep = served
    _prom_ok(prometheus_text(rep), rep)
    # the dict form renders the same text
    assert prometheus_text(rep.to_dict()) == prometheus_text(rep)


def test_prometheus_text_is_the_references(ref, served):
    """Equal reports render byte-equal in both packages: the port's
    report as it is, and as the reference's ServeReport."""
    _, rep = served
    theirs = ref.federated.ServeReport(**{
        k: getattr(rep, k) for k in (
            "spec_hash", "results", "telemetry", "latency_ms",
            "throughput_rps", "cache", "counters", "waiting", "rejected",
            "evicted", "obs")})
    assert prometheus_text(rep) == ref.obs.prometheus_text(theirs)
    assert prometheus_text(rep.to_dict()) == \
        ref.obs.prometheus_text(theirs.to_dict())
    assert prometheus_text({}) == ref.obs.prometheus_text({})
    assert LATENCY_BUCKETS_S == ref.obs.LATENCY_BUCKETS_S


# ---------------------------------------------------------------------------
# checkpoint stream stamp
# ---------------------------------------------------------------------------
def test_obs_checkpoint_stamp_refuses_cross_level_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(dataset="titanic", n_clients=3, epochs=1, seeds=(0,),
              obs="basic")
    full = _cpu(ExperimentSpec(rounds=4, **kw)).run()
    _cpu(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                        **kw)).run()
    res = _cpu(ExperimentSpec(rounds=4, checkpoint_dir=d,
                              checkpoint_every=1, **kw)).resume()
    assert res.resumed_from == 2
    assert res.metrics == full.metrics
    # the 2-round writer's series rows were refit to 4 rounds, and the
    # resumed run wrote the last two: the uninterrupted run's series
    for k in SERIES_KEYS:
        np.testing.assert_array_equal(res.telemetry.series[k],
                                      full.telemetry.series[k])
    with pytest.raises(ValueError, match="or obs level"):
        _cpu(ExperimentSpec(rounds=4, checkpoint_dir=d,
                            checkpoint_every=1,
                            **{**kw, "obs": "full"})).resume()


def test_obs_resume_into_fewer_rounds_drops_unwritten_rows(tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(dataset="titanic", n_clients=3, epochs=1, seeds=(0,),
              obs="full", first_layer="kernel")
    three = _cpu(ExperimentSpec(rounds=3, **kw)).run()
    _cpu(ExperimentSpec(rounds=5, checkpoint_dir=d, checkpoint_every=2,
                        **kw)).run()
    import os
    for step in (4,):
        os.remove(os.path.join(d, f"session_{step:08d}.npz"))
    res = _cpu(ExperimentSpec(rounds=3, checkpoint_dir=d,
                              checkpoint_every=2, **kw)).resume()
    assert res.resumed_from == 2
    for k in SERIES_KEYS:
        np.testing.assert_array_equal(res.telemetry.series[k],
                                      three.telemetry.series[k])


def test_obs_free_checkpoints_refuse_obs_resume(tmp_path):
    """An obs-free checkpoint has no series buffers to restore: the
    stream stamp (sync vs sync|obs=basic) refuses the splice."""
    d = str(tmp_path / "ckpt")
    kw = dict(dataset="titanic", n_clients=3, epochs=1, seeds=(0,))
    _cpu(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                        **kw)).run()
    with pytest.raises(ValueError, match="or obs level"):
        _cpu(ExperimentSpec(rounds=4, checkpoint_dir=d, checkpoint_every=1,
                            obs="basic", **kw)).resume()


def test_obs_checkpoint_keys_are_the_references(ref, tmp_path):
    """A port checkpoint under obs="full" holds the reference's keys,
    shapes and dtypes, and the reference resumes it."""
    kw = dict(dataset="titanic", n_clients=3, epochs=1, seeds=(0,),
              obs="full", first_layer="slice", checkpoint_every=1)
    d = str(tmp_path / "ckpt")
    _cpu(ExperimentSpec(rounds=2, checkpoint_dir=d, **kw)).run()
    theirs_dir = str(tmp_path / "theirs")
    ref.api.build(ref.api.ExperimentSpec(rounds=2, checkpoint_dir=theirs_dir,
                                         **kw)).run()
    ours = np.load(f"{d}/session_00000002.npz")
    theirs = np.load(f"{theirs_dir}/session_00000002.npz")
    assert set(ours.files) == set(theirs.files)
    for k in ours.files:
        assert ours[k].shape == theirs[k].shape, k
        assert ours[k].dtype == theirs[k].dtype, k
    res = ref.api.build(ref.api.ExperimentSpec(
        rounds=3, checkpoint_dir=d, **kw)).resume()
    assert res.resumed_from == 2
    assert np.asarray(res.telemetry.series["loss"]).shape == (3,)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_obs_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert obs_cli(["--device", "cpu", "--dataset", "titanic", "--rounds",
                    "2", "--prom", "--trace-out", str(out), "--schedule",
                    "stale_k:1", "--transform", "int8"]) == 0
    text = capsys.readouterr().out
    assert "per-round series" in text and "staleness" in text
    assert "serving: 4/4 completed" in text
    assert "repro_serve_completed_total 4" in text
    assert "span timeline" in text and "round" in text
    doc = json.load(open(out))
    assert [e["name"] for e in doc["traceEvents"]].count("round") == 2


def test_obs_cli_defaults_to_cuda():
    from repro_torch.obs.__main__ import build_parser
    assert build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            obs_cli(["--dataset", "titanic", "--rounds", "1"])
