"""The port's fault layer (``repro_torch.faults``: plans, ``FaultImpl``,
the exchange screen, ``RetryPolicy`` and the Session's watchdog) against
the JAX package's ``repro.faults``, and the reference's own invariants
inside the port.

Cross-package: the parser's canonical strings and error texts, spec
hashes, ``screen_exchange`` bit for bit, ``RetryPolicy`` and
``diverged``, and whole federations under ``crash:0.2:2``,
``straggle:0.3:2`` and ``corrupt:0.05`` in the masked, slice and kernel
lanes, replayed from the reference's inits, batches and coins: per-step
losses within ``LOSS_RTOL``, predictions and the four event counters
equal.

Inside the port (``tests/test_faults.py``'s contracts): padded is
bitwise unpadded; the screen keeps every loss finite under corruption
and quarantines exactly the corrupted client-rounds, and a screen that
lets a NaN slice through fails that check; resume is bitwise and a
checkpoint of another plan is refused; the watchdog rolls back and
reseeds past a poisoned round, and raises ``DivergenceError`` once its
retries run out; every fault lane is bitwise its standalone run; the
reference's sweep refusals.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentSpec, build, run_grid, spec_grid
from repro_torch.core.draws import CounterDraws
from repro_torch.core.exchange import screen_exchange
from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                    run_cell, run_padded_cells)
from repro_torch.faults import (GUARD_MAX, RESEED_TAG, DivergenceError,
                                RetryPolicy, diverged, fault_names,
                                get_fault_plan, register_fault)
from repro_torch.faults import engine as FE
from test_torch_support import (LOSS_RTOL, assert_engine_replays,
                                engine_traj, port_engine_run, reference,
                                reference_engine_run)

TINY = dict(dataset="titanic", n_clients=3, rounds=2, epochs=2, seed=0)
# all three built-in families at once
HOT = "crash:0.5:2+straggle:0.5:1+corrupt:0.5"


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        # the port registers test_poison below; the reference's registry
        # gets the name too, so both list the same options
        ns.faults.register_fault("test_poison", lambda **kw: None,
                                 overwrite=True)
        yield ns


def _error(fn, *args):
    try:
        fn(*args)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e).replace("repro_torch.", "repro.")
    return None


# ---------------------------------------------------------------------------
# a custom fault that NaN-poisons the whole exchange for a round when a
# federation-wide coin of the round's draws comes up heads, so the only
# way past it is the watchdog's reseeded retry
# ---------------------------------------------------------------------------
_POISON_TAG = 0x0BAD


class _PoisonImpl:
    def __init__(self, inner, p):
        self.inner, self.p = inner, p

    def init_state(self, sched):
        return {"inner": self.inner.init_state(sched),
                "poison": torch.zeros((), device=self.inner.device)}

    def round_start(self, state, lay, draws, round_idx):
        inner, eff = self.inner.round_start(state["inner"], lay, draws,
                                            round_idx)
        coin = draws.coins(_POISON_TAG, 0, self.p)[0]
        return {"inner": inner, "poison": coin}, eff

    def select(self, state, h_now):
        h_ref, inner = self.inner.select(state["inner"], h_now)
        h_ref = torch.where(state["poison"] > 0,
                            torch.full_like(h_ref, float("nan")), h_ref)
        return h_ref, {**state, "inner": inner}

    def round_end(self, state):
        return {**state, "inner": self.inner.round_end(state["inner"])}


register_fault(
    "test_poison",
    lambda inner, n_clients, batch_size, width, args: _PoisonImpl(
        inner, float(args[0]) if args else 0.5),
    overwrite=True)


def _poison_coins(seed, n=3, p=0.5):
    """Round 0's poison coin on the canonical draw and on the attempt-1
    reseed."""
    draws = CounterDraws(seed, n, "cpu")
    return tuple(bool(draws.round(0, a).coins(_POISON_TAG, 0, p)[0])
                 for a in (0, 1))


# ---------------------------------------------------------------------------
# the registry, RetryPolicy and the screen, against the reference
# ---------------------------------------------------------------------------
SPECS = ["none", "crash:0.2", "crash:0.2:1", "crash:0.20:3",
         "straggle:0.5:2", "corrupt:0.05", "corrupt:0.05:nan",
         "corrupt:0.05:scale", "corrupt:0.5+crash:0.2",
         "crash:0.2:2+straggle:0.3:2+corrupt:0.05", " crash:1.0 ",
         # errors
         "bogus", "crash", "crash:0", "crash:1.5", "crash:x", "crash:0.2:0",
         "crash:0.2:y", "crash:0.2:1:1", "straggle:0.5", "straggle:0.5:0",
         "straggle:0.5:z", "corrupt:0.1:zap", "none:1", "none+crash:0.2",
         "crash:0.2+crash:0.3", "crash:0.2+", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_parse_is_the_references(ref, spec):
    def parsed(get):
        err = _error(get, spec)
        if err:
            return err
        f = get(spec)
        return (f.spec, f.crash_p, f.max_dur, f.straggle_p, f.max_delay,
                f.corrupt_p, f.corrupt_kind, f.is_none)
    assert parsed(get_fault_plan) == parsed(ref.faults.get_fault_plan)


def test_fault_names_are_the_references(ref):
    assert fault_names() == ref.faults.fault_names()
    assert get_fault_plan("test_poison:0.5").spec == "test_poison:0.5"


@pytest.mark.parametrize("fault", ["crash:0.2", "crash:0.2:1", HOT,
                                   "corrupt:0.05:scale"])
def test_fault_spec_hashes_are_the_references(ref, fault):
    kw = dict(dataset="titanic", first_layer="slice", fault=fault,
              schedule="stale_k:1")
    ours, theirs = ExperimentSpec(**kw), ref.api.ExperimentSpec(**kw)
    assert (ours.fault, ours.spec_hash, ours.resume_hash) == \
        (theirs.fault, theirs.spec_hash, theirs.resume_hash)
    for mode in ("verticomb", "non_federated"):
        assert _error(lambda: ExperimentSpec(
            **{**kw, "schedule": "sync", "mode": mode})) == _error(
            lambda: ref.api.ExperimentSpec(
                **{**kw, "schedule": "sync", "mode": mode}))


@pytest.mark.parametrize("seed", range(4))
def test_screen_exchange_is_the_references(ref, seed):
    rng = np.random.default_rng(seed)
    n = 6
    payload = rng.standard_normal((n, 5, 4)).astype(np.float32)
    payload[1, 2, 3] = np.nan
    payload[2] *= np.float32(1e9)
    payload[3, 0, 0] = np.inf
    payload[4, 4, 1] = np.float32(GUARD_MAX)        # at the limit: kept
    last = rng.standard_normal((n, 5, 4)).astype(np.float32)
    order = rng.permutation(n)
    payload, last = payload[order], last[order]
    t_screened, t_bad = ref.exchange.screen_exchange(payload, last,
                                                     GUARD_MAX)
    screened, bad = screen_exchange(torch.tensor(payload), torch.tensor(last),
                                    GUARD_MAX)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(t_bad))
    np.testing.assert_array_equal(screened.numpy(), np.asarray(t_screened))
    assert int(bad.sum()) == 3
    assert (FE.GUARD_MAX, FE.CORRUPT_SCALE, FE.FAULT_TAG, RESEED_TAG) == (
        ref.faults.GUARD_MAX, ref.faults.CORRUPT_SCALE,
        ref.faults.FAULT_TAG, ref.faults.RESEED_TAG)


@pytest.mark.parametrize("kw", [dict(), dict(max_retries=-1),
                                dict(backoff=-1.0), dict(backoff_cap=-2.0),
                                dict(loss_threshold=0.0),
                                dict(backoff=0.5, backoff_cap=3.0)])
def test_retry_policy_is_the_references(ref, kw):
    assert _error(lambda: RetryPolicy(**kw)) == \
        _error(lambda: ref.faults.RetryPolicy(**kw))
    if _error(lambda: RetryPolicy(**kw)) is None:
        ours, theirs = RetryPolicy(**kw), ref.faults.RetryPolicy(**kw)
        assert [ours.sleep_s(a) for a in range(1, 6)] == \
            [theirs.sleep_s(a) for a in range(1, 6)]
    for losses in ([1.0, 2.0], [1.0, np.nan], [np.inf], [2e4, 1.0]):
        assert diverged(losses, 1e4) == ref.faults.diverged(losses, 1e4)


# ---------------------------------------------------------------------------
# whole federations against the reference
# ---------------------------------------------------------------------------
LANES = [("slice", "slice"), ("masked", "masked"), ("pallas", "kernel")]


@pytest.mark.parametrize("ref_lane,lane", LANES)
@pytest.mark.parametrize("fault", ["crash:0.2:2", "straggle:0.3:2",
                                   "corrupt:0.05"])
def test_faulted_federation_replays_reference(ref, fault, ref_lane, lane):
    kw = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1,
              fault=fault)
    r = reference_engine_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer=lane,
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL
    np.testing.assert_array_equal(sched["crash_left"].numpy(),
                                  r.sched["crash_left"])
    np.testing.assert_array_equal(sched["quar"].numpy(), r.sched["quar"])


@pytest.mark.parametrize("fault", [HOT, "corrupt:0.5:scale"])
def test_hot_plans_replay_reference_on_mnist(ref, fault):
    kw = dict(dataset="mnist", n_samples=600, n_clients=4, rounds=2,
              epochs=1, fault=fault, schedule="stale_k:1")
    r = reference_engine_run(ref, first_layer="slice", **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer="kernel",
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL
    assert int(r.fault["corruptions"]) > 0


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "kernel"])
@pytest.mark.parametrize("fault", ["crash:0.5:2", "straggle:0.5:2",
                                   "corrupt:0.5", HOT])
def test_padded_is_unpadded_bitwise_under_faults(fault, lane):
    kw = dict(TINY, fault=fault, first_layer=lane)
    a, fa, fed_a, sa = engine_traj(**kw)
    b, fb, fed_b, sb = engine_traj(max_clients=6, **kw)
    np.testing.assert_array_equal(a, b)
    assert fa == fb
    ta, tb = fed_a.fault_telemetry(sa), fed_b.fault_telemetry(sb)
    assert {k: int(v) for k, v in ta.items()} == \
        {k: int(v) for k, v in tb.items()}


def test_faults_are_deterministic_and_change_the_run():
    sync = engine_traj(**TINY)[0]
    for fault in ("crash:0.5", "straggle:0.5:1", "corrupt:0.5", HOT):
        a = engine_traj(fault=fault, **TINY)[0]
        np.testing.assert_array_equal(a, engine_traj(fault=fault, **TINY)[0])
        assert not np.array_equal(a, sync)


@pytest.mark.parametrize("kind", ["nan", "scale"])
def test_the_screen_quarantines_every_corruption(kind):
    fault = "corrupt:1.0" + (":scale" if kind == "scale" else "")
    losses, final, fed, sched = engine_traj(fault=fault, **TINY)
    assert np.isfinite(losses).all() and np.isfinite(final["f1"])
    tel = {k: int(v) for k, v in fed.fault_telemetry(sched).items()}
    rounds, n = TINY["rounds"], TINY["n_clients"]
    assert tel["corruptions"] == tel["quarantined"] == rounds * n


def test_a_screen_that_lets_nan_through_fails(monkeypatch):
    """The planted fault: a screen that passes a NaN slice into the sum
    poisons the losses, which the finite check catches."""
    def leaky(payload, last_good, max_abs):
        return payload, torch.zeros(payload.shape[0], dtype=torch.bool)
    monkeypatch.setattr(FE, "screen_exchange", leaky)
    losses = engine_traj(fault="corrupt:1.0", **TINY)[0]
    assert not np.isfinite(losses).all()


@pytest.mark.parametrize("schedule,fault", [
    ("stale_k:1", HOT), ("sync", "crash:0.5+corrupt:0.5"),
    ("partial:0.5", "straggle:0.5:2")])
def test_resume_is_bitwise_under_faults(tmp_path, schedule, fault):
    d = str(tmp_path)
    kw = dict(dataset="titanic", epochs=1, seeds=(0,), schedule=schedule,
              fault=fault, first_layer="kernel")
    full = build(ExperimentSpec(rounds=4, **kw), device="cpu").run()
    build(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                         **kw), device="cpu").run()
    res = build(ExperimentSpec(rounds=4, checkpoint_dir=d,
                               checkpoint_every=1, **kw),
                device="cpu").resume()
    assert res.resumed_from == 2 and res.metrics == full.metrics
    assert res.timings["fault"] == full.timings["fault"]
    for i, r in enumerate((2, 3)):
        np.testing.assert_array_equal(res.history[i]["round_losses"],
                                      full.history[r]["round_losses"])
    for other in ("crash:0.9", "none"):
        with pytest.raises(ValueError, match="different exchange schedule, "
                           "fault plan or wire"):
            build(ExperimentSpec(rounds=4, checkpoint_dir=d,
                                 checkpoint_every=1,
                                 **{**kw, "fault": other}),
                  device="cpu").resume()


def test_resume_skips_a_truncated_checkpoint_under_faults(tmp_path):
    d = str(tmp_path)
    kw = dict(dataset="titanic", epochs=1, seeds=(0,),
              fault="crash:0.5+corrupt:0.5", first_layer="slice")
    full = build(ExperimentSpec(rounds=4, **kw), device="cpu").run()
    build(ExperimentSpec(rounds=3, checkpoint_dir=d, checkpoint_every=1,
                         **kw), device="cpu").run()
    with open(os.path.join(d, "session_00000003.npz"), "r+b") as f:
        f.truncate(40)
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        res = build(ExperimentSpec(rounds=4, checkpoint_dir=d,
                                   checkpoint_every=1, **kw),
                    device="cpu").resume()
    assert res.resumed_from == 2 and res.metrics == full.metrics


def test_session_fault_telemetry_and_auto_policy():
    spec = ExperimentSpec(dataset="titanic", rounds=2, epochs=1,
                          fault="crash:0.5+corrupt:0.5", first_layer="slice")
    rr = build(spec, device="cpu").run()
    fault = rr.timings["fault"]
    assert set(fault) == {"crashes", "straggles", "corruptions",
                          "quarantined", "watchdog_trips", "retries"}
    assert fault["watchdog_trips"] == fault["retries"] == 0
    assert rr.telemetry.fault == fault
    # the Session is DeVertiFL.train() when nothing trips
    losses, final, _, _ = engine_traj(dataset="titanic", n_clients=3,
                                      rounds=2, epochs=1, first_layer="slice",
                                      fault="crash:0.5+corrupt:0.5")
    np.testing.assert_array_equal(
        np.concatenate([h["round_losses"] for h in rr.history]), losses)
    assert rr.metrics == final
    none = build(spec.replace(fault="none"), device="cpu").run()
    assert "fault" not in none.timings
    armed = build(spec.replace(fault="none"), device="cpu").run(
        retry=RetryPolicy())
    assert armed.timings["fault"] == {"watchdog_trips": 0, "retries": 0}


def test_watchdog_rolls_back_and_reseeds_past_a_poisoned_round():
    seed = next(s for s in range(64) if _poison_coins(s) == (True, False))
    spec = ExperimentSpec(dataset="titanic", n_clients=3, rounds=1,
                          epochs=1, seeds=(seed,), first_layer="kernel",
                          fault="test_poison:0.5")
    res = build(spec, device="cpu").run(retry=RetryPolicy(max_retries=2))
    assert res.timings["fault"] == {"watchdog_trips": 1, "retries": 1}
    losses = np.concatenate([h["round_losses"] for h in res.history])
    assert np.isfinite(losses).all() and np.isfinite(res.metrics["f1"])
    again = build(spec, device="cpu").run(retry=RetryPolicy(max_retries=2))
    np.testing.assert_array_equal(
        np.concatenate([h["round_losses"] for h in again.history]), losses)
    # without the watchdog the poisoned round stays poisoned
    bare = build(spec, device="cpu").run(retry=None)
    assert not np.isfinite(bare.history[0]["round_losses"]).all()


def test_divergence_error_when_retries_run_out():
    spec = ExperimentSpec(dataset="titanic", n_clients=3, rounds=1,
                          epochs=1, seeds=(0,), first_layer="slice",
                          fault="test_poison:1.0")
    with pytest.raises(DivergenceError, match="reseeded"):
        build(spec, device="cpu").run(retry=RetryPolicy(max_retries=1))
    with pytest.raises(TypeError, match="RetryPolicy"):
        build(spec, device="cpu").run(retry=42)
    with pytest.raises(ValueError, match="single-seed"):
        build(spec.replace(seeds=(0, 1)), device="cpu").run(
            retry=RetryPolicy())


# ---------------------------------------------------------------------------
# the fault lane axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "kernel"])
def test_every_fault_lane_is_its_standalone_run(lane):
    faults = ("none", "crash:0.5:2", "straggle:0.5:1", "corrupt:0.5:scale")
    lb = build_lane_batch("titanic", "devertifl", SweepConfig(
        client_counts=(2, 3), seeds=(0, 1), rounds=2, epochs=1,
        first_layer=lane, faults=faults, schedules=("sync", "stale_k:1")),
        device="cpu")
    assert lb.n_lanes == 32
    params, opt, step, sched, out = (lb.params, lb.opt_state, 0,
                                     lb.sched_state, [])
    for r in range(2):
        params, opt, step, sched, lr = lb.round_fn(
            params, opt, step, lb.round_indices(r), lb.xtr, lb.ytr, lb.lay,
            sched, lb.round_draws(r))
        out.append(lr)
    losses = torch.cat(out, dim=1).numpy()
    tel = lb.impl.telemetry(sched)
    for li, (nc, s) in enumerate(lb.lanes):
        fault, sc = faults[li // 8], ("sync", "stale_k:1")[li // 4 % 2]
        want, _, fed, st = engine_traj(
            dataset="titanic", n_clients=nc, seed=s, rounds=2, epochs=1,
            first_layer=lane, schedule=sc, fault=fault)
        np.testing.assert_array_equal(losses[li], want)
        if fault != "none":
            assert {k: int(v[li]) for k, v in tel.items()} == \
                {k: int(v) for k, v in fed.fault_telemetry(st).items()}


def test_fault_sweep_refuses_what_the_reference_refuses(ref):
    base = dict(client_counts=(2,), seeds=(0,), rounds=1, epochs=1)
    cases = [("non_federated", dict(faults=("crash:0.2",))),
             ("devertifl", dict(faults=("test_poison:0.5",))),
             ("devertifl", dict(faults=()))]
    for mode, axes in cases:
        ours = _error(lambda: run_padded_cells(
            "titanic", mode, SweepConfig(**base, **axes), device="cpu"))
        theirs = _error(lambda: ref.sweep.run_padded_cells(
            "titanic", mode, ref.sweep.SweepConfig(**base, **axes)))
        assert ours == theirs and ours is not None, (mode, axes)
    axes = dict(faults=("none", "crash:0.2"))
    assert _error(lambda: run_cell("titanic", "devertifl", 2, SweepConfig(
        **base, **axes), device="cpu")) == _error(
        lambda: ref.sweep.run_cell("titanic", "devertifl", 2,
                                   ref.sweep.SweepConfig(**base, **axes)))


def test_fault_grid_keys_and_cell_telemetry():
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(2,), seeds=(0, 1),
                      faults=("none", "crash:0.5"), rounds=1, epochs=1,
                      first_layer="slice")
    assert [s.fault for s in specs] == ["none", "crash:0.5"]
    grid = run_grid(specs, device="cpu")
    assert set(grid["cells"]) == {"titanic/devertifl/none/sync/2",
                                  "titanic/devertifl/crash:0.5/sync/2"}
    hot = grid["cells"]["titanic/devertifl/crash:0.5/sync/2"]
    assert hot["fault"] == "crash:0.5" and hot["spec_hash"]
    assert set(hot["fault_telemetry"]) == {"crashes", "straggles",
                                           "corruptions", "quarantined"}
    cell = run_cell("titanic", "devertifl", 2, SweepConfig(
        client_counts=(2,), seeds=(0, 1), rounds=1, epochs=1,
        first_layer="slice", faults=("crash:0.5",)), device="cpu")
    assert cell["fault_telemetry"] == hot["fault_telemetry"]
    assert cell["f1_per_seed"] == hot["f1_per_seed"]
