"""The port's exchange schedules (``repro_torch.schedule``) against the
JAX package's ``repro.schedule``, and the reference's own invariants
inside the port.

Cross-package: the parser's canonical strings and error texts, spec
hashes of scheduled specs, the participation mask and the scheduled
exchange, and whole federations under ``stale_k:2``, ``partial:0.5`` and
``double_buffer`` in the masked, slice and kernel lanes (the kernel's
plain version here), replayed from the reference's inits, batch indices
and coins (``RefDraws``): per-step losses within ``LOSS_RTOL``,
predictions equal.

Inside the port (``tests/test_schedule.py``'s contracts): ``stale_k:0``
and ``partial:1.0`` are bitwise sync, padded and not; padded is bitwise
unpadded; a single client trains under every schedule; a cold ring is an
exchange-free start; resume is bitwise; every sweep lane is bitwise its
standalone federation; the reference's sweep refusals; one first-layer
call a step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentSpec, build, run_grid, spec_grid
from repro_torch.core import protocol as P
from repro_torch.core.draws import CounterDraws
from repro_torch.core.exchange import (hidden_output_exchange,
                                       scheduled_exchange)
from repro_torch.core.partition import LayoutArrays
from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                    run_cell, run_padded_cells)
from repro_torch.schedule import (LaneScheduleImpl, get_schedule,
                                  participation_mask, register_schedule,
                                  schedule_names)
from test_torch_support import (LOSS_RTOL, RefDraws, assert_engine_replays,
                                engine_traj, port_engine_run, reference,
                                reference_engine_run)

TINY = dict(dataset="titanic", n_clients=3, rounds=2, epochs=2, seed=0)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _error(fn, *args):
    try:
        fn(*args)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e).replace("repro_torch.", "repro.")
    return None


# ---------------------------------------------------------------------------
# the registry, against the reference
# ---------------------------------------------------------------------------
SPECS = ["sync", "stale_k", "stale_k:4", "stale_k:0", "double_buffer",
         "partial:0.8", "partial:0.80:det", "partial:1.0", " stale_k:2 ",
         "partial:0.5+stale_k:3", "stale_k:1+partial:0.25:det",
         # errors
         "bogus", "stale_k:x", "stale_k:-1", "stale_k:1:2", "partial",
         "partial:0", "partial:1.5", "partial:y", "sync:1",
         "double_buffer:2", "sync+stale_k:1", "double_buffer+partial:0.5",
         "stale_k:1+stale_k:2", "stale_k:1+", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_parse_is_the_references(ref, spec):
    from repro_torch.schedule import get_schedule as ours

    def parsed(get):
        err = _error(get, spec)
        if err:
            return err
        s = get(spec)
        return (s.spec, s.k, s.p, s.deterministic, s.double_buffer,
                s.is_sync)
    assert parsed(ours) == parsed(ref.schedule.get_schedule)


def test_schedule_names_and_custom_registration(ref):
    assert schedule_names() == ref.schedule.schedule_names()
    # registered in both, so the registries' option lists stay equal
    for reg in (register_schedule, ref.schedule.register_schedule):
        reg("test_custom_sched", lambda **kw: None, overwrite=True)
    assert schedule_names() == ref.schedule.schedule_names()
    s = get_schedule("test_custom_sched:a:b")
    assert s.spec == "test_custom_sched:a:b" and not s.is_sync
    assert "does not compose" in _error(
        get_schedule, "test_custom_sched+stale_k:1")[1]


@pytest.mark.parametrize("kw", [
    dict(schedule="stale_k"), dict(schedule="partial:0.50"),
    dict(schedule="partial:0.8:det", n_clients=5),
    dict(schedule="double_buffer", mode="devertifl", seeds=(0, 1)),
    dict(schedule="stale_k:0"), dict(schedule="stale_k:4+partial:0.5")])
def test_scheduled_spec_hashes_are_the_references(ref, kw):
    kw = dict(dataset="titanic", first_layer="slice", **kw)
    ours, theirs = ExperimentSpec(**kw), ref.api.ExperimentSpec(**kw)
    assert ours.schedule == theirs.schedule
    assert ours.spec_hash == theirs.spec_hash
    assert ours.resume_hash == theirs.resume_hash
    assert ours.spec_hash != ExperimentSpec(
        **{**kw, "schedule": "sync"}).spec_hash


def test_spec_schedule_validation_is_the_references(ref):
    for kw in (dict(schedule="stale_k:2", mode="verticomb"),
               dict(schedule="partial:0.5", mode="non_federated"),
               dict(schedule="nope")):
        assert _error(lambda: ExperimentSpec(dataset="titanic", **kw)) == \
            _error(lambda: ref.api.ExperimentSpec(dataset="titanic", **kw))


# ---------------------------------------------------------------------------
# the exchange and the participation mask, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,live", [(3, 3), (5, 3), (4, 1)])
def test_scheduled_exchange_is_the_references(ref, n, live):
    rng = np.random.default_rng(n * 7 + live)
    h_all = rng.standard_normal((n, 6, 4)).astype(np.float32)
    h_ref = rng.standard_normal((n, 6, 4)).astype(np.float32)
    mask = (np.arange(n) < live).astype(np.float32)
    mask[0] = 1.0
    mask[-1] = 0.0 if n > 1 else 1.0
    theirs = np.asarray(ref.exchange.scheduled_exchange(h_all, h_ref, mask))
    ours = scheduled_exchange(torch.tensor(h_all), torch.tensor(h_ref),
                              torch.tensor(mask))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # over the detached current stack it is the sync exchange, bit for bit
    h = torch.tensor(h_all)
    np.testing.assert_array_equal(
        scheduled_exchange(h, h, torch.tensor(mask)).numpy(),
        hidden_output_exchange(h, False, torch.tensor(mask)).numpy())


@pytest.mark.parametrize("spec,n,live,r", [
    ("partial:0.5", 5, 5, 0), ("partial:0.5", 7, 4, 3),
    ("partial:0.3:det", 5, 5, 2), ("partial:0.6:det", 6, 3, 7),
    ("partial:0.01", 4, 4, 1), ("partial:1.0", 3, 2, 0)])
def test_participation_mask_is_the_references(ref, spec, n, live, r):
    jax, jnp = ref.jax, ref.jnp
    sched = get_schedule(spec)
    cm = (np.arange(n) < live).astype(np.float32)
    rkey = jax.random.fold_in(jax.random.PRNGKey(11), r)
    rimpl = ref.schedule.LaneScheduleImpl(0, n, 1, 1)
    rstate = rimpl.init_state(ref.schedule.get_schedule(spec))
    rlay = ref.partition.LayoutArrays(
        masks=jnp.zeros((n, 1)), offsets=jnp.zeros(n, jnp.int32),
        sizes=jnp.zeros(n, jnp.int32), client_mask=jnp.asarray(cm))
    theirs = np.asarray(ref.schedule.participation_mask(
        rstate, rlay, rkey, jnp.int32(r)))
    state = LaneScheduleImpl(0, n, 1, 1).init_state(sched)
    lay = LayoutArrays(masks=None, offsets=None, sizes=None,
                       client_mask=torch.tensor(cm))
    ours = participation_mask(state, lay, RefDraws(ref, rkey, n), r)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_ring_holds_the_references_layout():
    """buf[max_k - j] is the stack pushed j steps ago; a lane reads its
    own depth; cold slots are zeros."""
    impl = LaneScheduleImpl(max_k=3, n_clients=1, batch_size=1, width=1)
    st = impl.init_state(get_schedule("stale_k:2"))
    consumed = []
    for t in range(6):
        h_ref, st = impl.select(st, torch.full((1, 1, 1), float(t + 1)))
        consumed.append(float(h_ref[0, 0, 0]))
    assert consumed == [0.0, 0.0, 1.0, 2.0, 3.0, 4.0]
    assert st["buf"].flatten().tolist() == [4.0, 5.0, 6.0]
    st0 = impl.init_state(get_schedule("stale_k:0"))
    h_ref, _ = impl.select(st0, torch.full((1, 1, 1), 7.0))
    assert float(h_ref[0, 0, 0]) == 7.0
    with pytest.raises(ValueError, match="ring of 4"):
        impl.init_state(get_schedule("stale_k:4"))


# ---------------------------------------------------------------------------
# whole federations against the reference
# ---------------------------------------------------------------------------
LANES = [("slice", "slice"), ("masked", "masked"), ("pallas", "kernel")]


@pytest.mark.parametrize("ref_lane,lane", LANES)
@pytest.mark.parametrize("schedule", ["stale_k:2", "partial:0.5",
                                      "double_buffer"])
def test_scheduled_federation_replays_reference(ref, schedule, ref_lane,
                                                lane):
    kw = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1,
              schedule=schedule)
    r = reference_engine_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer=lane,
                                                 **kw)
    worst = assert_engine_replays(r, fed, losses, params, sched)
    assert worst <= LOSS_RTOL
    # the ring is the reference's after the same steps
    if "buf" in r.sched:
        np.testing.assert_allclose(sched["buf"].numpy(), r.sched["buf"],
                                   rtol=1e-5, atol=1e-6)


def test_mnist_partial_stale_replays_reference(ref):
    kw = dict(dataset="mnist", n_samples=600, n_clients=5, rounds=2,
              epochs=1, schedule="stale_k:1+partial:0.6")
    r = reference_engine_run(ref, first_layer="slice", **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer="kernel",
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
@pytest.mark.parametrize("schedule", ["stale_k:0", "partial:1.0",
                                      "partial:1.0:det"])
def test_degenerate_schedules_are_sync_bitwise(schedule, lane):
    kw = dict(TINY, first_layer=lane)
    sync = engine_traj(**kw)
    ours = engine_traj(schedule=schedule, **kw)
    np.testing.assert_array_equal(ours[0], sync[0])
    assert ours[1] == sync[1]
    # and padded: the live clients of a padded run are the unpadded run
    padded = engine_traj(schedule=schedule, max_clients=5, **kw)
    np.testing.assert_array_equal(padded[0], sync[0])


def test_a_real_schedule_changes_the_trajectory():
    sync = engine_traj(**TINY)[0]
    for s in ("stale_k:1", "partial:0.5", "partial:0.5:det",
              "double_buffer"):
        assert not np.array_equal(engine_traj(schedule=s, **TINY)[0], sync)


@pytest.mark.parametrize("lane", ["masked", "kernel"])
@pytest.mark.parametrize("schedule", ["stale_k:2", "partial:0.5",
                                      "partial:0.4:det", "double_buffer",
                                      "stale_k:1+partial:0.5"])
def test_padded_is_unpadded_bitwise(schedule, lane):
    kw = dict(TINY, schedule=schedule, first_layer=lane)
    a = engine_traj(**kw)
    b = engine_traj(max_clients=6, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


@pytest.mark.parametrize("schedule", ["sync", "stale_k:1", "double_buffer",
                                      "partial:0.5", "partial:0.5:det"])
def test_single_client_federation_every_schedule(schedule):
    losses, final, _, _ = engine_traj(dataset="titanic", n_clients=1,
                                      rounds=1, epochs=1, schedule=schedule)
    assert np.isfinite(losses).all() and 0.0 <= final["f1"] <= 1.0


def test_cold_start_buffers_equal_exchange_free_steps():
    """Zeros in the ring: the first k steps train exchange-free, as the
    non_federated trajectory's first k steps; step k diverges once the
    first stale stack arrives.  double_buffer's whole first round is
    exchange-free."""
    k = 3
    stale = engine_traj(schedule=f"stale_k:{k}", **TINY)[0]
    nonfed = engine_traj(mode="non_federated", **TINY)[0]
    np.testing.assert_allclose(stale[:k], nonfed[:k], rtol=1e-6)
    assert abs(stale[k] - nonfed[k]) > 1e-4
    one = dict(TINY, rounds=1)
    np.testing.assert_allclose(
        engine_traj(schedule="double_buffer", **one)[0],
        engine_traj(**dict(one, mode="non_federated"))[0], rtol=1e-6)


def test_train_is_the_engine_loop_and_reruns_bitwise():
    pcfg = P.ProtocolConfig(schedule="stale_k:1+partial:0.5", **TINY)
    out = P.DeVertiFL(pcfg, device="cpu").train()
    again = P.DeVertiFL(pcfg, device="cpu").train()
    losses = np.concatenate([h["round_losses"] for h in out["history"]])
    np.testing.assert_array_equal(
        losses, np.concatenate([h["round_losses"] for h in again["history"]]))
    np.testing.assert_array_equal(losses, engine_traj(
        schedule="stale_k:1+partial:0.5", **TINY)[0])


def test_run_round_needs_the_engine_state():
    fed = P.DeVertiFL(P.ProtocolConfig(schedule="stale_k:1", **TINY),
                      device="cpu")
    params, opt_state = fed.start(fed.init_params(
        P.train_generators(0)[0]))
    with pytest.raises(ValueError, match="sched_state"):
        fed.run_round(params, opt_state, 0,
                      fed.perms(P.round_generator(0, 0)))
    # the sync path threads {} through when asked
    sync = P.DeVertiFL(P.ProtocolConfig(**TINY), device="cpu")
    out = sync.run_round(params, opt_state, 0,
                         sync.perms(P.round_generator(0, 0)), {})
    assert len(out) == 5 and out[3] == {}


def test_draws_depend_on_seed_and_slot_alone():
    """A slot's coins and noise do not change with the slot count or
    padding; a lane batch's lane draws what its seed's federation
    draws."""
    one = CounterDraws(3, 4, "cpu").round(2)
    wide = CounterDraws(3, 9, "cpu").round(2)
    lanes = CounterDraws([5, 3], 18, "cpu", lanes=2).round(2)
    p = torch.full((4,), 0.5)
    c4 = one.coins(0x5EED, 0, p)
    assert torch.equal(wide.coins(0x5EED, 0, torch.full((9,), 0.5))[:4], c4)
    assert torch.equal(lanes.coins(0x5EED, 0, torch.full((18,), 0.5))[9:13],
                       c4)
    z = one.normal(0xC0DE, 7, (5, 3))
    assert torch.equal(wide.normal(0xC0DE, 7, (5, 3))[:4], z)
    assert torch.equal(lanes.normal(0xC0DE, 7, (5, 3))[9:13], z)
    assert not torch.equal(one.normal(0xC0DE, 8, (5, 3)), z)
    assert not torch.equal(CounterDraws(3, 4, "cpu").round(2, 1).normal(
        0xC0DE, 7, (5, 3)), z)
    big = CounterDraws(0, 64, "cpu").round(0).normal(0xC0DE, 0, (64, 64))
    assert abs(float(big.mean())) < 0.01 and abs(float(big.std()) - 1) < 0.01
    assert lanes.lane_key(0xC0DE).shape == (2, 2)
    np.testing.assert_array_equal(lanes.lane_key(0xC0DE)[1],
                                  one.lane_key(0xC0DE))


@pytest.mark.parametrize("schedule", ["stale_k:2", "partial:0.5",
                                      "double_buffer"])
def test_resume_is_bitwise_under_schedules(tmp_path, schedule):
    kw = dict(dataset="titanic", epochs=1, seeds=(0,), schedule=schedule,
              first_layer="kernel")
    full = build(ExperimentSpec(rounds=4, **kw), device="cpu").run()
    d = str(tmp_path)
    build(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                         **kw), device="cpu").run()
    res = build(ExperimentSpec(rounds=4, checkpoint_dir=d,
                               checkpoint_every=1, **kw),
                device="cpu").resume()
    assert res.resumed_from == 2 and res.metrics == full.metrics
    for i, r in enumerate((2, 3)):
        np.testing.assert_array_equal(res.history[i]["round_losses"],
                                      full.history[r]["round_losses"])
    with pytest.raises(ValueError, match="different exchange schedule"):
        build(ExperimentSpec(rounds=4, checkpoint_dir=d, checkpoint_every=1,
                             **{**kw, "schedule": "stale_k:3"}),
              device="cpu").resume()


def test_a_sync_checkpoint_cannot_resume_a_schedule(tmp_path):
    """A checkpoint without the stream stamp (a sync-era writer) is
    refused under a schedule, naming both."""
    import os
    from repro_torch.checkpoint import save_checkpoint
    kw = dict(dataset="titanic", epochs=1, seeds=(0,), first_layer="slice")
    d = str(tmp_path)
    build(ExperimentSpec(rounds=1, checkpoint_dir=d, checkpoint_every=1,
                         **kw), device="cpu").run()
    path = os.path.join(d, "session_00000001.npz")
    with np.load(path) as data:
        tree = {k: data[k] for k in data.files if k != "schedule_hash"}
    save_checkpoint(d, 1, tree, name="session")
    with pytest.raises(ValueError, match="carries no schedule stamp"):
        build(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                             schedule="stale_k:1", **kw),
              device="cpu").resume()


# ---------------------------------------------------------------------------
# the schedule lane axis
# ---------------------------------------------------------------------------
def _standalone(nc, seed, lane, rounds=2, **kw):
    return engine_traj(dataset="titanic", n_clients=nc, seed=seed,
                       rounds=rounds, epochs=1, first_layer=lane, **kw)[0]


def _lane_losses(lb, rounds=2):
    params, opt, step, sched, out = (lb.params, lb.opt_state, 0,
                                     lb.sched_state, [])
    for r in range(rounds):
        params, opt, step, sched, lr = lb.round_fn(
            params, opt, step, lb.round_indices(r), lb.xtr, lb.ytr, lb.lay,
            sched, lb.round_draws(r))
        out.append(lr)
    return torch.cat(out, dim=1).numpy(), sched


@pytest.mark.parametrize("lane", ["masked", "kernel"])
def test_every_schedule_lane_is_its_standalone_run(lane):
    scheds = ("sync", "stale_k:1", "stale_k:2", "partial:0.5")
    lb = build_lane_batch("titanic", "devertifl", SweepConfig(
        client_counts=(2, 3), seeds=(0, 1), rounds=2, epochs=1,
        first_layer=lane, schedules=scheds), device="cpu")
    assert lb.n_lanes == 16 and lb.n_base == 4
    losses, _ = _lane_losses(lb)
    for li, (nc, s) in enumerate(lb.lanes):
        want = _standalone(nc, s, lane, schedule=scheds[li // 4])
        np.testing.assert_array_equal(losses[li], want)


def test_double_buffer_single_schedule_sweep():
    out = run_padded_cells("titanic", "devertifl", SweepConfig(
        client_counts=(2, 3), seeds=(0,), rounds=1, epochs=1,
        first_layer="slice", schedules=("double_buffer",)), device="cpu")
    assert set(out["cells"]) == {"double_buffer/2", "double_buffer/3"}
    assert out["schedules"] == ["double_buffer"]


def test_schedule_sweep_refuses_what_the_reference_refuses(ref):
    base = dict(client_counts=(2,), seeds=(0,), rounds=1, epochs=1)
    register_schedule("test_custom_sched", lambda **kw: None,
                      overwrite=True)
    ref.schedule.register_schedule("test_custom_sched", lambda **kw: None,
                                   overwrite=True)
    cases = [("devertifl", dict(schedules=("sync", "double_buffer"))),
             ("non_federated", dict(schedules=("stale_k:1",))),
             ("devertifl", dict(schedules=("test_custom_sched",))),
             ("devertifl", dict(schedules=())),
             ("devertifl", dict(schedules=("sync", "stale_k:1"),
                                faults=("none",), transforms=("none",)))]
    for mode, axes in cases[:4]:
        ours = _error(lambda: run_padded_cells(
            "titanic", mode, SweepConfig(**base, **axes), device="cpu"))
        theirs = _error(lambda: ref.sweep.run_padded_cells(
            "titanic", mode, ref.sweep.SweepConfig(**base, **axes)))
        assert ours == theirs and ours is not None, (mode, axes)
    ours = _error(lambda: run_cell("titanic", "devertifl", 2, SweepConfig(
        **base, schedules=("sync", "stale_k:1")), device="cpu"))
    assert ours == _error(lambda: ref.sweep.run_cell(
        "titanic", "devertifl", 2, ref.sweep.SweepConfig(
            **base, schedules=("sync", "stale_k:1"))))


def test_schedule_grid_keys_and_multi_seed_session():
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(2, 3), seeds=(0, 1),
                      schedules=("sync", "stale_k:2"), rounds=1, epochs=1,
                      first_layer="kernel")
    grid = run_grid(specs, device="cpu")
    assert set(grid["cells"]) == {
        f"titanic/devertifl/{s}/{n}" for s in ("sync", "stale_k:2")
        for n in (2, 3)}
    for spec in specs:
        cell = grid["cells"][f"titanic/devertifl/{spec.schedule}/"
                             f"{spec.n_clients}"]
        assert cell["spec_hash"] == spec.spec_hash
        assert cell["schedule"] == spec.schedule
    sess = build(ExperimentSpec(dataset="titanic", n_clients=3, seeds=(0, 1),
                                rounds=1, epochs=1, schedule="stale_k:2",
                                first_layer="kernel"), device="cpu").run()
    cell = grid["cells"]["titanic/devertifl/stale_k:2/3"]
    assert sess.metrics["f1_per_seed"] == cell["f1_per_seed"]


@pytest.mark.parametrize("plan", [
    dict(schedule="stale_k:2"), dict(schedule="partial:0.5"),
    dict(schedule="double_buffer"), dict(fault="crash:0.5+corrupt:0.5"),
    dict(fault="straggle:0.5:2"), dict(transform="topk:0.5+int8+dp:0.1"),
    dict(schedule="stale_k:2", fault="crash:0.2+corrupt:0.05",
         transform="topk:0.5+int8+dp:0.1")])
def test_one_first_layer_call_a_step_under_every_plan(monkeypatch, plan):
    calls, real = [], P.vfl_matmul_clients

    def spy(x, w, x_off, w_off, sizes):
        calls.append(tuple(x.shape))
        return real(x, w, x_off, w_off, sizes)
    monkeypatch.setattr(P, "vfl_matmul_clients", spy)
    monkeypatch.setattr("repro_torch.core.sweep.vfl_matmul_clients", spy)
    out = P.DeVertiFL(P.ProtocolConfig(first_layer="kernel", **TINY, **plan),
                      device="cpu").train()
    steps = sum(len(h["round_losses"]) for h in out["history"])
    # every step, each round's evaluation and the final one
    assert len(calls) == steps + TINY["rounds"] + 1
    # a lane batch: one call a step for every lane
    calls.clear()
    axes = {k + "s": (v,) for k, v in plan.items()}
    lb = build_lane_batch("titanic", "devertifl", dataclasses.replace(
        SweepConfig(client_counts=(2, 3), seeds=(0, 1), rounds=1, epochs=1,
                    first_layer="kernel"), **axes), device="cpu")
    lb.round_fn(lb.params, lb.opt_state, 0, lb.round_indices(0)[:, :3],
                lb.xtr, lb.ytr, lb.lay, lb.sched_state, lb.round_draws(0))
    assert len(calls) == 3
