"""The port's sweep engine (``repro_torch.core.sweep``) and the grid half
of its front door against the JAX package's ``repro.core.sweep`` and
``repro.api``: stacked draws and lane structure equal, lane batches
replaying the reference's inits and batches, grid keys, hashes and
validation errors equal; and inside the port the reference's own
invariants -- a lane is its standalone federation, a multi-seed Session
is ``run_cell`` -- plus one first-layer launch a step whatever the lane
count, and the axes still to be ported."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.api import (ExperimentSpec, build, first_layer_names,
                             register_first_layer, run_grid, spec_grid,
                             sweep_config_for_specs)
from repro_torch.api import session as S
from repro_torch.core import sweep as SW
from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                       make_first_layer_fn,
                                       round_generator, train_generators)
from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                    kernel_first_layer, lane_arrays,
                                    run_cell, run_padded_cells)
from repro_torch.data import registry as DR
from repro_torch.data import synthetic as SD
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import LOSS_RTOL, reference, to_np


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _lanes(dataset="titanic", mode="devertifl", **kw):
    kw = {"client_counts": (2, 3), "seeds": (0, 1), "rounds": 2,
          "epochs": 1, **kw}
    return build_lane_batch(dataset, mode, SweepConfig(**kw), device="cpu")


def _train(lb, rounds=None):
    """Train ``lb`` from its initial state; per-round losses [L, S]."""
    params, opt_state, step, losses = lb.params, lb.opt_state, 0, []
    for r in range(rounds or lb.pcfg.rounds):
        params, opt_state, step, lr = lb.round_fn(
            params, opt_state, step, lb.round_indices(r), lb.xtr, lb.ytr,
            lb.lay)
        losses.append(lr)
    return params, torch.cat(losses, dim=1)


# ---------------------------------------------------------------------------
# stacked draws and the lane structure, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,n", [("mnist", 200), ("fmnist", 150),
                                    ("titanic", None), ("bank", 500)])
def test_make_dataset_stack_is_exact(ref, name, n):
    seeds = (0, 3, 1)
    ours = DR.make_dataset_stack(name, seeds, n=n)
    direct = SD.make_dataset_stack(name, seeds, n=n)
    theirs = ref.data.make_dataset_stack(name, seeds, n=n)
    for a, b, c in zip(ours, direct, theirs, strict=True):
        assert a.dtype == c.dtype and a.shape == c.shape
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    # seed s's slice is make_dataset(name, n, seed=s)
    for i, s in enumerate(seeds):
        for a, b in zip(ours, DR.make_dataset(name, n, seed=s)):
            np.testing.assert_array_equal(a[i], b)


def _reference_lanes(ref, dataset, mode, rounds=2, **kw):
    """The reference's lane batch trained by its vmapped round: what
    the port replays (the initial weights and every lane's batch-index
    matrices) and what it is held to (per-lane losses, predictions and
    F1)."""
    jax, sw = ref.jax, ref.sweep
    kw = {"client_counts": (2, 3, 4), "seeds": (0, 1), "rounds": rounds,
          "epochs": 1, **kw}
    lb = sw.build_lane_batch(dataset, mode, sw.SweepConfig(**kw))
    init = to_np(lb.params)
    plan = ref.protocol.make_perm_fn(lb.pcfg, lb.n_train)
    vround = jax.jit(jax.vmap(lb.round_fn))
    vpred = jax.jit(jax.vmap(ref.protocol.make_predict_fn(
        lb.model, lb.pcfg, first_layer_fn=lb.first)))
    fold = jax.vmap(jax.random.fold_in, in_axes=(0, None))
    params, opt_state, sched = lb.params, lb.opt_state, lb.sched_state
    step = jax.numpy.zeros((lb.n_lanes,), jax.numpy.int32)
    idx, losses = [], []
    for r in range(rounds):
        keys = fold(lb.loop_keys, r)
        idx.append(np.stack([np.asarray(plan.perms(k)) for k in keys]))
        params, opt_state, step, sched, lr = vround(
            params, opt_state, step, sched, keys, lb.xtr, lb.ytr, lb.lay)
        losses.append(np.asarray(lr))
    preds = np.asarray(vpred(params, lb.xte, lb.lay))
    f1s, _ = sw._lane_metrics(preds, np.asarray(lb.yte),
                              np.asarray(lb.ytr), lb.lanes)
    return types.SimpleNamespace(lb=lb, init=init, idx=idx, losses=losses,
                                 preds=preds, f1s=f1s, kw=kw)


@pytest.mark.parametrize("dataset", ["titanic", "bank"])
def test_lane_structure_equals_the_references(ref, dataset):
    kw = dict(client_counts=(2, 3, 5), seeds=(1, 0), rounds=1, epochs=1,
              first_layer="slice")
    theirs = ref.sweep.build_lane_batch(dataset, "devertifl",
                                        ref.sweep.SweepConfig(**kw))
    ours = build_lane_batch(dataset, "devertifl", SweepConfig(**kw),
                            device="cpu")
    assert ours.lanes == tuple(tuple(int(v) for v in ln)
                               for ln in theirs.lanes)
    assert (ours.n_lanes, ours.n_train, ours.width) == \
        (theirs.n_lanes, theirs.n_train, theirs.width)
    for field in ("masks", "offsets", "sizes", "client_mask"):
        a = getattr(ours.lay, field).numpy()
        b = np.asarray(getattr(theirs.lay, field))
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(a, b)
    for ours_t, theirs_t in ((ours.xtr, theirs.xtr), (ours.xte, theirs.xte),
                             (ours.ytr, theirs.ytr), (ours.yte, theirs.yte)):
        np.testing.assert_array_equal(ours_t.numpy(), np.asarray(theirs_t))
    # the parameter tree: the reference's [L, max_c, ...] lanes on the
    # model's client axis
    for a, b in zip(tree_leaves(ours.params),
                    tree_leaves(to_np(theirs.params)), strict=True):
        assert tuple(a.shape) == (b.shape[0] * b.shape[1],) + b.shape[2:]


# reference lane, port lane: the port's kernel lane (its plain version
# on the CPU) is held to the reference's gather-slice, the lane the
# reference's sweep runs for "pallas"
REPLAY_CASES = [
    ("titanic", "devertifl", "masked", "masked"),
    ("titanic", "devertifl", "slice", "slice"),
    ("titanic", "devertifl", "slice", "kernel"),
    ("titanic", "non_federated", "masked", "masked"),
    ("titanic", "verticomb", "slice", "kernel"),
    ("bank", "devertifl", "slice", "kernel"),
]


@pytest.mark.parametrize("dataset,mode,ref_lane,lane", REPLAY_CASES)
def test_lane_batch_replays_the_references(ref, dataset, mode, ref_lane,
                                           lane):
    extra = {"n_samples": 600} if dataset == "bank" else {}
    theirs = _reference_lanes(ref, dataset, mode, first_layer=ref_lane,
                              **extra)
    kw = dict(theirs.kw, first_layer=lane)
    lb = build_lane_batch(dataset, mode, SweepConfig(**kw), device="cpu")
    assert lb.first_layer == lane
    params = params_from_numpy(tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), theirs.init), "cpu")
    opt_state, step = lb.opt.init(params), 0
    for idx, their_losses in zip(theirs.idx, theirs.losses, strict=True):
        params, opt_state, step, losses = lb.round_fn(
            params, opt_state, step, torch.as_tensor(idx).long(), lb.xtr,
            lb.ytr, lb.lay)
        np.testing.assert_allclose(losses.numpy(), their_losses,
                                   rtol=LOSS_RTOL, atol=0)
    preds = lb.predict_fn(params, lb.xte, lb.lay).numpy()
    f1s, _ = SW._lane_metrics(preds, lb.yte.numpy(), lb.ytr.numpy(),
                              lb.lanes)
    for li, (nc, _) in enumerate(lb.lanes):
        agree = float((preds[li, :nc] == theirs.preds[li, :nc]).mean())
        assert agree >= 0.995, (li, agree)
        assert abs(f1s[li] - theirs.f1s[li]) <= 0.002, (li, f1s, theirs.f1s)


def test_run_padded_cells_schema_equals_the_references(ref):
    kw = dict(client_counts=(2, 3), seeds=(0,), rounds=1, epochs=1)
    theirs = ref.sweep.run_padded_cells("titanic", "devertifl",
                                        ref.sweep.SweepConfig(**kw))
    ours = run_padded_cells("titanic", "devertifl", SweepConfig(**kw),
                            device="cpu")
    assert set(ours) == set(theirs)
    assert set(ours["cells"]) == set(theirs["cells"]) == {2, 3}
    for nc in (2, 3):
        assert set(ours["cells"][nc]) == set(theirs["cells"][nc])
    assert (ours["round_traces"], ours["lanes"], ours["devices"],
            ours["schedules"]) == (1, 2, 1, ["sync"])


@pytest.mark.parametrize("n_lanes,shard", [(4, "auto"), (4, False), (3, 1),
                                           (4, 2), (3, 2), (6, 4)])
def test_lane_shards_are_the_references_on_one_device(ref, n_lanes, shard):
    def outcome(fn):
        try:
            return fn(n_lanes, shard)
        except ValueError as e:
            return str(e)
    assert outcome(SW._lane_shards) == outcome(ref.sweep._lane_shards)


# ---------------------------------------------------------------------------
# inside the port: a lane is its standalone federation
# ---------------------------------------------------------------------------
def test_lane_inits_and_batches_are_the_standalone_draws():
    lb = _lanes(client_counts=(2, 4), seeds=(0, 3))
    c = lb.lay.client_mask.shape[1]
    for li, (nc, s) in enumerate(lb.lanes):
        fed = DeVertiFL(ProtocolConfig(dataset="titanic", n_clients=nc,
                                       seed=s, rounds=2, epochs=1),
                        device="cpu")
        init = fed.init_params(train_generators(s)[0])
        for a, b in zip(tree_leaves(lb.params), tree_leaves(init)):
            assert torch.equal(a[li * c:li * c + nc], b)
        for r in range(2):
            assert torch.equal(lb.round_indices(r)[li],
                               fed.perms(round_generator(s, r)))


@pytest.mark.parametrize("mode", ["devertifl", "non_federated",
                                  "verticomb"])
@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
def test_lanes_are_the_standalone_runs(lane, mode):
    """Every lane's per-step losses and final F1 are its standalone
    ``DeVertiFL(n_clients=nc, seed=s).train()``'s, bit for bit on the
    CPU in all three lanes: the masked lane by construction (dead slots
    add exact +0.0 terms), the kernel lane's plain version computes
    each client's slice with the standalone run's own product, and the
    gather-slice's extra columns are exact +0.0 terms at the end of
    each sum.  On the card the kernel lane is held within LANE_RTOL
    (chip_smoke.py)."""
    lb = _lanes(mode=mode, first_layer=lane, client_counts=(2, 3, 4))
    params, losses = _train(lb)
    preds = lb.predict_fn(params, lb.xte, lb.lay).numpy()
    f1s, _ = SW._lane_metrics(preds, lb.yte.numpy(), lb.ytr.numpy(),
                              lb.lanes)
    for li, (nc, s) in enumerate(lb.lanes):
        out = DeVertiFL(ProtocolConfig(
            dataset="titanic", n_clients=nc, seed=s, rounds=2, epochs=1,
            mode=mode, first_layer=lane), device="cpu").train()
        solo = np.concatenate([h["round_losses"] for h in out["history"]])
        np.testing.assert_allclose(losses[li].numpy(), solo,
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_array_equal(losses[li].numpy(), solo)
        assert f1s[li] == out["final"]["f1"], (lane, mode, nc, s)


def test_masked_padded_sweep_is_the_standalone_runs_bitwise():
    """The reference's pin (tests/test_padded_engine.py): every masked
    lane of a three-count padded sweep is its standalone unpadded
    ``train(eval_every_round=False)``, bit for bit."""
    seeds, counts = (0, 1), (2, 3, 4)
    out = run_padded_cells("titanic", "devertifl", SweepConfig(
        client_counts=counts, seeds=seeds, rounds=2, epochs=2,
        first_layer="masked"), device="cpu")
    assert out["round_traces"] == 1 and out["lanes"] == 6
    for nc in counts:
        cell, last = out["cells"][nc], []
        for i, s in enumerate(seeds):
            fed = DeVertiFL(ProtocolConfig(
                dataset="titanic", n_clients=nc, rounds=2, epochs=2,
                seed=s, first_layer="masked"), device="cpu")
            solo = fed.train(eval_every_round=False)
            assert cell["f1_per_seed"][i] == solo["final"]["f1"], (nc, s)
            last.append(fed.train()["history"][-1]["round_losses"][-1])
        assert cell["final_loss_mean"] == float(np.mean(
            np.asarray(last, np.float32)))


@pytest.mark.parametrize("mode", ["non_federated", "devertifl",
                                  "verticomb"])
def test_run_cell_lanes_are_the_standalone_runs(mode):
    """Seed lane s of a cell is ``DeVertiFL(seed=s)``: the reference
    pins the F1 bitwise in non_federated (tests/test_engine.py); here
    it is bitwise in every mode."""
    seeds = (0, 1)
    cell = run_cell("titanic", mode, 3, SweepConfig(seeds=seeds, rounds=3,
                                                    epochs=2),
                    device="cpu")
    assert cell["n_clients"] == 3 and cell["seeds"] == list(seeds)
    for i, s in enumerate(seeds):
        solo = DeVertiFL(ProtocolConfig(
            dataset="titanic", n_clients=3, rounds=3, epochs=2, mode=mode,
            seed=s), device="cpu").train(eval_every_round=False)
        assert cell["f1_per_seed"][i] == solo["final"]["f1"], (mode, s)


def test_run_cell_refuses_seeds_with_other_offsets():
    # a registered partition whose first client's size is 1 + seed
    DR.register_dataset("titanic_ragged", make=DR.get_dataset("titanic").make,
                        n_classes=2, arch="paper-mlp-titanic",
                        partition=lambda nf, nc, seed: np.split(
                            np.arange(nf), [1 + seed]),
                        overwrite=True)
    with pytest.raises(ValueError, match="disagree on offsets/sizes"):
        run_cell("titanic_ragged", "devertifl", 2,
                 SweepConfig(seeds=(0, 1), rounds=1, epochs=1),
                 device="cpu")


def test_run_grid_schema_and_keys():
    grid = SW.run_grid(SweepConfig(
        datasets=("titanic",), modes=("devertifl", "non_federated"),
        client_counts=(2, 3), seeds=(0,), rounds=1, epochs=1),
        device="cpu")
    assert set(grid["cells"]) == {"titanic/devertifl/2",
                                  "titanic/devertifl/3",
                                  "titanic/non_federated/2",
                                  "titanic/non_federated/3"}
    cell = grid["cells"]["titanic/devertifl/2"]
    assert {"f1_mean", "f1_std", "acc_mean", "steps_per_sec",
            "final_loss_mean", "wall_s"} <= set(cell)
    assert set(grid["compare"]["titanic/2"]) == {"devertifl",
                                                 "non_federated"}
    assert grid["compare"]["titanic/3"]["devertifl"] == \
        grid["cells"]["titanic/devertifl/3"]["f1_mean"]


def test_multi_seed_session_is_run_cell():
    spec = ExperimentSpec(dataset="titanic", n_clients=3, seeds=(0, 1),
                          rounds=2, epochs=1)
    sess = build(spec, device="cpu")
    rr = sess.run()
    cell = run_cell("titanic", "devertifl", 3, SweepConfig(
        seeds=(0, 1), rounds=2, epochs=1, first_layer=spec.first_layer),
        device="cpu")
    assert rr.metrics == {
        "f1": cell["f1_mean"], "acc": cell["acc_mean"],
        "f1_std": cell["f1_std"], "f1_per_seed": cell["f1_per_seed"],
        "acc_per_seed": cell["acc_per_seed"],
        "final_loss_mean": cell["final_loss_mean"], "seeds": [0, 1]}
    assert rr.params is None and rr.history == []
    assert rr.telemetry.wall_s > 0 and rr.telemetry.steps_per_sec > 0
    assert rr.spec_hash == spec.spec_hash
    with pytest.raises(ValueError, match="multi-seed cells"):
        sess.predict(np.zeros((2, 9), np.float32))


# ---------------------------------------------------------------------------
# the first layer under lanes
# ---------------------------------------------------------------------------
def test_a_step_launches_vfl_matmul_once_whatever_the_lanes(monkeypatch):
    calls = []

    def spy(x, w, x_off, w_off, sizes):
        calls.append((tuple(x.shape), w.shape[0]))
        return vfl_matmul_clients(x, w, x_off, w_off, sizes)
    monkeypatch.setattr(SW, "vfl_matmul_clients", spy)
    for counts, seeds in (((3,), (0,)), ((2, 3, 4), (0, 1, 2))):
        lb = _lanes(client_counts=counts, seeds=seeds, first_layer="kernel")
        n_lanes, steps = len(counts) * len(seeds), 5
        calls.clear()
        lb.round_fn(lb.params, lb.opt_state, 0,
                    lb.round_indices(0)[:, :steps], lb.xtr, lb.ytr, lb.lay)
        assert calls == [((lb.batch_size, n_lanes * 9),
                          n_lanes * max(counts))] * steps
        calls.clear()
        lb.predict_fn(lb.params, lb.xte, lb.lay)
        assert calls == [((lb.xte.shape[1], n_lanes * 9),
                          n_lanes * max(counts))]


def test_stacked_first_layer_is_each_lane_alone_bitwise():
    """Lane l's slice of one stacked first-layer call is the call of
    lane l alone on the same inputs; a planted fault -- x_offsets
    without the lane's l*F -- makes every lane read lane 0's columns
    and must fail."""
    lb = _lanes("bank", client_counts=(2, 3, 5), seeds=(0, 1, 2),
                first_layer="kernel", n_samples=600)
    flat = lane_arrays(lb.lay)
    lanes = torch.arange(lb.n_lanes)[None, :]
    xb = lb.xtr[lanes, lb.round_indices(0)[:, 0].t()]       # [B, L, F]
    y = kernel_first_layer(lb.params, xb, flat)
    planted = kernel_first_layer(lb.params, xb, flat._replace(
        x_offsets=flat.offsets))
    c = lb.lay.client_mask.shape[1]
    for li in range(lb.n_lanes):
        one = slice(li * c, (li + 1) * c)
        w = {"layer_0": {k: v[one] for k, v in
                         lb.params["layer_0"].items()}}
        alone = kernel_first_layer(w, xb[:, li:li + 1], lane_arrays(
            type(lb.lay)(*(t[li:li + 1] for t in lb.lay))))
        assert torch.equal(y[one], alone), li
        assert torch.equal(planted[one], alone) == (li == 0), li


def test_auto_and_exchange_at_zero_resolve_as_the_protocol_does():
    assert _lanes(first_layer="auto").first_layer == "slice"
    assert _lanes(first_layer="kernel", exchange_at=0).first_layer == \
        "masked"


def test_custom_first_layer_is_refused():
    if "sweep_custom" not in first_layer_names():
        register_first_layer("sweep_custom", lambda model, pcfg, layout:
                             make_first_layer_fn(model, pcfg.replace(
                                 first_layer="slice"), layout, "cpu"))
    with pytest.raises(ValueError, match="custom first_layer 'sweep_custom' "
                                         "is not supported in padded"):
        _lanes(first_layer="sweep_custom")


def test_lane_batch_needs_cuda_unless_told_otherwise():
    scfg = SweepConfig(client_counts=(2,), seeds=(0,))
    if torch.cuda.is_available():
        assert build_lane_batch("titanic", "devertifl",
                                scfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_lane_batch("titanic", "devertifl", scfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_grid(spec_grid(datasets=("titanic",), modes=("devertifl",),
                           client_counts=(2,), seeds=(0,)))


# ---------------------------------------------------------------------------
# the grid front door, against the reference
# ---------------------------------------------------------------------------
def _grid_kw():
    return dict(datasets=("titanic",), modes=("devertifl", "verticomb"),
                client_counts=(2, 3), seeds=(0, 1), rounds=1, epochs=1)


def test_grid_keys_and_hashes_equal_the_references(ref):
    ours_specs = spec_grid(**_grid_kw())
    their_specs = ref.api.spec_grid(**_grid_kw())
    assert [s.spec_hash for s in ours_specs] == \
        [s.spec_hash for s in their_specs]
    ours = run_grid(ours_specs, device="cpu")
    theirs = ref.api.run_grid(their_specs)
    assert set(ours) == set(theirs)
    assert list(ours["cells"]) == list(theirs["cells"])
    assert set(ours["compare"]) == set(theirs["compare"])
    for k, cell in ours["cells"].items():
        assert set(cell) == set(theirs["cells"][k]), k
        assert cell["spec_hash"] == theirs["cells"][k]["spec_hash"], k
    for k, modes in ours["compare"].items():
        assert set(modes) == set(theirs["compare"][k])
    # the SweepConfig route goes to the same place
    scfg = SweepConfig(**_grid_kw(), first_layer="slice")
    assert SW.run_grid(scfg, device="cpu")["compare"] == ours["compare"]


def test_sweep_config_for_specs_gives_the_references_fields(ref):
    kw = dict(dataset="bank", mode="backward_exchange", seeds=(2, 0),
              rounds=3, epochs=2, lr=3e-3, exchange_at=1, n_samples=500)
    ours = sweep_config_for_specs([ExperimentSpec(n_clients=n, **kw)
                                   for n in (4, 2)])
    theirs = ref.api.sweep_config_for_specs(
        [ref.api.ExperimentSpec(n_clients=n, **kw) for n in (4, 2)])
    assert ours[:2] == theirs[:2] == ("bank", "verticomb")
    assert dataclasses.asdict(ours[2]) == dataclasses.asdict(theirs[2])
    # run_padded_cells takes the spec group in place of a SweepConfig
    specs = [ExperimentSpec(dataset="titanic", n_clients=n, rounds=1,
                            epochs=1) for n in (2, 3)]
    out = run_padded_cells(None, None, specs, device="cpu")
    assert set(out["cells"]) == {2, 3}
    with pytest.raises(ValueError, match="does not match the specs' mode"):
        run_padded_cells(None, "verticomb", specs, device="cpu")


def _invalid_grids(api):
    spec = api.ExperimentSpec(dataset="titanic", n_clients=2, rounds=1,
                              epochs=1)
    return {
        "empty": [],
        "not a spec": [object()],
        "duplicate": [spec, spec.replace(seeds=(0,))],
        "max_clients": [spec.replace(max_clients=4)],
        "splitnn": [spec.replace(mode="splitnn")],
        "engine": [spec.replace(engine="python")],
        "common": [spec, spec.replace(n_clients=3, lr=1e-2)],
    }


@pytest.mark.parametrize("case", ["empty", "not a spec", "duplicate",
                                  "max_clients", "splitnn", "engine",
                                  "common", "ragged", "two groups"])
def test_grid_validation_errors_are_the_references(ref, case):
    def error(api, fn_name):
        if case == "ragged":
            # only sync/none/none specs construct here, so a ragged
            # schedule axis is given to the validator directly
            group = [types.SimpleNamespace(
                dataset="titanic", mode="devertifl", n_clients=n,
                schedule=sc, fault="none", transform="none")
                for n, sc in ((2, "sync"), (3, "sync"), (2, "stale_k:2"))]
            fn, args = api._group_axes, (group,)
        elif case == "two groups":
            spec = api.ExperimentSpec(dataset="titanic", n_clients=2)
            fn = api.sweep_config_for_specs
            args = ([spec, spec.replace(mode="verticomb")],)
        else:
            fn, args = getattr(api, fn_name), (_invalid_grids(api)[case],)
        with pytest.raises((ValueError, TypeError)) as e:
            fn(*args)
        return type(e.value), str(e.value).replace("repro_torch.", "repro.")
    ours = error(S, "run_grid")
    theirs = error(ref.api.session, "run_grid")
    assert ours == theirs
    if case not in ("ragged", "two groups"):
        assert error(S, "sweep_config_for_specs") == ours


# ---------------------------------------------------------------------------
# the engine's lane axes: schedules, faults, transforms and obs all run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field,value", [
    ("schedules", ("sync", "stale_k:2")), ("faults", ("crash:0.2",)),
    ("transforms", ("int8",)), ("obs", ("basic",))])
def test_deferred_sweep_axes_name_their_queue_item(field, value):
    scfg = SweepConfig(datasets=("titanic",), modes=("devertifl",),
                       client_counts=(2,), seeds=(0,), rounds=1, epochs=1,
                       **{field: value})
    calls = [lambda: build_lane_batch("titanic", "devertifl", scfg,
                                      device="cpu"),
             lambda: run_padded_cells("titanic", "devertifl", scfg,
                                      device="cpu"),
             lambda: SW.run_grid(scfg, device="cpu"),
             lambda: run_cell("titanic", "devertifl", 2, dataclasses.replace(
                 scfg, **{field: value[-1:]}), device="cpu")]
    axis = {"schedules": "schedules", "faults": "faults",
            "transforms": "transforms"}.get(field)
    if axis is None:
        # the obs axis runs: every entry point records the level's
        # series, and a spec grid carries it as a common field
        out = calls[1]()
        assert out["obs"] == list(value) and len(out["cells"]) == 1
        assert calls[0]().n_lanes == 1
        assert set(calls[2]()["cells"]) == {
            f"titanic/devertifl/basic/none/none/sync/2"}
        assert calls[3]()["obs_series"]["loss"].shape == (1, 1)
        specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                          client_counts=(2,), seeds=(0,), rounds=1,
                          epochs=1, first_layer="slice", obs=value[0])
        assert [sp.obs for sp in specs] == list(value)
        return
    # the schedule, fault and transform axes run: one lane a value
    assert build_lane_batch("titanic", "devertifl", scfg,
                            device="cpu").n_lanes == len(value)
    out = run_padded_cells("titanic", "devertifl", scfg, device="cpu")
    assert len(out["cells"]) == len(value)
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(2,), seeds=(0,), rounds=1, epochs=1,
                      first_layer="slice", **{axis: value})
    assert [getattr(sp, axis[:-1]) for sp in specs] == list(value)
