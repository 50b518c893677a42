"""The port's wire layer (``repro_torch.wire``: plans, codecs, the packed
payload and ``WireImpl``) against the JAX package's ``repro.wire``, and
the reference's own invariants inside the port.

Cross-package: the parser's canonical strings and error texts, spec
hashes; ``topk_select``, ``int8_roundtrip``, ``pack``/``unpack`` and
``wire_bytes`` bit for bit on the same seeded input; whole federations
under ``topk:0.5+int8+dp:0.1`` and under the combination ``stale_k:2`` +
``crash:0.2+corrupt:0.05`` + ``topk:0.5+int8+dp:0.1`` in the masked,
slice and kernel lanes, replayed from the reference's inits, batches,
coins and noise: per-step losses within ``LOSS_RTOL``, predictions,
fault counters and wire bytes equal; the checkpoint's engine keys, the
reference's.

Inside the port (``tests/test_wire.py``'s contracts): ``topk:1.0`` is
bitwise sync; the int8 round trip is idempotent; padded is bitwise
unpadded; the Session's wire bytes are ``wire_bytes``'s integers; resume
is bitwise; every transform lane is bitwise its standalone run; the
reference's sweep refusals.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentSpec, build, run_grid, spec_grid
from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                    run_cell, run_padded_cells)
from repro_torch.wire import (WIRE_TAG, get_wire_plan, int8_roundtrip, pack,
                              topk_select, transform_names, unpack,
                              wire_apply_static, wire_bytes)
from test_torch_support import (LOSS_RTOL, assert_engine_replays,
                                engine_traj, port_engine_run, reference,
                                reference_engine_run)

TINY = dict(dataset="titanic", n_clients=3, rounds=2, epochs=2, seed=0)
COMBO = dict(schedule="stale_k:2", fault="crash:0.2+corrupt:0.05",
             transform="topk:0.5+int8+dp:0.1")


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


def _stack(seed, shape=(4, 6, 10)):
    """A seeded stack with the codecs' edge cases: ties at the topk
    threshold, an all-zero row, exact powers of two and half steps of
    the int8 grid, magnitudes from 1e-3 to 1e3."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-3, 4, shape[:-1] + (1,))).astype(np.float32)
    h[0, 0, :4] = np.float32(0.5)           # ties
    h[0, 1] = 0.0                           # an all-zero row
    h[1, 0, :3] = [np.float32(2.0 ** 5), -2.0 ** -3, 1.0]
    h[1, 1] = np.float32(1.0)
    h[1, 1, 1:4] = [np.float32(1.5 / 128), -2.5 / 128, 0.5 / 128]
    return h


# ---------------------------------------------------------------------------
# the registry and the codecs, against the reference
# ---------------------------------------------------------------------------
SPECS = ["none", "int8", "topk:0.25", "topk:0.250", "dp:0.1", "dp:0.10",
         "dp:0.10+topk:0.5+int8", "int8+dp:1", "topk:1.0", " int8 ",
         # errors
         "bogus", "topk", "topk:0", "topk:1.5", "topk:x", "topk:0.1:2",
         "int8:3", "dp", "dp:0", "dp:-1", "dp:y", "none:1", "none+int8",
         "int8+int8", "int8+", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_wire_parse_is_the_references(ref, spec):
    def parsed(get):
        err = _error(get, spec)
        if err:
            return err
        w = get(spec)
        return (w.spec, w.topk_p, w.int8, w.dp_sigma, w.is_none)
    assert parsed(get_wire_plan) == parsed(ref.wire.get_wire_plan)


def test_transform_names_are_the_references(ref):
    assert transform_names() == ref.wire.transform_names()
    assert WIRE_TAG == ref.wire.WIRE_TAG


@pytest.mark.parametrize("kw", [dict(transform="int8"),
                                dict(transform="dp:0.10+topk:0.5"),
                                COMBO, dict(COMBO, n_clients=5)])
def test_wire_spec_hashes_are_the_references(ref, kw):
    kw = dict(dataset="titanic", first_layer="slice", **kw)
    ours, theirs = ExperimentSpec(**kw), ref.api.ExperimentSpec(**kw)
    assert (ours.transform, ours.spec_hash, ours.resume_hash) == \
        (theirs.transform, theirs.spec_hash, theirs.resume_hash)
    bad = dict(dataset="titanic", transform="int8", mode="verticomb")
    assert _error(lambda: ExperimentSpec(**bad)) == \
        _error(lambda: ref.api.ExperimentSpec(**bad))


@pytest.mark.parametrize("p", [0.05, 0.25, 0.3, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_select_is_the_references(ref, seed, p):
    h = _stack(seed)
    theirs = np.asarray(ref.codecs.topk_select(h, ref.jnp.float32(p)))
    ours = topk_select(torch.tensor(h), p)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the per-slot form (a lane batch's) gives each slot its own fraction
    per_slot = topk_select(torch.tensor(h), torch.full((h.shape[0],), p))
    np.testing.assert_array_equal(per_slot.numpy(), theirs)
    if p == 1.0:
        np.testing.assert_array_equal(ours.numpy(), h)


@pytest.mark.parametrize("seed", range(4))
def test_int8_roundtrip_is_the_references(ref, seed):
    h = _stack(seed)
    theirs = np.asarray(ref.codecs.int8_roundtrip(h))
    ours = int8_roundtrip(torch.tensor(h))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # idempotent, bit for bit
    np.testing.assert_array_equal(int8_roundtrip(ours).numpy(),
                                  ours.numpy())


@pytest.mark.parametrize("spec", ["int8", "topk:0.3", "topk:0.5+int8",
                                  "none"])
def test_pack_and_unpack_are_the_references(ref, spec):
    h = _stack(3).reshape(24, 10)
    plan, rplan = get_wire_plan(spec), ref.wire.get_wire_plan(spec)
    sent = wire_apply_static(plan, torch.tensor(h))
    np.testing.assert_array_equal(
        sent.numpy(), np.asarray(ref.codecs.wire_apply_static(rplan, h)))
    ours, theirs = pack(plan, sent), ref.codecs.pack(rplan, sent.numpy())
    assert ours.nbytes == theirs.nbytes and ours.shape == theirs.shape
    for a, b in zip(ours.entries, theirs.entries, strict=True):
        for x, y in zip(a, b, strict=True):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
                assert np.asarray(x).dtype == np.asarray(y).dtype
    np.testing.assert_array_equal(unpack(ours), sent.numpy())
    np.testing.assert_array_equal(unpack(ours), ref.codecs.unpack(theirs))


@pytest.mark.parametrize("live_n,rows,width", [(5, 64, 10), (3.0, 7, 13),
                                               (0, 64, 10), (10, 64, 784)])
@pytest.mark.parametrize("topk_on,topk_p,int8_on", [
    (0.0, 1.0, 0.0), (1.0, 0.5, 0.0), (0.0, 1.0, 1.0), (1.0, 0.25, 1.0),
    (1.0, 0.33, 1.0)])
def test_wire_bytes_are_the_references(ref, live_n, rows, width, topk_on,
                                       topk_p, int8_on):
    jnp = ref.jnp
    theirs = ref.codecs.wire_bytes(
        jnp.float32(live_n), rows, width, topk_on=jnp.float32(topk_on),
        topk_p=jnp.float32(topk_p), int8_on=jnp.float32(int8_on))
    ours = wire_bytes(live_n, rows, width, topk_on=topk_on, topk_p=topk_p,
                      int8_on=int8_on)
    assert [int(v) for v in ours] == [int(v) for v in theirs]
    assert all(v.dtype == torch.int32 for v in ours)


# ---------------------------------------------------------------------------
# whole federations against the reference
# ---------------------------------------------------------------------------
LANES = [("slice", "slice"), ("masked", "masked"), ("pallas", "kernel")]


@pytest.mark.parametrize("ref_lane,lane", LANES)
@pytest.mark.parametrize("plan", [dict(transform="topk:0.5+int8+dp:0.1"),
                                  COMBO], ids=["wire", "combination"])
def test_wired_federation_replays_reference(ref, plan, ref_lane, lane):
    kw = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1, **plan)
    r = reference_engine_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer=lane,
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL
    # the engine state's leaves are the reference's, key for key
    assert sorted(_flat(sched)) == sorted(_flat(r.sched))
    np.testing.assert_array_equal(sched["wkey"], r.sched["wkey"])
    assert int(sched["wstep"]) == int(r.sched["wstep"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("transform", ["topk:0.25", "int8+dp:0.5"])
def test_wire_replays_reference_on_mnist(ref, transform):
    kw = dict(dataset="mnist", n_samples=600, n_clients=5, rounds=2,
              epochs=1, transform=transform, exchange_at=1)
    r = reference_engine_run(ref, first_layer="slice", **kw)
    fed, losses, params, sched = port_engine_run(ref, r, first_layer="kernel",
                                                 **kw)
    assert assert_engine_replays(r, fed, losses, params, sched) <= LOSS_RTOL


def test_checkpoint_keys_are_the_references(ref, tmp_path):
    """A Session checkpoint under the combination holds the reference's
    npz keys, shapes and dtypes (``sched/buf``, ``sched/inner/...``,
    ``sched/wkey`` as uint32 [2], ...)."""
    kw = dict(dataset="titanic", rounds=1, epochs=1, seeds=(0,),
              checkpoint_every=1, **COMBO)
    ours_dir, theirs_dir = str(tmp_path / "ours"), str(tmp_path / "theirs")
    build(ExperimentSpec(first_layer="slice", checkpoint_dir=ours_dir, **kw),
          device="cpu").run()
    ref.api.build(ref.api.ExperimentSpec(
        first_layer="slice", checkpoint_dir=theirs_dir, **kw)).run()
    name = "session_00000001.npz"
    with np.load(os.path.join(ours_dir, name)) as a, \
            np.load(os.path.join(theirs_dir, name)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
        np.testing.assert_array_equal(a["schedule_hash"], b["schedule_hash"])
        np.testing.assert_array_equal(a["resume_hash"], b["resume_hash"])


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
def test_topk_full_keep_is_sync_bitwise(lane):
    kw = dict(TINY, first_layer=lane)
    sync = engine_traj(**kw)
    ours = engine_traj(transform="topk:1.0", **kw)
    np.testing.assert_array_equal(ours[0], sync[0])
    assert ours[1] == sync[1]


def test_transforms_are_deterministic_and_change_the_run():
    sync = engine_traj(**TINY)[0]
    for t in ("topk:0.25", "int8", "dp:0.5", "topk:0.5+int8+dp:0.1"):
        a = engine_traj(transform=t, **TINY)[0]
        np.testing.assert_array_equal(a, engine_traj(transform=t, **TINY)[0])
        assert not np.array_equal(a, sync)


@pytest.mark.parametrize("lane", ["masked", "kernel"])
@pytest.mark.parametrize("plan", [dict(transform="topk:0.5"),
                                  dict(transform="int8+dp:0.1"), COMBO],
                         ids=["topk", "int8_dp", "combination"])
def test_padded_is_unpadded_bitwise_under_wire(plan, lane):
    kw = dict(TINY, first_layer=lane, **plan)
    a, fa, fed_a, sa = engine_traj(**kw)
    b, fb, fed_b, sb = engine_traj(max_clients=6, **kw)
    np.testing.assert_array_equal(a, b)
    assert fa == fb
    assert {k: int(v) for k, v in fed_a.wire_telemetry(sa).items()} == \
        {k: int(v) for k, v in fed_b.wire_telemetry(sb).items()}


def test_session_wire_bytes_are_wire_bytes_integers():
    spec = ExperimentSpec(dataset="titanic", n_clients=3, rounds=2, epochs=1,
                          first_layer="kernel", transform="topk:0.5+int8")
    sess = build(spec, device="cpu")
    rr = sess.run()
    fed = sess.federation
    raw, enc = wire_bytes(3, fed.bs, 2, topk_on=1.0, topk_p=0.5, int8_on=1.0)
    steps = spec.rounds * fed.n_batches
    assert rr.timings["wire"] == {
        "raw_bytes": int(raw) * steps, "encoded_bytes": int(enc) * steps,
        "raw_bytes_per_round": int(raw) * steps // 2,
        "encoded_bytes_per_round": int(enc) * steps // 2}
    assert "fault" not in rr.timings
    none = build(spec.replace(transform="none"), device="cpu").run()
    assert "wire" not in none.timings


@pytest.mark.parametrize("plan", [dict(transform="topk:0.5+int8+dp:0.1"),
                                  COMBO], ids=["wire", "combination"])
def test_resume_is_bitwise_under_wire(tmp_path, plan):
    d = str(tmp_path)
    kw = dict(dataset="titanic", epochs=1, seeds=(0,), first_layer="kernel",
              **plan)
    full = build(ExperimentSpec(rounds=4, **kw), device="cpu").run()
    build(ExperimentSpec(rounds=2, checkpoint_dir=d, checkpoint_every=1,
                         **kw), device="cpu").run()
    res = build(ExperimentSpec(rounds=4, checkpoint_dir=d,
                               checkpoint_every=1, **kw),
                device="cpu").resume()
    assert res.resumed_from == 2 and res.metrics == full.metrics
    assert res.timings["wire"] == full.timings["wire"]
    for i, r in enumerate((2, 3)):
        np.testing.assert_array_equal(res.history[i]["round_losses"],
                                      full.history[r]["round_losses"])
    with pytest.raises(ValueError, match="different exchange schedule"):
        build(ExperimentSpec(rounds=4, checkpoint_dir=d, checkpoint_every=1,
                             **{**kw, "transform": "int8"}),
              device="cpu").resume()


# ---------------------------------------------------------------------------
# the transform lane axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "kernel"])
def test_every_transform_lane_is_its_standalone_run(lane):
    transforms = ("none", "topk:0.5", "int8+dp:0.1")
    lb = build_lane_batch("titanic", "devertifl", SweepConfig(
        client_counts=(2, 3), seeds=(0, 1), rounds=2, epochs=1,
        first_layer=lane, transforms=transforms,
        faults=("none", "crash:0.5")), device="cpu")
    assert lb.n_lanes == 24
    params, opt, step, sched, out = (lb.params, lb.opt_state, 0,
                                     lb.sched_state, [])
    for r in range(2):
        params, opt, step, sched, lr = lb.round_fn(
            params, opt, step, lb.round_indices(r), lb.xtr, lb.ytr, lb.lay,
            sched, lb.round_draws(r))
        out.append(lr)
    losses = torch.cat(out, dim=1).numpy()
    wire = lb.impl.wire_telemetry(sched)
    for li, (nc, s) in enumerate(lb.lanes):
        t, f = transforms[li // 8], ("none", "crash:0.5")[li // 4 % 2]
        want, _, fed, st = engine_traj(
            dataset="titanic", n_clients=nc, seed=s, rounds=2, epochs=1,
            first_layer=lane, transform=t, fault=f)
        np.testing.assert_array_equal(losses[li], want)
        if t != "none":
            assert {k: int(v[li]) for k, v in wire.items()} == \
                {k: int(v) for k, v in fed.wire_telemetry(st).items()}


def test_wire_sweep_refuses_what_the_reference_refuses(ref):
    from repro_torch.wire import register_transform
    for reg in (register_transform, ref.wire.register_transform):
        reg("test_custom_wire", lambda **kw: None, overwrite=True)
    base = dict(client_counts=(2,), seeds=(0,), rounds=1, epochs=1)
    cases = [("non_federated", dict(transforms=("int8",))),
             ("devertifl", dict(transforms=("test_custom_wire",))),
             ("devertifl", dict(transforms=()))]
    for mode, axes in cases:
        ours = _error(lambda: run_padded_cells(
            "titanic", mode, SweepConfig(**base, **axes), device="cpu"))
        theirs = _error(lambda: ref.sweep.run_padded_cells(
            "titanic", mode, ref.sweep.SweepConfig(**base, **axes)))
        assert ours == theirs and ours is not None, (mode, axes)
    axes = dict(transforms=("none", "int8"))
    assert _error(lambda: run_cell("titanic", "devertifl", 2, SweepConfig(
        **base, **axes), device="cpu")) == _error(
        lambda: ref.sweep.run_cell("titanic", "devertifl", 2,
                                   ref.sweep.SweepConfig(**base, **axes)))


def test_transform_grid_keys_and_cell_bytes():
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(2,), seeds=(0,),
                      transforms=("none", "int8"), faults=("none",
                                                          "crash:0.5"),
                      rounds=1, epochs=1, first_layer="slice")
    grid = run_grid(specs, device="cpu")
    assert set(grid["cells"]) == {
        f"titanic/devertifl/{t}/{f}/sync/2" for t in ("none", "int8")
        for f in ("none", "crash:0.5")}
    cell = grid["cells"]["titanic/devertifl/int8/crash:0.5/sync/2"]
    assert cell["transform"] == "int8" and cell["fault"] == "crash:0.5"
    assert cell["wire"]["encoded_bytes"] < cell["wire"]["raw_bytes"]
