"""The port's training path beyond the default mode: the baselines,
the other exchange points, padded and skewed client axes against the
JAX package (replayed as in test_torch_protocol.py), and the invariants
the port pins inside itself -- padded == unpadded bitwise, the kernel,
slice and masked lanes allclose, a run reproducible from its seed."""
import numpy as np
import pytest
import torch

from repro_torch.core.protocol import DeVertiFL, ProtocolConfig
from test_torch_support import (LOSS_RTOL, assert_replays, port_run,
                                reference, reference_run)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


TITANIC = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1)

CASES = [
    # mode, exchange_at, reference lane, port lane, extra config
    ("non_federated", -1, "slice", "kernel", {}),
    ("non_federated", -1, "masked", "masked", {}),
    ("verticomb", -1, "pallas", "kernel", {}),
    ("verticomb", -1, "masked", "masked", {}),
    ("devertifl", 1, "slice", "kernel", {}),
    ("verticomb", 2, "masked", "masked", {}),
    ("devertifl", 0, "masked", "masked", {}),
    ("devertifl", 0, "slice", "kernel", {}),     # both resolve to masked
    ("devertifl", -1, "slice", "kernel", {"max_clients": 5}),
    ("devertifl", -1, "masked", "masked", {"max_clients": 4}),
    ("devertifl", -1, "slice", "kernel", {"partition_sizes": (5, 3, 1)}),
]


@pytest.mark.parametrize("mode,exchange_at,ref_lane,lane,extra", CASES)
def test_replays_reference(ref, mode, exchange_at, ref_lane, lane, extra):
    kw = dict(TITANIC, mode=mode, exchange_at=exchange_at, **extra)
    r = reference_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params = port_run(r.init, r.idx, first_layer=lane, **kw)
    assert fed.first_layer == ("masked" if exchange_at == 0 else lane)
    assert_replays(r, fed, losses, params)


def _train(**kw):
    fed = DeVertiFL(ProtocolConfig(**kw), device="cpu")
    return fed, fed.train()


@pytest.mark.parametrize("lane", ["kernel", "slice", "masked"])
@pytest.mark.parametrize("mode", ["devertifl", "verticomb"])
def test_padded_equals_unpadded_bitwise(lane, mode):
    kw = dict(TITANIC, first_layer=lane, mode=mode)
    fed, out = _train(**kw)
    fed_p, out_p = _train(max_clients=5, **kw)
    for h, hp in zip(out["history"], out_p["history"], strict=True):
        np.testing.assert_array_equal(h["round_losses"], hp["round_losses"])
        assert h["f1_per_client"] == hp["f1_per_client"]
    for name, layer in out["params"].items():
        for leaf, t in layer.items():
            assert torch.equal(t, out_p["params"][name][leaf][:3]), \
                (name, leaf)
    np.testing.assert_array_equal(
        fed.predict(out["params"], fed.xte).numpy(),
        fed_p.predict(out_p["params"], fed_p.xte).numpy()[:3])


@pytest.mark.parametrize("extra", [{}, {"partition_sizes": (5, 3, 1)}])
def test_lanes_agree_inside_the_port(extra):
    runs = {lane: _train(first_layer=lane, **TITANIC, **extra)[1]
            for lane in ("kernel", "slice", "masked")}
    base = np.concatenate([h["round_losses"]
                           for h in runs["slice"]["history"]])
    for lane in ("kernel", "masked"):
        got = np.concatenate([h["round_losses"]
                              for h in runs[lane]["history"]])
        np.testing.assert_allclose(got, base, rtol=LOSS_RTOL, atol=0)
        assert runs[lane]["final"]["f1"] == pytest.approx(
            runs["slice"]["final"]["f1"], abs=0.002)


def test_train_is_reproducible_and_engines_agree():
    fed, out = _train(first_layer="kernel", **TITANIC)
    again = fed.train()
    python = fed.train(engine="python")
    for a, b, c in zip(out["history"], again["history"],
                       python["history"]):
        np.testing.assert_array_equal(a["round_losses"], b["round_losses"])
        np.testing.assert_array_equal(a["round_losses"], c["round_losses"])
    other = fed.train(seed=1)
    assert not np.array_equal(other["history"][0]["round_losses"],
                              out["history"][0]["round_losses"])
    hist = out["history"]
    assert [h["round"] for h in hist] == [0, 1]
    assert hist[-1]["loss"] == hist[-1]["round_losses"][-1]
    assert len(hist[0]["round_losses"]) == fed.n_batches
    final = out["final"]
    assert 0 <= final["f1"] <= 1 and 0 <= final["acc"] <= 1
    assert len(final["f1_per_client"]) == 3
    assert tuple(fed.predict(out["params"], fed.xte[:4]).shape) == (3, 4)
    with pytest.raises(ValueError, match="engine"):
        fed.train(engine="jit")


def test_perm_plan_drops_the_tail():
    fed = DeVertiFL(ProtocolConfig(**TITANIC), device="cpu")
    n_train = len(fed.xtr)
    idx = fed.perms(torch.Generator().manual_seed(0))
    assert tuple(idx.shape) == (fed.n_batches, fed.bs)
    assert fed.n_batches * fed.bs + n_train % fed.bs == n_train
    assert len(set(idx.flatten().tolist())) == fed.n_batches * fed.bs
    params = fed.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="index matrix"):
        fed.run_round(params, fed.opt.init(params), 0, idx[:-1])


def test_set_fedavg():
    fed = DeVertiFL(ProtocolConfig(**TITANIC), device="cpu")
    fed.set_fedavg(lambda p: p)              # no averaging at all
    out = fed.train()
    k = out["params"]["layer_1"]["kernel"]
    assert not torch.equal(k[0], k[1])
    with pytest.raises(ValueError, match="client_mask"):
        DeVertiFL(ProtocolConfig(max_clients=4, **TITANIC),
                  fedavg_fn=lambda p: p, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("schedule", "stale_k:2"), ("fault", "crash:0.2"),
    ("transform", "int8"), ("obs", "basic")])
def test_unported_plans_refuse(field, value):
    """Every plan runs now: the schedule, fault, transform and obs plans
    wrap the engine, in devertifl mode only."""
    fed = DeVertiFL(ProtocolConfig(**TITANIC, **{field: value}),
                    device="cpu")
    assert fed.init_sched_state()
    with pytest.raises(ValueError, match="devertifl"):
        DeVertiFL(ProtocolConfig(**{**TITANIC, "mode": "verticomb"},
                                 **{field: value}), device="cpu")


def test_unknown_lane_names_the_options():
    with pytest.raises(ValueError, match="kernel"):
        DeVertiFL(ProtocolConfig(first_layer="pallas", **TITANIC),
                  device="cpu")
