"""The port's SplitNN baseline (``repro_torch.core.baselines``) against
the JAX package's: the same partition and data, the same batch order
(the reference's own numpy stream, reproduced, not injected), and from
the reference's injected initial weights the same training -- final
params allclose, predictions equal on >= 99.5% of the test rows, F1
within 0.002.  Inside the port: reruns bitwise, and the splitnn
Session is ``SplitNN.train`` exactly."""
import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentSpec, build
from repro_torch.core.baselines import SplitNN, SplitNNConfig
from repro_torch.tree import tree_leaves
from test_torch_support import reference, to_np


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


# float32 in another summation order, compounded over the run's Adam
# steps (measured on the CPU: at most 6.0e-8 absolute on these cases)
PARAM_ATOL = 1e-6
PARAM_RTOL = 1e-5

CASES = [
    # the reference test's case (tests/test_api.py:288)
    dict(dataset="bank", n_clients=2, rounds=1, epochs=2, n_samples=1500),
    dict(dataset="titanic", n_clients=3, rounds=2, epochs=2),
    dict(dataset="mnist", n_clients=4, rounds=1, epochs=1, n_samples=600,
         batch_size=32),
]


def _ids(case):
    return f"{case['dataset']}-{case['n_clients']}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_replays_reference_from_its_init(ref, case):
    rcfg = ref.baselines.SplitNNConfig(**case)
    theirs = ref.baselines.SplitNN(rcfg)
    init = to_np(theirs.init_params(ref.jax.random.PRNGKey(rcfg.seed)))
    r_metrics, r_params = theirs.train(return_state=True)
    ours = SplitNN(SplitNNConfig(**case), device="cpu")
    for a, b in zip(ours.partition, theirs.partition, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.xtr, theirs.xtr)
    metrics, params = ours.train(params=init, return_state=True)
    assert sorted(params) == sorted(r_params)
    for a, b in zip(tree_leaves(params),
                    ref.jax.tree.leaves(to_np(r_params)), strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
    preds = ours.predict(params, ours.xte)
    assert isinstance(preds, np.ndarray) and preds.shape == \
        (len(ours.xte),)
    agree = float((preds == theirs.predict(r_params, theirs.xte)).mean())
    assert agree >= 0.995, agree
    assert abs(metrics["f1"] - r_metrics["f1"]) <= 0.002, \
        (metrics, r_metrics)


def test_init_draws_the_references_shapes_and_scales(ref):
    cfg = dict(dataset="titanic", n_clients=3)
    theirs = ref.baselines.SplitNN(ref.baselines.SplitNNConfig(**cfg))
    r_init = to_np(theirs.init_params(ref.jax.random.PRNGKey(0)))
    ours = SplitNN(SplitNNConfig(**cfg), device="cpu")
    init = ours.init_params(torch.Generator().manual_seed(0))
    assert sorted(init) == sorted(r_init)
    for name in init:
        for leaf in ("kernel", "bias"):
            assert tuple(init[name][leaf].shape) == \
                r_init[name][leaf].shape, (name, leaf)
        assert not init[name]["bias"].any()
    wide = SplitNN(SplitNNConfig(dataset="mnist", n_clients=2,
                                 n_samples=200), device="cpu")
    k = wide.init_params(torch.Generator().manual_seed(0))["bottom_0"][
        "kernel"]
    assert k.std().item() == pytest.approx((2.0 / k.shape[0]) ** 0.5,
                                           rel=0.05)


def test_reruns_bitwise_and_seed_forks():
    cfg = SplitNNConfig(dataset="titanic", n_clients=3, rounds=1,
                        epochs=2)
    sn = SplitNN(cfg, device="cpu")
    m1, p1 = sn.train(return_state=True)
    m2, p2 = SplitNN(cfg, device="cpu").train(return_state=True)
    assert m1 == m2
    for a, b in zip(tree_leaves(p1), tree_leaves(p2), strict=True):
        assert torch.equal(a, b)
    _, p3 = sn.train(key=1, return_state=True)
    assert not torch.equal(p1["top_2"]["kernel"], p3["top_2"]["kernel"])
    assert 0.0 <= m1["f1"] <= 1.0 and 0.0 <= m1["acc"] <= 1.0


def test_splitnn_session_matches_baseline():
    spec = ExperimentSpec(dataset="bank", mode="splitnn", n_clients=2,
                          rounds=1, epochs=2, n_samples=1500)
    sess = build(spec, device="cpu")
    rr = sess.run()
    legacy = SplitNN(SplitNNConfig(dataset="bank", n_clients=2, rounds=1,
                                   epochs=2, n_samples=1500),
                     device="cpu").train()
    assert rr.metrics == legacy
    assert rr.params is not None
    sn = sess._splitnn()
    assert rr.telemetry.steps == 2 * sn.n_batches
    preds = sess.predict(np.zeros((5, sn.n_features), np.float32))
    assert isinstance(preds, np.ndarray) and preds.shape == (5,)
    multi = build(spec.replace(seeds=(0, 1)), device="cpu").run()
    assert multi.params is None
    assert multi.metrics["f1_per_seed"][0] == legacy["f1"]
    assert multi.metrics["seeds"] == [0, 1]
    with pytest.raises(ValueError, match="multi-seed"):
        build(spec.replace(seeds=(0, 1)), device="cpu").predict(
            np.zeros((2, sn.n_features), np.float32))


def test_needs_cuda_unless_told_otherwise():
    cfg = SplitNNConfig(dataset="titanic", n_clients=2)
    if torch.cuda.is_available():
        assert SplitNN(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SplitNN(cfg)
