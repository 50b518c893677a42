"""The port's front door (``repro_torch.api``) against the JAX package's
``repro.api``: the same spec hashes and validation errors, Sessions
that replay the reference's per-step losses from its injected inits
and batches in every mode x lane x padding, and inside the port the
reference's own invariants -- a Session is ``DeVertiFL.train`` bit for
bit, ``resume()`` is the uninterrupted run bit for bit, with the same
refusals -- plus registries, the RunResult schema and the entry points
still to be ported."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import (RESULT_SCHEMA_VERSION, ExperimentSpec,
                             RunResult, build, dataset_names,
                             first_layer_names, mode_names,
                             register_dataset, register_first_layer,
                             register_mode)
from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                       auto_first_layer,
                                       make_first_layer_fn,
                                       round_generator, train_federation)
from repro_torch.interop import params_from_numpy
from repro_torch.tree import tree_leaves
from test_torch_support import LOSS_RTOL, reference, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(dataset="titanic", n_clients=3, rounds=2, epochs=1)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _cpu(spec):
    return build(spec, device="cpu")


# ---------------------------------------------------------------------------
# spec hashes and validation, against the reference
# ---------------------------------------------------------------------------
DATASETS = ("mnist", "fmnist", "titanic", "bank")
MODES = ("devertifl", "non_federated", "verticomb", "splitnn")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dataset", DATASETS)
def test_hashes_equal_the_references(ref, dataset, mode):
    """spec_hash and resume_hash, letter for letter, over n_clients x
    exchange_at x lanes (masked, slice, auto) x max_clients x n_samples
    x engine; "auto" is "slice" in both packages on a machine without
    a card."""
    n = 0
    for nc in (2, 3, 5):
        for ex in (-1, 0, 1):
            for fl in ("masked", "slice", "auto"):
                for mc in (None, 6):
                    for ns in (None, 600):
                        for engine in ("scan", "python"):
                            kw = dict(dataset=dataset, mode=mode,
                                      n_clients=nc, exchange_at=ex,
                                      first_layer=fl, max_clients=mc,
                                      n_samples=ns, engine=engine)
                            ours = ExperimentSpec(**kw)
                            theirs = ref.api.ExperimentSpec(**kw)
                            assert ours.to_dict() == theirs.to_dict(), kw
                            assert ours.spec_hash == theirs.spec_hash, kw
                            assert ours.resume_hash == \
                                theirs.resume_hash, kw
                            n += 1
    assert n == 216


@pytest.mark.parametrize("kw", [
    dict(), dict(seeds=(1, 2)), dict(seeds=[3]), dict(seeds=4),
    dict(lr=1e-2, rounds=7, epochs=2, batch_size=32, fedavg=False),
    dict(mode="backward_exchange"),
    dict(eval_every=0, checkpoint_dir="/tmp/x", checkpoint_every=2,
         shard=False),
    dict(dataset="bank", mode="splitnn", n_clients=2, rounds=20,
         epochs=10)])
def test_more_hashes_equal_the_references(ref, kw):
    ours, theirs = ExperimentSpec(**kw), ref.api.ExperimentSpec(**kw)
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.spec_hash, ours.resume_hash) == \
        (theirs.spec_hash, theirs.resume_hash)


def test_kernel_and_pallas_lanes_keep_their_own_hashes(ref):
    ours = ExperimentSpec(first_layer="kernel", **TINY)
    theirs = ref.api.ExperimentSpec(first_layer="pallas", **TINY)
    assert ours.spec_hash != theirs.spec_hash
    assert ours.replace(first_layer="slice").spec_hash == \
        theirs.replace(first_layer="slice").spec_hash


def test_auto_first_layer_canonicalizes_at_construction(ref):
    spec = ExperimentSpec(**TINY)
    assert spec.first_layer == auto_first_layer() != "auto"
    assert spec.first_layer == ("kernel" if torch.cuda.is_available()
                                else "slice")
    assert spec.spec_hash == ExperimentSpec(
        first_layer=auto_first_layer(), **TINY).spec_hash
    if not torch.cuda.is_available():
        assert spec.spec_hash == ref.api.ExperimentSpec(**TINY).spec_hash


def test_mode_aliases_canonicalize():
    a = ExperimentSpec(dataset="titanic", mode="backward_exchange")
    b = ExperimentSpec(dataset="titanic", mode="verticomb")
    assert a.mode == "verticomb"
    assert a == b and a.spec_hash == b.spec_hash


def test_spec_hash_ignores_observation_knobs():
    spec = ExperimentSpec(dataset="titanic")
    assert spec.spec_hash == spec.replace(
        eval_every=0, checkpoint_dir="/tmp/x", checkpoint_every=0,
        shard=False).spec_hash
    assert spec.spec_hash != spec.replace(first_layer="masked").spec_hash
    assert spec.spec_hash != spec.replace(seeds=(1,)).spec_hash
    assert spec.resume_hash == spec.replace(rounds=9).resume_hash
    assert spec.spec_hash != spec.replace(rounds=9).spec_hash


def test_spec_hash_stable_across_processes():
    spec = ExperimentSpec(dataset="titanic", n_clients=4, rounds=7,
                          seeds=(0, 1), first_layer="slice")
    code = ("from repro_torch.api import ExperimentSpec;"
            "print(ExperimentSpec(dataset='titanic', n_clients=4,"
            " rounds=7, seeds=(0, 1), first_layer='slice').spec_hash)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == spec.spec_hash


def _message(cls, **kw):
    with pytest.raises(ValueError) as e:
        cls(**kw)
    return str(e.value).replace("repro_torch.", "repro.")


@pytest.mark.parametrize("kw,frag", [
    (dict(engine="jit"), "engine"),
    (dict(n_clients=0), "n_clients"),
    (dict(max_clients=2, n_clients=5), "max_clients"),
    (dict(exchange_at=7), "exchange_at"),
    (dict(checkpoint_every=2), "checkpoint_dir"),
    (dict(seeds=(0, 1), engine="python"), "scan"),
    (dict(seeds=(0, 1), max_clients=8), "max_clients"),
    (dict(seeds=()), "seeds"),
    (dict(shard=True), "shard"),
    (dict(eval_every=-1), "eval_every"),
    (dict(lr=0.0), "lr"),
    (dict(seeds=(0, 1), checkpoint_dir="/tmp/c", checkpoint_every=1),
     "single-seed"),
    (dict(mode="splitnn", checkpoint_dir="/tmp/c", checkpoint_every=1),
     "federated"),
    (dict(dataset="cifar"), "cifar"),
    (dict(mode="fedsgd"), "fedsgd"),
])
def test_bad_specs_raise_the_references_errors(ref, kw, frag):
    kw = {"dataset": "titanic", **kw}
    ours = _message(ExperimentSpec, **kw)
    assert frag in ours
    assert ours == _message(ref.api.ExperimentSpec, **kw)


def test_unknown_names_list_the_registered_options():
    with pytest.raises(ValueError) as e:
        ExperimentSpec(dataset="cifar")
    assert all(name in str(e.value) for name in dataset_names())
    with pytest.raises(ValueError) as e:
        ExperimentSpec(mode="fedsgd")
    assert all(name in str(e.value) for name in mode_names())
    with pytest.raises(ValueError) as e:
        ExperimentSpec(first_layer="pallas")
    assert all(name in str(e.value) for name in first_layer_names())
    assert "kernel" in first_layer_names()


def test_spec_normalization_and_replace():
    assert ExperimentSpec(seeds=4).seeds == (4,)
    assert ExperimentSpec(seeds=[0, 1]).seeds == (0, 1)
    spec = ExperimentSpec(dataset="titanic")
    assert spec.replace(n_clients=5).n_clients == 5
    with pytest.raises(ValueError):        # replace re-validates
        spec.replace(n_clients=-1)
    assert hash(spec) == hash(ExperimentSpec(dataset="titanic"))
    with pytest.raises(Exception):
        spec.rounds = 3


@pytest.mark.parametrize("field,value", [
    ("schedule", "stale_k:2"), ("fault", "crash:0.2"),
    ("transform", "int8"), ("obs", "basic")])
def test_unported_stream_axes_refuse(field, value):
    """Every stream axis runs now: the schedule, fault, transform and obs
    axes canonicalize as the reference's and refuse non-devertifl
    modes."""
    spec = ExperimentSpec(dataset="titanic", **{field: value})
    assert getattr(spec, field) == value
    with pytest.raises(ValueError, match="devertifl"):
        ExperimentSpec(dataset="titanic", mode="verticomb",
                       **{field: value})


# ---------------------------------------------------------------------------
# Sessions against the reference's, from its inits and batches
# ---------------------------------------------------------------------------
def _reference_session(ref, **kw):
    """Run the reference Session and read back what it drew: the
    initial weights and every round's batch-index matrix."""
    jax = ref.jax
    sess = ref.api.build(ref.api.ExperimentSpec(**kw))
    rr = sess.run()
    fed = sess.federation
    init_key, loop_key = ref.protocol.train_keys(
        jax.random.PRNGKey(rr.spec.seed))
    init = to_np(fed.init_params(init_key))
    idx = [np.asarray(fed._perms(jax.random.fold_in(loop_key, r)))
           for r in range(rr.spec.rounds)]
    preds = np.asarray(sess.predict(fed.xte))
    return rr, init, idx, preds


def _replaying_session(spec, init, idx):
    """A port Session on the CPU whose federation draws ``init`` and,
    round by round, the matrices of ``idx``."""
    sess = _cpu(spec)
    fed = sess.federation
    rounds = iter(idx)
    fed.init_params = lambda generator: params_from_numpy(init, "cpu")
    fed.perms = lambda generator: torch.as_tensor(next(rounds))
    return sess


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("ref_lane,lane", [("masked", "masked"),
                                           ("slice", "slice"),
                                           ("pallas", "kernel")])
@pytest.mark.parametrize("mode", ["devertifl", "non_federated",
                                  "verticomb"])
def test_session_replays_the_references(ref, mode, ref_lane, lane,
                                        padded):
    kw = dict(TINY, mode=mode, max_clients=6 if padded else None)
    rr, init, idx, ref_preds = _reference_session(
        ref, first_layer=ref_lane, **kw)
    sess = _replaying_session(ExperimentSpec(first_layer=lane, **kw),
                              init, idx)
    ours = sess.run()
    assert [h["round"] for h in ours.history] == [0, 1]
    for a, b in zip(ours.history, rr.history, strict=True):
        np.testing.assert_allclose(a["round_losses"], b["round_losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert a["loss"] == a["round_losses"][-1]
    preds = sess.predict(sess.federation.xte).numpy()
    assert preds.shape == ref_preds.shape == (3, len(ref_preds[0]))
    assert float((preds == ref_preds).mean()) >= 0.995
    assert abs(ours.metrics["f1"] - rr.metrics["f1"]) <= 0.002
    assert ours.telemetry.steps == rr.telemetry.steps


# ---------------------------------------------------------------------------
# inside the port: Session == train, resume == uninterrupted
# ---------------------------------------------------------------------------
def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("mode,lane,max_clients,engine", [
    ("devertifl", "kernel", None, "scan"),
    ("devertifl", "slice", 5, "python"),
    ("non_federated", "masked", None, "scan"),
    ("verticomb", "kernel", 6, "scan"),
])
def test_session_is_train_bitwise(mode, lane, max_clients, engine):
    kw = dict(TINY, mode=mode, first_layer=lane, max_clients=max_clients,
              engine=engine)
    rr = _cpu(ExperimentSpec(**kw)).run()
    out = DeVertiFL(ProtocolConfig(**kw), device="cpu").train()
    assert rr.metrics == out["final"]
    for a, b in zip(rr.history, out["history"], strict=True):
        np.testing.assert_array_equal(a["round_losses"], b["round_losses"])
        assert a["f1_per_client"] == b["f1_per_client"]
    assert _params_equal(rr.params, out["params"])


def test_round_generator_depends_on_seed_and_round_only():
    def draw(seed, r):
        return torch.randperm(50, generator=round_generator(seed, r))
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))
    fed = DeVertiFL(ProtocolConfig(**TINY), device="cpu")
    seen = []
    perms = fed.perms
    fed.perms = lambda g: seen.append(perms(g)) or seen[-1]
    fed.train()
    for r, idx in enumerate(seen):
        assert torch.equal(idx, perms(round_generator(0, r)))


def _ckpt(d, rounds, **kw):
    return ExperimentSpec(dataset="titanic", rounds=rounds, epochs=1,
                          seeds=(0,), checkpoint_dir=d,
                          checkpoint_every=1, **kw)


def test_resume_is_the_uninterrupted_run_bitwise(tmp_path):
    d = str(tmp_path / "ckpt")
    full = _cpu(ExperimentSpec(dataset="titanic", rounds=4, epochs=1,
                               seeds=(0,))).run()
    _cpu(_ckpt(d, 2)).run()
    res = _cpu(_ckpt(d, 4)).resume()
    assert res.resumed_from == 2
    assert res.metrics == full.metrics
    assert _params_equal(res.params, full.params)
    for i, r in enumerate((2, 3)):
        assert res.history[i]["round"] == r
        np.testing.assert_array_equal(res.history[i]["round_losses"],
                                      full.history[r]["round_losses"])
    fresh = _cpu(_ckpt(str(tmp_path / "empty"), 2)).resume()
    assert fresh.resumed_from is None
    with pytest.raises(ValueError, match="beyond spec.rounds"):
        _cpu(_ckpt(d, 1)).resume()
    with pytest.raises(ValueError, match="resume_hash"):
        _cpu(_ckpt(d, 6, lr=1e-2)).resume()
    # the newest file truncated: walk back to round 1, still bitwise
    newest = os.path.join(d, "session_00000004.npz")
    with open(newest, "rb") as f:
        blob = f.read()
    with open(newest, "wb") as f:
        f.write(blob[:len(blob) // 3])
    os.remove(os.path.join(d, "session_00000003.npz"))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        walked = _cpu(_ckpt(d, 4)).resume()
    assert walked.resumed_from == 2
    assert walked.metrics == full.metrics
    assert _params_equal(walked.params, full.params)
    # every file corrupt: warn and train from scratch
    for name in os.listdir(d):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"junk")
    with pytest.warns(RuntimeWarning, match="every checkpoint"):
        scratch = _cpu(_ckpt(d, 4)).resume()
    assert scratch.resumed_from is None
    assert scratch.metrics == full.metrics
    with pytest.raises(ValueError, match="key="):
        _cpu(_ckpt(d, 4)).run(key=9)


def test_resume_refuses_another_stream(tmp_path):
    """A checkpoint stamped with another schedule cannot resume here."""
    from repro_torch.checkpoint import save_checkpoint
    d = str(tmp_path)
    _cpu(_ckpt(d, 1)).run()
    path = os.path.join(d, "session_00000001.npz")
    with np.load(path) as data:
        tree = {k: data[k] for k in data.files}
    tree["schedule_hash"] = np.zeros(8, np.uint8)
    os.remove(path)
    save_checkpoint(d, 1, tree, name="session")
    with pytest.raises(ValueError, match="different exchange schedule"):
        _cpu(_ckpt(d, 2)).resume()


# ---------------------------------------------------------------------------
# registries, the result record, deferred entry points
# ---------------------------------------------------------------------------
def test_register_custom_dataset_runs():
    def loader(n=600, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, 9)).astype(np.float32)
        return x, (x.sum(1) > 0).astype(np.int32)

    if "toy9" not in dataset_names():
        register_dataset("toy9", loader, n_classes=2,
                         arch="paper-mlp-titanic", partition="random")
    rr = _cpu(ExperimentSpec(**{**TINY, "dataset": "toy9"})).run()
    assert 0.0 <= rr.metrics["f1"] <= 1.0
    sn = _cpu(ExperimentSpec(dataset="toy9", mode="splitnn", n_clients=2,
                             rounds=1, epochs=1)).run()
    assert 0.0 <= sn.metrics["acc"] <= 1.0
    with pytest.raises(ValueError, match="toy9"):
        ExperimentSpec(dataset="nope")


def test_register_custom_mode():
    class EchoRunner:
        def __init__(self, spec):
            self.spec = spec

        def run(self):
            return ({"f1": 1.0, "acc": 1.0}, [], None, {"wall_s": 0.0})

        def predict(self, params, x):
            return np.zeros(len(x), np.int64)

    if "echo" not in mode_names():
        register_mode("echo", lambda spec: EchoRunner(spec))
    sess = _cpu(ExperimentSpec(dataset="titanic", mode="echo"))
    rr = sess.run()
    assert rr.metrics == {"f1": 1.0, "acc": 1.0}
    assert rr.schema_version == 5 and rr.timings["wall_s"] == 0.0
    assert sess.predict(np.zeros((3, 9)), params={}).shape == (3,)


def test_register_custom_first_layer():
    """A registered lane runs in every step and evaluation; one that
    computes the slice lane's product gives the slice lane's run."""
    calls = []

    def make(model, pcfg, layout):
        first = make_first_layer_fn(model, pcfg.replace(first_layer="slice"),
                                    layout, "cpu")

        def counted(params, xb, lay):
            calls.append(xb.shape[0])
            return first(params, xb, lay)
        return counted

    if "slice_twin" not in first_layer_names():
        register_first_layer("slice_twin", make)
    spec = ExperimentSpec(first_layer="slice_twin", **TINY)
    assert spec.first_layer == "slice_twin"
    rr = _cpu(spec).run()
    base = _cpu(spec.replace(first_layer="slice")).run()
    assert rr.metrics == base.metrics
    assert _params_equal(rr.params, base.params)
    assert len(calls) == rr.telemetry.steps + spec.rounds + 1
    with pytest.raises(ValueError, match="exchange_at=0"):
        _cpu(spec.replace(exchange_at=0)).run()


def test_run_result_schema_and_serialization():
    sess = _cpu(ExperimentSpec(dataset="titanic", rounds=1, epochs=1))
    rr = sess.run()
    assert isinstance(rr, RunResult)
    assert rr.schema_version == RESULT_SCHEMA_VERSION == 5
    assert rr.spec_hash == rr.spec.spec_hash and len(rr.spec_hash) == 16
    d = json.loads(json.dumps(rr.to_dict()))
    assert d["schema_version"] == 5 and d["spec"]["dataset"] == "titanic"
    assert {"metrics", "history", "timings", "git_sha", "spec_hash",
            "telemetry", "resumed_from"} <= set(d)
    assert "params" not in d
    assert set(d["timings"]) == {"wall_s", "steps_per_sec"}
    tel = d["telemetry"]
    assert tel["steps"] == sess.federation.n_batches
    assert tel["fault"] is tel["wire"] is tel["series"] is None
    assert len(d["history"][0]["round_losses"]) == tel["steps"]
    preds = sess.predict(np.zeros((4, 9), np.float32))
    assert tuple(preds.shape) == (3, 4)
    padded = _cpu(ExperimentSpec(dataset="titanic", rounds=1, epochs=1,
                                 n_clients=3, max_clients=5))
    padded.run()
    assert tuple(padded.predict(np.zeros((4, 9), np.float32)).shape) == \
        (3, 4)
    with pytest.raises(ValueError, match="predict"):
        _cpu(ExperimentSpec(dataset="titanic")).predict(np.zeros((1, 9)))


def test_train_federation_shim_warns_and_matches_train():
    kw = dict(seed=2, **TINY)
    with pytest.warns(DeprecationWarning, match="ExperimentSpec"):
        out = train_federation(device="cpu", **kw)
    legacy = DeVertiFL(ProtocolConfig(**kw), device="cpu").train()
    assert out["final"] == legacy["final"]
    np.testing.assert_array_equal(
        np.concatenate([h["round_losses"] for h in out["history"]]),
        np.concatenate([h["round_losses"] for h in legacy["history"]]))
    assert _params_equal(out["params"], legacy["params"])


def test_deferred_entry_points_name_their_queue_item():
    """The entry points once deferred run: server()/serve() refuse only
    as the reference does (before run()), and obs="full" builds a
    Session with an armed tracer."""
    spec = ExperimentSpec(**TINY)
    sess = _cpu(spec)
    with pytest.raises(ValueError, match="before run"):
        sess.server()
    with pytest.raises(ValueError, match="before run"):
        sess.serve([])
    full = ExperimentSpec(**TINY, obs="full")
    assert full.obs == "full" and full.spec_hash == spec.spec_hash
    assert _cpu(full).tracer.active and not sess.tracer.active
    # a RetryPolicy runs now (repro_torch.faults); anything else is
    # refused as the reference refuses it
    with pytest.raises(TypeError, match="RetryPolicy"):
        sess.run(retry=object())
    with pytest.raises(TypeError, match="RetryPolicy"):
        _cpu(_ckpt("/nonexistent", 1)).resume(retry=object())


def test_build_needs_cuda_unless_told_otherwise():
    spec = ExperimentSpec(**TINY)
    if torch.cuda.is_available():
        assert build(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(spec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(spec.replace(mode="splitnn"))
    with pytest.raises(TypeError, match="ExperimentSpec"):
        build(ProtocolConfig(), device="cpu")
