"""The port's npz checkpoints (``repro_torch.checkpoint``): padded trees
and NamedTuple nodes round-trip; the keys are the JAX package's, so a
Session checkpoint written by one package loads, leaf for leaf, in the
other and resumes there; corrupt files raise CheckpointCorruptError."""
import os
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentSpec, build
from repro_torch.checkpoint import (CheckpointCorruptError,
                                    checkpoint_steps, latest_step,
                                    load_checkpoint, load_entry,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import partition as PT
from repro_torch.models.mlp_model import PaperMLP
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves
from test_torch_support import reference, to_np


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _padded_tree():
    model = PaperMLP(get_config("paper-mlp-titanic"), 8)
    params = model.init_params(torch.Generator().manual_seed(0))
    lay = PT.make_layout("titanic", 9, 3, seed=0, max_clients=8).arrays(
        "cpu")
    return {"params": params, "opt_state": adam(1e-3).init(params),
            "lay": lay, "step_idx": np.zeros((), np.int32),
            "empty": torch.zeros((0, 5)), "sched": {}}


def _leaves(tree):
    """Every leaf of a dict / NamedTuple tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for c in tree for x in _leaves(c)]
    return [tree]


def test_roundtrips_padded_trees(tmp_path):
    """Padded per-client params, Adam moments, the LayoutArrays
    NamedTuple, a 0-d int32, an empty tensor and an empty subtree
    round-trip: values, dtypes, devices and structure."""
    tree = _padded_tree()
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    restored = load_checkpoint(str(tmp_path), 3, tree)
    assert type(restored["lay"]) is type(tree["lay"])
    assert restored["sched"] == {}
    for a, b in zip(_leaves(tree), _leaves(restored), strict=True):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    bad_like = dict(tree, params=PaperMLP(get_config("paper-mlp-titanic"),
                                          6).init_params(
        torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="padded"):
        load_checkpoint(str(tmp_path), 3, bad_like)
    with pytest.raises(ValueError, match="no entry"):
        load_checkpoint(str(tmp_path), 3, dict(tree, extra=np.zeros(2)))


def test_keys_are_the_references(ref, tmp_path):
    """The same tree written by each package holds the same keys and
    values: sorted dict keys, NamedTuple attribute names, sequence
    indices; an empty subtree and None write nothing."""
    tree = _padded_tree()
    tree["seq"] = [np.arange(3), (np.ones(2), None)]
    ours = save_checkpoint(str(tmp_path / "port"), 1, tree)
    jtree = ref.jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, tree)
    jtree["lay"] = ref.partition.make_layout(
        "titanic", 9, 3, seed=0, max_clients=8).arrays()
    theirs = ref.checkpoint.save_checkpoint(str(tmp_path / "ref"), 1, jtree)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "lay/client_mask" in a.files and "seq/1/0" in a.files
        assert not any(k.startswith("sched") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


TINY = dict(dataset="titanic", n_clients=3, epochs=1, seeds=(0,),
            first_layer="slice")


def test_reference_session_checkpoint_loads_in_port(ref, tmp_path):
    """A reference Session's checkpoint loads into the port's like tree
    leaf for leaf, and the port resumes from it: the spec hashes agree,
    so the resume_hash and stream stamps pass."""
    d = str(tmp_path / "ckpt")
    rr = ref.api.build(ref.api.ExperimentSpec(
        rounds=2, checkpoint_dir=d, checkpoint_every=1, **TINY)).run()
    sess = build(ExperimentSpec(rounds=3, checkpoint_dir=d,
                                checkpoint_every=1, **TINY), device="cpu")
    fed = sess.federation
    like = {"params": fed.model.params(),
            "opt_state": fed.opt.init(fed.model.params()),
            "step_idx": np.zeros((), np.int32), "sched": {}}
    ours = load_checkpoint(d, 2, like, name="session")
    theirs = to_np(ref.checkpoint.load_checkpoint(
        d, 2, {"params": rr.params,
               "opt_state": ref.jax.vmap(ref.optim.adam(1e-3).init)(
                   rr.params),
               "step_idx": ref.jnp.zeros((), ref.jnp.int32),
               "sched": {}}, name="session"))
    assert int(ours["step_idx"]) == int(theirs["step_idx"]) == \
        2 * fed.n_batches
    for a, b in zip(tree_leaves({"p": ours["params"],
                                 "o": ours["opt_state"]}),
                    ref.jax.tree.leaves({"p": theirs["params"],
                                         "o": theirs["opt_state"]}),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        ours["params"]["layer_0"]["kernel"].numpy(),
        np.asarray(rr.params["layer_0"]["kernel"]))
    res = sess.resume()
    assert res.resumed_from == 2
    assert [h["round"] for h in res.history] == [2]
    assert np.isfinite(res.history[0]["round_losses"]).all()


def test_port_session_checkpoint_loads_in_reference(ref, tmp_path):
    """A port Session's checkpoint loads with the reference's
    load_checkpoint into the reference's like tree, leaf for leaf, and
    the reference resumes from it."""
    d = str(tmp_path / "ckpt")
    rr = build(ExperimentSpec(rounds=2, checkpoint_dir=d,
                              checkpoint_every=1, **TINY),
               device="cpu").run()
    spec = ref.api.ExperimentSpec(rounds=3, checkpoint_dir=d,
                                  checkpoint_every=1, **TINY)
    rsess = ref.api.build(spec)
    fed = rsess.federation
    init_key, _ = ref.protocol.train_keys(ref.jax.random.PRNGKey(0))
    params_like = fed.init_params(init_key)
    like = {"params": params_like,
            "opt_state": ref.jax.vmap(fed.opt.init)(params_like),
            "step_idx": ref.jnp.zeros((), ref.jnp.int32), "sched": {},
            "resume_hash": np.zeros(8, np.uint8),
            "schedule_hash": np.zeros(8, np.uint8)}
    theirs = to_np(ref.checkpoint.load_checkpoint(d, 2, like,
                                                  name="session"))
    assert theirs["step_idx"].dtype == np.int32
    assert bytes(theirs["resume_hash"]).hex() == spec.resume_hash
    for a, b in zip(tree_leaves(rr.params),
                    ref.jax.tree.leaves(theirs["params"]), strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    res = rsess.resume()
    assert res.resumed_from == 2 and len(res.history) == 1


def test_corrupt_missing_and_absent(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    assert checkpoint_steps(d) == [] and latest_step(d) is None
    assert checkpoint_steps(str(tmp_path / "none")) == []
    path = save_checkpoint(d, 1, tree)
    save_checkpoint(d, 12, tree)
    assert checkpoint_steps(d) == [1, 12]
    assert load_entry(d, 1, "nope") is None
    np.testing.assert_array_equal(load_entry(d, 1, "w"),
                                  tree["w"].numpy())
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(CheckpointCorruptError, match="corrupt"):
        load_checkpoint(d, 1, tree)
    with pytest.raises(CheckpointCorruptError):
        load_entry(d, 1, "w")
    with open(os.path.join(d, "state_00000003.npz"), "w") as f:
        f.write("not an npz")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 3, tree)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, 4, tree)
    # a member whose bytes are damaged inside an intact archive
    with zipfile.ZipFile(os.path.join(d, "state_00000012.npz")) as z:
        info = z.infolist()[0]
    with open(os.path.join(d, "state_00000012.npz"), "r+b") as f:
        f.seek(info.header_offset + 30 + len(info.filename) + 80)
        f.write(b"\xff" * 16)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 12, tree)


@pytest.mark.cuda
def test_loads_onto_the_like_leafs_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree = {"w": torch.arange(6.0, device="cuda"),
            "n": np.arange(2, dtype=np.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    out = load_checkpoint(str(tmp_path), 1, tree)
    assert out["w"].device.type == "cuda" and isinstance(out["n"],
                                                          np.ndarray)
    assert torch.equal(out["w"], tree["w"])
