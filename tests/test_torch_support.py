"""Shared pieces of the port's tests (``tests/test_torch_*.py``): the
reference import and the runs that feed both packages the same inputs.

The JAX package's protocol stack imports ``jax.core.Primitive``, which
jax 0.9 moved to ``jax.extend.core``; its auditor reads ``ClosedJaxpr``,
``Jaxpr``, ``Literal`` and ``DropVar`` (in ``jax._src.core``) too.  ``reference()``
sets those names, imports the reference, and on exit removes the names
and every ``repro`` module it imported, so the modules that other test
files see are exactly those they would have seen without it.

Two more patches let the reference's auditor read a jax 0.9 jaxpr, both
undone on exit: jax 0.9 names the ``pjit`` primitive ``jit``, which
``repro.analysis.ir.INLINE_CALLS`` lacks (every call would fall to the
conservative default rule), and lowers a split to a ``split`` primitive
the taint interpreter has no rule for (``_split_rule`` cuts a per-slot
taint along the split axis as ``_slice`` does).  Without them the
reference reports a false ``cross-client-flow`` for every optimizer
leaf.  Test files use it
from a module-scoped fixture, never at import time: the test workers
import every file, and a shim applied then would change how later
files are collected.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

_REFERENCE_MODULES = {
    "protocol": "repro.core.protocol",
    "exchange": "repro.core.exchange",
    "partition": "repro.core.partition",
    "data": "repro.data.registry",
    "synthetic": "repro.data.synthetic",
    "metrics": "repro.metrics.classification",
    "kernels": "repro.kernels.vfl_matmul",
    "optim": "repro.optim.optimizers",
    "mlp": "repro.models.mlp_model",
    "configs": "repro.configs",
    "reduced": "repro.configs.reduced",
    "layers": "repro.models.layers",
    "attention": "repro.models.attention",
    "transformer": "repro.models.transformer",
    "lm": "repro.models.model",
    "engine": "repro.serving.engine",
    "serve": "repro.launch.serve",
    "flash": "repro.kernels.flash_attention",
    "moe": "repro.models.moe",
    "router": "repro.kernels.moe_router",
    "ssm": "repro.models.ssm",
    "rwkv6": "repro.kernels.rwkv6_scan",
    "mamba": "repro.kernels.mamba_scan",
    "api": "repro.api",
    "baselines": "repro.core.baselines",
    "checkpoint": "repro.checkpoint",
    "sweep": "repro.core.sweep",
    "schedule": "repro.schedule",
    "schedule_engine": "repro.schedule.engine",
    "faults": "repro.faults",
    "faults_engine": "repro.faults.engine",
    "wire": "repro.wire",
    "codecs": "repro.wire.codecs",
    "spec": "repro.api.spec",
    "session": "repro.api.session",
    "obs": "repro.obs",
    "federated": "repro.serving.federated",
    "train": "repro.launch.train",
    "lr_schedule": "repro.optim.schedule",
    "lm_data": "repro.data.lm",
    # the two dry runs set XLA_FLAGS when imported: reference() imports
    # them after the backend is up and restores the variable
    "specs": "repro.launch.specs",
    "dryrun": "repro.launch.dryrun",
    "dryrun_federated": "repro.launch.dryrun_federated",
    "roofline_analysis": "repro.roofline.analysis",
    "hlo_costs": "repro.roofline.hlo_costs",
    "analysis": "repro.analysis",
    "analysis_audit": "repro.analysis.audit",
    "analysis_ir": "repro.analysis.ir",
    "analysis_taint": "repro.analysis.taint",
    "analysis_deadness": "repro.analysis.deadness",
    "analysis_retrace": "repro.analysis.retrace",
    "analysis_report": "repro.analysis.report",
}

# names the JAX package reads from ``jax.core`` that jax 0.9 keeps only
# in ``jax.extend.core`` (``DropVar`` only in ``jax._src.core``):
# Primitive for the protocol stack, the others for the auditor
# (``repro/analysis/ir.py``, ``taint.py``)
_CORE_NAMES = ("Primitive", "ClosedJaxpr", "Jaxpr", "Literal", "DropVar")


def _forget(before):
    for name in sorted(set(sys.modules) - before, reverse=True):
        if name != "repro" and not name.startswith("repro."):
            continue
        mod = sys.modules.pop(name)
        parent, _, child = name.rpartition(".")
        if getattr(sys.modules.get(parent), child, None) is mod:
            delattr(sys.modules[parent], child)


@contextlib.contextmanager
def reference():
    """The JAX package's modules (a namespace) under the jax 0.9 shim,
    with torch on one thread for the small shapes these tests use."""
    before = set(sys.modules)
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        import jax
        import jax._src.core
        import jax.extend
        for name in _CORE_NAMES:
            mp.setattr(jax.core, name, getattr(
                jax.extend.core, name, getattr(jax._src.core, name)),
                raising=False)
        torch.set_num_threads(1)
        # repro.launch.dryrun sets XLA_FLAGS to 512 host devices when
        # imported (dryrun.py:8); with the backend already up that
        # changes no device count here, and the variable is restored
        # before any test runs
        jax.devices()
        try:
            with pytest.MonkeyPatch.context() as env:
                # records the variable (or its absence) for the undo
                env.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
                ns = {k: importlib.import_module(v)
                      for k, v in _REFERENCE_MODULES.items()}
            _patch_auditor(mp, ns)
            yield types.SimpleNamespace(jax=jax, jnp=jax.numpy, **ns)
        finally:
            torch.set_num_threads(threads)
            _forget(before)


def _split_rule(taint, rule):
    """The reference taint interpreter's ``rule`` with a rule for jax
    0.9's ``split``: a per-slot taint on the split axis is cut by
    ``sizes``; any other taint passes to every piece."""
    def patched(self, eqn, in_abs, in_conc):
        if eqn.primitive.name != "split":
            return rule(self, eqn, in_abs, in_conc)
        a, axis = in_abs[0], eqn.params["axis"]
        sizes = eqn.params["sizes"]
        if a.axis != axis:
            return [a] * len(sizes)
        starts = np.cumsum((0,) + tuple(sizes))
        return [taint.perslot(axis, a.bits[s:s + n].copy())
                for s, n in zip(starts, sizes)]
    return patched


def _patch_auditor(mp, ns):
    ir, taint = ns["analysis_ir"], ns["analysis_taint"]
    mp.setattr(ir, "INLINE_CALLS", tuple(ir.INLINE_CALLS) + ("jit",))
    mp.setattr(taint.TaintInterpreter, "rule",
               _split_rule(taint, taint.TaintInterpreter.rule))


def chip_smoke():
    """chip_smoke.py as a module: its checks (``attn_excess``,
    ``route_reading``, ``route_ok``) and limits are the kernels' contract
    on the card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def to_np(tree):
    """A JAX tree as numpy (copies, so donated buffers cannot alias)."""
    import jax
    return jax.tree.map(lambda a: np.array(a), tree)


def reference_run(ref, **kw):
    """Train the reference ``DeVertiFL`` and return what the port needs
    to replay it: the initial weights, every round's batch-index matrix,
    the per-step losses, the final weights and test predictions."""
    jax = ref.jax
    fed = ref.protocol.DeVertiFL(ref.protocol.ProtocolConfig(**kw))
    init_key, loop_key = ref.protocol.train_keys(
        jax.random.PRNGKey(fed.pcfg.seed))
    init = to_np(fed.init_params(init_key))
    idx = [np.asarray(fed._perms(jax.random.fold_in(loop_key, r)))
           for r in range(fed.pcfg.rounds)]
    out = fed.train()
    params = out["params"]
    return types.SimpleNamespace(
        fed=fed, init=init, idx=idx,
        losses=[np.asarray(h["round_losses"]) for h in out["history"]],
        params=to_np(params), final=out["final"],
        preds=np.asarray(fed.predict(params, fed.xte)))


def port_run(init, idx, device="cpu", **kw):
    """Replay rounds in the port from given initial weights and batch
    indices; returns (federation, per-round losses, final params)."""
    from repro_torch.core.protocol import DeVertiFL, ProtocolConfig
    from repro_torch.interop import params_from_numpy
    fed = DeVertiFL(ProtocolConfig(**kw), device=device)
    params = params_from_numpy(init, device)
    opt_state = fed.opt.init(params)
    step, losses = 0, []
    for round_idx in idx:
        params, opt_state, step, round_losses = fed.run_round(
            params, opt_state, step, round_idx)
        losses.append(round_losses.cpu().numpy())
    return fed, losses, params


# per-step losses of the port against the reference, from the same
# weights and batches: float32 in another summation order, compounded
# over two rounds of Adam (measured on the CPU: at most 2.7e-7)
LOSS_RTOL = 2e-6


def assert_replays(ref_run, fed, losses, params, min_agree=0.995,
                   f1_tol=0.002):
    """The port's replay of a reference run agrees with it: every
    per-step loss, the test predictions and the final F1."""
    for ours, theirs in zip(losses, ref_run.losses, strict=True):
        np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL, atol=0)
    n = fed.pcfg.n_clients
    preds = fed.predict(params, fed.xte).cpu().numpy()[:n]
    agree = float((preds == ref_run.preds[:n]).mean())
    assert agree >= min_agree, agree
    f1 = fed.evaluate(params)["f1"]
    assert abs(f1 - ref_run.final["f1"]) <= f1_tol, (f1, ref_run.final)
    return agree, f1


def test_reference_leaves_modules_as_it_found_them():
    import jax
    before = set(sys.modules)
    had = {name: name in vars(jax.core) for name in _CORE_NAMES}
    with reference() as ref:
        assert ref.protocol.DeVertiFL is not None
        assert "repro.core.protocol" in sys.modules
        assert "jit" in ref.analysis_ir.INLINE_CALLS
        taint_cls = ref.analysis_taint.TaintInterpreter
        assert "rule" in vars(taint_cls)
        patched_rule = taint_cls.rule
    assert {name: name in vars(jax.core) for name in _CORE_NAMES} == had
    # the auditor's patches are undone on the modules themselves too
    assert "jit" not in ref.analysis_ir.INLINE_CALLS
    assert taint_cls.rule is not patched_rule
    added = {m for m in set(sys.modules) - before
             if m == "repro" or m.startswith("repro.")}
    assert not added, sorted(added)


class RefDraws:
    """A round's draws backed by the reference's own: its participation
    coins (``participation_mask``'s per-client bernoulli), fault coins
    (``_fault_coins``) and ``dp_noise`` on the reference's round key
    ``rkey``, for ``n`` client slots.  The port's impls take it in
    place of ``CounterDraws.round(r)``, as the replays take the
    reference's inits and batch indices."""

    def __init__(self, ref, rkey, n):
        self.ref, self.rkey, self.n = ref, rkey, n

    def coins(self, tag, kind, p):
        jax, jnp = self.ref.jax, self.ref.jnp
        p = float(torch.as_tensor(p).reshape(-1)[0])
        fe = self.ref.faults_engine
        if tag == fe.FAULT_TAG:
            c = fe._fault_coins(self.rkey, kind, self.n, p)
        elif tag == self.ref.schedule_engine.PARTICIPATION_TAG:
            pkey = jax.random.fold_in(self.rkey, tag)
            c = jax.vmap(lambda i: jax.random.bernoulli(
                jax.random.fold_in(pkey, i), p))(
                    jnp.arange(self.n, dtype=jnp.int32))
        else:           # a federation-wide coin (a custom plan's)
            c = jnp.full((self.n,), jax.random.bernoulli(
                jax.random.fold_in(self.rkey, tag), p))
        return torch.as_tensor(np.array(c, np.float32))

    def normal(self, tag, step, shape):
        jax = self.ref.jax
        key = jax.random.fold_in(jax.random.fold_in(self.rkey, tag),
                                 int(step))
        return torch.as_tensor(np.array(self.ref.codecs.dp_noise(
            key, self.n, tuple(shape))))

    def lane_key(self, tag):
        return np.asarray(self.ref.jax.random.fold_in(self.rkey, tag))


def reference_engine_run(ref, **kw):
    """``reference_run`` for a federation with an engine impl (a
    schedule, fault plan or transform): the reference's scanned rounds
    driven one by one, so the carried state comes back too.  Returns
    also each round's key (what ``RefDraws`` takes) and the fault and
    wire telemetry of the final state."""
    jax = ref.jax
    fed = ref.protocol.DeVertiFL(ref.protocol.ProtocolConfig(**kw))
    init_key, loop_key = ref.protocol.train_keys(
        jax.random.PRNGKey(fed.pcfg.seed))
    params = fed.init_params(init_key)
    init = to_np(params)
    opt_state = jax.vmap(fed.opt.init)(params)
    step = jax.numpy.zeros((), jax.numpy.int32)
    sched = fed.init_sched_state()
    keys, idx, losses = [], [], []
    for r in range(fed.pcfg.rounds):
        rkey = jax.random.fold_in(loop_key, r)
        keys.append(rkey)
        idx.append(np.asarray(fed._perms(rkey)))
        params, opt_state, step, sched, lr = fed._round(
            params, opt_state, step, sched, rkey, fed._xtr, fed._ytr,
            fed._lay)
        losses.append(np.asarray(lr))
    return types.SimpleNamespace(
        fed=fed, init=init, idx=idx, keys=keys, losses=losses,
        params=to_np(params), sched=to_np(sched),
        fault=fed.fault_telemetry(sched), wire=fed.wire_telemetry(sched),
        preds=np.asarray(fed.predict(params, fed.xte)))


def port_engine_run(ref, ref_run, device="cpu", **kw):
    """Replay ``reference_engine_run``'s rounds in the port from its
    inits, batch indices and draws (``RefDraws``).  Returns (federation,
    per-round losses, final params, final engine state)."""
    from repro_torch.core.protocol import DeVertiFL, ProtocolConfig
    from repro_torch.interop import params_from_numpy
    fed = DeVertiFL(ProtocolConfig(**kw), device=device)
    params = params_from_numpy(ref_run.init, device)
    opt_state = fed.opt.init(params)
    sched, step, losses = fed.init_sched_state(), 0, []
    n = fed.pcfg.padded_clients
    for rkey, round_idx in zip(ref_run.keys, ref_run.idx, strict=True):
        params, opt_state, step, sched, lr = fed.run_round(
            params, opt_state, step, round_idx, sched,
            RefDraws(ref, rkey, n))
        losses.append(lr.cpu().numpy())
    return fed, losses, params, sched


def assert_engine_replays(ref_run, fed, losses, params, sched):
    """Per-step losses within LOSS_RTOL, predictions and fault and wire
    counters exactly equal; returns the largest relative loss
    difference seen."""
    worst = 0.0
    for ours, theirs in zip(losses, ref_run.losses, strict=True):
        np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL, atol=0)
        worst = max(worst, float(np.max(np.abs(ours - theirs)
                                        / np.abs(theirs))))
    n = fed.pcfg.n_clients
    preds = fed.predict(params, fed.xte).cpu().numpy()[:n]
    np.testing.assert_array_equal(preds, ref_run.preds[:n])
    for ours, theirs in ((fed.fault_telemetry(sched), ref_run.fault),
                         (fed.wire_telemetry(sched), ref_run.wire)):
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert {k: int(v) for k, v in ours.items()} == \
                {k: int(v) for k, v in theirs.items()}
    return worst


def engine_traj(device="cpu", **kw):
    """Train the port's ``DeVertiFL(ProtocolConfig(**kw))``, returning
    every step's loss (one array), the final metrics, the federation
    and its final engine state."""
    from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                           round_generator,
                                           train_generators)
    fed = DeVertiFL(ProtocolConfig(**kw), device=device)
    seed = fed.pcfg.seed
    params, opt_state = fed.start(fed.init_params(train_generators(seed)[0]))
    sched, step, losses = fed.init_sched_state(), 0, []
    draws = fed.draws()
    for r in range(fed.pcfg.rounds):
        params, opt_state, step, sched, lr = fed.run_round(
            params, opt_state, step, fed.perms(round_generator(seed, r)),
            sched, draws.round(r))
        losses.append(lr.cpu().numpy())
    return (np.concatenate(losses), fed.evaluate(params), fed, sched)


def audit_grid(engine: bool):
    """The reference's default audit grid at 3 clients (38 mode x
    schedule x first-layer x fault x transform combos on mnist; the
    port's ``default_combos`` builds it by the same arithmetic), split
    in two for two test files: the combos with a fault plan or a wire
    transform (``engine``), or the others."""
    from repro_torch.analysis.audit import default_combos
    return [c for c in default_combos(device="cpu")
            if (c[3] != "none" or c[4] != "none") == engine]


def combo_id(combo) -> str:
    from repro_torch.analysis.audit import combo_name
    from repro_torch.core.protocol import ProtocolConfig
    return combo_name(ProtocolConfig(**_combo_kw(combo)))


def _combo_kw(combo):
    mode, schedule, first_layer, fault, transform = combo
    return dict(dataset="mnist", n_clients=3, mode=mode, schedule=schedule,
                first_layer=first_layer, fault=fault, transform=transform)


def assert_audits_alike(ref, combo):
    """One combo audits clean in the port and in the reference, with
    the same set of channels seen; the reference's ``pallas`` lane is
    the port's ``kernel`` lane.  Channel counts are not compared: the
    port unrolls the round's Python loop over batches where the
    reference traces one ``lax.scan`` body, and the port's backward
    re-tags a declared channel's cotangent wherever autograd runs it."""
    from repro_torch.analysis.audit import audit
    from repro_torch.core.protocol import ProtocolConfig
    kw = _combo_kw(combo)
    ref_kw = {**kw, "first_layer": {"kernel": "pallas"}.get(
        kw["first_layer"], kw["first_layer"])}
    theirs = ref.analysis_audit.audit(ref.protocol.ProtocolConfig(**ref_kw),
                                      lane_check=False)
    ours = audit(ProtocolConfig(**kw), lane_check=False, device="cpu")
    assert theirs.ok, theirs.summary()
    assert ours.ok, ours.summary()
    assert set(ours.channels) == set(theirs.channels), (ours.channels,
                                                        theirs.channels)
    assert ours.static_round_traces == theirs.static_round_traces == 1
