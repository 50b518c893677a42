"""The port's static auditor (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU: the planted leaky first
layer flags the same outputs in both, the padded deadness cases are
clean in both and a FedAvg term without its mask is flagged in both, and
the five lane cases are clean in both.  The reference's auditor runs
under the jax 0.9 patches of ``test_torch_support.reference()``.

The grid (every combo of the reference's default grid at 3 clients) is
in ``test_torch_analysis_grid.py`` and
``test_torch_analysis_grid_engine.py``."""
from __future__ import annotations

import pytest

from repro_torch.analysis import retrace as RT
from repro_torch.analysis import tag
from repro_torch.analysis.audit import audit
from repro_torch.core.protocol import ProtocolConfig, register_first_layer
from repro_torch.tree import tree_map
from test_torch_support import reference

TRACE = dict(dataset="mnist", n_clients=3)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _labels(report, code):
    """The output labels of a report's findings of one code."""
    return {f.message.split(":")[0] for f in report.violations
            if f.code == code}


# ---------------------------------------------------------------------------
# the planted leak: the whole raw batch's mean added to every client's
# first-layer output
# ---------------------------------------------------------------------------
def _ref_leaky(ref):
    jax, jnp = ref.jax, ref.jnp

    def make(model, pcfg, layout):
        sizes = layout.sizes

        def first(params, xb, lay):
            w, b = params["layer_0"]["kernel"], params["layer_0"]["bias"]
            outs = []
            for i, f_i in enumerate(sizes):
                x_i = jax.lax.dynamic_slice(xb, (0, lay.offsets[i]),
                                            (xb.shape[0], f_i))
                w_i = jax.lax.dynamic_slice(w[i], (lay.offsets[i], 0),
                                            (f_i, w.shape[-1]))
                outs.append(jax.nn.relu(x_i @ w_i + b[i]) + xb.mean())
            return jnp.stack(outs)
        return first
    return make


def _port_leaky(model, pcfg, layout):
    import torch
    offsets, sizes = layout.offsets, layout.sizes

    def first(params, xb, lay):
        w, b = params["layer_0"]["kernel"], params["layer_0"]["bias"]
        return torch.stack([
            torch.relu(xb[:, o:o + f] @ w[i, o:o + f] + b[i]) + xb.mean()
            for i, (o, f) in enumerate(zip(offsets, sizes))])
    return first


def test_planted_leak_flags_the_same_outputs(ref):
    if "leaky_parity" not in ref.protocol.FIRST_LAYERS.names():
        ref.protocol.register_first_layer("leaky_parity", _ref_leaky(ref))
    from repro_torch.core.protocol import FIRST_LAYERS
    if "leaky_parity" not in FIRST_LAYERS.names():
        register_first_layer("leaky_parity", _port_leaky)
    theirs = ref.analysis_audit.audit(ref.protocol.ProtocolConfig(
        first_layer="leaky_parity", **TRACE), passes=("taint",))
    ours = audit(ProtocolConfig(first_layer="leaky_parity", **TRACE),
                 passes=("taint",), device="cpu")
    want = _labels(theirs, "cross-client-flow")
    assert want, theirs.summary()
    assert _labels(ours, "cross-client-flow") == want
    # FedAvg declassifies the parameters: only the optimizer state leaks
    assert all(label.startswith("opt_state") for label in want)


# ---------------------------------------------------------------------------
# deadness over padded client axes
# ---------------------------------------------------------------------------
DEAD_CASES = [dict(n_clients=1, max_clients=3),
              dict(n_clients=2, max_clients=4, schedule="stale_k:2"),
              dict(n_clients=2, max_clients=4, schedule="partial:0.5:det")]


@pytest.mark.parametrize("case", DEAD_CASES,
                         ids=lambda c: f"{c['n_clients']}of"
                                       f"{c['max_clients']}-"
                                       f"{c.get('schedule', 'sync')}")
def test_padded_deadness_is_clean_in_both(ref, case):
    kw = dict(dataset="mnist", first_layer="masked", **case)
    theirs = ref.analysis_audit.audit(ref.protocol.ProtocolConfig(**kw),
                                      passes=("deadness",))
    ours = audit(ProtocolConfig(**kw), passes=("deadness",), device="cpu")
    assert theirs.ok, theirs.summary()
    assert ours.ok, ours.summary()
    for rep in (theirs, ours):
        assert not [f for f in rep.findings
                    if f.code == "no-terms-observed"]


def _ref_unmasked(ref):
    jax, jnp, rtag = ref.jax, ref.jnp, ref.analysis.tag

    def fedavg(stacked, client_mask=None):
        def avg(leaf):
            term = rtag(leaf, "term", "fedavg", client_axis=0)
            m = rtag(term.sum(0, keepdims=True) / client_mask.sum(),
                     "declass", "fedavg")
            return jnp.broadcast_to(m, leaf.shape)
        return jax.tree.map(avg, stacked)
    return fedavg


def _port_unmasked(stacked, client_mask=None):
    def avg(leaf):
        term = tag(leaf, "term", "fedavg", client_axis=0)
        m = tag(term.sum(0, keepdim=True) / client_mask.sum(), "declass",
                "fedavg")
        return m.expand_as(leaf)
    return tree_map(avg, stacked)


def test_a_fedavg_term_without_its_mask_is_flagged_in_both(ref,
                                                          monkeypatch):
    import repro_torch.core.protocol as P
    monkeypatch.setattr(ref.protocol, "fedavg", _ref_unmasked(ref))
    monkeypatch.setattr(P, "fedavg", _port_unmasked)
    kw = dict(dataset="mnist", first_layer="masked", n_clients=2,
              max_clients=3)
    theirs = ref.analysis_audit.audit(ref.protocol.ProtocolConfig(**kw),
                                      passes=("deadness",))
    ours = audit(ProtocolConfig(**kw), passes=("deadness",), device="cpu")
    for rep in (theirs, ours):
        assert {f.code for f in rep.violations} == {"unproven-dead-slot"}, \
            rep.summary()


# ---------------------------------------------------------------------------
# the lane check
# ---------------------------------------------------------------------------
def test_lane_cases_are_clean_in_both(ref):
    # the same five cases (RT.LANE_CASES mirrors the reference's list):
    # client count 2 vs 3, seed 0 vs 1, stale/partial lanes, fault lanes
    # and straggle rings, each pair tracing to one round body; the port
    # on its slice lane (the kernel's plain version reads offsets on the
    # host), as the reference
    assert not ref.analysis_retrace.run_lane_check("mnist")
    assert not RT.run_lane_check("mnist", "cpu")
