"""The port's static auditor (``repro_torch.analysis``) on its own, on the
CPU: the tag barrier, each taint rule on a small traced graph (the
``vfl_matmul_clients`` kernel op with its offsets folded and not), the
two guards this way of tracing needs (``opaque-write``, ``host-read``),
the planted faults the chip's ``audit`` phase also plants (a leaky first
layer, a FedAvg term without its mask, a carried leaf cast to float64, a
lane first layer that branches on its lane's client count), the traced
round bitwise an untraced one, and the CLI."""
from __future__ import annotations

import ctypes
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit, audit_tracing, auditing, ir, tag
from repro_torch.analysis import retrace as RT
from repro_torch.analysis import taint as TA
from repro_torch.analysis.audit import (TracedRound, audit_combos,
                                        combo_name, default_combos)
from repro_torch.core.protocol import (ProtocolConfig, make_first_layer_fn,
                                       register_first_layer)
from repro_torch.tree import tree_leaves, tree_map

TRACE = dict(n_samples=32, batch_size=16, epochs=1, rounds=1)
SLOTS = np.array([1, 2, 4], np.int64)


def _pcfg(**kw):
    base = dict(dataset="mnist", mode="devertifl", schedule="sync",
                first_layer="slice", n_clients=3)
    base.update(kw)
    return ProtocolConfig(**base)


def _taint(fn, args, seeds, n=3):
    """Trace ``fn(*args)`` and run the taint pass from ``seeds`` (one a
    tensor argument); returns (output taints, interpreter)."""
    tg = ir.trace_round(fn, tuple(args))
    interp = TA.TaintInterpreter(n_slots_hint=n)
    return interp.run(tg, seeds), interp


def _ops(fn, args):
    tg = ir.trace_round(fn, tuple(args))
    return [ir.op_name(n) for n in tg.gm.graph.nodes
            if n.op == "call_function"]


# ---------------------------------------------------------------------------
# the barrier
# ---------------------------------------------------------------------------
def test_tag_is_the_value_itself_outside_the_audit():
    x = torch.randn(3, 4)
    assert not auditing()
    assert tag(x, "declass", "exchange") is x
    ops = _ops(lambda v: tag(v * 2.0, "term", "exchange", client_axis=0),
               [x])
    assert "repro_torch.audit_tag" not in ops


@pytest.mark.parametrize("kind", ["declass", "term"])
def test_tag_in_the_audit_is_one_node_and_bitwise(kind):
    x = torch.randn(3, 4, dtype=torch.float32)
    w = torch.randn(4, 2)

    def f(x, w):
        xl = x.detach().requires_grad_()
        out = (tag(xl @ w, kind, "exchange", client_axis=0) ** 2).sum()
        return out, torch.autograd.grad(out, xl)[0]

    with audit_tracing():
        assert auditing()
        ops = _ops(f, [x, w])
        out_a, g_a = f(x, w)
    # the backward re-tags a declared channel's cotangent, not a term's
    assert ops.count("repro_torch.audit_tag") == (2 if kind == "declass"
                                                  else 1)
    out_b, g_b = f(x, w)
    assert torch.equal(out_a, out_b) and torch.equal(g_a, g_b)


# ---------------------------------------------------------------------------
# taint rules on small graphs
# ---------------------------------------------------------------------------
def _cols(owner):
    return TA.perslot(1, np.asarray([1 << o for o in owner], np.int64))


def test_bmm_keeps_the_client_batch_axis():
    x, w = torch.randn(3, 5, 4), torch.randn(3, 4, 2)
    (out,), _ = _taint(lambda x, w: torch.bmm(x, w), [x, w],
                       [TA.perslot(0, SLOTS), TA.perslot(0, SLOTS)])
    assert out.axis == 0 and out.bits.tolist() == [1, 2, 4]


def test_mm_contracting_owned_columns_mixes():
    x, w = torch.randn(5, 6), torch.randn(6, 2)
    (out,), _ = _taint(lambda x, w: x @ w, [x, w],
                       [_cols([0, 0, 1, 1, 2, 2]), TA.EMPTY])
    assert out.axis is None and out.bits == 7


def test_mask_multiply_reslots_columns_onto_clients():
    masks = torch.tensor([[1, 1, 0, 0, 0, 0], [0, 0, 1, 1, 0, 0],
                          [0, 0, 0, 0, 1, 1]], dtype=torch.float32)
    x = torch.randn(5, 6)
    (out,), _ = _taint(lambda x: x[None] * masks[:, None, :], [x],
                       [_cols([0, 0, 1, 1, 2, 2])])
    assert out.axis == 0 and out.bits.tolist() == [1, 2, 4]


def test_reductions_keep_or_collapse_the_slot_axis():
    x = torch.randn(3, 4, 5)
    (keep, gone), _ = _taint(lambda x: (x.sum(-1), x.mean(0)), [x],
                             [TA.perslot(0, SLOTS)])
    assert keep.axis == 0 and keep.bits.tolist() == [1, 2, 4]
    assert gone.axis is None and gone.bits == 7


def test_gather_and_index_select_over_concrete_indices_are_exact():
    x = torch.randn(6, 3)
    rows = torch.tensor([5, 0, 2])
    idx = torch.tensor([[2, 2, 2], [0, 0, 0], [1, 1, 1]])

    def f(x):
        return x.index_select(0, rows), torch.gather(x, 1, idx)
    (sel, gat), _ = _taint(f, [x], [TA.perslot(
        0, np.array([1, 1, 2, 2, 4, 4], np.int64))])
    assert sel.axis == 0 and sel.bits.tolist() == [4, 1, 2]
    assert gat.axis == 0 and gat.bits.tolist() == [1, 1, 2]


def test_scatter_add_and_select_backward_place_bits_in_their_slots():
    src = torch.randn(3, 4)
    index = torch.tensor([[2, 2, 2, 2], [0, 0, 0, 0], [1, 1, 1, 1]])
    w = torch.randn(3, 4)

    def f(src, w):
        scat = torch.zeros(3, 4).scatter_add(0, index, src)
        wl = w.detach().requires_grad_()
        (g,) = torch.autograd.grad((wl[1] * src[2]).sum(), wl)
        return scat, g
    (scat, g), _ = _taint(f, [src, w], [TA.perslot(0, SLOTS), TA.EMPTY])
    assert scat.axis == 0 and scat.bits.tolist() == [2, 4, 1]
    assert g.axis == 0 and g.bits.tolist() == [0, 4, 0]


def test_declass_clears_and_term_keeps():
    x = torch.randn(3, 4)

    def f(x):
        term = tag(x * 2.0, "term", "exchange", client_axis=0)
        return term, tag(term.sum(0), "declass", "exchange")
    with audit_tracing():
        (term, total), interp = _taint(f, [x], [TA.perslot(0, SLOTS)])
    assert term.axis == 0 and term.bits.tolist() == [1, 2, 4]
    assert TA.is_empty(total)
    assert interp.channels == {"exchange": 2}


def test_vfl_matmul_clients_op_with_folded_offsets():
    x, w = torch.randn(5, 6), torch.randn(3, 6, 2)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    sz = torch.tensor([2, 2, 2], dtype=torch.int32)
    op = torch.ops.repro_torch.vfl_matmul_clients

    def f(x, w):
        return op(x, w, off, off, sz)
    (out,), _ = _taint(f, [x, w], [_cols([0, 0, 1, 1, 2, 2]),
                                   TA.perslot(0, SLOTS)])
    assert out.axis == 0 and out.bits.tolist() == [1, 2, 4]
    # the client slices cross: y[0] reads client 1's columns
    cross = torch.tensor([2, 0, 4], dtype=torch.int32)
    (out,), _ = _taint(lambda x, w: op(x, w, cross, off, sz), [x, w],
                       [_cols([0, 0, 1, 1, 2, 2]), TA.EMPTY])
    assert out.axis == 0 and out.bits.tolist() == [2, 1, 4]


def test_vfl_matmul_clients_op_with_offsets_that_do_not_fold():
    x, w = torch.randn(5, 6), torch.randn(3, 6, 2)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    sz = torch.tensor([2, 2, 2], dtype=torch.int32)
    op = torch.ops.repro_torch.vfl_matmul_clients
    (out,), _ = _taint(lambda x, w, o: op(x, w, o, o, sz), [x, w, off],
                       [_cols([0, 0, 1, 1, 2, 2]), TA.perslot(0, SLOTS),
                        TA.EMPTY])
    assert out.axis is None and out.bits == 7


def test_the_kernel_op_matches_the_wrapper_on_the_cpu():
    from repro_torch.kernels.vfl_matmul import (vfl_matmul_clients,
                                                vfl_matmul_clients_ref)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(7, 9, generator=gen), torch.randn(3, 9, 4,
                                                         generator=gen)
    xo = torch.tensor([0, 3, 6], dtype=torch.int32)
    wo = torch.tensor([1, 0, 5], dtype=torch.int32)
    sz = torch.tensor([3, 2, 3], dtype=torch.int32)
    got = torch.ops.repro_torch.vfl_matmul_clients(x, w, xo, wo, sz)
    assert torch.equal(got, vfl_matmul_clients_ref(x, w, xo, wo, sz))
    assert torch.equal(got, vfl_matmul_clients(x, w, xo, wo, sz))
    meta = [t.to("meta") for t in (x, w, xo, wo, sz)]
    fake = torch.ops.repro_torch.vfl_matmul_clients(*meta)
    assert tuple(fake.shape) == (3, 7, 4) and fake.device.type == "meta"


# ---------------------------------------------------------------------------
# the guards of this way of tracing
# ---------------------------------------------------------------------------
def _opaque_fill(src):
    """A torch.empty filled through ctypes from ``src``: what a kernel
    launched outside the dispatcher does."""
    y = torch.empty(src.shape, dtype=src.dtype)
    ctypes.memmove(y.data_ptr(), src.contiguous().data_ptr(),
                   src.numel() * src.element_size())
    return y


def test_opaque_write_is_flagged():
    x = torch.randn(3, 4)
    (out,), interp = _taint(lambda x: _opaque_fill(x * 2.0) + 1.0, [x],
                            [TA.perslot(0, SLOTS)])
    codes = [f.code for f in interp.findings]
    assert codes == ["opaque-write"], codes
    # a torch.empty that recorded ops fill is not
    (out,), interp = _taint(
        lambda x: torch.empty(3, 4).copy_(x * 2.0) + 1.0, [x],
        [TA.perslot(0, SLOTS)])
    assert not interp.findings and out.bits.tolist() == [1, 2, 4]


def test_host_read_of_a_tainted_value_is_flagged():
    x = torch.randn(3, 4)
    (out,), interp = _taint(lambda x: x * float(x.sum()), [x],
                            [TA.perslot(0, SLOTS)])
    assert [f.code for f in interp.findings] == ["host-read"]
    (out,), interp = _taint(lambda x: x * float(x.sum()), [x], [TA.EMPTY])
    assert not interp.findings


# ---------------------------------------------------------------------------
# the round: clean, and the planted faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["masked", "slice", "kernel"])
def test_shipped_lanes_audit_clean(lane):
    rep = audit(_pcfg(first_layer=lane), lane_check=False, device="cpu")
    assert rep.ok, rep.summary()
    assert rep.channels["exchange"] and rep.channels["fedavg"]
    assert rep.static_round_traces == 1


def _make_leaky(model, pcfg, layout):
    offsets, sizes = layout.offsets, layout.sizes

    def first(params, xb, lay):
        w, b = params["layer_0"]["kernel"], params["layer_0"]["bias"]
        outs = []
        for i, (off, f_i) in enumerate(zip(offsets, sizes)):
            h = torch.relu(xb[:, off:off + f_i] @ w[i, off:off + f_i] + b[i])
            # THE LEAK: every client's hidden sees the whole raw batch
            outs.append(h + xb.mean())
        return torch.stack(outs)
    return first


def _register(name, make):
    from repro_torch.core.protocol import FIRST_LAYERS
    if name not in FIRST_LAYERS.names():
        register_first_layer(name, make)


def test_leaky_first_layer_is_flagged_with_its_chain():
    _register("leaky_test", _make_leaky)
    rep = audit(_pcfg(first_layer="leaky_test"), passes=("taint",),
                device="cpu")
    vio = [f for f in rep.violations if f.code == "cross-client-flow"]
    assert vio, rep.summary()
    assert "test_torch_analysis.py" in "\n".join(c for f in vio
                                                for c in f.chain)


def _make_opaque(model, pcfg, layout):
    plain = make_first_layer_fn(model, pcfg.replace(first_layer="slice"),
                                layout, torch.device("cpu"))

    def first(params, xb, lay):
        h = plain(params, xb, lay)
        # the values come through ctypes; the gradient still flows
        return _opaque_fill(h) + (h - h.detach())
    return first


def test_a_first_layer_filled_outside_the_dispatcher_is_flagged():
    _register("opaque_test", _make_opaque)
    rep = audit(_pcfg(first_layer="opaque_test"), passes=("taint",),
                device="cpu")
    assert "opaque-write" in {f.code for f in rep.violations}, rep.summary()


def unmasked_fedavg(stacked, client_mask=None):
    """FedAvg whose term leaves the mask out: dead slots' parameters
    enter the sum."""
    def avg(leaf):
        term = tag(leaf, "term", "fedavg", client_axis=0)
        m = tag(term.sum(0, keepdim=True) / client_mask.sum(), "declass",
                "fedavg")
        return m.expand_as(leaf)
    return tree_map(avg, stacked)


def test_a_fedavg_term_without_its_mask_is_flagged(monkeypatch):
    import repro_torch.core.protocol as P
    cfg = _pcfg(n_clients=2, max_clients=3)
    assert audit(cfg, passes=("deadness",), device="cpu").ok
    monkeypatch.setattr(P, "fedavg", unmasked_fedavg)
    rep = audit(cfg, passes=("deadness",), device="cpu")
    assert "unproven-dead-slot" in {f.code for f in rep.violations}


class DriftImpl:
    """A depth-0 schedule whose carried leaf comes back as float64."""

    def __init__(self, n_clients, device="cpu"):
        self.n, self.device = n_clients, device

    def init_state(self, sched):
        return {"acc": torch.zeros(self.n, device=self.device)}

    def round_start(self, state, lay, draws, round_idx):
        return state, lay.client_mask

    def select(self, state, h_now):
        return h_now, state

    def round_end(self, state):
        return {"acc": (state["acc"] + 1.0).double()}


def test_a_carried_leaf_cast_to_float64_is_flagged():
    from repro_torch.schedule import register_schedule
    register_schedule("drift_test", lambda n_clients, batch_size, width,
                      args: DriftImpl(n_clients), overwrite=True)
    rep = audit(_pcfg(schedule="drift_test"), passes=("retrace",),
                lane_check=False, device="cpu")
    drift = [f for f in rep.violations if f.code == "carry-aval-drift"]
    assert drift and "sched_state['acc']" in drift[0].message, rep.summary()
    assert rep.static_round_traces == 0


def branching_first_layer(lb):
    """The lane batch's first layer, plus an op only where the lane
    holds more than two clients: a round body that depends on a lane's
    value."""
    from repro_torch.core.sweep import make_uniform_first_layer_fn
    base = make_uniform_first_layer_fn(lb.width)

    def first(params, xb, lay):
        h = base(params, xb, lay)
        if int((lay.sizes > 0).sum()) > 2:
            h = h * 1.0
        return h
    return first


def test_lane_check_flags_a_first_layer_that_branches_on_the_count():
    case = RT.LANE_CASES[:1]
    assert not RT.run_lane_check("mnist", "cpu", cases=case)
    found = RT.run_lane_check("mnist", "cpu", cases=case,
                              first_layer_fn=branching_first_layer)
    assert [f.code for f in found] == ["lane-retrace-divergence"]


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["slice", "kernel"])
def test_traced_round_is_bitwise_an_untraced_round(lane):
    tr = TracedRound(_pcfg(first_layer=lane).replace(**TRACE), "cpu")
    params, opt_state, sched, _ = tr.args
    params = tree_map(lambda t: t.clone(), params)
    opt_state = tree_map(lambda t: t.clone(), opt_state)
    p, o, _, losses = tr.fed.run_round(params, opt_state, 0, tr.idx)
    want = tree_leaves(p) + tree_leaves(o) + [losses]
    # the first stage's run, and the graph the passes read run anew
    for got in (tr.graph.outputs, tr.graph.run(tr.args)):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_traced_round_labels_and_seeds():
    tr = TracedRound(_pcfg().replace(**TRACE), "cpu")
    assert combo_name(tr.pcfg) == "devertifl/sync/slice"
    seeds = tr.taint_seeds()
    assert len(seeds) == len(tr.graph.placeholders)
    cols = [s for s in seeds if s.axis == 1 and s.bits.shape[0] == 784]
    assert len(cols) == 1 and int(np.bitwise_or.reduce(cols[0].bits)) == 7
    specs = tr.out_specs()
    assert [s[2] for s in specs if s[0] == "skip"] == ["losses"]


def test_default_combos_match_the_reference_grid():
    combos = default_combos(modes=("devertifl",),
                            schedules=("sync", "stale_k:1"),
                            first_layers=("masked",))
    assert len(combos) == 10
    assert len(default_combos()) == 38
    assert {c[2] for c in default_combos(first_layers=("kernel",))} == \
        {"kernel"}


def test_audit_combos_merges_and_stamps():
    rep = audit_combos(modes=("devertifl",), schedules=("sync",),
                       first_layers=("masked",), transforms=("none",),
                       passes=("taint", "retrace"), lane_check=False,
                       device="cpu")
    assert len(rep.combos) == 2 and rep.ok, rep.summary()
    assert rep.static_round_traces == 1


def test_cli_smoke(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    rc = main(["--smoke", "--modes", "devertifl", "-q", "--out", str(out),
               "--device", "cpu"])
    assert rc == 0
    d = json.loads(out.read_text())
    assert d["static_round_traces"] == 1
    assert d["combos"] == ["devertifl/sync/slice"]
    assert not [f for f in d["findings"]
                if f["severity"] == "error" and not f["waived"]]


def test_the_audit_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        audit(_pcfg(), lane_check=False)


def test_the_api_audits_a_spec():
    from repro_torch.api import AnalysisReport, ExperimentSpec
    from repro_torch.api import audit as api_audit
    rep = api_audit(ExperimentSpec(dataset="mnist", n_clients=3,
                                   first_layer="slice"),
                    passes=("taint",), device="cpu")
    assert isinstance(rep, AnalysisReport) and rep.ok, rep.summary()
    assert rep.combos == ("devertifl/sync/slice",)
