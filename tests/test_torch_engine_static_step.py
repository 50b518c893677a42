"""The serving engine's static decode step, on the CPU: tiny float32
hybrid (Mamba + attention + MoE) and fine-grained MoE models with the
4-client input block.

The step reads its tokens from a static device buffer and advances the
state in place, so that on a card it can be captured once as a CUDA
graph and replayed (``serving/engine.py``).  Here it runs eagerly: it
serves bitwise what ``Model.decode_step`` gives on a cloned state, over
steps with admissions between them; the state, its cache tree and every
tensor in it stay the same objects; and a replayed step's device spans
(``GraphSpans`` taken at the capture, written out by
``SpanTracer.replayed``), driven through the engine by a stand-in
graph with stand-in events, nest inside their ``decode.dispatch`` as an
eager step's do, and resolve from the graph's events, which go to no
pool."""
import itertools

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.obs import trace
from repro_torch.obs.trace import GraphSpans, SpanTracer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.tree import tree_leaves, tree_map

CLIENTS = 4
TINY = {
    "jamba": dict(name="tiny-jamba", family="hybrid", ssm_type="mamba",
                  num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=96, vocab_size=256, attn_layer_period=8,
                  attn_layer_offset=4, num_experts=4, num_experts_per_tok=2,
                  moe_every=2, moe_offset=1, moe_d_ff=96, ssm_state_dim=8),
    "deepseek": dict(name="tiny-deepseek", family="moe", num_layers=3,
                     d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                     d_ff=32, vocab_size=256, num_experts=8,
                     num_experts_per_tok=3, num_shared_experts=2,
                     moe_d_ff=32, first_layer_dense_ff=128),
}
PROMPTS = [[3, 9, 27, 81, 5], [7, 1, 2], [200, 100, 50, 25, 12, 6, 3],
           [11] * 9, [4, 4, 8]]
DEVICE_SPANS = {"input_block", "ffn.moe", "moe.route", "moe.dispatch",
                "moe.experts", "moe.combine", "moe.shared"}


@pytest.fixture(scope="module", params=sorted(TINY))
def served_model(request):
    cfg = ModelConfig(**TINY[request.param], dtype="float32")
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    return model, params


def _engine(model, params, **kw):
    eng = ServingEngine(model, params, max_batch=2, cache_len=48, seed=0,
                        **kw)
    for uid, p in enumerate(PROMPTS):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4 + uid))
    return eng


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


def _identities(state):
    """id() of the state, of every dict in its tree and of every tensor."""
    out = [id(state)]

    def walk(d):
        out.append(id(d))
        for v in d.values():
            if isinstance(v, dict):
                walk(v)
            else:
                out.append(id(v))
    walk(state)
    return out


def test_static_step_serves_what_decode_step_does(served_model):
    """Every step's served tokens and the state it leaves are bitwise
    ``Model.decode_step`` on a clone of the state before it, fed the
    tokens the engine fed; admissions run between the steps."""
    model, params = served_model
    eng = _engine(model, params)
    steps = admitted = 0
    while eng.queue or any(s.active for s in eng.slots):
        before = eng.prefills
        eng.admit()
        admitted += eng.prefills > before and steps > 0
        if not any(s.active for s in eng.slots):
            continue
        state, fed = _clone(eng.state), eng._last_tok.clone()
        held = {i: (s.uid, len(s.generated))
                for i, s in enumerate(eng.slots) if s.active}
        eng.step()
        logits, want = model.decode_step(params, state, fed)
        greedy = logits[:, -1, :].argmax(-1)
        for i, (uid, n) in held.items():
            slot = eng.slots[i]
            got = slot.generated if slot.active and slot.uid == uid \
                else eng.done[uid]
            assert got[n] == int(greedy[i])
        a, b = tree_leaves(eng.state), tree_leaves(want)
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(eng.state["position"], want["position"])
        steps += 1
    assert steps == eng.decode_steps > 4 and admitted >= 2
    assert eng.graph_replays == 0          # eager on the CPU


def test_state_keeps_its_identity_across_steps(served_model):
    """``state``, ``state["cache"]``, every dict below it and every
    tensor in it are the same objects after each admission and step."""
    model, params = served_model
    eng = _engine(model, params)
    ids = _identities(eng.state)
    cache, position = eng.state["cache"], eng.state["position"]
    while eng.queue or any(s.active for s in eng.slots):
        eng.admit()
        if any(s.active for s in eng.slots):
            eng.step()
        assert _identities(eng.state) == ids
    assert eng.state["cache"] is cache
    assert eng.state["position"] is position


def test_decode_step_advances_the_state_in_place(served_model):
    """``Model.decode_step`` returns the state it was given, its
    position one on and its caches written."""
    model, params = served_model
    state = model.init_decode_state(2, 16, device="cpu")
    ids = _identities(state)
    before = _clone(state)
    out = state
    for _ in range(3):
        _, out = model.decode_step(params, out,
                                   torch.tensor([[5], [9]],
                                                dtype=torch.int32))
    assert out is state and _identities(state) == ids
    assert torch.equal(state["position"], before["position"] + 3)
    assert not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(state["cache"]),
                       tree_leaves(before["cache"])))


class _Event:
    """A stand-in for a timing event: ``record`` takes the next tick of
    a fake device clock (ms); ``elapsed_time`` the ticks between."""

    clock = itertools.count()

    def __init__(self):
        self.ms = None

    def record(self, stream=None):
        self.ms = float(next(self.clock))

    def elapsed_time(self, end):
        return end.ms - self.ms


class _CpuGraph(engine_mod._DecodeGraph):
    """The engine's graph on the CPU: its capture records the model's
    spans into ``GraphSpans`` with stand-in events while the step runs
    on a clone of the state; its replay runs the step again, untraced,
    on the engine's state, and records the events anew, as a graph's
    event nodes do."""

    def __init__(self, model, params, state, tokens):
        self.spans = GraphSpans(event=_Event)
        with trace.armed(self.spans):
            model.decode_step(params, _clone(state), tokens.clone())
        self.launches = [0] * len(engine_mod.KERNELS)
        self.logits = None

        def replay():
            with trace.armed(trace.NULL):
                self.logits, _ = model.decode_step(params, state, tokens)
            for s in self.spans.spans:
                s["e0"].record()
                s["e1"].record()
        self.graph = type("Graph", (), {"replay": staticmethod(replay)})


def _replaying(model, params, tracer):
    """An engine whose first step captures a ``_CpuGraph``."""
    eng = _engine(model, params, tracer=tracer)

    def first():
        logits, _ = model.decode_step(params, eng.state, eng._toks)
        eng._graph = _CpuGraph(model, params, eng.state, eng._toks)
        return logits
    eng._decode_eagerly = first
    return eng


def test_replayed_spans_nest_inside_their_dispatch(served_model):
    """Through the engine's replay path: every replayed step records the
    model's device spans, each inside that step's ``decode.dispatch``
    at the depth an eager step's has and inside the same parent; the
    replays are counted; the tokens are the eager engine's."""
    model, params = served_model
    tr = SpanTracer()
    eng = _replaying(model, params, tr)
    out = eng.run()
    assert out == _engine(model, params).run()
    assert eng.graph_replays == eng.decode_steps - 1 > 3
    assert tr.counters["decode_graph_replays"] == eng.graph_replays
    spans = [r for r in tr.records if r["ph"] == "X"]
    steps = [r for r in spans if r["name"] == "step"]
    dispatches = [r for r in spans if r["name"] == "decode.dispatch"]
    assert len(steps) == len(dispatches) == eng.decode_steps
    eager = _spans_inside(dispatches[0], spans)
    per_layer = eng._graph.spans.spans
    assert {s["name"] for s in per_layer} == \
        {r["name"] for r in eager} & DEVICE_SPANS
    for d in dispatches[1:]:
        got = _spans_inside(d, spans)
        assert [r["name"] for r in got] == [s["name"] for s in per_layer]
        for r in got:
            assert r["depth"] > d["depth"] and r["dur"] > 0
        # the same nesting as the eager step's device spans
        assert _tree(got) == _tree([r for r in eager
                                    if r["name"] in DEVICE_SPANS])


def _spans_inside(outer, spans):
    """The spans strictly inside ``outer``, in the order they opened."""
    inner = [r for r in spans if r is not outer and r["depth"] > outer[
        "depth"] and outer["ts"] <= r["ts"] and r["ts"] + r["dur"] <=
        outer["ts"] + outer["dur"]]
    return sorted(inner, key=lambda r: (r["ts"], r["depth"]))


def _tree(spans):
    """(name, depth, the name of the innermost span holding it) of each
    span, in the order they opened."""
    out = []
    for r in spans:
        up = [s for s in spans if s["depth"] < r["depth"]
              and s["ts"] <= r["ts"]
              and r["ts"] + r["dur"] <= s["ts"] + s["dur"]]
        parent = max(up, key=lambda s: s["depth"])["name"] if up else None
        out.append((r["name"], r["depth"], parent))
    return out


def test_replayed_device_spans_resolve_from_the_graph_events(
        served_model, monkeypatch):
    """A replayed span's device interval is read from the graph's events
    against the tracer's anchor, and the events go back to no pool: the
    next replay records them again."""
    model, params = served_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    gs = GraphSpans(event=_Event)
    with trace.armed(gs):
        model.decode_step(params, model.init_decode_state(
            2, 16, device="cpu"), torch.tensor([[1], [2]],
                                               dtype=torch.int32))
    tr = SpanTracer()
    anchor = _Event()
    anchor.record()
    tr._device, tr._anchor = "cpu", (tr.origin + 1.0, anchor)
    with tr.span("decode.dispatch", cat="serve"):
        t_in = tr.origin + 1.5
        for s in gs.spans:
            s["e0"].record()
            s["e1"].record()
        tr.replayed(gs, t_in, t_in + 0.01)
    tr.resolve()
    got = [r for r in tr.records if r["name"] in DEVICE_SPANS]
    assert len(got) == len(gs.spans) > 0
    for r, s in zip(got, gs.spans):
        assert r["dev_ts"] == pytest.approx(
            1e6 + (s["e0"].ms - anchor.ms) * 1e3)
        assert r["dev_dur"] == pytest.approx(
            (s["e1"].ms - s["e0"].ms) * 1e3)
        assert 1.5e6 < r["ts"] and r["ts"] + r["dur"] < 1.51e6
    assert tr._pool == [] and not tr._pending
