"""The port's serving engine under tracing (``repro_torch.obs.trace``):
tiny float32 hybrid (Mamba + attention + MoE) and fine-grained MoE
models with the 4-client input block, on the CPU.

With tracing off the engine records nothing; under a ``torch.profiler``
it records the engine's and the model's spans, nested as the engine's
docstring states; an operator's ``SpanTracer`` records without one.
Served tokens and the decode state are bitwise the same armed and off;
``admit`` and ``_admit`` serve the same; the request times are ordered;
the input block's bytes argument is what the clients transmit."""
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.obs import trace
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves

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
FAMILIES = sorted(TINY)


@pytest.fixture(scope="module", params=FAMILIES)
def served_model(request):
    cfg = ModelConfig(**TINY[request.param], dtype="float32")
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    return request.param, model, params


def _engine(model, params, **kw):
    eng = ServingEngine(model, params, max_batch=2, cache_len=48, seed=0,
                        **kw)
    for uid, p in enumerate(PROMPTS):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4 + uid))
    return eng


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def _spans(eng):
    return [r for r in eng.tracer.records if r["ph"] == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _parent(r, spans):
    """The innermost span holding ``r`` one level up."""
    up = [s for s in spans if s["depth"] == r["depth"] - 1
          and _inside(r, s)]
    assert len(up) == 1, (r["name"], [s["name"] for s in up])
    return up[0]["name"]


def test_engine_records_nothing_with_tracing_off(served_model):
    _, model, params = served_model
    eng = _engine(model, params)
    eng.run()
    assert eng.tracer.records == [] and eng.tracer.counters == {}
    assert trace.current() is trace.NULL


def test_engine_records_its_spans_under_a_profiler(served_model):
    family, model, params = served_model
    eng = _engine(model, params)
    _profiled(eng.run)
    assert trace.current() is trace.NULL
    spans = _spans(eng)
    names = {r["name"] for r in spans}
    want = {"admit", "prefill", "prefill.h2d", "prefill.dispatch",
            "prefill.first_token", "prefill.insert_state", "step",
            "decode.dispatch", "decode.sample", "decode.slots",
            "input_block", "mixer.attn", "ffn.moe", "moe.route",
            "moe.dispatch", "moe.experts", "moe.combine", "lm_head"}
    want |= {"mixer.mamba"} if family == "jamba" else {"moe.shared",
                                                       "ffn.mlp"}
    assert want <= names, want - names
    parents = {}
    for r in spans:
        if r["depth"]:
            parents.setdefault(r["name"], set()).add(_parent(r, spans))
    assert parents["prefill"] == {"admit"}
    for part in ("prefill.h2d", "prefill.dispatch", "prefill.first_token",
                 "prefill.insert_state"):
        assert parents[part] == {"prefill"}
    for part in ("decode.dispatch", "decode.sample", "decode.slots"):
        assert parents[part] == {"step"}
    for name in ("input_block", "lm_head", "mixer.attn", "ffn.moe"):
        assert parents[name] == {"prefill.dispatch", "decode.dispatch"}
    for part in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert parents[part] == {"ffn.moe"}
    assert {r["depth"] for r in spans if r["name"] in ("admit", "step")} \
        == {0}
    n = len(PROMPTS)
    # the MoE layers count each call; at capacity factor 1.25 none is
    # dropless
    n_moe = sum(kd["ffn"] == "moe" for kd in model.kinds)
    assert eng.tracer.counters == {
        "prefills": n, "prompt_tokens": sum(map(len, PROMPTS)),
        "decode_steps": eng.decode_steps,
        "moe_calls": n_moe * (n + eng.decode_steps)}
    assert eng.tracer.dropped == 0


def test_engine_records_into_an_operators_tracer_always(served_model):
    _, model, params = served_model
    tr = SpanTracer()
    eng = _engine(model, params, tracer=tr)
    eng.run()
    assert eng.tracer is tr
    steps = [r for r in tr.records if r["name"] == "step"]
    assert len(steps) == eng.decode_steps > 0
    assert trace.current() is trace.NULL


def test_tracing_leaves_tokens_and_state_bitwise(served_model):
    _, model, params = served_model
    off = _engine(model, params)
    armed = _engine(model, params)
    out_off = off.run()
    out_armed = _profiled(armed.run)
    assert armed.tracer.records and not off.tracer.records
    assert out_armed == out_off
    a, b = tree_leaves(off.state), tree_leaves(armed.state)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(off._last_tok, armed._last_tok)


def test_admit_and_the_harness_name_serve_the_same(served_model):
    _, model, params = served_model
    engines = [_engine(model, params), _engine(model, params)]
    for eng, admit in zip(engines, ("admit", "_admit")):
        while eng.queue or any(s.active for s in eng.slots):
            getattr(eng, admit)()
            if any(s.active for s in eng.slots):
                eng.step()
    assert engines[0].done == engines[1].done
    assert len(engines[0].done) == len(PROMPTS)


def test_request_times_are_ordered(served_model):
    _, model, params = served_model
    eng = _engine(model, params)
    eng.run()
    assert sorted(eng.lifecycle) == list(range(len(PROMPTS)))
    for t in eng.lifecycle.values():
        assert t.t_submit <= t.t_prefill_start <= t.t_first_token


def test_input_block_bytes_are_what_the_clients_transmit(served_model):
    _, model, params = served_model
    eng = _engine(model, params)
    _profiled(eng.run)
    cfg = model.cfg
    size = torch.tensor([], dtype=model.dtype).element_size()
    blocks = [r for r in _spans(eng) if r["name"] == "input_block"]
    prefills = [r for r in _spans(eng) if r["name"] == "prefill"]
    assert len(blocks) == len(prefills) + eng.decode_steps
    for r in blocks:
        assert r["args"]["clients"] == CLIENTS
        assert r["args"]["exchange"] == cfg.vfl.exchange == "zeropad_psum"
    # a prefill's block carries B = 1 and S = its prompt; a step's the
    # whole batch of one token each
    got = sorted(r["args"]["bytes"] for r in blocks)
    want = sorted([CLIENTS * 1 * len(p) * cfg.d_model * size
                   for p in PROMPTS] +
                  [CLIENTS * eng.max_batch * 1 * cfg.d_model * size]
                  * eng.decode_steps)
    assert got == want
