"""The MoE layer's dropless path (``models/moe.py``) on the CPU: a tiny
DeepSeekMoE (8 routed experts top-3 plus 2 shared, a dense first layer,
the 4-client input block) at capacity factor 3.0, at least E / k, with
seeded random weights, in float32.

- At ``C >= Tg`` the dropless path gives what the padded path gives
  (which then drops nothing), for a B = 1 prefill and a decode batch
  with padding rows, within 1e-5 of the output's largest entry:
  float32 in another summation order.
- A prefill and then decode steps through the cache agree with the
  plain reference's full forward pass over the same prefix
  (``perfbench/reference/model.py``, which drops nothing at this
  capacity), within 1e-5 relative: float32 summation order again.
- The dropless path is batch-invariant: a token's output does not move
  (within float32 rounding) when its batchmates change, while at
  capacity factor 1.25 the padded path drops the same token's pairs
  once its batchmates fill its experts, which moves it by a whole
  expert's share.
- Tiny jamba's MoE at 1.25 (``C < Tg``) is bitwise the padded
  computation as it was written before the dropless path (kept here).
- The counters ``moe_calls`` and ``moe_dropless_calls`` read one a call,
  and a captured decode step's counts are added once a replay.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.obs import trace
from repro_torch.obs.trace import GraphSpans, SpanTracer
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import model as ref  # noqa: E402

CLIENTS = 4
DEEPSEEK = dict(name="tiny-deepseek", family="moe", num_layers=3,
                d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                d_ff=32, vocab_size=256, num_experts=8,
                num_experts_per_tok=3, num_shared_experts=2, moe_d_ff=32,
                first_layer_dense_ff=128)
JAMBA = dict(name="tiny-jamba", family="hybrid", ssm_type="mamba",
             num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=96, vocab_size=256, attn_layer_period=8,
             attn_layer_offset=4, num_experts=4, num_experts_per_tok=2,
             moe_every=2, moe_offset=1, moe_d_ff=96, ssm_state_dim=8)
CF = 3.0                # >= E / k = 8 / 3: no pair can be dropped
PROMPTS = [[3, 9, 27, 81, 5], [7, 1, 2], [200, 100, 50, 25, 12, 6, 3],
           [11] * 9, [4, 4, 8]]


def _cfg(arch=DEEPSEEK, cf=CF):
    return ModelConfig(**arch, dtype="float32", expert_capacity_factor=cf)


def _layer(cfg, seed=0):
    return M.moe_init(torch.Generator().manual_seed(seed), cfg,
                      torch.float32)


def _x(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _counted(fn):
    """(fn()'s result, the counters it counted into an armed tracer)."""
    tr = SpanTracer()
    with trace.armed(tr):
        out = fn()
    return out, tr.counters


def _padded_only(monkeypatch):
    monkeypatch.setattr(M, "_grouped_ok", lambda x: False)


def _close(a, b, rtol=1e-5):
    err = float((a - b).abs().max())
    assert err <= rtol * float(b.abs().max()), err


@pytest.mark.parametrize("B,S", [(1, 40), (8, 1)])
def test_dropless_equals_padded_at_full_capacity(monkeypatch, B, S):
    cfg = _cfg()
    p = _layer(cfg)
    x = _x(1, B, S, cfg.d_model)
    if S == 1:
        x[5:] = 0.0             # the decode batch's padding rows
    (y, _), n = _counted(lambda: M.moe_apply(p, x, cfg))
    assert n == {"moe_calls": 1, "moe_dropless_calls": 1}
    _padded_only(monkeypatch)
    (want, _), n = _counted(lambda: M.moe_apply(p, x, cfg))
    assert n == {"moe_calls": 1}
    T = B * S
    C = min(max(1, int(CF * 3 * T / 8)), T * 3)
    assert C >= T            # the padded path drops nothing here
    _close(y, want)


def test_prefill_then_decode_matches_the_reference_forward():
    """A 20-token prefill, then four decode steps: each step's logits
    against the reference's full forward pass over the prompt so far."""
    cfg = _cfg()
    model = build_model(cfg, clients=CLIENTS)
    params, _ = weights.draw(model.init_meta(), 2**31 + 5, "cpu")
    conf = dataclasses.asdict(cfg)
    ids = torch.randint(0, cfg.vocab_size, (24,),
                        generator=torch.Generator().manual_seed(4))
    (logits, st), n = _counted(lambda: model.prefill(
        params, {"tokens": ids[None, :20]}, cache_len=32))
    assert n == {"moe_calls": 2, "moe_dropless_calls": 2}
    assert ref.rel_err(logits[0, -1], ref.prefill(params, conf,
                                                  ids[:20])["logits"]) < 1e-5
    for i in range(20, 24):
        logits, st = model.decode_step(params, st, ids[None, i:i + 1].int())
        want = ref.prefill(params, conf, ids[:i + 1])["logits"]
        assert ref.rel_err(logits[0, -1], want) < 1e-5, i


def _batch_pair(cfg):
    """Two decode batches of 12 tokens with the same last token: in one
    its batchmates are drawn at random, in the other they are copies of
    it, so that they fill its experts before it (it comes last)."""
    a = _x(2, 12, 1, cfg.d_model)
    b = a[-1:].expand(12, 1, cfg.d_model).clone()
    return a, b


def test_dropless_output_is_batch_invariant():
    cfg = _cfg()
    p = _layer(cfg)
    a, b = _batch_pair(cfg)
    ya, _ = M.moe_apply(p, a, cfg)
    yb, _ = M.moe_apply(p, b, cfg)
    _close(ya[-1], yb[-1], 1e-6)
    # the padded path at 1.25: C = int(1.25 * 3 * 12 / 8) = 5, and the
    # eleven copies before the last token take its experts' five places
    tight = _cfg(cf=1.25)
    ya, _ = M.moe_apply(p, a, tight)
    yb, _ = M.moe_apply(p, b, tight)
    assert float((ya[-1] - yb[-1]).abs().max()) > \
        1e-2 * float(ya[-1].abs().max())
    # dropped: what is left of the copy's output is the shared experts'
    shared = M.L.mlp_apply(p["shared"], b[-1:], "swiglu")
    _close(yb[-1], shared[0], 1e-6)


def _padded_before(p, x, cfg):
    """The routed and shared experts as ``moe_apply`` computed them
    before the dropless path, kept as written then."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    logits = xf.float() @ p["router"]["kernel"]
    top_w, top_idx, _ = M.moe_router(logits, k)
    top_idx = top_idx.long()
    G = M._pick_groups(T, B)
    Tg = T // G
    C = max(1, int(cfg.expert_capacity_factor * k * Tg / E))
    C = min(C, Tg * k)
    xg = xf.reshape(G, Tg, D)
    buf, dest, _, _, order = M._dispatch(xg, top_idx.reshape(G, Tg, k), E,
                                         C)
    ex = p["experts"]
    h = torch.einsum("gecd,edf->gecf", buf, ex["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, ex["w_up"])
    out = torch.einsum("gecf,efd->gecd", F.silu(h) * u, ex["w_down"])
    wg = top_w.reshape(G, Tg, k).to(x.dtype)
    out_flat = torch.cat([out.reshape(G, E * C, D),
                          out.new_zeros((G, 1, D))], dim=1)
    dest_tk = torch.empty_like(dest).scatter_(1, order, dest)
    g_idx = torch.arange(G, device=x.device)[:, None]
    slot = out_flat[g_idx, dest_tk].reshape(G, Tg, k, D)
    y = slot[:, :, 0] * wg[:, :, 0, None]
    for j in range(1, k):
        y = y + slot[:, :, j] * wg[:, :, j, None]
    return y.reshape(B, S, D)


@pytest.mark.parametrize("B,S", [(1, 40), (8, 1), (4, 128)])
def test_jamba_tiny_moe_is_bitwise_the_padded_path(B, S):
    cfg = _cfg(JAMBA, cf=1.25)
    p = _layer(cfg, seed=3)
    x = _x(5, B, S, cfg.d_model)
    (y, _), n = _counted(lambda: M.moe_apply(p, x, cfg))
    assert n == {"moe_calls": 1}
    assert torch.equal(y, _padded_before(p, x, cfg))


def _engine(model, params, tracer):
    eng = ServingEngine(model, params, max_batch=2, cache_len=48, seed=0,
                        tracer=tracer)
    for uid, prompt in enumerate(PROMPTS):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=4 + uid))
    return eng


@pytest.mark.parametrize("arch,cf,dropless", [(DEEPSEEK, CF, True),
                                              (DEEPSEEK, 1.25, False),
                                              (JAMBA, 1.25, False)])
def test_counters_read_one_a_moe_call(arch, cf, dropless):
    cfg = _cfg(arch, cf)
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator().manual_seed(0))
    tr = SpanTracer()
    eng = _engine(model, params, tr)
    eng.run()
    n_moe = sum(kd["ffn"] == "moe" for kd in model.kinds)
    calls = n_moe * (eng.prefills + eng.decode_steps)
    want = {"moe_calls": calls}
    if dropless:
        want["moe_dropless_calls"] = calls
    assert {k: tr.counters.get(k) for k in want} == want
    assert ("moe_dropless_calls" in tr.counters) == dropless
    for name in want:
        values = [r["args"]["value"] for r in tr.records
                  if r["ph"] == "C" and r["name"] == name]
        assert values == list(range(1, calls + 1))


def test_a_replay_adds_what_its_capture_counted():
    """A decode step captured into ``GraphSpans`` keeps what it counted;
    ``SpanTracer.replayed`` adds it once a replay, one reading a
    counter, beside the replayed spans."""
    cfg = _cfg()
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator().manual_seed(0))
    gs = GraphSpans(event=lambda: type("Ev", (), {
        "record": lambda self, stream=None: None})())
    with trace.armed(gs):
        model.decode_step(params, model.init_decode_state(2, 16,
                                                          device="cpu"),
                          torch.tensor([[1], [2]], dtype=torch.int32))
    assert gs.counts == {"moe_calls": 2, "moe_dropless_calls": 2}
    experts = [s for s in gs.spans if s["name"] == "moe.experts"]
    assert [s["args"] for s in experts] == \
        [{"rows": 6, "E": 8, "D": 64, "F": 32}] * 2
    tr = SpanTracer()
    for _ in range(3):
        tr.replayed(gs, tr.origin, tr.origin + 0.01)
    assert tr.counters == {"moe_calls": 6, "moe_dropless_calls": 6}
    readings = [(r["name"], r["args"]["value"]) for r in tr.records
                if r["ph"] == "C"]
    assert readings == [(n, v) for v in (2, 4, 6)
                        for n in ("moe_calls", "moe_dropless_calls")]
    got = [r["args"] for r in tr.records if r["name"] == "moe.experts"]
    assert got == [s["args"] for s in experts] * 3
