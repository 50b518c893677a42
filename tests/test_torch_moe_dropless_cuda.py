"""The MoE layer's dropless path inside the serving engine's CUDA graph,
on the card: a tiny bfloat16 DeepSeekMoE (16 routed experts top-4 plus
2 shared, a dense first layer, the 4-client input block) at capacity
factor 4.0, E / k, where every MoE call takes the dropless path.

The engine, recording into an operator's tracer, runs its first step
eagerly and captures it; every later step replays the graph.  Each
step is held bitwise to ``Model.decode_step`` run eagerly on a clone of
the state before it (the logits, every cache, the positions), over 16
and more steps with admissions between them.  The counters read one a
MoE call on the eager step, and each replay, of a step or of a
prefill, adds what its capture counted, one reading a counter.

The model pads exactly, so every admission replays a captured prefill:
each is held bitwise to ``Model._prefill`` run eagerly on the same
padded prompt (the logits, the cache, the position) and launches what
it launches, and within bfloat16 rounding to the unpadded prefill.
Skips without a card (run on the GPU with ``-m cuda``)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import KERNELS
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

TINY = dict(name="tiny-deepseek", family="moe", num_layers=3, d_model=256,
            num_heads=4, num_kv_heads=4, head_dim=64, d_ff=128,
            vocab_size=512, num_experts=16, num_experts_per_tok=4,
            num_shared_experts=2, moe_d_ff=128, first_layer_dense_ff=256,
            expert_capacity_factor=4.0, dtype="bfloat16")
SLOTS, CACHE_LEN = 4, 96


def _requests(vocab):
    g = torch.Generator().manual_seed(5)
    out = []
    for uid in range(7):
        n = int(torch.randint(4, 40, (1,), generator=g))
        out.append(Request(uid, torch.randint(0, vocab, (n,), generator=g)
                           .tolist(), max_new_tokens=6 + 3 * uid))
    return out


def test_dropless_step_replays_bitwise_and_counts():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    model = build_model(ModelConfig(**TINY), clients=4)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n_moe = sum(kd["ffn"] == "moe" for kd in model.kinds)
    tr = SpanTracer()
    eng = ServingEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                        tracer=tr)
    for r in _requests(model.cfg.vocab_size):
        eng.submit(r)
    steps = 0
    with torch.no_grad():
        while eng.queue or any(s.active for s in eng.slots):
            eng.admit()
            if not any(s.active for s in eng.slots):
                continue
            state = tree_map(lambda t: t.clone(), eng.state)
            fed = eng._last_tok.clone().cuda()
            before = dict(tr.counters)
            eng.step()
            logits, want = model.decode_step(params, state, fed)
            torch.cuda.synchronize()
            if steps:
                assert torch.equal(eng._graph.logits, logits), steps
            a, b = tree_leaves(eng.state), tree_leaves(want)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), steps
            for name in ("moe_calls", "moe_dropless_calls"):
                assert tr.counters[name] - before.get(name, 0) == n_moe
            steps += 1
    assert steps == eng.decode_steps >= 16
    assert eng.graph_replays == eng.decode_steps - 1
    assert eng._graph.spans.counts == {"moe_calls": n_moe,
                                       "moe_dropless_calls": n_moe}
    calls = n_moe * (eng.prefills + eng.decode_steps)
    assert tr.counters["moe_calls"] == tr.counters["moe_dropless_calls"] \
        == calls
    # the eager step reads one a call; a replay, of a step or of a
    # prefill, one reading of n_moe
    readings = [r for r in tr.records if r["ph"] == "C"
                and r["name"] == "moe_calls"]
    assert len(readings) == n_moe + eng.graph_replays + eng.prefills
    # every replayed step writes out its layers' experts spans with the
    # arguments they had at the capture: a step's T * k rows
    step = {"rows": SLOTS * 4, "E": 16, "D": 256, "F": 128}
    experts = [r["args"] for r in tr.records if r["name"] == "moe.experts"]
    assert experts.count(step) >= n_moe * eng.decode_steps


def test_dropless_prefill_replays_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    model = build_model(ModelConfig(**TINY), clients=4)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN)
    assert eng._pads
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for uid, n in enumerate((1, 5, 37, 95, 96)):
            prompt = torch.randint(0, 512, (n,), generator=g).tolist()
            toks = torch.tensor([prompt], device="cuda")
            before = [fn.launches for fn in KERNELS]
            logits, st = model.prefill(params, {"tokens": toks}, CACHE_LEN,
                                       graphs=eng._prefill_runner())
            torch.cuda.synchronize()
            got_n = [fn.launches - b for fn, b in zip(KERNELS, before)]
            logits, st = logits.clone(), tree_map(lambda t: t.clone(), st)
            padded = torch.zeros((1, CACHE_LEN), dtype=toks.dtype,
                                 device="cuda")
            padded[:, :n] = toks
            before = [fn.launches for fn in KERNELS]
            w_logits, want = model._prefill(
                params, {"tokens": padded}, CACHE_LEN,
                torch.tensor([n - 1], device="cuda"))
            torch.cuda.synchronize()
            assert got_n == [fn.launches - b for fn, b in
                             zip(KERNELS, before)] and sum(got_n) > 0
            assert torch.equal(logits, w_logits), n
            a, b = tree_leaves(st), tree_leaves(want)
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), n
            assert int(st["position"][0]) == n
            plain, _ = model.prefill(params, {"tokens": toks}, CACHE_LEN)
            err = (logits - plain).float().norm() / plain.float().norm()
            assert err < 2e-2, (n, float(err))
    assert sorted(eng._prefill_graphs.graphs) == [96]
