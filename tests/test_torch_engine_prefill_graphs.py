"""The serving engine's captured B = 1 prefills (``serving/engine.py``,
``_PrefillGraphs``) on the CPU, with the capture replaced by an eager
stand-in: a tiny DeepSeekMoE (8 routed experts top-3 plus 2 shared, a
dense first layer, the 4-client input block) at capacity factor 3.0,
at least E / k, so that its MoE drops nothing at any length.

- ``Model.prefill`` over a prompt padded at its end, with ``last`` at
  its last token, gives the prompt's logits, cache rows and position
  what the unpadded prefill gives (within float32 rounding: the
  products run over more rows).
- ``_pads_exactly`` admits that model and refuses every model whose
  padding would not be exact (an MoE that can drop, a Mamba state, a
  windowed ring, an encoder) and dense-only models.
- An engine that runs its admissions through the captured prefills
  serves the tokens an eager engine serves, each prompt in the shortest
  captured length that holds it, and every admission still passes
  through ``Model.prefill``, where a wrapper sees it.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as E

CLIENTS = 4
DEEPSEEK = dict(name="tiny-deepseek", family="moe", num_layers=3,
                d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                d_ff=32, vocab_size=256, num_experts=8,
                num_experts_per_tok=3, num_shared_experts=2, moe_d_ff=32,
                first_layer_dense_ff=128, expert_capacity_factor=3.0)
CACHE_LEN = 300          # captured lengths 128, 256, 300
PROMPTS = [[3, 9, 27, 81, 5], [7, 1, 2] * 43, [200, 100, 50] * 50,
           [11] * 131, list(range(1, 250)), [4, 4, 8]]


def _model(**kw):
    cfg = ModelConfig(**{**DEEPSEEK, **kw}, dtype="float32")
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator().manual_seed(0))
    return model, params


class _Replay:
    """Stands in for a captured graph: a replay runs the captured
    function eagerly."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def eager_capture(monkeypatch):
    monkeypatch.setattr(E._PrefillGraphs, "pool", staticmethod(lambda: None))
    monkeypatch.setattr(E._PrefillGraphs, "capture",
                        staticmethod(lambda fn, pool: _Replay(fn)))


@pytest.mark.parametrize("n", [1, 5, 37, 64])
def test_padded_prefill_gives_the_prompts_rows(n):
    model, params = _model()
    toks = torch.randint(1, 256, (1, n),
                         generator=torch.Generator().manual_seed(n))
    padded = torch.cat([toks, torch.zeros((1, 64 - n + 7),
                                          dtype=toks.dtype)], 1)
    want_logits, want = model.prefill(params, {"tokens": toks}, 96)
    got_logits, got = model.prefill(params, {"tokens": padded}, 96,
                                    last=torch.tensor([n - 1]))
    assert got_logits.shape == want_logits.shape
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got["position"], want["position"])
    for w, g in zip(_attn_caches(want["cache"]), _attn_caches(got["cache"])):
        S = w["pos"].shape[-1]
        wk, gk = (c["k"].reshape(-1, S, c["k"][0].numel() // S)
                  for c in (w, g))
        wv, gv = (c["v"].reshape(-1, S, c["v"][0].numel() // S)
                  for c in (w, g))
        torch.testing.assert_close(gk[:, :n], wk[:, :n], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(gv[:, :n], wv[:, :n], rtol=1e-5,
                                   atol=1e-5)
        wp, gp = w["pos"].reshape(-1, S), g["pos"].reshape(-1, S)
        assert torch.equal(gp[:, :n], wp[:, :n])
        # the padding's rows sit past the prompt: a causal decode at
        # position n and on masks them until it writes over them
        assert bool((gp[:, n:padded.shape[1]] >= n).all())


def _attn_caches(tree):
    """Every attention layer's cache dict in a decode state's tree."""
    if "pos" in tree:
        return [tree]
    return [c for v in tree.values() if isinstance(v, dict)
            for c in _attn_caches(v)]


def test_pads_exactly_only_where_padding_changes_no_row():
    ok, _ = _model()
    assert E._pads_exactly(ok, CACHE_LEN)
    drops, _ = _model(expert_capacity_factor=1.25)
    assert not E._pads_exactly(drops, CACHE_LEN)
    dense, _ = _model(num_experts=0, num_shared_experts=0)
    assert not E._pads_exactly(dense, CACHE_LEN)
    windowed, _ = _model(attn_type="swa", window_size=64)
    assert not E._pads_exactly(windowed, CACHE_LEN)
    hybrid = build_model(ModelConfig(
        name="tiny-jamba", family="hybrid", ssm_type="mamba", num_layers=8,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
        vocab_size=256, attn_layer_period=8, attn_layer_offset=4,
        num_experts=4, num_experts_per_tok=2, moe_every=2, moe_offset=1,
        moe_d_ff=96, ssm_state_dim=8, expert_capacity_factor=8.0,
        dtype="float32"), clients=CLIENTS)
    assert not E._pads_exactly(hybrid, CACHE_LEN)
    audio = dataclasses.replace(ok.cfg, is_encoder_decoder=True,
                                num_encoder_layers=1, modality="audio",
                                num_prefix_embeddings=4)
    assert not E._pads_exactly(build_model(audio, clients=CLIENTS),
                               CACHE_LEN)


def test_lengths_cover_the_cache():
    assert E._PrefillGraphs.lengths(300) == [128, 256, 300]
    assert E._PrefillGraphs.lengths(256) == [128, 256]
    assert E._PrefillGraphs.lengths(96) == [96]
    assert E._PrefillGraphs.lengths(2432)[-1] == 2432


def _serve(model, params, captured):
    eng = ServingEngine(model, params, max_batch=3, cache_len=CACHE_LEN)
    eng._pads = captured
    seen = []
    timed = model.prefill

    def prefill(*args, **kwargs):
        out = timed(*args, **kwargs)
        seen.append(out[0][0, -1].clone())
        return out
    model.prefill = prefill
    try:
        for uid, p in enumerate(PROMPTS):
            eng.submit(Request(uid, p, max_new_tokens=6 + uid))
        done = eng.run()
    finally:
        del model.prefill
    return eng, done, seen


def test_engine_serves_the_eager_tokens_through_captured_prefills(
        eager_capture):
    model, params = _model()
    _, want, want_seen = _serve(model, params, False)
    eng, got, seen = _serve(model, params, True)
    assert got == want
    graphs = eng._prefill_graphs
    assert sorted(graphs.graphs) == [128, 256, 300]
    assert len(seen) == len(want_seen) == eng.prefills == len(PROMPTS)
    for a, b in zip(seen, want_seen):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the last prompt, 3 tokens, ran in the 128-token graph: its buffer
    # holds it and then zeros
    buf = graphs.tokens[128][0]
    assert buf[:3].tolist() == PROMPTS[-1] and not buf[3:].any()
    assert int(graphs.last) == len(PROMPTS[-1]) - 1
