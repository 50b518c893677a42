"""The plain reference against the port at a reduced size on the CPU
(float32 models, where the two differ only by summation order)."""
from __future__ import annotations

import pytest
import torch

from conftest import TINY
from perfbench import weights
from perfbench.reference import model as ref


def _port(family, dtype="float32", **over):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model
    import dataclasses
    cfg = ModelConfig(**{**TINY[family], **over}, dtype=dtype)
    model = build_model(cfg, clients=4)
    params, _ = weights.draw(model.init_meta(), 11, "cpu")
    return model, params, dataclasses.asdict(cfg)


@pytest.mark.parametrize("family", ["jamba", "deepseek"])
@pytest.mark.parametrize("S", [5, 37, 300])
def test_prefill_matches_the_port(family, S):
    model, params, cfg = _port(family)
    ids = torch.randint(0, cfg["vocab_size"], (S,),
                        generator=torch.Generator().manual_seed(S))
    logits, state = model.prefill(params, {"tokens": ids[None]},
                                  cache_len=S + 4)
    out = ref.prefill(params, cfg, ids)
    assert ref.rel_err(logits[0, -1], out["logits"]) < 1e-5
    kinds = ref.layer_kinds(cfg)
    for l, (k, v) in out["kv"].items():
        c = ref.layer_tree(state["cache"], kinds, l)["attn"]
        assert ref.rel_err(c["k"][0, :S], k) < 1e-5
        assert ref.rel_err(c["v"][0, :S], v) < 1e-5
    assert len(out["state"]) == (7 if family == "jamba" else 0)
    for l, (h, conv) in out["state"].items():
        m = ref.layer_tree(state["cache"], kinds, l)["mamba"]
        assert ref.rel_err(m["h"][0], h) < 1e-5
        assert ref.rel_err(m["conv"][0], conv) < 1e-5


@pytest.mark.parametrize("family", ["jamba", "deepseek"])
def test_decode_step_matches_the_port(family):
    """A batch of three slots, each prefilled alone and spliced in, then
    one decode step: the reference's step from the port's state before
    it, the MoE capacity over the whole batch."""
    from repro_torch.serving import Request, ServingEngine
    model, params, cfg = _port(family)
    eng = ServingEngine(model, params, max_batch=3, cache_len=64)
    g = torch.Generator().manual_seed(3)
    for uid, S in enumerate((9, 30, 17)):
        eng.submit(Request(uid, torch.randint(0, 256, (S,), generator=g)
                           .tolist(), max_new_tokens=8))
    eng._admit()
    kinds = ref.layer_kinds(cfg)
    cache = eng.state["cache"]
    pos = eng.state["position"].clone().long()
    fed = eng._last_tok[:, 0].clone().long()
    before = {l: {k: t.clone() for k, t in
                  ref.layer_tree(cache, kinds, l)["mamba"].items()}
              for l, (m, _) in enumerate(kinds) if m == "mamba"}
    logits, state = model.decode_step(params, eng.state, fed[:, None].int())

    def st(l):
        return before.get(l) or ref.layer_tree(cache, kinds, l)["attn"]
    out = ref.decode(params, cfg, fed, pos, st)
    assert ref.rel_err(logits[:, 0], out["logits"]) < 1e-5
    rows = torch.arange(3)
    for l, new in out["new"].items():
        c = ref.layer_tree(state["cache"], kinds, l)
        if kinds[l][0] == "attn":
            assert ref.rel_err(c["attn"]["k"][rows, pos], new[0]) < 1e-5
        else:
            assert ref.rel_err(c["mamba"]["h"], new[0]) < 1e-5
            assert ref.rel_err(c["mamba"]["conv"], new[1]) < 1e-5


def test_capacity_drops_pairs_in_token_order():
    """Four tokens all routed to expert 0 and 1 of two, capacity 1.25 *
    2 * 4 / 2 = 5 pairs an expert: none dropped; at 0.5, 2 an expert:
    only the first two tokens' pairs are kept."""
    D = 4
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(0))
    p = {"router": {"kernel": torch.zeros(D, 2)},
         "experts": {"w_gate": torch.ones(2, D, 3), "w_up": torch.ones(2, D, 3),
                     "w_down": torch.ones(2, 3, D)}}
    cfg = {"num_experts": 2, "num_experts_per_tok": 2}
    full = ref.moe(x, p, {**cfg, "expert_capacity_factor": 1.25},
                   ref.Precision(), 1)
    cut = ref.moe(x, p, {**cfg, "expert_capacity_factor": 0.5},
                  ref.Precision(), 1)
    assert torch.equal(cut[:2], full[:2])
    assert torch.count_nonzero(cut[2:]) == 0


def test_fp8_control_lies_far_from_the_reference():
    model, params, cfg = _port("deepseek")
    ids = torch.arange(40) % cfg["vocab_size"]
    f32 = ref.prefill(params, cfg, ids)
    fp8 = ref.prefill(params, cfg, ids, ref.Precision("fp8"))
    bf16_model, bf16_params, _ = _port("deepseek", dtype="bfloat16")
    logits, _ = bf16_model.prefill(bf16_params, {"tokens": ids[None]})
    # the bf16 weights are the f32 draws rounded: compare on their own
    bf = ref.prefill(bf16_params, cfg, ids)
    assert ref.rel_err(fp8["logits"], f32["logits"]) > \
        3 * ref.rel_err(logits[0, -1], bf["logits"])
