"""The yardstick's counts against shapes worked by hand."""
from __future__ import annotations

import pytest

from perfbench import work


def test_visible_pairs_causal_and_window():
    assert work.visible_pairs(4, 4) == 1 + 2 + 3 + 4
    assert work.visible_pairs(4, 4, causal=False) == 16
    # window 2: every row after the first sees itself and one before
    assert work.visible_pairs(4, 4, window=2) == 1 + 2 + 2 + 2
    # a decode row at the end of 10 keys sees all of them
    assert work.visible_pairs(1, 10) == 10


@pytest.mark.parametrize("S", [1, 7, 64, 1000])
def test_prefill_attention_work(S):
    H, KV, hd = 32, 8, 128
    flops, nbytes = work.attention_prefill_work(S, H, KV, hd)
    assert flops == 4 * H * hd * work.visible_pairs(S, S)
    # q and o at H heads, k and v at KV heads, bf16
    assert nbytes == 2 * (2 * S * H * hd + 2 * S * KV * hd)


def test_decode_attention_work():
    # two rows seeing 3 and 5 keys over a 16-slot cache, hd 2, 1 head
    flops, nbytes = work.attention_decode_work([3, 5], 1, 1, 2, 16)
    assert flops == 4 * 1 * 2 * 8
    assert nbytes == 2 * 2 * 1 * 2 * 2 + 2 * 8 * 1 * 2 * 2 + 4 * 2 * 17


def test_mamba_scan_fused_work():
    B, T, D, N = 1, 3, 4, 2
    nbytes, ops, exps = work.mamba_scan_fused_work(B, T, D, N)
    # dt 4 B, x 2 B, B and C 2 B, A 4 B, state out 4 B, y 4 B
    assert nbytes == 4 * 12 + 2 * 12 + 2 * 2 * 6 + 4 * 8 + 4 * 8 + 4 * 12
    assert ops == 6 * 24 + 12
    assert exps == 24
    with_state = work.mamba_scan_fused_work(B, T, D, N, with_state=True)[0]
    assert with_state == nbytes + 4 * 8


def _cfg(**over):
    cfg = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
           "head_dim": 4, "d_ff": 16, "vocab_size": 32, "num_experts": 0}
    cfg.update(over)
    return cfg


def test_model_flops_dense_by_hand():
    cfg = _cfg()
    # a layer: q, o 8x8 each; k, v 8x4 each; swiglu 3 x 8x16
    per_layer = 2 * (8 * 8 * 2 + 8 * 4 * 2) + 2 * 3 * 8 * 16
    # 3 tokens seeing 1 + 2 + 3 keys, the head on the last one
    want = 3 * 2 * per_layer + 2 * 8 * 32 + 2 * 4 * 2 * 4 * 6
    assert work.model_flops(cfg, 3, 6, 1) == want


def test_model_flops_moe_counts_routed_and_shared_only():
    dense = work.model_flops(_cfg(), 1, 1, 0)
    moe = work.model_flops(_cfg(num_experts=8, num_experts_per_tok=2,
                                num_shared_experts=1, moe_d_ff=4), 1, 1, 0)
    # each layer: the dense FFN out; the router 8x8, 2 routed and 1 shared
    # expert of width 4 in
    per = -2 * 3 * 8 * 16 + 2 * 8 * 8 + 3 * 2 * 3 * 8 * 4
    assert moe == dense + 2 * per


def test_model_flops_mamba_layer():
    cfg = _cfg(num_layers=1, ssm_type="mamba", attn_layer_period=8,
               attn_layer_offset=4, ssm_expand=2, ssm_state_dim=2,
               ssm_conv_width=4)
    d_in, r = 16, 1
    mixer = 2 * (8 * 2 * d_in + d_in * (r + 4) + r * d_in + d_in * 8) + \
        2 * 4 * d_in + 6 * d_in * 2 + d_in
    assert work.model_flops(cfg, 1, 1, 0) == mixer + 2 * 3 * 8 * 16
