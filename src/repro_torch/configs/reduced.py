"""Reduced variants of each architecture for CPU tests: 2 layers (the
hybrid 4, one attention layer per period of 2; an encoder-decoder also
2 encoder layers), d_model 256, <=4 experts, 8 image rows or 16 frames,
tiny vocab, float32.  Same code paths as the full configs.  The port's
copy of ``repro.configs.reduced``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def reduced_config(name: str, **extra) -> ModelConfig:
    cfg = get_config(name)
    kw = dict(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        remat=False,
        dtype="float32",
    )
    if cfg.family == "moe":
        # generous capacity: routing is lossless at test token counts
        # (the reference's choice; the tests also run the default 1.25,
        # which drops pairs)
        kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=128,
                  expert_capacity_factor=8.0)
        if cfg.num_shared_experts:
            kw.update(num_shared_experts=1)
        if cfg.first_layer_dense_ff:
            kw.update(first_layer_dense_ff=256)
    if cfg.ssm_type == "rwkv6":
        kw.update(num_heads=4, num_kv_heads=4, rwkv_head_dim=64, d_ff=512)
    if cfg.family == "hybrid":
        kw.update(num_layers=4, attn_layer_period=2, attn_layer_offset=1,
                  num_experts=4, num_experts_per_tok=2, moe_every=2,
                  moe_offset=1, moe_d_ff=128, ssm_state_dim=8,
                  expert_capacity_factor=8.0)
    if cfg.attn_type in ("swa", "local_global"):
        kw.update(window_size=16)
    if cfg.modality == "vision_text":
        kw.update(num_prefix_embeddings=8)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2, num_prefix_embeddings=16)
    if cfg.num_heads and cfg.num_heads == cfg.num_kv_heads:
        kw.update(num_kv_heads=4)  # keep MHA archs MHA
    kw.update(extra)
    out = cfg.replace(**kw)
    object.__setattr__(out, "head_dim", 64)
    return out
