"""Mixtral-8x22B [arXiv:2401.04088] — 8-expert top-2 MoE, GQA kv=8, SWA.
The port's copy of ``repro.configs.mixtral_8x22b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_type="swa",
    window_size=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=16384,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
))
