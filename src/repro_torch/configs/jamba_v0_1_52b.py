"""Jamba-v0.1 52B [arXiv:2403.19887] — hybrid Mamba+attention at 1:7
(one attention layer per period of 8, offset 4), MoE 16 experts top-2 on
every other layer, GQA kv=8.
The port's copy of ``repro.configs.jamba_v0_1_52b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    ssm_type="mamba",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_type="full",
    attn_layer_period=8,
    attn_layer_offset=4,
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=14336,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    act="swiglu",
    source="arXiv:2403.19887",
))
