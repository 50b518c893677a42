"""Qwen2-7B [arXiv:2407.10671] — dense GQA decoder, QKV bias.
The port's copy of ``repro.configs.qwen2_7b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    attn_type="full",
    rope_theta=1_000_000.0,
    act="swiglu",
    norm_type="rmsnorm",
    source="arXiv:2407.10671",
))


# Beyond-assignment variant: sliding-window attention unlocks the
# long_500k decode shape for this otherwise full-attention arch (the
# assigned config above is untouched; see DESIGN.md section 4).
CONFIG_SWA = register(CONFIG.replace(
    name="qwen2-7b-swa",
    attn_type="swa",
    window_size=4096,
))
