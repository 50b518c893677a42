"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family] — dense, MHA (kv=20), QKV bias.
The port's copy of ``repro.configs.qwen1_5_4b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    attn_type="full",
    rope_theta=1_000_000.0,
    act="swiglu",
    source="hf:Qwen/Qwen1.5-4B",
))


# Beyond-assignment SWA variant (unlocks long_500k; see DESIGN.md §4).
CONFIG_SWA = register(CONFIG.replace(
    name="qwen1.5-4b-swa",
    attn_type="swa",
    window_size=4096,
))
