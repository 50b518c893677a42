"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, MHA (kv=16), QKV bias.
The port's copy of ``repro.configs.qwen1_5_0_5b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    attn_type="full",
    rope_theta=1_000_000.0,
    act="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
))
