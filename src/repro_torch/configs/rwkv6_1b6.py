"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free RNN with
data-dependent decay (ddlerp token shift + LoRA decay), head_dim 64.
The port's copy of ``repro.configs.rwkv6_1b6``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    ssm_type="rwkv6",
    num_layers=24,
    d_model=2048,
    num_heads=32,           # 2048 / 64 wkv heads
    num_kv_heads=32,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=7168,              # channel-mix hidden (3.5x)
    vocab_size=65536,
    attn_type="none",
    act="relu",             # channel-mix uses relu^2
    norm_type="layernorm",
    source="arXiv:2404.05892",
))
