"""Reduced variants of the dense architectures for CPU tests: 2 layers,
d_model 256, tiny vocab, float32.  Same code paths as the full configs.
The port's copy of ``repro.configs.reduced``, cut to the branches the
dense family takes (the MoE, SSM, hybrid and modality branches come
with those families)."""
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
    if cfg.attn_type in ("swa", "local_global"):
        kw.update(window_size=16)
    if cfg.num_heads and cfg.num_heads == cfg.num_kv_heads:
        kw.update(num_kv_heads=4)  # keep MHA archs MHA
    kw.update(extra)
    out = cfg.replace(**kw)
    object.__setattr__(out, "head_dim", 64)
    return out
