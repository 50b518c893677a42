"""Gemma2-2B [arXiv:2408.00118] — alternating local(SWA 4096)/global
attention, attn & final logit softcaps, GQA kv=4, head_dim 256.
The port's copy of ``repro.configs.gemma2_2b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_type="local_global",
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118",
))
