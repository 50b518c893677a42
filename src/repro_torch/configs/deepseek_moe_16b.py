"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE: 64 routed
experts top-6 + 2 shared experts, expert d_ff=1408; layer 0 is a dense
FFN (width 10944 per the paper); MHA kv=16.
The port's copy of ``repro.configs.deepseek_moe_16b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    attn_type="full",
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_layer_dense_ff=10944,
    act="swiglu",
    source="arXiv:2401.06066",
))
