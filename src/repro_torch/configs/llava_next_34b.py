"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-mistral-7b-hf lineage] — VLM:
Yi-34B-style dense decoder backbone consuming anyres-tiled patch
embeddings from a stubbed vision frontend (ViT + projector not
implemented in either package; the caller passes projected patch
embeddings as ``prefix_emb``).

anyres: base 576 patches + 4 tiles x 576 = 2880 image tokens/sample.
The port's copy of ``repro.configs.llava_next_34b``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attn_type="full",
    modality="vision_text",
    num_prefix_embeddings=2880,
    rope_theta=5_000_000.0,
    act="swiglu",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
