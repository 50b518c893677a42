"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder; the speech
frontend (mel + conformer feature extractor) is a stub in both
packages: the caller passes precomputed frame embeddings as
``prefix_emb`` to the text encoder/decoder transformer.
12 encoder + 12 decoder layers, d_model 1024, MHA kv=16.
The port's copy of ``repro.configs.seamless_m4t_medium``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,              # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attn_type="full",
    modality="audio_text",
    num_prefix_embeddings=1024,  # encoder frames per sample
    act="relu",
    norm_type="layernorm",
    source="arXiv:2308.11596",
))
