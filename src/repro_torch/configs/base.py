"""Config system of the LM zoo: every architecture is an instance of
ModelConfig, registered under its --arch id.  The port's copy of
``repro.configs.base``: the dataclasses, ``param_counts`` and the input
shapes are the reference's, field for field.

The port registers every architecture of the reference
(``configs/__init__.py``).  ``get_config`` also answers the paper's MLP
names with their ``MLPConfig`` (``configs/paper_mlp.py``), as the
reference's one registry does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class VFLConfig:
    """De-VertiFL protocol knobs (the paper's technique).

    enabled: vertical-federated input block (feature-sharded embedding +
        HiddenOutputExchange psum) is used in the forward pass.
    exchange: 'zeropad_psum'  — paper-faithful: each client materializes a
                               full-width zero-padded hidden and the
                               exchange sums them (Algorithm 2).
              'allgather'     — beyond-paper optimized: clients exchange
                               only their owned slices (same semantics,
                               1/n collective bytes). Used in §Perf.
    fedavg_every: local steps between FedAvg parameter pmeans over the
        federated axis (paper: E epochs per round). 0 = every step
        (standard data-parallel equivalent).
    """
    enabled: bool = True
    exchange: str = "zeropad_psum"
    fedavg_every: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | mlp
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # ---- attention variants ----
    attn_type: str = "full"          # full | swa | local_global | none
    window_size: int = 4096
    attn_logit_softcap: float = 0.0  # 0 = off (gemma2: 50.0)
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    moe_every: int = 1               # MoE on layers where (l % moe_every == moe_offset)
    moe_offset: int = 0
    first_layer_dense_ff: int = 0    # deepseek: dense FFN width on layer 0
    router_aux_weight: float = 0.01
    expert_capacity_factor: float = 1.25
    # ---- hybrid / SSM ----
    ssm_type: str = ""               # '' | 'mamba' | 'rwkv6'
    attn_layer_period: int = 0       # jamba: 1 attn layer per period
    attn_layer_offset: int = 0
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # ---- enc-dec / modality ----
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    modality: str = "text"           # text | vision_text | audio_text
    num_prefix_embeddings: int = 0   # VLM patch tokens / audio frames per sample
    # ---- misc ----
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu | relu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # '' = full remat; 'save_mixer_ffn' = keep per-block mixer/FFN
    # outputs (the TP-psum'd tensors) so backward does not re-run their
    # collectives (EXPERIMENTS.md section Perf iter 6)
    remat_policy: str = ""
    scan_layers: bool = True
    # ---- De-VertiFL ----
    vfl: VFLConfig = field(default_factory=VFLConfig)
    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def sub_quadratic_decode(self) -> bool:
        """Eligible for long_500k: SSM/hybrid, or windowed attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_type in ("swa", "local_global")

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step; enc-dec does."""
        return True  # all assigned archs decode (seamless decodes text)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------- parameter counting (for roofline MODEL_FLOPS) ----------
    def param_counts(self) -> dict:
        """Returns dict with total and active (per-token) parameter counts."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n_ff_mats = 3 if self.act == "swiglu" else 2

        def attn_params():
            return D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D

        def dense_ffn(f):
            return n_ff_mats * D * f

        def mamba_params():
            d_in = self.ssm_expand * D
            p = D * 2 * d_in                       # in_proj (x, z)
            p += d_in * self.ssm_conv_width        # conv
            p += d_in * (2 * self.ssm_state_dim + 1)  # B, C, dt(rank-1 simplified)
            p += d_in * D                          # out_proj
            p += d_in * self.ssm_state_dim         # A
            return p

        def rwkv_params():
            # time-mix: r,k,v,g,o projections + decay lora; channel-mix 2 mats
            tm = 5 * D * D + 2 * D * 64
            cm = 2 * D * int(3.5 * D) if self.d_ff == 0 else (2 * D * self.d_ff)
            return tm + cm

        total = 0
        active = 0
        emb = V * D * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb

        layers = range(self.num_layers)
        for l in layers:
            if self.family == "ssm" and self.ssm_type == "rwkv6":
                p = rwkv_params()
                total += p; active += p
                continue
            is_attn = True
            if self.attn_layer_period:
                is_attn = (l % self.attn_layer_period) == self.attn_layer_offset
            if self.family == "ssm":
                is_attn = False
            if is_attn and self.attn_type != "none":
                p = attn_params()
                total += p; active += p
            elif self.ssm_type == "mamba":
                p = mamba_params()
                total += p; active += p
            # FFN / MoE
            is_moe = (self.num_experts > 0
                      and (l % self.moe_every) == self.moe_offset
                      and not (l == 0 and self.first_layer_dense_ff))
            if l == 0 and self.first_layer_dense_ff:
                p = dense_ffn(self.first_layer_dense_ff)
                total += p; active += p
            elif is_moe:
                f = self.moe_d_ff or F
                per_expert = dense_ffn(f)
                total += self.num_experts * per_expert
                active += self.num_experts_per_tok * per_expert
                total += self.num_shared_experts * per_expert
                active += self.num_shared_experts * per_expert
                total += D * self.num_experts     # router
                active += D * self.num_experts
            else:
                p = dense_ffn(F)
                total += p; active += p
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder already counted adds cross-attn
            enc = self.num_encoder_layers * (attn_params() + dense_ffn(F))
            cross = self.num_layers * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": total, "active": active}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str):
    from repro_torch import configs as _c
    from repro_torch.configs import paper_mlp
    _c.load_all()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in paper_mlp.CONFIGS:
        return paper_mlp.get_config(name)
    raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")


def list_configs() -> list:
    from repro_torch import configs as _c
    from repro_torch.configs import paper_mlp
    _c.load_all()
    return sorted([*_REGISTRY, *paper_mlp.CONFIGS.names()])


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
