"""Architecture configs of the port.  Each architecture lives in its own
module and registers itself on import; ``load_all()`` imports every
module once.  The port of ``repro.configs``, every family of it: dense
(qwen2, qwen1.5, gemma2), MoE (deepseek-moe, mixtral), ssm (rwkv6),
hybrid (jamba), vlm (llava-next) and audio (seamless-m4t).  The
paper's MLPs keep their own ``MLPConfig`` registry in ``paper_mlp``."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    VFLConfig,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs.paper_mlp import MLPConfig  # noqa: F401

_MODULES = ["qwen2_7b", "qwen1_5_0_5b", "qwen1_5_4b", "gemma2_2b",
            "deepseek_moe_16b", "mixtral_8x22b", "rwkv6_1b6",
            "jamba_v0_1_52b", "llava_next_34b", "seamless_m4t_medium"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
