from repro_torch.configs.paper_mlp import (  # noqa: F401
    MLPConfig, get_config,
)
