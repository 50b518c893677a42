from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, sgd, clip_by_global_norm,
)
