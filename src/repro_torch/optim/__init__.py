from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, sgd, clip_by_global_norm,
    clip_by_global_norm_tree,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant_schedule, cosine_schedule, linear_warmup_cosine,
)
