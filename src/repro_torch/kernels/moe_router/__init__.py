from repro_torch.kernels.moe_router.ops import moe_router  # noqa: F401
from repro_torch.kernels.moe_router.ref import moe_router_ref  # noqa: F401
