from repro_torch.kernels.vfl_matmul.ops import (  # noqa: F401
    vfl_matmul, vfl_matmul_clients,
)
from repro_torch.kernels.vfl_matmul.ref import (  # noqa: F401
    vfl_matmul_clients_ref, vfl_matmul_ref,
)
