# Hand-written Hopper kernels, one package each, beside the JAX
# package's Pallas kernels they replace:
#   vfl_matmul       -- the all-clients first-layer matmul (CUDA C++, sm_90a)
#   flash_attention  -- the LM's prefill and decode attention (CUDA C++,
#                       sm_90a)
#   moe_router       -- the MoE layer's softmax, top-k and load stats
#                       (CUDA C++, sm_90a)
#   rwkv6_scan       -- the RWKV6 time mix's WKV recurrence, state in and
#                       out (CUDA C++, sm_90a)
#   mamba_scan       -- the Mamba mixer's selective scan, state in and out,
#                       and its fused form that discretises in registers
#                       (CUDA C++, sm_90a)
# Each package: csrc/ (the CUDA source), ops.py (wrapper, launch count,
# and its autograd.Function: vfl_matmul's backward in PyTorch ops; the LM
# kernels' the plain version's gradient, grad.py), ref.py (the plain
# PyTorch version).  build.py compiles the sources with nvcc at first
# use.
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref,
)
from repro_torch.kernels.mamba_scan.ops import (  # noqa: F401
    mamba_scan, mamba_scan_fused,
)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: F401
    mamba_scan_fused_ref, mamba_scan_ref,
)
from repro_torch.kernels.moe_router.ops import moe_router  # noqa: F401
from repro_torch.kernels.moe_router.ref import moe_router_ref  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: F401
from repro_torch.kernels.vfl_matmul.ops import (  # noqa: F401
    vfl_matmul, vfl_matmul_clients,
)
from repro_torch.kernels.vfl_matmul.ref import (  # noqa: F401
    vfl_matmul_clients_ref, vfl_matmul_ref,
)
