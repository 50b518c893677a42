from repro_torch.kernels.mamba_scan.ops import (  # noqa: F401
    mamba_scan, mamba_scan_fused,
)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: F401
    mamba_scan_fused_ref, mamba_scan_ref,
)
