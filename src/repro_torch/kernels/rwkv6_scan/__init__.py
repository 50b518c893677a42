from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: F401
