from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    combine_ref, decode_partials_ref, flash_attention_ref,
    tensor_core_emulation,
)
