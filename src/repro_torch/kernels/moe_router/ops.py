"""Public wrapper for the MoE router.

``moe_router(logits, k, *, bt=128)`` keeps the JAX package's signature
(``repro.kernels.moe_router.moe_router``): logits float32 [T, E] ->
(weights [T, k] float32, indices [T, k] int32, stats [ceil(T / bt), E]
float32), the semantics of ``moe_router_ref`` (``ref.py``): a softmax
over E, the k largest probabilities with ``lax.top_k``'s order, weights
renormalised over the picks, and per-tile (routed count + probability
mass) stats.  It takes any T >= 1 (the Pallas kernel asks T % bt == 0),
E <= 256 and k <= 8.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/moe_router.cu``, built at first use) or raises; on a CPU tensor
it runs the plain version in ``ref.py``.  There is no other path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.moe_router.ref import moe_router_ref

MAX_E = 256
MAX_K = 8


def _check(logits, k, bt):
    if logits.dim() != 2 or logits.shape[0] < 1:
        raise ValueError(f"expected logits [T, E] with T >= 1, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_router takes float32 logits, got "
                        f"{logits.dtype}")
    E = logits.shape[1]
    if not 1 <= E <= MAX_E:
        raise ValueError(f"moe_router takes 1 to {MAX_E} experts, got {E}")
    if not 1 <= k <= min(MAX_K, E):
        raise ValueError(f"moe_router takes 1 <= k <= min({MAX_K}, E={E}), "
                         f"got k={k}")
    if bt < 1:
        raise ValueError(f"bt must be positive, got {bt}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("moe_router").moe_router_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(logits, k, bt):
    T, E = logits.shape
    if T > 2 ** 31 - 1 - bt:
        raise ValueError(f"T={T} exceeds the kernel's int32 row count")
    logits = logits.contiguous()
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    stats = torch.empty((-(-T // bt), E), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 stats.data_ptr(), T, E, k, bt, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err}")
    moe_router.launches += 1
    return w, idx, stats


def moe_router(logits, k, *, bt=128):
    """Softmax + top-k + renormalise + per-tile stats (module doc)."""
    _check(logits, k, bt)
    bt = min(bt, logits.shape[0])
    if logits.device.type == "cuda":
        return _launch(logits, k, bt)
    if logits.device.type == "cpu":
        return moe_router_ref(logits, k, bt=bt)
    raise ValueError(f"moe_router runs on cuda or cpu, not {logits.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
moe_router.launches = 0
