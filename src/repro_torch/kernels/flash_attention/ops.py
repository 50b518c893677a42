"""Public wrapper for flash attention.

``flash_attention(q, k, v, *, causal, window, softcap, scale, q_pos,
k_pos)`` keeps the JAX package's signature
(``repro.kernels.flash_attention.flash_attention``): q [B, H, Sq, hd],
k and v [B, KV, Skv, hd] with H % KV == 0, output [B, H, Sq, hd] in q's
dtype (float32 or bfloat16).  It adds optional int32 positions, q_pos
[Sq] or [B, Sq] and k_pos [Skv] or [B, Skv] (default: arange), for the
model's decode over a ring-buffer cache; ``ref.py`` states the mask.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``, built at first use) or raises; on a CPU
tensor it runs the plain version in ``ref.py``.  There is no other path.
The kernel reads q, k and v through their strides (unit stride along
hd), so a transposed view of the model's [B, S, H, hd] activations costs
no copy; its output has q's memory layout.  It supports head dims 64,
128 and 256.  Forward only: the serving path needs no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_pos, k_pos):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B, H, Sq, hd] and k, v [B, KV, Skv, "
                         f"hd], got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[1] == 0 \
            or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head dim, H % KV == 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, one "
                        f"dtype for q, k and v; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, pos, n in (("q_pos", q_pos, Sq), ("k_pos", k_pos, k.shape[2])):
        if pos is None:
            continue
        if pos.dtype != torch.int32 or pos.shape[-1:] != (n,) \
                or pos.dim() > 2 or (pos.dim() == 2 and pos.shape[0] != B):
            raise ValueError(f"{name} must be int32 [{n}] or [{B}, {n}], got "
                             f"{pos.dtype} {tuple(pos.shape)}")
        if pos.device != q.device:
            raise ValueError(f"{name} on {pos.device}, q on {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention inputs on {q.device}, {k.device} "
                         f"and {v.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """``t`` as the kernel reads it: unit stride along hd and every
    other stride and the base on 16 bytes (a copy only where not)."""
    size = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(s * size % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.contiguous()


def _launch(q, k, v, causal, window, softcap, scale, q_pos, k_pos):
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if B > 65535 or KV > 65535:
        raise ValueError(f"B={B} or KV={KV} exceed the kernel's grid")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _aligned(torch.empty_like(q))
    pos = [None if p is None else p.contiguous() for p in (q_pos, k_pos)]
    pos_b = [0 if p is None or p.dim() == 1 else p.stride(0) for p in pos]
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *pos_b)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *(None if p is None else p.data_ptr() for p in pos),
                 int(q.dtype == torch.bfloat16), B, H, KV, Sq, Skv, hd,
                 strides, int(causal), int(window or 0), float(softcap or 0.0),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=None, softcap=0.0,
                    scale=None, q_pos=None, k_pos=None):
    """Attention of q over k, v (module doc); [B, H, Sq, hd]."""
    _check(q, k, v, q_pos, k_pos)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        if q.numel() == 0:
            return torch.empty_like(q)
        return _launch(q, k, v, causal, window, softcap, scale, q_pos, k_pos)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale, q_pos=q_pos,
                                   k_pos=k_pos)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
flash_attention.launches = 0
