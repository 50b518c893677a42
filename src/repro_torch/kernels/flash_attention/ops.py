"""Public wrapper for flash attention.

``flash_attention(q, k, v, *, causal, window, softcap, scale, q_pos,
k_pos)`` keeps the JAX package's signature
(``repro.kernels.flash_attention.flash_attention``): q [B, H, Sq, hd],
k and v [B, KV, Skv, hd] with H % KV == 0, output [B, H, Sq, hd] in q's
dtype (float32 or bfloat16).  It adds optional int32 positions, q_pos
[Sq] or [B, Sq] and k_pos [Skv] or [B, Skv] (default: arange), for the
model's decode over a ring-buffer cache; ``ref.py`` states the mask.

On a CUDA tensor it launches a hand-written Hopper kernel (built at
first use) or raises; on a CPU tensor it runs the plain version in
``ref.py``.  There is no other path.  ``route`` picks the kernel from the
call's static shape and dtype, never by catching a failure:

- ``"split_k_wgmma"`` and ``"split_k"``, every call of at most
  ``DECODE_ROWS`` rows (a row is one (query, head) pair: a decode
  step): the kv axis cut into ``num_splits(Skv)`` splits of
  ``SPLIT_SLOTS`` slots, one block a (split, kv head, batch) writing
  float32 partials to a workspace allocated here, then a combine kernel
  (``csrc/flash_attention.cu``).  The partials run on the tensor cores
  for bfloat16 (``split_k_wgmma``, ``csrc/flash_attention_wgmma.cu``),
  on the CUDA cores for float32 (``split_k``).
- ``"wgmma"``, the other bfloat16 calls: the tensor cores, with the
  probabilities split into two bf16 parts so that the result stays
  float32-accurate (``csrc/flash_attention_wgmma.cu``; at head dim 256
  a block of two warpgroups, each owning half of the output's
  columns).
- ``"cuda_cores"``, the other float32 calls: ``csrc/flash_attention.cu``.

Each call counts one launch, whichever route (a split-K call runs two
kernels).  The kernels read q, k and v through their strides (unit
stride along hd), so a transposed view of the model's [B, S, H, hd]
activations costs no copy; the output has q's memory layout.  Head dims
64, 128 and 256.

Gradient: where q, k or v requires grad, a CUDA call runs through
``FlashAttentionFunction`` (a ``torch.autograd.Function``): its forward is the
kernel, launched and counted as above; its backward recomputes the
plain version (``FlashAttentionFunction.plain``, ``flash_attention_ref``)
from the saved q, k and v and differentiates it with PyTorch ops,
launching no kernel.  The JAX package's training autodiffs plain
attention and has no backward kernel either.  A call without grad
launches as before.  On the CPU autograd differentiates the plain
version directly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grad import needs_grad, plain_vjp

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


# a call of at most DECODE_ROWS rows takes a split-K route, whose kv
# splits are SPLIT_SLOTS slots (the kernels' SPLIT and MAX_ROWS)
DECODE_ROWS = 64
SPLIT_SLOTS = 256
# the head dims the tensor-core kernels take (flash_attention_wgmma.cu)
WGMMA_HEAD_DIMS = (64, 128, 256)


def route(Sq, group, hd, dtype) -> str:
    """The kernels a CUDA call of Sq queries, ``group`` heads a kv head,
    head dim hd and ``dtype`` runs (module doc)."""
    tensor_cores = dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
    if Sq * group <= DECODE_ROWS:
        return "split_k_wgmma" if tensor_cores else "split_k"
    return "wgmma" if tensor_cores else "cuda_cores"


def num_splits(Skv) -> int:
    """The split-K routes' kv splits: a function of Skv alone, so that a
    row's arithmetic does not depend on the batch."""
    return max(1, -(-Skv // SPLIT_SLOTS))


# C launcher -> (library, arguments after flash_attention_launch's own)
_LAUNCHERS = {
    "flash_attention_launch": ("flash_attention", []),
    "flash_attention_decode_launch":
        ("flash_attention", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2),
    "flash_attention_wgmma_launch": ("flash_attention_wgmma", []),
    "flash_attention_wgmma_partials_launch":
        ("flash_attention_wgmma", [ctypes.c_void_p] * 2 + [ctypes.c_int]),
}
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_float] * 2)


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """The C launcher ``name`` of ``_LAUNCHERS``, its library built at
    first use."""
    from repro_torch.kernels import build
    lib, extra = _LAUNCHERS[name]
    fn = getattr(build.load(lib), name)
    fn.argtypes = _ARGS + extra + [ctypes.c_void_p]
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


class _Call:
    """One call's operands as the kernels read them, and the output."""

    def __init__(self, q, k, v, causal, window, softcap, scale, q_pos,
                 k_pos):
        B, H, Sq, hd = q.shape
        KV, Skv = k.shape[1], k.shape[2]
        if hd not in HEAD_DIMS:
            raise ValueError(f"the flash_attention kernels take head dims "
                             f"{HEAD_DIMS}, got {hd}")
        if B > 65535 or KV > 65535:
            raise ValueError(f"B={B} or KV={KV} exceed the kernels' grid")
        self.q, self.k, self.v = _aligned(q), _aligned(k), _aligned(v)
        self.out = _aligned(torch.empty_like(q))
        self.pos = [None if p is None else p.contiguous()
                    for p in (q_pos, k_pos)]
        pos_b = [0 if p is None or p.dim() == 1 else p.stride(0)
                 for p in self.pos]
        self.strides = (ctypes.c_longlong * 14)(
            *self.q.stride()[:3], *self.k.stride()[:3], *self.v.stride()[:3],
            *self.out.stride()[:3], *pos_b)
        self.args = (int(q.dtype == torch.bfloat16), B, H, KV, Sq, Skv, hd,
                     self.strides, int(causal), int(window or 0),
                     float(softcap or 0.0), float(scale))

    def run(self, name, *extra):
        """Runs the C launcher ``name``; raises on a CUDA error."""
        with torch.cuda.device(self.q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel(name)(
                self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                self.out.data_ptr(),
                *(None if p is None else p.data_ptr() for p in self.pos),
                *self.args, *extra, stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed "
                               f"({name}): CUDA error {err}")


def _split_k(q, k, v, causal, window, softcap, scale, q_pos, k_pos,
             edit=None):
    """A split-K route: each split's partials (tensor cores for bf16,
    the CUDA cores for float32) into a float32 workspace,
    then the combine.  ``edit(ws_o, ws_ml)``, where given, runs between
    the two (a check's planted fault); ws_o is [B, KV, rows, splits, hd]
    and ws_ml [B, KV, rows, splits, 2] (max, denominator)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rows, splits = Sq * (H // KV), num_splits(Skv)
    call = _Call(q, k, v, causal, window, softcap, scale, q_pos, k_pos)
    ws_o = torch.empty((B, KV, rows, splits, hd), dtype=torch.float32,
                       device=q.device)
    ws_ml = torch.empty((B, KV, rows, splits, 2), dtype=torch.float32,
                        device=q.device)
    ws = (ws_o.data_ptr(), ws_ml.data_ptr(), splits)
    if route(Sq, H // KV, hd, q.dtype) == "split_k_wgmma":
        call.run("flash_attention_wgmma_partials_launch", *ws)
    else:
        call.run("flash_attention_decode_launch", *ws, 1)
    if edit is not None:
        edit(ws_o, ws_ml)
    call.run("flash_attention_decode_launch", *ws, 2)
    return call.out


def _launch(q, k, v, causal, window, softcap, scale, q_pos, k_pos):
    B, H, Sq, hd = q.shape
    which = route(Sq, H // k.shape[1], hd, q.dtype)
    args = (q, k, v, causal, window, softcap, scale, q_pos, k_pos)
    if which.startswith("split_k"):
        out = _split_k(*args)
    else:
        call = _Call(*args)
        call.run("flash_attention_wgmma_launch" if which == "wgmma"
                 else "flash_attention_launch")
        out = call.out
    flash_attention.launches += 1
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel forward, the plain version's gradient (module doc).
    ``plain`` is the function the backward recomputes (a subclass may
    put another, as a planted fault does)."""
    plain = staticmethod(flash_attention_ref)

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_pos,
                k_pos):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return _launch(q, k, v, causal, window, softcap, scale, q_pos,
                       k_pos)

    @classmethod
    def backward(cls, ctx, g):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        return plain_vjp(cls.plain, (q, k, v), ctx.needs_input_grad[:3], g,
                         q_pos=q_pos, k_pos=k_pos, **ctx.opts) + \
            (None,) * 6


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
        if needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, causal, window,
                                                softcap, scale, q_pos, k_pos)
        return _launch(q, k, v, causal, window, softcap, scale, q_pos, k_pos)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale, q_pos=q_pos,
                                   k_pos=k_pos)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


# calls that launched on the card since import or since the caller last
# set it to 0 (one a call, whichever route); the CPU path adds nothing
flash_attention.launches = 0
