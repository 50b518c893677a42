"""Cost counting without HLO: the counterpart of the reference's
``roofline.hlo_costs.analyze`` for the port, which has no compiled
program to parse.

``CostCounter`` is a ``TorchDispatchMode``: every aten op that runs
under it is counted once per execution, so a Python loop over layers
(and the remat recompute) is counted once per iteration, which is what
``hlo_costs`` rebuilds from while-loop trip counts.

- FLOPs: ``torch.utils.flop_counter``'s registered formulas (matmuls,
  convolutions, SDPA), kept by the type they run in (bf16 or fp16 on
  the tensor cores, the rest at the float32 rate).
- Bytes: the inputs plus outputs of each op that moves data (views and
  allocations move none; an in-place op's output is its input): every
  intermediate round-trips through HBM, so this is the unfused upper
  bound.
- Kernels: ``meta_hooks`` gives the model's kernel hooks (``attend``,
  ``route``, ``wkv``, ``sscan``) for meta tensors.  Each returns empty
  outputs of the kernel's shapes and adds the kernel's work
  (``roofline.work``) to the counter; their backward adds
  ``BACKWARD_FACTOR`` times the forward's operations and bytes, the
  rule of a GEMM, whose backward is two products of its size.  (The
  port's backward recomputes the plain version, ``kernels/grad.py``, so
  for that part the counted bound is low.)  The plain versions are
  never run on meta tensors: the scans loop over T in Python.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import work as W

BACKWARD_FACTOR = 2
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_aten = torch.ops.aten
# ops that move no data: allocations and aliases
_NO_DATA = {_aten.empty, _aten.empty_like, _aten.empty_strided,
            _aten.new_empty, _aten.new_empty_strided, _aten.detach,
            _aten.lift_fresh, _aten.alias, _aten._local_scalar_dense,
            _aten.sym_size, _aten.sym_stride, _aten.sym_numel}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts what runs under it (module doc).  ``totals()`` gives
    ``flops`` (of which ``fp32_flops`` outside the tensor cores),
    ``bytes`` and each kernel's calls, flops and bytes; ``op_flops``
    the FLOPs by aten op."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.fp32_flops = 0.0
        self.bytes = 0.0
        self.kernels = collections.defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self.op_flops = collections.Counter()

    def add_flops(self, flops, dtype):
        self.flops += flops
        if dtype not in TENSOR_CORE_DTYPES:
            self.fp32_flops += flops

    def add_kernel(self, name, flops, nbytes, dtype, calls=1):
        k = self.kernels[name]
        k["calls"] += calls
        k["flops"] += flops
        k["bytes"] += nbytes
        self.add_flops(flops, dtype)
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.add_flops(flops, _tensors(args)[0].dtype)
            self.op_flops[str(packet)] += flops
        if not func.is_view and packet not in _NO_DATA:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            if not func._schema.is_mutable:     # else out is an input
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out

    def totals(self) -> dict:
        return {"flops": self.flops, "fp32_flops": self.fp32_flops,
                "bytes": self.bytes,
                "kernels": {n: dict(k) for n, k in self.kernels.items()}}


class _Counted(torch.autograd.Function):
    """A kernel call on meta tensors: ``make()`` builds its empty
    outputs, its work goes to the counter, and its backward counts
    BACKWARD_FACTOR times that work and gives empty gradients."""

    @staticmethod
    def forward(ctx, counter, name, work, make, *inputs):
        ctx.counter, ctx.name, ctx.work = counter, name, work
        ctx.specs = [None if t is None else (t.shape, t.dtype)
                     for t in inputs]
        counter.add_kernel(name, *work)
        outs = make()
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        flops, nbytes, dtype = ctx.work
        ctx.counter.add_kernel(ctx.name + " backward",
                               BACKWARD_FACTOR * flops,
                               BACKWARD_FACTOR * nbytes, dtype)
        return (None, None, None, None) + tuple(
            torch.empty(s[0], dtype=s[1], device="meta")
            if need and s is not None else None
            for s, need in zip(ctx.specs, ctx.needs_input_grad[4:]))


def _call(counter, name, work, make, *inputs):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _Counted.apply(counter, name, work, make, *inputs)
    counter.add_kernel(name, *work)
    return make()


def meta_hooks(counter) -> dict:
    """The four kernel hooks of ``Model`` for meta tensors, counting
    into ``counter`` (module doc)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def attend(q, k, v, *, causal=True, window=None, softcap=0.0,
               scale=None, q_pos=None, k_pos=None):
        flops, nbytes = W.attention_work(q, k, causal, window, q_pos, k_pos)
        out, = _call(counter, "flash_attention", (flops, nbytes, q.dtype),
                     lambda: (torch.empty_like(q),), q, k, v)
        return out

    def route(logits, k, bt=128):
        T, E = logits.shape
        nbytes, ops = W.router_work(T, E, k)
        n_tiles = -(-T // min(bt, T))
        return _call(counter, "moe_router", (ops, nbytes, torch.float32),
                     lambda: (empty((T, k), torch.float32),
                              empty((T, k), torch.int32),
                              empty((n_tiles, E), torch.float32)), logits)

    def wkv(r, k, v, w, u, state=None, *, state_out=None):
        B, T, H, hd = r.shape
        nbytes, ops = W.rwkv6_scan_work(r, u, state is not None)
        return _call(counter, "rwkv6_scan", (ops, nbytes, torch.float32),
                     lambda: (empty((B, T, H, hd), r.dtype),
                              empty((B, H, hd, hd), torch.float32)),
                     r, k, v, w, u, state)

    def sscan(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
        B, T, D = dt.shape
        nbytes, ops, _ = W.mamba_scan_fused_work(dt, x, Bm, A, h0)
        return _call(counter, "mamba_scan_fused",
                     (ops, nbytes, torch.float32),
                     lambda: (empty((B, T, D), torch.float32),
                              empty((B, D, A.shape[1]), torch.float32)),
                     dt, x, Bm, Cm, A, h0)

    return {"attend": attend, "route": route, "wkv": wkv, "sscan": sscan}
