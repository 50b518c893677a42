"""The LM kernels' gradients: each kernel's ``torch.autograd.Function``
runs the kernel forward and, in its backward, the gradient of the plain
version (``ref.py``) recomputed from the saved inputs with PyTorch ops.
The JAX package has no backward kernel for these either: its training
autodiffs plain JAX ops."""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs, grads, **kw):
    """The gradients of ``plain(*inputs, **kw)``'s outputs, weighted by
    ``grads``, for each input whose ``needs`` is set (None for the
    others and for None inputs)."""
    leaves = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        got = iter(torch.autograd.grad(plain(*leaves, **kw), wanted, grads))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)
