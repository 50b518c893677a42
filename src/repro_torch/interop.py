"""Moving parameter trees and decode states between the JAX package and
the port.

Both keep the same trees: the federation's clients stacked on a leading
axis (``{"layer_i": {"kernel": [n, in, out], "bias": [n, out]}}``), and
the LM's ``vfl_embedding`` / ``lm_head`` / ``final_norm`` /
``stack.scanned.sub_j...`` with a leading [n_groups] axis under
``scanned`` (an encoder-decoder's ``encoder.stack`` and
``encoder.final_norm`` the same way, its decode state's ``enc`` a plain
leaf), so crossing over is a copy with no transposes.  An optimizer state
(Adam's ``{"mu": tree, "nu": tree}``) and a tree stacked on a leading
axis (the LM's pods) cross the same way, leaf by leaf.  Arrays
cross as numpy (bfloat16 as ``ml_dtypes``' bfloat16, which is what
``np.asarray`` gives for a JAX bfloat16 array); nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def tensor_from_array(a, device, dtype):
    """One array as a tensor on ``device`` (in ``dtype``, or its own
    when None; bfloat16 arrays through their uint16 bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=torch.float32) -> dict:
    """A tree of arrays (numpy, or anything ``np.asarray`` takes) as
    tensors on ``device``: in ``dtype``, or each in its own dtype when
    ``dtype`` is None (an LM's bfloat16 weights, a cache's int32
    positions)."""
    return tree_map(lambda a: tensor_from_array(a, device, dtype), tree)


def array_from_tensor(t):
    """One tensor as a host numpy array in its own dtype (bfloat16 as
    ``ml_dtypes``' bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # numpy's bfloat16, as the reference's arrays
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree) -> dict:
    """A tree of tensors as numpy arrays (copied to the host), each in
    its own dtype: bfloat16 leaves as ``ml_dtypes``' bfloat16 (imported
    only for them), the inverse of ``params_from_numpy(..., dtype=None)``."""
    return tree_map(array_from_tensor, tree)


def state_to_numpy(state) -> dict:
    """The port's decode state (``{"cache": ..., "position": [B]}``) as
    numpy, bfloat16 leaves widened to float32 (numpy has no bfloat16 of
    its own), for comparison with the reference's.  The other way is
    ``params_from_numpy(state, device, dtype=None)``."""
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16
                               else t).detach().cpu().numpy(), state)
