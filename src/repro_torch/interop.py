"""Moving parameter trees between the JAX package and the port.

Both keep every client's parameters stacked on a leading axis in the
same tree, ``{"layer_i": {"kernel": [n, in, out], "bias": [n, out]}}``,
so crossing over is a copy with no transposes.  Arrays cross as numpy;
nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device) -> dict:
    """A tree of arrays (numpy, or anything ``np.asarray`` takes) as
    float32 tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def params_to_numpy(tree) -> dict:
    """A tree of tensors as numpy arrays (copied to the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
