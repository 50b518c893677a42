"""The paper's own model: an MLP with 3 hidden layers (10 neurons each)
and an output head, as in De-VertiFL section IV.  The port of
``repro.models.mlp_model.PaperMLP``.

One module holds every client's copy of the model, stacked on a
leading client axis: ``params()["layer_i"]["kernel"]`` is
[n_clients, in, out] and ``["bias"]`` is [n_clients, out], exactly the
JAX package's vmapped parameter tree, so carrying weights across is a
copy.  Every forward method runs all clients at once on a [n, B, .]
activation stack, and takes an optional ``params`` tree in that layout
in place of the module's own parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L


class PaperMLP(nn.Module):
    def __init__(self, cfg, n_clients: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.n_clients = n_clients
        self.in_features = cfg.in_features
        self.hidden = cfg.hidden
        self.n_hidden = cfg.n_hidden
        self.n_classes = cfg.n_classes
        self.dims = ([self.in_features] + [self.hidden] * self.n_hidden
                     + [self.n_classes])
        self.layers = nn.ModuleList()
        for i in range(len(self.dims) - 1):
            layer = nn.Module()
            layer.kernel = nn.Parameter(torch.zeros(
                (n_clients, self.dims[i], self.dims[i + 1]),
                device=device))
            layer.bias = nn.Parameter(torch.zeros(
                (n_clients, self.dims[i + 1]), device=device))
            self.layers.append(layer)

    def params(self) -> dict:
        """The module's parameters as the JAX-layout tree (live
        references, not copies)."""
        return {f"layer_{i}": {"kernel": layer.kernel, "bias": layer.bias}
                for i, layer in enumerate(self.layers)}

    @torch.no_grad()
    def load_params(self, params) -> None:
        """Copy a JAX-layout tree into the module's parameters."""
        for name, layer in self.params().items():
            layer["kernel"].copy_(params[name]["kernel"])
            layer["bias"].copy_(params[name]["bias"])

    def init_params(self, generator) -> dict:
        """A fresh stacked tree (CPU tensors): client by client, layer
        by layer, ``normal * sqrt(2/in)`` with zero biases from
        ``generator``.  Clients draw in slot order, so the live
        clients' weights do not depend on how many dead padding slots
        follow them."""
        per_client = [
            [L.dense_init(generator, self.dims[i], self.dims[i + 1],
                          bias=True, scale=(2.0 / self.dims[i]) ** 0.5)
             for i in range(len(self.dims) - 1)]
            for _ in range(self.n_clients)]
        return {f"layer_{i}": {
                    k: torch.stack([c[i][k] for c in per_client])
                    for k in ("kernel", "bias")}
                for i in range(len(self.dims) - 1)}

    def forward_from(self, h, start=0, upto=None, params=None):
        """Hidden layers [start, upto) on a [n, B, .] stack: h is the
        input when start=0, else the post-ReLU output of hidden layer
        start-1.  The slice-aware first-layer lanes compute layer 0 per
        client slice and continue here with start=1."""
        p = params if params is not None else self.params()
        n = self.n_hidden if upto is None else upto
        for i in range(start, n):
            h = torch.relu(L.dense(p[f"layer_{i}"], h))
        return h

    def forward_hidden(self, x, upto=None, params=None):
        """Forward through hidden layers; upto=k stops after hidden
        layer k (used by the exchange)."""
        return self.forward_from(x, 0, upto, params=params)

    def head(self, h, params=None):
        p = params if params is not None else self.params()
        return L.dense(p[f"layer_{self.n_hidden}"], h)
