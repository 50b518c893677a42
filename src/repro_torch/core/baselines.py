"""Centralized VFL baselines the paper compares against (Table II): the
port of ``repro.core.baselines``.

SplitNN-style split learning: each client owns a bottom network over
ITS OWN features (no zero-padding); a designated server concatenates
the client embeddings and trains the top; gradients flow back through
the cut layer (joint training).  The bottoms and the top are plain
dense products (``torch.matmul``), as the reference computes them
outside any Pallas kernel.

Randomness: the initial weights come from ``init_params(generator)``
(``train(key=seed)`` uses the init stream of ``train_generators``); the
batch order is the reference's own numpy stream,
``np.random.default_rng(cfg.seed).permutation(n)[:nb * bs]`` per
epoch, so it is the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import partition as PT
from repro_torch.core.protocol import resolve_device, train_generators
from repro_torch.data import registry as DR
from repro_torch.interop import params_from_numpy
from repro_torch.metrics import accuracy, f1_score
from repro_torch.models import layers as L
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class SplitNNConfig:
    dataset: str = "bank"
    n_clients: int = 2
    rounds: int = 20
    epochs: int = 20
    batch_size: int = 64
    lr: float = 1e-3
    hidden: int = 10
    seed: int = 0
    n_samples: Optional[int] = None


class SplitNN:
    """Split learning on ``device`` (CUDA unless the caller names
    another; there is no fallback)."""

    def __init__(self, cfg: SplitNNConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        xtr, ytr, xte, yte = DR.make_dataset(cfg.dataset, cfg.n_samples,
                                             seed=cfg.seed)
        self.xtr, self.ytr, self.xte, self.yte = xtr, ytr, xte, yte
        self.n_features = xtr.shape[1]
        self.n_classes = DR.get_dataset(cfg.dataset).n_classes
        self.partition = PT.make_partition(cfg.dataset, self.n_features,
                                           cfg.n_clients, seed=cfg.seed)
        self._cols = [torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                      device=self.device)
                      for idx in self.partition]
        self.bs = min(cfg.batch_size, len(xtr))
        self.n_batches = len(xtr) // self.bs
        self.opt = adam(cfg.lr, max_grad_norm=None)

    def init_params(self, generator) -> dict:
        """Bottoms in client order, then top_1 and top_2, drawn from
        ``generator`` as ``repro.models.layers.dense_init`` draws them
        (normal * scale, zero bias); on the device."""
        cfg = self.cfg
        params = {}
        for i, idx in enumerate(self.partition):
            params[f"bottom_{i}"] = L.dense_init(
                generator, len(idx), cfg.hidden, bias=True,
                scale=(2.0 / max(len(idx), 1)) ** 0.5)
        params["top_1"] = L.dense_init(generator,
                                       cfg.hidden * cfg.n_clients,
                                       cfg.hidden, bias=True)
        params["top_2"] = L.dense_init(generator, cfg.hidden,
                                       self.n_classes, bias=True)
        return tree_map(lambda t: t.to(self.device), params)

    def _forward(self, params, x):
        hs = [torch.relu(L.dense(params[f"bottom_{i}"],
                                 x.index_select(1, cols)))
              for i, cols in enumerate(self._cols)]
        h = torch.cat(hs, dim=-1)               # server-side concat
        h = torch.relu(L.dense(params["top_1"], h))
        return L.dense(params["top_2"], h)

    def _step(self, params, opt_state, xb, yb, i):
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        logp = torch.log_softmax(self._forward(ps, xb), dim=-1)
        loss = -logp.gather(-1, yb[:, None]).mean()
        grads = tree_unflatten(ps, torch.autograd.grad(loss,
                                                       tree_leaves(ps)))
        params, opt_state, _ = self.opt.update(grads, opt_state, params, i)
        return params, opt_state, loss.detach()

    @torch.no_grad()
    def predict(self, params, x):
        """[B] class predictions (numpy) from the server-side forward."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                            device=self.device)
        return torch.argmax(self._forward(params, x), dim=-1).cpu().numpy()

    def train(self, key=None, return_state=False, params=None):
        """Train; returns {"f1", "acc"}, or (metrics, params) with
        ``return_state=True``.  ``key`` is an int seed for the initial
        weights (default ``cfg.seed``); ``params`` an initial tree of
        arrays in their place (e.g. the reference's ``init_params``)."""
        cfg = self.cfg
        if params is None:
            seed = cfg.seed if key is None else key
            params = self.init_params(train_generators(seed)[0])
        else:
            params = params_from_numpy(params, self.device)
        opt_state = self.opt.init(params)
        rng = np.random.default_rng(cfg.seed)
        n, bs, nb = len(self.xtr), self.bs, self.n_batches
        xtr = torch.as_tensor(self.xtr, dtype=torch.float32,
                              device=self.device)
        ytr = torch.as_tensor(self.ytr, dtype=torch.int64,
                              device=self.device)
        i = 0
        for _ in range(cfg.rounds):
            for _ in range(cfg.epochs):
                order = torch.as_tensor(rng.permutation(n)[:nb * bs],
                                        device=self.device)
                for b in range(nb):
                    sl = order[b * bs:(b + 1) * bs]
                    params, opt_state, _ = self._step(
                        params, opt_state, xtr[sl], ytr[sl], i)
                    i += 1
        preds = self.predict(params, self.xte)
        avg = "macro" if self.n_classes > 2 else "binary"
        metrics = {"f1": f1_score(self.yte, preds, average=avg),
                   "acc": accuracy(self.yte, preds)}
        return (metrics, params) if return_state else metrics
