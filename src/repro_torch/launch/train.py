"""Training drivers: the port of ``repro.launch.train``.

make_train_step: one synchronous step: ``Model.loss`` and its gradient
by autograd (the kernels' forwards on the card, their backwards in
PyTorch ops: ``repro_torch.kernels``), then the optimizer's update,
which writes the new weights into the parameter tensors in place.

make_federated_train_step: the paper's protocol at pod scale -- each pod
is a "super-client" holding its own full replica of the weights (a
leading [n_pods] axis on every leaf of the parameters and the optimizer
state); local steps touch nothing across pods, and every
``fedavg_every`` steps the replicas are FedAvg'ed, Algorithm 1 lines
16-19.  The reference ``vmap``s the local step over the pod axis of one
mesh; here one card holds every replica and a Python loop runs each
pod's local step, which is ``make_train_step``'s on the pod's slice (its
clip over the pod's tree: per pod).

``shardings_for_train`` lays out a TPU mesh and is not ported
(ROADMAP.md, "Not to port").

Run as a script on the card at full size (qwen1.5-0.5b by default)::

  PYTHONPATH=src python -m repro_torch.launch.train --steps 50

On the CPU, at the reduced size::

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.protocol import resolve_device
from repro_torch.data import markov_lm_batches
from repro_torch.models import build_model
from repro_torch.optim import adam, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_train_step(model, opt):
    """``step(params, opt_state, step: int, batch) -> (params, opt_state,
    step + 1, metrics)``; metrics ``loss``, ``ce``, ``aux``, ``tokens``
    and ``grad_norm`` as tensors on the device (the caller syncs)."""
    def train_step(params, opt_state, step, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, met = model.loss(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)])
        params, opt_state, om = opt.update(grads, opt_state, params, step)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in met.items()}, **om}
        return params, opt_state, step + 1, metrics
    return train_step


def make_federated_train_step(model, opt, n_pods, fedavg_every):
    """Params and optimizer state carry a leading [n_pods] axis; batch
    leaves are [n_pods, B / n_pods, ...].  ``opt`` clips the whole tree
    (``adam(..., per_client=False)``): on a pod's slice that is the
    per-pod clip of the reference's vmapped update."""
    if opt.per_client:
        raise ValueError("make_federated_train_step runs each pod's step "
                         "on its own slice: pass an optimizer that clips "
                         "the whole tree (per_client=False)")
    local = make_train_step(model, opt)

    def train_step(params_f, opt_state_f, step, batch_f):
        losses = []
        for pod in range(n_pods):
            params = tree_map(lambda t: t[pod], params_f)     # views
            state = tree_map(lambda t: t[pod], opt_state_f)
            batch = {k: v[pod] for k, v in batch_f.items()}
            _, new_state, _, m = local(params, state, step, batch)
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src), state, new_state)
            losses.append(m["loss"])
        if step % fedavg_every == fedavg_every - 1:
            with torch.no_grad():
                for t in tree_leaves(params_f):
                    t.copy_(t.mean(0, keepdim=True).expand_as(t))
        return params_f, opt_state_f, step + 1, \
            {"loss": torch.stack(losses).mean()}

    return train_step


def main(argv=None):
    """Trains ``--arch`` on the Markov stream; returns every step's
    loss (floats, read once at the end)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced variant (CPU-friendly)")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.reduced:
        from repro_torch.configs.reduced import reduced_config
        cfg = reduced_config(args.arch)
    else:
        cfg = get_config(args.arch)
    if args.vocab:
        cfg = cfg.replace(vocab_size=args.vocab)
    model = build_model(cfg)
    opt = adam(linear_warmup_cosine(args.lr, 10, args.steps),
               per_client=False)
    step_fn = make_train_step(model, opt)

    it = markov_lm_batches(cfg.vocab_size, args.batch, args.seq)
    params = model.init(torch.Generator(device).manual_seed(0))
    opt_state = opt.init(params)
    step = 0
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        params, opt_state, step, m = step_fn(params, opt_state, step, batch)
        losses.append(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"({time.time()-t0:.1f}s)")
    print("done")
    return torch.stack(losses).tolist()


if __name__ == "__main__":
    main()
