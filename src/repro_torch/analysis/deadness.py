"""The padded-lane deadness prover (pass 2 of three), over the aten
graph of a round of the port; the port of ``repro.analysis.deadness``.

Padding the client axis to ``max_clients`` changes nothing for the live
clients: dead ``client_mask`` slots add exact zeros to the exchange sum,
the FedAvg weighting and the loss mean.  This pass proves it statically
over the traced round: a maybe-nonzero abstract interpretation (one bool
an element, True = possibly nonzero) in which the layout's masks and
``client_mask`` are concrete constants, so every mask multiply kills the
dead slots in the abstract domain.

Each mask-weighted per-client term is tagged ``kind="term"``
(``analysis.barrier``); the prover checks that the tagged value's dead
slots (client-axis indices >= ``n_real``) are all False.  The default
rule is TOP (all maybe-nonzero), so zero-breaking ops are conservative;
precision flows through the zero-preserving structure: multiplies,
matmuls and data movement (run on 0/1 indicators, ``ir.run_indicators``).
The proof assumes finite arithmetic (0 * finite == 0).
"""
from __future__ import annotations

import torch

from repro_torch.analysis import ir
from repro_torch.analysis.report import Finding
from repro_torch.analysis.taint import TAG

# f(0) == 0 elementwise: the pattern passes through
_ZERO_PRESERVING = {
    "neg", "abs", "sign", "sqrt", "relu", "tanh", "sin", "square", "erf",
    "expm1", "log1p", "floor", "round", "trunc", "clone", "_to_copy",
    "detach", "detach_copy", "lift_fresh_copy", "alias", "alias_copy",
    "contiguous", "div", "true_divide", "threshold_backward",
}
_OR = {"add", "sub", "rsub", "maximum", "minimum", "remainder", "atan2"}
_REDUCE = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "prod": 1,
           "nansum": 1}


class DeadnessInterpreter(ir.AbstractInterpreter):
    """Maybe-nonzero propagation with dead-slot checks at term tags."""

    def __init__(self, n_real: int, n_padded: int, combo: str):
        super().__init__()
        self.n_real = int(n_real)
        self.n_padded = int(n_padded)
        self.combo = combo
        self.findings = []
        self.terms_checked = 0

    # lattice: bool tensors of the full shape, on the CPU
    def bottom(self, node):
        return torch.zeros(ir.shape(node), dtype=torch.bool)

    def from_concrete(self, value):
        if not isinstance(value, torch.Tensor):
            return None
        return (value.detach() != 0).cpu()

    def join(self, a, b):
        return a | b

    def default(self, node, ins):
        v = ir.val(node)
        vals = v if isinstance(v, (list, tuple)) else [v]
        return [torch.ones(x.shape, dtype=torch.bool)
                if isinstance(x, torch.Tensor) else None for x in vals]

    # ------------------------------------------------------------------
    def rule(self, node, A, C):
        name = ir.op_name(node)
        shp = ir.shape(node)

        def arg(i):
            a = node.args[i]
            return A(a) if ir.is_tensor(a) else None

        if name == TAG:
            self._check_tag(node, A(node.args[0]))
            return [A(node.args[0])]
        if name in _ZERO_PRESERVING:
            return [torch.broadcast_to(arg(0), shp).clone()]
        if name == "mul":
            a, b = arg(0), arg(1)
            if a is None or b is None:
                out = a if b is None else b
                return [torch.broadcast_to(out, shp).clone()]
            return [torch.broadcast_to(a & b, shp).clone()]
        if name in _OR:
            pats = [p for p in (arg(0), arg(1)) if p is not None]
            out = pats[0]
            for p in pats[1:]:
                out = out | p
            return [torch.broadcast_to(out, shp).clone()]
        if name == "where":
            c = C(node.args[0])
            a, b = arg(1), arg(2)
            a = torch.zeros(shp, dtype=torch.bool) if a is None else a
            b = torch.zeros(shp, dtype=torch.bool) if b is None else b
            if c is not None:
                return [torch.where(c.cpu().bool(), a, b).expand(shp).clone()]
            return [torch.broadcast_to(a | b, shp).clone()]
        if name in ("copy", "copy_"):
            return [torch.broadcast_to(arg(1), shp).clone()]
        if name in _REDUCE:
            a = arg(0)
            dims = node.args[1] if len(node.args) > 1 else None
            keep = (node.args[2] if len(node.args) > 2 and
                    isinstance(node.args[2], bool)
                    else node.kwargs.get("keepdim", False))
            if dims is None or dims == []:
                out = a.any()
                return [out.reshape([1] * a.dim()) if keep else out]
            dims = [dims] if isinstance(dims, int) else list(dims)
            return [a.any(dim=tuple(dims), keepdim=keep)] if a.dim() else [a]
        if name in ir.DATA_ARGS:
            return self._via_indicators(node, A, C)
        return None

    def _via_indicators(self, node, A, C):
        """Run the op on the float patterns of its data arguments, with
        concrete values elsewhere: exact for data movement, and for a
        matmul a count of nonzero products."""
        dev = node.meta["val"].device if isinstance(
            ir.val(node), torch.Tensor) else "cpu"
        ind = {}
        for p in ir.DATA_ARGS[ir.op_name(node)]:
            a = node.args[p] if len(node.args) > p else None
            if isinstance(a, (list, tuple)):
                ind[p] = [A(x).float().to(dev) if ir.is_tensor(x) else x
                          for x in a]
            elif ir.is_tensor(a):
                ind[p] = A(a).float().to(dev)
        out = ir.run_indicators(node, C, ind)
        if out is None:
            return None
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return [(o != 0).cpu() for o in outs]

    # ------------------------------------------------------------------
    def _check_tag(self, node, pattern):
        kind, channel, ca = node.args[1], node.args[2], node.args[3]
        if kind != "term" or ca is None or ca >= pattern.dim() \
                or pattern.shape[ca] != self.n_padded:
            return
        self.terms_checked += 1
        if self.n_real >= self.n_padded:
            return
        dead = pattern.narrow(ca, self.n_real, self.n_padded - self.n_real)
        if bool(dead.any()):
            per = dead.movedim(ca, 0).reshape(dead.shape[ca], -1).any(1)
            bad = int(per.nonzero()[0, 0]) + self.n_real
            self.findings.append(Finding(
                "deadness", "unproven-dead-slot", self.combo,
                f"dead client slot {bad} of the tagged {channel!r} term is "
                "not provably zero", chain=(ir.node_line(node),)))


def run_deadness(tg, combo, n_real, n_padded):
    """Prove dead-slot zeros over a traced round (every input maybe
    nonzero).  Returns findings."""
    interp = DeadnessInterpreter(n_real, n_padded, combo)
    interp.run(tg, [torch.ones(ir.shape(p), dtype=torch.bool)
                    for p in tg.placeholders])
    findings = list(interp.findings)
    if interp.terms_checked == 0:
        findings.append(Finding(
            "deadness", "no-terms-observed", combo,
            "no mask-weighted term tags were observed in the traced round; "
            "deadness instrumentation is not wired into this path",
            severity="warning"))
    return findings
