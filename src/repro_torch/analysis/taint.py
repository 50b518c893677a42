"""The privacy-flow taint audit (pass 1 of three), over the aten graph of
a round of the port; the port of ``repro.analysis.taint``.

Lattice.  A :class:`Taint` over-approximates which clients' raw
features may have influenced each tensor:

  * ``Taint(None, bits)``   uniform: every element may carry the client
    sources in the bitmask ``bits`` (bit i = client i);
  * ``Taint(axis, bits[])`` per-slot: along one axis (the stacked
    client axis, or the canonical feature-column axis), slot s carries
    only ``bits[s]``.

Per-slot structure is what keeps the audit decidable on a round that
stacks every client on one axis.  Three mechanisms keep it alive:

  1. constant folding (``ir.AbstractInterpreter``): the layout's masks,
     offsets and sizes, the batch indices and the draws are constants,
     so indices and masks are concrete;
  2. structural rules: ``mm``/``bmm`` keep batch and free dims, views,
     ``cat``/``stack`` and the elementwise ops with broadcast move bits
     between slots explicitly;
  3. exact rules: an op whose output is a nonnegative combination of
     some inputs' elements (``gather``, ``index``, ``index_select``,
     ``scatter_add``, ``slice_backward``, ``select_backward``, a
     multiply by a concrete mask, ...) runs once a client bit on 0/1
     indicators of its data inputs (``ir.run_indicators``); the result
     says exactly which slots reach which outputs, and may re-slot a
     per-column taint onto the client axis (the masked lane's
     ``xb[None] * masks[:, None, :]``).

Two custom ops have rules of their own.  ``repro_torch.audit_tag``
(``analysis.barrier``): a ``"declass"`` tag clears the bits and counts
its channel.  ``repro_torch.vfl_matmul_clients``: ``y[c]`` carries the
owner bits of x's columns ``[x_off[c], x_off[c] + sizes[c])`` and
``w[c]``'s bits, with the offsets folded; where they do not fold, the
join of everything.  Every other op gets the sound default: the join
of all its inputs, uniform.

Two error findings make the theorem mean what the reference's does on a
graph recorded at the dispatcher:

  opaque-write  an allocation (``empty``, ``new_empty``, ...) read by a
                computing op before any recorded op wrote it: something
                outside the dispatcher (a ``ctypes`` launch) filled it,
                and its dependences are not in the graph;
  host-read     ``_local_scalar_dense`` of a tainted value: its value
                went to the host and came back as a literal, a
                dependence the graph does not show.

The contract on each round output: client slot j's parameters,
optimizer state and schedule state carry only bit j plus declassified
content.  One round suffices by induction (inputs are seeded per slot).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import ir
from repro_torch.analysis.barrier import TAG_OP_NAME
from repro_torch.analysis.report import Finding

TAG = f"repro_torch.{TAG_OP_NAME}"
KERNEL = "repro_torch.vfl_matmul_clients"


class Taint:
    """Client-source bitmask, uniform or refined along one axis."""
    __slots__ = ("axis", "bits")

    def __init__(self, axis, bits):
        self.axis = axis
        self.bits = bits if axis is None else np.asarray(bits, np.int64)

    def __repr__(self):
        if self.axis is None:
            return f"Taint({self.bits:#x})"
        return f"Taint(axis={self.axis}, bits={self.bits.tolist()})"


EMPTY = Taint(None, 0)


def uniform(bits: int) -> Taint:
    return EMPTY if bits == 0 else Taint(None, int(bits))


def perslot(axis: int, bits) -> Taint:
    return Taint(int(axis), bits)


def collapse(t: Taint) -> int:
    if t.axis is None:
        return t.bits
    return int(np.bitwise_or.reduce(t.bits)) if t.bits.size else 0


def is_empty(t: Taint) -> bool:
    return collapse(t) == 0


def is_mixed(t) -> bool:
    """True when some element carries more than one client bit."""
    if t is None or not isinstance(t, Taint) or is_empty(t):
        return False
    bits = np.ravel(t.bits) if t.axis is not None else [t.bits]
    return any(int(b) & (int(b) - 1) for b in bits)


def join(a: Taint, b: Taint) -> Taint:
    if a.axis is None and b.axis is None:
        return uniform(a.bits | b.bits)
    if a.axis is None:
        return perslot(b.axis, b.bits | np.int64(a.bits))
    if b.axis is None:
        return perslot(a.axis, a.bits | np.int64(b.bits))
    if a.axis == b.axis and a.bits.shape == b.bits.shape:
        return perslot(a.axis, a.bits | b.bits)
    return uniform(collapse(a) | collapse(b))


def _popcount(b) -> int:
    return bin(int(b)).count("1")


def _precision(t) -> int:
    """Lower = more precise: the most bits any slot carries."""
    if t.axis is None:
        return _popcount(t.bits) + 1000
    return max((_popcount(b) for b in t.bits), default=0)


def _bits_list(t):
    return [1 << i for i in range(64) if collapse(t) >> i & 1]


def indicator(t: Taint, shp, bit, device) -> torch.Tensor:
    """0/1 float32 tensor of shape ``shp``: where ``t`` may carry
    ``bit``."""
    if t.axis is None:
        return torch.full(shp, float(bool(t.bits & bit)), device=device)
    mid = [1] * len(shp)
    mid[t.axis] = shp[t.axis]
    on = torch.as_tensor((t.bits & bit) != 0, dtype=torch.float32,
                         device=device)
    return on.reshape(mid).expand(shp).contiguous()


def from_masks(masks) -> Taint:
    """The tightest Taint covering per-bit reach masks ({bit: bool
    tensor of the output's shape}): one candidate axis at a time, a
    slot's bits the union over the other dims; on a tie the lowest axis
    (where the client axis sits), as the reference picks."""
    masks = {b: m for b, m in masks.items() if bool(m.any())}
    if not masks:
        return EMPTY
    any_mask = next(iter(masks.values()))
    nd = any_mask.dim()
    if nd == 0:
        return uniform(sum(masks))
    best = None
    for k in range(nd):
        bits = np.zeros(any_mask.shape[k], np.int64)
        for b, m in masks.items():
            per = m.movedim(k, 0).reshape(m.shape[k], -1).any(1)
            bits[per.cpu().numpy()] |= np.int64(b)
        if (bits == bits[0]).all():
            cand = uniform(int(bits[0]))
        else:
            cand = perslot(k, bits)
        if best is None or _precision(cand) < _precision(best):
            best = cand
    return best


def _broadcast_to(a: Taint, in_shape, out_shape) -> Taint:
    """``a`` on a tensor of ``in_shape`` broadcast to ``out_shape``."""
    if a.axis is None:
        return a
    off = len(out_shape) - len(in_shape)
    ax = a.axis + off
    if off < 0 or not 0 <= ax < len(out_shape):
        return uniform(collapse(a))
    if in_shape[a.axis] == out_shape[ax]:
        return a if ax == a.axis else perslot(ax, a.bits)
    return uniform(collapse(a))


def _reshape(a: Taint, old, new) -> Taint:
    """A view/reshape keeps the slot axis iff some output axis has the
    same extent and the same numbers of elements before and after."""
    if a.axis is None:
        return a
    k = a.axis
    pre = int(np.prod(old[:k], dtype=np.int64))
    post = int(np.prod(old[k + 1:], dtype=np.int64))
    run = 1
    for j, d in enumerate(new):
        if (run == pre and d == old[k]
                and int(np.prod(new[j + 1:], dtype=np.int64)) == post):
            return perslot(j, a.bits)
        run *= d
    return uniform(collapse(a))


def _dims(node, pos, nd):
    """The reduced dims of a reduction node (all when absent)."""
    d = node.args[pos] if len(node.args) > pos else node.kwargs.get("dim")
    if d is None or d == []:
        return tuple(range(nd))
    d = [d] if isinstance(d, int) else list(d)
    return tuple(x % nd if nd else 0 for x in d)


def _keepdim(node, pos) -> bool:
    if len(node.args) > pos and isinstance(node.args[pos], bool):
        return node.args[pos]
    return bool(node.kwargs.get("keepdim", False))


_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "true_divide", "floor_divide",
    "remainder", "fmod", "pow", "maximum", "minimum", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "bitwise_left_shift", "bitwise_right_shift",
    "threshold_backward", "masked_fill", "lerp", "addcmul", "addcdiv",
    "atan2", "hypot", "copysign", "clamp", "clamp_min", "clamp_max",
    "neg", "abs", "sqrt", "rsqrt", "exp", "exp2", "log", "log2", "log1p",
    "expm1", "tanh", "sigmoid", "sin", "cos", "relu", "reciprocal",
    "floor", "ceil", "round", "trunc", "sign", "isfinite", "isnan",
    "isinf", "square", "erf", "leaky_relu", "gelu", "silu", "nan_to_num",
    "sigmoid_backward", "tanh_backward", "clone", "_to_copy", "detach",
    "detach_copy", "lift_fresh_copy", "alias", "alias_copy",
    "contiguous", "copy", "copy_",
}

_REDUCE = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
           "argmax": 1, "argmin": 1, "prod": 1, "all": 1, "any": 1,
           "logsumexp": 1, "nansum": 1, "count_nonzero": 1, "var": 1,
           "std": 1, "linalg_vector_norm": 2}

# mix their inputs along ``dim`` (argument 2 for the *_backward_data
# ops, else 1), elementwise along every other axis
_ALONG = {"_log_softmax": 1, "_softmax": 1, "cumsum": 1, "cumprod": 1,
          "logcumsumexp": 1, "sort": 1, "topk": 2,
          "_log_softmax_backward_data": 2, "_softmax_backward_data": 2}

_RESHAPES = {"view", "view_copy", "_unsafe_view", "reshape", "unsqueeze",
             "unsqueeze_copy", "squeeze", "squeeze_copy", "flatten",
             "unflatten"}

_OPAQUE = {"empty", "empty_like", "new_empty", "empty_strided",
           "new_empty_strided", "empty_permuted"}
# run on indicators when every non-data input is concrete
_EXACT = {"gather", "index", "index_select", "where", "scatter_add",
          "slice_backward", "select_backward"}
# overwrite part of their first argument (the rest passes through)
_SCATTERS = {"slice_scatter", "select_scatter", "index_put",
             "_index_put_impl", "scatter", "index_copy"}


class TaintInterpreter(ir.AbstractInterpreter):
    """Forward taint propagation with def-site provenance."""

    def __init__(self, n_slots_hint=0, combo=""):
        super().__init__()
        self.all_bits = (1 << max(n_slots_hint, 1)) - 1
        self.combo = combo
        self.channels = {}        # channel name -> tag count
        self.blame = {}           # node -> node that introduced mixing
        self.findings = []
        self.unwritten = {}       # node -> bool tensor: not yet written

    # lattice
    def bottom(self, node):
        return EMPTY

    def from_concrete(self, value):
        return EMPTY

    def join(self, a, b):
        if not isinstance(a, Taint) or not isinstance(b, Taint):
            return uniform(self._bits(a) | self._bits(b))
        return join(a, b)

    def collapse(self, a):
        return uniform(self._bits(a))

    def _bits(self, a):
        if isinstance(a, Taint):
            return collapse(a)
        if isinstance(a, (list, tuple)):
            return int(np.bitwise_or.reduce([self._bits(x) for x in a]
                                            or [0]))
        return 0

    # ------------------------------------------------------------------
    def on_node(self, node, ins, outs):
        """Blame bookkeeping (the reference's ``on_eqn``), and the
        opaque-write and host-read guards."""
        src, mixed_in = None, False
        for x in ir.input_nodes(node):
            if not is_mixed(self.A(x)):
                continue
            mixed_in = True
            if x in self.blame:
                src = self.blame[x]
                break
        if src is None and not mixed_in:
            src = node
        if src is not None and any(is_mixed(o) for o in outs):
            self.blame[node] = src
        self._guard_writes(node)
        name = ir.op_name(node)
        if name == "_local_scalar_dense" and ins and not is_empty(ins[0]):
            self.findings.append(Finding(
                "taint", "host-read", self.combo,
                f"a value carrying client bit(s) {collapse(ins[0]):#x} is "
                "read on the host; what depends on it enters the graph as "
                "a literal, outside the dataflow the audit sees",
                chain=tuple(self.explain(node, collapse(ins[0])
                                         & -collapse(ins[0])))))

    def _guard_writes(self, node):
        name = ir.op_name(node)
        if name in _OPAQUE:
            self.unwritten[node] = torch.ones(ir.shape(node), dtype=torch.bool)
            return
        if name in ir.VALUE_FREE:
            return
        for x in ir.input_nodes(node):
            pat = self.unwritten.get(x)
            if pat is None or not bool(pat.any()):
                continue
            if name in ("copy", "copy_") and x is node.args[0]:
                continue                      # overwritten whole
            if name in ir._VIEWS or name in _SCATTERS or \
                    name in ("cat", "stack"):
                # data movement: the unwritten part moves (a scatter's
                # written region leaves it); nothing is computed yet
                out = ir.run_indicators(node, self.C,
                                        self._only(node, x, pat))
                if isinstance(out, torch.Tensor):
                    self.unwritten[node] = out.cpu() != 0
                    continue
            alloc = self._alloc_of(x)
            self.findings.append(Finding(
                "taint", "opaque-write", self.combo,
                f"{ir.node_line(node)} reads memory allocated by "
                f"{ir.node_line(alloc)} that no recorded op wrote: it was "
                "filled outside the dispatcher, so its dependences are not "
                "in the graph",
                chain=(ir.node_line(node),
                       "<- allocated at " + ir.node_line(alloc))))
            self.unwritten[x] = torch.zeros_like(pat)     # once an alloc

    def _only(self, node, x, pat):
        """Indicators for ``node``'s data arguments: ``pat`` for ``x``,
        zeros for the others."""
        dev = self._device(node)

        def one(y):
            if y is x:
                return pat.float().to(dev)
            return torch.zeros(ir.shape(y), device=dev)
        ind = {}
        for p in ir.DATA_ARGS.get(ir.op_name(node), (0,)):
            a = node.args[p] if len(node.args) > p else None
            if isinstance(a, (list, tuple)):
                ind[p] = [one(y) if ir.is_tensor(y) else y for y in a]
            elif ir.is_tensor(a):
                ind[p] = one(a)
        return ind

    def _alloc_of(self, x):
        while ir.op_name(x) not in _OPAQUE:
            nxt = [y for y in ir.input_nodes(x) if y in self.unwritten]
            if not nxt:
                break
            x = nxt[0]
        return x

    # ------------------------------------------------------------------
    def rule(self, node, A, C):
        name = ir.op_name(node)
        out_shape = ir.shape(node)

        if name == TAG:
            kind, channel = node.args[1], node.args[2]
            self.channels[channel] = self.channels.get(channel, 0) + 1
            return [EMPTY] if kind == "declass" else [A(node.args[0])]
        if name == KERNEL:
            return [self._kernel(node, A, C)]
        if name in _OPAQUE or name in ir.VALUE_FREE:
            return [EMPTY]
        if name == "_local_scalar_dense":
            return [EMPTY]

        exact = self._exact(node, name, A, C)
        if exact is not None:
            return exact

        if name in _ELEMENTWISE:
            out = EMPTY
            for x in ir.input_nodes(node):
                if name in ("copy", "copy_") and x is node.args[0]:
                    continue        # its values are overwritten
                out = join(out, _broadcast_to(A(x), ir.shape(x), out_shape))
            return [out]
        if name in _REDUCE:
            return self._reduce(node, name, A)
        if name in _ALONG:
            return self._along(node, name, A)
        if name in _RESHAPES:
            return [_reshape(A(node.args[0]), ir.shape(node.args[0]),
                             out_shape)]
        if name in ("permute", "permute_copy"):
            a = A(node.args[0])
            if a.axis is None:
                return [a]
            perm = [d % len(out_shape) for d in node.args[1]]
            return [perslot(perm.index(a.axis), a.bits)]
        if name in ("transpose", "transpose_copy", "t", "t_copy"):
            a = A(node.args[0])
            nd = len(ir.shape(node.args[0]))
            if a.axis is None or nd < 2:
                return [a]
            d0, d1 = ((0, 1) if name.startswith("t") and len(node.args) == 1
                      else (node.args[1] % nd, node.args[2] % nd))
            ax = d1 if a.axis == d0 else d0 if a.axis == d1 else a.axis
            return [perslot(ax, a.bits)]
        if name in ("expand", "expand_copy"):
            return [_broadcast_to(A(node.args[0]), ir.shape(node.args[0]),
                                  out_shape)]
        if name in ("select", "select_copy"):
            a = A(node.args[0])
            nd = len(ir.shape(node.args[0]))
            dim, idx = node.args[1] % nd, node.args[2]
            if a.axis is None:
                return [a]
            if a.axis == dim:
                return [uniform(int(a.bits[idx]))]
            return [perslot(a.axis - (dim < a.axis), a.bits)]
        if name in ("slice", "slice_copy"):
            return [self._slice(node, A)]
        if name in ("unbind", "unbind_copy"):
            a = A(node.args[0])
            nd = len(ir.shape(node.args[0]))
            dim = (node.args[1] if len(node.args) > 1 else 0) % nd
            n = ir.shape(node.args[0])[dim]
            if a.axis is None:
                return [a] * n
            if a.axis == dim:
                return [uniform(int(b)) for b in a.bits]
            return [perslot(a.axis - (dim < a.axis), a.bits)] * n
        if name in ("cat", "stack"):
            return [self._cat(node, name, A)]
        if name in ("mm", "bmm"):
            return [self._matmul(node, name, A)]
        if name in ("index_select", "gather"):
            return [self._index_along(node, A)]
        return None

    # -- exact rules over indicators -------------------------------------
    def _exact(self, node, name, A, C):
        """Ops that move data or select by a concrete mask, run on
        indicators (module doc); None when a non-data input is not
        concrete (the structural rule or the default then applies)."""
        if name == "mul":
            return self._mul_mask(node, A, C)
        if name not in _EXACT:
            return None
        datas = {p: node.args[p] for p in ir.DATA_ARGS[name]
                 if len(node.args) > p}
        ins = [x for a in datas.values()
               for x in (a if isinstance(a, (list, tuple)) else [a])
               if ir.is_tensor(x)]
        bits = extra = 0
        for x in ir.input_nodes(node):
            if x in ins:
                bits |= collapse(A(x))
            else:
                extra |= collapse(A(x))     # indices reach every output
        n_out = ir._n_out(node)
        if bits == 0:
            return [uniform(extra)] * n_out
        dev = self._device(node)
        masks = [dict() for _ in range(n_out)]
        for b in [1 << i for i in range(64) if bits >> i & 1]:
            ind = {}
            for p, a in datas.items():
                if isinstance(a, (list, tuple)):
                    ind[p] = [indicator(A(x), ir.shape(x), b, dev)
                              if ir.is_tensor(x) else x for x in a]
                elif ir.is_tensor(a):
                    ind[p] = indicator(A(a), ir.shape(a), b, dev)
            out = ir.run_indicators(node, C, ind)
            if out is None:
                return None
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            for m, o in zip(masks, outs):
                m[b] = o != 0
        return [join(from_masks(m), uniform(extra)) for m in masks]

    def _mul_mask(self, node, A, C):
        a, b = node.args[0], node.args[1]
        for data, other in ((a, b), (b, a)):
            if not ir.is_tensor(data) or not ir.is_tensor(other):
                continue
            c = C(other)
            t = A(data)
            if c is None or is_empty(t):
                continue
            dev = self._device(node)
            out_shape = ir.shape(node)
            nz = (c != 0).to(dev)
            masks = {}
            for bit in _bits_list(t):
                ind = indicator(t, ir.shape(data), bit, dev)
                masks[bit] = torch.broadcast_to(ind * nz, out_shape) != 0
            return [from_masks(masks)]
        return None

    @staticmethod
    def _device(node):
        v = ir.val(node)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return v.device if isinstance(v, torch.Tensor) else "cpu"

    # -- structural rules --------------------------------------------------
    def _reduce(self, node, name, A):
        a = A(node.args[0])
        nd = len(ir.shape(node.args[0]))
        pos = _REDUCE[name]
        dims = _dims(node, pos, nd)
        keep = _keepdim(node, pos + 1)
        if a.axis is None:
            out = a
        elif a.axis in dims:
            out = uniform(collapse(a))
        else:
            out = perslot(a.axis if keep else
                          a.axis - sum(d < a.axis for d in dims), a.bits)
        return [out] * ir._n_out(node)

    def _along(self, node, name, A):
        pos = _ALONG[name]
        ins = ir.input_nodes(node)
        nd = len(ir.shape(ins[0]))
        dim = node.args[pos] if len(node.args) > pos else \
            node.kwargs.get("dim", -1)
        dim = dim % nd if nd else 0
        out = EMPTY
        for x in ins:
            a = A(x)
            out = join(out, uniform(collapse(a)) if a.axis == dim else a)
        return [out] * ir._n_out(node)

    def _slice(self, node, A):
        a = A(node.args[0])
        if a.axis is None:
            return a
        nd = len(ir.shape(node.args[0]))
        dim = (node.args[1] if len(node.args) > 1 else 0) % nd
        if a.axis != dim:
            return a
        start = node.args[2] if len(node.args) > 2 else None
        end = node.args[3] if len(node.args) > 3 else None
        step = node.args[4] if len(node.args) > 4 else 1
        n = len(a.bits)
        idx = range(n)[slice(start, end, step)]
        return perslot(dim, a.bits[list(idx)].copy())

    def _cat(self, node, name, A):
        parts = [x for x in node.args[0]]
        dim = node.args[1] if len(node.args) > 1 else \
            node.kwargs.get("dim", 0)
        shapes = [ir.shape(x) for x in parts]
        taints = [A(x) for x in parts]
        if name == "stack":
            nd = len(shapes[0]) + 1
            dim %= nd
            taints = [t if t.axis is None else
                      perslot(t.axis + (dim <= t.axis), t.bits)
                      for t in taints]
            shapes = [s[:dim] + (1,) + s[dim:] for s in shapes]
        else:
            dim %= len(shapes[0])
        axes = {t.axis for t in taints if t.axis is not None}
        if axes <= {dim}:
            segs = [t.bits if t.axis == dim else
                    np.full(s[dim], collapse(t), np.int64)
                    for t, s in zip(taints, shapes)]
            return perslot(dim, np.concatenate(segs))
        if len(axes) == 1:
            ax = axes.pop()
            if all(s[ax] == shapes[0][ax] for s in shapes):
                bits = np.zeros(shapes[0][ax], np.int64)
                for t in taints:
                    bits |= t.bits if t.axis == ax else np.int64(collapse(t))
                return perslot(ax, bits)
        return uniform(int(np.bitwise_or.reduce(
            [np.int64(collapse(t)) for t in taints])))

    def _matmul(self, node, name, A):
        lhs, rhs = node.args[0], node.args[1]
        lt, rt = A(lhs), A(rhs)
        b = 1 if name == "bmm" else 0

        def side(t, contract, out):
            if t.axis is None:
                return t
            if b and t.axis == 0:
                return perslot(0, t.bits)
            if t.axis == contract:
                return uniform(collapse(t))
            return perslot(out, t.bits)
        # lhs [(B,) M, K]: M -> out axis b; rhs [(B,) K, N]: N -> b + 1
        return join(side(lt, b + 1, b), side(rt, b, b + 1))

    def _index_along(self, node, A):
        """``index_select``/``gather`` along ``dim`` with an index that
        does not fold: slots on another axis stay where they are (a
        gather's output keeps the first index-extent of them); the
        index's taint reaches every output."""
        a, idx = A(node.args[0]), A(node.args[2])
        nd = len(ir.shape(node.args[0]))
        dim = node.args[1] % nd if nd else 0
        extra = uniform(collapse(idx))
        if a.axis is None or a.axis == dim:
            return join(uniform(collapse(a)), extra)
        n = ir.shape(node)[a.axis]
        return join(perslot(a.axis, a.bits[:n].copy()), extra)

    def _kernel(self, node, A, C):
        """``vfl_matmul_clients(x, w, x_off, w_off, sizes)``: y[c] from
        x's columns [x_off[c], x_off[c] + sizes[c]) and w[c]."""
        x, w, x_off, _, sizes = node.args[:5]
        tx, tw = A(x), A(w)
        n = ir.shape(node)[0]
        xo, sz = C(x_off), C(sizes)
        idx_bits = collapse(A(x_off)) | collapse(A(node.args[3])) | \
            collapse(A(sizes))
        if xo is None or sz is None or (tx.axis not in (None, 1)) or \
                (tw.axis not in (None, 0)):
            return uniform(collapse(tx) | collapse(tw) | idx_bits)
        xo, sz = xo.cpu().tolist(), sz.cpu().tolist()
        bits = np.zeros(n, np.int64)
        for c in range(n):
            if tx.axis is None:
                bits[c] = tx.bits if sz[c] > 0 else 0
            else:
                sel = tx.bits[xo[c]:xo[c] + sz[c]]
                bits[c] = np.bitwise_or.reduce(sel) if sel.size else 0
            bits[c] |= tw.bits[c] if tw.axis == 0 else tw.bits
        return join(perslot(0, bits), uniform(idx_bits))

    # -- provenance --------------------------------------------------------
    def explain(self, node, bit: int, limit=64):
        """Node chain from ``node`` back toward the source of one leaking
        client bit (the tainted input followed greedily)."""
        lines, seen, v = [], set(), node
        blame = None
        while isinstance(v, torch.fx.Node) and v.op == "call_function" \
                and v not in seen and len(lines) < limit:
            seen.add(v)
            blame = self.blame.get(v, blame)
            lines.append(ir.node_line(v))
            nxt, fallback = None, None
            for x in ir.input_nodes(v):
                t = self.A(x)
                if not isinstance(t, Taint) or not (collapse(t) & bit) \
                        or x in seen:
                    continue
                if x.op == "call_function":
                    nxt = x
                    break
                fallback = fallback or x
            v = nxt or fallback
        if isinstance(v, torch.fx.Node) and v.op == "placeholder":
            lines.append(f"<- input {v.name}")
        if blame is not None:
            lines.append("<- mixing introduced at " + ir.node_line(blame))
        lines.append(f"<- carries client bit {bit:#x} from a tainted "
                     "source input")
        return lines


def check_round_outputs(interp, tg, out_abs, out_specs, combo):
    """Per-slot separation on the round outputs: each entry of
    ``out_specs`` (aligned with ``tg.out_items``) is ``("perslot",
    client_axis, label)`` -- slot j may carry only bit j -- or
    ``("skip", None, label)`` for aggregate telemetry."""
    findings = []
    for item, t, (check, axis, label) in zip(tg.out_items, out_abs,
                                             out_specs, strict=True):
        if check == "skip" or t is None or is_empty(t):
            continue
        if t.axis == axis:
            bad = [(s, int(b) & ~(1 << s)) for s, b in enumerate(t.bits)
                   if int(b) & ~(1 << s)]
            if not bad:
                continue
            s, leaked = bad[0]
            findings.append(Finding(
                "taint", "cross-client-flow", combo,
                f"{label}: client slot {s} carries foreign client "
                f"bit(s) {leaked:#x} outside declared channels",
                chain=tuple(interp.explain(item, leaked & -leaked))))
        else:
            bits = collapse(t)
            findings.append(Finding(
                "taint", "unseparable-flow", combo,
                f"{label}: taint could not be separated per client slot "
                f"(carries {bits:#x} uniformly; expected per-slot on axis "
                f"{axis})", chain=tuple(interp.explain(item, bits & -bits))))
    return findings


def run_taint(tg, in_abs, out_specs, combo, n_slots):
    """Drive the taint interpreter over a traced round and check the
    per-slot separation contract.  Returns (findings, channels)."""
    interp = TaintInterpreter(n_slots_hint=n_slots, combo=combo)
    out_abs = interp.run(tg, in_abs)
    findings = list(interp.findings)
    findings += check_round_outputs(interp, tg, out_abs, out_specs, combo)
    if not interp.channels:
        findings.append(Finding(
            "taint", "no-channels-observed", combo,
            "no declared-channel tags were observed in the traced round; "
            "the audit instrumentation is not wired into this path",
            severity="warning"))
    return findings, interp.channels
