"""The graph side of the auditor: trace a round of the port into an aten
graph, and interpret that graph abstractly; the port of
``repro.analysis.ir``'s jaxpr half.

Tracing (:func:`trace_round`) takes two stages, because the round
cannot be functionalized directly: it differentiates leaf copies of the
parameters (``requires_grad_`` and ``autograd.grad`` inside the
function) and updates them in place.

  1. ``make_fx(fn, tracing_mode="real")`` records the round as it runs
     on real tensors: one aten node an op, the backward included.  The
     port records, for each node, the ``file:line`` outside ``torch/``
     that issued it (a ``TorchFunctionMode`` around the call), because
     ``make_fx`` keeps stack traces only under an ``nn.Module.forward``.
  2. ``make_fx(functionalize(stage 1, remove="mutations"))`` turns that
     graph into SSA form: every in-place update is an out-of-place op,
     and an in-place update of an input is a trailing ``copy_`` into
     its placeholder.  Views stay views (nothing writes through them
     any more), so every op sees the strides it saw in the round: on
     the card a view made a copy changes a GEMM's last bits, and the
     graph would no longer be the round bitwise (``TracedGraph.run``).
     The stage-1 locations ride along (``preserve_node_meta``).

In real mode every tensor the round closes over -- the layout's masks
and offsets, the labels, the batch indices, the round's draws -- is a
``get_attr`` constant whose value is known, while the carried state and
the features are placeholders the passes seed.

:class:`AbstractInterpreter` walks the SSA graph forward.  It folds every
node whose inputs are all concrete (constants, or values computed only
from constants), under a size cap, so the rules downstream see concrete
offsets, indices and masks; that is what keeps a per-client taint
separable on a round that stacks every client on one axis.

The reference's HLO-text helpers (``parse_shapes``, ``shape_elems``,
``shape_bytes``, ``bytes_of``) are not ported: one card has no HLO.
"""
from __future__ import annotations

import itertools
import operator
import os
import re
import sys

import torch
import torch.fx.traceback as fx_traceback
import torch.utils._pytree as pytree
from torch._guards import TracingContext, tracing
from torch._subclasses import FakeTensorMode
from torch.fx.experimental import proxy_tensor
from torch.overrides import TorchFunctionMode

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__)) + os.sep

# folding guard: never materialize giant intermediates while folding
FOLD_ELEM_LIMIT = 4_000_000


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
class _SourceRecorder(TorchFunctionMode):
    """Stamps each node a torch call adds to ``graph`` with the
    innermost frame outside torch (and outside this package) that made
    the call: ``node.meta["stack_trace"] = "path:line"``."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_function__(self, func, types, args=(), kwargs=None):
        before = len(self.graph.nodes)
        out = func(*args, **(kwargs or {}))
        added = len(self.graph.nodes) - before
        if added > 0:
            f = sys._getframe(1)
            while f is not None and f.f_code.co_filename.startswith(
                    (_TORCH_DIR, _HERE)):
                f = f.f_back
            where = ("?" if f is None
                     else f"{f.f_code.co_filename}:{f.f_lineno}")
            for node in itertools.islice(reversed(self.graph.nodes), added):
                node.meta.setdefault("stack_trace", where)
        return out


class TracedGraph:
    """A round as an SSA aten graph (``gm``), with:

      placeholders  the graph's input nodes, one a tensor leaf of the
                    traced arguments, labelled ``in_labels`` (pytree key
                    strings, e.g. ``[0]['layer_0']['kernel']``)
      out_items     the returned tensors' nodes, labelled ``out_labels``
      carried       placeholder -> the value a trailing ``copy_`` writes
                    into it (the in-place updates of the inputs)
      outputs       the tensors the stage-1 run returned: the traced
                    round really ran, on copies of the arguments
    """

    def __init__(self, gm, in_labels, out_labels, outputs):
        self.gm = gm
        self.in_labels = in_labels
        self.out_labels = out_labels
        self.outputs = outputs
        nodes = list(gm.graph.nodes)
        self.placeholders = [n for n in nodes if n.op == "placeholder"]
        out = next(n for n in nodes if n.op == "output")
        self.out_items = pytree.tree_leaves(out.args[0])
        self.carried = {}
        for n in nodes:
            if (n.op == "call_function" and op_name(n) == "copy_"
                    and n.args[0] in self.placeholders):
                self.carried[n.args[0]] = n.args[1]

    def run(self, args) -> list:
        """``gm``, the graph the passes read, run on copies of the tensor
        leaves of ``args`` (as ``trace_round`` took them): the tensors it
        returns, in the order of ``outputs``."""
        tensors = [t for t in pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor)]
        return list(self.gm(*_clone(tensors)))


def _clone(tree):
    return pytree.tree_map(
        lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
        tree)


def trace_round(fn, args) -> TracedGraph:
    """Trace ``fn(*args)`` in two stages (module doc).  ``args`` is a
    tuple of pytrees; their tensor leaves become the placeholders, any
    other leaf is closed over.  ``fn`` runs on copies of the tensors
    (twice: once a stage), so ``args`` is left as it was."""
    leaves, spec = pytree.tree_flatten(args)
    paths = [pytree.keystr(p) for p, _ in
             pytree.tree_flatten_with_path(args)[0]]
    where = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    box = {}

    def flat(*tensors):
        full = list(leaves)
        for i, t in zip(where, tensors):
            full[i] = t
        out = fn(*pytree.tree_unflatten(full, spec))
        items = pytree.tree_flatten_with_path(out)[0]
        kept = [(pytree.keystr(p), v) for p, v in items
                if isinstance(v, torch.Tensor)]
        box.setdefault("labels", [k for k, _ in kept])
        box.setdefault("outputs", [v for _, v in kept])
        return [v for _, v in kept]

    def recorded(*tensors):
        mode = proxy_tensor.get_proxy_mode()
        if mode is None:
            return flat(*tensors)
        with _SourceRecorder(mode.tracer.graph):
            return flat(*tensors)

    tensors = [leaves[i] for i in where]

    def replay(*ts):
        return torch.fx.Interpreter(gm1).run(*ts)

    # one FakeTensorMode holds every node's metadata (``make_fx`` in real
    # mode otherwise builds one a node: a third of the tracing time); a
    # host read of a traced value is recorded (``_local_scalar_dense``)
    # for the taint pass to judge, not refused
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        gm1 = proxy_tensor.make_fx(recorded, tracing_mode="real",
                                   _error_on_data_dependent_ops=False)(
            *_clone(tensors))
        with fx_traceback.preserve_node_meta():
            gm2 = proxy_tensor.make_fx(
                torch.func.functionalize(replay, remove="mutations"),
                tracing_mode="real", _error_on_data_dependent_ops=False)(
                    *_clone(tensors))
    return TracedGraph(gm2, [paths[i] for i in where], box["labels"],
                       box["outputs"])


# ---------------------------------------------------------------------------
# node helpers
# ---------------------------------------------------------------------------
def op_name(node) -> str:
    """``add`` for ``aten.add.Tensor``; ``repro_torch.audit_tag`` for a
    custom op; ``getitem`` for a tuple pick; else the target's name."""
    t = node.target
    if t is operator.getitem:
        return "getitem"
    if isinstance(t, torch._ops.OpOverload):
        ns, name = t.namespace, t._opname
        return name if ns == "aten" else f"{ns}.{name}"
    return getattr(t, "__name__", str(t))


def val(node):
    """The metadata of a node's value (a fake tensor: shape, dtype,
    device), or a tuple of them, or a Python scalar."""
    return node.meta.get("val")


def shape(node) -> tuple:
    v = val(node)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


def is_tensor(x) -> bool:
    return isinstance(x, torch.fx.Node) and isinstance(val(x), torch.Tensor)


def source(node) -> str:
    """``file:line`` of the code that issued the node, or ''."""
    st = node.meta.get("stack_trace") or ""
    return st.rsplit("/", 1)[-1] if st else ""


def node_line(node) -> str:
    """One-line rendering for reports: op, output shape and dtype, and
    the source location that issued it."""
    v = val(node)
    if isinstance(v, torch.Tensor):
        out = f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
    else:
        out = type(v).__name__
    src = source(node)
    return f"{op_name(node)} -> {out}" + (f"  [{src}]" if src else "")


def input_nodes(node) -> list:
    """The tensor nodes among a node's arguments, in order."""
    return [a for a in pytree.tree_leaves((node.args, node.kwargs))
            if is_tensor(a)]


_ADDR_RE = re.compile(r"0x[0-9a-f]+")


def normalized_code(gm) -> str:
    """The graph's structure as text: one line a node with its op, its
    arguments (nodes by position, literals as they are) and the shape
    and dtype it produced.  Constants' names and values are left out:
    two traces whose values differ only in constants (layouts, draws,
    batch indices) give the same text."""
    index = {n: i for i, n in enumerate(gm.graph.nodes)}

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return f"%{index[a]}"
        if isinstance(a, (list, tuple)):
            return "[" + ", ".join(arg(x) for x in a) + "]"
        return _ADDR_RE.sub("0x", repr(a))

    lines = []
    for n in gm.graph.nodes:
        v = val(n)
        meta = (f"{v.dtype}{list(v.shape)}@{v.device.type}"
                if isinstance(v, torch.Tensor) else "")
        target = "const" if n.op == "get_attr" else (
            op_name(n) if n.op == "call_function" else n.op)
        args = ", ".join([arg(a) for a in n.args]
                         + [f"{k}={arg(a)}" for k, a in n.kwargs.items()])
        lines.append(f"{index[n]}: {target}({args}) {meta}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# ops whose output is a nonnegative combination of some inputs' elements
# (data movement, masks, matmuls): run on 0/1 indicators in place of those
# inputs, they say exactly which input elements reach which outputs
# ---------------------------------------------------------------------------
_VIEWS = {"view", "view_copy", "_unsafe_view", "reshape", "unsqueeze",
          "unsqueeze_copy", "squeeze", "squeeze_copy", "flatten",
          "unflatten", "alias", "alias_copy", "permute", "permute_copy",
          "transpose", "transpose_copy", "t", "t_copy", "expand",
          "expand_copy", "select", "select_copy", "slice", "slice_copy",
          "narrow", "narrow_copy", "unbind", "unbind_copy", "split",
          "split_copy", "split_with_sizes", "split_with_sizes_copy",
          "repeat", "flip", "clone", "_to_copy", "detach", "detach_copy",
          "lift_fresh_copy", "contiguous", "diagonal", "diagonal_copy"}

# op -> positions of its data arguments (a list argument counts whole)
DATA_ARGS = {
    **{v: (0,) for v in _VIEWS},
    "cat": (0,), "stack": (0,),
    "gather": (0,), "index": (0,), "index_select": (0,),
    "scatter_add": (0, 3), "scatter": (0, 3), "index_copy": (0, 3),
    "index_put": (0, 2), "_index_put_impl": (0, 2),
    "slice_backward": (0,), "select_backward": (0,),
    "slice_scatter": (0, 1), "select_scatter": (0, 1),
    "where": (1, 2), "mm": (0, 1), "bmm": (0, 1),
}


def run_indicators(node, conc, indicators):
    """Run ``node``'s op with ``indicators`` ({arg position: tensor, or
    list of tensors for a list argument}) in place of its data
    arguments and concrete values elsewhere.  ``conc(n)`` is a node's
    concrete value or None.  Returns the output (a tensor or a list), or
    None when a non-data tensor argument is not concrete or the op
    refuses the indicators."""
    args = list(node.args)
    for pos, ind in indicators.items():
        args[pos] = ind
    missing = False

    def fill(a):
        nonlocal missing
        if isinstance(a, torch.fx.Node):
            c = conc(a)
            if c is None:
                missing = True
            return c
        return a

    args = [a if pos in indicators else
            torch.fx.node.map_aggregate(a, fill)
            for pos, a in enumerate(args)]
    kwargs = torch.fx.node.map_aggregate(dict(node.kwargs), fill)
    if missing:
        return None
    if op_name(node) in ("_to_copy", "clone") and "dtype" in kwargs:
        kwargs = {**kwargs, "dtype": None}
    try:
        return node.target(*args, **kwargs)
    except (RuntimeError, TypeError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# the abstract interpreter
# ---------------------------------------------------------------------------
# never folded: the tags (the passes must see them), allocations whose
# contents the graph does not know, and host reads (checked by a rule)
_NO_FOLD_OPS = {"empty", "empty_like", "new_empty", "empty_strided",
                "new_empty_strided", "empty_permuted",
                "_local_scalar_dense"}
# value depends on its inputs' shapes only
VALUE_FREE = {"ones_like", "zeros_like", "full_like", "new_zeros",
              "new_ones", "new_full", "zeros", "ones", "full", "arange",
              "scalar_tensor", "eye", "linspace", "fill", "zero"}


class AbstractInterpreter:
    """Forward abstract interpretation over a :class:`TracedGraph` with
    constant folding.

    Subclasses define the lattice:

      bottom(node)           least element
      from_concrete(value)   abstract value of a known tensor
      join(a, b)             least upper bound
      rule(node, A, C)       list of output values (one a tuple item),
                             or None for the conservative default;
                             ``A(x)``/``C(x)`` read an argument's
                             abstract / concrete value
      on_node(node, ins, outs)   observation hook

    The engine handles constants, folding, tuple outputs and ``getitem``.
    """

    def __init__(self):
        self.abs_env = {}
        self.conc_env = {}

    # -- lattice interface (subclass) -----------------------------------
    def bottom(self, node):
        raise NotImplementedError

    def from_concrete(self, value):
        raise NotImplementedError

    def join(self, a, b):
        raise NotImplementedError

    def rule(self, node, A, C):
        return None

    def default(self, node, ins):
        out = self.bottom(node)
        for a in ins:
            out = self.join(out, self.collapse(a))
        return [out] * _n_out(node)

    def collapse(self, a):
        return a

    def on_node(self, node, ins, outs):
        pass

    # -- env -------------------------------------------------------------
    def A(self, x):
        return self.abs_env.get(x) if isinstance(x, torch.fx.Node) else None

    def C(self, x):
        if isinstance(x, torch.fx.Node):
            return self.conc_env.get(x)
        return None

    def _write(self, node, a, c=None):
        self.abs_env[node] = a
        if c is not None:
            self.conc_env[node] = c

    # -- the walk --------------------------------------------------------
    def run(self, tg: TracedGraph, in_abs, in_conc=None):
        """Interpret ``tg`` from abstract values (and optional concrete
        ones, None-padded) for its placeholders; returns the abstract
        values of ``tg.out_items``."""
        in_conc = in_conc or [None] * len(in_abs)
        for ph, a, c in zip(tg.placeholders, in_abs, in_conc, strict=True):
            self._write(ph, a, c)
        for node in tg.gm.graph.nodes:
            if node.op == "get_attr":
                v = operator.attrgetter(node.target)(tg.gm)
                self._write(node, self.from_concrete(v), v)
            elif node.op == "call_function":
                self._node(node)
        return [self.A(x) for x in tg.out_items]

    def _node(self, node):
        name = op_name(node)
        ins = [self.A(x) for x in input_nodes(node)]
        if name == "getitem":
            src, i = node.args
            outs = self.A(src)[i]
            c = self.C(src)
            self._write(node, outs, None if c is None else c[i])
            self.on_node(node, ins, [outs])
            return
        folded = self._fold(node, name)
        if folded is not None:
            outs = [self.from_concrete(v) if isinstance(v, torch.Tensor)
                    else self.bottom(node) for v in folded]
        else:
            outs = self.rule(node, self.A, self.C)
            if outs is None:
                outs = self.default(node, ins)
        multi = isinstance(val(node), (list, tuple))
        if multi:
            self._write(node, outs, folded)
        else:
            self._write(node, outs[0], None if folded is None else folded[0])
        self.on_node(node, ins, outs)

    def _fold(self, node, name):
        """Concrete outputs of a node whose inputs are all concrete (a
        list, one an output), or None."""
        if name in _NO_FOLD_OPS or name.startswith("repro_torch."):
            return None
        v = val(node)
        vals = v if isinstance(v, (list, tuple)) else [v]
        if any(isinstance(x, torch.Tensor) and x.numel() > FOLD_ELEM_LIMIT
               for x in vals):
            return None
        read = self.C
        if name in VALUE_FREE:
            # the value depends on the inputs' shapes alone
            read = self._or_dummy
        elif not all(self.C(x) is not None for x in input_nodes(node)):
            return None
        try:
            args = torch.fx.node.map_arg(node.args, read)
            kwargs = torch.fx.node.map_arg(node.kwargs, read)
            out = node.target(*args, **kwargs)
        except (RuntimeError, TypeError, ValueError, IndexError):
            return None
        return list(out) if isinstance(out, (list, tuple)) else [out]


    def _or_dummy(self, x):
        c = self.C(x)
        if c is not None or not is_tensor(x):
            return c
        v = val(x)
        return torch.zeros(v.shape, dtype=v.dtype, device=v.device)


def _n_out(node) -> int:
    v = val(node)
    return len(v) if isinstance(v, (list, tuple)) else 1
