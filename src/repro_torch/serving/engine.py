"""Continuous-batching serving engine: the port of
``repro.serving.engine``.

A fixed pool of `max_batch` decode slots advances one token per step
for every active slot (one decode_step on the whole batch -- inactive
slots run padding and are masked). New requests are admitted by running
the model's *prefill* path at B=1 and splicing the resulting KV cache
into the slot (`_insert_state`), so a long prompt never stalls the
running batch for more than one prefill, and a finished slot is
refilled immediately -- the standard continuous-batching discipline.

Greedy or temperature sampling per request; temperature sampling draws
from a ``torch.Generator`` seeded from ``seed`` (the reference's
``jax.random`` key gives other draws from the same seed).  The engine
counts its prefills and decode steps (``prefills``, ``decode_steps``).

The vlm and audio families get a zero ``prefix_emb`` of
[1, num_prefix_embeddings, d_model] at every admission, as the
reference's engine passes (the frontends are stubs in both packages):
the vlm's image rows go before the prompt in the decoder's cache, the
audio family's frames through its encoder, whose output the slot keeps
in the state's ``"enc"`` (zero at construction, from
``init_decode_state``).  ``submit`` counts a vlm request's image rows
against ``cache_len``; the reference counts only the prompt and the new
tokens, and its prefill then keeps only the last ``cache_len`` positions,
dropping image rows (ROADMAP.md, "Documented differences").

Tracing (``repro_torch.obs.trace``): with a ``SpanTracer`` passed as
``tracer`` the engine records into it at every call; with none, into
its own ``tracer`` exactly while a ``torch.profiler`` records (checked
once an ``admit`` or ``step``), and takes the off path otherwise.  For
the call's length it is the tracer the model's layers record into
(``trace.current()``).  Spans: ``admit`` a pass, and in it a device span
``prefill`` a request holding ``prefill.h2d`` (the prompt to the
device), ``prefill.dispatch`` (the ``model.prefill`` call),
``prefill.first_token`` (its sample, copied to the host) and
``prefill.insert_state``; a device span ``step`` holding
``decode.dispatch`` (the ``model.decode_step`` call, launch side),
``decode.sample`` (the argmax copied to the host, which waits on the
device) and ``decode.slots`` (the slots' bookkeeping).  Counters:
``prefills``, ``prompt_tokens``, ``decode_steps``, and
``decode_graph_replays`` (below), beside the model's own (the MoE
layers' ``moe_calls`` and ``moe_dropless_calls``).  Whether traced or
not, ``lifecycle`` keeps each request's submit, prefill start and
first token times (``perf_counter`` seconds).

The decode step as one CUDA graph: a step's shapes are fixed for the
engine's life (``max_batch`` slots, inactive ones running padding;
caches of ``cache_len`` written in place), so on a CUDA device the
first step runs the model eagerly and is then captured
(``torch.cuda.graph``, not run), and every later step copies the fed
tokens into the static buffer the graph reads and replays it
(``graph_replays`` counts them), instead of launching the model's
kernels one by one from Python.  The graph reads and writes the
state's tensors in place (caches, ``position``, the audio family's
``"enc"``), which ``_insert_state`` writes between steps; sampling
and the slots' bookkeeping stay outside it.  On the CPU every step
runs eagerly.  The kernels' launch counters (``.launches`` of
``KERNELS``) count what a replay launches, as an eager step would.  A
replayed step records ``step``, ``decode.dispatch`` (now the replay),
``decode.sample`` and ``decode.slots`` as before, and the model's device
spans through ``SpanTracer.replayed``; the model's host-only spans
(``mixer.*``, ``ffn.mlp``/``ffn.rwkv_cm``, ``lm_head``) are not
recorded on a replayed step.  The model's counters run no Python on a
replay either: the capture keeps what the step counted
(``GraphSpans.counts``), and ``SpanTracer.replayed`` adds it again at
every replay, one reading a counter.

The B = 1 prefills as CUDA graphs too, where padding a prompt at its
end is exact (``_pads_exactly``: causal self-attention over the whole
cache in every layer, every FFN dense or an MoE layer that can drop no
pair, and at least one such MoE layer, whose many small launches leave
its eager prefill bound by the host): at the first admission on a CUDA
device, one graph is captured for each length in steps of 128 up to
``cache_len`` (``_PrefillGraphs``), and every admission replays the
shortest that holds its prompt, padded with zeros, the logits read at
its last token and the position set one past it.  The padding's keys
and values sit in the cache past the prompt, where a causal decode
masks them until it writes over them.  The engine still calls
``Model.prefill`` for each admission (with ``graphs=``), which hands
the call to the replay.  A replayed prefill records the model's device
spans and counters as a replayed step does.  Other models, and every
prefill on the CPU, run eagerly.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch._C._autograd import _profiler_enabled

from repro_torch.kernels import (
    flash_attention, mamba_scan, mamba_scan_fused, moe_router, rwkv6_scan,
)
from repro_torch.models import moe as _moe
from repro_torch.obs import trace as _trace
from repro_torch.tree import tree_map

# the model's kernels, whose wrappers count their launches
KERNELS = (flash_attention, mamba_scan, mamba_scan_fused, moe_router,
           rwkv6_scan)


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    stop_token: Optional[int] = None


@dataclass
class _Slot:
    active: bool = False
    uid: int = -1
    remaining: int = 0
    stop_token: Optional[int] = None
    temperature: float = 0.0
    generated: list = field(default_factory=list)


@dataclass
class RequestTimes:
    """A request's lifecycle on ``time.perf_counter``'s clock (None:
    not reached yet)."""
    t_submit: float
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None


class ServingEngine:
    def __init__(self, model, params, *, max_batch=8, cache_len=256,
                 seed=0, tracer=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = _params_device(params)     # serve where the weights are
        self.state = model.init_decode_state(max_batch, cache_len,
                                             device=self.device)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: deque = deque()
        self.done: Dict[int, list] = {}
        self.lifecycle: Dict[int, RequestTimes] = {}
        self.tracer = tracer if tracer is not None else _trace.SpanTracer()
        self._follow_profiler = tracer is None
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._last_tok = torch.zeros((max_batch, 1), dtype=torch.int32)
        # the tokens a decode step reads, on the device
        self._toks = torch.zeros((max_batch, 1), dtype=torch.int32,
                                 device=self.device)
        self._graph = None
        self._prefill_graphs = None
        self._pads = self.device.type == "cuda" and \
            _pads_exactly(model, cache_len)
        self.prefills = 0
        self.decode_steps = 0
        self.graph_replays = 0
        cfg = model.cfg
        # the prefix every admission passes, and the decoder positions
        # it takes (a vlm's image rows; an encoder's frames take none)
        self._prefix = None
        self._prefix_rows = 0
        if cfg.is_encoder_decoder or cfg.modality != "text":
            self._prefix = torch.zeros(
                (1, cfg.num_prefix_embeddings, cfg.d_model),
                dtype=model.dtype, device=self.device)
            if not cfg.is_encoder_decoder:
                self._prefix_rows = cfg.num_prefix_embeddings

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        need = self._prefix_rows + len(req.prompt) + req.max_new_tokens
        if not req.prompt or need > self.cache_len:
            after = f" after {self._prefix_rows} image rows" \
                if self._prefix_rows else ""
            raise ValueError(
                f"request {req.uid}: a prompt of {len(req.prompt)} tokens "
                f"and {req.max_new_tokens} new tokens{after} must be "
                f"non-empty and fit the {self.cache_len}-slot cache")
        self.lifecycle[req.uid] = RequestTimes(time.perf_counter())
        self.queue.append(req)

    def _call_tracer(self):
        """The tracer this call records into (module doc), armed anew on
        the engine's device: the device's clock is tied to the host's at
        every call recorded, where the device has little or nothing
        left to run, so the two clocks' drift never builds up."""
        if self._follow_profiler and not _profiler_enabled():
            # the last traced replay's events, read before another
            # replay records over them (a no-op with nothing pending)
            self.tracer.resolve()
            return _trace.NULL
        self.tracer.arm(self.device)
        return self.tracer

    def _insert_state(self, slot_idx, single_state, first_tok):
        """Splice a B=1 prefill state into batch slot `slot_idx`.

        Stacked-layer cache leaves are [n_groups, B, ...] -- the batch
        axis is 1 under "scanned", 0 everywhere else (path-aware)."""
        def ins(batched, single, in_scanned):
            if isinstance(batched, dict):
                for k in batched:
                    ins(batched[k], single[k], in_scanned or k == "scanned")
            elif in_scanned:
                batched[:, slot_idx] = single[:, 0]
            else:
                batched[slot_idx] = single[0]
        ins(self.state["cache"], single_state["cache"], False)
        self.state["position"][slot_idx] = single_state["position"][0]
        if "enc" in single_state:
            self.state["enc"][slot_idx] = single_state["enc"][0]
        self._last_tok[slot_idx, 0] = first_tok

    def admit(self):
        """Prefills queued requests into the free slots, one at a time
        (B = 1), each first token sampled and copied to the host."""
        tr = self._call_tracer()
        with _trace.armed(tr), tr.span("admit", cat="serve"):
            for i, slot in enumerate(self.slots):
                if slot.active or not self.queue:
                    continue
                self._prefill_into(i, self.queue.popleft(), tr)

    _admit = admit      # the name the benchmark harness drives

    def _prefill_into(self, i, req, tr):
        times = self.lifecycle[req.uid]
        times.t_prefill_start = time.perf_counter()
        with tr.span("prefill", cat="serve", device=True, uid=req.uid,
                     tokens=len(req.prompt)):
            with tr.span("prefill.h2d", cat="serve"):
                batch = {"tokens": torch.tensor(
                    [req.prompt], dtype=torch.int64, device=self.device)}
            if self._prefix is not None:
                batch["prefix_emb"] = self._prefix
            with tr.span("prefill.dispatch", cat="serve"):
                logits, st = self.model.prefill(
                    self.params, batch, cache_len=self.cache_len,
                    graphs=self._prefill_runner())
            with tr.span("prefill.first_token", cat="serve"):
                first = int(self._sample(logits[:, -1, :],
                                         req.temperature)[0])
            times.t_first_token = time.perf_counter()
            with tr.span("prefill.insert_state", cat="serve"):
                self._insert_state(i, st, first)
        self.prefills += 1
        tr.count("prefills")
        tr.count("prompt_tokens", len(req.prompt))
        self.slots[i] = _Slot(active=True, uid=req.uid,
                              remaining=req.max_new_tokens - 1,
                              stop_token=req.stop_token,
                              temperature=req.temperature,
                              generated=[first])

    def _prefill_runner(self):
        """The captured prefills where a padded prefill is exact on the
        card (module doc), captured at the first admission; else None."""
        if self._pads and self._prefill_graphs is None:
            self._prefill_graphs = _PrefillGraphs(
                self.model, self.params, self.cache_len, self.device)
        return self._prefill_graphs

    def _sample(self, logits, temperature):
        """[n, V] logits -> [n] token ids on the host."""
        if temperature <= 0:
            return logits.argmax(-1).cpu()
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu()

    # ------------------------------------------------------------------
    def step(self):
        """One decode step for every active slot."""
        tr = self._call_tracer()
        replay = self._graph is not None
        with _trace.armed(tr), tr.span("step", cat="serve", device=True):
            self._toks.copy_(self._last_tok)
            with tr.span("decode.dispatch", cat="serve"):
                logits = self._graph.replay(tr) if replay else \
                    self._decode_eagerly()
            with tr.span("decode.sample", cat="serve"):
                lg = logits[:, -1, :]
                greedy = self._sample(lg, 0.0)
            with tr.span("decode.slots", cat="serve"):
                self._advance(lg, greedy)
        self.decode_steps += 1
        tr.count("decode_steps")
        if replay:
            self.graph_replays += 1
            tr.count("decode_graph_replays")

    def _decode_eagerly(self):
        """The model's decode step launched from Python; on a CUDA
        device, captured after it (module doc)."""
        logits, _ = self.model.decode_step(self.params, self.state,
                                           self._toks)
        if self.device.type == "cuda":
            self._graph = _DecodeGraph(self.model, self.params, self.state,
                                       self._toks)
        return logits

    def _advance(self, lg, greedy):
        """Each active slot takes its token; a finished one is freed."""
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            nxt = int(greedy[i]) if slot.temperature <= 0 else \
                int(self._sample(lg[i:i + 1], slot.temperature)[0])
            slot.generated.append(nxt)
            self._last_tok[i, 0] = nxt
            slot.remaining -= 1
            if slot.remaining <= 0 or nxt == slot.stop_token:
                if nxt == slot.stop_token:
                    slot.generated.pop()
                self.done[slot.uid] = slot.generated
                self.slots[i] = _Slot()

    def run(self):
        """Drain the queue; returns {uid: generated tokens}."""
        while self.queue or any(s.active for s in self.slots):
            self.admit()
            if any(s.active for s in self.slots):
                self.step()
        return dict(self.done)

    @property
    def stats(self):
        return {"active": sum(s.active for s in self.slots),
                "queued": len(self.queue),
                "done": len(self.done)}


class _DecodeGraph:
    """A decode step captured as a CUDA graph over the engine's static
    tensors (module doc): ``logits`` is its output, which each replay
    writes anew."""

    def __init__(self, model, params, state, tokens):
        before = [fn.launches for fn in KERNELS]
        self.spans = _trace.GraphSpans()
        self.graph = torch.cuda.CUDAGraph()
        with _trace.armed(self.spans), torch.cuda.graph(self.graph):
            self.logits, _ = model.decode_step(params, state, tokens)
        # what a replay launches; the capture itself launched nothing
        self.launches = [fn.launches - n for fn, n in zip(KERNELS, before)]
        for fn, n in zip(KERNELS, before):
            fn.launches = n

    def replay(self, tr):
        t_in = time.perf_counter()
        self.graph.replay()
        for fn, n in zip(KERNELS, self.launches):
            fn.launches += n
        tr.replayed(self.spans, t_in, time.perf_counter())
        return self.logits


def _pads_exactly(model, cache_len):
    """Whether a B = 1 prefill of a prompt padded at its end up to any
    length within ``cache_len`` gives the prompt's rows what it gives
    them unpadded, and the model routes through a dropless MoE layer:
    a decoder-only text model whose every layer is causal self-attention
    over the whole cache and whose every FFN is dense or an MoE layer
    that drops no pair at any such length (``moe.drops_nothing``).
    Where an MoE layer could drop pairs, the padding would compete for
    its capacity; a Mamba or RWKV state would run on through it; a
    windowed ring could be overwritten by it.  Dense-only models would
    pad exactly too; they stay eager, their prefills not measured."""
    cfg = model.cfg
    if cfg.is_encoder_decoder or cfg.modality != "text":
        return False
    routed = False
    for kind in model.kinds:
        if kind["mixer"] != "attn" or kind["window"] or kind["cross"] \
                or not kind["causal"]:
            return False
        if kind["ffn"] == "moe":
            if not all(_moe.drops_nothing(cfg, n)
                       for n in _PrefillGraphs.lengths(cache_len)):
                return False
            routed = True
        elif kind["ffn"] not in ("dense", "dense0"):
            return False
    return routed


class _PrefillGraphs:
    """B = 1 prefills captured as CUDA graphs, one for each length in
    ``lengths(cache_len)`` (module doc).  A prompt runs in the shortest
    that holds it: its tokens and then zeros in that graph's static
    token buffer, the index of its last token in ``last``; the graph
    writes the logits and the decode state into static buffers that
    every graph shares (``run`` returns them; the engine copies the
    state into a slot before the next replay writes them again).  The
    graphs share one memory pool: they never run at once, and nothing
    one leaves in the pool is read after another runs."""

    STEP = 128

    @classmethod
    def lengths(cls, cache_len):
        return sorted({min(n, cache_len)
                       for n in range(cls.STEP, cache_len + cls.STEP,
                                      cls.STEP)})

    def __init__(self, model, params, cache_len, device):
        before = [fn.launches for fn in KERNELS]
        self.last = torch.zeros((1,), dtype=torch.int64, device=device)
        self.tokens, self.graphs = {}, {}
        self.logits = self.state = None
        pool = self.pool()
        for n in reversed(self.lengths(cache_len)):   # the pool's largest first
            toks = torch.zeros((1, n), dtype=torch.int64, device=device)
            self.tokens[n] = toks

            def prefill(toks=toks):
                return model._prefill(params, {"tokens": toks}, cache_len,
                                      self.last)
            self.last.fill_(n - 1)
            # eagerly first, counted nowhere: the shapes' libraries and
            # handles loaded
            with _trace.armed(_trace.NULL):
                logits, st = prefill()
            if self.logits is None:
                self.logits = logits.clone()
                self.state = tree_map(torch.clone, st)
            del logits, st

            def step(prefill=prefill):
                logits, st = prefill()
                self.logits.copy_(logits)
                tree_map(torch.Tensor.copy_, self.state, st)
            spans = _trace.GraphSpans()
            n0 = [fn.launches for fn in KERNELS]
            with _trace.armed(spans):
                graph = self.capture(step, pool)
            self.graphs[n] = (graph, spans, [fn.launches - m for fn, m
                                             in zip(KERNELS, n0)])
        # what a replay launches; the eager runs and captures count none
        for fn, m in zip(KERNELS, before):
            fn.launches = m

    # the capture itself; a CPU test replaces both with eager stand-ins
    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn, pool):
        """``fn`` captured (not run) as a CUDA graph in ``pool``."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            fn()
        return graph

    def run(self, batch):
        """(logits [1, 1, V], state) of ``batch``'s B = 1 prompt."""
        toks = batch["tokens"]
        n = toks.shape[1]
        m = next(k for k in sorted(self.tokens) if k >= n)
        buf = self.tokens[m]
        buf[:, :n].copy_(toks)
        buf[:, n:].zero_()
        self.last.fill_(n - 1)
        graph, spans, launches = self.graphs[m]
        t_in = time.perf_counter()
        graph.replay()
        for fn, k in zip(KERNELS, launches):
            fn.launches += k
        tr = _trace.current()
        tr.replayed(spans, t_in, time.perf_counter())
        # read now: another replay of this graph in the same admission
        # pass would record over its events
        tr.resolve()
        return self.logits, self.state


def _params_device(params):
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device
