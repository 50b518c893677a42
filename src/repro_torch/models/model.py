"""Top-level Model: config -> init / loss / forward / prefill / decode.  The
port of ``repro.models.model`` for every LM family: decoder-only (dense,
MoE, ssm, hybrid), the vlm family's decoder over image rows before the
text (``prefix_emb``), and the audio family's encoder-decoder (frames
through the encoder, ``_encode``; the decoder's cross attention over
its output, kept in the decode state as ``"enc"``).  The paper's MLPs
run through ``PaperMLP`` (stacked clients), which the federation builds
itself.

Parameters are a nested dict of tensors in the reference's tree
(``vfl_embedding``, ``stack``, ``final_norm``, ``lm_head``, and
``encoder`` with its own ``stack`` and ``final_norm``), so weights cross
over by key (``repro_torch.interop``).  ``forward_logits`` and ``loss``
build autograd's graph where the parameters require grad (the training
step, ``launch/train.py``, differentiates ``loss``); ``init``,
``prefill`` and ``decode_step`` run under ``torch.no_grad()``: serving
keeps no graph.

``clients`` (``Model`` and ``build_model``) is the number of clients
the input block's exchange emulates, the size of the reference's mesh
client axis (1: the plain lookup; ``transformer.embed_input``).  It goes
to every ``embed_input`` call: ``forward_logits`` and ``loss``,
``prefill`` and ``decode_step``.

The kernel hooks, keyword arguments of ``Model`` and ``build_model``:
``attend`` is the attention function every attention layer calls, with
``flash_attention``'s signature (None: ``flash_attention``, the kernel
on CUDA tensors); ``route`` the router every MoE layer calls
(None: ``moe_router``); ``wkv`` the WKV scan every RWKV6 time mix calls
(None: ``rwkv6_scan``); ``sscan`` the selective scan every Mamba mixer
calls, with ``mamba_scan_fused``'s signature ``(dt, x, B, C, A, h0, *,
h_out)`` (None: ``mamba_scan_fused``).  ``chip_smoke.py`` passes the plain
versions, and planted faults, to read the kernels' effect on the logits
and the routes.

Spans (``repro_torch.obs.trace``, into the tracer the serving engine
armed): ``input_block`` (host and device) around the input block, with
the clients, the exchange mode and the bytes the clients transmit
(``exchange_bytes``) as arguments, and ``lm_head`` around the final norm
and the output head, in ``prefill`` and ``decode_step``; the layers'
own in ``transformer`` and ``moe``.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs import trace as _trace


def padded_vocab(v: int) -> int:
    return ((v + 127) // 128) * 128


class Model:
    """Decoder-only or encoder-decoder LM assembled from a ModelConfig."""

    def __init__(self, cfg, clients=1, **hooks):
        self.cfg = cfg
        self.clients = clients
        self.dtype = L.dtype_of(cfg.dtype)
        self.kinds = T.layer_kinds(cfg)
        self.enc_kinds = T.encoder_kinds(cfg) if cfg.is_encoder_decoder \
            else []
        self.vocab = padded_vocab(cfg.vocab_size)
        unknown = set(hooks) - {"attend", "route", "wkv", "sscan"}
        if unknown:
            raise TypeError(f"unknown kernel hooks: {sorted(unknown)}")
        self.hooks = hooks

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator):
        """Random weights drawn from ``generator`` on its device (a CUDA
        generator initialises on the card: 7.6 B normals drawn on the
        host would take minutes)."""
        cfg = self.cfg
        emb_key = "vfl_embedding" if cfg.vfl.enabled else "embedding"
        params = {
            emb_key: L.embedding_init(generator, self.vocab, cfg.d_model,
                                      self.dtype),
            "stack": T.stack_init(generator, cfg, self.kinds, self.dtype),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type,
                                      generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                             self.vocab, dtype=self.dtype)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "stack": T.stack_init(generator, cfg, self.enc_kinds,
                                      self.dtype),
                "final_norm": L.norm_init(cfg.d_model, cfg.norm_type,
                                          generator.device),
            }
        return params

    def init_meta(self):
        """The parameter tree on the meta device: every leaf's shape and
        dtype, no number drawn and no memory allocated (the dry run,
        ``launch/dryrun.py``)."""
        return self.init(L.MetaGenerator())

    def exchange_bytes(self, batch_shape, prefix_rows=0):
        """Bytes the input block's exchange sends for a batch of
        ``batch_shape`` = (B, S) token ids (``prefix_rows`` image rows
        before them), counted from shapes and the table's dtype; no
        transfer takes place on one card.  'zeropad_psum': each of the
        n clients sends a full-width [B, P + S, D] tensor; 'allgather':
        each sends its [B, P + S, D/n] slice, one full width in all.
        0 with one client or the input block off."""
        cfg = self.cfg
        if self.clients == 1 or not cfg.vfl.enabled:
            return 0
        B, S = batch_shape
        full = B * (prefix_rows + S) * cfg.d_model * self.dtype.itemsize
        return full * (self.clients if cfg.vfl.exchange == "zeropad_psum"
                       else 1)

    # ------------------------------------------------------------------
    @staticmethod
    def _positions(n, device):
        return torch.arange(n, dtype=torch.int32, device=device)

    def _encode(self, params, prefix_emb):
        """Encoder pass (audio family): frame embeddings [B, F, D] ->
        memory [B, F, D] in the model's dtype."""
        h = prefix_emb.to(self.dtype)
        pos = self._positions(h.shape[1], h.device)
        h, _ = T.stack_apply(params["encoder"]["stack"], h, pos, self.cfg,
                             self.enc_kinds, self.hooks)
        return L.apply_norm(params["encoder"]["final_norm"], h,
                            self.cfg.norm_type)

    def _inputs(self, params, batch):
        """(decoder input [B, P + S, D] or [B, S, D], encoder memory or
        None) of a batch: an encoder-decoder encodes ``prefix_emb``; a
        vlm puts it before the text (where the batch has one)."""
        cfg = self.cfg
        enc = prefix = None
        if cfg.is_encoder_decoder:
            enc = self._encode(params, batch["prefix_emb"])
        elif cfg.modality != "text" and "prefix_emb" in batch:
            prefix = batch["prefix_emb"]
        return self._embed(params, batch["tokens"], prefix), enc

    def _embed(self, params, tokens, prefix=None):
        """The input block (``transformer.embed_input``) under the
        ``input_block`` span."""
        rows = 0 if prefix is None else prefix.shape[1]
        with _trace.current().span(
                "input_block", cat="model", device=True,
                clients=self.clients, exchange=self.cfg.vfl.exchange,
                bytes=self.exchange_bytes(tokens.shape, rows)):
            return T.embed_input(params, tokens, self.cfg,
                                 prefix_emb=prefix, clients=self.clients)

    def _head(self, params, h):
        """Final norm and output head: float32 logits."""
        with _trace.current().span("lm_head", cat="model"):
            h = L.apply_norm(params["final_norm"], h, self.cfg.norm_type)
            return T.logits_from_hidden(params, h, self.cfg)

    def forward_logits(self, params, batch):
        """batch: {'tokens': [B,S_text]} (+ 'prefix_emb': [B,P,D]).
        Returns (logits [B,S_text,V] float32 at the text positions,
        aux)."""
        cfg = self.cfg
        S_text = batch["tokens"].shape[1]
        h, enc = self._inputs(params, batch)
        S_total = h.shape[1]
        positions = self._positions(S_total, h.device)
        h, aux = T.stack_apply(params["stack"], h, positions, cfg,
                               self.kinds, self.hooks, enc)
        h = L.apply_norm(params["final_norm"], h[:, S_total - S_text:, :],
                         cfg.norm_type)
        return T.logits_from_hidden(params, h, cfg), aux

    def loss(self, params, batch):
        """Next-token CE plus the MoE load-balance ``aux``: batch needs
        'tokens' and 'labels' (same shape); labels < 0 are masked.
        Returns (loss, {'ce', 'aux', 'tokens'}), 0-d float32 tensors.
        The label logit is a gather where the reference contracts a
        one-hot (which only spares it a gather of vocab-sharded logits);
        the two are equal in float32."""
        logits, aux = self.forward_logits(params, batch)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        lab = labels.clamp(min=0).long()
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, lab[..., None])[..., 0]
        ll = label_logit - lse
        tokens = mask.sum()
        ce = -(ll * mask).sum() / tokens.clamp(min=1.0)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": tokens}

    # ------------------------------------------------------------------
    # prefill (forward-only; returns logits and a populated decode state)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, cache_len=None, last=None,
                graphs=None):
        """batch as in forward_logits. Returns (last-token logits
        [B,1,V], decode state ready for decode_step at position
        seq_len).

        ``last``: a [1] int64 tensor on the batch's device, the index of
        the prompt's last token where the tokens past it are padding;
        the logits are that row's and the position is one past it.  The
        padding's rows of the cache hold its keys and values at their
        positions, after the prompt's, which a causal decode masks until
        it writes over them.  ``graphs``: an object that runs the
        prefill instead (``graphs.run(batch)``: the serving engine's
        captured prefills), so that whoever wraps this method sees
        every admission's prefill."""
        if graphs is not None:
            return graphs.run(batch)
        return self._prefill(params, batch, cache_len, last)

    @torch.no_grad()
    def _prefill(self, params, batch, cache_len, last):
        cfg = self.cfg
        B = batch["tokens"].shape[0]
        h, enc = self._inputs(params, batch)
        S_total = h.shape[1]
        cache_len = cache_len or S_total
        positions = self._positions(S_total, h.device)
        h, cache = T.stack_prefill(params["stack"], h, positions, cfg,
                                   self.kinds, B, cache_len, self.dtype,
                                   self.hooks, enc)
        if last is None:
            logits = self._head(params, h[:, -1:, :])
            pos = torch.full((B,), S_total, dtype=torch.int32,
                             device=h.device)
        else:
            logits = self._head(params, h.index_select(1, last))
            pos = (last + 1).to(torch.int32).expand(B).clone()
        state = {"cache": cache, "position": pos}
        if cfg.is_encoder_decoder:
            state["enc"] = enc
        return logits, state

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_decode_state(self, batch_size, seq_len, prefill_len=None,
                          device=None):
        """Empty caches and positions for ``batch_size`` slots of
        ``seq_len`` (and, for an encoder-decoder, a zero encoder memory
        ``"enc"``), on ``device``: CUDA unless the caller names another
        (raises without a card, as the rest of the port does)."""
        from repro_torch.core.protocol import resolve_device
        cfg = self.cfg
        device = resolve_device(device)
        state = {
            "cache": T.stack_init_cache(cfg, self.kinds, batch_size,
                                        seq_len, self.dtype, device),
            "position": torch.full((batch_size,),
                                   prefill_len if prefill_len is not None
                                   else 0, dtype=torch.int32, device=device),
        }
        if cfg.is_encoder_decoder:
            state["enc"] = torch.zeros(
                (batch_size, cfg.num_prefix_embeddings, cfg.d_model),
                dtype=self.dtype, device=device)
        return state

    @torch.no_grad()
    def decode_step(self, params, state, tokens):
        """tokens: [B,1] -> (logits [B,1,V], state).  ``state`` is
        advanced in place: every cache written, ``position`` one on;
        it is returned, and every tensor in it stays the same object, so
        that a CUDA graph captured over the step replays it (the serving
        engine's)."""
        cfg = self.cfg
        h = self._embed(params, tokens)
        pos = state["position"]
        h, _ = T.stack_decode(params["stack"], h, pos, cfg, self.kinds,
                              state["cache"], self.hooks, state.get("enc"))
        logits = self._head(params, h)
        pos.add_(1)
        return logits, state


def build_model(cfg, clients=1, **hooks):
    if getattr(cfg, "family", "mlp") == "mlp":
        raise ValueError(
            f"{cfg.name} is a paper MLP: repro_torch runs it through "
            "repro_torch.models.PaperMLP (stacked clients), not Model")
    return Model(cfg, clients=clients, **hooks)
