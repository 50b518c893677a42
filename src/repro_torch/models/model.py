"""Top-level Model: config -> init / forward / prefill / decode.  The
port of ``repro.models.model`` for the decoder-only text families
(dense, MoE, ssm, hybrid).  The paper's MLPs
run through ``PaperMLP`` (stacked clients), which the federation builds
itself.

Parameters are a nested dict of tensors in the reference's tree
(``vfl_embedding``, ``stack``, ``final_norm``, ``lm_head``), so weights
cross over by key (``repro_torch.interop``).  Everything here is
forward-only, under ``torch.no_grad()``: the LM's training path
(``launch/train.py``) is not ported yet.

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
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def padded_vocab(v: int) -> int:
    return ((v + 127) // 128) * 128


class Model:
    """Decoder-only LM assembled from a ModelConfig."""

    def __init__(self, cfg, **hooks):
        if cfg.is_encoder_decoder or cfg.modality != "text":
            raise T._unported(f"the {cfg.family!r} family ({cfg.name})")
        self.cfg = cfg
        self.dtype = L.dtype_of(cfg.dtype)
        self.kinds = T.layer_kinds(cfg)
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
        return params

    # ------------------------------------------------------------------
    @staticmethod
    def _positions(n, device):
        return torch.arange(n, dtype=torch.int32, device=device)

    @torch.no_grad()
    def forward_logits(self, params, batch):
        """batch: {'tokens': [B,S]}.  Returns (logits [B,S,V] float32,
        aux)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = T.embed_input(params, tokens, cfg)
        positions = self._positions(h.shape[1], h.device)
        h, aux = T.stack_apply(params["stack"], h, positions, cfg,
                               self.kinds, self.hooks)
        h = L.apply_norm(params["final_norm"], h, cfg.norm_type)
        return T.logits_from_hidden(params, h, cfg), aux

    # ------------------------------------------------------------------
    # prefill (forward-only; returns logits and a populated decode state)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, cache_len=None):
        """batch as in forward_logits. Returns (last-token logits
        [B,1,V], decode state ready for decode_step at position
        seq_len)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        h = T.embed_input(params, tokens, cfg)
        S_total = h.shape[1]
        cache_len = cache_len or S_total
        positions = self._positions(S_total, h.device)
        h, cache = T.stack_prefill(params["stack"], h, positions, cfg,
                                   self.kinds, B, cache_len, self.dtype,
                                   self.hooks)
        h = L.apply_norm(params["final_norm"], h[:, -1:, :], cfg.norm_type)
        logits = T.logits_from_hidden(params, h, cfg)
        state = {"cache": cache,
                 "position": torch.full((B,), S_total, dtype=torch.int32,
                                        device=h.device)}
        return logits, state

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_decode_state(self, batch_size, seq_len, prefill_len=None,
                          device=None):
        """Empty caches and positions for ``batch_size`` slots of
        ``seq_len``, on ``device``: CUDA unless the caller names another
        (raises without a card, as the rest of the port does)."""
        from repro_torch.core.protocol import resolve_device
        device = resolve_device(device)
        return {
            "cache": T.stack_init_cache(self.cfg, self.kinds, batch_size,
                                        seq_len, self.dtype, device),
            "position": torch.full((batch_size,),
                                   prefill_len if prefill_len is not None
                                   else 0, dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def decode_step(self, params, state, tokens):
        """tokens: [B,1] -> (logits [B,1,V], new_state).  The caches in
        ``state`` are written in place; the new state shares them."""
        cfg = self.cfg
        h = T.embed_input(params, tokens, cfg)
        pos = state["position"]
        h, new_cache = T.stack_decode(params["stack"], h, pos, cfg,
                                      self.kinds, state["cache"],
                                      self.hooks)
        h = L.apply_norm(params["final_norm"], h, cfg.norm_type)
        logits = T.logits_from_hidden(params, h, cfg)
        new_state = dict(state)
        new_state["cache"] = new_cache
        new_state["position"] = pos + 1
        return logits, new_state


def build_model(cfg, **hooks):
    if getattr(cfg, "family", "mlp") == "mlp":
        raise ValueError(
            f"{cfg.name} is a paper MLP: repro_torch runs it through "
            "repro_torch.models.PaperMLP (stacked clients), not Model")
    return Model(cfg, **hooks)
