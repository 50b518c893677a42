"""Wire codecs: the port of ``repro.wire.codecs``, what happens to an
exchanged hidden stack on its way across the (simulated) wire, as
encode-decode round trips, plus the host-side packed form the serving
cache stores.

Every codec treats the TRAILING axis as the unit that crosses the wire
-- one entity's W-wide hidden vector -- so the same functions serve the
training stack ``[n_clients, B, W]`` (per batch row) and the serving
slot stack ``[n_clients, S, W]`` (per slot):

  topk    keep the ceil(p * W) largest-|.| entries of each row (ties at
          the threshold all kept), exact zeros elsewhere: a per-row
          threshold read from ``torch.sort`` and an exact ``where``, so
          ``p = 1.0`` is a bitwise identity.
  int8    symmetric quantization with a per-row power-of-two scale
          ``2^e / 128`` (``2^(e-1) < max|row| <= 2^e``, by
          ``torch.frexp``), ``q = round(row / scale)`` rounding half to
          even (as ``jnp.round``) and clipped to [-127, 127], decoded
          ``q * scale``.  Every multiply and divide is by a power of
          two, so the round trip is idempotent bit for bit.
  dp      Gaussian release noise ``sigma * N(0, 1)`` an entry, from the
          round's draws under WIRE_TAG and the in-round step, one
          stream a client slot (``repro_torch.core.draws``).

topk and int8 give the reference's bits on the same input.  A gate is a
python bool (one federation: an off component is not computed) or a
per-slot tensor (a lane batch: an exact ``where``, so an off lane keeps
its input's bits).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.schedule.engine import over_rows

# the draw tag of the dp noise (disjoint from PARTICIPATION_TAG =
# 0x5EED and FAULT_TAG = 0xFA17)
WIRE_TAG = 0xC0DE


def _keep_count(p, w):
    """ceil(p * W) clipped to [1, W], in float32 as the reference."""
    if isinstance(p, torch.Tensor):
        return torch.ceil(p.to(torch.float32) * float(w)).to(
            torch.int64).clamp(1, w)
    return int(min(max(np.ceil(np.float32(p) * np.float32(w)), 1), w))


def topk_select(h, p):
    """Per-row magnitude sparsification of ``h``: keep the ceil(p * W)
    largest |.| entries of each trailing-axis row (ties at the
    threshold are all kept), exact zeros elsewhere.  ``p``: a float, or
    a per-slot [n] tensor (each client's own fraction)."""
    w = h.shape[-1]
    k = _keep_count(p, w)
    mag = h.abs()
    srt = torch.sort(mag, dim=-1).values        # ascending
    if isinstance(k, int):
        thresh = srt[..., w - k:w - k + 1]
    else:
        idx = over_rows(w - k, h.dim()).expand(h.shape[:-1] + (1,))
        thresh = torch.gather(srt, -1, idx)
    return torch.where(mag >= thresh, h, torch.zeros_like(h))


def int8_roundtrip(h):
    """Symmetric int8 quantize -> dequantize with a per-row power-of-two
    scale.  All scaling is exact float arithmetic, so applying this
    twice equals applying it once, bit for bit."""
    amax = h.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(amax)                # amax <= 2^e < 2 * amax
    scale = torch.ldexp(torch.ones_like(amax), e - 7)   # 2^e / 128
    q = torch.clamp(torch.round(h / scale), -127.0, 127.0)
    return q * scale


def dp_noise(draws, step, shape):
    """[n_clients, *shape] standard normals for in-round step ``step``,
    client i's from its own slot's stream: a padded federation's live
    noise is the unpadded one's, bit for bit."""
    return draws.normal(WIRE_TAG, step, shape)


def _gate(on, new, old):
    if isinstance(on, bool):
        return new if on else old
    return torch.where(over_rows(on, new.dim()) > 0, new, old)


def wire_apply(h, draws, step, *, topk_on, topk_p, int8_on, dp_on,
               dp_sigma):
    """The full encode-decode round trip over a per-client stack ``h
    [n, ..., W]``: sparsify, quantize, noise, each component gated (a
    python bool, or a per-slot tensor for a lane batch's lanes).
    ``draws``/``step``: the round's draws and the in-round step."""
    h1 = h if topk_on is False else _gate(topk_on, topk_select(h, topk_p), h)
    h2 = h1 if int8_on is False else _gate(int8_on, int8_roundtrip(h1), h1)
    if dp_on is False:
        return h2
    if isinstance(dp_sigma, torch.Tensor):
        dp_sigma = over_rows(dp_sigma, h.dim())
    # a float scales in float32, as the reference's float32 sigma does
    noise = dp_sigma * dp_noise(draws, step, h.shape[1:])
    return _gate(dp_on, h2 + noise, h2)


def wire_bytes(live_n, rows, width, *, topk_on, topk_p, int8_on):
    """Integer bytes-on-wire for one step's exchange: ``raw`` is the
    fp32 dense cost, ``encoded`` what the active components ship -- per
    kept entry 1 byte (int8) or 4 (fp32), plus 4-byte indices for topk's
    kept entries and a 4-byte scale per quantized row.  The dp component
    is payload-size-neutral.  ``live_n`` is the round's effective sender
    count.  Float32 arithmetic in the reference's order, then int32."""
    live_n = torch.as_tensor(live_n, dtype=torch.float32)
    dev = live_n.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    topk_on, topk_p, int8_on = f32(topk_on), f32(topk_p), f32(int8_on)
    kept = torch.where(topk_on > 0, torch.ceil(topk_p * f32(width)),
                       f32(width))
    per_entry = torch.where(int8_on > 0, f32(1.0), f32(4.0))
    per_row = (kept * per_entry
               + torch.where(topk_on > 0, f32(4.0) * kept, f32(0.0))
               + torch.where(int8_on > 0, f32(4.0), f32(0.0)))
    raw = live_n * f32(4.0 * rows * width)
    enc = live_n * f32(rows) * per_row
    return raw.to(torch.int32), enc.to(torch.int32)


def wire_apply_static(plan, h, draws=None, step=0):
    """``wire_apply`` with the plan's components resolved statically --
    the serving / probe path, where one process runs one transform.
    ``draws=None`` skips the dp component (serving releases
    codec-encoded payloads; dp is a training-time release control)."""
    if plan.topk is not None:
        h = topk_select(h, plan.topk)
    if plan.int8:
        h = int8_roundtrip(h)
    if plan.dp is not None and draws is not None:
        h = h + plan.dp * dp_noise(draws, step, h.shape[1:])
    return h


# ---------------------------------------------------------------------------
# host-side packed form (the serving ExchangeCache entry)
# ---------------------------------------------------------------------------
class WirePayload(NamedTuple):
    """One encoded exchange stack as it would sit in a transport
    buffer: per-client entry tuples ``(idx, vals, scale)`` -- kept
    indices (or None when dense), int8 or fp32 values, and the per-row
    scale (or None when unquantized) -- plus the dense shape and the
    integer wire size."""
    entries: tuple
    shape: tuple
    nbytes: int


def pack(plan, h) -> WirePayload:
    """Encode an (already round-tripped) per-client stack ``h [n, W]``
    into its packed wire form.  Codec idempotence guarantees
    ``unpack(pack(plan, h)) == h`` bit for bit when ``h`` came out of
    :func:`wire_apply_static` for the same plan."""
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    h = np.asarray(h, np.float32)
    flat = h.reshape(h.shape[0], -1)
    entries, nbytes = [], 0
    for row in flat:
        if plan.topk is not None:
            idx = np.nonzero(row)[0].astype(np.int32)
            vals = row[idx]
            nbytes += 4 * int(idx.size)
        else:
            idx, vals = None, row
        if plan.int8:
            amax = np.float32(np.abs(vals).max()) if vals.size \
                else np.float32(0.0)
            _, e = np.frexp(amax)
            scale = np.ldexp(np.float32(1.0), int(e) - 7)
            q = np.clip(np.round(vals / scale), -127, 127) \
                .astype(np.int8)
            entries.append((idx, q, np.float32(scale)))
            nbytes += int(q.size) + 4
        else:
            entries.append((idx, vals, None))
            nbytes += 4 * int(vals.size)
    return WirePayload(tuple(entries), h.shape, int(nbytes))


def unpack(payload: WirePayload) -> np.ndarray:
    """Decode a packed payload back to the dense fp32 stack."""
    n = len(payload.entries)
    width = int(np.prod(payload.shape[1:], dtype=np.int64))
    out = np.zeros((n, width), np.float32)
    for i, (idx, vals, scale) in enumerate(payload.entries):
        dense = vals.astype(np.float32) * scale if scale is not None \
            else vals
        if idx is None:
            out[i] = dense
        else:
            out[i, idx] = dense
    return out.reshape(payload.shape)
