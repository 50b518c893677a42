"""The arithmetic behind the metric files (``e2e/<name>.py`` and
``metrics/<name>.py``): each reads one number from a finished run,
``Run`` below, or returns None where the run holds nothing to read.

Every end-to-end metric is taken over the whole window on the host's
clock: the tokens its clients were handed, the requests whose first
token came in it, every gap between two tokens of one request that both
came in it.  The per-layer metrics read the same run's host spans
(``admit``, ``step``) and, in a traced run, its device trace.
"""
from __future__ import annotations

from perfbench import peaks, stats, work


class Run:
    """What one run saw: the server and its records, the window, the
    device trace (traced runs) and the card."""

    def __init__(self, srv, t_open, t_close, setup_s, trace=None,
                 card=(None, None), t_trace=None):
        self.srv, self.t_open, self.t_close = srv, t_open, t_close
        self.setup_s = setup_s
        self.ops = trace          # [(name, start, end)] or None
        self.t_trace = t_trace or t_close      # the traced part's end
        self.power_w, self.exp_rate = card
        self.cfg = srv.cfg
        self.seconds = t_close - t_open
        self.traced_s = self.t_trace - t_open

    def inside(self, t):
        return self.t_open <= t <= self.t_close

    def steps(self, end=None):
        end = end or self.t_close
        return [s for s in self.srv.steps if s[0] >= self.t_open
                and s[1] <= end]

    def admits(self, end=None):
        end = end or self.t_close
        return [a for a in self.srv.admits if a[0] >= self.t_open
                and a[1] <= end]

    def prefills(self, end=None):
        """Prompt lengths of the prefills inside the window (up to
        ``end``)."""
        return [len(self.srv.reqs[u].prompt) for a in self.admits(end)
                for u in a[3]]

    def device_s(self, stems):
        """Device seconds of the traced kernels whose names hold a stem."""
        if self.ops is None:
            return None
        return sum(min(e, self.t_trace) - max(s, self.t_open)
                   for n, s, e in self.ops
                   if e > self.t_open and s < self.t_trace
                   and any(stem in n for stem in stems))

    def busy_s(self):
        if self.ops is None:
            return None
        return stats.covered([(s, e) for _, s, e in self.ops],
                             self.t_open, self.t_trace)


# ---------------------------------------------------------------------------
# end to end
def output_tok_s(run):
    n = sum(1 for r in run.srv.reqs.values() for t in r.times
            if run.inside(t))
    return n / run.seconds


def ttft_ms(run, q):
    vals = [(r.times[0] - r.t_submit) * 1e3 for r in run.srv.reqs.values()
            if r.t_submit >= run.t_open and r.times and run.inside(r.times[0])]
    return stats.percentile(vals, q)


def itl_ms(run, q):
    vals = [(b - a) * 1e3 for r in run.srv.reqs.values()
            for a, b in zip(r.times, r.times[1:])
            if a >= run.t_open and b <= run.t_close]
    return stats.percentile(vals, q)


def prefill_tok_s(run):
    return sum(a[2] for a in run.admits()) / run.seconds


# ---------------------------------------------------------------------------
# per layer
def decode_step_ms(run):
    return stats.median([(b - a) * 1e3 for a, b, _ in run.steps()])


def prefill_ms_per_ktok(run):
    return stats.median([(b - a) * 1e3 / (tok / 1e3)
                         for a, b, tok, _ in run.admits()])


def attn_roofline(run):
    """Σ bound / Σ device time of the attention kernels, in %: each call's
    bound the larger of its operations over the bf16 peak and its bytes
    over HBM's, its work counted from the traffic's shapes."""
    cfg = run.cfg
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    layers = sum(m == "attn" for m, _ in work._layer_kinds(cfg))
    bound = 0.0
    for S in run.prefills(run.t_trace):
        f, b = work.attention_prefill_work(S, H, KV, hd)
        bound += layers * max(f / peaks.BF16_FLOP_PER_S,
                              b / peaks.HBM_BYTES_PER_S)
    for _, _, keys in run.steps(run.t_trace):
        f, b = work.attention_decode_work(keys, H, KV, hd,
                                          run.srv.mix["cache_len"])
        bound += layers * max(f / peaks.BF16_FLOP_PER_S,
                              b / peaks.HBM_BYTES_PER_S)
    return _share(bound, run.device_s(peaks.ATTENTION_KERNELS))


def mamba_scan_roofline(run):
    """The same for ``mamba_scan_fused``: bytes over HBM's peak, float32
    operations over the float32 peak, exponentials over the SFU's rate."""
    cfg = run.cfg
    layers = sum(m == "mamba" for m, _ in work._layer_kinds(cfg))
    if not layers or run.exp_rate is None:
        return None
    D, N = cfg["ssm_expand"] * cfg["d_model"], cfg["ssm_state_dim"]

    def bound(nbytes, ops, exps):
        return max(nbytes / peaks.HBM_BYTES_PER_S,
                   ops / peaks.FP32_FLOP_PER_S, exps / run.exp_rate)
    total = sum(layers * bound(*work.mamba_scan_fused_work(1, S, D, N))
                for S in run.prefills(run.t_trace))
    total += sum(layers * bound(*work.mamba_scan_fused_work(
        len(keys), 1, D, N, with_state=True))
        for _, _, keys in run.steps(run.t_trace))
    return _share(total, run.device_s(peaks.MAMBA_KERNELS))


def mfu(run):
    """The model's operations in the traced window over its seconds at
    the bf16 peak, in %."""
    if run.ops is None:
        return None
    cfg = run.cfg
    flops = sum(work.model_flops(cfg, S, S * (S + 1) // 2, 1)
                for S in run.prefills(run.t_trace))
    flops += sum(work.model_flops(cfg, len(keys), sum(keys), len(keys))
                 for _, _, keys in run.steps(run.t_trace))
    return 100.0 * flops / (run.traced_s * peaks.BF16_FLOP_PER_S)


def idle_share(run):
    busy = run.busy_s()
    return None if busy is None else 100.0 * (1.0 - busy / run.traced_s)


def _share(bound_s, device_s):
    if not device_s:
        return None
    return 100.0 * bound_s / device_s
