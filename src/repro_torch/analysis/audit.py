"""Trace-and-audit orchestration: build a federation, trace one round of
it into an aten graph (``ir.trace_round``), and drive the taint,
deadness and retrace passes over the graph; the port of
``repro.analysis.audit``.

The harness closes over everything the passes treat as known -- the
round's batch indices and draws, the labels and the ``LayoutArrays`` --
so they arrive as graph constants the interpreters can fold, while the
carried state (parameters, optimizer state, schedule state) and the
feature matrix stay placeholders so they can be seeded per client slot.

Seeding encodes the induction hypothesis "round inputs are already
separated": client slot i's state leaves carry taint bit i, feature
column c carries the bit of the client that owns it, and the audited
theorem is that one round preserves that separation -- slot j's outputs
carry only bit j plus declassified channel content.

Tracing uses a tiny dataset slice (26 training rows, one batch a
round): the graph's structure does not depend on the data's size, and
the port unrolls the round's Python loop over batches, so one batch
keeps it short.  Tracing runs the round for real (``make_fx`` in real
mode), on copies of the state.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import deadness as DN
from repro_torch.analysis import ir
from repro_torch.analysis import retrace as RT
from repro_torch.analysis import taint as TA
from repro_torch.analysis.barrier import audit_tracing
from repro_torch.analysis.report import AnalysisReport, apply_waivers
from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                       resolve_device, resolve_first_layer,
                                       round_generator, train_generators)

ALL_PASSES = ("taint", "deadness", "retrace")

# trace-size overrides: the audit proves structural contracts, which do
# not depend on the data's size
_TRACE_KW = dict(n_samples=32, batch_size=16, epochs=1, rounds=1)

IN_GROUPS = ("params", "opt_state", "sched_state", "xtr")
OUT_GROUPS = ("params", "opt_state", "step_idx", "sched_state", "losses")


def _as_pcfg(spec) -> ProtocolConfig:
    """Accept a ProtocolConfig or a repro_torch.api ExperimentSpec."""
    if isinstance(spec, ProtocolConfig):
        return spec
    from repro_torch.api.modes import get_mode       # api sits above
    from repro_torch.api.session import _protocol_config
    return _protocol_config(spec, get_mode(spec.mode).internal)


def combo_name(pcfg: ProtocolConfig, device=None) -> str:
    name = (f"{pcfg.mode}/{pcfg.schedule}/"
            f"{resolve_first_layer(pcfg, torch.device(device or 'cpu'))}")
    if pcfg.fault != "none":
        name = f"{name}/{pcfg.fault}"
    return name if pcfg.transform == "none" else f"{name}/{pcfg.transform}"


# ---------------------------------------------------------------------------
# the trace harness
# ---------------------------------------------------------------------------
class TracedRound:
    """One federation's round as a traced graph (``graph``, an
    ``ir.TracedGraph``) plus the leaf bookkeeping the passes need.
    ``args`` is the state the round was traced from (left as it was);
    ``graph.outputs`` what the traced round returned."""

    def __init__(self, pcfg: ProtocolConfig, device=None):
        self.pcfg = pcfg
        fed = DeVertiFL(pcfg, device=device)
        self.fed = fed
        self.combo = combo_name(pcfg, fed.device)
        self.n_real = fed.layout.n_real
        self.n_padded = fed.layout.n_clients
        params = fed.init_params(train_generators(pcfg.seed)[0])
        self.args = (params, fed.opt.init(params), fed.init_sched_state(),
                     fed._xtr)
        self.idx = fed.perms(round_generator(pcfg.seed, 0)).to(fed.device)
        self.draws = fed.draws().round(0)
        with audit_tracing():
            self.graph = ir.trace_round(self.harness, self.args)

    def harness(self, params, opt_state, sched_state, xtr):
        """Round 0 from the given state: (params, opt_state, step_idx,
        sched_state, losses) on every path."""
        fed = self.fed
        if fed._impl is None:
            p, o, s, losses = fed._round(params, opt_state, 0, self.idx,
                                         xtr, fed._ytr, fed._lay)
            return p, o, s, sched_state, losses
        return fed._round(params, opt_state, 0, self.idx, xtr, fed._ytr,
                          fed._lay, sched_state, self.draws)

    # -- labels ----------------------------------------------------------
    @staticmethod
    def _index(label) -> int:
        return int(label[1:label.index("]")])

    def group_of(self, in_label) -> str:
        return IN_GROUPS[self._index(in_label)]

    def out_label(self, in_label) -> str:
        """The output label of a carried input leaf."""
        i = self._index(in_label)
        j = OUT_GROUPS.index(IN_GROUPS[i])
        return f"[{j}]" + in_label[in_label.index("]") + 1:]

    def pretty(self, label, groups=IN_GROUPS) -> str:
        return groups[self._index(label)] + label[label.index("]") + 1:]

    def client_axis(self, shape) -> Optional[int]:
        """The stacked-client axis of a state leaf, by shape: params and
        optimizer leaves are [n, ...] (axis 0); schedule buffers [n, B,
        W] (axis 0) or ring-stacked [depth, n, B, W] (axis ndim-3).
        None for scalars and client-free leaves."""
        nd = len(shape)
        if nd >= 3 and shape[nd - 3] == self.n_padded:
            return nd - 3
        if nd >= 1 and shape[0] == self.n_padded:
            return 0
        return None

    def taint_seeds(self):
        """Input taints aligned with the placeholders: state leaves per
        slot on their client axis, features per column by owner."""
        slot_bits = np.array([np.int64(1) << i
                              for i in range(self.n_padded)])
        lo = self.fed.layout
        seeds = []
        for ph, label in zip(self.graph.placeholders, self.graph.in_labels):
            shp = ir.shape(ph)
            if self.group_of(label) == "xtr":
                col = np.zeros(shp[1], np.int64)
                for i, (off, sz) in enumerate(zip(lo.offsets, lo.sizes)):
                    col[off:off + sz] |= np.int64(1) << i
                seeds.append(TA.perslot(1, col))
                continue
            ax = self.client_axis(shp)
            seeds.append(TA.EMPTY if ax is None else
                         TA.perslot(ax, slot_bits))
        return seeds

    def out_specs(self):
        """Per-output separation contract: carried state stays per slot
        on its client axis; the step counter and the loss stream are
        aggregate telemetry, excluded by contract."""
        specs = []
        for item, label in zip(self.graph.out_items, self.graph.out_labels):
            name = self.pretty(label, OUT_GROUPS)
            ax = self.client_axis(ir.shape(item))
            if OUT_GROUPS[self._index(label)] in ("step_idx", "losses") \
                    or ax is None:
                specs.append(("skip", None, name))
            else:
                specs.append(("perslot", ax, name))
        return specs


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------
def audit(spec, passes: Optional[Sequence[str]] = None,
          lane_check: bool = True, device=None) -> AnalysisReport:
    """Statically audit one experiment's round.

    ``spec`` is a repro_torch.api ExperimentSpec or a ProtocolConfig;
    its training-size knobs are shrunk for tracing.  ``passes`` selects
    from ``("taint", "deadness", "retrace")`` (default: all).
    ``lane_check=False`` skips the retrace pass's lane comparison (the
    grid runs it once, not per combo).  ``device`` is CUDA unless the
    caller names another.  ``report.ok`` is the gate."""
    pcfg = _as_pcfg(spec).replace(**_TRACE_KW)
    device = resolve_device(device)
    passes = tuple(passes or ALL_PASSES)
    bad = set(passes) - set(ALL_PASSES)
    if bad:
        raise ValueError(f"unknown pass(es) {sorted(bad)}; "
                         f"choose from {ALL_PASSES}")
    report = AnalysisReport(combos=(combo_name(pcfg, device),),
                            passes_run=passes)
    tr = TracedRound(pcfg, device)

    if "taint" in passes:
        findings, channels = TA.run_taint(
            tr.graph, tr.taint_seeds(), tr.out_specs(), tr.combo,
            tr.n_padded)
        report.findings.extend(findings)
        for ch, n in channels.items():
            report.channels[ch] = report.channels.get(ch, 0) + n

    if "deadness" in passes:
        # prove dead-slot zeros on a padded twin: an unpadded config has
        # no dead slots; the obligation is the padded variant every
        # sweep lane runs
        twin = tr if tr.n_real < tr.n_padded else TracedRound(
            pcfg.replace(max_clients=pcfg.n_clients + 1), device)
        report.findings.extend(DN.run_deadness(
            twin.graph, tr.combo, twin.n_real, twin.n_padded))

    if "retrace" in passes:
        report.findings.extend(RT.run_retrace(tr))
        if lane_check:
            report.findings.extend(RT.run_lane_check(pcfg.dataset, device))
        _stamp_traces(report)

    apply_waivers(report.findings)
    return report


def _stamp_traces(report: AnalysisReport):
    """static_round_traces == 1 iff the retrace pass ran and proved
    clean."""
    bad = any(f.pass_name == "retrace" and f.severity == "error"
              and not f.waived for f in report.findings)
    report.static_round_traces = 0 if bad else 1


def default_combos(modes=None, schedules=None, first_layers=None,
                   faults=None, transforms=None, device=None):
    """The registered mode x schedule x first-layer x fault x transform
    grid, as the reference builds it: every federated mode, the shipped
    schedule families, the three built-in first-layer lanes ("auto"
    dedupes to its resolution on ``device``), and for devertifl -- the
    only mode faults and transforms inject into -- a composite fault
    plan and the hot wire transforms, which multiply schedules, not
    first layers; one combo per transform also chains the composite
    fault."""
    from repro_torch.api.modes import MODES, get_mode
    device = torch.device(device or "cpu")
    if modes is None:
        seen = {}
        for name in MODES.names():
            m = get_mode(name)
            if m.kind == "federated" and m.internal not in seen:
                seen[m.internal] = m.internal
        modes = tuple(seen)
    if schedules is None:
        schedules = ("sync", "stale_k:2", "double_buffer",
                     "partial:0.5:det", "stale_k:1+partial:0.5")
    if first_layers is None:
        first_layers = ("masked", "slice", "kernel")
    if faults is None:
        faults = ("none", "crash:0.2:2+straggle:0.5:2+corrupt:0.05")
    if transforms is None:
        transforms = ("none", "int8+dp:0.1", "topk:0.5")
    combos = []
    for mode in modes:
        scheds = schedules if mode == "devertifl" else ("sync",)
        fts = faults if mode == "devertifl" else ("none",)
        wts = transforms if mode == "devertifl" else ("none",)
        fls, seen_fl = [], set()
        for fl in first_layers:
            r = resolve_first_layer(ProtocolConfig(mode=mode, first_layer=fl),
                                    device)
            if r not in seen_fl:
                seen_fl.add(r)
                fls.append(fl)
        combos.extend((mode, sc, fl, "none", "none")
                      for sc in scheds for fl in fls)
        combos.extend((mode, sc, fls[0], ft, "none")
                      for ft in fts if ft != "none" for sc in scheds)
        combos.extend((mode, sc, fls[0], "none", t)
                      for t in wts if t != "none" for sc in scheds)
        combos.extend((mode, scheds[0], fls[0], ft, t)
                      for t in wts if t != "none"
                      for ft in fts if ft != "none")
    return combos


def audit_combos(modes=None, schedules=None, first_layers=None,
                 passes: Optional[Sequence[str]] = None,
                 dataset: str = "mnist", n_clients: int = 3,
                 lane_check: bool = True, faults=None, transforms=None,
                 progress=None, device=None) -> AnalysisReport:
    """Audit every combination of :func:`default_combos` on ``device``;
    the lane comparison runs once for the grid.  ``progress(msg)`` is
    called before each combo and before the lane comparison.  Returns
    one merged report."""
    device = resolve_device(device)
    report = AnalysisReport()
    combos = default_combos(modes, schedules, first_layers, faults,
                            transforms, device)
    for i, (mode, sched, fl, fault, transform) in enumerate(combos):
        pcfg = ProtocolConfig(dataset=dataset, n_clients=n_clients,
                              mode=mode, schedule=sched, first_layer=fl,
                              fault=fault, transform=transform)
        if progress:
            progress(f"[{i + 1}/{len(combos)}] {combo_name(pcfg, device)}")
        report.merge(audit(pcfg, passes=passes, lane_check=False,
                           device=device))
    if lane_check and "retrace" in (passes or ALL_PASSES):
        if progress:
            progress("lane check")
        report.findings.extend(RT.run_lane_check(dataset, device))
        apply_waivers(report.findings)
    if "retrace" in (passes or ALL_PASSES):
        _stamp_traces(report)
    return report
