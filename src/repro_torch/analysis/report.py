"""Findings, waivers, and the AnalysisReport the auditor returns: a
copy of ``repro.analysis.report`` (pure Python; the port imports
nothing of the JAX package).

A *finding* is one violation (or warning) from one pass over one
audited combination.  A *waiver* is a pinned, justified exception:
``register_waiver("taint", "cross-client-flow", "devertifl/sync/*",
reason=...)`` marks matching findings as waived so the CI lane stays
green while the justification stays in code review's face.  Waivers
never delete findings -- a waived finding still appears in the JSON
report with its reason attached (docs/ARCHITECTURE.md section 8).

The report is plain data (dataclasses -> dicts) so the CLI can dump it
as JSON and the bench harness can stamp ``static_round_traces`` into
append-only bench entries.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from fnmatch import fnmatch
from typing import List, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    """One violation (or warning) from one pass over one audited combination.

    ``chain`` is the offending equation chain (taint violations walk
    the dataflow from the leaking output back to the tainted source;
    other passes attach whatever locates the problem)."""
    pass_name: str                   # taint | deadness | retrace
    code: str                        # stable machine-readable kind
    combo: str                       # e.g. "devertifl/stale_k:2/slice"
    message: str
    chain: Tuple[str, ...] = ()
    severity: str = "error"
    waived: str = ""                 # non-empty = waiver reason

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")
        self.chain = tuple(self.chain)


@dataclass
class Waiver:
    pass_name: str                   # exact pass, or "*"
    code: str                        # exact code, or "*"
    combo: str                       # fnmatch glob over combo strings
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.pass_name in ("*", f.pass_name)
                and self.code in ("*", f.code)
                and fnmatch(f.combo, self.combo))


# shipped waivers -- currently empty: every registered mode x schedule
# x first-layer combination audits clean (the acceptance bar for new
# engine code is to KEEP it that way, or pin a justified entry here).
WAIVERS: List[Waiver] = []


def register_waiver(pass_name: str, code: str, combo: str,
                    reason: str) -> Waiver:
    """Pin a justified exception.  ``reason`` is mandatory and lands in
    the JSON report next to every finding it waives."""
    if not reason or not reason.strip():
        raise ValueError("a waiver needs a non-empty justification")
    w = Waiver(pass_name, code, combo, reason.strip())
    WAIVERS.append(w)
    return w


def apply_waivers(findings: List[Finding]) -> List[Finding]:
    for f in findings:
        for w in WAIVERS:
            if w.matches(f):
                f.waived = w.reason
                break
    return findings


@dataclass
class AnalysisReport:
    """Everything the auditor proved (or failed to) in one run."""
    combos: Tuple[str, ...] = ()          # combinations audited
    findings: List[Finding] = field(default_factory=list)
    channels: dict = field(default_factory=dict)   # channel -> tag count
    static_round_traces: int = 0          # 1 iff retrace pass proved it
    passes_run: Tuple[str, ...] = ()

    @property
    def violations(self) -> List[Finding]:
        """Unwaived error-severity findings (what fails CI)."""
        return [f for f in self.findings
                if f.severity == "error" and not f.waived]

    @property
    def ok(self) -> bool:
        return not self.violations

    def merge(self, other: "AnalysisReport") -> "AnalysisReport":
        self.combos = tuple(dict.fromkeys(self.combos + other.combos))
        self.findings.extend(other.findings)
        for k, v in other.channels.items():
            self.channels[k] = self.channels.get(k, 0) + v
        self.passes_run = tuple(dict.fromkeys(self.passes_run
                                              + other.passes_run))
        if other.static_round_traces:
            self.static_round_traces = max(self.static_round_traces,
                                           other.static_round_traces)
        return self

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "combos": list(self.combos),
            "passes_run": list(self.passes_run),
            "channels": dict(self.channels),
            "static_round_traces": self.static_round_traces,
            "n_findings": len(self.findings),
            "n_violations": len(self.violations),
            "findings": [asdict(f) for f in self.findings],
        }

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        lines = [f"audited {len(self.combos)} combination(s); "
                 f"passes: {', '.join(self.passes_run) or '<none>'}; "
                 f"channels: "
                 + (", ".join(f"{k} x{v}" for k, v in
                              sorted(self.channels.items())) or "<none>")
                 + f"; static_round_traces={self.static_round_traces}"]
        for f in self.findings:
            mark = "WAIVED " if f.waived else ""
            lines.append(f"  [{f.severity}] {mark}{f.pass_name}/"
                         f"{f.code} {f.combo}: {f.message}")
            for c in f.chain:
                lines.append(f"      {c}")
        lines.append("OK" if self.ok
                     else f"{len(self.violations)} violation(s)")
        return "\n".join(lines)
