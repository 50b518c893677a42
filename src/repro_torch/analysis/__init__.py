"""repro_torch.analysis -- the static auditor of the port's round: the
port of ``repro.analysis``.

Traces one round of a federation into an aten graph
(``ir.trace_round``: ``make_fx`` in real mode, then functionalized) and
proves three contracts over it:

  taint      privacy flow: client i's raw features reach client j != i
             only through the declared channels (the hidden-output
             exchange and the FedAvg mean), marked in the graph by
             :mod:`repro_torch.analysis.barrier` tags
  deadness   dead padded ``client_mask`` slots contribute zeros to every
             tagged exchange / FedAvg / loss term
  retrace    the round's carried outputs keep their inputs' shapes,
             dtypes and devices, and the sweep's lane batch traces to
             one round body across client counts x schedules x faults x
             seeds

Entry points:

  audit(spec) -> AnalysisReport          one ExperimentSpec
  audit_combos(...) -> AnalysisReport    the registered mode x schedule
                                         x first-layer x fault x
                                         transform grid
  python -m repro_torch.analysis         the CLI; JSON report; exit 1 on
                                         any unwaived violation

Both run on CUDA unless the caller names another device
(``device="cpu"``, ``--device cpu``).  Violations can be waived, with a
reason in code, via :func:`repro_torch.analysis.report.register_waiver`;
none is shipped.

This module stays import-light: the round imports
:func:`repro_torch.analysis.barrier.tag`, so the passes load only when
an audit runs.
"""
from repro_torch.analysis.barrier import (  # noqa: F401
    audit_tracing, auditing, tag)
from repro_torch.analysis.report import (AnalysisReport, Finding,  # noqa: F401
                                         register_waiver)


def audit(spec, passes=None, **kw):
    """Audit one ExperimentSpec (or ProtocolConfig); see
    :func:`repro_torch.analysis.audit.audit`."""
    from repro_torch.analysis.audit import audit as _audit
    return _audit(spec, passes=passes, **kw)


def audit_combos(**kw):
    """Audit the registered grid; see
    :func:`repro_torch.analysis.audit.audit_combos`."""
    from repro_torch.analysis.audit import audit_combos as _ac
    return _ac(**kw)
