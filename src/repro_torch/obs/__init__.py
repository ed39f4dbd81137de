"""repro_torch.obs — observability: tracing, decision audits, metrics, provenance.

  * :mod:`repro_torch.obs.tracer` — deterministic span tracer (JSONL + Perfetto)
  * :mod:`repro_torch.obs.audit` — explainable decision audits with the term
    re-sum invariant
  * :mod:`repro_torch.obs.metrics` — counters / gauges / streaming histograms
  * :mod:`repro_torch.obs.manifest` — timestamp-free run provenance manifests
  * :mod:`repro_torch.obs.report` — markdown/terminal rendering of all of the above

Host code: nothing here launches a kernel or touches a device, except
``audit_cluster``, which re-evaluates the cluster's terms on the device it is
given.
"""

from .audit import AuditLog, DecisionAudit, ResumError, audit_cluster
from .manifest import manifest_delta, run_manifest
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .report import explain_flip, format_decision, render_report
from .tracer import Span, Tracer, merge

__all__ = [
    "AuditLog",
    "DecisionAudit",
    "ResumError",
    "audit_cluster",
    "run_manifest",
    "manifest_delta",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "merge",
    "format_decision",
    "explain_flip",
    "render_report",
]
