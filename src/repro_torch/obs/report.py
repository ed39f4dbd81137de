"""Render traces + decision audits into human-readable reports.

Two consumers:

  * ``repro_torch.launch.obs_report`` — the CLI that turns a trace JSONL +
    audit JSONL into a markdown/terminal report;
  * ``repro_torch.launch.serve`` — its per-epoch gateway lines come from
    :func:`format_decision` over the SAME audit rows a trace would contain,
    so printed output and recorded observability can never disagree.

The text is the reference's (``repro.obs.report``), character for character.
"""

from __future__ import annotations

from .audit import AuditLog, DecisionAudit
from .metrics import Histogram, MetricsRegistry
from .tracer import Tracer

__all__ = ["format_decision", "explain_flip", "render_report"]


def _ms(v: float) -> str:
    if v != v:
        return "nan"
    if v == float("inf"):
        return "inf"
    return f"{v * 1e3:.1f} ms"


def format_decision(a: DecisionAudit) -> str:
    """The canonical one-line view of a decision — derived from the audit row,
    not from ad-hoc locals at the call site."""
    bw = a.snapshot.get("bandwidth_Bps")
    bw_s = f"{bw * 8 / 1e6:5.1f} Mbps" if isinstance(bw, (int, float)) else "  n/a    "
    dev = a.totals.get("on_device", float("nan"))
    return (f"[{a.source}] epoch {a.epoch:3d} t={a.time_s:7.1f}s  {bw_s} -> "
            f"{a.chosen:10s} (pred {_ms(a.predicted_latency_s):>9s}; "
            f"device {_ms(dev):>9s}; margin {_ms(a.margin_s):>9s})")


def explain_flip(before: DecisionAudit, after: DecisionAudit) -> str:
    """Term-by-term account of why a decision flipped between two epochs.

    Shows, for the old and new targets, how each closed-form term moved
    between the two audit rows — the 'show your work' view of e.g. a
    bandwidth step pushing w_net_dev past the on-device service time.
    """
    lines = [
        f"flip @ epoch {after.epoch} (t={after.time_s:g}s): "
        f"{before.chosen} -> {after.chosen}  [{after.source}]",
        f"  snapshot: {_fmt_snapshot(before)}  ->  {_fmt_snapshot(after)}",
    ]
    for target in (before.chosen, after.chosen):
        tb, ta = before.terms.get(target), after.terms.get(target)
        if tb is None or ta is None:
            continue
        lines.append(f"  {target}: total {_ms(before.term_totals[target])} -> "
                     f"{_ms(after.term_totals[target])}")
        for k in ta:
            db, da = tb.get(k, 0.0), ta[k]
            marker = "  <-- moved" if abs(da - db) > 0.05 * max(
                abs(da), abs(db), 1e-12) else ""
            lines.append(f"      {k:12s} {_ms(db):>10s} -> {_ms(da):>10s}{marker}")
    if after.hysteresis.get("engaged"):
        lines.append("  (hysteresis engaged: raw argmin differed)")
    return "\n".join(lines)


def _fmt_snapshot(a: DecisionAudit) -> str:
    bits = []
    bw = a.snapshot.get("bandwidth_Bps")
    if isinstance(bw, (int, float)):
        bits.append(f"B={bw * 8 / 1e6:.1f}Mbps")
    lam = a.snapshot.get("lam_dev")
    if isinstance(lam, (int, float)):
        bits.append(f"lam={lam:.2f}/s")
    return " ".join(bits) or "(none)"


def _span_table(tracer: Tracer) -> list[str]:
    cats: dict[str, Histogram] = {}
    for s in tracer.spans:
        cats.setdefault(s.cat, Histogram()).record(s.dur)
    lines = ["| category | spans | total | p50 | p99 |",
             "|---|---:|---:|---:|---:|"]
    for cat in sorted(cats):
        h = cats[cat]
        lines.append(f"| {cat} | {h.count} | {_ms(h.sum)} | {_ms(h.p50)} | "
                     f"{_ms(h.p99)} |")
    return lines


def render_report(
    *,
    tracer: Tracer | None = None,
    audit: AuditLog | None = None,
    metrics: MetricsRegistry | None = None,
    title: str = "Observability report",
) -> str:
    """Markdown report over whatever observability streams exist."""
    out: list[str] = [f"# {title}", ""]
    if tracer is not None and tracer.spans:
        t0 = min(s.t for s in tracer.spans)
        t1 = max(s.t + s.dur for s in tracer.spans)
        out += [f"## Trace — {len(tracer.spans)} spans over "
                f"{t1 - t0:.3f} s on {len(tracer.tracks())} tracks", ""]
        out += _span_table(tracer)
        out.append("")
    if audit is not None and len(audit):
        err = audit.max_resum_error()
        out += [f"## Decisions — {len(audit)} audited "
                f"(max term re-sum error {err:.2e})", ""]
        out += ["```"] + [format_decision(a) for a in audit.rows] + ["```", ""]
        flips = audit.flips()
        if flips:
            out += [f"### {len(flips)} strategy flip(s), explained", ""]
            for before, after in flips:
                out += ["```", explain_flip(before, after), "```", ""]
    if metrics is not None:
        rendered = metrics.render()
        if rendered:
            out += ["## Metrics", "", "```", rendered, "```", ""]
    return "\n".join(out)
