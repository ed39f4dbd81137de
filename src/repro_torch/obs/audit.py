"""Explainable decisions: the full closed-form decomposition behind each one.

Every ``AdaptiveOffloadManager.decide`` (and therefore every gateway /
replay / cluster decision) can record a :class:`DecisionAudit`: the
per-strategy latency totals the argmin ranked, the per-term decomposition of
each strategy's mean latency (the same terms ``Scenario.analytic()`` reports,
same keys, same summation order), the telemetry snapshot the terms were
computed from, the margin over the best alternative, and the hysteresis
state. The core invariant — checked by :meth:`AuditLog.verify` and gated in
CI — is that the logged terms re-sum to the logged totals to <= 1e-9, so an
audit row can never tell a story the decision didn't follow.

In SLO-quantile mode the decision totals are q-quantiles, which do not
decompose as sums; the audit then carries the *mean* decomposition alongside
(``term_totals``), and the invariant binds terms to ``term_totals`` while
``decision_metric`` says what the totals actually are.

The manager talks to :class:`AuditLog` duck-typed through ``record(**row)``
(core must not import obs), so any object with that method — including a
plain test double — can sit in the audit seat.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Mapping

__all__ = [
    "DEVICE_TERMS",
    "EDGE_TERMS",
    "DecisionAudit",
    "AuditLog",
    "ResumError",
    "audit_cluster",
]

# exactly repro_torch.core.latency.LatencyBreakdown's keys, in its summation order
DEVICE_TERMS = ("w_proc_dev", "s_dev")
EDGE_TERMS = ("w_net_dev", "n_req", "w_proc_edge", "s_edge", "w_net_edge", "n_res")


class ResumError(AssertionError):
    """A logged term decomposition does not re-sum to its logged total."""


def _ordered_sum(terms: Mapping[str, float]) -> float:
    keys = DEVICE_TERMS if "w_proc_dev" in terms else EDGE_TERMS
    total = 0.0
    for k in keys:
        total += terms[k]
    return total


def _enc(v):
    """JSON-safe float encoding (inf/nan as strings, canonically)."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)  # "inf" | "-inf" | "nan"
    return v


def _enc_map(d: Mapping) -> dict:
    return {k: _enc_map(v) if isinstance(v, Mapping) else _enc(v)
            for k, v in d.items()}


def _dec(v):
    return float(v) if v in ("inf", "-inf", "nan") else v


def _dec_map(d: dict) -> dict:
    return {k: _dec_map(v) if isinstance(v, dict) else _dec(v)
            for k, v in d.items()}


@dataclass(frozen=True)
class DecisionAudit:
    """One decision, fully explained."""

    epoch: int
    time_s: float
    source: str  # "manager" | "gateway" | "replay" | "cluster[i]" | ...
    chosen: str  # target_name: "on_device" | "edge[j]"
    edge_index: int  # ON_DEVICE (-1) or edge index
    predicted_latency_s: float
    decision_metric: str  # "mean" | "p99" | ... (what `totals` measures)
    totals: dict[str, float]  # strategy -> the latency the argmin ranked
    terms: dict[str, dict[str, float]]  # strategy -> mean decomposition
    term_totals: dict[str, float]  # strategy -> ordered sum of its terms
    snapshot: dict  # the estimator outputs the terms were computed from
    margin_s: float  # best alternative minus chosen (negative under hysteresis)
    hysteresis: dict = field(default_factory=dict)
    slo_quantile: float | None = None

    def max_resum_error(self) -> float:
        """max |sum(terms) - term_totals| over strategies, plus
        |term_totals - totals| in mean mode (saturated inf == inf is exact)."""
        worst = 0.0

        def gap(a: float, b: float) -> float:
            if math.isinf(a) or math.isinf(b):
                return 0.0 if a == b else math.inf
            return abs(a - b)

        for strat, t in self.terms.items():
            worst = max(worst, gap(_ordered_sum(t), self.term_totals[strat]))
            if self.decision_metric == "mean":
                worst = max(worst, gap(self.term_totals[strat], self.totals[strat]))
        return worst

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "time_s": self.time_s,
            "source": self.source,
            "chosen": self.chosen,
            "edge_index": self.edge_index,
            "predicted_latency_s": _enc(self.predicted_latency_s),
            "decision_metric": self.decision_metric,
            "totals": _enc_map(self.totals),
            "terms": _enc_map(self.terms),
            "term_totals": _enc_map(self.term_totals),
            "snapshot": _enc_map(self.snapshot),
            "margin_s": _enc(self.margin_s),
            "hysteresis": _enc_map(self.hysteresis),
            "slo_quantile": self.slo_quantile,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionAudit":
        return cls(
            epoch=int(d["epoch"]),
            time_s=float(d["time_s"]),
            source=str(d["source"]),
            chosen=str(d["chosen"]),
            edge_index=int(d["edge_index"]),
            predicted_latency_s=float(_dec(d["predicted_latency_s"])),
            decision_metric=str(d["decision_metric"]),
            totals=_dec_map(d["totals"]),
            terms=_dec_map(d["terms"]),
            term_totals=_dec_map(d["term_totals"]),
            snapshot=_dec_map(d.get("snapshot", {})),
            margin_s=float(_dec(d["margin_s"])),
            hysteresis=_dec_map(d.get("hysteresis", {})),
            slo_quantile=d.get("slo_quantile"),
        )


class AuditLog:
    """An append-only sequence of :class:`DecisionAudit` rows."""

    def __init__(self):
        self.rows: list[DecisionAudit] = []

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[DecisionAudit]:
        return iter(self.rows)

    def record(self, **row) -> DecisionAudit:
        a = DecisionAudit(**row)
        self.rows.append(a)
        return a

    def clear(self) -> None:
        self.rows.clear()

    # -- the invariant -------------------------------------------------------
    def max_resum_error(self) -> float:
        return max((a.max_resum_error() for a in self.rows), default=0.0)

    def verify(self, tol: float = 1e-9) -> float:
        """Raise :class:`ResumError` if any row's terms fail to re-sum to its
        totals within ``tol``; returns the worst observed error."""
        worst = 0.0
        for i, a in enumerate(self.rows):
            err = a.max_resum_error()
            if err > tol:
                raise ResumError(
                    f"audit row {i} (source={a.source!r} epoch={a.epoch}): "
                    f"terms re-sum error {err:.3e} > {tol:.0e}")
            worst = max(worst, err)
        return worst

    # -- flips (the report CLI's headline) -----------------------------------
    def flips(self) -> list[tuple[DecisionAudit, DecisionAudit]]:
        """(before, after) pairs where consecutive same-source rows changed
        target — the decisions worth explaining."""
        by_source: dict[str, DecisionAudit] = {}
        out = []
        for a in self.rows:
            prev = by_source.get(a.source)
            if prev is not None and prev.edge_index != a.edge_index:
                out.append((prev, a))
            by_source[a.source] = a
        return out

    # -- serialization -------------------------------------------------------
    def to_jsonl(self) -> str:
        return "".join(
            json.dumps(a.to_dict(), sort_keys=True, separators=(",", ":")) + "\n"
            for a in self.rows
        )

    def write_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(self.to_jsonl())
        return path

    @classmethod
    def from_jsonl(cls, text: str) -> "AuditLog":
        log = cls()
        log.rows = [DecisionAudit.from_dict(json.loads(line))
                    for line in text.splitlines() if line.strip()]
        return log

    @classmethod
    def read_jsonl(cls, path: str | Path) -> "AuditLog":
        return cls.from_jsonl(Path(path).read_text())


def audit_cluster(result, *, epochs=None, clients=None, device=None) -> AuditLog:
    """Reconstruct per-client decision audits from a closed-loop cluster run.

    Re-evaluates the vectorized Algorithm-1 terms from the *estimates the scan
    actually acted on* (``ClusterResult.est_*``), so the audited totals are
    the very numbers ``predict_decisions`` returns on those estimates, and the
    chosen targets are the scan's own. N*T rows get large fast — ``epochs`` /
    ``clients`` subset (sequences of indices) before reconstructing.

    The terms are evaluated on ``device`` (default: the card), one
    ``predict_terms`` call per audited epoch.
    """
    import numpy as np

    from repro_torch.fleet.cluster import predict_terms

    choices = result.policies["adaptive"].choices
    t_n, n = choices.shape
    epochs = range(t_n) if epochs is None else epochs
    clients = range(n) if clients is None else clients
    clients = list(clients)
    dt = float(result.traces.epoch_s)
    log = AuditLog()
    for t in epochs:
        terms = predict_terms(
            result.spec,
            result.est_arrival_rate[t],
            result.est_bandwidth_Bps[t],
            result.est_endo_rate[t],
            result.est_exo_rate[t],
            device=device,
        )
        for i in clients:
            strat_terms = {"on_device": {
                "w_proc_dev": float(terms["w_proc_dev"][i]),
                "s_dev": float(terms["s_dev"][i]),
            }}
            totals = {"on_device": float(terms["t_dev"][i])}
            for j in range(result.spec.n_edges):
                strat_terms[f"edge[{j}]"] = {
                    k: float(terms[k][i, j]) for k in EDGE_TERMS}
                totals[f"edge[{j}]"] = float(terms["t_edge"][i, j])
            choice = int(choices[t, i])
            chosen = "on_device" if choice < 0 else f"edge[{choice}]"
            predicted = totals[chosen]
            alts = [v for k, v in totals.items() if k != chosen]
            margin = (min(alts) - predicted) if alts else math.inf
            log.record(
                epoch=t,
                time_s=t * dt,
                source=f"cluster[{i}]",
                chosen=chosen,
                edge_index=choice,
                predicted_latency_s=predicted,
                decision_metric="mean",
                totals=totals,
                terms=strat_terms,
                term_totals={s: _ordered_sum(v) for s, v in strat_terms.items()},
                snapshot={
                    "lam_dev": float(result.est_arrival_rate[t, i]),
                    "bandwidth_Bps": float(result.est_bandwidth_Bps[t, i]),
                    "endo_rate": [float(x) for x in
                                  np.asarray(result.est_endo_rate[t, i])],
                    "exo_rate": [float(x) for x in
                                 np.asarray(result.est_exo_rate[t])],
                },
                margin_s=margin,
            )
    return log
