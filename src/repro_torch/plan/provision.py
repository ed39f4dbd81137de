"""SLO-constrained fleet provisioning: the paper's question run backwards, on
the card.

The forward question (``repro_torch.core`` / ``repro_torch.fleet``) is *given* a fleet —
N clients, E edge servers of some accelerator tier, a shared uplink — what
latency does each client see at the decision equilibrium?  The provisioning
question inverts it: given N clients and a p99 budget, what is the **minimum**
deployment that meets it?  Three resources trade off:

  * ``n_edges``   — how many replicas of the edge template to stand up;
  * ``tier``      — which accelerator tier each replica runs (§2's ladder of
    accelerators: the whole point of the paper is that this axis moved);
  * ``bandwidth`` — how fat the shared client uplink is.

Feasibility of one candidate ``(E, tier, bandwidth)`` is *not* a closed form:
it is the fixed point of the decision -> load -> decision map
(:func:`repro_torch.fleet.solve_equilibrium` with ``slo_quantile`` set, so
clients best-respond on exact p99s computed by the batched Euler inversion of
the Pollaczek–Khinchine transform, each synchronous step one decision-scan
launch), judged by :meth:`Equilibrium.meets_slo` — converged, and the
*worst* client's q-quantile within budget.

The search exploits monotonicity instead of brute force.  Along each axis,
adding resource can only help: an extra identical edge adds capacity clients
may ignore, a faster tier stochastically dominates a slower one per-request,
and more shared bandwidth shrinks every NIC stage.  (Equilibria of this
congestion game descend a potential, so the Braess-style pathologies of
selfish *routing* with heterogeneous links don't arise for identical
replicas; the reference's tests cross-check the solver against exhaustive
grid search anyway.)  Monotone axes mean each minimisation is a
``smallest_true`` bracketed bisection — O(log) equilibrium solves per axis,
the helper the tenancy crossovers use.

The minimisation is **lexicographic**: fewest edges first (at the best tier
and fattest pipe), then the slowest tier that still works at that edge
count (at the fattest pipe), then the thinnest pipe that still works.  The
result is component-wise irreducible — decrementing *any* single resource of
the returned plan violates the SLO:

  * ``E-1`` fails at the *best* tier/bandwidth, hence also at the chosen ones;
  * ``tier-1`` fails at the fattest pipe, hence also at the chosen one;
  * ``bandwidth-1`` fails at the chosen ``(E, tier)`` by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np

from repro_torch.core.crossover import smallest_true
from repro_torch.core.latency import NetworkPath, ServiceModel, Tier
from repro_torch.core.scenario import ClusterSpec, Scenario, ScenarioError
from repro_torch.core.tail import resolve_tail_method
from repro_torch.fleet.cluster import Equilibrium, solve_equilibrium

__all__ = ["ProvisionPlan", "ProvisionSpace", "provision"]


def _tier_to_dict(t: Tier) -> dict:
    return {
        "name": t.name,
        "service_time_s": t.service_time_s,
        "parallelism_k": t.parallelism_k,
        "service_model": t.service_model.value,
        "service_var": t.service_var,
    }


def _tier_from_dict(d: Mapping, path: str) -> Tier:
    try:
        model = ServiceModel(d.get("service_model", "md1"))
    except ValueError:
        raise ScenarioError(f"{path}.service_model",
                            f"unknown service model {d.get('service_model')!r}") from None
    try:
        return Tier(
            name=d.get("name", "tier"),
            service_time_s=d["service_time_s"],
            parallelism_k=d.get("parallelism_k", 1.0),
            service_model=model,
            service_var=d.get("service_var", 0.0),
        )
    except (KeyError, TypeError):
        raise ScenarioError(f"{path}.service_time_s", "missing required field") from None


@dataclass(frozen=True)
class ProvisionSpace:
    """The candidate deployments the solver searches over.

    ``base`` is a single-edge template scenario: its workload/device describe
    one client, ``edges[0]`` is the edge replica template (background tenants
    and all) whose *tier* the ladder overrides, and its network path is
    replaced by each candidate bandwidth.  ``tiers`` must be ordered
    cheapest-first, i.e. slowest to fastest (strictly decreasing effective
    service time ``s/k``), and ``bandwidths_Bps`` ascending — both orderings
    are what makes per-axis feasibility monotone and the bisection valid.
    """

    base: Scenario
    tiers: tuple[Tier, ...]
    max_edges: int
    bandwidths_Bps: tuple[float, ...]
    name: str = "provision-space"

    def __post_init__(self):
        if not isinstance(self.tiers, tuple):
            object.__setattr__(self, "tiers", tuple(self.tiers))
        if not isinstance(self.bandwidths_Bps, tuple):
            object.__setattr__(self, "bandwidths_Bps",
                               tuple(float(b) for b in self.bandwidths_Bps))
        if not isinstance(self.base, Scenario):
            raise ScenarioError("base",
                                f"expected a Scenario, got {type(self.base).__name__}")
        if len(self.base.edges) != 1:
            raise ScenarioError(
                "base.edges",
                f"template must have exactly one edge (the replica template), "
                f"got {len(self.base.edges)}")
        if not self.tiers:
            raise ScenarioError("tiers", "need at least one accelerator tier")
        eff = [t.service_time_s / t.parallelism_k for t in self.tiers]
        for i in range(1, len(eff)):
            if not eff[i] < eff[i - 1]:
                raise ScenarioError(
                    f"tiers[{i}]",
                    f"tiers must be ordered slowest to fastest: effective "
                    f"service time s/k {eff[i]:.4g} !< {eff[i - 1]:.4g}")
        if self.max_edges < 1:
            raise ScenarioError("max_edges",
                                f"must be at least 1, got {self.max_edges}")
        if not self.bandwidths_Bps:
            raise ScenarioError("bandwidths_Bps", "need at least one bandwidth")
        for i, b in enumerate(self.bandwidths_Bps):
            if not b > 0:
                raise ScenarioError(f"bandwidths_Bps[{i}]",
                                    f"must be positive, got {b!r}")
            if i and not b > self.bandwidths_Bps[i - 1]:
                raise ScenarioError(
                    f"bandwidths_Bps[{i}]",
                    f"bandwidths must be strictly ascending: {b!r} !> "
                    f"{self.bandwidths_Bps[i - 1]!r}")

    def cluster_spec(self, n_edges: int, tier_index: int, bandwidth_index: int,
                     n_clients: int) -> ClusterSpec:
        """The candidate deployment as a solvable :class:`ClusterSpec`.

        Candidates routinely sit past a stability boundary — that is exactly
        what makes them infeasible — so the instantiated scenario carries
        ``allow_unstable=True`` and lets the closed forms report ``inf``.
        """
        template = self.base.edges[0]
        edge = replace(template, tier=self.tiers[tier_index])
        scn = replace(
            self.base,
            edges=(edge,) * n_edges,
            network=NetworkPath(self.bandwidths_Bps[bandwidth_index]),
            allow_unstable=True,
        )
        return ClusterSpec(base=scn, n_clients=n_clients,
                           name=f"{self.name}-{n_clients}x{n_edges}")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "tiers": [_tier_to_dict(t) for t in self.tiers],
            "max_edges": self.max_edges,
            "bandwidths_Bps": list(self.bandwidths_Bps),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ProvisionSpace":
        try:
            base_d, tiers_d = d["base"], d["tiers"]
            max_edges, bws = d["max_edges"], d["bandwidths_Bps"]
        except (KeyError, TypeError):
            raise ScenarioError(
                "provision_space",
                "missing required field (need base, tiers, max_edges, "
                "bandwidths_Bps)") from None
        return cls(
            base=Scenario.from_dict(base_d),
            tiers=tuple(_tier_from_dict(td, f"tiers[{i}]")
                        for i, td in enumerate(tiers_d)),
            max_edges=int(max_edges),
            bandwidths_Bps=tuple(float(b) for b in bws),
            name=d.get("name", "provision-space"),
        )


@dataclass(frozen=True)
class ProvisionPlan:
    """The minimal deployment found, plus the equilibrium it was judged at.

    ``tier_index`` / ``bandwidth_index`` index into the space's ladders so
    the minimality claim ("decrement any of these and the SLO breaks") is
    checkable without re-deriving positions from values.  ``evaluations``
    counts distinct equilibrium solves the search spent — the number grid
    search would have multiplied, not added.
    """

    n_clients: int
    slo_s: float
    q: float
    tail_method: str
    n_edges: int
    tier_index: int
    tier: Tier
    bandwidth_index: int
    bandwidth_Bps: float
    max_latency_s: float  # worst-client q-quantile at the chosen equilibrium
    mean_latency_s: float
    counts: dict[str, int]  # clients per target, Equilibrium.counts() style
    rho_edges: tuple[float, ...]
    iterations: int
    evaluations: int

    @property
    def slack_s(self) -> float:
        """Budget left at the worst client; >= 0 for any returned plan."""
        return self.slo_s - self.max_latency_s

    def to_dict(self) -> dict:
        return {
            "n_clients": self.n_clients,
            "slo_s": self.slo_s,
            "q": self.q,
            "tail_method": self.tail_method,
            "n_edges": self.n_edges,
            "tier_index": self.tier_index,
            "tier": _tier_to_dict(self.tier),
            "bandwidth_index": self.bandwidth_index,
            "bandwidth_Bps": self.bandwidth_Bps,
            "max_latency_s": self.max_latency_s,
            "mean_latency_s": self.mean_latency_s,
            "counts": dict(self.counts),
            "rho_edges": list(self.rho_edges),
            "iterations": self.iterations,
            "evaluations": self.evaluations,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ProvisionPlan":
        try:
            return cls(
                n_clients=int(d["n_clients"]),
                slo_s=float(d["slo_s"]),
                q=float(d["q"]),
                tail_method=str(d["tail_method"]),
                n_edges=int(d["n_edges"]),
                tier_index=int(d["tier_index"]),
                tier=_tier_from_dict(d["tier"], "tier"),
                bandwidth_index=int(d["bandwidth_index"]),
                bandwidth_Bps=float(d["bandwidth_Bps"]),
                max_latency_s=float(d["max_latency_s"]),
                mean_latency_s=float(d["mean_latency_s"]),
                counts={str(k): int(v) for k, v in d["counts"].items()},
                rho_edges=tuple(float(r) for r in d["rho_edges"]),
                iterations=int(d["iterations"]),
                evaluations=int(d["evaluations"]),
            )
        except (KeyError, TypeError):
            raise ScenarioError("provision_plan", "missing required field") from None


def provision(
    space: ProvisionSpace,
    n_clients: int,
    slo_s: float,
    *,
    q: float = 0.99,
    tail_method: str = "euler",
    max_iter: int = 20,
    device=None,
) -> ProvisionPlan | None:
    """Smallest ``(n_edges, tier, bandwidth)`` in ``space`` whose equilibrium
    keeps every client's q-quantile within ``slo_s`` — or ``None`` when even
    the maximal deployment misses the budget. The equilibria are solved on
    ``device`` (default: the card).

    Lexicographic: minimises edge count first, then tier (slowest feasible),
    then bandwidth (thinnest feasible); see the module docstring for why the
    result is component-wise irreducible.  Each feasibility probe is one
    :func:`solve_equilibrium` with ``slo_quantile=q``; probes are memoised so
    the reported ``evaluations`` counts distinct candidate deployments.
    """
    if n_clients < 1:
        raise ScenarioError("n_clients", f"must be at least 1, got {n_clients}")
    if not slo_s > 0:
        raise ScenarioError("slo_s", f"must be positive, got {slo_s!r}")
    if not 0.0 < q < 1.0:
        raise ScenarioError("q", f"quantile must be in (0, 1), got {q!r}")
    tail_method = resolve_tail_method(q, tail_method)

    cache: dict[tuple[int, int, int], Equilibrium] = {}

    def equilibrium(n_edges: int, ti: int, bi: int) -> Equilibrium:
        key = (n_edges, ti, bi)
        if key not in cache:
            spec = space.cluster_spec(n_edges, ti, bi, n_clients)
            cache[key] = solve_equilibrium(spec, max_iter=max_iter, slo_quantile=q,
                                           tail_method=tail_method, device=device)
        return cache[key]

    def feasible(n_edges: int, ti: int, bi: int) -> bool:
        return equilibrium(n_edges, ti, bi).meets_slo(slo_s)

    best_t = len(space.tiers) - 1
    best_b = len(space.bandwidths_Bps) - 1

    n_edges = smallest_true(lambda k: feasible(k, best_t, best_b), space.max_edges)
    if n_edges is None:
        return None
    # Both remaining axes are guaranteed feasible at their top index, so
    # smallest_true cannot return None here.
    ti = smallest_true(lambda k: feasible(n_edges, k - 1, best_b),
                       len(space.tiers)) - 1
    bi = smallest_true(lambda k: feasible(n_edges, ti, k - 1),
                       len(space.bandwidths_Bps)) - 1

    eq = equilibrium(n_edges, ti, bi)
    return ProvisionPlan(
        n_clients=n_clients,
        slo_s=float(slo_s),
        q=float(q),
        tail_method=tail_method,
        n_edges=n_edges,
        tier_index=ti,
        tier=space.tiers[ti],
        bandwidth_index=bi,
        bandwidth_Bps=float(space.bandwidths_Bps[bi]),
        max_latency_s=eq.max_latency_s,
        mean_latency_s=eq.mean_latency_s,
        counts=eq.counts(),
        rho_edges=tuple(float(r) for r in np.asarray(eq.rho_edges)),
        iterations=eq.iterations,
        evaluations=len(cache),
    )
