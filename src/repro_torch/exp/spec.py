"""Declared experiments of the port: the frozen ``ExperimentSpec`` and the
one registry (the twin of the reference's ``exp/spec.py``).

An :class:`ExperimentSpec` turns each artifact-producing entry point into a
*declared* experiment: what runs (a dotted payload reference), with which
seeds and config, which files it must produce (the output contract), which
gate budgets apply, and which JSON fields are wall-clock volatile (excluded
from the byte-stability contract: timings can never be byte-stable;
everything else must be).

:func:`registry` is the single enumeration of every experiment the port
knows how to run: the reference's 15, in its order, with its kinds, seeds,
configs, gates, outputs and volatile paths. Only the payloads differ: each
names a callable of ``repro_torch`` (``repro_torch.bench.*`` for the bench
families, ``repro_torch.exp.payloads`` for the rest). ``repro_torch.bench.run``
derives its family list from it and ``repro_torch.launch.reproduce`` replays
all of it, so a family added here is benchable, reproducible and
regression-gated at once.

Payloads are dotted ``"module.sub:callable"`` strings resolved lazily by
:mod:`repro_torch.exp.runner`, which refuses any module outside
``repro_torch``; this module imports nothing heavy.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields
from typing import Mapping

__all__ = [
    "KINDS",
    "ExperimentError",
    "ExperimentSpec",
    "registry",
    "bench_family_specs",
]

#: the experiment taxonomy: how the artifact relates to the paper's evidence
KINDS = (
    "bench-family",      # one bench.run family -> BENCH_<family>.json
    "validate-regime",   # a differential-gate regime -> VALIDATION.json
    "figure",            # the paper-figure suite -> BENCH_paper_figures.json
    "measured-profile",  # hardware-in-the-loop profile + measured gate
    "cluster-sim",       # closed-loop cluster replay -> CLUSTER.json
)

_ID_RE = re.compile(r"^[a-z0-9][a-z0-9_-]*$")
_PAYLOAD_RE = re.compile(r"^[A-Za-z_][\w.]*:[A-Za-z_]\w*$")


class ExperimentError(ValueError):
    """Invalid experiment spec or a spec/run contract violation."""


@dataclass(frozen=True)
class ExperimentSpec:
    """One declared, reproducible experiment.

    ``volatile`` maps a declared output file to dotted key paths whose
    values are wall-clock dependent (timings, throughputs). The runner's
    stability diff masks exactly those paths; every other byte of the
    artifact must be identical across same-seed reruns.
    """

    exp_id: str
    kind: str
    payload: str
    description: str = ""
    seeds: tuple[int, ...] = (0,)
    #: True when the payload consumes the runner's seed (``reproduce
    #: --seeds N`` only widens the seed list of seed-sensitive experiments;
    #: bench families pin their own internal seeds and run once)
    seed_sensitive: bool = False
    config: Mapping[str, object] = field(default_factory=dict)
    gates: Mapping[str, float] = field(default_factory=dict)
    outputs: tuple[str, ...] = ()
    volatile: Mapping[str, tuple[str, ...]] = field(default_factory=dict)

    def __post_init__(self):
        if not _ID_RE.match(self.exp_id):
            raise ExperimentError(
                f"exp_id {self.exp_id!r} must match {_ID_RE.pattern}")
        if self.kind not in KINDS:
            raise ExperimentError(
                f"{self.exp_id}: kind {self.kind!r} not one of {KINDS}")
        if not _PAYLOAD_RE.match(self.payload):
            raise ExperimentError(
                f"{self.exp_id}: payload {self.payload!r} must be "
                "'module.path:callable'")
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        if not self.seeds:
            raise ExperimentError(f"{self.exp_id}: seeds must be non-empty")
        if len(set(self.seeds)) != len(self.seeds):
            raise ExperimentError(f"{self.exp_id}: duplicate seeds {self.seeds}")
        if any(s < 0 for s in self.seeds):
            raise ExperimentError(f"{self.exp_id}: seeds must be >= 0")
        object.__setattr__(self, "config", dict(self.config))
        object.__setattr__(self, "gates",
                           {k: float(v) for k, v in dict(self.gates).items()})
        object.__setattr__(self, "outputs", tuple(self.outputs))
        if len(set(self.outputs)) != len(self.outputs):
            raise ExperimentError(f"{self.exp_id}: duplicate outputs")
        vol = {k: tuple(v) for k, v in dict(self.volatile).items()}
        object.__setattr__(self, "volatile", vol)
        unknown = [a for a in vol if a not in self.outputs]
        if unknown:
            raise ExperimentError(
                f"{self.exp_id}: volatile declares undeclared output(s) "
                f"{unknown} (outputs: {list(self.outputs)})")

    def to_dict(self) -> dict:
        return {
            "exp_id": self.exp_id,
            "kind": self.kind,
            "payload": self.payload,
            "description": self.description,
            "seeds": list(self.seeds),
            "seed_sensitive": self.seed_sensitive,
            "config": dict(self.config),
            "gates": dict(self.gates),
            "outputs": list(self.outputs),
            "volatile": {k: list(v) for k, v in self.volatile.items()},
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ExperimentError(f"unknown ExperimentSpec field(s) {unknown}")
        kw = dict(d)
        for tup_key in ("seeds", "outputs"):
            if tup_key in kw:
                kw[tup_key] = tuple(kw[tup_key])
        if "volatile" in kw:
            kw["volatile"] = {k: tuple(v) for k, v in kw["volatile"].items()}
        return cls(**kw)


def _bench(family: str, payload: str, *, kind: str = "bench-family",
           volatile: tuple[str, ...] = (), description: str = "") -> ExperimentSpec:
    artifact = f"BENCH_{family}.json"
    return ExperimentSpec(
        exp_id=f"bench-{family}" if kind == "bench-family" else "paper-figures",
        kind=kind,
        payload=payload,
        description=description or f"bench.run family '{family}'",
        config={"family": family},
        outputs=(artifact,),
        volatile={artifact: volatile} if volatile else {},
    )


def registry() -> dict[str, ExperimentSpec]:
    """Every experiment the repo knows how to run, keyed by ``exp_id``.

    The order is the execution order of ``reproduce --all``: cheap model
    gates first, then the bench families, then the hardware-in-the-loop and
    closed-loop runs.
    """
    specs = [
        # -- validate regimes (differential fidelity gate) --------------------
        ExperimentSpec(
            exp_id="validate-smoke",
            kind="validate-regime",
            payload="repro_torch.exp.payloads:validate_payload",
            description="tier-1 smoke slice of the differential fidelity "
                        "gate (golden-corpus subset, short simulations)",
            seeds=(0,),
            seed_sensitive=True,
            config={"smoke": True},
            gates={"mape_budget_pct": 5.0, "tail_budget_pct": 10.0},
            outputs=("VALIDATION.json",),
            volatile={"VALIDATION.json": ("corpus.elapsed_s",)},
        ),
        ExperimentSpec(
            exp_id="validate-full",
            kind="validate-regime",
            payload="repro_torch.exp.payloads:validate_payload",
            description="full tier-2 differential gate over the whole "
                        "golden corpus (the paper's 2.2%-MAPE analogue)",
            seeds=(0,),
            seed_sensitive=True,
            config={"smoke": False},
            gates={"mape_budget_pct": 5.0, "tail_budget_pct": 10.0},
            outputs=("VALIDATION.json",),
            volatile={"VALIDATION.json": ("corpus.elapsed_s",)},
        ),
        # -- the paper-figure suite -------------------------------------------
        _bench("paper_figures", "repro_torch.bench.run:run_paper_figures",
               kind="figure",
               description="every paper figure's headline numbers "
                           "(Fig. 2-7 MAPEs, crossovers, adaptation rows)"),
        # -- bench families ---------------------------------------------------
        _bench("fleet", "repro_torch.bench.fleet_bench:fleet_rows", volatile=(
            "analytic.pack_ms", "analytic.vec_scenarios_per_sec",
            "analytic.scalar_scenarios_per_sec", "analytic.speedup",
            "crossover.vec_crossovers_per_sec",
            "crossover.scalar_crossovers_per_sec", "crossover.speedup",
            "simulation.vec_jobs_per_sec", "simulation.scalar_jobs_per_sec",
            "simulation.speedup")),
        _bench("cluster", "repro_torch.bench.cluster_bench:cluster_rows", volatile=(
            "closed_loop.client_epochs_per_sec", "equilibrium.solve_ms")),
        _bench("meanfield", "repro_torch.bench.meanfield_bench:meanfield_rows",
               volatile=("diurnal.wall_s", "diurnal.client_epochs_per_sec",
                         "equilibrium.solve_ms", "cross_check.wall_ms")),
        _bench("validate", "repro_torch.bench.validate_bench:validate_rows",
               volatile=("analytic_vec_us", "analytic_scalar_us",
                         "smoke_gate_s")),
        _bench("tail", "repro_torch.bench.tail_bench:tail_rows", volatile=(
            "scalar_us_per_scenario", "vec_euler_rows_per_sec",
            "euler_vec_rows_per_s", "vec_asym_rows_per_sec",
            "euler_vec_slowdown_vs_asym", "station_pass_speedup")),
        _bench("kernels", "repro_torch.bench.kernel_bench:kernel_rows", volatile=(
            "flash_attention.us_per_call", "decode_attention.us_per_call",
            "ssm_scan.us_per_call", "rmsnorm.us_per_call",
            "lindley_scan.us_per_call", "decision_scan.us_per_call")),
        _bench("measure", "repro_torch.bench.measure_bench:measure_rows", volatile=(
            "engine.tokens_per_sec", "engine.wall_s",
            "harness.requests_per_sec", "harness.wall_s", "fit.wall_ms")),
        _bench("obs", "repro_torch.bench.obs_bench:obs_rows", volatile=(
            "tracer.tokens_per_sec_none", "tracer.tokens_per_sec_disabled",
            "tracer.tokens_per_sec_enabled", "tracer.disabled_overhead_pct",
            "tracer.enabled_overhead_pct", "audit.rows_per_sec")),
        _bench("plan", "repro_torch.bench.plan_bench:plan_rows",
               volatile=("solver.wall_s",)),
        # roofline emits CSV rows from pre-existing dry-run artifacts and
        # writes nothing of its own -> empty output contract
        ExperimentSpec(
            exp_id="bench-roofline",
            kind="bench-family",
            payload="repro_torch.bench.run:run_roofline",
            description="roofline table from experiments/roofline dry-run "
                        "artifacts, when present (no artifact of its own)",
            config={"family": "roofline"},
        ),
        # -- hardware in the loop ---------------------------------------------
        ExperimentSpec(
            exp_id="measured-smoke",
            kind="measured-profile",
            payload="repro_torch.exp.payloads:measured_payload",
            description="simulated-clock smoke profile of the real engine "
                        "+ the analytic-vs-observed measured gate",
            seeds=(0,),
            seed_sensitive=True,
            config={"arch": "starcoder2_3b", "slots": 1, "requests": 240,
                    "target_rho": 0.45},
            gates={"mean_budget_pct": 15.0, "tail_budget_pct": 35.0},
            outputs=("PROFILE_starcoder2_3b.json", "VALIDATION_measured.json"),
        ),
        # -- closed loop ------------------------------------------------------
        ExperimentSpec(
            exp_id="cluster-sim-smoke",
            kind="cluster-sim",
            payload="repro_torch.exp.payloads:cluster_sim_payload",
            description="closed-loop cluster replay (equilibrium + "
                        "bandwidth-step trace, adaptive vs statics)",
            seeds=(0,),
            seed_sensitive=True,
            config={"clients": 24, "duration": 60.0},
            outputs=("CLUSTER.json",),
            volatile={"CLUSTER.json": ("equilibrium.solve_s",
                                       "replay.client_epochs_per_sec",
                                       "cross_check.elapsed_s")},
        ),
    ]
    reg: dict[str, ExperimentSpec] = {}
    for spec in specs:
        if spec.exp_id in reg:
            raise ExperimentError(f"duplicate experiment id {spec.exp_id!r}")
        reg[spec.exp_id] = spec
    return reg


def bench_family_specs() -> dict[str, ExperimentSpec]:
    """``{family name: spec}`` for every bench.run family (the
    bench-family and figure kinds), in registry order."""
    return {str(spec.config["family"]): spec
            for spec in registry().values()
            if spec.kind in ("bench-family", "figure")}
