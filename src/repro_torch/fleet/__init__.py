"""Fleet-scale scenario evaluation on the card.

The scalar layer (``repro_torch.core``) answers "what happens at THIS
operating point"; this package answers it for a whole grid of operating
points at once, and for operating points that *move*:

  * :class:`ScenarioBatch` — struct-of-arrays packing of Scenario specs;
  * :func:`fleet_analytic` / :func:`fleet_crossover` — float64 closed forms
    and batched-bisection crossover solving over a whole batch;
  * :func:`simulate_fleet` / :func:`lindley_station` — the batched tandem
    FCFS simulator, one hand-written Lindley-scan launch per station;
  * :mod:`traces` + :func:`replay` — §5-style dynamic conditions scored
    against adaptive vs static offloading policies via the same
    ``AdaptiveOffloadManager.step()`` hook the serving gateway uses;
  * :mod:`cluster` — the closed loop: N clients sharing E edges, endogenous
    edge load, fixed-point equilibria, and an event-driven cross-check, its
    decide step one hand-written decision-scan launch per epoch.

Tails and the mean-field fleet are later slices of the port (ROADMAP A3).
"""

from .analytic_vec import (
    FleetCrossover,
    FleetPrediction,
    fleet_analytic,
    fleet_crossover,
    md1_wait_vec,
    mg1_wait_vec,
    mm1_wait_vec,
    mmk_wait_erlang_vec,
)
from .batch import MODEL_CODES, SWEEPABLE_PATHS, ScenarioBatch
from .cluster import (
    ClusterPolicyResult,
    ClusterResult,
    Equilibrium,
    cross_check_equilibrium,
    induced_scenario,
    predict_decisions,
    predict_terms,
    simulate_cluster,
    solve_equilibrium,
)
from .policy import (
    bg_template,
    clamp_saturation,
    parse_policy,
    static_fractions,
    true_latency,
)
from .replay import PolicyResult, ReplayResult, replay
from .sim_vec import FleetSimResult, lindley_station, simulate_fleet
from .traces import (
    Trace,
    TraceBatch,
    drift_signal,
    epoch_times,
    make_trace,
    mmpp_signal,
    step_signal,
)

__all__ = [k for k in dir() if not k.startswith("_")]
