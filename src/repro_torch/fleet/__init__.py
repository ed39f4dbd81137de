"""Fleet-scale scenario evaluation on the card.

The scalar layer (``repro_torch.core``) answers "what happens at THIS
operating point"; this package answers it for a whole grid of operating
points at once:

  * :class:`ScenarioBatch` — struct-of-arrays packing of Scenario specs;
  * :func:`fleet_analytic` / :func:`fleet_crossover` — float64 closed forms
    and batched-bisection crossover solving over a whole batch;
  * :func:`simulate_fleet` / :func:`lindley_station` — the batched tandem
    FCFS simulator, one hand-written Lindley-scan launch per station.

Traces, replay, tails, the closed-loop cluster and the mean-field fleet are
later slices of the port (ROADMAP A3).
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
from .sim_vec import FleetSimResult, lindley_station, simulate_fleet

__all__ = [k for k in dir() if not k.startswith("_")]
