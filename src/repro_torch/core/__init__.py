"""The paper's contribution: closed-form queueing latency models + the
model-driven adaptive offloading manager, plus the discrete-event simulator
used as the hardware-free validation testbed.

numpy-only copies of ``latency``, ``multitenant``, ``telemetry``, ``tail``,
``manager``, ``crossover``, ``simulation``, ``scenario``, ``queueing``,
``split`` and ``service_time``, with the same arithmetic: the scalar
``Scenario.analytic()`` here is the oracle the port's batched closed forms are
held against. ``predictor`` (the learned service-time MLP) is torch and trains
on the card; like the reference's, it is imported from its module, not here.
"""

from .latency import (
    LatencyBreakdown,
    NetworkPath,
    ServiceModel,
    Tier,
    Workload,
    edge_offload_latency,
    lemma31_rhs,
    lemma32_rhs,
    lemma33_rhs,
    offload_wins,
    on_device_latency,
    proc_wait,
)
from .crossover import (
    Crossover,
    arrival_rate_crossovers,
    bandwidth_crossover,
    service_gap_bound,
    solve_crossover,
    tenancy_crossover,
)
from .manager import (
    ON_DEVICE,
    AdaptiveOffloadManager,
    Decision,
    EdgeServerState,
    apply_decision_rule,
)
from .multitenant import (
    AggregateLoad,
    TenantStream,
    aggregate_streams,
    mixture_moments,
    multitenant_edge_latency,
)
from .scenario import (
    ClientClass,
    ClusterSpec,
    EdgeSpec,
    MeanFieldSpec,
    Scenario,
    ScenarioError,
    ScenarioPrediction,
    analytic,
    analytic_tail,
    crossovers,
    parse_strategy,
    simulate,
    tail_stations,
)
from .tail import (
    Station,
    mixture_station,
    mm1_sojourn_quantile,
    nic_station,
    proc_station,
    sojourn_cdf,
    sojourn_mean,
    sojourn_pdf,
    sojourn_quantile,
)
from .queueing import (
    QueueStats,
    gg1_wait_upper_bound,
    md1_wait,
    md1_wait_aggregated,
    mdk_wait_approx,
    mg1_wait,
    mm1_response,
    mm1_wait,
    mm1_wait_aggregated,
    mmk_wait_erlang,
    utilisation,
)
from .service_time import ServiceEstimate, fit_parallelism, from_profile, from_roofline
from .split import LayerProfile, SplitPlan, SplitPlanner, SplitPoint, split_latency
from .telemetry import (
    EwmaEstimator,
    SlidingRateEstimator,
    TelemetrySnapshot,
    UtilisationEstimator,
    WindowedMoments,
)

__all__ = [k for k in dir() if not k.startswith("_")]
