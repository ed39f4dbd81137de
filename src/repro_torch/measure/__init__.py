"""Hardware-in-the-loop service-time profiling: the port's ``repro.measure``.

Closes the paper's experimental loop: the port's serving engine runs under a
Poisson workload on a deterministic simulated-or-wall clock (``harness``),
the recorded trace is fitted into per-(phase, occupancy) service-time
distributions classified into the paper's M/D/1 / M/M/1 / M/G/1 taxonomy
(``fit``), and the fits are serialized as a versioned ``MeasuredProfile``
artifact that ``Tier.from_measured`` turns into an ordinary analytic tier
(``profile``). ``repro_torch.validate.measured`` then gates the closed forms
against the *observed* engine latencies, paper-§5 style.
"""

from .harness import (
    HarnessConfig,
    MeasuredTrace,
    RequestRecord,
    SimulatedTimer,
    run_harness,
)
from .fit import (
    DET_SCV_MAX,
    EXP_SCV_BAND,
    PERCENTILES,
    DistFit,
    classify_service_model,
    fit_samples,
    fit_trace,
)
from .profile import (
    PROFILE_VERSION,
    MeasuredProfile,
    build_profile,
    load_profile,
)

__all__ = [k for k in dir() if not k.startswith("_")]
