"""repro_torch.exp — declared experiments and manifest-driven reproduction
(the port's twin of the reference's ``exp`` package).

``spec`` holds the frozen :class:`ExperimentSpec` and the single registry of
every experiment the port knows how to run; ``runner`` executes a spec into
an isolated ``results/<exp-id>/<run-id>/`` directory with provenance,
cross-seed bootstrap CIs, resume-skip semantics, and a byte-stability
contract, on the device it is given (default: the card); ``payloads`` hosts
the non-bench payload callables and :func:`run_validate`, the engine of
``launch/validate.py``. The ``reproduce`` CLI
(:mod:`repro_torch.launch.reproduce`) replays the whole registry.
"""

from repro_torch.exp.payloads import run_validate
from repro_torch.exp.runner import (
    RunResult,
    diff_results,
    resolve_payload,
    run_experiment,
    run_id_for,
    strip_volatile,
)
from repro_torch.exp.spec import (
    KINDS,
    ExperimentError,
    ExperimentSpec,
    bench_family_specs,
    registry,
)

__all__ = [
    "KINDS",
    "ExperimentError",
    "ExperimentSpec",
    "RunResult",
    "bench_family_specs",
    "diff_results",
    "registry",
    "resolve_payload",
    "run_experiment",
    "run_id_for",
    "run_validate",
    "strip_volatile",
]
