"""Experiment payloads of the port.

Only :func:`run_validate` so far, the engine behind
``python -m repro_torch.launch.validate``; the reference's registry, runner
and the other payloads come with a later slice of the port.
"""

from .payloads import run_validate

__all__ = ["run_validate"]
