"""Analytic cost models of the port: only ``flops.param_counts`` so far, which
the measurement harness's simulated clock needs; the rest of the reference's
``perf`` (FLOP and byte models, hardware specs, rooflines) comes with ROADMAP
A11."""

from .flops import param_counts

__all__ = ["param_counts"]
