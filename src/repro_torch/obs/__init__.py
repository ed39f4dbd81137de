"""Run provenance for the port's reports (the ``obs`` subset the fleet path
needs; tracing, audits and metrics come with ROADMAP A2)."""

from .manifest import run_manifest

__all__ = ["run_manifest"]
