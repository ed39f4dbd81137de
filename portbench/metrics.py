"""Metric readers, found by name: ``portbench/metrics/<name>.py`` defines
``read(run)``, which returns the metric's value from a finished run
(``window.RunRecord``), or ``None`` where the run holds nothing to read; the
harness then leaves the metric out of its line. A share of a roofline or of
a peak is never 0 for want of data: its reader returns ``None``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

__all__ = ["reader", "read_all"]

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


def reader(name: str, directory: Path = METRICS_DIR):
    path = Path(directory) / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(entries: list[dict], run, directory: Path = METRICS_DIR) -> dict:
    """{name: {"value", "unit"}} of every entry whose reader found something."""
    out = {}
    for entry in entries:
        value = reader(entry["name"], directory)(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out
