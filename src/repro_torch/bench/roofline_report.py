"""Roofline rows for the benchmark CSV, read from experiments/roofline JSONs
(the twin of the reference's ``benchmarks/roofline_report.py``; pure JSON).

The port's own producer writes them: ``python -m repro_torch.launch.roofline_run``
(one report per cell on the H100 spec, from the dry run's census on the fake
production mesh, plus a ``manifest.json`` that the rows skip)."""

from __future__ import annotations

import json
from pathlib import Path

from .common import emit


def print_roofline_rows(directory: Path) -> None:
    for f in sorted(directory.glob("*.json")):
        if f.name == "manifest.json":  # dir-level provenance, not a cell
            continue
        r = json.loads(f.read_text())
        name = f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}"
        derived = (
            f"compute_s={r['compute_s']:.3e};memory_s={r['memory_s']:.3e};"
            f"collective_s={r['collective_s']:.3e};dominant={r['dominant']};"
            f"useful_ratio={r['useful_ratio']:.3f};roofline_fraction={r.get('roofline_fraction', 0):.3f}"
        )
        emit(name, 0.0, derived)
