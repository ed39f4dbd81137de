"""Three-term roofline analysis from per-device counts.

    compute term    = FLOPs       / (chips x peak FLOP/s)
    memory term     = bytes       / (chips x HBM bw)
    collective term = wire_bytes  / (chips x link bw)

The port's copy of ``repro.perf.roofline``. The counts come from the caller:
an analytic count (``flops.cell_flops`` and the step's weight and cache
bytes), or per-group counts extrapolated linearly over scan groups
(``combine_linear``: exact for homogeneous stacks; encoder-decoder models add
a second group for the encoder). Work the counts miss (recurrence scans) is
supplemented analytically (``flops``) and noted per cell.

One deliberate difference from the reference (ROADMAP C12): the reference's
``roofline_fraction`` divides the useful FLOPs by the TPU v5e's peak whatever
``hw`` built the report, while ``compute_s`` uses ``hw.peak_flops``. Here the
report keeps the spec it was built with (``hw``, left out of ``to_json``,
``repr`` and comparisons) and divides by that spec's peak. At the default
``TPU_V5E`` the two agree key for key.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from .flops import CellFlops, cell_flops
from .hardware import TPU_V5E, HardwareSpec
from .hlo import CollectiveStats

__all__ = ["RooflineReport", "combine_linear", "report_from_counts"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # per-device counts
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    wire_bytes_per_dev: float
    # supplements
    supplement_flops_per_dev: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops_global: float
    useful_ratio: float  # MODEL_FLOPS / (FLOPs x chips)
    collective_counts: dict = field(default_factory=dict)
    memory_analysis: dict = field(default_factory=dict)
    notes: str = ""
    # the spec the terms were computed with (C12: the fraction divides by its peak)
    hw: HardwareSpec = field(default=TPU_V5E, repr=False, compare=False)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute-time / bound-time: how close the step is to the
        compute roofline for its *useful* FLOPs."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops_global / (self.n_chips * self.hw.peak_flops)
        return useful_s / self.bound_s

    def to_json(self) -> str:
        d = asdict(self)
        del d["hw"]
        d["bound_s"] = self.bound_s
        d["roofline_fraction"] = self.roofline_fraction
        return json.dumps(d, indent=2, default=float)


def combine_linear(samples: dict[tuple[int, ...], dict], full: tuple[int, ...]) -> dict:
    """Linear extrapolation over scan-group counts.

    samples: {(1,1): costs, (2,1): costs, (1,2): costs} (second group optional)
    full: e.g. (num_superblocks, encoder_layers). costs are flat dicts of
    numbers. total = base + sum_i (full_i - 1) * slope_i.
    """
    base_key = tuple(1 for _ in full)
    base = samples[base_key]
    out = dict(base)
    for i, n in enumerate(full):
        probe = tuple(2 if j == i else 1 for j in range(len(full)))
        if probe not in samples:
            if n != 1:
                raise KeyError(f"missing probe {probe} for group {i}")
            continue
        slope = {k: samples[probe][k] - base[k] for k in base}
        for k in out:
            out[k] = out[k] + (n - 1) * slope[k]
    return out


def report_from_counts(
    *,
    arch: str,
    shape,
    mesh_name: str,
    n_chips: int,
    flops_per_dev: float,
    bytes_per_dev: float,
    collectives: CollectiveStats | dict,
    cfg=None,
    supplement_flops_global: float = 0.0,
    memory_analysis: dict | None = None,
    hw: HardwareSpec = TPU_V5E,
    notes: str = "",
) -> RooflineReport:
    wire = collectives.wire_bytes if isinstance(collectives, CollectiveStats) else collectives.get("wire_bytes", 0.0)
    counts = collectives.summary()["counts"] if isinstance(collectives, CollectiveStats) else collectives.get("counts", {})
    supp_dev = supplement_flops_global / n_chips
    compute_s = (flops_per_dev + supp_dev) / hw.peak_flops
    memory_s = bytes_per_dev / hw.hbm_bw
    collective_s = wire / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)

    cf: CellFlops | None = cell_flops(cfg, shape) if cfg is not None else None
    model_flops = cf.total if cf else 0.0
    hlo_global = (flops_per_dev + supp_dev) * n_chips
    return RooflineReport(
        arch=arch,
        shape=shape.name if hasattr(shape, "name") else str(shape),
        mesh=mesh_name,
        n_chips=n_chips,
        hlo_flops_per_dev=flops_per_dev,
        hlo_bytes_per_dev=bytes_per_dev,
        wire_bytes_per_dev=wire,
        supplement_flops_per_dev=supp_dev,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_global=model_flops,
        useful_ratio=(model_flops / hlo_global) if hlo_global else 0.0,
        collective_counts=dict(counts),
        memory_analysis=memory_analysis or {},
        notes=notes,
        hw=hw,
    )
