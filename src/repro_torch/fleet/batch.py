"""Packed struct-of-arrays representation of a scenario fleet.

A :class:`ScenarioBatch` flattens B validated :class:`repro_torch.core.Scenario`
specs into float64 numpy columns — one array per field, one row per scenario,
edges padded to the widest scenario — so the whole fleet can be handed to the
jitted closed forms in :mod:`repro_torch.fleet.analytic_vec` (and the batched
simulator in :mod:`repro_torch.fleet.sim_vec`) as a single device call.

Two constructors, two scales:

  * :meth:`ScenarioBatch.from_scenarios` packs an explicit list (the output of
    ``Scenario.sweep()`` / ``Scenario.grid()``) — every element was eagerly
    validated at construction, so packing is a plain transcription.
  * :meth:`ScenarioBatch.from_sweep` is the array-native fast path for
    cartesian grids: the base scenario is packed once and swept numeric
    columns are tiled with ``np.meshgrid`` — no per-point Python object is
    ever built, which is what makes million-scenario fleets cheap. Row ``i``
    corresponds exactly to ``base.grid(axes)[i]`` (C order, last axis
    fastest); each axis path is validated once against the base spec so bad
    paths still fail fast with a named-field :class:`ScenarioError`.

Background tenants are stored as the three rate-weighted sums the mixture
moments need (sum lam_i, sum lam_i*s_i, sum lam_i*(var_i + s_i^2)); the
scenario's own stream is folded in at evaluation time from the *current*
arrival-rate column, so sweeping ``workload.arrival_rate`` re-aggregates the
multi-tenant mixture exactly as ``aggregate_streams`` would.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from dataclasses import replace as _replace
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.latency import ServiceModel
from repro_torch.core.scenario import Scenario, ScenarioError

__all__ = ["ScenarioBatch", "MODEL_CODES", "SWEEPABLE_PATHS"]

# ServiceModel -> integer dispatch code used inside jitted kernels
MODEL_CODES = {
    ServiceModel.DETERMINISTIC: 0,
    ServiceModel.EXPONENTIAL: 1,
    ServiceModel.GENERAL: 2,
}

# field-path -> (attribute, edge-column or None); the numeric leaves
# from_sweep() can tile without materialising Scenario objects
SWEEPABLE_PATHS = {
    "workload.arrival_rate": "lam",
    "workload.req_bytes": "req_bytes",
    "workload.res_bytes": "res_bytes",
    "network.bandwidth_Bps": "bandwidth_Bps",
    "device.service_time_s": "dev_s",
    "device.parallelism_k": "dev_k",
    "device.service_var": "dev_var",
    # per-edge leaves are matched as edges[j].<leaf> via _sweep_slot()
}

_EDGE_LEAVES = {
    "tier.service_time_s": "edge_s",
    "tier.parallelism_k": "edge_k",
    "tier.service_var": "edge_var",
    "bandwidth_Bps": "edge_bw",
}

# domain of each sweepable column, mirroring Scenario's eager validation:
# positivity is NOT a stability concern, so even allow_unstable sweeps must
# fail fast on these (exactly like base.grid(axes) would, row for row)
_POSITIVE_ATTRS = frozenset(
    {"lam", "req_bytes", "bandwidth_Bps", "dev_s", "dev_k",
     "edge_s", "edge_k", "edge_bw"})
_NONNEGATIVE_ATTRS = frozenset({"res_bytes", "dev_var", "edge_var"})


def _validate_axis_domain(path: str, attr: str, values: np.ndarray) -> None:
    """Reject axis values grid() would reject, without building Scenarios."""
    if not np.all(np.isfinite(values)):
        bad = values[~np.isfinite(values)][0]
        raise ScenarioError(path, f"axis values must be finite, got {bad!r}")
    if attr in _POSITIVE_ATTRS and np.any(values <= 0):
        bad = values[values <= 0][0]
        raise ScenarioError(path, f"must be positive, got {bad!r}")
    if attr in _NONNEGATIVE_ATTRS and np.any(values < 0):
        bad = values[values < 0][0]
        raise ScenarioError(path, f"must be non-negative, got {bad!r}")


def _sweep_slot(path: str, n_edges: int) -> tuple[str, int | None]:
    """(attribute, edge column) for a sweepable field path."""
    if path in SWEEPABLE_PATHS:
        return SWEEPABLE_PATHS[path], None
    if path.startswith("edges["):
        close = path.index("]")
        j = int(path[6:close])
        if not 0 <= j < n_edges:
            raise ScenarioError(path, f"edge index {j} out of range (n_edges {n_edges})")
        leaf = path[close + 2 :]  # skip "]."
        if leaf in _EDGE_LEAVES:
            return _EDGE_LEAVES[leaf], j
    known = sorted(SWEEPABLE_PATHS) + [f"edges[j].{leaf}" for leaf in sorted(_EDGE_LEAVES)]
    raise ScenarioError(path, f"not a sweepable numeric field (known: {known})")


@dataclass(frozen=True)
class ScenarioBatch:
    """B scenarios as parallel float64 columns (edges padded to width E)."""

    # workload / network (B,)
    lam: np.ndarray
    req_bytes: np.ndarray
    res_bytes: np.ndarray
    bandwidth_Bps: np.ndarray
    return_results: np.ndarray  # bool
    # device tier (B,)
    dev_s: np.ndarray
    dev_k: np.ndarray
    dev_var: np.ndarray
    dev_model: np.ndarray  # int8 MODEL_CODES
    # edges, padded to (B, E); edge_mask False rows/cols are inert padding
    edge_mask: np.ndarray  # bool
    edge_s: np.ndarray
    edge_k: np.ndarray
    edge_var: np.ndarray
    edge_model: np.ndarray  # int8
    edge_bw: np.ndarray  # nan = "use the shared network path"
    # background tenants, pre-aggregated (B, E): sum lam_i, sum lam_i*s_i,
    # sum lam_i*(var_i + s_i^2) — own stream is folded in at eval time
    bg_lam: np.ndarray
    bg_wsum: np.ndarray
    bg_ssum: np.ndarray

    def __post_init__(self):
        b = self.lam.shape[0]
        for f in fields(self):
            arr = getattr(self, f.name)
            if arr.shape[0] != b:
                raise ValueError(f"{f.name}: leading dim {arr.shape[0]} != batch {b}")
        if self.edge_mask.ndim != 2:
            raise ValueError("edge arrays must be (B, E)")

    @property
    def size(self) -> int:
        return int(self.lam.shape[0])

    def __len__(self) -> int:
        return self.size

    @property
    def max_edges(self) -> int:
        return int(self.edge_mask.shape[1])

    @property
    def n_edges(self) -> np.ndarray:
        """(B,) number of real (non-padding) edges per scenario."""
        return self.edge_mask.sum(axis=1)

    def arrays(self) -> dict[str, np.ndarray]:
        """The columns as a plain dict pytree (the jitted kernels' input)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_scenarios(cls, scenarios: Sequence[Scenario] | Iterable[Scenario]) -> "ScenarioBatch":
        """Pack an explicit (already-validated) scenario list."""
        scns = list(scenarios)
        if not scns:
            raise ValueError("need at least one scenario")
        b = len(scns)
        e_max = max((len(s.edges) for s in scns), default=0)

        def col(fn, dtype=np.float64):
            return np.asarray([fn(s) for s in scns], dtype=dtype)

        edge_mask = np.zeros((b, e_max), dtype=bool)
        edge_s = np.ones((b, e_max))
        edge_k = np.ones((b, e_max))
        edge_var = np.zeros((b, e_max))
        edge_model = np.zeros((b, e_max), dtype=np.int8)
        edge_bw = np.full((b, e_max), np.nan)
        bg_lam = np.zeros((b, e_max))
        bg_wsum = np.zeros((b, e_max))
        bg_ssum = np.zeros((b, e_max))
        for i, s in enumerate(scns):
            for j, e in enumerate(s.edges):
                edge_mask[i, j] = True
                edge_s[i, j] = e.tier.service_time_s
                edge_k[i, j] = e.tier.parallelism_k
                edge_var[i, j] = e.tier.service_var
                edge_model[i, j] = MODEL_CODES[e.tier.service_model]
                if e.bandwidth_Bps is not None:
                    edge_bw[i, j] = e.bandwidth_Bps
                for t in e.background:
                    bg_lam[i, j] += t.arrival_rate
                    bg_wsum[i, j] += t.arrival_rate * t.service_mean_s
                    bg_ssum[i, j] += t.arrival_rate * (t.service_var + t.service_mean_s**2)

        return cls(
            lam=col(lambda s: s.workload.arrival_rate),
            req_bytes=col(lambda s: s.workload.req_bytes),
            res_bytes=col(lambda s: s.workload.res_bytes),
            bandwidth_Bps=col(lambda s: float(np.asarray(s.network.bandwidth_Bps))),
            return_results=col(lambda s: s.return_results, dtype=bool),
            dev_s=col(lambda s: s.device.service_time_s),
            dev_k=col(lambda s: s.device.parallelism_k),
            dev_var=col(lambda s: s.device.service_var),
            dev_model=col(lambda s: MODEL_CODES[s.device.service_model], dtype=np.int8),
            edge_mask=edge_mask,
            edge_s=edge_s,
            edge_k=edge_k,
            edge_var=edge_var,
            edge_model=edge_model,
            edge_bw=edge_bw,
            bg_lam=bg_lam,
            bg_wsum=bg_wsum,
            bg_ssum=bg_ssum,
        )

    @classmethod
    def from_sweep(cls, base: Scenario, axes: Mapping[str, Iterable]) -> "ScenarioBatch":
        """Cartesian grid over numeric field paths, packed without building
        per-point Scenario objects. Row order matches ``base.grid(axes)``."""
        if not axes:
            return cls.from_scenarios([base])
        paths = list(axes)
        values = [np.asarray(list(axes[p]), dtype=np.float64) for p in paths]
        # sweeps deliberately cross stability boundaries, exactly as
        # grid()/sweep() permit — probe with allow_unstable so row-for-row
        # equivalence with base.grid(axes) holds regardless of value order
        probe = base if base.allow_unstable else _replace(base, allow_unstable=True)
        for p, v in zip(paths, values):
            if v.ndim != 1 or v.size == 0:
                raise ScenarioError(p, "grid axis must be a non-empty 1-D value list")
            # fail fast on bad paths/values exactly like the object API would
            probe.replaced(p, float(v[0]))
        slots = [_sweep_slot(p, len(base.edges)) for p in paths]
        for p, v, (attr, _j) in zip(paths, values, slots):
            # EVERY value, not just the probe: grid() validates each point
            _validate_axis_domain(p, attr, v)

        packed = cls.from_scenarios([base])
        b = int(np.prod([v.size for v in values]))
        cols = {
            name: np.repeat(arr, b, axis=0).copy() for name, arr in packed.arrays().items()
        }
        mesh = np.meshgrid(*values, indexing="ij")  # C order, last axis fastest
        for (attr, j), grid_vals in zip(slots, mesh):
            flat = grid_vals.reshape(-1)
            if j is None:
                cols[attr][:] = flat
            else:
                cols[attr][:, j] = flat
        return cls(**cols)
