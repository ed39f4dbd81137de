"""Where the batched Euler quantile parts between two devices.

Runs ``fleet_tail(batch, 0.99, method="euler")`` over a sweep grid
(:func:`grid`) on the card and on the CPU, recording every CDF evaluation of the search (the growth,
bisection and Newton phases of ``euler_vec.quantile_euler_vec``, one call
per step, the same sequence on both devices). For each row whose quantiles
differ by more than ``RTOL`` it prints the two trajectories step by step
(the point evaluated and ``CDF - q`` on each device), the first step whose
point differs, whether any branch (``CDF < q``) went another way, and both
devices' CDF and density at the CPU's answer, and the CPU's noise band
there (:func:`noise_band`): the half-width in t over which the CDF's
evaluation noise outweighs its slope, inside which any converged search
may stop.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.euler_parity            # the card vs the CPU
  PYTHONPATH=src python -m repro_torch.launch.euler_parity --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleet import ScenarioBatch, euler_vec, fleet_tail
from repro_torch.launch.fleet_sweep import default_scenario
from repro_torch.validate import bottleneck_rho

__all__ = ["grid", "record_trajectories", "stations", "noise_band", "main"]

Q = 0.99
RTOL = 1e-8  # the differential harness's Euler contract


def grid():
    """The sweep ``tests/test_torch_cuda.py`` holds on the card: the fleet
    sweep's scenario over 64 bandwidths x 32 arrival rates."""
    return default_scenario(), {"network.bandwidth_Bps": np.geomspace(1e5, 1e8, 64),
                                "workload.arrival_rate": np.linspace(0.5, 30.0, 32)}


def record_trajectories(batch: ScenarioBatch, q: float, device) -> tuple:
    """``fleet_tail`` Euler on ``device`` and the list of its CDF evaluations:
    (phase, points, CDF, density or None) per call, as host float64 arrays."""
    calls = []
    cdf_only, cdf_pdf = euler_vec._cdf_vec, euler_vec.cdf_pdf_vec

    def spy_cdf(st, t, slot_kinds=None):
        f = cdf_only(st, t, slot_kinds)
        calls.append(("cdf", t.cpu().numpy().copy(), f.cpu().numpy().copy(), None))
        return f

    def spy_cdf_pdf(st, t, slot_kinds=None):
        f, p = cdf_pdf(st, t, slot_kinds)
        calls.append(("newton", t.cpu().numpy().copy(), f.cpu().numpy().copy(),
                      p.cpu().numpy().copy()))
        return f, p

    euler_vec._cdf_vec, euler_vec.cdf_pdf_vec = spy_cdf, spy_cdf_pdf
    try:
        pred = fleet_tail(batch, q, method="euler", device=device)
    finally:
        euler_vec._cdf_vec, euler_vec.cdf_pdf_vec = cdf_only, cdf_pdf
    return pred, calls


def _split(calls):
    """The calls of the on-device search (points of shape (B,)) and of the
    offload search ((B, E)): ``fleet_tail`` runs them in that order."""
    first = [c for c in calls if c[1].ndim == 1]
    return first, calls[len(first):]


def stations(batch: ScenarioBatch, device, column: int | None):
    """The station fields and slot hints ``fleet_tail`` gives the Euler
    search: the on-device path's (B, 1) when ``column`` is None, else the
    offload paths' (B, E, 3)."""
    from repro_torch.fleet.tail_vec import (
        _batch_tensors, _device_stations, _edge_stations, _uniform_kind_hint)

    arrays = batch.arrays()
    c = _batch_tensors(batch, torch.device(device))
    if column is None:
        return _device_stations(c), (_uniform_kind_hint(arrays["dev_model"]),)
    proc = None if np.any(arrays["bg_lam"] > 0.0) else _uniform_kind_hint(arrays["edge_model"])
    return _edge_stations(c), ("nic", proc, "nic")


def noise_band(st, t, slot_kinds, points: int = 33, span: float = 2e-8):
    """Half-width, in seconds, of the band around each ``t`` in which the
    Euler CDF's evaluation noise outweighs its slope: the CDF at
    ``t * (1 + span * u)`` for ``points`` values of u in [-1, 1], its largest
    residual about its least-squares line, over the line's slope (inf where
    the slope is not positive). A quantile search converges anywhere in
    that band, so two correct searches may land up to twice it apart."""
    t = torch.where(torch.isfinite(t), t, 1.0)
    u = torch.linspace(-1.0, 1.0, points, dtype=t.dtype, device=t.device)
    tk = t[..., None] * (1.0 + span * u)
    st_k = {k: v[..., None, :].expand(*tk.shape, v.shape[-1]) for k, v in st.items()}
    f = euler_vec._cdf_vec(st_k, tk, slot_kinds)
    x = tk - t[..., None]
    xc, fc = x - x.mean(-1, keepdim=True), f - f.mean(-1, keepdim=True)
    slope = (xc * fc).sum(-1) / (xc * xc).sum(-1)
    resid = (fc - slope[..., None] * xc).abs().amax(-1)
    return torch.where(slope > 0, resid / torch.where(slope > 0, slope, 1.0), float("inf"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="device held against the CPU (default: cuda)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    base, axes = grid()
    batch = ScenarioBatch.from_sweep(base, axes)
    scns = list(base.grid(axes))
    got, calls_dev = record_trajectories(batch, Q, device)
    want, calls_cpu = record_trajectories(batch, Q, "cpu")
    assert len(calls_dev) == len(calls_cpu)

    report = {"device": device, "q": Q, "rows": batch.size, "rtol": RTOL,
              "parted": []}
    dev_calls, cpu_calls = _split(calls_dev), _split(calls_cpu)
    for part, column, a, b in ((0, None, got.t_dev, want.t_dev),
                               (1, 0, got.t_edge[:, 0], want.t_edge[:, 0])):
        cd, cc = dev_calls[part], cpu_calls[part]
        strategy = "on_device" if column is None else f"edge[{column}]"
        fin = np.isfinite(b)
        rel = np.zeros_like(b)
        rel[fin] = np.abs(a[fin] - b[fin]) / np.abs(b[fin])
        gap = np.zeros_like(b)
        gap[fin] = np.abs(a[fin] - b[fin])
        st_cpu, hints = stations(batch, "cpu", column)
        st_dev, _ = stations(batch, device, column)
        t_cpu = torch.as_tensor(want.t_dev if column is None else want.t_edge)
        t_cpu = torch.where(torch.isfinite(t_cpu), t_cpu, 1.0)
        at = {"cpu": euler_vec.cdf_pdf_vec(st_cpu, t_cpu, hints),
              device: euler_vec.cdf_pdf_vec(st_dev, t_cpu.to(device), hints)}
        at = {k: tuple(x.cpu().numpy() for x in v) for k, v in at.items()}
        band = noise_band(st_cpu, t_cpu, hints).numpy()
        band_dev = noise_band(st_dev, t_cpu.to(device), hints).cpu().numpy()
        band_col = band if column is None else band[:, column]
        rho = np.array([bottleneck_rho(scn, strategy) for scn in scns])
        wide = fin & (2.0 * band_col > RTOL * np.abs(np.where(fin, b, 1.0)))
        report[strategy] = {
            "max_rel": float(rel.max()), "finite": int(fin.sum()),
            "rows_band_wider_than_rtol": int(wide.sum()),
            "min_rho_of_those": float(rho[wide].min()) if wide.any() else None,
            "rows_past_rtol": int((rel > RTOL).sum()),
            "rows_past_rtol_and_past_twice_the_band": int(
                (fin & (gap > np.maximum(RTOL * np.abs(b), 2.0 * band_col))).sum()),
        }
        bad = np.flatnonzero(rel > RTOL)
        for i in bad:
            idx = (i,) if column is None else (i, column)
            steps, first_point, branch_flips = [], None, []
            for k, (x, y) in enumerate(zip(cd, cc)):
                td, tc = float(x[1][idx]), float(y[1][idx])
                fd, fc = float(x[2][idx]) - Q, float(y[2][idx]) - Q
                steps.append({"phase": x[0], "t_dev": td, "t_cpu": tc,
                              "cdf_minus_q_dev": fd, "cdf_minus_q_cpu": fc})
                if first_point is None and td != tc:
                    first_point = k
                if (fd < 0) != (fc < 0):
                    branch_flips.append(k)
            f_dev, p_dev = (float(v[idx]) for v in at[device])
            f_cpu, p_cpu = (float(v[idx]) for v in at["cpu"])
            scn = scns[i]
            report["parted"].append({
                "row": int(i), "strategy": strategy,
                "bandwidth_Bps": float(scn.network.bandwidth_Bps),
                "arrival_rate": float(scn.workload.arrival_rate),
                "rho": float(rho[i]),
                "t_dev": float(a[i]), "t_cpu": float(b[i]), "rel": float(rel[i]),
                "abs": float(gap[i]),
                "first_step_apart": first_point, "steps": len(steps),
                "branch_flips": branch_flips,
                "cdf_dev_minus_cpu_at_t_cpu": f_dev - f_cpu,
                "pdf_at_t_cpu": p_cpu, "pdf_dev_at_t_cpu": p_dev,
                "noise_band_cpu": float(band[idx]), "noise_band_dev": float(band_dev[idx]),
                "trajectory": steps,
            })
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
