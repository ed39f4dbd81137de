"""Per-layer vs fixed cost breakdown of a cell: the port of ``repro.launch.perf_probe``.

Runs the 1- and 2-superblock probes (the roofline runner's machinery, the
dry run's census on the fake production mesh) and reports base (embedding,
head, optimizer, fixed) against slope (per superblock) for flops / bytes /
wire bytes: the napkin-math input for each hypothesis -> change -> measure
iteration.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch gemma2_9b --shape train_4k \\
      [--override seq_chunk=256] [--multi]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline_run import _probe_costs

__all__ = ["breakdown", "main"]


def breakdown(arch: str, shape_name: str, *, multi_pod: bool = False, overrides=None):
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    base_ov = dict(scan_layers=False, unroll_attn_chunks=True, grad_accum=1)
    out = {}
    for n in (1, 2):
        ov = dict(base_ov, num_superblocks=n)
        if cfg.is_encdec:
            ov["encoder_layers"] = 1
        out[n] = _probe_costs(dataclasses.replace(cfg, **ov), shape, mesh)
    n_sb = cfg.num_superblocks
    rows = {}
    for key in ("flops", "bytes", "wire_bytes"):
        slope = out[2][key] - out[1][key]
        base = out[1][key] - slope
        rows[key] = {
            "base": base,
            "per_superblock": slope,
            "total_extrapolated": base + n_sb * slope,
            "base_fraction": base / max(base + n_sb * slope, 1e-30),
        }
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, help="architecture id (see configs.base.ARCH_IDS)")
    ap.add_argument("--shape", required=True, help="input shape id (e.g. train_4k)")
    ap.add_argument("--multi", action="store_true", help="probe on the 2x16x16 multi-pod mesh")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable; value parsed as JSON)")
    args = ap.parse_args(argv)
    ov = {}
    for item in args.override:
        k, v = item.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        ov[k] = v
    rows = breakdown(args.arch, args.shape, multi_pod=args.multi, overrides=ov or None)
    for key, r in rows.items():
        print(
            f"{key:12s} base={r['base']:.3e}  per_sb={r['per_superblock']:.3e}  "
            f"total={r['total_extrapolated']:.3e}  base_frac={r['base_fraction']:.2f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
