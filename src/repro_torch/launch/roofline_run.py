"""Roofline analysis runner: the port of ``repro.launch.roofline_run``.

Per (arch x shape x mesh) cell:
  1. run probes of 1 and 2 superblocks (3 probes for an encoder-decoder, to
     separate the encoder's slope) through the dry run's census
     (``launch.dryrun.census_cell``) on the fake production mesh;
  2. extrapolate flops / bytes / collective wire bytes linearly to full
     depth (``perf.roofline.combine_linear``: exact for homogeneous stacks);
  3. combine with the dry-run record's ``memory_analysis`` and collective
     counts, where one was written, into a ``RooflineReport`` on the
     ``H100_SXM`` spec, the port's card (three terms, the dominant one, the
     model-FLOP/count ratio).

The reference unrolls its probes because XLA's cost analysis counts a loop
body once, and supplements the mamba / xLSTM time recurrences analytically
(``perf.flops``). The census runs every step of every loop eagerly and
counts each step's matrix products, so the port adds no supplement; the
recurrences' elementwise work goes uncounted, as all elementwise work does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_run --all --out experiments/roofline
  PYTHONPATH=src python -m repro_torch.launch.roofline_run --arch jamba_v0_1_52b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_cells
from repro_torch.launch.dryrun import census_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.perf.hardware import H100_SXM
from repro_torch.perf.roofline import combine_linear, report_from_counts

__all__ = ["roofline_cell", "main"]


def _probe_costs(cfg, shape, mesh) -> dict:
    """Run one probe; return its per-device cost dict."""
    c = census_cell(cfg, shape, mesh)
    return {
        "flops": float(c["flops"]),
        "bytes": float(c["bytes"]),
        "wire_bytes": float(c["collectives"].wire_bytes),
        "_counts": dict(c["collectives"].counts),
    }


def _probes(cfg) -> list[tuple[int, ...]]:
    return [(1,), (2,)] if not cfg.is_encdec else [(1, 1), (2, 1), (1, 2)]


def _probe_cfg(cfg, probe: tuple[int, ...]):
    ov = dict(scan_layers=False, unroll_attn_chunks=not cfg.has_mixer("mlstm"), grad_accum=1,
              num_superblocks=probe[0])
    if cfg.is_encdec:
        ov["encoder_layers"] = probe[1]
    return dataclasses.replace(cfg, **ov)


def roofline_cell(
    arch: str, shape_name: str, *, multi_pod: bool = False, overrides: dict | None = None,
    dryrun_dir: Path | None = None, verbose: bool = True,
):
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"

    groups = [cfg.num_superblocks]
    if cfg.is_encdec:
        groups.append(cfg.encoder_layers)
    samples = {}
    for probe in _probes(cfg):
        samples[probe] = {k: v for k, v in _probe_costs(_probe_cfg(cfg, probe), shape, mesh).items()
                          if not k.startswith("_")}
    combined = combine_linear(samples, tuple(groups))

    # memory analysis and the collective census from the dry-run record, if written
    mem, coll_counts = {}, {}
    if dryrun_dir:
        rec_path = Path(dryrun_dir) / f"{arch}__{shape_name}__{mesh_name}.json"
        if rec_path.exists():
            rec = json.loads(rec_path.read_text())
            mem = rec.get("memory_analysis", {})
            coll_counts = rec.get("collectives", {}).get("counts", {})

    report = report_from_counts(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        n_chips=int(mesh.size()),
        flops_per_dev=combined["flops"],
        bytes_per_dev=combined["bytes"],
        collectives={"wire_bytes": combined["wire_bytes"], "counts": coll_counts},
        cfg=cfg,
        memory_analysis=mem,
        hw=H100_SXM,
        notes="1/2-superblock extrapolation of the fake-mesh census (matrix-product FLOPs, "
              "unfused op bytes); recurrences counted step by step, no supplement",
    )
    if verbose:
        print(
            f"[roofline] {arch:24s} {shape_name:12s} {mesh_name:6s} "
            f"compute={report.compute_s:.3e}s memory={report.memory_s:.3e}s "
            f"collective={report.collective_s:.3e}s dominant={report.dominant:10s} "
            f"useful={report.useful_ratio:.2f} frac={report.roofline_fraction:.3f}"
        )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/roofline")
    ap.add_argument("--dryrun-dir", type=str, default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape required unless --all")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    from repro_torch.obs import run_manifest

    # per-cell reports stay lean; one provenance manifest covers the dir
    # (roofline_report skips it when emitting rows)
    (outdir / "manifest.json").write_text(json.dumps(
        run_manifest(config={"mesh": args.mesh, "all": bool(args.all)}), indent=2))

    if args.all:
        cells = [(arch, sh.name) for arch in ARCH_IDS for sh in shape_cells(get_config(arch))]
    else:
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in cells:
        try:
            rep = roofline_cell(arch, shape_name, multi_pod=(args.mesh == "multi"),
                                dryrun_dir=Path(args.dryrun_dir))
            (outdir / f"{arch}__{shape_name}__{args.mesh}.json").write_text(rep.to_json())
        except Exception as e:  # noqa: BLE001 - every cell is tried; failures are listed
            failures.append((arch, shape_name, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} roofline failures: {failures}")
        return 1
    print(f"roofline table complete: {len(cells)} cells -> {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
