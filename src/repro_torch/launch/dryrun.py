"""Multi-pod dry run: prove the distribution config is coherent and count
what one step costs each device.

The port of ``repro.launch.dryrun``. For every (architecture x input-shape)
cell the step runs once on the production meshes (16x16 single-pod and
2x16x16 multi-pod) of a fake world: one process standing in for every rank
(``launch.mesh.fake_world``). Parameters, optimizer state and inputs are
fake ``DTensor``s placed by ``rules_for_cell`` and ``shardings_for``: no
byte is allocated and no collective runs. That run is the twin of the
reference's lower + compile; ``perf.census.StepCensus`` counts what each
rank's share of it costs, in the reference's record keys:

  * ``flops_per_device``: FLOPs of the local ops' matrix products
    (``FlopCounterMode``'s registry); XLA also counts elementwise work;
  * ``bytes_accessed_per_device``: the input and output bytes of each local
    op, unfused, as the card runs the step eagerly;
  * ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` of the local shards (train outputs are the
    updated parameters and optimizer state, as the reference returns them),
    ``temp_size_in_bytes`` the peak of live local bytes the ops made, and
    ``alias_size_in_bytes`` the donated inputs (train: parameters and
    optimizer state; decode: the caches). XLA's
    ``generated_code_size_in_bytes`` has no meaning here and is left out;
  * ``collectives``: the collectives DTensor issued, by the reference's kind
    names, with ``perf.hlo``'s ring model for the wire bytes.

The step runs through the model's plain path: the kernel wrappers take
their plain versions because the fake tensors lie on the CPU. The count is
the step's work, whatever implements it. DTensor and XLA's partitioner pick
different collectives for the same rules, so the census is the port's own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2_15b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeSuite, get_config, \
    shape_cells
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import cell_step_and_specs
from repro_torch.models.params import map_axes
from repro_torch.sharding.partition import axis_sizes, rules_for_cell, use_rules

__all__ = ["run_cell", "census_cell", "main"]


def _local_shape(shape, placements, mesh) -> list[int]:
    """Rank 0's shard: the ceiling share of each sharded dim (XLA pads the
    other shards to it)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(md))
    return out


def _fake_leaf(spec, placements, mesh):
    """A fake DTensor for (shape, dtype), a plain fake tensor on a one-rank
    mesh; a scalar stays a real 0-dim tensor (the optimizer reads its step
    count as a number)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    shape, dtype = spec
    if not shape:
        with unset_fake_temporarily():
            return torch.zeros((), dtype=dtype)
    local = torch.empty(_local_shape(shape, placements, mesh), dtype=dtype)
    if mesh.size() == 1:  # one rank holds everything: plain tensors, no DTensor dispatch
        return local
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _read_args(kind: str, args: dict) -> dict:
    """The inputs the step reads (jax.jit drops the others from its
    arguments): prefill reads no targets; decode reads neither the encoder's
    weights nor the cross-attention K/V projections (the caches hold their
    output)."""
    if kind == "prefill":
        return {**args, "batch": {k: v for k, v in args["batch"].items()
                                  if k not in ("targets", "loss_mask")}}
    if kind == "decode":
        return {**args, "params": {k: v for k, v in args["params"].items()
                                   if not k.startswith("encoder.")
                                   and not k.endswith((".cross.wk", ".cross.wv"))}}
    return args


def _fake_model(cfg: ModelConfig, params: dict):
    """``LM(cfg)`` on the host with its parameters swapped for ``params``."""
    from torch import nn

    from repro_torch.models.lm import LM

    model = LM(cfg, device="cpu")
    for name, value in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, leaf,
                nn.Parameter(value, requires_grad=False))
    return model


def census_cell(cfg: ModelConfig, shape: ShapeSuite, mesh, *, donate: bool = True) -> dict:
    """Run one cell's step on fake DTensors over ``mesh``; returns its
    per-device census: {"kind", "flops", "bytes", "collectives"
    (``CollectiveStats``), "memory_analysis", "lower_s", "compile_s",
    "fallbacks"}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.perf.census import StepCensus

    rules = rules_for_cell(cfg, shape, mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(rules), implicit_replication():
        cell = cell_step_and_specs(cfg, shape, zero_size=axis_sizes(mesh).get("data", 1))
        # the serving steps run under inference mode, so their inputs are made in it
        with torch.inference_mode(cell.kind != "train"):
            args = {k: map_axes(lambda ax, spec: _fake_leaf(spec, rules.placements(ax), mesh),
                                cell.axes[k], cell.specs[k]) for k in cell.specs}
            model = _fake_model(cfg, args["params"])
        arg_bytes = _local_bytes(_read_args(cell.kind, args))
        t_lower = time.perf_counter() - t0
        census = StepCensus()
        with census:
            if cell.kind == "train":
                metrics = cell.step(model, args["opt_state"], args["batch"])
                outputs = (args["params"], args["opt_state"], metrics)
                donated = (args["params"], args["opt_state"])
            elif cell.kind == "prefill":
                outputs = cell.step(model, args["batch"])
                donated = ()
            else:
                outputs = cell.step(model, args["token"], shape.seq_len - 1, args["caches"])
                donated = (args["caches"],)
        t_compile = time.perf_counter() - t0 - t_lower
        mem = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _local_bytes(outputs),
            "temp_size_in_bytes": census.peak_bytes,
            "alias_size_in_bytes": _local_bytes(donated) if donate else 0,
        }
    return {"kind": cell.kind, "flops": census.flops, "bytes": census.bytes,
            "collectives": census.collectives, "memory_analysis": mem, "lower_s": t_lower,
            "compile_s": t_compile, "fallbacks": dict(census.fallbacks)}


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    scan_layers: bool = True,
    donate: bool = True,
    overrides: dict | None = None,
    verbose: bool = True,
) -> dict:
    """Run one cell on the fake production mesh; return the dry-run record."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if not scan_layers:
        cfg = dataclasses.replace(cfg, scan_layers=False, unroll_attn_chunks=True)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    c = census_cell(cfg, shape, mesh, donate=donate)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": int(mesh.size()),
        "kind": c["kind"],
        "scan_layers": cfg.scan_layers,
        "lower_s": round(c["lower_s"], 2),
        "compile_s": round(c["compile_s"], 2),
        "flops_per_device": float(c["flops"]),
        "bytes_accessed_per_device": float(c["bytes"]),
        "memory_analysis": c["memory_analysis"],
        "collectives": c["collectives"].summary(),
    }
    if verbose:
        ma = record["memory_analysis"]
        print(
            f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} OK  "
            f"compile={record['compile_s']:7.1f}s  "
            f"args={ma.get('argument_size_in_bytes', 0)/2**30:7.2f}GiB  "
            f"temp={ma.get('temp_size_in_bytes', 0)/2**30:7.2f}GiB  "
            f"colls={sum(record['collectives']['counts'].values())}"
        )
        print(f"  memory_analysis: {ma}")
        print(f"  cost_analysis: flops={record['flops_per_device']:.3e} "
              f"bytes={record['bytes_accessed_per_device']:.3e} (per device)")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--out", type=str, default=None, help="directory for JSON records")
    ap.add_argument("--no-scan", action="store_true", help="unrolled (roofline accounting)")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for sh in shape_cells(get_config(arch)):
                cells.append((arch, sh.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    outdir = Path(args.out) if args.out else None
    if outdir:
        from repro_torch.obs import run_manifest

        outdir.mkdir(parents=True, exist_ok=True)
        # per-cell records stay lean; one provenance manifest covers the dir
        (outdir / "manifest.json").write_text(json.dumps(
            run_manifest(config={"mesh": args.mesh, "cells": len(cells)}), indent=2))

    failures = []
    for arch, shape_name in cells:
        for multi in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
            try:
                rec = run_cell(arch, shape_name, multi_pod=multi, scan_layers=not args.no_scan)
                if outdir:
                    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
            except Exception as e:  # noqa: BLE001 - every cell is tried; failures are listed
                failures.append((tag, repr(e)))
                print(f"[dryrun] {tag} FAILED: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print(f"\nall {len(cells) * len(meshes)} dry-run cells compiled OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
