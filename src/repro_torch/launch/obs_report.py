"""Observability report CLI: render traces + decision audits, or demo them.

The port of ``repro.launch.obs_report``, with the same flags and artifacts,
plus ``--device`` (default ``cuda``) for the demo's engine run. Two modes:

  # render saved observability streams into a markdown report (host only)
  PYTHONPATH=src python -m repro_torch.launch.obs_report \\
      --trace trace.jsonl --audit audit.jsonl --out report.md

  # self-contained worked example: a bandwidth-step gateway scenario plus a
  # simulated-clock engine run on --device, exporting every artifact
  PYTHONPATH=src python -m repro_torch.launch.obs_report --demo --out-dir obs_demo
  PYTHONPATH=src python -m repro_torch.launch.obs_report --demo --device cpu \\
      --out-dir "${TMPDIR:-/tmp}/obs"

``--demo`` writes into ``--out-dir``:

  * ``trace.jsonl``       — span stream (canonical JSONL, byte-stable per seed)
  * ``trace.chrome.json`` — Chrome trace_event export; load at
    https://ui.perfetto.dev to see the decide/transfer/queue/prefill/decode/
    respond lanes
  * ``audit.jsonl``       — per-decision closed-form term decompositions
  * ``manifest.json``     — run provenance (seed, config hash, git, versions)
  * ``report.md``         — the rendered report, flips explained term-by-term

The demo replays the paper's Fig. 6 arc: bandwidth steps 20 -> 10 -> 2 -> 20
Mbps while the gateway runs Algorithm 1 each epoch, so the audit log contains
real strategy flips for :func:`repro_torch.obs.explain_flip` to decompose.

The engine run is the measure harness on its simulated clock (the reduced
StarCoder2-3B at 2 slots), so ``trace.jsonl``, ``trace.chrome.json``,
``audit.jsonl`` and ``report.md`` are the same bytes on the card, on the CPU
and in the reference; ``manifest.json`` records this package's environment.
``--no-engine`` and render mode touch no device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.obs import (
    AuditLog,
    MetricsRegistry,
    Tracer,
    merge,
    render_report,
    run_manifest,
)
from repro_torch.device import resolve_device

__all__ = ["main", "run_demo"]

DEMO_SCHEDULE_MBPS = (20.0, 20.0, 10.0, 10.0, 2.0, 2.0, 2.0, 20.0, 20.0)


def _demo_gateway(tracer: Tracer, auditor: AuditLog, metrics: MetricsRegistry,
                  *, rps: float = 10.0) -> None:
    """Bandwidth-step scenario on the deployable gateway (model-only: the
    device tier is a declared profile, no engine needed for the decisions)."""
    from repro_torch.core.latency import ServiceModel, Tier, Workload
    from repro_torch.serving.gateway import EdgeHandle, OffloadGateway

    s_dev = 0.080  # 80 ms on-device service
    req_bytes = int(0.8 * s_dev * 0.625e6)  # bandwidth crossover near 5 Mbps
    gw = OffloadGateway(
        Tier("device", s_dev, service_model=ServiceModel.EXPONENTIAL),
        [EdgeHandle("edge0", service_mean_s=s_dev / 8, parallelism_k=4.0)],
        Workload(rps, req_bytes, max(1, req_bytes // 5)),
        bandwidth_Bps=2.5e6,
        auditor=auditor,
        tracer=tracer,
        metrics=metrics,
    )
    for i, mbps in enumerate(DEMO_SCHEDULE_MBPS):
        for _ in range(3):
            gw.observe_bandwidth(mbps * 1e6 / 8)
        n = max(1, int(rps))
        for k in range(n):
            gw.observe_arrival(i + k / n)
        gw.decide(now=i + 1.0)


def _demo_engine(tracer: Tracer, *, seed: int, n_requests: int, device) -> None:
    """Simulated-clock engine run on ``device``: fills the queue/prefill/
    decode/respond lanes with a real request lifecycle (seeded => byte-stable
    trace)."""
    from repro_torch.measure import HarnessConfig, run_harness

    hc = HarnessConfig(arch="starcoder2_3b", slots=2, seed=seed,
                       n_requests=n_requests, clock="simulated")
    run_harness(hc, device=device, tracer=tracer)


def run_demo(out_dir: Path, *, seed: int = 0, n_requests: int = 12,
             engine: bool = True, device=None) -> dict:
    """Produce the full demo artifact set; returns {artifact name: path}.
    The engine runs on ``device`` (default: the card)."""
    if engine:
        device = resolve_device(device)  # no card: raise before any artifact
    out_dir.mkdir(parents=True, exist_ok=True)
    gw_tracer = Tracer()
    auditor = AuditLog()
    metrics = MetricsRegistry()
    _demo_gateway(gw_tracer, auditor, metrics)
    tracers = [gw_tracer]
    if engine:
        eng_tracer = Tracer()
        _demo_engine(eng_tracer, seed=seed, n_requests=n_requests, device=device)
        tracers.append(eng_tracer)
    tracer = merge(tracers)
    auditor.verify()

    paths = {
        "trace.jsonl": tracer.write_jsonl(out_dir / "trace.jsonl"),
        "trace.chrome.json": tracer.write_chrome(out_dir / "trace.chrome.json"),
        "audit.jsonl": auditor.write_jsonl(out_dir / "audit.jsonl"),
    }
    manifest = run_manifest(seed=seed, config={
        "demo": True, "schedule_Mbps": list(DEMO_SCHEDULE_MBPS),
        "engine": engine, "n_requests": n_requests,
    })
    mpath = out_dir / "manifest.json"
    mpath.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    paths["manifest.json"] = mpath
    report = render_report(tracer=tracer, audit=auditor, metrics=metrics,
                           title="Observability demo (Fig. 6 bandwidth steps)")
    rpath = out_dir / "report.md"
    rpath.write_text(report)
    paths["report.md"] = rpath
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", type=Path, default=None,
                    help="span trace JSONL (Tracer.write_jsonl output)")
    ap.add_argument("--audit", type=Path, default=None,
                    help="decision audit JSONL (AuditLog.write_jsonl output)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the markdown report here (default: stdout)")
    ap.add_argument("--title", default="Observability report")
    ap.add_argument("--demo", action="store_true",
                    help="run the bandwidth-step demo and export all artifacts")
    ap.add_argument("--out-dir", type=Path, default=Path("obs_demo"),
                    help="demo artifact directory (default ./obs_demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12,
                    help="demo engine requests (default 12)")
    ap.add_argument("--no-engine", action="store_true",
                    help="demo: skip the engine run (gateway decisions only)")
    ap.add_argument("--device", default="cuda",
                    help="demo: the engine run's device, cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.demo:
        paths = run_demo(args.out_dir, seed=args.seed, n_requests=args.requests,
                         engine=not args.no_engine, device=args.device)
        for name, path in paths.items():
            print(f"wrote {path}")
        print(f"load {paths['trace.chrome.json']} at https://ui.perfetto.dev")
        return 0

    if args.trace is None and args.audit is None:
        ap.error("nothing to render: pass --trace and/or --audit, or --demo")
    tracer = Tracer.read_jsonl(args.trace) if args.trace else None
    audit = AuditLog.read_jsonl(args.audit) if args.audit else None
    report = render_report(tracer=tracer, audit=audit, title=args.title)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(report)
        print(f"wrote {args.out}")
    else:
        print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
