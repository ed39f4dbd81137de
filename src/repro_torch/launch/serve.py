"""Serving launcher CLI: engine + Poisson workload + Algorithm-1 gateway.

The port of ``repro.launch.serve``. The engine half: a model at full width
(random weights from seed 0) serves ``--requests`` requests arriving at
``--rps`` on the CUDA card, through the port's RMSNorm, flash-attention and
decode-attention kernels, and for a hybrid model (jamba) its selective-scan
kernel; gemma2's local layers decode from a ring of W slots through the
same decode kernel, and xLSTM runs its recurrent cells in plain torch
around the RMSNorm kernels. ``--reduced`` swaps in the tiny same-family config the CPU tests use.
``--superblocks N`` keeps the first N superblocks at full width, a depth cut
for a model that one card cannot hold (the override of the reference's
``launch/perf_probe.py``). An encoder-decoder (``seamless_m4t_large_v2``)
is refused with the engine's message (ROADMAP C11).

The gateway half: the engine's profiled service (mean over its warm prefill
and decode calls, paper §4.2) becomes the device tier of the offload
gateway, which replays the ``--schedule`` of bandwidths (Mbps, one epoch
each) and prints each epoch's decision from its audit row, the audit's
re-sum check, the switch count and the metrics, as the reference prints
them. The gateway is host code: it launches nothing on the card.

Arrivals are replayed on the engine clock: a request is admitted once the
clock passes its arrival, the clock advances by each measured service time,
and an idle engine jumps to the next arrival. Latency is therefore queue
wait plus measured service.

Each slot's cache holds the longest prompt the workload can draw plus its
new tokens, rounded up to a multiple of 64, unless ``--max-seq`` sets it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --requests 16 --rps 20 --prompt-len 256 --prompt-jitter 64 --max-new 32 --slots 4 \
      --schedule 20,10,2,20
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b --superblocks 2 \
      --requests 8 --rps 4 --prompt-len 256 --prompt-jitter 64 --max-new 16 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b --requests 8 --rps 2 \
      --prompt-len 4608 --prompt-jitter 256 --max-new 32 --slots 4 --max-seq 4928
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1_3b --requests 8 --rps 4 \
      --prompt-len 256 --prompt-jitter 64 --max-new 16 --slots 4 --max-seq 384
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1_3b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.latency import ServiceModel, Tier, Workload
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.obs import AuditLog, MetricsRegistry, format_decision
from repro_torch.serving.engine import Engine, Request, ServeConfig
from repro_torch.serving.gateway import EdgeHandle, OffloadGateway
from repro_torch.serving.workload import PoissonWorkload, WorkloadConfig

__all__ = ["replay", "summarize", "gateway_epochs", "run", "main"]

_EPS = 1e-12
SEQ_ALIGN = 64  # cache capacity per slot is a multiple of this


def replay(engine: Engine, requests: list[Request]) -> float:
    """Serve ``requests`` (sorted by arrival) on the engine clock; returns the
    clock when the last request completes."""
    t, i, n = 0.0, 0, len(requests)
    while i < n or engine.queue or any(r is not None for r in engine.active):
        while i < n and requests[i].arrival_s <= t + _EPS:
            engine.submit(requests[i])
            i += 1
        if not engine.queue and not any(r is not None for r in engine.active):
            t = requests[i].arrival_s  # idle: jump to the next arrival
            continue
        k0 = len(engine.service_log)
        engine.tick(now=t)
        t += sum(ev.duration_s for ev in engine.service_log[k0:])
    return t


def summarize(engine: Engine) -> dict:
    """End-to-end numbers of a replay: latency on the engine clock, mean
    service per phase, output tokens per second of busy time, and the
    model's decode steps on the card by graph replay and eager."""
    lat = np.array([r.latency_s for r in engine.completed if r.latency_s is not None])
    warm = [ev for ev in engine.service_log if not ev.compile]
    prefill = [ev.duration_s for ev in warm if ev.phase == "prefill"]
    decode = [ev.duration_s for ev in warm if ev.phase == "decode"]
    busy = sum(ev.duration_s for ev in engine.service_log)
    tokens = sum(len(r.tokens_out) for r in engine.completed)
    return {
        "device": str(engine.device),
        "requests_done": len(engine.completed),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else None,
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else None,
        "prefill_ms_mean": float(np.mean(prefill) * 1e3) if prefill else None,
        "decode_step_ms_mean": float(np.mean(decode) * 1e3) if decode else None,
        "prefills": len(prefill),
        "decode_steps": len(decode),
        "tokens_out": tokens,
        "tokens_per_s_busy": tokens / busy if busy > 0 else None,
        "decode_graph_steps": engine.model.decode_graph_steps,
        "decode_eager_steps": engine.model.decode_eager_steps,
    }


def _fmt(x: float | None) -> str:
    return "n/a" if x is None else f"{x:.3f}"


def gateway_epochs(s_dev: float, rps: float, schedule, *, auditor, metrics,
                   tracer=None) -> OffloadGateway:
    """Algorithm 1 over a bandwidth ``schedule`` (Mbps, one epoch each) for a
    device tier whose exponential service has the profiled mean ``s_dev``,
    against one edge 8x faster with 4 servers; prints one line per epoch
    (rendered FROM the audit log, so the console and the machine-readable
    trail cannot disagree), verifies the audit, and prints the switches and
    the metrics. Returns the gateway."""
    dev = Tier("device-engine", s_dev, service_model=ServiceModel.EXPONENTIAL)
    # payloads scaled to the profiled service: the schedule's bandwidth
    # crossover lands near 5 Mbps regardless of machine speed
    req_bytes = max(1, int(0.8 * s_dev * 0.625e6))
    gw = OffloadGateway(
        dev,
        [EdgeHandle("edge0", service_mean_s=s_dev / 8, parallelism_k=4.0)],
        Workload(rps, req_bytes, max(1, req_bytes // 5)),
        bandwidth_Bps=2.5e6,
        auditor=auditor,
        tracer=tracer,
        metrics=metrics,
    )
    for i, mbps in enumerate(schedule):
        for _ in range(3):
            gw.observe_bandwidth(mbps * 1e6 / 8)
        for dt in np.arange(0.0, 1.0, 1.0 / max(rps, 1.0)):
            gw.observe_arrival(i + dt)
        gw.decide(now=i + 1.0)
        print(format_decision(auditor.rows[-1]))
    auditor.verify()  # terms must re-sum to the decision totals
    print(f"[gateway] switches={gw.switches}")
    for line in metrics.render().splitlines():
        print(f"[metrics] {line}")
    return gw


def run(argv=None) -> tuple[Engine, OffloadGateway]:
    """Parse the command line, serve the stream, print the summary, run the
    gateway over the profiled service and return ``(engine, gateway)`` (the
    engine's completed requests and service log; the gateway's decisions,
    audit rows in ``gateway.manager.auditor`` and metrics in
    ``gateway.metrics``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default="starcoder2_3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rps", type=float, default=20.0)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--prompt-jitter", type=int, default=0,
                    help="prompt lengths are uniform in prompt-len +/- this")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache capacity per slot (default: what the workload needs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU tests) instead of full width")
    ap.add_argument("--superblocks", type=int, default=None,
                    help="serve only the first N superblocks (a depth cut; widths unchanged)")
    ap.add_argument("--schedule", type=str, default="20,10,2,20",
                    help="bandwidth schedule in Mbps, one epoch each")
    args = ap.parse_args(argv)
    try:
        schedule = [float(x) for x in args.schedule.split(",")]
    except ValueError:
        ap.error(f"--schedule {args.schedule!r} is not a comma-separated list of Mbps")
    # the furthest shared decode position is the longest prompt plus its new tokens
    need = args.prompt_len + args.prompt_jitter + args.max_new + 1
    max_seq = args.max_seq or -(-need // SEQ_ALIGN) * SEQ_ALIGN
    if max_seq < need:
        ap.error(f"--max-seq {max_seq} does not hold a {args.prompt_len + args.prompt_jitter}"
                 f"-token prompt and {args.max_new} new tokens")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(seq_chunk=8)
    n_sb = cfg.num_superblocks
    if args.superblocks is not None:
        if not 1 <= args.superblocks <= n_sb:
            ap.error(f"--superblocks {args.superblocks} outside 1..{n_sb} for {cfg.name}")
        cfg = dataclasses.replace(cfg, num_superblocks=args.superblocks)
    device = resolve_device(args.device)
    model = LM(cfg, device=device)
    try:
        engine = Engine(cfg, model, ServeConfig(slots=args.slots, max_seq=max_seq), device=device)
    except NotImplementedError as exc:  # an encoder-decoder (ROADMAP C11)
        ap.error(str(exc))
    requests = PoissonWorkload(WorkloadConfig(
        arrival_rate=args.rps, prompt_len=args.prompt_len,
        prompt_len_jitter=args.prompt_jitter, max_new_tokens=args.max_new,
        vocab=cfg.vocab_size,
    )).take(args.requests)
    engine.warmup(sorted({len(r.prompt) for r in requests}))
    replay(engine, requests)
    s = summarize(engine)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} ({model.num_params():,} params, {cfg.dtype}; superblocks: "
          f"{cfg.num_superblocks} of {n_sb}) on {name}, {args.slots} slots of {max_seq} positions")
    print(f"[serve] {s['requests_done']} requests done; latency p50 {_fmt(s['latency_p50_ms'])} "
          f"ms, p99 {_fmt(s['latency_p99_ms'])} ms")
    print(f"[serve] prefill {_fmt(s['prefill_ms_mean'])} ms mean over {s['prefills']}; "
          f"decode step {_fmt(s['decode_step_ms_mean'])} ms mean over {s['decode_steps']}; "
          f"{_fmt(s['tokens_per_s_busy'])} tokens/s of busy time; on the card "
          f"{s['decode_graph_steps']} decode steps replayed as graphs, "
          f"{s['decode_eager_steps']} eager")

    s_dev, var = engine.observed_service_stats()
    print(f"[serve] profiled service {s_dev * 1e3:.3f} ms (var {var:.2e}); device tier rho "
          f"{args.rps * s_dev:.3f} at {args.rps:g} rps")
    gw = gateway_epochs(s_dev, args.rps, schedule, auditor=AuditLog(),
                        metrics=MetricsRegistry())
    return engine, gw


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
