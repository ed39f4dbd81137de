"""Hardware-in-the-loop profiling CLI: profile / fit / validate.

The port's counterpart of ``repro.launch.measure``, with the same flags,
outputs, printouts and exit codes, plus ``--device`` (default ``cuda``: the
engine and the gate's batched closed forms run on the card).

  # run the engine under Poisson load, fit distributions, write a profile
  PYTHONPATH=src python -m repro_torch.launch.measure profile --config starcoder2_3b \\
      --slots 1 --requests 240 --seed 0 --out PROFILE_starcoder2_3b.json

  # refit a saved trace (e.g. after changing fit thresholds)
  PYTHONPATH=src python -m repro_torch.launch.measure fit --trace TRACE.json --out PROFILE.json

  # gate analytic mean/p99 against the observed engine latencies
  PYTHONPATH=src python -m repro_torch.launch.measure validate --profile PROFILE.json

  # the smoke gate on the CPU (reduced model), and the full-width model on the card
  PYTHONPATH=src python -m repro_torch.launch.measure validate --device cpu \\
      --report-out "${TMPDIR:-/tmp}/M.json"
  PYTHONPATH=src python -m repro_torch.launch.measure validate --config starcoder2_3b \\
      --full-config

Profiling runs are seeded and (on the default simulated clock) bit-replayable:
the same command produces the same profile JSON, on the card or the CPU, and
the same trace as the reference's. ``--clock wall`` times the real hardware
instead. ``validate`` exits nonzero when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.measure import (
    HarnessConfig,
    MeasuredTrace,
    build_profile,
    load_profile,
    run_harness,
)
from repro_torch.obs import run_manifest
from repro_torch.validate.measured import (
    DEFAULT_MEASURED_BUDGET_PCT,
    DEFAULT_MEASURED_TAIL_BUDGET_PCT,
    run_measured_gate,
)

__all__ = ["main"]


def _print_profile(profile) -> None:
    print(f"profiled {profile.arch} ({profile.clock} clock, seed {profile.seed}): "
          f"{profile.n_requests} requests, slots={profile.slots}, "
          f"lambda={profile.arrival_rate:.2f} req/s")
    print(f"  observed: mean latency {profile.observed_stat('latency_mean_s')*1e3:.3f} ms, "
          f"p99 {profile.observed_stat('latency_p99_s')*1e3:.3f} ms, "
          f"rho_hat {profile.observed_stat('rho_hat'):.3f}")
    print("  fits (phase, occupancy): mean / SCV / model")
    for f in profile.fits:
        print(f"    {f.phase:8s} occ={f.occupancy}  n={f.n:4d}  "
              f"{f.mean_s*1e3:9.4f} ms  scv={f.scv:6.3f}  {f.model.value}  "
              f"(CI ±{f.ci_half_width_pct:.1f}%)")


def _print_gate(rep) -> None:
    d = rep.to_dict()
    m, t, v = d["mean"], d["tail"], d["vec"]
    print(f"measured gate: {rep.arch} occ={rep.occupancy} rho={rep.rho:.3f} "
          f"({rep.n_requests} requests, {rep.clock} clock)")
    print(f"  mean:  analytic {m['analytic_s']*1e3:.3f} ms vs observed "
          f"{m['observed_s']*1e3:.3f} ms -> MAPE {m['mape_pct']:.2f}% "
          f"(budget {m['budget_pct']:.1f}%, CI floor ±{m['ci_half_width_pct']:.1f}%) "
          f"-> {'PASS' if m['passed'] else 'FAIL'}")
    print(f"  p{t['pct']:g}:   analytic {t['analytic_s']*1e3:.3f} ms vs observed "
          f"{t['observed_s']*1e3:.3f} ms -> MAPE {t['mape_pct']:.2f}% "
          f"(budget {t['budget_pct']:.1f}%) -> {'PASS' if t['passed'] else 'FAIL'}")
    print(f"  fleet.analytic_vec consistency: rel err {v['rel_err']:.2e} "
          f"(tol {v['tol']:.0e}) -> {'PASS' if v['passed'] else 'FAIL'}")
    print(f"overall: {'PASS' if rep.passed else 'FAIL'}")


def _add_profile_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", "--arch", dest="arch", default="starcoder2_3b",
                    help="model-zoo config to profile (default starcoder2_3b)")
    ap.add_argument("--slots", type=int, default=1,
                    help="engine decode slots / target batch occupancy (default 1)")
    ap.add_argument("--requests", type=int, default=240,
                    help="recorded requests (default 240)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clock", choices=("simulated", "wall"), default="simulated",
                    help="simulated = seeded cost-model clock (replayable); "
                         "wall = real hardware timing")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="lambda in req/s (default: derived from --target-rho)")
    ap.add_argument("--target-rho", type=float, default=0.45,
                    help="target utilisation when deriving lambda (default 0.45)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prompt-jitter", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--geometric-p", type=float, default=0.35,
                    help="geometric output-length parameter (0 = fixed length)")
    ap.add_argument("--full-config", action="store_true",
                    help="profile the full-size config (default: reduced CPU proxy)")
    ap.add_argument("--trace-out", type=Path, default=None,
                    help="also save the raw trace JSON")
    ap.add_argument("--out", type=Path, default=None,
                    help="profile path (default results/PROFILE_<arch>.json)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the batched closed forms run: cuda "
                         "(default) or cpu")


def _harness_config(args) -> HarnessConfig:
    return HarnessConfig(
        arch=args.arch,
        slots=args.slots,
        reduced=not args.full_config,
        clock=args.clock,
        seed=args.seed,
        n_requests=args.requests,
        arrival_rate=args.arrival_rate,
        target_rho=args.target_rho,
        prompt_len=args.prompt_len,
        prompt_len_jitter=args.prompt_jitter,
        max_new_tokens=args.max_new,
        new_tokens_geometric_p=args.geometric_p,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_prof = sub.add_parser("profile", help="run the engine and write a MeasuredProfile")
    _add_profile_args(p_prof)

    p_fit = sub.add_parser("fit", help="refit a saved trace into a MeasuredProfile")
    p_fit.add_argument("--trace", type=Path, required=True)
    p_fit.add_argument("--seed", type=int, default=0, help="bootstrap seed")
    p_fit.add_argument("--out", type=Path, default=None,
                       help="profile path (default results/PROFILE_<arch>.json)")

    p_val = sub.add_parser("validate", help="gate analytic vs observed latencies")
    p_val.add_argument("--profile", type=Path, default=None,
                       help="saved MeasuredProfile JSON (default: profile in-process "
                            "with the default smoke harness)")
    _add_profile_args(p_val)
    p_val.add_argument("--occupancy", type=int, default=None,
                       help="request-fit occupancy to gate (default: dominant)")
    p_val.add_argument("--budget", type=float, default=DEFAULT_MEASURED_BUDGET_PCT,
                       help=f"mean MAPE budget %% (default {DEFAULT_MEASURED_BUDGET_PCT})")
    p_val.add_argument("--tail-budget", type=float,
                       default=DEFAULT_MEASURED_TAIL_BUDGET_PCT,
                       help="p99 MAPE budget %% "
                            f"(default {DEFAULT_MEASURED_TAIL_BUDGET_PCT})")
    p_val.add_argument("--report-out", type=Path,
                       default=Path("results/VALIDATION_measured.json"),
                       help="gate report path (default ./VALIDATION_measured.json)")

    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    if args.cmd == "profile":
        hc = _harness_config(args)
        trace = run_harness(hc, device=args.device)
        if args.trace_out is not None:
            trace.save(args.trace_out)
            print(f"wrote {args.trace_out}")
        profile = build_profile(trace, seed=args.seed,
                                manifest=run_manifest(seed=hc.seed,
                                                      config=hc.to_dict()))
        out = args.out or Path(f"results/PROFILE_{profile.arch}.json")
        profile.save(out)
        _print_profile(profile)
        print(f"wrote {out} in {time.perf_counter() - t0:.1f}s")
        return 0

    if args.cmd == "fit":
        trace = MeasuredTrace.load(args.trace)
        profile = build_profile(trace, seed=args.seed,
                                manifest=run_manifest(seed=trace.harness.seed,
                                                      config=trace.harness.to_dict()))
        out = args.out or Path(f"results/PROFILE_{profile.arch}.json")
        profile.save(out)
        _print_profile(profile)
        print(f"wrote {out}")
        return 0

    # validate
    if args.profile is not None:
        profile = load_profile(args.profile)
    else:
        hc = _harness_config(args)
        trace = run_harness(hc, device=args.device)
        profile = build_profile(trace, seed=args.seed,
                                manifest=run_manifest(seed=hc.seed,
                                                      config=hc.to_dict()))
        if args.out is not None:
            profile.save(args.out)
            print(f"wrote {args.out}")
    rep = run_measured_gate(profile, occupancy=args.occupancy,
                            budget_pct=args.budget,
                            tail_budget_pct=args.tail_budget,
                            device=args.device)
    d = rep.to_dict()
    # run provenance rides along with every gate report: the profile's own
    # manifest when it has one (a loaded artifact keeps its origin), else
    # this process's
    d["manifest"] = dict(profile.manifest) if profile.manifest is not None \
        else run_manifest(seed=args.seed)
    args.report_out.parent.mkdir(parents=True, exist_ok=True)
    args.report_out.write_text(json.dumps(d, indent=2) + "\n")
    _print_gate(rep)
    print(f"wrote {args.report_out} in {time.perf_counter() - t0:.1f}s")
    return 0 if rep.passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
