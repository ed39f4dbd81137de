#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card (H100).

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases; any failure exits non-zero before the result lines are printed:
  1. build: compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source, all
     started together) and print ptxas' register / shared-memory report;
  2. check: every kernel against its plain PyTorch version on the card, on the
     same inputs, at the slice's shapes and edge cases (RMSNorm and the fused
     add + RMSNorm at StarCoder2's and jamba's widths, whose s is torch's add
     and whose y is bit-equal to the RMSNorm kernel on that s; ragged prompts,
     Sq < Skv, window + softcap, every head dim, jamba's G = 4 shapes, decode
     at pos 700 of 1024, the measure phase's shapes (prompts of 1, 6, 8 and
     10 tokens; one slot of 64 positions at pos 0, 5 and 15), garbage past
     pos, G = 32, more (b, kv head) pairs
     than SMs, a CUDA-graph replay of decode equal to the eager call;
     Lindley scans bit for bit in float64 and float32 at B = 1, ragged B and T,
     zero services, arrival ties, the ring's edges (T of 1, TILE - 1, TILE,
     TILE + 1, STAGES * TILE + 1 at B of 1, 31, 33), k-server rows of mixed
     k at every instantiation (k_max 1, 4, 9, 64), a CUDA-graph replay, and
     the fleet path's (4096, 120000) float64; the decision scan bit for bit
     at the cluster's (120, 64, 5) and (600, 2048, 129), float64 and float32,
     every stagger in {1, 3, 8} with every hysteresis in {0, 0.15, 0.3},
     ragged N, NaN / +inf / tied columns, the ring's edges (T around its
     stages with odd N * (E+1), E+1 from 1 to 300 at N = 2047), a CUDA-graph
     replay, and the closed loop's one-epoch entry; the
     selective scan at jamba's full-width prefill (1, 241, 8192, 16) from
     zeros and decode step (4, 1, 8192, 16) from a random state, ragged T and
     D, N of 1, 4, 7 and 16 (N / G ragged, N < G), rows off 16 bytes, T of 1,
     33 and 241, B and C as strided slices of one x_proj output, each case
     also through every neighbour of its plan: G of 4, 8, 16 lanes per
     channel, y reduced by shuffles each step or reduce-scattered G steps
     at a time); gemma2's hd-256 attention with q drawn past the soft-cap of
     50 and held also by rel-L2 over blocks of rows (flash over 4864 tokens
     with the 4096 window, without it, and over a ragged 4353; decode for 4
     slots on a 4096-slot ring at pos 4095, 4096 and 4700 and on a 4928-slot
     cache at pos 4700), each beside planted faults the check must refuse
     (the kernel with no cap; with the window one key wider; the plain
     attention capping after the mask), and RMSNorm at gemma2's and xLSTM's
     widths (d 3584 and 2048); seamless's hd-64 attention (16 on 16): flash
     unmasked over (4, 1500) and a ragged (1, 613), cross prefill (4, 2 on
     1500), (1, 37 on 613) and more queries than keys (2, 300 on 100), a
     causal or windowed Sq > Skv refused, decode over 4 x 1500 frames at
     pos 1499 and 612;
  3. time: each kernel's device time per call (CUDA-graph replay between CUDA
     events; StarCoder2's and jamba's attention shapes) beside its plain
     version, one PyTorch library call for the same
     function (a yardstick the port never calls; for the Lindley scan, which
     no single call computes, the cumsum/cummax identity instead; for the
     decision scan ``torch.argmin(costs, -1) - 1``, the same function at
     h = 0 and stagger 1, also at one epoch; for the selective scan none) and
     its bound max(bytes / 3.35 TB/s, operations / peak rate); and its eager
     time per call from Python, host overhead included; besides, the Lindley
     recursion alone from shared memory (its chain floor), the k-server
     entry beside its own bound, and the decision scan's launch plan beside
     its neighbours (epochs per step, lanes per client, clients per CTA), the
     RMSNorm plan's (threads per row, rows per CTA) and the selective scan's
     (lanes per channel, the y reduction, steps per tile), the host time of
     the RMSNorm and scan planners per call, and the
     card's per-launch floor (a one-element elementwise op); then gemma2's
     attention at the serve_local cell's shapes (flash over 4608 tokens,
     causal and windowed; decode at pos 4700 on the append cache and the
     ring) beside SDPA (no soft-cap) and a compiled flex_attention with the
     soft-cap, where it builds; then seamless's (hd 64): flash unmasked over
     the encoder's (4, 1500) and a cross prefill (4, 2 on 1500), decode on
     4 x 1500 cross frames and a 66-slot self cache at pos 34, beside SDPA;
  4. serve: StarCoder2-3B at full width (bf16, random weights from seed 0)
     serving 16 Poisson requests through the serving CLI's own path
     (``repro_torch.launch.serve.run``), with the launch counters reset just
     before and read just after (2 rmsnorm and 2L - 1 fused add + rmsnorm
     launches per prefill, 1 and 2L per decode step); the same call then runs
     the offload gateway (Algorithm 1) over the profiled service and the
     20, 10, 2, 20 Mbps schedule, before the counts are read (so it adds no
     launch): every epoch's decision line, s_dev and rps * s_dev logged, the
     audit's re-sum check and each choice the argmin of its audited totals
     gated, the Fig. 6 row reported; then the tracer's cost on the warmed
     engine (12 requests of 8 + 8 tokens, no / disabled / enabled tracer
     interleaved, best of 5: the disabled tracer records no span and the
     enabled one exactly 3 per request plus 1 per decode step; the overheads
     reported beside the 5% budget); then the served model's
     kernel-path logits held against its plain path, and profiler traces of
     decode steps and prefills (device time, device operations per call);
  4b. serve_hybrid: the StarCoder engine freed, then jamba (mamba + MoE) at
     full width with 2 of its 4 superblocks (16 of 32 layers: 103 GB of bf16
     weights do not fit 80 GB) serving 8 Poisson requests through the same
     CLI path, launch counts reset just before and read just after (14
     selective-scan launches per prefill and per decode step), its gateway
     epochs checked as the serve phase's; its kernel
     path held against its plain path, and a profiler trace of decode steps;
  4c. serve_local: gemma2-9B at full width (42 layers, nothing cut) serving 8
     Poisson requests of 4352-4864 tokens (every one past the 4096 window:
     each prefill masks the window and rolls the local layers' rings, each
     decode step writes past the wrap) through the same CLI path, launch
     counts reset just before and read just after (the dense model's: 2 +
     83 + 42 flash per prefill, 1 + 84 + 42 decode per step); its gateway
     epochs checked; its logits on a 4353-token prompt and 4 decode steps
     gated above the model's rounding noise: the kernel path's rel-L2 to the
     plain path in float32 at most 1.5 times the plain bf16 path's, which a
     control (the norms' sums reordered) must pass and two planted faults (a
     full ring read as an append cache; local prefill without the window)
     must fail; a profiler trace of
     decode steps at pos 4700 against the step's floor (weights and K/V
     reads);
  4d. serve_xlstm: xLSTM-1.3B at full width (48 blocks, nothing cut) serving 8
     Poisson requests through the same path, launch counts exact (50 + 47
     per prefill, 49 + 48 per decode step: no FFN, so no norm2, and a head
     norm per cell), gateway, its logits over a prefill and 4 decode steps
     gated in float32 (kernel path against plain path, rel-L2 1e-3, which
     the control must pass and norms storing through bf16 must fail; the
     bf16 paths' difference reported), and a profiler trace of decode steps
     against the floor (weights and the mLSTM states read and written);
  4e. encdec: seamless-M4T-large-v2 at full width (24 + 24 layers, 2.03 B
     parameters, nothing cut) through ``LM.encode``, ``LM.prefill(...,
     enc_embeds=)`` and ``LM.decode_step`` (the engine refuses an
     encoder-decoder, as the reference's cannot serve one: ROADMAP C11):
     4 utterances of 1500 stub frames (30 s at 50 frames/s) with 2-token
     prompts and 64 greedy steps, then one of 613 frames and 4 steps, launch
     counts reset just before and read just after and exact (per prefill 72
     flash, 3 rmsnorm, 119 fused; per step 48 decode, 1 and 72), ids past
     the vocabulary counted (C6); encode + prefill and decode steps timed
     and profiled beside their floors, peak memory; the logits gate of
     serve_local over 1500 frames (kernel path within 1.5x the plain bf16
     path's error against the fp32 plain path; the control passes; rotary
     on the cross-attention, a causal encoder and cross decode over half
     the frames must fail);
  5. fleet: the fleet path at its users' sizes, counters reset just before and
     read just after: ``repro_torch.launch.fleet_sweep.run_sweep`` over a
     131,072-row grid with bandwidth crossovers (spot rows held against the
     scalar closed forms), ``simulate_fleet`` on 4,096 rows x 120,000 jobs on
     the device and through edge[0] (one and three Lindley launches; steady
     means within 5% MAPE of the closed forms) and through an edge of 1..4
     servers (two launches and one k-server launch), and differential gates
     1-3 on the golden corpus' smoke subset;
  6. cluster: the closed-loop cluster path, counters reset just before and
     read just after: the 64-client / 4-edge acceptance cluster
     (``solve_equilibrium`` within 20 iterations, one decision-scan launch
     per synchronous step, every edge at rho <= 0.9; ``cross_check_equilibrium``
     at 60,000 jobs, gated max MAPE <= 5%; ``simulate_cluster`` on the
     120-epoch bandwidth-step trace, exactly 120 launches, adaptive <= every
     static with no saturated epoch), then a city-scale pool (the four edge
     tiers x 32 = 128 edges, 2,048 clients, 600 one-second epochs, exactly 600
     launches) whose choices are held against the same run through the plain
     decision function, and a profile of that call;
  7. tails: the batched tails and the SLO cluster, counters reset just before
     and read just after: ``fleet_tail`` at p99 over the fleet phase's
     131,072-row grid by Euler and by the asymptote, a seeded sample of 512
     rows held against the scalar ``analytic_tail`` (1e-8 / 1e-6, the same
     sample through the CPU beside it); the asymptote on the shared-pole
     (C2) cases, which take the Euler path (1e-8); differential gates 1-5 on
     the smoke subset (gate 3's and 4's simulations one Lindley launch per
     station, gate 5's exact solves one decision-scan launch per synchronous
     step, both counts exact); the 64 x 4 acceptance cluster in SLO mode
     (q = 0.99, asymptote: the equilibrium within 20 iterations and its
     choices equal to the CPU solve's, the 120-epoch closed loop with exactly
     120 launches and no saturated epoch; ``adaptive_wins`` is reported, not
     gated: on this trace the reference's SLO loop loses to on-device too,
     as ``tests/test_torch_cluster.py`` shows on the reference's counts);
     the city pool in SLO mode (adaptive only, 300 epochs, exactly one launch
     per epoch); profiles of the sweep's asymptote and of SLO city epochs;
  8. meanfield_plan: ``cluster_sim --meanfield --clients 1000000`` (converged,
     adaptive undercuts every static price), ``provision`` at its default
     space for 48 clients at p99 <= 120 ms by Euler (the plan equal to the
     same call on the CPU), and ``launch/validate.py --smoke`` (exit 0);
  9. measure: the measurement harness (``repro_torch.measure``) and the
     measured gate, three runs: the reduced StarCoder2-3B on the simulated
     clock on the card and on the CPU (the traces bit-equal, the profiles
     equal); ``launch/measure.py validate --config starcoder2_3b
     --full-config`` (240 Poisson requests at one slot, simulated clock: exit
     0, the launch counts exact for warmup plus the recorded prefills and
     decode steps); the same harness at full width on the wall clock (every
     fit finite, the batched cross-check within 1e-6, the counts exact with
     the 8 calibration requests; its mean and p99 MAPE printed beside the 15%
     and 35% budgets, not gated);
 10. obs: the 64 x 4 acceptance closed loop with a tracer (one decide span
     per epoch, offloaded = the choices' row sums; the decision-scan launches
     and the results equal to the same call without one), ``audit_cluster``
     over 8 epochs x 8 clients on the card (re-sum check; the targets and
     terms equal the CPU's to 1e-9), and ``obs_report --demo --device cuda``
     (its trace, Chrome export, audit and report byte for byte the
     ``--device cpu`` run's; the reduced engine's launch counts exact);
 11. report: one ``kernels`` JSON line (all six kernels and the fused RMSNorm
     entry; the serving kernels also with their launches in the measure
     phase's full-width simulated run, in serve_local and in encdec, the
     RMSNorm entries in serve_xlstm, flash and decode with their gemma2 and
     seamless timing rows, and they
     and the decision scan with their launches in the obs phase), the card's
     name and power limit as nvidia-smi gives them, and the final
     ``{"ok": true, ...}`` line.
Everything it measures also goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 tensor-core and
# fp32 / fp64 CUDA-core operations/s
HBM_BPS = 3.35e12
BF16_OPS = 989e12
FP32_OPS = 67e12
FP64_OPS = 34e12  # float64 outside the tensor cores (NVIDIA data sheet, H100 SXM)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # outputs round to bf16 at different points
# decode attention accumulates in fp32 and rounds p to bf16 where the plain
# version does (before P V), then the output once; its bf16 error on the card
# was 7.8e-3 at most (one bf16 step of an output between 1 and 2)
DECODE_BF16_TOL = dict(atol=8e-3, rtol=1e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)  # same arithmetic, other summation order
# gemma2's attention cases draw q at 40x: at hd 256 the scaled scores then
# have a standard deviation of 40 and a fifth of them pass the soft-cap of 50,
# so the cap shapes every row, and each output row is carried by a few keys
# and stays of order 1 (with q ~ N(0, 1) the scores sit far below the cap and
# a row past the first few hundred averages ~1,500 keys to |out| ~ 0.03, the
# size of BF16_TOL's atol). Such outputs are also held by their rel-L2 over
# blocks of 64 query rows of one head (each row in decode): the kernels read
# 3.1e-3 to 3.6e-3, the subtlest planted fault (the window one key wider)
# 3.6e-2, the kernel with no cap 6.6 (an H100 80GB HBM3 at 700 W), so 1e-2
CAP_Q_SCALE = 40.0
CAP_REL_L2 = 1e-2
# kernel-path vs plain-path logits of the full 30-layer bf16 model: bf16
# rounding of attention outputs compounds over 30 residual layers
LOGITS_REL_L2 = 3e-2
# the selective scan: y is rounded once to bf16 by kernel and plain loop alike,
# so they differ by one bf16 step (at most 2^-7 of |y|) where fp32 sums over N
# in another order fall on either side of a rounding boundary, plus that
# order difference itself (16 terms up to ~10 at 2^-24 each, with margin);
# the fp32 state to 1e-5 (exp and multiply-adds, contracted into FMAs here)
SCAN_Y_BF16_TOL = dict(atol=1e-4, rtol=2**-7)
SCAN_H_TOL = dict(atol=1e-5, rtol=1e-5)
# H100 SXM special-function units: 16 results per clock per SM (CUDA C++
# programming guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost clock: the rate of expf's exponentials
MUFU_OPS = 16 * 132 * 1.98e9
# jamba's full-width cut: 2 of 4 superblocks, 8 Poisson requests at 4 rps,
# prompts 256 +/- 64, 16 new tokens, 4 slots of 512 positions
HYBRID_ARGV = ["--arch", "jamba_v0_1_52b", "--superblocks", "2", "--requests", "8",
               "--rps", "4", "--prompt-len", "256", "--prompt-jitter", "64", "--max-new", "16",
               "--slots", "4", "--max-seq", "512", "--device", "cuda"]
# kernel-path vs plain-path logits of the 16-layer bf16 hybrid, the plain
# path routed to the experts the kernel path chose: the same bf16 rounding
# as the dense model's, over 16 layers (14 of them scans that round y once)
HYBRID_LOGITS_REL_L2 = 3e-2

FAILURES: list[str] = []
RESULT: dict = {}
COUNTED: list = []  # every kernel wrapper with a launch counter (filled by main)
STARTED = time.perf_counter()

# the fleet path's sizes: the acceptance sweep of tests/test_fleet.py (131,072
# rows) and the reference's full differential-gate run length (base_n 120,000)
SWEEP_AXES = {"network.bandwidth_Bps": ("geom", 1e5, 1e8, 512),
              "workload.arrival_rate": ("lin", 0.5, 30.0, 256)}
SIM_ROWS, SIM_JOBS = 4096, 120_000
SIM_MAPE_BUDGET_PCT = 5.0
# the cluster path's sizes: the reference's 64 x 4 acceptance cluster and
# 120-epoch trace (tests/test_cluster.py:204,300,324), and a city-scale pool:
# default_cluster's four edge tiers x 32, 2,048 clients (16 per edge, the
# acceptance ratio), 600 one-second epochs of the CLI's bandwidth walk
ACCEPT_CLIENTS, ACCEPT_EPOCHS = 64, 120
CITY_REPEAT, CITY_CLIENTS, CITY_EPOCHS, CITY_STAGGER = 32, 2048, 600, 8
DECISION_SHAPES = ((ACCEPT_EPOCHS, ACCEPT_CLIENTS, 5),
                   (CITY_EPOCHS, CITY_CLIENTS, 4 * CITY_REPEAT + 1))
# the tail path's sizes: p99, the fleet sweep's grid, a 512-row sample held
# against the scalar tail; the SLO city pool cut to 300 of the mean-mode
# city's 600 epochs (600 took 112 s on the card, past the 90 s this run may
# take alone), clients and edges whole
TAIL_Q, TAIL_SAMPLE = 0.99, 512
CITY_SLO_EPOCHS = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def end_phase(name: str) -> None:
    if FAILURES:
        fail(f"phase {name}: " + "; ".join(FAILURES))
    RESULT.setdefault("phase_end_s", {})[name] = time.perf_counter() - STARTED
    log(f"[smoke] phase {name} passed ({RESULT['phase_end_s'][name]:.1f} s since the start)")


def reset_counts() -> None:
    for op in COUNTED:
        op.launches = 0


def read_counts() -> dict[str, int]:
    return {op.__name__: op.launches for op in COUNTED}


# ---------------------------------------------------------------------------


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    RESULT["build_s"] = secs
    log(f"[build] {len(paths)} libraries in {secs:.1f} s (built in parallel, one nvcc each)")
    for name in paths:
        entry = ""
        for line in _build.build_log(name).splitlines():
            found = re.search(r"[a-z_]*kernel\w*?E(?=v)", line)
            if "Compiling entry function" in line and found:
                entry = found.group(0) + ": "  # the kernel and its template arguments, mangled
            if ("Used" in line or "warning" in line.lower()
                    or "spill" in line.lower() and "0 bytes spill" not in line):
                log(f"[build] {name}: {entry}{line.strip()}")


class Checker:
    def __init__(self, torch):
        self.torch = torch
        self.max_err: dict[str, float] = {}

    def _within(self, got, want, tol: dict) -> tuple[bool, float]:
        got_f, want_f = got.float(), want.float()
        err = (got_f - want_f).abs()
        ok = bool(self.torch.isfinite(got_f).all()) and got.shape == want.shape and bool(
            (err <= tol["atol"] + tol["rtol"] * want_f.abs()).all())
        return ok, float(err.max())

    def compare(self, name: str, what: str, got, want, tol: dict) -> None:
        ok, e = self._within(got, want, tol)
        self.max_err[name] = max(self.max_err.get(name, 0.0), e)
        log(f"[check] {name:16s} {what:52s} max_abs_err {e:.3e} "
            f"(atol {tol['atol']:g} rtol {tol['rtol']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} {what}: max_abs_err {e:.3e}")

    def compare_rows(self, name: str, what: str, got, want, tol: dict, limit: float, rows: int,
                     *, fault: bool = False) -> None:
        """``compare``, and the largest rel-L2 over blocks of ``rows`` rows
        (dim 1) of one batch entry and head of a (B, S, H, hd) output: a
        measure sized to the output where it is small. A planted ``fault``
        must fail one of the two (and is kept out of the recorded error)."""
        F = self.torch.nn.functional
        ok, e = self._within(got, want, tol)
        B, S, H, D = want.shape
        pad = -S % rows

        def blocks(t):
            return F.pad(t.square(), (0, 0, 0, 0, 0, pad)).view(B, -1, rows, H, D).sum((2, 4))

        rel = float((blocks(got.float() - want.float()) / blocks(want.float())).sqrt().max())
        ok = ok and rel <= limit
        what = f"{what:52s} max_abs_err {e:.3e} (atol {tol['atol']:g} rtol {tol['rtol']:g}), " \
               f"rel_l2 over {rows}-row blocks {rel:.3e} (limit {limit:g})"
        if fault:
            log(f"[check] {name:16s} {what}: planted fault {'caught' if not ok else 'MISSED'}")
            if ok:
                FAILURES.append(f"{name} {what}: the planted fault passed the check")
            return
        self.max_err[name] = max(self.max_err.get(name, 0.0), e)
        log(f"[check] {name:16s} {what} {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} {what}")

    def run(self, name: str, what: str, fn) -> None:
        try:
            fn()
        except Exception as exc:  # record and go on: one run reports every case
            log(f"[check] {name:16s} {what:52s} ERROR {type(exc).__name__}: {exc}")
            FAILURES.append(f"{name} {what}: {type(exc).__name__}: {exc}")


def phase_check(torch, ops, refs) -> Checker:
    rmsnorm, rmsnorm_add, flash_attention, decode_attention = ops
    rmsnorm_ref, rmsnorm_add_ref, flash_ref, decode_ref = refs
    ck = Checker(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    # rmsnorm and the fused add + rmsnorm: prefill and decode rows of
    # StarCoder2-3B (d 3072: 3 of a thread's 4 vectors live) and of jamba (d
    # 4096: all 4 live), odd widths, fp32; the fused entry's s equal to
    # torch's add and its y bit-equal to the rmsnorm kernel applied to that s
    exact = dict(atol=0.0, rtol=0.0)
    for shape, dtype in [((256, 3072), torch.bfloat16), ((4, 1, 3072), torch.bfloat16),
                         ((256, 4096), torch.bfloat16), ((4, 1, 4096), torch.bfloat16),
                         ((3, 97, 256), torch.bfloat16), ((64, 3072), torch.float32),
                         ((5, 16), torch.float32),
                         # gemma2 (d 3584) and xLSTM (d 2048): decode and prefill rows
                         ((4, 3584), torch.bfloat16), ((4864, 3584), torch.bfloat16),
                         ((4, 2048), torch.bfloat16), ((320, 2048), torch.bfloat16),
                         # seamless (d 1024: one warp a row, four rows a CTA): decode
                         # rows, the 2-token prompts, the encoder over 4 x 1500 frames,
                         # the ragged utterance
                         ((4, 1024), torch.bfloat16), ((8, 1024), torch.bfloat16),
                         ((6000, 1024), torch.bfloat16), ((613, 1024), torch.bfloat16)]:
        def case(shape=shape, dtype=dtype):
            x = randn(*shape, dtype=dtype, scale=3.0)
            sc = randn(shape[-1], dtype=dtype, scale=0.2)  # non-zero: (1+scale) matters
            tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            ck.compare("rmsnorm", f"x {tuple(shape)} {str(dtype)[6:]}", rmsnorm(x, sc, 1e-6),
                       rmsnorm_ref(x, sc, 1e-6), tol)
            r = randn(*shape, dtype=dtype)
            s, y = rmsnorm_add(x, r, sc, 1e-6)
            rs, ry = rmsnorm_add_ref(x, r, sc, 1e-6)
            what = f"{tuple(shape)} {str(dtype)[6:]}"
            ck.compare("rmsnorm_add", f"y {what}", y, ry, tol)
            ck.compare("rmsnorm_add", f"s = x + r {what}, exact", s, rs, exact)
            ck.compare("rmsnorm_add", f"y = rmsnorm kernel of s {what}, exact", y,
                       rmsnorm(s, sc, 1e-6), exact)
        ck.run("rmsnorm", f"x {tuple(shape)}", case)

    # flash attention: (B, Sq, Skv, H, K, hd, causal, window, softcap)
    flash_cases = [
        (1, 256, 256, 24, 2, 128, True, 0, 0.0),  # slice: one 256-token StarCoder2 prompt
        (1, 200, 200, 24, 2, 128, True, 0, 0.0),  # ragged prompt
        (1, 320, 320, 24, 2, 128, True, 0, 0.0),  # longest prompt of the workload
        (2, 37, 300, 4, 2, 64, True, 0, 0.0),  # Sq < Skv
        (1, 256, 256, 24, 2, 128, True, 64, 50.0),  # window 64 + softcap 50
        (2, 256, 256, 4, 2, 64, True, 0, 0.0),  # tests/test_kernels.py cases
        (1, 256, 256, 4, 4, 128, True, 128, 0.0),
        (2, 128, 128, 8, 2, 64, True, 0, 50.0),
        (1, 256, 256, 2, 1, 64, False, 0, 0.0),
        (1, 192, 192, 6, 3, 32, True, 64, 30.0),
        (1, 130, 130, 8, 2, 256, True, 0, 0.0),  # widest head
        (1, 50, 50, 4, 2, 16, True, 0, 0.0),  # narrowest head
        (1, 256, 256, 32, 8, 128, True, 0, 0.0),  # jamba: one 256-token prompt, G = 4
        (1, 1024, 1024, 24, 2, 128, True, 0, 0.0),  # a 1024-token prompt: 16 query tiles
        (2, 700, 700, 16, 16, 256, True, 0, 30.0),  # hd 256: 32-key kv tiles, softcap
        (1, 1000, 1000, 32, 4, 32, True, 300, 0.0),  # window edge across many kv tiles
        # the measure phase's prompts (6-10 tokens) and one token: one partly
        # filled query tile against one partly filled kv tile
        (1, 1, 1, 24, 2, 128, True, 0, 0.0),
        (1, 6, 6, 24, 2, 128, True, 0, 0.0),
        (1, 8, 8, 24, 2, 128, True, 0, 0.0),
        (1, 10, 10, 24, 2, 128, True, 0, 0.0),
        # seamless (16 on 16, hd 64), unmasked: the encoder over four 30 s
        # utterances and over a ragged one; cross-attention at prefill, a
        # 2-token prompt on 1500 frames, 37 tokens on 613, 300 on 100 (more
        # queries than keys)
        (4, 1500, 1500, 16, 16, 64, False, 0, 0.0),
        (1, 613, 613, 16, 16, 64, False, 0, 0.0),
        (4, 2, 1500, 16, 16, 64, False, 0, 0.0),
        (1, 37, 613, 16, 16, 64, False, 0, 0.0),
        (2, 300, 100, 16, 16, 64, False, 0, 0.0),
        # seamless's decoder self-attention at prefill: the 2-token prompts
        (4, 2, 2, 16, 16, 64, True, 0, 0.0),
        (1, 2, 2, 16, 16, 64, True, 0, 0.0),
    ]
    for B, Sq, Skv, H, K, hd, causal, window, cap in flash_cases:
        what = f"q ({B},{Sq},{H},{hd}) kv ({Skv},{K}) c{int(causal)} w{window} cap{cap:g}"

        def case(B=B, Sq=Sq, Skv=Skv, H=H, K=K, hd=hd, causal=causal, window=window, cap=cap,
                 what=what):
            q, k, v = randn(B, Sq, H, hd), randn(B, Skv, K, hd), randn(B, Skv, K, hd)
            kw = dict(causal=causal, window=window, softcap=cap)
            ck.compare("flash_attention", what, flash_attention(q, k, v, **kw),
                       flash_ref(q, k, v, **kw), BF16_TOL)
        ck.run("flash_attention", what, case)

    def strided():  # q, k, v as head slices of one fused projection, read through strides
        qkv = randn(1, 96, 24 + 2 + 2, 128)
        q, k, v = qkv[:, :, :24], qkv[:, :, 24:26], qkv[:, :, 26:]
        ck.compare("flash_attention", "strided q/k/v views of one (1,96,28,128)",
                   flash_attention(q, k, v), flash_ref(q, k, v), BF16_TOL)
    ck.run("flash_attention", "strided views", strided)

    def refuses_fp32():
        q = randn(1, 8, 4, 64, dtype=torch.float32)
        k = randn(1, 8, 2, 64, dtype=torch.float32)
        try:
            flash_attention(q, k, k)
        except TypeError:
            log(f"[check] {'flash_attention':16s} {'float32 input raises TypeError':52s} ok")
            return
        FAILURES.append("flash_attention accepted float32")
    ck.run("flash_attention", "float32 refused", refuses_fp32)

    def refuses_masked_sq_past_skv():  # only unmasked attention takes Sq > Skv
        q, k = randn(2, 300, 16, 64), randn(2, 100, 16, 64)
        for kw in (dict(causal=True), dict(causal=False, window=64)):
            try:
                flash_attention(q, k, k, **kw)
            except ValueError:
                what = f"Sq 300 > Skv 100 with {kw} raises"
                log(f"[check] {'flash_attention':16s} {what:52s} ok")
                continue
            FAILURES.append(f"flash_attention accepted Sq 300 > Skv 100 with {kw}")
    ck.run("flash_attention", "masked Sq > Skv refused", refuses_masked_sq_past_skv)

    # decode attention: (B, S, H, K, hd, pos, softcap, dtype)
    decode_cases = [
        (4, 1024, 24, 2, 128, 700, 0.0, torch.bfloat16),  # slice: 4 slots, pos 700 of 1024
        (4, 1024, 24, 2, 128, 1023, 0.0, torch.bfloat16),  # full cache
        (4, 1024, 24, 2, 128, 0, 0.0, torch.bfloat16),  # only position 0
        (4, 1024, 24, 2, 128, 300, 0.0, torch.float32),
        (2, 512, 8, 2, 64, 511, 0.0, torch.bfloat16),  # tests/test_kernels.py cases
        (1, 1024, 4, 4, 128, 700, 0.0, torch.bfloat16),
        (2, 512, 6, 2, 64, 40, 50.0, torch.bfloat16),
        (1, 256, 16, 8, 32, 255, 0.0, torch.bfloat16),
        (1, 300, 32, 2, 256, 299, 0.0, torch.bfloat16),  # widest head, 16 heads per kv head
        (3, 100, 4, 2, 16, 77, 30.0, torch.float32),
        (4, 512, 32, 8, 128, 300, 0.0, torch.bfloat16),  # jamba: 4 slots of 512, G = 4
        (1, 700, 64, 2, 64, 650, 0.0, torch.bfloat16),  # G = 32: two 16-row tiles
        (70, 64, 8, 2, 128, 50, 0.0, torch.bfloat16),  # B * K > 132 SMs: one run per pair
        (1, 4096, 8, 1, 128, 4000, 0.0, torch.float32),  # fp32, 126 runs merged
        (1, 64, 24, 2, 128, 0, 0.0, torch.bfloat16),  # the measure phase: 1 slot of 64
        (1, 64, 24, 2, 128, 5, 0.0, torch.bfloat16),
        (1, 64, 24, 2, 128, 15, 0.0, torch.bfloat16),
        # seamless's cross decode: 4 slots on 1500 frames (16 on 16, hd 64),
        # every frame and a partial run
        (4, 1500, 16, 16, 64, 1499, 0.0, torch.bfloat16),
        (4, 1500, 16, 16, 64, 612, 0.0, torch.bfloat16),
        (1, 613, 16, 16, 64, 612, 0.0, torch.bfloat16),  # the ragged utterance
        # seamless's self decode: 4 slots of 66 (2 prompt + 64 steps) at the
        # first, the profiled and the last step; the ragged call's 6 slots
        (4, 66, 16, 16, 64, 2, 0.0, torch.bfloat16),
        (4, 66, 16, 16, 64, 34, 0.0, torch.bfloat16),
        (4, 66, 16, 16, 64, 65, 0.0, torch.bfloat16),
        (1, 6, 16, 16, 64, 5, 0.0, torch.bfloat16),
    ]
    for B, S, H, K, hd, pos, cap, dtype in decode_cases:
        what = f"q ({B},1,{H},{hd}) cache ({S},{K}) pos {pos} cap{cap:g} {str(dtype)[6:]}"

        def case(B=B, S=S, H=H, K=K, hd=hd, pos=pos, cap=cap, dtype=dtype, what=what):
            q = randn(B, 1, H, hd, dtype=dtype)
            # the caches are one superblock's slice of a stacked (n_sb, B, S, K, hd) cache
            kc, vc = randn(3, B, S, K, hd, dtype=dtype)[1], randn(3, B, S, K, hd, dtype=dtype)[1]
            tol = DECODE_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            ck.compare("decode_attention", what, decode_attention(q, kc, vc, pos, softcap=cap),
                       decode_ref(q, kc, vc, pos, softcap=cap), tol)
        ck.run("decode_attention", what, case)

    def garbage():
        q, kc, vc = randn(4, 1, 24, 128), randn(4, 1024, 2, 128), randn(4, 1024, 2, 128)
        o1 = decode_attention(q, kc, vc, 700)
        kc[:, 701:], vc[:, 701:] = 1e6, -1e6
        ck.compare("decode_attention", "garbage past pos 700 is ignored",
                   decode_attention(q, kc, vc, 700), o1, dict(atol=0.0, rtol=0.0))
    ck.run("decode_attention", "garbage past pos", garbage)

    def graph_replay():  # the split pass and its merge replay: equal to the eager call
        q, kc, vc = randn(4, 1, 24, 128), randn(4, 1024, 2, 128), randn(4, 1024, 2, 128)
        eager = decode_attention(q, kc, vc, 300)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, kc, vc, 300)
        for i in range(2):
            graph.replay()
            torch.cuda.synchronize()
            ck.compare("decode_attention", f"CUDA-graph replay {i + 1} equals the eager call",
                       out, eager, dict(atol=0.0, rtol=0.0))
    ck.run("decode_attention", "graph replay", graph_replay)
    torch.cuda.synchronize()
    check_capped_attention(torch, ck, flash_attention, decode_attention, flash_ref, decode_ref)
    return ck


def flash_cap_after_mask(torch, q, k, v, *, window: int, softcap: float):
    """A planted fault: the plain causal attention (Sq = Skv) with the
    soft-cap applied after the mask, so a masked score of -inf becomes
    -softcap instead of staying out of the softmax."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf, vf = k.float().repeat_interleave(G, dim=2), v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd**-0.5
    i = torch.arange(S, device=q.device)
    keep = i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    s = softcap * torch.tanh(s.masked_fill(~keep, float("-inf")) / softcap)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf).to(q.dtype)


def check_capped_attention(torch, ck: Checker, flash_attention, decode_attention, flash_ref,
                           decode_ref) -> None:
    """gemma2's attention at hd 256, 16 query heads on 8 kv heads, soft-cap
    50, with q drawn at CAP_Q_SCALE: prefill over the longest serve_local
    prompt with the 4096 window (the window's edge after the cap) and without
    it (a global layer), and over a ragged 4353 tokens; decode for 4 slots
    on a 4096-slot ring before, at and past its wrap (the wrapper attends
    min(pos + 1, 4096) slots) and on a global layer's 4928-slot cache. Each
    case beside the planted faults it must catch: the kernel with no cap,
    the kernel with the window one key wider (its edge off by one), and the
    plain attention that caps after the mask."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2408)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    cap = 50.0
    for Sq, window in ((4864, 4096), (4864, 0), (4353, 4096)):
        what = f"q (1,{Sq},16,256) x {CAP_Q_SCALE:g} kv ({Sq},8) w{window} cap{cap:g}"

        def case(Sq=Sq, window=window, what=what):
            q = randn(1, Sq, 16, 256, scale=CAP_Q_SCALE)
            k, v = randn(1, Sq, 8, 256), randn(1, Sq, 8, 256)
            want = flash_ref(q, k, v, window=window, softcap=cap)
            args = ("flash_attention", what)
            ck.compare_rows(*args, flash_attention(q, k, v, window=window, softcap=cap), want,
                            BF16_TOL, CAP_REL_L2, 64)
            faults = [("kernel with no cap", flash_attention(q, k, v, window=window))]
            if window:
                faults.append(("kernel, window one key wider",
                               flash_attention(q, k, v, window=window + 1, softcap=cap)))
            if Sq == 4864 and window:
                faults.append(("plain attention, cap after the mask",
                               flash_cap_after_mask(torch, q, k, v, window=window, softcap=cap)))
            for fault, got in faults:
                ck.compare_rows("flash_attention", f"{what}, {fault}", got, want, BF16_TOL,
                                CAP_REL_L2, 64, fault=True)
        ck.run("flash_attention", what, case)
        torch.cuda.empty_cache()

    for S, pos in ((4096, 4095), (4096, 4096), (4096, 4700), (4928, 4700)):
        what = f"q (4,1,16,256) x {CAP_Q_SCALE:g} cache ({S},8) pos {pos} cap{cap:g}"

        def case(S=S, pos=pos, what=what):
            q = randn(4, 1, 16, 256, scale=CAP_Q_SCALE)
            kc, vc = randn(4, S, 8, 256), randn(4, S, 8, 256)
            want = decode_ref(q, kc, vc, pos, softcap=cap)
            ck.compare_rows("decode_attention", what, decode_attention(q, kc, vc, pos, softcap=cap),
                            want, DECODE_BF16_TOL, CAP_REL_L2, 1)
            ck.compare_rows("decode_attention", f"{what}, kernel with no cap",
                            decode_attention(q, kc, vc, pos), want, DECODE_BF16_TOL, CAP_REL_L2, 1,
                            fault=True)
        ck.run("decode_attention", what, case)


# ---------------------------------------------------------------------------


def eager_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call launched from Python, host overhead included (CUDA events
    around a loop; the card idles whenever the host is slower than the kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def host_us(fn, calls: int = 20_000) -> float:
    """Host time per call of a function that launches nothing (a planner), in
    microseconds on the host's clock."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host overhead is counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_row(torch, name, shape, kernel, plain, library, nbytes, nops, peak) -> dict:
    """Kernel, plain version and one library call for the same function:
    device time per call by CUDA-graph replay, the bound, and the kernel's
    and the library's eager time per call from Python."""
    b_ms, b_by = bound(nbytes, nops, peak)
    r = dict(shape=shape, ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
             library_ms=device_ms(torch, library), bound_ms=b_ms, bound_by=b_by,
             eager_ms=eager_ms(torch, kernel), library_eager_ms=eager_ms(torch, library))
    log(f"[time] {name:16s} {shape:44s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
        f"  library {r['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({b_by});  eager from "
        f"Python: kernel {r['eager_ms']:.4f} ms, library {r['library_eager_ms']:.4f} ms")
    return r


def phase_time(torch, F, ops, refs) -> dict:
    """Kernel, plain and library times at the main path's shapes: device time
    per call (CUDA-graph replay) and, for the kernel, the eager time per call
    from Python. L2 is warm: every call reads the same inputs."""
    rmsnorm, rmsnorm_add, flash_attention, decode_attention = ops
    rmsnorm_ref, rmsnorm_add_ref, flash_ref, decode_ref = refs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = {}

    def record(name, shape, kernel, plain, library, nbytes, nops, peak):
        rows.setdefault(name, []).append(
            time_row(torch, name, shape, kernel, plain, library, nbytes, nops, peak))

    d = 3072
    for n in (4, 256):  # decode rows (4 slots), prefill rows (a 256-token prompt)
        x, r, sc = randn(n, d), randn(n, d), randn(d) * 0.2
        w = (1.0 + sc.float()).to(torch.bfloat16)
        record("rmsnorm", f"x ({n},{d}) bf16", lambda: rmsnorm(x, sc, 1e-6),
               lambda: rmsnorm_ref(x, sc, 1e-6), lambda: F.rms_norm(x, (d,), w, 1e-6),
               nbytes=2 * (2 * n * d + d), nops=4 * n * d, peak=FP32_OPS)
        # x and r read, s and y written; library: torch.add, then F.rms_norm
        record("rmsnorm_add", f"x, r ({n},{d}) bf16", lambda: rmsnorm_add(x, r, sc, 1e-6),
               lambda: rmsnorm_add_ref(x, r, sc, 1e-6),
               lambda: F.rms_norm(torch.add(x, r), (d,), w, 1e-6),
               nbytes=2 * (4 * n * d + d), nops=5 * n * d, peak=FP32_OPS)
        rows["rmsnorm"][-1]["plan_variants"] = norm_plan_variants(torch, x, r, sc)
    # the planner each RMSNorm call runs: a cached lookup, beside planning anew
    from repro_torch.kernels.rmsnorm.ops import norm_plan
    plan_host = dict(cached_us=host_us(lambda: norm_plan(4, d, 2)),
                     uncached_us=host_us(lambda: norm_plan.__wrapped__(4, d, 2)))
    rows["rmsnorm"][0]["plan_host"] = plan_host
    log(f"[time] {'rmsnorm':16s} host time of the plan per call: {plan_host['cached_us']:.3f} us "
        f"(planned anew: {plan_host['uncached_us']:.3f} us)")
    # the card's per-launch floor: a one-element elementwise op, timed the same way
    one = torch.zeros(1, device="cuda")
    floor = dict(shape="one-element add_ (float32)", ms=device_ms(torch, lambda: one.add_(1.0)),
                 eager_ms=eager_ms(torch, lambda: one.add_(1.0)))
    rows["launch_floor"] = [floor]
    log(f"[time] {'launch floor':16s} {floor['shape']:44s} {floor['ms']:.5f} ms device, "
        f"{floor['eager_ms']:.4f} ms eager from Python")

    # StarCoder2 (24 heads / 2 kv) at L 256 and 1024, then jamba (32 / 8) at L 256
    for L, H, K in ((256, 24, 2), (1024, 24, 2), (256, 32, 8)):
        q, k, v = randn(1, L, H, 128), randn(1, L, K, 128), randn(1, L, K, 128)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        pairs = L * (L + 1) // 2  # causal (q, k) pairs this input needs
        record("flash_attention", f"q (1,{L},{H},128) kv (1,{L},{K},128) causal",
               lambda: flash_attention(q, k, v), lambda: flash_ref(q, k, v),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True),
               nbytes=2 * (2 * L * H * 128 + 2 * L * K * 128), nops=4 * H * 128 * pairs,
               peak=BF16_OPS)

    # StarCoder2's 4 slots of 1024 at pos 300 and 1023, then jamba's 4 slots of 512
    for S, H, K, pos in ((1024, 24, 2, 300), (1024, 24, 2, 1023), (512, 32, 8, 300)):
        q, kc, vc = randn(4, 1, H, 128), randn(4, S, K, 128), randn(4, S, K, 128)
        n = pos + 1
        qt = q.transpose(1, 2)
        kt, vt = kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
        record("decode_attention", f"q (4,1,{H},128) cache (4,{S},{K},128) pos {pos}",
               lambda: decode_attention(q, kc, vc, pos), lambda: decode_ref(q, kc, vc, pos),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
               nbytes=2 * (2 * 4 * H * 128 + 2 * 4 * n * K * 128), nops=4 * 4 * H * 128 * n,
               peak=BF16_OPS)
    return rows


# gemma2's attention in the serve_local cell: 16 query heads on 8 kv heads,
# head dim 256, a 4096-token window on the local layers, soft-cap 50
GEMMA_H, GEMMA_K, GEMMA_HD, GEMMA_W, GEMMA_CAP = 16, 8, 256, 4096, 50.0


def flex_softcap(torch, L: int, window: int):
    """``flex_attention`` (compiled) with gemma2's soft-cap as its score_mod
    and the causal mask (and window) as a block mask over L queries and L
    keys, or none for one query: the library's one call for the function
    the kernels compute. Raises where it does not build."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return GEMMA_CAP * torch.tanh(score / GEMMA_CAP)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = kv_idx <= q_idx
        return keep & (kv_idx > q_idx - window) if window else keep

    block = create_block_mask(mask_mod, None, None, L, L, device="cuda") if L > 1 else None
    compiled = torch.compile(flex_attention)
    return lambda q, k, v: compiled(q, k, v, score_mod=score_mod, block_mask=block,
                                    enable_gqa=True)


def phase_time_gemma2(torch, F, flash_attention, decode_attention, flash_ref, decode_ref) -> dict:
    """The serve_local cell's attention at hd 256, device time per call
    (CUDA-graph replay): flash over a 4608-token prompt (the cell's mean),
    causal as a global layer runs it and in the 4096 window as a local layer
    does; decode for 4 slots at pos 4700 against a global layer's 4928-slot
    cache and a local layer's full 4096-slot ring. Beside kernel, plain
    version and bound, two library yardsticks the port never calls: SDPA
    with ``enable_gqa`` (no soft-cap: no single SDPA call computes it; the
    window as an explicit boolean mask) and ``flex_attention`` with the
    soft-cap, compiled, where it builds (else its error is recorded)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    H, K, hd, cap = GEMMA_H, GEMMA_K, GEMMA_HD, GEMMA_CAP

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows: dict[str, list] = {"flash_attention": [], "decode_attention": []}

    def timed(make):  # build a yardstick and time it; it may not build or run: (ms, error)
        try:
            return device_ms(torch, make()), None
        except Exception as exc:  # recorded and reported, not gated
            return None, f"{type(exc).__name__}: {exc}"[:400]

    def record(name, shape, kernel, plain, sdpa, make_flex, nbytes, nops):
        b_ms, b_by = bound(nbytes, nops, BF16_OPS)
        r = dict(shape=shape, ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
                 bound_ms=b_ms, bound_by=b_by, eager_ms=eager_ms(torch, kernel))
        r["sdpa_no_softcap_ms"], r["sdpa_error"] = timed(lambda: sdpa)
        r["flex_softcap_ms"], r["flex_error"] = timed(make_flex)
        rows[name].append(r)
        lib = " ".join(f"{k} {'n/a' if r[k] is None else f'{r[k]:.4f} ms'}"
                       for k in ("sdpa_no_softcap_ms", "flex_softcap_ms"))
        log(f"[time] {name:16s} {shape:52s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} "
            f"ms  bound {b_ms:.5f} ms ({b_by});  {lib};  eager kernel {r['eager_ms']:.4f} ms")
        for k in ("sdpa_error", "flex_error"):
            if r[k]:
                log(f"[time] {name:16s} {k}: {r[k]}")

    L = 4608
    q, k, v = randn(1, L, H, hd), randn(1, L, K, hd), randn(1, L, K, hd)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    for window in (0, GEMMA_W):
        pairs = sum(min(i + 1, window or L) for i in range(L))  # (q, k) pairs this mask keeps
        i = torch.arange(L, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def flex(window=window):
            fn = flex_softcap(torch, L, window)
            return lambda: fn(qt, kt, vt)

        record("flash_attention",
               f"q (1,{L},{H},{hd}) kv ({L},{K}) {'window ' + str(window) if window else 'causal'}"
               f" cap {cap:g}",
               lambda window=window: flash_attention(q, k, v, window=window, softcap=cap),
               lambda window=window: flash_ref(q, k, v, window=window, softcap=cap),
               (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True)) if not window else
               (lambda band=band: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                                 enable_gqa=True)),
               flex, nbytes=2 * (2 * L * H * hd + 2 * L * K * hd), nops=4 * H * hd * pairs)

    q = randn(4, 1, H, hd)
    for S, pos, what in ((4928, 4700, "global append cache"), (GEMMA_W, 4700, "local ring")):
        kc, vc = randn(4, S, K, hd), randn(4, S, K, hd)
        n = min(pos + 1, S)  # the keys the wrapper attends
        qt, kt, vt = q.transpose(1, 2), kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)

        def flex(qt=qt, kt=kt, vt=vt):
            fn = flex_softcap(torch, 1, 0)
            return lambda: fn(qt, kt, vt)

        record("decode_attention", f"q (4,1,{H},{hd}) {what} (4,{S},{K},{hd}) pos {pos} cap "
               f"{cap:g}",
               lambda kc=kc, vc=vc: decode_attention(q, kc, vc, pos, softcap=cap),
               lambda kc=kc, vc=vc: decode_ref(q, kc, vc, pos, softcap=cap),
               lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           enable_gqa=True),
               flex, nbytes=2 * (2 * 4 * H * hd + 2 * 4 * n * K * hd), nops=4 * 4 * H * hd * n)
    return rows


# seamless in the encdec phase: 16 query heads on 16 kv heads, head dim 64;
# 4 utterances of 1500 frames, 2-token prompts, decode at pos 34 of 66
SEAMLESS_H, SEAMLESS_HD, SEAMLESS_B, SEAMLESS_SE = 16, 64, 4, 1500
SEAMLESS_PROMPT, SEAMLESS_STEPS, SEAMLESS_PROFILE_POS = 2, 64, 34


def phase_time_seamless(torch, F, flash_attention, decode_attention, flash_ref,
                        decode_ref) -> dict:
    """The encdec phase's attention at hd 64 (16 on 16), device time per call
    by CUDA-graph replay beside the plain version, SDPA and the bound: flash
    unmasked over the encoder's (4, 1500) and over a cross prefill of 2
    queries on 1500 frames; decode over 1500 cross frames (pos 1499) and the
    decoder's self cache at pos 34 of 66."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(55)
    B, H, hd, Se = SEAMLESS_B, SEAMLESS_H, SEAMLESS_HD, SEAMLESS_SE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows: dict[str, list] = {"flash_attention": [], "decode_attention": []}
    for Sq, what in ((Se, "encoder"), (SEAMLESS_PROMPT, "cross prefill")):
        q, k, v = randn(B, Sq, H, hd), randn(B, Se, H, hd), randn(B, Se, H, hd)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows["flash_attention"].append(time_row(
            torch, "flash_attention", f"{what} q ({B},{Sq},{H},{hd}) kv ({Se},{H}) unmasked",
            lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=False),
            lambda q=q, k=k, v=v: flash_ref(q, k, v, causal=False),
            lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt),
            nbytes=2 * (2 * B * Sq * H * hd + 2 * B * Se * H * hd),
            nops=4 * B * H * hd * Sq * Se, peak=BF16_OPS))
    cache_len = SEAMLESS_PROMPT + SEAMLESS_STEPS
    for S, pos, what in ((Se, Se - 1, "cross"), (cache_len, SEAMLESS_PROFILE_POS, "self")):
        q, kc, vc = randn(B, 1, H, hd), randn(B, S, H, hd), randn(B, S, H, hd)
        n = pos + 1
        qt, kt, vt = q.transpose(1, 2), kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
        rows["decode_attention"].append(time_row(
            torch, "decode_attention", f"{what} q ({B},1,{H},{hd}) cache ({B},{S},{H},{hd}) "
            f"pos {pos}",
            lambda q=q, kc=kc, vc=vc, pos=pos: decode_attention(q, kc, vc, pos),
            lambda q=q, kc=kc, vc=vc, pos=pos: decode_ref(q, kc, vc, pos),
            lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt),
            nbytes=2 * (2 * B * H * hd + 2 * B * n * H * hd), nops=4 * B * H * hd * n,
            peak=BF16_OPS))
    return rows


def norm_plan_variants(torch, x, r, sc) -> list[dict]:
    """The RMSNorm plan's neighbours at x's shape: a warp per row up to a CTA
    per row, one to four rows per CTA, each entry held to the plain version
    (the fused one's y bit-equal to the plain entry's on its s) and timed
    beside the plan in this call."""
    from repro_torch.kernels.rmsnorm import ops

    rows, d = x.shape
    elt = x.element_size()
    plan = ops.norm_plan(rows, d, elt)
    want = ops.rmsnorm_reference(x, sc, 1e-6)
    out = []
    for tpr, per_cta in ((32, 1), (32, 4), (64, 1), (64, 2), (128, 1), (128, 2), (256, 1)):
        try:
            p = ops.norm_plan(rows, d, elt, threads_per_row=tpr, rows_per_cta=per_cta)
        except ValueError:
            continue
        y = ops._launch(x, None, sc, 1e-6, p)
        s, ys = ops._launch(x, r, sc, 1e-6, p)
        err = float((y.float() - want.float()).abs().max())
        if not (torch.isfinite(y).all() and bool(((y.float() - want.float()).abs() <= BF16_TOL[
                "atol"] + BF16_TOL["rtol"] * want.float().abs()).all())
                and torch.equal(ys, ops._launch(s, None, sc, 1e-6, p))):
            FAILURES.append(f"rmsnorm plan {p} at ({rows},{d}): not within tolerance or the "
                            "fused y differs from rmsnorm(s)")
        row = dict(threads_per_row=tpr, rows_per_cta=per_cta, vectors=p.vectors,
                   planned=(tpr, per_cta) == (plan.threads_per_row, plan.rows_per_cta),
                   max_abs_err=err, ms=device_ms(torch, lambda: ops._launch(x, None, sc, 1e-6, p)),
                   add_ms=device_ms(torch, lambda: ops._launch(x, r, sc, 1e-6, p)))
        out.append(row)
        log(f"[time] {'rmsnorm':16s} plan ({rows},{d}) {tpr:3d} threads a row, {per_cta} rows a "
            f"CTA, {p.vectors:2d} vectors a thread: {row['ms']:.5f} ms, fused add "
            f"{row['add_ms']:.5f} ms" + (" (the plan)" if row["planned"] else ""))
    return out


# ---------------------------------------------------------------------------

# where the model layers call each kernel wrapper (plain_path swaps them)
KERNEL_SITES = {"rmsnorm": "layers", "rmsnorm_add": "layers", "flash_attention": "attention",
                "decode_attention": "attention", "ssm_scan": "ssm"}


@contextlib.contextmanager
def plain_path(refs: dict):
    """Route the model through the plain versions (for the logits check only):
    ``refs`` maps each name of ``KERNEL_SITES`` to its plain version, and may
    also swap a model function by its "module.name" under
    ``repro_torch.models`` (a planted fault)."""
    import importlib

    sites = {name: (KERNEL_SITES[name], name) if "." not in name else name.split(".")
             for name in {**KERNEL_SITES, **refs}}
    mods = {name: importlib.import_module(f"repro_torch.models.{mod}")
            for name, (mod, _) in sites.items()}
    saved = {name: getattr(mods[name], attr) for name, (_, attr) in sites.items()}
    for name, (_, attr) in sites.items():
        setattr(mods[name], attr, refs[name])
    try:
        yield
    finally:
        for name, (_, attr) in sites.items():
            setattr(mods[name], attr, saved[name])


def serving_launches(L: int, prefills: int, decodes: int) -> dict[str, int]:
    """Every kernel's launches for that many prefills and decode steps of an
    L-layer dense model: 2 rmsnorm, 2L - 1 rmsnorm_add and L flash per
    prefill, 1 rmsnorm, 2L rmsnorm_add and L decode per step, nothing else."""
    return {"rmsnorm": 2 * prefills + decodes,
            "rmsnorm_add": (2 * L - 1) * prefills + 2 * L * decodes,
            "flash_attention": L * prefills, "decode_attention": L * decodes,
            "lindley_scan": 0, "lindley_kserver": 0, "decision_scan": 0, "ssm_scan": 0}


# the slice's cell: 16 Poisson requests at 20 rps, prompts 256 +/- 64, 32 new
# tokens, 4 slots of 1024 positions, at full width
SERVE_ARGV = ["--arch", "starcoder2_3b", "--requests", "16", "--rps", "20",
              "--prompt-len", "256", "--prompt-jitter", "64", "--max-new", "32",
              "--slots", "4", "--max-seq", "1024", "--device", "cuda"]


def serve_full_width(torch, tag: str, argv: list, arch: str, *, requests: int, max_new: int,
                     rps: float, cut: str = "nothing cut"):
    """One full-width cell through the serving CLI's path with the launch
    counters reset just before and read just after; logs its summary and
    checks every request done with all its tokens inside the padded vocab.
    Returns (engine, gateway, out, launches, prefills, decode steps)."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import num_params

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, gw = serve.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    cfg, model = engine.cfg, engine.model
    n_params = model.num_params()
    if cfg.name != arch or n_params != num_params(cfg):
        FAILURES.append(f"served {cfg.name} holds {n_params} params, template says "
                        f"{num_params(cfg)}")
    lengths = sorted({len(r.prompt) for r in engine.completed})
    s = serve.summarize(engine)
    s.update(wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
             prompt_lengths=[len(r.prompt) for r in engine.completed])
    log(f"[{tag}] {cfg.name} ({cfg.num_layers} layers, {n_params:,} params, {cut}): "
        f"{s['requests_done']} requests done in {wall:.2f} s wall (model set-up and warmup of "
        f"{len(lengths)} prompt lengths, {lengths[0]}..{lengths[-1]} tokens, included)")
    log(f"[{tag}] latency p50 {s['latency_p50_ms']:.2f} ms, p99 {s['latency_p99_ms']:.2f} ms "
        f"(Poisson {rps:g} rps replayed on the engine clock)")
    log(f"[{tag}] prefill {s['prefill_ms_mean']:.3f} ms mean over {s['prefills']}; decode step "
        f"{s['decode_step_ms_mean']:.3f} ms mean over {s['decode_steps']}; {s['tokens_out']} "
        f"tokens, {s['tokens_per_s_busy']:.1f} tokens/s of busy time; peak memory "
        f"{s['peak_mem_gib']:.2f} GiB (limit 80 GB)")
    out: dict = {"params": n_params, "argv": argv, "layers": cfg.num_layers, "serve": s}
    if s["requests_done"] != requests:
        FAILURES.append(f"{tag}: {s['requests_done']} of {requests} requests done")
    for r in engine.completed:
        if len(r.tokens_out) != max_new or not all(
                0 <= t < cfg.padded_vocab for t in r.tokens_out):
            FAILURES.append(f"{tag} request {r.rid}: {len(r.tokens_out)} tokens "
                            f"{r.tokens_out[:4]}...")
    if torch.cuda.max_memory_allocated() >= 80e9:
        FAILURES.append(f"{tag} peak memory {s['peak_mem_gib']:.2f} GiB")
    n_prefill = len(lengths) + sum(ev.phase == "prefill" for ev in engine.service_log)
    n_decode = 1 + sum(ev.phase == "decode" for ev in engine.service_log)
    return engine, gw, out, launches, n_prefill, n_decode


def check_launches(tag: str, launches: dict, expect: dict, what: str) -> None:
    ok = launches == expect
    log(f"[{tag}] launches {launches}; expected {expect} for {what} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} launch counts {launches} != {expect}")


def phase_serve(torch, ops, refs) -> dict:
    # the CLI's path: model, warmup, replay, summary, then the gateway's epochs
    engine, gw, out, launches, n_prefill, n_decode = serve_full_width(
        torch, "serve", SERVE_ARGV, "starcoder2_3b", requests=16, max_new=32, rps=20.0)
    cfg, model = engine.cfg, engine.model
    log(f"[serve] weight-read floor of a decode step {2 * out['params'] / HBM_BPS * 1e3:.3f} ms")
    # every prefill and decode call (warmup included) went through the kernels
    L = cfg.num_layers
    check_launches("serve", launches, serving_launches(L, n_prefill, n_decode),
                   f"{n_prefill} prefills (2 rmsnorm + {2 * L - 1} rmsnorm_add + {L} flash each) "
                   f"and {n_decode} decode steps (1 rmsnorm + {2 * L} rmsnorm_add + {L} decode "
                   "each); the gateway's epochs, run before the counts were read, add none")
    out["launches"] = launches
    out["gateway"] = check_gateway("serve", engine, gw, rps=20.0)
    out["tracer"] = tracer_cost(torch, engine)

    out.update(kernel_vs_plain(torch, model, refs, LOGITS_REL_L2, cache_len=1024))
    out["profile"] = profile_decode(torch, model, slots=4, pos=300, cache_len=1024)
    del engine, model, gw
    return out


def check_gateway(tag: str, engine, gw, *, rps: float) -> dict:
    """The serve CLI's gateway half over the profiled service: the audit
    verifies, each epoch's choice is the argmin of its audited totals (no
    hysteresis), and the Fig. 6 row (reported, not gated: it depends on the
    profiled service)."""
    from repro_torch.obs import format_decision

    s_dev, var = engine.observed_service_stats()
    auditor = gw.manager.auditor
    log(f"[{tag}] gateway: profiled service s_dev {s_dev * 1e3:.3f} ms (var {var:.3e}); device "
        f"tier rho = rps * s_dev = {rps * s_dev:.4f}")
    for row in auditor:
        log(f"[{tag}]   {format_decision(row)}")
    try:
        err = auditor.verify()
    except AssertionError as exc:
        FAILURES.append(f"{tag} gateway audit: {exc}")
        err = None
    argmin = all(row.totals[row.chosen] == min(row.totals.values()) for row in auditor)
    ok = err is not None and argmin and len(auditor) == len(gw.decisions) >= 1
    fig6 = ";".join("on_device" if d.edge_index < 0 else "offload" for d in gw.decisions)
    log(f"[{tag}] gateway: {len(gw.decisions)} epochs, audit re-sum error {err} (limit 1e-9), "
        f"every choice the argmin of its audited totals: {argmin}, switches {gw.switches}; "
        f"Fig. 6 row {fig6} (reported, not gated) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{tag} gateway: re-sum error {err}, argmin {argmin}, "
                        f"{len(auditor)} audits for {len(gw.decisions)} epochs")
    return dict(s_dev_s=s_dev, s_dev_var=var, rho_device=rps * s_dev, fig6_row=fig6,
                switches=gw.switches, resum_error=err, metrics=gw.metrics.snapshot(),
                decisions=[format_decision(row) for row in auditor])


TRACER_REQUESTS, TRACER_REPEATS, TRACER_BUDGET_PCT = 12, 5, 5.0


def tracer_cost(torch, engine) -> dict:
    """The tracer's cost on the warmed full-width engine, after the reference's
    ``benchmarks/obs_bench.py``: bursts of 12 requests (8-token prompts, 8 new
    tokens) drained on the wall clock with no tracer, a disabled one and an
    enabled one, the modes interleaved, best of 5 each. Gated: the disabled
    tracer records nothing and the enabled one exactly 3 spans per request
    (queue, prefill, respond) plus 1 per decode step. The overheads are
    reported beside the reference's 5% budget, not gated (host-bound)."""
    import numpy as np

    from repro_torch.obs import Tracer
    from repro_torch.serving.engine import Request

    cfg = engine.cfg
    engine.warmup([8])
    engine.completed.clear()
    engine.service_log.clear()

    def drain() -> tuple[float, int]:
        rng = np.random.default_rng(0)
        for rid in range(TRACER_REQUESTS):
            engine.submit(Request(rid=rid, max_new_tokens=8,
                                  prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)))
        t0 = time.perf_counter()
        engine.drain()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.tokens_out) for r in engine.completed)
        steps = sum(ev.phase == "decode" for ev in engine.service_log)
        engine.completed.clear()
        engine.service_log.clear()
        return tokens / wall, steps

    drain()  # untimed: the first drain after a warmup runs slower
    modes = {"none": None, "disabled": Tracer(enabled=False), "enabled": Tracer()}
    best: dict[str, float] = {}
    expect_spans = 0
    for _ in range(TRACER_REPEATS):
        for mode, tracer in modes.items():
            engine.tracer = tracer
            engine._trace = tracer is not None and tracer.enabled
            tps, steps = drain()
            best[mode] = max(best.get(mode, 0.0), tps)
            if mode == "enabled":
                expect_spans += 3 * TRACER_REQUESTS + steps
    engine.tracer, engine._trace = None, False
    n_off, n_on = len(modes["disabled"]), len(modes["enabled"])
    cats = {c: len(modes["enabled"].by_cat(c)) for c in ("queue", "prefill", "respond", "decode")}
    dis = (best["none"] - best["disabled"]) / best["none"] * 100.0
    ena = (best["none"] - best["enabled"]) / best["none"] * 100.0
    ok = n_off == 0 and n_on == expect_spans
    log(f"[serve] tracer cost at full width ({TRACER_REQUESTS} requests of 8 + 8 tokens, best of "
        f"{TRACER_REPEATS}, modes interleaved; {RESULT.get('card')}): tokens/s none "
        f"{best['none']:.2f}, disabled {best['disabled']:.2f}, enabled {best['enabled']:.2f}; "
        f"overhead disabled {dis:.2f}%, enabled {ena:.2f}% (budget {TRACER_BUDGET_PCT:g}%, "
        "reported, not gated)")
    log(f"[serve] tracer spans: disabled {n_off} (expected 0), enabled {n_on} (expected "
        f"{expect_spans} = 3 per request + 1 per decode step; {cats}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"tracer spans: disabled {n_off}, enabled {n_on} != {expect_spans}")
    return dict(tokens_per_s=best, disabled_overhead_pct=dis, enabled_overhead_pct=ena,
                budget_pct=TRACER_BUDGET_PCT, spans_disabled=n_off, spans_enabled=n_on,
                spans_expected=expect_spans, spans_by_cat=cats)


def fill_caches(full, part, L: int) -> None:
    """Copy a batch-1 prefill's caches into ``full`` (batch 1): the L
    positions of the attention leaves, the state leaves whole."""
    for dst, src in zip(full, part):
        for key in dst:
            if dst[key].shape[2] != src[key].shape[2]:
                dst[key][:, :, :L].copy_(src[key])
            else:
                dst[key].copy_(src[key])


@contextlib.contextmanager
def routing(record: list | None = None, replay: list | None = None):
    """Record every MoE layer's top-k expert choices in ``record``, or route
    by the recorded choices of ``replay`` instead of the layer's own; yields
    a one-element list that counts the (token, slot) choices replaced."""
    from repro_torch.models import moe

    saved, pinned, replaced = moe.route, iter(replay or ()), [0]

    def route(p, xt, cfg):
        probs, idx = saved(p, xt, cfg)
        if record is not None:
            record.append(idx)
        if replay is not None:
            fixed = next(pinned)
            replaced[0] += int((fixed != idx).sum())
            idx = fixed
        return probs, idx

    moe.route = route
    try:
        yield replaced
    finally:
        moe.route = saved


def resummed_norms(torch):
    """The plain RMSNorm entries with the mean of squares summed in another
    order (two halves of the row, then their sum), as the kernel sums it in
    its own: the same function, its bf16 output one step apart where the
    order tips the rounding."""
    def rmsnorm(x, scale, eps=1e-6):
        sq = x.float() ** 2
        h = sq.shape[-1] // 2
        var = (sq[..., :h].sum(-1, keepdim=True) + sq[..., h:].sum(-1, keepdim=True)) / (
            sq.shape[-1])
        return (x.float() * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)

    def rmsnorm_add(x, r, scale, eps=1e-6):
        s = x + r
        return s, rmsnorm(s, scale, eps)

    return {"rmsnorm": rmsnorm, "rmsnorm_add": rmsnorm_add}


def bf16_rounded_norms(torch, refs):
    """A planted fault: the plain RMSNorm entries with their output stored
    through bfloat16 whatever the input's type."""
    def rmsnorm(x, scale, eps=1e-6):
        return refs["rmsnorm"](x, scale, eps).to(torch.bfloat16).to(x.dtype)

    def rmsnorm_add(x, r, scale, eps=1e-6):
        s, y = refs["rmsnorm_add"](x, r, scale, eps)
        return s, y.to(torch.bfloat16).to(y.dtype)

    return {"rmsnorm": rmsnorm, "rmsnorm_add": rmsnorm_add}


def ring_as_append_cache(refs):
    """A planted fault: decode attention that reads a full ring (pos past its
    S slots) as an append cache, attending only its slots 0..pos % S."""
    def decode_attention(q, k, v, pos, **kw):
        S = k.shape[1]
        return refs["decode_attention"](q, k, v, pos % S if pos >= S else pos, **kw)

    return {"decode_attention": decode_attention}


def gemma2_faults(torch, refs) -> dict:
    """The planted faults gemma2's logits gate must refuse."""
    def no_window(q, k, v, **kw):
        return refs["flash_attention"](q, k, v, **{**kw, "window": 0})

    return {"ring read as an append cache": ring_as_append_cache(refs),
            "local prefill without the window": {"flash_attention": no_window}}


def xlstm_faults(torch, refs) -> dict:
    """The planted faults xLSTM's logits gate must refuse."""
    return {"norm outputs stored through bf16": bf16_rounded_norms(torch, refs)}


@contextlib.contextmanager
def in_fp32(torch, model):
    """The model with its weights and its dtype in float32, restored after
    (bfloat16 to float32 and back is exact)."""
    cfg, params = model.cfg, list(model.parameters())
    dtypes = [p.dtype for p in params]
    for p in params:
        p.data = p.data.float()
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    try:
        yield
    finally:
        for p, dt in zip(params, dtypes):
            p.data = p.data.to(dt)
        model.cfg = cfg
        if p.is_cuda:
            torch.cuda.empty_cache()


def path_logits(model, prompt, toks, cache_len: int, refs: dict | None = None,
                enc_embeds=None) -> list:
    """The logits of a prefill of ``prompt`` (an encoder-decoder's over
    ``enc_embeds``), then of a decode step for each of ``toks`` from that
    prefill's caches: through the kernels, or through ``refs`` in their
    place."""
    L = prompt.shape[1]
    with plain_path(refs) if refs else contextlib.nullcontext():
        if enc_embeds is None:
            logits, caches = model.prefill(prompt)
            full = model.init_caches(1, cache_len)
        else:
            logits, caches = model.prefill(prompt, enc_embeds=enc_embeds)
            full = model.init_caches(1, cache_len, enc_len=enc_embeds.shape[1])
        fill_caches(full, caches, L)
        del caches
        return [logits] + [model.decode_step(t, L + i, full)[0] for i, t in enumerate(toks)]


def logits_gate(torch, model, refs, faults: dict, *, cache_len: int, prompt_len: int,
                steps: int, fp32_kernels: bool, enc_len: int = 0) -> dict:
    """The served model's kernel path held against its plain path above the
    model's own rounding noise: a ragged prompt (for an encoder-decoder over
    ``enc_len`` frame embeddings drawn in bf16 from the seed, the same for
    every path), then ``steps`` decode steps (tokens from a seed). Beside
    the kernel path run a control (the plain
    path with its RMSNorm sums in another order, ``resummed_norms``: a
    correct kernel's kind of difference) and planted ``faults`` (name ->
    plain versions to swap in); the gate must pass the kernel path and the
    control and refuse every fault.

    ``fp32_kernels``: the model runs in float32 through the kernels and
    through the plain path, and each is held by the worst rel-L2 of its
    logits against the plain path's over the prefill and the steps, limit
    FP32_LOGITS_REL_L2. Otherwise (a kernel on the path takes bf16 only) the
    bf16 paths are held against the plain path in float32, after the
    convention of FlashAttention's own tests: at every position the kernel
    path's rel-L2 to it at most FP32_ERROR_RATIO times the plain bf16
    path's. The bf16 kernel path against the bf16 plain path is reported
    beside it, not gated."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    L = prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (1, L), generator=gen, device=dev)
    toks = [torch.randint(0, cfg.vocab_size, (1, 1), generator=gen, device=dev)
            for _ in range(steps)]
    enc = None
    if enc_len:
        enc = torch.randn((1, enc_len, cfg.d_model), generator=gen, device=dev).bfloat16()
    variants = {"control": {**refs, **resummed_norms(torch)}}
    variants.update({f"fault: {name}": {**refs, **swap} for name, swap in faults.items()})

    def rel_l2(got, want):
        return float((got.float() - want.float()).norm() / want.float().norm())

    def run_all(paths):
        return {name: path_logits(model, prompt, toks, cache_len, r, enc)
                for name, r in paths.items()}

    bf16 = run_all({"kernel": None, "plain": refs})
    worst = max(rel_l2(g, w) for g, w in zip(bf16["kernel"], bf16["plain"]))
    finite = all(bool(torch.isfinite(g).all()) and g.shape == (1, 1, cfg.padded_vocab)
                 for g in bf16["kernel"])
    out: dict = {"bf16_kernel_vs_plain_rel_l2": worst}
    log(f"[serve] {cfg.name}: bf16 kernel vs plain path over the prefill ({L} tokens) and "
        f"{steps} decode steps: worst rel_l2 {worst:.3e} (reported, not gated: the model's "
        f"rounding noise); logits finite, shape (1, 1, {cfg.padded_vocab}): {finite}")
    if not finite:
        FAILURES.append(f"{cfg.name}: kernel-path logits not finite or misshapen")
    if fp32_kernels:
        with in_fp32(torch, model):
            runs = run_all({"plain": refs, "kernel": None, **variants})
        limit, measure = FP32_LOGITS_REL_L2, "worst rel_l2 to the fp32 plain path"
        reading = {name: max(rel_l2(g, w) for g, w in zip(runs[name], runs["plain"]))
                   for name in runs if name != "plain"}
        plain = [rel_l2(p, r) for p, r in zip(bf16["plain"], runs["plain"])]
    else:
        bf16.update(run_all(variants))
        with in_fp32(torch, model):
            ref = path_logits(model, prompt, toks, cache_len, refs, enc)
        plain = [rel_l2(p, r) for p, r in zip(bf16["plain"], ref)]
        limit = FP32_ERROR_RATIO
        measure = "worst ratio of its rel_l2 to the fp32 path to the plain bf16 path's"
        reading = {name: max(rel_l2(g, r) / e for g, r, e in zip(bf16[name], ref, plain))
                   for name in bf16 if name != "plain"}
    out["bf16_plain_vs_fp32_rel_l2"] = plain
    log(f"[serve] {cfg.name}: the plain bf16 path against the fp32 plain path: rel_l2 "
        + ", ".join(f"{e:.3e}" for e in plain) + " (prefill, then each step)")
    for name, r in reading.items():
        fault = name.startswith("fault")
        ok = (r > limit) if fault else (r <= limit)
        verdict = ("caught" if ok else "MISSED") if fault else ("ok" if ok else "FAIL")
        log(f"[serve] {cfg.name}: {name}: {measure} {r:.3e} (limit {limit:g}) {verdict}")
        out.setdefault("readings", {})[name] = r
        if not ok:
            FAILURES.append(f"{cfg.name} logits gate, {name}: {r:.3e} against {limit:g}")
    out["gate_limit"] = limit
    return out


def kernel_vs_plain(torch, model, refs, limit: float, *, cache_len: int) -> dict:
    """The served model, kernel path vs plain path: a ragged 241-token prompt,
    then one decode step from each path's own caches; rel-L2 of the logits.
    The plain path routes each MoE token to the experts the kernel path chose
    (a top-k is discontinuous: one bf16 step in a hidden state can swap a
    near-tie, which is not the kernels' error); how many choices that
    replaced, and the rel-L2 with the plain path's own routing, are reported
    beside it, not gated."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    L = 241
    prompt = torch.randint(0, cfg.vocab_size, (1, L), generator=gen, device="cuda")
    chosen: dict[str, list] = {"prefill": [], "decode": []}
    with routing(record=chosen["prefill"]):
        logits_k, caches_k = model.prefill(prompt)
    with plain_path(refs), routing(replay=chosen["prefill"]) as replaced_prefill:
        logits_p, caches_p = model.prefill(prompt)
    with plain_path(refs):
        logits_free = model.prefill(prompt)[0]
    nxt = logits_p[:, -1].argmax(-1, keepdim=True)
    steps, replaced = {}, {"prefill": replaced_prefill[0]}
    for name, caches in (("kernel", caches_k), ("plain", caches_p)):
        full = model.init_caches(1, cache_len)
        fill_caches(full, caches, L)
        if name == "kernel":
            with routing(record=chosen["decode"]):
                steps[name] = model.decode_step(nxt, L, full)[0]
        else:
            with plain_path(refs), routing(replay=chosen["decode"]) as r:
                steps[name] = model.decode_step(nxt, L, full)[0]
            replaced["decode"] = r[0]
    out = {}
    n_routed = {k: sum(int(i.numel()) for i in v) for k, v in chosen.items()}
    for what, key, got, want in (("prefill logits", "prefill", logits_k, logits_p),
                                 ("decode-step logits", "decode", steps["kernel"],
                                  steps["plain"])):
        g, w = got.float(), want.float()
        rel = float((g - w).norm() / w.norm())
        same = float((g.argmax(-1) == w.argmax(-1)).float().mean())
        ok = bool(torch.isfinite(g).all()) and g.shape == (1, 1, cfg.padded_vocab) \
            and rel <= limit
        routed = ""
        if n_routed[key]:
            routed = (f"; plain path routed as the kernel path: {replaced[key]} of "
                      f"{n_routed[key]} expert choices replaced")
        log(f"[serve] {cfg.name}: {what} ({L}-token prompt), kernel vs plain path: rel_l2 "
            f"{rel:.3e} (limit {limit:g}), max_abs {float((g - w).abs().max()):.3e}, "
            f"|logits|max {float(w.abs().max()):.3f}, argmax agree {same:.0%}{routed} "
            f"{'ok' if ok else 'FAIL'}")
        tag = what.replace(" ", "_").replace("-", "_")
        out[f"{tag}_rel_l2"] = rel
        if n_routed[key]:
            out[f"{tag}_routing_replaced"] = replaced[key]
            out[f"{tag}_routing_choices"] = n_routed[key]
        if not ok:
            FAILURES.append(f"{cfg.name} {what}: rel_l2 {rel:.3e}")
    if n_routed["prefill"]:
        free = float((logits_k.float() - logits_free.float()).norm() / logits_free.float().norm())
        out["prefill_logits_rel_l2_own_routing"] = free
        log(f"[serve] {cfg.name}: prefill logits with the plain path's own routing: rel_l2 "
            f"{free:.3e} (reported, not gated)")
    return out


def profile_calls(torch, label: str, fn, n: int = 5) -> dict | None:
    """Device busy share, device operations (kernels, copies) per call and
    time by kernel over ``n`` calls of ``fn``, after two warm calls."""
    try:
        from torch.profiler import ProfilerActivity, profile
    except ImportError:
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels, dev_total, ops = [], 0.0, 0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue  # host-side ops; their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / (n * 1e3), e.key, e.count // n))
            dev_total += us / (n * 1e3)
            ops += e.count
    kernels.sort(reverse=True)
    if not kernels:
        log(f"[profile] {label}: no device time in the trace: device busy share not measured")
        return None
    log(f"[profile] {label}: {wall_ms:.3f} ms wall, device busy {dev_total:.3f} ms "
        f"({dev_total / wall_ms:.0%}), {ops / n:.0f} device operations a call; top kernels by "
        "device time:")
    for ms, key, count in kernels[:8]:
        log(f"[profile]   {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_total, "device_ops": ops / n,
            "top": [dict(ms=ms, name=key, per_call=count) for ms, key, count in kernels[:12]]}


def profile_decode(torch, model, *, slots: int, pos: int, cache_len: int) -> dict | None:
    """``profile_calls`` over 5 decode steps at ``pos``, and over 3 prefills
    of a 256-token prompt (under "prefill")."""
    name = model.cfg.name
    tok = torch.zeros((slots, 1), dtype=torch.long, device="cuda")
    caches = model.init_caches(slots, cache_len)
    out = profile_calls(torch, f"{name} decode step at pos {pos}, {slots} slots",
                        lambda: model.decode_step(tok, pos, caches))
    del caches
    prompt = torch.zeros((1, 256), dtype=torch.long, device="cuda")
    prefill = profile_calls(torch, f"{name} prefill of 256 tokens", lambda: model.prefill(prompt),
                            n=3)
    if out is not None:
        out["prefill"] = prefill
    return out


# ---------------------------------------------------------------------------
# the hybrid serving path: the selective scan and jamba at full width


def scan_inputs(torch, gen, B, T, D, N, dtype, *, h0=False, fused=False):
    """dt = softplus(N(0,1)) * 0.1, u, B, C ~ N(0,1), A = -exp(N(0,1) / 2) as
    the mixer makes them, on the card; ``fused`` gives B and C as column
    slices of one (B, T, dtr + 2N) tensor, the mixer's x_proj output at
    jamba's width (dtr 256)."""
    dt = (torch.nn.functional.softplus(torch.randn(B, T, D, generator=gen, device="cuda"))
          * 0.1).to(dtype)
    u = torch.randn(B, T, D, generator=gen, device="cuda").to(dtype)
    A = -torch.exp(torch.randn(D, N, generator=gen, device="cuda") * 0.5)
    if fused:
        dbc = torch.randn(B, T, 256 + 2 * N, generator=gen, device="cuda").to(dtype)
        Bc, Cc = dbc[..., 256:256 + N], dbc[..., 256 + N:]
    else:
        Bc = torch.randn(B, T, N, generator=gen, device="cuda").to(dtype)
        Cc = torch.randn(B, T, N, generator=gen, device="cuda").to(dtype)
    h = torch.randn(B, D, N, generator=gen, device="cuda") if h0 else None
    return dt, Bc, Cc, u, A, h


def phase_check_ssm(torch, ck: Checker, ssm_scan, scan_ref) -> None:
    """The selective scan against its plain loop at the hybrid path's shapes
    and the lane groups' edges (N / G ragged or N < G, D not a multiple of a
    CTA's channels, rows off 16 bytes, T of 1, 33 and 241), through the
    wrapper and through every neighbour of its plan (G in {4, 8, 16}, y
    reduced by shuffles each step or reduce-scattered)."""
    from repro_torch.kernels.ssm_scan import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((1, 241, 8192, 16), bf16, False, False, "jamba prefill, ragged T, h0 zeros"),
        ((4, 1, 8192, 16), bf16, True, False, "jamba decode step, random h0"),
        ((2, 37, 200, 16), bf16, True, False, "ragged T and D"),
        ((3, 64, 256, 4), f32, True, False, "N = 4 (the reduced config), fp32"),
        ((2, 96, 8192, 16), bf16, True, True, "B, C strided slices of x_proj"),
        ((2, 33, 200, 16), bf16, False, True, "D ragged in a CTA, strided B/C, no h0"),
        ((2, 33, 203, 7), bf16, True, False, "odd D, N = 7: plain loads"),
        ((4, 241, 1000, 7), bf16, False, True, "N = 7 strided, T = 241"),
        ((3, 241, 96, 1), f32, False, False, "N = 1, below every group"),
        ((2, 1, 128, 4), f32, True, True, "N = 4, T = 1, fp32 B/C by cp.async"),
        ((1, 33, 8192, 4), bf16, True, True, "N = 4 bf16: 8-byte rows, plain loads"),
    ]
    for shape, dtype, h0, fused, note in cases:
        what = f"{shape} {str(dtype)[6:]}: {note}"

        def case(shape=shape, dtype=dtype, h0=h0, fused=fused, what=what):
            args = scan_inputs(torch, gen, *shape, dtype, h0=h0, fused=fused)
            ry, rh = scan_ref(*args)
            ytol = SCAN_Y_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            y, h = ssm_scan(*args)
            ck.compare("ssm_scan", f"y {what}", y, ry, ytol)
            ck.compare("ssm_scan", f"h_final {what}", h, rh, SCAN_H_TOL)
            if y.dtype != dtype or h.dtype != torch.float32:
                FAILURES.append(f"ssm_scan {what}: dtypes {y.dtype}/{h.dtype}")
            for group in ops.GROUPS:
                for reduce in ops.REDUCTIONS:
                    p = ops.scan_plan(*shape, args[3].element_size(), n_sm, group=group,
                                      reduce=reduce)
                    y, h = ops._launch(*args, p)
                    tag = f"G {group} {reduce} {shape}"
                    ck.compare("ssm_scan", f"y {tag}", y, ry, ytol)
                    ck.compare("ssm_scan", f"h_final {tag}", h, rh, SCAN_H_TOL)
        ck.run("ssm_scan", what, case)

    def refuses():
        dt, Bc, Cc, u, A, h0 = scan_inputs(torch, gen, 2, 8, 64, 16, torch.bfloat16, h0=True)
        wrong = {
            "float16 inputs": (TypeError, (dt.half(), Bc.half(), Cc.half(), u.half(), A, h0)),
            "a wrong shape": (ValueError, (dt, Bc, Cc, u[:, :4], A, h0)),
            "a CPU h0 with CUDA inputs": (ValueError, (dt, Bc, Cc, u, A, h0.cpu())),
        }
        for what, (exc, args) in wrong.items():
            try:
                ssm_scan(*args)
            except exc:
                log(f"[check] {'ssm_scan':16s} {what + ' raises ' + exc.__name__:52s} ok")
                continue
            FAILURES.append(f"ssm_scan accepted {what}")
    ck.run("ssm_scan", "wrong inputs refused", refuses)
    torch.cuda.synchronize()


def scan_bound(B, T, D, N, elt: int, h0: bool) -> tuple[float, str, dict]:
    """max(bytes / HBM rate, exps / MUFU rate, flops / fp32 peak) for one
    scan: dt, u read and y written at their dtype, B and C read, A read, h0
    read when given and h_final written, in fp32; one exponential and 6 fp32
    operations per (t, d, n) (dt*A, decay*h, (dt u)*B, +, h*C, +) and one per
    (t, d) (dt*u)."""
    nbytes = 3 * B * T * D * elt + 2 * B * T * N * elt + D * N * 4 + (1 + h0) * B * D * N * 4
    t_bytes = nbytes / HBM_BPS * 1e3
    t_exp = B * T * D * N / MUFU_OPS * 1e3
    t_flop = (6 * B * T * D * N + B * T * D) / FP32_OPS * 1e3
    b_ms, b_by = max((t_bytes, "bytes"), (t_exp, "operations"), (t_flop, "operations"))
    return b_ms, b_by, dict(bytes_ms=t_bytes, exp_ms=t_exp, flop_ms=t_flop)


def phase_time_ssm(torch, ssm_scan, scan_ref) -> list[dict]:
    """Device time per call by CUDA-graph replay at jamba's decode step and
    full-width prefill, beside the plain loop's, the eager time from Python
    and the bound, and the plan's neighbours timed beside it. No single
    PyTorch call computes a selective scan."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(55)
    rows = []
    for shape, h0, what in (((4, 1, 8192, 16), True, "decode step"),
                            ((1, 241, 8192, 16), False, "prefill")):
        args = scan_inputs(torch, gen, *shape, torch.bfloat16, h0=h0)
        b_ms, b_by, parts = scan_bound(*shape, 2, h0)
        T = shape[1]
        r = dict(shape=f"dt, u ({shape[0]},{T},{shape[2]}) bf16, N {shape[3]} ({what})",
                 ms=device_ms(torch, lambda: ssm_scan(*args)),
                 plain_ms=device_ms(torch, lambda: scan_ref(*args), calls=2 if T > 1 else 20,
                                    replays=3 if T > 1 else 10),
                 library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_parts=parts,
                 eager_ms=eager_ms(torch, lambda: ssm_scan(*args)))
        rows.append(r)
        log(f"[time] {'ssm_scan':16s} {r['shape']:44s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library none (no single call)  bound {b_ms:.5f} ms "
            f"({b_by}: bytes {parts['bytes_ms']:.5f}, exps {parts['exp_ms']:.5f}, fp32 "
            f"{parts['flop_ms']:.5f});  eager from Python: kernel {r['eager_ms']:.4f} ms")
        r["plan_variants"] = scan_plan_variants(torch, args, scan_ref)
        r["plan_host"] = scan_plan_host(torch, args)
    return rows


def scan_plan_host(torch, args) -> dict:
    """Host time per call of what the wrapper decides before it launches: the
    plan (a cached lookup, beside planning anew) and the cp.async row test."""
    from repro_torch.kernels.ssm_scan import ops

    dt, Bc, Cc, u, A, h0 = args
    key = (*u.shape, A.shape[1], u.element_size(),
           torch.cuda.get_device_properties(0).multi_processor_count)
    plan = ops.scan_plan(*key)
    out = dict(cached_us=host_us(lambda: ops.scan_plan(*key)),
               uncached_us=host_us(lambda: ops.scan_plan.__wrapped__(*key)),
               async_rows_us=host_us(lambda: ops._async_rows(dt, Bc, Cc, u, plan)))
    log(f"[time] {'ssm_scan':16s} host time per call at {tuple(u.shape)}: plan "
        f"{out['cached_us']:.3f} us (planned anew: {out['uncached_us']:.3f} us), cp.async row "
        f"test {out['async_rows_us']:.3f} us")
    return out


def scan_plan_variants(torch, args, scan_ref) -> list[dict]:
    """The selective scan's plan and its neighbours at one shape: G in {4, 8,
    16} lanes per channel, each reduction of y, and reduce-scattered tiles of
    half as many steps; each held to the plain loop and timed in this call.
    A neighbour that misses the tolerances fails the run."""
    from repro_torch.kernels.ssm_scan import ops

    dt, Bc, Cc, u, A, h0 = args
    B, T, D = u.shape
    N = A.shape[1]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ops.scan_plan(B, T, D, N, u.element_size(), n_sm)
    ry, rh = scan_ref(*args)
    out = []
    combos = list(itertools.product(ops.GROUPS, ops.REDUCTIONS, (None,)))
    combos += [(g, "scatter", ops.TILE_T // 2) for g in ops.GROUPS if T > ops.TILE_T // 2]
    for group, reduce, tile in combos:
        p = ops.scan_plan(B, T, D, N, u.element_size(), n_sm, group=group, reduce=reduce,
                          tile_t=tile)
        y, h = ops._launch(*args, p)
        y_err, h_err = (y.float() - ry.float()).abs(), (h - rh).abs()
        ytol, htol = SCAN_Y_BF16_TOL, SCAN_H_TOL
        held = bool((y_err <= ytol["atol"] + ytol["rtol"] * ry.float().abs()).all()) and bool(
            (h_err <= htol["atol"] + htol["rtol"] * rh.abs()).all())
        row = dict(group=group, reduce=reduce, tile_t=p.tile_t, held=held,
                   planned=(group, reduce, p.tile_t) == (plan.group, plan.reduce, plan.tile_t),
                   y_max_abs_err=float(y_err.max()), h_max_abs_err=float(h_err.max()),
                   ms=device_ms(torch, lambda: ops._launch(*args, p)))
        out.append(row)
        if not held:
            FAILURES.append(f"ssm_scan plan G {group} {reduce} at ({B},{T},{D},{N}): outside "
                            "the tolerances")
        log(f"[time] {'ssm_scan':16s} plan ({B},{T},{D},{N}) G {group:2d} {reduce:7s} "
            f"tile {p.tile_t:2d}: {row['ms']:.5f} ms, y err "
            f"{row['y_max_abs_err']:.2e}, h err {row['h_max_abs_err']:.2e}, "
            f"{'within' if held else 'OUTSIDE'} the tolerances"
            + (" (the plan)" if row["planned"] else ""))
    return out


def phase_serve_hybrid(torch, refs) -> dict:
    """Jamba at full width, 2 of 4 superblocks, through the serving CLI's path."""
    engine, gw, out, launches, n_prefill, n_decode = serve_full_width(
        torch, "serve_hybrid", HYBRID_ARGV, "jamba_v0_1_52b", requests=8, max_new=16, rps=4.0,
        cut="2 of 4 superblocks")
    cfg, model = engine.cfg, engine.model
    if cfg.num_superblocks != 2:
        FAILURES.append(f"hybrid served {cfg.num_superblocks} superblocks, not 2")
    out["superblocks"] = f"{cfg.num_superblocks} of 4"
    floor_ms = 2 * out["params"] / HBM_BPS * 1e3
    out["serve"]["decode_floor_ms"] = floor_ms
    log(f"[serve_hybrid] decode-step weight-read floor 2 x {out['params']:,} B / 3.35 TB/s = "
        f"{floor_ms:.3f} ms (the dense dispatch runs every expert over a capacity buffer of "
        "at least 4)")
    n_mamba = sum(spec.mixer == "mamba" for spec in cfg.superblock) * cfg.num_superblocks
    n_attn = cfg.num_layers - n_mamba
    L = cfg.num_layers
    expect = {"rmsnorm": 2 * n_prefill + n_decode,
              "rmsnorm_add": (2 * L - 1) * n_prefill + 2 * L * n_decode,
              "flash_attention": n_attn * n_prefill, "decode_attention": n_attn * n_decode,
              "lindley_scan": 0, "lindley_kserver": 0, "decision_scan": 0,
              "ssm_scan": n_mamba * (n_prefill + n_decode)}
    check_launches("serve_hybrid", launches, expect,
                   f"{n_prefill} prefills (2 rmsnorm + {2 * L - 1} rmsnorm_add + {n_attn} flash + "
                   f"{n_mamba} ssm_scan each) and {n_decode} decode steps (1 rmsnorm + {2 * L} "
                   f"rmsnorm_add + {n_attn} decode + {n_mamba} ssm_scan each)")
    out["launches"] = launches
    out["gateway"] = check_gateway("serve_hybrid", engine, gw, rps=4.0)

    out.update(kernel_vs_plain(torch, model, refs, HYBRID_LOGITS_REL_L2, cache_len=512))
    out["profile"] = profile_decode(torch, model, slots=4, pos=300, cache_len=512)
    del engine, model, gw
    return out


# ---------------------------------------------------------------------------
# gemma2 (sliding-window ring-buffer decode, head dim 256) and xLSTM at full width

# gemma2-9B, nothing cut: 8 Poisson requests at 2 rps, prompts 4608 +/- 256
# (every one past the 4096 window), 32 new tokens, 4 slots of 4928 positions
LOCAL_ARGV = ["--arch", "gemma2_9b", "--requests", "8", "--rps", "2", "--prompt-len", "4608",
              "--prompt-jitter", "256", "--max-new", "32", "--slots", "4", "--max-seq", "4928",
              "--device", "cuda"]
# xLSTM-1.3B, nothing cut: 8 Poisson requests at 4 rps, prompts 256 +/- 64, 16
# new tokens, 4 slots of 384 positions
XLSTM_ARGV = ["--arch", "xlstm_1_3b", "--requests", "8", "--rps", "4", "--prompt-len", "256",
              "--prompt-jitter", "64", "--max-new", "16", "--slots", "4", "--max-seq", "384",
              "--device", "cuda"]
# the logits gates of these two cells (``logits_gate``). The bf16 kernel path
# sits at the model's own rounding noise from the bf16 plain path (gemma2
# 2.9e-2, as far as a control that only reorders the norms' sums; xLSTM 3.5e-2,
# its bf16 logits 0.49-0.63 from its own float32 evaluation, so that two bf16
# paths can land anywhere up to that apart), so no limit on that difference
# separates a faulty kernel from a correct one. xLSTM's kernels take float32, so it is
# held in float32 against its plain path: kernel path 5.26e-5, control
# 5.20e-5, norms storing through bf16 4.4e-1, so 1e-3. gemma2's flash kernel
# takes bf16 only, so its error against the fp32 plain path is held to a
# multiple of the plain bf16 path's: kernel path 1.006, control 1.036, local
# prefill without the window 1.87, a full ring read as an append cache 14.3,
# so 1.5 (readings on an H100 80GB HBM3 at 700 W)
FP32_LOGITS_REL_L2 = 1e-3
FP32_ERROR_RATIO = 1.5


def xlstm_launches(cfg, prefills: int, decodes: int) -> tuple[dict[str, int], str]:
    """Every kernel's launches for that many prefills and decode steps of an
    xLSTM whose L blocks have no FFN (so no norm2), X of them recurrent
    cells with a head norm, and the formula: per prefill 1 + X + 1 rmsnorm
    (layer 0's norm1, the head norms, the final norm of the last position)
    and L - 1 rmsnorm_add (every other norm1 fused with the mixer's add);
    per decode step 1 + X rmsnorm and L rmsnorm_add (the final norm fused)."""
    L = cfg.num_layers
    X = sum(spec.mixer in ("mlstm", "slstm") for spec in cfg.superblock) * cfg.num_superblocks
    counts = {"rmsnorm": (2 + X) * prefills + (1 + X) * decodes,
              "rmsnorm_add": (L - 1) * prefills + L * decodes,
              "flash_attention": 0, "decode_attention": 0, "lindley_scan": 0,
              "lindley_kserver": 0, "decision_scan": 0, "ssm_scan": 0}
    formula = (f"per prefill 1 + X + 1 = {2 + X} rmsnorm and L - 1 = {L - 1} rmsnorm_add, per "
               f"decode step 1 + X = {1 + X} and L = {L} (L = {L} blocks, X = {X} head norms)")
    return counts, formula


def phase_serve_local(torch, refs) -> dict:
    """gemma2-9B at full width: 21 local layers (a 4096-token window, ring
    caches of 4096 slots) and 21 global ones, head dim 256, soft-caps 50 and
    30, through the serving CLI's path; every prompt longer than the window,
    so each prefill masks the window and rolls the ring and each decode step
    writes past its wrap."""
    engine, gw, out, launches, n_prefill, n_decode = serve_full_width(
        torch, "serve_local", LOCAL_ARGV, "gemma2_9b", requests=8, max_new=32, rps=2.0)
    cfg, model = engine.cfg, engine.model
    W = cfg.window_size
    shortest = min(len(r.prompt) for r in engine.completed)
    log(f"[serve_local] shortest prompt {shortest} tokens, window {W}: every prompt past the "
        f"window {'ok' if shortest > W else 'FAIL'}")
    if shortest <= W:
        FAILURES.append(f"serve_local: a {shortest}-token prompt does not pass the {W} window")
    L = cfg.num_layers
    check_launches("serve_local", launches, serving_launches(L, n_prefill, n_decode),
                   f"{n_prefill} prefills (2 rmsnorm + 2L - 1 = {2 * L - 1} rmsnorm_add + L = "
                   f"{L} flash each) and {n_decode} decode steps (1 rmsnorm + 2L = {2 * L} "
                   f"rmsnorm_add + L = {L} decode each), L = {L}")
    out["launches"] = launches
    # a decode step's floor at pos 4700: the weights once, then every layer's K
    # and V over the keys it attends (4701 on a global layer, the 4096-slot ring
    # on a local one) for 4 slots
    n_local = sum(sp.mixer == "attn_local" for sp in cfg.superblock) * cfg.num_superblocks
    kv_bytes = 2 * 4 * cfg.num_kv_heads * cfg.resolved_head_dim * 2  # K and V, 4 slots, bf16
    weights_ms = 2 * out["params"] / HBM_BPS * 1e3
    cache_ms = (n_local * W + (L - n_local) * 4701) * kv_bytes / HBM_BPS * 1e3
    out["serve"].update(decode_floor_ms=weights_ms + cache_ms, weights_floor_ms=weights_ms,
                        cache_floor_ms=cache_ms)
    log(f"[serve_local] decode-step floor at pos 4700: weights 2 x {out['params']:,} B / 3.35 "
        f"TB/s = {weights_ms:.3f} ms + K/V reads {cache_ms:.3f} ms = {weights_ms + cache_ms:.3f} "
        f"ms; measured mean {out['serve']['decode_step_ms_mean']:.3f} ms over all positions")
    out["gateway"] = check_gateway("serve_local", engine, gw, rps=2.0)
    # a ragged prompt past the window, then decode steps past the ring's wrap
    out["logits"] = logits_gate(torch, model, refs, gemma2_faults(torch, refs), cache_len=4928,
                                prompt_len=4353, steps=4, fp32_kernels=False)
    out["profile"] = profile_decode(torch, model, slots=4, pos=4700, cache_len=4928)
    del engine, model, gw
    return out


def phase_serve_xlstm(torch, refs) -> dict:
    """xLSTM-1.3B at full width: 6 sLSTM and 42 mLSTM blocks, no FFN, through
    the serving CLI's path; the cells in plain torch around the RMSNorm
    kernels."""
    engine, gw, out, launches, n_prefill, n_decode = serve_full_width(
        torch, "serve_xlstm", XLSTM_ARGV, "xlstm_1_3b", requests=8, max_new=16, rps=4.0)
    cfg, model = engine.cfg, engine.model
    expect, formula = xlstm_launches(cfg, n_prefill, n_decode)
    check_launches("serve_xlstm", launches, expect,
                   f"{n_prefill} prefills and {n_decode} decode steps: {formula}")
    out["launches"] = launches
    out["launch_formula"] = formula
    # a decode step's floor: the weights once, then the mLSTM states (C and n,
    # fp32, 4 slots) read and written
    n_mlstm = sum(sp.mixer == "mlstm" for sp in cfg.superblock) * cfg.num_superblocks
    H = cfg.num_heads
    hd = cfg.d_model // H
    weights_ms = 2 * out["params"] / HBM_BPS * 1e3
    state_ms = 2 * n_mlstm * 4 * H * (hd * hd + hd) * 4 / HBM_BPS * 1e3
    out["serve"].update(decode_floor_ms=weights_ms + state_ms, weights_floor_ms=weights_ms,
                        state_floor_ms=state_ms)
    log(f"[serve_xlstm] decode-step floor: weights 2 x {out['params']:,} B / 3.35 TB/s = "
        f"{weights_ms:.3f} ms + mLSTM states read and written {state_ms:.3f} ms = "
        f"{weights_ms + state_ms:.3f} ms; measured mean "
        f"{out['serve']['decode_step_ms_mean']:.3f} ms")
    out["gateway"] = check_gateway("serve_xlstm", engine, gw, rps=4.0)
    out["logits"] = logits_gate(torch, model, refs, xlstm_faults(torch, refs), cache_len=384,
                                prompt_len=241, steps=4, fp32_kernels=True)
    out["profile"] = profile_decode(torch, model, slots=4, pos=300, cache_len=384)
    del engine, model, gw
    return out


# ---------------------------------------------------------------------------
# seamless: the encoder-decoder at full width through the model's entry points


def encdec_faults(torch) -> dict:
    """The planted faults seamless's logits gate must refuse, each a swap of
    a model function: rotary on the cross-attention (k at its frame
    positions 0..Se-1, so in the cache too; q at its positions in the call,
    0 for decode's lone query, as the reference's attention numbers one); a
    causal mask in the encoder; cross decode attending only the first half
    of the frames."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import rope_apply

    cross_kv, cross_attn, attn_forward = A.cross_kv, A.cross_attn_forward, A.attn_forward

    def rope(t, cfg):
        return rope_apply(t, torch.arange(t.shape[1], device=t.device), cfg.rope_theta)

    def roped_kv(p, enc_out, cfg):
        k, v = cross_kv(p, enc_out, cfg)
        return rope(k, cfg), v

    def roped_cross(p, x, k, v, cfg, *, decode=False):
        B, S, _ = x.shape
        q = rope((x @ p["wq"]).view(B, S, cfg.num_heads, cfg.resolved_head_dim), cfg)
        out = (A.decode_attention(q, k, v, k.shape[1] - 1) if decode
               else A.flash_attention(q, k, v, causal=False))
        return out.reshape(B, S, -1) @ p["wo"]

    def causal(p, x, cfg, **kw):
        return attn_forward(p, x, cfg, **{**kw, "causal": True})

    def half_frames(p, x, k, v, cfg, *, decode=False):
        if decode:
            k, v = k[:, :k.shape[1] // 2], v[:, :v.shape[1] // 2]
        return cross_attn(p, x, k, v, cfg, decode=decode)

    return {"rotary on the cross-attention's q and k": {"attention.cross_kv": roped_kv,
                                                        "attention.cross_attn_forward":
                                                            roped_cross},
            "a causal mask in the encoder": {"attention.attn_forward": causal},
            "cross decode over the first half of the frames": {
                "attention.cross_attn_forward": half_frames}}


def encdec_launches(cfg, prefills: int, decodes: int) -> tuple[dict[str, int], str]:
    """Every kernel's launches for that many encode + prefill calls and
    decode steps of an encoder-decoder with Le encoder and L decoder layers,
    and the formula. Per prefill: rmsnorm 3 (the encoder's and the decoder's
    first norm1, the final norm of the last position), rmsnorm_add 2Le (the
    encoder's norm2s, its later norm1s and its final norm) + 3L - 1 (norm_cross,
    norm2, the later norm1s), flash Le + 2L (encoder, self, cross); per step:
    rmsnorm 1, rmsnorm_add 3L (the final norm fused), decode 2L (self, cross)."""
    Le, L = cfg.encoder_layers, cfg.num_layers
    counts = {"rmsnorm": 3 * prefills + decodes,
              "rmsnorm_add": (2 * Le + 3 * L - 1) * prefills + 3 * L * decodes,
              "flash_attention": (Le + 2 * L) * prefills, "decode_attention": 2 * L * decodes,
              "lindley_scan": 0, "lindley_kserver": 0, "decision_scan": 0, "ssm_scan": 0}
    formula = (f"per encode + prefill 3 rmsnorm, 2Le + 3L - 1 = {2 * Le + 3 * L - 1} "
               f"rmsnorm_add, Le + 2L = {Le + 2 * L} flash; per decode step 1 rmsnorm, 3L = "
               f"{3 * L} rmsnorm_add, 2L = {2 * L} decode (Le = {Le}, L = {L})")
    return counts, formula


def greedy(model, prompt, frames, steps: int, sync=None) -> tuple[list, list, list, float]:
    """Encode + prefill, caches of prompt + steps positions and every frame,
    then ``steps`` greedy decode steps (argmax over the padded vocabulary, as
    the reference's engine takes it). Returns (every step's logits, the
    tokens, the caches, the mean step's ms), left on the card: without
    ``sync`` nothing here waits for it and the step time is nan; with it
    (``torch.cuda.synchronize``) the decode loop runs between two syncs."""
    P = prompt.shape[1]
    logits, part = model.prefill(prompt, enc_embeds=frames)
    caches = model.init_caches(prompt.shape[0], P + steps, enc_len=frames.shape[1])
    fill_caches(caches, part, P)
    del part
    out, toks = [logits], [logits[:, -1].argmax(-1)]
    if sync:
        sync()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = model.decode_step(toks[-1][:, None], P + i, caches)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1))
    if not sync:
        return out, toks, caches, float("nan")
    sync()
    return out, toks, caches, (time.perf_counter() - t0) * 1e3 / max(steps, 1)


def phase_encdec(torch, refs) -> dict:
    """seamless_m4t_large_v2 at full width (24 encoder + 24 decoder layers,
    nothing cut) through ``LM.encode``, ``LM.prefill(..., enc_embeds=)`` and
    ``LM.decode_step``, as the reference's ``make_prefill_step`` and
    ``make_decode_step`` call them (its engine cannot serve an
    encoder-decoder: ROADMAP C11). Four 30 s utterances (1500 frames at the
    encoder's 50 frames/s, stub embeddings from a seed), 2-token prompts
    (</s>, id 3, and a tag id from the seed), 64 greedy steps; then one
    ragged utterance of 613 frames and 4 steps; launch counts exact over
    both; the logits gate with three planted faults; encode + prefill and
    decode steps beside their floors; peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, num_params

    cfg = get_config("seamless_m4t_large_v2")
    B, Se, P, steps = SEAMLESS_B, SEAMLESS_SE, SEAMLESS_PROMPT, SEAMLESS_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = model.num_params()
    out: dict = {"params": n_params, "build_s": time.perf_counter() - t0}
    log(f"[encdec] {cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
        f"{n_params:,} params ({2 * n_params / 1e9:.2f} GB bf16, nothing cut), built on the card "
        f"in {out['build_s']:.2f} s")
    if n_params != num_params(cfg):
        FAILURES.append(f"encdec: {n_params} params, the template says {num_params(cfg)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def utterances(n, frames):
        emb = torch.randn((n, frames, cfg.d_model), generator=gen, device="cuda").bfloat16()
        tags = torch.randint(0, cfg.vocab_size, (n, 1), generator=gen, device="cuda")
        return torch.cat([torch.full_like(tags, 3), tags], 1), emb

    prompt, frames = utterances(B, Se)
    r_prompt, r_frames = utterances(1, 613)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, toks, _, _ = greedy(model, prompt, frames, steps)
    r_logits, r_toks, _, _ = greedy(model, r_prompt, r_frames, 4)
    torch.cuda.synchronize()
    out["main_wall_s"] = time.perf_counter() - t0
    launches = read_counts()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    expect, formula = encdec_launches(cfg, 2, steps + 4)
    check_launches("encdec", launches, expect, f"2 encode + prefill calls and {steps} + 4 "
                   f"decode steps: {formula}")
    out.update(launches=launches, launch_formula=formula)
    ok = all(bool(torch.isfinite(lg).all()) and lg.shape[1:] == (1, cfg.padded_vocab)
             for lg in logits + r_logits)
    ids = torch.cat([torch.stack(toks).flatten(), torch.stack(r_toks).flatten()]).cpu()
    past = int((ids >= cfg.vocab_size).sum())
    out.update(tokens=int(ids.numel()), ids_past_vocab=past, logits_finite=ok)
    log(f"[encdec] {B} utterances of {Se} frames, prompts of {P} tokens, {steps} greedy steps; "
        f"then 1 of 613 frames and 4 steps: {out['main_wall_s']:.2f} s wall; logits finite, "
        f"shape (B, 1, {cfg.padded_vocab}): {ok}; {ids.numel()} tokens, {past} at or above the "
        f"vocabulary's {cfg.vocab_size} (argmax over the padded {cfg.padded_vocab}, ROADMAP C6); "
        f"peak memory {out['peak_mem_gib']:.2f} GiB")
    if not ok or not bool(((ids >= 0) & (ids < cfg.padded_vocab)).all()):
        FAILURES.append("encdec: logits not finite or misshapen, or ids outside the padded vocab")

    # encode + prefill: host clock around synchronised calls, and a profile
    # against the compute floor (the decoder's 2-token prefill left out)
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompt, enc_embeds=frames)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    Le, L, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model
    H, hd, K = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    enc_w = sum(p.numel() for p in model.encoder.layers.parameters() if p.dim() == 2)
    flops = {"encoder matmuls": 2 * enc_w * B * Se,
             "encoder attention": 4 * B * Se * Se * H * hd * Le,
             "cross K/V projections": 2 * 2 * d * K * hd * B * Se * L}
    floor_ms = sum(flops.values()) / BF16_OPS * 1e3
    out["prefill"] = dict(wall_ms=calls, floor_ms=floor_ms, flops=flops)
    log(f"[encdec] encode + prefill ({B} x {Se} frames, {P} tokens): "
        + ", ".join(f"{c:.3f}" for c in calls) + " ms (host clock, synchronised); compute floor "
        + " + ".join(f"{k} {v / 1e12:.3f}" for k, v in flops.items())
        + f" TFLOP = {sum(flops.values()) / 1e12:.3f} TFLOP / 989 TFLOP/s = {floor_ms:.3f} ms")
    out["prefill"]["profile"] = profile_calls(
        torch, f"{cfg.name} encode + prefill, {B} x {Se} frames",
        lambda: model.prefill(prompt, enc_embeds=frames), n=2)

    # decode steps: the mean of 64 from the host clock (the greedy run once
    # more, outside the counted window), a profile at pos 34 beside the floor
    # (weights read: the decoder without the cross wk / wv, which only
    # prefill reads, and the unembedding; cross and self K/V reads)
    _, toks, caches, step_ms = greedy(model, prompt, frames, steps, sync=torch.cuda.synchronize)
    tok = toks[-1][:, None]
    pos = SEAMLESS_PROFILE_POS
    dec_w = sum(p.numel() for n, p in model.layers.named_parameters()
                if not n.endswith(("cross.wk", "cross.wv")))
    dec_w += model.embed["unembed"].numel() + model.final_norm.numel()
    kv_row = 2 * B * K * hd * 2  # K and V, every slot, bf16
    floor = {"weights": 2 * dec_w / HBM_BPS * 1e3, "cross K/V": L * Se * kv_row / HBM_BPS * 1e3,
             "self K/V": L * (pos + 1) * kv_row / HBM_BPS * 1e3}
    prof = profile_calls(torch, f"{cfg.name} decode step at pos {pos}, {B} slots",
                         lambda: model.decode_step(tok, pos, caches))
    out["decode"] = dict(step_ms=step_ms, floor_ms=floor, floor_total_ms=sum(floor.values()),
                         weights=dec_w, profile=prof)
    log(f"[encdec] decode step {step_ms:.3f} ms mean over {steps} (host clock, synchronised at "
        f"the ends); floor at pos {pos}: weights 2 x {dec_w:,} B / 3.35 TB/s = "
        f"{floor['weights']:.3f} ms + cross K/V {floor['cross K/V']:.3f} ms + self K/V "
        f"{floor['self K/V']:.4f} ms = {sum(floor.values()):.3f} ms")
    del caches
    out["logits"] = logits_gate(torch, model, refs, encdec_faults(torch), cache_len=8,
                                prompt_len=P, steps=4, fp32_kernels=False, enc_len=Se)
    del model
    return out


# ---------------------------------------------------------------------------
# the fleet path: Lindley scans, closed forms, the batched simulator, gates 1-3


def lindley_inputs(torch, gen, B, T, dtype, kind="exp"):
    """Poisson arrival clocks and exponential services, made on the card."""
    inter = torch.empty(B, T, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    if kind == "ties":
        inter[:, ::3] = 0.0  # every third job arrives with the one before it
    svc = torch.empty(B, T, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    svc.mul_(0.9)
    if kind == "zero":
        svc.zero_()
    return torch.cumsum(inter, dim=1).to(dtype), svc.to(dtype)


def sim_grids():
    """The simulator's two grids of SIM_ROWS scenarios: arrival rate by
    bandwidth, and the same with edge[0] at 1..4 servers (k the last axis,
    so row i has i % 4 + 1 servers)."""
    import numpy as np

    from repro_torch.fleet import ScenarioBatch
    from repro_torch.launch import fleet_sweep

    base = fleet_sweep.default_scenario()
    rates = np.linspace(0.5, 6.0, 64)
    batch = ScenarioBatch.from_sweep(base, {
        "workload.arrival_rate": rates,
        "network.bandwidth_Bps": np.geomspace(6.0 * 30_000 / 0.9, 100e6 / 8, 64)})
    batch_k = ScenarioBatch.from_sweep(base, {
        "workload.arrival_rate": rates,
        "network.bandwidth_Bps": np.geomspace(6.0 * 30_000 / 0.9, 100e6 / 8, 16),
        "edges[0].tier.parallelism_k": [1.0, 2.0, 3.0, 4.0]})
    if batch.size != SIM_ROWS or batch_k.size != SIM_ROWS:
        fail(f"simulation grids have {batch.size} and {batch_k.size} rows, not {SIM_ROWS}")
    return batch, batch_k


def phase_check_lindley(torch, ck: Checker, lindley, refs) -> None:
    """The Lindley kernels against their plain versions with torch.equal: a
    max and an add round exactly, so any difference is a bug."""
    lindley_scan, lindley_kserver = lindley
    scan_ref, kserver_ref = refs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    exact = dict(atol=0.0, rtol=0.0)

    cases = [(1, 5000, "exp"), (45, 3000, "exp"), (33, 130, "exp"), (300, 1000, "exp"),
             (64, 700, "zero"), (40, 2000, "ties")]
    for B, T, kind in cases:
        for dtype in (torch.float64, torch.float32):
            what = f"({B},{T}) {kind} {str(dtype)[6:]}"

            def case(B=B, T=T, kind=kind, dtype=dtype, what=what):
                arr, svc = lindley_inputs(torch, gen, B, T, dtype, kind)
                got, want = lindley_scan(arr, svc), scan_ref(arr, svc)
                ck.compare("lindley_scan", what, got, want, exact)
                if not torch.equal(got, want):
                    FAILURES.append(f"lindley_scan {what}: not bit-equal to the plain version")
            ck.run("lindley_scan", what, case)

    for B, T, k_max in ((70, 2000, 8), (4096, 300, 8), (5, 100, 1)):
        what = f"k-server ({B},{T}) k in 1..{k_max}"

        def kcase(B=B, T=T, k_max=k_max, what=what):
            arr, svc = lindley_inputs(torch, gen, B, T, torch.float64)
            svc.mul_(k_max)  # keep every k busy
            k = torch.randint(1, k_max + 1, (B,), generator=gen, device="cuda",
                              dtype=torch.int32)
            got, want = lindley_kserver(arr, svc, k, k_max), kserver_ref(arr, svc, k, k_max)
            ck.compare("lindley_scan", what, got, want, exact)
            if not torch.equal(got, want):
                FAILURES.append(f"lindley_kserver {what}: not bit-equal to the plain version")
        ck.run("lindley_scan", what, kcase)

    # the ring's edges (TILE columns per stage, STAGES stages): a ragged last
    # tile, fewer tiles than stages, a wrap, odd T, ragged last CTAs
    from repro_torch.kernels.lindley_scan.ops import STAGES as stages
    from repro_torch.kernels.lindley_scan.ops import TILE as tile

    for B in (1, 31, 33):
        for T in (1, tile - 1, tile, tile + 1, stages * tile + 1):
            for dtype in (torch.float64, torch.float32):
                what = f"ring edge ({B},{T}) {str(dtype)[6:]}"

                def edge(B=B, T=T, dtype=dtype, what=what):
                    arr, svc = lindley_inputs(torch, gen, B, T, dtype)
                    got, want = lindley_scan(arr, svc), scan_ref(arr, svc)
                    ck.compare("lindley_scan", what, got, want, exact)
                    if not torch.equal(got, want):
                        FAILURES.append(f"lindley_scan {what}: not bit-equal to the plain version")
                ck.run("lindley_scan", what, edge)

    for k_max in (1, 4, 9, 64):  # registers for k_max <= 8, local memory above
        for dtype in (torch.float64, torch.float32):
            what = f"k-server (33,{stages * tile + 1}) k_max {k_max} {str(dtype)[6:]}"

            def kinst(k_max=k_max, dtype=dtype, what=what):
                arr, svc = lindley_inputs(torch, gen, 33, stages * tile + 1, dtype)
                svc.mul_(k_max)
                k = torch.randint(1, k_max + 1, (33,), generator=gen, device="cuda",
                                  dtype=torch.int32)
                k[0] = k_max
                got, want = lindley_kserver(arr, svc, k, k_max), kserver_ref(arr, svc, k, k_max)
                ck.compare("lindley_scan", what, got, want, exact)
                if not torch.equal(got, want):
                    FAILURES.append(f"lindley_kserver {what}: not bit-equal to the plain version")
            ck.run("lindley_scan", what, kinst)

    def graph_replay():
        arr, svc = lindley_inputs(torch, gen, 45, 3 * stages * tile + 7, torch.float64)
        eager = lindley_scan(arr, svc)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = lindley_scan(arr, svc)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        ck.compare("lindley_scan", "graph replay (45, 775) equals the eager call", out, eager,
                   exact)
        if not torch.equal(out, eager):
            FAILURES.append("lindley_scan graph replay: not equal to the eager call")
    ck.run("lindley_scan", "graph replay", graph_replay)

    def full():
        arr, svc = lindley_inputs(torch, gen, SIM_ROWS, SIM_JOBS, torch.float64)
        got = lindley_scan(arr, svc)
        want = scan_ref(arr, svc)
        ck.compare("lindley_scan", f"({SIM_ROWS},{SIM_JOBS}) float64, the fleet path's shape",
                   got, want, exact)
        if not torch.equal(got, want):
            FAILURES.append("lindley_scan at the fleet path's shape: not bit-equal")
    ck.run("lindley_scan", "fleet path's shape", full)

    def kfull():  # the k-server entry at the shape and k mix of the k = 1..4 fleet run
        k = torch.as_tensor(sim_grids()[1].edge_k[:, 0], device="cuda").to(torch.int32)
        arr, svc = lindley_inputs(torch, gen, SIM_ROWS, SIM_JOBS, torch.float64)
        svc.mul_(k[:, None])  # every server of a row at load 0.9
        got = lindley_kserver(arr, svc, k, 4)
        want = kserver_ref(arr, svc, k, 4)
        what = f"k-server ({SIM_ROWS},{SIM_JOBS}) float64, k = row % 4 + 1 as the fleet run"
        ck.compare("lindley_scan", what, got, want, exact)
        if not torch.equal(got, want):
            FAILURES.append("lindley_kserver at the fleet path's shape and k mix: not bit-equal")
    ck.run("lindley_scan", "k-server at the fleet path's shape", kfull)

    def refuses():
        arr, svc = lindley_inputs(torch, gen, 8, 64, torch.float64)
        k = torch.ones(8, dtype=torch.int32, device="cuda")
        bad = [("bfloat16", TypeError, lambda: lindley_scan(arr.bfloat16(), svc.bfloat16())),
               ("mixed dtypes", TypeError, lambda: lindley_scan(arr, svc.float())),
               ("strided rows", ValueError, lambda: lindley_scan(arr[:, ::2], svc[:, ::2])),
               ("shape mismatch", ValueError, lambda: lindley_scan(arr, svc[:4])),
               ("1-D input", ValueError, lambda: lindley_scan(arr[0], svc[0])),
               ("int64 k", ValueError, lambda: lindley_kserver(arr, svc, k.long(), 2)),
               ("k_max over the limit", ValueError, lambda: lindley_kserver(arr, svc, k, 999)),
               ("k over k_max", ValueError, lambda: lindley_kserver(arr, svc, k + 2, 2)),
               ("k of 0", ValueError, lambda: lindley_kserver(arr, svc, k - 1, 2))]
        for what, exc, call in bad:
            try:
                call()
            except exc:
                log(f"[check] {'lindley_scan':16s} {what + ' raises ' + exc.__name__:52s} ok")
                continue
            FAILURES.append(f"lindley_scan accepted {what}")
    ck.run("lindley_scan", "wrong inputs refused", refuses)
    torch.cuda.synchronize()


def phase_time_lindley(torch, lindley, refs) -> dict:
    """Device time of the k = 1 kernel at the fleet path's shape beside its
    bound, its plain loop (timed once from Python: 120,000 steps of a few
    launches each, too many to capture) and the cumsum/cummax identity of
    ``core.simulation.station_pass`` as a yardstick; and the k-server kernel
    at k = 4, timed from Python (its wrapper reads k on the host)."""
    lindley_scan, lindley_kserver = lindley
    scan_ref, _ = refs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    arr, svc = lindley_inputs(torch, gen, SIM_ROWS, SIM_JOBS, torch.float64)

    def identity():
        csum = torch.cumsum(svc, dim=1)
        return csum + torch.cummax(arr - (csum - svc), dim=1).values

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    scan_ref(arr, svc)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    nbytes = 3 * SIM_ROWS * SIM_JOBS * 8
    b_ms, b_by = bound(nbytes, 2 * SIM_ROWS * SIM_JOBS, FP64_OPS)
    k, svc4 = torch.full((SIM_ROWS,), 4, dtype=torch.int32, device="cuda"), 4.0 * svc
    from repro_torch.kernels import _build

    chain_out = torch.empty_like(arr)
    chain_fn = _build.function("lindley_scan", "lindley_chain_floor_launch",
                               (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p))

    def chain_floor():  # the recursion alone, one tile resident in shared memory
        _build.check(chain_fn(_build.DTYPE_CODES[arr.dtype], arr.data_ptr(), svc.data_ptr(),
                              chain_out.data_ptr(), SIM_ROWS, SIM_JOBS, _build.stream_handle()),
                     "lindley_scan")

    r = dict(shape=f"arrivals, services ({SIM_ROWS},{SIM_JOBS}) float64",
             ms=device_ms(torch, lambda: lindley_scan(arr, svc), calls=5, replays=4),
             plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
             yardstick_ms=device_ms(torch, identity, calls=5, replays=4),
             chain_floor_ms=device_ms(torch, chain_floor, calls=5, replays=4),
             eager_ms=eager_ms(torch, lambda: lindley_scan(arr, svc), iters=5, warmup=1),
             kserver_k4_ms=eager_ms(torch, lambda: lindley_kserver(arr, svc4, k, 4),
                                    iters=3, warmup=1),
             # arrivals, services, k read once, departures written once
             kserver_k4_bound_ms=bound(nbytes + SIM_ROWS * 4, 2 * SIM_ROWS * SIM_JOBS,
                                       FP64_OPS)[0])
    log(f"[time] {'lindley_scan':16s} {r['shape']:44s} kernel {r['ms']:.4f} ms  plain "
        f"{plain_ms:.1f} ms (eager loop)  yardstick cumsum/cummax {r['yardstick_ms']:.4f} ms  "
        f"bound {b_ms:.5f} ms ({b_by});  chain floor (the recursion alone from shared memory) "
        f"{r['chain_floor_ms']:.4f} ms;  k-server at k=4 {r['kserver_k4_ms']:.4f} ms (bound "
        f"{r['kserver_k4_bound_ms']:.5f} ms; from Python: its wrapper reads k's range on the "
        f"host, which a graph cannot capture); eager from Python: kernel {r['eager_ms']:.4f} ms")
    return r


def profile_fleet_sim(torch, simulate_fleet, batch) -> dict | None:
    """Device busy share and time by kernel over one simulate_fleet call
    through edge[0] at the fleet path's size (host copies included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate_fleet(batch, "edge[0]", n=SIM_JOBS, seed=1, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, dev_total = [], 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 1e3, e.key, e.count))
            dev_total += us / 1e3
    kernels.sort(reverse=True)
    if not kernels:
        log("[profile] no device time in the trace: device busy share not measured")
        return None
    log(f"[profile] simulate_fleet edge[0] {SIM_ROWS} x {SIM_JOBS}: {wall_ms:.1f} ms wall, "
        f"device busy {dev_total:.1f} ms ({dev_total / wall_ms:.0%}); top by device time:")
    for ms, key, count in kernels[:8]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<3d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_total,
            "top": [dict(ms=ms, name=key, count=count) for ms, key, count in kernels[:12]]}


def _axis(spec):
    import numpy as np

    kind, lo, hi, n = spec
    return np.geomspace(lo, hi, n) if kind == "geom" else np.linspace(lo, hi, n)


def phase_fleet(torch) -> dict:
    import numpy as np

    from repro_torch.fleet import ScenarioBatch, fleet_analytic, fleet_crossover, simulate_fleet
    from repro_torch.launch import fleet_sweep
    from repro_torch.validate import load_corpus, run_differential, smoke_subset

    out: dict = {}
    base = fleet_sweep.default_scenario()
    reset_counts()

    # 1. the sweep CLI's own path over the acceptance-size grid, with crossovers
    axes = {path: _axis(spec) for path, spec in SWEEP_AXES.items()}
    rep = fleet_sweep.run_sweep(base, axes, crossover_axis="bandwidth", repeat=3, device="cuda")
    t, cx = rep["timing"], rep["crossover"]
    log(f"[fleet] sweep: {rep['batch_size']} scenarios on {rep['device']}; closed forms "
        f"{t['eval_ms']:.3f} ms per call ({t['scenarios_per_sec'] / 1e6:.2f}M scenarios/s, "
        f"device result copied to the host included); crossovers {cx['solve_ms']:.1f} ms, found "
        f"for {cx['found_frac']:.1%}, median {cx['median']}; shares {rep['strategy_counts']}")
    if rep["batch_size"] != 131_072 or sum(rep["strategy_counts"].values()) != 131_072 \
            or not 0.0 < rep["best_latency_s"]["finite_frac"] <= 1.0:
        FAILURES.append(f"sweep report malformed: {rep['batch_size']} rows, "
                        f"{rep['strategy_counts']}")
    # spot rows of the same grid against the scalar closed forms and solver
    grid_rows = np.random.default_rng(0).choice(rep["batch_size"], 48, replace=False)
    full = ScenarioBatch.from_sweep(base, axes)
    pick = ScenarioBatch(**{k: v[grid_rows] for k, v in full.arrays().items()})
    pred = fleet_analytic(pick, device="cuda")
    cxs = fleet_crossover(pick, "bandwidth", device="cuda")
    worst, worst_cx = 0.0, 0.0
    for row, i in enumerate(grid_rows):
        scn = base  # grid row i, C order: the last axis fastest
        for (path, vals), j in zip(axes.items(), np.unravel_index(i, [len(v) for v in
                                                                        axes.values()])):
            scn = scn.replaced(path, float(vals[j]))
        for k, v in scn.analytic().totals().items():
            got = pred.totals(row)[k]
            if np.isinf(v) or np.isinf(got):
                worst = max(worst, 0.0 if v == got else np.inf)
            else:
                worst = max(worst, abs(got - v) / abs(v))
        sc = scn.crossovers("bandwidth")
        if (sc.value is None) == bool(cxs.found[row]):
            worst_cx = np.inf
        elif sc.value is not None:
            worst_cx = max(worst_cx, abs(cxs.value[row] - sc.value) / sc.value)
    ok = worst <= 1e-9 and worst_cx <= 1e-6
    log(f"[fleet] sweep spot check, 48 grid rows vs scalar analytic(): max rel err {worst:.2e} "
        f"(limit 1e-9); crossovers vs the scalar solver {worst_cx:.2e} (limit 1e-6) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"sweep spot check: {worst:.2e} / crossovers {worst_cx:.2e}")
    out["sweep"] = {k: rep[k] for k in ("batch_size", "timing", "strategy_counts",
                                        "best_latency_s", "crossover")}
    out["sweep"]["spot_max_rel_err"], out["sweep"]["spot_cx_max_rel_err"] = worst, worst_cx
    sweep_counts = read_counts()

    # 2. the batched simulator at the reference's gate run length: every queue
    # at rho <= 0.9 (device tx2 0.15 s at up to 6 rps; NIC at up to 0.9); then
    # the edge with 1..4 servers, which takes the k-server kernel and both
    # resorts (its MAPE is reported, not gated: at k > 1 the closed forms use
    # the paper's k*mu aggregation, which the reference does not gate either)
    batch, batch_k = sim_grids()
    out["sim"] = {}
    for label, b, strategy, expect, gated in (
            ("on_device", batch, "on_device", (1, 0), True),
            ("edge[0]", batch, "edge[0]", (3, 0), True),
            ("edge[0] k=1..4", batch_k, "edge[0]", (2, 1), False)):
        pred = fleet_analytic(b, device="cuda")
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = simulate_fleet(b, strategy, n=SIM_JOBS, seed=0, device="cuda")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = read_counts()
        n_k1 = after["lindley_scan"] - before["lindley_scan"]
        n_kk = after["lindley_kserver"] - before["lindley_kserver"]
        want = pred.t_dev if strategy == "on_device" else pred.t_edge[:, 0]
        mean = res.mean
        ape = np.abs(mean - want) / want * 100
        shape_ok = res.latencies.shape == (SIM_ROWS, SIM_JOBS) and bool(
            np.isfinite(res.latencies).all()) and bool((res.latencies > 0).all())
        ok = shape_ok and (n_k1, n_kk) == expect and (
            not gated or ape.mean() <= SIM_MAPE_BUDGET_PCT)
        log(f"[fleet] simulate_fleet {label}: {SIM_ROWS} x {SIM_JOBS} jobs in {wall:.2f} s "
            f"wall (draws, {n_k1} lindley_scan + {n_kk} k-server launches, host copies); "
            f"steady mean vs fleet_analytic: MAPE {ape.mean():.3f}% mean, "
            f"{np.median(ape):.3f}% median, {ape.max():.3f}% max ("
            + (f"limit {SIM_MAPE_BUDGET_PCT:g}% mean" if gated else "k*mu aggregation, not gated")
            + f"); peak device memory {peak:.2f} GiB {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"simulate_fleet {label}: shape/finite {shape_ok}, launches "
                            f"{n_k1}+{n_kk} (expected {expect}), MAPE {ape.mean():.3f}%")
        out["sim"][label] = dict(wall_s=wall, peak_mem_gib=peak, lindley_scan=n_k1,
                                 lindley_kserver=n_kk, mape_mean_pct=float(ape.mean()),
                                 mape_median_pct=float(np.median(ape)),
                                 mape_max_pct=float(ape.max()), gated=gated)
        del res

    out["sim_profile"] = profile_fleet_sim(torch, simulate_fleet, batch)

    # 3. differential gates 1-3 on the golden corpus' smoke subset, at the
    # reference's tier-1 smoke sizes
    entries, meta = load_corpus()
    sub = smoke_subset(entries)
    t0 = time.perf_counter()
    val = run_differential(sub, expected_totals=meta["expected_totals"], base_n=20_000,
                           max_n_factor=2.0, bootstrap=100, sim_cross_count=2, meanfield=False,
                           device="cuda")
    d = val.to_dict()
    log(f"[fleet] differential gates 1-3 on {len(sub)} smoke entries in "
        f"{time.perf_counter() - t0:.2f} s: scalar vs batched max rel err "
        f"{d['scalar_vs_vec']['max_rel_err']:.2e} (limit {val.vec_tol:g}); golden "
        f"{d['golden']['max_rel_err']:.2e} (limit {val.golden_tol:g}); analytic vs simulated "
        f"MAPE {val.gate.mean_pct:.3f}% over {val.gate.n} (limit {val.mape_budget_pct:g}%); "
        f"simulators agree to {val.sim_cross.get('max_mape_pct', float('nan')):.3f}% "
        f"{'ok' if val.passed else 'FAIL'}")
    if not (val.vec_passed and val.golden_passed and val.gate_passed) or val.gate.n != len(sub):
        FAILURES.append(f"differential gates: {d['scalar_vs_vec']}, {d['golden']}, "
                        f"{d['mape_gate']}")
    out["gates"] = {k: d[k] for k in ("scalar_vs_vec", "golden", "mape_gate", "sim_cross")}

    launches = read_counts()
    out["launches"] = launches
    log(f"[fleet] launches over the fleet path: {launches} (the sweep alone: {sweep_counts})")
    others = {k: v for k, v in launches.items() if not k.startswith("lindley")}
    if any(others.values()) or any(sweep_counts.values()) or launches["lindley_scan"] < 9 \
            or launches["lindley_kserver"] < 1:
        FAILURES.append(f"fleet launch counts {launches}, sweep {sweep_counts}")
    return out


# ---------------------------------------------------------------------------
# the cluster path: the decision scan, the equilibrium, the closed loop


def decision_costs(torch, gen, T, N, E1, dtype, specials=True):
    """Exponential costs made on the card; with ``specials``, all-+inf rows,
    a +inf column, a NaN and exact ties, at epochs every cohort reaches."""
    c = torch.empty(T, N, E1, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    c = (0.05 * c).to(dtype)
    if specials:
        c[2, : N // 2] = float("inf")
        c[3, :, E1 - 1] = float("inf")
        c[4, 2 % N, E1 // 2] = float("nan")
        c[5, 1 % N, :] = 0.07
        c[6, ::5] = c[6, ::5, :1]  # every fifth client: every column ties with on-device
    return c


def phase_check_decision(torch, ck: Checker, decision_scan, scan_ref) -> None:
    """The decision scan against its plain loop with torch.equal: choices are
    integers, and one boundary case an ulp apart would flip one."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)

    def check(what, costs, cohort, **kw):
        got, want = decision_scan(costs, cohort, **kw), scan_ref(costs, cohort, **kw)
        ck.compare("decision_scan", what, got, want, dict(atol=0.0, rtol=0.0))
        if not torch.equal(got, want):
            FAILURES.append(f"decision_scan {what}: not equal to the plain version")

    shapes = DECISION_SHAPES + ((37, 13, 4), (50, 1000, 33), (9, 70, 1))
    for T, N, E1 in shapes:
        for dtype in (torch.float64, torch.float32):
            for stagger in (1, 3, 8):
                for h in (0.0, 0.15, 0.3):
                    what = f"({T},{N},{E1}) {str(dtype)[6:]} stagger {stagger} h {h:g}"

                    def case(T=T, N=N, E1=E1, dtype=dtype, stagger=stagger, h=h, what=what):
                        costs = decision_costs(torch, gen, T, N, E1, dtype, specials=T > 6)
                        cohort = (torch.arange(N, device="cuda") % stagger).to(torch.int32)
                        check(what, costs, cohort, hysteresis=h, stagger=stagger)
                    ck.run("decision_scan", what, case)

    # the ring's edges (STAGES epochs in shared memory): T around STAGES with
    # N * (E+1) odd (every epoch's span at another offset mod 16); every E+1
    # from 1 to one above 256 at N = 2047, not a multiple of the plan's
    # clients per CTA
    from repro_torch.kernels.decision_scan.ops import STAGES

    edges = [(T, 77, 33) for T in (1, 2, STAGES - 1, STAGES, STAGES + 1)]
    edges += [(9, N, E1) for N in (2047, 13) for E1 in (1, 5, 33, 129, 300)]
    for T, N, E1 in edges:
        for dtype in (torch.float64, torch.float32):
            what = f"ring edge ({T},{N},{E1}) {str(dtype)[6:]} stagger 3 h 0.15"

            def edge(T=T, N=N, E1=E1, dtype=dtype, what=what):
                costs = decision_costs(torch, gen, T, N, E1, dtype, specials=T > 6)
                cohort = (torch.arange(N, device="cuda") % 3).to(torch.int32)
                check(what, costs, cohort, hysteresis=0.15, stagger=3)
            ck.run("decision_scan", what, edge)

    def graph_replay():
        costs = decision_costs(torch, gen, 3 * STAGES + 1, 2047, 129, torch.float64)
        cohort = (torch.arange(2047, device="cuda") % 3).to(torch.int32)
        eager = decision_scan(costs, cohort, hysteresis=0.15, stagger=3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decision_scan(costs, cohort, hysteresis=0.15, stagger=3)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        ck.compare("decision_scan", "graph replay (13, 2047, 129) equals the eager call", out,
                   eager, dict(atol=0.0, rtol=0.0))
        if not torch.equal(out, eager):
            FAILURES.append("decision_scan graph replay: not equal to the eager call")
    ck.run("decision_scan", "graph replay", graph_replay)

    for t0 in (0, 1, 7, 8, 599):  # the closed loop's one-epoch entry
        what = f"(1,{CITY_CLIENTS},129) with prev, t0 {t0}, stagger 8, h 0.15"

        def one(t0=t0, what=what):
            costs = decision_costs(torch, gen, 1, CITY_CLIENTS, 129, torch.float64, specials=False)
            costs[0, ::7] = costs[0, ::7, :1]
            cohort = (torch.arange(CITY_CLIENTS, device="cuda") % 8).to(torch.int32)
            prev = torch.randint(-1, 128, (CITY_CLIENTS,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            check(what, costs, cohort, hysteresis=0.15, stagger=8, prev=prev, t0=t0)
        ck.run("decision_scan", what, one)

    def refuses():
        costs = decision_costs(torch, gen, 8, 16, 5, torch.float64, specials=False)
        cohort = torch.zeros(16, dtype=torch.int32, device="cuda")
        bad = [("bfloat16 costs", TypeError, lambda: decision_scan(costs.bfloat16(), cohort)),
               ("2-D costs", ValueError, lambda: decision_scan(costs[0], cohort)),
               ("strided costs", ValueError, lambda: decision_scan(costs[:, :, ::2], cohort)),
               ("stagger 0", ValueError, lambda: decision_scan(costs, cohort, stagger=0)),
               ("int64 cohort", ValueError, lambda: decision_scan(costs, cohort.long())),
               ("prev past the last edge", ValueError, lambda: decision_scan(
                   costs, cohort, prev=torch.full((16,), 4, dtype=torch.int32, device="cuda")))]
        for what, exc, call in bad:
            try:
                call()
            except exc:
                log(f"[check] {'decision_scan':16s} {what + ' raises ' + exc.__name__:52s} ok")
                continue
            FAILURES.append(f"decision_scan accepted {what}")
    ck.run("decision_scan", "wrong inputs refused", refuses)
    torch.cuda.synchronize()


def phase_time_decision(torch, decision_scan, scan_ref) -> dict:
    """Device time of the decision scan at the city-scale shape, all 600
    epochs in one call (CUDA-graph replay), beside its byte bound, its plain
    loop (timed once from Python), the ``argmin - 1`` yardstick (the same
    function at h = 0, stagger 1), and the eager time of the closed loop's
    own call: one epoch with ``prev`` and ``t0``, whose wrapper reads prev's
    range on the host."""
    T, N, E1 = DECISION_SHAPES[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    costs = decision_costs(torch, gen, T, N, E1, torch.float64, specials=False)
    cohort1 = torch.zeros(N, dtype=torch.int32, device="cuda")
    cohort8 = (torch.arange(N, device="cuda") % CITY_STAGGER).to(torch.int32)

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    scan_ref(costs, cohort1)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    nbytes = T * N * E1 * 8 + T * N * 4 + N * 4
    b_ms, b_by = bound(nbytes, T * N * E1, FP64_OPS)
    one = costs[:1].contiguous()
    prev = torch.randint(-1, E1 - 1, (N,), generator=gen, device="cuda", dtype=torch.int32)
    r = dict(shape=f"costs ({T},{N},{E1}) float64",
             ms=device_ms(torch, lambda: decision_scan(costs, cohort1), calls=5, replays=4),
             ms_stagger8_h015=device_ms(torch, lambda: decision_scan(
                 costs, cohort8, hysteresis=0.15, stagger=CITY_STAGGER), calls=5, replays=4),
             plain_ms=plain_ms,
             library_ms=device_ms(torch, lambda: torch.argmin(costs, -1) - 1, calls=5, replays=4),
             bound_ms=b_ms, bound_by=b_by,
             eager_ms=eager_ms(torch, lambda: decision_scan(costs, cohort1), iters=10),
             epoch_eager_ms=eager_ms(torch, lambda: decision_scan(
                 one, cohort8, stagger=CITY_STAGGER, prev=prev, t0=9), iters=200, warmup=20),
             epoch_device_ms=device_ms(torch, lambda: decision_scan(
                 one, cohort8, stagger=CITY_STAGGER, t0=9), calls=50, replays=10),
             epoch_library_ms=device_ms(torch, lambda: torch.argmin(one, -1) - 1, calls=50,
                                        replays=10),
             epoch_bound_ms=bound(N * E1 * 8 + 2 * N * 4, N * E1, FP64_OPS)[0])
    r["plan_variants"] = decision_plan_variants(torch, decision_scan, costs, cohort1, one,
                                                cohort8)
    log(f"[time] {'decision_scan':16s} {r['shape']:44s} kernel {r['ms']:.4f} ms (stagger 8, "
        f"h 0.15: {r['ms_stagger8_h015']:.4f} ms)  plain {plain_ms:.1f} ms (eager loop)  "
        f"library argmin-1 {r['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({b_by});  one epoch "
        f"(1,{N},{E1}): {r['epoch_device_ms']:.5f} ms device (argmin-1 "
        f"{r['epoch_library_ms']:.5f} ms, bound {r['epoch_bound_ms']:.5f} ms), "
        f"{r['epoch_eager_ms']:.4f} ms eager from Python with prev (its range read on the host)")
    return r


def decision_plan_variants(torch, decision_scan, costs, cohort1, one, cohort8) -> list[dict]:
    """The plan's neighbours, each timed beside the plan in this call and held
    equal to the wrapper's result: epochs per step, lanes per client and
    clients per CTA at the city shape (stagger 1, h 0) and at its one-epoch
    shape (stagger 8, t0 9)."""
    from repro_torch.kernels.decision_scan import ops

    T, N, E1 = costs.shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {"city": ops.scan_plan(T, N, E1, 8, n_sm), "epoch": ops.scan_plan(1, N, E1, 8, n_sm)}
    want = {"city": decision_scan(costs, cohort1),
            "epoch": decision_scan(one, cohort8, stagger=CITY_STAGGER, t0=9)}
    calls = {"city": lambda p: ops._launch(costs, cohort1, None, 0.0, 1, 0, p),
             "epoch": lambda p: ops._launch(one, cohort8, None, 0.0, CITY_STAGGER, 9, p)}
    rows = []
    for step in ops.STEPS:
        for group in (8, 16, 32):
            for clients in (4, 8, 16):
                row = dict(step=step, group=group, clients=clients)
                for shape, plan in plans.items():
                    if step > plan.step:  # a step past the epochs there are
                        continue
                    p = plan._replace(step=step, group=group, clients=clients,
                                      threads=-(-clients * group // 32) * 32)
                    if not torch.equal(calls[shape](p), want[shape]):
                        FAILURES.append(f"decision_scan plan {row} at the {shape} shape: not "
                                        "equal to the planned launch")
                    row[f"{shape}_ms"] = device_ms(torch, lambda: calls[shape](p),
                                                   calls=5 if shape == "city" else 50,
                                                   replays=4 if shape == "city" else 10)
                    row[f"{shape}_planned"] = (step, group, clients) == (
                        plan.step, plan.group, plan.clients)
                rows.append(row)
                times = [f"{row[f'{shape}_ms']:.5f} ms at {label}"
                         + (" (the plan)" if row[f"{shape}_planned"] else "")
                         for shape, label in (("city", f"({T},{N},{E1})"), ("epoch", "one epoch"))
                         if f"{shape}_ms" in row]
                log(f"[time] {'decision_scan':16s} plan step {step} group {group:2d} clients "
                    f"{clients:2d}: " + ", ".join(times))
    return rows


def city_cluster():
    """default_cluster's four edge tiers repeated CITY_REPEAT times (each copy
    renamed), shared by CITY_CLIENTS clients."""
    from dataclasses import replace

    from repro_torch.core.scenario import ClusterSpec
    from repro_torch.launch.cluster_sim import default_cluster

    base = default_cluster(ACCEPT_CLIENTS).base
    edges = tuple(replace(e, tier=replace(e.tier, name=f"{e.tier.name}-{r}"))
                  for r in range(CITY_REPEAT) for e in base.edges)
    return ClusterSpec(base=replace(base, edges=edges, name="city-base"),
                       n_clients=CITY_CLIENTS,
                       name=f"city-{CITY_CLIENTS}x{len(edges)}")


def walk_trace(duration: float, bw0: float, drop: float = 0.15):
    """The cluster CLI's default walk: bandwidth x ``drop`` in the middle third."""
    from repro_torch.fleet import make_trace, step_signal

    third = duration / 3
    return make_trace(duration, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: step_signal(
        t, [(0.0, bw0), (third, bw0 * drop), (2 * third, bw0)]))


@contextlib.contextmanager
def route_decisions(fn):
    """Route the cluster's decide steps through ``fn`` (comparisons only)."""
    from repro_torch.fleet import cluster

    saved = cluster.decision_scan
    cluster.decision_scan = fn
    try:
        yield
    finally:
        cluster.decision_scan = saved


def profile_cluster(torch, simulate_cluster, spec, trace, n_req) -> dict | None:
    """Host and device time, and device time by kernel, of one city-scale
    closed-loop run (adaptive policy only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate_cluster(spec, trace, policies=("adaptive",), stagger=CITY_STAGGER, n_req=n_req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, dev_total = [], 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 1e3, e.key, e.count))
            dev_total += us / 1e3
    kernels.sort(reverse=True)
    if not kernels:
        log("[profile] no device time in the trace: device busy share not measured")
        return None
    log(f"[profile] simulate_cluster adaptive {CITY_CLIENTS} x {CITY_EPOCHS} epochs: "
        f"{wall_ms:.1f} ms wall (profiler on), device busy {dev_total:.1f} ms "
        f"({dev_total / wall_ms:.0%}); top by device time:")
    for ms, key, count in kernels[:10]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_total,
            "top": [dict(ms=ms, name=key, count=count) for ms, key, count in kernels[:14]]}


def phase_cluster(torch, scan_ref) -> dict:
    import numpy as np

    from repro_torch.fleet import cross_check_equilibrium, simulate_cluster, solve_equilibrium
    from repro_torch.launch.cluster_sim import default_cluster

    out: dict = {}
    reset_counts()
    spec = default_cluster(ACCEPT_CLIENTS)
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))

    # 1. the acceptance equilibrium: one launch per synchronous step (the
    # same solve on the CPU counts the steps), then the damped sweeps on the host
    before = read_counts()
    t0 = time.perf_counter()
    eq = solve_equilibrium(spec, max_iter=20, device="cuda")
    solve_ms = (time.perf_counter() - t0) * 1e3
    n_eq = read_counts()["decision_scan"] - before["decision_scan"]
    steps = []
    with route_decisions(lambda *a, **k: steps.append(1) or scan_ref(*a, **k)):
        eq_cpu = solve_equilibrium(spec, max_iter=20, device="cpu")
    used = sum(1 for c in eq.counts().values() if c)
    ok = (eq.converged and eq.iterations <= 20 and used >= 2 and bool(np.all(eq.rho_edges <= 0.9))
          and n_eq == len(steps) >= 1 and np.array_equal(eq.choices, eq_cpu.choices)
          and eq.iterations == eq_cpu.iterations)
    log(f"[cluster] equilibrium {ACCEPT_CLIENTS} x 4: converged {eq.converged} in "
        f"{eq.iterations} iterations (limit 20; damped after oscillation: {eq.oscillation}) in "
        f"{solve_ms:.1f} ms; {n_eq} decision_scan launches for {len(steps)} synchronous steps; "
        f"counts {eq.counts()}; edge rho {np.round(eq.rho_edges, 4).tolist()} (limit 0.9); "
        f"choices equal to the CPU solve: {np.array_equal(eq.choices, eq_cpu.choices)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"equilibrium: converged {eq.converged}, {eq.iterations} iterations, "
                        f"{used} targets, rho {eq.rho_edges}, {n_eq} launches for "
                        f"{len(steps)} steps")
    out["equilibrium"] = dict(iterations=eq.iterations, converged=eq.converged,
                              oscillation=eq.oscillation, counts=eq.counts(),
                              rho_edges=eq.rho_edges.tolist(), solve_ms=solve_ms,
                              launches=n_eq, synchronous_steps=len(steps))

    before = read_counts()
    t0 = time.perf_counter()
    cc = cross_check_equilibrium(spec, eq, n=60_000, seed=0, device="cuda")
    cc_s = time.perf_counter() - t0
    n_lindley = read_counts()["lindley_scan"] - before["lindley_scan"]
    on_dev = any(g["target"] == "on_device" for g in cc["groups"])
    gated = cc["gated_max_mape_pct"]
    ok = gated is not None and gated <= 5.0 and n_lindley == int(on_dev)
    log(f"[cluster] cross-check at 60,000 jobs in {cc_s:.2f} s: "
        + "; ".join(f"{g['target']} x{g['n_clients']} rho {g['rho']:.3f} MAPE "
                    f"{g['mape_pct']:.3f}%" for g in cc["groups"])
        + f"; gated max MAPE {gated} (limit 5%); {n_lindley} lindley_scan launches (one per "
          f"on-device batch; on-device groups: {on_dev}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"cross-check: gated max MAPE {gated}, {n_lindley} Lindley launches")
    out["cross_check"] = dict(gated_max_mape_pct=gated, groups=cc["groups"], elapsed_s=cc_s,
                              lindley_launches=n_lindley)

    # 2. the acceptance closed loop: 120 epochs, stagger 8, seed 1, every static
    pols = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(spec.n_edges))
    trace = walk_trace(float(ACCEPT_EPOCHS), bw0)
    before = read_counts()
    t0 = time.perf_counter()
    res = simulate_cluster(spec, trace, policies=pols, stagger=8, seed=1)
    wall = time.perf_counter() - t0
    n_dec = read_counts()["decision_scan"] - before["decision_scan"]
    a = res.policies["adaptive"]
    finite = all(np.isfinite(p.latencies_s).all() and p.latencies_s.shape ==
                 (ACCEPT_EPOCHS, ACCEPT_CLIENTS) for p in res.policies.values())
    ok = finite and res.adaptive_wins and a.saturated_epochs == 0 and n_dec == ACCEPT_EPOCHS
    log(f"[cluster] closed loop {ACCEPT_CLIENTS} x 4 x {ACCEPT_EPOCHS} epochs in {wall:.2f} s: "
        + ", ".join(f"{n} {p.mean_latency_s * 1e3:.3f} ms (sat {p.saturated_epochs})"
                    for n, p in res.policies.items())
        + f"; adaptive <= every static: {res.adaptive_wins}; {n_dec} decision_scan launches "
          f"(expected {ACCEPT_EPOCHS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"acceptance closed loop: wins {res.adaptive_wins}, saturated "
                        f"{a.saturated_epochs}, launches {n_dec}, finite {finite}")
    out["acceptance"] = dict(wall_s=wall, launches=n_dec, adaptive_wins=res.adaptive_wins,
                             means_s={n: p.mean_latency_s for n, p in res.policies.items()},
                             saturated={n: p.saturated_epochs for n, p in res.policies.items()})

    # 3. the city-scale pool: its counts drawn once on the card, so that the
    # plain-decision run below sees the same arrivals
    city = city_cluster()
    n_e = city.n_edges
    trace = walk_trace(float(CITY_EPOCHS), bw0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lam = torch.full((CITY_EPOCHS, CITY_CLIENTS), 2.0, dtype=torch.float64, device="cuda")
    n_req = torch.poisson(lam * trace.epoch_s, generator=gen).cpu().numpy()
    table_gb = CITY_EPOCHS * CITY_CLIENTS * n_e * 8 / 1e9
    log(f"[cluster] city pool: {CITY_CLIENTS} clients x {n_e} edges x {CITY_EPOCHS} epochs; "
        f"a (T*N, E) float64 scoring table is {table_gb:.3f} GB; the scoring holds about 16 of "
        f"them at once (their temporaries in analytic_vec), so the peak is reckoned near "
        f"{16 * table_gb:.0f} GB (T would be halved above 60 GB)")
    city_pols = ("adaptive", "on_device", "edge[0]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t0 = time.perf_counter()
    res = simulate_cluster(city, trace, policies=city_pols, stagger=CITY_STAGGER, n_req=n_req)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_dec = read_counts()["decision_scan"] - before["decision_scan"]
    t0 = time.perf_counter()
    res_a = simulate_cluster(city, trace, policies=("adaptive",), stagger=CITY_STAGGER,
                             n_req=n_req)
    wall_a = time.perf_counter() - t0
    launches = read_counts()
    out["launches"] = launches
    a = res.policies["adaptive"]
    ce = CITY_EPOCHS * CITY_CLIENTS
    finite = all(np.isfinite(p.latencies_s).all() and p.latencies_s.shape ==
                 (CITY_EPOCHS, CITY_CLIENTS) for p in res.policies.values())
    with route_decisions(scan_ref):
        res_p = simulate_cluster(city, trace, policies=("adaptive",), stagger=CITY_STAGGER,
                                 n_req=n_req)
    same = np.array_equal(a.choices, res_p.policies["adaptive"].choices) and np.array_equal(
        a.choices, res_a.policies["adaptive"].choices)
    ok = finite and same and n_dec == CITY_EPOCHS and peak <= 60 * 1e9 / 2**30
    log(f"[cluster] city closed loop: {ce} client-epochs, all three policies in {wall:.2f} s "
        f"wall; adaptive alone {wall_a:.2f} s ({ce / wall_a:,.0f} client-epochs/s); peak device "
        f"memory {peak:.2f} GiB; {n_dec} decision_scan launches (expected {CITY_EPOCHS}); "
        f"choices equal to the plain-decision run: {same} {'ok' if ok else 'FAIL'}")
    log("[cluster] city means: " + ", ".join(
        f"{n} {p.mean_latency_s * 1e3:.3f} ms (saturated {p.saturated_epochs} of {ce}, "
        f"offload {p.offload_frac:.1%}, switches {p.switches})" for n, p in res.policies.items())
        + f"; adaptive <= both statics: {res.adaptive_wins} (reported, not gated)")
    if not ok:
        FAILURES.append(f"city closed loop: finite {finite}, choices equal {same}, launches "
                        f"{n_dec}, peak {peak:.2f} GiB")
    out["city"] = dict(clients=CITY_CLIENTS, edges=n_e, epochs=CITY_EPOCHS, wall_s=wall,
                       adaptive_wall_s=wall_a, client_epochs_per_s=ce / wall_a,
                       peak_mem_gib=peak, launches=n_dec, choices_equal_plain=same,
                       adaptive_wins=res.adaptive_wins,
                       means_s={n: p.mean_latency_s for n, p in res.policies.items()},
                       saturated={n: p.saturated_epochs for n, p in res.policies.items()},
                       offload_frac={n: p.offload_frac for n, p in res.policies.items()},
                       adaptive_switches=a.switches)
    del res, res_a, res_p
    out["city_profile"] = profile_cluster(torch, simulate_cluster, city, trace, n_req)

    serving = {k: launches[k] for k in ("rmsnorm", "flash_attention", "decode_attention",
                                        "ssm_scan")}
    if any(serving.values()):
        FAILURES.append(f"serving kernels ran in the cluster phase: {serving}")
    log(f"[cluster] launches over the cluster path: {launches}")
    return out


# ---------------------------------------------------------------------------
# the tail path: batched quantiles, gates 1-5, the cluster in SLO mode


def _sweep_rows(base, axes, rows):
    """The Scenarios of grid rows ``rows`` (C order, the last axis fastest)."""
    import numpy as np

    out = []
    for i in rows:
        scn = base
        for (path, vals), j in zip(axes.items(),
                                   np.unravel_index(i, [len(v) for v in axes.values()])):
            scn = scn.replaced(path, float(vals[j]))
        out.append(scn)
    return out


def _c2_cases():
    """The shared-pole cases of ROADMAP C2 as station tuples, and as offload
    paths whose request and result NICs are identical and dominant."""
    from repro_torch.core import tail as T
    from repro_torch.core.latency import NetworkPath, Tier, Workload
    from repro_torch.core.scenario import EdgeSpec, Scenario

    stations = {"md1_lam1_mean05_x2": [T.proc_station(1.0, T.KIND_DET, 0.5, 0.0)] * 2,
                "det_rho04375_x2": [T.proc_station(0.4375, T.KIND_DET, 1.0, 0.0)] * 2}
    scenarios = [Scenario(
        workload=Workload(arrival_rate=2.0, req_bytes=80_000, res_bytes=80_000, name="c2"),
        device=Tier("slow", 0.4), edges=(EdgeSpec(Tier("fast", 0.01)),),
        network=NetworkPath(bw), name=f"c2-shared-nic-{bw:g}") for bw in (4e5, 6e5)]
    return stations, scenarios


def phase_tails(torch, scan_ref) -> dict:
    import numpy as np

    from repro_torch.core import tail as T
    from repro_torch.core.scenario import parse_strategy
    from repro_torch.fleet import ScenarioBatch, fleet_tail, simulate_cluster, solve_equilibrium
    from repro_torch.fleet.tail_vec import STATION_KEYS, sojourn_quantile_vec
    from repro_torch.launch import fleet_sweep
    from repro_torch.launch.cluster_sim import default_cluster
    from repro_torch.validate import load_corpus, run_differential, run_meanfield_gate, smoke_subset
    from repro_torch.validate.differential import _rel_err, _sim_n_for

    out: dict = {}
    reset_counts()

    # 1. fleet_tail at p99 over the sweep's grid, both methods; a seeded
    # sample against the scalar tail, the same sample through the CPU beside it
    base = fleet_sweep.default_scenario()
    axes = {path: _axis(spec) for path, spec in SWEEP_AXES.items()}
    full = ScenarioBatch.from_sweep(base, axes)
    rows = np.sort(np.random.default_rng(1).choice(full.size, TAIL_SAMPLE, replace=False))
    pick = ScenarioBatch(**{k: v[rows] for k, v in full.arrays().items()})
    scns = _sweep_rows(base, axes, rows)
    out["fleet_tail"] = {}
    for method, limit in (("euler", 1e-8), ("asymptote", 1e-6)):
        fleet_tail(pick, TAIL_Q, method=method, device="cuda")  # first-call set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = fleet_tail(full, TAIL_Q, method=method, device="cuda")  # results on the host
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        cpu = fleet_tail(pick, TAIL_Q, method=method, device="cpu")
        worst = worst_cpu = 0.0
        for row, (i, scn) in enumerate(zip(rows, scns)):
            for k, v in scn.analytic_tail(TAIL_Q, method=method).items():
                worst = max(worst, _rel_err(pred.totals(int(i))[k], v))
                worst_cpu = max(worst_cpu, _rel_err(cpu.totals(row)[k], v))
        finite = float(np.isfinite(np.concatenate([pred.t_dev[:, None], pred.t_edge], 1)).mean())
        ok = (pred.size == full.size == 131_072 and worst <= limit and worst_cpu <= limit
              and 0.0 < finite <= 1.0 and not np.isnan(pred.t_edge).any())
        log(f"[tails] fleet_tail p99 {method}: {pred.size} rows in {wall * 1e3:.1f} ms "
            f"({pred.size / wall:,.0f} rows/s, results on the host); peak device memory "
            f"{peak:.3f} GiB; {finite:.1%} of the (row, strategy) quantiles finite; {TAIL_SAMPLE} "
            f"sampled rows vs the scalar analytic_tail: max rel err {worst:.3e} on the card, "
            f"{worst_cpu:.3e} on the CPU (limit {limit:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"fleet_tail {method}: card {worst:.3e}, CPU {worst_cpu:.3e}, "
                            f"{pred.size} rows")
        out["fleet_tail"][method] = dict(rows=pred.size, wall_s=wall, rows_per_s=pred.size / wall,
                                         peak_mem_gib=peak, max_rel_err=worst,
                                         cpu_max_rel_err=worst_cpu, finite_frac=finite)
    out["fleet_tail_profile"] = profile_calls(
        torch, f"fleet_tail p99 asymptote over {full.size} rows",
        lambda: fleet_tail(full, TAIL_Q, method="asymptote", device="cuda"), n=1)

    # 2. the asymptote on the C2 cases: a shared dominant pole takes the
    # Euler path, as the port's scalar does
    stations, c2_scns = _c2_cases()
    worst = 0.0
    for name, sts in stations.items():
        st = {k: torch.tensor([[getattr(x, k) for x in sts]], device="cuda",
                              dtype=torch.int64 if k[1:] == "kind" else torch.float64)
              for k in STATION_KEYS}
        for q in (0.9, TAIL_Q, T.EULER_Q_MAX):
            got = float(sojourn_quantile_vec(st, q, method="asymptote")[0])
            worst = max(worst, _rel_err(got, T.sojourn_quantile(sts, q, method="asymptote")))
    pred = fleet_tail(ScenarioBatch.from_scenarios(c2_scns), TAIL_Q, method="asymptote",
                      device="cuda")
    for i, scn in enumerate(c2_scns):
        for k, v in scn.analytic_tail(TAIL_Q, method="asymptote").items():
            worst = max(worst, _rel_err(pred.totals(i)[k], v))
    ok = worst <= 1e-8
    log(f"[tails] asymptote on the C2 shared-pole cases ({len(stations)} station pairs at q "
        f"0.9 / 0.99 / EULER_Q_MAX, {len(c2_scns)} paths with identical NICs): max rel err vs "
        f"the scalar {worst:.3e} (limit 1e-8) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"C2 cases: {worst:.3e}")
    out["c2_max_rel_err"] = worst

    # 3. differential gates 1-5 on the smoke subset: one Lindley launch per
    # station of each (strategy, run length) group; one decision-scan launch
    # per synchronous step of gate 5's exact solves (counted on the CPU)
    entries, meta = load_corpus()
    sub = smoke_subset(entries)
    groups = {}
    for e in sub:
        j = parse_strategy(e.strategy, len(e.scenario.edges))
        if j < 0 or not e.scenario.edges[j].background:
            groups[(e.strategy, _sim_n_for(e.rho, 20_000, 2.0))] = 1 if j < 0 else 3
    steps = []
    with route_decisions(lambda *a, **k: steps.append(1) or scan_ref(*a, **k)):
        run_meanfield_gate(device="cpu")
    before = read_counts()
    t0 = time.perf_counter()
    val = run_differential(sub, expected_totals=meta["expected_totals"], base_n=20_000,
                           max_n_factor=2.0, bootstrap=100, sim_cross_count=2, device="cuda")
    gates_s = time.perf_counter() - t0
    after = read_counts()
    n_lind = sum(after[k] - before[k] for k in ("lindley_scan", "lindley_kserver"))
    n_dec = after["decision_scan"] - before["decision_scan"]
    d = val.to_dict()
    mf = d["meanfield_gate"]
    ok = (val.passed and val.gate.n == len(sub) and val.tail.n >= 5
          and n_lind == sum(groups.values()) and n_dec == len(steps) >= 1)
    log(f"[tails] differential gates 1-5 on {len(sub)} smoke entries in {gates_s:.2f} s: "
        f"(1) scalar vs batched {d['scalar_vs_vec']['max_rel_err']:.3e} (limit "
        f"{val.vec_tol:g}); (2) golden {d['golden']['max_rel_err']:.3e} (limit "
        f"{val.golden_tol:g}); (3) MAPE {val.gate.mean_pct:.3f}% mean, {val.gate.max_pct:.3f}% "
        f"max over {val.gate.n} (limit {val.mape_budget_pct:g}%); (4) scalar vs batched tail "
        f"{d['scalar_vs_vec_tail']['max_rel_err']:.3e} (limit {val.vec_tol:g}), batched vs "
        f"scalar Euler {d['tail_euler_vec']['max_rel_err']:.3e} over "
        f"{d['tail_euler_vec']['n_entries']} (limit {val.euler_vec_tol:g}), analytic vs "
        f"simulated p99 {val.tail.mean_pct:.3f}% mean, {val.tail.max_pct:.3f}% max over "
        f"{val.tail.n} (limit {val.tail_budget_pct:g}%); (5) mean field vs exact "
        f"{mf['gated_max_mape_pct']:.3f}% max, {mf['gated_mean_mape_pct']:.3f}% mean over "
        f"{mf['n_specs']} fleets, converged {mf['converged']} (limit {mf['budget_pct']:g}%); "
        f"simulators agree to {val.sim_cross.get('max_mape_pct', float('nan')):.3f}%; "
        f"{n_lind} Lindley launches (expected {sum(groups.values())}), {n_dec} decision_scan "
        f"launches for {len(steps)} synchronous steps; passed {val.passed} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"gates 1-5: passed {val.passed}, Lindley {n_lind}, decision {n_dec} "
                        f"of {len(steps)}")
    out["gates"] = {k: d[k] for k in ("passed", "scalar_vs_vec", "golden", "mape_gate",
                                      "tail_gate", "scalar_vs_vec_tail", "tail_euler_vec",
                                      "sim_cross")}
    out["gates"]["meanfield_gate"] = {k: v for k, v in mf.items() if k != "specs"}
    out["gates"].update(elapsed_s=gates_s, lindley_launches=n_lind, decision_launches=n_dec)

    # 4. the acceptance cluster in SLO mode: p99 by the asymptote
    spec = default_cluster(ACCEPT_CLIENTS)
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))
    slo = dict(slo_quantile=TAIL_Q, tail_method="asymptote")
    before = read_counts()
    t0 = time.perf_counter()
    eq = solve_equilibrium(spec, max_iter=20, device="cuda", **slo)
    solve_ms = (time.perf_counter() - t0) * 1e3
    n_eq = read_counts()["decision_scan"] - before["decision_scan"]
    steps = []
    with route_decisions(lambda *a, **k: steps.append(1) or scan_ref(*a, **k)):
        eq_cpu = solve_equilibrium(spec, max_iter=20, device="cpu", **slo)
    ok = (eq.converged and eq.iterations <= 20 and n_eq == len(steps) >= 1
          and np.array_equal(eq.choices, eq_cpu.choices) and eq.iterations == eq_cpu.iterations)
    log(f"[tails] SLO equilibrium {ACCEPT_CLIENTS} x 4, p99 asymptote: converged {eq.converged} "
        f"in {eq.iterations} iterations (limit 20; damped after oscillation: {eq.oscillation}) "
        f"in {solve_ms:.1f} ms; {n_eq} decision_scan launches for {len(steps)} synchronous "
        f"steps; counts {eq.counts()}; worst client p99 {eq.max_latency_s * 1e3:.3f} ms; "
        f"choices equal to the CPU solve: {np.array_equal(eq.choices, eq_cpu.choices)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"SLO equilibrium: converged {eq.converged}, {eq.iterations} "
                        f"iterations, {n_eq} launches for {len(steps)} steps")
    out["slo_equilibrium"] = dict(iterations=eq.iterations, converged=eq.converged,
                                  oscillation=eq.oscillation, counts=eq.counts(),
                                  max_latency_s=eq.max_latency_s, solve_ms=solve_ms,
                                  launches=n_eq, synchronous_steps=len(steps))

    pols = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(spec.n_edges))
    trace = walk_trace(float(ACCEPT_EPOCHS), bw0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    lam = torch.full((ACCEPT_EPOCHS, ACCEPT_CLIENTS), 2.0, dtype=torch.float64, device="cuda")
    n_req = torch.poisson(lam * trace.epoch_s, generator=gen).cpu().numpy()
    before = read_counts()
    t0 = time.perf_counter()
    res = simulate_cluster(spec, trace, policies=pols, stagger=8, n_req=n_req, **slo)
    wall = time.perf_counter() - t0
    n_dec = read_counts()["decision_scan"] - before["decision_scan"]
    a = res.policies["adaptive"]
    finite = all(np.isfinite(p.latencies_s).all() and p.latencies_s.shape ==
                 (ACCEPT_EPOCHS, ACCEPT_CLIENTS) for p in res.policies.values())
    ok = finite and a.saturated_epochs == 0 and n_dec == ACCEPT_EPOCHS
    log(f"[tails] SLO closed loop {ACCEPT_CLIENTS} x 4 x {ACCEPT_EPOCHS} epochs in {wall:.2f} s: "
        + ", ".join(f"{n} p99 {p.mean_latency_s * 1e3:.3f} ms (sat {p.saturated_epochs})"
                    for n, p in res.policies.items())
        + f"; adaptive <= every static: {res.adaptive_wins} (reported, not gated); {n_dec} "
          f"decision_scan launches (expected {ACCEPT_EPOCHS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"SLO acceptance closed loop: saturated {a.saturated_epochs}, launches "
                        f"{n_dec}, finite {finite}")
    out["slo_acceptance"] = dict(wall_s=wall, launches=n_dec, adaptive_wins=res.adaptive_wins,
                                 means_s={n: p.mean_latency_s for n, p in res.policies.items()},
                                 saturated={n: p.saturated_epochs for n, p in res.policies.items()})

    # 5. the city pool in SLO mode, adaptive only, its counts drawn on the card
    city = city_cluster()
    trace = walk_trace(float(CITY_SLO_EPOCHS), bw0)
    gen.manual_seed(0)
    lam = torch.full((CITY_SLO_EPOCHS, CITY_CLIENTS), 2.0, dtype=torch.float64, device="cuda")
    n_req = torch.poisson(lam * trace.epoch_s, generator=gen).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t0 = time.perf_counter()
    res = simulate_cluster(city, trace, policies=("adaptive",), stagger=CITY_STAGGER,
                           n_req=n_req, **slo)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_dec = read_counts()["decision_scan"] - before["decision_scan"]
    a = res.policies["adaptive"]
    ce = CITY_SLO_EPOCHS * CITY_CLIENTS
    finite = bool(np.isfinite(a.latencies_s).all()) and a.latencies_s.shape == (
        CITY_SLO_EPOCHS, CITY_CLIENTS)
    ok = finite and n_dec == CITY_SLO_EPOCHS
    log(f"[tails] SLO city closed loop: {CITY_CLIENTS} clients x {city.n_edges} edges x "
        f"{CITY_SLO_EPOCHS} epochs, adaptive only, in {wall:.2f} s ({ce / wall:,.0f} "
        f"client-epochs/s); mean p99 {a.mean_latency_s * 1e3:.3f} ms, saturated "
        f"{a.saturated_epochs} of {ce}, offload {a.offload_frac:.1%}, switches {a.switches}; "
        f"peak device memory {peak:.2f} GiB; {n_dec} decision_scan launches (expected "
        f"{CITY_SLO_EPOCHS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"SLO city: finite {finite}, launches {n_dec}")
    out["slo_city"] = dict(clients=CITY_CLIENTS, edges=city.n_edges, epochs=CITY_SLO_EPOCHS,
                           wall_s=wall, client_epochs_per_s=ce / wall, peak_mem_gib=peak,
                           launches=n_dec, mean_latency_s=a.mean_latency_s,
                           saturated=a.saturated_epochs, offload_frac=a.offload_frac,
                           switches=a.switches)
    launches = read_counts()
    out["launches"] = launches
    log(f"[tails] launches over the tail path: {launches}")
    if any(launches[k] for k in ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan")):
        FAILURES.append(f"serving kernels ran in the tails phase: {launches}")
    short = walk_trace(4.0, bw0)
    out["slo_city_profile"] = profile_calls(
        torch, f"SLO city closed loop, 4 epochs of {CITY_CLIENTS} x {city.n_edges}",
        lambda: simulate_cluster(city, short, policies=("adaptive",), stagger=CITY_STAGGER,
                                 n_req=n_req[:4], **slo), n=1)
    return out


def phase_meanfield_plan(torch, scan_ref) -> dict:
    from repro_torch.launch import cluster_sim
    from repro_torch.launch import provision as provision_cli
    from repro_torch.launch import validate as validate_cli
    from repro_torch.plan import provision
    from repro_torch.validate.differential import _rel_err

    out: dict = {}
    reports = tempfile.TemporaryDirectory()  # the CLIs' reports, read back into RESULT
    out_dir = Path(reports.name)
    reset_counts()

    # 1. the mean-field CLI at a million clients, its other flags at their defaults
    mf_path = out_dir / "meanfield_1m.json"
    t0 = time.perf_counter()
    rc = cluster_sim.main(["--meanfield", "--clients", "1000000", "--out", str(mf_path)])
    wall = time.perf_counter() - t0
    rep = json.loads(mf_path.read_text()) if mf_path.exists() else {}
    eqr, rp = rep.get("equilibrium", {}), rep.get("replay", {})
    ok = (rc == 0 and eqr.get("converged") is True and rep.get("adaptive_wins") is True
          and rep.get("device") == "cuda")
    log(f"[meanfield] cluster_sim --meanfield --clients 1000000: exit {rc} in {wall:.2f} s; "
        f"equilibrium converged {eqr.get('converged')} in {eqr.get('iterations')} iterations, "
        f"{eqr.get('solve_s', float('nan')) * 1e3:.1f} ms; adaptive undercuts every static "
        f"price: {rep.get('adaptive_wins')}; replay {rp.get('client_epochs')} client-epochs at "
        f"{rp.get('client_epochs_per_sec', float('nan')):.4e} client-epochs/s (warm) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"--meanfield 1M: exit {rc}, converged {eqr.get('converged')}, "
                        f"wins {rep.get('adaptive_wins')}")
    out["meanfield_1m"] = dict(exit=rc, wall_s=wall, equilibrium=eqr, replay=rp,
                               adaptive_wins=rep.get("adaptive_wins"))

    # 2. provision at the CLI's default space, on the card and on the CPU
    space = provision_cli.default_space()
    before = read_counts()["decision_scan"]
    t0 = time.perf_counter()
    plan = provision(space, 48, 0.120, q=0.99, tail_method="euler", device="cuda")
    card_s = time.perf_counter() - t0
    n_dec = read_counts()["decision_scan"] - before
    t0 = time.perf_counter()
    plan_cpu = provision(space, 48, 0.120, q=0.99, tail_method="euler", device="cpu")
    cpu_s = time.perf_counter() - t0
    same = plan is not None and plan_cpu is not None
    if same:
        g, w = plan.to_dict(), plan_cpu.to_dict()
        for k, v in w.items():
            if k in ("max_latency_s", "mean_latency_s"):
                same = same and _rel_err(g[k], v) <= 1e-9
            elif k == "rho_edges":
                same = same and all(_rel_err(a, b) <= 1e-9 for a, b in zip(g[k], v))
            else:
                same = same and g[k] == v
    ok = same and n_dec >= 1
    log(f"[meanfield] provision, default space, N = 48, p99 <= 120 ms, Euler: "
        + (f"{plan.n_edges} x {plan.tier.name} at {plan.bandwidth_Bps * 8 / 1e6:g} Mbit, worst "
           f"p99 {plan.max_latency_s * 1e3:.3f} ms, {plan.evaluations} equilibrium solves"
           if plan is not None else "no plan")
        + f"; {card_s:.2f} s on the card ({n_dec} decision_scan launches), {cpu_s:.2f} s on "
          f"the CPU; the same plan: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"provision: same plan {same}, launches {n_dec}")
    out["provision"] = dict(plan=None if plan is None else plan.to_dict(), card_s=card_s,
                            cpu_s=cpu_s, same_plan_as_cpu=same, launches=n_dec)

    # 3. the validate CLI's smoke gate
    t0 = time.perf_counter()
    rc = validate_cli.main(["--smoke", "--out", str(out_dir / "VALIDATION_smoke.json")])
    wall = time.perf_counter() - t0
    log(f"[meanfield] launch/validate.py --smoke: exit {rc} in {wall:.2f} s "
        f"{'ok' if rc == 0 else 'FAIL'}")
    if rc != 0:
        FAILURES.append(f"validate --smoke exit {rc}")
    out["validate_smoke"] = dict(exit=rc, wall_s=wall)
    reports.cleanup()
    launches = read_counts()
    out["launches"] = launches
    log(f"[meanfield] launches over the mean-field and planning path: {launches}")
    return out


# ---------------------------------------------------------------------------
# the measured gate: the measure CLI's documented profiling run at full width

# HarnessConfig's defaults: 240 Poisson requests at target rho 0.45, 1 slot of
# 64 positions, prompts 8 +/- 2, at most 6 new tokens (geometric p 0.35)
MEASURE_ARGV = ["validate", "--config", "starcoder2_3b", "--full-config", "--device", "cuda"]


def log_fits(profile) -> None:
    for f in profile.fits:
        log(f"[measure]   {f.phase:8s} occ={f.occupancy}  n={f.n:4d}  {f.mean_s * 1e3:9.4f} ms  "
            f"scv={f.scv:6.3f}  {f.model.value}")


def phase_measure(torch) -> dict:
    """Three runs of the measurement harness: the reduced model on the card
    and the CPU (simulated clock: the same trace), the full-width model on
    the simulated clock through the CLI (its gate passes, kernel counts
    exact), and the full-width model on the wall clock (its gate reported)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import measure as measure_cli
    from repro_torch.measure import HarnessConfig, build_profile, load_profile, run_harness
    from repro_torch.obs import run_manifest
    from repro_torch.validate import MEASURED_VEC_TOL, run_measured_gate

    t_phase = time.perf_counter()
    out: dict = {}
    reports = tempfile.TemporaryDirectory()  # the CLI's profile and report, read back
    tmp = Path(reports.name)
    L = get_config("starcoder2_3b").num_layers

    # 1. the reduced model on the simulated clock: the card's trace is the CPU's
    hc = HarnessConfig(arch="starcoder2_3b", slots=1)
    t0 = time.perf_counter()
    card = run_harness(hc, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_harness(hc, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_trace = card.to_dict() == cpu.to_dict()
    same_profile = build_profile(card).dumps() == build_profile(cpu).dumps()
    ok = same_trace and same_profile
    log(f"[measure] reduced {hc.arch}, simulated clock: {len(card.events)} events, "
        f"{len(card.requests)} requests, lambda {card.arrival_rate!r} req/s; {card_s:.2f} s on "
        f"the card, {cpu_s:.2f} s on the CPU; traces bit-equal {same_trace}, profiles equal "
        f"{same_profile} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"reduced simulated trace: card vs CPU trace equal {same_trace}, "
                        f"profile equal {same_profile}")
    out["reduced"] = dict(events=len(card.events), requests=len(card.requests),
                          arrival_rate=card.arrival_rate, card_s=card_s, cpu_s=cpu_s,
                          same_trace=same_trace, same_profile=same_profile)
    del card, cpu

    # 2. full width, simulated clock, through the CLI: warmup runs 5 prompt
    # lengths and 1 decode step, then every recorded event is one call
    defaults = HarnessConfig(arch="starcoder2_3b")
    warm_prefills = 2 * defaults.prompt_len_jitter + 1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rc = measure_cli.main(MEASURE_ARGV + ["--out", str(tmp / "profile.json"),
                                          "--report-out", str(tmp / "gate.json")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = load_profile(tmp / "profile.json")
    rep = json.loads((tmp / "gate.json").read_text())
    n_prefill = sum(f.n for f in prof.fits if f.phase == "prefill")
    n_decode = sum(f.n for f in prof.fits if f.phase == "decode")
    expect = serving_launches(L, warm_prefills + n_prefill, 1 + n_decode)
    ok = (rc == 0 and rep["passed"] is True and launches == expect
          and n_prefill == prof.n_requests == defaults.n_requests)
    log(f"[measure] {' '.join(MEASURE_ARGV)}: exit {rc} in {wall:.2f} s (model set-up "
        f"included); lambda {prof.arrival_rate!r} req/s, rho_hat "
        f"{prof.observed_stat('rho_hat'):.4f}; peak memory {peak:.2f} GiB")
    log(f"[measure] simulated gate: mean MAPE {rep['mean']['mape_pct']:.4f}% (budget "
        f"{rep['mean']['budget_pct']:g}%), p99 MAPE {rep['tail']['mape_pct']:.4f}% (budget "
        f"{rep['tail']['budget_pct']:g}%), vec rel err {rep['vec']['rel_err']:.2e}; fits:")
    log_fits(prof)
    log(f"[measure] launches {launches}; expected {expect} for {warm_prefills} + {n_prefill} "
        f"prefills and 1 + {n_decode} decode steps {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"measure --full-config: exit {rc}, passed {rep['passed']}, launches "
                        f"{launches} != {expect}")
    out.update(argv=MEASURE_ARGV, exit=rc, wall_s=wall, peak_mem_gib=peak, launches=launches,
               gate=rep, fits=[f.to_dict() for f in prof.fits],
               arrival_rate=prof.arrival_rate, rho_hat=prof.observed_stat("rho_hat"))
    del prof
    reports.cleanup()

    # 3. full width, wall clock: the gate is reported, not gated (a measurement
    # of the closed forms against a host-bound engine, not a check of the port).
    # Its calls: warmup, 8 unrecorded calibration requests of max_new_tokens
    # tokens at one slot (1 prefill and max_new_tokens - 1 decode steps each),
    # then every recorded event
    hw = HarnessConfig(arch="starcoder2_3b", reduced=False, clock="wall")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trace = run_harness(hw, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = build_profile(trace, manifest=run_manifest(seed=hw.seed, config=hw.to_dict()))
    gate = run_measured_gate(prof, device="cuda")
    n_prefill = sum(e[1] == "prefill" for e in trace.events)
    n_decode = sum(e[1] == "decode" for e in trace.events)
    calib = hw.calibrate_requests
    expect = serving_launches(L, warm_prefills + calib + n_prefill,
                              1 + calib * (hw.max_new_tokens - 1) + n_decode)
    finite = all(math.isfinite(x) for f in prof.fits for x in (f.mean_s, f.var_s, f.scv)) and all(
        math.isfinite(x) for x in (gate.analytic_mean_s, gate.analytic_p99_s, gate.rho))
    ok = finite and gate.vec_rel_err <= MEASURED_VEC_TOL and launches == expect
    log(f"[measure] wall clock, {hw.arch} at full width: {len(trace.requests)} requests, "
        f"{len(trace.events)} events in {wall:.2f} s (model set-up included); lambda "
        f"{trace.arrival_rate!r} req/s, rho_hat {prof.observed_stat('rho_hat'):.4f}, gate rho "
        f"{gate.rho:.4f}; peak memory {peak:.2f} GiB; on {RESULT.get('card')}")
    log(f"[measure] wall-clock gate (reported, not gated): mean MAPE {gate.mean_mape_pct:.4f}% "
        f"against {gate.budget_pct:g}% -> {'PASS' if gate.mean_passed else 'FAIL'}; p99 MAPE "
        f"{gate.p99_mape_pct:.4f}% against {gate.tail_budget_pct:g}% -> "
        f"{'PASS' if gate.tail_passed else 'FAIL'}; analytic {gate.analytic_mean_s * 1e3:.3f} / "
        f"{gate.analytic_p99_s * 1e3:.3f} ms vs observed {gate.observed_mean_s * 1e3:.3f} / "
        f"{gate.observed_p99_s * 1e3:.3f} ms (mean / p99); vec rel err {gate.vec_rel_err:.2e}; "
        "fits:")
    log_fits(prof)
    log(f"[measure] launches {launches}; expected {expect} for {warm_prefills} + {calib} + "
        f"{n_prefill} prefills and 1 + {calib * (hw.max_new_tokens - 1)} + {n_decode} decode "
        f"steps (warmup + calibration + recorded) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"measure wall clock: finite {finite}, vec rel err {gate.vec_rel_err}, "
                        f"launches {launches} != {expect}")
    out["wall"] = dict(wall_s=wall, peak_mem_gib=peak, launches=launches,
                       events=len(trace.events), requests=len(trace.requests),
                       arrival_rate=trace.arrival_rate, rho_hat=prof.observed_stat("rho_hat"),
                       gate=gate.to_dict(), fits=[f.to_dict() for f in prof.fits])
    del trace, prof
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[measure] phase wall time {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the obs path: the cluster's decide spans and audits, the obs_report demo

OBS_AUDIT_EPOCHS, OBS_AUDIT_CLIENTS = range(0, ACCEPT_EPOCHS, 15), range(0, ACCEPT_CLIENTS, 8)
OBS_ARTIFACTS = ("trace.jsonl", "trace.chrome.json", "audit.jsonl", "report.md")


def phase_obs(torch) -> dict:
    """The acceptance closed loop with a tracer (one decide span per epoch,
    the same launches and results as without), ``audit_cluster`` over 8
    epochs x 8 clients on the card against the CPU, and ``obs_report --demo``
    on the card against the CPU (the artifacts byte for byte, the reduced
    engine's serving-kernel launches exact)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.fleet import simulate_cluster
    from repro_torch.launch import obs_report
    from repro_torch.launch.cluster_sim import default_cluster
    from repro_torch.measure import HarnessConfig
    from repro_torch.obs import Tracer, audit_cluster

    t_phase = time.perf_counter()
    out: dict = {}
    spec = default_cluster(ACCEPT_CLIENTS)
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))
    pols = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(spec.n_edges))
    trace = walk_trace(float(ACCEPT_EPOCHS), bw0)
    kw = dict(policies=pols, stagger=8, seed=1, device="cuda")

    # 1. the closed loop with and without a tracer: the same counts (seed 1 on
    # the card), the same launches, the same results
    reset_counts()
    t0 = time.perf_counter()
    plain = simulate_cluster(spec, trace, **kw)
    plain_s = time.perf_counter() - t0
    n_plain = read_counts()["decision_scan"]
    reset_counts()
    tracer = Tracer()
    t0 = time.perf_counter()
    res = simulate_cluster(spec, trace, tracer=tracer, **kw)
    traced_s = time.perf_counter() - t0
    n_traced = read_counts()["decision_scan"]
    choices = res.policies["adaptive"].choices
    spans = tracer.by_cat("decide")
    offloaded = [dict(sp.attrs)["offloaded"] for sp in spans]
    row_sums = offloaded == [int(n) for n in (choices >= 0).sum(axis=1)]
    same = all(np.array_equal(a.choices, b.choices) and np.array_equal(a.latencies_s,
                                                                       b.latencies_s)
               for a, b in zip(res.policies.values(), plain.policies.values()))
    ok = (len(tracer) == len(spans) == ACCEPT_EPOCHS
          and [dict(sp.attrs)["epoch"] for sp in spans] == list(range(ACCEPT_EPOCHS))
          and row_sums and n_traced == n_plain == ACCEPT_EPOCHS and same)
    log(f"[obs] closed loop {ACCEPT_CLIENTS} x {spec.n_edges} x {ACCEPT_EPOCHS} epochs with a "
        f"tracer in {traced_s:.2f} s (without {plain_s:.2f} s): {len(spans)} decide spans, "
        f"offloaded per epoch = the choices' row sums: {row_sums}; "
        f"decision_scan launches {n_traced} with the tracer, {n_plain} without (expected "
        f"{ACCEPT_EPOCHS}); results bit-equal {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"obs cluster spans: {len(tracer)} spans, launches {n_traced} / "
                        f"{n_plain}, results equal {same}")
    out["cluster"] = dict(spans=len(tracer), launches=n_traced, launches_untraced=n_plain,
                          traced_s=traced_s, plain_s=plain_s, offloaded=offloaded)

    # 2. audit_cluster on a subset, on the card and on the CPU
    t0 = time.perf_counter()
    card = audit_cluster(res, epochs=OBS_AUDIT_EPOCHS, clients=OBS_AUDIT_CLIENTS, device="cuda")
    audit_s = time.perf_counter() - t0
    cpu = audit_cluster(res, epochs=OBS_AUDIT_EPOCHS, clients=OBS_AUDIT_CLIENTS, device="cpu")
    worst = 0.0
    for a, b in zip(card, cpu):
        for strat, terms in a.terms.items():
            for k, v in terms.items():
                w = b.terms[strat][k]
                if v != w:
                    worst = max(worst, abs(v - w) / abs(w) if math.isfinite(w) and w else math.inf)
    try:
        errs = (card.verify(), cpu.verify())
    except AssertionError as exc:
        FAILURES.append(f"obs audit_cluster: {exc}")
        errs = None
    n_rows = len(OBS_AUDIT_EPOCHS) * len(OBS_AUDIT_CLIENTS)
    targets = [r.edge_index for r in card] == [r.edge_index for r in cpu] == [
        int(choices[t, i]) for t in OBS_AUDIT_EPOCHS for i in OBS_AUDIT_CLIENTS]
    ok = errs is not None and len(card) == len(cpu) == n_rows and targets and worst <= 1e-9
    log(f"[obs] audit_cluster over {len(OBS_AUDIT_EPOCHS)} epochs x {len(OBS_AUDIT_CLIENTS)} "
        f"clients: {len(card)} rows on the card in {audit_s:.3f} s; re-sum errors (card, CPU) "
        f"{errs} (limit 1e-9); targets equal the scan's and the CPU's {targets}; terms vs the "
        f"CPU max rel err {worst:.2e} (limit 1e-9) {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"obs audit_cluster: {len(card)} rows, targets {targets}, terms {worst}")
    out["audit"] = dict(rows=len(card), resum_errors=errs, terms_max_rel_err=worst,
                        card_s=audit_s)

    # 3. obs_report --demo on the card and on the CPU; warmup runs every
    # prompt length and one decode step, then each recorded event is one call
    hc = HarnessConfig(arch="starcoder2_3b")
    L = get_config("starcoder2_3b").reduced(seq_chunk=hc.seq_chunk).num_layers
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        reset_counts()
        t0 = time.perf_counter()
        rc_card = obs_report.main(["--demo", "--device", "cuda", "--out-dir", str(tmp / "cuda")])
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
        launches = read_counts()
        rc_cpu = obs_report.main(["--demo", "--device", "cpu", "--out-dir", str(tmp / "cpu")])
        equal = {n: (tmp / "cuda" / n).read_bytes() == (tmp / "cpu" / n).read_bytes()
                 for n in OBS_ARTIFACTS}
        lines = (tmp / "cuda" / "trace.jsonl").read_text().splitlines()
    cats = [json.loads(ln)["cat"] for ln in lines]
    n_prefill, n_decode = cats.count("prefill"), cats.count("decode")
    expect = serving_launches(L, 2 * hc.prompt_len_jitter + 1 + n_prefill, 1 + n_decode)
    ok = rc_card == rc_cpu == 0 and all(equal.values()) and launches == expect and n_prefill
    log(f"[obs] obs_report --demo --device cuda: exit {rc_card} in {demo_s:.2f} s, {len(lines)} "
        f"spans; artifacts equal to the --device cpu run's: {equal}")
    log(f"[obs] demo launches {launches}; expected {expect} for {2 * hc.prompt_len_jitter + 1} + "
        f"{n_prefill} prefills and 1 + {n_decode} decode steps of the reduced {L}-layer model "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"obs demo: exits {rc_card} / {rc_cpu}, equal {equal}, launches "
                        f"{launches} != {expect}")
    out["demo"] = dict(spans=len(lines), equal=equal, launches=launches, demo_s=demo_s)
    out["launches"] = {**launches, "decision_scan": n_traced}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[obs] phase wall time {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA card is visible; this smoke test runs on the card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/csrc beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.decision_scan.ops import decision_scan
    from repro_torch.kernels.decision_scan.ref import decision_scan_reference
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    from repro_torch.kernels.lindley_scan.ops import lindley_kserver, lindley_scan
    from repro_torch.kernels.lindley_scan.ref import (
        lindley_kserver_reference,
        lindley_scan_reference,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_reference, rmsnorm_reference
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_reference

    ops = (rmsnorm, rmsnorm_add, flash_attention, decode_attention)
    refs = (rmsnorm_reference, rmsnorm_add_reference, flash_attention_reference,
            decode_attention_reference)
    # every kernel a served model can launch, by the name plain_path swaps
    model_refs = dict(zip(("rmsnorm", "rmsnorm_add", "flash_attention", "decode_attention",
                           "ssm_scan"), refs + (ssm_scan_reference,)))
    lindley = (lindley_scan, lindley_kserver)
    lindley_refs = (lindley_scan_reference, lindley_kserver_reference)
    COUNTED.extend(ops + lindley + (decision_scan, ssm_scan))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    log(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    RESULT["card"] = card

    phase_build(_build)
    end_phase("build")
    ck = phase_check(torch, ops, refs)
    phase_check_lindley(torch, ck, lindley, lindley_refs)
    torch.cuda.empty_cache()
    phase_check_decision(torch, ck, decision_scan, decision_scan_reference)
    torch.cuda.empty_cache()
    phase_check_ssm(torch, ck, ssm_scan, ssm_scan_reference)
    torch.cuda.empty_cache()
    end_phase("check")
    timing = phase_time(torch, F, ops, refs)
    timing["lindley_scan"] = [phase_time_lindley(torch, lindley, lindley_refs)]
    torch.cuda.empty_cache()
    timing["decision_scan"] = [phase_time_decision(torch, decision_scan, decision_scan_reference)]
    torch.cuda.empty_cache()
    timing["ssm_scan"] = phase_time_ssm(torch, ssm_scan, ssm_scan_reference)
    torch.cuda.empty_cache()
    timing["serve_local"] = phase_time_gemma2(torch, F, flash_attention, decode_attention,
                                              flash_attention_reference,
                                              decode_attention_reference)
    torch.cuda.empty_cache()
    timing["encdec"] = phase_time_seamless(torch, F, flash_attention, decode_attention,
                                           flash_attention_reference, decode_attention_reference)
    torch.cuda.empty_cache()
    end_phase("time")
    serve = phase_serve(torch, ops, model_refs)
    gc.collect()  # the StarCoder engine goes before jamba's 52 GB of weights come
    torch.cuda.empty_cache()
    end_phase("serve")
    hybrid = phase_serve_hybrid(torch, model_refs)
    gc.collect()
    torch.cuda.empty_cache()
    end_phase("serve_hybrid")
    serve_local = phase_serve_local(torch, model_refs)
    gc.collect()
    torch.cuda.empty_cache()
    end_phase("serve_local")
    serve_xlstm = phase_serve_xlstm(torch, model_refs)
    gc.collect()
    torch.cuda.empty_cache()
    end_phase("serve_xlstm")
    encdec = phase_encdec(torch, model_refs)
    gc.collect()
    torch.cuda.empty_cache()
    end_phase("encdec")
    fleet = phase_fleet(torch)
    torch.cuda.empty_cache()
    end_phase("fleet")
    cluster = phase_cluster(torch, decision_scan_reference)
    end_phase("cluster")
    torch.cuda.empty_cache()
    tails = phase_tails(torch, decision_scan_reference)
    end_phase("tails")
    torch.cuda.empty_cache()
    meanfield_plan = phase_meanfield_plan(torch, decision_scan_reference)
    end_phase("meanfield_plan")
    gc.collect()
    torch.cuda.empty_cache()
    measure = phase_measure(torch)
    end_phase("measure")
    obs = phase_obs(torch)
    end_phase("obs")

    where = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/rmsnorm.py:32"),
        "rmsnorm_add": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/rmsnorm.py:32"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:112"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/decode_attention.py:88"),
        "lindley_scan": ("src/repro_torch/csrc/lindley_scan.cu",
                         "src/repro/kernels/lindley_scan/lindley_scan.py:58"),
        "decision_scan": ("src/repro_torch/csrc/decision_scan.cu",
                          "src/repro/kernels/decision_scan/decision_scan.py:87"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/ssm_scan.py:64"),
    }
    kernels = []
    for name, path_launches in (("rmsnorm", serve), ("rmsnorm_add", serve),
                                ("flash_attention", serve),
                                ("decode_attention", serve), ("lindley_scan", fleet),
                                ("decision_scan", cluster), ("ssm_scan", hybrid)):
        t = timing[name][0]  # the shape the main path launches most
        row = {
            "name": name, "route": "cuda", "source": where[name][0], "replaces": where[name][1],
            "launches": path_launches["launches"][name], "max_abs_err": ck.max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "eager_ms": t["eager_ms"],
        }
        if name in ("rmsnorm", "rmsnorm_add"):  # decode rows; beside them the per-launch floor
            p = timing[name][1]
            row.update(prefill_shape=p["shape"], prefill_ms=p["ms"], prefill_plain_ms=p["plain_ms"],
                       prefill_bound_ms=p["bound_ms"], prefill_library_ms=p["library_ms"],
                       launch_floor_ms=timing["launch_floor"][0]["ms"])
        if name == "rmsnorm_add":  # no one library call: torch.add, then F.rms_norm
            row.update(library_ms=None, yardstick_ms=t["library_ms"],
                       prefill_library_ms=None, prefill_yardstick_ms=p["library_ms"])
        if name in ("rmsnorm", "rmsnorm_add", "flash_attention", "decode_attention"):
            row["measure_launches"] = measure["launches"][name]  # the full-width measured gate
            row["serve_local_launches"] = serve_local["launches"][name]  # gemma2-9B
        if name in ("rmsnorm", "rmsnorm_add"):
            row["serve_xlstm_launches"] = serve_xlstm["launches"][name]  # xLSTM-1.3B
        if name in ("flash_attention", "decode_attention"):  # gemma2's hd-256 shapes
            row["serve_local_timing"] = timing["serve_local"][name]
        if name in ("rmsnorm", "rmsnorm_add", "flash_attention", "decode_attention"):
            row["encdec_launches"] = encdec["launches"][name]  # seamless
        if name in ("flash_attention", "decode_attention"):  # seamless's hd-64 shapes
            row["encdec_timing"] = timing["encdec"][name]
        if name in ("rmsnorm", "rmsnorm_add", "flash_attention", "decode_attention",
                    "decision_scan"):  # the obs phase: the demo's engine, the traced loop
            row["obs_launches"] = obs["launches"][name]
        if name in ("lindley_scan", "decision_scan"):  # launched on the new paths too
            row.update(tails_launches=tails["launches"][name],
                       meanfield_plan_launches=meanfield_plan["launches"][name])
        if name == "lindley_scan":  # no one library call; the k-server entry of the same .cu
            row.update(yardstick_ms=t["yardstick_ms"], chain_floor_ms=t["chain_floor_ms"],
                       kserver_k4_ms=t["kserver_k4_ms"],
                       kserver_k4_bound_ms=t["kserver_k4_bound_ms"],
                       kserver_launches=fleet["launches"]["lindley_kserver"])
        if name == "decision_scan":  # the closed loop launches it one epoch at a time
            row.update(epoch_ms=t["epoch_device_ms"], epoch_eager_ms=t["epoch_eager_ms"],
                       epoch_library_ms=t["epoch_library_ms"],
                       epoch_bound_ms=t["epoch_bound_ms"], ms_stagger8_h015=t["ms_stagger8_h015"])
        if name == "ssm_scan":  # launched per decode step (the row) and per prefill
            p = timing[name][1]
            row.update(prefill_shape=p["shape"], prefill_ms=p["ms"], prefill_plain_ms=p["plain_ms"],
                       prefill_bound_ms=p["bound_ms"], prefill_bound_by=p["bound_by"],
                       prefill_eager_ms=p["eager_ms"])
        kernels.append(row)
    RESULT.update(kernels=kernels, timing=timing, serve=serve, serve_hybrid=hybrid,
                  serve_local=serve_local, serve_xlstm=serve_xlstm, encdec=encdec, fleet=fleet,
                  cluster=cluster, tails=tails, meanfield_plan=meanfield_plan, measure=measure,
                  obs=obs)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULT, indent=1, default=str))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
