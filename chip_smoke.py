#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card (H100).

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases; any failure exits non-zero before the result lines are printed:
  1. build: compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source, all
     started together) and print ptxas' register / shared-memory report;
  2. check: every kernel against its plain PyTorch version on the card, on the
     same inputs, at the slice's shapes and edge cases (ragged prompts,
     Sq < Skv, window + softcap, decode at pos 700 of 1024, garbage past pos;
     Lindley scans bit for bit in float64 and float32 at B = 1, ragged B and T,
     zero services, arrival ties, k-server rows of mixed k, and the fleet
     path's (4096, 120000) float64);
  3. time: each kernel's device time per call (CUDA-graph replay between CUDA
     events) beside its plain version, one PyTorch library call for the same
     function (a yardstick the port never calls; for the Lindley scan, which
     no single call computes, the cumsum/cummax identity instead) and its
     bound max(bytes / 3.35 TB/s, operations / peak rate); and its eager time
     per call from Python, host overhead included;
  4. serve: StarCoder2-3B at full width (bf16, random weights from seed 0)
     serving 16 Poisson requests through the serving CLI's own path
     (``repro_torch.launch.serve.run``), with the launch counters reset just
     before and read just after; then the served model's kernel-path logits
     held against its plain path, and a profiler trace of decode steps;
  5. fleet: the fleet path at its users' sizes, counters reset just before and
     read just after: ``repro_torch.launch.fleet_sweep.run_sweep`` over a
     131,072-row grid with bandwidth crossovers (spot rows held against the
     scalar closed forms), ``simulate_fleet`` on 4,096 rows x 120,000 jobs on
     the device and through edge[0] (one and three Lindley launches; steady
     means within 5% MAPE of the closed forms) and through an edge of 1..4
     servers (two launches and one k-server launch), and differential gates
     1-3 on the golden corpus' smoke subset;
  6. report: one ``kernels`` JSON line, the card's name and power limit as
     nvidia-smi gives them, and the final ``{"ok": true, ...}`` line.
Everything it measures also goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
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
# decode attention stages K/V and accumulates in fp32 and rounds once; its
# bf16 error on the card was 3.9e-3 at most (one bf16 step below 1)
DECODE_BF16_TOL = dict(atol=8e-3, rtol=1e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)  # same arithmetic, other summation order
# kernel-path vs plain-path logits of the full 30-layer bf16 model: bf16
# rounding of attention outputs compounds over 30 residual layers
LOGITS_REL_L2 = 3e-2

FAILURES: list[str] = []
RESULT: dict = {}
COUNTED: list = []  # every kernel wrapper with a launch counter (filled by main)

# the fleet path's sizes: the acceptance sweep of tests/test_fleet.py (131,072
# rows) and the reference's full differential-gate run length (base_n 120,000)
SWEEP_AXES = {"network.bandwidth_Bps": ("geom", 1e5, 1e8, 512),
              "workload.arrival_rate": ("lin", 0.5, 30.0, 256)}
SIM_ROWS, SIM_JOBS = 4096, 120_000
SIM_MAPE_BUDGET_PCT = 5.0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def end_phase(name: str) -> None:
    if FAILURES:
        fail(f"phase {name}: " + "; ".join(FAILURES))
    log(f"[smoke] phase {name} passed")


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
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                log(f"[build] {name}: {line.strip()}")


class Checker:
    def __init__(self, torch):
        self.torch = torch
        self.max_err: dict[str, float] = {}

    def compare(self, name: str, what: str, got, want, tol: dict) -> None:
        torch = self.torch
        got_f, want_f = got.float(), want.float()
        err = (got_f - want_f).abs()
        ok = bool(torch.isfinite(got_f).all()) and got.shape == want.shape and bool(
            (err <= tol["atol"] + tol["rtol"] * want_f.abs()).all())
        e = float(err.max())
        self.max_err[name] = max(self.max_err.get(name, 0.0), e)
        log(f"[check] {name:16s} {what:52s} max_abs_err {e:.3e} "
            f"(atol {tol['atol']:g} rtol {tol['rtol']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{name} {what}: max_abs_err {e:.3e}")

    def run(self, name: str, what: str, fn) -> None:
        try:
            fn()
        except Exception as exc:  # record and go on: one run reports every case
            log(f"[check] {name:16s} {what:52s} ERROR {type(exc).__name__}: {exc}")
            FAILURES.append(f"{name} {what}: {type(exc).__name__}: {exc}")


def phase_check(torch, ops, refs) -> Checker:
    rmsnorm, flash_attention, decode_attention = ops
    rmsnorm_ref, flash_ref, decode_ref = refs
    ck = Checker(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    # rmsnorm: prefill and decode rows of StarCoder2-3B, odd widths, fp32
    for shape, dtype in [((256, 3072), torch.bfloat16), ((4, 1, 3072), torch.bfloat16),
                         ((3, 97, 256), torch.bfloat16), ((64, 3072), torch.float32),
                         ((5, 16), torch.float32)]:
        def case(shape=shape, dtype=dtype):
            x = randn(*shape, dtype=dtype, scale=3.0)
            sc = randn(shape[-1], dtype=dtype, scale=0.2)  # non-zero: (1+scale) matters
            tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            ck.compare("rmsnorm", f"x {tuple(shape)} {str(dtype)[6:]}", rmsnorm(x, sc, 1e-6),
                       rmsnorm_ref(x, sc, 1e-6), tol)
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
    torch.cuda.synchronize()
    return ck


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


def phase_time(torch, F, ops, refs) -> dict:
    """Kernel, plain and library times at the main path's shapes: device time
    per call (CUDA-graph replay) and, for the kernel, the eager time per call
    from Python. L2 is warm: every call reads the same inputs."""
    rmsnorm, flash_attention, decode_attention = ops
    rmsnorm_ref, flash_ref, decode_ref = refs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = {}

    def record(name, shape, kernel, plain, library, nbytes, nops, peak):
        b_ms, b_by = bound(nbytes, nops, peak)
        r = dict(shape=shape, ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
                 library_ms=device_ms(torch, library), bound_ms=b_ms, bound_by=b_by,
                 eager_ms=eager_ms(torch, kernel), library_eager_ms=eager_ms(torch, library))
        rows.setdefault(name, []).append(r)
        log(f"[time] {name:16s} {shape:44s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            f"  library {r['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({b_by});  eager from "
            f"Python: kernel {r['eager_ms']:.4f} ms, library {r['library_eager_ms']:.4f} ms")

    d = 3072
    for n in (4, 256):  # decode rows (4 slots), prefill rows (a 256-token prompt)
        x, sc = randn(n, d), randn(d) * 0.2
        w = (1.0 + sc.float()).to(torch.bfloat16)
        record("rmsnorm", f"x ({n},{d}) bf16", lambda: rmsnorm(x, sc, 1e-6),
               lambda: rmsnorm_ref(x, sc, 1e-6), lambda: F.rms_norm(x, (d,), w, 1e-6),
               nbytes=2 * (2 * n * d + d), nops=4 * n * d, peak=FP32_OPS)

    for L in (256, 1024):
        q, k, v = randn(1, L, 24, 128), randn(1, L, 2, 128), randn(1, L, 2, 128)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        pairs = L * (L + 1) // 2  # causal (q, k) pairs this input needs
        record("flash_attention", f"q (1,{L},24,128) kv (1,{L},2,128) causal",
               lambda: flash_attention(q, k, v), lambda: flash_ref(q, k, v),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True),
               nbytes=2 * (2 * L * 24 * 128 + 2 * L * 2 * 128), nops=4 * 24 * 128 * pairs,
               peak=BF16_OPS)

    for pos in (300, 1023):
        q, kc, vc = randn(4, 1, 24, 128), randn(4, 1024, 2, 128), randn(4, 1024, 2, 128)
        n = pos + 1
        qt = q.transpose(1, 2)
        kt, vt = kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
        record("decode_attention", f"q (4,1,24,128) cache (4,1024,2,128) pos {pos}",
               lambda: decode_attention(q, kc, vc, pos), lambda: decode_ref(q, kc, vc, pos),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
               nbytes=2 * (2 * 4 * 24 * 128 + 2 * 4 * n * 2 * 128), nops=4 * 4 * 24 * 128 * n,
               peak=BF16_OPS)
    return rows


# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_path(refs):
    """Route the model through the plain versions (for the logits check only)."""
    from repro_torch.models import attention, layers

    saved = (layers.rmsnorm, attention.flash_attention, attention.decode_attention)
    layers.rmsnorm, attention.flash_attention, attention.decode_attention = refs
    try:
        yield
    finally:
        layers.rmsnorm, attention.flash_attention, attention.decode_attention = saved


# the slice's cell: 16 Poisson requests at 20 rps, prompts 256 +/- 64, 32 new
# tokens, 4 slots of 1024 positions, at full width
SERVE_ARGV = ["--arch", "starcoder2_3b", "--requests", "16", "--rps", "20",
              "--prompt-len", "256", "--prompt-jitter", "64", "--max-new", "32",
              "--slots", "4", "--max-seq", "1024", "--device", "cuda"]


def phase_serve(torch, ops, refs) -> dict:
    from repro_torch.launch import serve
    from repro_torch.models.lm import num_params

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine = serve.run(SERVE_ARGV)  # the CLI's path: model, warmup, replay, summary
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    cfg, model = engine.cfg, engine.model
    n_params = model.num_params()
    if cfg.name != "starcoder2_3b" or n_params != num_params(cfg):
        FAILURES.append(f"served {cfg.name} holds {n_params} params, template says "
                        f"{num_params(cfg)}")
    out: dict = {"params": n_params, "argv": SERVE_ARGV}
    n_requests, max_new = 16, 32
    lengths = sorted({len(r.prompt) for r in engine.completed})
    s = serve.summarize(engine)
    s.update(wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[serve] {s['requests_done']} requests done in {wall:.2f} s wall (model set-up and "
        f"warmup of {len(lengths)} prompt lengths included)")
    log(f"[serve] latency p50 {s['latency_p50_ms']:.2f} ms, p99 {s['latency_p99_ms']:.2f} ms "
        "(Poisson 20 rps replayed on the engine clock)")
    log(f"[serve] prefill {s['prefill_ms_mean']:.3f} ms mean over {s['prefills']}; decode step "
        f"{s['decode_step_ms_mean']:.3f} ms mean over {s['decode_steps']} "
        f"(weight-read floor {2 * n_params / HBM_BPS * 1e3:.3f} ms)")
    log(f"[serve] {s['tokens_out']} tokens, {s['tokens_per_s_busy']:.1f} tokens/s of busy time; "
        f"peak memory {s['peak_mem_gib']:.2f} GiB")
    out["serve"] = s

    # outputs: every request done with all its tokens, ids inside the padded vocab
    if s["requests_done"] != n_requests:
        FAILURES.append(f"{s['requests_done']} of {n_requests} requests done")
    for r in engine.completed:
        if len(r.tokens_out) != max_new or not all(
                0 <= t < cfg.padded_vocab for t in r.tokens_out):
            FAILURES.append(f"request {r.rid}: {len(r.tokens_out)} tokens {r.tokens_out[:4]}...")

    # launch counts: every prefill and decode call (warmup included) went through the kernels
    n_prefill = len(lengths) + sum(ev.phase == "prefill" for ev in engine.service_log)
    n_decode = 1 + sum(ev.phase == "decode" for ev in engine.service_log)
    n_norm = 2 * cfg.num_layers + 1
    expect = {"rmsnorm": n_norm * (n_prefill + n_decode),
              "flash_attention": cfg.num_layers * n_prefill,
              "decode_attention": cfg.num_layers * n_decode,
              "lindley_scan": 0, "lindley_kserver": 0}
    log(f"[serve] launches {launches}; expected {expect} for {n_prefill} prefills "
        f"({n_norm} rmsnorm + {cfg.num_layers} flash each) and {n_decode} decode steps "
        f"({n_norm} rmsnorm + {cfg.num_layers} decode each)")
    if launches != expect:
        FAILURES.append(f"launch counts {launches} != {expect}")
    out["launches"] = launches

    # the served model, kernel path vs plain path: a ragged prompt, then one decode step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    L = 241
    prompt = torch.randint(0, cfg.vocab_size, (1, L), generator=gen, device="cuda")
    logits_k, caches_k = model.prefill(prompt)
    with plain_path(refs):
        logits_p, caches_p = model.prefill(prompt)
    nxt = logits_p[:, -1].argmax(-1, keepdim=True)
    steps = {}
    for name, caches, ctx in (("kernel", caches_k, contextlib.nullcontext()),
                              ("plain", caches_p, plain_path(refs))):
        full = model.init_caches(1, 1024)
        for dst, src in zip(full, caches):
            for key in dst:
                dst[key][:, :, :L].copy_(src[key])
        with ctx:
            steps[name] = model.decode_step(nxt, L, full)[0]
    for what, got, want in (("prefill logits", logits_k, logits_p),
                            ("decode-step logits", steps["kernel"], steps["plain"])):
        g, w = got.float(), want.float()
        rel = float((g - w).norm() / w.norm())
        same = float((g.argmax(-1) == w.argmax(-1)).float().mean())
        ok = bool(torch.isfinite(g).all()) and g.shape == (1, 1, cfg.padded_vocab) \
            and rel <= LOGITS_REL_L2
        log(f"[serve] {what} ({L}-token prompt), kernel vs plain path: rel_l2 {rel:.3e} "
            f"(limit {LOGITS_REL_L2:g}), max_abs {float((g - w).abs().max()):.3e}, "
            f"|logits|max {float(w.abs().max()):.3f}, argmax agree {same:.0%} "
            f"{'ok' if ok else 'FAIL'}")
        out[f"{what.replace(' ', '_')}_rel_l2"] = rel
        if not ok:
            FAILURES.append(f"{what}: rel_l2 {rel:.3e}")
    del caches_k, caches_p, logits_k, logits_p

    out["profile"] = profile_decode(torch, engine, model)
    return out


def profile_decode(torch, engine, model) -> dict | None:
    """Device busy share and time by kernel over 5 decode steps at 4 slots."""
    try:
        from torch.profiler import ProfilerActivity, profile
    except ImportError:
        return None
    tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    caches = model.init_caches(4, 1024)
    for _ in range(2):
        model.decode_step(tok, 300, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            model.decode_step(tok, 300, caches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    kernels, dev_total = [], 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue  # host-side ops; their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 5e3, e.key, e.count // 5))
            dev_total += us / 5e3
    kernels.sort(reverse=True)
    if not kernels:
        log("[profile] no device time in the trace: device busy share not measured")
        return None
    log(f"[profile] decode step at pos 300, 4 slots: {wall_ms:.3f} ms wall, device busy "
        f"{dev_total:.3f} ms ({dev_total / wall_ms:.0%}); top kernels by device time:")
    for ms, key, count in kernels[:8]:
        log(f"[profile]   {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_total,
            "top": [dict(ms=ms, name=key, per_step=count) for ms, key, count in kernels[:12]]}


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
    r = dict(shape=f"arrivals, services ({SIM_ROWS},{SIM_JOBS}) float64",
             ms=device_ms(torch, lambda: lindley_scan(arr, svc), calls=5, replays=4),
             plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
             yardstick_ms=device_ms(torch, identity, calls=5, replays=4),
             eager_ms=eager_ms(torch, lambda: lindley_scan(arr, svc), iters=5, warmup=1),
             kserver_k4_ms=eager_ms(torch, lambda: lindley_kserver(arr, svc4, k, 4),
                                    iters=3, warmup=1))
    log(f"[time] {'lindley_scan':16s} {r['shape']:44s} kernel {r['ms']:.4f} ms  plain "
        f"{plain_ms:.1f} ms (eager loop)  yardstick cumsum/cummax {r['yardstick_ms']:.4f} ms  "
        f"bound {b_ms:.5f} ms ({b_by});  k-server at k=4 {r['kserver_k4_ms']:.4f} ms (from "
        f"Python: its wrapper reads k's range on the host, which a graph cannot capture); "
        f"eager from Python: kernel {r['eager_ms']:.4f} ms")
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
                           max_n_factor=2.0, bootstrap=100, sim_cross_count=2, device="cuda")
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
    out["gates"] = {k: d[k] for k in ("passed", "covers", "scalar_vs_vec", "golden",
                                      "mape_gate", "sim_cross")}

    launches = read_counts()
    out["launches"] = launches
    log(f"[fleet] launches over the fleet path: {launches} (the sweep alone: {sweep_counts})")
    others = {k: v for k, v in launches.items() if not k.startswith("lindley")}
    if any(others.values()) or any(sweep_counts.values()) or launches["lindley_scan"] < 9 \
            or launches["lindley_kserver"] < 1:
        FAILURES.append(f"fleet launch counts {launches}, sweep {sweep_counts}")
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
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    from repro_torch.kernels.lindley_scan.ops import lindley_kserver, lindley_scan
    from repro_torch.kernels.lindley_scan.ref import (
        lindley_kserver_reference,
        lindley_scan_reference,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    ops = (rmsnorm, flash_attention, decode_attention)
    refs = (rmsnorm_reference, flash_attention_reference, decode_attention_reference)
    lindley = (lindley_scan, lindley_kserver)
    lindley_refs = (lindley_scan_reference, lindley_kserver_reference)
    COUNTED.extend(ops + lindley)
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
    end_phase("check")
    timing = phase_time(torch, F, ops, refs)
    timing["lindley_scan"] = [phase_time_lindley(torch, lindley, lindley_refs)]
    torch.cuda.empty_cache()
    end_phase("time")
    serve = phase_serve(torch, ops, refs)
    torch.cuda.empty_cache()
    end_phase("serve")
    fleet = phase_fleet(torch)
    end_phase("fleet")

    where = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/rmsnorm.py:32"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:112"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/decode_attention.py:88"),
        "lindley_scan": ("src/repro_torch/csrc/lindley_scan.cu",
                         "src/repro/kernels/lindley_scan/lindley_scan.py:58"),
    }
    kernels = []
    for name, path_launches in (("rmsnorm", serve), ("flash_attention", serve),
                                ("decode_attention", serve), ("lindley_scan", fleet)):
        t = timing[name][0]  # the shape the main path launches most
        row = {
            "name": name, "route": "cuda", "source": where[name][0], "replaces": where[name][1],
            "launches": path_launches["launches"][name], "max_abs_err": ck.max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "eager_ms": t["eager_ms"],
        }
        if name == "lindley_scan":  # no one library call; the k-server entry of the same .cu
            row.update(yardstick_ms=t["yardstick_ms"], kserver_k4_ms=t["kserver_k4_ms"],
                       kserver_launches=fleet["launches"]["lindley_kserver"])
        kernels.append(row)
    RESULT.update(kernels=kernels, timing=timing, serve=serve, fleet=fleet)
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
