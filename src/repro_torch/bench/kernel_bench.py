"""Kernel rows for the benchmark CSV + the ``BENCH_kernels.json`` artifact
(the twin of the reference's ``benchmarks/kernel_bench.py``): each of the
port's six kernel wrappers at the reference's shapes, timed and held against
its plain PyTorch version (``kernels/*/ref.py``) on the same inputs.

On the card each wrapper launches its hand-written kernel: ``us_per_call``
times that call with a ``torch.cuda.synchronize()`` inside the timed call,
and ``max_abs_err`` is the kernel's distance from the plain version. On the
CPU each wrapper routes to the plain version itself, so ``max_abs_err`` is
``ERR_FLOOR`` (flash's is the plain version's own bf16 rounding against its
fp32 run) and ``us_per_call`` times the plain version: the CPU run checks the
report's shape, the card checks the numbers.

Differences from the reference, each forced by the port:

  * inputs are drawn with numpy from seed 0 (torch cannot replay
    ``jax.random``), so no number here is the reference's;
  * flash attention runs in bfloat16, the only dtype its kernel takes, and
    its error is taken against the plain version in float32 of the same
    bfloat16 inputs (about 1e4 times the reference's float32 error, which is
    why the port's baselines are its own); the others keep the reference's
    float32, the Lindley and decision scans their float32 costs too;
  * the reference's tile arguments (``blk_q``, ``impl=``...) do not exist in
    the port and are dropped.

``max_abs_err`` values are headline-gated by ``check_regression`` (a 10x
error growth trips the gate). Errors are floored at ``ERR_FLOOR`` so a kernel
that happens to be bit-exact against its plain version still yields a
meaningful ratio baseline.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .common import emit, timed

SEED = 0

ERR_FLOOR = 1e-9  # measurement floor for bit-exact kernels (keeps ratios finite)


def _err(out, ref) -> float:
    return max(float((out.float() - ref.float()).abs().max()), ERR_FLOOR)


def kernel_rows(out_dir: Path | None = None, device=None) -> dict:
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.decision_scan.ops import decision_scan
    from repro_torch.kernels.decision_scan.ref import decision_scan_reference
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    from repro_torch.kernels.lindley_scan.ops import lindley_scan
    from repro_torch.kernels.lindley_scan.ref import lindley_scan_reference
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_reference

    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    report: dict[str, dict] = {}

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    def normal(*shape, dtype=torch.float32):
        return tensor(rng.standard_normal(shape), dtype)

    def call(fn, *args, **kw):
        """The wrapper's call, ended by a synchronize on the card."""
        def run():
            out = fn(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out
        return run

    def record(name: str, us: float, err: float) -> None:
        report[name] = {"us_per_call": us, "max_abs_err": err}
        emit(f"kernel_{name}", us, f"max_err={err:.2e}")

    # flash attention: bf16 in, the plain version in fp32 on the same values
    q = normal(1, 256, 4, 64, dtype=torch.bfloat16)
    k = normal(1, 256, 2, 64, dtype=torch.bfloat16)
    v = normal(1, 256, 2, 64, dtype=torch.bfloat16)
    out, us = timed(call(flash_attention, q, k, v))
    ref = flash_attention_reference(q.float(), k.float(), v.float())
    record("flash_attention", us, _err(out, ref))

    # decode attention
    qd = normal(2, 1, 8, 64)
    kc = normal(2, 512, 2, 64)
    vc = normal(2, 512, 2, 64)
    out, us = timed(call(decode_attention, qd, kc, vc, 511))
    ref = decode_attention_reference(qd, kc, vc, 511)
    record("decode_attention", us, _err(out, ref))

    # ssm scan
    B, T, D, N = 2, 128, 128, 8
    dt = torch.nn.functional.softplus(normal(B, T, D)) * 0.1
    Bc = normal(B, T, N)
    Cc = normal(B, T, N)
    u = normal(B, T, D)
    A = -torch.exp(normal(D, N) * 0.5)
    (out, _), us = timed(call(ssm_scan, dt, Bc, Cc, u, A))
    ref = ssm_scan_reference(dt, Bc, Cc, u, A)[0]
    record("ssm_scan", us, _err(out, ref))

    # rmsnorm
    x = normal(8, 128, 512)
    sc = normal(512) * 0.1
    out, us = timed(call(rmsnorm, x, sc))
    ref = rmsnorm_reference(x, sc)
    record("rmsnorm", us, _err(out, ref))

    # lindley scan (the fleet simulator's per-station recurrence)
    arr = tensor(np.cumsum(rng.exponential(0.1, (16, 1024)), axis=1))
    svc = tensor(rng.exponential(0.05, (16, 1024)))
    out, us = timed(call(lindley_scan, arr, svc))
    ref = lindley_scan_reference(arr, svc)
    record("lindley_scan", us, _err(out, ref))

    # decision scan (the cluster simulator's per-epoch staggered decide step)
    costs = tensor(rng.exponential(0.05, (256, 16, 5)))
    coh = torch.as_tensor(np.arange(16) % 4, dtype=torch.int32, device=dev)
    out, us = timed(call(decision_scan, costs, coh, hysteresis=0.15, stagger=4))
    ref = decision_scan_reference(costs, coh, hysteresis=0.15, stagger=4)
    record("decision_scan", us, _err(out, ref))

    if out_dir is not None:
        (out_dir / "BENCH_kernels.json").write_text(json.dumps(report, indent=2))
    return report
