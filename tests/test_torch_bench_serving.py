"""The port's serving-side bench families (``repro_torch.bench.{kernel,
measure,obs}_bench``) on the CPU against the reference's
(``benchmarks/*_bench.py``), at the same shrunken module constants on both
sides (the reference sizes run on the card through ``chip_smoke.py``).

The paths the spec declares ``volatile`` (timings, rates) are masked; every
other leaf is held, and each divergence on purpose is named here:

  * kernels: the report names the reference's six kernels. On the CPU each
    wrapper runs its plain version, so its ``max_abs_err`` is ``ERR_FLOOR``
    (the reference's floor) where the reference reports its interpret-mode
    float32 error; flash runs in bfloat16 (the only dtype its kernel takes),
    so its error is its own bf16 rounding against the float32 plain
    version, within the card's bf16 tolerance. The card checks the numbers
    (``chip_smoke.py``, ``tests/test_torch_cuda.py``); no launch counter
    moves on the CPU;
  * measure: the engine's random weights come from torch, not
    ``jax.random``, but never reach the simulated clock, so the harness's
    request count and the measured gate's MAPEs, rho and verdict are the
    reference's (1e-9 relative; the verdict exactly), and the engine's token
    count is too (every request runs to its budget);
  * obs: the tracer's ``overhead_gate_pass`` depends on the host's timing
    noise (host numbers spread 15% between runs) and is not compared; the
    span count and the audit's rows are exact, its re-sum error within its
    1e-9 tolerance on both sides.

The reference's measured gate reaches ``fleet_analytic``'s x64 path, so it
runs under the C1 shim (ROADMAP C1).
"""

import contextlib
import importlib
import io
import json
import math
from numbers import Number

import jax
import jax.experimental
import pytest
import torch

from repro_torch.bench.kernel_bench import ERR_FLOOR
from repro_torch.exp import bench_family_specs

RTOL = 1e-9
BF16_ATOL = 2e-2  # chip_smoke.py's BF16_TOL: outputs round to bf16 at different points

FAMILIES = {
    "kernels": ("kernel_bench", "kernel_rows", {}),
    "measure": ("measure_bench", "measure_rows", {}),
    "obs": ("obs_bench", "obs_rows", dict(REPEATS=1, N_REQUESTS=4, AUDIT_EPOCHS=200)),
}


def _kernel_err(name):
    if name == "flash_attention":
        return lambda p, r: ERR_FLOOR < p <= BF16_ATOL and r >= ERR_FLOOR
    return lambda p, r: p == ERR_FLOOR and r >= ERR_FLOOR


# leaves held otherwise than by equality: leaf -> check(port, ref)
OTHERWISE = {
    "kernels": {f"{k}.max_abs_err": _kernel_err(k)
                for k in ("flash_attention", "decode_attention", "ssm_scan", "rmsnorm",
                          "lindley_scan", "decision_scan")},
    "obs": {"tracer.overhead_gate_pass": lambda p, r: p in (0.0, 1.0) and r in (0.0, 1.0),
            "audit.max_resum_error": lambda p, r: 0.0 <= p <= 1e-9 and 0.0 <= r <= 1e-9},
}


def _run(pkg: str, family: str, out_dir):
    module, fn, consts = FAMILIES[family]
    mod = importlib.import_module(f"{pkg}.{module}")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in consts.items():
            mp.setattr(mod, k, v)
        kw = {"device": "cpu"} if pkg == "repro_torch.bench" else {}
        out_dir.mkdir()
        with contextlib.redirect_stdout(io.StringIO()) as csv:
            report = getattr(mod, fn)(out_dir, **kw)
    doc = json.loads((out_dir / f"BENCH_{family}.json").read_text())
    return report, doc, csv.getvalue()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    cache = {}

    def get(family):
        if family not in cache:
            tmp = tmp_path_factory.mktemp(family)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                               raising=False)
                    ref = _run("benchmarks", family, tmp / "ref")
                port = _run("repro_torch.bench", family, tmp / "port")
            finally:
                torch.set_num_threads(threads)
            cache[family] = port, ref
        return cache[family]
    return get


def _flatten(doc, prefix=""):
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _close(a, b) -> bool:
    if isinstance(a, bool) or not isinstance(a, Number):
        return a == b and type(a) is type(b)
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    if not (math.isfinite(a) and math.isfinite(b)):
        return a == b
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_report_equals_the_reference(reports, family):
    (port, port_doc, _), (ref, ref_doc, _) = reports(family)
    p, r = _flatten(port), _flatten(ref)
    assert list(p) == list(r)
    volatile = set(bench_family_specs()[family].volatile[f"BENCH_{family}.json"])
    otherwise = OTHERWISE.get(family, {})
    for leaf in p:
        if leaf in volatile:
            continue
        if leaf in otherwise:
            assert otherwise[leaf](p[leaf], r[leaf]), (leaf, p[leaf], r[leaf])
            continue
        assert _close(p[leaf], r[leaf]), (leaf, p[leaf], r[leaf])
    assert json.loads(json.dumps(port)) == port_doc and json.loads(json.dumps(ref)) == ref_doc


@pytest.mark.parametrize("family", list(FAMILIES))
def test_csv_rows_are_the_reference_s(reports, family):
    (_, _, port_csv), (_, _, ref_csv) = reports(family)
    names = lambda csv: [line.split(",", 1)[0] for line in csv.splitlines()]  # noqa: E731
    assert names(port_csv) == names(ref_csv) and names(port_csv)


def test_measure_gate_is_the_reference_s(reports):
    """The portable headlines of the measure family: the simulated clock's
    gate, equal to the reference's."""
    (port, _, _), (ref, _, _) = reports("measure")
    for k in ("mean_mape_pct", "p99_mape_pct", "rho"):
        assert port["gate"][k] == pytest.approx(ref["gate"][k], rel=RTOL)
    assert port["gate"]["passed"] is ref["gate"]["passed"] is True
    assert port["engine"]["n_tokens"] == ref["engine"]["n_tokens"] == 12 * 8


def test_obs_portable_headlines(reports):
    (port, _, _), (ref, _, _) = reports("obs")
    assert port["audit"]["resum_gate_pass"] == ref["audit"]["resum_gate_pass"] == 1.0
    assert port["audit"]["n_rows"] == ref["audit"]["n_rows"] == 200
    assert port["tracer"]["n_spans_enabled"] == ref["tracer"]["n_spans_enabled"] > 0


def test_no_kernel_launches_on_the_cpu():
    """On the CPU every wrapper takes its plain version: no counter moves."""
    from repro_torch.bench.kernel_bench import kernel_rows
    from repro_torch.kernels.decision_scan.ops import decision_scan
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lindley_scan.ops import lindley_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssm_scan.ops import ssm_scan

    ops = (decision_scan, decode_attention, flash_attention, lindley_scan, rmsnorm, ssm_scan)
    before = [op.launches for op in ops]
    with contextlib.redirect_stdout(io.StringIO()):
        report = kernel_rows(None, device="cpu")
    assert len(report) == len(ops)
    assert [op.launches for op in ops] == before
