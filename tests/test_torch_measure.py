"""The port's measurement path (``repro_torch.measure``, the measured gate and
``launch/measure.py``) against the JAX package's, on the CPU.

Under the simulated clock every duration comes from the timer's seeded numpy
draws and the engine has no end-of-sequence stop, so the weights (random in
both packages, from different generators) never reach the trace: the port's
trace must equal the reference's for the same ``HarnessConfig``, event for
event and bit for bit, and so must the fits and the observed block built
from it. The gate reports are held to 1e-12 relative: the same float64
closed forms in numpy on both sides (the batched cross-check through torch
float64 here, through JAX there). Manifests differ by design (each names its
own packages) and are left out of every comparison.

The reference's gate calls ``fleet_analytic``, which needs the x64 shim for
JAX 0.9.0 (ROADMAP C1): the ``x64`` fixture applies it to each test that
runs the reference's gate, and to nothing else.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import measure as jax_cli
from repro.measure import HarnessConfig as JaxHarnessConfig
from repro.measure import SimulatedTimer as JaxSimulatedTimer
from repro.measure import build_profile as jax_build_profile
from repro.measure import fit_trace as jax_fit_trace
from repro.measure import run_harness as jax_run_harness
from repro.measure.profile import PROFILE_VERSION as JAX_PROFILE_VERSION
from repro.perf.flops import param_counts as jax_param_counts
from repro.validate.measured import run_measured_gate as jax_run_measured_gate
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import measure as cli
from repro_torch.measure import (
    DET_SCV_MAX,
    EXP_SCV_BAND,
    PERCENTILES,
    PROFILE_VERSION,
    HarnessConfig,
    MeasuredProfile,
    MeasuredTrace,
    SimulatedTimer,
    build_profile,
    fit_samples,
    fit_trace,
    load_profile,
    run_harness,
)
from repro_torch.measure.harness import TRACE_VERSION
from repro_torch.models.lm import LM
from repro_torch.perf.flops import param_counts
from repro_torch.validate import (
    DEFAULT_MEASURED_BUDGET_PCT,
    DEFAULT_MEASURED_TAIL_BUDGET_PCT,
    MEASURED_VEC_TOL,
    run_measured_gate,
)

# the runs held against the reference: the smoke gate (the CLI's default
# harness), the same at two slots (where the reference's gate fails), and the
# hybrid model (mamba state leaves, MoE FFNs) on a shorter stream
RUNS = {
    "smoke": dict(arch="starcoder2_3b", slots=1),
    "slots2": dict(arch="starcoder2_3b", slots=2),
    "jamba": dict(arch="jamba_v0_1_52b", slots=1, n_requests=60),
}
GATE_RTOL = 1e-12
# the smoke gate's numbers in the reference (HarnessConfig(arch="starcoder2_3b",
# slots=1): 240 requests, 863 events), and its failing two-slot run
SMOKE_MAPE = (2.326, 7.474)
SLOTS2_MAPE = (20.02, 75.81)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, restored after (see test_torch_fleet)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def x64(monkeypatch):
    """The reference's ``jax.experimental.enable_x64()`` for this test only."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)


@pytest.fixture(scope="module")
def ref_trace():
    """The reference's trace of each run, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_run_harness(JaxHarnessConfig(**RUNS[name]))
        return cache[name]
    return get


@pytest.fixture(scope="module")
def port_trace():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_harness(HarnessConfig(**RUNS[name]), device="cpu")
        return cache[name]
    return get


def _canonical(d: dict) -> str:
    d = dict(d)
    d.pop("manifest", None)
    return json.dumps(d, indent=2, sort_keys=True)


def _assert_close_tree(got, want, path="report"):
    """Equal structure; floats to GATE_RTOL relative, everything else exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and not isinstance(want, bool):
        if math.isinf(want) or math.isnan(want):
            assert got == want or (math.isnan(got) and math.isnan(want)), path
        else:
            assert abs(got - want) <= GATE_RTOL * abs(want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


# ---------------------------------------------------------------------------
# param_counts and the simulated timer


# configs the port does not serve yet: gemma2 local attention, xLSTM and the
# encoder-decoder (ROADMAP A5, A8, A9)
UNSERVED = ("gemma2_9b", "xlstm_1_3b", "seamless_m4t_large_v2")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_the_reference(arch, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(seq_chunk=8), cfg.reduced(seq_chunk=8)
    if arch in UNSERVED:  # passed on from num_params, naming the ROADMAP item
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            param_counts(cfg)
        return
    got = param_counts(cfg)
    assert got == jax_param_counts(jcfg) and all(type(n) is int for n in got)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "jamba_v0_1_52b", "dbrx_132b"])
def test_simulated_timer_matches_the_reference(arch):
    kw = dict(seed=5, device_flops=2e12, overhead_s=3e-4, cv2=0.3)
    jt = JaxSimulatedTimer(jax_get_config(arch), **kw)
    t = SimulatedTimer(get_config(arch), **kw)
    assert t.flop_per_token == jt.flop_per_token
    for phase in ("prefill", "decode"):
        for tokens in (1, 7, 300):
            assert t.expected_seconds(phase, tokens=tokens, occupancy=2) == \
                jt.expected_seconds(phase, tokens=tokens, occupancy=2)
    ran = []
    for i in range(50):
        phase, tokens = ("prefill", 9) if i % 3 == 0 else ("decode", 1 + i % 4)
        out, dt = t(phase, lambda: ran.append(i) or i, tokens=tokens, occupancy=1)
        jout, jdt = jt(phase, lambda: i, tokens=tokens, occupancy=1)
        assert (out, dt) == (jout, jdt)
    assert ran == list(range(50))  # the op itself runs on every call


# ---------------------------------------------------------------------------
# traces, fits and profiles


@pytest.mark.parametrize("name", list(RUNS))
def test_simulated_trace_is_the_references_bit_for_bit(name, ref_trace, port_trace):
    trace, ref = port_trace(name), ref_trace(name)
    assert trace.version == ref.version == TRACE_VERSION
    assert trace.arrival_rate == ref.arrival_rate
    assert trace.events == ref.events
    assert trace.requests == tuple(type(trace.requests[0]).from_dict(r.to_dict())
                                   for r in ref.requests)
    assert json.dumps(trace.to_dict(), sort_keys=True) == json.dumps(ref.to_dict(),
                                                                     sort_keys=True)
    assert len(trace.requests) == RUNS[name].get("n_requests", 240)
    if name == "smoke":
        assert len(trace.events) == 863


def test_trace_json_round_trips_across_packages(ref_trace, port_trace, tmp_path):
    ref = ref_trace("smoke")
    path = ref.save(tmp_path / "ref_trace.json")
    loaded = MeasuredTrace.load(path)
    assert loaded.events == port_trace("smoke").events
    assert loaded.save(tmp_path / "again.json").read_text() == path.read_text()


@pytest.mark.parametrize("name", ["smoke", "slots2"])
def test_fits_and_profile_equal_the_references(name, ref_trace, port_trace):
    trace, ref = port_trace(name), ref_trace(name)
    fits, jfits = fit_trace(trace, seed=3), jax_fit_trace(ref, seed=3)
    assert [f.to_dict() for f in fits] == [f.to_dict() for f in jfits]
    assert [f.model.value for f in fits] == [f.model.value for f in jfits]
    prof, jprof = build_profile(trace), jax_build_profile(ref)
    assert _canonical(prof.to_dict()) == _canonical(jprof.to_dict())


def test_fit_thresholds_are_the_references():
    from repro.measure import fit as jfit

    assert (DET_SCV_MAX, EXP_SCV_BAND, PERCENTILES) == (
        jfit.DET_SCV_MAX, jfit.EXP_SCV_BAND, jfit.PERCENTILES)
    assert PROFILE_VERSION == JAX_PROFILE_VERSION


def test_profile_json_is_canonical_and_loads_across_packages(ref_trace, port_trace, tmp_path):
    prof = build_profile(port_trace("smoke"), manifest={"seed": 0})
    path = prof.save(tmp_path / "p.json")
    again = load_profile(path)
    assert again == prof
    assert again.dumps() == path.read_text() == prof.dumps()
    # the reference's artifact loads in the port and serializes to the same bytes
    jpath = jax_build_profile(ref_trace("smoke"), manifest={"seed": 0}).save(
        tmp_path / "jp.json")
    assert load_profile(jpath).dumps() == jpath.read_text() == path.read_text()


def test_profile_version_gate_and_missing_fits_fail_loudly(port_trace):
    prof = build_profile(port_trace("smoke"))
    d = prof.to_dict()
    for bad in (0, PROFILE_VERSION + 1):
        with pytest.raises(ValueError, match="unsupported MeasuredProfile version"):
            MeasuredProfile.from_dict({**d, "version": bad})
    with pytest.raises(KeyError, match="no fit for"):
        prof.fit_for("request", 7)
    with pytest.raises(KeyError, match="no observed stat"):
        prof.observed_stat("latency_p42_s")
    with pytest.raises(ValueError, match="no fit group"):
        fit_trace(port_trace("smoke"), min_group=10_000)
    with pytest.raises(ValueError, match="no samples"):
        fit_samples([], phase="decode", occupancy=1)
    with pytest.raises(ValueError, match="positive"):
        fit_samples([1e-3, 0.0], phase="decode", occupancy=1)


# ---------------------------------------------------------------------------
# the measured gate


@pytest.mark.parametrize("name", ["smoke", "slots2"])
def test_measured_gate_equals_the_references(name, ref_trace, port_trace, x64):
    rep = run_measured_gate(build_profile(port_trace(name)), device="cpu")
    jrep = jax_run_measured_gate(jax_build_profile(ref_trace(name)))
    _assert_close_tree(rep.to_dict(), jrep.to_dict())
    assert rep.passed == jrep.passed
    assert rep.vec_rel_err <= MEASURED_VEC_TOL
    want = SMOKE_MAPE if name == "smoke" else SLOTS2_MAPE
    places = 3 if name == "smoke" else 2
    assert (round(rep.mean_mape_pct, places), round(rep.p99_mape_pct, places)) == want
    # the smoke gate passes; at two slots the closed forms miss, as in the reference
    assert rep.passed is (name == "smoke")
    assert (rep.budget_pct, rep.tail_budget_pct) == (DEFAULT_MEASURED_BUDGET_PCT,
                                                     DEFAULT_MEASURED_TAIL_BUDGET_PCT)


def test_measured_gate_budgets_bind(port_trace):
    prof = build_profile(port_trace("smoke"))
    rep = run_measured_gate(prof, budget_pct=0.001, device="cpu")
    assert not rep.mean_passed and rep.tail_passed and not rep.passed
    rep = run_measured_gate(prof, tail_budget_pct=0.001, device="cpu")
    assert rep.mean_passed and not rep.tail_passed and not rep.passed


# ---------------------------------------------------------------------------
# the CLI against the reference CLI


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    # "wrote <path> in <seconds>s": the paths and wall times differ by design
    return rc, [line for line in out.splitlines() if not line.startswith("wrote ")]


def test_cli_profile_and_fit_match_the_reference_cli(tmp_path, capsys):
    flags = ["--requests", "60", "--seed", "2", "--slots", "1"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    rc, out = _run_cli(cli.main, ["profile", *flags, "--device", "cpu",
                                  "--trace-out", str(ours / "trace.json"),
                                  "--out", str(ours / "profile.json")], capsys)
    jrc, jout = _run_cli(jax_cli.main, ["profile", *flags,
                                        "--trace-out", str(theirs / "trace.json"),
                                        "--out", str(theirs / "profile.json")], capsys)
    assert rc == jrc == 0 and out == jout
    assert (ours / "trace.json").read_text() == (theirs / "trace.json").read_text()
    profile = json.loads((ours / "profile.json").read_text())
    assert _canonical(profile) == _canonical(json.loads((theirs / "profile.json").read_text()))
    assert profile["manifest"]["packages"].keys() == {"torch", "numpy"}

    # fit, each CLI on the other package's trace
    rc, out = _run_cli(cli.main, ["fit", "--trace", str(theirs / "trace.json"), "--seed", "4",
                                  "--out", str(ours / "refit.json")], capsys)
    jrc, jout = _run_cli(jax_cli.main, ["fit", "--trace", str(ours / "trace.json"),
                                        "--seed", "4", "--out", str(theirs / "refit.json")],
                         capsys)
    assert rc == jrc == 0 and out == jout
    assert _canonical(json.loads((ours / "refit.json").read_text())) == _canonical(
        json.loads((theirs / "refit.json").read_text()))


@pytest.mark.parametrize("extra, exit_code", [([], 0), (["--slots", "2"], 1),
                                              (["--budget", "0.001"], 1)],
                         ids=["smoke", "slots2", "tight-budget"])
def test_cli_validate_matches_the_reference_cli(extra, exit_code, tmp_path, capsys, x64):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    rc, out = _run_cli(cli.main, ["validate", *extra, "--device", "cpu",
                                  "--report-out", str(ours)], capsys)
    jrc, jout = _run_cli(jax_cli.main, ["validate", *extra, "--report-out", str(theirs)],
                         capsys)
    assert rc == jrc == exit_code
    assert out == jout
    rep, jrep = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert rep.pop("manifest")["packages"].keys() == {"torch", "numpy"}
    jrep.pop("manifest")
    _assert_close_tree(rep, jrep)


def test_cli_validate_reads_a_saved_profile(port_trace, tmp_path, capsys):
    path = build_profile(port_trace("slots2")).save(tmp_path / "p.json")
    rc, out = _run_cli(cli.main, ["validate", "--profile", str(path), "--device", "cpu",
                                  "--report-out", str(tmp_path / "r.json")], capsys)
    assert rc == 1 and out[-1] == "overall: FAIL"
    assert json.loads((tmp_path / "r.json").read_text())["passed"] is False


# ---------------------------------------------------------------------------
# the device and the wall clock


def test_no_card_raises(monkeypatch, tmp_path):
    """Entry points run on the card unless asked for the CPU: with no card
    visible, the harness and the CLI's default ``--device`` raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_harness(HarnessConfig(arch="starcoder2_3b", n_requests=4))
    for cmd in (["profile", "--out", str(tmp_path / "p.json")],
                ["validate", "--report-out", str(tmp_path / "r.json")]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main([cmd[0], "--requests", "4", *cmd[1:]])
    assert not list(tmp_path.iterdir())


def test_wall_clock_run_is_well_formed(monkeypatch):
    """A short wall-clock run on the CPU: real durations, the same request and
    event structure as a serving run, and the model calls the card's launch
    counts rest on — warmup (5 prompt lengths, 1 decode step), 8 unrecorded
    calibration requests of ``max_new_tokens`` tokens at one slot (1 prefill
    and max_new_tokens - 1 decode steps each), then the recorded events."""
    calls = {"prefill": 0, "decode": 0}
    prefill, decode_step = LM.prefill, LM.decode_step

    def counted(fn, key):
        def wrapped(self, *a, **kw):
            calls[key] += 1
            return fn(self, *a, **kw)
        return wrapped

    monkeypatch.setattr(LM, "prefill", counted(prefill, "prefill"))
    monkeypatch.setattr(LM, "decode_step", counted(decode_step, "decode"))
    hc = HarnessConfig(arch="starcoder2_3b", clock="wall", n_requests=24, seed=1)
    trace = run_harness(hc, device="cpu")

    assert len(trace.requests) == 24 and np.isfinite(trace.arrival_rate)
    assert trace.arrival_rate > 0
    ev = trace.events
    assert all(e[2] > 0 and e[6] is False for e in ev)  # real durations, nothing cold
    assert [e[0] for e in ev] == sorted(e[0] for e in ev)
    n_prefill = sum(e[1] == "prefill" for e in ev)
    n_decode = sum(e[1] == "decode" for e in ev)
    assert n_prefill == 24 and all(e[3] == 1 for e in ev)
    assert n_decode == sum(r.n_decode for r in trace.requests) == sum(
        r.n_tokens - 1 for r in trace.requests)
    for r in trace.requests:
        assert r.arrival_s <= r.t_admit <= r.t_first_token <= r.t_done
        assert 1 <= r.n_tokens <= hc.max_new_tokens
    assert calls == {"prefill": 5 + hc.calibrate_requests + n_prefill,
                     "decode": 1 + hc.calibrate_requests * (hc.max_new_tokens - 1) + n_decode}

    prof = build_profile(trace)
    assert prof.clock == "wall" and prof.n_requests == 24
    assert all(np.isfinite([f.mean_s, f.var_s, f.scv]).all() for f in prof.fits)
    rep = run_measured_gate(prof, device="cpu")
    assert np.isfinite([rep.analytic_mean_s, rep.observed_mean_s, rep.rho]).all()
    assert rep.vec_rel_err <= MEASURED_VEC_TOL
