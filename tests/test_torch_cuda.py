"""The port's hand-written kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper card and nvcc, and skip
elsewhere. On a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(``python3 chip_smoke.py`` runs the same comparisons at more shapes, times
the kernels, serves the full-width model and runs the fleet and cluster
paths.) The fused add + RMSNorm is held bit for bit to torch's add followed
by the RMSNorm kernel. Tolerances: bfloat16 2e-2 (outputs round to bf16 at different
points), float32 1e-5; the Lindley and decision scans exact (one max and one
add per job; compares and one multiply per decision, no reassociation); the
fleet path on the card against the CPU 1e-12 relative on departure clocks
(the card's cumsum associates differently) and 1e-9 on the closed forms (the
card's pow/log/exp may round an ulp apart); the cluster on the card against
the CPU on the same counts: choices exact, floats 1e-12 relative (client-axis
sums associate differently), the rate estimators exact; the selective scan's
bf16 y to one bf16 step plus the fp32 sum order, its fp32 state to 1e-5;
the batched tails on the card against the CPU 1e-8 (the same trajectory;
the card's complex products may round an ulp apart, which moves a quantile
~1e-12) for Euler, 1e-6 for the asymptote, but an Euler row whose CDF's
rounding noise fixes its quantile only to a wider band, at twice that band
(ROADMAP C10: past rho 0.99 an ulp moves the search onto other noise; 3
rows of 1,646 here, measured by ``launch.euler_parity.noise_band``); the
SLO closed loop's choices exact on the same counts; the mean-field fixed
point 1e-12 (closed forms over a few dozen rows, the same iteration count);
the measurement harness's simulated trace on the card equal to the CPU's bit
for bit (its durations are the timer's seeded draws), and so its engine's
spans; the closed loop's decide spans and ``audit_cluster`` rows on the card
against the CPU's: counts and targets exact, latencies and terms 1e-9;
gemma2's hd-256 attention shapes with q drawn past the soft-cap, to the
same bf16 tolerances and to rel-L2 1e-2 over blocks of rows (the kernel with
no cap must fail it), and a reduced gemma2 engine in bf16 on the card
followed by the CPU's: logits at every step to the bf16 tolerance, tokens
equal wherever the CPU's top two logits stand further apart than it;
seamless's norm and attention shapes (norms at d 1024, the unmasked
encoder over 1500 and 613 frames, cross-attention at prefill with fewer and
more queries than keys, the causal 2-token prompts, cross decode over 1500
frames and self decode over 66 slots) to the same bf16 tolerances, and a
reduced seamless in bf16 on the card against the CPU's logits through
encode, prefill and decode; the latency predictor fitted on the card by
default against the CPU from the same initial weights, its held-out
predictions to the paper phase's tolerance.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.predictor import LatencyPredictor, workload_features
from repro_torch.fleet import (
    ScenarioBatch,
    fleet_analytic,
    fleet_crossover,
    fleet_tail,
    make_trace,
    simulate_cluster,
    simulate_fleet,
    solve_meanfield_equilibrium,
    step_signal,
)
from repro_torch.kernels.decision_scan.ops import STAGES, decision_scan, scan_plan
from repro_torch.kernels.decision_scan.ref import decision_scan_reference
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
from repro_torch.kernels.lindley_scan.ops import STAGES as LINDLEY_STAGES
from repro_torch.kernels.lindley_scan.ops import TILE as LINDLEY_TILE
from repro_torch.kernels.lindley_scan.ops import lindley_kserver, lindley_scan
from repro_torch.kernels.lindley_scan.ref import (
    lindley_kserver_reference,
    lindley_scan_reference,
)
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_reference, rmsnorm_reference
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_reference
from repro_torch.launch.cluster_sim import default_cluster, default_meanfield
from repro_torch.launch import euler_parity
from repro_torch.launch.fleet_sweep import default_scenario
from repro_torch.measure import HarnessConfig, build_profile, run_harness
from repro_torch.obs import Tracer, audit_cluster
from repro_torch.validate import EULER_VEC_RHO_MAX, bottleneck_rho, meanfield_gate_specs

pytestmark = pytest.mark.cuda

BF16 = dict(atol=2e-2, rtol=2e-2)
FP32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a; no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16), (torch.float32, FP32)])
def test_rmsnorm(gen, dtype, tol):
    x, sc = randn(gen, 7, 3072, dtype=dtype) * 3, randn(gen, 3072, dtype=dtype) * 0.2
    before = rmsnorm.launches
    out = rmsnorm(x, sc, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_reference(x, sc, 1e-6).float(), **tol)


NORM_SHAPES = [(4, 1, 3072), (256, 3072), (4, 1, 4096), (256, 4096), (3, 97, 256), (5, 16),
               (2, 7168),
               # seamless (d 1024): decode rows, 2-token prompts, 4 x 1500 frames, 613
               (4, 1024), (8, 1024), (6000, 1024), (613, 1024)]


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16), (torch.float32, FP32)])
def test_rmsnorm_add_is_add_then_rmsnorm(gen, shape, dtype, tol):
    x, r = randn(gen, *shape, dtype=dtype) * 3, randn(gen, *shape, dtype=dtype)
    sc = randn(gen, shape[-1], dtype=dtype) * 0.2
    before = (rmsnorm.launches, rmsnorm_add.launches)
    s, y = rmsnorm_add(x, r, sc, 1e-6)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_add.launches) == (before[0], before[1] + 1)
    assert s.dtype == y.dtype == dtype and s.shape == y.shape == x.shape
    assert torch.equal(s, x + r)  # rounded once to x's dtype, as torch's add
    assert torch.equal(y, rmsnorm(s, sc, 1e-6))  # the same reduction, bit for bit
    rs, ry = rmsnorm_add_reference(x, r, sc, 1e-6)
    assert torch.equal(s, rs)
    torch.testing.assert_close(y.float(), ry.float(), **tol)


@pytest.mark.parametrize("tpr,rows_per_cta", [(32, 1), (32, 4), (64, 2), (128, 1), (128, 2),
                                              (256, 1), (512, 1)])
@pytest.mark.parametrize("shape,dtype", [((256, 3072), torch.bfloat16),
                                         ((4, 3072), torch.bfloat16),
                                         ((33, 1024), torch.float32)])
def test_rmsnorm_every_plan(gen, tpr, rows_per_cta, shape, dtype):
    """The plan's neighbours: a warp per row up to a CTA per row, one to four
    rows per CTA, each held to the plain version; both entries bit-equal."""
    x, r = randn(gen, *shape, dtype=dtype) * 3, randn(gen, *shape, dtype=dtype)
    sc = randn(gen, shape[-1], dtype=dtype) * 0.2
    plan = norm_ops.norm_plan(shape[0], shape[1], x.element_size(), threads_per_row=tpr,
                              rows_per_cta=rows_per_cta)
    y = norm_ops._launch(x, None, sc, 1e-6, plan)
    s, ys = norm_ops._launch(x, r, sc, 1e-6, plan)
    torch.cuda.synchronize()
    tol = BF16 if dtype == torch.bfloat16 else FP32
    torch.testing.assert_close(y.float(), rmsnorm_reference(x, sc, 1e-6).float(), **tol)
    assert torch.equal(s, x + r)
    assert torch.equal(ys, norm_ops._launch(s, None, sc, 1e-6, plan))


def test_rmsnorm_add_wrong_inputs_raise(gen):
    x, r, sc = randn(gen, 4, 256), randn(gen, 4, 256), randn(gen, 256)
    with pytest.raises(TypeError):
        rmsnorm_add(x.half(), r.half(), sc.half())
    with pytest.raises(ValueError):
        rmsnorm_add(x, r.float(), sc)  # r of another dtype
    with pytest.raises(ValueError):
        rmsnorm_add(x, r[:2], sc)  # r of another shape
    with pytest.raises(ValueError):
        rmsnorm_add(x, r.t().contiguous().t(), sc)  # r not contiguous
    with pytest.raises(ValueError):
        rmsnorm_add(x, r.cpu(), sc)  # r on the CPU
    with pytest.raises(ValueError):
        rmsnorm_add(x, r, sc.float())  # scale of another dtype
    with pytest.raises(ValueError):  # rows of 255: not whole 16-byte vectors
        rmsnorm_add(x[:, :-1].contiguous(), r[:, :-1].contiguous(), sc[:-1].contiguous())


@pytest.mark.parametrize("Sq,Skv,window,cap", [(200, 200, 0, 0.0), (37, 300, 0, 0.0),
                                               (256, 256, 64, 50.0)])
def test_flash_attention(gen, Sq, Skv, window, cap):
    q, k, v = randn(gen, 1, Sq, 24, 128), randn(gen, 1, Skv, 2, 128), randn(gen, 1, Skv, 2, 128)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.parametrize("pos,dtype,tol", [(700, torch.bfloat16, BF16), (0, torch.bfloat16, BF16),
                                           (300, torch.float32, FP32)])
def test_decode_attention(gen, pos, dtype, tol):
    q = randn(gen, 4, 1, 24, 128, dtype=dtype)
    kc, vc = randn(gen, 4, 1024, 2, 128, dtype=dtype), randn(gen, 4, 1024, 2, 128, dtype=dtype)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), decode_attention_reference(q, kc, vc, pos).float(),
                               **tol)


DECODE_BF16 = dict(atol=8e-3, rtol=1e-2)  # p rounds to bf16 where the plain version rounds it


@pytest.mark.parametrize("L", [1, 6, 8, 10])
def test_flash_attention_measure_prompts(gen, L):
    """The measurement path's prompts (6-10 tokens) at StarCoder2's heads: one
    partly filled query tile and one partly filled kv tile."""
    q, k, v = randn(gen, 1, L, 24, 128), randn(gen, 1, L, 2, 128), randn(gen, 1, L, 2, 128)
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               flash_attention_reference(q, k, v).float(), **BF16)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_measure_cache(gen, pos):
    """The measurement path's decode: one slot of 64 positions, pos <= 15."""
    q, kc, vc = randn(gen, 1, 1, 24, 128), randn(gen, 1, 64, 2, 128), randn(gen, 1, 64, 2, 128)
    torch.testing.assert_close(decode_attention(q, kc, vc, pos).float(),
                               decode_attention_reference(q, kc, vc, pos).float(), **DECODE_BF16)


def test_simulated_trace_on_the_card_equals_cpu(gen):  # gen: skips without a card
    hc = HarnessConfig(arch="starcoder2_3b", n_requests=60)
    card, cpu = run_harness(hc, device="cuda"), run_harness(hc, device="cpu")
    assert card.to_dict() == cpu.to_dict()
    assert build_profile(card).dumps() == build_profile(cpu).dumps()


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_trace_on_the_card_equals_cpu(gen, slots):  # gen: skips without a card
    hc = HarnessConfig(arch="starcoder2_3b", slots=slots, n_requests=12)
    card, cpu = Tracer(), Tracer()
    before = flash_attention.launches
    run_harness(hc, device="cuda", tracer=card)
    run_harness(hc, device="cpu", tracer=cpu)
    assert flash_attention.launches > before  # the card run went through the kernels
    assert card.to_jsonl() == cpu.to_jsonl() and len(card) > 3 * 12


def test_cluster_spans_and_audits_on_the_card_match_cpu(gen):
    """Spans: epoch, stamps and counts exact, the mean latency 1e-9 (the
    closed forms in float64; the card's pow/log/exp may round an ulp apart);
    ``audit_cluster``: the targets exact, the terms 1e-9; the tracer adds no
    decision-scan launch."""
    spec = default_cluster(24)
    tr = make_trace(40.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: step_signal(
        t, [(0, 2.5e6), (15, 3.75e5), (30, 2.5e6)]))
    n_req = np.random.default_rng(5).poisson(2.0, (tr.n_epochs, 24)).astype(np.float64)
    kw = dict(policies=("adaptive", "on_device"), stagger=3, hysteresis=0.05, n_req=n_req)
    card_tr, cpu_tr = Tracer(), Tracer()
    before = decision_scan.launches
    got = simulate_cluster(spec, tr, tracer=card_tr, **kw)
    assert decision_scan.launches == before + tr.n_epochs
    want = simulate_cluster(spec, tr, device="cpu", tracer=cpu_tr, **kw)
    assert len(card_tr) == len(cpu_tr) == tr.n_epochs
    for a, b in zip(card_tr.spans, cpu_tr.spans):
        da, db = dict(a.attrs), dict(b.attrs)
        assert (a.t, a.dur, da["epoch"], da["offloaded"], da["on_device"]) == \
            (b.t, b.dur, db["epoch"], db["offloaded"], db["on_device"])
        assert da["mean_latency_s"] == pytest.approx(db["mean_latency_s"], rel=1e-9)
    sub = dict(epochs=range(0, 40, 5), clients=range(0, 24, 3))
    card_log = audit_cluster(got, **sub)
    cpu_log = audit_cluster(want, device="cpu", **sub)
    assert card_log.verify() <= 1e-9 and cpu_log.verify() <= 1e-9
    assert [r.edge_index for r in card_log] == [r.edge_index for r in cpu_log]
    for a, b in zip(card_log, cpu_log, strict=True):
        for strat, terms in a.terms.items():
            for k, v in terms.items():
                assert v == pytest.approx(b.terms[strat][k], rel=1e-9, abs=0), (strat, k)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("Sq", [130, 700])  # a ragged second tile; many tiles past the window
def test_flash_attention_every_head_dim(gen, hd, Sq):
    q, k, v = randn(gen, 2, Sq, 8, hd), randn(gen, 2, Sq, 2, hd), randn(gen, 2, Sq, 2, hd)
    out = flash_attention(q, k, v, window=200, softcap=30.0)
    torch.testing.assert_close(
        out.float(), flash_attention_reference(q, k, v, window=200, softcap=30.0).float(), **BF16)


def test_flash_attention_jamba_prompt(gen):  # 32 query heads on 8 kv heads (G = 4)
    q, k, v = randn(gen, 1, 256, 32, 128), randn(gen, 1, 256, 8, 128), randn(gen, 1, 256, 8, 128)
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               flash_attention_reference(q, k, v).float(), **BF16)


@pytest.mark.parametrize("B,S,H,K,hd,pos", [
    (4, 512, 32, 8, 128, 300),  # jamba: 4 slots of 512, G = 4
    (1, 300, 32, 2, 256, 299),  # G = 16 at the widest head
    (1, 700, 64, 2, 64, 650),  # G = 32: two 16-row tiles
])
def test_decode_attention_shapes(gen, B, S, H, K, hd, pos):
    q, kc, vc = randn(gen, B, 1, H, hd), randn(gen, B, S, K, hd), randn(gen, B, S, K, hd)
    torch.testing.assert_close(decode_attention(q, kc, vc, pos).float(),
                               decode_attention_reference(q, kc, vc, pos).float(), **DECODE_BF16)


def test_decode_attention_graph_replay_equals_eager(gen):
    """The split pass and its merge, captured and replayed, equal the eager call."""
    q, kc, vc = randn(gen, 4, 1, 24, 128), randn(gen, 4, 1024, 2, 128), randn(gen, 4, 1024, 2, 128)
    eager = decode_attention(q, kc, vc, 1023)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, kc, vc, 1023)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_wrong_layouts_raise(gen):
    q = randn(gen, 1, 64, 4, 64)
    k = randn(gen, 1, 64, 2, 64)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., ::2], k[..., ::2], k[..., ::2])  # head dim not unit-stride
    with pytest.raises(ValueError):
        rmsnorm(q, torch.zeros(64, device="cuda", dtype=torch.float32))  # scale dtype


def lindley_inputs(gen, B, T, dtype=torch.float64, kind="exp"):
    inter = torch.empty(B, T, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    if kind == "ties":
        inter[:, ::3] = 0.0
    svc = torch.empty(B, T, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    if kind == "zero":
        svc.zero_()
    return torch.cumsum(inter, dim=1).to(dtype), svc.to(dtype)


@pytest.mark.parametrize("B,T,kind", [(1, 1000, "exp"), (45, 1000, "exp"), (33, 130, "exp"),
                                      (64, 256, "zero"), (40, 500, "ties")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lindley_scan(gen, B, T, kind, dtype):
    arr, svc = lindley_inputs(gen, B, T, dtype, kind)
    before = lindley_scan.launches
    out = lindley_scan(arr, svc)
    torch.cuda.synchronize()
    assert lindley_scan.launches == before + 1
    assert torch.equal(out, lindley_scan_reference(arr, svc))


def test_lindley_kserver_mixed_k(gen):
    arr, svc = lindley_inputs(gen, 70, 700)
    svc *= 4.0
    k = torch.randint(1, 9, (70,), generator=gen, device="cuda", dtype=torch.int32)
    before = lindley_kserver.launches
    out = lindley_kserver(arr, svc, k, 8)
    torch.cuda.synchronize()
    assert lindley_kserver.launches == before + 1
    assert torch.equal(out, lindley_kserver_reference(arr, svc, k, 8))


@pytest.mark.parametrize("T", [1, LINDLEY_TILE - 1, LINDLEY_TILE, LINDLEY_TILE + 1,
                               LINDLEY_STAGES * LINDLEY_TILE + 1,
                               2 * LINDLEY_STAGES * LINDLEY_TILE + 3])
@pytest.mark.parametrize("B", [1, 31, 33])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lindley_scan_ring_edges(gen, B, T, dtype):
    """The ring's edges: a ragged last tile, fewer tiles than stages, a ring
    that wraps, odd T (rows that start off 16 bytes), a ragged last CTA."""
    arr, svc = lindley_inputs(gen, B, T, dtype)
    assert torch.equal(lindley_scan(arr, svc), lindley_scan_reference(arr, svc))


@pytest.mark.parametrize("k_max", [1, 4, 9, 64])  # registers for k_max <= 8, local memory above
@pytest.mark.parametrize("B,T", [(33, LINDLEY_TILE + 1), (70, LINDLEY_STAGES * LINDLEY_TILE + 1)])
def test_lindley_kserver_every_instantiation(gen, k_max, B, T):
    arr, svc = lindley_inputs(gen, B, T)
    svc *= k_max  # keep the servers busy
    k = torch.randint(1, k_max + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    k[0] = k_max  # every row count from 1 to k_max, mixed
    before = lindley_kserver.launches
    out = lindley_kserver(arr, svc, k, k_max)
    torch.cuda.synchronize()
    assert lindley_kserver.launches == before + 1
    assert torch.equal(out, lindley_kserver_reference(arr, svc, k, k_max))


def test_lindley_scan_graph_replay_equals_eager(gen):
    arr, svc = lindley_inputs(gen, 45, 3 * LINDLEY_STAGES * LINDLEY_TILE + 7)
    eager = lindley_scan(arr, svc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lindley_scan(arr, svc)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_lindley_wrong_inputs_raise(gen):
    arr, svc = lindley_inputs(gen, 8, 64)
    with pytest.raises(TypeError):
        lindley_scan(arr.to(torch.bfloat16), svc.to(torch.bfloat16))
    with pytest.raises(TypeError):
        lindley_scan(arr, svc.float())
    with pytest.raises(ValueError):
        lindley_scan(arr[:, ::2], svc[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        lindley_scan(arr, svc[:4])
    with pytest.raises(ValueError):
        lindley_kserver(arr, svc, torch.ones(8, dtype=torch.int64, device="cuda"), 2)
    with pytest.raises(ValueError):
        lindley_kserver(arr, svc, torch.ones(8, dtype=torch.int32, device="cuda"), 1000)
    with pytest.raises(ValueError):
        lindley_kserver(arr, svc, torch.full((8,), 3, dtype=torch.int32, device="cuda"), 2)
    with pytest.raises(ValueError):
        lindley_kserver(arr, svc, torch.zeros(8, dtype=torch.int32, device="cuda"), 2)


def _sweep(n_lam=4, n_bw=4, k_edge=1.0):
    base = default_scenario()
    return ScenarioBatch.from_sweep(base, {
        "workload.arrival_rate": np.linspace(0.5, 4.5, n_lam),
        "network.bandwidth_Bps": np.geomspace(1.5e6, 20e6, n_bw) / 8,
        "edges[0].tier.parallelism_k": [k_edge]})


@pytest.mark.parametrize("strategy,k_edge,k1,kk", [("on_device", 1.0, 1, 0),
                                                   ("edge[0]", 1.0, 3, 0),
                                                   ("edge[0]", 3.0, 2, 1)])
def test_simulate_fleet_launches_and_matches_cpu(gen, strategy, k_edge, k1, kk):
    batch = _sweep(k_edge=k_edge)
    n = 3000
    rng = np.random.default_rng(0)
    names = ("inter", "service_exp") if strategy == "on_device" else (
        "inter", "nic_req", "service_exp", "nic_res")
    draws = {name: rng.exponential(1.0, (batch.size, n)) for name in names}
    before = (lindley_scan.launches, lindley_kserver.launches)
    got = simulate_fleet(batch, strategy, n=n, draws=draws)
    assert (lindley_scan.launches - before[0], lindley_kserver.launches - before[1]) == (k1, kk)
    want = simulate_fleet(batch, strategy, n=n, draws=draws, device="cpu")
    np.testing.assert_allclose(got.latencies + got.arrivals, want.latencies + want.arrivals,
                               rtol=1e-12, atol=0)


def test_fleet_closed_forms_match_cpu(gen):  # gen: skips without a card
    batch = _sweep(16, 16)
    got, want = fleet_analytic(batch), fleet_analytic(batch, device="cpu")
    np.testing.assert_allclose(got.t_dev, want.t_dev, rtol=1e-9)
    np.testing.assert_allclose(got.t_edge, want.t_edge, rtol=1e-9)
    np.testing.assert_array_equal(got.best_edge, want.best_edge)
    cx, cx_cpu = fleet_crossover(batch, "bandwidth"), fleet_crossover(batch, "bandwidth",
                                                                      device="cpu")
    np.testing.assert_array_equal(cx.found, cx_cpu.found)
    np.testing.assert_allclose(cx.value[cx.found], cx_cpu.value[cx.found], rtol=1e-9)


def decision_costs(gen, T, N, E1, dtype=torch.float64, specials=True):
    """Exponential costs; with ``specials``, all-+inf rows, a +inf column, a
    NaN and an exact tie."""
    c = torch.empty(T, N, E1, dtype=torch.float64, device="cuda").exponential_(generator=gen)
    c = (0.05 * c).to(dtype)
    if specials:
        c[2, : N // 2] = float("inf")
        c[3, :, E1 - 1] = float("inf")
        c[4, 2 % N, E1 // 2] = float("nan")
        c[5, 1 % N, :] = 0.07
    return c


@pytest.mark.parametrize("T,N,E1", [(120, 64, 5), (37, 13, 4), (600, 2048, 129)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stagger,h", [(1, 0.0), (3, 0.15), (4, 0.3)])
def test_decision_scan(gen, T, N, E1, dtype, stagger, h):
    costs = decision_costs(gen, T, N, E1, dtype)
    cohort = (torch.arange(N, device="cuda") % stagger).to(torch.int32)
    before = decision_scan.launches
    out = decision_scan(costs, cohort, hysteresis=h, stagger=stagger)
    torch.cuda.synchronize()
    assert decision_scan.launches == before + 1
    assert torch.equal(out, decision_scan_reference(costs, cohort, hysteresis=h, stagger=stagger))


@pytest.mark.parametrize("T", [1, 2, STAGES - 1, STAGES, STAGES + 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_decision_scan_ring_edges_in_t(gen, T, dtype):
    """Fewer epochs than the ring holds, exactly as many, one more; N * (E+1)
    odd, so that every epoch's span starts at another offset mod 16."""
    N, E1 = 77, 33
    costs = decision_costs(gen, T, N, E1, dtype, specials=False)
    costs[:, ::4] = costs[:, ::4, :1]  # ties with on-device
    cohort = (torch.arange(N, device="cuda") % 3).to(torch.int32)
    kw = dict(hysteresis=0.15, stagger=3)
    assert torch.equal(decision_scan(costs, cohort, **kw),
                       decision_scan_reference(costs, cohort, **kw))


@pytest.mark.parametrize("E1", [1, 5, 33, 129, 300])
@pytest.mark.parametrize("N", [2047, 13])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_decision_scan_ring_edges_in_n_and_e(gen, E1, N, dtype):
    """Every E+1 up to one above 256, odd N, and N not a multiple of the
    plan's clients per CTA (a ragged last CTA)."""
    costs = decision_costs(gen, 9, N, E1, dtype)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = scan_plan(9, N, E1, costs.element_size(), n_sm)
    assert N % plan.clients or plan.clients == 1
    cohort = (torch.arange(N, device="cuda") % 4).to(torch.int32)
    for h in (0.0, 0.3):
        kw = dict(hysteresis=h, stagger=4)
        assert torch.equal(decision_scan(costs, cohort, **kw),
                           decision_scan_reference(costs, cohort, **kw))


def test_decision_scan_graph_replay_equals_eager(gen):
    costs = decision_costs(gen, 3 * STAGES + 1, 2047, 129)
    cohort = (torch.arange(2047, device="cuda") % 3).to(torch.int32)
    kw = dict(hysteresis=0.15, stagger=3)
    eager = decision_scan(costs, cohort, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decision_scan(costs, cohort, **kw)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("t0", [0, 1, 5, 7])
def test_decision_scan_one_epoch_entry(gen, t0):
    """The closed loop's per-epoch launch: T = 1 with the carry and global epoch."""
    costs = decision_costs(gen, 1, 2048, 129, specials=False)
    costs[0, ::7] = costs[0, ::7, :1]  # exact ties with on-device
    cohort = (torch.arange(2048, device="cuda") % 3).to(torch.int32)
    prev = torch.randint(-1, 128, (2048,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(hysteresis=0.15, stagger=3, prev=prev, t0=t0)
    assert torch.equal(decision_scan(costs, cohort, **kw),
                       decision_scan_reference(costs, cohort, **kw))


def test_decision_scan_wrong_inputs_raise(gen):
    costs = decision_costs(gen, 8, 16, 5, specials=False)
    cohort = torch.zeros(16, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        decision_scan(costs.to(torch.bfloat16), cohort)
    with pytest.raises(ValueError):
        decision_scan(costs[0], cohort)  # not (T, N, E+1)
    with pytest.raises(ValueError):
        decision_scan(costs[:, :, ::2], cohort)  # not contiguous
    with pytest.raises(ValueError):
        decision_scan(costs, cohort, stagger=0)
    with pytest.raises(ValueError):
        decision_scan(costs, cohort.long())
    with pytest.raises(ValueError):
        decision_scan(costs, cohort, prev=torch.full((16,), 4, dtype=torch.int32, device="cuda"))


def test_simulate_cluster_on_the_card_matches_cpu(gen):
    spec = default_cluster(24)
    tr = make_trace(60.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: step_signal(
        t, [(0, 2.5e6), (20, 3.75e5), (40, 2.5e6)]))
    n_req = np.random.default_rng(3).poisson(2.0, (tr.n_epochs, 24)).astype(np.float64)
    kw = dict(policies=("adaptive", "on_device", "edge[1]"), stagger=3, hysteresis=0.05,
              n_req=n_req)
    before = decision_scan.launches
    got = simulate_cluster(spec, tr, **kw)
    assert decision_scan.launches == before + tr.n_epochs
    want = simulate_cluster(spec, tr, device="cpu", **kw)
    for name in kw["policies"]:
        a, b = got.policies[name], want.policies[name]
        np.testing.assert_array_equal(a.choices, b.choices)
        np.testing.assert_allclose(a.latencies_s, b.latencies_s, rtol=1e-12, atol=0)
        np.testing.assert_allclose(a.edge_loads, b.edge_loads, rtol=1e-12, atol=0)
    # the estimators are exact on both: window sums of integer counts divided
    # by a device tensor (not multiplied by a reciprocal), EWMAs of sums of
    # equal rates
    np.testing.assert_array_equal(got.est_endo_rate, want.est_endo_rate)
    np.testing.assert_array_equal(got.est_arrival_rate, want.est_arrival_rate)


@pytest.mark.parametrize("method,rtol", [("euler", 1e-8), ("asymptote", 1e-6)])
def test_fleet_tail_on_the_card_matches_cpu(gen, method, rtol):
    """Every finite row at ``rtol``, but an Euler row whose quantile the
    CDF's rounding noise fixes only to a band wider than that (ROADMAP C10:
    three edge rows past rho 0.99 on this grid) is held to twice its band,
    as far apart as two converged searches inside it can stop."""
    base, axes = euler_parity.grid()
    batch = ScenarioBatch.from_sweep(base, axes)
    got = fleet_tail(batch, 0.99, method=method)
    want = fleet_tail(batch, 0.99, method=method, device="cpu")
    rho = np.array([[bottleneck_rho(scn, s) for s in ("on_device", "edge[0]")]
                    for scn in base.grid(axes)])
    for column, a, b, r in ((None, got.t_dev, want.t_dev, rho[:, 0]),
                            (0, got.t_edge[:, 0], want.t_edge[:, 0], rho[:, 1])):
        assert np.array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        assert (fin & (r <= EULER_VEC_RHO_MAX)).sum() >= 400
        tol = rtol * np.abs(b[fin])
        if method == "euler":
            st, hints = euler_parity.stations(batch, "cpu", column)
            t = torch.as_tensor(want.t_dev if column is None else want.t_edge)
            band = euler_parity.noise_band(st, t, hints).numpy()
            band = (band if column is None else band[:, column])[fin]
            wide = 2.0 * band > tol
            assert wide.sum() <= 0.01 * fin.sum() and (r[fin][wide] > 0.99).all()
            tol = np.maximum(tol, 2.0 * band)
        gap = np.abs(a[fin] - b[fin])
        assert (gap <= tol).all(), (np.flatnonzero(fin)[gap > tol], gap[gap > tol])
    np.testing.assert_array_equal(got.best_edge, want.best_edge)


def test_slo_closed_loop_on_the_card_matches_cpu(gen):
    spec = default_cluster(24)
    tr = make_trace(40.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: step_signal(
        t, [(0, 2.5e6), (13, 3.75e5), (26, 2.5e6)]))
    n_req = np.random.default_rng(4).poisson(2.0, (tr.n_epochs, 24)).astype(np.float64)
    kw = dict(policies=("adaptive", "on_device", "edge[1]"), stagger=3, n_req=n_req,
              slo_quantile=0.99)
    before = decision_scan.launches
    got = simulate_cluster(spec, tr, **kw)
    assert decision_scan.launches == before + tr.n_epochs
    want = simulate_cluster(spec, tr, device="cpu", **kw)
    for name in kw["policies"]:
        a, b = got.policies[name], want.policies[name]
        np.testing.assert_array_equal(a.choices, b.choices)
        np.testing.assert_allclose(a.latencies_s, b.latencies_s, rtol=1e-6, atol=0)


def test_meanfield_on_the_card_matches_cpu(gen):
    for spec in meanfield_gate_specs() + (default_meanfield(1_000_000),):
        for q in (None, 0.99):
            got = solve_meanfield_equilibrium(spec, slo_quantile=q)
            want = solve_meanfield_equilibrium(spec, slo_quantile=q, device="cpu")
            assert (got.iterations, got.converged) == (want.iterations, want.converged)
            for name in ("fractions", "latency_s", "edge_loads"):
                np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                           rtol=1e-12, atol=1e-15, err_msg=name)


# ---------------------------------------------------------------------------
# selective scan (mamba S6)

# y is rounded once to bf16 by both: one bf16 step (at most 2^-7 of |y|) where
# fp32 sums over N in another order land on either side of a rounding
# boundary, plus that fp32 order difference itself (16 terms of |h C| up to
# ~10 at 2^-24 each, with margin); the fp32 state to 1e-5 (exp and
# multiply-adds, contracted into FMAs on the card)
SCAN_Y_BF16 = dict(atol=1e-4, rtol=2**-7)
SCAN_H = dict(atol=1e-5, rtol=1e-5)


def scan_inputs(gen, B, T, D, N, dtype=torch.bfloat16, h0=False, fused=False):
    dt = (torch.nn.functional.softplus(torch.randn(B, T, D, generator=gen, device="cuda"))
          * 0.1).to(dtype)
    u = randn(gen, B, T, D, dtype=dtype)
    A = -torch.exp(torch.randn(D, N, generator=gen, device="cuda") * 0.5)
    if fused:  # B and C as column slices of the mixer's (B, T, dtr + 2N) x_proj output
        dbc = randn(gen, B, T, 256 + 2 * N, dtype=dtype)
        Bc, Cc = dbc[..., 256:256 + N], dbc[..., 256 + N:]
    else:
        Bc, Cc = randn(gen, B, T, N, dtype=dtype), randn(gen, B, T, N, dtype=dtype)
    h = torch.randn(B, D, N, generator=gen, device="cuda") if h0 else None
    return dt, Bc, Cc, u, A, h


@pytest.mark.parametrize("B,T,D,N,dtype,h0,fused", [
    (1, 241, 8192, 16, torch.bfloat16, False, False),  # full-width prefill, ragged T
    (4, 1, 8192, 16, torch.bfloat16, True, False),  # decode step from the cache's state
    (2, 37, 200, 16, torch.bfloat16, True, False),  # ragged T and D
    (3, 50, 128, 4, torch.float32, True, False),  # the reduced config's N, fp32
    (2, 70, 8192, 16, torch.bfloat16, True, True),  # strided B and C
])
def test_ssm_scan(gen, B, T, D, N, dtype, h0, fused):
    args = scan_inputs(gen, B, T, D, N, dtype, h0, fused)
    before = ssm_scan.launches
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    ry, rh = ssm_scan_reference(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), ry.float(),
                               **(SCAN_Y_BF16 if dtype == torch.bfloat16 else FP32))
    torch.testing.assert_close(h, rh, **SCAN_H)


# the kernel's edge cases: N / G ragged or N < G, D not a multiple of a CTA's
# channels, rows off 16 bytes (plain loads, not cp.async), T of 1, 33, 241
SSM_EDGES = [
    (1, 241, 8192, 16, torch.bfloat16, False, False),  # jamba prefill from zeros
    (4, 1, 8192, 16, torch.bfloat16, True, False),  # jamba decode step
    (2, 33, 200, 16, torch.bfloat16, True, True),  # D ragged in a CTA's channels, strided B/C
    (2, 33, 203, 7, torch.bfloat16, True, False),  # odd D and N: plain loads
    (3, 241, 96, 1, torch.float32, False, False),  # N = 1, below every group
    (2, 1, 128, 4, torch.float32, True, True),  # N = 4, fp32 strided B/C by cp.async
    (1, 33, 8192, 4, torch.bfloat16, True, True),  # N = 4 in bf16: 8-byte rows, plain loads
]


@pytest.mark.parametrize("B,T,D,N,dtype,h0,fused", SSM_EDGES)
@pytest.mark.parametrize("group", scan_ops.GROUPS)
@pytest.mark.parametrize("reduce", scan_ops.REDUCTIONS)
def test_ssm_scan_every_plan(gen, B, T, D, N, dtype, h0, fused, group, reduce):
    args = scan_inputs(gen, B, T, D, N, dtype, h0, fused)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = scan_ops.scan_plan(B, T, D, N, args[3].element_size(), n_sm, group=group,
                              reduce=reduce)
    y, h = scan_ops._launch(*args, plan)
    torch.cuda.synchronize()
    ry, rh = ssm_scan_reference(*args)
    torch.testing.assert_close(y.float(), ry.float(),
                               **(SCAN_Y_BF16 if dtype == torch.bfloat16 else FP32))
    torch.testing.assert_close(h, rh, **SCAN_H)


def test_ssm_scan_wrong_inputs_raise(gen):
    dt, Bc, Cc, u, A, h0 = scan_inputs(gen, 2, 8, 64, 16, h0=True)
    with pytest.raises(TypeError):
        ssm_scan(dt.half(), Bc.half(), Cc.half(), u.half(), A, h0)
    with pytest.raises(TypeError):
        ssm_scan(dt, Bc, Cc, u, A.to(torch.bfloat16), h0)
    with pytest.raises(ValueError):
        ssm_scan(dt, Bc, Cc, u[:, :4], A, h0)  # shapes disagree
    with pytest.raises(ValueError):
        ssm_scan(dt, Bc, Cc, u, A, h0.cpu())  # a CPU h0 with CUDA inputs
    with pytest.raises(ValueError):
        ssm_scan(dt[:, ::2], Bc[:, ::2], Cc[:, ::2], u[:, ::2], A, h0)  # not contiguous
    with pytest.raises(ValueError):
        ssm_scan(dt, Bc[..., ::2], Cc[..., ::2], u, A[:, :8], h0[..., :8].contiguous())
    with pytest.raises(ValueError):  # more states than the kernel keeps in registers
        ssm_scan(dt, *(torch.cat([x, x], -1) for x in (Bc, Cc)), u, torch.cat([A, A], -1))


def test_mamba_layer_on_the_card_matches_its_plain_path(gen):
    """Reduced jamba's mixer in bf16 on the card, kernel vs plain scan: prefill
    then a decode step from the prefill's cache."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models.params import ParamTree

    cfg = dataclasses.replace(get_config("jamba_v0_1_52b").reduced(), dtype="bfloat16",
                              mamba_d_state=16)
    p = ParamTree(SSM.mamba_template(cfg), path="m", seed=0, dtype=torch.bfloat16,
                  device=torch.device("cuda"))
    x, xt = randn(gen, 2, 29, cfg.d_model), randn(gen, 2, 1, cfg.d_model)
    y, cache = SSM.mamba_forward(p, x, cfg, return_cache=True)
    y1, cache1 = SSM.mamba_decode(p, xt, cache, cfg)
    saved = SSM.ssm_scan
    SSM.ssm_scan = ssm_scan_reference
    try:
        ry, rcache = SSM.mamba_forward(p, x, cfg, return_cache=True)
        ry1, rcache1 = SSM.mamba_decode(p, xt, rcache, cfg)
    finally:
        SSM.ssm_scan = saved
    torch.testing.assert_close(y.float(), ry.float(), **BF16)
    torch.testing.assert_close(y1.float(), ry1.float(), **BF16)
    torch.testing.assert_close(cache1["h"], rcache1["h"], **SCAN_H)


# ---------------------------------------------------------------------------
# gemma2: head dim 256, 16 query heads on 8 kv heads, window 4096, soft-cap 50


# q is drawn at 40x: the scaled scores (std 40 at hd 256) pass the cap of 50
# in a fifth of their entries and each output row, carried by a few keys,
# stays of order 1 (with q ~ N(0, 1) the cap does nothing and most rows
# average ~1,500 keys to |out| ~ 0.03, the size of the bf16 atol); the outputs
# are also held by rel-L2 over blocks of 64 query rows of one head (each row
# in decode), and the kernel with no cap must fail that check
CAP_Q_SCALE, CAP_REL_L2 = 40.0, 1e-2  # kernels 3.1e-3 to 3.6e-3, faults 3.6e-2 and up


def capped_within(got, want, tol, rows):
    """Elementwise within ``tol`` and within CAP_REL_L2 over blocks of
    ``rows`` rows (dim 1) of one batch entry and head."""
    g, w = got.float(), want.float()
    B, S, H, D = w.shape
    pad = -S % rows

    def blocks(t):
        return torch.nn.functional.pad(t.square(), (0, 0, 0, 0, 0, pad)).view(
            B, -1, rows, H, D).sum((2, 4))

    rel = float((blocks(g - w) / blocks(w)).sqrt().max())
    return bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all()) and rel <= CAP_REL_L2


@pytest.mark.parametrize("Sq,window", [(4864, 4096), (4864, 0), (4353, 4096)])
def test_flash_attention_gemma2_prefill(gen, Sq, window):
    """The serve_local cell's longest prompt in a local layer (the soft-cap,
    then the window's edge) and in a global one, and a ragged prompt; the
    kernel with no cap, or with the window one key wider, fails the check."""
    q = randn(gen, 1, Sq, 16, 256, dtype=torch.float32).mul(CAP_Q_SCALE).bfloat16()
    k, v = randn(gen, 1, Sq, 8, 256), randn(gen, 1, Sq, 8, 256)
    ref = flash_attention_reference(q, k, v, window=window, softcap=50.0)
    out = flash_attention(q, k, v, window=window, softcap=50.0)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)
    assert capped_within(out, ref, BF16, 64)
    assert not capped_within(flash_attention(q, k, v, window=window), ref, BF16, 64)
    if window:
        wider = flash_attention(q, k, v, window=window + 1, softcap=50.0)
        assert not capped_within(wider, ref, BF16, 64)


@pytest.mark.parametrize("S,pos", [(4096, 4095), (4096, 4096), (4096, 4700), (4928, 4700)])
def test_decode_attention_gemma2(gen, S, pos):
    """4 slots against a local layer's 4096-slot ring before, at and past its
    wrap (min(pos + 1, 4096) slots attended), and a global layer's 4928-slot
    append cache; the kernel with no cap fails the check."""
    q = randn(gen, 4, 1, 16, 256, dtype=torch.float32).mul(CAP_Q_SCALE).bfloat16()
    kc, vc = randn(gen, 4, S, 8, 256), randn(gen, 4, S, 8, 256)
    ref = decode_attention_reference(q, kc, vc, pos, softcap=50.0)
    out = decode_attention(q, kc, vc, pos, softcap=50.0)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_BF16)
    assert capped_within(out, ref, DECODE_BF16, 1)
    assert not capped_within(decode_attention(q, kc, vc, pos), ref, DECODE_BF16, 1)


def test_gemma2_engine_on_the_card_follows_cpu_across_the_wrap(gen):
    """Reduced gemma2 (window 8) in bf16, the same weights on the card and on
    the CPU, both engines on one deterministic timer over prompts of 8-16
    tokens with two slots busy: the ring wraps in prefill and in decode.
    The CPU engine takes the card's logits for its argmax (so both emit the
    card's tokens: a bf16 near-tie may go either way) and holds its own
    logits at every prefill and decode step to the card's within BF16; where
    its own top two logits stand further apart than that, its own token is
    the card's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.workload import PoissonWorkload, WorkloadConfig

    cfg = dataclasses.replace(get_config("gemma2_9b").reduced(seq_chunk=8), dtype="bfloat16")
    card_model, cpu_model = LM(cfg, device="cuda"), LM(cfg, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())

    def timer(phase, run, *, tokens, occupancy):
        return run(), (2e-3 if phase == "prefill" else 1e-3) + 1e-4 * tokens

    card_logits, checked = [], {"steps": 0, "clear": 0}

    def recording(fn):
        def run(*args):
            logits, caches = fn(*args)
            card_logits.append(logits.float().cpu())
            return logits, caches
        return run

    def following(fn):
        def run(*args):
            logits, caches = fn(*args)
            want = card_logits[checked["steps"]]
            got = logits.float()
            torch.testing.assert_close(got, want, **BF16)
            top2 = got.topk(2, dim=-1).values
            tol = BF16["atol"] + BF16["rtol"] * top2[..., 0].abs()
            clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
            assert bool(((got.argmax(-1) == want.argmax(-1)) | ~clear).all())
            checked["steps"] += 1
            checked["clear"] += int(clear.sum())
            return want.to(logits.dtype), caches
        return run

    card_model.prefill = recording(card_model.prefill)
    card_model.decode_step = recording(card_model.decode_step)
    cpu_model.prefill = following(cpu_model.prefill)
    cpu_model.decode_step = following(cpu_model.decode_step)
    wl = WorkloadConfig(arrival_rate=400.0, prompt_len=12, prompt_len_jitter=4, max_new_tokens=8,
                        new_tokens_geometric_p=0.3, seed=3, vocab=cfg.vocab_size)
    before = decode_attention.launches
    engines = {}
    for device, model in (("cuda", card_model), ("cpu", cpu_model)):
        engines[device] = Engine(cfg, model, ServeConfig(slots=2, max_seq=32), timer=timer,
                                 device=device)
        serve.replay(engines[device], PoissonWorkload(wl).take(7))
    card, cpu = engines["cuda"], engines["cpu"]
    assert decode_attention.launches > before  # the card engine went through the kernel
    assert checked["steps"] == len(card_logits) and checked["clear"] > 0
    assert sorted((r.rid, r.tokens_out) for r in card.completed) == sorted(
        (r.rid, r.tokens_out) for r in cpu.completed)
    assert max(e.occupancy for e in card.service_log if e.phase == "decode") == 2
    assert max(len(r.prompt) + len(r.tokens_out) for r in card.completed) > 2 * cfg.window_size


# seamless (encoder-decoder): 16 query heads on 16 kv heads, head dim 64
@pytest.mark.parametrize("B,Sq,Skv,causal", [
    (4, 1500, 1500, False),  # the encoder over four 30 s utterances
    (1, 613, 613, False),  # a ragged utterance: a partly filled tile
    (4, 2, 1500, False),  # cross-attention at prefill: a 2-token prompt on 1500 frames
    (1, 37, 613, False),
    (2, 300, 100, False),  # more queries than keys: every key visible to every query
    (4, 2, 2, True),  # the decoder's self-attention over the 2-token prompts
    (1, 2, 2, True),
])
def test_flash_attention_seamless(gen, B, Sq, Skv, causal):
    q, k, v = randn(gen, B, Sq, 16, 64), randn(gen, B, Skv, 16, 64), randn(gen, B, Skv, 16, 64)
    torch.testing.assert_close(flash_attention(q, k, v, causal=causal).float(),
                               flash_attention_reference(q, k, v, causal=causal).float(), **BF16)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 64), (True, 64)])
def test_flash_attention_masked_refuses_more_queries_than_keys(gen, causal, window):
    q, k = randn(gen, 2, 300, 16, 64), randn(gen, 2, 100, 16, 64)
    with pytest.raises(ValueError, match="causal or windowed"):
        flash_attention(q, k, k, causal=causal, window=window)


@pytest.mark.parametrize("B,S,pos", [
    (4, 1500, 1499), (4, 1500, 612),  # cross decode over 1500 frames; a partial run
    (1, 613, 612),  # cross decode over the ragged utterance
    # self decode: 4 slots of 66 (2 prompt + 64 steps) at the first, a middle
    # and the last step; the ragged call's one slot of 6
    (4, 66, 2), (4, 66, 34), (4, 66, 65), (1, 6, 5),
])
def test_decode_attention_seamless(gen, B, S, pos):
    q, kc, vc = randn(gen, B, 1, 16, 64), randn(gen, B, S, 16, 64), randn(gen, B, S, 16, 64)
    torch.testing.assert_close(decode_attention(q, kc, vc, pos).float(),
                               decode_attention_reference(q, kc, vc, pos).float(), **DECODE_BF16)


def test_seamless_on_the_card_follows_cpu(gen):
    """Reduced seamless in bf16 on the card, through the kernels (the counts
    say so), against the same weights on the CPU: encode + prefill over 37
    frames and 3 tokens, then 3 decode steps on fixed tokens. Two bf16 paths
    round at different points, so each is held by its error against the
    CPU's float32 run: at every step the card's rel-L2 at most twice the CPU
    bf16 run's (the factor of FlashAttention's own tests)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = get_config("seamless_m4t_large_v2").reduced(seq_chunk=8)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    card, cpu16, cpu32 = LM(cfg16, device="cuda"), LM(cfg16, device="cpu"), LM(cfg, device="cpu")
    cpu16.load_state_dict(card.state_dict())
    cpu32.load_state_dict(card.state_dict())  # bf16 to float32 is exact
    enc = randn(gen, 2, 37, cfg.d_model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 3), generator=gen, device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (3, 2, 1), generator=gen, device="cuda")

    def run(model, device):
        logits, part = model.prefill(tokens.to(device), enc_embeds=enc.to(device))
        full = model.init_caches(2, 8, enc_len=37)
        for dst, src in zip(full, part):
            for name in dst:
                dst[name][:, :, :src[name].shape[2]].copy_(src[name])
        out = [logits] + [model.decode_step(t.to(device), 3 + i, full)[0]
                          for i, t in enumerate(steps)]
        return [o.float().cpu() for o in out]

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    before = (flash_attention.launches, decode_attention.launches)
    got = run(card, "cuda")
    L, Le = cfg.num_layers, cfg.encoder_layers
    assert (flash_attention.launches - before[0], decode_attention.launches - before[1]) == (
        Le + 2 * L, 3 * 2 * L)
    plain, ref = run(cpu16, "cpu"), run(cpu32, "cpu")
    for g, p, r in zip(got, plain, ref):
        assert torch.isfinite(g).all() and g.shape == (2, 1, cfg.padded_vocab)
        assert rel_l2(g, r) <= 2 * rel_l2(p, r), (rel_l2(g, r), rel_l2(p, r))


# the latency predictor: the reference test's run (512 seeded points, 448 to
# train, 2,500 Adam steps at 3e-3) on the card and on the CPU from the same
# initial weights; held-out predictions to chip_smoke.py's PRED_CARD_CPU_RTOL
PRED_CARD_CPU_RTOL = 2e-4  # 2.4e-5 measured


def predictor_law(seed=0, n=512):
    """The reference test's synthetic law with the H100's data-sheet peaks."""
    rng = np.random.default_rng(seed)
    flops = 10 ** rng.uniform(9, 13, n)
    pbytes = 10 ** rng.uniform(6, 10, n)
    abytes = 10 ** rng.uniform(6, 9, n)
    batch = rng.integers(1, 64, n)
    seq = rng.integers(64, 4096, n)
    lat = np.maximum(flops / 989e12, pbytes / 3.35e12) * (1 + 0.05 * rng.normal(size=n))
    lat = np.abs(lat) + 1e-6
    X = np.stack([workload_features(f, p, a, b, s)
                  for f, p, a, b, s in zip(flops, pbytes, abytes, batch, seq)])
    return X, lat


def test_predictor_fit_on_the_card_matches_cpu(gen):  # gen: skips without a card
    X, lat = predictor_law()
    card = LatencyPredictor(seed=0)  # device=None: the card
    cpu = LatencyPredictor(seed=0, device="cpu")
    assert card.device.type == "cuda" and all(p.is_cuda for p in card.parameters())
    for a, b in zip(card.state_dict().values(), cpu.state_dict().values()):
        assert torch.equal(a.cpu(), b)
    card.fit(X[:448], lat[:448], steps=2500, lr=3e-3)
    cpu.fit(X[:448], lat[:448], steps=2500, lr=3e-3)
    a, b = card.predict(X[448:]), cpu.predict(X[448:])
    np.testing.assert_allclose(a, b, rtol=PRED_CARD_CPU_RTOL, atol=0)
    assert card.mape(X[448:], lat[448:]) < 25.0
    # one row: the single-row product takes another cuBLAS kernel than the
    # 64-row one, so its float32 sums run in another order (1.1e-6 measured)
    one = card.predict(X[448])
    assert type(one) is np.float32 and one == pytest.approx(float(a[0]), rel=1e-5)


# the kernels bench family at the reference's shapes (bench/kernel_bench.py),
# each error within chip_smoke.py's KERNEL_BENCH_TOL: flash in bf16 against
# the fp32 plain version (6.75e-3 measured), decode / RMSNorm / the selective
# scan in fp32 (1.94e-7, 9.54e-7, 1.43e-6), the Lindley and decision scans
# exact (the family's ERR_FLOOR)
KERNEL_BENCH_TOL = {"flash_attention": 2e-2, "decode_attention": 1e-5, "ssm_scan": 1e-5,
                    "rmsnorm": 1e-5, "lindley_scan": 1e-9, "decision_scan": 1e-9}


def test_kernel_bench_rows_land_on_the_card(gen):  # gen: skips without a card
    from repro_torch.bench.kernel_bench import kernel_rows

    ops = {"flash_attention": flash_attention, "decode_attention": decode_attention,
           "ssm_scan": ssm_scan, "rmsnorm": rmsnorm, "lindley_scan": lindley_scan,
           "decision_scan": decision_scan}
    before = {name: op.launches for name, op in ops.items()}
    report = kernel_rows(None)  # device=None: the card
    assert list(report) == list(KERNEL_BENCH_TOL)
    for name, tol in KERNEL_BENCH_TOL.items():
        assert report[name]["max_abs_err"] <= tol, (name, report[name])
        assert ops[name].launches > before[name], name


def test_run_experiment_on_the_card_resumes(gen, tmp_path):  # gen: skips without a card
    from repro_torch.exp import registry, run_experiment

    spec = registry()["bench-kernels"]
    first = run_experiment(spec, results_root=tmp_path)  # device=None: the card
    again = run_experiment(spec, results_root=tmp_path)
    assert first.passed and not first.skipped
    assert again.skipped and again.passed and again.run_dir == first.run_dir
    manifest = (first.run_dir / "manifest.json").read_text()
    assert torch.cuda.get_device_name(0) in manifest


def test_simulate_fleet_one_row_repeats_bit_for_bit(gen):  # gen: skips without a card
    """A lone row's arrival clock stays on the row-wise scan (torch scans a
    one-row tensor with CUB's device-wide scan, whose float sums can move by
    an ulp between runs): the validate gate's one-row groups repeat exactly."""
    batch = ScenarioBatch.from_scenarios([default_scenario()])
    first = simulate_fleet(batch, "on_device", n=40_000, seed=3)
    for _ in range(4):
        again = simulate_fleet(batch, "on_device", n=40_000, seed=3)
        np.testing.assert_array_equal(again.latencies, first.latencies)
        np.testing.assert_array_equal(again.arrivals, first.arrivals)


# ---------------------------------------------------------------------------
# training: the kernels under autograd (bf16 forward kernels, fp32 torch
# backwards) against autograd through the plain versions in float32 on the
# same bf16-valued inputs. Each gradient is held by its rel-L2, 1e-2: the
# kernel's bf16 output (which the flash backward's D = rowsum(dO * O) reads)
# and the gradients' storage in bf16 each round at 2^-8.

GRAD_REL_L2 = 1e-2


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,softcap", [
    (1, 1024, 1024, 14, 2, 64, True, 0, 0.0),  # internvl2's training shape, cut in S
    (1, 600, 600, 8, 4, 256, True, 256, 50.0),  # gemma2's local layer
    (2, 37, 300, 16, 16, 64, False, 0, 0.0),  # seamless's cross-attention
    (1, 100, 333, 4, 2, 128, True, 0, 0.0),  # the queries the tail of the keys
])
def test_flash_attention_gradients_on_the_card(gen, B, Sq, Skv, H, K, hd, causal, window,
                                               softcap):
    q = randn(gen, B, Sq, H, hd).requires_grad_()
    k, v = (randn(gen, B, Skv, K, hd).requires_grad_() for _ in range(2))
    do = randn(gen, B, Sq, H, hd)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap, chunk=256)
    assert flash_attention.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_reference(*leaves, causal=causal, window=window, softcap=softcap)
    want = torch.autograd.grad(ref, leaves, do.float())
    torch.testing.assert_close(out.float(), ref.detach(), **BF16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _rel_l2(g, w) <= GRAD_REL_L2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_gradients_on_the_card(gen, dtype):
    x = (randn(gen, 2, 512, 896, dtype=dtype) * 3).requires_grad_()
    r = randn(gen, 2, 512, 896, dtype=dtype).requires_grad_()
    sc = (randn(gen, 896, dtype=dtype) * 0.3).requires_grad_()
    gs, gy = randn(gen, 2, 512, 896, dtype=dtype), randn(gen, 2, 512, 896, dtype=dtype)
    before = (rmsnorm.launches, rmsnorm_add.launches)
    y = rmsnorm(x, sc, 1e-6)
    s, y2 = rmsnorm_add(x, r, sc, 1e-6)
    assert (rmsnorm.launches, rmsnorm_add.launches) == (before[0] + 1, before[1] + 1)
    assert y.grad_fn is not None and y2.grad_fn is not None
    got = torch.autograd.grad((y, s, y2), (x, r, sc), (gy, gs, gy))
    leaves = [t.detach().float().requires_grad_() for t in (x, r, sc)]
    ref_s, ref_y2 = rmsnorm_add_reference(*leaves, 1e-6)
    outs = (rmsnorm_reference(leaves[0], leaves[2], 1e-6), ref_s, ref_y2)
    want = torch.autograd.grad(outs, leaves, (gy.float(), gs.float(), gy.float()))
    for g, w in zip(got, want):
        assert g.dtype == dtype and _rel_l2(g, w) <= GRAD_REL_L2


def test_the_loss_gradient_reaches_layer_0_through_the_kernels(gen):
    """No silent detachment: the reduced internvl2 in bf16 with remat "full"
    on the card, one loss and backward: every kernel launched as the train
    phase counts them, and the gradients of layer 0's wq and the embedding
    nonzero and within 5e-2 rel-L2 of the same weights' float32 gradients on
    the CPU (bf16 against float32 over two layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import LM, loss_fn

    cfg = dataclasses.replace(get_config("internvl2_1b").reduced(), dtype="bfloat16",
                              remat="full")
    model = LM(cfg, seed=0).requires_grad_(True)
    batch = make_batch(cfg, 2, 64)
    ops = (rmsnorm, rmsnorm_add, flash_attention)
    before = [op.launches for op in ops]
    loss, _ = loss_fn(model, batch)
    loss.backward()
    L = cfg.num_layers
    assert [op.launches - b for op, b in zip(ops, before)] == [2, 4 * L - 1, 2 * L]
    cpu = LM(dataclasses.replace(cfg, dtype="float32"), device="cpu").requires_grad_(True)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    cpu_loss, _ = loss_fn(cpu, {k: v.cpu() for k, v in batch.items()})
    cpu_loss.backward()
    for name in ("layers.0.attn.wq", "embed.embedding"):
        g = dict(model.named_parameters())[name].grad
        want = dict(cpu.named_parameters())[name].grad
        assert float(g.float().norm()) > 0 and _rel_l2(g.cpu(), want) <= 5e-2, name


def test_ssm_scan_and_decode_attention_refuse_grad(gen):
    """Neither kernel has a backward: on the card an input that requires
    grad under grad mode raises instead of returning a detached output;
    without grad mode they launch as before."""
    dt, Bc, Cc, u, A, h = scan_inputs(gen, 1, 8, 64, 16)
    u.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP B-perf"):
        ssm_scan(dt, Bc, Cc, u, A, h)
    with torch.no_grad():
        ssm_scan(dt, Bc, Cc, u, A, h)
    q = randn(gen, 2, 1, 8, 64).requires_grad_()
    kc, vc = randn(gen, 2, 32, 2, 64), randn(gen, 2, 32, 2, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP B-perf"):
        decode_attention(q, kc, vc, 20)
    with torch.inference_mode():
        decode_attention(q.detach(), kc, vc, 20)
