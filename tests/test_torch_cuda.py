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
bf16 y to one bf16 step plus the fp32 sum order, its fp32 state to 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.fleet import (
    ScenarioBatch,
    fleet_analytic,
    fleet_crossover,
    make_trace,
    simulate_cluster,
    simulate_fleet,
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
from repro_torch.launch.cluster_sim import default_cluster
from repro_torch.launch.fleet_sweep import default_scenario

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
               (2, 7168)]


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
