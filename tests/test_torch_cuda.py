"""The port's hand-written kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper card and nvcc, and skip
elsewhere. On a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(``python3 chip_smoke.py`` runs the same comparisons at more shapes, times
the kernels, serves the full-width model and runs the fleet path.)
Tolerances: bfloat16 2e-2 (outputs round to bf16 at different points),
float32 1e-5; the Lindley scans exact (one max and one add per job, no
reassociation); the fleet path on the card against the CPU 1e-12 relative on
departure clocks (the card's cumsum associates differently) and 1e-9 on the
closed forms (the card's pow/log/exp may round an ulp apart).
"""

import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
import numpy as np

from repro_torch.fleet import ScenarioBatch, fleet_analytic, fleet_crossover, simulate_fleet
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
from repro_torch.kernels.lindley_scan.ops import lindley_kserver, lindley_scan
from repro_torch.kernels.lindley_scan.ref import (
    lindley_kserver_reference,
    lindley_scan_reference,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
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
