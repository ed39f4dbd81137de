"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's kernels: ``impl="xla"`` (the reference oracle) everywhere and
``impl="interpret"`` (the Pallas kernel run on the CPU) for a few cases.

Inputs are drawn from a seed with numpy and handed to both packages.
Tolerances: float32 1e-5 (same arithmetic, other summation order), bfloat16
2e-2 (outputs round to bf16 at different points; tests/test_kernels.py uses
the same bf16 budget for the Pallas kernels). The selective scan's fp32
state is held to 1e-5 as well (exp, multiply-adds and a sum over N in fp32;
the two packages sum over N in their own order). The fused add + RMSNorm's
sum is held exactly to JAX's bf16 / fp32 add (both round the exact sum once
to the input's dtype) and its norm to the RMSNorm budgets above.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models.layers import rms_norm as jax_rms_norm
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_reference as jax_ssm_scan_reference
from repro_torch.kernels.decision_scan.ops import LANE_COLUMNS, MAX_THREADS, SMEM_LIMIT, scan_plan
from repro_torch.kernels.decision_scan.ops import STAGES as DS_STAGES
from repro_torch.kernels.decision_scan.ops import STEPS as DS_STEPS
from repro_torch.kernels.decode_attention.ops import (
    MIN_SPLIT,
    decode_attention,
    scratch_floats,
    split_plan,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ops import ssm_scan

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)


def pair(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class TestRmsNorm:
    @pytest.mark.parametrize("shape", [(1, 1, 64), (3, 17, 128), (2, 97, 256), (5, 3072)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, shape, dtype):
        rng = np.random.default_rng(sum(shape))
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        # non-zero scales: the templates zero-init them, which would hide the (1+scale) term
        sc = (rng.standard_normal(shape[-1]) * 0.2).astype(np.float32)
        (jx, tx), (js, ts) = pair(x, dtype), pair(sc, dtype)
        out = rmsnorm(tx, ts, 1e-6)
        assert out.dtype == DTYPES[dtype][1] and out.shape == tx.shape
        np.testing.assert_allclose(as_np(out), as_np(jax_rmsnorm(jx, js, impl="xla")),
                                   **tol(dtype))

    def test_matches_pallas_interpret(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 40, 128)).astype(np.float32)
        sc = (rng.standard_normal(128) * 0.1).astype(np.float32)
        (jx, tx), (js, ts) = pair(x), pair(sc)
        ref = jax_rmsnorm(jx, js, impl="interpret", blk_rows=32)
        np.testing.assert_allclose(rmsnorm(tx, ts, 1e-6).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


class TestRmsNormAdd:
    """The fused residual add + RMSNorm's plain version (what the CPU runs)
    against the JAX package's ``x + y`` followed by its RMSNorm kernel in
    interpret mode and by ``repro.models.layers.rms_norm``."""

    @pytest.mark.parametrize("shape", [(1, 1, 64), (3, 17, 128), (2, 40, 256), (4, 3072),
                                       (2, 5, 1024)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax_add_then_norm(self, shape, dtype):
        rng = np.random.default_rng(sum(shape) + 1)
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        r = rng.standard_normal(shape).astype(np.float32)
        sc = (rng.standard_normal(shape[-1]) * 0.2).astype(np.float32)
        (jx, tx), (jr, tr), (js, ts) = pair(x, dtype), pair(r, dtype), pair(sc, dtype)
        s, y = rmsnorm_add(tx, tr, ts, 1e-6)
        assert s.dtype == y.dtype == DTYPES[dtype][1] and s.shape == y.shape == tx.shape
        js_sum = jx + jr  # the reference's `x = x + y`, in the input's dtype
        np.testing.assert_array_equal(as_np(s), as_np(js_sum))
        np.testing.assert_allclose(as_np(y), as_np(jax_rms_norm(js_sum, js, 1e-6)), **tol(dtype))
        rows = int(np.prod(shape[:-1]))
        interp = jax_rmsnorm(js_sum.reshape(rows, shape[-1]), js, impl="interpret",
                             blk_rows=min(8, rows))
        np.testing.assert_allclose(as_np(y).reshape(rows, -1), as_np(interp), **tol(dtype))

    def test_equals_add_then_rmsnorm_on_the_cpu(self):
        rng = np.random.default_rng(8)
        x, r = (torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
        sc = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(torch.bfloat16)
        s, y = rmsnorm_add(x, r, sc, 1e-6)
        assert torch.equal(s, x + r) and torch.equal(y, rmsnorm(x + r, sc, 1e-6))


class TestNormPlan:
    """The RMSNorm kernel's launch (threads per row, rows per CTA, 16-byte
    vectors per thread), planned on the host."""

    def test_every_vector_of_a_row_on_exactly_one_thread(self):
        for elt in (2, 4):
            for d in range(16 // elt, 20_000, 8 // elt * 37):
                if (d * elt) % 16:
                    continue
                p = norm_ops.norm_plan(7, d, elt)
                nvec = d * elt // 16
                # thread t of a row holds vectors t, t + tpr, ...: all of them
                # once, with the fewest vectors a thread the kernel is built for
                assert p.threads_per_row * p.vectors >= nvec, (d, elt, p)
                assert p.vectors == 1 or p.threads_per_row * (p.vectors // 2) < nvec, (d, p)
                assert p.vectors in norm_ops.VECTORS and p.threads_per_row in norm_ops.ROW_THREADS
                assert p.threads_per_row * p.rows_per_cta <= 512, (d, p)

    @pytest.mark.parametrize("rows", [1, 3, 4, 5, 256, 1000])
    def test_every_row_in_exactly_one_cta(self, rows):
        for d, elt in ((16, 4), (64, 2), (3072, 2), (3072, 4), (7168, 2)):
            p = norm_ops.norm_plan(rows, d, elt)
            assert (p.ctas - 1) * p.rows_per_cta < rows <= p.ctas * p.rows_per_cta, (d, p)

    def test_the_serving_widths(self):
        # StarCoder2-3B's rows (d 3072 bf16): a CTA of 128 threads per row, 3
        # of 4 vectors live; jamba's (4096): 128 threads of 4 vectors each
        assert norm_ops.norm_plan(4, 3072, 2) == (128, 1, 4, 4)
        assert norm_ops.norm_plan(256, 3072, 2) == (128, 1, 4, 256)
        assert norm_ops.norm_plan(4, 4096, 2) == (128, 1, 4, 4)
        assert norm_ops.norm_plan(6, 64, 2) == (32, 4, 1, 2)  # the reduced configs' width

    def test_the_neighbours_and_rows_that_fit_nothing_raise(self):
        assert norm_ops.norm_plan(256, 3072, 2, threads_per_row=32) == (32, 4, 16, 64)
        assert norm_ops.norm_plan(256, 3072, 2, threads_per_row=64, rows_per_cta=2) == (
            64, 2, 8, 128)
        with pytest.raises(ValueError):
            norm_ops.norm_plan(4, 3071, 2)  # not whole 16-byte vectors
        with pytest.raises(ValueError):
            norm_ops.norm_plan(4, 65536 + 8, 2)  # wider than 512 threads of 16 vectors
        with pytest.raises(ValueError):
            norm_ops.norm_plan(4, 3072, 2, threads_per_row=48)
        with pytest.raises(ValueError):
            norm_ops.norm_plan(4, 3072, 2, threads_per_row=256, rows_per_cta=4)
        with pytest.raises(ValueError):
            norm_ops.norm_plan(4, 3072, 8)

    def test_a_plan_is_made_once_per_shape(self):
        # each wrapper plans on every call: a shape seen before costs a lookup
        p = norm_ops.norm_plan(4, 3072, 2)
        hits = norm_ops.norm_plan.cache_info().hits
        assert norm_ops.norm_plan(4, 3072, 2) is p
        assert norm_ops.norm_plan.cache_info().hits == hits + 1
        assert norm_ops.norm_plan(4, 3072, 2, threads_per_row=64) != p


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, H, K, hd, causal, window, cap   (tests/test_kernels.py cases first)
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),  # GQA causal
    (1, 256, 256, 4, 4, 128, True, 128, 0.0),  # MHA sliding window
    (2, 128, 128, 8, 2, 64, True, 0, 50.0),  # softcap (gemma2)
    (1, 256, 256, 2, 1, 64, False, 0, 0.0),  # bidirectional MQA
    (1, 192, 192, 6, 3, 32, True, 64, 30.0),  # window + softcap, odd dims
    (1, 200, 200, 24, 2, 128, True, 0, 0.0),  # ragged prompt at the StarCoder2 head split
    (2, 37, 300, 4, 2, 64, True, 0, 0.0),  # Sq < Skv, ragged both
    (1, 100, 100, 4, 2, 128, True, 64, 50.0),  # window 64 + softcap 50, ragged
]


def _qkv(B, Sq, Skv, H, K, hd, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    return q, k, v


class TestFlashAttention:
    @pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap", FLASH_CASES)
    def test_matches_jax(self, B, Sq, Skv, H, K, hd, causal, window, cap):
        q, k, v = _qkv(B, Sq, Skv, H, K, hd)
        (jq, tq), (jk, tk), (jv, tv) = pair(q), pair(k), pair(v)
        out = flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap)
        ref = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=cap,
                                  impl="xla")
        assert out.shape == (B, Sq, H, hd)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 64, 50.0)])
    def test_matches_pallas_interpret(self, causal, window, cap):
        q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=11)
        (jq, tq), (jk, tk), (jv, tv) = pair(q), pair(k), pair(v)
        ref = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=cap,
                                  impl="interpret", blk_q=64, blk_k=64)
        out = flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_bfloat16(self):
        q, k, v = _qkv(1, 96, 96, 4, 2, 64, seed=5)
        (jq, tq), (jk, tk), (jv, tv) = pair(q, "bfloat16"), pair(k, "bfloat16"), pair(v, "bfloat16")
        out = flash_attention(tq, tk, tv)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(out), as_np(jax_flash_attention(jq, jk, jv, impl="xla")),
                                   **tol("bfloat16"))


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, S, H, K, hd, pos, cap   (tests/test_kernels.py cases first)
    (2, 512, 8, 2, 64, 511, 0.0),
    (1, 1024, 4, 4, 128, 700, 0.0),  # partially filled cache
    (2, 512, 6, 2, 64, 40, 50.0),  # softcap, short valid region
    (1, 256, 16, 8, 32, 255, 0.0),
    (4, 1024, 24, 2, 128, 300, 0.0),  # the StarCoder2-3B decode shape, 4 slots
    (3, 100, 4, 2, 16, 0, 0.0),  # only position 0 visible
]


def _cache(B, S, H, K, hd, seed=9):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, kc, vc


class TestDecodeAttention:
    @pytest.mark.parametrize("B,S,H,K,hd,pos,cap", DECODE_CASES)
    def test_matches_jax(self, B, S, H, K, hd, pos, cap):
        q, kc, vc = _cache(B, S, H, K, hd)
        (jq, tq), (jk, tk), (jv, tv) = pair(q), pair(kc), pair(vc)
        out = decode_attention(tq, tk, tv, pos, softcap=cap)
        ref = jax_decode_attention(jq, jk, jv, jnp.int32(pos), softcap=cap, impl="xla")
        assert out.shape == (B, 1, H, hd)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_matches_pallas_interpret(self):
        q, kc, vc = _cache(2, 256, 6, 2, 64, seed=4)
        (jq, tq), (jk, tk), (jv, tv) = pair(q), pair(kc), pair(vc)
        ref = jax_decode_attention(jq, jk, jv, jnp.int32(130), softcap=30.0,
                                   impl="interpret", blk_k=64)
        out = decode_attention(tq, tk, tv, 130, softcap=30.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_garbage_past_pos_is_ignored(self):
        """Cache slots beyond ``pos`` must not affect the output."""
        q, kc, vc = _cache(1, 256, 4, 2, 64)
        pos = 100
        tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
        o1 = decode_attention(tq, tk, tv, pos)
        tk2, tv2 = tk.clone(), tv.clone()
        tk2[:, pos + 1:] = 1e6
        tv2[:, pos + 1:] = -1e6
        o2 = decode_attention(tq, tk2, tv2, pos)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6, atol=1e-6)

    def test_bfloat16(self):
        q, kc, vc = _cache(2, 128, 8, 2, 64, seed=2)
        (jq, tq), (jk, tk), (jv, tv) = (pair(a, "bfloat16") for a in (q, kc, vc))
        out = decode_attention(tq, tk, tv, 77)
        assert out.dtype == torch.bfloat16
        ref = jax_decode_attention(jq, jk, jv, jnp.int32(77), impl="xla")
        np.testing.assert_allclose(as_np(out), as_np(ref), **tol("bfloat16"))


class TestSplitPlan:
    """The decode kernel's runs of keys (one CTA each), planned on the host."""

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_every_key_in_exactly_one_run(self, n_sm):
        for bk in range(1, 65):
            for n_valid in range(1, 1025):
                chunk, nsplit = split_plan(bk, 1, n_valid, n_sm)
                # runs [s * chunk, min((s + 1) * chunk, n_valid)) for s < nsplit
                assert (nsplit - 1) * chunk < n_valid <= nsplit * chunk, (bk, n_valid)

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_runs_are_multiples_of_16_keys_but_the_last(self, n_sm):
        for bk in range(1, 65):
            for n_valid in range(1, 1025):
                chunk, nsplit = split_plan(bk, 1, n_valid, n_sm)
                if nsplit > 1:
                    assert chunk % 16 == 0 and chunk >= MIN_SPLIT, (bk, n_valid, chunk)

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_runs_cover_the_card_where_the_keys_allow(self, n_sm):
        for bk in range(1, 65):
            for n_valid in range(1, 1025):
                _, nsplit = split_plan(bk, 1, n_valid, n_sm)
                most = bk * -(-n_valid // MIN_SPLIT)  # runs of MIN_SPLIT keys, the most allowed
                assert bk * nsplit >= min(n_sm, most), (bk, n_valid, nsplit)

    @pytest.mark.parametrize("B,K", [(4, 2), (2, 4), (8, 8)])
    def test_batch_and_kv_heads_enter_only_as_their_product(self, B, K):
        for n_valid in (1, 33, 301, 1024):
            assert split_plan(B, K, n_valid, 132) == split_plan(B * K, 1, n_valid, 132)

    def test_starcoder2_and_jamba_serving_plans(self):
        assert split_plan(4, 2, 301, 132) == (32, 10)  # StarCoder2, 4 slots, pos 300
        assert split_plan(4, 2, 1024, 132) == (48, 22)  # pos 1023: 176 CTAs
        assert split_plan(4, 8, 301, 132) == (48, 7)  # jamba, 4 slots, pos 300
        assert split_plan(70, 2, 51, 132) == (64, 1)  # the pairs alone fill the card

    def test_scratch_holds_every_runs_partials(self):
        for B, H, hd, nsplit in ((4, 24, 128, 10), (4, 32, 128, 7), (1, 32, 256, 17)):
            rows = B * H * nsplit
            # partial outputs, then maxima, then sums (csrc/decode_attention.cu)
            assert scratch_floats(B, H, hd, nsplit) == rows * hd + rows + rows
        assert scratch_floats(4, 24, 128, 1) == 0  # one run writes the output itself

    def test_refuses_empty_sizes(self):
        with pytest.raises(ValueError):
            split_plan(4, 2, 0, 132)


class TestDecisionScanPlan:
    """The decision-scan kernel's CTAs (blocks of clients, each with a ring of
    STAGES epochs in shared memory), planned on the host."""

    E1S = (1, 2, 5, 16, 17, 33, 129, 257, 1000, 3628)

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_every_client_in_exactly_one_cta(self, n_sm):
        for e1 in self.E1S:
            for elt in (4, 8):
                for n in range(1, 3000, 7):
                    p = scan_plan(600, n, e1, elt, n_sm)
                    # CTA i takes clients [i * clients, min((i + 1) * clients, n))
                    assert p.ctas == -(-n // p.clients), (n, e1, elt, p)
                    assert (p.ctas - 1) * p.clients < n <= p.ctas * p.clients, (n, e1, elt, p)

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_the_ring_fits_and_every_client_has_its_lanes(self, n_sm):
        for e1 in self.E1S:
            for elt in (4, 8):
                for n in (1, 13, 64, 2047, 2048, 100_000):
                    p = scan_plan(600, n, e1, elt, n_sm)
                    # one 8-byte mbarrier per stage (rounded to 16 bytes), then
                    # STAGES stages: the span rounded up to 16 bytes, plus 16
                    # for its shift
                    stage = -(-p.clients * e1 * elt // 16) * 16 + 16
                    assert p.smem == -(-8 * DS_STAGES // 16) * 16 + DS_STAGES * stage, (n, e1, p)
                    assert p.smem <= SMEM_LIMIT == 232_448, (n, e1, p)
                    assert p.threads % 32 == 0 and p.clients * p.group <= p.threads
                    assert p.threads <= MAX_THREADS and p.threads - p.clients * p.group < 32

    def test_a_lane_scans_at_most_lane_columns_unless_its_client_has_32_lanes(self):
        for e1 in range(1, 3000):
            g = scan_plan(600, 64, e1, 8, 132).group
            assert g & (g - 1) == 0 and 1 <= g <= 32 and g <= e1, e1
            assert -(-e1 // g) <= LANE_COLUMNS or g == 32, e1
            assert g == 1 or -(-e1 // (g // 2)) > LANE_COLUMNS, e1  # and no more lanes

    @pytest.mark.parametrize("n_sm", [132, 114, 16])
    def test_the_grid_covers_the_card_where_clients_allow(self, n_sm):
        for e1 in self.E1S:
            for n in range(1, 5000, 11):
                assert scan_plan(600, n, e1, 8, n_sm).ctas >= min(n, n_sm), (n, e1)

    def test_a_step_takes_whole_stages_and_leaves_some_ahead(self):
        assert DS_STAGES >= 3 and DS_STAGES & (DS_STAGES - 1) == 0
        for step in DS_STEPS:
            assert DS_STAGES % step == 0 and DS_STAGES - step >= 3  # epochs in flight
        for t in range(1, 20):
            step = scan_plan(t, 2048, 129, 8, 132).step
            assert step in DS_STEPS and step <= t  # no step reduces epochs that are not there
        assert scan_plan(600, 2048, 129, 8, 132).step == max(DS_STEPS)

    def test_city_and_acceptance_plans(self):
        # the city pool (2,048 clients, 128 edges) over 600 epochs and the
        # closed loop's one-epoch launch: 8 clients of 16 lanes per CTA
        ring = 64 + 8 * (8 * 129 * 8 + 16)
        assert scan_plan(600, 2048, 129, 8, 132) == (4, 8, 128, 16, ring, 256)
        assert scan_plan(1, 2048, 129, 8, 132) == (1, 8, 128, 16, ring, 256)
        assert scan_plan(120, 64, 5, 8, 132) == (4, 1, 32, 1, 64 + 8 * 64, 64)  # the 64 x 4 cluster
        assert scan_plan(600, 2047, 129, 8, 132).ctas == 256  # ragged: the last CTA holds 7

    def test_sizes_that_fit_nothing_raise(self):
        # one client's 8 epochs of 3,628 float64 costs fit 232,448 bytes, 3,629 do not
        assert scan_plan(600, 1, 3628, 8, 132).smem == 232_384
        with pytest.raises(ValueError, match="shared memory"):
            scan_plan(600, 1, 3629, 8, 132)
        with pytest.raises(ValueError, match="shared memory"):
            scan_plan(1, 2048, 20_000, 4, 132)
        with pytest.raises(ValueError):
            scan_plan(600, 0, 5, 8, 132)
        with pytest.raises(ValueError):
            scan_plan(0, 16, 5, 8, 132)
        with pytest.raises(ValueError):
            scan_plan(600, 16, 5, 2, 132)  # neither float32 nor float64


# ---------------------------------------------------------------------------
# Selective scan (mamba S6)
# ---------------------------------------------------------------------------


class TestSsmScanPlan:
    """The selective-scan kernel's CTAs (a group of lanes per channel holding
    its states, a block of channels per CTA, tiles of steps), planned on the
    host."""

    def test_a_plan_is_made_once_per_shape(self):
        p = scan_ops.scan_plan(4, 1, 8192, 16, 2, 132)
        hits = scan_ops.scan_plan.cache_info().hits
        assert scan_ops.scan_plan(4, 1, 8192, 16, 2, 132) is p
        assert scan_ops.scan_plan.cache_info().hits == hits + 1
        assert scan_ops.scan_plan(4, 1, 8192, 16, 2, 132, group=8).group == 8

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_cp_async_only_where_every_staged_row_is_whole_16_byte_chunks(self, dtype):
        # dt, u (B, T, D) contiguous; B and C column slices of one x_proj
        # output (B, T, W), as the mixer passes them: the kernel copies by
        # cp.async only where every row starts on 16 bytes and spans whole
        # 16-byte chunks, else it takes plain loads
        elt = torch.tensor([], dtype=dtype).element_size()
        per = 16 // elt  # elements per 16-byte chunk

        def rows(B, T, D, N, W, lo):
            dt, u = torch.zeros(B, T, D, dtype=dtype), torch.zeros(B, T, D, dtype=dtype)
            xp = torch.zeros(B, T, W, dtype=dtype)
            Bc, Cc = xp[..., lo:lo + N], xp[..., lo + N:lo + 2 * N]
            p = scan_ops.scan_plan(B, T, D, N, elt, 132)
            return scan_ops._async_rows(dt, Bc, Cc, u, p.channels)

        assert rows(4, 1, 8192, 16, 8 + 32 + 8192 // 16, per)  # jamba's decode step
        assert rows(1, 241, 8192, 16, 8 * per + 32, per)  # its prefill
        assert not rows(1, 241, 8192, 16, 8 * per + 32 + 1, per)  # x_proj rows off 16 bytes
        assert not rows(2, 5, 8192, 16, 8 * per + 32, 1)  # B's first column off 16 bytes
        assert not rows(2, 5, 200 + 1, 16, 8 * per + 32, per)  # D off whole chunks
        assert rows(1, 1, 256, 16, 16 * per + 32 + 1, per)  # one row: no stride steps
        assert not rows(2, 1, 256, 16, 16 * per + 32 + 1, per)  # two rows off 16 bytes
        # N = 4: whole chunks in fp32, half a chunk in bf16
        assert rows(2, 5, 256, 4, 2 * per + 8, per) == (elt == 4)

    @pytest.mark.parametrize("group", scan_ops.GROUPS)
    def test_every_channel_in_one_cta_and_every_state_on_one_lane(self, group):
        for n in range(1, scan_ops.N_MAX + 1):
            for b, d in ((1, 8192), (4, 8192), (2, 200), (3, 203), (1, 1), (5, 97)):
                p = scan_ops.scan_plan(b, 33, d, n, 2, 132, group=group)
                # CTA (x, b) takes channels [x * channels, (x + 1) * channels)
                # of batch row b; thread i of it, channel i // group, lane i % group
                per_row = -(-d // p.channels)
                assert p.ctas == b * per_row and (per_row - 1) * p.channels < d
                assert p.channels * p.group == scan_ops.THREADS
                assert scan_ops.THREADS % 32 == 0 and 32 % p.group == 0  # groups within a warp
                owner = {}
                for lane in range(p.group):  # lane l: states [l * 16/G, (l + 1) * 16/G)
                    spl = scan_ops.N_MAX // p.group
                    for s in range(lane * spl, (lane + 1) * spl):
                        if s < n:
                            assert s not in owner
                            owner[s] = lane
                assert sorted(owner) == list(range(n)), (n, group)

    def test_the_grid_covers_the_card_at_jambas_shapes(self):
        for n_sm in (132, 114):
            for b, t in ((1, 241), (4, 1), (1, 256), (8, 1)):
                p = scan_ops.scan_plan(b, t, 8192, 16, 2, n_sm)
                assert p.ctas >= n_sm, (b, t, p)
                assert (b * 8192 * p.group >= n_sm * scan_ops.FILL_THREADS
                        or p.group == max(scan_ops.GROUPS)), (b, t, p)
                smaller = [g for g in scan_ops.GROUPS if g < p.group]
                assert all(b * 8192 * g < n_sm * scan_ops.FILL_THREADS for g in smaller)

    def test_jambas_plans(self):
        n_sm = 132
        # prefill (1, 241, 8192, 16): 4 lanes of 4 states a channel, 32
        # channels a CTA, 256 CTAs, tiles of 64 steps, y reduce-scattered 4
        # steps at a time
        p = scan_ops.scan_plan(1, 241, 8192, 16, 2, n_sm)
        assert (p.group, p.channels, p.tile_t, p.reduce, p.ctas) == (4, 32, 64, "scatter", 256)
        # a decode step (4, 1, 8192, 16): 4 lanes of 4 states, 32 channels a
        # CTA, one step reduced by shuffles
        p = scan_ops.scan_plan(4, 1, 8192, 16, 2, n_sm)
        assert (p.group, p.channels, p.tile_t, p.reduce, p.ctas) == (4, 32, 1, "shuffle", 1024)

    def test_shared_memory_fits_and_scatter_tiles_hold_whole_groups(self):
        for group in scan_ops.GROUPS:
            for reduce in scan_ops.REDUCTIONS:
                for n in range(1, 17):
                    for elt in (2, 4):
                        for t, tile in itertools.product((0, 1, 31, 32, 33, 10_000),
                                                         (None, 1, 5, 64)):
                            p = scan_ops.scan_plan(2, t, 100, n, elt, 132, group=group,
                                                   reduce=reduce, tile_t=tile)
                            assert p.smem == scan_ops.smem_bytes(p.tile_t, p.channels, n, elt)
                            assert p.smem % 16 == 0 and p.smem <= scan_ops.SMEM_LIMIT
                            assert 1 <= p.tile_t <= scan_ops.TILE_T
                            assert reduce != "scatter" or p.tile_t % group == 0
                            assert p.tile_t >= min(t, tile or scan_ops.TILE_T)
        # bf16 jamba prefill: two raw stages of (64 x 32) dt and u and (64 x
        # 16) B and C, the fp32 tile ((dt, dt u) per channel, (B, C) per
        # state), and 64 x 32 staged sums of y
        raw = 2 * (2 * 64 * 32 * 2 + 2 * 64 * 16 * 2)
        assert scan_ops.scan_plan(1, 241, 8192, 16, 2, 132).smem == (
            raw + 64 * 32 * 8 + 64 * 16 * 8 + 64 * 32 * 4)

    def test_sizes_that_fit_nothing_raise(self):
        for bad in ((1, 5, 64, 0, 2), (1, 5, 64, 17, 2), (65536, 5, 64, 16, 2), (1, 5, 64, 16, 8),
                    (0, 5, 64, 16, 2), (1, 5, 0, 16, 2), (1, -1, 64, 16, 2)):
            with pytest.raises(ValueError):
                scan_ops.scan_plan(*bad, 132)
        with pytest.raises(ValueError):
            scan_ops.scan_plan(1, 5, 64, 16, 2, 132, group=2)
        for reduce in ("tree", "smem"):  # "smem" was measured slower and is not built
            with pytest.raises(ValueError):
                scan_ops.scan_plan(1, 5, 64, 16, 2, 132, reduce=reduce)
        with pytest.raises(ValueError):
            scan_ops.scan_plan(1, 5, 64, 16, 2, 132, tile_t=scan_ops.TILE_T + 1)



def _scan_inputs(B, T, D, N, seed=13, with_h0=False, fused=False):
    """dt > 0, B, C, u ~ N(0, 1), A < 0 as the mixer makes them. ``fused``
    gives B and C as column slices of one (B, T, 8 + 2N) array, the layout
    of the mixer's x_proj output."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)))).astype(np.float32) * 0.1
    u = rng.standard_normal((B, T, D)).astype(np.float32)
    A = -np.exp(rng.standard_normal((D, N)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32) if with_h0 else None
    if fused:
        dbc = rng.standard_normal((B, T, 8 + 2 * N)).astype(np.float32)
        return dt, dbc, u, A, h0
    Bc = rng.standard_normal((B, T, N)).astype(np.float32)
    Cc = rng.standard_normal((B, T, N)).astype(np.float32)
    return dt, Bc, Cc, u, A, h0


class TestSsmScan:
    @pytest.mark.parametrize("B,T,D,N,with_h0", [
        (2, 64, 128, 8, False),  # tests/test_kernels.py's shapes
        (1, 128, 256, 16, False),
        (2, 37, 200, 16, True),  # ragged T and D, decode-style h0
        (4, 1, 96, 16, True),  # one decode step
        (3, 19, 40, 4, True),  # the reduced config's N
    ])
    def test_matches_jax_reference_with_final_state(self, B, T, D, N, with_h0):
        dt, Bc, Cc, u, A, h0 = _scan_inputs(B, T, D, N, with_h0=with_h0)
        y, h = ssm_scan(*(torch.from_numpy(a) for a in (dt, Bc, Cc, u, A)),
                        None if h0 is None else torch.from_numpy(h0))
        jy, jh = jax_ssm_scan_reference(*(jnp.asarray(a) for a in (dt, Bc, Cc, u, A)),
                                        None if h0 is None else jnp.asarray(h0))
        assert y.shape == (B, T, D) and h.shape == (B, D, N) and h.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)

    def test_strided_b_and_c_slices(self):
        dt, dbc, u, A, h0 = _scan_inputs(2, 33, 64, 16, seed=5, with_h0=True, fused=True)
        tdbc = torch.from_numpy(dbc)
        _, tB, tC = tdbc.split([8, 16, 16], dim=-1)
        assert not tB.is_contiguous() and tB.stride() == (33 * 40, 40, 1)
        y, h = ssm_scan(torch.from_numpy(dt), tB, tC, torch.from_numpy(u), torch.from_numpy(A),
                        torch.from_numpy(h0))
        jy, jh = jax_ssm_scan_reference(jnp.asarray(dt), jnp.asarray(dbc[..., 8:24]),
                                        jnp.asarray(dbc[..., 24:]), jnp.asarray(u),
                                        jnp.asarray(A), jnp.asarray(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("B,T,D,N,bt,bd", [(2, 64, 128, 8, 16, 64),
                                               (1, 128, 256, 16, 32, 128)])
    def test_matches_pallas_interpret(self, B, T, D, N, bt, bd):
        dt, Bc, Cc, u, A, _ = _scan_inputs(B, T, D, N, seed=21)
        ref = jax_ssm_scan(*(jnp.asarray(a) for a in (dt, Bc, Cc, u, A)), impl="interpret",
                           blk_t=bt, blk_d=bd)
        y, _ = ssm_scan(*(torch.from_numpy(a) for a in (dt, Bc, Cc, u, A)))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_bfloat16_rounds_y_once(self):
        dt, Bc, Cc, u, A, h0 = _scan_inputs(2, 24, 64, 16, seed=3, with_h0=True)
        pairs = [pair(a, "bfloat16") for a in (dt, Bc, Cc, u)]
        y, h = ssm_scan(*(t for _, t in pairs), torch.from_numpy(A), torch.from_numpy(h0))
        jy, jh = jax_ssm_scan_reference(*(j for j, _ in pairs), jnp.asarray(A), jnp.asarray(h0))
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        np.testing.assert_allclose(as_np(y), as_np(jy), **tol("bfloat16"))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain version and never count a launch
# ---------------------------------------------------------------------------


def _launch_counts():
    return (rmsnorm.launches, rmsnorm_add.launches, flash_attention.launches,
            decode_attention.launches, ssm_scan.launches)


def test_cpu_calls_never_touch_the_launch_counters():
    before = _launch_counts()
    rmsnorm(torch.ones(2, 64), torch.zeros(64), 1e-6)
    rmsnorm_add(torch.ones(2, 64), torch.ones(2, 64), torch.zeros(64), 1e-6)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 4, 2, 32))
    flash_attention(q, k, v)
    q, kc, vc = (torch.from_numpy(a) for a in _cache(1, 32, 4, 2, 32))
    decode_attention(q, kc, vc, 5)
    ssm_scan(*(torch.from_numpy(a) for a in _scan_inputs(1, 5, 8, 4)[:5]))
    assert _launch_counts() == before


def test_other_devices_are_refused():
    meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        rmsnorm(meta, torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        rmsnorm_add(meta, meta, torch.empty(64, device="meta"))
    q = torch.empty(1, 8, 4, 32, device="meta")
    kv = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        decode_attention(q[:, :1], kv, kv, 3)
    x, bc = torch.empty(1, 4, 8, device="meta"), torch.empty(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        ssm_scan(x, bc, bc, x, torch.empty(8, 2, device="meta"))


def test_building_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("rmsnorm",))


@pytest.mark.parametrize("header", ["common.cuh", "hopper.cuh"])
def test_editing_a_shared_header_rebuilds_every_library(monkeypatch, tmp_path, header):
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._library_path(name) for name in _build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {name: _build._library_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    with open(csrc / "rmsnorm.cu", "a") as f:  # a kernel's own source rebuilds only it
        f.write("\n// edited\n")
    again = {name: _build._library_path(name) for name in _build.SOURCES}
    assert [n for n in _build.SOURCES if again[n] != after[n]] == ["rmsnorm"]
