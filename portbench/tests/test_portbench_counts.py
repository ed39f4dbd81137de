"""The yardstick's counts against hand counts at small shapes."""

import pytest

from portbench.cell import expand_model
from portbench.counts import flash, model_flops, peaks


def test_flash_bytes_and_operations_by_hand():
    # L 4, 2 query heads on 1 kv head, hd 8: q and o 4*2*8 each, k and v 4*1*8 each, bf16
    assert flash.flash_bytes(4, 2, 1, 8) == 2 * (4 * 2 * 8 * 2 + 4 * 1 * 8 * 2)
    # causal pairs 4+3+2+1 = 10; QK^T and PV 2 FLOPs a multiply-add each over hd 8, 2 heads
    assert flash.flash_ops(4, 2, 8) == 10 * 2 * (2 * 8 + 2 * 8)
    assert flash.flash_ops(4, 2, 8, causal=False) == 16 * 2 * 32
    L = 4096
    assert flash.flash_bound_s(L, 24, 2, 128) == pytest.approx(
        max(flash.flash_bytes(L, 24, 2, 128) / peaks.HBM_BPS,
            flash.flash_ops(L, 24, 128) / peaks.BF16_FLOPS))


def dense():
    return expand_model({"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
                         "d_ff": 16, "vocab_size": 256, "superblock": [["attn", "mlp"]],
                         "num_superblocks": 3, "gated_mlp": False})


def test_dense_prefill_and_decode_by_hand():
    m = dense()
    attn_lin = 2 * 8 * (8 + 2 * 4) + 2 * 8 * 8  # q, k, v; o
    mlp = 2 * 8 * 16 * 2  # wi, wo
    head = 2 * 8 * 256
    L = 5
    pairs = 15
    assert model_flops.prefill_flops(m, L) == head + 3 * (L * (attn_lin + mlp) + 4 * 2 * 4 * pairs)
    assert model_flops.decode_flops(m, 7) == head + 3 * (attn_lin + mlp + 4 * 2 * 4 * 8)
    assert model_flops.decode_flops(m, 7, batch=3) == 3 * model_flops.decode_flops(m, 7)


def test_hybrid_counts_routed_experts_and_the_scan():
    m = expand_model({"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
                      "vocab_size": 256, "superblock": [["mamba", "moe"], ["attn", "mlp"]],
                      "num_superblocks": 1, "gated_mlp": True, "num_experts": 4,
                      "num_experts_per_tok": 2, "mamba_d_state": 2, "mamba_d_conv": 4,
                      "mamba_expand": 2, "mamba_dt_rank": 1})
    lin = model_flops.per_token_linear(m)
    di = 16
    assert lin["mamba"] == (2 * 8 * 32 + 2 * 4 * di + 2 * di * (1 + 4) + 2 * 1 * di
                            + 4 * di * 2 + 2 * di * 8)
    assert lin["moe"] == 2 * 8 * 4 + 2 * 3 * 2 * 8 * 16  # router; 2 experts of 3 products
    assert lin["mlp"] == 3 * 2 * 8 * 16
    assert model_flops.decode_flops(m, 0) == (2 * 8 * 256 + lin["mamba"] + lin["moe"]
                                              + lin["attn"] + lin["mlp"] + 4 * 2 * 4 * 1)
