"""Analytic FLOP models: MODEL_FLOPS (6ND-style) + recurrence supplements.

The port's copy of ``repro.perf.flops`` over the port's configs and
``models.lm.num_params`` (every config, the encoder-decoder's encoder and
cross branches included). Used for (a) the MODEL_FLOPS / counted-FLOPs
"useful compute" ratio of ``roofline.report_from_counts``, (b) supplements
for work hidden inside recurrences (mamba / xLSTM time scans), (c) the
paper-side service-time estimates (``core.service_time.from_roofline``), and
(d) the measurement harness's simulated clock (``param_counts``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeSuite

__all__ = ["CellFlops", "cell_flops", "param_counts"]


@dataclass(frozen=True)
class CellFlops:
    model_flops: float  # canonical 6ND / 2ND (active params)
    attn_flops: float  # quadratic attention term (fwd, incl. bwd factor for train)
    recurrence_flops: float  # mamba/xLSTM scan supplements (hidden in while loops)
    total: float  # model + attn + recurrence
    n_params: int
    n_active: int
    note: str = ""


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total params, active params) — active discounts non-routed experts."""
    from repro_torch.models.lm import num_params

    total = num_params(cfg)
    if cfg.num_experts == 0:
        return total, total
    moe_layers = sum(1 for s in cfg.superblock if s.ffn in ("moe", "moe_dense"))
    moe_layers *= cfg.num_superblocks
    per_expert = 3 * cfg.d_model * cfg.d_ff  # wi, wg, wo
    inactive = moe_layers * per_expert * (cfg.num_experts - cfg.num_experts_per_tok)
    return total, total - inactive


def _matmul_params(cfg: ModelConfig, n: int) -> int:
    """Params participating in matmuls: drop the input-embedding gather,
    keep the logits matmul (tied models reuse the table there)."""
    emb = cfg.vocab_size * cfg.d_model
    if cfg.tie_embeddings:
        return n  # single table, used as the logits matmul
    return n - emb  # gather excluded; unembed already counted


def _attn_layer_flops(cfg: ModelConfig, B: int, S_q: int, S_kv: int, *, local: bool) -> float:
    """QK^T + PV for one layer, forward. Causal halves the full square;
    local layers touch min(S_kv, W) keys per query."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    keys = min(S_kv, cfg.window_size) if local else S_kv
    causal_factor = 0.5 if (S_q == S_kv and not local) else 1.0
    return 2.0 * 2.0 * B * H * hd * S_q * keys * causal_factor


def _recurrence_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Per-token scan work hidden in while loops (fwd)."""
    total = 0.0
    per_sb = {m: sum(1 for s in cfg.superblock if s.mixer == m) for m in ("mamba", "mlstm", "slstm")}
    n = cfg.num_superblocks
    if per_sb["mamba"]:
        di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
        total += per_sb["mamba"] * n * 6.0 * B * S * di * ds
    if per_sb["mlstm"]:
        H = cfg.num_heads
        hd = cfg.d_model // H
        Lc = 256
        total += per_sb["mlstm"] * n * B * S * H * (4.0 * min(Lc, S) * hd + 6.0 * hd * hd)
    if per_sb["slstm"]:
        hd = cfg.d_model // cfg.num_heads
        total += per_sb["slstm"] * n * 8.0 * B * S * cfg.d_model * hd
    return total


def cell_flops(cfg: ModelConfig, shape: ShapeSuite) -> CellFlops:
    B, S = shape.global_batch, shape.seq_len
    total, active = param_counts(cfg)
    n_mm = _matmul_params(cfg, active)

    attn_positions = [
        (spec.mixer == "attn_local") for spec in cfg.superblock if spec.mixer.startswith("attn")
    ]
    n_sb = cfg.num_superblocks

    if shape.kind == "train":
        tokens = B * S
        model = 6.0 * n_mm * tokens
        attn = 3.0 * sum(
            _attn_layer_flops(cfg, B, S, S, local=loc) for loc in attn_positions
        ) * n_sb
        if cfg.is_encdec:
            attn += 3.0 * cfg.encoder_layers * _attn_layer_flops(cfg, B, S, S, local=False)
            # cross attention: S_q x S_enc full
            attn += 3.0 * len(attn_positions) * n_sb * 2.0 * 2.0 * B * cfg.num_heads * cfg.resolved_head_dim * S * S
        rec = 3.0 * _recurrence_flops(cfg, B, S)
        if cfg.remat == "full":
            model *= 4.0 / 3.0  # extra forward for rematerialisation
            attn *= 4.0 / 3.0
            rec *= 4.0 / 3.0
        note = "train: 6ND(active, matmul params) x remat(4/3)"
    elif shape.kind == "prefill":
        tokens = B * S
        model = 2.0 * n_mm * tokens
        attn = sum(_attn_layer_flops(cfg, B, S, S, local=loc) for loc in attn_positions) * n_sb
        if cfg.is_encdec:
            attn += cfg.encoder_layers * _attn_layer_flops(cfg, B, S, S, local=False)
            attn += len(attn_positions) * n_sb * 2.0 * 2.0 * B * cfg.num_heads * cfg.resolved_head_dim * S * S
        rec = _recurrence_flops(cfg, B, S)
        note = "prefill: 2ND"
    else:  # decode: one token against an S-token cache
        model = 2.0 * n_mm * B
        attn = sum(
            _attn_layer_flops(cfg, B, 1, S, local=loc) for loc in attn_positions
        ) * n_sb
        if cfg.is_encdec:
            attn += len(attn_positions) * n_sb * 2.0 * 2.0 * B * cfg.num_heads * cfg.resolved_head_dim * 1 * S
        rec = _recurrence_flops(cfg, B, 1)
        note = "decode: 2N per token + KV-cache attention"

    return CellFlops(
        model_flops=model,
        attn_flops=attn,
        recurrence_flops=rec,
        total=model + attn + rec,
        n_params=total,
        n_active=active,
        note=note,
    )
