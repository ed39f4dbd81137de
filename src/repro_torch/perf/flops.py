"""Parameter counts for the cost models: the port's copy of
``repro.perf.flops.param_counts``, over the port's ``models.lm.num_params``
(every config, the encoder-decoder's encoder and cross branches included).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

__all__ = ["param_counts"]


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
