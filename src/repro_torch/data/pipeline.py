"""Deterministic synthetic data pipeline: the port of ``repro.data.pipeline``.

Produces next-token-prediction batches (tokens / targets / loss_mask, plus
stub prefix or encoder embeddings for the VLM and audio architectures) from
a seeded, *stateless* generator: batch ``i`` is a pure function of (seed,
i), drawn from a ``torch.Generator`` seeded from both, so a restarted job
resumes the data exactly where its checkpoint left off by storing only the
step counter.

The token stream is a mixture of Zipf(1.2) unigrams and short repeated
motifs, giving the model structure to fit (a smoke run's loss falls well
below the uniform entropy). The motif bank is the reference's, drawn from
``numpy.random.default_rng(seed)``; the per-step draws cannot replay
``jax.random``, so they match the reference's in distribution only.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import torch_dtype

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


def _step_seed(seed: int, step: int) -> int:
    digest = hashlib.sha256(f"batch:{seed}:{step}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class SyntheticLM:
    """Stateless batch source: ``[step]`` -> batch dict of tensors on
    ``device`` (the CUDA card when None)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, *,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        v = cfg.vocab_size
        rng = np.random.default_rng(data.seed)
        # fixed Zipf unigram table + motif bank (generation-time constants)
        p = np.arange(1, v + 1, dtype=np.float64) ** (-data.zipf_a)
        self._probs = torch.tensor(p / p.sum(), dtype=torch.float32, device=self.device)
        self._motifs = torch.tensor(rng.integers(0, v, size=(64, data.motif_len)),
                                    dtype=torch.int32, device=self.device)

    def _tokens(self, gen: torch.Generator, batch: int, seq: int) -> torch.Tensor:
        uni = torch.multinomial(self._probs, batch * seq, replacement=True,
                                generator=gen).view(batch, seq)
        # overlay repeated motifs: position t copies motif[t % M] with prob q
        midx = torch.randint(0, self._motifs.shape[0], (batch,), generator=gen,
                             device=self.device)
        motif = self._motifs[midx]  # (batch, M)
        tiled = motif.repeat(1, seq // self.data.motif_len + 1)[:, :seq]
        use = torch.rand((batch, 1), generator=gen, device=self.device) < self.data.motif_prob
        return torch.where(use, tiled, uni.to(torch.int32))

    def _embeds(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """(batch, n, d) stub embeddings, N(0, 0.02^2) in the model's dtype."""
        shape = (self.data.batch, n, self.cfg.d_model)
        e = torch.randn(shape, generator=gen, device=self.device) * 0.02
        return e.to(torch_dtype(self.cfg.dtype))

    def __getitem__(self, step: int) -> dict:
        cfg, d = self.cfg, self.data
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(d.seed, step))
        S, P = d.seq_len, 0
        batch: dict = {}
        if cfg.is_encdec:
            batch["enc_embeds"] = self._embeds(gen, S)
        elif cfg.prefix_embed:
            P = int(S * cfg.prefix_len_fraction)
            batch["prefix_embeds"] = self._embeds(gen, P)
        text = S - P
        tokens = self._tokens(gen, d.batch, text)
        batch["tokens"] = tokens
        batch["targets"] = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((d.batch, text), dtype=torch.float32, device=self.device)
        mask[:, -1] = 0.0
        batch["loss_mask"] = mask
        return batch


def make_batch(cfg: ModelConfig, batch: int, seq: int, step: int = 0, seed: int = 0, *,
               device: str | torch.device | None = None) -> dict:
    """One-shot convenience for tests and examples."""
    return SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq, seed=seed), device=device)[step]
