"""Workload generation for serving experiments (paper §4.1).

"We implement a workload generator that generates requests following a
Poisson process." Prompts/output lengths are drawn from configurable
distributions so the LLM case exhibits the variable service times the paper
models with M/M/1 (§3.5).

The generator is deterministic per seed: the same ``WorkloadConfig`` yields
an identical request stream (arrival times, prompt tokens, lengths), which is
what makes profiling runs replayable. The port's copy of
``repro.serving.workload`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import Request

__all__ = ["WorkloadConfig", "PoissonWorkload"]

MIN_PROMPT_LEN = 4  # floor enforced on every sampled prompt length


@dataclass(frozen=True)
class WorkloadConfig:
    arrival_rate: float  # lambda (requests/s, simulated clock)
    prompt_len: int = 64
    prompt_len_jitter: int = 0  # uniform +/- jitter
    max_new_tokens: int = 16
    new_tokens_geometric_p: float = 0.0  # >0 -> geometric output lengths (LLM case)
    vocab: int = 256
    seed: int = 0

    def __post_init__(self):
        if not self.arrival_rate > 0:
            raise ValueError(f"arrival_rate must be > 0, got {self.arrival_rate}")
        if self.prompt_len_jitter < 0:
            raise ValueError(
                f"prompt_len_jitter must be >= 0, got {self.prompt_len_jitter}")
        if self.prompt_len - self.prompt_len_jitter < MIN_PROMPT_LEN:
            # the min-length floor would otherwise silently truncate the low
            # tail of the configured distribution (and jitter >= prompt_len
            # could even produce non-positive lengths)
            raise ValueError(
                "prompt_len - prompt_len_jitter must be >= "
                f"{MIN_PROMPT_LEN} so the minimum-length floor never clips "
                f"the configured distribution; got prompt_len={self.prompt_len}, "
                f"prompt_len_jitter={self.prompt_len_jitter}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if not 0.0 <= self.new_tokens_geometric_p < 1.0:
            raise ValueError(
                "new_tokens_geometric_p must be in [0, 1), got "
                f"{self.new_tokens_geometric_p}")
        if self.vocab < 1:
            raise ValueError(f"vocab must be >= 1, got {self.vocab}")

    @property
    def prompt_len_range(self) -> tuple[int, int]:
        """Inclusive (min, max) prompt length the generator can emit —
        exactly the shapes an engine warmup has to cover."""
        return (self.prompt_len - self.prompt_len_jitter,
                self.prompt_len + self.prompt_len_jitter)


class PoissonWorkload:
    """Yields (arrival_time, Request) pairs on a simulated clock."""

    def __init__(self, wc: WorkloadConfig):
        self.wc = wc
        self.rng = np.random.default_rng(wc.seed)
        self._t = 0.0
        self._rid = 0

    def next_request(self) -> Request:
        wc = self.wc
        self._t += self.rng.exponential(1.0 / wc.arrival_rate)
        L = wc.prompt_len
        if wc.prompt_len_jitter:
            L += int(self.rng.integers(-wc.prompt_len_jitter, wc.prompt_len_jitter + 1))
        assert L >= MIN_PROMPT_LEN  # guaranteed by WorkloadConfig validation
        if wc.new_tokens_geometric_p > 0:
            nt = 1 + int(self.rng.geometric(wc.new_tokens_geometric_p))
            nt = min(nt, wc.max_new_tokens)
        else:
            nt = wc.max_new_tokens
        req = Request(
            rid=self._rid,
            prompt=self.rng.integers(0, wc.vocab, size=L).astype(np.int32),
            max_new_tokens=nt,
            arrival_s=self._t,
        )
        self._rid += 1
        return req

    def take(self, n: int) -> list[Request]:
        return [self.next_request() for _ in range(n)]
