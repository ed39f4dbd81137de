"""The one traffic generator: a traffic file's parameters in, a list of
requests out.

A copy of the seeded Poisson stream of ``repro_torch.serving.workload``,
extended to the cells' distributions, kept here so that later changes to the
program cannot move the yardstick. Two streams are drawn:

* the schedule (due times, prompt lengths, output lengths) from the traffic
  file's own ``schedule_seed``: every ``--seed`` replays the same trace, so a
  run's timing does not hang on which order a seed happens to draw;
* the prompt tokens from ``--seed`` (and the weights, elsewhere), so each
  seed serves different inputs.

A traffic file (JSON) holds:

``arrivals``     "poisson" (open loop at the cell's ``rate_rps``) or
                 "standing" (``requests`` due as the window opens)
``requests``     standing queue only: how many are due
``prompt_len``   {"dist": "loguniform" | "uniform" | "fixed", "min", "max"} or
                 {"dist": "fixed", "value"}
``new_tokens``   the same forms
``slots``        decode slots the engine serves with
``schedule_seed`` the trace's seed
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Item", "draw_length", "schedule", "prompt_tokens", "max_lengths"]


@dataclass(frozen=True)
class Item:
    """One request of the trace: when it is due, and its sizes."""
    rid: int
    due_s: float
    prompt_len: int
    new_tokens: int


def draw_length(spec: dict, rng: np.random.Generator) -> int:
    """One length from ``spec``: log-uniform or uniform over [min, max]
    inclusive, or a fixed value."""
    dist = spec["dist"]
    if dist == "fixed":
        return int(spec["value"])
    lo, hi = int(spec["min"]), int(spec["max"])
    if not 1 <= lo <= hi:
        raise ValueError(f"length range {lo}..{hi} is empty")
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "loguniform":
        x = math.exp(rng.uniform(math.log(lo), math.log(hi + 1)))
        return min(hi, max(lo, int(x)))
    raise ValueError(f"unknown length distribution {dist!r}")


def max_lengths(traffic: dict) -> tuple[int, int]:
    """The longest prompt and output the traffic can draw."""
    def top(spec):
        return int(spec["value"]) if spec["dist"] == "fixed" else int(spec["max"])
    return top(traffic["prompt_len"]), top(traffic["new_tokens"])


def schedule(traffic: dict, *, seconds: float, rate_rps: float | None = None) -> list[Item]:
    """The trace for a window of ``seconds``. Poisson: every request due in
    [0, seconds) at ``rate_rps``; standing: ``requests`` due at 0. The
    schedule depends on the traffic file alone, never on ``--seed``."""
    rng = np.random.default_rng(int(traffic["schedule_seed"]))
    kind = traffic["arrivals"]
    items: list[Item] = []
    if kind == "poisson":
        if not rate_rps or rate_rps <= 0:
            raise ValueError("a poisson traffic needs the cell's rate_rps > 0")
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate_rps))
            if t >= seconds:
                break
            items.append(Item(len(items), t, draw_length(traffic["prompt_len"], rng),
                              draw_length(traffic["new_tokens"], rng)))
    elif kind == "standing":
        for i in range(int(traffic["requests"])):
            items.append(Item(i, 0.0, draw_length(traffic["prompt_len"], rng),
                              draw_length(traffic["new_tokens"], rng)))
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    return items


def prompt_tokens(items: list[Item], vocab: int, seed: int) -> list[np.ndarray]:
    """Each request's prompt ids, uniform over [0, vocab), from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=it.prompt_len).astype(np.int32) for it in items]
