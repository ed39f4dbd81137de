"""The traffic generator: reproducible from its seeds, following its
distributions, and the schedule independent of ``--seed``."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic as gen

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_the_schedule_repeats_and_ignores_the_run_seed():
    t = load("onepass")
    a = gen.schedule(t, seconds=20, rate_rps=21)
    b = gen.schedule(t, seconds=20, rate_rps=21)
    assert a == b
    assert gen.prompt_tokens(a, 49152, 5)[3].tolist() == gen.prompt_tokens(a, 49152, 5)[3].tolist()
    assert gen.prompt_tokens(a, 49152, 5)[3].tolist() != gen.prompt_tokens(a, 49152, 6)[3].tolist()


def test_a_longer_window_extends_the_shorter_one():
    t = load("onepass")
    short, long = gen.schedule(t, seconds=10, rate_rps=21), gen.schedule(t, seconds=51, rate_rps=21)
    assert long[:len(short)] == short and len(long) > len(short)


def test_poisson_arrivals_at_the_rate_within_the_window():
    t = load("onepass")
    items = gen.schedule(t, seconds=400, rate_rps=21)
    due = np.array([it.due_s for it in items])
    assert np.all(np.diff(due) > 0) and due[0] > 0 and due[-1] < 400
    assert abs(len(items) / 400 - 21) < 4 * math.sqrt(21 / 400)  # four standard errors
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - 1) < 0.1  # exponential: SCV 1


def test_lengths_follow_their_distributions():
    t = load("onepass")
    items = gen.schedule(t, seconds=400, rate_rps=21)
    L = np.array([it.prompt_len for it in items])
    assert L.min() >= 1536 and L.max() <= 4096
    # log-uniform: the median near the geometric mean of the ends
    assert abs(np.median(L) / math.sqrt(1536 * 4097) - 1) < 0.05
    assert all(it.new_tokens == 1 for it in items)
    chat = gen.schedule(load("chat"), seconds=51)
    assert len(chat) == load("chat")["requests"] and all(it.due_s == 0.0 for it in chat)
    out = np.array([it.new_tokens for it in chat])
    assert out.min() >= 32 and out.max() <= 160


def test_tokens_lie_in_the_vocabulary():
    items = gen.schedule(load("chat"), seconds=51)
    for ids in gen.prompt_tokens(items, 300, 2**31 + 9):
        assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 300


@pytest.mark.parametrize("spec", [{"dist": "uniform", "min": 5, "max": 3},
                                  {"dist": "zipf", "min": 1, "max": 3}])
def test_a_bad_length_spec_is_refused(spec):
    with pytest.raises(ValueError):
        gen.draw_length(spec, np.random.default_rng(0))


def test_poisson_needs_a_rate():
    with pytest.raises(ValueError):
        gen.schedule(load("onepass"), seconds=5)
