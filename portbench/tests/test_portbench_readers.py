"""The metric arithmetic: p95 over every request with failures as missing,
tokens stamped inside the window over its seconds, the gaps between tokens,
and the readers found by name."""

import math

import pytest

from portbench import derive, metrics
from portbench.cell import expand_model
from portbench.stats import percentile, spread
from portbench.window import ReqRecord, RunRecord

MODEL = expand_model({"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
                      "vocab_size": 256, "superblock": [["attn", "mlp"]], "num_superblocks": 2,
                      "gated_mlp": False})


def rec(due, done, stamps=()):
    r = ReqRecord(rid=0, due_s=due, prompt_len=4, new_tokens=len(stamps) or 1)
    r.t_done = done
    r.stamps = list(stamps)
    return r


def test_percentile_is_linear_between_order_statistics():
    assert percentile(range(101), 95) == pytest.approx(95.0)
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    assert percentile([], 95) is None


def test_a_failure_is_missing_every_limit():
    v = [0.1] * 94 + [math.inf] * 6
    assert math.isinf(percentile(v, 95))
    assert percentile([0.1] * 96 + [math.inf] * 4, 95) == pytest.approx(0.1)


def test_latency_p95_counts_the_wait_from_the_due_time_and_every_request():
    reqs = [rec(i * 0.1, i * 0.1 + 0.02 * (i + 1)) for i in range(100)]
    run = RunRecord(seconds=10, model=MODEL, requests=reqs, events=[])
    lat = sorted(0.02 * (i + 1) for i in range(100))
    assert derive.due_to_done_p95_ms(run) == pytest.approx(1e3 * (lat[94] + 0.05 * (lat[95] - lat[94])))
    reqs[3].t_done = None  # one of 100 never finished: still read
    assert derive.due_to_done_p95_ms(run) is not None
    for r in reqs[:6]:
        r.t_done = None
    assert derive.due_to_done_p95_ms(run) is None  # more than 5% failed: no finite p95


def test_tokens_and_gaps_count_inside_the_window_only():
    a = rec(0.0, 2.5, stamps=[0.5, 1.0, 1.5, 2.5])
    b = rec(0.0, 1.9, stamps=[1.7, 1.9])
    run = RunRecord(seconds=2.0, model=MODEL, requests=[a, b], events=[])
    assert derive.tokens_per_s(run) == pytest.approx(5 / 2.0)  # 2.5 lies past the close
    gaps = [0.5, 0.5, 0.2]  # the gap ending at 2.5 does not count
    assert derive.token_gap_p95_ms(run) == pytest.approx(1e3 * percentile(gaps, 95))
    run.untraced_s = 1.2  # a traced run: only before its profiled stretch
    assert derive.tokens_per_s(run) == pytest.approx(2 / 1.2)


def test_service_means_and_mfu_read_the_events_inside_the_window():
    evs = [dict(t=0.1, phase="prefill", duration_s=0.03, occupancy=1, tokens=10, pos=None),
           dict(t=0.2, phase="decode", duration_s=0.01, occupancy=1, tokens=1, pos=10),
           dict(t=0.95, phase="prefill", duration_s=0.1, occupancy=1, tokens=12, pos=None)]
    run = RunRecord(seconds=1.0, model=MODEL, requests=[], events=evs)
    assert derive.mean_service_ms(run, "prefill") == pytest.approx(30.0)  # the last ends late
    assert derive.mean_service_ms(run, "decode") == pytest.approx(10.0)
    from portbench.counts.model_flops import decode_flops, prefill_flops
    from portbench.counts.peaks import BF16_FLOPS
    want = (prefill_flops(MODEL, 10) + decode_flops(MODEL, 10)) / BF16_FLOPS * 100
    assert derive.mfu_pct(run) == pytest.approx(want)
    run.untraced_s = 0.15  # a traced run: only before its profiled stretch
    assert derive.mfu_pct(run) == pytest.approx(prefill_flops(MODEL, 10) / 0.15 / BF16_FLOPS * 100)


def test_device_readers_read_nothing_without_a_profile():
    run = RunRecord(seconds=1.0, model=MODEL, requests=[], events=[])
    assert derive.idle_pct(run) is None
    assert derive.flash_roofline_pct(run, "flash_attention_kernel") is None
    assert metrics.read_all([{"name": "device_idle.onepass", "unit": "%"}], run) == {}


def test_flash_roofline_sums_bounds_over_device_time():
    from portbench.counts.flash import flash_bound_s
    prof = {"busy_s": 0.5, "window_s": 1.0,
            "kernels": {"void flash_attention_kernel<4>(x)": (4, 2e-3), "gemm": (9, 1.0)},
            "events": [dict(phase="prefill", tokens=100), dict(phase="prefill", tokens=50)]}
    run = RunRecord(seconds=1.0, model=MODEL, requests=[], events=[], profile=prof)
    want = 2 * (flash_bound_s(100, 2, 1, 4) + flash_bound_s(50, 2, 1, 4)) / 2e-3 * 100
    assert derive.flash_roofline_pct(run, "flash_attention_kernel") == pytest.approx(want)
    assert derive.idle_pct(run) == pytest.approx(50.0)
    prof["kernels"]["void flash_attention_kernel<4>(x)"] = (3, 2e-3)  # a launch missing
    assert derive.flash_roofline_pct(run, "flash_attention_kernel") is None


def test_spread_is_the_interquartile_distance_over_the_median():
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_every_metric_of_the_benchmark_has_a_reader():
    import json
    from pathlib import Path
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metrics.reader(m["name"]))
