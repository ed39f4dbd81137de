"""``regions.py``: launch calls and idle time by the program's host regions,
on synthetic intervals, and held against ``devtrace``'s idle gaps."""

from types import SimpleNamespace

import pytest

from portbench import devtrace, regions


def test_launches_count_by_midpoint_in_every_annotation_that_holds_them():
    # engine.decode.enqueue [0, 100) holds lm.mixer.mamba [10, 40) and lm.ffn.moe [50, 90)
    ann = [(0, 100, "engine.decode.enqueue"), (10, 40, "lm.mixer.mamba"),
           (50, 90, "lm.ffn.moe"), (200, 300, "engine.decode.enqueue"),
           (210, 240, "lm.mixer.mamba"), (250, 290, "lm.ffn.moe")]
    launches = [(12, 14), (20, 22), (55, 57), (95, 97),  # 4 in the first step
                (215, 217), (255, 257), (258, 260), (292, 294),  # 4 in the second
                (38, 44),  # midpoint 41: the enqueue's own
                (150, 152)]  # between the steps: in none
    got = regions.attribute(ann, launches, [], 0, 300)
    enq = got["engine.decode.enqueue"]
    assert (enq["calls"], enq["launches"], enq["launches_min"], enq["launches_max"]) == \
        (2, 9, 4, 5)
    assert enq["host_s"] == pytest.approx(200e-9)
    assert got["lm.mixer.mamba"]["launches"] == 3 and got["lm.ffn.moe"]["launches"] == 3
    assert got[None]["launches"] == 1


def test_idle_time_goes_to_the_innermost_annotation_cut_at_its_edges():
    ann = [(0, 100, "engine.decode.enqueue"), (10, 40, "lm.mixer.mamba"),
           (50, 90, "lm.ffn.moe"), (100, 130, "engine.decode.sync")]
    # the card works in [0, 20), [45, 60) and [95, 130); idle in [20, 45), [60, 95), [130, 160)
    device = [(0, 20), (45, 55), (50, 60), (95, 130)]
    got = regions.attribute(ann, [], device, 0, 160)
    idle = {k: round(v["idle_s"] * 1e9, 6) for k, v in got.items()}
    assert idle == {None: 30.0, "engine.decode.enqueue": 5 + 5,
                    "lm.mixer.mamba": 20.0, "lm.ffn.moe": 30.0, "engine.decode.sync": 0.0}
    assert sum(idle.values()) == 25 + 35 + 30


def _event(start, end, name, *, device=False, annotation=False):
    return SimpleNamespace(start_ns=lambda: start, duration_ns=lambda: end - start,
                           name=lambda: name, is_user_annotation=lambda: annotation,
                           device_type=lambda: "DeviceType.CUDA" if device else "DeviceType.CPU")


def _stretch(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return SimpleNamespace(prof=prof, t_start=0.0, t_stop=1.0, events_from=0, events_to=1)


def test_the_idle_time_equals_devtraces_gaps_where_no_gap_crosses_an_edge():
    events = [
        _event(0, 400, "portbench.tick", annotation=True),
        _event(0, 200, "engine.decode.enqueue", annotation=True),
        _event(10, 100, "lm.mixer.mamba", annotation=True),
        _event(110, 190, "lm.ffn.moe", annotation=True),
        _event(200, 300, "engine.decode.sync", annotation=True),
        _event(300, 400, "engine.sample", annotation=True),
        _event(20, 22, "cudaLaunchKernel"), _event(120, 122, "cudaLaunchKernel"),
        _event(0, 400, "portbench.tick", device=True, annotation=True),  # the mirror
        _event(0, 30, "kernel_a", device=True), _event(70, 130, "kernel_b", device=True),
        _event(150, 250, "kernel_c", device=True), _event(300, 395, "kernel_d", device=True),
    ]
    summary = devtrace.summarize(_stretch(events))
    got = regions.from_profile(_stretch(events).prof)
    # gaps [30, 70) mamba, [130, 150) moe, [250, 300) sync, [395, 400) sample
    assert dict(summary["idle_gaps"]) == pytest.approx(
        {k: v["idle_s"] for k, v in got.items() if v["idle_s"] > 0})
    assert got["engine.decode.enqueue"]["launches"] == 2
    assert got["portbench.tick"]["idle_s"] == 0.0


def test_a_program_without_regions_has_no_region_cost(monkeypatch):
    import repro_torch.obs

    class Plain:  # the parent's tracer: spans, no regions
        def __init__(self, *, enabled=True):
            self.enabled = enabled

    assert set(regions.region_cost_us(10)) == {"off", "on"}
    monkeypatch.setattr(repro_torch.obs, "Tracer", Plain)
    assert regions.region_cost_us(10) is None


def test_a_profile_with_no_device_operation_reads_as_nothing():
    events = [_event(0, 10, "engine.decode.enqueue", annotation=True)]
    assert regions.from_profile(_stretch(events).prof) is None
