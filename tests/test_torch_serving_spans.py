"""The serving path's host regions: the engine's enqueue / sync / sample and
the model's mixer / FFN / head ranges in a ``torch.profiler`` capture, named
only for an engine with a tracer on the wall clock, and free of spans.

CPU tests run a reduced jamba (one superblock: seven mamba and one attention
mixer, four MoE and four MLP FFNs) in float32. The card test, marked
``cuda``, runs one superblock at full width and skips elsewhere:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_serving_spans.py
"""

from collections import Counter
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.obs import Tracer
from repro_torch.obs import tracer as tracer_mod
from repro_torch.serving.engine import Engine, Request, ServeConfig

CFG = get_config("jamba_v0_1_52b").reduced(num_superblocks=1)
MIXERS = Counter(f"lm.mixer.{s.mixer}" for s in CFG.superblock)
FFNS = Counter(f"lm.ffn.{s.ffn}" for s in CFG.superblock)
PROGRAM = ("engine.", "lm.")  # the regions' names
LIFECYCLE = {"queue", "prefill", "decode", "respond"}
# host calls that put work on the card's stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


@pytest.fixture(scope="module")
def model():
    return LM(CFG, device="cpu", seed=0)


def serve(model, tracer=None, *, prompts=(9,), new_tokens=4, slots=1, timer=None):
    """Every request due at once; ticks at whole seconds until all finish."""
    eng = Engine(CFG, model, ServeConfig(slots=slots, max_seq=64), tracer=tracer, timer=timer,
                 device="cpu")
    eng.warmup(prompts)
    rng = np.random.default_rng(1)
    for rid, L in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, CFG.vocab_size, L).astype(np.int32),
                           max_new_tokens=new_tokens))
    t = 0.0
    while eng.queue or any(r is not None for r in eng.active):
        eng.tick(now=t)
        t += 1.0
    return eng


def host_events(prof):
    """(user annotations (start, end, name), launch calls (start, end)) on
    the host, in nanoseconds."""
    annotations, launches = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0 or "CUDA" in str(e.device_type()):
            continue
        if e.is_user_annotation():
            annotations.append((start, start + dur, e.name()))
        elif e.name().startswith(LAUNCH_CALLS):
            launches.append((start, start + dur))
    return annotations, launches


def regions(prof) -> list:
    return sorted(a for a in host_events(prof)[0] if a[2].startswith(PROGRAM))


def profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        out = fn()
    return out, prof


def model_regions(n_calls: int) -> Counter:
    want = Counter({"lm.head": n_calls})
    for name, n in (MIXERS + FFNS).items():
        want[name] = n * n_calls
    return want


def idle_by_innermost(annotations, device, lo, hi, *, cut: bool = True) -> dict:
    """Each gap in [lo, hi] between the card's operations by the name of the
    latest-starting annotation open at its midpoint, the first to end of
    those that start together (None: no annotation). With ``cut`` a gap is
    first cut at every annotation's edge inside it, each piece named alone,
    as ``portbench/regions.py`` attributes the benchmark's idle time: a gap
    that spans several annotations (the turn from one tick's sample to the
    next tick's first launch) is shared among them by where the host was.
    Without, the whole gap goes to the annotation at its midpoint."""
    busy = []
    for a, b in sorted(device):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    bounds = sorted({x for r in annotations for x in r[:2]}) if cut else []
    out: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        cuts = [a] + [x for x in bounds if a < x < b] + [b]
        for c, d in zip(cuts, cuts[1:]):
            if d <= c:
                continue
            mid = (c + d) / 2
            holders = [r for r in annotations if r[0] <= mid <= r[1]]
            name = max(holders, key=lambda r: (r[0], -r[1]))[2] if holders else None
            out[name] = out.get(name, 0) + (d - c)
    return out


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled", "disabled"])
def test_each_operation_names_its_regions(model, enabled):
    tr = Tracer(enabled=enabled)
    eng, prof = profiled(lambda: serve(model, tr, prompts=(9, 5), new_tokens=4))
    n_pre = sum(e.phase == "prefill" for e in eng.service_log)
    n_dec = sum(e.phase == "decode" for e in eng.service_log)
    assert (n_pre, n_dec) == (2, 6)
    got = Counter(name for _, _, name in regions(prof))
    # every tick here decodes: one schedule (its admission, the step's inputs) a step
    assert got == model_regions(n_pre + n_dec) + Counter({
        "engine.prefill.enqueue": n_pre, "engine.prefill.sync": n_pre,
        "engine.schedule": n_dec, "engine.decode.enqueue": n_dec, "engine.decode.sync": n_dec,
        "engine.sample": n_dec})
    # a full jamba superblock's step: a mixer and an FFN a layer, the head, schedule, enqueue,
    # sync, sample
    assert sum(model_regions(1).values()) + 4 == 2 * len(CFG.superblock) + 5
    # the regions keep no span: an enabled tracer holds the lifecycle spans alone
    assert {s.name for s in tr.spans} == (LIFECYCLE if enabled else set())


def test_the_models_regions_nest_inside_the_enqueue(model):
    _, prof = profiled(lambda: serve(model, Tracer(), prompts=(9, 5), new_tokens=3, slots=2))
    got = regions(prof)
    enqueues = [r for r in got if r[2].endswith(".enqueue")]
    syncs = [r for r in got if r[2].endswith(".sync")]
    samples = [r for r in got if r[2] == "engine.sample"]
    assert len(enqueues) == len(syncs) == 2 + len(samples) and samples
    for r in got:
        if r[2].startswith("lm."):
            holders = [e for e in enqueues if e[0] <= r[0] and r[1] <= e[1]]
            assert len(holders) == 1, r
    per_step = len(CFG.superblock) * 2 + 1
    for e, s in zip(enqueues, syncs):
        assert e[1] <= s[0] and e[2].rsplit(".", 1)[0] == s[2].rsplit(".", 1)[0]
        assert sum(e[0] <= r[0] and r[1] <= e[1] for r in got if r[2].startswith("lm.")) \
            == per_step
    # each decode step's sample follows its wait for the card
    decode_syncs = [s for s in syncs if s[2] == "engine.decode.sync"]
    assert all(s[1] <= m[0] for s, m in zip(decode_syncs, samples))


@pytest.mark.parametrize("clock", ["no-tracer", "simulated"])
def test_no_region_without_a_tracer_or_on_a_simulated_clock(model, clock):
    def timer(phase, run, *, tokens, occupancy):
        return run(), 1e-3

    if clock == "no-tracer":
        eng, prof = profiled(lambda: serve(model, None, prompts=(9,), new_tokens=3))
    else:
        tr = Tracer()
        eng, prof = profiled(lambda: serve(model, tr, prompts=(9,), new_tokens=3, timer=timer))
        assert {s.name for s in tr.spans} == LIFECYCLE
    assert len(eng.completed) == 1 and regions(prof) == []


def test_without_a_tracer_the_model_is_called_as_before(model, monkeypatch):
    """Wrappers with the parent's fixed signatures still serve, profiler on."""
    prefill, decode_step = model.prefill, model.decode_step
    monkeypatch.setattr(model, "prefill", lambda tokens: prefill(tokens))
    monkeypatch.setattr(model, "decode_step",
                        lambda token, pos, caches: decode_step(token, pos, caches))
    eng, _ = profiled(lambda: serve(model, None, prompts=(9, 5), new_tokens=3))
    assert len(eng.completed) == 2


def test_no_profiler_range_is_entered_while_no_profiler_records(model, monkeypatch):
    entered = []

    class Counting(record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(tracer_mod, "record_function", Counting)
    serve(model, Tracer(), prompts=(9,), new_tokens=3)
    assert entered == []
    profiled(lambda: serve(model, Tracer(), prompts=(9,), new_tokens=3))
    assert "lm.ffn.moe" in entered and "engine.decode.sync" in entered


@pytest.mark.parametrize("mode", ["disabled", "enabled", "profiled"])
def test_tracing_changes_no_output(model, mode):
    ref = serve(model, None, prompts=(9, 5), new_tokens=4)
    if mode == "profiled":
        eng, _ = profiled(lambda: serve(model, Tracer(), prompts=(9, 5), new_tokens=4))
    else:
        eng = serve(model, Tracer(enabled=mode == "enabled"), prompts=(9, 5), new_tokens=4)
    assert [(e.phase, e.occupancy, e.rid, e.tokens, e.compile) for e in eng.service_log] == \
        [(e.phase, e.occupancy, e.rid, e.tokens, e.compile) for e in ref.service_log]
    assert [r.tokens_out for r in eng.completed] == [r.tokens_out for r in ref.completed]


def test_a_region_is_the_shared_no_op_while_no_profiler_records():
    tr = Tracer()
    assert tr.region("lm.head") is tracer_mod.NO_REGION is tracer_mod.no_region("lm.head")
    with tr.region("lm.head"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = tr.region("lm.head")
        with r:
            torch.ones(4).sum()
    assert isinstance(r, record_function) and len(tr) == 0
    assert [name for _, _, name in host_events(prof)[0]] == ["lm.head"]


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_the_models_logits_are_bit_equal_with_regions(model, phase):
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, CFG.vocab_size, (1, 7)))

    def call(tracer):
        logits, caches = model.prefill(tokens, tracer=tracer)
        if phase == "decode":
            logits, _ = model.decode_step(tokens[:, -1:], 6, caches, tracer=tracer)
        return logits

    plain = call(None)
    traced, _ = profiled(lambda: call(Tracer()))
    assert torch.equal(plain, traced)


def test_the_idle_sweep_names_each_gap_by_its_innermost_annotation():
    # tick [0, 200) holds engine.decode.enqueue [0, 100) holding lm.mixer.mamba [10, 40)
    # and lm.ffn.moe [50, 90); engine.decode.sync [100, 130)
    annotations = [(0, 200, "tick"), (0, 100, "engine.decode.enqueue"),
                   (10, 40, "lm.mixer.mamba"), (50, 90, "lm.ffn.moe"),
                   (100, 130, "engine.decode.sync")]
    # the card works in [0, 20), [45, 60) and [95, 130); idle in [20, 45), [60, 95), [130, 250)
    device = [(0, 20), (45, 55), (50, 60), (95, 130)]
    got = idle_by_innermost(annotations, device, 0, 250)
    # cut at the annotations' edges: [20, 40) the mamba mixer and [40, 45) the enqueue;
    # [60, 90) the MoE and [90, 95) the enqueue; [130, 200) the tick and [200, 250) none
    assert got == {"lm.mixer.mamba": 20, "engine.decode.enqueue": 10, "lm.ffn.moe": 30,
                   "tick": 70, None: 50}
    # whole gaps by their midpoints: [20, 45) at 32.5 the mamba mixer; [60, 95) at 77.5 the
    # MoE; [130, 250) at 190 the tick
    assert idle_by_innermost(annotations, device, 0, 250, cut=False) == {
        "lm.mixer.mamba": 25, "lm.ffn.moe": 35, "tick": 120}
    for cut in (True, False):
        assert idle_by_innermost(annotations, [], 300, 400, cut=cut) == {None: 100}


@pytest.mark.cuda
def test_a_traced_decode_on_the_card_names_its_idle_time_and_launches_alike():
    """One jamba superblock at full width, one slot: twelve decode steps under
    the profiler, each tick in a ``tick`` range as the benchmark's traced run
    takes them, with a disabled tracer; then four with none. Each step
    replays the graphs captured at warm-up: its regions are the graphs
    (``lm.graph``) and the eager pieces between them. At least 90% of the
    idle time inside ticks falls in the program's regions, gaps cut at the
    annotations' edges; the share by whole gaps at their midpoints is
    printed beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a; no CPU mode)")
    cfg = replace(get_config("jamba_v0_1_52b"), num_superblocks=1)
    model = LM(cfg, device="cuda", seed=0)
    eng = Engine(cfg, model, ServeConfig(slots=1, max_seq=512), device="cuda")
    eng.warmup([128])
    graphed = Counter({"lm.graph": model._decode_graphs.graphs, "lm.mixer.attn": MIXERS[
        "lm.mixer.attn"], "lm.moe.route": FFNS["lm.ffn.moe"], "lm.head": 1})
    replays = model.decode_graph_steps
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the profiler's own set-up, outside the stretch
        torch.ones(16, device="cuda").sum()
        torch.cuda.synchronize()
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 128).astype(np.int32)
    shares = {}
    for tracer, steps in ((Tracer(enabled=False), 12), (None, 4)):
        eng.tracer = tracer
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=40))
        eng.tick(now=0.0)  # the prefill and the first step, not profiled
        with profile(activities=activities) as prof:
            for k in range(steps):
                with record_function("tick"):
                    eng.tick(now=1.0 + k)
        eng.drain()
        annotations, launches = host_events(prof)
        ticks = [a for a in annotations if a[2] == "tick"]
        assert len(ticks) == steps
        named = [a for a in annotations if a[2].startswith(PROGRAM)]
        if tracer is None:
            assert named == []
            continue
        enqueues = [a for a in named if a[2] == "engine.decode.enqueue"]
        assert len(enqueues) == steps
        for a, b, _ in enqueues:
            assert Counter(n for c, d, n in named if a <= c and d <= b
                           and n.startswith("lm.")) == graphed
        mids = [(a + b) / 2 for a, b in launches]
        per_step = [sum(a <= m <= b for m in mids) for a, b, _ in enqueues]
        assert per_step[0] > 0 and len(set(per_step)) == 1, per_step
        device = [(e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if "CUDA" in str(e.device_type()) and not e.is_user_annotation()
                  and e.duration_ns() > 0]
        # both sweeps: gaps cut at annotation edges (as regions.py), and whole gaps by midpoint
        for cut in (True, False):
            idle = idle_by_innermost(annotations, device, ticks[0][0], ticks[-1][1], cut=cut)
            inside = sum(v for k, v in idle.items() if k is not None)
            in_regions = sum(v for k, v in idle.items()
                             if k is not None and k.startswith(PROGRAM))
            shares["cut" if cut else "midpoint"] = (in_regions / inside, idle)
        print(f"idle inside ticks in the program's regions: {shares}")
    # every step after the warm-up replayed: the two prefills' first steps and the rest
    assert eng.completed and model.decode_graph_steps - replays == 2 * 39
    assert shares["cut"][0] >= 0.9, shares
