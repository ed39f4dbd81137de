"""The decode step replayed as CUDA graphs (``models/decode_graph.py``).

CPU tests hold the split of the step (``decode_plan``) and the eager step's
profiler ranges as functions of the layer specs for every family, the
kernel wrappers' counters under capture and replay (``kernels/launches.py``),
and check that a CPU call, a sharded call and a call with other caches take
the eager path. The card tests, marked ``cuda``, capture reduced models in
bf16 and hold the replayed step against the eager one, down to the kernels
the card runs, and skip elsewhere:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph.py
"""

from dataclasses import replace
import re
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.kernels import launches as L
from repro_torch.models import moe
from repro_torch.models.decode_graph import Piece, decode_pieces, decode_plan, engages
from repro_torch.models.lm import LM
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.sharding.partition import use_rules

# host calls that put work on the card's stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
MAX_LAUNCHES = 130  # launch calls of a replayed step of jamba's superblock


def specs(arch: str, superblocks: int = 1):
    return replace(get_config(arch), num_superblocks=superblocks).superblock * superblocks


def runs(plan) -> list:
    """The plan as (captured, first piece, last piece) runs, pieces as "kind n"."""
    def name(p):
        return p.kind if p.layer < 0 else f"{p.kind} {p.layer}"
    return [(captured, name(pieces[0]), name(pieces[-1])) for captured, pieces in plan]


def test_jambas_superblock_splits_at_its_routing_and_attention():
    assert runs(decode_plan(specs("jamba_v0_1_52b"))) == [
        (True, "embed", "norm2 1"), (False, "route 1", "route 1"),
        (True, "experts 1", "norm2 3"), (False, "route 3", "route 3"),
        (True, "experts 3", "norm1 4"), (False, "mixer 4", "mixer 4"),
        (True, "ffn 4", "norm2 5"), (False, "route 5", "route 5"),
        (True, "experts 5", "norm2 7"), (False, "route 7", "route 7"),
        (True, "experts 7", "experts 7"), (False, "head", "head")]


@pytest.mark.parametrize("arch,superblocks,graphs,eager", [
    ("jamba_v0_1_52b", 2, 11, {"route": 8, "mixer": 2, "head": 1}),  # the benchmark's cut
    ("jamba_v0_1_52b", 4, 21, {"route": 16, "mixer": 4, "head": 1}),
    ("starcoder2_3b", 30, 31, {"mixer": 30, "head": 1}),
    ("gemma2_9b", 21, 43, {"mixer": 42, "head": 1}),
    ("xlstm_1_3b", 6, 1, {"head": 1}),
    ("dbrx_132b", 40, 81, {"mixer": 40, "route": 40, "head": 1}),
    ("arctic_480b", 35, 71, {"mixer": 35, "route": 35, "head": 1}),
])
def test_the_plan_captures_all_but_attention_routing_and_the_head(arch, superblocks, graphs,
                                                                   eager):
    layers = specs(arch, superblocks)
    plan = decode_plan(layers)
    # every piece once, in the step's order; no two captured runs side by side
    assert tuple(p for _, pieces in plan for p in pieces) == decode_pieces(layers)
    assert all(not (a[0] and b[0]) for a, b in zip(plan, plan[1:]))
    assert sum(captured for captured, _ in plan) == graphs
    kinds = [pieces[0].kind for captured, pieces in plan if not captured]
    assert {k: kinds.count(k) for k in set(kinds)} == eager
    assert all(len(pieces) == 1 for captured, pieces in plan if not captured)
    for captured, pieces in plan:
        for p in pieces:
            if p.kind == "mixer":  # an attention mixer reads the position on the host
                assert captured == (not layers[p.layer].mixer.startswith("attn")), p
    # a layer without an FFN has no FFN piece; a MoE's routing sits between its norm and experts
    n_ffn = sum(s.ffn != "none" for s in layers)
    n_moe = sum(s.ffn.startswith("moe") for s in layers)
    assert len(decode_pieces(layers)) == 2 + 2 * len(layers) + n_ffn + 2 * n_moe


def test_a_layer_without_an_ffn_hands_its_mixer_on():
    assert decode_pieces(specs("xlstm_1_3b"))[:5] == (
        Piece("embed", -1), Piece("norm1", 0), Piece("mixer", 0), Piece("norm1", 1),
        Piece("mixer", 1))


ARCHS = ["jamba_v0_1_52b", "starcoder2_3b", "gemma2_9b", "xlstm_1_3b", "arctic_480b",
         "seamless_m4t_large_v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_eager_step_runs_each_layers_pieces_in_its_mixers_and_ffns_ranges(arch):
    """The eager step's profiler ranges: the embedding in none, each layer's
    norm1 and mixer in ``lm.mixer.<mixer>``, the rest of the layer in
    ``lm.ffn.<ffn>`` (none for a layer without one), the head in
    ``lm.head``; every piece once, in the step's order."""
    model = LM(get_config(arch).reduced(num_superblocks=2), device="cpu")
    specs = model.layer_specs
    ranges = model._decode_ranges
    assert tuple(p for _, pieces in ranges for p in pieces) == decode_pieces(specs)
    want = [None]
    for spec in specs:
        want.append(f"lm.mixer.{spec.mixer}")
        if spec.ffn != "none":
            want.append(f"lm.ffn.{spec.ffn}")
    assert [name for name, _ in ranges] == want + ["lm.head"]
    assert ranges[0][1] == (Piece("embed", -1),) and ranges[-1][1] == (Piece("head", -1),)
    for name, pieces in ranges[1:-1]:
        assert len({p.layer for p in pieces}) == 1
        kinds = {p.kind for p in pieces}
        assert kinds == {"norm1", "mixer"} if name.startswith("lm.mixer.") else \
            kinds in ({"ffn"}, {"norm2", "route", "experts"})


def test_the_routing_piece_calls_moe_route_as_installed_at_call_time(monkeypatch):
    cfg = get_config("jamba_v0_1_52b").reduced(num_superblocks=1)
    model = LM(cfg, device="cpu", seed=0)
    caches = model.init_caches(1, 16)
    seen = []
    route = moe.route

    def kept(*args, **kw):
        probs, idx = route(*args, **kw)
        seen.append(idx)
        return probs, idx

    monkeypatch.setattr(moe, "route", kept)
    s = {"token": torch.zeros((1, 1), dtype=torch.long)}
    with torch.inference_mode():
        for p in decode_pieces(model.layer_specs):
            model._decode_piece(p, s, caches, 0, None)
    assert len(seen) == sum(spec.ffn == "moe" for spec in cfg.superblock) == 4


def cloned(caches: tuple) -> tuple:
    return tuple({name: leaf.clone() for name, leaf in c.items()} for c in caches)


def fake_token(device: str, batch: int = 1):
    return SimpleNamespace(device=torch.device(device), shape=(batch, 1))


def test_only_a_call_on_the_card_with_the_captured_caches_and_no_rules_engages():
    caches = ({"h": None},)
    graphs = SimpleNamespace(caches=caches, batch=1)
    assert engages(graphs, fake_token("cuda"), caches)
    assert not engages(None, fake_token("cuda"), caches)
    assert not engages(graphs, fake_token("cpu"), caches)  # a CPU call
    assert not engages(graphs, fake_token("cuda"), ({"h": None},))  # other caches
    assert not engages(graphs, fake_token("cuda", 2), caches)  # another batch
    with use_rules(object()):  # a sharded call
        assert not engages(graphs, fake_token("cuda"), caches)


@pytest.fixture
def counter():
    """A wrapper with a launch counter, and a switch for whether the current
    stream captures (the CPU build has no capture)."""
    def op():
        pass
    op.launches = 0
    state = {"capturing": False}
    return op, state


@pytest.fixture
def capturing(monkeypatch, counter):
    _, state = counter
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state["capturing"])
    return state


def test_a_launch_counts_in_the_wrapper_outside_capture(counter, capturing):
    op, _ = counter
    L.launched(op)
    L.launched(op)
    assert op.launches == 2


def test_a_captured_launch_counts_in_the_capture_and_in_every_replay(counter, capturing):
    op, _ = counter
    with L.captured() as tally:
        capturing["capturing"] = True
        L.launched(op)
        L.launched(op)
        capturing["capturing"] = False
        L.launched(op)  # a launch beside the capture, not in it
    assert op.launches == 1 and tally == Counter({op: 2})
    for _ in range(3):
        L.replayed(tally)
    assert op.launches == 1 + 3 * 2


def test_a_launch_under_capture_counts_in_the_innermost_tally_or_nowhere(counter, capturing):
    op, _ = counter
    capturing["capturing"] = True
    L.launched(op)  # a capture no one tallies: launches nothing, counts nothing
    with L.captured() as outer:
        with L.captured() as inner:
            L.launched(op)
        L.launched(op)
    assert op.launches == 0 and outer == Counter({op: 1}) and inner == Counter({op: 1})


def test_every_counting_wrapper_is_in_the_registry():
    """Each wrapper whose module counts with ``launched`` is in
    ``launches.counted()``, which the card's smoke run reads; each starts
    from a whole count."""
    kernels = Path(L.__file__).parent
    called = {name for path in kernels.glob("*/ops.py")
              for name in re.findall(r"launched\((\w+)\)", path.read_text())}
    names = [op.__name__ for op in L.counted()]
    assert len(names) == len(set(names)) == 11 and set(names) == called
    assert all(isinstance(op.launches, int) for op in L.counted())


def test_a_cpu_call_runs_the_eager_step():
    cfg = get_config("jamba_v0_1_52b").reduced(num_superblocks=1)
    model = LM(cfg, device="cpu", seed=0)
    caches = model.init_caches(1, 16)
    want, _ = model.decode_step(torch.ones((1, 1), dtype=torch.long), 0,
                                model.init_caches(1, 16))

    class Refused:
        batch = 1

        def __init__(self):
            self.caches = caches

        def run(self, *args):
            raise AssertionError("a CPU call replayed graphs")

    model._decode_graphs = Refused()
    got, _ = model.decode_step(torch.ones((1, 1), dtype=torch.long), 0, caches)
    assert torch.equal(got, want)
    assert (model.decode_graph_steps, model.decode_eager_steps) == (0, 0)
    with pytest.raises(ValueError, match="CUDA graphs"):
        model.capture_decode(caches)
    model._decode_graphs = Refused()
    model.to(torch.float32)  # new storage for the parameters: the graphs go
    assert model._decode_graphs is None


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a; no CPU mode)")


def card_model(arch: str):
    cfg = replace(get_config(arch).reduced(num_superblocks=1), dtype="bfloat16")
    return cfg, LM(cfg, device="cuda", seed=0)


def captured(arch: str, prompt_len: int = 37, cache_len: int = 128):
    """A reduced model in bf16 behind a one-slot engine (warm-up captures its
    decode step against the engine's caches), one prompt prefilled into the
    slot, and an eager copy of those caches. Returns (cfg, model, engine,
    the copy, the first token)."""
    cfg, model = card_model(arch)
    eng = Engine(cfg, model, ServeConfig(slots=1, max_seq=cache_len), device="cuda")
    eng.warmup([prompt_len])
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                                (1, prompt_len)),
                             device="cuda")
    logits, one = model.prefill(prompt)
    eng._write_slot(one, 0)
    copy = cloned(eng.caches)
    return cfg, model, eng, copy, logits[:, -1:].argmax(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "starcoder2_3b", "gemma2_9b", "xlstm_1_3b"])
def test_the_replayed_step_is_the_eager_step_over_64_greedy_steps(card, arch):
    """Bit-equal logits and the same tokens (gemma2's ring of 8 wraps many
    times), every call counted, and a logits tensor of its own each step."""
    cfg, model, eng, copy, first = captured(arch)
    graphs = model._decode_graphs
    assert graphs is not None and graphs.caches is eng.caches
    tok_g = tok_e = first
    kept, values = [], []
    g0, e0 = model.decode_graph_steps, model.decode_eager_steps
    for k in range(64):
        pos = 37 + k
        got, _ = model.decode_step(tok_g, pos, eng.caches)
        want, _ = model.decode_step(tok_e, pos, copy)
        assert torch.equal(got, want), (arch, k, float((got.float() - want.float()).norm()
                                                        / want.float().norm()))
        tok_g, tok_e = got[:, -1:].argmax(-1), want[:, -1:].argmax(-1)
        assert torch.equal(tok_g, tok_e)
        kept.append(got)
        values.append(got.clone())
    assert (model.decode_graph_steps - g0, model.decode_eager_steps - e0) == (64, 64)
    assert len({t.data_ptr() for t in kept}) == 64
    assert all(torch.equal(a, b) for a, b in zip(kept, values))  # no step wrote an earlier one's
    for a, b in zip(eng.caches, copy):  # the states and caches the graphs wrote in place
        assert all(torch.equal(a[name], b[name]) for name in a)


@pytest.mark.cuda
def test_a_route_installed_after_capture_is_called_and_its_experts_dispatched(card,
                                                                            monkeypatch):
    """As the benchmark installs its route after warm-up: called once a MoE
    layer a step on the step's real inputs; a route that picks the least
    probable experts moves the replayed step exactly as it moves the eager
    one."""
    cfg, model, eng, copy, tok = captured("jamba_v0_1_52b")
    n_moe = sum(spec.ffn == "moe" for spec in cfg.superblock)
    route, seen = moe.route, []

    def least(p, xt, cfg_):
        probs, _ = route(p, xt, cfg_)
        idx = torch.topk(probs, cfg_.num_experts_per_tok, dim=-1, largest=False).indices
        seen.append((xt.clone(), idx))
        return probs, idx

    plain, _ = model.decode_step(tok, 37, cloned(eng.caches))
    monkeypatch.setattr(moe, "route", least)
    got, _ = model.decode_step(tok, 37, eng.caches)
    graph_calls, seen[:] = list(seen), []
    want, _ = model.decode_step(tok, 37, copy)
    assert len(graph_calls) == len(seen) == n_moe
    for (xg, ig), (xe, ie) in zip(graph_calls, seen):
        assert torch.equal(xg, xe) and torch.equal(ig, ie)  # the real inputs, the same choice
    assert torch.equal(got, want) and not torch.equal(got, plain)


# the hand-written kernels a jamba decode step runs, by their names on the card
HAND_WRITTEN = re.compile(r"\b(rmsnorm_kernel|ssm_scan_kernel|decode_bf16_kernel|"
                          r"decode_merge_kernel)\b")


def per_step(prof) -> list:
    """Each ``step`` annotation's (launch calls on the host, kernels on the
    card by name): a launch call by its midpoint, a kernel by its midpoint
    (each step waits for the card before it starts and before it ends, so
    its kernels run inside it). Copies and memsets are not counted as
    kernels, nor the kernels CUDA runs a graph's copies as
    (``memcpy32_post``: the mamba states' in-place writes)."""
    steps, launches, kernels = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        mid = start + dur / 2
        if "CUDA" in str(e.device_type()):
            if not e.is_user_annotation() and not e.name().lower().startswith(("memcpy",
                                                                               "memset")):
                kernels.append((mid, e.name()))
        elif e.is_user_annotation() and e.name() == "step":
            steps.append((start, start + dur))
        elif e.name().startswith(LAUNCH_CALLS):
            launches.append(mid)
    return [(sum(a <= m <= b for m in launches),
             Counter(name for m, name in kernels if a <= m <= b)) for a, b in sorted(steps)]


def by_kernel(kernels: Counter) -> Counter:
    """The hand-written kernels of ``kernels`` by name."""
    out = Counter()
    for name, n in kernels.items():
        m = HAND_WRITTEN.search(name)
        if m:
            out[m.group(1)] += n
    return out


@pytest.mark.cuda
def test_a_replayed_step_makes_few_launch_calls_and_counts_every_kernel(card):
    """Jamba's superblock under the profiler: each replayed step makes the
    same launch calls, at most MAX_LAUNCHES, and runs on the card the same
    kernels as an eager step, each as often; the hand-written ones as often
    as the wrappers' counters say, which move as much a step either way.
    Capture ran nothing: it left the caches and the counters as they were."""
    cfg, model, eng, copy, tok = captured("jamba_v0_1_52b")
    before = {op: op.launches for op in L.counted()}
    model.capture_decode(eng.caches)
    assert {op: op.launches for op in L.counted()} == before
    for a, b in zip(eng.caches, copy):
        assert all(torch.equal(a[name], b[name]) for name in a)

    def stepped(caches, steps=6):
        start = {op.__name__: op.launches for op in L.counted()}
        t = tok
        for k in range(steps):
            torch.cuda.synchronize()
            with record_function("step"):
                t = model.decode_step(t, 37 + k, caches)[0][:, -1:].argmax(-1)
                torch.cuda.synchronize()
        return {op.__name__: op.launches - start[op.__name__] for op in L.counted()}

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        graphed = stepped(eng.caches)
    replayed = per_step(prof)
    with profile(activities=activities) as prof:
        eager = stepped(copy)
    plain = per_step(prof)
    assert len(replayed) == len(plain) == 6
    calls = [n for n, _ in replayed]
    assert len(set(calls)) == 1 and calls[0] <= MAX_LAUNCHES, calls
    assert plain[0][0] > 2 * calls[0]
    n_mamba = sum(spec.mixer == "mamba" for spec in cfg.superblock)
    assert graphed == eager and eager["ssm_scan"] == 6 * n_mamba
    assert eager["rmsnorm"] + eager["rmsnorm_add"] == 6 * (2 * len(cfg.superblock) + 1)
    for (_, got), (_, want) in zip(replayed, plain):
        assert got == want, (got - want, want - got)  # every kernel, by name and count
        mine = by_kernel(got)
        assert mine["ssm_scan_kernel"] == n_mamba > 0
        assert mine["rmsnorm_kernel"] == 2 * len(cfg.superblock) + 1
        assert mine["decode_bf16_kernel"] == eager["decode_attention"] // 6 > 0
