#!/usr/bin/env python3
"""The port's benchmark: one cell, one seed, one window.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Set-up builds the program's kernels (only the first run of a checkout
compiles; the build cache is ``src/repro_torch/_build/``), draws the model's
weights on the card from the seed and warms the cell's shapes; the window
then drives ``repro_torch``'s serving engine on the wall clock
(``window.py``) for ``--seconds``; after it the program's state is freed and a
sample of what it served is held against the plain fp32 reference
(``check.py``). The last line of standard output is the result, one JSON
object; each compared number and its limit are the last lines of standard
error and the result's last key. ``--trace 1`` profiles a steady stretch of
the window and reports the per-layer metrics instead of the end-to-end ones.

Not for the benchmark's own runs: ``--control 1`` puts the fp8 control in
the program's place for the comparison (how the limits were set; see
``check.py``): ``correct`` and ``checks`` are then the control's, and
``program_checks`` holds the program's readings of the same run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import replace  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
# every kernel and build cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)  # the harness's modules import as portbench.*
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench import check as checks  # noqa: E402
from portbench import metrics as readers  # noqa: E402
from portbench import traffic as gen  # noqa: E402
from portbench.cell import Cell, load_cell, round_up  # noqa: E402
from portbench.window import ReqRecord, RunRecord, capture_logits, drive  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NO_READING = 1e30  # a compared number that could not be read fails its limit
SERVING_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def program_config(cell: Cell):
    """The program's configuration for the cell, checked against the file's
    model block key by key, so the reference and the program run one
    architecture."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    conf = cell.config
    cfg = replace(get_config(conf["program_config"]), **conf.get("program_overrides", {}))
    m = conf["model"]
    wrong = []
    for key, want in m.items():
        if key == "superblock":
            have = [[s.mixer, s.ffn] for s in cfg.superblock]
            want = [list(s) for s in want]
        elif key == "mamba_dt_rank":
            have = ssm._dt_rank(cfg)
        elif key == "head_dim":
            have = cfg.resolved_head_dim
        else:
            have = getattr(cfg, key)
        if have != want:
            wrong.append(f"{key}: file {want!r}, program {have!r}")
    if cfg.attn_softcap or cfg.final_softcap or any(
            s.mixer not in ("attn", "mamba") or s.ffn not in ("mlp", "moe")
            for s in cfg.superblock):
        wrong.append("the reference covers attn / mamba mixers and mlp / moe FFNs without soft-caps")
    if wrong:
        raise ValueError(f"{cell.name}: the program's configuration differs from "
                         f"{conf['name']}'s file: " + "; ".join(wrong))
    return cfg


def requests_for(cell: Cell, seed: int, seconds: float, rate: float | None) -> list[ReqRecord]:
    """The window's requests: the traffic's trace at ``rate`` (requests a
    second, an open loop), the prompts' tokens from the seed."""
    items = gen.schedule(cell.traffic, seconds=seconds, rate_rps=rate)
    prompts = gen.prompt_tokens(items, cell.model["vocab_size"], seed)
    return [ReqRecord(it.rid, it.due_s, it.prompt_len, it.new_tokens, prompt=p)
            for it, p in zip(items, prompts)]


def warm_lengths(traffic: dict) -> list[int]:
    """Prompt lengths the warm-up prefills: the traffic's longest, shortest
    and one between, so the card's memory pool holds blocks for the range."""
    spec = traffic["prompt_len"]
    if spec["dist"] == "fixed":
        return [int(spec["value"])]
    lo, hi = int(spec["min"]), int(spec["max"])
    return [hi, lo, (lo + hi) // 2]


def setup(cell: Cell, seed: int, device: str, *, fault=None):
    """The engine over the program's model, weights from the seed, the cell's
    shapes warmed; the logits capture installed after the warm-up."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = program_config(cell)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build(SERVING_KERNELS)
    model = LM(cfg, device=device, seed=seed)
    long_prompt, long_out = gen.max_lengths(cell.traffic)
    slots = int(cell.traffic["slots"])
    sc = ServeConfig(slots=slots, max_seq=round_up(long_prompt + long_out + 1, 64))
    engine = Engine(cfg, model, sc, device=device)
    engine.warmup(warm_lengths(cell.traffic), decode=long_out > 1)
    if fault is not None:
        fault(engine)
    calls, undo = capture_logits(engine)
    return engine, calls, undo


def make_request(rec: ReqRecord):
    from repro_torch.serving.engine import Request
    return Request(rid=rec.rid, prompt=rec.prompt, max_new_tokens=rec.new_tokens,
                   arrival_s=rec.due_s)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, fault=None) -> dict:
    """One run of ``cell``; returns the result object, its keys in print
    order, ``checks`` last. ``fault(engine)``, for tests, breaks the timed
    path after set-up."""
    cuda = device == "cuda"
    records = requests_for(cell, seed, seconds, cell.numbers.get("rate_rps"))
    standing = cell.traffic["arrivals"] == "standing"
    engine, calls, undo = setup(cell, seed, device, fault=fault)
    log(f"[setup] model and engine ready at {time.perf_counter() - T_START:.3f} s")
    stretch = None
    if trace and cuda:
        from portbench import devtrace
        devtrace.warm_profiler()
        # the last seconds of the window: the profile's stop (which reads the
        # trace) falls at the close, after every measured tick
        stretch = devtrace.Stretch(seconds - min(6.0, 0.3 * seconds), seconds)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    on_tick = None
    if stretch is not None:
        def on_tick(now):
            stretch(now, len(engine.service_log))
    host0 = _host_counters()
    attempted, events, late = drive(engine, records, seconds=seconds, standing=standing,
                                    calls=calls, on_tick=on_tick, make_request=make_request,
                                    spans=stretch is not None)
    _log_host(host0, _host_counters(), events, seconds)
    if stretch is not None and stretch.prof is not None and stretch.t_stop is None:
        stretch(float("inf"), len(engine.service_log))
    if stretch is not None and stretch.t_stop is not None:
        log(f"[trace] profiled {stretch.t_stop - stretch.t_start:.3f} s of the window; "
            f"starting the profiler took {stretch.start_cost_s * 1e3:.1f} ms")
    prefills = [(e["duration_s"], e["tokens"]) for e in events if e["phase"] == "prefill"]
    if len(prefills) > 20:
        log("[window] the first prefills (ms, tokens): " + ", ".join(
            f"{d * 1e3:.2f}/{n}" for d, n in prefills[:16]))
        log(f"[window] prefill service: the first 10 {sum(d for d, _ in prefills[:10]) * 100:.3f} "
            f"ms each, the rest {sum(d for d, _ in prefills[10:]) / (len(prefills) - 10) * 1e3:.3f}"
            " ms each")
    log(f"[window] {len(attempted)} requests attempted, "
        f"{sum(r.finished for r in attempted)} finished; the generator ran at most "
        f"{late * 1e3:.3f} ms late")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        mem = torch.cuda.memory_stats()
        log(f"[window] the allocator freed its cache to retry {mem.get('num_alloc_retries', 0)} "
            f"time(s); {mem.get('num_device_alloc', 0)} device allocations; peak reserved "
            f"{torch.cuda.max_memory_reserved()} B")
    rec = RunRecord(seconds=seconds, model=cell.model, requests=attempted,
                    events=events, setup_s=setup_s, late_max_s=late)
    if stretch is not None:
        from portbench import devtrace
        rec.untraced_s = stretch.start_now
        rec.profile = devtrace.summarize(stretch)
        if rec.profile is not None:
            e0, e1 = stretch.events_from, stretch.events_to
            rec.profile["events"] = [dict(e) for e in events[e0:e1]]
        stretch.prof = None
    metrics = readers.read_all(cell.per_layer if trace else cell.end_to_end, rec)
    # the sample's logits as the timed path returned them, then free the program
    picked = checks.sample(attempted, cell.numbers.get("check", {"requests": 8}), seed)
    program_logits = [torch.stack(r.logits) for r in picked]
    routes = [r.routes for r in picked]
    for r in attempted:
        r.logits, r.routes = [], []
    undo()
    # every reference to the model goes, so that the reference has the card
    del engine, calls, undo, on_tick
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(not r.finished for r in attempted)
    t_check = time.perf_counter()
    readings = (checks.compare(cell.model, seed, picked, program_logits, routes, device,
                               control=control)
                if picked else {name: NO_READING for name in checks.numbers(cell.model)})
    log(f"[check] reference over {len(picked)} requests took "
        f"{time.perf_counter() - t_check:.3f} s")
    for L, n, rel_all, rel_first in readings.get("detail", []):
        log(f"[check] prompt {L}, {n} tokens: logits rel-L2 {rel_first:.4g} at the prefill, "
            f"{rel_all:.4g} at most")
    limits = cell.numbers.get("limits", {})

    def held(values: dict) -> dict:
        out = {"failed_requests": {"value": failed, "limit": 0}}
        for name in checks.numbers(cell.model):
            out[name] = {"value": values[name], "limit": float(limits[name])}
        return out

    # under the control, the fp8 reference stands in the program's place
    compared = held(readings.get("control", readings) if control else readings)
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": len(attempted), "failed": failed,
              "metrics": metrics}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and rec.profile is not None:
        result["device"]["busy_s"] = rec.profile["busy_s"]
        result["device"]["window_s"] = rec.profile["window_s"]
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps"]}
    if control:
        result["program_checks"] = held(readings)
    result["sample"] = {"requests": readings.get("requests", 0),
                        "positions": readings.get("positions", 0)}
    result["checks"] = compared
    return result


def _host_counters() -> dict:
    """The host's state around the window, where Linux shows it: the wall
    clock, this process's CPU time and forced context switches, and the
    machine's CPU ticks stolen by the hypervisor and in all."""
    out = {"wall": time.perf_counter(), "cpu": time.process_time()}
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        out["steal"], out["ticks"] = (ticks[7] if len(ticks) > 7 else 0), sum(ticks)
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    out["forced"] = int(line.split()[1])
    except (OSError, ValueError):
        pass
    return out


def _log_host(a: dict, b: dict, events: list, seconds: float) -> None:
    """One line on what the host did in the window: decode service quantiles,
    ticks that ran far over the median, time between ticks, and the host
    counters' deltas. For reading spreads between runs; no metric uses it."""
    dec = sorted(e["duration_s"] for e in events if e["phase"] == "decode"
                 and 0.0 <= e["t"] and e["t"] + e["duration_s"] <= seconds)
    inside = [e for e in events if 0.0 <= e["t"] and e["t"] + e["duration_s"] <= seconds]
    pre = sum(e["duration_s"] for e in inside if e["phase"] == "prefill")
    msg = f"[host] window {b['wall'] - a['wall']:.3f} s wall, {b['cpu'] - a['cpu']:.3f} s CPU"
    if dec:
        med = dec[len(dec) // 2]
        slow = [d for d in dec if d > 2.0 * med]
        msg += (f"; {len(dec)} decode ticks, median {med * 1e3:.3f} ms, p95 "
                f"{dec[int(0.95 * (len(dec) - 1))] * 1e3:.3f}, max {dec[-1] * 1e3:.3f}; "
                f"{len(slow)} over twice the median ({sum(slow):.3f} s); prefill {pre:.3f} s; "
                f"outside service {seconds - sum(dec) - pre:.3f} s")
    if "ticks" in a and "ticks" in b and b["ticks"] > a["ticks"]:
        msg += f"; steal {100.0 * (b['steal'] - a['steal']) / (b['ticks'] - a['ticks']):.3f}%"
    if "forced" in a and "forced" in b:
        msg += f"; {b['forced'] - a['forced']} forced context switches"
    log(msg)


def _power() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    torch.set_num_threads(2)
    log(f"[device] {torch.cuda.get_device_name(0)}; name, power limit: {_power()}")
    result = run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                 control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        log(f"refused: the process holds {bad} (JAX or the JAX package)")
        return 3
    line = json.dumps(result)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
