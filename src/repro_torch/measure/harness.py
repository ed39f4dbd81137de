"""Profiling harness: drive the real Engine under PoissonWorkload, record a trace.

The port's counterpart of ``repro.measure.harness``, with the same
:class:`HarnessConfig`, trace JSON and ``TRACE_VERSION``.

The harness owns the clock. In ``"simulated"`` mode every engine op is
charged a seeded cost-model duration (:class:`SimulatedTimer`) so a run is
bit-replayable — same :class:`HarnessConfig` => identical trace — which is
what lets CI gate analytic-vs-measured latency deterministically. In
``"wall"`` mode durations come from ``time.perf_counter`` around the op,
stamped after ``torch.cuda.synchronize`` (real hardware in the loop); the
request/event *structure* is still seeded, only the durations float.

Either way the engine itself is real: prompts run through ``LM.prefill`` /
``LM.decode_step`` (on the card, through the port's kernels), tokens are
argmax-decoded, slots and queues behave exactly as in serving. The simulated
clock replaces *when* things finish, never *what* the engine computes.

The model's weights are random, drawn from ``seed`` by the port's own
generator (torch cannot replay the reference's ``jax.random`` init). Under
the simulated clock that changes nothing in the trace: every duration comes
from the timer's numpy draws, and the engine has no end-of-sequence stop, so
the tokens' values never decide when a request ends. The simulated trace
therefore equals the reference's for the same :class:`HarnessConfig`.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, replace
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

__all__ = [
    "HarnessConfig",
    "SimulatedTimer",
    "RequestRecord",
    "MeasuredTrace",
    "run_harness",
]

TRACE_VERSION = 1
_EPS = 1e-12

CLOCKS = ("simulated", "wall")


@dataclass(frozen=True)
class HarnessConfig:
    """One profiling run, fully specified (the replay key for a trace).

    ``arrival_rate=None`` derives lambda from ``target_rho``: the expected
    request service time comes from the cost model (simulated clock) or a
    short unrecorded calibration run (wall clock), and lambda is set so the
    engine sits at the requested utilisation — profiling at a known rho is
    what makes the queueing comparison meaningful.
    """

    arch: str
    slots: int = 1
    max_seq: int = 64
    reduced: bool = True  # cfg.reduced(): tiny CPU-runnable proxy of the arch
    seq_chunk: int = 8
    clock: str = "simulated"  # "simulated" (seeded, replayable) | "wall"
    seed: int = 0
    n_requests: int = 240
    arrival_rate: float | None = None  # requests/s; None -> from target_rho
    target_rho: float = 0.45
    calibrate_requests: int = 8  # wall clock: unrecorded service-time probe
    # workload shape
    prompt_len: int = 8
    prompt_len_jitter: int = 2
    max_new_tokens: int = 6
    new_tokens_geometric_p: float = 0.35
    # simulated-clock cost model (see SimulatedTimer)
    device_flops: float = 5.0e12
    overhead_s: float = 5.0e-4
    timing_cv2: float = 0.25

    def __post_init__(self):
        if self.clock not in CLOCKS:
            raise ValueError(f"clock must be one of {CLOCKS}, got {self.clock!r}")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.arrival_rate is not None and not self.arrival_rate > 0:
            raise ValueError(f"arrival_rate must be > 0, got {self.arrival_rate}")
        if not 0.0 < self.target_rho < 1.0:
            raise ValueError(f"target_rho must be in (0, 1), got {self.target_rho}")
        if self.timing_cv2 < 0:
            raise ValueError(f"timing_cv2 must be >= 0, got {self.timing_cv2}")
        if not self.device_flops > 0 or self.overhead_s < 0:
            raise ValueError("device_flops must be > 0 and overhead_s >= 0")

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "HarnessConfig":
        return cls(**dict(d))


class SimulatedTimer:
    """Seeded service-time model plugged into ``Engine(timer=...)``.

    Charges each engine op a linear cost-model duration scaled by i.i.d.
    gamma jitter with unit mean and squared coefficient of variation
    ``cv2``:

        prefill(L tokens):   (overhead + L * flop_per_token / device_flops) * G
        decode(m slots):     (overhead + m * flop_per_token / device_flops) * G

    ``flop_per_token = 2 * active_params`` (the standard 2N forward cost,
    from ``perf.flops.param_counts``), so larger zoo configs are properly
    slower. The gamma jitter gives the service distribution a known SCV for
    the fit layer to recover, while keeping every draw seeded — the whole
    point of the simulated clock is that reruns are byte-identical.
    """

    def __init__(self, cfg, *, seed: int = 0, device_flops: float = 5.0e12,
                 overhead_s: float = 5.0e-4, cv2: float = 0.25):
        from repro_torch.perf.flops import param_counts

        _, active = param_counts(cfg)
        self.flop_per_token = 2.0 * float(active)
        self.device_flops = float(device_flops)
        self.overhead_s = float(overhead_s)
        self.cv2 = float(cv2)
        self.rng = np.random.default_rng(seed)

    def expected_seconds(self, phase: str, *, tokens: int, occupancy: int) -> float:
        """Mean duration of one op (jitter has unit mean)."""
        return self.overhead_s + tokens * self.flop_per_token / self.device_flops

    def __call__(self, phase: str, run: Callable[[], Any], *,
                 tokens: int, occupancy: int) -> tuple[Any, float]:
        out = run()  # the real engine op still executes
        dt = self.expected_seconds(phase, tokens=tokens, occupancy=occupancy)
        if self.cv2 > 0:
            dt *= float(self.rng.gamma(1.0 / self.cv2, self.cv2))
        return out, dt


@dataclass(frozen=True)
class RequestRecord:
    """Per-request timeline extracted from the engine's service log."""

    rid: int
    arrival_s: float
    prompt_len: int
    n_tokens: int
    t_admit: float
    t_first_token: float
    t_done: float
    prefill_s: float
    decode_s: float  # sum of the decode steps this request participated in
    n_decode: int
    mean_occupancy: float  # mean decode-batch size over those steps

    @property
    def queue_wait_s(self) -> float:
        return self.t_admit - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.t_done - self.arrival_s

    @property
    def service_s(self) -> float:
        """In-service wall time (admission to completion) — the request-level
        service the latency models reason about. >= prefill_s + decode_s when
        other requests' prefills interleave (head-of-line batching)."""
        return self.t_done - self.t_admit

    @property
    def occupancy(self) -> int:
        """Rounded mean decode occupancy — the fit-group key."""
        return int(round(self.mean_occupancy)) if self.n_decode else 1

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RequestRecord":
        return cls(**dict(d))


@dataclass(frozen=True)
class MeasuredTrace:
    """A completed profiling run: resolved config + per-request records +
    the raw engine service log (compile-flagged events excluded)."""

    harness: HarnessConfig
    arrival_rate: float  # resolved lambda actually used
    requests: tuple[RequestRecord, ...]
    events: tuple[tuple, ...]  # ServiceEvent rows (t, phase, dur, occ, rid, tokens, compile)
    version: int = TRACE_VERSION

    def latencies(self) -> np.ndarray:
        return np.array([r.latency_s for r in self.requests])

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "harness": self.harness.to_dict(),
            "arrival_rate": self.arrival_rate,
            "requests": [r.to_dict() for r in self.requests],
            "events": [list(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "MeasuredTrace":
        return cls(
            harness=HarnessConfig.from_dict(d["harness"]),
            arrival_rate=float(d["arrival_rate"]),
            requests=tuple(RequestRecord.from_dict(r) for r in d["requests"]),
            events=tuple(tuple(e) for e in d["events"]),
            version=int(d.get("version", TRACE_VERSION)),
        )

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "MeasuredTrace":
        return cls.from_dict(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


def _expected_workload(hc: HarnessConfig) -> tuple[float, float]:
    """(E[prompt_len], E[new_tokens]) of the configured workload, estimated
    from a large seeded sample of the same draw logic (exact enough for
    setting a target utilisation; derived from hc only, so deterministic)."""
    rng = np.random.default_rng(hc.seed + 104729)
    n = 4096
    L = np.full(n, hc.prompt_len, dtype=np.int64)
    if hc.prompt_len_jitter:
        L = L + rng.integers(-hc.prompt_len_jitter, hc.prompt_len_jitter + 1, size=n)
    if hc.new_tokens_geometric_p > 0:
        nt = 1 + rng.geometric(hc.new_tokens_geometric_p, size=n)
        nt = np.minimum(nt, hc.max_new_tokens)
    else:
        nt = np.full(n, hc.max_new_tokens, dtype=np.int64)
    return float(L.mean()), float(nt.mean())


def _resolve_arrival_rate(hc: HarnessConfig, eng, timer: SimulatedTimer | None,
                          make_request) -> float:
    """lambda for the run: explicit, or target_rho * slots / E[request service]."""
    if hc.arrival_rate is not None:
        return float(hc.arrival_rate)
    e_len, e_new = _expected_workload(hc)
    if timer is not None:
        service = timer.expected_seconds("prefill", tokens=int(round(e_len)), occupancy=1)
        service += (e_new - 1.0) * timer.expected_seconds("decode", tokens=1, occupancy=1)
    else:
        # wall clock: probe the hardware with a short back-to-back burst
        # (unrecorded; the caller clears the service log afterwards)
        for k in range(hc.calibrate_requests):
            eng.submit(make_request(rid=-(k + 1)))
        eng.drain()
        probes = [r.service_s for r in
                  (_request_records(eng.completed, eng.service_log)
                   if eng.completed else [])]
        service = float(np.mean(probes)) if probes else 1e-3
        eng.completed.clear()
    return hc.target_rho * hc.slots / max(service, _EPS)


def _request_records(reqs, events) -> list[RequestRecord]:
    """Join completed requests against the service log.

    A request's decode steps are exactly the decode events whose start time
    falls in [t_first_token, t_done): every decode step in that window ran
    the full active batch, which included this request."""
    prefills = {ev.rid: ev for ev in events if ev.phase == "prefill"}
    decodes = [ev for ev in events if ev.phase == "decode"]
    out = []
    for r in sorted(reqs, key=lambda r: r.rid):
        if r.t_done is None or r.rid not in prefills:
            continue
        pre = prefills[r.rid]
        dec = [ev for ev in decodes
               if r.t_first_token - _EPS <= ev.t < r.t_done - _EPS]
        out.append(RequestRecord(
            rid=r.rid,
            arrival_s=float(r.arrival_s),
            prompt_len=int(len(r.prompt)),
            n_tokens=int(len(r.tokens_out)),
            t_admit=float(r.t_admit),
            t_first_token=float(r.t_first_token),
            t_done=float(r.t_done),
            prefill_s=float(pre.duration_s),
            decode_s=float(sum(ev.duration_s for ev in dec)),
            n_decode=len(dec),
            mean_occupancy=float(np.mean([ev.occupancy for ev in dec])) if dec else 1.0,
        ))
    return out


def run_harness(hc: HarnessConfig, *, device=None, tracer=None) -> MeasuredTrace:
    """Run one profiling experiment end to end and return its trace.

    Event loop: arrivals with ``arrival_s <= t`` are submitted, the engine
    ticks on the harness clock, and ``t`` advances by the service time the
    tick consumed (the engine serialises its ops, so elapsed time is exactly
    the sum of the tick's event durations). When the system empties, ``t``
    jumps to the next arrival — idle time costs nothing.

    ``tracer`` (a ``repro_torch.obs.Tracer``) records the queue/prefill/
    decode/respond lifecycle of every request on the harness clock — with the
    simulated clock the emitted span stream is byte-stable per seed, and
    equal to the reference's for the same config. Calibration probes are
    excluded (the tracer is attached after calibration, mirroring
    service_log.clear()).

    ``device=None`` runs the engine on the CUDA card (and raises where there
    is none); pass ``device="cpu"`` for the CPU. The device is not part of
    the :class:`HarnessConfig`: a simulated trace is the same on either.
    On the card the model runs in bfloat16, the dtype the port's
    flash-attention kernel takes; that changes only the reduced configs,
    which are float32 for the CPU, and no simulated trace (the timer's
    durations do not depend on the dtype).
    """
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Request, ServeConfig
    from repro_torch.serving.workload import PoissonWorkload, WorkloadConfig

    dev = resolve_device(device)
    cfg = get_config(hc.arch)
    if hc.reduced:
        cfg = cfg.reduced(seq_chunk=hc.seq_chunk)
    if dev.type == "cuda":
        cfg = replace(cfg, dtype="bfloat16")
    model = LM(cfg, device=dev, seed=hc.seed)
    timer = None
    if hc.clock == "simulated":
        timer = SimulatedTimer(cfg, seed=hc.seed + 1, device_flops=hc.device_flops,
                               overhead_s=hc.overhead_s, cv2=hc.timing_cv2)
    eng = Engine(cfg, model, ServeConfig(slots=hc.slots, max_seq=hc.max_seq),
                 timer=timer, device=dev)

    lo, hi = hc.prompt_len - hc.prompt_len_jitter, hc.prompt_len + hc.prompt_len_jitter
    eng.warmup(range(lo, hi + 1))

    probe_rng = np.random.default_rng(hc.seed + 2)

    def probe_request(rid: int):
        return Request(rid=rid,
                       prompt=probe_rng.integers(0, cfg.vocab_size, size=hc.prompt_len)
                       .astype(np.int32),
                       max_new_tokens=hc.max_new_tokens)

    lam = _resolve_arrival_rate(hc, eng, timer, probe_request)
    eng.service_log.clear()  # drop any calibration events
    if tracer is not None:
        eng.tracer = tracer
        eng._trace = getattr(tracer, "enabled", True)

    wc = WorkloadConfig(
        arrival_rate=lam,
        prompt_len=hc.prompt_len,
        prompt_len_jitter=hc.prompt_len_jitter,
        max_new_tokens=hc.max_new_tokens,
        new_tokens_geometric_p=hc.new_tokens_geometric_p,
        vocab=cfg.vocab_size,
        seed=hc.seed,
    )
    reqs = PoissonWorkload(wc).take(hc.n_requests)

    t, i, n = 0.0, 0, len(reqs)
    while len(eng.completed) < n:
        while i < n and reqs[i].arrival_s <= t + _EPS:
            eng.submit(reqs[i])
            i += 1
        if not eng.queue and not any(r is not None for r in eng.active):
            t = reqs[i].arrival_s  # idle: jump to the next arrival
            continue
        k0 = len(eng.service_log)
        eng.tick(now=t)
        t += sum(ev.duration_s for ev in eng.service_log[k0:])

    steady = [ev for ev in eng.service_log if not ev.compile]
    return MeasuredTrace(
        harness=hc,
        arrival_rate=lam,
        requests=tuple(_request_records(eng.completed, steady)),
        events=tuple(tuple(ev) for ev in steady),
    )
