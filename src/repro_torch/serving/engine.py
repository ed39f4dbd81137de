"""Serving engine: batched prefill + decode with KV caches.

The port's counterpart of ``repro.serving.engine``, with the same contract:
requests are admitted into fixed-capacity decode slots; each engine tick runs
one decode step for every active slot; finished sequences free their slot for
the admission queue. Prefill runs per request (batch 1) and writes the slot's
cache region.

Timing is measurement-grade:

  * every service stamp is taken AFTER ``torch.cuda.synchronize()`` — CUDA
    launches are asynchronous, so a bare clock pair around a call measures
    the enqueue, not the device's work (the reference waits with
    ``jax.block_until_ready`` at the same place);
  * :meth:`warmup` runs prefill for every prompt length and one decode step
    up front (kernel builds, cuBLAS set-up), and a wall-clocked call of a
    prompt length that was not warmed is flagged ``compile=True`` in the
    service log and excluded from :meth:`observed_service_stats`, as in the
    reference;
  * a pluggable ``timer`` substitutes a seeded, deterministic service-time
    model for the wall clock while the engine still runs the real model.

Caches are preallocated once and updated in place (prefill copies into the
slot's region, decode writes one position), where the reference rebuilt its
immutable cache arrays with ``.at[].set`` and ``dynamic_update_slice``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM

__all__ = ["Request", "ServeConfig", "ServiceEvent", "Engine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    # filled by the engine:
    tokens_out: list = field(default_factory=list)
    t_admit: float | None = None  # prefill start (queue wait ends here)
    t_first_token: float | None = None
    t_done: float | None = None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.arrival_s

    @property
    def queue_wait_s(self) -> float | None:
        return None if self.t_admit is None else self.t_admit - self.arrival_s


@dataclass(frozen=True)
class ServeConfig:
    slots: int = 4  # concurrent decode slots
    max_seq: int = 512  # cache capacity per slot
    greedy: bool = True


class ServiceEvent(NamedTuple):
    """One timed engine operation in the service log.

    ``t`` is the operation's start on the engine clock (simulated or wall);
    ``occupancy`` is the compute batch the accelerator saw (1 for per-request
    prefill, the number of active slots for a decode step). ``compile=True``
    marks a wall-clocked call whose shape was not warmed up — excluded from
    steady-state statistics.
    """

    t: float
    phase: str  # "prefill" | "decode"
    duration_s: float
    occupancy: int
    rid: int  # request id for prefill; -1 for batched decode steps
    tokens: int  # prompt tokens (prefill) / tokens emitted (decode)
    compile: bool = False


# timer(phase, run, tokens=..., occupancy=...) -> (run's result, seconds)
Timer = Callable[..., tuple[Any, float]]


class Engine:
    """Single-model serving engine over ``LM.prefill`` / ``LM.decode_step``.

    ``device=None`` means the CUDA card (and raises where there is none); the
    model must already be on that device. ``timer`` (optional) replaces the
    wall clock for service durations. ``tracer`` (optional, a
    ``repro_torch.obs.Tracer``) records each request's queue / prefill /
    respond spans and one decode span per step, stamped on the engine clock
    with the reference's names and attributes.
    """

    def __init__(self, cfg: ModelConfig, model: LM, sc: ServeConfig,
                 timer: Timer | None = None, tracer=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None and model.device != self.device):
            raise ValueError(f"model is on {model.device}, engine runs on {self.device}")
        self.cfg = cfg
        self.sc = sc
        self.model = model
        self.timer = timer
        # request tracing (duck-typed; serving never imports obs). _trace is
        # the single predicate every emission site checks: tracer=None and
        # Tracer(enabled=False) cost exactly one bool test.
        self.tracer = tracer
        self._trace = tracer is not None and getattr(tracer, "enabled", True)
        # slot state
        B, S = sc.slots, sc.max_seq
        self.caches = model.init_caches(B, S)
        self.positions = np.zeros(B, np.int32)  # next position per slot
        self.active: list[Request | None] = [None] * B
        self.remaining = np.zeros(B, np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.service_log: list[ServiceEvent] = []
        # shapes already run (prefill by prompt length; one decode shape)
        self._warm_prefill: set[int] = set()
        self._warm_decode = False

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, phase: str, run: Callable[[], Any], *,
               tokens: int, occupancy: int) -> tuple[Any, float]:
        """Run ``run`` and return (result, service seconds). Wall mode waits
        for the device BEFORE the closing stamp."""
        if self.timer is not None:
            out, dt = self.timer(phase, run, tokens=tokens, occupancy=occupancy)
            return out, float(dt)
        t0 = time.perf_counter()
        out = run()
        self._sync()
        return out, time.perf_counter() - t0

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    def warmup(self, prompt_lens: Iterable[int] = (), *, decode: bool = True) -> None:
        """Run prefill for every prompt length the workload can draw and one
        decode step, outside the measured path. Runs on scratch inputs and a
        scratch cache; engine state is untouched."""
        for L in sorted({int(x) for x in prompt_lens}):
            if L in self._warm_prefill:
                continue
            self.model.prefill(self._tokens(np.zeros((1, L), np.int64)))
            self._warm_prefill.add(L)
        if decode and not self._warm_decode:
            scratch = self.model.init_caches(self.sc.slots, self.sc.max_seq)
            self.model.decode_step(self._tokens(np.zeros((self.sc.slots, 1), np.int64)), 0,
                                   scratch)
            self._warm_decode = True
        self._sync()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self, now: float) -> float:
        """Admit queued requests into free slots; returns the advanced clock
        (each prefill occupies the accelerator, so admissions serialise)."""
        for slot in range(self.sc.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            L = len(req.prompt)
            cold = self.timer is None and L not in self._warm_prefill

            def run():
                logits, caches = self.model.prefill(self._tokens(req.prompt[None]))
                # write this request's cache into the slot inside the timed
                # region — the copy is device work the request's service includes
                self._write_slot(caches, slot)
                return logits

            req.t_admit = now
            logits, dt = self._timed("prefill", run, tokens=L, occupancy=1)
            self._warm_prefill.add(L)
            next_tok = int(torch.argmax(logits[0, -1]))
            self.positions[slot] = L
            self.remaining[slot] = req.max_new_tokens - 1
            req.tokens_out.append(next_tok)
            req.t_first_token = now + dt
            self.service_log.append(
                ServiceEvent(now, "prefill", dt, 1, req.rid, L, cold))
            if self._trace:
                track = f"req[{req.rid}]"
                self.tracer.span(
                    t=req.arrival_s, dur=max(0.0, now - req.arrival_s),
                    name="queue", cat="queue", track=track, rid=req.rid)
                self.tracer.span(
                    t=now, dur=dt, name="prefill", cat="prefill", track=track,
                    rid=req.rid, tokens=L, compile=cold)
            now += dt
            if self.remaining[slot] <= 0:
                # single-token request: prefill IS the whole service
                req.t_done = req.t_first_token
                self.completed.append(req)
                if self._trace:
                    self._respond(req)
            else:
                self.active[slot] = req
        return now

    def _write_slot(self, one: tuple, slot: int) -> None:
        """Copy a single-request cache (leading batch 1) into slot ``slot`` of
        the engine's caches, in place, by the reference's rule:
        sequence-bearing leaves (dim 2 is the cache capacity, which differs
        from the prompt's length) copy the prompt's prefix; state leaves
        (mamba ``conv`` and ``h``) copy wholesale."""
        for full_pos, one_pos in zip(self.caches, one):
            for name, full in full_pos.items():
                part = one_pos[name]
                if full.dim() >= 3 and part.dim() == full.dim() and full.shape[2] != part.shape[2]:
                    s = min(part.shape[2], full.shape[2])
                    full[:, slot, :s].copy_(part[:, 0, :s])
                else:
                    full[:, slot].copy_(part[:, 0])

    # ------------------------------------------------------------------
    def tick(self, now: float | None = None) -> int:
        """Admit + one decode step for all active slots. Returns #active.

        ``now`` is the engine clock at tick start (wall time when omitted);
        completion stamps land at ``now + elapsed service``.
        """
        now = time.time() if now is None else now
        now = self._admit(now)
        if not any(r is not None for r in self.active):
            return 0
        cold = self.timer is None and not self._warm_decode

        last = np.zeros((self.sc.slots, 1), np.int64)
        for slot, req in enumerate(self.active):
            if req is not None:
                last[slot, 0] = req.tokens_out[-1]
        # every slot decodes at the furthest active position (the reference's
        # shared decode position: shorter prompts write past their own length)
        pos = int(max(self.positions[s] for s, r in enumerate(self.active) if r is not None))
        n_active = sum(r is not None for r in self.active)

        def run():
            logits, _ = self.model.decode_step(self._tokens(last), pos, self.caches)
            return logits

        logits, dt = self._timed("decode", run, tokens=n_active, occupancy=n_active)
        self._warm_decode = True
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.tokens_out.append(int(nxt[slot]))
            self.positions[slot] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or self.positions[slot] >= self.sc.max_seq - 1:
                req.t_done = now + dt
                self.completed.append(req)
                self.active[slot] = None
                if self._trace:
                    self._respond(req)
        self.service_log.append(
            ServiceEvent(now, "decode", dt, n_active, -1, n_active, cold))
        if self._trace:
            self.tracer.span(
                t=now, dur=dt, name="decode", cat="decode", track="engine",
                occupancy=n_active, compile=cold)
        return n_active

    def _respond(self, req: Request) -> None:
        self.tracer.instant(
            t=req.t_done, name="respond", cat="respond", track=f"req[{req.rid}]",
            rid=req.rid, tokens=len(req.tokens_out), latency_s=req.latency_s)

    def drain(self) -> None:
        """Tick on the wall clock until the queue and every slot are empty."""
        while self.queue or any(r is not None for r in self.active):
            self.tick()

    # ------------------------------------------------------------------
    def observed_service_stats(self) -> tuple[float, float]:
        """(mean, var) of measured per-op service times — the paper's
        profiled service-time input (§4.2). Calls flagged cold are excluded."""
        durs = [ev.duration_s for ev in self.service_log if not ev.compile]
        if not durs:
            return 0.0, 0.0
        arr = np.array(durs)
        return float(arr.mean()), float(arr.var())
