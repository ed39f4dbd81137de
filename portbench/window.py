"""The measured window: the program's serving engine driven on the host's
wall clock.

Open loop (``arrivals: poisson``): each request is submitted once its due
time has passed, with ``arrival_s`` = its due time, so the generator's own
lateness counts as waiting; every request due in the window is followed to
completion after it. Standing queue (``arrivals: standing``): every request
is due as the window opens and is handed to the engine when a slot is free
while the window is open; every request admitted in the window is followed
to completion, and one never admitted was not attempted.

Each engine tick gets ``now`` = wall seconds since the window opened. The
first token of a request is stamped at the engine's ``t_first_token``, every
further token at the wall time at which the tick that made it returned. A
request that has not finished a minute after the close has failed.

The logits the timed path returns are kept (a reference to each returned
tensor; no copy, no synchronisation, nothing changed in the program), each
under the request it served, for the correctness check.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

__all__ = ["ReqRecord", "RunRecord", "capture_logits", "drive"]

GRACE_S = 60.0


@dataclass
class ReqRecord:
    rid: int
    due_s: float
    prompt_len: int
    new_tokens: int
    prompt: object = None
    t_admit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    stamps: list = field(default_factory=list)  # wall seconds of each token
    tokens: list = field(default_factory=list)
    logits: list = field(default_factory=list)  # (vocab,) tensors, one per token
    routes: list = field(default_factory=list)  # per model call: (tokens, k) expert ids a MoE layer

    @property
    def finished(self) -> bool:
        return self.t_done is not None

    @property
    def latency_s(self) -> float:
        return float("inf") if self.t_done is None else self.t_done - self.due_s


@dataclass
class RunRecord:
    """What the readers read: the window, its requests and service events,
    the model block, set-up time and, in a traced run, the profile."""
    seconds: float
    model: dict
    requests: list  # ReqRecord, every request attempted
    events: list  # dicts: t, phase, duration_s, occupancy, tokens, pos (decode)
    setup_s: float = 0.0
    late_max_s: float = 0.0
    profile: dict | None = None
    untraced_s: float | None = None  # a traced run's window up to its profiled stretch

    def events_in_window(self, phase: str | None = None) -> list:
        """Service events finished in the window; in a traced run, before its
        profiled stretch (the profiler slows the host)."""
        end = self.seconds if self.untraced_s is None else self.untraced_s
        return [e for e in self.events if (phase is None or e["phase"] == phase)
                and e["t"] >= 0.0 and e["t"] + e["duration_s"] <= end]


def capture_logits(engine):
    """Keep every logits tensor the model returns to the engine, and the
    experts each MoE layer routed to in that call: prefill entries
    ("prefill", logits, routes), decode entries ("decode", logits, routes,
    the slots' requests at the call). Each routes entry is the (tokens, k)
    ids ``moe.route`` returned, in layer order. Returns (the call list, a
    function that takes the capture off)."""
    from repro_torch.models import moe

    calls: list = []
    routed: list = []
    model = engine.model
    prefill, decode_step, route = model.prefill, model.decode_step, moe.route

    def kept_route(*args, **kw):
        probs, idx = route(*args, **kw)
        routed.append(idx)
        return probs, idx

    def kept_prefill(*args, **kw):
        del routed[:]
        logits, caches = prefill(*args, **kw)
        calls.append(("prefill", logits, list(routed)))
        return logits, caches

    def kept_decode(*args, **kw):
        del routed[:]
        logits, caches = decode_step(*args, **kw)
        calls.append(("decode", logits, list(routed), list(engine.active)))
        return logits, caches

    model.prefill, model.decode_step, moe.route = kept_prefill, kept_decode, kept_route

    def undo():
        del model.prefill, model.decode_step
        moe.route = route

    return calls, undo


def _busy(engine) -> bool:
    return bool(engine.queue) or any(r is not None for r in engine.active)


def drive(engine, records: list[ReqRecord], *, seconds: float, standing: bool, calls: list,
          make_request, on_tick=None, spans: bool = False) -> tuple[list, list, float]:
    """Run the window. Returns (attempted records, service events, the
    generator's largest lateness in seconds). ``on_tick(now)`` runs between
    ticks (the traced run starts and stops its profile there); ``spans``
    marks each tick and each idle wait as a profiler annotation
    (``portbench.tick``, ``portbench.idle``)."""
    if spans:
        from torch.profiler import record_function
    else:
        def record_function(_name):
            return nullcontext()
    by_req: dict[int, ReqRecord] = {}
    events: list = []
    pending = list(records)
    attempted: list[ReqRecord] = []
    late = 0.0
    i = 0

    def submit(rec: ReqRecord) -> None:
        req = make_request(rec)
        by_req[id(req)] = rec
        engine.submit(req)
        attempted.append(rec)

    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if on_tick is not None:
            on_tick(now)
        if standing:
            free = sum(r is None for r in engine.active) - len(engine.queue)
            while now < seconds and free > 0 and i < len(pending):
                submit(pending[i])
                i, free = i + 1, free - 1
        else:
            while i < len(pending) and pending[i].due_s <= now:
                late = max(late, now - pending[i].due_s)
                submit(pending[i])
                i += 1
        if not _busy(engine):
            if standing and (now >= seconds or i == len(pending)):
                break
            if not standing and i == len(pending):
                break
            if not standing:  # idle until the next request is due
                wait = pending[i].due_s - (time.perf_counter() - t0)
                if wait > 0.002:
                    with record_function("portbench.idle"):
                        time.sleep(wait - 0.001)
            continue
        if now > seconds + GRACE_S:
            break  # what is still queued or active has failed
        queued = list(engine.queue)
        active = [r for r in engine.active if r is not None]
        before = {id(r): len(r.tokens_out) for r in queued + active}
        n_calls, n_events = len(calls), len(engine.service_log)
        with record_function("portbench.tick"):
            engine.tick(now=now)
        t_ret = time.perf_counter() - t0
        # the tick's logits: its prefills in queue order, then its decode step by slot
        prefills = [c for c in calls[n_calls:] if c[0] == "prefill"]
        for req, call in zip([r for r in queued if r.t_admit is not None], prefills):
            rec = by_req[id(req)]
            rec.logits.append(call[1][0, -1])
            rec.routes.append([idx.reshape(-1, idx.shape[-1]) for idx in call[2]])
        decode_pos = None
        for call in calls[n_calls:]:
            if call[0] != "decode":
                continue
            for slot, req in enumerate(call[3]):
                if req is not None:
                    rec = by_req[id(req)]
                    rec.logits.append(call[1][slot, 0])
                    rec.routes.append([idx.reshape(-1, idx.shape[-1])[slot:slot + 1]
                                       for idx in call[2]])
                    pos = rec.prompt_len + len(req.tokens_out) - 2
                    decode_pos = pos if decode_pos is None else max(decode_pos, pos)
        for req in queued + active:
            rec = by_req[id(req)]
            for k in range(before[id(req)], len(req.tokens_out)):
                rec.stamps.append(req.t_first_token if k == 0 else t_ret)
            rec.tokens = list(req.tokens_out)
            rec.t_admit, rec.t_first_token, rec.t_done = req.t_admit, req.t_first_token, req.t_done
        for ev in engine.service_log[n_events:]:
            events.append(dict(t=ev.t, phase=ev.phase, duration_s=ev.duration_s,
                               occupancy=ev.occupancy, tokens=ev.tokens,
                               pos=decode_pos if ev.phase == "decode" else None))
    return attempted, events, late
