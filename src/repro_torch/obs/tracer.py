"""Span-based request tracing: deterministic, zero-overhead when disabled.

The tracer records the request lifecycle the paper's two-level methodology
implies — decide / transfer / queue / prefill / decode / respond — stamped on
whatever clock the producer runs (the measure harness's simulated clock or the
wall clock). Spans carry no wall-time side channel of their own, so a
simulated-clock run serializes byte-identically across same-seed reruns.

Two export formats:

  * JSONL (:meth:`Tracer.to_jsonl`) — one canonical (sorted-keys) JSON object
    per span, byte-stable per seed; the format
    :mod:`repro_torch.launch.obs_report` reads back.
  * Chrome/Perfetto ``trace_event`` (:meth:`Tracer.to_chrome`) — "X" complete
    events with microsecond ``ts``/``dur``, loadable at https://ui.perfetto.dev.

Hot paths hold a ``tracer`` that is either ``None`` (recommended: guard the
emission site with ``if tracer is not None``) or a :class:`Tracer`; a tracer
constructed with ``enabled=False`` no-ops on every record call, so either
convention keeps the disabled cost to one predicate.

Producers pass plain Python ``int``/``float``/``str`` attributes, never a
tensor: a 0-d tensor would reach ``.item()`` at its own precision (float32
for a reduced model) and the JSONL would no longer equal the reference's.
The JSONL and Chrome exports are those of ``repro.obs.tracer``, byte for byte.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable

__all__ = ["Span", "Tracer", "merge"]

# the span categories the serving and fleet stack emits (open set — consumers must not
# assume exhaustiveness, the report CLI groups by whatever it finds)
CATEGORIES = ("decide", "transfer", "queue", "prefill", "decode", "respond")


def _scalar(v):
    """Coerce numpy scalars / bools to plain Python so json round-trips are
    canonical and never emit e.g. ``Infinity`` payload variants per dtype."""
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, float):
        if v != v:
            return "nan"
        if v == float("inf"):
            return "inf"
        if v == float("-inf"):
            return "-inf"
    return v


@dataclass(frozen=True)
class Span:
    """One timed (or instant, ``dur == 0``) event on a named track."""

    t: float  # start, seconds on the producer's clock
    dur: float  # seconds (0.0 for instants)
    name: str
    cat: str  # lifecycle category ("decide", "prefill", ...)
    track: str  # display lane (Perfetto thread): "engine", "req[3]", ...
    attrs: tuple[tuple[str, Any], ...] = ()

    def to_dict(self) -> dict:
        return {
            "t": self.t,
            "dur": self.dur,
            "name": self.name,
            "cat": self.cat,
            "track": self.track,
            "attrs": dict(self.attrs),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            t=float(d["t"]), dur=float(d["dur"]), name=str(d["name"]),
            cat=str(d["cat"]), track=str(d["track"]),
            attrs=tuple(sorted(d.get("attrs", {}).items())),
        )


class Tracer:
    """Collects :class:`Span` records; serializes them deterministically."""

    __slots__ = ("enabled", "spans")

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []

    def __len__(self) -> int:
        return len(self.spans)

    def clear(self) -> None:
        self.spans.clear()

    # -- recording ----------------------------------------------------------
    def span(self, *, t: float, dur: float, name: str, cat: str,
             track: str = "main", **attrs) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(
            t=float(t), dur=float(dur), name=name, cat=cat, track=track,
            attrs=tuple(sorted((k, _scalar(v)) for k, v in attrs.items())),
        ))

    def instant(self, *, t: float, name: str, cat: str,
                track: str = "main", **attrs) -> None:
        self.span(t=t, dur=0.0, name=name, cat=cat, track=track, **attrs)

    # -- JSONL --------------------------------------------------------------
    def to_jsonl(self) -> str:
        """One canonical JSON object per line — byte-stable for identical
        span sequences (same seed + simulated clock => identical bytes)."""
        return "".join(
            json.dumps(s.to_dict(), sort_keys=True, separators=(",", ":")) + "\n"
            for s in self.spans
        )

    def write_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(self.to_jsonl())
        return path

    @classmethod
    def from_jsonl(cls, text: str) -> "Tracer":
        tr = cls()
        tr.spans = [Span.from_dict(json.loads(line))
                    for line in text.splitlines() if line.strip()]
        return tr

    @classmethod
    def read_jsonl(cls, path: str | Path) -> "Tracer":
        return cls.from_jsonl(Path(path).read_text())

    # -- Chrome/Perfetto trace_event ----------------------------------------
    def to_chrome(self) -> dict:
        """The ``trace_event`` JSON object Perfetto / chrome://tracing load.

        Every span becomes an "X" (complete) event; instants become "i".
        ``ts``/``dur`` are microseconds. Tracks map to tids in order of first
        appearance (deterministic for a deterministic span stream), with
        ``thread_name`` metadata so Perfetto labels the lanes.
        """
        tids: dict[str, int] = {}
        events: list[dict] = []
        for s in self.spans:
            tid = tids.setdefault(s.track, len(tids) + 1)
            ev = {
                "name": s.name,
                "cat": s.cat,
                "ph": "X" if s.dur > 0.0 else "i",
                "ts": s.t * 1e6,
                "pid": 1,
                "tid": tid,
                "args": dict(s.attrs),
            }
            if s.dur > 0.0:
                ev["dur"] = s.dur * 1e6
            else:
                ev["s"] = "t"  # instant scope: thread
            events.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": track}}
            for track, tid in tids.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_chrome(), sort_keys=True) + "\n")
        return path

    # -- queries (report CLI / tests) ---------------------------------------
    def by_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        return list(seen)


def merge(tracers: Iterable[Tracer]) -> Tracer:
    """Concatenate several tracers' spans (e.g. engine + gateway) into one
    stream ordered by start time (stable for equal stamps)."""
    out = Tracer()
    spans: list[Span] = []
    for tr in tracers:
        spans.extend(tr.spans)
    out.spans = sorted(spans, key=lambda s: s.t)
    return out
