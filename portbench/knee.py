#!/usr/bin/env python3
"""The knee sweep of an open-loop cell: the highest rate at which the queue
does not grow over a window, found once when the cell is defined.

    python3 portbench/knee.py --workload <cell> --rates 20,24,28,32 --seconds 20

One process builds the model once (weights from ``--seed``) and drives a
fresh engine over it at each rate, on the cell's traffic. For each rate it
prints one JSON line: requests due and finished by the close, the backlog
(due, not yet admitted) at the close, p95 latency, and the mean latency of the
first and the last quarter of the window's arrivals (a queue that grows
makes the last quarter wait longer). The cell's ``rate_rps`` is then set to
about 0.8 of the highest rate whose queue did not grow.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent)]
from portbench import run as R  # noqa: E402  (sets up paths and caches)

import torch  # noqa: E402

from portbench.derive import due_to_done_p95_ms  # noqa: E402
from portbench.window import RunRecord, capture_logits, drive  # noqa: E402


def sweep(cell, rates, seconds: float, seed: int, device: str = "cuda") -> list[dict]:
    from repro_torch.serving.engine import Engine

    engine, _, undo = R.setup(cell, seed, device)
    undo()
    model, cfg, sc = engine.model, engine.cfg, engine.sc
    del engine
    out = []
    for rate in rates:
        engine = Engine(cfg, model, sc, device=device)
        calls, undo = capture_logits(engine)
        records = R.requests_for(cell, seed, seconds, rate)
        attempted, events, late = drive(engine, records, seconds=seconds, standing=False,
                                        calls=calls, make_request=R.make_request)
        rec = RunRecord(seconds=seconds, model=cell.model, requests=attempted,
                        events=events)
        n = len(attempted)
        q = max(1, n // 4)
        first = [r.latency_s for r in attempted[:q]]
        last = [r.latency_s for r in attempted[-q:]]
        row = {"rate_rps": rate, "due": n,
               "finished_by_close": sum(r.finished and r.t_done <= seconds for r in attempted),
               "backlog_at_close": sum(r.t_admit is None or r.t_admit > seconds
                                       for r in attempted),
               "p95_ms": due_to_done_p95_ms(rec),
               "mean_ms_first_quarter": 1e3 * sum(first) / q,
               "mean_ms_last_quarter": 1e3 * sum(last) / q,
               "mean_service_ms": 1e3 * sum(e["duration_s"] for e in events) / max(1, len(events)),
               "late_max_ms": 1e3 * late}
        print(json.dumps(row), flush=True)
        out.append(row)
        undo()
        del engine, calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the knee sweep runs on the card", file=sys.stderr)
        return 2
    cell = R.load_cell(R.ROOT, args.workload)
    sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
