"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and always holding the longest,
is run through the plain fp32 reference (``reference/``) over each prompt
with the tokens the engine served. Two numbers are compared, each against
the cell's limit (``portbench/cells/<cell>.json``):

* ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position (greedy decoding serves
  the program's argmax);
* ``logits_rel_l2``: the largest, over the sampled positions, of
  |program logits - reference logits| / |reference logits|, the program's
  logits being those its timed path returned.

* ``route_margin`` (a model with experts): the reference routes each token
  to the experts the program chose, read from the program's own calls, and
  compares that choice with its own router: the widest amount, in router
  probability, by which a chosen expert lies below the best one left out.
  Top-k routing is discontinuous at a tie, so a lower precision may choose
  otherwise where two experts lie within its rounding; the reference then
  follows that choice and this number holds it to a near tie.

``failed_requests`` (requests that never finished) is compared too, with the
limit 0. The control (``--control 1``, never in the benchmark's own runs) is
the reference computed with fp8 linear layers, put in the program's place:
the same numbers are read for it (the gap of the token fp8 puts first, its
logits' distance, its routing margin) and go through the same limits, so
that its run comes out not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.model import Served, reference_logits

__all__ = ["sample", "compare", "control_readings"]


def sample(records: list, check: dict, seed: int) -> list:
    """Finished requests, the longest (prompt + served tokens) first. With
    ``check["requests"]`` = n, one more from each of n - 1 strata of equal
    count of the others sorted by length, drawn from the seed, so that every
    band of lengths is held; with ``check["tokens"]``, others in an order drawn
    from the seed until that many served tokens are held."""
    done = sorted((r for r in records if r.finished and r.logits),
                  key=lambda r: (r.prompt_len + len(r.tokens), r.rid))
    if not done:
        return []
    longest, rest = done[-1], done[:-1]
    rng = np.random.default_rng(seed)
    if "requests" in check:
        k = min(int(check["requests"]) - 1, len(rest))
        strata = np.array_split(np.arange(len(rest)), k) if k > 0 else []
        return [longest] + [rest[int(s[rng.integers(len(s))])] for s in strata]
    picked, tokens = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if tokens >= int(check["tokens"]):
            break
        picked.append(rest[int(i)])
        tokens += len(rest[int(i)].tokens)
    return picked


def numbers(model: dict) -> list[str]:
    """The names of the numbers compared for a model (besides failures)."""
    return ["token_gap", "logits_rel_l2"] + (["route_margin"] if model.get("num_experts") else [])


def _served(picked: list, routes: list | None) -> list[Served]:
    """Each request's tokens and, where the program routed to experts, its
    experts per MoE layer over every position (the prefill's, then each
    decode step's)."""
    out = []
    for i, r in enumerate(picked):
        ids = np.concatenate([np.asarray(r.prompt, np.int64),
                              np.asarray(r.tokens[:-1], np.int64)])
        per_layer = None
        if routes is not None and routes[i] and routes[i][0]:
            per_layer = [torch.cat([call[j] for call in routes[i]], dim=0)
                         for j in range(len(routes[i][0]))]
        out.append(Served(torch.from_numpy(ids), r.prompt_len, per_layer))
    return out


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return ref.max(dim=-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def _rel(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (a - ref).norm(dim=-1) / ref.norm(dim=-1)


def _readings(V: int, refs: list, lows: list, tokens: list) -> tuple[float, float]:
    gap, rel = 0.0, 0.0
    for ref, low, toks in zip(refs, lows, tokens):
        ref, low = ref[:, :V], low[:, :V].float()
        toks = low.argmax(dim=-1) if toks is None else toks.to(ref.device)
        gap = max(gap, float(_gaps(ref, toks).max()))
        rel = max(rel, float(_rel(low, ref).max()))
    return gap, rel


def compare(model: dict, seed: int, picked: list, program_logits: list, routes: list, device,
            control: bool = False) -> dict:
    """The compared numbers, and with ``control`` the control's readings.
    ``program_logits``: per request, the (tokens, padded vocab) logits the
    timed path returned; ``routes``: per request, the experts each of its
    model calls routed to. The reference follows those experts and reads how
    far each choice lies from its own top-k (``route_margin``)."""
    V = model["padded_vocab"]
    served = _served(picked, routes)
    refs, margin, _ = reference_logits(model, seed, served, device)
    toks = [torch.as_tensor(r.tokens, dtype=torch.long) for r in picked]
    gap, rel = _readings(V, refs, program_logits, toks)
    detail = [(r.prompt_len, len(r.tokens), float(_rel(p[:, :V].float(), ref[:, :V]).max()),
               float(_rel(p[:1, :V].float(), ref[:1, :V]).max()))
              for r, p, ref in zip(picked, program_logits, refs)]
    out = {"token_gap": gap, "logits_rel_l2": rel, "route_margin": margin, "detail": detail,
           "positions": int(sum(len(r.tokens) for r in picked)), "requests": len(picked)}
    if control:
        out["control"] = control_readings(model, seed, served, refs, device)
    return out


def control_readings(model: dict, seed: int, served: list, refs: list, device) -> dict:
    """The reference in fp8 in the program's place, routing by itself; the
    fp32 reference then follows the control's experts, as it follows the
    program's. Read at each position of the same prompts and served tokens:
    the gap of the token fp8 puts first, its logits' distance, its routing
    margin."""
    V = model["padded_vocab"]
    own = [Served(s.tokens, s.prompt_len) for s in served]
    lows, _, used = reference_logits(model, seed, own, device, control=True)
    margin = 0.0
    if model.get("num_experts"):
        follow = [Served(s.tokens, s.prompt_len, u) for s, u in zip(served, used)]
        refs, margin, _ = reference_logits(model, seed, follow, device)
    gap, rel = _readings(V, refs, lows, [None] * len(lows))
    return {"token_gap": gap, "logits_rel_l2": rel, "route_margin": margin}
