"""CUDA-graph replay of the decode step's position-free layers.

A decode step launches hundreds of small kernels, and at one token a step
the host issuing them sets the pace, not the card. ``DecodeGraphs``
captures the step's runs of layers that read nothing from the host, each
run as one CUDA graph, and replays them between the pieces that must stay
eager:

* an attention mixer: it reads the position on the host (its cache slot,
  ``pos % W`` on a ring, the RoPE tables, ``decode_attention``'s split
  plan); with an encoder-decoder its cross-attention goes with it;
* a MoE layer's routing: ``moe.route`` is looked up on the module at call
  time, as ``moe.moe_apply`` does, so a function installed over it is
  called on the step's real inputs and what it returns is what the experts
  dispatch;
* the head (the final fused norm and the unembedding), so that every step
  returns a logits tensor of its own.

Everything else is captured: the embedding of the step's token (copied into
the first graph's input), the fused norms, the mamba and xLSTM mixers with
their in-place state writes, the MLPs and the MoE's dispatch, experts and
combine. ``decode_plan`` is that split, a function of the layer specs alone.

The graphs are captured against one set of the model's caches at one batch
size, on a side stream, sharing one memory pool. Capture only records:
nothing runs then (the eager pieces are captured too, into graphs that are
dropped, to make the tensors the next graph reads). ``engages`` says when a
call may replay them (the caches captured, on the card, no sharding rules
active); any other call runs the eager step.

The same kernels run in the same order on the same inputs: a replay copies
each eager piece's outputs into the next graph's inputs (the token, the
routing's probabilities and expert ids, an attention mixer's output). The
kernel wrappers count nothing while a graph is captured and each graph's
kernels on every replay (``kernels/launches.py``), so their ``.launches``
count what a step runs whether it replays or not.

The graphs hold raw pointers to the model's parameters and to the caches:
anything that gives a parameter new storage after capture must drop them
(``LM._apply`` does, for ``.to()`` and the like; a ``.data`` swap must set
``model._decode_graphs`` to None itself).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.kernels.launches import captured, replayed
from repro_torch.sharding.partition import current_rules

__all__ = ["EAGER_MIXERS", "Piece", "DecodeGraphs", "decode_pieces", "decode_plan", "engages"]

EAGER_MIXERS = ("attn", "attn_local")  # they read the position on the host
MOE_FFNS = ("moe", "moe_dense")


class Piece(NamedTuple):
    """One piece of a decode step: ``kind`` is "embed", "norm1", "mixer",
    "ffn" (norm2 and an MLP), "norm2", "route", "experts" (a MoE's dispatch,
    experts and combine) or "head"; ``layer`` its layer (-1 for the embed
    and the head)."""
    kind: str
    layer: int


def decode_pieces(specs) -> tuple[Piece, ...]:
    """The decode step's pieces in order for layers ``specs``. A layer
    without an FFN hands its mixer's output on from the mixer piece."""
    out = [Piece("embed", -1)]
    for n, spec in enumerate(specs):
        out += [Piece("norm1", n), Piece("mixer", n)]
        if spec.ffn in MOE_FFNS:
            out += [Piece("norm2", n), Piece("route", n), Piece("experts", n)]
        elif spec.ffn != "none":
            out.append(Piece("ffn", n))
    return tuple(out) + (Piece("head", -1),)


def _eager(piece: Piece, specs) -> bool:
    return piece.kind in ("route", "head") or (
        piece.kind == "mixer" and specs[piece.layer].mixer in EAGER_MIXERS)


def decode_plan(specs) -> tuple[tuple[bool, tuple[Piece, ...]], ...]:
    """The step as (captured, pieces) runs: each eager piece alone, every
    maximal run of the others one captured run."""
    plan: list[tuple[bool, list[Piece]]] = []
    for piece in decode_pieces(specs):
        in_graph = not _eager(piece, specs)
        if in_graph and plan and plan[-1][0]:
            plan[-1][1].append(piece)
        else:
            plan.append((in_graph, [piece]))
    return tuple((in_graph, tuple(pieces)) for in_graph, pieces in plan)


def engages(graphs, token: torch.Tensor, caches) -> bool:
    """Whether a decode call may replay ``graphs``: there are graphs, the
    token is on the card with the captured batch, the caches are the tuple
    they were captured against, and no sharding rules are active."""
    return (graphs is not None and token.device.type == "cuda" and caches is graphs.caches
            and tuple(token.shape) == (graphs.batch, 1) and current_rules() is None)


def _region(model, piece: Piece) -> str:
    """An eager piece's profiler range."""
    if piece.kind == "mixer":
        return model._region_names[piece.layer][0]
    return "lm.moe.route" if piece.kind == "route" else "lm.head"


class _Segment(NamedTuple):
    pieces: tuple[Piece, ...]
    region: str  # the profiler range a call runs it under
    graph: torch.cuda.CUDAGraph | None  # None: an eager piece
    inputs: dict  # state name -> the graph's static input
    outputs: dict  # state name -> the graph's static output
    launches: Counter  # wrapper -> its launches in one replay


class DecodeGraphs:
    """The decode step of ``model`` (an ``LM``) captured against ``caches``
    at their batch size. ``run`` replays it for that model."""

    def __init__(self, model, caches: tuple):
        self.caches = caches
        self.batch = next(iter(caches[0].values())).shape[1]
        dev = model.device
        rope_cs = model._rope_at(0, dev)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        state = {"token": torch.zeros((self.batch, 1), dtype=torch.long, device=dev)}
        segments = []
        torch.cuda.synchronize(dev)
        for in_graph, pieces in decode_plan(model.layer_specs):
            # an eager piece is captured too, at position 0, and its graph dropped:
            # that only makes its outputs, the next graph's inputs, without running
            inputs = dict(state)
            graph = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), captured() as launches:
                graph.capture_begin(pool=pool)
                try:
                    for piece in pieces:
                        model._decode_piece(piece, state, caches, 0, rope_cs)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            segments.append(
                _Segment(pieces, "lm.graph", graph, inputs, dict(state), launches) if in_graph
                else _Segment(pieces, _region(model, pieces[0]), None, {}, {}, Counter()))
        torch.cuda.synchronize(dev)
        self.segments = tuple(segments)

    @property
    def graphs(self) -> int:
        return sum(seg.graph is not None for seg in self.segments)

    def run(self, model, token: torch.Tensor, pos: int, caches: tuple, region) -> torch.Tensor:
        """One decode step of ``model``: the logits (B, 1, V), a new tensor
        each call. ``region`` names each segment's profiler range
        (``Tracer.region``)."""
        rope_cs = model._rope_at(pos, token.device)
        state = {"token": token}
        for seg in self.segments:
            with region(seg.region):
                if seg.graph is None:
                    model._decode_piece(seg.pieces[0], state, caches, pos, rope_cs)
                    continue
                for name, static in seg.inputs.items():
                    if state[name] is not static:
                        static.copy_(state[name])
                seg.graph.replay()
            replayed(seg.launches)
            state = dict(seg.outputs)
        return state["logits"]
