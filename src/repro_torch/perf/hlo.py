"""HLO text analysis: collective-op inventory and byte counts.

A copy of the JAX package's parser (pure regex over text, no compiler): a
post-SPMD-partitioning HLO text, such as ``compiled.as_text()`` gives it, is
scanned for all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute / collective-broadcast ops. For each op we record operand bytes, output bytes,
and an estimated *wire* bytes-per-device figure using standard ring-algorithm
cost models:

    all-reduce        2 * (n-1)/n * operand   ~= 2 * operand
    all-gather        (n-1)/n * output        ~= output
    reduce-scatter    (n-1)/n * operand       ~= operand
    all-to-all        (n-1)/n * operand       ~= operand
    collective-permute  operand
    collective-broadcast operand

(n is unknown at parse time; we use the asymptotic factor, which is what the
assignment's "sum operand sizes" convention approximates.)

Caveat: collectives inside while-loop bodies appear once in the text;
scanned-layer totals are therefore extrapolated from unrolled
1-/2-superblock compiles (see ``roofline.combine_linear``).
``roofline.report_from_counts`` takes the ``CollectiveStats`` this returns,
or a dict of the same summary.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["CollectiveStats", "parse_collectives", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "pred": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "ragged-all-to-all",
)

_WIRE_FACTOR = {
    "all-reduce": ("operand", 2.0),
    "all-gather": ("output", 1.0),
    "reduce-scatter": ("operand", 1.0),
    "all-to-all": ("operand", 1.0),
    "collective-permute": ("operand", 1.0),
    "collective-broadcast": ("operand", 1.0),
    "ragged-all-to-all": ("operand", 1.0),
}

# "%name = f32[8,16]{1,0} all-reduce(...)", also tuple outputs
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\s*\("
)
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def _all_shape_bytes(text: str) -> int:
    return sum(_shape_bytes(m.group(1), m.group(2)) for m in _SHAPE_RE.finditer(text))


@dataclass
class CollectiveStats:
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    operand_bytes: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    output_bytes: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_output_bytes(self) -> int:
        return sum(self.output_bytes.values())

    @property
    def wire_bytes(self) -> float:
        """Estimated bytes over the wire per device (ring cost model)."""
        total = 0.0
        for kind in self.counts:
            src, factor = _WIRE_FACTOR[kind]
            b = self.operand_bytes[kind] if src == "operand" else self.output_bytes[kind]
            total += factor * b
        return total

    def summary(self) -> dict:
        return {
            "counts": dict(self.counts),
            "operand_bytes": dict(self.operand_bytes),
            "output_bytes": dict(self.output_bytes),
            "wire_bytes": self.wire_bytes,
        }

    def __add__(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats()
        for s in (self, other):
            for k, v in s.counts.items():
                out.counts[k] += v
            for k, v in s.operand_bytes.items():
                out.operand_bytes[k] += v
            for k, v in s.output_bytes.items():
                out.output_bytes[k] += v
        return out

    def scaled(self, factor: float) -> "CollectiveStats":
        out = CollectiveStats()
        for k, v in self.counts.items():
            out.counts[k] = v
        for k, v in self.operand_bytes.items():
            out.operand_bytes[k] = int(v * factor)
        for k, v in self.output_bytes.items():
            out.output_bytes[k] = int(v * factor)
        return out


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Scan post-partitioning HLO for collective ops and sum their sizes.

    Async pairs (-start/-done) are counted once (on -start); -done lines
    repeat the shapes and are skipped.
    """
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if "-done" in line and any(c in line for c in _COLLECTIVES):
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        out_shape_text, kind = m.group(1), m.group(2)
        # operands: everything inside the call parens
        call = line[m.end() :]
        depth, end = 1, 0
        for i, ch in enumerate(call):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operands_text = call[:end]
        stats.counts[kind] += 1
        stats.operand_bytes[kind] += _all_shape_bytes(operands_text)
        stats.output_bytes[kind] += _all_shape_bytes(out_shape_text)
    return stats
