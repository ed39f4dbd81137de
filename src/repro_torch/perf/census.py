"""Per-device cost census of one step run on fake DTensors: the port's twin
of XLA's ``cost_analysis`` / ``memory_analysis`` and of ``hlo.parse_collectives``.

``StepCensus`` is a ``TorchDispatchMode``. It lets ``DTensor`` turn each
global op into the ops one rank runs on its local shards, and counts those:

  * ``flops``: the FLOPs of each local op that torch's ``FlopCounterMode``
    knows (matrix products, attention, convolution); elementwise work is not
    counted, where XLA's count includes it;
  * ``bytes``: every input and output byte of each local op that is not a
    view, op by op and unfused, as the card runs the step eagerly;
  * ``collectives``: the functional collectives DTensor issues, by the
    reference's kind names, with their operand and output bytes in a
    ``hlo.CollectiveStats`` (its ring model gives the wire bytes);
  * ``peak_bytes``: the most bytes of local tensors that the ops made and
    that were alive at once (the step's arguments are not among them).

Ops that DTensor runs on global-shape fake tensors only to infer output
shapes (its sharding propagation) are not the rank's work and are skipped.
A reshape that DTensor refuses because a sharded dim does not split evenly
(a flattened heads dim of 24 heads over 16 ranks) is retried after that
dim's mesh axes move to a dim the reshape keeps (the sequence: an
all-to-all) or, where none divides, are gathered; XLA pads instead. Any
other refused op is retried on inputs gathered step by step (``fallbacks``
counts the retries), and the collectives of each retry are counted.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from .hlo import CollectiveStats

__all__ = ["StepCensus", "COLLECTIVE_KINDS"]

# functional collective (``_c10d_functional``) -> the reference's HLO kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "_local_scalar_dense", "device",
               "wait_tensor", "lift_fresh", "set_", "resize_", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_same_size"}


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


_PLUMBING = ("torch/_ops.py", "torch/utils/_stats.py", "torch/_compile.py",
             "torch/_dynamo/eval_frame.py", "torch/utils/_python_dispatch.py",
             "torch/_subclasses/", "repro_torch/perf/census.py")
_FACTORIES = {"empty", "empty_strided", "zeros", "ones", "full", "new_empty", "new_zeros",
              "new_ones", "new_full", "empty_like", "zeros_like", "ones_like", "full_like"}


def _caller() -> tuple[bool, bool]:
    """(inside DTensor's output-shape inference, which runs the op on fake
    tensors of the global shape; called from torch.distributed's own code)."""
    f = sys._getframe(2)
    internal = None
    for _ in range(48):
        if f is None:
            break
        name = f.f_code.co_filename.replace("\\", "/")
        if name.endswith("_sharding_prop.py"):
            return True, True
        if internal is None and not any(m in name for m in _PLUMBING):
            internal = "torch/distributed/" in name
        f = f.f_back
    return False, bool(internal)


class StepCensus(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}  # id of a live storage -> its bytes
        self._dtensor_depth = 0
        self.fallbacks: dict[str, int] = defaultdict(int)  # op:stage -> retries

    # -- live-byte tracking -------------------------------------------------
    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)  # the storage's Python object lives as long as the storage
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._release, key)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if not func._schema.returns:  # a value check (``_assert_async``): fake values pass
                self.fallbacks[f"{func}:skipped"] += 1
                return None
            if self._dtensor_depth:
                return NotImplemented  # DTensor desugars it; its local ops come back here
            self._dtensor_depth += 1
            try:
                with self:
                    return self._dtensor_call(func, args, kwargs)
            finally:
                self._dtensor_depth -= 1
        if func.namespace == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under inference mode composite ops (matmul) arrive whole: count their parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        propagating, internal = _caller()
        if internal and func._overloadpacket.__name__ not in _FACTORIES \
                and not any(isinstance(a, FakeTensor) for a in tree_flatten((args, kwargs))[0]):
            # DTensor's index arithmetic (``torch.arange`` and views of it,
            # read back with ``tolist``) runs on real tensors
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not propagating:
            self._count(func, args, kwargs, out)
        return out

    def _dtensor_call(self, func, args, kwargs):
        """Run a DTensor op; where DTensor refuses it, gather its inputs step
        by step (the dims a refused reshape splits; then every dim but the
        leading batch dim; then everything) and run it again. The counts of
        a refused attempt are rolled back."""
        snapshot = self._snapshot()
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - refused ops are retried on gathered inputs
            error = e
        reshape = func.is_view or func._overloadpacket is torch.ops.aten._unsafe_view
        for stage in (("split",) if reshape else ()) + ("inner", "all"):
            self._restore(snapshot)
            try:
                if stage == "split":
                    args2 = (_reshard_for_reshape(args[0], args[1]), *args[1:])
                    kwargs2 = kwargs
                else:
                    keep = 1 if stage == "inner" else None
                    args2, kwargs2 = tree_map_only(
                        DTensor, lambda t: _gather(t, None if keep is None else range(keep, t.ndim)),
                        (args, kwargs))
                out = func(*args2, **kwargs2)
            except Exception:  # noqa: BLE001
                continue
            self.fallbacks[f"{func}:{stage}"] += 1
            return out
        raise error

    def _snapshot(self):
        c = self.collectives
        return (self.flops, self.bytes, dict(c.counts), dict(c.operand_bytes),
                dict(c.output_bytes))

    def _restore(self, snap) -> None:
        self.flops, self.bytes = snap[0], snap[1]
        for d, saved in zip((self.collectives.counts, self.collectives.operand_bytes,
                             self.collectives.output_bytes), snap[2:]):
            d.clear()
            d.update(saved)

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                self.collectives.counts[kind] += 1
                self.collectives.operand_bytes[kind] += sum(
                    _tensor_bytes(a) for a in tree_flatten(args)[0])
                self.collectives.output_bytes[kind] += sum(
                    _tensor_bytes(o) for o in tree_flatten(out)[0])
                self._track(out)
            return
        if name in _NO_TRAFFIC:
            if name.startswith("empty"):
                self._track(out)
            return
        if func.is_view or name == "_unsafe_view":  # aliases move no byte
            return
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](
                *tree_map_only(torch.Tensor, lambda x: x.shape, args),
                **tree_map_only(torch.Tensor, lambda x: x.shape, kwargs),
                out_val=out))
        self.bytes += sum(_tensor_bytes(a) for a in tree_flatten((args, kwargs))[0])
        self.bytes += sum(_tensor_bytes(o) for o in tree_flatten(out)[0])
        self._track(out)


def _reshard_for_reshape(src, shape):
    """``src`` (a DTensor) with each mesh axis that shards a dim the reshape
    to ``shape`` splits moved to the largest unsharded dim the reshape keeps
    that it divides (an all-to-all; XLA pads the split dim instead), or
    gathered where none does."""
    from torch.distributed.tensor import Replicate, Shard

    old, new = tuple(src.shape), tuple(shape)
    first = 0
    while first < min(len(old), len(new)) and old[first] == new[first]:
        first += 1
    taken = {p.dim for p in src.placements if isinstance(p, Shard)}
    target = []
    for md, p in enumerate(src.placements):
        if isinstance(p, Shard) and p.dim >= first:
            n = src.device_mesh.size(md)
            kept = [d for d in range(first) if d not in taken and old[d] % n == 0 and old[d] > 1]
            p = Shard(max(kept, key=lambda d: old[d])) if kept else Replicate()
            if isinstance(p, Shard):
                taken.add(p.dim)
        target.append(p)
    return src.redistribute(src.device_mesh, target)


def _gather(t, dims):
    """DTensor ``t`` with the mesh axes that shard any of ``dims`` (every
    dim for None) replicated, and its pending (Partial) sums reduced."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dims = set(range(t.ndim) if dims is None else dims)
    target = [p if isinstance(p, Shard) and p.dim not in dims else Replicate()
              for p in t.placements]
    if tuple(target) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, target)
