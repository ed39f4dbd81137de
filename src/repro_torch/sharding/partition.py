"""Logical-axis sharding: t5x-style rules mapping logical axis names to mesh axes.

The port of ``repro.sharding.partition``. Model code annotates activations
with *logical* axis names ("batch", "heads", "ff", ...) through ``hint``; a
``ShardingRules`` context resolves those names to the axes of a torch
``DeviceMesh`` and redistributes a ``DTensor`` to the placements they give.
Outside any context every hint returns its input after one thread-local
read, so the serving and training paths (plain tensors, no rules) run as
before and launch what they launched.

Baseline rules: Megatron-style tensor parallelism over "model", batch data
parallelism over ("pod", "data"), optimizer state further sharded over
"data" (ZeRO-1, see ``training/optimizer.py``).

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (sharded over their product, the first the
outermost). ``placements`` turns a spec into one DTensor placement per mesh
dim. A mesh here is a ``DeviceMesh`` (``mesh_dim_names`` and a shape tuple)
or anything with the reference's ``shape`` mapping and ``axis_names``:
``rules_for_cell`` reads only those.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, replace

__all__ = ["ShardingRules", "rules_for_cell", "use_rules", "current_rules", "hint",
           "logical_to_spec", "named_sharding", "placements", "axis_sizes", "axis_names",
           "write_slot"]


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, for a ``DeviceMesh`` or the reference's mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}
    return {n: int(s) for n, s in dict(mesh.shape).items()}


@dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> mesh axis (str | tuple | None)."""

    mesh: object
    rules: dict[str, object] = field(default_factory=dict)

    @staticmethod
    def default(mesh, *, seq_parallel: bool = False) -> "ShardingRules":
        batch_axes = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
        rules = {
            "batch": batch_axes,  # batch dim of activations / data
            "seq": "model" if seq_parallel else None,  # residual-stream sequence dim
            "seq_inner": None,  # interior activations (heads/ff already use model)
            "kv_seq": None,  # key/value sequence dim (cache; see decode rules)
            "embed": None,  # d_model dim of activations & params
            "heads": "model",  # attention heads (param + activation)
            "qkv": "model",  # flattened heads*head_dim param dim
            "kv": "model",  # flattened kv_heads*head_dim param dim
            "ff": "model",  # MLP hidden
            "vocab": "model",  # embedding/logits vocab dim
            "expert": "model",  # MoE expert dim
            "expert_ff": "data",  # per-expert hidden (480B-class stacks shard over data too)
            "zero": "data",  # ZeRO-1 optimizer-state axis
            "mlstm_dk": "model",  # xLSTM matrix-memory key dim
            "cache_batch": batch_axes,  # KV cache batch dim
            "cache_kv": "model",  # KV cache flattened kv feature dim
            "cache_seq": None,  # KV cache sequence dim (long_500k: "data")
            "conv_state": None,
        }
        return ShardingRules(mesh, rules)

    def with_overrides(self, **overrides) -> "ShardingRules":
        new = dict(self.rules)
        new.update(overrides)
        return replace(self, rules=new)

    def spec(self, logical_axes: tuple) -> tuple:
        return tuple(None if ax is None else self.rules.get(ax) for ax in logical_axes)

    def placements(self, logical_axes: tuple) -> tuple:
        return placements(self.spec(logical_axes), self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(i)`` where tensor dim i's
    entry names that mesh axis, else ``Replicate()``. An entry naming several
    axes shards its dim over each of them, outermost first, as the
    reference's ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for i, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax in owner:
                raise ValueError(f"mesh axis {ax!r} appears twice in {spec}")
            owner[ax] = i
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in axis_names(mesh))


def rules_for_cell(cfg, shape, mesh, *, seq_parallel: bool = False) -> ShardingRules:
    """Resolve rules for one (arch x shape x mesh) cell, honouring divisibility.

    * batch axes: the largest prefix of (pod, data) whose product divides the
      global batch (long_500k's batch=1 shards nothing);
    * vocab: replicated when the padded vocab is not divisible by the model axis;
    * decode caches: sequence-sharded over "model" (split-KV decode); for
      unsharded-batch cells over every axis that divides the cache length.
    """
    sizes = axis_sizes(mesh)
    names = axis_names(mesh)
    model = sizes.get("model", 1)
    # sequence parallelism for full-sequence steps: residual stream sharded
    # over model (Megatron-SP); decode has seq=1 so it never applies.
    # cfg.seq_parallel "on"/"off" overrides the heuristic.
    sp_mode = getattr(cfg, "seq_parallel", "auto")
    if sp_mode == "off":
        seq_parallel = False
    elif sp_mode == "on":
        seq_parallel = shape.seq_len % model == 0
    else:
        seq_parallel = seq_parallel or (
            shape.kind in ("train", "prefill") and shape.seq_len % model == 0)
    rules = ShardingRules.default(mesh, seq_parallel=seq_parallel)

    cand = ("pod", "data") if "pod" in names else ("data",)
    batch_axes: tuple = ()
    prod = 1
    for ax in cand:
        if shape.global_batch % (prod * sizes[ax]) == 0:
            batch_axes += (ax,)
            prod *= sizes[ax]
    batch_rule = batch_axes if batch_axes else None
    overrides: dict = {"batch": batch_rule, "cache_batch": batch_rule}

    if cfg.padded_vocab % model:
        overrides["vocab"] = None
    if cfg.num_experts and cfg.d_ff % sizes.get("data", 1):
        overrides["expert_ff"] = None
    if cfg.num_experts and shape.kind == "decode":
        # inference holds no optimizer state, so expert weights stay resident
        # instead of being gathered over "data" every decode step
        overrides["expert_ff"] = None

    if shape.kind == "decode":
        cache_axes: tuple = ()
        cprod = 1
        lens = [shape.seq_len]
        if cfg.has_mixer("attn_local"):
            lens.append(min(shape.seq_len, cfg.window_size))
        axis_order = ("model",) if batch_axes else tuple(
            a for a in ("pod", "data", "model") if a in names)
        for ax in axis_order:
            if all(n % (cprod * sizes[ax]) == 0 for n in lens):
                cache_axes += (ax,)
                cprod *= sizes[ax]
        overrides["cache_seq"] = cache_axes if cache_axes else None
    elif shape.kind == "prefill":
        # emit caches already in decode layout
        if shape.seq_len % model == 0 and (
                not cfg.has_mixer("attn_local") or min(shape.seq_len, cfg.window_size) % model == 0):
            overrides["cache_seq"] = "model"

    return rules.with_overrides(**overrides)


_local = threading.local()


@contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_local, "rules", None)


def logical_to_spec(logical_axes: tuple) -> tuple | None:
    rules = current_rules()
    if rules is None:
        return None
    return rules.spec(logical_axes)


def hint(x, *logical_axes):
    """Under the active rules, redistribute a DTensor to the placements its
    logical axes resolve to (the reference's ``with_sharding_constraint``);
    the identity otherwise, and for a plain tensor."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank {x.ndim} vs logical axes {logical_axes}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    target = rules.placements(logical_axes)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def write_slot(cache, slot: int, value) -> None:
    """``cache[:, slot] = value`` in place. A DTensor cache sharded over its
    slot dim is written shard by shard, each rank at its local slot
    ``slot % local length``, as XLA partitions a dynamic-update-slice, instead
    of DTensor gathering the whole cache to write one slot."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if current_rules() is None or not isinstance(cache, DTensor) or not any(
            isinstance(p, Shard) and p.dim == 1 for p in cache.placements):
        cache[:, slot] = value
        return
    # value (B, ...) lies as the cache does, without its slot dim
    target = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1
                   else Shard(p.dim - (p.dim > 1)) for p in cache.placements)
    local = cache.to_local()
    local[:, slot % local.shape[1]] = value.redistribute(value.device_mesh, target).to_local()


def named_sharding(logical_axes: tuple) -> tuple | None:
    """The placements the active rules give these logical axes (the twin of
    the reference's ``NamedSharding``); None with no rules active."""
    rules = current_rules()
    if rules is None:
        return None
    return rules.placements(logical_axes)
