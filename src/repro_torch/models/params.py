"""Parameter templates: one source of truth for shapes and init rules.

The port's copy of ``repro.models.params``. A model declares its parameters
as a nested tree (dicts and tuples) of ``TSpec`` leaves. From the template:

  * ``count_params`` — exact parameter count, with nothing allocated
  * ``init_tensor``  — one leaf's tensor, drawn from a ``torch.Generator``
    seeded by (seed, the leaf's path): deterministic and independent of the
    order in which leaves are made
  * ``ParamTree``    — an ``nn.Module`` holding a template's tensors

``stack`` prepends a stacked-layer dimension (the JAX package scans its
layers; the port keeps the stacked shapes for caches and for counting).
``jax.random`` streams cannot be replayed here, so the port's random weights
differ from the reference's for the same seed; tests hand both packages the
same numpy weights instead (``models.convert``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = [
    "TSpec",
    "stack",
    "tree_map",
    "count_params",
    "init_tensor",
    "ParamTree",
    "torch_dtype",
]


@dataclass(frozen=True)
class TSpec:
    """One parameter leaf."""

    shape: tuple[int, ...]
    axes: tuple  # logical axis names (len == ndim), None = replicated
    init: str = "normal"  # "normal" | "zeros" | "ones" | "fan_in"
    std: float = 0.02
    dtype: str | None = None  # override model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn, tree: Any, path: str = "") -> Any:
    """Map ``fn(path, leaf)`` over the TSpec leaves of a dict/tuple tree; paths
    are dotted like ``state_dict`` keys ("attn.wq", "0.k")."""
    if isinstance(tree, TSpec):
        return fn(path, tree)
    join = (lambda k: f"{path}.{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, join(i)) for i, v in enumerate(tree))
    raise TypeError(f"unexpected template node {type(tree).__name__} at {path!r}")


def stack(template: Any, n: int) -> Any:
    """Prepend a stacked-layer dim of size n to every leaf."""
    return tree_map(
        lambda _, leaf: replace(leaf, shape=(n, *leaf.shape), axes=(None, *leaf.axes)), template)


def count_params(template: Any) -> int:
    total = 0

    def add(_, leaf: TSpec):
        nonlocal total
        total += int(np.prod(leaf.shape))

    tree_map(add, template)
    return total


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _path_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_tensor(leaf: TSpec, path: str, seed: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Materialise one leaf. Normal draws are made in fp32 and cast, as the
    reference does."""
    d = torch_dtype(leaf.dtype) if leaf.dtype else dtype
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=d, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=d, device=device)
    if leaf.init == "fan_in":
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        std = 1.0 / np.sqrt(fan_in)
    elif leaf.init == "normal":
        std = leaf.std
    else:
        raise ValueError(leaf.init)
    gen = torch.Generator(device=device)
    gen.manual_seed(_path_seed(seed, path))
    w = torch.randn(leaf.shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(d)


class ParamTree(nn.Module):
    """An ``nn.Module`` over a dict template: TSpec leaves become frozen
    parameters, nested dicts become child modules. ``tree["wq"]`` reads like
    the reference's param dicts, so the layer functions take either."""

    def __init__(self, template: dict, *, path: str, seed: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        for name, node in template.items():
            sub = f"{path}.{name}" if path else name
            if isinstance(node, TSpec):
                t = init_tensor(node, sub, seed, dtype, device)
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))
            elif isinstance(node, dict):
                self.add_module(name, ParamTree(node, path=sub, seed=seed, dtype=dtype,
                                                device=device))
            else:
                raise TypeError(f"unexpected template node {type(node).__name__} at {sub!r}")

    def __getitem__(self, name: str):
        return getattr(self, name)
