"""Fault-tolerant checkpointing: the port of ``repro.checkpoint.checkpointer``.

  * atomic: a snapshot is written into a temporary file in the checkpoint
    directory and renamed into place (``os.replace``), so a crash mid-write
    never corrupts the latest checkpoint and leaves no ``.tmp`` file behind;
  * self-describing: ``torch.save`` of the tree (dicts, lists, tuples, None
    and tensors, each tensor keeping its dtype and shape), read back with
    ``torch.load(weights_only=True)``, which unpickles nothing but those.
    The reference writes msgpack with ml_dtypes; the machine with the card
    has neither, and torch's format carries bfloat16 itself;
  * device-agnostic: tensors are saved from the host and ``restore`` puts
    them on the device it is asked for, in their saved dtypes (or a target's);
  * bounded retention: the ``keep`` newest checkpoints are retained.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any

import torch

from repro_torch.device import resolve_device

__all__ = ["Checkpointer", "save_pytree", "load_pytree"]


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def _cast(tree: Any, target: Any, path: str = "") -> Any:
    """The loaded ``tree`` checked against ``target`` (the same structure with
    (shape, dtype) leaves) and cast to its dtypes."""
    if _is_spec(target):
        shape, dtype = target
        if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(shape):
            got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__
            raise ValueError(f"{path or 'checkpoint'}: {got} vs target {tuple(shape)}")
        return tree.to(dtype)
    if isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            raise ValueError(f"{path or 'checkpoint'}: keys differ from the target's")
        return {k: _cast(tree[k], t, f"{path}.{k}" if path else str(k)) for k, t in target.items()}
    raise TypeError(f"unexpected target node {type(target).__name__} at {path!r}")


def save_pytree(path: str | Path, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically (a temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(_to_host(tree), fh)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def load_pytree(path: str | Path, *, device: str | torch.device | None = None,
                target: Any = None) -> Any:
    """The tree saved at ``path``, its tensors on ``device`` (the CUDA card
    when None) in their saved dtypes, or checked against ``target`` and
    cast to its dtypes."""
    tree = torch.load(path, map_location=resolve_device(device), weights_only=True)
    return tree if target is None else _cast(tree, target)


class Checkpointer:
    """Step-indexed checkpoint directory with retention and resume."""

    _PAT = re.compile(r"^step_(\d+)\.ckpt$")

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.ckpt"

    def save(self, step: int, tree: Any) -> Path:
        p = self._path(step)
        save_pytree(p, tree)
        self._gc()
        return p

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in self.dir.iterdir()
                      if (m := self._PAT.match(f.name)))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, *, device: str | torch.device | None = None,
                target: Any = None) -> tuple[int, Any]:
        """(step, tree) of ``step`` (the latest when None), as ``load_pytree``
        gives it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, load_pytree(self._path(step), device=device, target=target)

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            self._path(s).unlink(missing_ok=True)
