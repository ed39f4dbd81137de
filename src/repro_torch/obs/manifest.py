"""Run provenance: the manifest attached to the port's reports.

A manifest pins the run — seed, a hash of the resolved config, the git commit
(+dirty flag), and the package versions the closed forms ran on — WITHOUT any
timestamp, so artifacts that embed one stay byte-stable across same-seed
reruns on the same checkout.
"""

from __future__ import annotations

import hashlib
import json
import platform
import subprocess
from functools import lru_cache
from pathlib import Path

__all__ = ["run_manifest", "config_hash", "MANIFEST_VERSION"]

MANIFEST_VERSION = 1


def config_hash(config) -> str | None:
    """sha256 of the canonical-JSON resolved config (None passes through)."""
    if config is None:
        return None
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


@lru_cache(maxsize=1)
def _git_state() -> dict:
    """{"sha", "dirty"} of the checkout this package runs from, or
    {"sha": "unknown", "dirty": None} outside a git repo / without git."""
    cwd = Path(__file__).resolve().parent
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True,
        ).stdout.strip()
        porcelain = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True,
        ).stdout
        return {"sha": sha, "dirty": bool(porcelain.strip())}
    except (OSError, subprocess.SubprocessError):
        return {"sha": "unknown", "dirty": None}


@lru_cache(maxsize=1)
def _environment() -> dict:
    import numpy as np
    import torch

    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "packages": {"torch": torch.__version__, "numpy": np.__version__},
    }


def run_manifest(*, seed=None, config=None, extra=None) -> dict:
    """The provenance record for one run. Deliberately timestamp-free."""
    m = {
        "manifest_version": MANIFEST_VERSION,
        "seed": seed,
        "config_sha256": config_hash(config),
        "git": dict(_git_state()),
        **_environment(),
    }
    if extra:
        m["extra"] = dict(extra)
    return m
