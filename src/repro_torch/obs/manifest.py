"""Run provenance: the manifest attached to the port's reports.

A manifest pins the run — seed, a hash of the resolved config, the git commit
(+dirty flag), and the package versions the closed forms ran on — WITHOUT any
timestamp, so artifacts that embed one stay byte-stable across same-seed
reruns on the same checkout.

``manifest_delta`` lists the provenance differences between two manifests:
a comparison of two runs stays valid when they differ, but says what changed.
"""

from __future__ import annotations

import hashlib
import json
import platform
import subprocess
from functools import lru_cache
from pathlib import Path

__all__ = ["run_manifest", "config_hash", "manifest_delta", "MANIFEST_VERSION"]

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


# keys whose drift is worth reporting (seed/config differences are usually
# the run's *point*, not provenance drift)
_DRIFT_KEYS = ("git", "python", "platform", "packages")


def manifest_delta(a: dict | None, b: dict | None) -> list[str]:
    """Human-readable list of provenance differences between two manifests.

    Empty list => same provenance (or one side has no manifest to compare —
    absence is reported by the caller, not guessed at here). A drift key
    missing entirely from one side is skipped, not drift: a committed
    baseline may strip the machine/git-bound fields, and a stripped baseline
    vs a full fresh manifest would otherwise report perpetual pseudo-drift.
    """
    if not a or not b:
        return []
    out: list[str] = []
    for key in _DRIFT_KEYS:
        if key not in a or key not in b:
            continue
        va, vb = a.get(key), b.get(key)
        if va == vb:
            continue
        if isinstance(va, dict) and isinstance(vb, dict):
            for sub in sorted(set(va) | set(vb)):
                if va.get(sub) != vb.get(sub):
                    out.append(f"{key}.{sub}: {va.get(sub)!r} -> {vb.get(sub)!r}")
        else:
            out.append(f"{key}: {va!r} -> {vb!r}")
    return out
