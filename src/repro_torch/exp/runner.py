"""Execute an :class:`~repro_torch.exp.spec.ExperimentSpec` into ``results/``
(the port's twin of the reference's ``exp/runner.py``).

Layout of one run::

    results/<exp-id>/<run-id>/
        manifest.json    run provenance (obs.run_manifest) + the exact spec
        metrics.json     per-seed metric leaves + cross-seed bootstrap CIs
        summary.md       human-readable digest; written LAST -> its presence
                         is the completion marker that enables resume-skip
        seed-<s>/        the artifacts the spec's output contract declares

The run id is deterministic: a hash of the spec, the seed list, the
machine/git provenance, and the device the payloads ran on (for a card, its
name too: a CPU run and a card run of one checkout are different runs).
Re-running the same spec on the same checkout and device lands in the same
directory and — because ``summary.md`` only appears once a run
finished — is skipped, while any spec/config/seed/toolchain change starts a
fresh directory instead of silently overwriting evidence.

Byte-stability is a contract, not an aspiration: :func:`diff_results`
compares two results trees file-by-file, masking only the dotted JSON paths
each spec declares wall-clock ``volatile``. Everything else must match to
the byte.

``device`` follows the port's rule: ``None`` means the CUDA card (and raises
where there is none); a payload that takes ``device`` gets it, as one that
takes ``seed`` or ``config`` gets those.
"""

from __future__ import annotations

import fnmatch
import hashlib
import importlib
import inspect
import json
import shutil
from dataclasses import dataclass
from numbers import Number
from pathlib import Path
from typing import Callable, Iterable, Mapping, Sequence

from repro_torch.exp.spec import ExperimentError, ExperimentSpec, registry
from repro_torch.obs import run_manifest

__all__ = [
    "RunResult",
    "resolve_payload",
    "call_payload",
    "device_key",
    "run_id_for",
    "run_experiment",
    "strip_volatile",
    "diff_results",
    "takes_device",
]

#: provenance keys that key a run id — a new git sha, interpreter, machine,
#: or dependency set is a different run, not a resume
_PROVENANCE_KEYS = ("git", "python", "platform", "packages")

#: files the runner itself writes at the run root (never part of the
#: payload's output contract, and excluded from the byte-stability diff —
#: metrics.json embeds wall-clock-derived leaves by design)
_RUNNER_FILES = ("manifest.json", "metrics.json", "summary.md")


def _dump(doc: Mapping) -> str:
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


@dataclass(frozen=True)
class RunResult:
    """Outcome of :func:`run_experiment` for one spec."""

    exp_id: str
    run_id: str
    run_dir: Path
    seeds: tuple[int, ...]
    skipped: bool
    passed: bool
    metrics: dict


#: the one package a payload may live in: the port resolves nothing of the
#: JAX package or of its ``benchmarks`` harness, whatever a spec names
_PAYLOAD_PACKAGE = "repro_torch"


def resolve_payload(payload: str) -> Callable:
    """Import the callable behind a ``"module.path:callable"`` reference; a
    module outside ``repro_torch`` is refused before anything is imported."""
    mod_name, _, attr = payload.partition(":")
    if mod_name.split(".")[0] != _PAYLOAD_PACKAGE:
        raise ExperimentError(
            f"payload {payload!r} lies outside {_PAYLOAD_PACKAGE}: the port "
            "resolves only its own modules")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ExperimentError(f"payload module {mod_name!r} not importable: {e}")
    fn = getattr(mod, attr, None)
    if not callable(fn):
        raise ExperimentError(f"payload {payload!r} is not a callable")
    return fn


def takes_device(fn: Callable) -> bool:
    """Whether a payload runs on a device (it declares ``device``)."""
    return "device" in inspect.signature(fn).parameters


def call_payload(fn: Callable, out_dir: Path, *, seed: int,
                 config: Mapping, device=None) -> dict:
    """Call a payload, passing ``seed``/``config``/``device`` only if it
    accepts them.

    Bench families keep the ``fn(out_dir, device=None) -> report`` shape;
    seed-sensitive payloads take ``fn(out_dir, seed=..., config=...,
    device=...)``; host-only ones (the figure suite, roofline) take no
    device. A payload returning ``None`` contributes no metrics (roofline).
    """
    params = inspect.signature(fn).parameters
    kwargs = {}
    if "seed" in params:
        kwargs["seed"] = seed
    if "config" in params:
        kwargs["config"] = config
    if "device" in params:
        kwargs["device"] = device
    result = fn(Path(out_dir), **kwargs)
    if result is None:
        return {}
    if not isinstance(result, Mapping):
        raise ExperimentError(
            f"payload {fn.__module__}.{fn.__qualname__} returned "
            f"{type(result).__name__}, expected a metrics mapping")
    return dict(result)


def device_key(device=None) -> dict:
    """Where a run's payloads execute: ``{"device": "cpu"}``, or for the card
    ``{"device": "cuda", "card": <its name>}``. ``None`` means the card and
    raises where there is none."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    key = {"device": dev.type}
    if dev.type == "cuda":
        key["card"] = torch.cuda.get_device_name(dev)
    return key


def run_id_for(spec: ExperimentSpec, seeds: Sequence[int], device=None) -> str:
    """Deterministic run id over (spec, seeds, machine/git provenance,
    device and card)."""
    return _run_id(spec, seeds, device_key(device))


def _run_id(spec: ExperimentSpec, seeds: Sequence[int], where: Mapping) -> str:
    prov = run_manifest()
    key = {
        "spec": spec.to_dict(),
        "seeds": [int(s) for s in seeds],
        "provenance": {k: prov.get(k) for k in _PROVENANCE_KEYS},
        "device": dict(where),
    }
    digest = hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()
    return "run-" + digest[:12]


def _flatten(doc: Mapping, prefix: str = "") -> dict:
    flat: dict = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = v
    return flat


def _gate_leaves(flat: Mapping) -> dict:
    """The boolean leaves that decide a run's verdict."""
    def is_gate(name: str) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        return leaf == "passed" or leaf.endswith("_passed") \
            or leaf.endswith("_gate_pass")
    return {k: v for k, v in flat.items() if is_gate(k)}


def _aggregate(per_seed: Mapping[int, Mapping]) -> dict:
    """Cross-seed stats per numeric metric leaf.

    With several seeds and genuinely varying values the entry carries a
    bootstrap 95% CI (reusing the validate layer's engine); a leaf identical
    across seeds is flagged ``seed_stable`` instead.
    """
    from repro_torch.validate.metrics import bootstrap_mean_ci

    keys: list[str] = []
    for flat in per_seed.values():
        for k in flat:
            if k not in keys:
                keys.append(k)
    agg: dict = {}
    for k in keys:
        vals = [flat[k] for flat in per_seed.values() if k in flat]
        if not vals or not all(
                isinstance(v, Number) and not isinstance(v, bool)
                for v in vals):
            continue
        vals = [float(v) for v in vals]
        entry: dict = {"n_seeds": len(vals), "mean": sum(vals) / len(vals)}
        if len(vals) > 1 and max(vals) > min(vals):
            ci = bootstrap_mean_ci(vals, seed=0)
            entry.update(ci95_lo=ci.lo, ci95_hi=ci.hi, seed_stable=False)
        else:
            entry["seed_stable"] = True
        agg[k] = entry
    return agg


def _summary_md(spec: ExperimentSpec, run_id: str, seeds: Sequence[int],
                metrics: Mapping) -> str:
    lines = [
        f"# {spec.exp_id}",
        "",
        spec.description or "(no description)",
        "",
        f"- kind: `{spec.kind}`",
        f"- payload: `{spec.payload}`",
        f"- run id: `{run_id}`",
        f"- seeds: {list(seeds)}",
        f"- verdict: **{'PASS' if metrics['passed'] else 'FAIL'}**",
        "",
    ]
    gates = metrics.get("gate_leaves", {})
    if gates:
        lines += ["## Gates", ""]
        for k, v in sorted(gates.items()):
            lines.append(f"- `{k}`: {'PASS' if v else 'FAIL'}")
        lines.append("")
    agg = metrics.get("aggregate", {})
    if agg:
        lines += ["## Metrics", "",
                  "| metric | mean | 95% CI | seeds |", "|---|---|---|---|"]
        for k, e in agg.items():
            ci = (f"[{e['ci95_lo']:.6g}, {e['ci95_hi']:.6g}]"
                  if "ci95_lo" in e else "seed-stable")
            lines.append(f"| `{k}` | {e['mean']:.6g} | {ci} | {e['n_seeds']} |")
        lines.append("")
    outs = metrics.get("outputs", [])
    if outs:
        lines += ["## Artifacts", ""]
        lines += [f"- `{p}`" for p in outs]
        lines.append("")
    return "\n".join(lines)


def _stored_spec(run_dir: Path) -> dict | None:
    try:
        doc = json.loads((run_dir / "manifest.json").read_text())
        return doc["experiment"]["spec"]
    except (OSError, ValueError, KeyError):
        return None


def run_experiment(spec: ExperimentSpec, *,
                   results_root: Path = Path("results"),
                   seeds: Sequence[int] | None = None,
                   force: bool = False, device=None) -> RunResult:
    """Run one spec into ``results/<exp-id>/<run-id>/`` on ``device``
    (default: the card); see module doc.

    ``seeds`` overrides the spec's seed list only for seed-sensitive
    experiments — bench families pin their own internal seeds and always
    run exactly once.
    """
    if seeds is not None and spec.seed_sensitive:
        run_seeds = tuple(dict.fromkeys(int(s) for s in seeds))
    else:
        run_seeds = spec.seeds
    if not run_seeds:
        raise ExperimentError(f"{spec.exp_id}: empty seed list")

    where = device_key(device)
    run_id = _run_id(spec, run_seeds, where)
    run_dir = Path(results_root) / spec.exp_id / run_id

    if (run_dir / "summary.md").exists() and not force:
        if _stored_spec(run_dir) == spec.to_dict():
            try:
                metrics = json.loads((run_dir / "metrics.json").read_text())
            except (OSError, ValueError):
                metrics = {}
            return RunResult(spec.exp_id, run_id, run_dir, run_seeds,
                             skipped=True,
                             passed=bool(metrics.get("passed", False)),
                             metrics=metrics)
    if run_dir.exists():
        shutil.rmtree(run_dir)  # partial or forced: start clean
    run_dir.mkdir(parents=True)

    fn = resolve_payload(spec.payload)
    per_seed_flat: dict[int, dict] = {}
    produced: list[str] = []
    for s in run_seeds:
        seed_dir = run_dir / f"seed-{s}"
        seed_dir.mkdir()
        raw = call_payload(fn, seed_dir, seed=s, config=spec.config,
                           device=device)
        missing = [f for f in spec.outputs if not (seed_dir / f).exists()]
        if missing:
            raise ExperimentError(
                f"{spec.exp_id} seed {s}: payload did not produce declared "
                f"output(s) {missing}")
        _stamp_outputs(spec, seed_dir, seed=s)
        per_seed_flat[s] = _flatten(raw)
        produced += [f"seed-{s}/{f}" for f in spec.outputs]

    gate_leaves = {f"seed-{s}.{k}": v
                   for s, flat in per_seed_flat.items()
                   for k, v in _gate_leaves(flat).items()}
    passed = all(bool(v) for v in gate_leaves.values()) if gate_leaves \
        else True

    metrics = {
        "exp_id": spec.exp_id,
        "run_id": run_id,
        "seeds": list(run_seeds),
        "passed": passed,
        "gates": dict(spec.gates),
        "gate_leaves": gate_leaves,
        "per_seed": {str(s): flat for s, flat in per_seed_flat.items()},
        "aggregate": _aggregate(per_seed_flat),
        "outputs": produced,
    }

    manifest = run_manifest(seed=run_seeds[0], config=dict(spec.config))
    manifest["experiment"] = {"spec": spec.to_dict(),
                              "seeds": list(run_seeds), "run_id": run_id,
                              "device": where}
    (run_dir / "manifest.json").write_text(_dump(manifest))
    (run_dir / "metrics.json").write_text(_dump(metrics))
    # completion marker: everything above must already be on disk
    (run_dir / "summary.md").write_text(
        _summary_md(spec, run_id, run_seeds, metrics))
    return RunResult(spec.exp_id, run_id, run_dir, run_seeds,
                     skipped=False, passed=passed, metrics=metrics)


def _stamp_outputs(spec: ExperimentSpec, seed_dir: Path, *, seed: int) -> None:
    """Ensure every declared JSON artifact carries a provenance manifest.

    Payloads that already stamp one (validate, measured, cluster-sim) are
    left alone; bench families get theirs from
    ``repro_torch.bench.run.stamp_manifests`` and the same treatment here.
    """
    for fname in spec.outputs:
        path = seed_dir / fname
        if path.suffix != ".json":
            continue
        try:
            doc = json.loads(path.read_text())
        except ValueError:
            continue
        if not isinstance(doc, dict) or "manifest" in doc:
            continue
        doc["manifest"] = run_manifest(
            seed=seed, config={"exp_id": spec.exp_id, **dict(spec.config)})
        path.write_text(json.dumps(doc, indent=2) + "\n")


def strip_volatile(doc, patterns: Iterable[str]):
    """Deep-copy ``doc`` with every dotted-path pattern removed.

    Each ``.``-separated segment is an fnmatch pattern, so
    ``"*.us_per_call"`` masks that leaf under every top-level key. Matching
    a non-leaf segment removes the whole subtree.
    """
    doc = json.loads(json.dumps(doc))
    for pat in patterns:
        _strip_one(doc, pat.split("."))
    return doc


def _strip_one(node, segs: list[str]) -> None:
    if not isinstance(node, dict) or not segs:
        return
    head, rest = segs[0], segs[1:]
    for key in [k for k in node if fnmatch.fnmatch(str(k), head)]:
        if rest:
            _strip_one(node[key], rest)
        else:
            del node[key]


def _volatile_for(rel: Path, reg: Mapping[str, ExperimentSpec]) -> tuple[str, ...] | None:
    """Declared volatile paths for a results-tree file, else None.

    ``rel`` is relative to a results root: ``<exp-id>/<run-id>/...``.
    Returns ``None`` for files outside any spec's output contract (those
    must be byte-identical), or the masking patterns for declared artifacts.
    """
    if not rel.parts:
        return None
    spec = reg.get(rel.parts[0])
    if spec is None:
        return None
    if rel.name in spec.outputs:
        return tuple(spec.volatile.get(rel.name, ()))
    return None


def diff_results(root_a: Path, root_b: Path,
                 reg: Mapping[str, ExperimentSpec] | None = None) -> list[str]:
    """Byte-stability diff of two results trees; ``[]`` means stable.

    Runner-owned ``metrics.json``/``summary.md`` are excluded (they embed
    wall-clock-derived leaves by design); ``manifest.json`` and every
    payload artifact are compared — JSON artifacts after masking their
    spec-declared volatile paths, everything else byte-for-byte.
    """
    reg = registry() if reg is None else reg
    root_a, root_b = Path(root_a), Path(root_b)

    skip = ("metrics.json", "summary.md", "REPRODUCTION.md")

    def files_of(root: Path) -> dict[Path, Path]:
        return {p.relative_to(root): p for p in sorted(root.rglob("*"))
                if p.is_file() and p.name not in skip}

    a_files, b_files = files_of(root_a), files_of(root_b)
    diffs: list[str] = []
    for rel in sorted(set(a_files) - set(b_files)):
        diffs.append(f"only in {root_a}: {rel}")
    for rel in sorted(set(b_files) - set(a_files)):
        diffs.append(f"only in {root_b}: {rel}")
    for rel in sorted(set(a_files) & set(b_files)):
        raw_a = a_files[rel].read_bytes()
        raw_b = b_files[rel].read_bytes()
        if raw_a == raw_b:
            continue
        vol = _volatile_for(rel, reg)
        if vol is not None and rel.suffix == ".json":
            try:
                doc_a = strip_volatile(json.loads(raw_a), vol)
                doc_b = strip_volatile(json.loads(raw_b), vol)
            except ValueError:
                diffs.append(f"differs (unparseable JSON): {rel}")
                continue
            if _dump(doc_a) == _dump(doc_b):
                continue
            diffs.append(f"differs beyond declared-volatile fields: {rel}")
        else:
            diffs.append(f"differs: {rel}")
    return diffs
