"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/<name>-<hash>.so``
(``_build/`` sits beside ``csrc/`` and is listed in ``.gitignore``), with a
plain C interface and no PyTorch headers, so a build takes seconds. The hash
covers the source, every shared header (``csrc/*.cuh``) and the flags: an
edited source or header builds anew, an unchanged one loads from the earlier
build. Nothing builds at import:
the first call of a kernel's wrapper builds its library (``build`` builds
several at once, one nvcc process each, all started together).

The wrappers pass raw pointers (``tensor.data_ptr()``) and PyTorch's current
stream; every C entry returns ``cudaGetLastError()`` after its launches and
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "SOURCES", "DTYPE_CODES", "build", "build_log", "function", "check", "stream_handle",
    "check_cuda_tensors", "requires_grad", "refuse_grad",
]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("rmsnorm", "flash_attention", "decode_attention", "lindley_scan", "decision_scan",
           "ssm_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; the port's CUDA "
                           "kernels build on a machine with the CUDA toolkit")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):  # every shared header
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) of ``name``'s build."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, Path]:
    """Build every named library that is not built yet, one nvcc each, in parallel."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry ``symbol`` of library ``name`` with its signature declared."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _functions[key] = fn
    return fn


def check(code: int, name: str) -> None:
    """Raise if a C entry of library ``name`` returned a CUDA error."""
    if code != 0:
        msg = _library(name).repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def stream_handle() -> int:
    """PyTorch's current stream on the current card, as a pointer for ctypes."""
    return torch.cuda.current_stream().cuda_stream


def check_cuda_tensors(**tensors: torch.Tensor) -> None:
    """The layout every kernel here reads: on the current card, unit stride on
    the last dimension, 16-byte aligned, other strides in 16-byte steps."""
    device = torch.cuda.current_device()
    for name, t in tensors.items():
        if t.device.index != device:
            raise ValueError(f"{name} is on {t.device}, but the current device is cuda:{device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on its last dimension, got {t.stride()}")
        per16 = 16 // t.element_size()
        steps = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(st % per16 for st in steps) or t.shape[-1] % per16:
            raise ValueError(f"{name} must be 16-byte aligned with strides and last dimension "
                             f"in multiples of {per16} elements; got shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")


def requires_grad(*tensors: torch.Tensor | None) -> bool:
    """Grad mode is on and an input requires grad: a wrapper's output must
    then carry a gradient (``None`` inputs are skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, item: str, *tensors: torch.Tensor | None) -> None:
    """Raise ``NotImplementedError`` where a kernel without a backward would
    return a detached output (``requires_grad``). ``item`` names the ROADMAP
    item that is to add the backward."""
    if requires_grad(*tensors):
        raise NotImplementedError(f"{name} has no backward on the card (its output would carry "
                                  f"no gradient); {item} is to add one. Run this model's "
                                  "training on the CPU, where the plain version is differentiated")
