"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``cm3p_torch/_build/lib<name>-<hash>.so`` (the hash covers the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source rebuilds). The libraries expose plain C entry
points; wrappers pass ``data_ptr()`` values and the current stream as
``c_void_p`` and raise when an entry point returns a CUDA error code.
Nothing here runs at import time.

``checked=True`` (``build``, ``library``) builds and loads the bounds-checked
form of a source in ``CHECKED_SOURCES`` instead: the same source with
``CHECKED_FLAGS`` (line info and the ``ATTN_BOUNDS_CHECK`` define of
``csrc/bounds.cuh``), into its own ``lib<name>-checked-<hash>.so``. Only that
argument selects it; ``ops.attention.checked_kernels`` is the way the
wrappers ask for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("attention", "attention_wo", "attention_bwd", "fused_ffn", "fused_ln_matmul", "attention_f32",
                  "fused_ffn_f32", "fused_ln_matmul_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
CHECKED_SOURCES = ("attention", "attention_bwd")  # the sources with a bounds-checked build
CHECKED_FLAGS = ("-lineinfo", "-DATTN_BOUNDS_CHECK")

_lock = threading.Lock()
_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name ("<name> (checked)" for a checked build) -> nvcc's output (ptxas report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def flags(checked: bool = False) -> tuple[str, ...]:
    """nvcc's flags for a source's default build, or for its bounds-checked build."""
    return NVCC_FLAGS + CHECKED_FLAGS if checked else NVCC_FLAGS


def _target(name: str, checked: bool = False) -> Path:
    if checked and name not in CHECKED_SOURCES:
        raise ValueError(f"{name}.cu has no bounds-checked build (those are {', '.join(CHECKED_SOURCES)})")
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(flags(checked)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}{'-checked' if checked else ''}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES, checked: bool = False) -> dict[str, float]:
    """Compile every missing library, one nvcc process per source, all at once (with ``checked`` the
    bounds-checked builds of ``names``, each a source of ``CHECKED_SOURCES``).

    Returns seconds spent per built source (0.0 where the library existed).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name, checked)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(checked), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[f"{name} (checked)" if checked else name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu{' (checked)' if checked else ''} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str, signatures: dict, checked: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed; with ``checked`` its bounds-checked build.

    ``signatures`` maps entry-point names to their ctypes argtypes; every
    entry point returns a C int (a cudaError_t).
    """
    with _lock:
        lib = _libs.get((name, checked))
        if lib is None:
            build((name,), checked)
            lib = ctypes.CDLL(str(_target(name, checked)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[(name, checked)] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
