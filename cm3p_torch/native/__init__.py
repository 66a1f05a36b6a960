"""The port's host C++ library: the .osu front end, the WAVE decoder and the analytics core.

``beatmap_fast.cpp`` (parse -> event lowering -> window token ids), ``audio_fast.cpp``
(WAVE decode -> downmix -> polyphase resample) and ``analytics.cpp`` (PCA, k-means,
normalisation, k-NN) build with the host ``g++`` at first use into one shared
library, ``cm3p_torch/_build/host/libcm3p_host-<hash>.so``. The hash covers the
sources, the flags and the host CPU (``-march=native`` code from one machine may
not run on another). Each builder compiles in a directory of its own and publishes
the library by an atomic rename, so test workers and loader workers may build at
once. A failed build raises with the compiler's output; nothing falls back to
Python quietly. Nothing here runs at import time.

``beatmap_fast`` and ``audio_fast`` replicate the Python / numpy float arithmetic
bit for bit, so they compile with ``-ffp-contract=off`` (a fused multiply-add
changes low-order bits); ``analytics`` keeps full optimisation.

The analytics functions below take ``native=False`` for their numpy versions,
which give the same results (the visualizer's JS fallbacks hold the same
semantics).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "_build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-fvisibility=hidden")
SOURCES = {  # source -> its extra flags
    "beatmap_fast.cpp": ("-ffp-contract=off",),
    "audio_fast.cpp": ("-ffp-contract=off",),
    "analytics.cpp": (),
}
LINK_FLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_LIB = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_st = ctypes.c_size_t
_SIGNATURES = {  # entry point -> (argtypes, restype)
    "cm3p_pca": ([_f32p, _st, _st, ctypes.c_uint32, _f32p], None),
    "cm3p_kmeans": ([_f32p, _st, _st, _st, ctypes.c_uint32, _i8p], None),
    "cm3p_kmeans_parallel": ([_f32p, _st, _st, _st, ctypes.c_uint32, ctypes.c_int, _i8p], None),
    "cm3p_normalize": ([_f32p, _st, _st, _f32p], None),
    "cm3p_normalize_parallel": ([_f32p, _st, _st, ctypes.c_int, _f32p], None),
    "cm3p_knn": ([_f32p, _st, _st, _st, _st, _u32p, _f32p], _st),
}


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH to build cm3p_torch/native")
    return path


def _host_cpu() -> bytes:
    """The CPU's model and feature flags (what ``-march=native`` resolves to)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    lines = [line for line in text.splitlines() if line.startswith(("model name", "flags", "Features"))]
    return "\n".join(dict.fromkeys(lines)).encode()


def target() -> Path:
    """The library's path for these sources, flags and host CPU."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode() + _host_cpu())
    for name, extra in SOURCES.items():
        digest.update(name.encode() + b"\0" + " ".join(extra).encode() + b"\0")
        digest.update((SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libcm3p_host-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the three sources (one ``g++`` each, all at once) and link them, unless built already."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix=".build-") as work:
        procs = []
        for name, extra in SOURCES.items():
            obj = Path(work) / f"{Path(name).stem}.o"
            cmd = [cxx, *CXX_FLAGS, *extra, "-c", "-o", str(obj), str(SOURCE_DIR / name)]
            procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                     text=True)))
        failures = []
        for name, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name} (exit {proc.returncode}):\n{log}")
        if failures:
            raise RuntimeError("host library build failed:\n" + "\n".join(failures))
        lib = Path(work) / out.name
        run = subprocess.run([cxx, *LINK_FLAGS, "-o", str(lib), *(str(obj) for _, obj, _ in procs)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"host library link failed (exit {run.returncode}):\n{run.stdout}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded host library (built if needed) with every entry point's signature declared."""
    global _LIB
    with _lock:
        if _LIB is None:
            from . import audio, beatmap

            lib = ctypes.CDLL(str(build()))
            for table in (_SIGNATURES, beatmap.SIGNATURES, audio.SIGNATURES):
                for fn, (argtypes, restype) in table.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            _LIB = lib
    return _LIB


def _as_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(x: np.ndarray, typ):
    return x.ctypes.data_as(typ)


# ---------------------------------------------------------------------- PCA


def calculate_pca(embeddings: np.ndarray, seed: int = 12345, native: bool = True) -> np.ndarray:
    """Project (n, d) embeddings to 2-D via power-iteration PCA."""
    emb = _as_f32(embeddings)
    n, d = emb.shape
    if n == 0 or d == 0:
        return np.zeros((0, 2), np.float32)
    if not native:
        return _pca_numpy(emb, seed)
    out = np.zeros((n, 2), np.float32)
    library().cm3p_pca(_ptr(emb, _f32p), n, d, seed, _ptr(out, _f32p))
    return out


def _pca_numpy(emb: np.ndarray, seed: int) -> np.ndarray:
    # start vectors come from the same LCG chain as the C++ core (state / 2^32 - 0.5);
    # plain Python ints with an explicit mask: np.uint32 arithmetic would warn on the intended overflow
    state = int(seed if seed else 12345) & 0xFFFFFFFF

    def lcg_unit():
        nonlocal state
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        return float(state) / 4294967296.0

    centered = emb - emb.mean(axis=0)
    comps = []
    for c in range(2):
        ev = np.asarray([lcg_unit() - 0.5 for _ in range(emb.shape[1])], np.float32)
        ev /= np.linalg.norm(ev) + 1e-12
        for _ in range(8):
            nxt = centered.T @ (centered @ ev)
            mag = np.linalg.norm(nxt)
            if mag > 0:
                ev = nxt / mag
        if c == 1:
            ev -= (comps[0] @ ev) * comps[0]
            mag = np.linalg.norm(ev)
            if mag > 0:
                ev /= mag
        comps.append(ev)
    return np.stack([centered @ comps[0], centered @ comps[1]], axis=1).astype(np.float32)


# ------------------------------------------------------------------- kmeans


def calculate_kmeans(
    embeddings: np.ndarray, k: int, seed: int = 42, n_threads: int = 1, native: bool = True
) -> np.ndarray:
    """Lloyd k-means labels (int8), max-distance init, <= 10 iterations."""
    emb = _as_f32(embeddings)
    n, d = emb.shape
    if n == 0 or k == 0:
        return np.zeros(0, np.int8)
    if not native:
        return _kmeans_numpy(emb, k, seed)
    labels = np.zeros(n, np.int8)
    lib = library()
    if n_threads > 1:
        lib.cm3p_kmeans_parallel(_ptr(emb, _f32p), n, d, k, seed, n_threads, _ptr(labels, _i8p))
    else:
        lib.cm3p_kmeans(_ptr(emb, _f32p), n, d, k, seed, _ptr(labels, _i8p))
    return labels


def _kmeans_numpy(emb: np.ndarray, k: int, seed: int) -> np.ndarray:
    n, d = emb.shape
    state = int(seed) & 0xFFFFFFFF

    def lcg():
        nonlocal state
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        return state

    centroids = np.zeros((k, d), np.float32)
    centroids[0] = emb[lcg() % n]
    distances = np.full(n, np.inf, np.float32)
    for i in range(1, k):
        dist = ((emb - centroids[i - 1]) ** 2).sum(axis=1)
        distances = np.minimum(distances, dist)
        centroids[i] = emb[int(np.argmax(distances))]

    labels = np.zeros(n, np.int8)
    for it in range(10):
        d2 = ((emb[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        new_labels = d2.argmin(axis=1).astype(np.int8)
        changed = int((new_labels != labels).sum())
        labels = new_labels
        if it > 0 and changed == 0:
            break
        for c in range(k):
            mask = labels == c
            if mask.any():
                centroids[c] = emb[mask].mean(axis=0)
    return labels


# ---------------------------------------------------------------- normalize


def normalize_vectors(embeddings: np.ndarray, n_threads: int = 1, native: bool = True) -> np.ndarray:
    """Per-row L2 normalisation; all-zero rows stay zero."""
    emb = _as_f32(embeddings)
    n, d = emb.shape
    if not native:
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        return np.where(norms > 0, emb / np.maximum(norms, 1e-30), 0.0).astype(np.float32)
    out = np.zeros_like(emb)
    lib = library()
    if n_threads > 1:
        lib.cm3p_normalize_parallel(_ptr(emb, _f32p), n, d, n_threads, _ptr(out, _f32p))
    else:
        lib.cm3p_normalize(_ptr(emb, _f32p), n, d, _ptr(out, _f32p))
    return out


# ---------------------------------------------------------------------- kNN


def find_nearest_neighbors(
    normalized: np.ndarray, query_idx: int, n_neighbors: int, native: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine-distance neighbours of row ``query_idx``: (indices, distances), nearest first."""
    emb = _as_f32(normalized)
    n, d = emb.shape
    if query_idx >= n or n < 2:
        return np.zeros(0, np.uint32), np.zeros(0, np.float32)
    k = min(n_neighbors, n - 1)
    if not native:
        dist = 1.0 - emb @ emb[query_idx]
        dist[query_idx] = np.inf
        order = np.argpartition(dist, k - 1)[:k]
        order = order[np.argsort(dist[order])]
        return order.astype(np.uint32), dist[order].astype(np.float32)
    indices = np.zeros(k, np.uint32)
    dists = np.zeros(k, np.float32)
    got = library().cm3p_knn(_ptr(emb, _f32p), n, d, query_idx, k, _ptr(indices, _u32p), _ptr(dists, _f32p))
    return indices[:got], dists[:got]
