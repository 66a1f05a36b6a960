"""Profiling and tracing: the counterpart of the JAX package's ``utils/profiling.py``.

:func:`trace` wraps ``torch.profiler.profile`` (the CPU activity, and the CUDA
activity when a GPU is used) and writes a Chrome trace into ``log_dir`` when
the block ends; :func:`annotate` is a named span in that trace
(``torch.profiler.record_function``). :class:`StepTimer` accumulates
wall-clock step times with the JAX package's summary (the same keys, numpy
percentiles and ``skip_warmup``); a caller timing CUDA work synchronises
inside the timed block. :func:`device_memory_stats` and :func:`probe_link`
report the CUDA devices' memory and one host -> device -> host round trip.

    with trace("traces/run1"):
        with annotate("step"):
            step(batch)

    timer = StepTimer()
    for batch in data:
        with timer:
            step(batch)
            torch.cuda.synchronize()
    print(timer.summary())
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]):
    """Profile the block and write ``log_dir/trace.json`` (a Chrome trace; open it in Perfetto): the CPU
    activity, and the CUDA activity where a GPU is available. Yields the profiler."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """A named region that shows up in traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulate wall-clock step times; robust percentiles in summary."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, skip_warmup: int = 1) -> dict:
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": len(self.times),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p95_s": float(np.percentile(ts, 95)),
            "steps_per_sec": float(1.0 / ts.mean()) if ts.mean() > 0 else 0.0,
        }


def device_memory_stats() -> dict:
    """Per CUDA device: ``bytes_in_use``, ``peak_bytes_in_use`` (PyTorch's allocator) and ``bytes_limit``
    (the device's total memory); ``{}`` without a GPU."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return stats


def probe_link(size_mb: int = 16, repeats: int = 2, device: Optional[Union[str, torch.device]] = None) -> dict:
    """The host <-> device link: one ``size_mb`` float32 round trip, best of ``repeats`` (the first may pay
    allocation); MB/s counts both directions (2 x ``size_mb`` / wall). ``device`` None means ``cuda``, which
    raises without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_link on cuda but torch.cuda.is_available() is False; pass device='cpu'")
    x = torch.ones(size_mb * 1024 * 1024 // 4, dtype=torch.float32)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        d = x.to(device)
        d.cpu()  # a full fetch: the completion barrier and the down leg
        best = min(best, time.perf_counter() - t0)
    return {
        "size_mb": size_mb,
        "roundtrip_s": round(best, 4),
        "mb_per_s": round(2 * size_mb / max(best, 1e-9), 1),
        "device": str(device),
    }
