"""Profiling hooks (port of blim_tpu/utils/profiling.py).

`trace` writes a `torch.profiler` trace of a scope (CPU activity, and CUDA
activity on a GPU) as a Chrome trace file, `timed` prints a scope's wall
time, `device_memory_gb` reads the peak CUDA memory and `annotate` names a
range on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = TRACE_FILE):
    """torch.profiler over the scope, its Chrome trace written to
    log_dir/name when the scope ends (also on an error, as the JAX
    package's stop_trace); a no-op for None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def timed(name: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{name}: {time.perf_counter() - t0:.3f}s")


def device_memory_gb() -> Optional[float]:
    """Peak CUDA memory allocated in GiB (torch.cuda.max_memory_allocated),
    or None without a GPU or before any allocation."""
    import torch

    if not torch.cuda.is_available():
        return None
    peak = torch.cuda.max_memory_allocated()
    return peak / 2**30 if peak else None


def annotate(name: str):
    """A named range on the profiler's timeline (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)
