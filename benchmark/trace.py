"""The traced run's reading: the card's activity from torch.profiler
(CUDA activity only: no host operators, stacks, shapes or memory), and
the harness's own spans, taken on the host clock (time.time_ns, the clock
the profiler stamps its events with). From them: busy seconds (the union
of kernel, copy and set intervals), the device operations that took the
most time, grouped by the layer that launches them, and the idle gaps
named by the innermost harness span around them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

# kernel-name fragments -> the layer that launches them
GROUPS = (
    ("flash_fwd_dense (B2, ViT attention)", ("flash_fwd_dense",)),
    ("flash_fwd (B1, prefix attention)", ("flash_fwd",)),
    ("matrix products", ("gemm", "cutlass", "sm90_xmma", "sm80_xmma", "cublas", "nvjet",
                         "matmul")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("sort, gather, index", ("sort", "Sort", "radix", "gather", "index", "scatter")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "cast", "Memcpy", "memcpy", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "fill", "Memset")),
)


def group_of(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


class Spans:
    """Host-clock intervals (name, start_ns, end_ns) of the harness's own
    spans; `wrap` times a bound method under a name."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))

    def wrap(self, fn, name: str):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed


@contextlib.contextmanager
def device_profile(enabled: bool):
    """torch.profiler over the body, CUDA activity only; yields a holder
    whose `events` are (name, start_ns, end_ns) of every device activity
    once the body has ended."""
    holder = {"events": []}
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        holder["start_s"] = time.perf_counter() - t0
        yield holder
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    cuda = events[0].device_type().__class__.CUDA if events else None
    holder["events"] = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                        if e.device_type() == cuda]
    holder["stop_s"] = t2 - t1
    holder["read_s"] = time.perf_counter() - t2


def union_ns(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(events, spans: Sequence[Tuple[str, int, int]], window: Tuple[int, int],
           kernel: Optional[str] = None) -> Dict:
    """busy_s, window_s, the breakdown's device_ops and idle_gaps (each at
    most 10, seconds), and for `kernel` (a name fragment) its launches and
    mean seconds, all inside `window` (start_ns, end_ns)."""
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in events if e > w0 and s < w1]
    busy = union_ns([(s, e) for _, s, e in inside])
    busy_ns = sum(e - s for s, e in busy)
    by_group: Dict[str, float] = {}
    for n, s, e in inside:
        by_group[group_of(n)] = by_group.get(group_of(n), 0.0) + (e - s) / 1e9
    ops = sorted(by_group.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        around = [sp for sp in spans if sp[1] <= mid < sp[2]]
        name = min(around, key=lambda sp: sp[2] - sp[1])[0] if around else "between_spans"
        named[name] = named.get(name, 0.0) + (e - s) / 1e9
    out = {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
           "device_ops": [[k, v] for k, v in ops],
           "idle_gaps": [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:10]]}
    if kernel is not None:
        times = [(e - s) / 1e9 for n, s, e in inside if kernel in n]
        out["kernel_launches"] = len(times)
        out["kernel_mean_s"] = sum(times) / len(times) if times else None
    return out
