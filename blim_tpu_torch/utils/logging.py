"""Metric logging: windowed smoothing and ETA progress (copy of
blim_tpu/utils/logging.py).

`SmoothedValue` keeps a window's median and mean beside global averages;
`MetricLogger.log_every` prints iteration and data times and an ETA.
Synchronizing sums the global (count, total) over the process group
(utils/distributed.py); outside a group nothing changes.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import numpy as np


class SmoothedValue:
    """Tracks a value over a smoothing window plus global totals."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum (count, total) over the process group (fp64); the window
        stays this process's."""
        from blim_tpu_torch.utils import distributed as dist

        if dist.in_group():
            count, total = dist.all_reduce_sum(np.asarray([self.count, self.total], np.float64))
            self.count, self.total = int(count), float(total)

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        print_freq = max(int(print_freq), 1)
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                    print(
                        f"{header} [{i}/{total}] eta: {eta} {self} "
                        f"time: {iter_time} data: {data_time}"
                    )
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}")
