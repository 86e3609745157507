"""The process group behind the CLI, the rerank engine and the train step
(counterpart of blim_tpu/utils/distributed.py).

Under a launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT, as `torchrun` sets them) `init_distributed_mode` joins a
`torch.distributed` group through env://, even at world size 1: NCCL for a
CUDA device, gloo for the CPU, or the backend the caller names. The group
has a finite timeout, so a lost peer fails the run instead of hanging it.
Without that environment the process stays rank 0 of 1 and joins no group:
`barrier` returns and every reduction returns its input, with no
collective. In a group, even of one, every helper makes its collective.

A collective's tensor goes where the backend takes it: the device under
NCCL, host memory under gloo (a CUDA tensor is copied to the host and back).
`calls` counts the collectives made, by kind.

`setup_for_distributed` replaces `builtins.print` with the rank-0,
timestamped print the JAX package installs. `process_shard_bounds` is the
reference's rank-row arithmetic (a copy of blim_tpu/core/mesh.py's).
"""

from __future__ import annotations

import builtins
import collections
import datetime
import functools
import os
from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as tdist

from blim_tpu_torch.core.device import DeviceLike, resolve_device

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
GROUP_TIMEOUT = datetime.timedelta(minutes=10)

calls: collections.Counter = collections.Counter()   # collectives made, by kind


def launched() -> bool:
    """True under a launcher's environment (all of LAUNCH_ENV set)."""
    return all(k in os.environ for k in LAUNCH_ENV)


def in_group() -> bool:
    """True once this process has joined a process group."""
    return tdist.is_available() and tdist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def device_for_rank(device: DeviceLike = "cuda") -> torch.device:
    """The device a rank runs on: a bare "cuda" means cuda:{LOCAL_RANK}; an
    explicit index or the CPU stays as given. Raises without a GPU, when
    LOCAL_RANK has no card of its own, and under a launcher's environment
    when an explicit index is not LOCAL_RANK's, so two ranks never share a
    card silently (ranks that share one on purpose give each LOCAL_RANK 0)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    lr = local_rank()
    if dev.index is not None:
        if launched() and dev.index != lr:
            raise RuntimeError(f"device {dev} but LOCAL_RANK {lr}: a launched rank runs on "
                               f"cuda:{lr}, one rank per card")
        return dev
    if lr >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {lr} but only {torch.cuda.device_count()} CUDA "
                           "device(s): one rank per card")
    return torch.device("cuda", lr)


def init_distributed_mode(force_master_print: bool = False, backend: Optional[str] = None,
                          device: DeviceLike = "cuda",
                          timeout: Union[datetime.timedelta, float] = GROUP_TIMEOUT) -> None:
    """Join the launcher's process group (once per process), then install
    the rank-0 print. `backend` defaults to NCCL for a CUDA `device` and
    gloo for the CPU; under NCCL the rank's card (LOCAL_RANK) becomes the
    current device first. `timeout` (a timedelta or seconds) bounds every
    collective's wait."""
    if launched() and not in_group():
        dev = torch.device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        if not isinstance(timeout, datetime.timedelta):
            timeout = datetime.timedelta(seconds=timeout)
        tdist.init_process_group(backend=backend, init_method="env://",
                                 rank=int(os.environ["RANK"]),
                                 world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    setup_for_distributed(is_main_process() or force_master_print)


def destroy_process_group() -> None:
    if in_group():
        tdist.destroy_process_group()


def backend() -> Optional[str]:
    return tdist.get_backend() if in_group() else None


def get_rank() -> int:
    return tdist.get_rank() if in_group() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if in_group() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Rank-0-only printing with timestamps: replaces builtins.print (a
    caller that must undo it keeps the original)."""
    builtin_print = builtins.print

    @functools.wraps(builtin_print)
    def tprint(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            builtin_print(f"[{now}]", *args, **kwargs)

    builtins.print = tprint


def process_shard_bounds(n: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous [start, end) row range for `shard` of `num_shards`, with
    the reference's rank sharding arithmetic: step = n // num_shards + 1."""
    step = n // num_shards + 1
    start = min(shard * step, n)
    end = min(n, start + step)
    return start, max(start, end)


def _collective_device() -> torch.device:
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Cross-process sync point; returns at once outside a group."""
    if not in_group():
        return
    calls["barrier"] += 1
    if backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over ranks in place (through the host under gloo) and return
    it; outside a group it stays as it is."""
    if not in_group():
        return t
    calls["all_reduce"] += 1
    dev = _collective_device()
    if t.device == dev:
        tdist.all_reduce(t)
        return t
    buf = t.to(dev)
    tdist.all_reduce(buf)
    return t.copy_(buf)


def all_reduce_sum(x: np.ndarray) -> np.ndarray:
    """Sum of a numpy array over ranks, as a new array of its dtype."""
    x = np.asarray(x)
    if not in_group():
        return x
    return all_reduce_sum_(torch.from_numpy(np.array(x))).numpy()


def all_reduce_mean(x: float) -> float:
    """Mean of a per-process scalar over ranks (fp64)."""
    if not in_group():
        return float(x)
    return float(all_reduce_sum(np.asarray([x], np.float64))[0]) / get_world_size()


@torch.no_grad()
def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite every tensor with rank `src`'s, in place, one broadcast a
    tensor; outside a group they stay as they are."""
    if not in_group():
        return
    dev = _collective_device()
    for t in tensors:
        calls["broadcast"] += 1
        if t.device == dev and t.is_contiguous():
            tdist.broadcast(t, src)
        else:
            buf = t.to(dev).contiguous()
            tdist.broadcast(buf, src)
            t.copy_(buf)
