"""The process-group surface the CLI calls (counterpart of
blim_tpu/utils/distributed.py), for one process on one GPU.

Rank 0 of a world of 1: `barrier` returns at once and `all_reduce_mean`
returns its input. `setup_for_distributed` still replaces `builtins.print`
with the rank-0, timestamped print the JAX package installs. Data parallel
over several GPUs (`torch.distributed` behind these functions) is not
ported yet.
"""

from __future__ import annotations

import builtins
import datetime
import functools


def init_distributed_mode(force_master_print: bool = False) -> None:
    """One process: nothing to initialize; installs the rank-0 print."""
    setup_for_distributed(is_main_process() or force_master_print)


def get_rank() -> int:
    return 0


def get_world_size() -> int:
    return 1


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


def barrier() -> None:
    """Cross-process sync point: one process, so it returns at once."""


def all_reduce_mean(x: float) -> float:
    """Mean of a per-process scalar over processes: its own value here."""
    return float(x)
