"""Save and resume the trainable state (counterpart of
blim_tpu/checkpoints/orbax_io.py).

`{output_dir}/{name}/` holds the fp32 trainable tree (LoRA factors and
visual_head) as `trainable.safetensors` (names are the tree paths joined
with "/"), the AdamW `state_dict()` as `optimizer.pt`, and `meta.json` with
the JAX package's keys (epoch, n_trainable, args). Only rank 0 writes;
every rank of a process group calls `save_checkpoint` and waits at a
barrier until the write is done, so no rank reads a checkpoint that rank 0
is still writing. Resuming checks the exact trainable parameter count.

A checkpoint the JAX package wrote is an Orbax tree, which needs `orbax`
to read: it is not read here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from blim_tpu_torch.checkpoints import safetensors_io
from blim_tpu_torch.utils.distributed import barrier, is_main_process

TRAINABLE_FILE = "trainable.safetensors"
OPTIMIZER_FILE = "optimizer.pt"
META_FILE = "meta.json"


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def count_params(tree) -> int:
    """Elements over the tree's leaves (None leaves, a tied lm_head, count 0)."""
    return sum(t.numel() for t in _flat(tree).values() if t is not None)


def save_checkpoint(
    output_dir: str,
    name: str,
    trainable: Any,
    optimizer: Optional[torch.optim.Optimizer],
    epoch: int,
    args: Optional[Dict[str, Any]] = None,
) -> str:
    """Write {output_dir}/{name}/ on rank 0, then wait for every rank at a
    barrier; returns the path."""
    path = os.path.abspath(os.path.join(output_dir, name))
    if is_main_process():
        os.makedirs(path, exist_ok=True)
        flat = {k: t.detach().to(torch.float32) for k, t in _flat(trainable).items()}
        safetensors_io.save_file(flat, os.path.join(path, TRAINABLE_FILE))
        if optimizer is not None:
            torch.save(optimizer.state_dict(), os.path.join(path, OPTIMIZER_FILE))
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump({"epoch": int(epoch), "n_trainable": count_params(trainable),
                       "args": args or {}}, f)
    barrier()
    return path


def load_checkpoint(path: str, expected_trainable: Any = None):
    """Returns (trainable, optimizer_state, epoch): the trainable tree as fp32
    CPU tensors, the optimizer's state_dict (None if none was saved) and
    the saved epoch. With `expected_trainable`, asserts the exact trainable
    parameter count."""
    trainable = _unflat({k: t.clone() for k, t in
                         safetensors_io.load_file(os.path.join(path, TRAINABLE_FILE)).items()})
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    opt_state = (torch.load(opt_path, map_location="cpu", weights_only=True)
                 if os.path.exists(opt_path) else None)
    meta_path = os.path.join(path, META_FILE)
    epoch = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            epoch = json.load(f).get("epoch", 0)
    if expected_trainable is not None:
        got, want = count_params(trainable), count_params(expected_trainable)
        assert got == want, f"trainable param count mismatch: ckpt {got} != model {want}"
    return trainable, opt_state, epoch


@torch.no_grad()
def assign_trainable(trainable: Any, loaded: Any) -> None:
    """Copy a loaded tree into the live trainable leaves in place, so an
    optimizer built over those leaves keeps them."""
    live, new = _flat(trainable), _flat(loaded)
    if live.keys() != new.keys():
        raise KeyError(f"trainable trees differ: {sorted(live.keys() ^ new.keys())[:4]}")
    for k, t in live.items():
        t.copy_(new[k].to(t.device, t.dtype))
