"""The epoch-level train loop (port of blim_tpu/engine/loop.py::train_one_epoch).

Per batch: collate into the static layouts, move to the device, run the
train step, and abort the whole run on a non-finite loss. Metrics are plain
averages over the epoch. The metric logger and the evaluation epoch
(`val_one_epoch`, which needs the 6-matrix flow) are not ported yet.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional

import numpy as np
import torch

from blim_tpu_torch.core.device import DeviceLike, resolve_device
from blim_tpu_torch.data.collate import collate_train_batch
from blim_tpu_torch.data.datasets import RetrievalDataset, TrainLoader
from blim_tpu_torch.data.prompts import TVGLayout, VTGLayout

METRICS = ("loss", "vtg_loss", "tvg_loss")


def train_one_epoch(
    state,
    step_fn,
    frozen,
    dataset: RetrievalDataset,
    loader: TrainLoader,
    features: np.ndarray,              # (V, clips, tokens_per_clip, mm) video vocabulary features
    video_vocab: torch.Tensor,
    tokenizer,
    vtg_layout: VTGLayout,
    tvg_layout: TVGLayout,
    epoch: int,
    generator: Optional[torch.Generator] = None,
    print_freq_div: int = 4,
    device: DeviceLike = "cuda",
):
    """One pass over `loader` -> (state, {loss, vtg_loss, tvg_loss} averaged)."""
    dev = resolve_device(device)
    n_batches = len(loader)
    print_freq = max(n_batches // print_freq_div, 1)
    sums = dict.fromkeys(METRICS, 0.0)
    n = 0
    for it, idx in enumerate(loader.batches(epoch)):
        batch_np = collate_train_batch(
            [dataset.captions[i] for i in idx],
            features[dataset.item_video_idx[idx]],
            dataset.item_video_idx[idx],
            tokenizer,
            dataset.name,
            vtg_layout,
            tvg_layout,
        )
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch_np.items()}
        state, metrics = step_fn(state, frozen, batch, video_vocab, generator)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            # a non-finite loss aborts the whole run
            print(f"Loss is {loss}, stopping training")
            sys.exit(1)
        for k in METRICS:
            sums[k] += float(metrics[k])
        n += 1
        if it % print_freq == 0:
            print(f"Epoch: [{epoch}] [{it}/{n_batches}] "
                  + "  ".join(f"{k}: {float(metrics[k]):.4f}" for k in METRICS), flush=True)
    averages: Dict[str, float] = {k: v / max(n, 1) for k, v in sums.items()}
    print("Averaged stats:", "  ".join(f"{k}: {v:.4f}" for k, v in averages.items()))
    return state, averages
