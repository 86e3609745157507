"""Epoch-level train and eval loops (port of blim_tpu/engine/loop.py).

Train: per batch, collate into the static layouts, move to the device, run
the train step, abort the whole run on a non-finite loss, and log the
losses and the step's learning rate through a MetricLogger; the epoch's
averages come back, summed over the process group's ranks. Eval: the
6-matrix evaluation over a dataset, fused into the recall tables of the
five scorings; in a process group every rank runs it, and the merged
matrices make the tables equal on every rank.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from blim_tpu_torch.core.device import DeviceLike, resolve_device
from blim_tpu_torch.data.collate import collate_train_batch
from blim_tpu_torch.data.datasets import RetrievalDataset, TrainLoader
from blim_tpu_torch.data.prompts import TVGLayout, VTGLayout
from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
from blim_tpu_torch.engine.rerank import RerankEngine
from blim_tpu_torch.scoring import fusion
from blim_tpu_torch.utils.logging import MetricLogger, SmoothedValue


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
    """One pass over `loader` -> (state, the epoch's averages of loss,
    vtg_loss, tvg_loss and lr). The lr is the one the step's optimizer
    applied (0 without an optimizer)."""
    dev = resolve_device(device)
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    print_freq = max(len(loader) // print_freq_div, 1)

    for idx in metric_logger.log_every(loader.batches(epoch), print_freq, header):
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
        optimizer = getattr(state, "optimizer", None)
        metric_logger.update(
            loss=loss,
            vtg_loss=float(metrics["vtg_loss"]),
            tvg_loss=float(metrics["tvg_loss"]),
            lr=optimizer.param_groups[0]["lr"] if optimizer is not None else 0.0,
        )

    metric_logger.synchronize_between_processes()
    print("Averaged stats:", metric_logger)
    return state, {k: m.global_avg for k, m in metric_logger.meters.items()}


def val_one_epoch(
    engine: RerankEngine,
    dataset: RetrievalDataset,
    iv2_scores: Dict[str, np.ndarray],
    tokenizer,
    topk: int,
    cpn: bool,
    alpha: Tuple[float, float],
    c: Tuple[float, float, float, float],
    has_tvg: bool,
) -> Dict[str, Dict[str, float]]:
    """The evaluation of every item of `dataset` against its videos, then
    the recall tables {scoring: {metric: value}}."""
    inputs = EvalInputs(
        captions=dataset.captions,
        item_video_idx=dataset.item_video_idx,
        features=dataset.load_features(),
        t2v_iv2=iv2_scores["t2v"],
        v2t_iv2=iv2_scores["v2t"],
    )
    t2v_dict, v2t_dict = evaluation(
        engine, inputs, tokenizer, dataset.name, topk=topk, cpn=cpn, has_tvg=has_tvg
    )
    n = len(dataset)
    ids = {i: i for i in range(n)}
    return fusion.all_scoring_results(
        t2v_dict, v2t_dict, ids, ids, alpha=alpha, c=c, cpn=cpn, has_tvg=has_tvg
    )


def results_table(results: Dict[str, Dict[str, float]]) -> str:
    """The recall tables as one text table, pandas' if it is installed,
    else a fixed-width one."""
    try:
        import pandas as pd

        return pd.DataFrame(results).transpose().to_string()
    except ImportError:
        lines = []
        cols = list(next(iter(results.values())).keys())
        lines.append(" " * 26 + "  ".join(f"{c:>10}" for c in cols))
        for name, row in results.items():
            lines.append(f"{name:<26}" + "  ".join(f"{row[c]:>10.2f}" for c in cols))
        return "\n".join(lines)
