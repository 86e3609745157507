"""Retrieval recall metrics (copy of blim_tpu/scoring/recall.py: `get_recall`,
and `compute_metrics`, which delegates to the copy of alt_metrics).

R@1/5/10, per-direction means and the overall r_mean, with multi-ground-
truth support and the zero sentinel: a fully computed score matrix never
holds an exact 0.0, so a zero anywhere marks a skipped direction, whose
recalls are reported as zeros.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np

GtIds = Union[int, Sequence[int]]


def _ranks(scores: np.ndarray, gt_ids: Mapping[int, GtIds]) -> np.ndarray:
    """Rank of the best ground-truth item per row under descending argsort."""
    ranks = np.zeros(scores.shape[0])
    for index, row in enumerate(scores):
        inds = np.argsort(row)[::-1]
        gt = gt_ids[index]
        if isinstance(gt, (int, np.integer)):
            ranks[index] = np.where(inds == gt)[0][0]
        else:
            ranks[index] = min(np.where(inds == g)[0][0] for g in gt)
    return ranks


def _recalls(scores: np.ndarray, gt_ids: Mapping[int, GtIds]):
    if np.count_nonzero(scores == 0) != 0:
        return 0.0, 0.0, 0.0
    ranks = _ranks(scores, gt_ids)
    n = len(ranks)
    return (
        100.0 * np.sum(ranks < 1) / n,
        100.0 * np.sum(ranks < 5) / n,
        100.0 * np.sum(ranks < 10) / n,
    )


def get_recall(
    t2v: np.ndarray,
    v2t: np.ndarray,
    t2v_ids: Mapping[int, GtIds],
    v2t_ids: Mapping[int, GtIds],
) -> Dict[str, float]:
    v2t_r1, v2t_r5, v2t_r10 = _recalls(v2t, v2t_ids)
    t2v_r1, t2v_r5, t2v_r10 = _recalls(t2v, t2v_ids)
    v2t_mean = (v2t_r1 + v2t_r5 + v2t_r10) / 3
    t2v_mean = (t2v_r1 + t2v_r5 + t2v_r10) / 3
    result = {
        "t2v_r1": t2v_r1, "t2v_r5": t2v_r5, "t2v_r10": t2v_r10, "t2v_r_mean": t2v_mean,
        "v2t_r1": v2t_r1, "v2t_r5": v2t_r5, "v2t_r10": v2t_r10, "v2t_r_mean": v2t_mean,
        "r_mean": (v2t_mean + t2v_mean) / 2,
    }
    return {k: round(v, 2) for k, v in result.items()}


def compute_metrics(sim_matrix: np.ndarray) -> Dict[str, float]:
    """Single-direction diagonal-rank metrics: delegates to
    `scoring.alt_metrics.compute_metrics` (R1..R1000 over the tie-expanded
    rank list, MR/MedianR/MeanR, cols), as the JAX package's does."""
    from blim_tpu_torch.scoring.alt_metrics import compute_metrics as _full

    return _full(sim_matrix)
