"""Alternative retrieval metrics (legacy Flipped-VQA surface; a copy of
blim_tpu/scoring/alt_metrics.py below this docstring).

Full numpy parity with the reference's unused-but-shipped metrics module
(reference: util/metrics.py:1-115): diagonal-rank metrics with the
tie/NaN semantics of its sort-and-match trick, the multi-sentence 3D
variants, and the result formatting helpers. `scoring.recall` holds the
metrics the training loop actually uses (training_utils.py:173-221).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _diag_rank_positions(x: np.ndarray) -> np.ndarray:
    """All descending-sort positions whose value ties the row's diagonal.

    The reference sorts each row descending and reports EVERY index where
    the sorted value equals the diagonal (util/metrics.py:5-11), so a row
    with t tied values contributes t entries at ranks
    [#strictly-greater, #greater-or-equal). A NaN diagonal contributes
    nothing (NaN compares false). Row order, then ascending rank —
    np.where's row-major scan order.
    """
    diag = np.diag(x)[:, None]
    n_greater = np.nansum(x > diag, axis=1)
    n_ge = n_greater + np.nansum(x == diag, axis=1)
    return np.concatenate(
        [np.arange(g, e) for g, e in zip(n_greater, n_ge)]
    ).astype(np.int64) if len(x) else np.zeros(0, np.int64)


def compute_metrics(x: np.ndarray) -> Dict[str, object]:
    """Diagonal-rank recalls of a square similarity matrix.

    Keys and semantics match the reference exactly (util/metrics.py:4-23):
    R1..R1000 percentages over the tie-expanded rank list, MR/MedianR =
    median rank + 1, MeanR = mean rank + 1, and `cols` = the raw 0-based
    rank list.
    """
    ind = _diag_rank_positions(np.asarray(x, dtype=np.float64))
    metrics: Dict[str, object] = {}
    for k in (1, 5, 10, 50, 100, 500, 1000):
        metrics[f"R{k}"] = float(np.sum(ind < k)) * 100 / len(ind)
    metrics["MR"] = np.median(ind) + 1
    metrics["MedianR"] = metrics["MR"]
    metrics["MeanR"] = np.mean(ind) + 1
    metrics["cols"] = [int(i) for i in list(ind)]
    return metrics


def _lower_median(v: np.ndarray) -> float:
    """torch.median semantics: the LOWER of the two middle values for even
    counts (np.median averages them)."""
    s = np.sort(v)
    return float(s[(len(s) - 1) // 2])


def tensor_text_to_video_metrics(
    sim_tensor: np.ndarray, top_k: Sequence[int] = (1, 5, 10, 50)
) -> Dict[str, float]:
    """Rank metrics for a (videos, texts-per-video, videos) similarity stack.

    Mirrors the reference's double-argsort construction
    (util/metrics.py:25-54): permute so each text slice is a text x video
    matrix, rank every text's own video via argsort-of-argsort, and drop
    ranks whose original diagonal score is inf/NaN padding.
    """
    sim = np.asarray(sim_tensor, dtype=np.float64)
    stacked = sim.transpose(1, 0, 2)                       # (T, V, V)
    first = np.argsort(-stacked, axis=-1)
    second = np.argsort(first, axis=-1)
    ranks = np.diagonal(second, axis1=1, axis2=2).reshape(-1)
    original = np.diagonal(sim, axis1=0, axis2=2).reshape(-1)
    valid = ranks[~(np.isinf(original) | np.isnan(original))].astype(np.float64)

    results: Dict[str, float] = {
        f"R{k}": float(np.sum(valid < k) * 100 / len(valid)) for k in top_k
    }
    results["MedianR"] = _lower_median(valid + 1)
    results["MeanR"] = float(np.mean(valid + 1))
    results["Std_Rank"] = float(np.std(valid + 1))
    results["MR"] = results["MedianR"]
    return results


def tensor_video_to_text_sim(sim_tensor: np.ndarray) -> np.ndarray:
    """Collapse (videos, texts-per-video, videos) to a square v2t matrix by
    max over each video's texts, NaNs treated as -inf
    (util/metrics.py:56-62)."""
    sim = np.array(sim_tensor, dtype=np.float64, copy=True)
    sim[np.isnan(sim)] = -np.inf
    return sim.max(axis=1).squeeze().T


def multi_sentence_retrieval(
    logits: np.ndarray, cut_off_points: Sequence[int]
) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Regroup a flat (texts, videos) matrix into per-video text slices
    padded with -inf, then score both directions (util/metrics.py:105-115;
    the reference spells it `multi_setence_retrieval`)."""
    ends = [p + 1 for p in cut_off_points]
    starts = [0] + ends[:-1]
    max_length = max(e - s for s, e in zip(starts, ends))
    groups = []
    for s, e in zip(starts, ends):
        pad = np.full((max_length - (e - s), logits.shape[1]), -np.inf)
        groups.append(np.concatenate((logits[s:e], pad), axis=0))
    stacked = np.stack(groups, axis=0)
    tv_metrics = tensor_text_to_video_metrics(stacked)
    vt_metrics = compute_metrics(tensor_video_to_text_sim(stacked))
    return tv_metrics, vt_metrics


# kept for back-compat with the reference's exported name
multi_setence_retrieval = multi_sentence_retrieval


_LINE = (
    "\t>>>  R@1: {R1:.1f} - R@5: {R5:.1f} - R@10: {R10:.1f} - R@50: {R50:.1f}"
    " - Median R: {MR:.1f} - Mean R: {MeanR:.1f}"
)


def format_metrics(
    t_len: int,
    v_len: int,
    t2v: Dict[str, float],
    v2t: Dict[str, float],
    t2v_dsl: Dict[str, float],
    v2t_dsl: Dict[str, float],
) -> List[str]:
    """The report block of util/metrics.py:64-81 as a list of lines."""
    sep = "-" * 60
    out = [f"\t Length-T: {t_len}, Length-V:{v_len}", sep]
    for title, m in (
        ("DSL Text-to-Video:", t2v_dsl),
        ("DSL Video-to-Text:", v2t_dsl),
        (sep, None),
        ("Text-to-Video:", t2v),
        ("Video-to-Text:", v2t),
    ):
        out.append(title)
        if m is not None:
            out.append(_LINE.format(**m))
    return out


def print_metrics(t_len, v_len, t2v, v2t, t2v_dsl, v2t_dsl) -> None:
    for line in format_metrics(t_len, v_len, t2v, v2t, t2v_dsl, v2t_dsl):
        print(line)


def log_metrics(results, f) -> None:
    """Append the same block to an open file (util/metrics.py:83-103)."""
    t_len, v_len, t2v, v2t, t2v_dsl, v2t_dsl = results
    for line in format_metrics(t_len, v_len, t2v, v2t, t2v_dsl, v2t_dsl):
        f.write(line + "\n")
