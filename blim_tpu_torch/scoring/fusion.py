"""Score fusion: CPN debiasing, the BLiM ensemble and the grid searches of
its weights (copy of blim_tpu/scoring/fusion.py; `calculate_score` and
`calculate_cpn_score` are its text byte for byte).

  cpn_candidate = candidate_likelihood - alpha * candidate_prior
  blim          = c[dir] * query_likelihood + (1 - c[dir]) * cpn_candidate
  final         = c[2|3] * blim + (1 - c[2|3]) * internvideo2
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from blim_tpu_torch.scoring.recall import get_recall


def cpn_normalize(candidate: np.ndarray, prior: Optional[np.ndarray], alpha: float) -> np.ndarray:
    """Candidate Prior Normalization: subtract alpha x the prior."""
    if prior is None or alpha == 0.0:
        return candidate
    return candidate - alpha * prior


def blim_ensemble(
    t2v: Mapping[str, np.ndarray],
    v2t: Mapping[str, np.ndarray],
    alpha: Tuple[float, float],
    c: Tuple[float, float, float, float],
    has_tvg: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (cpn_t2v, cpn_v2t, blim_t2v, blim_v2t). With has_tvg=False
    (zero-shot) the untrained TVG paths are skipped: t2v cpn is a zero matrix
    and v2t blim falls back to cpn_v2t."""
    n_t, n_v = (t2v["query_likelihood"].shape if "query_likelihood" in t2v
                else t2v["internvideo2"].shape)
    if has_tvg:
        cpn_t2v = cpn_normalize(t2v["candidate_likelihood"], t2v.get("candidate_prior"), alpha[0])
    else:
        cpn_t2v = np.zeros((n_t, n_v))
    cpn_v2t = cpn_normalize(v2t["candidate_likelihood"], v2t.get("candidate_prior"), alpha[1])

    blim_t2v = c[0] * t2v["query_likelihood"] + (1 - c[0]) * cpn_t2v
    if has_tvg:
        blim_v2t = c[1] * v2t["query_likelihood"] + (1 - c[1]) * cpn_v2t
    else:
        blim_v2t = cpn_v2t
    blim_t2v = c[2] * blim_t2v + (1 - c[2]) * t2v["internvideo2"]
    blim_v2t = c[3] * blim_v2t + (1 - c[3]) * v2t["internvideo2"]
    return cpn_t2v, cpn_v2t, blim_t2v, blim_v2t


def calculate_score(t2v_1, v2t_1, t2v_2, v2t_2, t2v_ids, v2t_ids):
    """Grid-search the convex blend weight over c in linspace(0,1,11),
    maximizing R@1 per direction (reference: training_utils.py:106-121)."""
    best_v2t, v2t_c = 0.0, 0.0
    best_t2v, t2v_c = 0.0, 0.0
    for c in np.linspace(0, 1, 11):
        res = get_recall(c * t2v_1 + (1 - c) * t2v_2, c * v2t_1 + (1 - c) * v2t_2, t2v_ids, v2t_ids)
        if best_v2t < res["v2t_r1"]:
            best_v2t, v2t_c = res["v2t_r1"], round(float(c), 1)
        if best_t2v < res["t2v_r1"]:
            best_t2v, t2v_c = res["t2v_r1"], round(float(c), 1)
    return (
        t2v_c * t2v_1 + (1 - t2v_c) * t2v_2,
        v2t_c * v2t_1 + (1 - v2t_c) * v2t_2,
        t2v_c,
        v2t_c,
    )


def calculate_cpn_score(t2v, v2t, t2v_prior, v2t_prior, t2v_ids, v2t_ids):
    """Grid-search CPN strength alpha (reference: training_utils.py:123-138)."""
    best_v2t, v2t_c = 0.0, 0.0
    best_t2v, t2v_c = 0.0, 0.0
    for c in np.linspace(0, 1, 11):
        res = get_recall(t2v - c * t2v_prior, v2t - c * v2t_prior, t2v_ids, v2t_ids)
        if best_v2t < res["v2t_r1"]:
            best_v2t, v2t_c = res["v2t_r1"], round(float(c), 1)
        if best_t2v < res["t2v_r1"]:
            best_t2v, t2v_c = res["t2v_r1"], round(float(c), 1)
    return t2v - t2v_c * t2v_prior, v2t - v2t_c * v2t_prior, t2v_c, v2t_c


def all_scoring_results(
    t2v_dict: Mapping[str, np.ndarray],
    v2t_dict: Mapping[str, np.ndarray],
    t2v_ids,
    v2t_ids,
    alpha: Tuple[float, float],
    c: Tuple[float, float, float, float],
    cpn: bool,
    has_tvg: bool,
) -> Dict[str, Dict[str, float]]:
    """Recall tables for the named scorings."""
    zeros_tv = np.zeros((len(t2v_ids), len(v2t_ids)))
    zeros_vt = np.zeros((len(v2t_ids), len(t2v_ids)))
    results: Dict[str, Dict[str, float]] = {}
    for name in ["internvideo2", "candidate_likelihood", "query_likelihood"]:
        results[name] = get_recall(
            t2v_dict.get(name, zeros_tv), v2t_dict.get(name, zeros_vt), t2v_ids, v2t_ids
        )
    eff_alpha = alpha if cpn else (0.0, 0.0)
    cpn_t2v, cpn_v2t, blim_t2v, blim_v2t = blim_ensemble(
        t2v_dict, v2t_dict, eff_alpha, c, has_tvg=has_tvg
    )
    if cpn:
        results["cpn_candidate_likelihood"] = get_recall(cpn_t2v, cpn_v2t, t2v_ids, v2t_ids)
    results["blim"] = get_recall(blim_t2v, blim_v2t, t2v_ids, v2t_ids)
    return results
