"""Evaluation: top-k rerank in both directions with CPN priors and
score-matrix assembly (port of blim_tpu/engine/evaluation.py). Three
schedules: the shared-prefix packed one, the default; with packed=False the
shared-prefix rectangle schedule (fixed (K, W) groups, a prefix forward a
group: RerankEngine.score_pairs_vtg_shared, score_pairs_tvg_shared and
compute_vtg_priors); and with shared_prefix=False the naive per-pair
full-sequence forwards.

  v2t candidate likelihood (VTG): P(candidate caption | query video)
  v2t candidate prior      (VTG): P(candidate caption), the CPN prior
  t2v query     likelihood (VTG): P(query caption | candidate video)
  v2t query     likelihood (TVG): P(query video | candidate caption)
  t2v candidate likelihood (TVG): P(candidate video | query caption)
  t2v candidate prior      (TVG): P(candidate video), the CPN prior

The TVG directions (`has_tvg`, the fine-tuned flow) need an engine built
with a TVG layout. Items are (video, caption) rows and the matrices are
(N x N) over items; cells outside the top-k keep the fill value -100. In a
process group the shared-prefix passes (packed or rectangle; not the VTG
prior pass) are sharded over the ranks and merged, so every rank returns
the same matrices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence, Tuple

import numpy as np

from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine, topk_pairs, unique_pairs


@dataclasses.dataclass
class EvalInputs:
    captions: Sequence[str]            # per item
    item_video_idx: np.ndarray         # (N,) item -> unique-video index
    features: np.ndarray               # (V, clips, tokens_per_clip, mm)
    t2v_iv2: np.ndarray                # (N, N) InternVideo2 text->video scores
    v2t_iv2: np.ndarray                # (N, N) InternVideo2 video->text scores


def evaluation(
    engine: RerankEngine,
    inputs: EvalInputs,
    tokenizer,
    dataset: str,
    topk: int = 16,
    cpn: bool = False,
    has_tvg: bool = True,
    fill: float = -100.0,
    verbose: bool = True,
    shared_prefix: bool = True,
    packed: bool = True,
    timings: Dict[str, float] | None = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Returns (t2v_dict, v2t_dict) of (N, N) score matrices. packed=False
    scores the shared-prefix union in (K, W) rectangles of 2 * topk pairs a
    group; shared_prefix=False scores every grid cell with its own
    full-sequence forward (the naive schedule, RerankEngine.score_grid_*),
    the comparator the packed passes are held to."""
    if has_tvg and engine.tvg_layout is None:
        raise ValueError("has_tvg=True needs an engine built with a tvg_layout "
                         "(RerankEngine(params, config, vtg_layout, tvg_layout, ...))")
    t_start = time.time()
    n = len(inputs.captions)
    item_vid = np.asarray(inputs.item_video_idx)

    def mark(name: str) -> None:
        if timings is not None:
            timings[name] = time.time() - t_start

    bank = CaptionBank.build_vtg(inputs.captions, tokenizer, dataset, engine.vtg_layout)
    banks = engine.upload(bank, inputs.features)
    mark("upload")
    if has_tvg:
        tvg_bank = CaptionBank.build_tvg(inputs.captions, tokenizer, engine.tvg_layout)
        tvg_banks = engine.upload(tvg_bank, inputs.features, shared_feats=banks)
        video_vocab = engine.video_vocab(banks)
        mark("upload_tvg")
    v_rows, v_cols = topk_pairs(inputs.v2t_iv2, topk)   # rows: videos, cols: captions
    t_rows, t_cols = topk_pairs(inputs.t2v_iv2, topk)   # rows: captions, cols: videos
    t2v_dict: Dict[str, np.ndarray] = {}
    v2t_dict: Dict[str, np.ndarray] = {}

    def scatter(rows, cols, values) -> np.ndarray:
        mat = np.full((n, n), fill, np.float32)
        mat[rows, cols] = values
        return mat

    if shared_prefix:
        prior = None
        if packed:
            prior = engine.compute_vtg_priors_packed(banks) if cpn else None
            mark("prior_done")
        n1 = len(v_rows)
        # cross-grid dedup: v2t_candidate[i, j] and t2v_query[j, i] are the same
        # number P(caption j | video i), and v2t_query[i, j] and
        # t2v_candidate[j, i] the same P(video i | caption j); score the union once
        all_caps = np.concatenate([v_cols, t_rows])
        all_vids = np.concatenate([item_vid[v_rows], item_vid[t_cols]])
        u_cap, u_vid, inv = unique_pairs(all_caps, all_vids)
        if verbose:
            print(f"VTG union: {len(u_cap)} unique pairs of {len(all_caps)} grid cells "
                  f"(topk={topk})")
        # union groups hold ~2 * topk pairs a video (its own v2t row and ~topk
        # queries' t2v lists), so the rectangle's groups take 2 * topk
        if has_tvg:
            if packed:
                tscores, tpriors = engine.score_pairs_tvg_packed(tvg_banks, video_vocab, u_cap,
                                                                 u_vid, with_prior=cpn)
            else:
                tscores, tpriors = engine.score_pairs_tvg_shared(tvg_banks, video_vocab, u_cap,
                                                                 u_vid, 2 * topk, with_prior=cpn)
            mark("tvg_done")
        if packed:
            scores = engine.score_pairs_vtg_packed(banks, u_cap, u_vid)
        else:
            scores = engine.score_pairs_vtg_shared(banks, u_cap, u_vid, 2 * topk)
        mark("vtg_done")
        if cpn and not packed:
            prior = engine.compute_vtg_priors(banks)
            mark("prior_done")
        v2t_dict["candidate_likelihood"] = scatter(v_rows, v_cols, scores[inv[:n1]])
        t2v_dict["query_likelihood"] = scatter(t_rows, t_cols, scores[inv[n1:]])
        if cpn:
            v2t_dict["candidate_prior"] = scatter(v_rows, v_cols, prior[v_cols])
        if has_tvg:
            v2t_dict["query_likelihood"] = scatter(v_rows, v_cols, tscores[inv[:n1]])
            t2v_dict["candidate_likelihood"] = scatter(t_rows, t_cols, tscores[inv[n1:]])
            if cpn:
                t2v_dict["candidate_prior"] = scatter(t_rows, t_cols, tpriors[inv[n1:]])
    else:
        # naive per-pair full-sequence forwards: each direction its own grid
        # (no cross-grid dedup), the priors beside the candidate grids
        if verbose:
            print(f"V2T grid: {len(v_rows)} pairs, T2V grid: {len(t_rows)} pairs (topk={topk})")
        grid = dict(out_shape=(n, n), fill=fill)
        v2t_dict["candidate_likelihood"], prior = engine.score_grid_vtg(
            banks, v_rows, v_cols, v_cols, item_vid[v_rows], with_prior=cpn, **grid)
        if cpn:
            v2t_dict["candidate_prior"] = prior
        t2v_dict["query_likelihood"], _ = engine.score_grid_vtg(
            banks, t_rows, t_cols, t_rows, item_vid[t_cols], with_prior=False, **grid)
        if has_tvg:
            v2t_dict["query_likelihood"], _ = engine.score_grid_tvg(
                tvg_banks, video_vocab, v_rows, v_cols, v_cols, item_vid[v_rows],
                with_prior=False, **grid)
            t2v_dict["candidate_likelihood"], prior = engine.score_grid_tvg(
                tvg_banks, video_vocab, t_rows, t_cols, t_rows, item_vid[t_cols],
                with_prior=cpn, **grid)
            if cpn:
                t2v_dict["candidate_prior"] = prior
        mark("naive_done")
    v2t_dict["internvideo2"] = np.asarray(inputs.v2t_iv2, np.float32)
    t2v_dict["internvideo2"] = np.asarray(inputs.t2v_iv2, np.float32)
    mark("total")
    if verbose:
        print(f"Evaluation time {time.time() - t_start:.1f}s")
    return t2v_dict, v2t_dict
