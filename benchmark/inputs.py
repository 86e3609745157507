"""Traffic generation: the inputs of one run, from its traffic file and
--seed. Every seed gets the same sizes in another order: the traffic
file's `structure_seed` fixes the caption lengths (the quantiles of the
length distribution) and the InternVideo2 score pattern that picks the
top-k candidates, and --seed permutes the items and draws the caption
words, the video features and the frames. So each seed does the same
work, and the same seed gives the same inputs.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

# The words of the synthetic captions (bytes under the byte tokenizer).
WORDS = ["man", "woman", "dog", "cat", "runs", "jumps", "sings", "cooks",
         "dances", "rides", "park", "kitchen", "stage", "street", "ball", "car",
         "talks", "plays", "guitar", "soccer", "child", "group", "slowly", "red"]


def caption_lengths(n: int, dist: Dict, budget: int) -> np.ndarray:
    """n token lengths at the quantiles (i + 0.5) / n of lognormal(ln
    median, sigma), rounded and clipped to [min, budget - 2] (MSRVTT's
    profile under the byte tokenizer: median 12, sigma 0.35)."""
    nd = statistics.NormalDist()
    z = np.asarray([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.rint(np.exp(np.log(dist["median"]) + dist["sigma"] * z))
    return np.clip(lens, dist["min"], budget - 2).astype(int)


def caption(length: int, rng: np.random.Generator) -> str:
    """Random words joined by spaces, cut to exactly `length` characters
    (a trailing space becomes a letter)."""
    words: List[str] = []
    total = 0
    while total < length:
        w = WORDS[rng.integers(len(WORDS))]
        words.append(w)
        total += len(w) + (1 if total else 0)
    s = " ".join(words)[:length]
    return s[:-1] + "s" if s.endswith(" ") else s


def rerank_inputs(traffic: Dict, cfg: Dict, seed: int, feature_seed: int, device) -> Dict:
    """{captions, item_video_idx, features (N, clips, tokens, mm) float32
    numpy, t2v_iv2, v2t_iv2 (N, N)} for one evaluation of N items."""
    n = traffic["queries"]
    srng = np.random.default_rng(traffic["structure_seed"])
    lens = srng.permutation(caption_lengths(n, traffic["caption_tokens"],
                                            traffic["caption_budget"]))
    t2v = srng.standard_normal((n, n)).astype(np.float32) + 0.01
    v2t = srng.standard_normal((n, n)).astype(np.float32) + 0.01
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    item_len = np.empty(n, int)
    item_len[perm] = lens
    t2v_p = np.empty_like(t2v)
    v2t_p = np.empty_like(v2t)
    t2v_p[np.ix_(perm, perm)] = t2v
    v2t_p[np.ix_(perm, perm)] = v2t
    gen = torch.Generator(device=device).manual_seed(feature_seed)
    clips, tokens = cfg["num_clips"], cfg["tokens_per_frame"] * cfg["mm_local_num_frames"]
    feats = torch.randn((n, clips, tokens, cfg["mm_hidden_size"]), generator=gen,
                        device=device).mul_(traffic["feature_scale"])
    return {"captions": [caption(int(L), rng) for L in item_len],
            "item_video_idx": np.arange(n), "features": feats.cpu().numpy(),
            "t2v_iv2": t2v_p, "v2t_iv2": v2t_p}


def topk_cells(sims: np.ndarray, k: int):
    """(rows, cols) of each row's k largest entries."""
    cols = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    rows = np.repeat(np.arange(sims.shape[0]), k)
    return rows, cols.reshape(-1)


def video_frames(traffic: Dict, n_videos: int, seed: int, device) -> torch.Tensor:
    """(n_videos, clips, frames, H, W, 3) uint8 frames: per video a smooth
    random picture (a coarse grid of colours, bilinearly upsampled) that
    drifts from frame to frame, plus per-pixel noise; made on the card."""
    t = traffic
    clips, frames = t["clips"], t["frames_per_clip"]
    h, w = t["frame_hw"]
    gh, gw = t["coarse_grid"]
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.rand((n_videos, 3, gh + 2, gw + 2), generator=gen, device=device) * 255.0
    steps = clips * frames
    out = torch.empty((n_videos, steps, h, w, 3), dtype=torch.uint8, device=device)
    for f in range(steps):
        shift = f * t["drift_per_frame"]
        coarse = torch.roll(base, shifts=(int(shift), int(shift)), dims=(2, 3))[:, :, 1:-1, 1:-1]
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                              align_corners=False)
        img = img + torch.randn(img.shape, generator=gen, device=device) * t["noise_std"]
        out[:, f] = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out.reshape(n_videos, clips, frames, h, w, 3)
