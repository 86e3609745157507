"""Batch collation into the static layouts (copy of blim_tpu/data/collate.py).

Every train batch lands in the fixed VTG/TVG layouts, so every step of the
train step sees the same shapes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from blim_tpu_torch.data.prompts import TVGLayout, VTGLayout


def collate_train_batch(
    captions: Sequence[str],
    video_features: np.ndarray,     # (B, clips, tokens_per_clip, mm)
    video_labels: np.ndarray,       # (B,) vocab indices of the true videos
    tokenizer,
    dataset: str,
    vtg_layout: VTGLayout,
    tvg_layout: TVGLayout,
) -> Dict[str, np.ndarray]:
    vtg = [vtg_layout.encode_caption(c, tokenizer, dataset) for c in captions]
    tvg = [tvg_layout.encode_caption(c, tokenizer) for c in captions]
    ws, wl = vtg_layout.label_window
    cs = vtg_layout.caption_start
    return {
        "vtg_input_ids": np.stack([e["input_ids"] for e in vtg]),
        "vtg_attention_mask": np.stack([e["attention_mask"] for e in vtg]),
        "vtg_window_labels": np.stack([e["labels"][cs: cs + wl] for e in vtg]),
        "tvg_input_ids": np.stack([e["input_ids"] for e in tvg]),
        "tvg_attention_mask": np.stack([e["attention_mask"] for e in tvg]),
        "video": np.asarray(video_features),
        "video_label": np.asarray(video_labels, np.int32),
    }
