"""Likelihood criteria and training losses in fp32 (port of
blim_tpu/scoring/criteria.py).

VTG eval criterion: the negated mean per-token cross-entropy over labeled
tokens. The LM head runs only on scored positions, and the fused CE streams
the vocabulary in chunks so the (rows, V) logits are never materialized;
`vtg_likelihood` on `chunked_window_logits` is the same score through the
full window logits.
TVG: per-clip classification of the true video against the video
vocabulary through the fp32 `visual_head`. Training losses are the
batch-mean variants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from blim_tpu_torch.core.constants import IGNORE_INDEX
from blim_tpu_torch.core.numerics import matmul_f32


def token_ce_from_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE (fp32) and validity mask. logits (..., W, V); labels
    (..., W). IGNORE_INDEX labels give ce=0, valid=False."""
    logits = logits.float()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, logz - target, torch.zeros_like(logz)), valid


def vtg_likelihood(window_logits: torch.Tensor, window_labels: torch.Tensor) -> torch.Tensor:
    """Per-row score = -(sum CE / #labeled) over the label window, from its
    logits: window_logits[b, i] predicts window_labels[b, i] (the shift is in
    the window)."""
    ce, valid = token_ce_from_logits(window_logits, window_labels)
    return -(ce.sum(dim=-1) / valid.sum(dim=-1).clamp(min=1))


def vtg_train_loss(window_logits: torch.Tensor, window_labels: torch.Tensor) -> torch.Tensor:
    """Scalar batch-mean CE over all labeled tokens."""
    ce, valid = token_ce_from_logits(window_logits, window_labels)
    return ce.sum() / valid.sum().clamp(min=1)


def tvg_clip_logits(clip_hidden: torch.Tensor,         # (B, num_clips, D) at the gather positions
                    visual_head_kernel: torch.Tensor,  # (D, mm_hidden), fp32
                    video_vocab: torch.Tensor,         # (V, num_clips, mm_hidden)
                    ) -> torch.Tensor:
    """Per-clip logits over the video vocabulary, in fp32:
    logits[b, c, v] = <visual_head(h[b, c]), vocab[v, c]> / sqrt(mm_hidden)."""
    proj = clip_hidden.float() @ visual_head_kernel.float()
    scale = video_vocab.shape[-1] ** -0.5
    return torch.einsum("bcm,vcm->bcv", proj, video_vocab.float()) * scale


def _clip_ce(clip_logits: torch.Tensor, video_label: torch.Tensor) -> torch.Tensor:
    labels = video_label[:, None].expand(clip_logits.shape[:2])
    return token_ce_from_logits(clip_logits, labels)[0]


def tvg_likelihood(clip_logits: torch.Tensor, video_label: torch.Tensor) -> torch.Tensor:
    """Per-row score = -mean over clips of CE(correct video). clip_logits
    (B, C, V); video_label (B,)."""
    return -_clip_ce(clip_logits, video_label).mean(dim=-1)


def tvg_train_loss(clip_logits: torch.Tensor, video_label: torch.Tensor) -> torch.Tensor:
    """Scalar batch-mean CE of the true video over every clip."""
    return _clip_ce(clip_logits, video_label).mean()


def chunked_window_logits(hidden_window: torch.Tensor,   # (B, W, D)
                          lm_kernel: torch.Tensor,       # (D, V)
                          chunk: int = 32768) -> torch.Tensor:
    """The LM head on a scoring window, (B, W, V) logits in fp32 (one
    product; `chunk` is kept for the original's signature). ce_from_hidden
    computes the same CE without the full logits."""
    return matmul_f32(hidden_window, lm_kernel)


def ce_from_hidden(
    hidden: torch.Tensor,            # (..., W, D), any leading batch dims
    lm_kernel: torch.Tensor,         # (D, V)
    labels: torch.Tensor,            # (..., W) int; IGNORE_INDEX excluded
    lora_a: Optional[torch.Tensor] = None,   # (D, r) lm_head LoRA factors
    lora_b: Optional[torch.Tensor] = None,   # (r, V)
    lora_scale: float = 0.0,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cross-entropy without the full logits: the vocabulary streams in
    chunks with a running max / sum-exp in fp32; the last chunk is simply
    shorter when V is not a multiple of `chunk`. The chunk shrinks so one
    fp32 (rows, chunk) tile stays within ~128 MB. Returns (per-token CE fp32,
    validity mask), like token_ce_from_logits."""
    batch_shape = labels.shape
    rows = labels.numel()
    V = lm_kernel.shape[1]
    max_chunk = max(2048, (128 * 2**20 // (4 * max(rows, 1))) // 2048 * 2048)
    chunk = min(chunk, max_chunk, V)

    h = hidden.reshape(rows, hidden.shape[-1])
    lab = labels.reshape(rows)
    valid = lab != IGNORE_INDEX
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    ha = None if lora_b is None else h.to(lora_a.dtype) @ lora_a

    m = torch.full((rows,), -1e30, dtype=torch.float32, device=h.device)
    l = torch.zeros(rows, dtype=torch.float32, device=h.device)
    tgt = torch.zeros(rows, dtype=torch.float32, device=h.device)
    for start in range(0, V, chunk):
        stop = min(start + chunk, V)
        logits = matmul_f32(h, lm_kernel[:, start:stop])
        if ha is not None:
            logits = logits + matmul_f32(ha, lora_b[:, start:stop]) * lora_scale
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = safe - start
        in_chunk = (local >= 0) & (local < stop - start)
        t = logits.gather(1, local.clamp(0, stop - start - 1)[:, None])[:, 0]
        tgt = torch.where(in_chunk, t, tgt)
    ce = torch.where(valid, torch.log(l) + m - tgt, torch.zeros_like(l))
    return ce.reshape(batch_shape), valid.reshape(batch_shape)


def vtg_likelihood_from_hidden(
    hidden: torch.Tensor, lm_kernel: torch.Tensor, labels: torch.Tensor,
    lora_a=None, lora_b=None, lora_scale: float = 0.0,
) -> torch.Tensor:
    """Memory-bounded VTG likelihood: (..., W, D) hidden + labels -> (...,)."""
    ce, valid = ce_from_hidden(hidden, lm_kernel, labels, lora_a, lora_b, lora_scale)
    return -(ce.sum(dim=-1) / valid.sum(dim=-1).clamp(min=1))
