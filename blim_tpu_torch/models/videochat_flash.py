"""VideoChat-Flash scoring and training surface (port of the VTG and TVG
scoring and the training forwards of blim_tpu/models/videochat_flash.py).

Batch dict contract of the naive paths (`score_vtg`, `score_tvg`):
  input_ids       (B, T) int   layout token ids (video slots arbitrary)
  attention_mask  (B, T) int   1 = real token
  cpn_mask        (B, T) int   CPN prior visibility mask
  video           (B, clips, tokens_per_clip, mm) cached features
  window_labels   (B, W) int   VTG only: labels of the static label window
  video_label     (B,) int     TVG only: vocabulary index of the row's video

Training forwards (`vtg_hidden`, `tvg_hidden`) take the LoRA tree, LoRA
dropout on the projector (drawn from a `torch.Generator`) and `remat`
(per-layer activation checkpointing).

Shared-prefix scoring: every VTG pair that shares a video also shares the
whole [pre][video][post] prefix, so the prefix runs once per video and only
the caption suffixes run per pair. The CPN prior masks the video out of
attention, so its text-only prefix runs once per dataset. In the TVG
direction the caption is the prefix: caption prefixes are packed back to
back into rows (`tvg_pack_prefix_kv`) and each (caption, video) pair is a
clips-wide query against its caption's segment (`score_tvg_packed`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from blim_tpu_torch.core.config import ModelConfig
from blim_tpu_torch.models import projector as projector_lib
from blim_tpu_torch.models import qwen2
from blim_tpu_torch.scoring import criteria

Params = Dict[str, Any]


def _lora_parts(lora: Optional[Params]):
    if lora is None:
        return None, None
    return lora.get("llm"), lora.get("projector")


def _lm_head_parts(params: Params, lora: Optional[Params]):
    kernel = qwen2.lm_head_kernel(params["llm"])
    llm_lora, _ = _lora_parts(lora)
    if llm_lora is not None and "lm_head" in llm_lora:
        return kernel, llm_lora["lm_head"]["a"], llm_lora["lm_head"]["b"]
    return kernel, None, None


def splice_video(token_embeds: torch.Tensor,   # (B, T, D)
                 video_embeds: torch.Tensor,   # (B, Nv, D)
                 video_start: int) -> torch.Tensor:
    """Overwrite the layout's video slot with projected video embeddings."""
    nv = video_embeds.shape[1]
    return torch.cat([token_embeds[:, :video_start],
                      video_embeds.to(token_embeds.dtype),
                      token_embeds[:, video_start + nv:]], dim=1)


def _embed_with_video(params, ids, video, video_start, lora, lora_scale, project=None,
                      **dropout):
    _, proj_lora = _lora_parts(lora)
    vid = (project or projector_lib.project_vtg)(params["projector"], video, lora=proj_lora,
                                                 lora_scale=lora_scale, **dropout)
    return splice_video(qwen2.embed_tokens(params["llm"], ids), vid, video_start)


def vtg_hidden(params: Params, config: ModelConfig, input_ids: torch.Tensor,
               mask: torch.Tensor, video: torch.Tensor, video_start: int, *,
               lora: Optional[Params] = None, lora_scale: float = 0.0,
               generator: Optional[torch.Generator] = None, lora_dropout: float = 0.0,
               remat: bool = False) -> torch.Tensor:
    """Embed + splice + decode for the VTG direction; returns (B, T, D)."""
    emb = _embed_with_video(params, input_ids, video, video_start, lora, lora_scale,
                            generator=generator, lora_dropout=lora_dropout)
    llm_lora, _ = _lora_parts(lora)
    return qwen2.forward_hidden(params["llm"], config.llm, emb, mask,
                                lora=llm_lora, lora_scale=lora_scale, remat=remat)


def tvg_hidden(params: Params, config: ModelConfig, input_ids: torch.Tensor,
               mask: torch.Tensor, video: torch.Tensor, video_start: int, *,
               lora: Optional[Params] = None, lora_scale: float = 0.0,
               generator: Optional[torch.Generator] = None, lora_dropout: float = 0.0,
               remat: bool = False) -> torch.Tensor:
    """Embed + splice + decode for the TVG direction (one token per clip);
    returns (B, T, D)."""
    emb = _embed_with_video(params, input_ids, video, video_start, lora, lora_scale,
                            project=projector_lib.project_tvg, generator=generator,
                            lora_dropout=lora_dropout)
    llm_lora, _ = _lora_parts(lora)
    return qwen2.forward_hidden(params["llm"], config.llm, emb, mask,
                                lora=llm_lora, lora_scale=lora_scale, remat=remat)


def vtg_window_logits(params: Params, config: ModelConfig, hidden: torch.Tensor,
                      window_start: int, window_len: int, lora: Optional[Params] = None,
                      lora_scale: float = 0.0) -> torch.Tensor:
    """Slice the static label window and apply the LM head (fp32, with its
    LoRA) there only."""
    llm_lora, _ = _lora_parts(lora)
    return qwen2.lm_logits(params["llm"], hidden[:, window_start: window_start + window_len],
                           config.llm, lora=llm_lora, lora_scale=lora_scale)


def make_video_vocab(features: torch.Tensor) -> torch.Tensor:
    """(V, clips, tokens_per_clip, mm) cached features -> (V, clips, mm)
    vocabulary, the mean over the token axis."""
    return features.mean(dim=-2)


def score_vtg(params: Params, config: ModelConfig, batch: Dict[str, torch.Tensor],
              video_start: int, window_start: int, window_len: int, *,
              cpn: bool = False, lora: Optional[Params] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    """P(caption | video) per row over the full sequence, or the CPN prior
    P(caption) with cpn=True (video block masked out of attention). The
    naive baseline the shared-prefix path is held to."""
    mask = batch["cpn_mask"] if cpn else batch["attention_mask"]
    hidden = vtg_hidden(params, config, batch["input_ids"], mask, batch["video"],
                        video_start, lora=lora, lora_scale=lora_scale)
    win = hidden[:, window_start : window_start + window_len]
    kernel, la, lb = _lm_head_parts(params, lora)
    return criteria.vtg_likelihood_from_hidden(win, kernel, batch["window_labels"],
                                               la, lb, lora_scale)


def vtg_prefix_hidden_kv(params: Params, config: ModelConfig,
                         prefix_ids: torch.Tensor,   # (G, P)
                         video: torch.Tensor,        # (G, clips, tokens_per_clip, mm)
                         video_start: int,
                         position_ids: Optional[torch.Tensor] = None,
                         prefix_mask: Optional[torch.Tensor] = None,   # (G, P); None = all real
                         *, lora: Optional[Params] = None, lora_scale: float = 0.0):
    """Video-prefix forward returning per-layer K/V (L, G, P, Hkv, hd)."""
    emb = _embed_with_video(params, prefix_ids, video, video_start, lora, lora_scale)
    if prefix_mask is None:
        prefix_mask = torch.ones(prefix_ids.shape, dtype=torch.int32, device=prefix_ids.device)
    llm_lora, _ = _lora_parts(lora)
    _, kv = qwen2.forward_collect_kv(params["llm"], config.llm, emb, prefix_mask, position_ids,
                                     lora=llm_lora, lora_scale=lora_scale)
    return kv


def vtg_text_prefix_kv(params: Params, config: ModelConfig,
                       prefix_ids: torch.Tensor,      # (1, P2) pre + post[:-1]
                       position_ids: torch.Tensor,    # (1, P2) layout positions (gap at video)
                       prefix_mask: Optional[torch.Tensor] = None, *,
                       lora: Optional[Params] = None, lora_scale: float = 0.0):
    """Prefix K/V for the CPN prior P(t): the video block is invisible, so the
    prefix is pure text at its original (gapped) positions."""
    emb = qwen2.embed_tokens(params["llm"], prefix_ids)
    if prefix_mask is None:
        prefix_mask = torch.ones(prefix_ids.shape, dtype=torch.int32, device=prefix_ids.device)
    llm_lora, _ = _lora_parts(lora)
    _, kv = qwen2.forward_collect_kv(params["llm"], config.llm, emb, prefix_mask, position_ids,
                                     lora=llm_lora, lora_scale=lora_scale)
    return kv


def score_vtg_packed(params: Params, config: ModelConfig,
                     prefix_kv,                    # k/v: (L, G, P, Hkv, hd)
                     pack_ids: torch.Tensor,       # (G, T) packed caption suffix tokens
                     pack_seg: torch.Tensor,       # (G, T) segment per token; -1 = padding
                     pack_pos: torch.Tensor,       # (G, T) global positions
                     pack_labels: torch.Tensor,    # (G, T) next-token labels; IGNORE elsewhere
                     n_segments: int, *,
                     prefix_mask: Optional[torch.Tensor] = None,
                     lora: Optional[Params] = None,
                     lora_scale: float = 0.0) -> torch.Tensor:
    """Per-segment mean log-likelihoods for a pack of caption suffixes that
    share one prefix -> (G, n_segments)."""
    llm_lora, _ = _lora_parts(lora)
    emb = qwen2.embed_tokens(params["llm"], pack_ids)
    hidden = qwen2.forward_packed_suffix(params["llm"], config.llm, emb, prefix_kv,
                                         pack_seg, pack_pos, prefix_mask=prefix_mask,
                                         lora=llm_lora, lora_scale=lora_scale)
    kernel, la, lb = _lm_head_parts(params, lora)
    ce, valid = criteria.ce_from_hidden(hidden, kernel, pack_labels, la, lb, lora_scale)
    seg_oh = F.one_hot(pack_seg.clamp(0, n_segments - 1).long(), n_segments).float()
    seg_oh = seg_oh * (pack_seg >= 0)[..., None].float()
    total = torch.einsum("gts,gt->gs", seg_oh, ce)
    count = torch.einsum("gts,gt->gs", seg_oh, valid.float())
    return -(total / count.clamp(min=1.0))


def score_tvg(params: Params, config: ModelConfig, batch: Dict[str, torch.Tensor],
              video_vocab: torch.Tensor,      # (V, clips, mm)
              video_start: int, gather_start: int, *, cpn: bool = False,
              lora: Optional[Params] = None, lora_scale: float = 0.0) -> torch.Tensor:
    """P(video | caption) per row through the visual_head classifier over the
    video vocabulary, or the CPN prior P(video) with cpn=True (the caption
    masked down to the instruction head). The batch carries `video_label`
    (B,), the vocabulary index of each row's video. The naive full-sequence
    baseline the packed-prefix path is held to."""
    mask = batch["cpn_mask"] if cpn else batch["attention_mask"]
    hidden = tvg_hidden(params, config, batch["input_ids"], mask, batch["video"], video_start,
                        lora=lora, lora_scale=lora_scale)
    clip_hidden = hidden[:, gather_start: gather_start + config.num_clips]
    logits = criteria.tvg_clip_logits(clip_hidden, params["visual_head"]["kernel"], video_vocab)
    return criteria.tvg_likelihood(logits, batch["video_label"])


def tvg_pack_prefix_kv(params: Params, config: ModelConfig,
                       pack_ids: torch.Tensor,   # (G, T) caption prefixes packed back to back
                       pack_seg: torch.Tensor,   # (G, T) segment per token; -1 = padding
                       pack_pos: torch.Tensor,   # (G, T) absolute positions (P_full - L_c + j)
                       *, lora: Optional[Params] = None, lora_scale: float = 0.0):
    """Packed-prefix K/V (L, G, T, Hkv, hd) for the TVG direction: many
    variable-length caption prefixes share one row with block-diagonal
    causal attention. The TVG prefix is pure text, so no video splice."""
    llm_lora, _ = _lora_parts(lora)
    emb = qwen2.embed_tokens(params["llm"], pack_ids)
    _, kv = qwen2.forward_collect_kv_packed(params["llm"], config.llm, emb, pack_seg, pack_pos,
                                            lora=llm_lora, lora_scale=lora_scale)
    return kv


def score_tvg_packed(params: Params, config: ModelConfig,
                     pack_kv,                   # k/v: (L, G, T, Hkv, hd) packed prefix K/V
                     pack_seg: torch.Tensor,    # (G, T) segment per pack token
                     q_seg: torch.Tensor,       # (G, Q) segment per query; -1 = unused slot
                     q_first: torch.Tensor,     # (G, Q) last text token of the query's caption
                     q_video: torch.Tensor,     # (G, Q, clips, D) per-video TVG embeddings
                     q_label: torch.Tensor,     # (G, Q) vocabulary index of each query's video
                     video_vocab: torch.Tensor,  # (V, clips, mm)
                     position_offset: int,      # global position of suffix token 0 (P_full)
                     *, cpn: bool = False, lora: Optional[Params] = None,
                     lora_scale: float = 0.0) -> torch.Tensor:
    """Packed-TVG likelihood, or with cpn the prior -> (G, Q): a flat query
    list per pack, each query attending to its own segment of the packed
    prefix. The suffix is [last text token | clips - 1 clip embeddings]
    (W = clips): hidden positions 0..clips-1 are all the TVG head reads, and
    causality makes the last clip and the terminators unreadable by them.
    With cpn the last text token (suffix column 0) is masked."""
    g, qn = q_seg.shape
    clips = config.num_clips
    emb_dtype = params["llm"]["embed_tokens"]["embedding"].dtype
    llm_lora, _ = _lora_parts(lora)
    first = qwen2.embed_tokens(params["llm"], q_first)[:, :, None, :]          # (G,Q,1,D)
    vid = q_video.to(emb_dtype)[:, :, : clips - 1]                            # (G,Q,clips-1,D)
    suffix = torch.cat([first.to(emb_dtype), vid], dim=2)                     # (G,Q,clips,D)
    valid = q_seg >= 0
    suffix_mask = valid[:, :, None].to(torch.int32).repeat(1, 1, clips)
    if cpn:
        suffix_mask[:, :, 0] = 0
    prefix_mask = (pack_seg[:, None, :] == q_seg[:, :, None]) & valid[:, :, None]
    hidden = qwen2.forward_suffix_with_prefix(
        params["llm"], config.llm, suffix, pack_kv, suffix_mask, position_offset,
        prefix_mask=prefix_mask, lora=llm_lora, lora_scale=lora_scale)
    clip_hidden = hidden.reshape(g * qn, clips, -1)
    logits = criteria.tvg_clip_logits(clip_hidden, params["visual_head"]["kernel"], video_vocab)
    return criteria.tvg_likelihood(logits, q_label.reshape(-1)).reshape(g, qn)
