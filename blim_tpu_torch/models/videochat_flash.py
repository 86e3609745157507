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
clips-wide query against its caption's segment (`score_tvg_packed`). The
rectangle schedule scores K suffixes of one width per prefix instead
(`score_vtg_suffix`; `tvg_prefix_kv`, one left-padded caption prefix a
row, and `score_tvg_shared`).

PyramidDrop (`vtg_hidden_pdrop`, models/pyramid_drop.py) drops video
tokens inside the decoder when the config turns it on.

Interactive use: `chat` (a video file -> featurizer -> prompt -> `generate`
-> text and history) and `generate` (splice at the prompt's image slot,
then models/generation's prefill and KV-cache decode); the single-image
path `encode_image_tiles` (tower on 1-frame tiles, ToMe to 64, `mlp`) and
`merge_image_patches` (anyres tiles back to raster order).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from blim_tpu_torch.core.config import ModelConfig
from blim_tpu_torch.core.device import DeviceLike, resolve_device
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


def score_vtg_suffix(params: Params, config: ModelConfig,
                     prefix_kv,                    # k/v: (L, G, P, Hkv, hd)
                     suffix_ids: torch.Tensor,     # (G, K, W)
                     suffix_mask: torch.Tensor,    # (G, K, W)
                     suffix_labels: torch.Tensor,  # (G, K, W-1): label of hidden i is token i+1
                     position_offset: int, *,
                     prefix_mask: Optional[torch.Tensor] = None,
                     lora: Optional[Params] = None,
                     lora_scale: float = 0.0) -> torch.Tensor:
    """Likelihood of each of K caption suffixes given its group's prefix ->
    (G, K): the rectangle counterpart of `score_vtg_packed`, every suffix
    padded to the group's width W."""
    llm_lora, _ = _lora_parts(lora)
    emb = qwen2.embed_tokens(params["llm"], suffix_ids)
    hidden = qwen2.forward_suffix_with_prefix(params["llm"], config.llm, emb, prefix_kv,
                                              suffix_mask, position_offset,
                                              prefix_mask=prefix_mask, lora=llm_lora,
                                              lora_scale=lora_scale)
    kernel, la, lb = _lm_head_parts(params, lora)
    return criteria.vtg_likelihood_from_hidden(hidden[:, :, :-1], kernel, suffix_labels,
                                               la, lb, lora_scale)


def pdrop_total_dropped(config: ModelConfig) -> int:
    """Video tokens PyramidDrop removes by the last layer: the caption region
    and gather positions shift by this much when mm_llm_compress is on."""
    if not config.mm_llm_compress or not config.llm_compress_layer_list:
        return 0
    final_ratio = config.llm_image_token_ratio_list[len(config.llm_compress_layer_list)]
    return config.video_tokens_vtg - int(config.video_tokens_vtg * final_ratio)


def vtg_hidden_pdrop(params: Params, config: ModelConfig, input_ids: torch.Tensor,
                     mask: torch.Tensor, video: torch.Tensor, video_start: int,
                     query_pos: int,              # the last instruction token (prompt end)
                     *, lora: Optional[Params] = None, lora_scale: float = 0.0,
                     generator: Optional[torch.Generator] = None, lora_dropout: float = 0.0,
                     remat: bool = False):
    """VTG forward with PyramidDrop's in-LLM video-token pruning (on when
    config.mm_llm_compress is). Returns (post-norm hidden (B, T -
    pdrop_total_dropped(config), D), the kept tokens' indices (B, T') into
    the original sequence). Right-padded layouts only."""
    from blim_tpu_torch.models.pyramid_drop import pdrop_forward_hidden

    emb = _embed_with_video(params, input_ids, video, video_start, lora, lora_scale,
                            generator=generator, lora_dropout=lora_dropout)
    llm_lora, _ = _lora_parts(lora)
    return pdrop_forward_hidden(
        params["llm"], config.llm, emb, mask, video_start, config.video_tokens_vtg, query_pos,
        config.llm_compress_layer_list, config.llm_image_token_ratio_list,
        compress_type=config.llm_compress_type, lora=llm_lora, lora_scale=lora_scale,
        remat=remat)


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


def tvg_prefix_kv(params: Params, config: ModelConfig,
                  prefix_ids: torch.Tensor,    # (G, P) left-padded prompt through "assistant\n"[:-1]
                  prefix_mask: torch.Tensor,   # (G, P) the attention mask or the CPN prior mask
                  position_ids: Optional[torch.Tensor] = None,   # absolute positions of a
                  *, lora: Optional[Params] = None,              # row trimmed from the left
                  lora_scale: float = 0.0):
    """Per-caption TVG prefix K/V (L, G, P, Hkv, hd), one row a caption
    (B1 on CUDA). With the CPN prefix mask only the instruction head stays
    visible, for the prior P(video)."""
    llm_lora, _ = _lora_parts(lora)
    emb = qwen2.embed_tokens(params["llm"], prefix_ids)
    _, kv = qwen2.forward_collect_kv(params["llm"], config.llm, emb, prefix_mask, position_ids,
                                     lora=llm_lora, lora_scale=lora_scale)
    return kv


def score_tvg_shared(params: Params, config: ModelConfig,
                     prefix_kv,                     # k/v: (L, G, P, Hkv, hd)
                     prefix_mask: torch.Tensor,     # (G, P)
                     first_ids: torch.Tensor,       # (G,) last text token (suffix position 0)
                     video: torch.Tensor,           # (G, K, clips, D) TVG embeddings, or
                                                    # (G, K, clips, tokens_per_clip, mm) features
                     video_label: torch.Tensor,     # (G, K) vocabulary index of each pair's video
                     video_vocab: torch.Tensor,     # (V, clips, mm)
                     terminator_ids,                # tuple of terminator token ids
                     position_offset: int,          # global position of suffix token 0
                     *, cpn: bool = False, lora: Optional[Params] = None,
                     lora_scale: float = 0.0) -> torch.Tensor:
    """Shared-prefix TVG likelihood, or with cpn the prior -> (G, K): K
    candidate videos against each caption's prefix. Suffix = [last text
    token | clip tokens | terminators]; hidden positions 0..clips-1 predict
    clips 0..clips-1. With cpn the last text token (suffix position 0) is
    masked: it lies beyond the instruction head."""
    llm_lora, proj_lora = _lora_parts(lora)
    g, k = video.shape[:2]
    clips = config.num_clips
    emb_dtype = params["llm"]["embed_tokens"]["embedding"].dtype
    first = qwen2.embed_tokens(params["llm"], first_ids)[:, None, None, :]
    first = first.expand(g, k, 1, first.shape[-1])
    if video.ndim == 4:
        vid = video.to(emb_dtype)
    else:
        vid = projector_lib.project_tvg(params["projector"], video, lora=proj_lora,
                                        lora_scale=lora_scale).to(emb_dtype)
    term_ids = torch.as_tensor(list(terminator_ids), dtype=torch.int64, device=first_ids.device)
    term = qwen2.embed_tokens(params["llm"], term_ids)
    term = term[None, None].expand(g, k, len(terminator_ids), term.shape[-1])
    suffix = torch.cat([first.to(emb_dtype), vid, term.to(emb_dtype)], dim=2)
    suffix_mask = torch.ones(suffix.shape[:3], dtype=torch.int32, device=suffix.device)
    if cpn:
        suffix_mask[:, :, 0] = 0
    hidden = qwen2.forward_suffix_with_prefix(params["llm"], config.llm, suffix, prefix_kv,
                                              suffix_mask, position_offset,
                                              prefix_mask=prefix_mask, lora=llm_lora,
                                              lora_scale=lora_scale)
    clip_hidden = hidden[:, :, :clips].reshape(g * k, clips, -1)
    logits = criteria.tvg_clip_logits(clip_hidden, params["visual_head"]["kernel"], video_vocab)
    return criteria.tvg_likelihood(logits, video_label.reshape(-1)).reshape(g, k)


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


# ---------------------------------------------------------------------------
# Interactive generation (generate / chat) and the single-image path
# ---------------------------------------------------------------------------

def encode_image_tiles(params: Params,              # must include "vision_tower"
                       config: ModelConfig,
                       pixels,                      # (N, 3, H, W) anyres tiles, base first
                       lora: Optional[Params] = None, lora_scale: float = 0.0,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """Single-image encode: each anyres tile runs the tower as a 1-frame
    clip with the image position table (B2 on CUDA at S = patches a frame),
    ToMe-compresses to 64 tokens and projects through `mlp` -> (N, 64,
    hidden). Pixels enter the tower in its parameters' dtype."""
    from blim_tpu_torch.models import umt_vit

    dev = resolve_device(device)
    tower = params["vision_tower"]
    pixels = torch.as_tensor(pixels).to(device=dev, dtype=tower["patch_embed"]["kernel"].dtype)
    n = pixels.shape[0]
    _, pos_img = umt_vit.build_pos_tables(config.vision)
    with torch.no_grad():
        feats = umt_vit.encode_clips(tower, pixels[:, None], pos_img,
                                     config.vision)                   # (N, patches, mm)
        compressed = projector_lib.compress_image_tokens(
            feats.reshape(n, -1, config.mm_hidden_size), config.vision.num_attention_heads,
            target=64)
        mlp = params["projector"]["mlp"]
        return projector_lib.mlp_apply(mlp, compressed.to(mlp["fc1"]["kernel"].dtype),
                                       lora=None if lora is None else lora["projector"].get("mlp"),
                                       lora_scale=lora_scale)


def merge_image_patches(image_feature: torch.Tensor,   # (N_tiles, 64, hidden), base first
                        image_size,                    # original (width, height)
                        config: ModelConfig,
                        image_grid_pinpoints,
                        image_aspect_ratio: str = "anyres_nopad",
                        mm_patch_merge_type: str = "spatial_nopad") -> torch.Tensor:
    """Reassemble anyres tile features into one token sequence: grid tiles
    view as (nph, npw, 8, 8, C), transpose to raster order, flatten, and
    prepend the base view. Branches the reference leaves unimplemented
    (maxpool2x2, unpad, non-anyres) raise."""
    from blim_tpu_torch.data.images import get_anyres_image_grid_shape

    if image_feature.shape[0] == 1:
        if "unpad" in mm_patch_merge_type:
            raise NotImplementedError("unpad newline: unimplemented in the reference path")
        return image_feature[0]
    base = image_feature[0]
    tiles = image_feature[1:]
    hw = 8  # num_image_patches_per_side
    assert hw * hw == tiles.shape[1], tiles.shape
    if "anyres" not in image_aspect_ratio:
        raise NotImplementedError(image_aspect_ratio)
    npw, nph = get_anyres_image_grid_shape(image_size, image_grid_pinpoints,
                                           config.vision.image_size)
    if "maxpool2x2" in mm_patch_merge_type or "unpad" in mm_patch_merge_type:
        raise NotImplementedError("unimplemented in the reference path")
    feat = tiles.reshape(nph, npw, hw, hw, tiles.shape[-1])
    feat = feat.permute(0, 2, 1, 3, 4).reshape(-1, tiles.shape[-1])
    if "nobase" in mm_patch_merge_type:
        return feat
    return torch.cat([base, feat], dim=0)


def generate(params: Params, config: ModelConfig,
             input_ids,                      # flat prompt ids holding one -200 image slot
             video_embeds: torch.Tensor,     # (Nv, D) projected video embeddings
             tokenizer, max_new_tokens: int = 256, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             lora: Optional[Params] = None,  # {"llm": ..., "projector": ...}
             lora_scale: float = 0.0, device: DeviceLike = "cuda",
             return_logits: bool = False):
    """Single-prompt generation: the video embeddings spliced at the first
    IMAGE_TOKEN_INDEX slot (or none, for a text-only prompt), prefill and
    KV-cache decode; a LoRA tree applies throughout. Returns the
    (max_new_tokens,) token ids as numpy, and with `return_logits` also the
    (steps run, V) fp32 logits they were chosen from."""
    from blim_tpu_torch.core.constants import IMAGE_TOKEN_INDEX
    from blim_tpu_torch.models import generation

    dev = resolve_device(device)
    llm = params["llm"]
    ids = np.asarray(input_ids)
    (img_pos,) = np.nonzero(ids == IMAGE_TOKEN_INDEX)
    as_ids = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)  # noqa: E731
    if len(img_pos):
        ip = int(img_pos[0])
        emb = torch.cat([qwen2.embed_tokens(llm, as_ids(ids[:ip])),
                         video_embeds.to(device=dev, dtype=llm["embed_tokens"]["embedding"].dtype),
                         qwen2.embed_tokens(llm, as_ids(ids[ip + 1:]))], dim=0)[None]
    else:
        emb = qwen2.embed_tokens(llm, as_ids(ids))[None]
    mask = torch.ones(emb.shape[:2], dtype=torch.int32, device=dev)
    eos = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None else [151645]
    out = generation.generate_tokens(
        llm, config.llm, emb, mask, max_new_tokens, eos, temperature=temperature,
        generator=generator, lora=None if lora is None else lora["llm"], lora_scale=lora_scale,
        return_logits=return_logits)
    if return_logits:
        tokens, logits = out
        return tokens[0].cpu().numpy(), logits[0]
    return out[0].cpu().numpy()


def chat(params: Params, config: ModelConfig, video_path: str, tokenizer, user_prompt: str,
         featurize,                          # pixels -> cached features (extract.make_featurizer)
         image_processor, chat_history: Optional[list] = None, return_history: bool = True,
         max_num_frames: int = 512, max_new_tokens: int = 256, temperature: float = 0.0,
         generator: Optional[torch.Generator] = None,
         lora: Optional[Params] = None,      # {"llm": ..., "projector": ...}
         lora_scale: float = 0.0, device: DeviceLike = "cuda"):
    """Video chat: decode -> featurize -> prompt -> generate -> detokenize.
    The first turn carries the video and the time message; later turns
    replay `chat_history`. Returns (text, history), or the text alone."""
    from blim_tpu_torch.core.constants import DEFAULT_IMAGE_TOKEN
    from blim_tpu_torch.data.conversation import conv_templates
    from blim_tpu_torch.data.prompts import tokenizer_image_token
    from blim_tpu_torch.data.video import load_video
    from blim_tpu_torch.models.generation import KeywordsStoppingCriteria

    dev = resolve_device(device)
    frames, time_msg = load_video(video_path, max_num_frames=max_num_frames,
                                  local_num_frames=config.mm_local_num_frames)
    pixels = image_processor.preprocess(frames)  # (T, 3, H, W)
    lf = config.mm_local_num_frames
    clips = len(pixels) // lf
    pix = torch.from_numpy(np.ascontiguousarray(
        pixels[: clips * lf].reshape(1, clips, lf, *pixels.shape[1:])))
    feats = featurize(pix)[0]                    # (clips, tokens_per_clip, mm)
    proj = params["projector"]
    with torch.no_grad():
        video_embeds = projector_lib.project_vtg(
            proj, feats[None].to(device=dev, dtype=proj["mlp"]["fc1"]["kernel"].dtype),
            lora=None if lora is None else lora["projector"], lora_scale=lora_scale)[0]

    conv = conv_templates["qwen_2"].copy()
    if chat_history:
        for msg in chat_history:
            conv.append_message(msg["role"], msg["content"])
        conv.append_message(conv.roles[0], user_prompt)
    else:
        conv.append_message(conv.roles[0],
                            f"{DEFAULT_IMAGE_TOKEN}\n{time_msg.strip()} {user_prompt}")
    conv.append_message(conv.roles[1], None)
    input_ids = tokenizer_image_token(conv.get_prompt(), tokenizer)

    tokens = generate(params, config, input_ids, video_embeds, tokenizer,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      generator=generator, lora=lora, lora_scale=lora_scale, device=dev)
    text = tokenizer.decode(list(tokens), skip_special_tokens=True)
    text = KeywordsStoppingCriteria([conv.sep], tokenizer).trim(text)

    history = list(chat_history or [])
    history.append({"role": conv.roles[0], "content": user_prompt})
    history.append({"role": conv.roles[1], "content": text})
    return (text, history) if return_history else text
