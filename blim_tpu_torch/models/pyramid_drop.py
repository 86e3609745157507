"""PyramidDrop: in-LLM video-token pruning (port of
blim_tpu/models/pyramid_drop.py).

At each configured layer the video-token span is ranked by the attention
the last instruction token pays it (computed with that layer's input
layernorm and q/k projections), a ratio of it is kept, and the sequence is
repacked as [prefix | kept video | suffix]. BLiM's configs leave it off (an
empty layer list), but a config that sets `mm_llm_compress` turns it on.

The video block sits at a fixed window and each stage keeps
int(n_video * ratio) tokens, so every stage's length is known before the
forward. The decoder runs in segments between the drops, each a loop over
its slice of the stacked layers through the port's decoder layer (B1 on
CUDA); the ranking attention is plain torch ops, as it is plain XLA in the
JAX package. After each drop the positions renumber 0..len-1, as the
reference's repack does, so layouts must be right-padded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from blim_tpu_torch.core.config import Qwen2Config
from blim_tpu_torch.core.numerics import einsum_fp32
from blim_tpu_torch.kernels.attention import NEG_INF
from blim_tpu_torch.models.qwen2 import (_decoder_layer, _layer_slice, apply_rope, rms_norm,
                                         rope_cos_sin)

Params = dict


def _slice_layers(layers: Params, lo: int, hi: int) -> Params:
    """Layers [lo, hi) of a stacked (L, ...) tree."""
    return {k: _slice_layers(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in layers.items()}


def _n_layers(layers: Params) -> int:
    leaf = layers
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _run_segment(params_layers: Params, config: Qwen2Config, hidden: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], position_ids: torch.Tensor,
                 lora_layers: Optional[Params], lora_scale: float,
                 remat: bool) -> torch.Tensor:
    """The stacked layers of one segment over hidden (B, S, D), the mask as
    both key and query mask; with `remat` each layer under activation
    checkpointing."""
    cos, sin = rope_cos_sin(position_ids, config.head_dim, config.rope_theta)

    def layer(h, lp, ll):
        return _decoder_layer(config, lp, h, cos, sin, attention_mask, None, ll, lora_scale)[0]

    for i in range(_n_layers(params_layers)):
        lp = _layer_slice(params_layers, i)
        ll = _layer_slice(lora_layers, i)
        if remat:
            hidden = checkpoint(layer, hidden, lp, ll, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            hidden = layer(hidden, lp, ll)
    return hidden


def rank_video_tokens(layer_params: Params,          # the rank layer's (unstacked) weights
                      config: Qwen2Config,
                      hidden: torch.Tensor,           # (B, S, D) pre-layernorm residual stream
                      attention_mask: Optional[torch.Tensor],   # (B, S)
                      position_ids: torch.Tensor,     # (B, S)
                      query_pos: int,                 # the last instruction token
                      video_start: int,
                      n_video: int) -> torch.Tensor:
    """Mean over heads of the attention the query token pays each video
    token -> (B, n_video), fp32."""
    c = config
    B, S, _ = hidden.shape
    H, Kh, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    x = rms_norm(hidden, layer_params["input_layernorm"]["scale"], c.rms_norm_eps)
    q = (x @ layer_params["q_proj"]["kernel"] + layer_params["q_proj"]["bias"]).reshape(B, S, H, hd)
    k = (x @ layer_params["k_proj"]["kernel"] + layer_params["k_proj"]["bias"]).reshape(B, S, Kh, hd)
    cos, sin = rope_cos_sin(position_ids, hd, c.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    qt = q[:, query_pos].reshape(B, Kh, H // Kh, hd).float() * hd ** -0.5
    scores = einsum_fp32("bhgd,bshd->bhgs", qt, k)                     # (B, Kh, G, S)
    visible = (torch.arange(S, device=hidden.device) <= query_pos)[None]
    if attention_mask is not None:
        visible = visible & (attention_mask > 0)
    scores = scores.masked_fill(~visible[:, None, None, :], NEG_INF)
    mean_heads = torch.softmax(scores, dim=-1).reshape(B, H, S).mean(dim=1)
    return mean_heads[:, video_start: video_start + n_video]


def pdrop_forward_hidden(params: Params, config: Qwen2Config,
                         inputs_embeds: torch.Tensor,     # (B, S, D), right-padded layout
                         attention_mask: Optional[torch.Tensor],
                         video_start: int, n_video: int,
                         query_pos: int,                  # the last instruction token
                         layer_list: Sequence[int],       # 1-based rank layers
                         ratio_list: Sequence[float],     # len(layer_list) + 1, leading 1.0
                         compress_type: str = "attention",   # attention | uniform |
                                                             # uniform0_attention
                         lora: Optional[Params] = None, lora_scale: float = 0.0,
                         remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder stack with staged video-token dropping. Returns (post-norm
    hidden (B, S_final, D), the kept tokens' indices (B, S_final) into the
    original sequence)."""
    assert len(ratio_list) == len(layer_list) + 1, (layer_list, ratio_list)
    c = config
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    hidden = inputs_embeds
    position_ids = torch.arange(S, device=dev)[None].expand(B, S)
    index_map = position_ids
    mask = attention_mask
    lora_layers = None if lora is None else lora["layers"]

    def seg_lora(lo, hi):
        return None if lora_layers is None else _slice_layers(lora_layers, lo, hi)

    cur_video, cur_vstart, cur_qpos, prev = n_video, video_start, query_pos, 0
    for stage, rank_layer in enumerate(layer_list):
        # layers [prev, rank_layer) run, then layer rank_layer's projections rank
        hidden = _run_segment(_slice_layers(params["layers"], prev, rank_layer), c, hidden, mask,
                              position_ids, seg_lora(prev, rank_layer), lora_scale, remat)
        prev = rank_layer
        keep = int(n_video * ratio_list[stage + 1])
        if keep >= cur_video:
            continue
        stage_type = compress_type
        if compress_type == "uniform0_attention":
            stage_type = "uniform" if stage == 0 else "attention"
        if stage_type == "attention":
            weights = rank_video_tokens(_layer_slice(params["layers"], rank_layer), c, hidden,
                                        mask, position_ids, cur_qpos, cur_vstart, cur_video)
            top = torch.topk(weights, keep, dim=-1).indices.sort(dim=-1).values
        elif stage_type == "uniform":
            lin = np.linspace(0, cur_video - 1, keep).astype(np.int64)
            top = torch.from_numpy(lin).to(dev)[None].expand(B, keep)
        else:
            raise NotImplementedError(stage_type)
        s_cur = hidden.shape[1]
        gather = torch.cat([torch.arange(cur_vstart, device=dev)[None].expand(B, cur_vstart),
                            top + cur_vstart,
                            torch.arange(cur_vstart + cur_video, s_cur, device=dev)[None].expand(
                                B, s_cur - cur_vstart - cur_video)], dim=1)     # (B, S_new)
        hidden = hidden.gather(1, gather[..., None].expand(-1, -1, hidden.shape[-1]))
        index_map = index_map.gather(1, gather)
        if mask is not None:
            mask = mask.gather(1, gather)
        s_new = gather.shape[1]
        position_ids = torch.arange(s_new, device=dev)[None].expand(B, s_new)
        cur_qpos -= cur_video - keep
        cur_video = keep

    hidden = _run_segment(_slice_layers(params["layers"], prev, c.num_hidden_layers), c, hidden,
                          mask, position_ids, seg_lora(prev, c.num_hidden_layers), lora_scale,
                          remat)
    return rms_norm(hidden, params["norm"]["scale"], c.rms_norm_eps), index_map
