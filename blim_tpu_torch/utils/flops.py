"""Analytic forward-FLOP accounting (copy of blim_tpu/utils/flops.py).

The rerank engine counts the FLOPs it dispatches (`RerankEngine.flops`) and
the request's zero-waste work (`useful_flops`) with these formulas; a
timing harness divides them by elapsed time x the card's peak for MFU.

FLOPs model:

  * one multiply-accumulate = 2 FLOPs;
  * decoder body, per token per layer:
      q_proj 2*h*(nh*dh) + k,v_proj 2*2*h*(nkv*dh) + o_proj 2*(nh*dh)*h
      + SwiGLU MLP 3 matmuls = 6*h*i
    (norms/rotary/elementwise are <0.5% and are ignored);
  * attention score+PV, per layer: 4*dh*nh*sum(q_len*kv_len);
  * lm_head (the fused chunked-vocab CE computes the same product): 2*h*V
    per scored position;
  * visual_head + video-vocab bmm (TVG): 2*h*mm + 2*mm*Vv per gathered clip.

Only dispatched work counts: padding inside a step counts, skipped pairs do
not. A mixture-of-experts decoder is counted through `dense_view` and
`routed_flops`, after the copied formulas. Everything from `decoder_matmul_flops_per_token` to the TPU peak table
is the original's text byte for byte (tests/test_torch_copies.py pins it);
`peak_flops_per_chip` reads a torch device instead of a JAX one.
"""

from __future__ import annotations

import torch

import dataclasses

from blim_tpu_torch.core.config import ModelConfig, Qwen2Config, moe_of


def decoder_matmul_flops_per_token(cfg: Qwen2Config) -> float:
    """Forward matmul FLOPs per token through all decoder layers (no lm_head)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    qo = 4.0 * h * cfg.num_attention_heads * cfg.head_dim
    kv = 4.0 * h * cfg.num_key_value_heads * cfg.head_dim
    mlp = 6.0 * h * i
    return cfg.num_hidden_layers * (qo + kv + mlp)


def attention_flops(cfg: Qwen2Config, qkv_terms: float) -> float:
    """Score+PV FLOPs for qkv_terms = sum over sequences of q_len*kv_len."""
    return 4.0 * cfg.head_dim * cfg.num_attention_heads * cfg.num_hidden_layers * qkv_terms


def lm_head_flops(cfg: Qwen2Config, positions: float) -> float:
    return 2.0 * cfg.hidden_size * cfg.vocab_size * positions


def causal_self_attn_terms(seq_len: int) -> float:
    """sum_{q=1..S} q for a causal self-attention forward over S tokens."""
    return seq_len * (seq_len + 1) / 2.0


def suffix_attn_terms(width: int, prefix_len: int) -> float:
    """Suffix of `width` tokens attending to a prefix KV of `prefix_len`
    plus itself causally."""
    return width * prefix_len + causal_self_attn_terms(width)


def full_forward_flops(cfg: Qwen2Config, batch: int, seq_len: int,
                       lm_positions: float = 0.0) -> float:
    """One full-sequence causal forward of `batch` sequences of seq_len."""
    return (
        batch * seq_len * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, batch * causal_self_attn_terms(seq_len))
        + lm_head_flops(cfg, batch * lm_positions)
    )


def prefix_forward_flops(cfg: Qwen2Config, batch: int, prefix_len: int) -> float:
    """Prefix-KV forward: full causal body, no lm_head."""
    return full_forward_flops(cfg, batch, prefix_len)


def suffix_forward_flops(cfg: Qwen2Config, batch: int, width: int,
                         prefix_len: int, lm_positions: float = 0.0) -> float:
    """Suffix forward against cached prefix KV."""
    return (
        batch * width * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, batch * suffix_attn_terms(width, prefix_len))
        + lm_head_flops(cfg, batch * lm_positions)
    )


def packed_suffix_forward_flops(cfg: Qwen2Config, n_packs: int, pack_len: int,
                                prefix_len: int) -> float:
    """Packed-suffix forward against cached prefix KV: the attention einsum
    computes the full (T, P+T) score grid per pack (segment masking discards,
    not skips), and the fused CE runs on every pack position."""
    return (
        n_packs * pack_len * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, n_packs * pack_len * (prefix_len + pack_len))
        + lm_head_flops(cfg, n_packs * pack_len)
    )


def suffix_forward_flops_varlen(cfg: Qwen2Config, lens, prefix_len,
                                lm_positions_per_suffix=None) -> float:
    """Sum of suffix_forward_flops over variable-length suffixes `lens`
    (numpy array), each against a prefix of `prefix_len` (scalar or array).
    lm_positions_per_suffix: None -> len-1 per suffix (next-token CE on every
    real position); scalar/array -> that many per suffix.

    This is the USEFUL-work oracle for the rerank schedulers: exactly the
    real tokens of each suffix, no width/pack/batch padding, per-segment
    attention only."""
    import numpy as np

    lens = np.asarray(lens, np.float64)
    if lm_positions_per_suffix is None:
        lm = np.maximum(lens - 1.0, 0.0)
    else:
        lm = np.broadcast_to(np.asarray(lm_positions_per_suffix, np.float64), lens.shape)
    terms = lens * np.asarray(prefix_len, np.float64) + lens * (lens + 1.0) / 2.0
    return float(
        lens.sum() * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, float(terms.sum()))
        + lm_head_flops(cfg, float(lm.sum()))
    )


def prefix_forward_flops_varlen(cfg: Qwen2Config, lens) -> float:
    """Sum of exact-length causal prefix forwards (the useful-work oracle for
    packed prefixes: only the real segment tokens, block-diagonal attention)."""
    import numpy as np

    lens = np.asarray(lens, np.float64)
    terms = lens * (lens + 1.0) / 2.0
    return float(
        lens.sum() * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, float(terms.sum()))
    )


def packed_prefix_kv_flops(cfg: Qwen2Config, n_packs: int, pack_len: int) -> float:
    """Packed-prefix KV forward (block-diagonal causal by segment): the XLA
    attention computes the full (T, T) score grid per pack — segment masking
    discards, not skips."""
    return (
        n_packs * pack_len * decoder_matmul_flops_per_token(cfg)
        + attention_flops(cfg, n_packs * float(pack_len) * pack_len)
    )


def flat_query_suffix_flops(cfg: Qwen2Config, n_queries: int, width: int,
                            pack_len: int) -> float:
    """Flat-query suffix step over a packed prefix: every query's score row
    spans the whole pack (its own segment is selected by masking)."""
    return (
        n_queries * width * decoder_matmul_flops_per_token(cfg)
        + attention_flops(
            cfg, n_queries * (width * float(pack_len) + causal_self_attn_terms(width))
        )
    )


def train_step_executed_flops(
    config: ModelConfig,
    batch: int,
    vtg_seq: int,
    vtg_lm_positions: int,
    tvg_seq: int,
    vocab_videos: int,
    lora_r: int,
    vtg_video_tokens: int = 0,
    tvg_video_tokens: int = 0,
) -> dict:
    """Executed-work FLOPs for one LoRA train step (the honest MFU numerator).

    The 7B base is FROZEN: jax.value_and_grad is taken only wrt the LoRA
    factors + visual_head (engine/train.py:168-174), so dW for a base matrix
    is never computed. With remat=True on both decoder forwards
    (engine/train.py:125,135) the executed work per component is:

      decoder base matmuls    3x fwd  (fwd + remat recompute + dx backward;
                                       the dW = x^T dy matmul is skipped)
      attention score/PV      4x fwd  (fwd + remat + backward: dS/dV/dQ/dK
                                       are 4 score-grid matmuls vs 2 forward)
      lm_head (frozen + LoRA) 2x fwd  (OUTSIDE the remat — vtg_window_logits
                                       consumes the saved hidden: fwd + dx)
      LoRA factors           ~4x fwd  (fwd + remat + dA/dB/dx; <0.5% of total)
      visual_head (trainable) 3x fwd  (fwd + dx + dW; outside remat)
      video-vocab bmm         2x fwd  (fwd + dx; the vocab is data, no dW)
      projector MLP (frozen)  3x fwd  (fwd + remat + dx; LoRA folded into ~)

    The classic 4x-fwd rule (1 fwd + 2 bwd + 1 remat) bills a dW per base
    matmul that is never executed, overstating this step by ~1/3 (0.9865
    "MFU" at 7B). bench.py keeps the old number as `mfu_4x_rule` for
    round-over-round continuity.

    Returns {"executed": ..., "fwd": ...} (fwd = one true forward, with the
    LoRA/projector/head extras included).
    """
    llm = config.llm
    d, r = llm.hidden_size, lora_r
    nh_out = llm.num_attention_heads * llm.head_dim
    nkv_out = llm.num_key_value_heads * llm.head_dim

    tokens = float(batch) * (vtg_seq + tvg_seq)
    m_dec = tokens * decoder_matmul_flops_per_token(llm)
    attn = attention_flops(
        llm,
        batch * (causal_self_attn_terms(vtg_seq) + causal_self_attn_terms(tvg_seq)),
    )
    head = lm_head_flops(llm, float(batch) * vtg_lm_positions)
    lora_dec = tokens * llm.num_hidden_layers * 2.0 * (
        (d * r + r * nh_out)            # q_proj adapter
        + 2.0 * (d * r + r * nkv_out)   # k,v_proj adapters
        + (nh_out * r + r * d)          # o_proj adapter
    )
    lora_head = float(batch) * vtg_lm_positions * 2.0 * (d * r + r * llm.vocab_size)
    clips = float(batch) * config.num_clips
    vh = clips * 2.0 * d * config.mm_hidden_size
    bmm = clips * 2.0 * config.mm_hidden_size * vocab_videos
    proj = (
        float(batch) * (vtg_video_tokens + tvg_video_tokens)
        * 2.0 * (config.mm_hidden_size * d + d * d)
    )
    executed = (
        3.0 * m_dec + 4.0 * attn + 2.0 * head
        + 4.0 * (lora_dec + lora_head) + 3.0 * vh + 2.0 * bmm + 3.0 * proj
    )
    fwd = m_dec + attn + head + lora_dec + lora_head + vh + bmm + proj
    return {"executed": executed, "fwd": fwd}


def tvg_head_flops(config: ModelConfig, clips: float, vocab_videos: int) -> float:
    """visual_head projection + video-vocab bmm per gathered clip token."""
    h, mm = config.llm.hidden_size, config.mm_hidden_size
    return clips * (2.0 * h * mm + 2.0 * mm * vocab_videos)


# v5e-1 peak dense bf16 throughput; used for MFU. Keyed on device_kind.
PEAK_BF16_FLOPS = {
    "TPU v4": 275e12,
    "TPU v5 lite": 197e12,   # v5e
    "TPU v5e": 197e12,
    "TPU v5": 459e12,        # v5p
    "TPU v5p": 459e12,
    "TPU v6 lite": 918e12,   # v6e / Trillium
    "TPU v6e": 918e12,
}


def peak_flops_per_chip(device) -> float | None:
    """Peak dense bf16 FLOP/s of a torch device (or anything torch.device
    takes), or None for the CPU and for a card not in the table."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, val in PEAK_BF16_FLOPS_CUDA.items():
        if name.startswith(key):
            return val
    return None


# Peak dense bf16 throughput of the cards the port knows, keyed on the start
# of torch.cuda.get_device_name (NVIDIA's data sheet: H100 SXM5 80 GB).
PEAK_BF16_FLOPS_CUDA = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def dense_view(cfg: Qwen2Config) -> Qwen2Config:
    """The decoder as the shape formulas above count it. A mixture of
    experts (models/moe.py) counts as a dense decoder whose MLP is its shared
    experts side by side; its router and routed experts depend on the data
    and are counted from routed rows (`routed_flops`)."""
    m = moe_of(cfg)
    if m is None:
        return cfg
    dense = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(Qwen2Config)}
    return Qwen2Config(**dict(dense, intermediate_size=m.shared * m.shared_size))


def routed_flops(cfg: Qwen2Config, rows: float, tokens: float) -> float:
    """A mixture of experts' data-dependent work: `rows` (token, routed
    expert) pairs, each three products of hidden x routed_size, and `tokens`
    token-layers through the router (hidden x experts)."""
    m = moe_of(cfg)
    return (6.0 * cfg.hidden_size * m.routed_size * float(rows)
            + 2.0 * cfg.hidden_size * m.experts * float(tokens))
