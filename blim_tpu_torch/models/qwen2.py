"""Functional Qwen2 decoder in PyTorch (port of blim_tpu/models/qwen2.py).

Parameters are the JAX package's tree (see checkpoints/convert.py): layers
stacked along a leading axis, kernels in (in, out) form. The JAX `lax.scan`
over layers becomes a Python loop over that axis. Attention on the prefix
forwards goes through kernels/attention.multi_head_attention (the
hand-written flash kernel on CUDA); the packed-suffix attention, the TVG
packed-prefix and flat-query attentions and the LM head are plain PyTorch,
as they were plain XLA in the JAX package.

Numerics follow the JAX package: RMSNorm statistics, softmax statistics and
logits in fp32; RoPE tables in fp32, cast to the activations' dtype before
the product.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from blim_tpu_torch.adapters.lora import apply_dense
from blim_tpu_torch.core.config import Qwen2Config, moe_of
from blim_tpu_torch.core.numerics import einsum_f32, einsum_fp32, matmul_f32
from blim_tpu_torch.kernels.attention import NEG_INF, multi_head_attention
from blim_tpu_torch.models import moe

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 statistics."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables (B, S, head_dim), HF layout (half-dim frequencies
    duplicated)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=position_ids.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = position_ids.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D). HF rotate_half convention; the
    tables are cast to x's dtype before the product."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rotated * s


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"]["embedding"][input_ids.long()]


def _layer_slice(tree: Optional[Params], i: int) -> Optional[Params]:
    """Layer i of a stacked (L, ...) tree."""
    if tree is None:
        return None
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _layer_windows(config: Qwen2Config, seq_len: int) -> Optional[List[int]]:
    """Per-layer sliding-window bounds, or None when inactive (the window
    applies only with use_sliding_window on, a window set, a sequence longer
    than it, and below max_window_layers)."""
    c = config
    if not c.use_sliding_window or not c.sliding_window or seq_len <= c.sliding_window:
        return None
    return [c.sliding_window if i < c.max_window_layers else seq_len
            for i in range(c.num_hidden_layers)]


def _lora_of(ll: Optional[Params], name: str) -> Optional[Params]:
    return None if ll is None else ll.get(name)


def _qkv(c: Qwen2Config, lp: Params, x: torch.Tensor, cos, sin, ll, lora_scale):
    B, S, _ = x.shape
    H, K, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    q = apply_dense(lp["q_proj"], x, _lora_of(ll, "q_proj"), lora_scale).reshape(B, S, H, hd)
    k = apply_dense(lp["k_proj"], x, _lora_of(ll, "k_proj"), lora_scale).reshape(B, S, K, hd)
    v = apply_dense(lp["v_proj"], x, _lora_of(ll, "v_proj"), lora_scale).reshape(B, S, K, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out(c: Qwen2Config, lp: Params, hidden, attn, ll, lora_scale) -> torch.Tensor:
    B, S = attn.shape[:2]
    o = apply_dense(lp["o_proj"], attn.reshape(B, S, -1), _lora_of(ll, "o_proj"), lora_scale)
    return hidden + o


def _mlp(c: Qwen2Config, lp: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The layer's MLP with its residual: the dense SwiGLU, or the mixture
    of experts of a `Qwen2MoEConfig` (models/moe.py)."""
    x = rms_norm(hidden, lp["post_attention_layernorm"]["scale"], c.rms_norm_eps)
    experts = moe_of(c)
    if experts is not None:
        return hidden + moe.moe_mlp(experts, lp["moe"], x)
    gate = F.silu(x @ lp["gate_proj"]["kernel"])
    up = x @ lp["up_proj"]["kernel"]
    return hidden + (gate * up) @ lp["down_proj"]["kernel"]


def _default_positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _decoder_layer(c: Qwen2Config, lp: Params, hidden: torch.Tensor, cos, sin,
                   mask: Optional[torch.Tensor], window, ll: Optional[Params],
                   lora_scale: float):
    """One decoder layer -> (hidden, post-RoPE k, v). A position with mask 0
    is invisible as a key and emits a zero attention output as a query."""
    x = rms_norm(hidden, lp["input_layernorm"]["scale"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, x, cos, sin, ll, lora_scale)
    attn = multi_head_attention(q, k, v, key_mask=mask, query_mask=mask, causal=True,
                                scale=c.head_dim ** -0.5, window=window)
    return _mlp(c, lp, _attn_out(c, lp, hidden, attn, ll, lora_scale)), k, v


def _stack_inputs(params, config, inputs_embeds, position_ids, lora):
    """Per-layer (weights, LoRA, window) and the RoPE tables of a forward."""
    c = config
    if position_ids is None:
        position_ids = _default_positions(inputs_embeds)
    cos, sin = rope_cos_sin(position_ids, c.head_dim, c.rope_theta)
    wins = _layer_windows(c, inputs_embeds.shape[1])
    layers = [(_layer_slice(params["layers"], i),
               _layer_slice(None if lora is None else lora["layers"], i),
               None if wins is None else wins[i]) for i in range(c.num_hidden_layers)]
    return layers, cos, sin


# ---------------------------------------------------------------------------
# Public forward surface
# ---------------------------------------------------------------------------

def forward_collect_kv(
    params: Params,
    config: Qwen2Config,
    inputs_embeds: torch.Tensor,                      # (B, P, D)
    attention_mask: Optional[torch.Tensor] = None,    # (B, P) 1 = real token
    position_ids: Optional[torch.Tensor] = None,      # (B, P)
    *,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the stack; return (final post-norm hidden (B,P,D), per-layer
    post-RoPE {"k": (L,B,P,Hkv,hd), "v": (L,B,P,Hkv,hd)}).

    A position with mask 0 is invisible as a key and emits a zero attention
    output as a query (then keeps evolving through the residual and MLP).
    """
    layers, cos, sin = _stack_inputs(params, config, inputs_embeds, position_ids, lora)
    hidden = inputs_embeds
    ks, vs = [], []
    for lp, ll, win in layers:
        hidden, k, v = _decoder_layer(config, lp, hidden, cos, sin, attention_mask, win, ll,
                                      lora_scale)
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(hidden, params["norm"]["scale"], config.rms_norm_eps)
    return hidden, {"k": torch.stack(ks), "v": torch.stack(vs)}


def forward_hidden(
    params: Params,
    config: Qwen2Config,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    remat: bool = False,
) -> torch.Tensor:
    """Run the decoder stack; returns the final post-norm hidden (B,S,D).

    With `remat`, each layer runs under non-reentrant activation
    checkpointing (the JAX package's per-layer `jax.checkpoint`): the
    backward recomputes the layer's forward instead of keeping its
    activations, so only each layer's input hidden state is kept."""
    layers, cos, sin = _stack_inputs(params, config, inputs_embeds, position_ids, lora)

    def layer(hidden, lp, ll, win):
        return _decoder_layer(config, lp, hidden, cos, sin, attention_mask, win, ll,
                              lora_scale)[0]

    hidden = inputs_embeds
    for lp, ll, win in layers:
        if remat:
            # the layer draws no random numbers: no RNG state to replay
            hidden = checkpoint(layer, hidden, lp, ll, win, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            hidden = layer(hidden, lp, ll, win)
    return rms_norm(hidden, params["norm"]["scale"], config.rms_norm_eps)


def _packed_prefix_attention(
    q: torch.Tensor,        # (G, T, Hq, hd) packed variable-length suffixes
    k_suf: torch.Tensor,    # (G, T, Hkv, hd)
    v_suf: torch.Tensor,
    k_pre: torch.Tensor,    # (G, P, Hkv, hd)
    v_pre: torch.Tensor,
    seg_ids: torch.Tensor,  # (G, T) int; -1 = padding
    scale: float,
    prefix_mask: Optional[torch.Tensor] = None,   # (G, P)
) -> torch.Tensor:
    """Packed suffix tokens over [shared prefix | own segment]: a token sees
    the whole (masked) prefix plus the causally-earlier tokens of its own
    segment. Padding (seg -1) neither sees nor is seen and emits zeros.
    Scores in fp32 from bf16 products; probabilities in v's dtype."""
    g, t, hq, hd = q.shape
    hkv = k_suf.shape[2]
    p_len = k_pre.shape[1]
    qr = q.reshape(g, t, hkv, hq // hkv, hd)
    s_pre = einsum_f32("gthud,gphd->ghutp", qr, k_pre) * scale
    s_suf = einsum_f32("gthud,gshd->ghuts", qr, k_suf) * scale
    if prefix_mask is not None:
        s_pre = s_pre.masked_fill(~prefix_mask.bool()[:, None, None, None, :], NEG_INF)
    valid = seg_ids >= 0
    idx = torch.arange(t, device=q.device)
    vis = ((seg_ids[:, :, None] == seg_ids[:, None, :])
           & (idx[:, None] >= idx[None, :])[None] & valid[:, None, :])
    s_suf = s_suf.masked_fill(~vis[:, None, None], NEG_INF)
    p = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
    o = torch.einsum("ghutp,gphd->gthud", p[..., :p_len].to(v_pre.dtype), v_pre)
    o = o + torch.einsum("ghuts,gshd->gthud", p[..., p_len:].to(v_suf.dtype), v_suf)
    o = o * valid[:, :, None, None, None].to(o.dtype)
    return o.reshape(g, t, hq, hd)


def forward_packed_suffix(
    params: Params,
    config: Qwen2Config,
    suffix_embeds: torch.Tensor,          # (G, T, D) packed caption tokens
    prefix_kv: Dict[str, torch.Tensor],   # k/v: (L, G, P, Hkv, hd)
    seg_ids: torch.Tensor,                # (G, T); -1 = padding
    positions: torch.Tensor,              # (G, T) global positions (per-segment restart)
    *,
    prefix_mask: Optional[torch.Tensor] = None,   # (G, P)
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> torch.Tensor:
    """Decode a pack of variable-length caption suffixes against one shared
    prefix per pack -> hidden (G, T, D)."""
    c = config
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    hidden = suffix_embeds
    for i in range(c.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        ll = _layer_slice(None if lora is None else lora["layers"], i)
        x = rms_norm(hidden, lp["input_layernorm"]["scale"], c.rms_norm_eps)
        q, k, v = _qkv(c, lp, x, cos, sin, ll, lora_scale)
        attn = _packed_prefix_attention(q, k, v, prefix_kv["k"][i], prefix_kv["v"][i],
                                        seg_ids, c.head_dim ** -0.5, prefix_mask=prefix_mask)
        hidden = _mlp(c, lp, _attn_out(c, lp, hidden, attn, ll, lora_scale))
    return rms_norm(hidden, params["norm"]["scale"], c.rms_norm_eps)


# ---------------------------------------------------------------------------
# TVG: packed caption prefixes and flat-query suffixes
# ---------------------------------------------------------------------------

def _packed_self_attention(
    q: torch.Tensor,        # (G, T, Hq, hd)
    k: torch.Tensor,        # (G, T, Hkv, hd)
    v: torch.Tensor,
    seg_ids: torch.Tensor,  # (G, T) int; -1 = padding
    scale: float,
) -> torch.Tensor:
    """Block-diagonal causal self-attention over a pack of independent
    segments: a token sees the causally-earlier tokens of its own segment
    only. Padding (seg -1) neither sees nor is seen and emits zeros. Scores
    in fp32 from bf16 products; probabilities in v's dtype."""
    g, t, hq, hd = q.shape
    hkv = k.shape[2]
    qr = q.reshape(g, t, hkv, hq // hkv, hd)
    scores = einsum_f32("gqhud,gkhd->ghuqk", qr, k) * scale
    valid = seg_ids >= 0
    idx = torch.arange(t, device=q.device)
    vis = ((seg_ids[:, :, None] == seg_ids[:, None, :])
           & (idx[:, None] >= idx[None, :])[None] & valid[:, None, :])
    scores = scores.masked_fill(~vis[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("ghuqk,gkhd->gqhud", probs, v)
    out = out * valid[:, :, None, None, None].to(out.dtype)
    return out.reshape(g, t, hq, hd)


def forward_collect_kv_packed(
    params: Params,
    config: Qwen2Config,
    inputs_embeds: torch.Tensor,   # (G, T, D) segments packed back to back
    seg_ids: torch.Tensor,         # (G, T) int; -1 = padding
    position_ids: torch.Tensor,    # (G, T) absolute positions of each segment's tokens
    *,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """forward_collect_kv over a pack of independent variable-length
    prefixes (block-diagonal causal attention by segment id). Each
    segment's K/V equals that prefix run alone at the same positions.
    Returns (final hidden (G,T,D), {"k": (L,G,T,Hkv,hd), "v": ...})."""
    c = config
    cos, sin = rope_cos_sin(position_ids, c.head_dim, c.rope_theta)
    hidden = inputs_embeds
    ks, vs = [], []
    for i in range(c.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        ll = _layer_slice(None if lora is None else lora["layers"], i)
        x = rms_norm(hidden, lp["input_layernorm"]["scale"], c.rms_norm_eps)
        q, k, v = _qkv(c, lp, x, cos, sin, ll, lora_scale)
        attn = _packed_self_attention(q, k, v, seg_ids, c.head_dim ** -0.5)
        hidden = _mlp(c, lp, _attn_out(c, lp, hidden, attn, ll, lora_scale))
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(hidden, params["norm"]["scale"], c.rms_norm_eps)
    return hidden, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _grouped_prefix_attention(
    q: torch.Tensor,        # (G, K, W, Hq, hd) K suffixes per prefix group
    k_suf: torch.Tensor,    # (G, K, W, Hkv, hd)
    v_suf: torch.Tensor,
    k_pre: torch.Tensor,    # (G, P, Hkv, hd)
    v_pre: torch.Tensor,
    suffix_mask: torch.Tensor,   # (G, K, W) 1 = real suffix token
    scale: float,
    prefix_mask: Optional[torch.Tensor] = None,   # (G, P) or (G, K, P); None = all visible
) -> torch.Tensor:
    """Attention of suffix queries over [shared prefix | own suffix]. The
    prefix K/V broadcasts over the K suffixes of a group inside the product.
    A 3-D prefix mask gives each suffix its own prefix visibility (the
    packed TVG path: the K queries of a group belong to different segments
    of one packed prefix row). Suffix keys are causal and masked. Scores
    from fp32 operands (not bf16 products), softmax in fp32; a masked
    suffix query emits zeros."""
    g, kk, w, hq, hd = q.shape
    hkv = k_suf.shape[3]
    qf = q.float().reshape(g, kk, w, hkv, hq // hkv, hd) * scale
    s_pre = einsum_fp32("gkwhud,gphd->gkhuwp", qf, k_pre)
    s_suf = einsum_fp32("gkwhud,gkxhd->gkhuwx", qf, k_suf)
    if prefix_mask is not None:
        pm = prefix_mask.bool()
        pm = pm[:, :, None, None, None, :] if pm.ndim == 3 else pm[:, None, None, None, None, :]
        s_pre = s_pre.masked_fill(~pm, NEG_INF)
    idx = torch.arange(w, device=q.device)
    vis = (idx[:, None] >= idx[None, :]) & suffix_mask.bool()[:, :, None, None, None, :]
    s_suf = s_suf.masked_fill(~vis, NEG_INF)
    p_len = s_pre.shape[-1]
    p = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
    out = torch.einsum("gkhuwp,gphd->gkwhud", p[..., :p_len].to(v_pre.dtype), v_pre)
    out = out + torch.einsum("gkhuwx,gkxhd->gkwhud", p[..., p_len:].to(v_suf.dtype), v_suf)
    out = out * suffix_mask[:, :, :, None, None, None].to(out.dtype)
    return out.reshape(g, kk, w, hq, hd)


def forward_suffix_with_prefix(
    params: Params,
    config: Qwen2Config,
    suffix_embeds: torch.Tensor,          # (G, K, W, D)
    prefix_kv: Dict[str, torch.Tensor],   # k/v: (L, G, P, Hkv, hd)
    suffix_mask: torch.Tensor,            # (G, K, W)
    position_offset: int,                 # global position of suffix token 0
    *,
    prefix_mask: Optional[torch.Tensor] = None,   # (G, P) or (G, K, P)
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> torch.Tensor:
    """Decode K suffixes per shared prefix -> hidden (G, K, W, D). Suffix
    token j sits at position_offset + j in every suffix."""
    c = config
    G, K, W, D = suffix_embeds.shape
    pos = (torch.arange(W, device=suffix_embeds.device) + position_offset)[None]
    cos, sin = rope_cos_sin(pos, c.head_dim, c.rope_theta)   # (1, W, hd), broadcast over G*K

    def grouped(t):
        return t.reshape(G, K, W, *t.shape[2:])

    hidden = suffix_embeds.reshape(G * K, W, D)
    for i in range(c.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        ll = _layer_slice(None if lora is None else lora["layers"], i)
        x = rms_norm(hidden, lp["input_layernorm"]["scale"], c.rms_norm_eps)
        q, k, v = _qkv(c, lp, x, cos, sin, ll, lora_scale)
        attn = _grouped_prefix_attention(grouped(q), grouped(k), grouped(v), prefix_kv["k"][i],
                                         prefix_kv["v"][i], suffix_mask, c.head_dim ** -0.5,
                                         prefix_mask=prefix_mask)
        attn = attn.reshape(G * K, W, *attn.shape[3:])
        hidden = _mlp(c, lp, _attn_out(c, lp, hidden, attn, ll, lora_scale))
    return rms_norm(hidden, params["norm"]["scale"], c.rms_norm_eps).reshape(G, K, W, D)


def lm_head_kernel(params: Params) -> torch.Tensor:
    kernel = params["lm_head"]["kernel"]
    return params["embed_tokens"]["embedding"].T if kernel is None else kernel


def lm_logits(params: Params, hidden: torch.Tensor, config: Qwen2Config,
              lora: Optional[Params] = None, lora_scale: float = 0.0) -> torch.Tensor:
    """LM-head logits in float32. Apply to scoring windows, not whole
    sequences."""
    logits = matmul_f32(hidden, lm_head_kernel(params))
    if lora is not None and "lm_head" in lora:
        lh = lora["lm_head"]
        logits = logits + matmul_f32(hidden.to(lh["a"].dtype) @ lh["a"], lh["b"]) * lora_scale
    return logits


def forward_logits(
    params: Params,
    config: Qwen2Config,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> torch.Tensor:
    """Token ids (B, S) -> full-sequence fp32 logits (B, S, V), the LoRA on
    the decoder and the LM head. For checks and small inputs: scoring runs
    the LM head on its label window only."""
    hidden = forward_hidden(params, config, embed_tokens(params, input_ids), attention_mask,
                            position_ids, lora=lora, lora_scale=lora_scale)
    return lm_logits(params, hidden, config, lora=lora, lora_scale=lora_scale)
