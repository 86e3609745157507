"""Autoregressive generation with a KV cache: the `generate` / `chat` path
(port of blim_tpu/models/generation.py).

The prefill is qwen2.forward_collect_kv (the hand-written kernel B1 on CUDA
tensors, one launch a layer), and its per-layer K/V go into a preallocated
(L, B, P + max_new, Hkv, hd) cache. Each decode step writes one token's K/V
per layer into the slot at `cur_len` and attends over the whole masked
cache in plain torch ops, as the JAX package does in XLA: fp32 scores from
fp32 operands, -1e30 on invisible slots, probabilities cast to the cache's
dtype before P.V. The JAX `while_loop` becomes a Python loop that stops
once every row has emitted an EOS (one host read a step); tokens after a
row's EOS are `eos[0]`.

Greedy at temperature <= 0, else a draw from softmax(logits / T) with a
`torch.Generator` (seeded 0 when none is given). jax.random's draws cannot
be reproduced, so sampled tokens differ from the JAX package's; greedy
tokens are the same. A LoRA tree applies in the prefill, in every decode
step and in the LM head.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from blim_tpu_torch.adapters.lora import apply_dense
from blim_tpu_torch.core.config import Qwen2Config
from blim_tpu_torch.core.numerics import einsum_fp32
from blim_tpu_torch.kernels.attention import NEG_INF
from blim_tpu_torch.models import qwen2

Params = Dict[str, Any]


def _decode_layer(
    c: Qwen2Config,
    lp: Params,
    hidden: torch.Tensor,          # (B, 1, D)
    cache_k: torch.Tensor,         # (B, Smax, Kh, hd), written in place at cur_len
    cache_v: torch.Tensor,
    cur_len: int,                  # tokens already in the cache
    visible: torch.Tensor,         # (B, Smax) bool: slot <= cur_len and a real token
    cos: torch.Tensor,
    sin: torch.Tensor,
    ll: Optional[Params] = None,   # per-layer LoRA factors (q/k/v/o_proj)
    lora_scale: float = 0.0,
) -> torch.Tensor:
    B = hidden.shape[0]
    H, Kh, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def lo(name):
        return None if ll is None else ll.get(name)

    x = qwen2.rms_norm(hidden, lp["input_layernorm"]["scale"], c.rms_norm_eps)
    q = apply_dense(lp["q_proj"], x, lo("q_proj"), lora_scale).reshape(B, 1, H, hd)
    k = apply_dense(lp["k_proj"], x, lo("k_proj"), lora_scale).reshape(B, 1, Kh, hd)
    v = apply_dense(lp["v_proj"], x, lo("v_proj"), lora_scale).reshape(B, 1, Kh, hd)
    q = qwen2.apply_rope(q, cos, sin)
    k = qwen2.apply_rope(k, cos, sin)

    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)

    qf = q.float().reshape(B, Kh, H // Kh, hd) * (hd ** -0.5)
    scores = einsum_fp32("bhgd,bshd->bhgs", qf, cache_k)
    scores = scores.masked_fill(~visible[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", probs, cache_v).reshape(B, 1, H * hd)
    hidden = hidden + apply_dense(lp["o_proj"], out, lo("o_proj"), lora_scale)
    return qwen2._mlp(c, lp, hidden)


def _layers(params: Params, lora: Optional[Params]) -> List[Tuple[Params, Optional[Params]]]:
    """(weights, LoRA) of each layer, sliced once per generation."""
    return [(qwen2._layer_slice(params["layers"], i),
             qwen2._layer_slice(None if lora is None else lora["layers"], i))
            for i in range(params["layers"]["q_proj"]["kernel"].shape[0])]


def _decode_step(params, config, layers, token_embed, cache, cur_len, base_mask, position,
                 lora_scale):
    cos, sin = qwen2.rope_cos_sin(position, config.head_dim, config.rope_theta)
    slots = torch.arange(base_mask.shape[1], device=base_mask.device)
    visible = (slots[None, :] <= cur_len) & (base_mask > 0)
    hidden = token_embed
    for i, (lp, ll) in enumerate(layers):
        hidden = _decode_layer(config, lp, hidden, cache["k"][i], cache["v"][i], cur_len,
                               visible, cos, sin, ll, lora_scale)
    return qwen2.rms_norm(hidden, params["norm"]["scale"], config.rms_norm_eps), cache


def decode_one(
    params: Params,
    config: Qwen2Config,
    token_embed: torch.Tensor,           # (B, 1, D)
    cache: Dict[str, torch.Tensor],      # k/v (L, B, Smax, Kh, hd), updated in place
    cur_len: int,
    base_mask: torch.Tensor,             # (B, Smax)
    position: torch.Tensor,              # (B, 1) RoPE position of this token
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step across all layers; returns (post-norm hidden (B,1,D),
    the cache, with this token's K/V written at cur_len)."""
    return _decode_step(params, config, _layers(params, lora), token_embed, cache, cur_len,
                        base_mask, position, lora_scale)


@torch.no_grad()
def generate_tokens(
    params: Params,
    config: Qwen2Config,
    inputs_embeds: torch.Tensor,         # (B, P, D) prompt embeddings (video spliced)
    attention_mask: torch.Tensor,        # (B, P)
    max_new_tokens: int,
    eos_token_ids: Sequence[int],
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    return_logits: bool = False,
):
    """Prefill + greedy/sampled decode on inputs_embeds' device. Returns
    (B, max_new_tokens) int64 tokens, positions after an EOS padded with
    eos[0]; with `return_logits` also the fp32 logits each token was chosen
    from, (B, steps run, V)."""
    B, P, _ = inputs_embeds.shape
    c = config
    dev = inputs_embeds.device

    hidden, kv = qwen2.forward_collect_kv(params, c, inputs_embeds, attention_mask,
                                          lora=lora, lora_scale=lora_scale)
    cache = {}
    for name in ("k", "v"):
        L, _, _, kh, hd = kv[name].shape
        cache[name] = kv[name].new_zeros((L, B, P + max_new_tokens, kh, hd))
        cache[name][:, :, :P] = kv[name]
    del kv
    base_mask = torch.cat([attention_mask.to(device=dev, dtype=torch.int32),
                           torch.ones((B, max_new_tokens), dtype=torch.int32, device=dev)], dim=1)

    eos = torch.tensor(list(eos_token_ids), dtype=torch.long, device=dev)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def select(logits):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    logits = qwen2.lm_logits(params, hidden[:, -1:], c, lora, lora_scale)[:, 0]
    steps = [logits]
    tokens = torch.full((B, max_new_tokens), int(eos[0]), dtype=torch.long, device=dev)
    tok = select(logits)
    tokens[:, 0] = tok
    done = torch.isin(tok, eos)

    layers = _layers(params, lora)
    for step in range(max_new_tokens - 1):
        if bool(done.all()):
            break
        emb = qwen2.embed_tokens(params, tokens[:, step:step + 1])
        pos = torch.full((B, 1), P + step, dtype=torch.long, device=dev)
        hidden, cache = _decode_step(params, c, layers, emb, cache, P + step, base_mask, pos,
                                     lora_scale)
        logits = qwen2.lm_logits(params, hidden, c, lora, lora_scale)[:, 0]
        if return_logits:
            steps.append(logits)
        nxt = torch.where(done, eos[0], select(logits))
        tokens[:, step + 1] = nxt
        done = done | torch.isin(nxt, eos)
    if return_logits:
        return tokens, torch.stack(steps, dim=1)
    return tokens


class KeywordsStoppingCriteria:
    """Host-side keyword trim of decoded text (the reference stops HF
    generate on decoded keywords, mm_utils.py:828-851). The decode loop
    stops on EOS ids; this covers keywords that are not token-aligned."""

    def __init__(self, keywords: List[str], tokenizer):
        self.keywords = keywords
        self.tokenizer = tokenizer

    def trim(self, text: str) -> str:
        for kw in self.keywords:
            idx = text.find(kw)
            if idx >= 0:
                text = text[:idx]
        return text.strip()
