"""Attention dispatch: the hand-written flash kernels on CUDA tensors, the
plain PyTorch versions on CPU tensors (port of blim_tpu/kernels/attention.py).

Semantics (flash-attn varlen output semantics, as in the JAX package): GQA
without repeating K/V; masked keys get the finite logit -1e30; masked query
positions emit a zero attention output. The CPN prior depends on it:
CPN-masked tokens neither see nor are seen but still ride the residual
stream.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30  # finite: fully-masked rows softmax to finite garbage that
                 # the query mask then zeroes, instead of NaN


def reference_attention(
    q: torch.Tensor,                       # (B, S, Hq, D)
    k: torch.Tensor,                       # (B, S, Hkv, D)
    v: torch.Tensor,                       # (B, S, Hkv, D)
    key_mask: Optional[torch.Tensor] = None,     # (B, S) 1 = visible as key
    query_mask: Optional[torch.Tensor] = None,   # (B, S) 1 = emit output
    causal: bool = True,
    scale: Optional[float] = None,
    window: Union[int, torch.Tensor, None] = None,  # query i sees key j iff i-j <= window
) -> torch.Tensor:
    """The plain version (blim_tpu attention._xla_attention): fp32 scores and
    softmax, probabilities cast to v's dtype before the P.V product."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    groups = hq // hkv
    if scale is None:
        scale = d ** -0.5

    qg = (q.float() * scale).reshape(b, s, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())

    idx = torch.arange(s, device=q.device)
    mask = None
    if causal:
        mask = (idx[:, None] >= idx[None, :])[None, None, None]
    if window is not None:
        wmask = ((idx[:, None] - idx[None, :]) <= window)[None, None, None]
        mask = wmask if mask is None else mask & wmask
    if key_mask is not None:
        km = key_mask.bool()[:, None, None, None, :]
        mask = km if mask is None else mask & km
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)

    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, hq, d)
    if query_mask is not None:
        out = out * query_mask[:, :, None, None].to(out.dtype)
    return out


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    query_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Union[int, torch.Tensor, None] = None,
) -> torch.Tensor:
    """GQA attention, q (B,S,Hq,D); k,v (B,S,Hkv,D) -> (B,S,Hq,D).

    A tensor that needs a gradient (grad mode on and any of q, k, v
    requiring grad) goes through the differentiable flash attention: on CUDA
    the B1-lse forward and the B3/B4 backward kernels, on the CPU their
    plain versions inside the same autograd Function. A CUDA tensor at head
    dim 64 with causal=False and no masks (the UMT ViT) goes to B2, or, when
    it needs a gradient, to the same Function's d = 64 kernels (B2-lse
    forward, the fused flash_bwd_dense backward); at head dim 64 with masks or
    causal=True there are no kernels, and such a CUDA tensor raises. Any
    other CUDA tensor goes to the inference kernel B1, whatever its size
    (the JAX wrapper's small-problem gate does not apply), which raises on a
    head dim other than 128.

    A sliding `window` (dormant in BLiM configs) runs the plain windowed
    attention as torch ops on any device, under autograd when the tensors
    need a gradient: the JAX wrapper likewise takes its XLA path whenever a
    window is set, since the flash kernel has none."""
    from blim_tpu_torch.kernels import flash_attention as fa

    if window is not None:
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale, window)
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                              or v.requires_grad)
    if q.device.type == "cpu" and not needs_grad:
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale)
    dense64 = fa.kernel_head_dim(q, key_mask, query_mask, causal) == fa.DENSE_HEAD_DIM
    if needs_grad:
        if q.shape[-1] == fa.DENSE_HEAD_DIM and not dense64 and q.device.type != "cpu":
            raise ValueError(f"attention at head dim {q.shape[-1]} runs on the card only dense "
                             f"and non-causal (the ViT's mode); got causal={causal}, key_mask "
                             f"{'set' if key_mask is not None else 'None'}, query_mask "
                             f"{'set' if query_mask is not None else 'None'}")
        return fa.FlashAttentionFunction.apply(q, k, v, key_mask, query_mask, causal, scale)
    if dense64:
        return fa.flash_attention_dense(q, k, v, scale=scale)
    return fa.flash_attention(q, k, v, key_mask=key_mask, query_mask=query_mask, causal=causal,
                              scale=scale)
