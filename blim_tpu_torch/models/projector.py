"""ToMe token compression and the projector MLPs (port of
blim_tpu/models/projector.py).

ToMe (bipartite soft matching, size-weighted averaging) runs in feature
extraction: the vision tower's clip tokens are merged down to
tokens_per_frame x local_frames before they are cached. The merge schedule
depends on shapes only, so each round is a fixed sequence of tensor ops: a
similarity matmul, a max, a stable descending argsort (JAX's argsort of the
negated keys is stable), gathers and one scatter-add. ToMe runs in x's dtype
(bf16 on the card, as in the JAX package). The scatter-add is deterministic
on both devices: on the card index_put_ with accumulate, which sorts the
destinations and sums each one's sources in a fixed order (index_add_'s
atomics would change a destination token's last bit from run to run, and
through the later rounds' similarity ranking every merge after it); on the
CPU index_add_, a serial loop (index_put_'s accumulate runs in parallel
there).

The two projections read the cached features: `mlp` for the VTG direction
(every token) and `tvg_mlp` for the TVG direction (one token per clip).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from blim_tpu_torch.adapters.lora import apply_dense

Params = Dict[str, Any]


def merge_schedule(num_tokens: int, target: int) -> List[int]:
    """Tokens removed per ToMe round: halve until within one round of the
    target, then remove the remainder."""
    assert num_tokens > target, f"{num_tokens} should be greater than {target}"
    r_list: List[int] = []
    t = num_tokens
    while t != target:
        if t - target <= t // 2:
            r_list.append(t - target)
            break
        r_list.append(t // 2)
        t = t - t // 2
    return r_list


def _bipartite_merge_indices(metric: torch.Tensor,
                             r: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ToMe merge indices for one round. metric: (B, T, C). Returns (unm_idx
    (B, Ta-r), src_idx (B, r), dst_idx (B, r)): a = even-position tokens,
    b = odd-position tokens; the r src tokens of a with the most similar
    partner in b merge into it, the rest of a stays (unm), in descending
    order of that similarity."""
    t = metric.shape[1]
    r = min(r, t // 2)
    assert r > 0, r

    metric = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-12)
    a, b = metric[:, ::2, :], metric[:, 1::2, :]
    scores = a @ b.transpose(-1, -2)                      # (B, Ta, Tb)

    node_max, node_idx = scores.max(dim=-1)               # first maximum, as jnp.argmax
    edge_idx = torch.argsort(node_max, dim=-1, descending=True, stable=True)

    src_idx = edge_idx[:, :r]
    unm_idx = edge_idx[:, r:]
    dst_idx = torch.gather(node_idx, -1, src_idx)
    return unm_idx, src_idx, dst_idx


def _merge_sum(x: torch.Tensor, unm_idx: torch.Tensor, src_idx: torch.Tensor,
               dst_idx: torch.Tensor) -> torch.Tensor:
    """Apply one merge round with sum reduction. x: (B, T, C) ->
    (B, T - r, C): the unmerged a tokens, then every b token with the src
    tokens that merged into it added."""
    src_all, dst_all = x[:, ::2, :], x[:, 1::2, :]
    bsz, tb, c = dst_all.shape

    def rows(idx):
        return torch.gather(src_all, 1, idx[..., None].expand(*idx.shape, c))

    unm, moved = rows(unm_idx), rows(src_idx)
    flat = (dst_idx + tb * torch.arange(bsz, device=x.device)[:, None]).reshape(-1)
    rows_all, moved = dst_all.reshape(bsz * tb, c), moved.reshape(-1, c)
    if x.is_cuda:
        dst = rows_all.index_put((flat,), moved, accumulate=True)
    else:
        dst = rows_all.index_add(0, flat, moved)
    return torch.cat([unm, dst.reshape(bsz, tb, c)], dim=1)


def merge_tokens(x: torch.Tensor, target_num_token: int, num_attention_heads: int) -> torch.Tensor:
    """ToMe-compress (B, T, C) to (B, target, C) with size-weighted averaging."""
    b, t, c = x.shape
    size = torch.ones((b, t, 1), dtype=x.dtype, device=x.device)
    head_dim = c // num_attention_heads

    for r in merge_schedule(t, target_num_token):
        metric = x.reshape(b, x.shape[1], num_attention_heads, head_dim).mean(dim=2)
        unm_idx, src_idx, dst_idx = _bipartite_merge_indices(metric, r)
        x = _merge_sum(x * size, unm_idx, src_idx, dst_idx)
        size = _merge_sum(size, unm_idx, src_idx, dst_idx)
        x = x / size
    return x


def compress_image_tokens(image_features: torch.Tensor, num_attention_heads: int,
                          target: int = 64) -> torch.Tensor:
    """Single-image ToMe path: (B, patches, C) -> (B, target, C)."""
    return merge_tokens(image_features, target, num_attention_heads)


def compress_clip_tokens(clip_features: torch.Tensor, tokens_per_frame: int,
                         local_num_frames: int, num_attention_heads: int) -> torch.Tensor:
    """Vision-tower output (clips, local_frames * patches, C) -> the
    ToMe-compressed features that extraction caches (clips,
    tokens_per_frame * local_frames, C)."""
    return merge_tokens(clip_features, tokens_per_frame * local_num_frames, num_attention_heads)


def mlp_apply(p: Params, x: torch.Tensor, lora: Optional[Params] = None,
              lora_scale: float = 0.0, lora_dropout: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Linear -> exact (erf) GELU -> Linear, with optional LoRA deltas on
    both Linears; LoRA dropout draws from `generator`."""
    x = apply_dense(p["fc1"], x, None if lora is None else lora.get("fc1"), lora_scale,
                    lora_dropout, generator)
    x = F.gelu(x, approximate="none")
    return apply_dense(p["fc2"], x, None if lora is None else lora.get("fc2"), lora_scale,
                       lora_dropout, generator)


def project_vtg(params: Params, feats: torch.Tensor, lora: Optional[Params] = None,
                lora_scale: float = 0.0, **kw) -> torch.Tensor:
    """Cached features (..., clips, T, mm) -> VTG embeddings (..., clips*T, D)."""
    out = mlp_apply(params["mlp"], feats, None if lora is None else lora.get("mlp"),
                    lora_scale, **kw)
    return out.reshape(*out.shape[:-3], out.shape[-3] * out.shape[-2], out.shape[-1])


def project_tvg(params: Params, feats: torch.Tensor, lora: Optional[Params] = None,
                lora_scale: float = 0.0, **kw) -> torch.Tensor:
    """Cached features (..., clips, T, mm) -> TVG embeddings (..., clips, D):
    `tvg_mlp`, then the mean over the token axis (mean after the MLP)."""
    out = mlp_apply(params["tvg_mlp"], feats, None if lora is None else lora.get("tvg_mlp"),
                    lora_scale, **kw)
    return out.mean(dim=-2)
