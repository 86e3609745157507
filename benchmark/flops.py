"""The benchmark's own operation and byte counts, from shapes alone."""

from __future__ import annotations

from typing import Dict


def vit_clip_flops(vcfg: Dict, frames: int, target_tokens: int) -> float:
    """Operations of one clip through the featurizer: the patch embedding,
    `depth` blocks (q/k/v, the attention's two products, the projection,
    the MLP) and ToMe's similarity products, at 2 per multiply-add."""
    D = vcfg["hidden_size"]
    ps = vcfg["patch_size"]
    side = vcfg["image_size"] // ps
    S = frames * side * side
    I = int(D * vcfg["mlp_ratio"])
    patch = 2.0 * S * (ps * ps * 3) * D
    block = 2.0 * S * D * (3 * D + D + 2 * I) + 4.0 * S * S * D
    head_dim = D // vcfg["num_attention_heads"]
    tome = 0.0
    t = S
    while t != target_tokens:
        r = t - target_tokens if t - target_tokens <= t // 2 else t // 2
        tome += 2.0 * (t - t // 2) * (t // 2) * head_dim
        t -= r
    return patch + vcfg["depth"] * block + tome


def attention_bound_s(batch: int, seq: int, heads: int, head_dim: int, peak_flops: float,
                      peak_bytes: float) -> Dict[str, float]:
    """The least time of dense non-causal attention at bf16: the larger of
    its two products' operations over the peak rate and q, k, v read once
    and the output written once over the memory bandwidth."""
    ops = 4.0 * batch * heads * seq * seq * head_dim
    nbytes = 4.0 * batch * seq * heads * head_dim * 2
    return {"ops_s": ops / peak_flops, "bytes_s": nbytes / peak_bytes,
            "bound_s": max(ops / peak_flops, nbytes / peak_bytes)}
