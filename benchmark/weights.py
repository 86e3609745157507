"""Seeded weights, made on the card by the benchmark in a few large draws
from one torch.Generator each, in the parameter-tree layout the measured
program takes (kernels in (in, out) form, layers stacked on a leading
axis). Both the program and the reference read these same tensors.

Scales follow the usual initialisations: N(0, 0.02) for the decoder's
dense weights and the fp32 visual_head, Glorot-normal kernels for the
projector and the ViT, zero biases, unit norm scales; LoRA A
Kaiming-uniform and B drawn off zero (`lora_b_std`) so that the adapters
change every score.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _normal(gen, shape, std, dtype, device):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(std)


def _glorot(gen, shape, dtype, device):
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return _normal(gen, shape, std, torch.float32, device).to(dtype)


def llm_tree(cfg: Dict, seed: int, dtype, device) -> Dict:
    """{llm, projector, visual_head} of VideoChat-Flash: the Qwen2 decoder,
    the `mlp` (VTG) and `tvg_mlp` (TVG) projector MLPs, and visual_head."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, I = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim", D // H)
    V, mm = cfg["vocab_size"], cfg["mm_hidden_size"]

    def dense(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    llm = {
        "embed_tokens": {"embedding": dense(V, D)},
        "layers": {
            "input_layernorm": {"scale": full(1.0, L, D)},
            "post_attention_layernorm": {"scale": full(1.0, L, D)},
            "q_proj": {"kernel": dense(L, D, H * hd), "bias": full(0.0, L, H * hd)},
            "k_proj": {"kernel": dense(L, D, K * hd), "bias": full(0.0, L, K * hd)},
            "v_proj": {"kernel": dense(L, D, K * hd), "bias": full(0.0, L, K * hd)},
            "o_proj": {"kernel": dense(L, H * hd, D)},
            "gate_proj": {"kernel": dense(L, D, I)},
            "up_proj": {"kernel": dense(L, D, I)},
            "down_proj": {"kernel": dense(L, I, D)},
        },
        "norm": {"scale": full(1.0, D)},
        "lm_head": {"kernel": dense(D, V)},
    }

    def lin(din, dout):
        return {"kernel": _glorot(gen, (din, dout), dtype, device),
                "bias": torch.zeros(dout, dtype=dtype, device=device)}

    projector = {name: {"fc1": lin(mm, D), "fc2": lin(D, D)} for name in ("mlp", "tvg_mlp")}
    visual_head = {"kernel": _normal(gen, (D, mm), 0.02, torch.float32, device)}
    return {"llm": llm, "projector": projector, "visual_head": visual_head}


def lora_tree(cfg: Dict, lora: Dict, seed: int, device) -> Dict:
    """fp32 LoRA factors {a: (in, r), b: (r, out)} on q/k/v/o (stacked per
    layer), lm_head, and both projector MLPs' Linears."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r, b_std = lora["r"], lora["b_std"]
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim", D // H)
    mm, V = cfg["mm_hidden_size"], cfg["vocab_size"]

    def factors(din, dout, *lead):
        bound = 1.0 / math.sqrt(din)
        a = torch.rand(lead + (din, r), generator=gen, device=device).mul_(2 * bound).sub_(bound)
        return {"a": a, "b": _normal(gen, lead + (r, dout), b_std, torch.float32, device)}

    return {
        "llm": {"layers": {"q_proj": factors(D, H * hd, L), "k_proj": factors(D, K * hd, L),
                           "v_proj": factors(D, K * hd, L), "o_proj": factors(H * hd, D, L)},
                "lm_head": factors(D, V)},
        "projector": {name: {"fc1": factors(mm, D), "fc2": factors(D, D)}
                      for name in ("mlp", "tvg_mlp")},
    }


def vit_tree(vcfg: Dict, seed: int, dtype, device) -> Dict:
    """The UMT ViT tower run to `depth` blocks: Glorot-normal kernels, zero
    biases, unit norm scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D = vcfg["depth"], vcfg["hidden_size"]
    I = int(D * vcfg["mlp_ratio"])
    ps = vcfg["patch_size"]

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    blocks = {
        "norm1": {"scale": full(1.0, L, D), "bias": full(0.0, L, D)},
        "norm2": {"scale": full(1.0, L, D), "bias": full(0.0, L, D)},
        "qkv": {"kernel": _glorot(gen, (L, D, 3 * D), dtype, device)},
        "q_bias": full(0.0, L, D),
        "v_bias": full(0.0, L, D),
        "proj": {"kernel": _glorot(gen, (L, D, D), dtype, device), "bias": full(0.0, L, D)},
        "fc1": {"kernel": _glorot(gen, (L, D, I), dtype, device), "bias": full(0.0, L, I)},
        "fc2": {"kernel": _glorot(gen, (L, I, D), dtype, device), "bias": full(0.0, L, D)},
    }
    patch = {"kernel": _glorot(gen, (1, ps, ps, 3, D), dtype, device), "bias": full(0.0, D)}
    return {"patch_embed": patch, "blocks": blocks,
            "final_norm": {"scale": full(1.0, D), "bias": full(0.0, D)}}
