"""Seeded weights of a mixture-of-experts configuration (Uni-MoE-2.0's
language model), made on the card in a few large draws, in the parameter
tree the measured program takes: `weights.llm_tree`'s layout with each
layer's dense MLP replaced by a `moe` tree (blim_tpu_torch/models/moe.py):

  router  {"kernel": (L, D, E + Z) float32}
  experts {"gate_up": (L, E, D, 2 I), "down": (L, E, I, D)}      gate = [..., :I]
  shared  {"gate_up": (L, D, 2 S Is), "down": (L, S Is, D)}       gate = [:, :S Is];
          shared expert j owns columns j Is:(j + 1) Is of each half

The router, the routed and the shared experts are drawn N(0, 0.02) as the
other dense weights. Both the program and the reference read these same
tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.weights import _glorot, _normal


def llm_tree(cfg: Dict, seed: int, dtype, device) -> Dict:
    """{llm, projector, visual_head} with the mixture-of-experts decoder."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim", D // H)
    V, mm = cfg["vocab_size"], cfg["mm_hidden_size"]
    E, I = cfg["mlp_dynamic_expert_num"], cfg["dynamic_intermediate_size"]
    S = cfg["mlp_fixed_expert_num"] * cfg["shared_intermediate_size"]

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
            "moe": {
                "router": {"kernel": _normal(gen, (L, D, E + cfg["mlp_dynamic_null_expert_num"]),
                                             0.02, torch.float32, device)},
                "experts": {"gate_up": dense(L, E, D, 2 * I), "down": dense(L, E, I, D)},
                "shared": {"gate_up": dense(L, D, 2 * S), "down": dense(L, S, D)},
            },
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

