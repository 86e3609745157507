"""LoRA adapters as plain parameter trees (port of blim_tpu/adapters/lora.py).

The LoRA setup of the paper (r=8, alpha=32, dropout=0.05) sits on the LLM's
q/k/v/o_proj + lm_head and on the projector MLP Linears. An adapter is a
parallel tree of {a: (in, r), b: (r, out)} factors, kept in fp32; a dense
layer applies
    y = x @ W + b  +  (alpha/r) * dropout(x) @ A @ B
A is Kaiming-uniform, B zeros, so the adapter starts as a no-op. The init
draws from a `torch.Generator` (its numbers differ from jax.random's; tests
that compare the two packages bridge the JAX tree instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: int = 32
    dropout: float = 0.05

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def init_lora_factors(gen: torch.Generator, din: int, dout: int, r: int,
                      stack: int = 0) -> Params:
    """A ~ Kaiming-uniform(fan_in=din), B = 0, both fp32 on the generator's
    device; `stack` > 0 adds a leading (stack, ...) layer axis."""
    bound = 1.0 / math.sqrt(din)
    lead = (stack,) if stack else ()
    a = torch.rand(lead + (din, r), generator=gen, device=gen.device, dtype=torch.float32)
    return {"a": a.mul_(2 * bound).sub_(bound),
            "b": torch.zeros(lead + (r, dout), device=gen.device, dtype=torch.float32)}


def apply_dense(p: Params, x: torch.Tensor, lora: Optional[Params] = None,
                scale: float = 0.0, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """y = x @ kernel (+ bias) (+ scaled LoRA delta, computed in the factors'
    precision and cast to the base dtype). With dropout > 0 and a generator,
    the LoRA branch reads x with each element kept with probability
    1 - dropout and scaled by 1 / (1 - dropout); each call draws afresh."""
    y = x @ p["kernel"]
    if p.get("bias") is not None:
        y = y + p["bias"]
    if lora is not None:
        xd = x
        if dropout > 0.0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
            xd = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
        delta = (xd.to(lora["a"].dtype) @ lora["a"]) @ lora["b"]
        y = y + (delta * scale).to(y.dtype)
    return y


def init_llm_lora(gen: torch.Generator, config, lora_cfg: LoraConfig) -> Params:
    """LoRA factors for the Qwen2 targets: q/k/v/o_proj (stacked per layer)
    and lm_head."""
    c = config
    L, D = c.num_hidden_layers, c.hidden_size
    H, K, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    return {
        "layers": {
            "q_proj": init_lora_factors(gen, D, H * hd, lora_cfg.r, stack=L),
            "k_proj": init_lora_factors(gen, D, K * hd, lora_cfg.r, stack=L),
            "v_proj": init_lora_factors(gen, D, K * hd, lora_cfg.r, stack=L),
            "o_proj": init_lora_factors(gen, H * hd, D, lora_cfg.r, stack=L),
        },
        "lm_head": init_lora_factors(gen, D, c.vocab_size, lora_cfg.r),
    }


def init_projector_lora(gen: torch.Generator, mm_hidden: int, hidden: int,
                        lora_cfg: LoraConfig) -> Params:
    """LoRA for the projector MLPs. `tvg_mlp` starts as a copy of `mlp`, as
    the paper's setup deep-copies the adapted `mlp` into `tvg_mlp`."""
    mlp = {
        "fc1": init_lora_factors(gen, mm_hidden, hidden, lora_cfg.r),
        "fc2": init_lora_factors(gen, hidden, hidden, lora_cfg.r),
    }
    tvg = {name: {k: t.clone() for k, t in f.items()} for name, f in mlp.items()}
    return {"mlp": mlp, "tvg_mlp": tvg}
