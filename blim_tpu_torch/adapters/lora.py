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
        y = y + lora_delta(lora, x, scale, dropout, generator).to(y.dtype)
    return y


def lora_delta(lora: Params, x: torch.Tensor, scale: float, dropout: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The LoRA delta alone, (alpha/r) * dropout(x) @ A @ B, in the factors'
    precision. With dropout > 0 and a generator, each element of x is kept
    with probability 1 - dropout and scaled by 1 / (1 - dropout)."""
    xd = x
    if dropout > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
        xd = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
    return ((xd.to(lora["a"].dtype) @ lora["a"]) @ lora["b"]) * scale


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


def merge_lora_into_dense(dense: Params, lora: Params, scale: float) -> Params:
    """Fold a LoRA adapter into the base kernel: kernel + scale * A @ B in
    fp32 (stacked (L, in, r) factors fold layer by layer), cast back to the
    kernel's dtype."""
    delta = torch.einsum("...dr,...ro->...do", lora["a"].float(), lora["b"].float()) * scale
    out = dict(dense)
    out["kernel"] = (dense["kernel"].float() + delta).to(dense["kernel"].dtype)
    return out


def merge_lora(params: Params, lora: Params, scale: float) -> Params:
    """A copy of the model's params tree with a whole LoRA tree folded in by
    merge_lora_into_dense, at the scale apply_dense uses: the LLM's
    q/k/v/o_proj (every layer) and lm_head, and the projector's `mlp` and
    `tvg_mlp` Linears, each where the tree has factors for it. Scoring and
    chat on the result with lora=None compute what they compute on `params`
    with the LoRA applied (without dropout). A tied lm_head becomes an
    untied kernel. Untouched leaves are shared with `params`."""
    out = dict(params)
    llm_lora = lora.get("llm")
    if llm_lora is not None:
        llm = dict(params["llm"])
        layers = dict(llm["layers"])
        for name, factors in llm_lora.get("layers", {}).items():
            layers[name] = merge_lora_into_dense(layers[name], factors, scale)
        llm["layers"] = layers
        if "lm_head" in llm_lora:
            head = llm["lm_head"]
            if head["kernel"] is None:
                head = dict(head, kernel=llm["embed_tokens"]["embedding"].T)
            llm["lm_head"] = merge_lora_into_dense(head, llm_lora["lm_head"], scale)
        out["llm"] = llm
    proj_lora = lora.get("projector")
    if proj_lora is not None:
        proj = dict(params["projector"])
        for mlp, fcs in proj_lora.items():
            proj[mlp] = dict(proj[mlp], **{fc: merge_lora_into_dense(proj[mlp][fc], f, scale)
                                           for fc, f in fcs.items()})
        out["projector"] = proj
    return out
