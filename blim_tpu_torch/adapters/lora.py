"""Dense layers with an optional LoRA delta (port of
blim_tpu/adapters/lora.py::apply_dense).

A LoRA adapter is a parallel tree of {a: (in, r), b: (r, out)} factors:
    y = x @ W + b  +  scale * x @ A @ B
The zero-shot path passes lora=None; LoRA init and dropout join the port
with the fine-tuned flow.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


def apply_dense(p: Params, x: torch.Tensor, lora: Optional[Params] = None,
                scale: float = 0.0) -> torch.Tensor:
    """y = x @ kernel (+ bias) (+ scaled LoRA delta, computed in the factors'
    precision and cast to the base dtype)."""
    y = x @ p["kernel"]
    if p.get("bias") is not None:
        y = y + p["bias"]
    if lora is not None:
        delta = (x.to(lora["a"].dtype) @ lora["a"]) @ lora["b"]
        y = y + (delta * scale).to(y.dtype)
    return y
