"""Projector MLP (port of the VTG half of blim_tpu/models/projector.py).

Cached features are post-ToMe, so the zero-shot path needs only the `mlp`
projection. ToMe merging and the TVG projection join the port with the
extraction and fine-tuned flows.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from blim_tpu_torch.adapters.lora import apply_dense

Params = Dict[str, Any]


def mlp_apply(p: Params, x: torch.Tensor, lora: Optional[Params] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    """Linear -> exact (erf) GELU -> Linear, with optional LoRA deltas."""
    x = apply_dense(p["fc1"], x, None if lora is None else lora.get("fc1"), lora_scale)
    x = F.gelu(x, approximate="none")
    return apply_dense(p["fc2"], x, None if lora is None else lora.get("fc2"), lora_scale)


def project_vtg(params: Params, feats: torch.Tensor, lora: Optional[Params] = None,
                lora_scale: float = 0.0) -> torch.Tensor:
    """Cached features (..., clips, T, mm) -> VTG embeddings (..., clips*T, D)."""
    out = mlp_apply(params["mlp"], feats, None if lora is None else lora.get("mlp"), lora_scale)
    return out.reshape(*out.shape[:-3], out.shape[-3] * out.shape[-2], out.shape[-1])
