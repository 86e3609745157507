"""Projector MLPs (port of blim_tpu/models/projector.py without ToMe).

Cached features are post-ToMe, so the port needs only the two projections:
`mlp` for the VTG direction (every token) and `tvg_mlp` for the TVG
direction (one token per clip). ToMe merging joins the port with
extraction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from blim_tpu_torch.adapters.lora import apply_dense

Params = Dict[str, Any]


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
