"""Layer-wise learning-rate decay, BEiT style (port of
blim_tpu/utils/lr_decay.py).

Deeper layers get larger learning rates: scale = decay^(num_layers + 1 -
layer_id). With stacked-layer trees the scale is a per-layer vector
broadcast along the stacking axis. Nothing in the train step applies it
(the JAX package wires it nowhere either): a caller scales its updates with
`scale_updates_by` before the optimizer's learning rate.
"""

from __future__ import annotations

from typing import Any

import torch


def layer_scale_vector(num_layers: int, layer_decay: float) -> torch.Tensor:
    """scale[i] = decay^(L + 1 - (i + 1)) for stacked layer index i (block b
    is layer_id b + 1), fp32."""
    return torch.tensor([layer_decay ** (num_layers + 1 - (i + 1)) for i in range(num_layers)],
                        dtype=torch.float32)


def stacked_tree_scales(tree: Any, num_layers: int, layer_decay: float) -> Any:
    """Per-leaf multipliers for a tree of tensors stacked along a leading
    layer axis of size `num_layers` (the LLM LoRA factors): that axis gets
    the layer's scale, broadcast over the rest; a leaf without it gets the
    head scale 1.0. Each multiplier lives on its leaf's device."""
    vec = layer_scale_vector(num_layers, layer_decay)

    def leaf_scale(x):
        if x.ndim >= 1 and x.shape[0] == num_layers:
            return vec.to(x.device).reshape((num_layers,) + (1,) * (x.ndim - 1))
        return torch.tensor(1.0, dtype=torch.float32, device=x.device)

    return _tree_map(leaf_scale, tree)


def scale_updates_by(updates: Any, scales: Any) -> Any:
    """A tree of update tensors multiplied elementwise by `scales`
    (stacked_tree_scales' tree of the same structure)."""
    return _tree_map(lambda u, s: u * s, updates, scales)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
