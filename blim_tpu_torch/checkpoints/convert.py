"""The weight bridge: the JAX package's parameter tree as the port's tensors,
and a torch-native seeded init of the same tree.

Layout. The port keeps the JAX tree as it is: nested dicts, per-layer
weights stacked along a leading (L, ...) axis, every dense `kernel` in
(in, out) form. The decoder applies `x @ kernel`, which needs no transpose,
so this bridge transposes nothing; it only moves each leaf to the requested
dtype and device. `visual_head` (an fp32 island of the TVG head) and every
LoRA factor stay float32 whatever the dtype, as in the JAX package.

The trainable tree ({"lora": {"llm", "projector"}, "visual_head"}, the JAX
package's `train.init_trainable`) crosses as fp32 leaf tensors that require
grad; `params_to_numpy` and `grads_to_numpy` bring the values and their
gradients back.

The seeded init draws from `torch.Generator`s on the target device with the
JAX init's shapes and distributions (qwen2.init_params, projector.init_params,
videochat_flash.init_params, umt_vit.init_params). A CUDA generator builds
the 7B and the ViT-L tower on the card directly in bf16: no host-side
normals. The numbers differ from the JAX init's; tests that compare the two
packages bridge the JAX tree instead.

`convert_vision_tower` maps an HF UMT ViT state dict to the JAX package's
numpy tree (torch Linear (out, in) -> kernel (in, out); Conv3d (out, in, t,
h, w) -> (t, h, w, in, out)), which `params_from_numpy` then carries across.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from blim_tpu_torch.core.config import ModelConfig, Qwen2Config, VisionConfig
from blim_tpu_torch.core.device import DeviceLike, resolve_device

Params = Dict[str, Any]

_FP32_SUBTREES = ("visual_head", "lora")


def params_from_numpy(tree: Params, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda") -> Params:
    """Numpy (or array-like) parameter tree -> the same tree of tensors.
    `None` leaves (a tied lm_head) stay None."""
    dev = resolve_device(device)

    def conv(node, leaf_dtype):
        if isinstance(node, dict):
            return {k: conv(v, torch.float32 if k in _FP32_SUBTREES else leaf_dtype)
                    for k, v in node.items()}
        if node is None:
            return None
        arr = np.array(node, np.float32)  # a writable copy of possibly read-only input
        return torch.from_numpy(arr).to(device=dev, dtype=leaf_dtype)

    return conv(tree, dtype)


def params_to_numpy(params: Params) -> Params:
    """Tensor tree -> float32 numpy tree (the inverse bridge): copies, so a
    later in-place update of the tensors leaves them as they were."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if params is None:
        return None
    return params.detach().to(device="cpu", dtype=torch.float32).numpy().copy()


def trainable_from_numpy(tree: Params, device: DeviceLike = "cuda") -> Params:
    """Numpy trainable tree -> fp32 leaf tensors with requires_grad=True."""
    return _map_leaves(params_from_numpy(tree, torch.float32, device),
                       lambda t: t.requires_grad_(True))


def grads_to_numpy(trainable: Params) -> Params:
    """The .grad of every leaf as float32 numpy (zeros where none was set)."""
    return _map_leaves(trainable, lambda t: params_to_numpy(
        torch.zeros_like(t) if t.grad is None else t.grad))


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)


def init_qwen2(config: Qwen2Config, gen: torch.Generator, dtype, device) -> Params:
    """Stacked-layer Qwen2 tree: N(0, 0.02) dense weights, zero biases, unit
    norm scales (qwen2.init_params)."""
    c = config
    L, D, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size
    H, K, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def dense(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    params: Params = {
        "embed_tokens": {"embedding": dense(c.vocab_size, D)},
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
    }
    params["lm_head"] = {"kernel": None if c.tie_word_embeddings else dense(D, c.vocab_size)}
    return params


def init_projector(mm_hidden: int, hidden: int, gen: torch.Generator, dtype, device) -> Params:
    """Projector MLPs: Glorot-normal kernels drawn in fp32, zero biases
    (projector.init_params)."""

    def lin(din, dout):
        scale = (2.0 / (din + dout)) ** 0.5
        return {"kernel": _normal(gen, (din, dout), scale, torch.float32, device).to(dtype),
                "bias": torch.zeros(dout, dtype=dtype, device=device)}

    return {
        "mlp": {"fc1": lin(mm_hidden, hidden), "fc2": lin(hidden, hidden)},
        "tvg_mlp": {"fc1": lin(mm_hidden, hidden), "fc2": lin(hidden, hidden)},
    }


def init_params(config: ModelConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda") -> Params:
    """Random VideoChat-Flash tree {llm, projector, visual_head} on `device`
    (videochat_flash.init_params)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    llm = init_qwen2(config.llm, gen, dtype, dev)
    proj = init_projector(config.mm_hidden_size, config.llm.hidden_size, gen, dtype, dev)
    vh = _normal(gen, (config.llm.hidden_size, config.mm_hidden_size), 0.02, torch.float32, dev)
    return {"llm": llm, "projector": proj, "visual_head": {"kernel": vh}}


def init_vision_tower(config: VisionConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda") -> Params:
    """Random UMT ViT tree {patch_embed, blocks, final_norm} on `device`
    (umt_vit.init_params): Glorot-normal kernels over the last two axes
    drawn in fp32, zero biases, unit norm scales; blocks stacked to depth."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = config
    L, D = c.depth, c.hidden_size
    I = int(D * c.mlp_ratio)

    def w(*shape):
        scale = (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return _normal(gen, shape, scale, torch.float32, dev).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=dev)

    blocks = {
        "norm1": {"scale": full(1.0, L, D), "bias": full(0.0, L, D)},
        "norm2": {"scale": full(1.0, L, D), "bias": full(0.0, L, D)},
        "qkv": {"kernel": w(L, D, 3 * D)},
        "q_bias": full(0.0, L, D),
        "v_bias": full(0.0, L, D),
        "proj": {"kernel": w(L, D, D), "bias": full(0.0, L, D)},
        "fc1": {"kernel": w(L, D, I), "bias": full(0.0, L, I)},
        "fc2": {"kernel": w(L, I, D), "bias": full(0.0, L, D)},
    }
    patch = {"kernel": w(c.tubelet_size, c.patch_size, c.patch_size, 3, D),
             "bias": full(0.0, D)}
    return {"patch_embed": patch, "blocks": blocks,
            "final_norm": {"scale": full(1.0, D), "bias": full(0.0, D)}}


def _stack(getter: Callable[[int], np.ndarray], n: int) -> np.ndarray:
    return np.stack([getter(i) for i in range(n)], axis=0)


def convert_vision_tower(
    state_dict: Mapping[str, Any],
    config: VisionConfig,
    prefix: str = "model.vision_tower.vision_tower.encoder.",
) -> Params:
    """HF UMT ViT state dict -> the stacked numpy tree of models/umt_vit.py
    (blim_tpu checkpoints.convert_vision_tower)."""
    L = config.depth

    def sd(name: str) -> np.ndarray:
        x = state_dict[prefix + name]
        return params_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    def blk(i: int, name: str) -> np.ndarray:
        return sd(f"blocks.{i}.{name}")

    layers: Params = {
        "norm1": {
            "scale": _stack(lambda i: blk(i, "norm1.weight"), L),
            "bias": _stack(lambda i: blk(i, "norm1.bias"), L),
        },
        "norm2": {
            "scale": _stack(lambda i: blk(i, "norm2.weight"), L),
            "bias": _stack(lambda i: blk(i, "norm2.bias"), L),
        },
        # qkv is one packed Linear(dim, 3*dim, bias=False) with separate q/v
        # bias parameters and an implicit zero k bias
        "qkv": {"kernel": _stack(lambda i: blk(i, "attn.qkv.weight").T, L)},
        "proj": {
            "kernel": _stack(lambda i: blk(i, "attn.proj.weight").T, L),
            "bias": _stack(lambda i: blk(i, "attn.proj.bias"), L),
        },
        "fc1": {
            "kernel": _stack(lambda i: blk(i, "mlp.fc1.weight").T, L),
            "bias": _stack(lambda i: blk(i, "mlp.fc1.bias"), L),
        },
        "fc2": {
            "kernel": _stack(lambda i: blk(i, "mlp.fc2.weight").T, L),
            "bias": _stack(lambda i: blk(i, "mlp.fc2.bias"), L),
        },
    }
    if prefix + "blocks.0.attn.q_bias" in state_dict:
        layers["q_bias"] = _stack(lambda i: blk(i, "attn.q_bias"), L)
        layers["v_bias"] = _stack(lambda i: blk(i, "attn.v_bias"), L)
    return {
        "patch_embed": {
            # Conv3d weight (out, in, t, h, w) -> (t, h, w, in, out)
            "kernel": sd("patch_embed.proj.weight").transpose(2, 3, 4, 1, 0),
            "bias": sd("patch_embed.proj.bias"),
        },
        "blocks": layers,
        "final_norm": {
            "scale": sd("vision_layernorm.weight"),
            "bias": sd("vision_layernorm.bias"),
        },
    }
