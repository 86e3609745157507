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

Checkpoints. `convert_videochat_flash` (and its parts `convert_qwen2`,
`convert_projector`, `convert_vision_tower`) maps an HF VideoChat-Flash
state dict to the JAX package's numpy tree, as blim_tpu's converter does
(torch Linear (out, in) -> kernel (in, out); Conv3d (out, in, t, h, w) ->
(t, h, w, in, out)); `params_from_numpy` then carries it across. That path
makes fp32 host copies of every tensor and then stacks them, twice the
checkpoint in fp32 on the host at 7B. `load_videochat_flash` computes the
same tree streaming: each tensor goes from the checkpoint's memory map to
the device in its stored dtype, takes the target dtype and its transpose
there, and is copied into a preallocated (L, ...) stack. The checkpoint is
read through the port's own safetensors reader (checkpoints/safetensors_io)
or, for `pytorch_model*.bin`, `torch.load(weights_only=True)`.
`export_hf_state_dict` is the inverse: the tree as HF-named tensor views.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from blim_tpu_torch.checkpoints import safetensors_io
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


def _to_np(x) -> np.ndarray:
    """A tensor -> float32 numpy copy; numpy passes through (as JAX's _to_np)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x)


class _SD:
    """Accessor over a flat name -> tensor mapping with prefix handling."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def __call__(self, name: str) -> np.ndarray:
        return _to_np(self.sd[self.prefix + name])

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd


def _stack(getter: Callable[[int], np.ndarray], n: int) -> np.ndarray:
    return np.stack([getter(i) for i in range(n)], axis=0)


def _linear(sd: _SD, name: str, bias: bool) -> Params:
    out: Params = {"kernel": sd(f"{name}.weight").T}
    if bias:
        out["bias"] = sd(f"{name}.bias")
    return out


# HF key suffixes of the stacked Qwen2 layers: (tree path, key, transposed)
_QWEN2_LAYER_KEYS = (
    (("input_layernorm", "scale"), "input_layernorm.weight", False),
    (("post_attention_layernorm", "scale"), "post_attention_layernorm.weight", False),
    (("q_proj", "kernel"), "self_attn.q_proj.weight", True),
    (("q_proj", "bias"), "self_attn.q_proj.bias", False),
    (("k_proj", "kernel"), "self_attn.k_proj.weight", True),
    (("k_proj", "bias"), "self_attn.k_proj.bias", False),
    (("v_proj", "kernel"), "self_attn.v_proj.weight", True),
    (("v_proj", "bias"), "self_attn.v_proj.bias", False),
    (("o_proj", "kernel"), "self_attn.o_proj.weight", True),
    (("gate_proj", "kernel"), "mlp.gate_proj.weight", True),
    (("up_proj", "kernel"), "mlp.up_proj.weight", True),
    (("down_proj", "kernel"), "mlp.down_proj.weight", True),
)

# HF key suffixes of the stacked UMT ViT blocks (q_bias / v_bias when present)
_VIT_BLOCK_KEYS = (
    (("norm1", "scale"), "norm1.weight", False),
    (("norm1", "bias"), "norm1.bias", False),
    (("norm2", "scale"), "norm2.weight", False),
    (("norm2", "bias"), "norm2.bias", False),
    # qkv is one packed Linear(dim, 3*dim, bias=False) with separate q/v
    # bias parameters and an implicit zero k bias
    (("qkv", "kernel"), "attn.qkv.weight", True),
    (("proj", "kernel"), "attn.proj.weight", True),
    (("proj", "bias"), "attn.proj.bias", False),
    (("fc1", "kernel"), "mlp.fc1.weight", True),
    (("fc1", "bias"), "mlp.fc1.bias", False),
    (("fc2", "kernel"), "mlp.fc2.weight", True),
    (("fc2", "bias"), "mlp.fc2.bias", False),
)
_VIT_QV_BIAS_KEYS = ((("q_bias",), "attn.q_bias", False), (("v_bias",), "attn.v_bias", False))

LLM_PREFIX = "model."
PROJECTOR_PREFIX = "model.mm_projector."
TOWER_PREFIX = "model.vision_tower.vision_tower.encoder."
LM_HEAD_KEY = "lm_head.weight"
VISUAL_HEAD_KEY = "visual_head.weight"


def _set(tree: Params, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def convert_qwen2(
    state_dict: Mapping[str, Any],
    config: Qwen2Config,
    prefix: str = LLM_PREFIX,
    lm_head_key: str = LM_HEAD_KEY,
) -> Params:
    """HF Qwen2 state dict -> the stacked-layer numpy tree of models/qwen2.py
    (blim_tpu checkpoints.convert_qwen2). A tied or missing lm_head gives
    kernel None."""
    sd = _SD(state_dict, prefix)
    L = config.num_hidden_layers
    layers: Params = {}
    for path, key, transposed in _QWEN2_LAYER_KEYS:
        _set(layers, path, _stack(
            lambda i, key=key, tr=transposed: sd(f"layers.{i}.{key}").T if tr
            else sd(f"layers.{i}.{key}"), L))
    params: Params = {
        "embed_tokens": {"embedding": sd("embed_tokens.weight")},
        "layers": layers,
        "norm": {"scale": sd("norm.weight")},
    }
    if config.tie_word_embeddings or lm_head_key not in state_dict:
        params["lm_head"] = {"kernel": None}
    else:
        params["lm_head"] = {"kernel": _to_np(state_dict[lm_head_key]).T}
    return params


def convert_mlp_seq(sd: _SD, name: str) -> Params:
    """nn.Sequential(Linear, GELU, Linear) -> {'fc1', 'fc2'} (the projector MLPs)."""
    return {
        "fc1": _linear(sd, f"{name}.0", bias=True),
        "fc2": _linear(sd, f"{name}.2", bias=True),
    }


def convert_projector(state_dict: Mapping[str, Any], prefix: str = PROJECTOR_PREFIX) -> Params:
    sd = _SD(state_dict, prefix)
    return {"mlp": convert_mlp_seq(sd, "mlp"), "tvg_mlp": convert_mlp_seq(sd, "tvg_mlp")}


def convert_vision_tower(
    state_dict: Mapping[str, Any],
    config: VisionConfig,
    prefix: str = TOWER_PREFIX,
) -> Params:
    """HF UMT ViT state dict -> the stacked numpy tree of models/umt_vit.py
    (blim_tpu checkpoints.convert_vision_tower)."""
    sd = _SD(state_dict, prefix)
    keys = _VIT_BLOCK_KEYS + (_VIT_QV_BIAS_KEYS if sd.has("blocks.0.attn.q_bias") else ())
    layers: Params = {}
    for path, key, transposed in keys:
        _set(layers, path, _stack(
            lambda i, key=key, tr=transposed: sd(f"blocks.{i}.{key}").T if tr
            else sd(f"blocks.{i}.{key}"), config.depth))
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


def convert_videochat_flash(state_dict: Mapping[str, Any], config: ModelConfig) -> Params:
    """Full VideoChat-Flash state dict -> the numpy tree {llm, projector,
    visual_head[, vision_tower]} (blim_tpu checkpoints.convert_videochat_flash):
    tvg_mlp and visual_head are required; the tower is converted only if
    model.vision_tower.* keys exist."""
    params: Params = {
        "llm": convert_qwen2(state_dict, config.llm),
        "projector": convert_projector(state_dict),
        "visual_head": {"kernel": _to_np(state_dict[VISUAL_HEAD_KEY]).T},
    }
    if any(k.startswith("model.vision_tower.") for k in state_dict):
        params["vision_tower"] = convert_vision_tower(state_dict, config.vision)
    return params


def _bin_files(model_path: str) -> List[str]:
    return sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))


def _torch_load(path: str) -> Dict[str, torch.Tensor]:
    try:   # a memory map: tensors are read when used
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:   # the legacy (non-zip) format cannot be mapped
        return torch.load(path, map_location="cpu", weights_only=True)


def load_hf_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint directory (safetensors preferred,
    else pytorch_model*.bin) as CPU tensors in their stored dtypes; the
    safetensors ones view the files' memory maps. blim_tpu's counterpart
    returns numpy arrays; the values are the same."""
    st_files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    out: Dict[str, torch.Tensor] = {}
    if st_files:
        for path in st_files:
            out.update(safetensors_io.load_file(path))
        return out
    bin_files = _bin_files(model_path)
    if not bin_files:
        raise FileNotFoundError(f"no checkpoint shards under {model_path}")
    for path in bin_files:
        out.update(_torch_load(path))
    return out


class _Source:
    """A checkpoint directory opened for streaming: every tensor's file, and
    its dtype and shape, before any data is read."""

    def __init__(self, model_path: str):
        self.files = safetensors_io.checkpoint_files(model_path)
        self._bins: Dict[str, Dict[str, torch.Tensor]] = {}
        self.meta: Dict[str, Tuple[torch.dtype, Tuple[int, ...]]] = {}
        if self.files:
            for path, names in self.files.items():
                entries = safetensors_io.read_header(path)[0]
                for name in names:
                    e = entries[name]
                    self.meta[name] = (safetensors_io.DTYPES[e["dtype"]], tuple(e["shape"]))
        else:
            bins = _bin_files(model_path)
            if not bins:
                raise FileNotFoundError(f"no checkpoint shards under {model_path}")
            for path in bins:
                sd = self._bins[path] = _torch_load(path)
                self.files[path] = list(sd)
                for name, t in sd.items():
                    self.meta[name] = (t.dtype, tuple(t.shape))

    def __contains__(self, name: str) -> bool:
        return name in self.meta

    def shards(self):
        """(path, get(name)) per file, one file open at a time."""
        for path, names in self.files.items():
            if path in self._bins:
                sd = self._bins.pop(path)
                yield path, sd.__getitem__
                del sd
            else:
                f = safetensors_io.SafetensorsFile(path)
                yield path, f.get
                del f


# how a stored tensor becomes its tree leaf
_COPY, _T, _CONV = "copy", "t", "conv"


def _leaf_shape(shape: Tuple[int, ...], how: str) -> Tuple[int, ...]:
    if how == _T:
        return shape[::-1]
    if how == _CONV:       # (out, in, t, h, w) -> (t, h, w, in, out)
        return (shape[2], shape[3], shape[4], shape[1], shape[0])
    return shape


def _transform(x: torch.Tensor, how: str) -> torch.Tensor:
    if how == _T:
        return x.t()
    if how == _CONV:
        return x.permute(2, 3, 4, 1, 0)
    return x


PARTS = ("llm", "projector", "visual_head", "vision_tower")


def load_videochat_flash(model_path: str, config: ModelConfig,
                         dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda",
                         parts: Sequence[str] = PARTS) -> Params:
    """The tree of `params_from_numpy(convert_videochat_flash(
    load_hf_state_dict(model_path), config), dtype, device)`, streamed: the
    (L, ...) stacks are allocated on `device` first, then each tensor goes
    from the checkpoint (one file at a time) to the device in its stored
    dtype, takes `dtype` and its transpose there, and is copied into its
    slot. `visual_head` stays float32. `parts` picks the subtrees (the
    extractor takes only "vision_tower"); a requested tower is loaded only
    if the checkpoint has model.vision_tower.* keys, as the converter does."""
    dev = resolve_device(device)
    src = _Source(model_path)
    tree: Params = {}
    plan: Dict[str, Tuple[torch.Tensor, Optional[int], str]] = {}

    def leaf(path: Tuple[str, ...], key: str, how: str, leaf_dtype=dtype):
        if key not in src:
            raise KeyError(key)
        t = torch.empty(_leaf_shape(src.meta[key][1], how), dtype=leaf_dtype, device=dev)
        _set(tree, path, t)
        plan[key] = (t, None, how)

    def stacked(path: Tuple[str, ...], fmt: str, n: int, how: str):
        keys = [fmt.format(i) for i in range(n)]
        for key in keys:
            if key not in src:
                raise KeyError(key)
        t = torch.empty((n, *_leaf_shape(src.meta[keys[0]][1], how)), dtype=dtype, device=dev)
        _set(tree, path, t)
        for i, key in enumerate(keys):
            plan[key] = (t, i, how)

    if "llm" in parts:
        p, L = LLM_PREFIX, config.llm.num_hidden_layers
        leaf(("llm", "embed_tokens", "embedding"), p + "embed_tokens.weight", _COPY)
        for path, key, tr in _QWEN2_LAYER_KEYS:
            stacked(("llm", "layers") + path, p + "layers.{}." + key, L, _T if tr else _COPY)
        leaf(("llm", "norm", "scale"), p + "norm.weight", _COPY)
        if config.llm.tie_word_embeddings or LM_HEAD_KEY not in src:
            tree["llm"]["lm_head"] = {"kernel": None}
        else:
            leaf(("llm", "lm_head", "kernel"), LM_HEAD_KEY, _T)
    if "projector" in parts:
        for mlp in ("mlp", "tvg_mlp"):
            for fc, idx in (("fc1", 0), ("fc2", 2)):
                base = f"{PROJECTOR_PREFIX}{mlp}.{idx}."
                leaf(("projector", mlp, fc, "kernel"), base + "weight", _T)
                leaf(("projector", mlp, fc, "bias"), base + "bias", _COPY)
    if "visual_head" in parts:
        leaf(("visual_head", "kernel"), VISUAL_HEAD_KEY, _T, torch.float32)
    if "vision_tower" in parts and any(k.startswith("model.vision_tower.") for k in src.meta):
        p, L = TOWER_PREFIX, config.vision.depth
        keys = _VIT_BLOCK_KEYS + (_VIT_QV_BIAS_KEYS if p + "blocks.0.attn.q_bias" in src else ())
        for path, key, tr in keys:
            stacked(("vision_tower", "blocks") + path, p + "blocks.{}." + key, L,
                    _T if tr else _COPY)
        leaf(("vision_tower", "patch_embed", "kernel"), p + "patch_embed.proj.weight", _CONV)
        leaf(("vision_tower", "patch_embed", "bias"), p + "patch_embed.proj.bias", _COPY)
        leaf(("vision_tower", "final_norm", "scale"), p + "vision_layernorm.weight", _COPY)
        leaf(("vision_tower", "final_norm", "bias"), p + "vision_layernorm.bias", _COPY)

    for path, get in src.shards():
        for key in src.files[path]:
            if key not in plan:
                continue
            dst, i, how = plan.pop(key)
            x = _transform(get(key).to(dev).to(dst.dtype), how)
            (dst if i is None else dst[i]).copy_(x)
            del x
    assert not plan, f"checkpoint tensors never read: {sorted(plan)[:4]}"
    return tree


def export_hf_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """The inverse of convert_videochat_flash: a tensor tree {llm,
    projector, visual_head[, vision_tower]} as HF-named tensors in HF
    orientation, each a view of the tree's storage (no copy): what a
    VideoChat-Flash checkpoint directory stores."""
    out: Dict[str, torch.Tensor] = {}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def emit(key: str, x: torch.Tensor, how: str):
        if how == _T:
            x = x.t()
        elif how == _CONV:   # (t, h, w, in, out) -> (out, in, t, h, w)
            x = x.permute(4, 3, 0, 1, 2)
        out[key] = x

    if "llm" in params:
        llm, p = params["llm"], LLM_PREFIX
        emit(p + "embed_tokens.weight", llm["embed_tokens"]["embedding"], _COPY)
        for path, key, tr in _QWEN2_LAYER_KEYS:
            stack = get(llm["layers"], path)
            for i in range(stack.shape[0]):
                emit(f"{p}layers.{i}.{key}", stack[i], _T if tr else _COPY)
        emit(p + "norm.weight", llm["norm"]["scale"], _COPY)
        if llm["lm_head"]["kernel"] is not None:
            emit(LM_HEAD_KEY, llm["lm_head"]["kernel"], _T)
    if "projector" in params:
        for mlp in ("mlp", "tvg_mlp"):
            for fc, idx in (("fc1", 0), ("fc2", 2)):
                layer = params["projector"][mlp][fc]
                emit(f"{PROJECTOR_PREFIX}{mlp}.{idx}.weight", layer["kernel"], _T)
                emit(f"{PROJECTOR_PREFIX}{mlp}.{idx}.bias", layer["bias"], _COPY)
    if "visual_head" in params:
        emit(VISUAL_HEAD_KEY, params["visual_head"]["kernel"], _T)
    if "vision_tower" in params:
        vt, p = params["vision_tower"], TOWER_PREFIX
        blocks = vt["blocks"]
        keys = _VIT_BLOCK_KEYS + (_VIT_QV_BIAS_KEYS if "q_bias" in blocks else ())
        for path, key, tr in keys:
            stack = get(blocks, path)
            for i in range(stack.shape[0]):
                emit(f"{p}blocks.{i}.{key}", stack[i], _T if tr else _COPY)
        emit(p + "patch_embed.proj.weight", vt["patch_embed"]["kernel"], _CONV)
        emit(p + "patch_embed.proj.bias", vt["patch_embed"]["bias"], _COPY)
        emit(p + "vision_layernorm.weight", vt["final_norm"]["scale"], _COPY)
        emit(p + "vision_layernorm.bias", vt["final_norm"]["bias"], _COPY)
    return out
