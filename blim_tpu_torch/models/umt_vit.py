"""UMT ViT-L vision tower (port of blim_tpu/models/umt_vit.py).

Host part (numpy, copies pinned to the originals by
tests/test_torch_vit.py): the sin-cos position tables with the reference's
bicubic (A=-0.75) and linear resampling, the PIL-exact bicubic resize
matrices, and the host image processor.

Device part: tubelet patch embed as a reshape and one matmul, pre-norm
blocks with packed-QKV non-causal attention (q/v biases, zero k bias), exact
GELU MLP, a Python loop over the stacked (L, ...) blocks where the JAX
package scans, and the final eps=1e-12 LayerNorm. Every function takes the
JAX package's layouts and parameter tree (kernels (in, out), blocks stacked).
On CUDA tensors each block's attention is the hand-written kernel B2
(kernels/flash_attention.flash_attention_dense, via multi_head_attention).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from blim_tpu_torch.core.config import VisionConfig
from blim_tpu_torch.kernels.attention import multi_head_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Position embeddings (host-side, numpy fp64, computed once)
# ---------------------------------------------------------------------------

def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Classic transformer sin-cos table."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel, torch bicubic's A=-0.75."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = (a + 2) * t[m1] ** 3 - (a + 3) * t[m1] ** 2 + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = a * t[m2] ** 3 - 5 * a * t[m2] ** 2 + 8 * a * t[m2] - 4 * a
    return out


def pil_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix reproducing one axis of PIL Image.resize BICUBIC:
    kernel a=-0.5, window renormalisation at the borders, antialias filter
    widening on downscale. Applied as two separable passes, horizontal first,
    quantising to the uint8 image domain between passes as PIL's uint8
    pipeline does, it matches Image.resize to within +-1 grey level on a
    small share of pixels (fixed-point tie rounding)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        w = _cubic_kernel((np.arange(lo, hi) - center + 0.5) / fs, a=-0.5)
        m[i, lo:hi] = w / w.sum()
    return m


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix implementing torch's 1-D bicubic interpolation
    with align_corners=False (clamped borders)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), n_in - 1)
            w[i, idx] += _cubic_kernel(np.asarray(x - (x0 + k)))
    return w


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) as a matrix."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for k, coef in ((x0, 1 - t), (x0 + 1, t)):
            idx = min(max(k, 0), n_in - 1)
            w[i, idx] += coef
    return w


def interpolated_pos_table(
    n_position: int,
    d_hid: int,
    cur_frame: int,
    ckpt_num_frame: int,
    pre_n_position: int,
) -> np.ndarray:
    """The pretrained-resolution table, bicubic-resized in space 14->P and
    linearly resized in time ckpt->cur as needed. Returns (1, n_position,
    d_hid)."""
    table = sinusoid_table(pre_n_position, d_hid)[None]  # (1, pre_n, C)

    if n_position != pre_n_position:
        T, P, C = ckpt_num_frame, 14, d_hid
        new_p = int(round((n_position // cur_frame) ** 0.5))
        x = table.reshape(-1, T, P, P, C).reshape(-1, P, P, C)   # (T, P, P, C)
        m = cubic_resize_matrix(P, new_p)
        # separable bicubic: rows then cols
        x = np.einsum("op,tpqc->toqc", m, x)
        x = np.einsum("oq,tpqc->tpoc", m, x)
        table = x.reshape(1, T, new_p, new_p, C).reshape(1, T * new_p * new_p, C)

    if cur_frame != ckpt_num_frame:
        T, new_t, C = ckpt_num_frame, cur_frame, d_hid
        P = int(round((n_position // cur_frame) ** 0.5))
        x = table.reshape(-1, T, P, P, C).transpose(0, 2, 3, 4, 1).reshape(-1, C, T)
        m = _linear_resize_matrix(T, new_t)
        x = np.einsum("ot,bct->bco", m, x)
        x = x.reshape(1, P, P, C, new_t).transpose(0, 4, 1, 2, 3)
        table = x.reshape(1, new_t * P * P, C)
    return table


def build_pos_tables(config: VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(video pos table, single-image pos table) for this tower config."""
    c = config
    frames = c.num_frames // c.tubelet_size
    num_patches = c.patches_per_frame * frames
    if c.image_size != 224:
        video = interpolated_pos_table(
            num_patches, c.hidden_size, cur_frame=frames,
            ckpt_num_frame=c.ckpt_num_frame, pre_n_position=784,
        )
        image = interpolated_pos_table(
            c.patches_per_frame, c.hidden_size, cur_frame=1, ckpt_num_frame=1,
            pre_n_position=196,
        )
    else:
        video = sinusoid_table(num_patches, c.hidden_size)[None]
        image = sinusoid_table(c.patches_per_frame, c.hidden_size)[None]
    return video, image


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and affine, cast back to x's dtype."""
    out = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias), kernel in (in, out) form."""
    return F.linear(x, p["kernel"].t(), p.get("bias"))


def patch_embed(params: Params, pixels: torch.Tensor, config: VisionConfig) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T*L, D). The tubelet Conv3D has stride equal
    to its kernel, so it is an exact block reshape and one matmul."""
    c = config
    b, ch, t, h, w = pixels.shape
    ts, ps = c.tubelet_size, c.patch_size
    nt, nh, nw = t // ts, h // ps, w // ps
    x = pixels.reshape(b, ch, nt, ts, nh, ps, nw, ps)
    # -> (B, nt, nh, nw, ts, ps, ps, ch), the kernel's (ts, ps, ps, ch, D) order
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(b, nt * nh * nw, ts * ps * ps * ch)
    kernel = params["patch_embed"]["kernel"]
    return F.linear(x, kernel.reshape(-1, kernel.shape[-1]).t(), params["patch_embed"]["bias"])


def vit_block(bp: Params, x: torch.Tensor, config: VisionConfig) -> torch.Tensor:
    """One pre-norm ViT block: LN -> packed-QKV attention (q/v biases, zero k
    bias) -> proj -> LN -> exact-GELU MLP. q, k and v reach the attention as
    strided views of the packed projection, which B2 reads in place."""
    c = config
    H = c.num_attention_heads
    D = c.hidden_size
    hd = D // H
    y = _layer_norm(x, bp["norm1"]["scale"], bp["norm1"]["bias"], c.layer_norm_eps)
    qkv_bias = torch.cat([bp["q_bias"], torch.zeros_like(bp["q_bias"]), bp["v_bias"]])
    qkv = F.linear(y, bp["qkv"]["kernel"].t(), qkv_bias)
    b, n, _ = qkv.shape
    qkv = qkv.reshape(b, n, 3, H, hd)
    attn = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False,
                                scale=hd ** -0.5)
    x = x + _dense(bp["proj"], attn.reshape(b, n, D))
    y = _layer_norm(x, bp["norm2"]["scale"], bp["norm2"]["bias"], c.layer_norm_eps)
    y = F.gelu(_dense(bp["fc1"], y), approximate="none")
    return x + _dense(bp["fc2"], y)


def _block_params(blocks: Params, i: int) -> Params:
    return {k: _block_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def forward_features(
    params: Params,
    pixels: torch.Tensor,                           # (B, C, T, H, W)
    pos_table,                                      # (1, T*L, D) numpy or tensor
    config: VisionConfig,
) -> torch.Tensor:
    """Full tower: patchify + pos + truncated blocks + final LN -> (B, T*L, D).
    The position table is taken in fp32 and added in x's dtype."""
    c = config
    x = patch_embed(params, pixels, c)
    if not isinstance(pos_table, torch.Tensor):
        pos_table = torch.from_numpy(np.asarray(pos_table, np.float32))
    x = x + pos_table.to(device=x.device, dtype=x.dtype)
    blocks = params["blocks"]
    for i in range(blocks["qkv"]["kernel"].shape[0]):
        x = vit_block(_block_params(blocks, i), x, c)
    return _layer_norm(x, params["final_norm"]["scale"], params["final_norm"]["bias"],
                       c.final_layer_norm_eps)


def encode_clips(
    params: Params,
    clips: torch.Tensor,                            # (B, T, C, H, W) frames of clips
    pos_table,
    config: VisionConfig,
) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T*L, D): the UMTVisionTower.forward contract."""
    return forward_features(params, clips.transpose(1, 2), pos_table, config)


# ---------------------------------------------------------------------------
# Image preprocessing (host-side)
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class UMTImageProcessor:
    """Resize(bicubic) + rescale(1/255) + ImageNet-normalize, channels-first."""

    def __init__(self, size: Tuple[int, int] = (224, 224)):
        self.size = size
        self.image_mean = IMAGENET_MEAN
        self.image_std = IMAGENET_STD

    def preprocess(self, frames: np.ndarray, target_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """frames: (T, H, W, 3) uint8 -> (T, 3, h, w) float32."""
        h, w = target_size or self.size
        out = np.empty((len(frames), 3, h, w), np.float32)
        resized = self.resize_frames(frames, (h, w))
        for i, f in enumerate(resized):
            arr = f.astype(np.float32) / 255.0
            out[i] = ((arr - self.image_mean) / self.image_std).transpose(2, 0, 1)
        return out

    def resize_frames(self, frames: np.ndarray, target_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """frames: (T, H, W, 3) uint8 -> (T, h, w, 3) uint8, bicubic, staying
        in uint8 (rescale, normalise and channels-first belong on the device:
        make_featurizer(..., device_preprocess=True)). PIL when it is
        installed, else the PIL-exact two-pass numpy resize."""
        h, w = target_size or self.size
        if frames.shape[1] == h and frames.shape[2] == w:
            return frames
        out = np.empty((len(frames), h, w, 3), np.uint8)
        try:
            from PIL import Image

            for i, f in enumerate(frames):
                out[i] = np.asarray(Image.fromarray(f).resize((w, h), Image.BICUBIC))
        except ImportError:
            # PIL-exact fallback: horizontal pass first, uint8 quantisation
            # between passes (see pil_resize_matrix)
            mh = pil_resize_matrix(frames.shape[1], h)
            mw = pil_resize_matrix(frames.shape[2], w)
            for i, f in enumerate(frames):
                arr = np.einsum("ow,hwc->hoc", mw, f.astype(np.float64))
                arr = np.clip(np.rint(arr), 0, 255)
                arr = np.einsum("oh,hwc->owc", mh, arr)
                out[i] = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        return out
