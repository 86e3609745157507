"""Plain PyTorch reference of VideoChat-Flash's video featurizer: the
PIL-exact bicubic resize of uint8 frames, ImageNet normalisation, the UMT
ViT-L tower (tubelet patch embedding, sin-cos position table resampled to
the resolution, pre-norm blocks with q/v biases, exact GELU, the final
LayerNorm) run to its selected layer, and ToMe (bipartite soft matching
with size-weighted averaging) down to the cached tokens per clip. Float32
with TF32 off (the resize in float64), one block of clips at a time. The
table and resize helpers are frozen copies of the published algorithms'
arithmetic; nothing of the measured program is imported.

`quant` as in benchmark/reference/llm.py: `fake_fp8` on both operands of
every weight product makes the control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.llm import Quant, dense, fake_fp8, full_fp32  # noqa: F401

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _cubic(t: np.ndarray, a: float) -> np.ndarray:
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = (a + 2) * t[m1] ** 3 - (a + 3) * t[m1] ** 2 + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = a * t[m2] ** 3 - 5 * a * t[m2] ** 2 + 8 * a * t[m2] - 4 * a
    return out


def pil_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): one axis of PIL's BICUBIC resize (a = -0.5, support
    widened on downscale, weights renormalised at the borders)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        w = _cubic((np.arange(lo, hi) - center + 0.5) / fs, -0.5)
        m[i, lo:hi] = w / w.sum()
    return m


def _torch_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """torch's bicubic interpolation (a = -0.75, align_corners=False)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            w[i, min(max(x0 + k, 0), n_in - 1)] += _cubic(np.asarray(x - (x0 + k)), -0.75)
    return w


def _linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for k, coef in ((x0, 1 - t), (x0 + 1, t)):
            w[i, min(max(k, 0), n_in - 1)] += coef
    return w


def position_table(image_size: int, patch: int, frames: int, dim: int,
                   ckpt_frames: int = 4, ckpt_side: int = 14) -> np.ndarray:
    """(frames * side^2, dim) sin-cos table of the pretrained 14 x 14 x
    ckpt_frames grid, bicubic-resampled in space and linearly in time."""
    n = ckpt_frames * ckpt_side * ckpt_side
    pos = np.arange(n)[:, None]
    j = np.arange(dim)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / dim)
    table = np.zeros((n, dim))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    side = image_size // patch
    x = table.reshape(ckpt_frames, ckpt_side, ckpt_side, dim)
    if side != ckpt_side:
        m = _torch_bicubic_matrix(ckpt_side, side)
        x = np.einsum("op,tpqc->toqc", m, x)
        x = np.einsum("oq,tpqc->tpoc", m, x)
    if frames != ckpt_frames:
        m = _linear_matrix(ckpt_frames, frames)
        x = np.einsum("ot,tpqc->opqc", m, x)
    return x.reshape(frames * side * side, dim)


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., 3, size, size) float32: the two-pass
    PIL bicubic resize (horizontal first, rounded half to even and clamped
    to [0, 255] after each pass), then x / 255 normalised by ImageNet's
    mean and std."""
    x = frames.double()
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) != (size, size):
        mh = torch.from_numpy(pil_bicubic_matrix(h, size)).to(x.device)
        mw = torch.from_numpy(pil_bicubic_matrix(w, size)).to(x.device)
        x = torch.einsum("ow,...hwc->...hoc", mw, x).round().clamp(0, 255)
        x = torch.einsum("oh,...hwc->...owc", mh, x).round().clamp(0, 255)
    mean = torch.tensor(MEAN, dtype=torch.float64, device=x.device)
    std = torch.tensor(STD, dtype=torch.float64, device=x.device)
    return ((x / 255.0 - mean) / std).float().movedim(-1, -3)


def _ln(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)


def tower(params: Dict, vcfg: Dict, pixels: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """(clips, frames, 3, H, W) float32 -> (clips, frames * patches, D):
    patch embedding, the position table, `depth` blocks, final LayerNorm."""
    c, t, ch, h, w = pixels.shape
    ps, D, H = vcfg["patch_size"], vcfg["hidden_size"], vcfg["num_attention_heads"]
    x = pixels.reshape(c, t, ch, h // ps, ps, w // ps, ps)
    x = x.permute(0, 1, 3, 5, 4, 6, 2).reshape(c, t * (h // ps) * (w // ps), ps * ps * ch)
    pe = params["patch_embed"]
    x = dense(x, {"kernel": pe["kernel"].reshape(-1, D), "bias": pe["bias"]}, None, 0.0, quant)
    pos = position_table(vcfg["image_size"], ps, t, D)
    x = x + torch.from_numpy(pos).float().to(x.device)
    blocks = params["blocks"]
    for i in range(vcfg["depth"]):
        b = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
             for k, v in blocks.items()}
        y = _ln(x, b["norm1"], vcfg["layer_norm_eps"])
        bias = torch.cat([b["q_bias"], torch.zeros_like(b["q_bias"]), b["v_bias"]])
        qkv = dense(y, {"kernel": b["qkv"]["kernel"], "bias": bias}, None, 0.0, quant)
        q, k, v = qkv.view(c, -1, 3, H, D // H).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D // H)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(c, -1, D)
        x = x + dense(a, b["proj"], None, 0.0, quant)
        y = _ln(x, b["norm2"], vcfg["layer_norm_eps"])
        x = x + dense(F.gelu(dense(y, b["fc1"], None, 0.0, quant)), b["fc2"], None, 0.0, quant)
    return _ln(x, params["final_norm"], vcfg["final_layer_norm_eps"])


def merge_schedule(n: int, target: int) -> List[int]:
    """Tokens removed per round: halve until one round from the target."""
    out = []
    while n != target:
        r = n - target if n - target <= n // 2 else n // 2
        out.append(r)
        n -= r
    return out


def _merge(v: torch.Tensor, unm: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """One round's merge by sum: the unmerged even-position (a) tokens in
    the given order, then every odd-position (b) token with the a tokens
    that merge into it added."""
    a, b = v[:, ::2], v[:, 1::2].clone()
    keep = a.gather(1, unm[..., None].expand(-1, -1, v.shape[-1]))
    moved = a.gather(1, src[..., None].expand(-1, -1, v.shape[-1]))
    for i in range(v.shape[0]):
        b[i].index_add_(0, dst[i], moved[i])
    return torch.cat([keep, b], 1)


def tome(x: torch.Tensor, target: int, heads: int, quant: Quant = None,
         record: list = None) -> torch.Tensor:
    """ToMe to `target` tokens: each round splits the tokens into even (a)
    and odd (b) positions, matches every a token with its most similar b
    token (cosine similarity of the head-averaged features; the first
    maximum), merges the r a tokens with the best matches into their
    partners (in a stable descending order) by size-weighted averaging, and
    keeps the unmerged a tokens in that order before all b tokens. `record`
    collects each round's (metric, r, unm, src, dst)."""
    B, T, C = x.shape
    size = torch.ones(B, T, 1, dtype=x.dtype, device=x.device)
    for r in merge_schedule(T, target):
        metric = x.reshape(B, x.shape[1], heads, C // heads).mean(2)
        unm, src, dst = merge_indices(metric, r, quant)
        if record is not None:
            record.append((metric, r, unm, src, dst))
        x = _merge(x * size, unm, src, dst)
        size = _merge(size, unm, src, dst)
        x = x / size
    return x


def merge_indices(metric: torch.Tensor, r: int, quant: Quant = None):
    """(unm, src, dst) of one ToMe round from its (B, T, c) metric."""
    m = metric.float()
    m = m / (m.norm(dim=-1, keepdim=True) + 1e-12)
    a, b = m[:, ::2], m[:, 1::2]
    if quant is not None:
        a, b = quant(a, -1), quant(b, -1)
    best, partner = (a @ b.transpose(1, 2)).max(-1)
    order = torch.argsort(best, dim=-1, descending=True, stable=True)
    src, unm = order[:, :r], order[:, r:]
    return unm, src, partner.gather(1, src)


def replay(x: torch.Tensor, rounds) -> torch.Tensor:
    """ToMe on x with another run's merge decisions ((metric, r, unm, src,
    dst) per round) in place of its own."""
    size = torch.ones(*x.shape[:2], 1, dtype=x.dtype, device=x.device)
    for _metric, _r, unm, src, dst in rounds:
        x = _merge(x * size, unm, src, dst)
        size = _merge(size, unm, src, dst)
        x = x / size
    return x


def merge_shortfall(rounds) -> float:
    """How far a run's merge decisions fall short of ToMe's rule, judged in
    float32 from that run's own metric at each round: for each merged
    token, how far its best similarity lies below the r-th best of its
    clip, or the similarity to the partner it took below its best; the
    mean over every merged token of every round."""
    total, count = 0.0, 0
    for metric, r, _unm, src, dst in rounds:
        m = metric.float()
        m = m / (m.norm(dim=-1, keepdim=True) + 1e-12)
        scores = m[:, ::2] @ m[:, 1::2].transpose(1, 2)
        best = scores.max(-1).values
        kth = best.sort(-1, descending=True).values[:, r - 1: r]
        chosen = best.gather(1, src)
        rows = scores.gather(1, src[..., None].expand(-1, -1, scores.shape[-1]))
        to_partner = rows.gather(2, dst[..., None])[..., 0]
        short = torch.maximum((kth - chosen).clamp(min=0), (chosen - to_partner).clamp(min=0))
        total += float(short.sum())
        count += short.numel()
    return total / max(count, 1)


def towers(params: Dict, cfg: Dict, frames: torch.Tensor, quant: Quant = None,
           clips_per_block: int = 4) -> torch.Tensor:
    """(videos, clips, frames, H, W, 3) uint8 -> (videos * clips, frames *
    patches, D) float32 tower outputs, before ToMe."""
    vcfg = cfg["vision"]
    flat = frames.reshape(-1, *frames.shape[2:])
    return torch.cat([tower(params, vcfg, preprocess(flat[s: s + clips_per_block],
                                                     vcfg["image_size"]), quant)
                      for s in range(0, flat.shape[0], clips_per_block)])


def featurize(params: Dict, cfg: Dict, frames: torch.Tensor, quant: Quant = None,
              clips_per_block: int = 4, record: list = None) -> torch.Tensor:
    """(videos, clips, frames, H, W, 3) uint8 -> (videos, clips, tokens, D)
    float32 cached features; `record` collects each block's ToMe rounds."""
    v, c = frames.shape[:2]
    vcfg = cfg["vision"]
    target = cfg["tokens_per_frame"] * frames.shape[2]
    flat = frames.reshape(v * c, *frames.shape[2:])
    out = []
    for s in range(0, v * c, clips_per_block):
        px = preprocess(flat[s: s + clips_per_block], vcfg["image_size"])
        out.append(tome(tower(params, vcfg, px, quant), target, vcfg["num_attention_heads"],
                        quant, record))
    return torch.cat(out).reshape(v, c, target, -1)


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (Frobenius, float32)."""
    return float((got.float() - want.float()).norm() / want.float().norm())

