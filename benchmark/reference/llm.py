"""Plain PyTorch reference of VideoChat-Flash's likelihood scores: the
Qwen2 decoder with LoRA on q/k/v/o and the LM head, the projector MLPs with
their LoRA, the fp32 `visual_head`, and BLiM's VTG and TVG scores with
their CPN priors. Every sequence runs whole (no shared prefix, no packing,
no cache), in float32 with TF32 off, layer by layer over blocks of rows so
that one layer's weights are widened to float32 once. It reads the
parameter tree the benchmark made (kernels in (in, out) form, layers
stacked on a leading axis) and imports nothing of the measured program.

`quant` (None, or a function (tensor, axis) -> tensor) is applied to both
operands of every weight product: `fake_fp8` turns this reference into the
control, the same arithmetic with float8 (e4m3) operands.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import prompts

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]
NEG = -1e30


@contextlib.contextmanager
def full_fp32():
    """float32 products without TF32 for the body of the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fake_fp8(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `axis`
    (the absolute maximum maps to 448), returned in float32."""
    amax = x.abs().amax(dim=axis, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def dense(x: torch.Tensor, p: Dict, lora: Optional[Dict], scale: float, quant: Quant
          ) -> torch.Tensor:
    """x @ kernel (+ bias) (+ scale * x @ A @ B), all float32."""
    w = p["kernel"].float()
    if quant is None:
        y = x @ w
    else:
        y = quant(x, -1) @ quant(w, 0)
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    if lora is not None:
        y = y + (x @ lora["a"].float()) @ lora["b"].float() * scale
    return y


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention; x (B, T, H, d), pos (B, T)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.double()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().float()[:, :, None], ang.sin().float()[:, :, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def _layer(cfg: Dict, w: Dict, ll: Optional[Dict], scale: float, quant: Quant,
           h: torch.Tensor, pos: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """One decoder layer on a block of rows: causal attention over the keys
    with vis = 1; a position with vis = 0 gets no attention output."""
    B, T, D = h.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    lo = (lambda name: None if ll is None else ll[name])
    x = rms_norm(h, w["input_layernorm"]["scale"], cfg["rms_norm_eps"])
    q = rope(dense(x, w["q_proj"], lo("q_proj"), scale, quant).view(B, T, H, hd), pos,
             cfg["rope_theta"])
    k = rope(dense(x, w["k_proj"], lo("k_proj"), scale, quant).view(B, T, K, hd), pos,
             cfg["rope_theta"])
    v = dense(x, w["v_proj"], lo("v_proj"), scale, quant).view(B, T, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    allowed = causal[None] & (vis[:, None, :] > 0)
    s = torch.where(allowed[:, None], s, torch.full_like(s, NEG))
    a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v) * vis[:, :, None, None]
    h = h + dense(a.reshape(B, T, H * hd), w["o_proj"], lo("o_proj"), scale, quant)
    x = rms_norm(h, w["post_attention_layernorm"]["scale"], cfg["rms_norm_eps"])
    gate = F.silu(dense(x, w["gate_proj"], None, 0.0, quant))
    up = dense(x, w["up_proj"], None, 0.0, quant)
    return h + dense(gate * up, w["down_proj"], None, 0.0, quant)


def _slice(tree, i: int):
    if tree is None:
        return None
    return {k: _slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def decode(params: Dict, cfg: Dict, embeds: torch.Tensor, pos: torch.Tensor,
           vis: torch.Tensor, lora: Optional[Dict], scale: float, quant: Quant,
           rows: int = 8) -> torch.Tensor:
    """Final post-norm hidden states (B, T, D) of padded rows: embeds (B, T,
    D) float32, pos (B, T), vis (B, T) (0 for padding and masked keys)."""
    llm = params["llm"]
    h = embeds
    for i in range(cfg["num_hidden_layers"]):
        w = _slice(llm["layers"], i)
        ll = None if lora is None else _slice(lora["llm"]["layers"], i)
        h = torch.cat([_layer(cfg, w, ll, scale, quant, h[s: s + rows], pos[s: s + rows],
                              vis[s: s + rows]) for s in range(0, h.shape[0], rows)])
    return rms_norm(h, llm["norm"]["scale"], cfg["rms_norm_eps"])


def mlp(p: Dict, x: torch.Tensor, lora: Optional[Dict], scale: float, quant: Quant
        ) -> torch.Tensor:
    """Linear -> exact GELU -> Linear, with LoRA on both."""
    lo = (lambda n: None if lora is None else lora[n])
    return dense(F.gelu(dense(x, p["fc1"], lo("fc1"), scale, quant)), p["fc2"], lo("fc2"),
                 scale, quant)


def _embed(params: Dict, ids: Sequence[int], device) -> torch.Tensor:
    table = params["llm"]["embed_tokens"]["embedding"]
    return table[torch.as_tensor(list(ids), dtype=torch.long, device=device)].float()


def _pad(rows: List[torch.Tensor], value: float = 0.0) -> torch.Tensor:
    T = max(r.shape[0] for r in rows)
    return torch.stack([F.pad(r, (0, 0) * (r.dim() - 1) + (0, T - r.shape[0]), value=value)
                        for r in rows])


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]


def _proj_lora(lora: Optional[Dict], name: str) -> Optional[Dict]:
    return None if lora is None else lora["projector"][name]


def vtg_scores(params: Dict, cfg: Dict, captions: Sequence[str], features: torch.Tensor,
               pairs: Sequence, dataset: str, max_caption_tokens: int,
               lora: Optional[Dict] = None, scale: float = 0.0, quant: Quant = None,
               block: int = 32) -> torch.Tensor:
    """BLiM's VTG score of each (caption, video, prior) in `pairs`: minus
    the mean cross-entropy of the caption and terminator tokens given the
    video (prior=False) or with the video invisible (prior=True, the CPN
    prior P(caption)). features: (V, clips, tokens, mm) float32."""
    dev = features.device
    head = params["llm"]["lm_head"]["kernel"]
    head_lora = None if lora is None else lora["llm"]["lm_head"]
    out = []
    for s in range(0, len(pairs), block):
        embeds, poss, viss, targets = [], [], [], []
        for cap, vid, prior in pairs[s: s + block]:
            pre, post, scored = prompts.vtg_parts(captions[cap], dataset, max_caption_tokens)
            video = mlp(params["projector"]["mlp"], features[vid].reshape(-1, features.shape[-1]),
                        _proj_lora(lora, "mlp"), scale, quant)
            e = torch.cat([_embed(params, pre, dev), video, _embed(params, post + scored, dev)])
            T = e.shape[0]
            vis = torch.ones(T, device=dev)
            if prior:
                vis[len(pre): len(pre) + video.shape[0]] = 0
            embeds.append(e)
            poss.append(torch.arange(T, device=dev))
            viss.append(vis)
            targets.append((T - len(scored), scored))
        h = decode(params, cfg, _pad(embeds), _pad([p[:, None] for p in poss])[..., 0],
                   _pad([v[:, None] for v in viss])[..., 0], lora, scale, quant)
        for b, (start, scored) in enumerate(targets):
            x = h[b, start - 1: start - 1 + len(scored)]
            logits = dense(x, {"kernel": head}, head_lora, scale, quant)
            labels = torch.as_tensor(scored, dtype=torch.long, device=dev)
            out.append(-_ce(logits, labels).mean())
    return torch.stack(out)


def tvg_scores(params: Dict, cfg: Dict, captions: Sequence[str], features: torch.Tensor,
               pairs: Sequence, max_caption_tokens: int, lora: Optional[Dict] = None,
               scale: float = 0.0, quant: Quant = None, block: int = 32) -> torch.Tensor:
    """BLiM's TVG score of each (caption, video, prior) in `pairs`: minus
    the mean over clips of the cross-entropy of the true video among all of
    `features`' videos, through the fp32 visual_head on the hidden state
    before each clip token; prior=True masks the caption down to the
    instruction head (the CPN prior P(video))."""
    dev = features.device
    clips, mm = features.shape[1], features.shape[-1]
    vocab = features.mean(dim=2)                                  # (V, clips, mm)
    vh = params["visual_head"]["kernel"]
    term = prompts.tokenize(prompts.TERMINATOR)
    width = prompts.tvg_padded_length(max_caption_tokens, clips)
    head_len = prompts.tvg_head_length()
    out = []
    for s in range(0, len(pairs), block):
        embeds, poss, viss, targets = [], [], [], []
        for cap, vid, prior in pairs[s: s + block]:
            text = prompts.tvg_text(captions[cap])
            feats = features[vid]
            clip = mlp(params["projector"]["tvg_mlp"], feats, _proj_lora(lora, "tvg_mlp"), scale,
                       quant).mean(dim=1)                         # (clips, D)
            e = torch.cat([_embed(params, text, dev), clip, _embed(params, term, dev)])
            T = e.shape[0]
            vis = torch.ones(T, device=dev)
            if prior:
                vis[head_len: len(text)] = 0
            embeds.append(e)
            poss.append(torch.arange(width - T, width, device=dev))
            viss.append(vis)
            targets.append((len(text) - 1, vid))
        h = decode(params, cfg, _pad(embeds), _pad([p[:, None] for p in poss])[..., 0],
                   _pad([v[:, None] for v in viss])[..., 0], lora, scale, quant)
        for b, (g, vid) in enumerate(targets):
            x = h[b, g: g + clips]                                # (clips, D)
            proj = dense(x, {"kernel": vh}, None, 0.0, quant)     # (clips, mm)
            logits = torch.einsum("cm,vcm->cv", proj, vocab) / math.sqrt(mm)
            labels = torch.full((clips,), vid, dtype=torch.long, device=dev)
            out.append(-_ce(logits, labels).mean())
    return torch.stack(out)
