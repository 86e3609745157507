"""Plain PyTorch reference of BLiM's VTG scores and CPN priors through
Uni-MoE-2.0-Omni's mixture-of-experts language model: the Qwen2 attention
block of `reference/llm.py` with each MLP replaced by the dynamic-capacity
mixture of experts, for the hidden state h of one token:

    x = RMSNorm(h)
    p = softmax(x @ W_r)                       # E routed experts, then Z null ones
    order the experts by p, descending (ties: the lower index first)
    S = the shortest leading run whose p sums to >= top_p, at most top_k experts
    y = h + sum_j FFN^shared_j(x) + sum_{e in S, e routed} p_e * FFN_e(x)
    FFN(x) = W_down (silu(W_gate x) * W_up x)

(p is not renormalised over S, the shared experts have weight 1, the router
has no bias: the configuration's `assumed` points). Float32 with TF32 off,
one pair at a time (no padding, packing or cache), layer by layer: a
layer's weights are widened to float32 once, when that layer runs, for every
pair. It reads the benchmark's parameter tree (weights_moe.py) and imports
nothing of the measured program.

Routing: by its own probabilities, or by given decisions (the program's
log: per pair an int (L, T, top_k) tensor of expert indices in order of p,
-1 for a slot not taken, FREE for a token routed by the reference's own
probabilities), so that the scores are compared on the same routes and
the routes are judged apart by `route_shortfall` on the reference's own
float32 probabilities.

`quant` (None, or `llm.fake_fp8`) is applied to both operands of every
weight product, the router's too: the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import prompts
from benchmark.reference.llm import NEG, Quant, _ce, _embed, mlp, rms_norm, rope

# a decisions row of this value: the token routes by the reference's own p
FREE = -2


def moe_config(cfg: Dict) -> Dict:
    return {"routed": cfg["mlp_dynamic_expert_num"], "null": cfg["mlp_dynamic_null_expert_num"],
            "top_p": cfg["mlp_dynamic_top_p"], "top_k": cfg["mlp_dynamic_top_k"],
            "shared": cfg["mlp_fixed_expert_num"], "shared_size": cfg["shared_intermediate_size"]}


def top_p_rule(p: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """p (T, X) -> (T, top_k) decisions: the experts in descending order of
    p (ties: lower index first), a slot taken while the slots before it sum
    to less than top_p, -1 where not taken."""
    ps, es = torch.sort(p, dim=-1, descending=True, stable=True)
    ps, es = ps[:, :top_k], es[:, :top_k]
    before = torch.cat([torch.zeros_like(ps[:, :1]), ps[:, :-1].cumsum(-1)], -1)
    return torch.where(before < top_p, es, -1)


def route_shortfall(p: torch.Tensor, dec: torch.Tensor, top_p: float) -> float:
    """The largest amount of probability by which a decision lies on the
    wrong side of the top-P rule, judged on p (T, X): an unchosen expert
    above a chosen one (by how much), one expert chosen with p < top_p
    (top_p - p), two chosen when the first alone reached top_p (p - top_p).
    Rows of FREE are not judged."""
    judged = dec[:, 0] != FREE
    p, dec = p[judged], dec[judged].long()
    if not len(dec):
        return 0.0
    chosen = dec >= 0
    X = p.shape[1]
    slot = torch.where(chosen, dec, X)
    pc = torch.cat([p, torch.zeros_like(p[:, :1])], 1).gather(1, slot)
    low = torch.where(chosen, pc, torch.inf).amin(1)
    high = torch.where(chosen, pc, -torch.inf).amax(1)
    taken = torch.zeros(p.shape[0], X + 1, dtype=torch.bool, device=p.device)
    taken = taken.scatter_(1, slot, True)[:, :X]
    out = (torch.where(taken, -torch.inf, p).amax(1) - low).clamp(min=0)
    n = chosen.sum(1)
    if dec.shape[1] > 1:
        out = torch.maximum(out, torch.where(n == 1, top_p - high, 0.0).clamp(min=0))
        out = torch.maximum(out, torch.where(n > 1, high - top_p, 0.0).clamp(min=0))
    return float(out.max())


def _prod(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    """x @ w, w already float32 (and quantised by columns under quant)."""
    return (x if quant is None else quant(x, -1)) @ w


def _widen(w: torch.Tensor, quant: Quant) -> torch.Tensor:
    w = w.float()
    return w if quant is None else quant(w, -2)


def _layer_weights(llm: Dict, i: int, quant: Quant) -> Dict:
    """Layer i's weights in float32 (the operands of products quantised)."""
    lw = llm["layers"]
    m = lw["moe"]
    return {
        "in_scale": lw["input_layernorm"]["scale"][i].float(),
        "post_scale": lw["post_attention_layernorm"]["scale"][i].float(),
        **{n: _widen(lw[n]["kernel"][i], quant) for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
        **{f"{n}_bias": lw[n]["bias"][i].float() for n in ("q_proj", "k_proj", "v_proj")},
        "router": _widen(m["router"]["kernel"][i], quant),
        "gate_up": torch.stack([_widen(w, quant) for w in m["experts"]["gate_up"][i]]),
        "down": torch.stack([_widen(w, quant) for w in m["experts"]["down"][i]]),
        "shared_gate_up": _widen(m["shared"]["gate_up"][i], quant),
        "shared_down": _widen(m["shared"]["down"][i], quant),
    }


def _attention(cfg: Dict, w: Dict, quant: Quant, h: torch.Tensor, pos: torch.Tensor,
               vis: torch.Tensor) -> torch.Tensor:
    """h (T, D) + causal attention over the keys with vis = 1."""
    T, D = h.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    x = rms_norm(h, w["in_scale"], cfg["rms_norm_eps"])
    q = rope((_prod(x, w["q_proj"], quant) + w["q_proj_bias"]).view(1, T, H, hd), pos[None],
             cfg["rope_theta"])
    k = rope((_prod(x, w["k_proj"], quant) + w["k_proj_bias"]).view(1, T, K, hd), pos[None],
             cfg["rope_theta"])
    v = (_prod(x, w["v_proj"], quant) + w["v_proj_bias"]).view(1, T, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    allowed = torch.ones(T, T, dtype=torch.bool, device=h.device).tril() & (vis[None, :] > 0)
    s = torch.where(allowed[None, None], s, torch.full_like(s, NEG))
    a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v) * vis[None, :, None, None]
    return h + _prod(a.reshape(T, H * hd), w["o_proj"], quant)


def _swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, quant: Quant
            ) -> torch.Tensor:
    g = _prod(x, gate_up, quant)
    half = g.shape[-1] // 2
    return _prod(F.silu(g[:, :half]) * g[:, half:], down, quant)


def _experts(cfg: Dict, w: Dict, quant: Quant, h: torch.Tensor,
             given: Optional[torch.Tensor]) -> tuple:
    """h (T, D) + the mixture of experts -> (h', p, the decisions used)."""
    m = moe_config(cfg)
    x = rms_norm(h, w["post_scale"], cfg["rms_norm_eps"])
    p = torch.softmax(_prod(x, w["router"], quant), -1)
    dec = top_p_rule(p, m["top_p"], m["top_k"])
    if given is not None:
        dec = torch.where(given[:, :1] == FREE, dec, given.long())
    y = torch.zeros_like(h)
    for j in range(m["shared"]):
        cols = slice(j * m["shared_size"], (j + 1) * m["shared_size"])
        gu = w["shared_gate_up"]
        half = gu.shape[1] // 2
        gate_up = torch.cat([gu[:, cols], gu[:, half:][:, cols]], 1)
        y = y + _swiglu(x, gate_up, w["shared_down"][cols], quant)
    for e in range(m["routed"]):
        tok = (dec == e).any(1).nonzero()[:, 0]
        if len(tok):
            y[tok] += p[tok, e, None] * _swiglu(x[tok], w["gate_up"][e], w["down"][e], quant)
    return h + y, p, dec


def vtg_scores(params: Dict, cfg: Dict, captions: Sequence[str], features: torch.Tensor,
               pairs: Sequence, dataset: str, max_caption_tokens: int, quant: Quant = None,
               decisions: Optional[Sequence[torch.Tensor]] = None,
               record: Optional[List] = None) -> torch.Tensor:
    """BLiM's VTG score of each (caption, video, prior) in `pairs`: minus
    the mean cross-entropy of the caption and terminator tokens given the
    video (prior=False) or with the video invisible as keys (prior=True,
    the CPN prior P(caption)). features: (V, clips, tokens, mm) float32.
    `decisions[i]` routes pair i (None: every token by its own p);
    `record`, a list, receives per pair per layer (p, decisions used)."""
    dev = features.device
    llm = params["llm"]
    hs, poss, viss, targets = [], [], [], []
    for cap, vid, prior in pairs:
        pre, post, scored = prompts.vtg_parts(captions[cap], dataset, max_caption_tokens)
        video = mlp(params["projector"]["mlp"], features[vid].reshape(-1, features.shape[-1]),
                    None, 0.0, quant)
        e = torch.cat([_embed(params, pre, dev), video, _embed(params, post + scored, dev)])
        T = e.shape[0]
        vis = torch.ones(T, device=dev)
        if prior:
            vis[len(pre): len(pre) + video.shape[0]] = 0
        hs.append(e)
        poss.append(torch.arange(T, device=dev))
        viss.append(vis)
        targets.append((T - len(scored), scored))
    if decisions is not None:
        for h, d in zip(hs, decisions):
            if d.shape[1] != h.shape[0]:
                raise ValueError(f"decisions for {d.shape[1]} tokens, sequence of {h.shape[0]}")
    if record is not None:
        record.extend([] for _ in pairs)
    for i in range(cfg["num_hidden_layers"]):
        w = _layer_weights(llm, i, quant)
        for b in range(len(hs)):
            h = _attention(cfg, w, quant, hs[b], poss[b], viss[b])
            given = None if decisions is None else decisions[b][i].to(dev)
            hs[b], p, dec = _experts(cfg, w, quant, h, given)
            if record is not None:
                record[len(record) - len(hs) + b].append((p, dec))
        del w
    head = _widen(llm["lm_head"]["kernel"], quant)
    out = []
    for h, (start, scored) in zip(hs, targets):
        x = rms_norm(h, llm["norm"]["scale"], cfg["rms_norm_eps"])[start - 1: start - 1 + len(scored)]
        logits = _prod(x, head, quant)
        labels = torch.as_tensor(scored, dtype=torch.long, device=dev)
        out.append(-_ce(logits, labels).mean())
    return torch.stack(out)
