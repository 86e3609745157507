"""Uni-MoE-2.0-Omni's dynamic-capacity mixture of experts, the MLP of a
`Qwen2MoEConfig` decoder layer (`qwen2._mlp` dispatches here and adds the
residual).

For the hidden state h of one token (E routed experts, Z null experts):

    x = RMSNorm(h)                               # post_attention_layernorm
    p = softmax(float32(x) @ W_r)                # W_r (D, E + Z) float32, no bias
    order the E + Z experts by p, descending (ties: the lower index first)
    S = the shortest leading run whose p sums to >= top_p, at most top_k experts
    y = h + sum_j FFN^shared_j(x) + sum_{e in S, e routed} p_e * FFN_e(x)
    FFN(x) = W_down (silu(W_gate x) * W_up x)

p is not renormalised over S, the shared experts are summed with weight 1,
and a null expert outputs zero and costs nothing. Padding positions are
routed like any token: they cost what a real token costs, and the rerank
engine counts them apart.

Everything runs on the device at shapes fixed by the token count, with no
host read of routed data, so a layer captures into a CUDA graph:

  * route (`moe.route`): the fp32 router product, softmax, the top_k
    experts by repeated argmax (the first maximum: the lower index on ties),
    and the top-P rule;
  * permute (`moe.permute`): the N * top_k (token, slot) pairs ordered by
    expert with a counting sort (a cumulative sum along a one-hot table),
    slots that run no expert last; the per-expert group ends stay on the
    device;
  * experts (`moe.experts`): two grouped products (`torch._grouped_mm`,
    CUTLASS's grouped GEMM on sm_90): gate and up side by side, then down,
    each expert multiplying only its own rows; rows past the last group end
    (the null and untaken slots) are not computed;
  * shared (`moe.shared`): the shared experts, one dense SwiGLU as wide as
    all of them side by side;
  * combine (`moe.combine`): each token's expert outputs weighted by p in
    fp32, plus the shared experts' output, cast once to the activations'
    dtype.

Each part (`route`, `permute`, `experts`, `shared`, `combine`) runs under
the span of its name, so an eager run's profile puts every kernel of the
layer under one of them.

Parameters of one layer, `lp["moe"]` (the tree stacks them over layers):
  router  {"kernel": (D, E + Z) float32}
  experts {"gate_up": (E, D, 2 I), "down": (E, I, D)}   gate = [..., :I], up = [..., I:]
  shared  {"gate_up": (D, 2 S Is), "down": (S Is, D)}   gate = [:, :S Is], up = [:, S Is:];
          shared expert j owns columns j Is:(j + 1) Is of each half and rows of down

Routing log: inside `collect()`, every layer appends its decisions, an
int8 (N, top_k) tensor on the device (the chosen experts in order of p, a
null expert by its index E..E+Z-1, -1 for a slot not taken), in call order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from blim_tpu_torch.core.config import MoEConfig
from blim_tpu_torch.core.numerics import einsum_fp32
from blim_tpu_torch.utils.profiling import span

Params = Dict[str, object]

# the decisions of the layers run inside `collect()`, or None
_log: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def collect() -> Iterator[List[torch.Tensor]]:
    """The routing decisions of every MoE layer run in the block, in order."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        _log = outer


def route(x: torch.Tensor, router: torch.Tensor, m: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, D) -> (p, e, taken), each (N, top_k): the probabilities and
    indices of the top_k experts in descending order of p, and whether the
    top-P rule takes each slot. Slot j is taken while the slots before it
    sum to less than top_p; slot 0 always."""
    probs = torch.softmax(einsum_fp32("nd,de->ne", x, router), dim=-1)
    rest, ps, es = probs, [], []
    for _ in range(m.top_k):
        e = rest.argmax(dim=-1, keepdim=True)
        ps.append(probs.gather(-1, e))
        es.append(e)
        rest = rest.scatter(-1, e, -1.0)
    p, e = torch.cat(ps, -1), torch.cat(es, -1)
    before = F.pad(p[:, :-1].cumsum(-1), (1, 0))
    return p, e, before < m.top_p


def decisions(e: torch.Tensor, taken: torch.Tensor) -> torch.Tensor:
    """The routing log's form: int8 (N, top_k) expert indices, -1 untaken."""
    return torch.where(taken, e, -1).to(torch.int8)


def permute(e: torch.Tensor, runs: torch.Tensor, n_routed: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, slot) pairs ordered by routed expert, stable, the slots
    that run none last. e, runs (N, K) -> (src (N K,) the flat slot of each
    sorted row, dst (N K,) the sorted row of each flat slot, ends (E,)
    int32 group ends)."""
    flat = torch.where(runs, e, n_routed).reshape(-1)
    # (experts + 1, N K): each expert's running count along the slots, an
    # innermost-axis scan
    table = (flat[None] == torch.arange(n_routed + 1, device=e.device)[:, None]).to(torch.int32)
    seen = table.cumsum(1)
    counts = seen[:, -1]
    starts = counts.cumsum(0) - counts
    dst = starts[flat] + seen.gather(0, flat[None])[0] - 1
    src = torch.empty_like(dst).scatter_(0, dst, torch.arange(dst.numel(), device=e.device))
    return src, dst, counts[:n_routed].cumsum(0).to(torch.int32)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows grouped by expert, w (E, K, N), ends (E,) int32 ->
    (M, N): group g's rows times w[g]; rows at or past ends[-1] are left
    unwritten."""
    return torch._grouped_mm(x, w, offs=ends)


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of gate and up side by side on the last axis."""
    half = h.shape[-1] // 2
    return F.silu(h[..., :half]) * h[..., half:]


def experts(w: Params, rows: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The routed experts on their rows (`permute`'s order) -> (N K, D);
    rows past the last group end are left unwritten."""
    return grouped_mm(swiglu(grouped_mm(rows, w["gate_up"], ends)), w["down"], ends)


def combine(p: torch.Tensor, runs: torch.Tensor, dst: torch.Tensor, out: torch.Tensor
            ) -> torch.Tensor:
    """Each token's expert outputs weighted by p, in fp32 -> (N, D)."""
    n, k = runs.shape
    per_slot = out.index_select(0, dst).view(n, k, -1)
    weight = torch.where(runs, p, 0.0)
    return torch.where(runs[..., None], per_slot, 0).float().mul(weight[..., None]).sum(1)


def shared(w: Params, xs: torch.Tensor) -> torch.Tensor:
    """The shared experts, side by side as one SwiGLU -> (N, D)."""
    return swiglu(xs @ w["gate_up"]) @ w["down"]


def moe_mlp(m: MoEConfig, w: Params, x: torch.Tensor) -> torch.Tensor:
    """One layer's mixture of experts on its normalised input: x (..., D)
    -> (..., D) in x's dtype, without the residual (`qwen2._mlp` adds it);
    w is the layer's `moe` tree."""
    shape = x.shape
    xs = x.reshape(-1, shape[-1])
    with span("moe.route"):
        p, e, taken = route(xs, w["router"]["kernel"], m)
        runs = taken & (e < m.routed)
        if _log is not None:
            _log.append(decisions(e, taken))
    with span("moe.permute"):
        src, dst, ends = permute(e, runs, m.routed)
        rows = xs.index_select(0, src // m.top_k)
    with span("moe.experts"):
        out = experts(w["experts"], rows, ends)
    with span("moe.shared"):
        always = shared(w["shared"], xs)
    with span("moe.combine"):
        routed = combine(p, runs, dst, out)
        return (always.float() + routed).to(x.dtype).view(shape)
