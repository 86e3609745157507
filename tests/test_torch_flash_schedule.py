"""The arithmetic of the forward and backward Hopper kernels, tile by tile
on the CPU, against the plain versions they are held to on the card.

`scheduled_forward` below is a model of flash_fwd.cu and flash_fwd_dense.cu,
not a part of the port. flash_fwd.cu (d = 128): 128-row q tiles (two
warpgroups of 64 rows, whose rows are independent) and 128-row KV tiles;
its P V is issued one tile late but after O's rescale, so O = O alpha_j +
P_j V_j tile by tile, as in one pass. flash_fwd_dense.cu (B2, B2-lse: d =
64, dense, non-causal): 192-row q tiles (three warpgroups) and 112-row KV
tiles (tfa.DENSE_Q_ROWS, tfa.DENSE_KV_TILE), each tile's P V added one tile
late, as the kernel issues it beside the next tile's QK^T: O = (O +
P_(j-1) V_(j-1)) alpha_j. Both: KV tiles in order, zero-filled beyond S as
TMA returns them; KV tiles wholly above the causal diagonal skipped; a tile
masked, by position and key bits, only when it is the causal diagonal, the
ragged last tile, or one of its key bits is 0 (per batch row), with the
kernel's masked logit, the power of two nearest -1e30 in the scaled-logit
domain, in unscaled units; the running max kept in unscaled scores; the
exponentials as exp2 of one fused multiply-add with scale * log2(e) folded
in (the exact product, then one rounding: modelled in fp64); P rounded to
bf16 per tile before P.V, l summed from the fp32 P; O / max(l, 1e-30) times
the query mask; lse = m * scale + log(max(l, 1e-30)).

It runs at the main paths' masks and shapes (B2 also at a ragged S whose
last q and KV tiles are both partial), held to
`reference_attention` and `reference_attention_lse` with chip_smoke.py's own
tolerances (output |d| <= ATTN_ATOL + ATTN_RTOL |plain|; lse |d| <= LSE_TOL on
rows with query mask 1), so a tiling or rounding choice that would break
chip_smoke.py's phases 2, 5 or 8 shows here first.

`scheduled_backward` models flash_bwd.cu the same way: flash_dq's 128-row q
tiles against 64-row kv tiles up to the causal diagonal, flash_dkv's 128-row
kv tiles against 64-row q tiles from it, both zero-filled beyond S; the
exponentials as exp2 of one FMA of the unscaled score with scale * log2(e)
and lse * log2(e) (fp64); invisible pairs given p = 0; P and dS rounded to
bf16 before their products; each cluster rank's partial dK, dV over its q
heads of the GQA group, summed in rank order. It is held to
`reference_attention_backward` with chip_smoke.py's GRAD_TOL at the train
step's d = 128 masks.

`scheduled_backward_dense` models flash_bwd_dense.cu, the fused backward of
the ViT's d = 64 dense non-causal mode, through the port's own plain
versions of its two passes: the preprocess's delta and zeroed accumulator;
128-row kv tiles (a CTA each) against 64-row q tiles, zero-filled beyond S,
one exp2-FMA a pair, p = 0 where the q or kv row lies beyond S, P and dS
rounded to bf16 before their products; dV, dK summed over the q tiles in
order; each kv tile's dQ tile added in fp32 into the accumulator, laid out
as the kernel lays it out, in an order drawn from a seeded permutation (the
bulk reductions land in L2 in no fixed order); then the convert. It is
held to `reference_attention_backward` at GRAD_TOL at one clip of S = 3136
(a ragged last 128-row kv tile) and at the image tiles' S = 784 (ragged
64-row q tiles too), and two add orders to each other.
"""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ATTN_ATOL, ATTN_RTOL, GRAD_TOL, LSE_TOL
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import reference_attention

BQ = BK = 128                 # q rows per CTA, kv rows per tile
DQ_ROWS, DQ_KV = 128, 64      # flash_dq: q rows a CTA, kv rows a tile
DKV_ROWS, DKV_Q = 128, 64     # flash_dkv: kv rows a CTA, q rows a tile
DENSE_KV, DENSE_Q = 128, 64   # flash_bwd_dense: kv rows a CTA, q rows a tile
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tile-by-tile models are thousands of small ops: one intra-op
    thread keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(x: float) -> float:
    return float(np.float32(x))


def scheduled_forward(q, k, v, key_mask=None, query_mask=None, causal=True, scale=None,
                      bq=BQ, bk=BK, deferred_pv=False, unmasked_tile=None):
    """The forward kernels, modelled tile by tile: (out bf16, lse fp32).
    bq, bk: q and KV rows a tile; deferred_pv: each tile's P V added after
    the next tile's rescale, as flash_fwd_dense.cu orders it; unmasked_tile:
    a KV tile index left unmasked whatever its key bits (a planted fault)."""
    b, s, hq, d = q.shape
    grp = hq // k.shape[2]
    scale = _f32(d ** -0.5 if scale is None else scale)
    c = _f32(scale * _f32(LOG2E))                       # scale_log2, one fp32 product
    neg = -math.ldexp(1.0, round(math.log2(_f32(1e30 / scale))))
    n_kv = -(-s // bk)
    pad = n_kv * bk - s
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))   # TMA's zero fill
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kp = kp.repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)      # (B, Hq, S', d)
    vp = vp.repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)
    qf = q.float().permute(0, 2, 1, 3)                              # (B, Hq, S, d)
    kbits = torch.ones((b, n_kv * bk), dtype=torch.bool)
    kbits[:, s:] = False
    if key_mask is not None:
        kbits[:, :s] &= key_mask.bool()
    out = torch.zeros((b, hq, s, d))
    lse = torch.zeros((b, hq, s))
    for qt in range(-(-s // bq)):
        rows = torch.arange(qt * bq, min(s, (qt + 1) * bq))
        m = torch.full((b, hq, len(rows)), neg)
        l = torch.zeros((b, hq, len(rows)))
        o = torch.zeros((b, hq, len(rows), d))
        pv = torch.zeros_like(o)                                # the tile's P V not added yet
        for kt in range(min(qt + 1, n_kv) if causal else n_kv):
            cols = torch.arange(kt * bk, (kt + 1) * bk)
            sc = qf[:, :, rows] @ kp[:, :, cols].transpose(-1, -2)   # unscaled fp32 scores
            diag = causal and kt == qt
            # the rule: the diagonal, the ragged last tile (its bits beyond S
            # are 0) and a tile with a 0 key bit are masked, per batch row
            masked = ~kbits[:, cols].all(-1) | diag
            if kt == unmasked_tile:
                masked[:] = False
            vis = kbits[:, None, None, cols]
            if diag:
                vis = vis & (cols[None, :] <= rows[:, None])[None, None]
            sc = torch.where(masked[:, None, None, None], sc.masked_fill(~vis, neg), sc)
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - mx) * c)
            mb = (mx * c).float()                               # rounded to fp32
            p = torch.exp2(sc.double() * c - mb.double()[..., None]).float()
            l = l * alpha + p.sum(-1)
            if deferred_pv:
                o = (o + pv) * alpha[..., None]
                pv = p.to(torch.bfloat16).float() @ vp[:, :, cols]
            else:
                o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vp[:, :, cols]
            m = mx
        o = o + pv
        keep = torch.ones((b, 1, len(rows), 1)) if query_mask is None else \
            query_mask[:, rows].float()[:, None, :, None]
        lc = l.clamp_min(1e-30)
        out[:, :, rows] = o / lc[..., None] * keep
        lse[:, :, rows] = m * scale + torch.log(lc)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16), lse


def _masked_logit(scale):
    """The power of two nearest -1e30 in the scaled-logit domain, in unscaled units."""
    return -math.ldexp(1.0, round(math.log2(_f32(1e30 / scale))))


def _cluster_size(group):
    return next(c for c in range(8, 0, -1) if group % c == 0)


def scheduled_backward(q, k, v, key_mask, query_mask, out, lse, dout, causal=True, scale=None,
                       invisible_p_zero=True):
    """flash_bwd.cu's dq, dk, dv (bf16), modelled tile by tile. With
    invisible_p_zero False, invisible pairs keep the forward's masked logit
    and go through the same exp2-FMA instead of getting p = 0."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    grp = hq // hkv
    scale = _f32(d ** -0.5 if scale is None else scale)
    c = _f32(scale * _f32(LOG2E))
    neg = _masked_logit(scale)
    g = dout if query_mask is None else dout * query_mask[:, :, None, None].to(dout.dtype)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)          # (B, Hq, S)
    lse2 = (lse.float() * _f32(LOG2E)).double()                         # rounded to fp32 first
    sp = -(-s // 128) * 128
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, sp - s)).permute(0, 2, 1, 3)  # noqa: E731
    qf, gf, kf, vf = pad(q), pad(g), pad(k), pad(v)                     # (B, H, S', d), TMA's zeros
    delta = torch.nn.functional.pad(delta, (0, sp - s))
    lse2 = torch.nn.functional.pad(lse2, (0, sp - s))
    kbits = torch.zeros((b, sp), dtype=torch.bool)
    kbits[:, :s] = True if key_mask is None else key_mask.bool()
    pos = torch.arange(sp)
    qin = pos < s

    def p_and_ds(qh, kh, rows, cols):
        """P and dS (fp32) of q heads qh against their kv heads kh, (B, H, rows, cols)."""
        sc = qf[:, qh][:, :, rows] @ kf[:, kh][:, :, cols].transpose(-1, -2)   # unscaled fp32
        dp = gf[:, qh][:, :, rows] @ vf[:, kh][:, :, cols].transpose(-1, -2)
        vis = kbits[:, None, None, cols] & qin[rows][None, None, :, None]
        if causal:
            vis = vis & (cols[None, :] <= rows[:, None])[None, None]
        if not invisible_p_zero:
            sc = sc.masked_fill(~vis, neg)
        p = torch.exp2(sc.double() * c - lse2[:, qh][:, :, rows, None]).float()
        if invisible_p_zero:
            p = p.masked_fill(~vis, 0.0)
        return p, p * (dp - delta[:, qh][:, :, rows, None])

    # tiles of one kernel are independent CTAs: without causality each sees
    # the same tiles of the other side, so the model takes them all at once
    heads = torch.arange(hq)
    dq = torch.zeros((b, hq, sp, d))
    n_kv = -(-s // DQ_KV)
    for qt in range(sp // DQ_ROWS if causal else 1):
        rows = torch.arange(qt * DQ_ROWS, (qt + 1) * DQ_ROWS) if causal else torch.arange(sp)
        for kt in range(min(2 * qt + 2, n_kv) if causal else n_kv):
            cols = torch.arange(kt * DQ_KV, (kt + 1) * DQ_KV)
            _, ds = p_and_ds(heads, heads // grp, rows, cols)
            dq[:, :, rows] += ds.to(torch.bfloat16).float() @ kf[:, heads // grp][:, :, cols]

    cl = _cluster_size(grp)
    dk = torch.zeros((b, hkv, sp, d))
    dv = torch.zeros((b, hkv, sp, d))
    for kt in range(sp // DKV_ROWS if causal else 1):
        cols = torch.arange(kt * DKV_ROWS, (kt + 1) * DKV_ROWS) if causal else torch.arange(sp)
        j0 = 2 * kt if causal else 0
        parts = []
        for rank in range(cl):                          # one CTA of the cluster each
            pk = torch.zeros((b, hkv, len(cols), d))
            pv = torch.zeros((b, hkv, len(cols), d))
            for i in range(grp // cl):
                qh = torch.arange(hkv) * grp + i * cl + rank
                for j in range(j0, -(-s // DKV_Q)):
                    rows = torch.arange(j * DKV_Q, (j + 1) * DKV_Q)
                    p, ds = p_and_ds(qh, torch.arange(hkv), rows, cols)
                    pv += p.transpose(-1, -2).to(torch.bfloat16).float() @ gf[:, qh][:, :, rows]
                    pk += ds.transpose(-1, -2).to(torch.bfloat16).float() @ qf[:, qh][:, :, rows]
            parts.append((pk, pv))
        for pk, pv in parts:                            # the cluster's sum, in rank order
            dk[:, :, cols] += pk
            dv[:, :, cols] += pv
    back = lambda t, mul: (t[:, :, :s] * mul).permute(0, 2, 1, 3).to(torch.bfloat16)  # noqa: E731
    return back(dq, scale), back(dk, scale), back(dv, 1.0)


def scheduled_backward_dense(q, k, v, out, lse, dout, scale=None, order_seed=0):
    """flash_bwd_dense.cu's preprocess, fused kernel and convert, modelled
    tile by tile: (dq, dk, dv) in bf16. One q head a K/V head, no masks,
    non-causal. `order_seed` draws, for every q tile, the order in which the
    kv tiles' dQ tiles reach the accumulator."""
    b, s, h, d = q.shape
    scale = _f32(d ** -0.5 if scale is None else scale)
    c = _f32(scale * _f32(LOG2E))
    delta, acc = tfa.reference_bwd_dense_prep(out, dout)                 # (B, H, S), zeros
    lse2 = (lse.float() * _f32(LOG2E)).double()                         # rounded to fp32 first
    n_kv, n_q = -(-s // DENSE_KV), -(-s // DENSE_Q)
    pad = lambda t, n: torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, n - s)).permute(0, 2, 1, 3)  # noqa: E731
    qf, gf = pad(q, n_q * DENSE_Q), pad(dout, n_q * DENSE_Q)            # TMA's zeros beyond S
    kf, vf = pad(k, n_kv * DENSE_KV), pad(v, n_kv * DENSE_KV)
    rows = torch.arange(n_q * DENSE_Q)
    delta = torch.nn.functional.pad(delta, (0, n_q * DENSE_Q - s))
    lse2 = torch.nn.functional.pad(lse2, (0, n_q * DENSE_Q - s))
    dk = torch.zeros((b, h, n_kv * DENSE_KV, d))
    dv = torch.zeros((b, h, n_kv * DENSE_KV, d))
    dq_tiles = torch.zeros((n_kv, b, h, n_q * DENSE_Q, d))               # each CTA's dQ tiles
    for kt in range(n_kv):                                              # one CTA each
        cols = torch.arange(kt * DENSE_KV, (kt + 1) * DENSE_KV)
        sc = qf @ kf[:, :, cols].transpose(-1, -2)                      # unscaled fp32 (S^T's transpose)
        dp = gf @ vf[:, :, cols].transpose(-1, -2)
        p = torch.exp2(sc.double() * c - lse2[..., None]).float()
        p = p.masked_fill(~((rows < s)[:, None] & (cols < s)[None, :]), 0.0)
        ds = p * (dp - delta[..., None])
        pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        dv[:, :, cols] = pb.transpose(-1, -2) @ gf
        dk[:, :, cols] = dsb.transpose(-1, -2) @ qf
        dq_tiles[kt] = dsb @ kf[:, :, cols]
    # every q tile's dQ tiles reach the accumulator in their own order
    order = torch.from_numpy(np.random.default_rng(order_seed).permuted(
        np.tile(np.arange(n_kv), (n_q, 1)), axis=1))
    tiles = dq_tiles.reshape(n_kv, b, h, n_q, DENSE_Q, d)
    summed = torch.zeros((n_q, b, h, DENSE_Q, d))
    for step in range(n_kv):
        summed += tiles[order[:, step], :, :, torch.arange(n_q)]
    acc[..., tfa.dq_accumulator_order().reshape(-1)] += summed.permute(1, 2, 0, 3, 4).reshape(
        b, h, n_q, DENSE_Q * d)
    dq = tfa.reference_bwd_dense_convert(acc, s, scale)
    back = lambda t, mul: (t[:, :, :s] * mul).permute(0, 2, 1, 3).to(torch.bfloat16)  # noqa: E731
    return dq, back(dk, scale), back(dv, 1.0)


def _vtg_mask(s):
    m = torch.ones((4, s), dtype=torch.int32)
    for i, pad in enumerate((23, 61, 5, 88)):
        m[i, s - pad:] = 0
    return m


def _tvg_mask(s):
    m = torch.ones((4, s), dtype=torch.int32)
    for i, pad in enumerate((120, 97, 143, 110)):
        m[i, :pad] = 0
    return m


def _run_mask(s, lo, hi):
    """All ones but keys lo .. hi - 1: with 128-row tiles, a run inside one
    interior tile (the rows there are query-masked too, as the paths pass
    one mask as both)."""
    m = torch.ones((1, s), dtype=torch.int32)
    m[:, lo:hi] = 0
    return m


def _holes_mask(rng, b, s):
    m = np.ones((b, s), np.int32)
    m[:, s - 9:] = 0
    m[:, 14:270] = 0                      # a CPN-masked video block
    m &= (rng.random((b, s)) > 0.1).astype(np.int32)
    m[:, 0] = 1
    return torch.from_numpy(m)


# name -> (B, S, Hq, Hkv, d, causal, mask maker): the main paths' shapes with
# fewer heads (the GQA group of 4 kept); a long causal S of 9 q and kv tiles,
# ragged at the end (the chat's prefill cut down), all-ones or with a run of
# masked keys inside one interior tile; B2 (flash_fwd_dense.cu, its tiles) at
# one clip and one head, at the image tiles' S = 784 and at a ragged S
CASES = {
    "B1 S=341 right pads": (4, 341, 8, 2, 128, True, lambda rng: _vtg_mask(341)),
    "B1 S=341 CPN holes": (4, 341, 8, 2, 128, True, lambda rng: _holes_mask(rng, 4, 341)),
    "B1 S=85 prior prefix": (1, 85, 8, 2, 128, True, lambda rng: torch.ones((1, 85), dtype=torch.int32)),
    "B1 S=341 dense causal": (2, 341, 8, 2, 128, True, lambda rng: None),
    "B1-lse VTG S=448 right pads": (4, 448, 8, 2, 128, True, lambda rng: _vtg_mask(448)),
    "B1-lse TVG S=256 left pads": (4, 256, 8, 2, 128, True, lambda rng: _tvg_mask(256)),
    "B2 S=3136 dense d=64": (1, 3136, 1, 1, 64, False, lambda rng: None),
    "B2 dense d=64 S=784 image tiles": (2, 784, 1, 1, 64, False, lambda rng: None),
    "B2 dense d=64 S=1000 ragged": (1, 1000, 2, 2, 64, False, lambda rng: None),
    "long B1 S=1100 all-ones": (1, 1100, 8, 2, 128, True,
                                lambda rng: torch.ones((1, 1100), dtype=torch.int32)),
    "long B1 S=1100 masked run in one tile": (1, 1100, 8, 2, 128, True,
                                              lambda rng: _run_mask(1100, 300, 341)),
}


def _forward_tiles(d):
    """The model's tiling of the forward kernel that takes head dim d."""
    if d == tfa.DENSE_HEAD_DIM:
        return dict(bq=tfa.DENSE_Q_ROWS, bk=tfa.DENSE_KV_TILE, deferred_pv=True)
    return dict(bq=BQ, bk=BK)


def _inputs(case):
    b, s, hq, hkv, d, causal, make_mask = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)  # noqa: E731
    return t(b, s, hq, d), t(b, s, hkv, d), t(b, s, hkv, d), make_mask(rng), causal


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_plain_versions(case):
    q, k, v, mask, causal = _inputs(case)
    scale = q.shape[-1] ** -0.5
    out, lse = scheduled_forward(q, k, v, mask, mask, causal, scale, **_forward_tiles(q.shape[-1]))
    ref, ref_lse = tfa.reference_attention_lse(q, k, v, mask, mask, causal, scale)
    assert torch.equal(ref, reference_attention(q, k, v, mask, mask, causal, scale))
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    excess = ((out.float() - ref.float()).abs() - ATTN_RTOL * ref.float().abs()).max().item()
    assert excess <= ATTN_ATOL, case
    rows = torch.ones(lse.shape, dtype=torch.bool) if mask is None else \
        mask.bool()[:, None, :].expand(lse.shape)
    assert (lse - ref_lse)[rows].abs().max().item() <= LSE_TOL, case


def test_a_tile_with_a_masked_key_must_be_masked():
    """flash_fwd.cu masks a loop tile only when one of its key bits is 0.
    Planted: the interior tile that holds the run of masked keys (keys 300
    .. 340 of tile 2) left unmasked; the rows after it then see those keys
    and leave chip_smoke.py's tolerance, while the model under the rule
    holds to it."""
    q, k, v, mask, causal = _inputs("long B1 S=1100 masked run in one tile")
    ref = reference_attention(q, k, v, mask, mask, causal)
    excess = {}
    for planted in (None, 2):
        out, _ = scheduled_forward(q, k, v, mask, mask, causal, unmasked_tile=planted,
                                   **_forward_tiles(128))
        excess[planted] = ((out.float() - ref.float()).abs()
                           - ATTN_RTOL * ref.float().abs()).max().item()
    assert excess[None] <= ATTN_ATOL < excess[2], excess


def test_forward_tiles_and_budgets_are_the_kernels():
    """The model's d = 128 tiles are flash_fwd.cu's (kBQ q rows a CTA, two
    consumer warpgroups of 64, kBK kv rows a tile); its rings of kStages K
    and V buffers, the Q tile, the key bits and the mbarriers fit in the
    227 KB a block may take; and setmaxnreg's split fits in the registers
    that one CTA of 384 threads holds at entry (168 a thread), with each
    consumer thread's S (64 fp32), P (32 bf16 pairs) and O (64 fp32) under
    its share."""
    src = tfa.SOURCES["flash_fwd"].read_text()
    const = {name: int(value) for name, value in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kBQ"] == BQ and const["kBK"] == BK and const["kD"] == tfa.HEAD_DIM
    assert const["kBQ"] == 64 * const["kConsumers"]
    stages = const["kStages"]
    assert stages >= 2
    smem = (BQ + 2 * stages * BK) * tfa.HEAD_DIM * 2 + stages * BK // 8 + (1 + 4 * stages) * 8
    assert smem + 1024 <= 232_448
    threads = (const["kConsumers"] + 1) * 128
    entry = 65536 // threads // 8 * 8
    assert entry == 168
    assert (const["kProducerRegs"] + const["kConsumers"] * const["kConsumerRegs"]) * 128 \
        <= entry * threads
    assert const["kConsumerRegs"] - (BK // 2 + BK // 4 + tfa.HEAD_DIM // 2) >= 64
    assert 24 <= const["kProducerRegs"] <= const["kConsumerRegs"] <= 256
    assert const["kProducerRegs"] % 8 == 0 and const["kConsumerRegs"] % 8 == 0


def test_prefill_bound_and_exponential_floor():
    """The chat's prefill, (1, 8381, 28 q heads on 4 KV heads, 128), causal
    under an all-ones mask: 28 x 8381 x 8382 / 2 visible pairs at 4 d = 512
    flops each, 503.5 GFLOP, 0.5091 ms at 989 TFLOP/s, bound by operations
    (q, k, v, o and the mask are 60.5 MB, 0.018 ms); one exponential a pair
    on the SFUs, 0.2546 ms, half the bound."""
    s, hq, hkv, d = 8381, 28, 4, 128
    mask = torch.ones((1, s), dtype=torch.int32)
    ms, by = chip_smoke.attention_bound_ms(1, s, hq, hkv, d, mask, mask)
    assert by == "operations" and ms == pytest.approx(0.5091, abs=1e-4)
    pairs = s * (s + 1) // 2
    assert chip_smoke.pairs_visible(mask, mask) == pairs
    assert 4.0 * d * hq * pairs == pytest.approx(503.5e9, rel=1e-4)
    floor = chip_smoke.exp_floor_ms(hq * pairs)
    assert floor == pytest.approx(0.2546, abs=1e-4) and floor == pytest.approx(ms / 2, rel=1e-9)


def test_fully_masked_rows_stay_finite_only_with_a_power_of_two_masked_logit():
    """TVG left pads leave whole q tiles with no visible key. With the masked
    logit a power of two, neg * scale_log2 is exact and the fused
    multiply-add gives those rows exponents of exactly 0; with -1e30 / scale
    it leaves the product's rounding error, ~1e23, and exp2 overflows."""
    q, k, v, mask, _ = _inputs("B1-lse TVG S=256 left pads")
    out, lse = scheduled_forward(q, k, v, mask, mask, True)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out[mask == 0].float() == 0).all()
    c = _f32(_f32(128 ** -0.5) * _f32(LOG2E))
    for neg, exact in ((-math.ldexp(1.0, round(math.log2(_f32(1e30 / _f32(128 ** -0.5))))), True),
                       (_f32(-1e30 / _f32(128 ** -0.5)), False)):
        exponent = neg * c - _f32(neg * c)     # the FMA: exact product minus its fp32 rounding
        assert (exponent == 0.0) == exact


# name -> (B, S, Hq, Hkv, d, causal, mask maker): the train step's backward
# shapes with one kv head's worth of the 7B's GQA group of 7 (Hq 14, Hkv 2),
# and the forward's other masks; one case at a group of 4 (a cluster of 4);
# the ViT's dense non-causal d = 64 at one clip of 2 heads, and at the image
# tiles' S = 784: these two through the fused model, scheduled_backward_dense
BACKWARD_CASES = {
    "VTG S=448 right pads": (4, 448, 14, 2, 128, True, lambda rng: _vtg_mask(448)),
    "TVG S=256 left pads": (4, 256, 14, 2, 128, True, lambda rng: _tvg_mask(256)),
    "S=341 CPN holes": (4, 341, 14, 2, 128, True, lambda rng: _holes_mask(rng, 4, 341)),
    "S=341 dense causal": (2, 341, 14, 2, 128, True, lambda rng: None),
    "S=200 right pads": (2, 200, 14, 2, 128, True, lambda rng: _vtg_mask(200)[:2]),
    "S=200 right pads group 4": (2, 200, 8, 2, 128, True, lambda rng: _vtg_mask(200)[:2]),
    "ViT S=3136 dense d=64 group 1": (1, 3136, 2, 2, 64, False, lambda rng: None),
    "image tiles S=784 dense d=64 group 1": (2, 784, 2, 2, 64, False, lambda rng: None),
}


def _backward_inputs(case):
    b, s, hq, hkv, d, causal, make_mask = BACKWARD_CASES[case]
    rng = np.random.default_rng(100 + sorted(BACKWARD_CASES).index(case))
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k, v, dout = t(b, s, hq, d), t(b, s, hkv, d), t(b, s, hkv, d), t(b, s, hq, d)
    mask = make_mask(rng)
    out, lse = tfa.reference_attention_lse(q, k, v, mask, mask, causal, d ** -0.5)
    return q, k, v, mask, out, lse, dout


def _assert_within_grad_tol(got, want, case):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (case, name)
        assert torch.isfinite(g.float()).all(), (case, name)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_TOL * w.float().abs().max().item(), (case, name, err)


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_scheduled_backward_matches_plain_version(case):
    q, k, v, mask, out, lse, dout = _backward_inputs(case)
    causal = BACKWARD_CASES[case][5]
    scale = q.shape[-1] ** -0.5
    if q.shape[-1] == tfa.DENSE_HEAD_DIM:          # the fused d = 64 kernel
        got = scheduled_backward_dense(q, k, v, out, lse, dout)
    else:
        got = scheduled_backward(q, k, v, mask, mask, out, lse, dout, causal)
    want = tfa.reference_attention_backward(q, k, v, mask, mask, out, lse, dout, causal, scale)
    _assert_within_grad_tol(got, want, case)


def test_fused_dense_backward_add_orders_agree():
    """The fused kernel's dQ tiles reach the fp32 accumulator in no fixed
    order. Two orders both hold to the plain version, and their dq differ by
    under 1% of max|plain| (chip_smoke.py's DQ_RUN_SPREAD); dk and dv do not
    depend on the order."""
    case = "image tiles S=784 dense d=64 group 1"
    q, k, v, _, out, lse, dout = _backward_inputs(case)
    want = tfa.reference_attention_backward(q, k, v, None, None, out, lse, dout, False)
    first = scheduled_backward_dense(q, k, v, out, lse, dout, order_seed=1)
    second = scheduled_backward_dense(q, k, v, out, lse, dout, order_seed=2)
    for got in (first, second):
        _assert_within_grad_tol(got, want, case)
    spread = (first[0].float() - second[0].float()).abs().max().item()
    assert spread < chip_smoke.DQ_RUN_SPREAD * want[0].float().abs().max().item()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


def test_dq_accumulator_order_is_the_consumer_thread_layout():
    """Thread t of the dQ product's warpgroup holds accumulator registers
    4j .. 4j + 3 = rows 16(t // 32) + (t % 32) // 4 (+ 8 for the last two),
    columns 8j + 2(t % 4) (+ 1 for the odd ones), and stages them as float4
    (j, t) of the tile; the convert reads them back through the same map."""
    order = tfa.dq_accumulator_order()
    seen = torch.zeros(64 * 64, dtype=torch.bool)
    for t in range(128):
        for j in range(8):
            for e in range(4):
                r = 16 * (t // 32) + (t % 32) // 4 + 8 * (e // 2)
                col = 8 * j + 2 * (t % 4) + e % 2
                assert order[r, col].item() == (j * 128 + t) * 4 + e
                seen[(j * 128 + t) * 4 + e] = True
    assert seen.all()
    acc = torch.zeros((1, 1, 2, 4096))
    acc[0, 0, 1, order[5, 9]] = 3.0                      # q tile 1, row 5, column 9
    dq = tfa.reference_bwd_dense_convert(acc, 100, 0.5)
    assert dq.shape == (1, 100, 1, 64) and dq[0, 69, 0, 9].item() == 1.5
    assert dq.float().abs().sum().item() == 1.5


def test_fully_masked_query_rows_stay_finite_only_with_p_zero_for_invisible_pairs():
    """TVG left pads leave query rows with no visible key, whose lse is about
    -1e30. Giving their invisible pairs the masked logit and the exp2-FMA
    leaves the difference of two values near -1.4e30 whose fp32 roundings
    do not cancel: with the plain version's lse, that is +1.5e29, p = inf,
    and inf x dO = 0 makes dv NaN. With p = 0 for invisible pairs every
    gradient is finite, whichever forward produced the lse."""
    q, k, v, mask, out, lse, dout = _backward_inputs("TVG S=256 left pads")
    bad = scheduled_backward(q, k, v, mask, mask, out, lse, dout, invisible_p_zero=False)
    assert not torch.isfinite(bad[2].float()).all()
    out_k, lse_k = scheduled_forward(q, k, v, mask, mask, True)
    for o, l in ((out, lse), (out_k, lse_k)):
        for t in scheduled_backward(q, k, v, mask, mask, o, l, dout):
            assert torch.isfinite(t.float()).all()


def test_backward_bound_counts_every_byte_at_the_vtg_shape():
    """B3 reads q, dO, k, v, lse, delta and the mask and writes dq: ~42.6 MB,
    0.0127 ms at 3.35 TB/s; B4 writes dk, dv instead: ~33.4 MB, 0.0100 ms."""
    traffic = chip_smoke.backward_traffic(4, 448, 28, 4, 128, _vtg_mask(448), _vtg_mask(448))
    dq_bytes, dq_flops = traffic["flash_dq"]
    dkv_bytes, dkv_flops = traffic["flash_dkv"]
    assert dq_bytes == 3 * 12_845_056 + 2 * 1_835_008 + 401_408 + 7_168 == 42_613_760
    assert dkv_bytes == 2 * 12_845_056 + 4 * 1_835_008 + 401_408 + 7_168 == 33_438_720
    assert dkv_flops == pytest.approx(dq_flops * 8 / 6)
    ms, by = chip_smoke.roofline_ms(dq_bytes, dq_flops)
    assert by == "bytes" and ms == pytest.approx(0.01272, abs=1e-5)
    ms, by = chip_smoke.roofline_ms(dkv_bytes, dkv_flops)
    assert by == "bytes" and ms == pytest.approx(0.00998, abs=1e-5)


def test_dense_bounds_at_the_vit_shape():
    """Every pair visible at 8 clips of (3136, 16, 64): B2-lse 4 d flops a
    pair, 3.22e11 (0.3258 ms); flash_dq's count 6 d, 4.83e11 (0.4888 ms),
    flash_dkv's 8 d, 6.45e11 (0.6517 ms) (the bounds of the two kernels
    that the fused d = 64 backward replaced), all bound by operations;
    flash_dq's ~0.26 GB of bytes (q, dO, k, v, lse, delta, dq) would take
    0.078 ms."""
    clips, s, h, d = 8, 3136, 16, 64
    pairs = clips * h * s * s
    ms, by = chip_smoke.vit_attention_bound_ms(clips, s, h, d, with_lse=True)
    assert by == "operations" and ms == pytest.approx(0.3258, abs=1e-4)
    traffic = chip_smoke.backward_traffic(clips, s, h, h, d, None, None, causal=False)
    dq_bytes, dq_flops = traffic["flash_dq"]
    dkv_bytes, dkv_flops = traffic["flash_dkv"]
    assert dq_flops == 6.0 * d * pairs == pytest.approx(4.83e11, rel=1e-3)
    assert dkv_flops == 8.0 * d * pairs == pytest.approx(6.45e11, rel=1e-3)
    one = 2 * clips * s * h * d                   # bf16 q, dO, k, v, dq, dk or dv
    stats = 2 * 4 * clips * h * s                 # fp32 lse and delta, no mask
    assert dq_bytes == 5 * one + stats and dkv_bytes == 6 * one + stats
    assert dq_bytes / chip_smoke.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.078, abs=1e-3)
    for (nbytes, flops), want in ((traffic["flash_dq"], 0.4888), (traffic["flash_dkv"], 0.6517)):
        ms, by = chip_smoke.roofline_ms(nbytes, flops)
        assert by == "operations" and ms == pytest.approx(want, abs=1e-4)
    # causal without masks counts the triangle, as the forward's bound does
    causal = chip_smoke.backward_traffic(1, s, h, h, d, None, None)
    assert causal["flash_dq"][1] == 6.0 * d * h * (s * (s + 1) // 2)


def test_dense_forward_tiles_are_the_kernels():
    """The model's B2 tiles are flash_fwd_dense.cu's: kBK kv rows a tile and
    kConsumers warpgroups of 64 q rows a CTA; 112 divides the ViT's S and the
    image tiles' S, so neither runs a masked kv tile."""
    src = tfa.SOURCES["flash_fwd_dense"].read_text()
    assert f"constexpr int kBK = {tfa.DENSE_KV_TILE};" in src
    assert f"constexpr int kConsumers = {tfa.DENSE_Q_ROWS // 64};" in src
    assert 3136 % tfa.DENSE_KV_TILE == 0 and 784 % tfa.DENSE_KV_TILE == 0


def test_exponential_floor_equals_the_bound_at_d64():
    """B2 at 8 clips of (3136, 16, 64): one exponential a pair, 1.259e9, at
    16 a clock an SM on 132 SMs at the 1.829 GHz that 989 TFLOP/s implies
    (4096 flops a clock an SM) take 0.3258 ms, the same as the tensor-core
    bound of its 4 d = 256 flops a pair; at d 128 a pair's flops double and
    the floor is half the bound."""
    clips, s, h, d = 8, 3136, 16, 64
    n_exp = clips * h * s * s
    assert n_exp == pytest.approx(1.259e9, rel=1e-3)
    clock = chip_smoke.PEAK_BF16_FLOPS / (chip_smoke.SMS * chip_smoke.TENSOR_FLOPS_PER_CLOCK)
    assert clock == pytest.approx(1.829e9, rel=1e-3)
    floor = chip_smoke.exp_floor_ms(n_exp)
    assert floor == pytest.approx(n_exp / (16 * 132 * clock) * 1e3)
    assert floor == pytest.approx(0.3258, abs=1e-4)
    bound, by = chip_smoke.vit_attention_bound_ms(clips, s, h, d)
    assert by == "operations" and floor == pytest.approx(bound, rel=1e-12)
    bound128, _ = chip_smoke.vit_attention_bound_ms(clips, s, h, 128)
    assert floor == pytest.approx(bound128 / 2, rel=1e-12)


def test_fused_dense_backward_bound_at_the_vit_shape():
    """The fused d = 64 backward at 8 clips of (3136, 16, 64): 10 d flops a
    pair (S, dP, dV, dK, dQ), 8.056e11 or 0.8146 ms at 989 TFLOP/s, against
    q, k, v, dO, dq, dk, dv once (7 x 51,380,224 bytes) and the fp32 lse and
    delta (3,211,264): 362,872,832 bytes, 0.108 ms; its two passes are
    bound by bytes."""
    clips, s, h, d = 8, 3136, 16, 64
    nbytes, flops = chip_smoke.backward_traffic(clips, s, h, h, d, None, None,
                                                causal=False)["flash_bwd_dense"]
    assert nbytes == 7 * 51_380_224 + 3_211_264 == 362_872_832
    assert flops == 10.0 * d * clips * h * s * s == pytest.approx(8.056e11, rel=1e-4)
    ms, by = chip_smoke.roofline_ms(nbytes, flops)
    assert by == "operations" and ms == pytest.approx(0.8146, abs=1e-4)
    assert nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.1083, abs=1e-4)
    passes = chip_smoke.dense_pass_traffic(clips, s, h, d)
    acc = 4 * clips * h * 49 * 64 * d                    # S = 3136 is 49 whole q tiles
    assert passes["flash_bwd_dense_prep"][0] == 2 * 51_380_224 + 1_605_632 + acc
    assert passes["flash_bwd_dense_convert"][0] == acc + 51_380_224
    for nbytes, flops in passes.values():
        assert chip_smoke.roofline_ms(nbytes, flops)[1] == "bytes"


def test_editing_the_shared_header_rebuilds_both_libraries(monkeypatch, tmp_path):
    """Every source includes csrc/hopper.cuh: an edit to it must change the
    library path of each, or a stale build would be loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(tfa.CSRC, csrc)
    monkeypatch.setattr(tfa, "SOURCES", {n: csrc / p.name for n, p in tfa.SOURCES.items()})
    before = {n: tfa.library_path(n) for n in tfa.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: tfa.library_path(n) for n in tfa.SOURCES}
    assert all(before[n] != after[n] for n in tfa.SOURCES)
    assert all(after[n].name == f"lib{n}.so" for n in tfa.SOURCES)
