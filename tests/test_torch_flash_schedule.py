"""The arithmetic of flash_fwd.cu's Hopper design, tile by tile on the CPU,
against the plain versions it is held to on the card.

`scheduled_forward` below is a model of the kernel, not a part of the port:
128-row q tiles (two warpgroups of 64 rows, whose rows are independent) and
128-row KV tiles, zero-filled beyond S as TMA returns them; KV tiles wholly
above the causal diagonal skipped; the diagonal tile, the ragged last tile
and (with a key mask) every tile masked by position and key bits with the
kernel's masked logit, the power of two nearest -1e30 in the scaled-logit
domain, in unscaled units; the running max kept in unscaled scores; the
exponentials as exp2 of one fused multiply-add with scale * log2(e) folded
in (the exact product, then one rounding: modelled in fp64); P rounded to
bf16 per tile before P.V, l summed from the fp32 P; O / max(l, 1e-30) times
the query mask; lse = m * scale + log(max(l, 1e-30)).

It runs at the main paths' masks and shapes, held to
`reference_attention` and `reference_attention_lse` with chip_smoke.py's own
tolerances (output |d| <= ATTN_ATOL + ATTN_RTOL |plain|; lse |d| <= LSE_TOL on
rows with query mask 1), so a tiling or rounding choice that would break
chip_smoke.py's phases 2, 5 or 8 shows here first.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_ATOL, ATTN_RTOL, LSE_TOL
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import reference_attention

BQ = BK = 128                 # q rows per CTA, kv rows per tile
LOG2E = 1.4426950408889634


def _f32(x: float) -> float:
    return float(np.float32(x))


def scheduled_forward(q, k, v, key_mask=None, query_mask=None, causal=True, scale=None):
    """flash_fwd.cu's forward, modelled tile by tile: (out bf16, lse fp32)."""
    b, s, hq, d = q.shape
    grp = hq // k.shape[2]
    scale = _f32(d ** -0.5 if scale is None else scale)
    c = _f32(scale * _f32(LOG2E))                       # scale_log2, one fp32 product
    neg = -math.ldexp(1.0, round(math.log2(_f32(1e30 / scale))))
    n_kv = -(-s // BK)
    pad = n_kv * BK - s
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))   # TMA's zero fill
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kp = kp.repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)      # (B, Hq, S', d)
    vp = vp.repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)
    qf = q.float().permute(0, 2, 1, 3)                              # (B, Hq, S, d)
    kbits = torch.ones((b, n_kv * BK), dtype=torch.bool)
    kbits[:, s:] = False
    if key_mask is not None:
        kbits[:, :s] &= key_mask.bool()
    out = torch.zeros((b, hq, s, d))
    lse = torch.zeros((b, hq, s))
    for qt in range(-(-s // BQ)):
        rows = torch.arange(qt * BQ, min(s, (qt + 1) * BQ))
        m = torch.full((b, hq, len(rows)), neg)
        l = torch.zeros((b, hq, len(rows)))
        o = torch.zeros((b, hq, len(rows), d))
        for kt in range(min(qt + 1, n_kv) if causal else n_kv):
            cols = torch.arange(kt * BK, (kt + 1) * BK)
            sc = qf[:, :, rows] @ kp[:, :, cols].transpose(-1, -2)   # unscaled fp32 scores
            diag = causal and kt == qt
            if key_mask is not None or diag or (kt + 1) * BK > s:
                vis = kbits[:, None, None, cols]
                if diag:
                    vis = vis & (cols[None, :] <= rows[:, None])[None, None]
                sc = sc.masked_fill(~vis, neg)
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - mx) * c)
            mb = (mx * c).float()                               # rounded to fp32
            p = torch.exp2(sc.double() * c - mb.double()[..., None]).float()
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vp[:, :, cols]
            m = mx
        keep = torch.ones((b, 1, len(rows), 1)) if query_mask is None else \
            query_mask[:, rows].float()[:, None, :, None]
        lc = l.clamp_min(1e-30)
        out[:, :, rows] = o / lc[..., None] * keep
        lse[:, :, rows] = m * scale + torch.log(lc)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16), lse


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


def _holes_mask(rng, b, s):
    m = np.ones((b, s), np.int32)
    m[:, s - 9:] = 0
    m[:, 14:270] = 0                      # a CPN-masked video block
    m &= (rng.random((b, s)) > 0.1).astype(np.int32)
    m[:, 0] = 1
    return torch.from_numpy(m)


# name -> (B, S, Hq, Hkv, d, causal, mask maker): the main paths' shapes with
# fewer heads (the GQA group of 4 kept); B2 at one clip and one head
CASES = {
    "B1 S=341 right pads": (4, 341, 8, 2, 128, True, lambda rng: _vtg_mask(341)),
    "B1 S=341 CPN holes": (4, 341, 8, 2, 128, True, lambda rng: _holes_mask(rng, 4, 341)),
    "B1 S=85 prior prefix": (1, 85, 8, 2, 128, True, lambda rng: torch.ones((1, 85), dtype=torch.int32)),
    "B1 S=341 dense causal": (2, 341, 8, 2, 128, True, lambda rng: None),
    "B1-lse VTG S=448 right pads": (4, 448, 8, 2, 128, True, lambda rng: _vtg_mask(448)),
    "B1-lse TVG S=256 left pads": (4, 256, 8, 2, 128, True, lambda rng: _tvg_mask(256)),
    "B2 S=3136 dense d=64": (1, 3136, 1, 1, 64, False, lambda rng: None),
}


def _inputs(case):
    b, s, hq, hkv, d, causal, make_mask = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)  # noqa: E731
    return t(b, s, hq, d), t(b, s, hkv, d), t(b, s, hkv, d), make_mask(rng), causal


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_plain_versions(case):
    q, k, v, mask, causal = _inputs(case)
    scale = q.shape[-1] ** -0.5
    out, lse = scheduled_forward(q, k, v, mask, mask, causal, scale)
    ref, ref_lse = tfa.reference_attention_lse(q, k, v, mask, mask, causal, scale)
    assert torch.equal(ref, reference_attention(q, k, v, mask, mask, causal, scale))
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    excess = ((out.float() - ref.float()).abs() - ATTN_RTOL * ref.float().abs()).max().item()
    assert excess <= ATTN_ATOL, case
    rows = torch.ones(lse.shape, dtype=torch.bool) if mask is None else \
        mask.bool()[:, None, :].expand(lse.shape)
    assert (lse - ref_lse)[rows].abs().max().item() <= LSE_TOL, case


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
