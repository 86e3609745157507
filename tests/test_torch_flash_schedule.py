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

`scheduled_backward` models flash_bwd.cu the same way: flash_dq's 128-row q
tiles against 64-row kv tiles up to the causal diagonal, flash_dkv's 128-row
kv tiles against 64-row q tiles from it, both zero-filled beyond S; the
exponentials as exp2 of one FMA of the unscaled score with scale * log2(e)
and lse * log2(e) (fp64); invisible pairs given p = 0; P and dS rounded to
bf16 before their products; each cluster rank's partial dK, dV over its q
heads of the GQA group, summed in rank order. It is held to
`reference_attention_backward` with chip_smoke.py's GRAD_TOL.
"""

import math

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

    heads = torch.arange(hq)
    dq = torch.zeros((b, hq, sp, d))
    for qt in range(sp // DQ_ROWS):
        rows = torch.arange(qt * DQ_ROWS, (qt + 1) * DQ_ROWS)
        n_kv = -(-s // DQ_KV)
        for kt in range(min(2 * qt + 2, n_kv) if causal else n_kv):
            cols = torch.arange(kt * DQ_KV, (kt + 1) * DQ_KV)
            _, ds = p_and_ds(heads, heads // grp, rows, cols)
            dq[:, :, rows] += ds.to(torch.bfloat16).float() @ kf[:, heads // grp][:, :, cols]

    cl = _cluster_size(grp)
    dk = torch.zeros((b, hkv, sp, d))
    dv = torch.zeros((b, hkv, sp, d))
    for kt in range(sp // DKV_ROWS):
        cols = torch.arange(kt * DKV_ROWS, (kt + 1) * DKV_ROWS)
        j0 = 2 * kt if causal else 0
        parts = []
        for rank in range(cl):                          # one CTA of the cluster each
            pk = torch.zeros((b, hkv, DKV_ROWS, d))
            pv = torch.zeros((b, hkv, DKV_ROWS, d))
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


# name -> (B, S, Hq, Hkv, mask maker): the train step's backward shapes with
# one kv head's worth of the 7B's GQA group of 7 (Hq 14, Hkv 2), and the
# forward's other masks; one case at a group of 4 (a cluster of 4)
BACKWARD_CASES = {
    "VTG S=448 right pads": (4, 448, 14, 2, lambda rng: _vtg_mask(448)),
    "TVG S=256 left pads": (4, 256, 14, 2, lambda rng: _tvg_mask(256)),
    "S=341 CPN holes": (4, 341, 14, 2, lambda rng: _holes_mask(rng, 4, 341)),
    "S=341 dense causal": (2, 341, 14, 2, lambda rng: None),
    "S=200 right pads": (2, 200, 14, 2, lambda rng: _vtg_mask(200)[:2]),
    "S=200 right pads group 4": (2, 200, 8, 2, lambda rng: _vtg_mask(200)[:2]),
}


def _backward_inputs(case):
    b, s, hq, hkv, make_mask = BACKWARD_CASES[case]
    rng = np.random.default_rng(100 + sorted(BACKWARD_CASES).index(case))
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k, v, dout = t(b, s, hq, 128), t(b, s, hkv, 128), t(b, s, hkv, 128), t(b, s, hq, 128)
    mask = make_mask(rng)
    out, lse = tfa.reference_attention_lse(q, k, v, mask, mask, True, 128 ** -0.5)
    return q, k, v, mask, out, lse, dout


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_scheduled_backward_matches_plain_version(case):
    q, k, v, mask, out, lse, dout = _backward_inputs(case)
    got = scheduled_backward(q, k, v, mask, mask, out, lse, dout)
    want = tfa.reference_attention_backward(q, k, v, mask, mask, out, lse, dout, True, 128 ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (case, name)
        assert torch.isfinite(g.float()).all(), (case, name)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_TOL * w.float().abs().max().item(), (case, name, err)


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


def test_editing_the_shared_header_rebuilds_both_libraries(monkeypatch, tmp_path):
    """Both sources include csrc/hopper.cuh: an edit to it must change the
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
