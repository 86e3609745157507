#!/usr/bin/env python
"""What sets the pace of the d = 128 attention forward
(blim_tpu_torch/kernels/csrc/flash_fwd.cu, B1): the kernel timed as built
and with one part of its design or its work taken out at a time, at the
chat's prefill and at the zero-shot rerank's packs.

    python scripts/ablate_fwd_torch.py [--seq 8381] [--rounds 2]

Each variant is the kernel's source with the edits listed in VARIANTS
(each edit names how many times its text occurs in the source), built by
scripts/ablation_torch.py (one nvcc per variant, all at once; each variant's
ptxas spills and any wgmma serialization are printed), and timed through
its C entry point, replayed from a CUDA graph, in the causal masked mode at
two shapes of 28 q heads on 4 KV heads: (1, SEQ) under an all-ones mask
(the chat's prefill: `generate_tokens` passes its attention mask) and (4,
341) under chip_smoke.py's CPN-holes mask (phase 2's record). SDPA's causal
forward on the same q, k, v is timed beside, as a yardstick. Only the kernel
as built is held to the plain version (out within chip_smoke.ATTN_ATOL +
ATTN_RTOL |plain|); the other variants are timing probes whose results may
be wrong by design. The variants run in turns, `rounds` times, all in one
process on one card; the card's name and power limit head the output.
Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse

import ablation_torch as ab

# name -> [(text in the kernel's source, its replacement, times it occurs)]
VARIANTS = {
    "as built": [],
    "no turn-taking barriers": [("named_bar_sync(mine, 256);", ";", 4),
                                ("named_bar_arrive(next, 256);", ";", 4)],
    "no early QK^T (wait for both products)": [("    wgmma_wait<1>();\n",
                                                "    wgmma_wait<0>();\n", 1)],
    "every tile masked (the former rule)": [("} else if (kMasked && hole) {", "} else if (kMasked) {", 1)],
    "3-buffer K and V rings": [("constexpr int kStages = 2;", "constexpr int kStages = 3;", 1)],
    "no exponentials (SFU)": [("fast_exp2(fmaf(", "(fmaf(", 4)],
    "no P V product": [("    wgmma_rs_n128(o, a, desc_mnmajor2(v_tile, kk, kBK * 128));\n", "", 1)],
    "no K/V loads after the rings' first pass": [
        ("mbar_expect_tx(&sm.full_k[st], kTileBytes);",
         "mbar_expect_tx(&sm.full_k[st], j < kStages ? kTileBytes : 0);", 1),
        ("for (int hf = 0; hf < kHalves; ++hf)\n              tma_load(sm.k[st][hf]",
         "for (int hf = 0; hf < kHalves && j < kStages; ++hf)\n              tma_load(sm.k[st][hf]", 1),
        ("mbar_expect_tx(&sm.full_v[st], kTileBytes);",
         "mbar_expect_tx(&sm.full_v[st], jv < kStages ? kTileBytes : 0);", 1),
        ("for (int hf = 0; hf < kHalves; ++hf)\n              tma_load(sm.v[st][hf]",
         "for (int hf = 0; hf < kHalves && jv < kStages; ++hf)\n              tma_load(sm.v[st][hf]", 1)],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=8381)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from blim_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = ab.card()
    libs = ab.build_variants("flash_fwd", VARIANTS)

    gen = torch.Generator(device="cuda").manual_seed(7)
    hq, hkv, d = 28, 4, 128
    scale = d ** -0.5
    holes = torch.ones((4, 341), dtype=torch.int32, device="cuda")
    holes[:, 341 - 9:] = 0
    holes[:, 14:270] = 0                  # a CPN-masked video block
    holes &= (torch.rand((4, 341), generator=gen, device="cuda") > 0.1).int()
    holes[:, 0] = 1
    shapes = {f"(1, {args.seq}) all-ones mask": torch.ones((1, args.seq), dtype=torch.int32,
                                                           device="cuda"),
              "(4, 341) CPN holes": holes}
    for label, mask in shapes.items():
        b, s = mask.shape
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        iters, replays = (10, 2) if s > 1024 else (20, 5)
        times = {name: [] for name in VARIANTS}
        sdpa = []
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        idx = torch.arange(s, device="cuda")
        allowed = (idx[:, None] >= idx[None, :])[None, None] & mask.bool()[:, None, None, :]
        # with no key masked, SDPA's causal flag (as chip_smoke.chat_kernel_b1 times it)
        sdpa_mask = dict(is_causal=True) if bool(mask.all()) else dict(attn_mask=allowed)
        for _ in range(args.rounds):
            for name in VARIANTS:
                fa._libs["flash_fwd"] = libs[name]
                run = cs.raw_fwd(q, k, v, mask)
                if name == "as built" and not times[name]:
                    run()
                    torch.cuda.synchronize()
                    out = run.operands[3]
                    want = fa.reference_attention(q, k, v, mask, mask, True, scale)
                    excess = ((out.float() - want.float()).abs()
                              - cs.ATTN_RTOL * want.float().abs()).max().item()
                    del want
                    if excess > cs.ATTN_ATOL:
                        raise SystemExit(f"{label}: the kernel as built is off its plain version "
                                         f"(excess {excess:.3e} over {cs.ATTN_RTOL}|plain|)")
                times[name].append(cs.graph_time_ms(run, iters=iters, replays=replays))
            sdpa.append(cs.graph_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa_mask), iters=iters, replays=replays))
        bound, bound_by = cs.attention_bound_ms(b, s, hq, hkv, d, mask, mask)
        floor = cs.exp_floor_ms(hq * cs.pairs_visible(mask, mask))
        ab.print_times(f"flash_fwd (B1) at {label}, ({b}, {s}, {hq} / {hkv}, {d}) causal, raw "
                       f"entry point in a CUDA graph, bound {bound:.4f} ms ({bound_by}), "
                       f"exponential floor {floor:.4f} ms; sdpa "
                       f"{', '.join(f'{t:.4f}' for t in sdpa)} ms [{card}]", times)
        del q, k, v, qt, kt, vt, allowed, sdpa_mask


if __name__ == "__main__":
    main()
