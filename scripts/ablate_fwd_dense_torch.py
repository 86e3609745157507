#!/usr/bin/env python
"""What sets the pace of the d = 64 dense attention forward
(blim_tpu_torch/kernels/csrc/flash_fwd_dense.cu, B2): the kernel timed as
built and with one part of its design or its work taken out at a time.

    python scripts/ablate_fwd_dense_torch.py [--clips 8] [--seq 3136] [--rounds 2]

Each variant is the kernel's source with the edits listed in VARIANTS
(each edit names how many times its text occurs in the source), built by
scripts/ablation_torch.py (one nvcc per variant, all at once; each variant's
ptxas spills and any wgmma serialization are printed), and timed through
its C entry point, replayed from a CUDA graph, at CLIPS clips of (SEQ, 16,
64) with q, k, v strided views of one packed qkv (the tower's shape). Only
the kernel as built is held to the plain version (out within
chip_smoke.ATTN_ATOL + ATTN_RTOL |plain|); the other variants are timing
probes whose results may be wrong by design. The variants run in turns,
`rounds` times, all in one process on one card; the card's name and power
limit head the output. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse

import ablation_torch as ab

# name -> [(text in the kernel's source, its replacement, times it occurs)]
VARIANTS = {
    "as built": [],
    "no turn-taking barriers": [("named_bar_sync(mine, 256);", ";", 4),
                                ("named_bar_arrive(next, 256);", ";", 4)],
    "idle consumers run the products": [("const bool active = q0 + 64 * wg < S;",
                                         "const bool active = true;", 1)],
    "no early QK^T (wait for both products)": [("    wgmma_wait<1>();\n",
                                                "    wgmma_wait<0>();\n", 1)],
    "2 consumers (128 q rows a CTA)": [("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;", 1),
                                       ("constexpr int kProducerRegs = 32;", "constexpr int kProducerRegs = 24;", 1),
                                       ("constexpr int kConsumerRegs = 160;", "constexpr int kConsumerRegs = 240;", 1)],
    "kv tile 128": [("constexpr int kBK = 112;", "constexpr int kBK = 128;", 1),
                    ("wgmma_ss_n112(", "wgmma_ss_n128(", 1)],
    "no exponentials (SFU)": [("fast_exp2(fmaf(", "(fmaf(", 4)],
    "no P V product": [("    wgmma_rs_n64(o, a, desc_mnmajor(v_tile, kk));\n", "", 1)],
    "no K/V loads after the rings' first pass": [
        ("          mbar_expect_tx(&sm.full_k[st], kTileBytes);\n"
         "          tma_load(sm.k[st], &tm_k, &sm.full_k[st], 0, j * kBK, kvh, b);\n",
         "          mbar_expect_tx(&sm.full_k[st], j < kStages ? kTileBytes : 0);\n"
         "          if (j < kStages) tma_load(sm.k[st], &tm_k, &sm.full_k[st], 0, j * kBK, kvh, b);\n",
         1),
        ("          mbar_expect_tx(&sm.full_v[st], kTileBytes);\n"
         "          tma_load(sm.v[st], &tm_v, &sm.full_v[st], 0, jv * kBK, kvh, b);\n",
         "          mbar_expect_tx(&sm.full_v[st], jv < kStages ? kTileBytes : 0);\n"
         "          if (jv < kStages) tma_load(sm.v[st], &tm_v, &sm.full_v[st], 0, jv * kBK, kvh, b);\n",
         1)],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--seq", type=int, default=3136)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from blim_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = ab.card()
    libs = ab.build_variants("flash_fwd_dense", VARIANTS)

    gen = torch.Generator(device="cuda").manual_seed(5)
    s, h, d = args.seq, 16, 64
    scale = d ** -0.5
    qkv = torch.randn((args.clips, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bound, bound_by = cs.vit_attention_bound_ms(args.clips, s, h, d)
    floor = cs.exp_floor_ms(args.clips * h * s * s)
    times = {name: [] for name in VARIANTS}
    for _ in range(args.rounds):
        for name in VARIANTS:
            fa._libs["flash_fwd_dense"] = libs[name]
            out, _, call = fa._dense_forward_call(q, k, v, False, scale)
            run = cs.checked(call, "flash_fwd_dense", libs[name].blim_flash_fwd_dense_error_string)
            if name == "as built" and not times[name]:
                run()
                torch.cuda.synchronize()
                want = fa.reference_attention(q, k, v, None, None, False, scale)
                excess = ((out.float() - want.float()).abs()
                          - cs.ATTN_RTOL * want.float().abs()).max().item()
                if excess > cs.ATTN_ATOL:
                    raise SystemExit(f"the kernel as built is off its plain version (excess "
                                     f"{excess:.3e} over {cs.ATTN_RTOL}|plain|)")
                del want
            times[name].append(cs.graph_time_ms(run, iters=10, replays=2))
    ab.print_times(f"flash_fwd_dense (B2) at {args.clips} clips of ({s}, {h}, {d}), raw entry "
                   f"point in a CUDA graph, bound {bound:.4f} ms ({bound_by}), exponential floor "
                   f"{floor:.4f} ms [{card}]", times)


if __name__ == "__main__":
    main()
