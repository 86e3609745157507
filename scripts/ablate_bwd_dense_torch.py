#!/usr/bin/env python
"""What sets the pace of the fused d = 64 attention backward
(blim_tpu_torch/kernels/csrc/flash_bwd_dense.cu): the kernel timed as built
and with one part of its work taken out at a time.

    python scripts/ablate_bwd_dense_torch.py [--clips 8] [--rounds 2]

Each variant is the kernel's source with the edits listed in VARIANTS,
built with the port's nvcc flags into blim_tpu_torch/_build/ and timed
through its C entry point, replayed from a CUDA graph, at CLIPS clips of the
UMT ViT-L's (3136, 16, 64) with q, k, v strided views of one packed qkv (the
tower's shape). Only the kernel as built computes the gradient, and only it
is held to the plain version (within chip_smoke.GRAD_TOL x max|plain|): the
other variants are timing probes whose results are wrong by design. The
variants run in turns, `rounds` times, all in one process on one card; the
card's name and power limit head the output. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> [(text in the kernel's source, its replacement)]
VARIANTS = {
    "as built": [],
    "no dQ reduction": [
        ("        bulk_reduce_add_f32(acc + (long long)it * kTileFloats, stage, kTileFloats * 4);\n",
         ""),
    ],
    "no dQ product": [
        ("        wgmma_ss_n64_mnmajor(dq, desc_mnmajor(ds_smem, kk), desc_mnmajor(k_smem, kk), "
         "kk > 0);\n", ""),
    ],
    "no dQ product, no reduction": [
        ("        bulk_reduce_add_f32(acc + (long long)it * kTileFloats, stage, kTileFloats * 4);\n",
         ""),
        ("        wgmma_ss_n64_mnmajor(dq, desc_mnmajor(ds_smem, kk), desc_mnmajor(k_smem, kk), "
         "kk > 0);\n", ""),
    ],
    "no exponentials": [("fast_exp2(fmaf(", "(fmaf(")],
    "no barriers between the consumers": [
        ("      named_bar_sync(kBarDsFull + buf, 256);\n", ""),
        ("      named_bar_arrive(kBarDsFull + buf, 256);\n", ""),
        ("    if (!owner && it >= 2) named_bar_sync(kBarDsFree + buf, 256);\n", ""),
        ("      if (it + 2 < n_q) named_bar_arrive(kBarDsFree + buf, 256);\n", ""),
    ],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"the kernel's source no longer holds this line once: {old!r}")
        text = text.replace(old, new)
    return text


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from blim_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    source = fa.SOURCES["flash_bwd_dense"]
    text = source.read_text()
    libs = {}
    for name, edits in VARIANTS.items():
        folder = fa.BUILD_ROOT / "ablate" / name.replace(" ", "_").replace(",", "")
        folder.mkdir(parents=True, exist_ok=True)
        for header in source.parent.glob("*.cuh"):
            (folder / header.name).write_text(header.read_text())
        (folder / source.name).write_text(variant_source(text, edits))
        fa.SOURCES["flash_bwd_dense"] = folder / source.name
        fa._libs.pop("flash_bwd_dense", None)
        fa.build(("flash_bwd_dense",))
        libs[name] = fa._library("flash_bwd_dense")
    fa.SOURCES["flash_bwd_dense"] = source

    gen = torch.Generator(device="cuda").manual_seed(5)
    s, h, d = 3136, 16, 64
    qkv = torch.randn((args.clips, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn((args.clips, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    out, lse = fa.reference_attention_lse(q, k, v, None, None, False, d ** -0.5)
    bound, bound_by = cs.roofline_ms(*cs.backward_traffic(args.clips, s, h, h, d, None, None,
                                                          causal=False)["flash_bwd_dense"])
    times = {name: [] for name in VARIANTS}
    for _ in range(args.rounds):
        for name in VARIANTS:
            fa._libs["flash_bwd_dense"] = libs[name]
            dq, dk, dv, _, _, prep, fused, convert = cs.raw_bwd_dense(q, k, v, dout, out, lse)
            if name == "as built" and not times[name]:
                prep()
                fused()
                convert()
                torch.cuda.synchronize()
                want = fa.reference_attention_backward(q, k, v, None, None, out, lse, dout,
                                                       False, d ** -0.5)
                for gname, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                    gap = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                    if gap > cs.GRAD_TOL:
                        raise SystemExit(f"{gname}: the kernel as built is off its plain version "
                                         f"({gap:.3e} of max|plain|)")
                del want
            prep()
            times[name].append(cs.graph_time_ms(fused, iters=10, replays=2))
    base = min(times["as built"])
    print(f"fused d = 64 backward at {args.clips} clips of ({s}, {h}, {d}), raw entry point in a "
          f"CUDA graph, bound {bound:.4f} ms ({bound_by}) [{card}]")
    for name, ts in times.items():
        best = min(ts)
        print(f"  {name:36s} {', '.join(f'{t:.4f}' for t in ts)} ms; best {best:.4f} "
              f"({100 * (best - base) / base:+.1f}% against as built)")


if __name__ == "__main__":
    main()
