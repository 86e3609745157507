#!/usr/bin/env python3
"""Where the time goes in the port's zero-shot rerank flow, or in its 7B
LoRA train step, on one GPU.

    python3 scripts/profile_torch_flow.py [--train] [--out DIR]

Without --train: runs chip_smoke.py's zero-shot flow (Qwen2-7B in bf16 from
a seed on the card, CPN on, topk 16) once untimed at its WARM_ITEMS, then
once under torch.profiler at its ITEMS, and prints the wall time of each
pass of the flow. With --train: chip_smoke.py's train step (B = 4, caption
budget 96, per-layer recompute, AdamW) for TRAIN_WARM untimed steps, then
TRAIN_STEPS steps timed without the profiler and TRAIN_STEPS under it.
Both print the device-busy share (summed kernel time over wall time; the
work runs on one stream) and the kernels that take the most device time,
grouped by the layer that launches them. With --out, the full kernel table
goes to DIR/profile.txt (DIR/profile_train.txt with --train).
Needs a CUDA GPU and the kernel toolchain, like chip_smoke.py.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# kernel-name fragments -> the layer that launches them
GROUPS = (
    ("flash_fwd (B1 / B1-lse, prefix or train attention forward)", ("flash_fwd",)),
    ("flash_dq (B3, attention backward dq)", ("flash_dq",)),
    ("flash_dkv (B4, attention backward dk, dv)", ("flash_dkv",)),
    ("matrix products (7B linears, LM head, packed attention)",
     ("gemm", "cutlass", "sm90_xmma", "sm80_xmma", "cublas", "nvjet", "matmul")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "cast", "Memcpy", "memcpy", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "fill")),
)


def group_of(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def train_steps(chip_smoke, tr, params, n):
    """n train steps on fresh batches (collated before the clock); wall s."""
    import torch

    batches = [tr["batch"](chip_smoke.TRAIN_B) for _ in range(n)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in batches:
        tr["state"], _ = tr["step"](tr["state"], params, b, tr["vocab"], tr["gen"])
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile the LoRA train step")
    ap.add_argument("--out", help="directory for the full kernel table")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_flow: no CUDA GPU")
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    flow = chip_smoke.setup_flow()
    if args.train:
        tr = chip_smoke.setup_train(flow)
        n = chip_smoke.TRAIN_STEPS
        train_steps(chip_smoke, tr, flow[1], chip_smoke.TRAIN_WARM)
        plain_wall = train_steps(chip_smoke, tr, flow[1], n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = train_steps(chip_smoke, tr, flow[1], n)
    else:
        chip_smoke.run_flow(flow, chip_smoke.WARM_ITEMS)
        timings = {}
        # device activity only: tracing every host-side op as well slows the
        # host enough to change what it measures
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, engine, _, _, wall = chip_smoke.run_flow(flow, chip_smoke.ITEMS, timings)
    kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and e.self_device_time_total > 0),
                     reverse=True)
    busy_s = sum(us for us, _, _ in kernels) / 1e6
    if args.train:
        print(f"[profile] {n} train steps: wall {1e3 * plain_wall / n:.1f} ms/step without the "
              f"profiler, {1e3 * wall / n:.1f} ms/step under it, device busy "
              f"{1e3 * busy_s / n:.1f} ms/step ({100 * busy_s / wall:.1f}% of the profiled "
              f"wall) [{card}]")
    else:
        print(f"[profile] {chip_smoke.ITEMS} queries, topk {chip_smoke.TOPK}: wall {wall:.3f}s "
              f"under the profiler, device busy {busy_s:.3f}s ({100 * busy_s / wall:.1f}%), "
              f"{engine.steps} steps [{card}]")
        prev = 0.0
        for name, t in sorted(timings.items(), key=lambda kv: kv[1]):
            print(f"[profile]   pass {name:<12} ends at {t:.3f}s (+{t - prev:.3f}s)")
            prev = t
    by_group = {}
    for us, _, name in kernels:
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + us
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {100 * us / 1e6 / busy_s:5.1f}%  {us / 1e6:8.3f}s  {label}")
    for us, count, name in kernels[:12]:
        print(f"[profile]   kernel {us / 1e3:9.1f} ms  x{count:<6d} {name[:110]}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / ("profile_train.txt" if args.train else "profile.txt")).write_text(
            f"{card}\n" + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
