#!/usr/bin/env python3
"""Where the time goes in the port's zero-shot rerank flow, its 7B LoRA
train step, or its video featurizer, on one GPU.

    python3 scripts/profile_torch_flow.py [--train | --extract] [--out DIR]

Without --train: runs chip_smoke.py's zero-shot flow (Qwen2-7B in bf16 from
a seed on the card, CPN on, topk 16) once untimed at its WARM_ITEMS, then
once under torch.profiler at its ITEMS, and prints the wall time of each
pass of the flow. With --train: chip_smoke.py's train step (B = 4, caption
budget 96, per-layer recompute, AdamW) for TRAIN_WARM untimed steps, then
TRAIN_STEPS steps timed without the profiler and TRAIN_STEPS under it.
With --extract: the UMT ViT-L + ToMe featurizer at chip_smoke.py's
EXTRACT_B videos with on-card preprocessing of raw FRAME_HW uint8 frames
(so the resize runs), one untimed batch, then EXTRACT_TIMED batches timed
without the profiler and EXTRACT_TIMED under it; the resize and ToMe alone
are timed with CUDA events besides, since their matrix products share
kernel names with the tower's; then chip_smoke.py's end-to-end extraction
(run_extraction over E2E_VIDEOS videos at E2E_B, decode and saves
included) runs once untimed and once under the profiler, for its wall and
device-busy share. All print the device-busy share (summed
kernel time over wall time; the work runs on one stream) and the kernels
that take the most device time, grouped by the layer that launches them.
With --out, the full kernel table goes to DIR/profile.txt
(profile_train.txt, profile_extract.txt).
Needs a CUDA GPU and the kernel toolchain, like chip_smoke.py.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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


# the featurizer's kernel groups
EXTRACT_GROUPS = (
    ("flash_fwd_dense (B2, ViT attention)", ("flash_fwd",)),
    ("matrix products (ViT linears, patch embed, ToMe similarity, resize)",
     ("gemm", "cutlass", "sm90_xmma", "sm80_xmma", "cublas", "nvjet", "matmul")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GELU", ("gelu", "Gelu")),
    ("ToMe sort, gather, index_add", ("sort", "Sort", "radix", "gather", "index", "scatter")),
    ("reductions (ToMe means, norms, max)", ("reduce",)),
    ("copies and casts", ("copy", "cast", "Memcpy", "memcpy", "cat")),
    ("elementwise (residual adds, normalise, bias, rescale)",
     ("elementwise", "vectorized", "unrolled", "where", "fill")),
)


def group_of(name: str, groups=GROUPS) -> str:
    for label, keys in groups:
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


def featurizer_setup(chip_smoke):
    """The full-width ViT-L tower in bf16 from SEED on the card, its
    device-preprocess featurizer, and EXTRACT_TIMED + 1 batches of raw
    uint8 frames (EXTRACT_B videos each) already on the card."""
    import torch

    from blim_tpu_torch.checkpoints.convert import init_vision_tower
    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.pipelines.extract import make_featurizer

    cfg = ModelConfig()
    vit = init_vision_tower(cfg.vision, seed=chip_smoke.SEED, dtype=torch.bfloat16,
                            device="cuda")
    feat = make_featurizer(vit, cfg, device="cuda", device_preprocess=True)
    paths = [f"synthetic_{i:03d}" for i in range(chip_smoke.EXTRACT_B)]
    frames = np.stack([chip_smoke.synthetic_frames(p) for p in paths])
    frames = frames.reshape(len(paths), cfg.num_clips, cfg.mm_local_num_frames,
                            *frames.shape[2:])
    batches = [torch.from_numpy(np.roll(frames, i, axis=0)).cuda()
               for i in range(chip_smoke.EXTRACT_TIMED + 1)]
    return cfg, vit, feat, batches


def featurize_all(feat, batches):
    """Featurize the batches back to back, as the pipeline does; wall s."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = [feat(b) for b in batches]
    outs[-1].cpu()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def part_times_ms(chip_smoke, cfg, batch):
    """Device ms per batch of the on-card resize and of ToMe alone (CUDA
    events), on this batch and on a tower output of its shape."""
    import torch

    from blim_tpu_torch.models.projector import compress_clip_tokens
    from blim_tpu_torch.pipelines.extract import device_resize

    x = batch.float()
    resize_ms = chip_smoke.gpu_time_ms(lambda: device_resize(x, cfg.vision.image_size), iters=5)
    clips = batch.shape[0] * batch.shape[1]
    tokens = cfg.vision.num_frames * cfg.vision.patches_per_frame
    feats = torch.randn((clips, tokens, cfg.mm_hidden_size), device="cuda", dtype=torch.bfloat16)
    tome_ms = chip_smoke.gpu_time_ms(lambda: compress_clip_tokens(
        feats, cfg.tokens_per_frame, cfg.mm_local_num_frames, cfg.vision.num_attention_heads),
        iters=5)
    return resize_ms, tome_ms


def end_to_end_busy(chip_smoke, cfg, vit):
    """chip_smoke.py's end-to-end extraction (decode, featurize, save) once
    untimed, then once under the profiler; returns (videos, wall s, device
    busy s) of the profiled run."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as out_dir:
        chip_smoke.end_to_end_extraction(vit, cfg, out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n_ok, wall = chip_smoke.end_to_end_extraction(vit, cfg, out_dir)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    return n_ok, wall, busy_us / 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile the LoRA train step")
    mode.add_argument("--extract", action="store_true", help="profile the video featurizer")
    ap.add_argument("--out", help="directory for the full kernel table")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_flow: no CUDA GPU")
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    groups = GROUPS
    if args.extract:
        groups = EXTRACT_GROUPS
        cfg, vit, feat, batches = featurizer_setup(chip_smoke)
        n = len(batches) - 1
        featurize_all(feat, batches[:1])
        plain_wall = featurize_all(feat, batches[1:])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = featurize_all(feat, batches[1:])
        resize_ms, tome_ms = part_times_ms(chip_smoke, cfg, batches[0])
        e2e = end_to_end_busy(chip_smoke, cfg, vit)
    elif args.train:
        flow = chip_smoke.setup_flow()
        tr = chip_smoke.setup_train(flow)
        n = chip_smoke.TRAIN_STEPS
        train_steps(chip_smoke, tr, flow[1], chip_smoke.TRAIN_WARM)
        plain_wall = train_steps(chip_smoke, tr, flow[1], n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = train_steps(chip_smoke, tr, flow[1], n)
    else:
        flow = chip_smoke.setup_flow()
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
    if args.extract:
        b = chip_smoke.EXTRACT_B
        print(f"[profile] featurizer, {n} batches of {b} videos ({b * cfg.num_clips} clips), "
              f"raw {chip_smoke.FRAME_HW[0]}x{chip_smoke.FRAME_HW[1]} uint8 frames resized on the "
              f"card: wall {1e3 * plain_wall / n:.1f} ms/batch without the profiler "
              f"({b * n / plain_wall:.3f} videos/s), {1e3 * wall / n:.1f} ms/batch under it, "
              f"device busy {1e3 * busy_s / n:.1f} ms/batch ({100 * busy_s / wall:.1f}% of the "
              f"profiled wall) [{card}]")
        print(f"[profile]   alone (CUDA events): on-card resize {resize_ms:.1f} ms/batch, ToMe "
              f"{tome_ms:.1f} ms/batch [{card}]")
        n_ok, e2e_wall, e2e_busy = e2e
        print(f"[profile] end to end (run_extraction, {n_ok} videos at B={chip_smoke.E2E_B}, "
              f"4 decode threads, saves included): wall {e2e_wall:.3f}s under the profiler "
              f"({n_ok / e2e_wall:.3f} videos/s), device busy {e2e_busy:.3f}s "
              f"({100 * e2e_busy / e2e_wall:.1f}%) [{card}]")
    elif args.train:
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
        label = group_of(name, groups)
        by_group[label] = by_group.get(label, 0.0) + us
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {100 * us / 1e6 / busy_s:5.1f}%  {us / 1e6:8.3f}s  {label}")
    for us, count, name in kernels[:12]:
        print(f"[profile]   kernel {us / 1e3:9.1f} ms  x{count:<6d} {name[:110]}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        name = ("profile_train.txt" if args.train else "profile_extract.txt" if args.extract
                else "profile.txt")
        (out / name).write_text(
            f"{card}\n" + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
