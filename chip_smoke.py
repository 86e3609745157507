#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (all numbers beside the card's name and power limit):
  1. build    compile every hand-written kernel from the checkout's sources
              (nvcc, sm_90a, one process per source, all at once) and print
              each kernel's registers, spills and shared memory;
  2. kernels  hold B1 (flash_fwd, inference) to its plain PyTorch version
              at the zero-shot path's shapes, and time kernel, plain
              version, one PyTorch library call of the same function
              (yardstick only) and the card's bound for the same work;
              the forward kernels (through their C entry point) and the
              library calls are timed from CUDA graphs, so host work
              between launches does not pace them; the Python wrapper's
              time is printed beside;
  3. slice    the zero-shot rerank flow (CPN priors + packed VTG scoring) at
              Qwen2-7B width and depth in bf16 with seeded random weights
              and synthetic inputs: untimed at WARM_ITEMS, timed at ITEMS;
              the kernel launch counts of the timed run must match the path;
  4. packed   packed shared-prefix scores against the naive full-sequence
              path on the card;
  5. train-kernels  B1-lse, B3 (flash_dq) and B4 (flash_dkv) against their
              plain versions at the train step's VTG and TVG shapes, timed
              like phase 2 (library yardstick: SDPA forward, and SDPA's
              backward for dq + dk + dv together);
  6. train    the 7B LoRA train step (VTG + TVG losses, backward through the
              frozen 7B with per-layer recompute, AdamW) on phase 3's
              weights: TRAIN_WARM untimed steps, then TRAIN_STEPS timed
              ones whose launch counts must match the path;
  7. gradcheck  at full width and GRADCHECK_LAYERS layers, the loss and the
              LoRA gradients through the kernels against the same step
              through the plain attention;
  8. vit-kernel  B2 (flash_fwd_dense, d = 64, dense non-causal) against its
              plain version at VIT_CLIPS clips of the ViT's (clips, 3136, 16,
              64), q, k, v strided views of one packed qkv tensor; timed like
              phase 2 (library yardstick: SDPA), and kernel and SDPA again at
              the featurizer's EXTRACT_B x 4 clips;
  9. extract  the UMT ViT-L tower at res448, full depth, in bf16 from SEED on
              the card, with ToMe: the featurizer at EXTRACT_B videos (one
              untimed batch, EXTRACT_TIMED timed in a pipeline, launches
              checked); the tower through B2 against the same tower through
              the plain attention; ToMe on the card against ToMe on the CPU
              on the same fp32 tower output; then the extraction pipeline
              (run_extraction, device preprocessing) over E2E_VIDEOS synthetic
              videos of 16 uint8 frames of FRAME_HW, saved through the
              feature store, with the on-card resize held to the CPU resize.
Then one JSON line of kernel records, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Without a CUDA GPU, or without the package next to this script,
it fails at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, dense bf16 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

ATTN_ATOL, ATTN_RTOL = 1e-2, 2e-2   # |kernel - plain| <= atol + rtol |plain|:
                     # two bf16 ulps (both round P and O to bf16, at different
                     # points of the online softmax)
LSE_TOL = 1e-3       # |kernel - plain| lse on query-mask-1 rows: fp32 sums of
                     # exact bf16 products in another order, ~1e-6 relative at |lse| ~ 7
GRAD_TOL = 3e-2      # |kernel - plain| dq, dk, dv over max|plain|: the kernels
                     # round P and dS to bf16 before their tensor-core products
                     # and write bf16; the plain version keeps fp32 to the end
PACKED_TOL = 5e-2    # max |packed - naive| on per-caption mean CE (~12)
                     # after 28 bf16 layers computed in a different order
TOWER_TOL = 5e-2     # |kernel - plain| / |plain| (Frobenius) of the ViT-L tower
                     # output: each block's attention differs by about one bf16
                     # ulp (0.2-0.4%, P and O rounded at other points) and 23
                     # blocks compound it, ~1% expected; 5x that
TOME_AGREE = 0.99    # least share of clips whose ToMe output on the card matches
                     # the CPU's (same fp32 input): a clip agrees when its max
                     # |d| <= TOME_CLIP_TOL x max|CPU|, i.e. every merge was the
                     # same (a different merge moves whole tokens)
TOME_CLIP_TOL = 1e-3
RESIZE_SHARE = 1e-2  # most values the on-card resize may put 1 grey level off the
                     # CPU resize (UMTImageProcessor.resize_frames): PIL's
                     # fixed-point rounding where PIL is installed (+-1 on < 1%,
                     # tests/test_extract_device_resize.py), else its float64
                     # two-pass, which fp32 products miss only at near-ties

ITEMS = 256          # queries in the timed run
WARM_ITEMS = 64      # queries in the untimed run before it
TOPK = 16
CAPTION_TOKENS = 96  # caption budget of the VTG and TVG layouts
SEED = 0

TRAIN_B = 4          # train batch, 64-video vocabulary, lr 1e-4 without warmup,
TRAIN_VOCAB = 64     # 100 steps an epoch: the JAX package's train-step bench
TRAIN_WARM = 2       # untimed steps
TRAIN_STEPS = 5      # timed steps
GRADCHECK_LAYERS = 2
GRADCHECK_B = 2
GRADCHECK_LOSS_TOL = 2e-2   # |kernel - plain| loss (~16) after 2 bf16 layers
GRADCHECK_TOL = 5e-2        # |kernel - plain| per LoRA leaf over max|plain|: bf16
                            # activations through 2 layers, P and dS rounded to
                            # bf16 in the kernels, in another order in the plain

VIT_CLIPS = 8        # B2's check and record shape: the end-to-end batch, 2 videos x 4 clips
EXTRACT_B = 16       # featurizer batch in videos (the JAX package's featurizer bench)
EXTRACT_TIMED = 5    # timed featurizer batches after one untimed
E2E_VIDEOS = 32      # end-to-end extraction: videos, batch, frames of each video
E2E_B = 2
FRAME_HW = (240, 320)   # MSRVTT-like source frames, smaller than 448^2: shipped raw

WORDS = ["man", "woman", "dog", "cat", "runs", "jumps", "sings", "cooks",
         "dances", "rides", "park", "kitchen", "stage", "street", "ball", "car",
         "talks", "plays", "guitar", "soccer", "child", "group", "slowly", "red"]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_captions(n, rng, budget):
    """Synthetic captions with MSRVTT's token-length profile under the byte
    tokenizer: lognormal(ln 12, 0.35) lengths clipped to [5, budget-2]."""
    lens = np.clip(np.rint(rng.lognormal(np.log(12.0), 0.35, size=n)), 5, budget - 2)
    caps = []
    for L in lens.astype(int):
        words, total = [], 0
        while total < L:
            w = WORDS[rng.integers(len(WORDS))]
            words.append(w)
            total += len(w) + (1 if total else 0)
        caps.append(" ".join(words)[:L].strip())
    return caps


def gpu_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters=20, replays=5, stream=None):
    """Device time per call of fn, from one CUDA graph of `iters` calls
    replayed `replays` times: no host work runs between the launches, so a
    kernel shorter than its host-side call is timed, not the host. With a
    stream, fn runs and is captured on it (an autograd backward runs on the
    stream of its forward, which must then be that stream)."""
    import contextlib

    import torch

    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def raw_fwd(q, k, v, mask=None, causal=True, with_lse=False):
    """A zero-argument call of flash_fwd.cu's C entry point on operands
    prepared once: no checks, no allocation, no mask conversion, no launch
    counted. Times the kernel where the wrapper's host work would pace it."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    lib = fa._library("flash_fwd")
    b, s, hq, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if with_lse else None
    m = None if mask is None else mask.to(torch.int32).contiguous()
    mp = None if m is None else m.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, mp, out.data_ptr(),
            None if lse is None else lse.data_ptr(), hq * s, s, b, s, hq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            0 if m is None else m.stride(0), d ** -0.5, int(causal))

    def call():
        rc = lib.blim_flash_fwd(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"blim_flash_fwd: CUDA error {rc} ({lib.blim_cuda_error_string(rc).decode()})")

    call.operands = (q, k, v, out, lse, m)   # the pointers in args stay valid while call lives
    return call


def raw_bwd(q, k, v, dout, mask, out, lse):
    """Zero-argument calls of flash_bwd.cu's two C entry points (dq, then dk
    and dv) on operands prepared once, as the wrapper prepares them: dO
    times the mask, delta = rowsum(dO * O), a causal masked launch each; no
    checks, no allocation, no launch counted."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    g = (dout * mask[:, :, None, None].to(dout.dtype)).contiguous()
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    km = mask.to(torch.int32).contiguous()
    *_, call_dq, call_dkv = fa._backward_calls(q.contiguous(), k.contiguous(), v.contiguous(),
                                               g, lse.contiguous(), delta, km,
                                               q.shape[-1] ** -0.5, True)
    error_string = fa._library("flash_bwd").blim_flash_bwd_error_string

    def checked(call, name):
        def run():
            rc = call()
            if rc:
                fail(f"blim_{name}: CUDA error {rc} ({error_string(rc).decode()})")
        return run

    return checked(call_dq, "flash_dq"), checked(call_dkv, "flash_dkv")


def pairs_visible(key_mask, query_mask):
    """Causal (query, key) pairs with both masks 1 and the key not after the query."""
    km = key_mask.bool().cpu().numpy()
    qm = query_mask.bool().cpu().numpy()
    return float((np.cumsum(km, axis=1) * qm).sum())


def roofline_ms(nbytes, flops):
    """The least time this card could take: the larger of the bytes over the
    memory rate and the flops over the bf16 rate, and which one it is."""
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def attention_bound_ms(b, s, hq, hkv, d, key_mask, query_mask):
    """Bound of one causal attention forward: each input read once and the
    output written once, against the FLOPs of the visible (query, key) pairs."""
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    if key_mask is not None:
        nbytes += 2 * 4 * b * s
        pairs = pairs_visible(key_mask, query_mask)
    else:
        pairs = float(b * s * (s + 1) // 2)
    return roofline_ms(nbytes, 4.0 * d * hq * pairs)


def backward_traffic(b, s, hq, hkv, d, key_mask, query_mask):
    """Bytes and flops of one causal masked backward, per kernel: each input
    read once and each output written once; B3 (flash_dq) reads q, dO, k, v,
    lse, delta, the mask and writes dq, against 3 products of 2 d flops per
    visible (query, key) pair; B4 (flash_dkv) reads the same and writes dk,
    dv, against 4 products."""
    q_like = 2 * b * s * hq * d       # bf16 q, dO or dq
    kv_like = 2 * b * s * hkv * d     # bf16 k, v, dk or dv
    stats = 2 * 4 * b * hq * s        # fp32 lse and delta
    mask = 4 * b * s
    pairs = pairs_visible(key_mask, query_mask)
    return {"flash_dq": (3 * q_like + 2 * kv_like + stats + mask, 6.0 * d * hq * pairs),
            "flash_dkv": (2 * q_like + 4 * kv_like + stats + mask, 8.0 * d * hq * pairs)}


def phase_build():
    from blim_tpu_torch.kernels import flash_attention as fa

    t0 = time.time()
    reports = fa.build()              # one nvcc per source, all started together
    secs = time.time() - t0
    for name, report in reports.items():
        print(f"[build] {fa.SOURCES[name].name} -> {fa.library_path(name).name} for sm_90a"
              + ("" if report else " (already built)"), flush=True)
        for ln in report.splitlines():
            if any(w in ln for w in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"[build]   {ln.strip()}", flush=True)
    fwd, bwd = fa._library("flash_fwd"), fa._library("flash_bwd")
    print(f"[build] dynamic shared memory per CTA: flash_fwd {fwd.blim_flash_fwd_smem_bytes(128)} B "
          f"at d 128, {fwd.blim_flash_fwd_smem_bytes(64)} B at d 64 (flash_fwd_dense), "
          f"flash_dq {bwd.blim_flash_bwd_smem_bytes(0)} B, "
          f"flash_dkv {bwd.blim_flash_bwd_smem_bytes(1)} B", flush=True)
    occupancy = bwd.blim_flash_dkv_cluster_occupancy(7)
    if occupancy < 0:
        fail(f"flash_dkv cluster occupancy query: CUDA error {-occupancy}")
    print(f"[build] flash_dkv at the 7B's GQA group of 7: clusters of {occupancy // 1000} CTAs, "
          f"{occupancy % 1000} clusters resident at once "
          f"({occupancy // 1000 * (occupancy % 1000)} of the card's SMs)", flush=True)
    print(f"[build] {len(reports)} sources in {secs:.1f}s", flush=True)


def phase_kernels(card):
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    hq, hkv, d = 28, 4, 128

    def inputs(b, s):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        return q, k, v

    def pads_mask(b, s, pad):
        m = torch.ones((b, s), dtype=torch.int32, device="cuda")
        m[:, s - pad:] = 0
        return m

    def holes_mask(b, s):
        m = pads_mask(b, s, 9)
        m[:, 14:270] = 0                      # a CPN-masked video block
        m &= (torch.rand((b, s), generator=gen, device="cuda") > 0.1).int()
        m[:, 0] = 1
        return m

    m_pads = pads_mask(4, 341, 23)
    m_holes = holes_mask(4, 341)
    cases = [
        ("G=4 S=341 pads", (4, 341), m_pads),
        ("G=4 S=341 CPN holes", (4, 341), m_holes),
        ("B=1 S=85 prior prefix", (1, 85), torch.ones((1, 85), dtype=torch.int32, device="cuda")),
        ("G=4 S=341 dense", (4, 341), None),
    ]
    record = None
    worst = 0.0
    for name, (b, s), mask in cases:
        q, k, v = inputs(b, s)
        before = fa.launches
        out = fa.flash_attention(q, k, v, key_mask=mask, query_mask=mask)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            fail(f"kernel case {name}: the wrapper did not launch the kernel")
        ref = reference_attention(q, k, v, mask, mask, True, d ** -0.5)
        if not torch.isfinite(out).all():
            fail(f"kernel case {name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
        worst = max(worst, err)
        ms = graph_time_ms(raw_fwd(q, k, v, mask))
        wrapper_ms = gpu_time_ms(lambda: fa.flash_attention(q, k, v, key_mask=mask,
                                                            query_mask=mask))
        plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, mask, mask, True, d ** -0.5))
        idx = torch.arange(s, device="cuda")
        allowed = (idx[:, None] >= idx[None, :])[None, None]
        if mask is not None:
            allowed = allowed & mask.bool()[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed, enable_gqa=True))
        except TypeError:            # a PyTorch without enable_gqa
            lib_ms = None
        bound_ms, bound_by = attention_bound_ms(b, s, hq, hkv, d, mask, mask)
        print(f"[kernels] flash_fwd {name}: max|d|={err:.3e} "
              f"(tol {ATTN_ATOL} + {ATTN_RTOL}|plain|) "
              f"kernel {ms:.4f} ms (raw entry point, CUDA graph), wrapper {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms (CUDA graph)'}, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]", flush=True)
        if excess > ATTN_ATOL:
            fail(f"kernel case {name}: |kernel - plain| exceeds {ATTN_ATOL} + "
                 f"{ATTN_RTOL}|plain| (max |d| {err:.3e})")
        if name == "G=4 S=341 CPN holes":
            record = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
    record["max_abs_err"] = worst
    return record


def train_attention_cases():
    """The train step's attention shapes: VTG (4, 448) with right pads of
    caption-like lengths, TVG (4, 256) with left pads (the TVG layout)."""
    import torch

    vtg = torch.ones((4, 448), dtype=torch.int32, device="cuda")
    for b, pad in enumerate((23, 61, 5, 88)):
        vtg[b, 448 - pad:] = 0
    tvg = torch.ones((4, 256), dtype=torch.int32, device="cuda")
    for b, pad in enumerate((120, 97, 143, 110)):
        tvg[b, :pad] = 0
    return [("VTG B=4 S=448 right pads", vtg), ("TVG B=4 S=256 left pads", tvg)]


def phase_train_kernels(card):
    """B1-lse, B3 and B4 against their plain versions at the train step's
    shapes, in bf16 (fp32 accumulators on both sides), with times."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    hq, hkv, d = 28, 4, 128
    scale = d ** -0.5
    records = {}
    for name, m in train_attention_cases():
        b, s = m.shape
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                         dtype=torch.bfloat16)
        q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        rows = m.bool()[:, None, :].expand(b, hq, s)
        pairs = pairs_visible(m, m)
        io = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * s   # q, k, v, o + mask

        # B1-lse
        before = fa.counts()
        out, lse = fa.flash_attention_lse(q, k, v, key_mask=m, query_mask=m)
        torch.cuda.synchronize()
        if fa.launches_lse != before["flash_fwd_lse"] + 1 or fa.launches != before["flash_fwd"]:
            fail(f"flash_fwd_lse {name}: the wrapper did not launch the lse kernel once")
        ref, ref_lse = fa.reference_attention_lse(q, k, v, m, m, True, scale)
        if not (torch.isfinite(out).all() and torch.isfinite(lse[rows]).all()):
            fail(f"flash_fwd_lse {name}: non-finite output or lse")
        diff = (out.float() - ref.float()).abs()
        err_o = diff.max().item()
        excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
        err_lse = (lse - ref_lse)[rows].abs().max().item()
        ms = graph_time_ms(raw_fwd(q, k, v, m, with_lse=True))
        wrapper_ms = gpu_time_ms(lambda: fa.flash_attention_lse(q, k, v, key_mask=m,
                                                                query_mask=m))
        plain_ms = gpu_time_ms(lambda: fa.reference_attention_lse(q, k, v, m, m, True, scale))
        allowed = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()[None, None] \
            & m.bool()[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=allowed, enable_gqa=True)
        lib_ms = graph_time_ms(sdpa)     # with grad on, the forward also keeps its lse
        bound_ms, bound_by = roofline_ms(io + 4 * b * hq * s, 4.0 * d * hq * pairs)
        print(f"[train-kernels] flash_fwd_lse {name}: max|d| out {err_o:.3e} "
              f"(tol {ATTN_ATOL} + {ATTN_RTOL}|plain|), lse {err_lse:.3e} on query-mask-1 rows "
              f"(tol {LSE_TOL}); kernel {ms:.4f} ms (raw entry point, CUDA graph), wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa fwd {lib_ms:.4f} ms (CUDA graph), "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
        if excess > ATTN_ATOL or err_lse > LSE_TOL:
            fail(f"flash_fwd_lse {name}: kernel and plain disagree")
        rec = records.setdefault("flash_fwd_lse", dict(max_abs_err=0.0))
        rec["max_abs_err"] = max(rec["max_abs_err"], err_o, err_lse)
        if "VTG" in name:
            rec.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms)

        # B3 + B4 on the plain forward's O and lse, so both sides read the same inputs
        before = fa.counts()
        dq, dk, dv = fa.flash_attention_backward(q, k, v, m, m, ref, ref_lse, dout)
        torch.cuda.synchronize()
        if (fa.launches_dq, fa.launches_dkv) != (before["flash_dq"] + 1,
                                                 before["flash_dkv"] + 1):
            fail(f"flash_dq/dkv {name}: the wrapper did not launch each kernel once")
        want = fa.reference_attention_backward(q, k, v, m, m, ref, ref_lse, dout, True, scale)
        errs = {}
        for gname, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            if not torch.isfinite(got).all():
                fail(f"{gname} {name}: non-finite")
            errs[gname] = ((got.float() - w.float()).abs().max().item(),
                           w.float().abs().max().item())
        ms_wrapper = gpu_time_ms(
            lambda: fa.flash_attention_backward(q, k, v, m, m, ref, ref_lse, dout))
        plain_bwd = gpu_time_ms(
            lambda: fa.reference_attention_backward(q, k, v, m, m, ref, ref_lse, dout, True, scale))
        call_dq, call_dkv = raw_bwd(q, k, v, dout, m, ref, ref_lse)
        ms_dq_only = graph_time_ms(call_dq)
        ms_dkv_only = graph_time_ms(call_dkv)
        # SDPA's backward alone: its forward runs eagerly on a side stream,
        # then autograd.grad (dq, dk, dv) is captured on that stream
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out_sdpa = sdpa()
        do_t = dout.transpose(1, 2)
        lib_bwd = graph_time_ms(lambda: torch.autograd.grad(out_sdpa, (qt, kt, vt), do_t,
                                                            retain_graph=True), stream=side)
        traffic = backward_traffic(b, s, hq, hkv, d, m, m)
        b_dq, by_dq = roofline_ms(*traffic["flash_dq"])
        b_dkv, by_dkv = roofline_ms(*traffic["flash_dkv"])
        print(f"[train-kernels] flash_dq/flash_dkv {name}: " + ", ".join(
            f"{gname} max|d| {e:.3e} (max|plain| {mx:.3e})" for gname, (e, mx) in errs.items())
            + f" (tol {GRAD_TOL} max|plain|); dq kernel {ms_dq_only:.4f} ms (bound {b_dq:.4f}, "
            f"{by_dq}), dkv kernel {ms_dkv_only:.4f} ms (bound {b_dkv:.4f}, {by_dkv}) (raw entry "
            f"points, CUDA graph), wrapper with delta {ms_wrapper:.4f} ms, plain backward "
            f"{plain_bwd:.4f} ms, sdpa backward (dq+dk+dv) {lib_bwd:.4f} ms (CUDA graph) [{card}]",
            flush=True)
        for gname, (e, mx) in errs.items():
            if e > GRAD_TOL * mx:
                fail(f"{gname} {name}: |kernel - plain| {e:.3e} > {GRAD_TOL} x {mx:.3e}")
        for key, ms_k, b_k, by_k, gnames in (("flash_dq", ms_dq_only, b_dq, by_dq, ("dq",)),
                                             ("flash_dkv", ms_dkv_only, b_dkv, by_dkv,
                                              ("dk", "dv"))):
            rec = records.setdefault(key, dict(max_abs_err=0.0))
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [errs[gn][0] for gn in gnames])
            if "VTG" in name:
                # the plain backward and the library backward compute dq, dk and dv together
                rec.update(ms=ms_k, wrapper_ms=ms_wrapper, plain_ms=plain_bwd, bound_ms=b_k,
                           bound_by=by_k, library_ms=lib_bwd,
                           plain_and_library_cover="dq+dk+dv", wrapper_covers="dq+dk+dv")
    return records


def make_inputs(cfg, n):
    """Synthetic MSRVTT-like inputs for n items, made from SEED: captions,
    features (n, clips, tokens, mm) and InternVideo2 matrices kept off the
    exact 0.0 that recall reads as a skipped direction."""
    from blim_tpu_torch.engine.evaluation import EvalInputs

    r = np.random.default_rng((SEED, n))
    return EvalInputs(
        captions=make_captions(n, r, CAPTION_TOKENS),
        item_video_idx=np.arange(n),
        features=np.asarray(r.standard_normal(
            (n, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)), np.float32) * 0.5,
        t2v_iv2=r.standard_normal((n, n)).astype(np.float32) + 0.01,
        v2t_iv2=r.standard_normal((n, n)).astype(np.float32) + 0.01,
    )


def setup_flow():
    """Qwen2-7B (ModelConfig(), full width and depth) in bf16 from SEED on
    the card, the byte tokenizer and the MSRVTT VTG layout."""
    import torch

    from blim_tpu_torch.checkpoints.convert import init_params
    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer

    cfg = ModelConfig()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    tok = ByteFallbackTokenizer()
    layout = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=CAPTION_TOKENS)
    return cfg, params, tok, layout


def run_flow(flow, n, timings=None):
    """One zero-shot evaluation (CPN on, TOPK) of n synthetic items on a
    fresh engine, synchronized. Returns (inputs, engine, t2v, v2t, seconds)."""
    import torch

    from blim_tpu_torch.engine.evaluation import evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine

    cfg, params, tok, layout = flow
    inputs = make_inputs(cfg, n)
    engine = RerankEngine(params, cfg, layout, device="cuda")
    torch.cuda.synchronize()
    t = time.time()
    t2v, v2t = evaluation(engine, inputs, tok, "MSRVTT", topk=TOPK, cpn=True, has_tvg=False,
                          verbose=False, timings=timings)
    torch.cuda.synchronize()
    return inputs, engine, t2v, v2t, time.time() - t


def phase_slice(card):
    import torch

    from blim_tpu_torch.engine.rerank import topk_pairs
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.scoring.fusion import all_scoring_results

    t0 = time.time()
    flow = setup_flow()
    cfg, params = flow[:2]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[slice] Qwen2-7B, {cfg.llm.num_hidden_layers} layers, {n_params / 1e9:.2f}B params "
          f"in bf16, seeded init on the card in {time.time() - t0:.2f}s", flush=True)
    warm_s = run_flow(flow, WARM_ITEMS)[-1]
    print(f"[slice] untimed warm run: {WARM_ITEMS} items in {warm_s:.2f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    inputs, engine, t2v, v2t, elapsed = run_flow(flow, ITEMS)
    launches = fa.launches
    others = sum(fa.counts().values()) - launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = ITEMS
    expected = cfg.llm.num_hidden_layers * engine.prefix_forwards
    v_rows, v_cols = topk_pairs(inputs.v2t_iv2, TOPK)
    t_rows, t_cols = topk_pairs(inputs.t2v_iv2, TOPK)
    pairs = len(set(zip(v_cols.tolist(), v_rows.tolist())) | set(zip(t_rows.tolist(), t_cols.tolist())))
    print(f"[slice] timed run: {n} queries in {elapsed:.3f}s = {n / elapsed:.3f} q/s, "
          f"peak {peak_gb:.2f} GiB, {pairs} unique pairs, {engine.steps} steps, "
          f"flash_fwd launches {launches} (expected {expected} = {cfg.llm.num_hidden_layers} x "
          f"({engine.prefix_forwards - 1} video-prefix steps + 1 prior prefix)) [{card}]",
          flush=True)
    if launches != expected or launches == 0 or others:
        fail(f"flash_fwd launches {launches} != expected {expected}, or another kernel "
             f"launched ({fa.counts()})")
    owned = [
        (v2t["candidate_likelihood"], v_rows, v_cols, "v2t candidate_likelihood"),
        (v2t["candidate_prior"], v_rows, v_cols, "v2t candidate_prior"),
        (t2v["query_likelihood"], t_rows, t_cols, "t2v query_likelihood"),
    ]
    for mat, rows, cols, name in owned:
        if mat.shape != (n, n):
            fail(f"{name} has shape {mat.shape}")
        cells = mat[rows, cols]
        if not np.isfinite(cells).all() or (cells == -100.0).any():
            fail(f"{name}: a scored cell is non-finite or still the -100 fill")
    ids = {i: i for i in range(n)}
    res = all_scoring_results(t2v, v2t, ids, ids, alpha=(0.0, 0.8), c=(1.0, 0.0, 0.8, 0.6),
                              cpn=True, has_tvg=False)
    print(f"[slice] recall r_mean: " + ", ".join(
        f"{k} {v['r_mean']}" for k, v in res.items()), flush=True)
    return dict(flow=flow, inputs=inputs, v2t=v2t, v_rows=v_rows, v_cols=v_cols,
                launches=launches)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def phase_packed(st, card):
    import torch

    from blim_tpu_torch.engine.rerank import CaptionBank
    from blim_tpu_torch.models import videochat_flash as vcf

    cfg, params, tok, layout = st["flow"]
    inputs, v2t = st["inputs"], st["v2t"]
    rows, cols = st["v_rows"][:8], st["v_cols"][:8]          # (video, caption) cells
    bank = CaptionBank.build_vtg([inputs.captions[c] for c in cols], tok, "MSRVTT", layout)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    batch = {
        "input_ids": dev(bank.input_ids),
        "attention_mask": dev(bank.attention_mask),
        "cpn_mask": dev(bank.cpn_mask),
        "window_labels": dev(bank.window_labels),
        "video": dev(inputs.features[rows]).to(params["llm"]["embed_tokens"]["embedding"].dtype),
    }
    ws, wl = layout.label_window
    with torch.no_grad():
        naive = vcf.score_vtg(params, cfg, batch, layout.video_start, ws, wl)
        naive_prior = vcf.score_vtg(params, cfg, batch, layout.video_start, ws, wl, cpn=True)
    naive = naive.float().cpu().numpy()
    naive_prior = naive_prior.float().cpu().numpy()
    packed = v2t["candidate_likelihood"][rows, cols]
    packed_prior = v2t["candidate_prior"][rows, cols]
    err = float(np.abs(packed - naive).max())
    err_prior = float(np.abs(packed_prior - naive_prior).max())
    print(f"[packed] 8 pairs, packed vs naive score_vtg: max|d| likelihood {err:.3e}, "
          f"prior {err_prior:.3e} (tol {PACKED_TOL}; scores ~{naive.mean():.2f}) [{card}]",
          flush=True)
    if not (np.isfinite(naive).all() and np.isfinite(naive_prior).all()):
        fail("naive scores are not finite")
    if max(err, err_prior) > PACKED_TOL:
        fail(f"packed vs naive disagree: {err:.3e} / {err_prior:.3e} > {PACKED_TOL}")


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _slice_layers(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def train_setup(cfg, tok, vtg_layout, seed):
    """TVG layout, synthetic train batches and video vocabulary from `seed`."""
    from blim_tpu_torch.data.collate import collate_train_batch
    from blim_tpu_torch.data.prompts import make_tvg_layout

    tvg_layout = make_tvg_layout(tok, cfg.num_clips, CAPTION_TOKENS)
    r = np.random.default_rng((SEED, seed))

    def batch(b):
        feats = r.standard_normal((b, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size))
        return collate_train_batch(make_captions(b, r, CAPTION_TOKENS), feats.astype(np.float32),
                                   np.arange(b) % 4, tok, "MSRVTT", vtg_layout, tvg_layout)

    vocab = r.standard_normal((TRAIN_VOCAB, cfg.num_clips, cfg.mm_hidden_size)).astype(np.float32)
    return tvg_layout, batch, vocab


def setup_train(flow):
    """The 7B LoRA train step on the flow's weights, as the JAX package's
    train-step bench sets it up: a seeded trainable tree on the card, the
    state, the step, a batch maker, the video vocabulary, the generator."""
    import torch

    from blim_tpu_torch.engine import train as train_lib

    cfg, params, tok, vtg_layout = flow
    tvg_layout, batch, vocab = train_setup(cfg, tok, vtg_layout, 7)
    tcfg = train_lib.TrainConfig(lr=1e-4, warmup_epochs=0.0, epochs=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    trainable = train_lib.init_trainable(
        gen, cfg, tcfg, visual_head=torch.full((cfg.llm.hidden_size, cfg.mm_hidden_size), 0.02))
    return dict(state=train_lib.init_train_state(trainable, tcfg, steps_per_epoch=100),
                step=train_lib.make_train_step(cfg, tcfg, vtg_layout, tvg_layout, device="cuda"),
                batch=batch, vocab=torch.from_numpy(vocab).cuda(), gen=gen,
                tvg_layout=tvg_layout)


def phase_train(st, card):
    """The 7B LoRA train step on the card: B = 4, caption budget 96,
    per-layer recompute, AdamW; launch counts checked against the path."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    cfg, params, tok, vtg_layout = st["flow"]
    tr = setup_train(st["flow"])
    state, step, batch, vocab, gen = tr["state"], tr["step"], tr["batch"], tr["vocab"], tr["gen"]
    tvg_layout = tr["tvg_layout"]
    llm = params["llm"]
    frozen_probe = [t.detach().clone() for t in (
        llm["embed_tokens"]["embedding"][:64], llm["layers"]["q_proj"]["kernel"][0, :64],
        llm["layers"]["down_proj"]["kernel"][-1, :64], llm["lm_head"]["kernel"][:, :64],
        params["projector"]["tvg_mlp"]["fc2"]["kernel"][:64], params["visual_head"]["kernel"])]
    leaves = list(_leaves(state.trainable))
    before = [t.detach().clone() for t in leaves]
    torch.cuda.empty_cache()
    t0 = time.time()
    for _ in range(TRAIN_WARM):
        state, m = step(state, params, batch(TRAIN_B), vocab, gen)
        if not np.isfinite(float(m["loss"])):
            fail("train: non-finite loss in an untimed step")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    batches = [batch(TRAIN_B) for _ in range(TRAIN_STEPS)]   # host collation outside the clock
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    times, metrics = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, params, b, vocab, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = fa.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.llm.num_hidden_layers
    expected = {"flash_fwd": 0, "flash_fwd_lse": TRAIN_STEPS * (1 + 1) * layers * 2,
                "flash_fwd_dense": 0, "flash_dq": TRAIN_STEPS * layers * 2,
                "flash_dkv": TRAIN_STEPS * layers * 2}
    ms = [t * 1e3 for t in times]
    print(f"[train] Qwen2-7B LoRA train step, B={TRAIN_B}, VTG seq {vtg_layout.seq_len} + TVG seq "
          f"{tvg_layout.seq_len}, remat: {TRAIN_WARM} untimed steps in {warm_s:.2f}s, then "
          f"{TRAIN_STEPS} timed: {np.mean(ms):.1f} ms/step mean, {np.min(ms):.1f} min, "
          f"{np.max(ms):.1f} max; peak {peak_gb:.2f} GiB; loss "
          + ", ".join(f"{x['loss']:.4f}" for x in metrics) + "; grad_norm "
          + ", ".join(f"{x['grad_norm']:.4e}" for x in metrics)
          + f"; launches {counts} (expected {expected}) [{card}]", flush=True)
    for x in metrics:
        if not all(np.isfinite(v) for v in x.values()):
            fail(f"train: non-finite metrics {x} (a finite grad_norm means finite gradients)")
    if counts != expected:
        fail(f"train: launches {counts} != expected {expected}")
    after = (llm["embed_tokens"]["embedding"][:64], llm["layers"]["q_proj"]["kernel"][0, :64],
             llm["layers"]["down_proj"]["kernel"][-1, :64], llm["lm_head"]["kernel"][:, :64],
             params["projector"]["tvg_mlp"]["fc2"]["kernel"][:64], params["visual_head"]["kernel"])
    if not all(torch.equal(a, b) for a, b in zip(frozen_probe, after)):
        fail("train: a frozen weight changed")
    changed = sum(not torch.equal(a, b.detach()) for a, b in zip(before, leaves))
    if changed != len(leaves):
        fail(f"train: only {changed} of {len(leaves)} trainable leaves changed")
    print(f"[train] frozen probes unchanged, {changed}/{len(leaves)} trainable leaves changed, "
          f"{state.applied} updates applied", flush=True)
    return dict(counts=counts, ms=float(np.mean(ms)))


def phase_gradcheck(st, card):
    """Loss and LoRA gradients through the kernels against the same step
    through the plain attention, swapped into qwen2's attention call here
    only: reference_attention in fp32 under autograd, output cast back to
    bf16. In bf16, autograd would round dP to bf16 before dP - delta
    cancels, a coarser yardstick than the kernels, which keep dP in fp32."""
    import dataclasses

    import torch

    from blim_tpu_torch.engine import train as train_lib
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import qwen2

    cfg, params, tok, vtg_layout = st["flow"]
    small = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=GRADCHECK_LAYERS))
    frozen = dict(params, llm=dict(params["llm"], layers=_slice_layers(
        params["llm"]["layers"], GRADCHECK_LAYERS)))
    tvg_layout, batch, vocab = train_setup(cfg, tok, vtg_layout, 11)
    tcfg = train_lib.TrainConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    trainable = train_lib.init_trainable(
        gen, small, tcfg, visual_head=torch.full((cfg.llm.hidden_size, cfg.mm_hidden_size), 0.02))
    with torch.no_grad():          # LoRA B non-zero, so A gets a gradient too
        for name, t in _named_leaves(trainable):
            if name.endswith("b"):
                t.normal_(0.0, 0.01, generator=gen)
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch(GRADCHECK_B).items()}
    b["video"] = b["video"].to(params["projector"]["mlp"]["fc1"]["kernel"].dtype)
    vocab = torch.from_numpy(vocab).cuda()
    ws, wl = vtg_layout.label_window
    geoms = ((vtg_layout.video_start, ws, wl),
             (tvg_layout.video_start, int(tvg_layout.gather_positions[0])))
    names, leaves = zip(*_named_leaves(trainable))

    def loss_and_grads():
        loss, _ = train_lib.loss_fn(trainable, frozen, small, b, vocab, *geoms, tcfg.lora.scale)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    fa.reset_counts()
    k_loss, k_grads = loss_and_grads()
    k_counts = fa.counts()
    kernel_mha = qwen2.multi_head_attention
    qwen2.multi_head_attention = lambda q, k, v, *, key_mask, query_mask, causal, scale, window: \
        reference_attention(q.float(), k.float(), v.float(), key_mask, query_mask, causal, scale,
                            window).to(q.dtype)
    try:
        fa.reset_counts()
        p_loss, p_grads = loss_and_grads()
        p_counts = fa.counts()
    finally:
        qwen2.multi_head_attention = kernel_mha
    worst = max(((g - w).abs().max().item() / w.abs().max().item(), n)
                for n, g, w in zip(names, k_grads, p_grads))
    worst_norm = max(((g - w).norm().item() / w.norm().item(), n)
                     for n, g, w in zip(names, k_grads, p_grads))
    expected = {"flash_fwd": 0, "flash_fwd_lse": 2 * 2 * GRADCHECK_LAYERS, "flash_fwd_dense": 0,
                "flash_dq": 2 * GRADCHECK_LAYERS, "flash_dkv": 2 * GRADCHECK_LAYERS}
    print(f"[gradcheck] {GRADCHECK_LAYERS} layers at full width, B={GRADCHECK_B}: loss kernel "
          f"{k_loss:.5f} vs plain {p_loss:.5f} (tol {GRADCHECK_LOSS_TOL}); worst LoRA leaf "
          f"max|d|/max|plain| {worst[0]:.3e} at {worst[1]} (tol {GRADCHECK_TOL}), worst "
          f"|d|/|plain| (Frobenius) {worst_norm[0]:.3e} at {worst_norm[1]}, over "
          f"{len(names)} leaves; kernel launches {k_counts}, plain {p_counts} [{card}]", flush=True)
    if not (np.isfinite(k_loss) and all(torch.isfinite(g).all() for g in k_grads)):
        fail("gradcheck: non-finite loss or gradient through the kernels")
    if k_counts != expected or any(p_counts.values()):
        fail(f"gradcheck: launches {k_counts} / {p_counts}, expected {expected} / none")
    if abs(k_loss - p_loss) > GRADCHECK_LOSS_TOL or worst[0] > GRADCHECK_TOL:
        fail("gradcheck: kernels and plain attention disagree")


def vit_attention_bound_ms(clips, s, h, d):
    """Bound of one B2 launch: q, k, v read once and o written once, against
    4 S^2 d flops per head and clip (QK^T and PV, no pair skipped)."""
    return roofline_ms(2 * 4 * clips * s * h * d, 4.0 * clips * h * s * s * d)


def phase_vit_kernel(card):
    """B2 against its plain version at the ViT's shapes, with times."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    vcfg = ModelConfig().vision                       # (S, H, d) = (3136, 16, 64)
    s, h = vcfg.num_frames * vcfg.patches_per_frame, vcfg.num_attention_heads
    d = vcfg.hidden_size // h

    def packed(clips):
        qkv = torch.randn((clips, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    q, k, v = packed(VIT_CLIPS)
    before = fa.counts()
    out = fa.flash_attention_dense(q, k, v)
    torch.cuda.synchronize()
    after = fa.counts()
    if after != dict(before, flash_fwd_dense=before["flash_fwd_dense"] + 1):
        fail(f"flash_fwd_dense: the wrapper did not launch B2 once ({before} -> {after})")
    ref = reference_attention(q, k, v, None, None, False, d ** -0.5)
    if not torch.isfinite(out).all():
        fail("flash_fwd_dense: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
    del ref, diff
    ms = graph_time_ms(raw_fwd(q, k, v, causal=False), iters=10, replays=2)
    wrapper_ms = gpu_time_ms(lambda: fa.flash_attention_dense(q, k, v), iters=10)
    plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, None, None, False, d ** -0.5),
                           iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10,
                           replays=2)
    bound_ms, bound_by = vit_attention_bound_ms(VIT_CLIPS, s, h, d)
    print(f"[vit-kernel] flash_fwd_dense {VIT_CLIPS} clips ({VIT_CLIPS}, {s}, {h}, {d}) strided "
          f"views of a packed qkv: max|d|={err:.3e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|) "
          f"kernel {ms:.4f} ms (raw entry point, CUDA graph), wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (CUDA graph), bound {bound_ms:.4f} ms "
          f"({bound_by}): kernel at {100 * bound_ms / ms:.1f}% of the bound, "
          f"{4.0 * VIT_CLIPS * h * s * s * d / ms / 1e9:.1f} TFLOP/s [{card}]", flush=True)
    if excess > ATTN_ATOL:
        fail(f"flash_fwd_dense: |kernel - plain| exceeds {ATTN_ATOL} + {ATTN_RTOL}|plain| "
             f"(max |d| {err:.3e})")
    record = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=lib_ms, max_abs_err=err)
    del q, k, v, qt, kt, vt, out
    clips = EXTRACT_B * 4
    q, k, v = packed(clips)
    ms_f = graph_time_ms(raw_fwd(q, k, v, causal=False), iters=5, replays=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_f = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5,
                          replays=1)
    bound_f, _ = vit_attention_bound_ms(clips, s, h, d)
    print(f"[vit-kernel] flash_fwd_dense {clips} clips (the featurizer's batch): kernel "
          f"{ms_f:.4f} ms, sdpa {lib_f:.4f} ms, bound {bound_f:.4f} ms: kernel at "
          f"{100 * bound_f / ms_f:.1f}% of the bound [{card}]", flush=True)
    record["featurizer_batch"] = dict(clips=clips, ms=ms_f, library_ms=lib_f, bound_ms=bound_f)
    return record


def synthetic_frames(path):
    """16 seeded uint8 frames of FRAME_HW for a synthetic video: a random
    base image drifting sideways, so neighbouring frames differ as in a pan."""
    i = int(path.rsplit("_", 1)[1])
    rng = np.random.default_rng((SEED, i))
    base = rng.integers(0, 256, (FRAME_HW[0], FRAME_HW[1] + 64, 3), dtype=np.uint8)
    return np.stack([base[:, 4 * t:4 * t + FRAME_HW[1]] for t in range(16)])


def end_to_end_extraction(vit, cfg, out_dir):
    """run_extraction with on-card preprocessing over E2E_VIDEOS synthetic
    videos at E2E_B, 4 decode threads, features saved as fp16 files through
    a FeatureStore in out_dir; returns (videos featurized, seconds)."""
    import torch

    from blim_tpu_torch.data.features import FeatureStore
    from blim_tpu_torch.models import umt_vit
    from blim_tpu_torch.pipelines import extract

    proc = umt_vit.UMTImageProcessor(size=(cfg.vision.image_size,) * 2)
    featurize = extract.make_featurizer(vit, cfg, device="cuda", device_preprocess=True)
    store = FeatureStore(out_dir)

    def decode(path):
        return extract.resize_for_upload(synthetic_frames(path), proc, proc.size)

    def consume(batch_paths, feats_dev):
        for path, feat in zip(batch_paths, feats_dev.to(torch.float16).cpu().numpy()):
            store.save(path, feat)

    return extract.run_extraction(
        [f"synthetic_{i:03d}" for i in range(E2E_VIDEOS)], decode, featurize, consume,
        batch_size=E2E_B, clips=cfg.num_clips, local_frames=cfg.mm_local_num_frames,
        decode_workers=4, log=lambda *a: None)


def phase_extract(card):
    """The extraction slice at full width on the card."""
    import tempfile

    import torch

    from blim_tpu_torch.checkpoints.convert import init_vision_tower
    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import projector, umt_vit
    from blim_tpu_torch.pipelines import extract

    cfg = ModelConfig()
    vcfg = cfg.vision
    depth = vcfg.depth
    t0 = time.time()
    vit = init_vision_tower(vcfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(vit))
    print(f"[extract] UMT ViT-L res{vcfg.image_size}: {depth} blocks, hidden {vcfg.hidden_size}, "
          f"{vcfg.num_attention_heads} heads of {vcfg.hidden_size // vcfg.num_attention_heads}, "
          f"{vcfg.num_frames * vcfg.patches_per_frame} tokens a clip, {n_params / 1e6:.1f}M "
          f"params in bf16, seeded init on the card in {time.time() - t0:.2f}s", flush=True)

    # featurizer: one untimed batch, then EXTRACT_TIMED in a pipeline
    featurize = extract.make_featurizer(vit, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (EXTRACT_B, cfg.num_clips, cfg.mm_local_num_frames, 3, vcfg.image_size,
             vcfg.image_size)
    pix = [torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) * 0.1
           for _ in range(EXTRACT_TIMED + 1)]
    featurize(pix.pop()).cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 2**30
    fa.reset_counts()
    t = time.perf_counter()
    outs = [featurize(x) for x in pix]
    outs[-1].cpu()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    counts = fa.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    vps = EXTRACT_B * EXTRACT_TIMED / elapsed
    expected = dict({k: 0 for k in counts}, flash_fwd_dense=depth * EXTRACT_TIMED)
    print(f"[extract] featurizer B={EXTRACT_B} videos ({EXTRACT_B * cfg.num_clips} clips), "
          f"{EXTRACT_TIMED} batches pipelined: {1e3 * elapsed / EXTRACT_TIMED:.1f} ms/batch, "
          f"{vps:.3f} videos/s, peak {peak_gb:.2f} GiB ({resident_gb:.2f} GiB of it resident "
          f"before: weights and the {EXTRACT_TIMED} input batches), launches {counts} (expected "
          f"{expected}) "
          f"[{card}]", flush=True)
    if counts != expected:
        fail(f"featurizer: launches {counts} != expected {expected}")
    for o in outs:
        if o.shape != (EXTRACT_B, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size) \
                or not torch.isfinite(o).all():
            fail(f"featurizer: output of shape {tuple(o.shape)} or non-finite")
    del outs, pix

    # the tower through B2 against the same tower through the plain attention
    pos = torch.from_numpy(np.asarray(umt_vit.build_pos_tables(vcfg)[0], np.float32)).cuda()
    clips = torch.randn((4 * 4, cfg.mm_local_num_frames, 3, vcfg.image_size, vcfg.image_size),
                        generator=gen, device="cuda", dtype=torch.bfloat16) * 0.5
    with torch.inference_mode():
        fa.reset_counts()
        kern = umt_vit.encode_clips(vit, clips[:4], pos, vcfg).float()
        tower_launches = fa.counts()["flash_fwd_dense"]
        kernel_mha = umt_vit.multi_head_attention
        umt_vit.multi_head_attention = lambda q, k, v, *, causal, scale: reference_attention(
            q, k, v, None, None, causal, scale)
        try:
            fa.reset_counts()
            plain = umt_vit.encode_clips(vit, clips[:4], pos, vcfg).float()
            plain_launches = sum(fa.counts().values())
        finally:
            umt_vit.multi_head_attention = kernel_mha
        tower = umt_vit.encode_clips(vit, clips, pos, vcfg)      # 4 videos, for ToMe
    d = kern - plain
    rel_max = (d.abs().max() / plain.abs().max()).item()
    rel_fro = (d.norm() / plain.norm()).item()
    print(f"[extract] tower, 1 video (4 clips): B2 vs plain attention max|d|/max|plain| "
          f"{rel_max:.3e}, |d|/|plain| (Frobenius) {rel_fro:.3e} (tol {TOWER_TOL}); launches "
          f"{tower_launches} / {plain_launches} (expected {depth} / 0) [{card}]", flush=True)
    if not torch.isfinite(kern).all() or rel_fro > TOWER_TOL:
        fail(f"tower: kernel and plain disagree ({rel_fro:.3e} > {TOWER_TOL})")
    if (tower_launches, plain_launches) != (depth, 0):
        fail("tower: launch counts do not match the path")

    # ToMe alone: the card against the CPU on the same fp32 tower output
    feats = tower.float()
    args = (cfg.tokens_per_frame, cfg.mm_local_num_frames, vcfg.num_attention_heads)
    t = time.time()
    on_card = projector.compress_clip_tokens(feats, *args).cpu()
    on_cpu = projector.compress_clip_tokens(feats.cpu(), *args)
    per_clip = (on_card - on_cpu).abs().amax(dim=(1, 2))
    agree = per_clip <= TOME_CLIP_TOL * on_cpu.abs().amax(dim=(1, 2))
    share = agree.float().mean().item()
    worst = per_clip[agree].max().item() if agree.any() else float("nan")
    print(f"[extract] ToMe {projector.merge_schedule(feats.shape[1], cfg.tokens_per_clip)} on "
          f"{feats.shape[0]} clips, fp32, card vs CPU: {share:.4f} of clips merge alike (tol "
          f"{TOME_AGREE}), max|d| {worst:.3e} among them ({time.time() - t:.1f}s) [{card}]",
          flush=True)
    if share < TOME_AGREE:
        fail(f"ToMe: only {share:.4f} of clips merge alike on the card and the CPU")
    del tower, kern, plain, feats, clips

    # end to end: run_extraction with device preprocessing and the feature store
    proc = umt_vit.UMTImageProcessor(size=(vcfg.image_size,) * 2)
    n_frames = cfg.num_clips * cfg.mm_local_num_frames
    paths = [f"synthetic_{i:03d}" for i in range(E2E_VIDEOS)]
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e2e_resident = torch.cuda.memory_allocated() / 2**30
        fa.reset_counts()
        n_ok, e2e_s = end_to_end_extraction(vit, cfg, out_dir)
        e2e_counts = fa.counts()
        e2e_peak = torch.cuda.max_memory_allocated() / 2**30
        files = sorted(os.listdir(out_dir))
        loaded = [np.load(os.path.join(out_dir, f)) for f in files]
    calls = -(-E2E_VIDEOS // E2E_B)
    e2e_expected = dict({k: 0 for k in e2e_counts}, flash_fwd_dense=depth * calls)
    print(f"[extract] end to end: {n_ok} videos of {n_frames} frames {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"(shipped raw, resized on the card), B={E2E_B}, 4 decode threads: {e2e_s:.3f}s = "
          f"{n_ok / e2e_s:.3f} videos/s, peak {e2e_peak:.2f} GiB ({e2e_resident:.2f} GiB of it "
          f"resident before: the weights), {len(files)} feature files, "
          f"launches {e2e_counts} (expected {e2e_expected}) [{card}]", flush=True)
    if n_ok != E2E_VIDEOS or len(files) != E2E_VIDEOS:
        fail(f"end to end: {n_ok} videos featurized, {len(files)} files written")
    want = (cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)
    for f, a in zip(files, loaded):
        if a.shape != want or a.dtype != np.float16 or not np.isfinite(a.astype(np.float32)).all():
            fail(f"end to end: {f} is {a.dtype} {a.shape}, expected finite float16 {want}")
    if e2e_counts != e2e_expected:
        fail(f"end to end: launches {e2e_counts} != expected {e2e_expected}")

    # the on-card resize against the port's CPU resize of the same frames
    frames = synthetic_frames(paths[0])[:4]
    on_card = extract.device_resize(torch.from_numpy(frames).cuda().float(), vcfg.image_size)
    try:
        import PIL  # noqa: F401
        yardstick = "PIL"
    except ImportError:
        yardstick = "float64 two-pass, no PIL"
    host = proc.resize_frames(frames).astype(np.int16)
    off = np.abs(on_card.cpu().numpy().astype(np.int16) - host)
    share_off = float((off > 0).mean())
    print(f"[extract] on-card resize {FRAME_HW} -> {vcfg.image_size}^2 vs the CPU resize "
          f"({yardstick}), 4 "
          f"frames: max |d| {off.max()} grey levels, {share_off:.2e} of values off (tol 1 level "
          f"on <= {RESIZE_SHARE}) [{card}]", flush=True)
    if off.max() > 1 or share_off > RESIZE_SHARE:
        fail("the on-card resize disagrees with the CPU resize")
    return dict(launches=e2e_counts["flash_fwd_dense"], featurizer_vps=vps, e2e_vps=n_ok / e2e_s)


def main():
    if not (ROOT / "blim_tpu_torch" / "kernels" / "csrc").is_dir():
        fail(f"the blim_tpu_torch package is not next to {Path(__file__).name}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} [{card}]", flush=True)

    phase_build()
    record = phase_kernels(card)
    st = phase_slice(card)
    phase_packed(st, card)
    t0 = time.time()
    train_records = phase_train_kernels(card)
    train = phase_train(st, card)
    phase_gradcheck(st, card)
    print(f"[time] phases 5-7 (train kernels, train, gradcheck) took {time.time() - t0:.1f}s",
          flush=True)
    b1_launches = st["launches"]
    del st                      # the 7B weights: phases 8-9 measure their own peak memory
    torch.cuda.empty_cache()
    t0 = time.time()
    vit_record = phase_vit_kernel(card)
    extract_st = phase_extract(card)
    print(f"[time] phases 8-9 (vit kernel, extract) took {time.time() - t0:.1f}s", flush=True)

    src = "blim_tpu_torch/kernels/csrc/"
    ref = "blim_tpu/kernels/flash_attention.py:"
    kernels = [{"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
                "replaces": ref + "42", "launches": b1_launches, **record}]
    for name, source, line in (("flash_fwd_lse", "flash_fwd.cu", "121"),
                               ("flash_dq", "flash_bwd.cu", "195"),
                               ("flash_dkv", "flash_bwd.cu", "252")):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + line, "launches": train["counts"][name],
                        **train_records[name]})
    kernels.append({"name": "flash_fwd_dense", "route": "cuda", "source": src + "flash_fwd.cu",
                    "replaces": ref + "42", "launches": extract_st["launches"], **vit_record})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
