#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (all numbers beside the card's name and power limit):
  1. build    compile every hand-written kernel of the main path from the
              checkout's sources (nvcc, sm_90a; one source so far);
  2. kernels  hold each kernel to its plain PyTorch version on the card at
              the main path's shapes, and time kernel, plain version, one
              PyTorch library call of the same function (yardstick only)
              and the card's bound for the same work;
  3. slice    the zero-shot rerank flow (CPN priors + packed VTG scoring) at
              Qwen2-7B width and depth in bf16 with seeded random weights
              and synthetic inputs: untimed at WARM_ITEMS, timed at ITEMS;
              the kernel launch counts of the timed run must match the path;
  4. packed   packed shared-prefix scores against the naive full-sequence
              path on the card.
Then one JSON line of kernel records, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Without a CUDA GPU, or without the package next to this script,
it fails at once.
"""

from __future__ import annotations

import json
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
PACKED_TOL = 5e-2    # max |packed - naive| on per-caption mean CE (~12)
                     # after 28 bf16 layers computed in a different order

ITEMS = 256          # queries in the timed run
WARM_ITEMS = 64      # queries in the untimed run before it
TOPK = 16
CAPTION_TOKENS = 96  # caption budget of the VTG layout
SEED = 0

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


def attention_bound_ms(b, s, hq, hkv, d, key_mask, query_mask):
    """Least time for one causal attention call on this card: each input read
    once and the output written once, against the FLOPs of the (query, key)
    pairs these masks leave visible; the larger of the two, and which."""
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    if key_mask is not None:
        nbytes += 2 * 4 * b * s
        km = key_mask.bool().cpu().numpy()
        qm = query_mask.bool().cpu().numpy()
        pairs = float((np.cumsum(km, axis=1) * qm).sum())
    else:
        pairs = float(b * s * (s + 1) // 2)
    flops = 4.0 * d * hq * pairs
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def phase_build():
    from blim_tpu_torch.kernels import flash_attention as fa

    t0 = time.time()
    report = fa.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] flash_fwd.cu -> {fa.library_path().name} for sm_90a in {secs:.1f}s"
          + ("" if report else " (already built)"), flush=True)
    for ln in ptxas:
        print(f"[build]   {ln}", flush=True)


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
        ms = gpu_time_ms(lambda: fa.flash_attention(q, k, v, key_mask=mask, query_mask=mask))
        plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, mask, mask, True, d ** -0.5))
        idx = torch.arange(s, device="cuda")
        allowed = (idx[:, None] >= idx[None, :])[None, None]
        if mask is not None:
            allowed = allowed & mask.bool()[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            lib_ms = gpu_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed, enable_gqa=True))
        except TypeError:            # a PyTorch without enable_gqa
            lib_ms = None
        bound_ms, bound_by = attention_bound_ms(b, s, hq, hkv, d, mask, mask)
        print(f"[kernels] flash_fwd {name}: max|d|={err:.3e} "
              f"(tol {ATTN_ATOL} + {ATTN_RTOL}|plain|) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]", flush=True)
        if excess > ATTN_ATOL:
            fail(f"kernel case {name}: |kernel - plain| exceeds {ATTN_ATOL} + "
                 f"{ATTN_RTOL}|plain| (max |d| {err:.3e})")
        if name == "G=4 S=341 CPN holes":
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
    record["max_abs_err"] = worst
    return record


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
    fa.launches = 0
    inputs, engine, t2v, v2t, elapsed = run_flow(flow, ITEMS)
    launches = fa.launches
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
    if launches != expected or launches == 0:
        fail(f"flash_fwd launches {launches} != expected {expected}")
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

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "blim_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "blim_tpu/kernels/flash_attention.py:42",
        "launches": st["launches"],
        **record,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
