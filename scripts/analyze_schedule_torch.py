#!/usr/bin/env python
"""Offline rerank-schedule analyzer on the PyTorch port: dispatched-vs-useful
FLOP decomposition. The port's counterpart of scripts/analyze_schedule.py,
with the same flags and the same printed report.

Mirrors bench.py's workload (same rng streams, caption-length profile,
byte-fallback tokenizer, layouts) and the port's RerankEngine pack
schedulers (blim_tpu_torch/engine/rerank.py: build_packs / build_tvg_packs +
the G-batch padding loops), then accounts every dispatched FLOP with the
same formulas the engine uses (blim_tpu_torch/utils/flops.py) and splits the
dispatched-minus-useful gap into named waste categories. Pure host compute,
no device: a schedule change's packing efficiency can be evaluated here
exactly, before paying for a run on the card. It imports torch's port only
(no JAX, no bench.py): `make_captions` below is a copy of bench.py's.

Waste categories (per pass):
  prefix_recompute   a video/caption prefix forwarded more than once because
                     its segments spill across packs (or, TVG, its queries
                     split across packs)
  pack_tail          pack rows dispatched beyond the pack's real token load
                     (size - load per pack)
  batch_pad          whole packs dispatched only to pad the G-batch to a
                     multiple of the step batch (repeated pack 0)
  cross_segment      attention computed across segment boundaries (the
                     packed attention scores the full (T, P+T) grid;
                     per-segment attention is the useful part)
  lm_overcount       lm_head / TVG-head positions beyond the real labeled
                     positions (packed CE runs on every pack position)
  query_pad          (TVG) flat query slots padded to the class's max_queries

Run: python scripts/analyze_schedule_torch.py [--queries 1000] [--finetuned-queries 256] [--sweep]
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from blim_tpu_torch.core.config import ModelConfig  # noqa: E402
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout  # noqa: E402
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer  # noqa: E402
from blim_tpu_torch.engine.rerank import (  # noqa: E402
    CaptionBank,
    batch_plan,
    build_packs,
    build_tvg_packs,
    default_pack_sizes,
    default_tvg_pack_classes,
    default_tvg_q_buckets,
    topk_pairs,
    unique_pairs,
)
from blim_tpu_torch.utils import flops as F  # noqa: E402

WORDS = ["man", "woman", "dog", "cat", "runs", "jumps", "sings", "cooks",
         "dances", "rides", "park", "kitchen", "stage", "street", "ball", "car",
         "talks", "plays", "guitar", "soccer", "child", "group", "slowly", "red"]


def make_captions(n, rng, budget):
    """Synthetic captions with MSRVTT's token-length profile under the byte
    tokenizer: lognormal(ln 12, 0.35) lengths clipped to [5, budget-2]
    (bench.py's generator)."""
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


def fmt_tf(x):
    return f"{x / 1e12:10.1f}"


QUIET = False


class PassReport:
    def __init__(self, name):
        self.name = name
        self.dispatched = 0.0
        self.useful = 0.0
        self.waste = defaultdict(float)

    def print(self):
        if QUIET:
            return self
        print(f"\n== {self.name} ==")
        print(f"  dispatched {fmt_tf(self.dispatched)} TF")
        print(f"  useful     {fmt_tf(self.useful)} TF   "
              f"(fraction {self.useful / self.dispatched:.3f})")
        gap = self.dispatched - self.useful
        acc = sum(self.waste.values())
        for k, v in sorted(self.waste.items(), key=lambda kv: -kv[1]):
            print(f"    waste {k:<18} {fmt_tf(v)} TF  ({v / self.dispatched:6.1%} of dispatched)")
        resid = gap - acc
        print(f"    waste {'(unattributed)':<18} {fmt_tf(resid)} TF  "
              f"({resid / self.dispatched:6.1%})")
        return self


def analyze_vtg_packed(cfg, layout, lens, cap_idx, vid_idx, pack_sizes,
                       token_budget, name, prior_prefix_len=None, n_data=1,
                       g_cap=8, prior_tokens=2200, prior_g_cap=8):
    """Mirror score_pairs_vtg_packed / compute_vtg_priors_packed accounting.

    prior_prefix_len: if set, this is the prior pass (one shared text prefix,
    key axis is all-zeros) with that prefix length; otherwise the score pass
    with the layout's full video prefix.
    """
    llm = cfg.llm
    rep = PassReport(name)
    is_prior = prior_prefix_len is not None
    P_len = prior_prefix_len if is_prior else layout.prefix_len

    # useful oracle (same as engine._useful_vtg / _useful_vtg_prior)
    if is_prior:
        n_caps = len(lens)
        rep.useful = F.prefix_forward_flops(llm, 1, P_len) + \
            F.suffix_forward_flops_varlen(llm, lens, P_len)
        key_idx = np.zeros(n_caps, np.int64)
        pay_idx = np.arange(n_caps)
    else:
        rep.useful = F.prefix_forward_flops(llm, len(np.unique(vid_idx)), P_len) + \
            F.suffix_forward_flops_varlen(llm, lens[cap_idx], P_len)
        key_idx, pay_idx = vid_idx, cap_idx

    n_prefix_useful = 1 if is_prior else len(np.unique(vid_idx))
    total_packs = 0
    if is_prior:
        # the one-time prior-prefix KV forward (compute_vtg_priors_packed
        # bills it at rerank.py's `prefix_forward_flops(llm, 1, P_prior)`);
        # without it the useful oracle — which also includes one prefix
        # forward — exceeds dispatched at small shapes
        rep.dispatched += F.prefix_forward_flops(llm, 1, P_len)
    for size, packs in build_packs(key_idx, pay_idx, lens, pack_sizes):
        m = len(packs)
        total_packs += m
        # engine-identical G: budget-derived per-chip batch scaled by the
        # mesh's data rows (rerank.py `G *= self.n_data`); the prior pass
        # runs its own geometry (broadcast prefix, rerank prior_pack_tokens)
        if is_prior:
            G = max(1, min(prior_tokens // (P_len + size), prior_g_cap)) * n_data
        else:
            G = max(1, min(token_budget // (P_len + size), g_cap)) * n_data
        m_pad = sum(batch_plan(m, G, n_data))
        n_batch_pad = m_pad - m
        # dispatched, engine-identically:
        if not is_prior:
            rep.dispatched += F.prefix_forward_flops(llm, m_pad, P_len)
        else:
            # prior packs broadcast the cached prefix KV: no per-pack prefix
            pass
        rep.dispatched += F.packed_suffix_forward_flops(llm, m_pad, size, P_len)

        # batch padding: whole repeated packs
        pad_fl = F.packed_suffix_forward_flops(llm, n_batch_pad, size, P_len)
        if not is_prior:
            pad_fl += F.prefix_forward_flops(llm, n_batch_pad, P_len)
        rep.waste["batch_pad"] += pad_fl

        for key, caps, _pos in packs:
            load = int(lens[np.asarray(caps)].sum())
            # pack tail: rows beyond the real load
            rep.waste["pack_tail"] += (
                F.packed_suffix_forward_flops(llm, 1, size, P_len)
                - F.packed_suffix_forward_flops(llm, 1, load, P_len)
            )
            # cross-segment attention: full (load, P+load) grid vs per-segment
            seg = lens[np.asarray(caps)].astype(np.float64)
            full_terms = float(load) * (P_len + load)
            seg_terms = float((seg * P_len + seg * (seg + 1.0) / 2.0).sum())
            rep.waste["cross_segment"] += F.attention_flops(llm, full_terms - seg_terms)
            # lm_head overcount: CE on every load position vs (len-1) labels
            lm_real = float((seg - 1.0).sum())
            rep.waste["lm_overcount"] += F.lm_head_flops(llm, load - lm_real)
    if not is_prior:
        rep.waste["prefix_recompute"] = F.prefix_forward_flops(
            llm, total_packs - n_prefix_useful, P_len)
    return rep.print()


def analyze_tvg_packed(cfg, layout, lens, cap_idx, vid_idx, classes,
                       token_budget, vocab_videos, name, head_len=None,
                       q_buckets=None, n_data=1, g_cap=8):
    """Mirror score_pairs_tvg_packed's run_pass accounting (one pass)."""
    llm = cfg.llm
    W = cfg.num_clips
    rep = PassReport(name)
    eff = lens if head_len is None else np.full(len(lens), head_len, np.int32)
    hl = layout.tvg_prefix_length

    # useful oracle — the engine's _useful_tvg splits score and prior parts;
    # replicate the relevant half here
    u_caps = np.unique(cap_idx)
    n = len(cap_idx)
    w_arr = np.full(n, W, np.float64)
    if head_len is None:
        rep.useful = F.prefix_forward_flops_varlen(llm, lens[u_caps])
        rep.useful += F.suffix_forward_flops_varlen(
            llm, w_arr, lens[cap_idx], lm_positions_per_suffix=0.0)
    else:
        rep.useful = F.prefix_forward_flops_varlen(
            llm, np.minimum(lens[u_caps], hl))
        rep.useful += F.suffix_forward_flops_varlen(
            llm, w_arr, float(hl), lm_positions_per_suffix=0.0)
    rep.useful += F.tvg_head_flops(cfg, n * W, vocab_videos)

    useful_prefix_tokens = (np.minimum(lens[u_caps], hl).sum() if head_len is not None
                            else lens[u_caps].sum())
    seg_tokens_total = 0.0
    for size, qn, packs in build_tvg_packs(cap_idx, vid_idx, eff, classes,
                                           q_buckets=q_buckets):
        m = len(packs)
        G = max(1, min(token_budget // (size + qn * W), g_cap)) * n_data
        m_pad = sum(batch_plan(m, G, n_data))
        n_batch_pad = m_pad - m
        rep.dispatched += F.packed_prefix_kv_flops(llm, m_pad, size)
        rep.dispatched += F.flat_query_suffix_flops(llm, m_pad * qn, W, size)
        rep.dispatched += F.tvg_head_flops(cfg, m_pad * qn * W, vocab_videos)

        rep.waste["batch_pad"] += (
            F.packed_prefix_kv_flops(llm, n_batch_pad, size)
            + F.flat_query_suffix_flops(llm, n_batch_pad * qn, W, size)
            + F.tvg_head_flops(cfg, n_batch_pad * qn * W, vocab_videos)
        )
        for segs in packs:
            seg_lens_pack = np.asarray(
                [min(int(eff[c]), int(eff[c])) for c, _v, _p in segs], np.float64)
            load = float(seg_lens_pack.sum())
            seg_tokens_total += load
            nq = sum(len(v) for _c, v, _p in segs)
            # pack tail
            rep.waste["pack_tail"] += (
                F.packed_prefix_kv_flops(llm, 1, size)
                - F.packed_prefix_kv_flops(llm, 1, int(load))
            )
            # cross-segment prefix attention: (load, load) vs block-diag causal
            full_terms = load * load
            seg_terms = float((seg_lens_pack * (seg_lens_pack + 1.0) / 2.0).sum())
            rep.waste["cross_segment"] += F.attention_flops(llm, full_terms - seg_terms)
            # query padding: unfilled flat-query slots
            rep.waste["query_pad"] += (
                F.flat_query_suffix_flops(llm, qn - nq, W, size)
                + F.tvg_head_flops(cfg, (qn - nq) * W, vocab_videos)
            )
            # real queries attend the whole pack instead of their own segment
            for c, vids, _p in segs:
                k = len(vids)
                own = float(eff[c])
                full_q = W * float(size) + W * (W + 1) / 2.0
                useful_q = W * own + W * (W + 1) / 2.0
                rep.waste["cross_segment"] += F.attention_flops(
                    llm, k * (full_q - useful_q))
    # prefix duplicated across packs (a caption's queries split across packs)
    rep.waste["prefix_recompute"] = max(
        0.0, (seg_tokens_total - float(useful_prefix_tokens))
    ) * F.decoder_matmul_flops_per_token(llm)
    return rep.print()


def build_workload(args, cfg, vtg_l, tvg_l, m, finetuned):
    """The bench's exact eval workload, host side only."""
    tok = ByteFallbackTokenizer()
    r = np.random.default_rng((args.seed, m, 0))
    caps = make_captions(m, r, args.caption_tokens)
    r.standard_normal((m, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size))
    t2v = r.standard_normal((m, m)).astype(np.float32) + 0.01
    v2t = r.standard_normal((m, m)).astype(np.float32) + 0.01
    vtg_bank = CaptionBank.build_vtg(caps, tok, "MSRVTT", vtg_l)
    vtg_lens = vtg_bank.suffix_mask.sum(axis=1).astype(np.int32)
    v_rows, v_cols = topk_pairs(v2t, args.topk)
    t_rows, t_cols = topk_pairs(t2v, args.topk)
    item_vid = np.arange(m)
    all_caps = np.concatenate([v_cols, t_rows])
    all_vids = np.concatenate([item_vid[v_rows], item_vid[t_cols]])
    u_cap, u_vid, _ = unique_pairs(all_caps, all_vids)
    tvg_lens = None
    if finetuned:
        tvg_bank = CaptionBank.build_tvg(caps, tok, tvg_l)
        tvg_lens = tvg_bank.prefix_mask.sum(axis=1).astype(np.int32)
    return vtg_lens, tvg_lens, u_cap, u_vid


def flow_totals(cfg, vtg_l, tvg_l, wl, finetuned, pack_sizes, tvg_classes,
                token_budget, label="", q_buckets=None, n_data=1, g_cap=8,
                prior_tokens=2200, prior_g_cap=8):
    vtg_lens, tvg_lens, u_cap, u_vid = wl
    m = None
    reports = [
        analyze_vtg_packed(cfg, vtg_l, vtg_lens, u_cap, u_vid, pack_sizes,
                           token_budget, f"{label} VTG score (packed)",
                           n_data=n_data, g_cap=g_cap),
        analyze_vtg_packed(cfg, vtg_l, vtg_lens, None, None, pack_sizes,
                           token_budget, f"{label} VTG prior (packed)",
                           prior_prefix_len=len(vtg_l.prior_prefix()[0]),
                           n_data=n_data, g_cap=g_cap,
                           prior_tokens=prior_tokens, prior_g_cap=prior_g_cap),
    ]
    if finetuned:
        m = int(u_vid.max()) + 1
        # engine-identical prior dedup: prior(c, v) == prior(len(c), v),
        # one representative caption per distinct prefix length
        lenk = tvg_lens[u_cap].astype(np.int64)
        uk = np.unique(np.stack([lenk, u_vid.astype(np.int64)], axis=1), axis=0)
        rep_for_len = {}
        for c in np.unique(u_cap):
            rep_for_len.setdefault(int(tvg_lens[c]), int(c))
        p_cap = np.array([rep_for_len[int(L)] for L, _v in uk], np.int64)
        p_vid = uk[:, 1]
        reports += [
            analyze_tvg_packed(cfg, tvg_l, tvg_lens, u_cap, u_vid,
                               tvg_classes, token_budget, m,
                               f"{label} TVG score (packed)",
                               q_buckets=q_buckets, n_data=n_data, g_cap=g_cap),
            analyze_tvg_packed(cfg, tvg_l, tvg_lens, p_cap, p_vid,
                               tvg_classes, token_budget, m,
                               f"{label} TVG prior (packed, head-only, deduped)",
                               head_len=tvg_l.tvg_prefix_length,
                               q_buckets=q_buckets, n_data=n_data, g_cap=g_cap),
        ]
    disp = sum(r.dispatched for r in reports)
    use = sum(r.useful for r in reports)
    return disp, use, reports


def sweep(args, cfg, vtg_l, tvg_l):
    """Try candidate pack-size grids / TVG class sets offline; report total
    dispatched FLOPs for each (useful is schedule-independent)."""
    global QUIET
    QUIET = True
    token_budget = 2200
    P_full = tvg_l.prefix_len
    top = -(-vtg_l.suffix_width // 128) * 128
    extra = {top} if top > 768 else set()
    top_t = max(512, -(-P_full // 128) * 128)

    size_grids = {
        "r2 step128 {128..768}": tuple(sorted({128, 256, 384, 512, 640, 768} | extra)),
        "CUR step64 {64..768}": default_pack_sizes(vtg_l.suffix_width),
        "step32 {32..768}": tuple(sorted(set(range(32, 769, 32)) | extra)),
        "step64 {64..512}+{640,768}": tuple(sorted(set(range(64, 513, 64)) | {640, 768} | extra)),
    }
    class_sets = {
        "r2 ((128,160),(256,96),(512,160))": ((128, 160), (256, 96), (top_t, 160)),
        "CUR (448,160) 4-class": default_tvg_pack_classes(P_full),
        "4cls +384": ((128, 160), (256, 96), (384, 128), (top_t, 160)),
        "qmax192": ((128, 192), (256, 128), (top_t, 192)),
        "qmax256 top640": ((128, 160), (256, 128), (384, 160), (640, 256)),
        "fine (128,64)(192,96)(256,128)(384,160)(512,192)":
            ((128, 64), (192, 96), (256, 128), (384, 160), (top_t, 192)),
    }

    # decoupled (size x qcap) classification: sizes from the class table,
    # qcap from an independent bucket grid (see build_tvg_packs q_buckets)
    cur_cls = default_tvg_pack_classes(P_full)
    fine_sizes = tuple(
        (s, 160) for s in sorted({64, 128, 192, 256, 320, 384, 448} | {top_t})
        if s <= top_t)
    qbucket_sets = {
        "coupled (None)": (cur_cls, None),
        "q{32..160 step32}": (cur_cls, (32, 64, 96, 128, 160)),
        "q{16..160 step16}": (cur_cls, tuple(range(16, 161, 16))),
        "sizes64 q{16..160 step16}": (fine_sizes, tuple(range(16, 161, 16))),
        "sizes64 q{8..160 step8}": (fine_sizes, tuple(range(8, 161, 8))),
    }

    for label, m, finetuned in [("zero-shot", args.queries, False),
                                ("fine-tuned", args.finetuned_queries, True)]:
        if m <= 0:
            continue
        wl = build_workload(args, cfg, vtg_l, tvg_l, m, finetuned)
        print(f"\n#### sweep {label} ({m} queries)")
        base = None
        for gname, grid in size_grids.items():
            for cname, cls in (class_sets.items() if finetuned
                               else [("-", ((128, 160), (256, 96), (top_t, 160)))]):
                disp, use, _ = flow_totals(cfg, vtg_l, tvg_l, wl, finetuned,
                                           grid, cls, token_budget,
                                           n_data=args.n_data, g_cap=args.g_cap,
                                           prior_tokens=args.prior_tokens,
                                           prior_g_cap=args.prior_g_cap)
                if base is None:
                    base = disp
                print(f"  sizes[{gname:<28}] classes[{cname:<44}] "
                      f"disp {disp/1e12:8.1f} TF  frac {use/disp:.3f}  "
                      f"vs cur {disp/base:6.3f}")
        if not finetuned:
            continue
        cur_sizes = default_pack_sizes(vtg_l.suffix_width)
        for qname, (cls, qb) in qbucket_sets.items():
            disp, use, _ = flow_totals(cfg, vtg_l, tvg_l, wl, finetuned,
                                       cur_sizes, cls, token_budget,
                                       q_buckets=qb, n_data=args.n_data,
                                       g_cap=args.g_cap,
                                       prior_tokens=args.prior_tokens,
                                       prior_g_cap=args.prior_g_cap)
            print(f"  sizes[{'CUR step64':<28}] qbuckets[{qname:<43}] "
                  f"disp {disp/1e12:8.1f} TF  frac {use/disp:.3f}  "
                  f"vs cur {disp/base:6.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--finetuned-queries", type=int, default=256)
    ap.add_argument("--topk", type=int, default=16)
    ap.add_argument("--caption-tokens", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--g-cap", type=int, default=8,
                    help="engine packs-per-step cap (RerankEngine.g_cap); keep "
                         "in sync so the analyzer's dispatch model matches an "
                         "engine tuned to a different cap")
    ap.add_argument("--prior-tokens", type=int, default=2200,
                    help="prior-pass tokens per step (RerankEngine.prior_pack_tokens)")
    ap.add_argument("--prior-g-cap", type=int, default=8,
                    help="prior-pass packs-per-step cap (RerankEngine.prior_g_cap)")
    ap.add_argument("--n-data", type=int, default=1,
                    help="mesh data-axis size (the engine scales step batches "
                         "G by n_data and ladders in n_data-row units); 1 = "
                         "the single-chip bench shape")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep candidate pack-size grids / class sets")
    args = ap.parse_args()

    cfg = ModelConfig()
    tok = ByteFallbackTokenizer()
    vtg_l = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg,
                            max_caption_tokens=args.caption_tokens)
    tvg_l = make_tvg_layout(tok, cfg.num_clips,
                            max_caption_tokens=args.caption_tokens)

    if args.sweep:
        sweep(args, cfg, vtg_l, tvg_l)
        return

    # the engine's schedule knobs (single source of truth in rerank.py)
    pack_sizes = default_pack_sizes(vtg_l.suffix_width)
    token_budget = 2200
    tvg_classes = default_tvg_pack_classes(tvg_l.prefix_len)
    q_buckets = default_tvg_q_buckets(tvg_classes)

    for label, m, finetuned in [("zero-shot", args.queries, False),
                                ("fine-tuned", args.finetuned_queries, True)]:
        if m <= 0:
            continue
        wl = build_workload(args, cfg, vtg_l, tvg_l, m, finetuned)
        vtg_lens, tvg_lens, u_cap, u_vid = wl
        print(f"\n#### {label}: {m} queries, topk {args.topk}, "
              f"{len(u_cap)} unique VTG pairs "
              f"(P_vtg={vtg_l.prefix_len}, suffix lens median "
              f"{np.median(vtg_lens):.0f})")
        if finetuned:
            print(f"  TVG prefix lens: median {np.median(tvg_lens):.0f}, "
                  f"head {tvg_l.tvg_prefix_length}, P_full {tvg_l.prefix_len}")
        disp, use, _ = flow_totals(cfg, vtg_l, tvg_l, wl, finetuned,
                                   pack_sizes, tvg_classes, token_budget, label,
                                   q_buckets=q_buckets, n_data=args.n_data,
                                   g_cap=args.g_cap,
                                   prior_tokens=args.prior_tokens,
                                   prior_g_cap=args.prior_g_cap)
        print(f"\n  {label} TOTAL: dispatched {disp/1e12:.1f} TF, useful "
              f"{use/1e12:.1f} TF, fraction {use/disp:.3f}")


if __name__ == "__main__":
    main()
