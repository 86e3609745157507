#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (all numbers beside the card's name and power limit):
  1. build    compile every hand-written kernel from the checkout's sources
              (nvcc, sm_90a, one process per source, all at once) and print
              each kernel's registers, spills and shared memory (B1's on one
              line of their own); a spill or a ptxas warning that it
              serialized a kernel's wgmma fails;
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
  5. finetuned  the fine-tuned rerank flow on phase 3's weights with a LoRA
              tree (r 8, alpha 32, B factors seeded off zero) on the LLM and
              the projector made on the card from SEED: VTG and TVG packed
              scoring with both CPN priors, the six score matrices; untimed at
              WARM_ITEMS, timed at ITEMS, B1's launches checked against the
              VTG prefix forwards (the TVG packed prefixes and flat queries
              are plain PyTorch, as they are plain XLA in the JAX package);
              then the packed TVG scores and priors of 8 pairs against the
              naive full-sequence score_tvg, and the same pairs re-scored
              with a planted segment, position or bf16-product fault, to show
              what the tolerance can see;
  5b. naive   the naive per-pair schedule (evaluation(shared_prefix=False):
              16 pairs a full-sequence forward, the candidate grids' priors a
              second forward) at NAIVE_ITEMS on phase 5's weights and LoRA
              tree, against the packed evaluation of the same inputs (VTG
              within GRID_VTG_TOL on the max and GRID_VTG_MEAN_TOL on the
              mean, TVG within TVG_TOL, the same fill cells);
              B1 launches = 28 x its forwards; the packed evaluation re-run
              with a planted VTG segment or position fault must exceed one of
              the two VTG limits; then phase 13's one-process
              yardsticks are kept (phases 3 and 5's matrices; after phase 8,
              DP_TRAIN_STEPS train steps accumulated over the batch's parts);
  5c. rectangle  the rectangle schedule (evaluation(packed=False): groups of
              2 x TOPK suffixes, remainders in k-buckets 16/8/4, one B1 prefix
              forward a group, the TVG caption prefixes left-padded and
              trimmed to 96/128/192/249 at their absolute positions, a second
              TVG prefix pass under the CPN mask) at ITEMS on phase 5's
              weights and LoRA tree, held to phase 5's packed matrices (VTG
              within GRID_VTG_TOL / GRID_VTG_MEAN_TOL, TVG within TVG_TOL, the
              same fill cells); B1 launches = 28 x its prefix forwards, each
              TVG prefix forward 28 of them; wall, q/s, steps, peak and the
              split by pass beside phase 5's; at NAIVE_ITEMS, a planted VTG
              position fault and a TVG prefix position fault (positions
              restarting at 0) must each exceed a limit; B1 at the two most
              common TVG rectangle shapes under their left-padded and CPN
              masks against its plain version, timed like phase 2 (the most
              common one is the record);
  6. train-kernels  B1-lse, B3 (flash_dq) and B4 (flash_dkv) against their
              plain versions at the train step's VTG and TVG shapes, timed
              like phase 2 (library yardstick: SDPA forward, and SDPA's
              backward for dq + dk + dv together);
  7. train    the 7B LoRA train step (VTG + TVG losses, backward through the
              frozen 7B with per-layer recompute, AdamW) on phase 3's
              weights: TRAIN_WARM untimed steps, then TRAIN_STEPS timed
              ones whose launch counts must match the path;
  8. gradcheck  at full width and GRADCHECK_LAYERS layers, the loss and the
              LoRA gradients through the kernels against the same step
              through the plain attention;
  9. vit-kernel  B2 (flash_fwd_dense.cu, d = 64, dense non-causal) against
              its plain version at VIT_CLIPS clips of the ViT's (clips, 3136,
              16, 64), q, k, v strided views of one packed qkv tensor, and at
              the featurizer's EXTRACT_B x 4 clips (the plain version
              VIT_CLIPS clips at a time); both timed like phase 2 (library
              yardstick: SDPA), each line with the bound, the exponentials'
              floor and the share of the bound reached; then B2 and B2-lse,
              untimed, at RAGGED_S, whose q and kv tiles are both ragged;
 10. extract  the UMT ViT-L tower at res448, full depth, in bf16 from SEED on
              the card, with ToMe: the featurizer at EXTRACT_B videos (one
              untimed batch, EXTRACT_TIMED timed in a pipeline, launches
              checked); the tower through B2 against the same tower through
              the plain attention; ToMe on the card against ToMe on the CPU
              on the same fp32 tower output; then the extraction pipeline
              (run_extraction, device preprocessing) over E2E_VIDEOS synthetic
              videos of 16 uint8 frames of FRAME_HW, saved through the
              feature store, with the on-card resize held to the CPU resize;
 11. cli      the train/eval CLI on a checkpoint directory: the seeded
              Qwen2-7B (CLI_LAYERS layers) and ViT-L tower written in the
              published layout (config.json, sharded safetensors with an
              index) into a temporary directory, read back through the
              streaming loader and held to the seeded tree bit for bit; a
              synthetic MSRVTT root (CLI_TEST_ITEMS test, CLI_TRAIN_ITEMS
              train items, a features.pack, the score matrices), whose
              FeatureStore must read through the native reader and gather
              what a numpy memmap gathers bit for bit; then
              pipelines.main in-process three times (zero-shot eval with
              --preset, one training epoch, the fine-tuned eval of the saved
              best state with --resume, whose table must equal the epoch's),
              launch counts checked against each run's path, the zero-shot
              run's feature gathers through the native reader; and
              pipelines.extract.main on the checkpoint's tower over
              CLI_VIDEOS synthetic videos, held to the featurizer on the
              seeded tower;
 12. chat     the seeded Qwen2-7B + ViT-L in bf16: `chat` end to end at the
              CHAT_FRAMES cap on a synthetic video written with OpenCV (or,
              without a decoder, load_video replaced by the seeded frames;
              the line says so): decode, preprocess, featurizer (B2, 23
              launches), prefill (B1, 28), greedy decode of CHAT_NEW_TOKENS,
              with its breakdown and peak memory; `generate` on the chat's
              prompt and video embedding: time to first token, decode
              ms/token against the weight-read bound, and the cached steps'
              logits against one teacher-forced full forward (DECODE_TOL; a
              cache planted without the prompt's K/V must exceed it, a RoPE
              position one late is printed beside); the image path
              (encode_image_tiles + merge_image_patches on a 2 x 2 anyres
              grid plus the base view, the tower through B2 against the
              plain tower); then B1 at the chat's prefill shape and B2 at
              the tiles' shape against their plain versions, timed like
              phases 2 and 9, and B1, untimed, at RAGGED_PREFILL_S under a
              mask with runs of zeros inside a few interior kv tiles.
 13. dp       data parallel over processes (torch.multiprocessing spawn, each
              group joined within DP_TIMEOUT_S and killed on expiry; a rank's
              failure fails the script): 13a, DP_WORLD gloo ranks sharing
              cuda:0 each build phase 3's 7B and inputs and phase 5's LoRA
              tree, run both flows at ITEMS with the packs sharded and the
              scores merged, and are held to phases 3 and 5's matrices
              (DP_VTG_TOL / DP_VTG_MEAN_TOL VTG, TVG_TOL TVG; the VTG cells
              whose pack a rank scored in a step of the one-process step's
              batch size within DP_SAME_SHAPE_TOL), to each other bit for
              bit, to
              disjoint pack shards covering the one-process pack count, and
              to B1 = 28 x their prefix forwards; then DP_TRAIN_STEPS
              data-parallel LoRA train steps on their halves of a B = TRAIN_B
              batch: trees identical across ranks bit for bit, the applied
              gradient within GRADCHECK_TOL of the one-process step's (the
              mean of the halves' gradients) and the first step's tree too,
              112 / 56 / 56 B1-lse / B3 / B4 launches a rank a step; a
              control rank at world 1 (gloo, every pack in its shard, so
              every step as in one process) runs the fine-tuned flow, held
              to phase 5's matrices within DP_SAME_SHAPE_TOL;
              13b, pipelines.main under a torchrun-style environment at world
              1 on phase 11's synthetic MSRVTT root and the seeded 7B: NCCL,
              the collectives counted, a zero-shot eval whose table equals
              the same eval without the environment, and a one-epoch run;
              13c, with two or more cards, 13a with one NCCL rank a card.
 14. dormant  (run after phase 8, on phase 3's 7B) PyramidDrop on PDROP_ROWS VTG rows,
              held on their caption scores within PACKED_TOL:
              keep-all against vtg_hidden, one uniform stage (PDROP_LAYER,
              PDROP_RATIO) through B1 against its plain-attention run
              (equal kept tokens; positions left un-renumbered after the drop,
              planted, must exceed it), one attention-ranked stage, 28
              B1 launches each; the sliding window (WINDOW) on the card,
              forward and backward, against the CPU plain version; and, in
              phase 11's fine-tuned eval, --profile_dir's trace.
 15. parity   (run after phase 14, on phase 3's 7B and phase 5's LoRA tree)
              qwen2.forward_logits at full width and depth on 2 x PARITY_TOKENS
              text tokens, one row right-padded, through B1 (28 launches)
              against the same call through the plain attention, held on the
              rows' VTG likelihood over a label window within PACKED_TOL (not on
              logits: a position fault hides under the bf16 hidden-state gap);
              the two window-CE routes (vtg_likelihood of chunked_window_logits
              against the fused vtg_likelihood_from_hidden) on the same hidden
              within WINDOW_CE_TOL; the LoRA tree merged into a copy of the
              attention kernels, lm_head and projector (lora.merge_lora) scoring
              MERGE_ROWS VTG rows with lora=None against the unmerged tree with
              the LoRA applied, within MERGE_TOL, and a merge planted without
              its scale must exceed it (a merge with the layers' factors in
              reverse order is printed beside); the same comparison on an fp32
              copy of the 7B through the plain attention, within MERGE_F32_TOL
              (the witness that the bf16 gap is rounding, not the merge), the
              scale left out above it; then scripts/parity_torch.py
              --synthetic --device cuda in a subprocess (head dim 128, so B1,
              B1-lse, B3 and B4 run): exit 0, no FAIL, step 5 PASS, step 2 PASS
              or SKIP (transformers absent), every one of those kernels
              launched; last, B1-lse, B3 and B4 at that harness's train shapes
              (2 q heads on 1 K/V head: B4's cluster of 2), on the masks one
              of its train steps gives them (recorded in this process), with
              unit-normal q, k, v and dO, against their plain versions at
              ATTN_ATOL / LSE_TOL / GRAD_TOL.
 16. vit-grad  (run after phase 10, on its seeded ViT-L tower) the tower's
              gradient on the card: 16a, B2-lse (flash_fwd_dense_lse) and
              the fused d 64 backward (flash_bwd_dense, which replaces B3-d64
              and B4-d64, with its preprocess and convert passes,
              flash_bwd_dense_prep and flash_bwd_dense_convert) against
              their plain versions at VIT_CLIPS clips of (3136, 16, 64), q,
              k, v strided views of one packed qkv, the backward run twice
              (dq's spread between runs under DQ_RUN_SPREAD x max|plain|, dk
              and dv equal bit for bit), timed like phases 2 and 6 (library
              yardstick: SDPA's forward and its backward), and held
              (untimed) at the image tiles' (5, 784, 16, 64); 16b, the
              gradient of a seeded linear loss on GRAD_VIT_LAYERS blocks at
              full width and GRAD_VIT_CLIPS clips through the kernels against
              the same through the plain attention in fp32, on the pixels and
              the first and last blocks' qkv and fc2 kernels (GRAD_TOL x
              max|plain|), and again with a planted backward fault (lse +
              log 2; dk and dv swapped), each of which must exceed it; 16c,
              the whole tower (23 blocks) forward and backward at VIT_CLIPS
              clips, timed (one untimed, VIT_GRAD_TIMED timed), its peak
              memory, every gradient finite and exactly 23 launches of each
              of the four kernels a run (B2-lse, the fused backward and its
              two passes) and none of any other.
Then the whole script's time, one JSON line of kernel records, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Without a CUDA GPU, or without the package next to this script,
it fails at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, dense bf16 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
SMS = 132                     # streaming multiprocessors of an H100 SXM
TENSOR_FLOPS_PER_CLOCK = 4096 # dense bf16 tensor-core flops a clock an SM
EXP_PER_CLOCK = 16            # exp2 (ex2.approx) a clock an SM on the SFUs

ATTN_ATOL, ATTN_RTOL = 1e-2, 2e-2   # |kernel - plain| <= atol + rtol |plain|:
                     # two bf16 ulps (both round P and O to bf16, at different
                     # points of the online softmax)
LSE_TOL = 1e-3       # |kernel - plain| lse on query-mask-1 rows: fp32 sums of
                     # exact bf16 products in another order, ~1e-6 relative at |lse| ~ 7
DQ_RUN_SPREAD = 1e-2 # max |dq run 1 - dq run 2| over max|plain| of the fused d 64 backward:
                     # its dQ tiles reach the fp32 accumulator in L2 in no fixed order, so
                     # two runs may differ in dq's last bits (dk and dv must not differ)
DELTA_TOL = 1e-5     # |kernel - plain| delta = rowsum(dO * O) over max|plain|: fp32 sums of
                     # 64 products in another order
GRAD_TOL = 3e-2      # |kernel - plain| dq, dk, dv over max|plain|: the kernels
                     # round P and dS to bf16 before their tensor-core products
                     # and write bf16; the plain version keeps fp32 to the end
PACKED_TOL = 5e-2    # max |packed - naive| on per-caption mean CE (~12) after 28
                     # bf16 layers computed in a different order
WINDOW_CE_TOL = 1e-3 # max |vtg_likelihood(chunked_window_logits(h)) - vtg_likelihood_from_hidden(h)|
                     # (phase 15): the same bf16 products with fp32 sums, the logsumexp
                     # over the vocabulary in one piece against 16384-wide chunks; ~12
MERGE_TOL = PACKED_TOL   # max |merged LoRA - applied LoRA| VTG caption score (phase 15): the
                     # merged kernels round W + scale A B to bf16 once, the applied LoRA
                     # adds the fp32 delta's bf16 product to the bf16 base product
PARITY_TOKENS = 64   # phase 15's forward_logits check: 2 rows of text tokens, the second
PARITY_REAL = 40     # right-padded after PARITY_REAL; scored over a window inside both
PARITY_WINDOW = (8, 32)   # rows' real tokens: (start, length)
MERGE_F32_TOL = 1e-3 # the same gap with the 7B, the LoRA and the merge in fp32 through the
                     # plain attention (phase 15): fp32 rounding only, so a merge that is
                     # algebraically wrong anywhere shows here far above it
MERGE_ROWS = 8       # VTG rows scored on the merged tree and with the LoRA applied
MERGE_DECODE_TOKENS = 16  # greedy tokens timed on the merged tree and with the LoRA applied
PARITY_SCRIPT_TIMEOUT_S = 420   # scripts/parity_torch.py --synthetic on the card
TVG_TOL = 1.5e-2     # max |packed - naive| TVG score and prior (per-clip mean CE
                     # over the vocabulary, ~log ITEMS) on 8 pairs: above the
                     # error of a right port, below what a planted segment or
                     # position fault moves (phase 5 checks both). On an H100
                     # with the seeded 7B: right port up to ~6e-3, segment
                     # fault ~7e-2, position one off ~4e-2
LORA_B_STD = 0.02    # the smoke's LoRA B factors, seeded off zero (as the CPU
                     # tests make them) so the adapters add to every product
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
NAIVE_ITEMS = 32     # the naive schedule's check: 4 grids of NAIVE_ITEMS x TOPK pairs, 16
                     # a step, 6 x 32 forwards of 16 x ~440 tokens
GRID_VTG_TOL = 1e-1  # max |naive - packed| over a whole grid's VTG scores (phase 5b): the
                     # two schedules compute every score in another order. PACKED_TOL was
                     # set on 8 pairs (their max 2-3e-2 on an H100); over phase 5b's 1,536
                     # cells the tail of the same bf16 spread reached 5.4e-2 (0.43% of
                     # ~12.6), so a whole grid takes twice PACKED_TOL on its max and
GRID_VTG_MEAN_TOL = 2e-2  # this on its mean |a - b|, which a fault moving every score exceeds;
                     # phase 5b re-runs the packed side with a planted segment and position
                     # fault, each of which must exceed one of the two (on an H100: clean
                     # 5.4e-2 / 1.3e-2, segment 1.41 / 0.31, position one late 0.68 / 0.16)

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

RAGGED_S = 1000      # phase 9's untimed sequence length: no multiple of a q or a kv tile
VIT_CLIPS = 8        # B2's check and record shape: the end-to-end batch, 2 videos x 4 clips;
                     # also B2-lse's, the fused d 64 backward's and the whole tower's
                     # gradient (phase 16)
GRAD_VIT_LAYERS = 4  # phase 16b: blocks of the tower whose gradient is held to the plain
GRAD_VIT_CLIPS = 2   # attention's, at full width, and its clips
VIT_GRAD_TIMED = 3   # phase 16c: timed forward + backward runs of the whole tower
EXTRACT_B = 16       # featurizer batch in videos (the JAX package's featurizer bench)
EXTRACT_TIMED = 5    # timed featurizer batches after one untimed
E2E_VIDEOS = 32      # end-to-end extraction: videos, batch, frames of each video
E2E_B = 2
FRAME_HW = (240, 320)   # MSRVTT-like source frames, smaller than 448^2: shipped raw

CLI_LAYERS = 28      # phase 11's checkpoint depth: the full Qwen2-7B (15.2 GB bf16 + the
                     # 0.58 GB tower); the chip machine's temporary directory holds it
CLI_SHARD_BYTES = 5 * 10**9   # ~4 shards, as the published checkpoint
CLI_TEST_ITEMS = 64  # the CLI's synthetic MSRVTT test split (one caption a video)
CLI_TRAIN_ITEMS = 16 # its train split: 4 steps of batch 4
CLI_VIDEOS = 8       # extract.main's synthetic videos, batch 4

CHAT_FRAMES = 512    # the chat's frame cap (load_video's default): 128 clips, 8192 video tokens
CHAT_FPS = 1.0       # the synthetic video: CHAT_FRAMES + 2 frames at 1 fps, so ~1 fps
CHAT_HW = (240, 320) # sampling reaches the cap; MSRVTT-like frames
CHAT_NEW_TOKENS = 64 # greedy tokens of the chat and of the generate check
CHAT_PROMPT = "Describe what happens in the video, step by step."
RAGGED_PREFILL_S = 5001   # phase 12's untimed long B1 check: 40 q and kv tiles of 128, the
                          # last of 9 rows (its second consumer has no row below S)
RAGGED_PREFILL_HOLES = ((1000, 1007), (2600, 2660), (4100, 4101))   # its masked keys, inside
                          # kv tiles 7, 20 and 32
DECODE_TOL = 0.1     # max |cached decode - teacher-forced full forward| over the 64 steps'
                     # logits, relative to max |full forward logits|: both sides are bf16
                     # through 28 layers, the decode's single-token products and the
                     # prefill's K/V against the full forward's batched products and B1;
                     # a cache that lost the prompt's K/V (planted in phase 12) must exceed it
DP_WORLD = 2         # phase 13a: ranks sharing the one card (gloo: NCCL refuses two ranks a card)
DP_CARDS = 4         # phase 13c: at most this many cards, one NCCL rank each
DP_TRAIN_STEPS = 2   # data-parallel LoRA train steps; each rank takes TRAIN_B // world rows
DP_TIMEOUT_S = 420   # a group of ranks, spawn to join; killed after it
DP_VTG_TOL = PACKED_TOL   # max |rank - one process| over phase 13's VTG matrices. Sharding
                     # alone moves only the packs that a rank scores in a step of another
                     # batch size than one process does (other GEMM shapes): on an H100,
                     # 213 of 8,192 cells at 2 ranks, by up to 4.2e-2 with the LoRA on and
                     # 2.9e-6 without; every other cell, and a world-1 rank, bit for bit
DP_VTG_MEAN_TOL = 1e-3    # its mean |rank - one process| (1.7e-4 on an H100): a shard whose
                     # scores land on the wrong pairs moves the mean by ~1
DP_SAME_SHAPE_TOL = 1e-5  # max |rank - one process| where the step that scored a cell's pack
                     # had the one-process step's batch size (the world-1 control, and the
                     # cells of the sharded ranks whose step kept its size): 0 on an H100
DP_GROUP_TIMEOUT_S = 180  # the process group's timeout: one collective's longest wait
PDROP_LAYER = 8      # phase 14's PyramidDrop stage: layer 8 ranks (the first rank layer
PDROP_RATIO = 0.5    # of the 8/16/24 schedule the config reader test uses) and half the
                     # video stays; BLiM's configs set no stage
PDROP_ROWS = 8       # VTG rows of phase 14's PyramidDrop checks; they are held on their
                     # caption scores (the label window, shifted left by the dropped
                     # tokens) within PACKED_TOL, not on the final hidden: that differs by
                     # ~4% (Frobenius) between two attention versions through 28 seeded
                     # random bf16 layers with or without a drop (4.1e-2 / 3.9e-2 on an
                     # H100), which a planted position fault (7.6e-2) barely exceeds. On an
                     # H100 the scores read 1.8e-2 through B1 vs plain with the drop (1.4e-2
                     # without), the planted fault 0.11
WINDOW = 128         # phase 14's sliding window (dormant in BLiM configs)
IMAGE_SIDE = 896     # the image path's seeded image: 896 x 896 takes the 2 x 2 grid of
IMAGE_GRID = "(1x1),...,(2x2)"  # these pinpoints, 4 tiles + the base view at 448

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


def raw_fwd_dense(q, k, v, with_lse=False):
    """A zero-argument call of flash_fwd_dense.cu's C entry point on q, k, v
    (d = 64) read in place, its outputs allocated once: no checks, no launch
    counted."""
    from blim_tpu_torch.kernels import flash_attention as fa

    _, _, call = fa._dense_forward_call(q, k, v, with_lse, q.shape[-1] ** -0.5)
    return checked(call, "flash_fwd_dense",
                   fa._library("flash_fwd_dense").blim_flash_fwd_dense_error_string)


def checked(call, name, error_string):
    """call, failing the run when its C entry point returns a CUDA error."""
    def run():
        rc = call()
        if rc:
            fail(f"blim_{name}: CUDA error {rc} ({error_string(rc).decode()})")
    return run


def raw_bwd_dense(q, k, v, dout, out, lse):
    """flash_bwd_dense.cu's three C entry points on operands prepared once,
    as the wrapper prepares them (q, k, v, dO and O read in place): (dq, dk,
    dv, delta, acc, prep, fused, convert), each call checked, none
    counted."""
    from blim_tpu_torch.kernels import flash_attention as fa

    *outs, call_prep, call_bwd, call_convert = fa._dense_backward_calls(
        q, k, v, dout, out, lse.contiguous(), q.shape[-1] ** -0.5)
    error_string = fa._library("flash_bwd_dense").blim_flash_bwd_dense_error_string
    return (*outs, checked(call_prep, "flash_bwd_dense_prep", error_string),
            checked(call_bwd, "flash_bwd_dense", error_string),
            checked(call_convert, "flash_bwd_dense_convert", error_string))


def raw_bwd(q, k, v, dout, mask, out, lse, causal=True):
    """Zero-argument calls of flash_bwd.cu's two C entry points (dq, then dk
    and dv) on operands prepared once, as the wrapper prepares them: dO
    times the mask (if any), delta = rowsum(dO * O), q, k, v read in place;
    no checks, no allocation, no launch counted."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    g = (dout if mask is None else dout * mask[:, :, None, None].to(dout.dtype)).contiguous()
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    km = None if mask is None else mask.to(torch.int32).contiguous()
    *_, call_dq, call_dkv = fa._backward_calls(q, k, v, g, lse.contiguous(), delta, km,
                                               q.shape[-1] ** -0.5, causal)
    error_string = fa._library("flash_bwd").blim_flash_bwd_error_string
    return checked(call_dq, "flash_dq", error_string), checked(call_dkv, "flash_dkv", error_string)


def sdpa_backward_ms(sdpa, inputs, dout, **timing):
    """SDPA's backward alone (the library yardstick of B3 + B4): its forward
    runs eagerly on a side stream, then autograd.grad of the inputs (dq, dk,
    dv) is captured on that stream and timed like graph_time_ms."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = sdpa()
    return graph_time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True),
                         stream=side, **timing)


def fwd_timing(ms, lib_ms, bound_ms, bound_by):
    """What a B1 or B1-lse line prints beside its check: the kernel's time,
    SDPA's in the same run, the bound and the share of the bound reached."""
    versus = "sdpa n/a" if lib_ms is None else \
        f"sdpa {lib_ms:.4f} ms (CUDA graph; the kernel at {lib_ms / ms:.2f}x its speed)"
    return (f"kernel {ms:.4f} ms (raw entry point, CUDA graph), {versus}, bound {bound_ms:.4f} ms "
            f"({bound_by}): kernel at {100 * bound_ms / ms:.1f}% of the bound")


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


def backward_traffic(b, s, hq, hkv, d, key_mask, query_mask, causal=True):
    """Bytes and flops of one backward, per kernel: each input read once and
    each output written once; B3 (flash_dq) reads q, dO, k, v, lse, delta,
    the mask (if any) and writes dq, against 3 products of 2 d flops per
    visible (query, key) pair; B4 (flash_dkv) reads the same and writes dk,
    dv, against 4 products; the fused backward (flash_bwd_dense) reads the
    same and writes dq, dk and dv, against 5 products (S, dP, dV, dK, dQ).
    Masked, the pairs are the causal ones with both masks 1; without masks,
    the causal triangle or (causal=False, the ViT) all S^2 of them."""
    q_like = 2 * b * s * hq * d       # bf16 q, dO or dq
    kv_like = 2 * b * s * hkv * d     # bf16 k, v, dk or dv
    stats = 2 * 4 * b * hq * s        # fp32 lse and delta
    if key_mask is None:
        mask = 0
        pairs = float(b * s * (s + 1) // 2 if causal else b * s * s)
    else:
        mask = 4 * b * s
        pairs = pairs_visible(key_mask, query_mask)
    return {"flash_dq": (3 * q_like + 2 * kv_like + stats + mask, 6.0 * d * hq * pairs),
            "flash_dkv": (2 * q_like + 4 * kv_like + stats + mask, 8.0 * d * hq * pairs),
            "flash_bwd_dense": (3 * q_like + 4 * kv_like + stats + mask, 10.0 * d * hq * pairs)}


def dense_pass_traffic(b, s, h, d):
    """Bytes and flops of the fused backward's two passes: the preprocess
    reads O and dO and writes delta (fp32) and the zeroed fp32 dQ
    accumulator (64-row tiles), 2 d flops a row; the convert reads the
    accumulator and writes dq, one multiply an element."""
    one = 2 * b * s * h * d
    acc = 4 * b * h * -(-s // 64) * 64 * d
    return {"flash_bwd_dense_prep": (2 * one + 4 * b * h * s + acc, 2.0 * d * b * s * h),
            "flash_bwd_dense_convert": (acc + one, 1.0 * d * b * s * h)}


def phase_build():
    from blim_tpu_torch.kernels import flash_attention as fa

    t0 = time.time()
    reports = fa.build()              # one nvcc per source, all started together
    secs = time.time() - t0
    faults = []
    for name, report in reports.items():
        print(f"[build] {fa.SOURCES[name].name} -> {fa.library_path(name).name} for sm_90a"
              + ("" if report else " (already built)"), flush=True)
        for ln in report.splitlines():
            if any(w in ln for w in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"[build]   {ln.strip()}", flush=True)
            if "serializ" in ln.lower() or any(c in ln for c in ("C7514", "C7515", "C7520")):
                faults.append(f"{fa.SOURCES[name].name}: {ln.strip()}")
        if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)):
            faults.append(f"{fa.SOURCES[name].name} spills registers")
    if faults:
        fail("ptxas: " + "; ".join(faults))
    fwd, bwd = fa._library("flash_fwd"), fa._library("flash_bwd")
    report = reports.get("flash_fwd") or (fa.library_path("flash_fwd").parent
                                          / "build.log").read_text()
    regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers", report)})
    spills = sorted({int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)})
    print(f"[build] flash_fwd.cu (B1, B1-lse; {report.count('Compiling entry')} instantiations): "
          f"registers at entry {regs}, spill bytes {spills}, dynamic shared memory "
          f"{fwd.blim_flash_fwd_smem_bytes(128)} B a CTA", flush=True)
    fwd_dense, bwd_dense = fa._library("flash_fwd_dense"), fa._library("flash_bwd_dense")
    print(f"[build] dynamic shared memory per CTA: "
          f"flash_fwd_dense {fwd_dense.blim_flash_fwd_dense_smem_bytes()} B (d 64, "
          f"B2 and B2-lse), flash_dq {bwd.blim_flash_bwd_smem_bytes(0, 128)} B, "
          f"flash_dkv {bwd.blim_flash_bwd_smem_bytes(1, 128)} B (d 128), flash_bwd_dense "
          f"{bwd_dense.blim_flash_bwd_dense_smem_bytes()} B (d 64)", flush=True)
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
              f"{fwd_timing(ms, lib_ms, bound_ms, bound_by)}; wrapper {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)
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
              f"(tol {LSE_TOL}); {fwd_timing(ms, lib_ms, bound_ms, bound_by)} (sdpa: its forward "
              f"with grad); wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
              flush=True)
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
        lib_bwd = sdpa_backward_ms(sdpa, (qt, kt, vt), dout.transpose(1, 2))
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

    # B3 + B4 in the non-causal masked mode at group 7 (no path runs it; held here
    # because its grid order, a head's tiles side by side, is no causal path's)
    name, m = train_attention_cases()[0]
    b, s = m.shape
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    ref, ref_lse = fa.reference_attention_lse(q, k, v, m, m, False, scale)
    before = fa.counts()
    got = fa.flash_attention_backward(q, k, v, m, m, ref, ref_lse, dout, causal=False)
    torch.cuda.synchronize()
    if (fa.launches_dq, fa.launches_dkv) != (before["flash_dq"] + 1, before["flash_dkv"] + 1):
        fail(f"flash_dq/dkv non-causal {name}: the wrapper did not launch each kernel once")
    want = fa.reference_attention_backward(q, k, v, m, m, ref, ref_lse, dout, False, scale)
    errs = {gname: ((g.float() - w.float()).abs().max().item(), w.float().abs().max().item())
            for gname, g, w in zip(("dq", "dk", "dv"), got, want)}
    print(f"[train-kernels] flash_dq/flash_dkv non-causal {name}: " + ", ".join(
        f"{gname} max|d| {e:.3e} (max|plain| {mx:.3e})" for gname, (e, mx) in errs.items())
        + f" (tol {GRAD_TOL} max|plain|) [{card}]", flush=True)
    for gname, g in zip(("dq", "dk", "dv"), got):
        if not torch.isfinite(g).all():
            fail(f"{gname} non-causal {name}: non-finite")
        e, mx = errs[gname]
        if e > GRAD_TOL * mx:
            fail(f"{gname} non-causal {name}: |kernel - plain| {e:.3e} > {GRAD_TOL} x {mx:.3e}")
    for key, gnames in (("flash_dq", ("dq",)), ("flash_dkv", ("dk", "dv"))):
        records[key]["max_abs_err"] = max([records[key]["max_abs_err"]]
                                          + [errs[gn][0] for gn in gnames])
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


def setup_finetuned(flow):
    """What the fine-tuned flow adds to the flow's weights, as the JAX
    package's bench sets it up: a LoRA tree (LoraConfig(): r 8, alpha 32) on
    the LLM and the projector, made on the card from SEED, its scale, and
    the TVG layout. The B factors, zero at init, are drawn from the same
    generator (std LORA_B_STD) so that the checks see the adapters."""
    import torch

    from blim_tpu_torch.adapters.lora import LoraConfig, init_llm_lora, init_projector_lora
    from blim_tpu_torch.data.prompts import make_tvg_layout

    cfg, _, tok, _ = flow
    lcfg = LoraConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lora = {"llm": init_llm_lora(gen, cfg.llm, lcfg),
            "projector": init_projector_lora(gen, cfg.mm_hidden_size, cfg.llm.hidden_size, lcfg)}
    for name, leaf in _named_leaves(lora):
        if name.rsplit("/", 1)[-1] == "b":
            leaf.normal_(0.0, LORA_B_STD, generator=gen)
    return dict(lora=lora, lora_scale=lcfg.scale,
                tvg_layout=make_tvg_layout(tok, cfg.num_clips, CAPTION_TOKENS))


def run_flow(flow, n, timings=None, finetuned=None, shared_prefix=True, packed=True):
    """One evaluation (CPN on, TOPK) of n synthetic items on a fresh engine,
    synchronized: the zero-shot flow, or with `finetuned` (setup_finetuned)
    the fine-tuned flow, TVG directions and LoRA on; shared_prefix=False
    runs the naive per-pair schedule, packed=False the rectangle schedule.
    Returns (inputs, engine, t2v, v2t, seconds)."""
    import torch

    from blim_tpu_torch.engine.evaluation import evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine

    cfg, params, tok, layout = flow
    inputs = make_inputs(cfg, n)
    ft = finetuned or {}
    engine = RerankEngine(params, cfg, layout, ft.get("tvg_layout"), lora=ft.get("lora"),
                          lora_scale=ft.get("lora_scale", 0.0), device="cuda")
    torch.cuda.synchronize()
    t = time.time()
    t2v, v2t = evaluation(engine, inputs, tok, "MSRVTT", topk=TOPK, cpn=True,
                          has_tvg=finetuned is not None, verbose=False, timings=timings,
                          shared_prefix=shared_prefix, packed=packed)
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
                launches=launches, zeroshot=dict(t2v=t2v, v2t=v2t, packs=pack_count(engine),
                                                 qps=n / elapsed))


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


def tvg_controls(engine, inputs, tok, rows, cols, naive, naive_prior):
    """The pairs (rows, cols) re-scored through the packed TVG engine, clean
    and with one fault planted at a time -> {name: (max|d| scores, max|d|
    priors)} against the naive scores. Faults: 'segment', each query reads
    the next segment of its pack row (another caption's prefix, as a
    segment mask off by one would); 'position', the flat-query suffix one
    position late; 'bf16', the flat-query attention scores from bf16
    products with fp32 accumulation where the JAX package takes fp32
    operands."""
    import torch

    from blim_tpu_torch.core.numerics import einsum_f32
    from blim_tpu_torch.engine.rerank import CaptionBank
    from blim_tpu_torch.models import qwen2
    from blim_tpu_torch.models import videochat_flash as vcf

    banks = engine.upload(CaptionBank.build_tvg(inputs.captions, tok, engine.tvg_layout),
                          inputs.features)
    vocab = engine.video_vocab(banks)
    score_tvg_packed, einsum_fp32 = vcf.score_tvg_packed, qwen2.einsum_fp32

    def next_segment(params, config, kv, pack_seg, q_seg, *args, **kw):
        n_seg = (pack_seg.amax(dim=1, keepdim=True) + 1).clamp(min=1)
        q_seg = torch.where(q_seg >= 0, (q_seg + 1) % n_seg, q_seg)
        return score_tvg_packed(params, config, kv, pack_seg, q_seg, *args, **kw)

    def late_position(*args, **kw):
        *front, position_offset = args
        return score_tvg_packed(*front, position_offset + 1, **kw)

    def bf16_products(equation, a, b):
        return einsum_f32(equation, a.bfloat16(), b.bfloat16())

    faults = {"clean": (vcf, "score_tvg_packed", score_tvg_packed),
              "segment": (vcf, "score_tvg_packed", next_segment),
              "position": (vcf, "score_tvg_packed", late_position),
              "bf16": (qwen2, "einsum_fp32", bf16_products)}
    out = {}
    for name, (module, attr, fn) in faults.items():
        setattr(module, attr, fn)
        try:
            s, p = engine.score_pairs_tvg_packed(banks, vocab, rows, cols, with_prior=True)
        finally:
            vcf.score_tvg_packed, qwen2.einsum_fp32 = score_tvg_packed, einsum_fp32
        out[name] = (float(np.abs(s - naive).max()), float(np.abs(p - naive_prior).max()))
    return out


def phase_finetuned(st, card):
    """The fine-tuned flow on phase 3's weights: an untimed run at
    WARM_ITEMS, a timed run at ITEMS with B1's launches checked (the VTG
    prefix forwards launch it; the TVG packed prefixes launch nothing), the
    six matrices checked, the recall tables printed, then 8 pairs' packed
    TVG scores and priors against the naive full-sequence score_tvg, and
    tvg_controls' planted faults, of which the segment and the position
    fault must exceed TVG_TOL."""
    import torch

    from blim_tpu_torch.engine.rerank import CaptionBank, topk_pairs
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import videochat_flash as vcf
    from blim_tpu_torch.scoring.fusion import all_scoring_results

    t0 = time.time()
    flow = st["flow"]
    cfg, params, tok, _ = flow
    ft = setup_finetuned(flow)
    warm_s = run_flow(flow, WARM_ITEMS, finetuned=ft)[-1]
    print(f"[finetuned] LoRA r 8 alpha 32 on the LLM and the projector; untimed warm run: "
          f"{WARM_ITEMS} items in {warm_s:.2f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    timings = {}
    inputs, engine, t2v, v2t, elapsed = run_flow(flow, ITEMS, finetuned=ft, timings=timings)
    launches = fa.launches
    others = sum(fa.counts().values()) - launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    packs = pack_count(engine)      # before tvg_controls scores more packs on this engine
    steps = engine.steps
    n = ITEMS
    layers = cfg.llm.num_hidden_layers
    expected = layers * engine.prefix_forwards
    print(f"[finetuned] timed run: {n} queries in {elapsed:.3f}s = {n / elapsed:.3f} q/s, "
          f"peak {peak_gb:.2f} GiB, {engine.steps} steps, VTG prefix forwards "
          f"{engine.prefix_forwards} ({engine.prefix_forwards - 1} video-prefix steps + 1 prior "
          f"prefix), TVG packed-prefix forwards {engine.tvg_prefix_forwards}, flash_fwd "
          f"launches {launches} (expected {expected} = {layers} x {engine.prefix_forwards}); "
          f"split {pass_split(timings)} [{card}]", flush=True)
    if launches != expected or launches == 0 or others:
        fail(f"fine-tuned flow: flash_fwd launches {launches} != expected {expected}, or "
             f"another kernel launched ({fa.counts()})")
    if engine.tvg_prefix_forwards == 0:
        fail("fine-tuned flow ran no TVG packed-prefix forward")
    v_rows, v_cols = topk_pairs(inputs.v2t_iv2, TOPK)
    t_rows, t_cols = topk_pairs(inputs.t2v_iv2, TOPK)
    grids = {"v2t": (v_rows, v_cols), "t2v": (t_rows, t_cols)}
    scored = [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
              ("v2t", "query_likelihood"), ("t2v", "query_likelihood"),
              ("t2v", "candidate_likelihood"), ("t2v", "candidate_prior")]
    mats = {"v2t": v2t, "t2v": t2v}
    for direction, name in scored + [("v2t", "internvideo2"), ("t2v", "internvideo2")]:
        if name not in mats[direction] or mats[direction][name].shape != (n, n):
            fail(f"fine-tuned flow: {direction} {name} missing or not ({n}, {n})")
    for direction, name in scored:
        rows, cols = grids[direction]
        cells = mats[direction][name][rows, cols]
        if not np.isfinite(cells).all() or (cells == -100.0).any():
            fail(f"fine-tuned {direction} {name}: a scored cell is non-finite or the -100 fill")
    ids = {i: i for i in range(n)}
    res = all_scoring_results(t2v, v2t, ids, ids, alpha=(0.0, 0.9), c=(1.0, 0.6, 0.8, 0.4),
                              cpn=True, has_tvg=True)
    print(f"[finetuned] recall r_mean (has_tvg): " + ", ".join(
        f"{k} {v['r_mean']}" for k, v in res.items()), flush=True)

    # packed against naive: 8 t2v cells (caption = row, video = column), 8
    # captions, each with its first candidate
    layout = ft["tvg_layout"]
    first = np.arange(8) * TOPK
    rows, cols = t_rows[first], t_cols[first]
    bank = CaptionBank.build_tvg([inputs.captions[c] for c in rows], tok, layout)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    feats = dev(inputs.features).to(params["llm"]["embed_tokens"]["embedding"].dtype)
    batch = {"input_ids": dev(bank.input_ids), "attention_mask": dev(bank.attention_mask),
             "cpn_mask": dev(bank.cpn_mask), "video": feats[dev(cols)],
             "video_label": dev(cols)}
    with torch.no_grad():
        vocab = vcf.make_video_vocab(feats.float())
        naive, naive_prior = (
            vcf.score_tvg(params, cfg, batch, vocab, layout.video_start,
                          int(layout.gather_positions[0]), cpn=cpn, lora=ft["lora"],
                          lora_scale=ft["lora_scale"]).float().cpu().numpy()
            for cpn in (False, True))
    packed = t2v["candidate_likelihood"][rows, cols]
    packed_prior = t2v["candidate_prior"][rows, cols]
    err = float(np.abs(packed - naive).max())
    err_prior = float(np.abs(packed_prior - naive_prior).max())
    print(f"[finetuned] 8 pairs, packed TVG vs naive score_tvg: max|d| likelihood {err:.3e}, "
          f"prior {err_prior:.3e} (tol {TVG_TOL}); naive scores mean {naive.mean():.4f} std "
          f"{naive.std():.3e} range {np.ptp(naive):.3e}, priors mean {naive_prior.mean():.4f} "
          f"std {naive_prior.std():.3e} range {np.ptp(naive_prior):.3e} [{card}]", flush=True)
    if not (np.isfinite(naive).all() and np.isfinite(naive_prior).all()):
        fail("naive TVG scores are not finite")
    if not (np.isfinite(packed).all() and np.isfinite(packed_prior).all()):
        fail("packed TVG scores are not finite")
    if max(err, err_prior) > TVG_TOL:
        fail(f"packed vs naive TVG disagree: {err:.3e} / {err_prior:.3e} > {TVG_TOL}")
    controls = tvg_controls(engine, inputs, tok, rows, cols, naive, naive_prior)
    print("[finetuned] the 8 pairs re-scored packed, max|packed - naive| likelihood / prior: "
          + ", ".join(f"{k} {s:.3e} / {p:.3e}" for k, (s, p) in controls.items())
          + f" (tol {TVG_TOL}) [{card}]", flush=True)
    if max(controls["clean"]) > TVG_TOL:
        fail(f"the 8 pairs re-scored packed disagree with naive: {controls['clean']}")
    for fault in ("segment", "position"):
        if max(controls[fault]) <= TVG_TOL:
            fail(f"a planted {fault} fault moved the TVG scores by {controls[fault]}, not "
                 f"above {TVG_TOL}: the packed-vs-naive check cannot see it")
    print(f"[time] phase 5 (finetuned) took {time.time() - t0:.1f}s", flush=True)
    return dict(launches=launches, qps=n / elapsed, ft=ft, t2v=t2v, v2t=v2t, packs=packs,
                seconds=elapsed, peak_gb=peak_gb, steps=steps, timings=timings)


def pass_split(timings):
    """The evaluation's wall split by pass, from its timing marks: banks
    (upload of both banks), then the passes in the order they ran."""
    marks = sorted(timings.items(), key=lambda kv: kv[1])
    out, prev = [], 0.0
    for name, t in marks:
        if name == "total":
            continue
        out.append(f"{name.replace('_done', '')} {t - prev:.2f}s")
        prev = t
    return ", ".join(out)


def pack_count(engine):
    """The packs of the sharded passes (VTG, TVG, TVG prior) in the whole
    evaluation: each bucket's m."""
    return sum(m for _name, _bucket, _lo, _hi, m in engine.pack_shards)


VTG_MATRICES = [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
                ("t2v", "query_likelihood")]
TVG_MATRICES = [("v2t", "query_likelihood"), ("t2v", "candidate_likelihood"),
                ("t2v", "candidate_prior")]


def matrix_gaps(got, want, names):
    """({direction/name: max |got - want| over the scored cells}, whether
    the fill cells (-100) are the same cells in both, the mean |got - want|
    over every scored cell of the named matrices)."""
    gaps, same_fill, diffs = {}, True, [np.zeros(0)]
    for direction, name in names:
        g, w = got[direction][name], want[direction][name]
        fill = w == -100.0
        same_fill &= bool(np.array_equal(g == -100.0, fill))
        diffs.append(np.abs(g[~fill] - w[~fill]))
        gaps[f"{direction}/{name}"] = float(diffs[-1].max()) if diffs[-1].size else 0.0
    d = np.concatenate(diffs)
    return gaps, same_fill, float(d.mean()) if d.size else 0.0


def vtg_grid_controls(flow, ft, naive):
    """Phase 5b's packed evaluation re-run with one VTG fault planted at a
    time -> {name: (max |d|, mean |d|)} over its VTG matrices against the
    naive schedule's (`naive`: {"t2v", "v2t"}). Faults: 'segment', the
    packed suffix forward without its segment mask (a caption also attends
    to the captions before it in its pack row); 'position', the packed
    suffix scored one position late (likelihoods and priors)."""
    import torch

    from blim_tpu_torch.models import qwen2
    from blim_tpu_torch.models import videochat_flash as vcf

    forward, score = qwen2.forward_packed_suffix, vcf.score_vtg_packed

    def one_segment(params, config, emb, kv, seg, *args, **kw):
        return forward(params, config, emb, kv, torch.where(seg >= 0, 0, seg), *args, **kw)

    def late_position(params, config, kv, ids, segs, poss, *args, **kw):
        return score(params, config, kv, ids, segs, poss + 1, *args, **kw)

    out = {}
    for name, (module, attr, fn) in {"segment": (qwen2, "forward_packed_suffix", one_segment),
                                     "position": (vcf, "score_vtg_packed", late_position)}.items():
        setattr(module, attr, fn)
        try:
            _, _, t2v, v2t, _ = run_flow(flow, NAIVE_ITEMS, finetuned=ft)
        finally:
            qwen2.forward_packed_suffix, vcf.score_vtg_packed = forward, score
        gaps, _, mean = matrix_gaps(naive, {"t2v": t2v, "v2t": v2t}, VTG_MATRICES)
        out[name] = (max(gaps.values()), mean)
    return out


def phase_naive(st, fine, card):
    """Phase 5b: the naive per-pair schedule (evaluation(shared_prefix=False),
    the fine-tuned flow with CPN on) at NAIVE_ITEMS on phase 5's weights and
    LoRA tree, against the packed evaluation of the same inputs: VTG
    matrices within GRID_VTG_TOL (max) and GRID_VTG_MEAN_TOL (mean), TVG
    within TVG_TOL, the same fill cells;
    B1 launches = 28 x the naive forwards (16 pairs of the full sequence a
    forward, a second forward for the candidate grids' priors); then
    vtg_grid_controls' segment and position faults, each of which must
    exceed GRID_VTG_TOL or GRID_VTG_MEAN_TOL."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    t0 = time.time()
    flow, ft = st["flow"], fine["ft"]
    layers = flow[0].llm.num_hidden_layers
    _, packed_engine, pt2v, pv2t, packed_s = run_flow(flow, NAIVE_ITEMS, finetuned=ft)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    _, engine, nt2v, nv2t, naive_s = run_flow(flow, NAIVE_ITEMS, finetuned=ft,
                                              shared_prefix=False)
    counts = fa.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = dict({k: 0 for k in counts}, flash_fwd=layers * engine.naive_forwards)
    naive, packed = {"t2v": nt2v, "v2t": nv2t}, {"t2v": pt2v, "v2t": pv2t}
    vtg, vtg_fill, vtg_mean = matrix_gaps(naive, packed, VTG_MATRICES)
    tvg, tvg_fill, _ = matrix_gaps(naive, packed, TVG_MATRICES)
    vtg_d = np.concatenate([np.abs(naive[d][n] - packed[d][n])[packed[d][n] != -100.0]
                            for d, n in VTG_MATRICES])
    pairs = NAIVE_ITEMS * TOPK
    print(f"[naive] fine-tuned flow at {NAIVE_ITEMS} items, topk {TOPK}: naive schedule "
          f"{naive_s:.2f}s ({engine.steps} steps of {engine.batch_size} pairs, "
          f"{engine.naive_forwards} full-sequence forwards of {engine.batch_size} x "
          f"{flow[3].seq_len} VTG / {ft['tvg_layout'].seq_len} TVG tokens; 4 grids of {pairs} "
          f"pairs, the 2 candidate grids with a prior forward), packed {packed_s:.2f}s "
          f"({packed_engine.steps} steps); peak {peak_gb:.2f} GiB; max|naive - packed| VTG "
          + ", ".join(f"{k} {v:.3e}" for k, v in vtg.items())
          + f" (tol {GRID_VTG_TOL}), over its {vtg_d.size} cells mean {vtg_mean:.3e} (tol "
          f"{GRID_VTG_MEAN_TOL}), 99th percentile {np.percentile(vtg_d, 99):.3e}, "
          f"{int((vtg_d > PACKED_TOL).sum())} cells above PACKED_TOL; TVG "
          + ", ".join(f"{k} {v:.3e}" for k, v in tvg.items()) + f" (tol {TVG_TOL}); fill cells "
          f"{'the same' if vtg_fill and tvg_fill else 'DIFFERENT'}; launches {counts} "
          f"(expected {expected}) [{card}]", flush=True)
    if counts != expected or not engine.naive_forwards:
        fail(f"naive schedule: launches {counts} != expected {expected}")
    if not (vtg_fill and tvg_fill):
        fail("naive schedule: the fill cells differ from the packed evaluation's")
    if not all(np.isfinite(m[k]).all() for m in (nt2v, nv2t) for k in m):
        fail("naive schedule: a non-finite score")
    if max(vtg.values()) > GRID_VTG_TOL or vtg_mean > GRID_VTG_MEAN_TOL \
            or max(tvg.values()) > TVG_TOL:
        fail("naive schedule: disagrees with the packed evaluation")
    controls = dict(clean=(max(vtg.values()), vtg_mean), **vtg_grid_controls(flow, ft, naive))
    print("[naive] the packed evaluation re-run, max / mean |naive - packed| over the VTG "
          "matrices: " + ", ".join(f"{k} {m:.3e} / {a:.3e}" for k, (m, a) in controls.items())
          + f" (tol {GRID_VTG_TOL} / {GRID_VTG_MEAN_TOL}) [{card}]", flush=True)
    for fault in ("segment", "position"):
        m, a = controls[fault]
        if m <= GRID_VTG_TOL and a <= GRID_VTG_MEAN_TOL:
            fail(f"a planted VTG {fault} fault moved the grid by max {m:.3e}, mean {a:.3e}, "
                 f"within {GRID_VTG_TOL} / {GRID_VTG_MEAN_TOL}: the check cannot see it")
    print(f"[time] phase 5b (naive) took {time.time() - t0:.1f}s", flush=True)
    return dict(launches=counts["flash_fwd"], forwards=engine.naive_forwards, seconds=naive_s)


def rect_controls(flow, ft):
    """Phase 5c's planted faults, at NAIVE_ITEMS: the rectangle evaluation
    clean and with one fault planted at a time against the packed
    evaluation of the same inputs -> {name: (VTG max |d|, VTG mean |d|, TVG
    max |d|)}. Faults: 'vtg_position', the rectangle's VTG suffixes (and
    priors) scored one position late; 'tvg_position', the trimmed TVG
    prefixes at positions restarting at 0 instead of P_full - B."""
    from blim_tpu_torch.models import videochat_flash as vcf

    _, _, pt2v, pv2t, _ = run_flow(flow, NAIVE_ITEMS, finetuned=ft)
    packed = {"t2v": pt2v, "v2t": pv2t}
    score_vtg_suffix, tvg_prefix_kv = vcf.score_vtg_suffix, vcf.tvg_prefix_kv

    def late_suffix(params, config, kv, ids, mask, labels, position_offset, **kw):
        return score_vtg_suffix(params, config, kv, ids, mask, labels, position_offset + 1, **kw)

    def restarted(params, config, ids, mask, position_ids=None, **kw):
        return tvg_prefix_kv(params, config, ids, mask,
                             position_ids=position_ids - position_ids[:, :1], **kw)

    out = {}
    for name, (attr, fn) in {"clean": (None, None),
                             "vtg_position": ("score_vtg_suffix", late_suffix),
                             "tvg_position": ("tvg_prefix_kv", restarted)}.items():
        if attr:
            setattr(vcf, attr, fn)
        try:
            _, _, t2v, v2t, _ = run_flow(flow, NAIVE_ITEMS, finetuned=ft, packed=False)
        finally:
            vcf.score_vtg_suffix, vcf.tvg_prefix_kv = score_vtg_suffix, tvg_prefix_kv
        got = {"t2v": t2v, "v2t": v2t}
        vtg, _, vtg_mean = matrix_gaps(got, packed, VTG_MATRICES)
        tvg, _, _ = matrix_gaps(got, packed, TVG_MATRICES)
        out[name] = (max(vtg.values()), vtg_mean, max(tvg.values()))
    return out


def phase_rectangle(st, fine, card):
    """Phase 5c: the rectangle schedule (evaluation(packed=False), the
    fine-tuned flow with CPN on) at ITEMS on phase 5's weights and LoRA tree,
    held to phase 5's packed matrices of the same inputs (VTG within
    GRID_VTG_TOL max and GRID_VTG_MEAN_TOL mean, TVG within TVG_TOL, the
    same fill cells); B1 launches = 28 x the prefix forwards, the TVG
    prefixes among them (each one through B1: 28 launches); then
    rect_controls' faults, each of which must exceed a limit; then B1 at the
    two most common TVG rectangle shapes against its plain version."""
    import collections

    import torch

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import videochat_flash as vcf

    t0 = time.time()
    flow, ft = st["flow"], fine["ft"]
    layers = flow[0].llm.num_hidden_layers
    tvg_calls, tvg_masks = [], {}
    real_kv = vcf.tvg_prefix_kv

    def counted(params, config, ids, mask, position_ids=None, **kw):
        before = fa.launches
        kv = real_kv(params, config, ids, mask, position_ids=position_ids, **kw)
        shape = tuple(ids.shape)
        tvg_calls.append((shape, fa.launches - before))
        if len(tvg_masks.setdefault(shape, [])) < 2:   # a step's likelihood, then prior mask
            tvg_masks[shape].append(mask.clone())
        return kv

    vcf.tvg_prefix_kv = counted
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    timings = {}
    try:
        inputs, engine, t2v, v2t, elapsed = run_flow(flow, ITEMS, finetuned=ft, timings=timings,
                                                     packed=False)
    finally:
        vcf.tvg_prefix_kv = real_kv
    counts = fa.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = dict({k: 0 for k in counts}, flash_fwd=layers * engine.prefix_forwards)
    tvg_forwards = len(tvg_calls)
    tvg_launches = sum(n for _, n in tvg_calls)
    shapes = collections.Counter(shape for shape, _ in tvg_calls)
    rect = {"t2v": t2v, "v2t": v2t}
    packed = {"t2v": fine["t2v"], "v2t": fine["v2t"]}
    vtg, vtg_fill, vtg_mean = matrix_gaps(rect, packed, VTG_MATRICES)
    tvg, tvg_fill, _ = matrix_gaps(rect, packed, TVG_MATRICES)
    groups = {(n, k): m for n, k, _lo, _hi, m in engine.pack_shards}
    print(f"[rectangle] fine-tuned flow, evaluation(packed=False), {ITEMS} queries topk {TOPK} "
          f"(one run, no warm run: eager PyTorch compiles nothing a shape): wall {elapsed:.3f}s "
          f"= {ITEMS / elapsed:.3f} q/s (phase 5 packed: {fine['seconds']:.3f}s = "
          f"{fine['qps']:.3f} q/s); {engine.steps} steps (packed {fine['steps']}); peak "
          f"{peak_gb:.2f} GiB (packed {fine['peak_gb']:.2f}); split {pass_split(timings)} "
          f"(packed: {pass_split(fine['timings'])}); groups by (pass, k) "
          f"{groups}; prefix forwards {engine.prefix_forwards} (TVG "
          f"{tvg_forwards}, each {tvg_launches // max(tvg_forwards, 1)} B1 launches), launches "
          f"{counts} (expected {expected}); TVG prefix shapes (G, B) "
          f"{dict(shapes.most_common())} [{card}]", flush=True)
    print(f"[rectangle] max|rectangle - packed| VTG " + ", ".join(
        f"{k} {v:.3e}" for k, v in vtg.items()) + f" (tol {GRID_VTG_TOL}), mean {vtg_mean:.3e} "
          f"(tol {GRID_VTG_MEAN_TOL}); TVG " + ", ".join(f"{k} {v:.3e}" for k, v in tvg.items())
          + f" (tol {TVG_TOL}); fill cells {'the same' if vtg_fill and tvg_fill else 'DIFFERENT'}"
          f" [{card}]", flush=True)
    if counts != expected or not engine.prefix_forwards:
        fail(f"rectangle: launches {counts} != expected {expected}")
    if not tvg_forwards or tvg_launches != layers * tvg_forwards:
        fail(f"rectangle: {tvg_forwards} TVG prefix forwards made {tvg_launches} B1 launches, "
             f"not {layers} each")
    if not (vtg_fill and tvg_fill):
        fail("rectangle: the fill cells differ from the packed evaluation's")
    if not all(np.isfinite(m[k]).all() for m in (t2v, v2t) for k in m):
        fail("rectangle: a non-finite score")
    for d in ("t2v", "v2t"):
        if not np.array_equal(rect[d]["internvideo2"], packed[d]["internvideo2"]):
            fail(f"rectangle: {d} internvideo2 differs from phase 5's")
    if max(vtg.values()) > GRID_VTG_TOL or vtg_mean > GRID_VTG_MEAN_TOL \
            or max(tvg.values()) > TVG_TOL:
        fail("rectangle: disagrees with the packed evaluation")
    controls = rect_controls(flow, ft)
    print(f"[rectangle] at {NAIVE_ITEMS} items against the packed evaluation, max / mean |d| "
          f"VTG and max |d| TVG: " + ", ".join(f"{k} {a:.3e} / {b:.3e}, {c:.3e}"
                                                for k, (a, b, c) in controls.items())
          + f" (tol {GRID_VTG_TOL} / {GRID_VTG_MEAN_TOL}, {TVG_TOL}) [{card}]", flush=True)
    a, b, c = controls["clean"]
    if a > GRID_VTG_TOL or b > GRID_VTG_MEAN_TOL or c > TVG_TOL:
        fail(f"rectangle at {NAIVE_ITEMS} items disagrees with the packed evaluation")
    a, b, _ = controls["vtg_position"]
    if a <= GRID_VTG_TOL and b <= GRID_VTG_MEAN_TOL:
        fail(f"a planted VTG position fault moved the grid by {a:.3e} / {b:.3e}: not seen")
    if controls["tvg_position"][2] <= TVG_TOL:
        fail(f"a planted TVG prefix position fault moved the TVG scores by "
             f"{controls['tvg_position'][2]:.3e}, not above {TVG_TOL}: not seen")
    # the record is the most common shape's; the next one is checked too
    b1 = [rect_kernel_b1(shape, tvg_masks[shape], card) for shape, _ in shapes.most_common(2)][0]
    print(f"[time] phase 5c (rectangle) took {time.time() - t0:.1f}s", flush=True)
    return dict(launches=counts["flash_fwd"], prefix_forwards=engine.prefix_forwards,
                tvg_forwards=tvg_forwards, seconds=elapsed, b1=b1)


def rect_kernel_b1(shape, masks, card):
    """B1 against its plain version at a TVG rectangle prefix shape (G, B),
    under the masks a step of phase 5c gave it there: the left-padded
    attention mask (leading rows fully masked) and the CPN mask (only the
    instruction head visible). Timed like phase 2 under the first."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    g, s = shape
    gen = torch.Generator(device="cuda").manual_seed(6)
    hq, hkv, d = 28, 4, 128
    q = torch.randn((g, s, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((g, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((g, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    errs = []
    for mask in masks:
        before = fa.counts()
        out = fa.flash_attention(q, k, v, key_mask=mask, query_mask=mask)
        torch.cuda.synchronize()
        if fa.counts() != dict(before, flash_fwd=before["flash_fwd"] + 1):
            fail("rectangle B1: the wrapper did not launch the kernel once")
        ref = reference_attention(q, k, v, mask, mask, True, d ** -0.5)
        if not torch.isfinite(out).all():
            fail("rectangle B1: non-finite output")
        if (out[mask == 0] != 0).any():
            fail("rectangle B1: a masked row is not zero")
        diff = (out.float() - ref.float()).abs()
        errs.append(diff.max().item())
        if (diff - ATTN_RTOL * ref.float().abs()).max().item() > ATTN_ATOL:
            fail(f"rectangle B1: |kernel - plain| exceeds {ATTN_ATOL} + {ATTN_RTOL}|plain| "
                 f"({errs[-1]:.3e})")
    mask = masks[0]
    ms = graph_time_ms(raw_fwd(q, k, v, mask))
    plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, mask, mask, True, d ** -0.5))
    idx = torch.arange(s, device="cuda")
    allowed = (idx[:, None] >= idx[None, :])[None, None] & mask.bool()[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                                  enable_gqa=True))
    bound_ms, bound_by = attention_bound_ms(g, s, hq, hkv, d, mask, mask)
    rows = [int(m.sum(dim=1).min().item()) for m in masks]
    print(f"[rectangle] flash_fwd at a TVG rectangle shape (G={g}, B={s}, {hq}, "
          f"{d}), left-padded (fewest real rows {rows[0]}) and CPN-masked (fewest visible "
          f"{rows[-1]}): max|d| {', '.join(f'{e:.3e}' for e in errs)} (tol {ATTN_ATOL} + "
          f"{ATTN_RTOL}|plain|), masked rows zero; {fwd_timing(ms, lib_ms, bound_ms, bound_by)}; "
          f"plain {plain_ms:.4f} ms [{card}]", flush=True)
    return dict(shape=[g, s, hq, hkv, d], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max(errs))


def rel_gap(got, want):
    """|got - want| / |want| (Frobenius), in fp32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def phase_dormant(st, card):
    """Phase 14: the dormant features at the 7B's width on phase 3's weights.
    PyramidDrop on PDROP_ROWS VTG rows (the video block at its layout slot, the
    prompt's last token ranking): keep-all against vtg_hidden; one uniform
    stage (PDROP_LAYER, PDROP_RATIO) through B1 against the same forward
    through the plain attention; one attention-ranked stage through B1 (its
    launches, shape and kept tokens; the plain run's kept tokens beside).
    The windowed attention on the card (forward and, under autograd,
    backward) against the same on the CPU."""
    import dataclasses

    import torch

    from blim_tpu_torch.engine.rerank import CaptionBank
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import pyramid_drop, qwen2
    from blim_tpu_torch.models import videochat_flash as vcf
    from blim_tpu_torch.scoring import criteria

    t0 = time.time()
    cfg, params, tok, layout = st["flow"]
    layers = cfg.llm.num_hidden_layers
    inputs = st["inputs"]
    bank = CaptionBank.build_vtg(inputs.captions[:PDROP_ROWS], tok, "MSRVTT", layout)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    ids, mask = dev(bank.input_ids), dev(bank.attention_mask)
    video = dev(inputs.features[:PDROP_ROWS]).to(
        params["llm"]["embed_tokens"]["embedding"].dtype)
    labels = dev(bank.window_labels)
    ws, wl = layout.label_window
    lm_kernel = qwen2.lm_head_kernel(params["llm"])

    def scores(hidden, dropped=0):
        """The rows' VTG caption scores from a final hidden whose label
        window moved left by the dropped tokens."""
        win = hidden[:, ws - dropped: ws - dropped + wl]
        return criteria.vtg_likelihood_from_hidden(win, lm_kernel, labels).float()

    def score_gap(a, b):
        return (a - b).abs().max().item()
    vs, qpos = layout.video_start, layout.caption_start - 1
    nv = cfg.video_tokens_vtg

    def plain_attention(q, k, v, *, key_mask=None, query_mask=None, causal=True, scale=None,
                        window=None):
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale, window)

    def pdrop(ratio, kind, plain=False, stale_positions=False):
        c = dataclasses.replace(cfg, mm_llm_compress=True, llm_compress_layer_list=(PDROP_LAYER,),
                                llm_image_token_ratio_list=(1.0, ratio), llm_compress_type=kind)
        dropped = vcf.pdrop_total_dropped(c)
        mha, rope = qwen2.multi_head_attention, pyramid_drop.rope_cos_sin
        if plain:
            qwen2.multi_head_attention = plain_attention
        if stale_positions:      # the planted fault: positions after the drop not renumbered
            def rope_stale(pos, *a):
                if pos.shape[1] == T - dropped:
                    pos = pos + (pos >= vs + nv - dropped) * dropped
                return rope(pos, *a)
            pyramid_drop.rope_cos_sin = rope_stale
        fa.reset_counts()
        try:
            with torch.no_grad():
                hidden, idx = vcf.vtg_hidden_pdrop(params, c, ids, mask, video, vs, qpos)
            torch.cuda.synchronize()
        finally:
            qwen2.multi_head_attention, pyramid_drop.rope_cos_sin = mha, rope
        return hidden, idx, fa.counts(), dropped

    T = ids.shape[1]
    with torch.no_grad():
        ref = vcf.vtg_hidden(params, cfg, ids, mask, video, vs)
        mha = qwen2.multi_head_attention
        qwen2.multi_head_attention = plain_attention
        try:
            ref_plain = vcf.vtg_hidden(params, cfg, ids, mask, video, vs)
        finally:
            qwen2.multi_head_attention = mha
    keep, keep_idx, keep_counts, _ = pdrop(1.0, "uniform")
    drop, drop_idx, drop_counts, dropped = pdrop(PDROP_RATIO, "uniform")
    drop_plain, plain_idx, plain_counts, _ = pdrop(PDROP_RATIO, "uniform", plain=True)
    fault = pdrop(PDROP_RATIO, "uniform", stale_positions=True)[0]
    rel = {"no drop": rel_gap(ref, ref_plain), "drop": rel_gap(drop, drop_plain),
           "fault": rel_gap(fault, drop_plain)}
    gap_keep = score_gap(scores(keep), scores(ref))
    s_plain = scores(drop_plain, dropped)
    gap_full = score_gap(scores(ref), scores(ref_plain))
    gap_drop = score_gap(scores(drop, dropped), s_plain)
    gap_fault = score_gap(scores(fault, dropped), s_plain)
    att, att_idx, att_counts, _ = pdrop(PDROP_RATIO, "attention")
    att_plain, att_plain_idx, _, _ = pdrop(PDROP_RATIO, "attention", plain=True)
    kept = att_idx[:, vs: vs + nv - dropped]
    kept_plain = att_plain_idx[:, vs: vs + nv - dropped]
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / kept.shape[1]
                       for a, b in zip(kept, kept_plain)])
    launch = dict({k: 0 for k in keep_counts}, flash_fwd=layers)
    print(f"[dormant] PyramidDrop on {PDROP_ROWS} VTG rows of {T} tokens ({nv} video tokens at "
          f"{vs}, ranked from position {qpos}), max |d| of the caption scores (~"
          f"{s_plain.mean().item():.2f}): keep-all vs vtg_hidden {gap_keep:.3e}; one uniform "
          f"stage at layer {PDROP_LAYER} keeping {PDROP_RATIO} of the video ({dropped} dropped, "
          f"{T} -> {drop.shape[1]} tokens) through B1 vs the plain attention {gap_drop:.3e} "
          f"(tol {PACKED_TOL}; vtg_hidden through B1 vs plain, no drop: {gap_full:.3e}; planted "
          f"positions not renumbered after the drop: {gap_fault:.3e}); final hidden |d|/|plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + "; kept-index maps "
          f"{'equal' if torch.equal(drop_idx, plain_idx) else 'DIFFERENT'}; attention-ranked "
          f"stage: {att.shape[1]} tokens, kept video tokens shared with the plain run's "
          f"{overlap:.3f}; launches keep-all {keep_counts['flash_fwd']}, uniform "
          f"{drop_counts['flash_fwd']}, attention {att_counts['flash_fwd']}, plain "
          f"{plain_counts['flash_fwd']} (expected {layers}, {layers}, {layers}, 0) [{card}]",
          flush=True)
    for name, c in (("keep-all", keep_counts), ("uniform", drop_counts), ("attention", att_counts)):
        if c != launch:
            fail(f"PyramidDrop {name}: launches {c} != {launch}")
    if sum(plain_counts.values()):
        fail(f"PyramidDrop plain run launched a kernel: {plain_counts}")
    if gap_keep > PACKED_TOL or gap_drop > PACKED_TOL or not torch.equal(drop_idx, plain_idx):
        fail("PyramidDrop through B1 disagrees with vtg_hidden or with its plain run")
    if gap_fault <= PACKED_TOL:
        fail(f"a planted PyramidDrop position fault moved the scores by {gap_fault:.3e}, not "
             f"above {PACKED_TOL}: the check cannot see it")
    for h in (keep, drop, att):
        if not torch.isfinite(h).all():
            fail("PyramidDrop: non-finite hidden")
    if drop.shape[1] != T - dropped or att.shape != drop.shape:
        fail(f"PyramidDrop: {drop.shape[1]} / {att.shape[1]} tokens, not {T - dropped}")
    if not (torch.diff(kept, dim=1) > 0).all():
        fail("PyramidDrop attention stage: kept video indices not increasing")

    # the sliding window: plain windowed attention on the card vs the CPU
    gen = torch.Generator(device="cuda").manual_seed(7)
    hq, hkv, d = 28, 4, 128
    q, k, v = (torch.randn((2, T, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (hq, hkv, hkv))
    mask = mask[:2]
    before = fa.counts()
    qc, kc, vc = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = qwen2.multi_head_attention(qc, kc, vc, key_mask=mask, query_mask=mask, causal=True,
                                     scale=d ** -0.5, window=WINDOW)
    (out.float().square().sum()).backward()
    torch.cuda.synchronize()
    launched = fa.counts() != before
    qh, kh, vh = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    want = reference_attention(qh, kh, vh, mask.cpu(), mask.cpu(), True, d ** -0.5, WINDOW)
    (want.float().square().sum()).backward()
    err = (out.detach().cpu().float() - want.detach().float()).abs()
    excess = (err - ATTN_RTOL * want.detach().float().abs()).max().item()
    grads = [((a.grad.cpu().float() - b.grad.float()).abs().max()
              / b.grad.float().abs().max()).item() for a, b in ((qc, qh), (kc, kh), (vc, vh))]
    unwindowed = qwen2.multi_head_attention(q, k, v, key_mask=mask, query_mask=mask,
                                            causal=True, scale=d ** -0.5)
    moved = (unwindowed.float() - out.detach().float()).abs().max().item()
    print(f"[dormant] windowed attention (window {WINDOW}) on the card at (2, {T}, {hq}, {d}): "
          f"forward vs the CPU plain version max|d| {err.max().item():.3e} (tol {ATTN_ATOL} + "
          f"{ATTN_RTOL}|plain|), gradients dq / dk / dv max|d|/max|plain| "
          + " / ".join(f"{g:.3e}" for g in grads) + f" (tol {GRAD_TOL}); without the window the "
          f"output moves by {moved:.3e}; kernels launched: {'YES' if launched else 'none'} "
          f"[{card}]", flush=True)
    if excess > ATTN_ATOL or max(grads) > GRAD_TOL or launched or moved < 1e-2:
        fail("windowed attention on the card disagrees with the CPU plain version")
    print(f"[time] phase 14 (dormant) took {time.time() - t0:.1f}s", flush=True)
    return dict(pdrop_launches=drop_counts["flash_fwd"] + att_counts["flash_fwd"]
                + keep_counts["flash_fwd"])


def phase_parity(st, fine, card):
    """Phase 15: the last public functions at the 7B's width on phase 3's
    weights and phase 5's LoRA tree, and the port's parity harness on its
    synthetic checkpoint. Returns the phase's launch counts."""
    import torch

    from blim_tpu_torch.adapters import lora as lora_lib
    from blim_tpu_torch.engine.rerank import CaptionBank
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import generation, qwen2
    from blim_tpu_torch.models import videochat_flash as vcf
    from blim_tpu_torch.scoring import criteria

    t0 = time.time()
    cfg, params, tok, layout = st["flow"]
    llm, layers = params["llm"], cfg.llm.num_hidden_layers
    none = {k: 0 for k in fa.counts()}

    def plain_attention(q, k, v, *, key_mask=None, query_mask=None, causal=True, scale=None,
                        window=None):
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale, window)

    def counted(fn, plain=False):
        mha = qwen2.multi_head_attention
        if plain:
            qwen2.multi_head_attention = plain_attention
        fa.reset_counts()
        try:
            with torch.no_grad():
                out = fn()
            torch.cuda.synchronize()
        finally:
            qwen2.multi_head_attention = mha
        return out, fa.counts()

    # (a) forward_logits through B1 against the plain attention, on scores
    r = np.random.default_rng((SEED, 15))
    ids = torch.from_numpy(r.integers(0, 151643, (2, PARITY_TOKENS))).cuda()
    mask = torch.ones((2, PARITY_TOKENS), dtype=torch.int32, device="cuda")
    mask[1, PARITY_REAL:] = 0
    ws, wl = PARITY_WINDOW
    labels = ids[:, ws + 1: ws + wl + 1]

    def window_scores(logits):
        return criteria.vtg_likelihood(logits[:, ws: ws + wl], labels)

    logits, c_b1 = counted(lambda: qwen2.forward_logits(llm, cfg.llm, ids, mask))
    logits_plain, c_plain = counted(lambda: qwen2.forward_logits(llm, cfg.llm, ids, mask),
                                    plain=True)
    s_b1, s_plain = window_scores(logits), window_scores(logits_plain)
    gap_logits = (s_b1 - s_plain).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits, logits_plain
    print(f"[parity] forward_logits at {layers} layers on (2, {PARITY_TOKENS}) text tokens (row "
          f"2 right-padded after {PARITY_REAL}), logits {shape} fp32 "
          f"{'finite' if finite else 'NOT FINITE'}: per-row VTG likelihood over positions "
          f"[{ws}, {ws + wl}) through B1 vs the plain attention max|d| {gap_logits:.3e} (tol "
          f"{PACKED_TOL}; scores {s_b1.tolist()}); launches B1 {c_b1}, plain {c_plain} [{card}]",
          flush=True)
    if c_b1 != dict(none, flash_fwd=layers) or c_plain != none:
        fail(f"forward_logits launches {c_b1} (expected {layers} B1) / plain {c_plain}")
    if not finite or shape != (2, PARITY_TOKENS, cfg.llm.vocab_size) or gap_logits > PACKED_TOL:
        fail("forward_logits through B1 disagrees with the plain attention")

    # (b) the two window-CE routes on one hidden
    hidden, c_hidden = counted(lambda: qwen2.forward_hidden(
        llm, cfg.llm, qwen2.embed_tokens(llm, ids), mask))
    win = hidden[:, ws: ws + wl]
    kernel = qwen2.lm_head_kernel(llm)
    with torch.no_grad():
        unfused = criteria.vtg_likelihood(criteria.chunked_window_logits(win, kernel), labels)
        fused = criteria.vtg_likelihood_from_hidden(win, kernel, labels)
    gap_ce = (unfused - fused).abs().max().item()
    print(f"[parity] window CE on the same hidden (2 x {wl} positions, V {cfg.llm.vocab_size}): "
          f"vtg_likelihood(chunked_window_logits) vs vtg_likelihood_from_hidden max|d| "
          f"{gap_ce:.3e} (tol {WINDOW_CE_TOL}); scores {fused.tolist()} [{card}]", flush=True)
    if gap_ce > WINDOW_CE_TOL or not torch.isfinite(fused).all():
        fail(f"the two window-CE routes disagree by {gap_ce:.3e}")
    del hidden, win

    # (c) the LoRA merged into the weights against the LoRA applied
    lora, scale = fine["ft"]["lora"], fine["ft"]["lora_scale"]
    bank = CaptionBank.build_vtg(st["inputs"].captions[:MERGE_ROWS], tok, "MSRVTT", layout)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    batch = {k: dev(getattr(bank, k)) for k in ("input_ids", "attention_mask", "cpn_mask",
                                                  "window_labels")}
    batch["video"] = dev(st["inputs"].features[:MERGE_ROWS]).to(
        llm["embed_tokens"]["embedding"].dtype)
    vs, (lws, lwl) = layout.video_start, layout.label_window

    def vtg(p, lo=None):
        return counted(lambda: vcf.score_vtg(p, cfg, batch, vs, lws, lwl, lora=lo,
                                             lora_scale=scale))

    torch.cuda.reset_peak_memory_stats()
    applied, c_applied = vtg(params, lora)
    base = vtg(params)[0]
    t_merge = time.time()
    merged_tree = lora_lib.merge_lora(params, lora, scale)
    torch.cuda.synchronize()
    t_merge = time.time() - t_merge
    merged, c_merged = vtg(merged_tree)

    def decode_ms(p, lo=None):
        """ms a greedy decode step from the real row of (a), batch 1 (no EOS)."""
        emb = qwen2.embed_tokens(p["llm"], ids[:1])

        def run(n):
            torch.cuda.synchronize()
            t = time.time()
            with torch.no_grad():
                generation.generate_tokens(p["llm"], cfg.llm, emb, mask[:1], n, [-1], lora=lo,
                                           lora_scale=scale)
            torch.cuda.synchronize()
            return time.time() - t
        run(2)
        return (run(MERGE_DECODE_TOKENS + 1) - run(1)) / MERGE_DECODE_TOKENS * 1e3

    decode = {"merged": decode_ms(merged_tree), "applied": decode_ms(params, lora["llm"])}
    del merged_tree
    no_scale = lora_lib.merge_lora(params, lora, 1.0)
    fault_scale = vtg(no_scale)[0]
    del no_scale
    flipped = dict(lora, llm=dict(lora["llm"], layers={
        n: {k: f.flip(0) for k, f in ab.items()} for n, ab in lora["llm"]["layers"].items()}))
    reordered = lora_lib.merge_lora(params, flipped, scale)
    fault_order = vtg(reordered)[0]
    del reordered, flipped
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    gap = lambda a: (a - applied).abs().max().item()  # noqa: E731
    gaps = {"merged": gap(merged), "no LoRA": gap(base), "scale left out": gap(fault_scale),
            "layers reversed": gap(fault_order)}
    mean_gap = (merged - applied).abs().mean().item()
    print(f"[parity] LoRA merged into q/k/v/o ({layers} layers), lm_head and the projector in "
          f"{t_merge:.2f}s, peak {peak:.2f} GiB: {MERGE_ROWS} VTG rows' caption scores (~"
          f"{applied.mean().item():.2f}) max|d| against the LoRA applied: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (tol {MERGE_TOL}; merged mean |d| {mean_gap:.3e}); launches applied "
          f"{c_applied['flash_fwd']}, merged {c_merged['flash_fwd']}; greedy decode (batch 1, "
          f"{PARITY_TOKENS}-token prompt) {decode['merged']:.2f} ms/token merged against "
          f"{decode['applied']:.2f} with the LoRA applied (phase 12 decodes without a LoRA) "
          f"[{card}]", flush=True)
    if gaps["merged"] > MERGE_TOL or not torch.isfinite(merged).all():
        fail(f"the merged LoRA scores disagree with the applied LoRA's: {gaps['merged']:.3e}")
    if gaps["scale left out"] <= MERGE_TOL:
        fail(f"a merge planted without its scale moved the scores by {gaps['scale left out']:.3e},"
             f" not above {MERGE_TOL}: the check cannot see it")
    if c_merged != dict(none, flash_fwd=layers) or c_applied != c_merged:
        fail(f"merged / applied scoring launches {c_merged} / {c_applied}")

    # (c') the same merge in fp32 through the plain attention: what is left of
    # the bf16 gap once nothing is rounded to bf16
    f32 = lambda t: _tree_map(lambda a: a.float() if a.is_floating_point() else a, t)  # noqa: E731
    t_f32 = time.time()
    params32, lora32 = f32(params), f32(lora)
    batch32 = dict(batch, video=batch["video"].float())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def vtg32(p, lo=None):
            got, c = counted(lambda: vcf.score_vtg(p, cfg, batch32, vs, lws, lwl, lora=lo,
                                                   lora_scale=scale), plain=True)
            if c != none:
                fail(f"the fp32 scoring through the plain attention launched {c}")
            return got
        applied32 = vtg32(params32, lora32)
        merged32 = vtg32(lora_lib.merge_lora(params32, lora32, scale))
        fault32 = vtg32(lora_lib.merge_lora(params32, lora32, 1.0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del params32, lora32
    torch.cuda.empty_cache()
    gap32 = (merged32 - applied32).abs().max().item()
    fault_gap32 = (fault32 - applied32).abs().max().item()
    bf16_vs_f32 = (applied - applied32).abs().max().item()
    print(f"[parity] the same in fp32 (the 7B, the LoRA and the merge; plain attention, TF32 "
          f"off) in {time.time() - t_f32:.1f}s: merged vs applied max|d| {gap32:.3e} (tol "
          f"{MERGE_F32_TOL}), scale left out {fault_gap32:.3e}; bf16 applied vs fp32 applied "
          f"{bf16_vs_f32:.3e} [{card}]", flush=True)
    if gap32 > MERGE_F32_TOL or not torch.isfinite(merged32).all():
        fail(f"the fp32 merged LoRA scores disagree with the applied LoRA's: {gap32:.3e}")
    if fault_gap32 <= MERGE_F32_TOL:
        fail(f"an fp32 merge planted without its scale moved the scores by {fault_gap32:.3e},"
             f" not above {MERGE_F32_TOL}: the check cannot see it")

    # (d) the port's parity harness on its synthetic checkpoint, on the card
    t_script = time.time()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "parity_torch.py"),
                           "--synthetic", "--device", "cuda"], cwd=ROOT, capture_output=True,
                          text=True, timeout=PARITY_SCRIPT_TIMEOUT_S)
    t_script = time.time() - t_script
    out = proc.stdout
    summary = {line.split(None, 1)[1]: line.split()[0] for line in
               out.split("== parity summary ==")[-1].splitlines()
               if line.startswith("  ") and len(line.split()) > 1}
    launch_lines = [l for l in out.splitlines() if l.startswith("launches: ")]
    script = json.loads(launch_lines[-1][len("launches: "):]) if launch_lines else {}
    for line in out.splitlines():
        if line.startswith("[") and "] " in line[:8]:
            print(f"[parity]   {line}", flush=True)
    print(f"[parity] scripts/parity_torch.py --synthetic --device cuda: exit {proc.returncode} "
          f"in {t_script:.1f}s, steps {summary}, launches {script} [{card}]", flush=True)
    if proc.returncode != 0 or "FAIL" in summary.values():
        fail(f"parity_torch.py --synthetic failed (exit {proc.returncode}):\n"
             f"{proc.stderr[-3000:]}\n{out[-3000:]}")
    if summary.get("5 train trajectory") != "PASS" or summary.get("2 logit parity") not in (
            "PASS", "SKIP"):
        fail(f"parity_torch.py --synthetic: steps {summary}")
    if not all(script.get(k, 0) > 0 for k in ("flash_fwd", "flash_fwd_lse", "flash_dq",
                                               "flash_dkv")):
        fail(f"parity_torch.py --synthetic on the card did not launch every kernel: {script}")

    # (e) B1-lse, B3 and B4 at the harness's own train shapes and masks
    train_errs = hold_parity_train_kernels(synthetic_train_calls(), card)
    print(f"[time] phase 15 (parity) took {time.time() - t0:.1f}s [{card}]", flush=True)
    return dict(forward_logits=c_b1["flash_fwd"] + c_hidden["flash_fwd"],
                merged_lora=c_merged["flash_fwd"] + c_applied["flash_fwd"], script=script,
                decode_ms=decode, train_errs=train_errs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def synthetic_train_calls(device="cuda"):
    """The distinct B1-lse calls (q and k shapes, key and query masks, causal,
    scale) of one step of scripts/parity_torch.py's step 5 on its synthetic
    checkpoint, run in this process with a recording wrapper around the
    wrapper. The harness's report lines are printed, prefixed."""
    import contextlib
    import importlib.util
    import io

    from blim_tpu_torch.kernels import flash_attention as fa

    spec = importlib.util.spec_from_file_location("parity_torch",
                                                  ROOT / "scripts" / "parity_torch.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    calls, lse = {}, fa.flash_attention_lse

    def recording(q, k, v, *, key_mask=None, query_mask=None, causal=True, scale=None):
        masks = tuple(None if m is None else m.detach().clone() for m in (key_mask, query_mask))
        key = (tuple(q.shape), tuple(k.shape), causal, scale) + tuple(
            None if m is None else m.cpu().numpy().tobytes() for m in masks)
        calls.setdefault(key, (tuple(q.shape), tuple(k.shape), *masks, causal, scale))
        return lse(q, k, v, key_mask=key_mask, query_mask=query_mask, causal=causal, scale=scale)

    out = io.StringIO()
    fa.flash_attention_lse = recording
    try:
        with contextlib.redirect_stdout(out):
            rc = harness.main(["--synthetic", "--device", device, "--steps", "5",
                               "--train_steps", "1"])
    finally:
        fa.flash_attention_lse = lse
    for line in out.getvalue().splitlines():
        if line.startswith("["):
            print(f"[parity]   {line}", flush=True)
    if rc != 0 or not calls:
        fail(f"parity_torch.py step 5 in this process: exit {rc}, {len(calls)} attention calls"
             f" recorded:\n{out.getvalue()[-3000:]}")
    return list(calls.values())


def hold_parity_train_kernels(calls, card):
    """B1-lse, then B3 and B4 on the plain forward's O and lse, against their
    plain versions on unit-normal bf16 q, k, v and dO at each recorded call's
    shapes and masks, as phase 6 holds them at the 7B's. Returns the max
    |kernel - plain| of each kernel."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(15)
    errs = {"flash_fwd_lse": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for qs, ks, km, qm, causal, scale in calls:
        b, s, hq, d = qs
        rnd = lambda shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                        dtype=torch.bfloat16)
        q, k, v, dout = rnd(qs), rnd(ks), rnd(ks), rnd(qs)
        km, qm = (None if m is None else m.cuda() for m in (km, qm))
        out, lse = fa.flash_attention_lse(q, k, v, key_mask=km, query_mask=qm, causal=causal,
                                          scale=scale)
        ref, ref_lse = fa.reference_attention_lse(q, k, v, km, qm, causal, scale)
        # lse rows that mean something: the query emits and sees a key
        keys = (torch.ones((b, s), device="cuda") if km is None else km.float())
        seen = keys.cumsum(1) > 0 if causal else keys.sum(1, keepdim=True).expand(b, s) > 0
        rows = (seen if qm is None else seen & qm.bool())[:, None, :].expand(b, hq, s)
        diff = (out.float() - ref.float()).abs()
        excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
        err_lse = (lse - ref_lse)[rows].abs().max().item()
        dq, dk, dv = fa.flash_attention_backward(q, k, v, km, qm, ref, ref_lse, dout, causal,
                                                 scale)
        want = fa.reference_attention_backward(q, k, v, km, qm, ref, ref_lse, dout, causal,
                                               scale)
        gerr = {g: ((got.float() - w.float()).abs().max().item(), w.float().abs().max().item())
                for g, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        finite = all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv)) \
            and bool(torch.isfinite(lse[rows]).all())
        masks = ", ".join(f"{n} {'none' if m is None else f'{int(m.sum())}/{m.numel()} ones'}"
                          for n, m in (("key mask", km), ("query mask", qm)))
        print(f"[parity] harness train shape q {qs}, k/v {ks} ({masks}, causal {causal}): "
              f"B1-lse out max|d| {diff.max().item():.3e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|),"
              f" lse {err_lse:.3e} (tol {LSE_TOL}); " + ", ".join(
                  f"{g} {e:.3e} (max|plain| {mx:.3e})" for g, (e, mx) in gerr.items())
              + f" (tol {GRAD_TOL} max|plain|) [{card}]", flush=True)
        if not finite:
            fail(f"harness train shape {qs}: non-finite kernel output")
        if excess > ATTN_ATOL or err_lse > LSE_TOL:
            fail(f"flash_fwd_lse at the harness train shape {qs}: kernel and plain disagree")
        for g, (e, mx) in gerr.items():
            if e > GRAD_TOL * mx:
                fail(f"{g} at the harness train shape {qs}: |kernel - plain| {e:.3e} > "
                     f"{GRAD_TOL} x {mx:.3e}")
        errs["flash_fwd_lse"] = max(errs["flash_fwd_lse"], diff.max().item(), err_lse)
        errs["flash_dq"] = max(errs["flash_dq"], gerr["dq"][0])
        errs["flash_dkv"] = max(errs["flash_dkv"], gerr["dk"][0], gerr["dv"][0])
    return errs


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
    expected = dict({k: 0 for k in counts}, flash_fwd_lse=TRAIN_STEPS * (1 + 1) * layers * 2,
                    flash_dq=TRAIN_STEPS * layers * 2, flash_dkv=TRAIN_STEPS * layers * 2)
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
    expected = dict({k: 0 for k in k_counts}, flash_fwd_lse=2 * 2 * GRADCHECK_LAYERS,
                    flash_dq=2 * GRADCHECK_LAYERS, flash_dkv=2 * GRADCHECK_LAYERS)
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


def dp_train_setup(flow, parts, accum=1):
    """Phase 13's train step: phase 7's settings (lr 1e-4, no warmup, 100
    steps an epoch, LoRA dropout on) with accum_iter `accum`, one B = TRAIN_B
    batch from the seed split into `parts` equal parts, the trainable tree
    from SEED (broadcast from rank 0 in a group), the video vocabulary."""
    import torch

    from blim_tpu_torch.engine import train as train_lib

    cfg, _, tok, vtg_layout = flow
    tvg_layout, batch, vocab = train_setup(cfg, tok, vtg_layout, 13)
    full, b = batch(TRAIN_B), TRAIN_B // parts
    split = [{k: v[i * b: (i + 1) * b] for k, v in full.items()} for i in range(parts)]
    tcfg = train_lib.TrainConfig(lr=1e-4, warmup_epochs=0.0, epochs=1, accum_iter=accum)
    trainable = train_lib.init_trainable(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, tcfg,
        visual_head=torch.full((cfg.llm.hidden_size, cfg.mm_hidden_size), 0.02))
    state = train_lib.init_train_state(trainable, tcfg, steps_per_epoch=100)
    step = train_lib.make_train_step(cfg, tcfg, vtg_layout, tvg_layout, device="cuda")
    return state, step, split, torch.from_numpy(vocab).cuda()


def dropout_generator(part):
    """The LoRA dropout stream of batch part `part` (rank `part` in phase 13)."""
    import torch

    return torch.Generator(device="cuda").manual_seed(SEED + 100 + part)


def snapshot(tree, grads=False):
    """name -> numpy copy of each leaf (of its .grad with `grads`)."""
    return {n: (t.grad if grads else t).detach().cpu().numpy().copy()
            for n, t in _named_leaves(tree)}


def applied_gradients(store, tree):
    """Wrap engine.train.average_gradients so that each applied update
    appends snapshot(tree, grads=True) to `store` after the averaging;
    returns the function that undoes the wrap."""
    from blim_tpu_torch.engine import train as train_lib

    real = train_lib.average_gradients

    def spy(leaves):
        real(leaves)
        store.append(snapshot(tree, grads=True))

    train_lib.average_gradients = spy
    return lambda: setattr(train_lib, "average_gradients", real)


def leaf_gap(got, want):
    """(the worst max|got - want| / max|want| over the leaves, its leaf)."""
    return max((float(np.abs(got[n] - want[n]).max()) / max(float(np.abs(want[n]).max()), 1e-30),
                n) for n in want)


def dp_train_reference(st, parts):
    """The one-process yardstick of phase 13's data-parallel steps: per
    step, `parts` accumulated micro-steps over the batch's parts, each with
    its part's dropout stream, so the applied gradient is the mean of the
    parts' gradients. Returns, for each of DP_TRAIN_STEPS applied steps,
    {"grad": that mean gradient, "tree": the trainable tree after the
    update} (name -> numpy)."""
    state, step, split, vocab = dp_train_setup(st["flow"], parts, accum=parts)
    gens = [dropout_generator(i) for i in range(parts)]
    grads, out = [], []
    undo = applied_gradients(grads, state.trainable)
    try:
        for _ in range(DP_TRAIN_STEPS):
            for i in range(parts):
                state, _ = step(state, st["flow"][1], split[i], vocab, gens[i])
            out.append({"grad": grads[-1], "tree": snapshot(state.trainable)})
    finally:
        undo()
    del state, step
    return out


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_environment(rank, world, port, local_rank):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))


def spawn_ranks(fn, world, backend, tmp, label):
    """Start `world` processes of fn(rank, world, port, backend, tmp) (spawn),
    join them within DP_TIMEOUT_S and kill any still alive; a rank that
    raises or dies fails the script. Returns (each rank's pickled result,
    seconds from spawn to join)."""
    import pickle

    import torch.multiprocessing as mp

    t = time.time()
    ctx = mp.start_processes(fn, args=(world, free_port(), backend, tmp), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t > DP_TIMEOUT_S:
                fail(f"{label}: ranks still running after {DP_TIMEOUT_S}s (killed)")
    except Exception as e:       # a rank raised or died: join terminated the others
        fail(f"{label}: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.time() - t
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out, wall


def step_sizes(m, G, lo, hi):
    """The batch size of the step that scores each of a bucket's m packs
    when packs [lo, hi) are run in batch_plan steps of up to G (None
    outside [lo, hi))."""
    from blim_tpu_torch.engine.rerank import batch_plan

    out, s = [None] * m, lo
    for g in batch_plan(hi - lo, G):
        n = min(g, hi - s)
        out[s: s + n] = [g] * n
        s += n
    return out


def record_vtg_steps(store):
    """Wrap RerankEngine.score_pairs_vtg_packed so that each call records,
    for each (caption, video) pair this rank scores, its pack size and the
    batch size of the step that scores its pack, on this rank and in one
    process: store[(caption, video)] = (size, one-process g, this rank's g).
    Returns the function that undoes the wrap."""
    from blim_tpu_torch.engine import rerank
    from blim_tpu_torch.utils import distributed as dist

    real = rerank.RerankEngine.score_pairs_vtg_packed

    def spy(self, banks, cap_idx, vid_idx):
        p_len = len(self.vtg_layout.prefix_token_ids())
        for size, packs in rerank.build_packs(vid_idx, cap_idx, banks["suffix_len_host"],
                                              self.pack_sizes):
            m, G = len(packs), rerank.packs_per_step(p_len, size)
            lo, hi = dist.process_shard_bounds(m, dist.get_world_size(), dist.get_rank())
            one, mine = step_sizes(m, G, 0, m), step_sizes(m, G, lo, hi)
            for j in range(lo, hi):
                for p in packs[j][2]:
                    store[(int(cap_idx[p]), int(vid_idx[p]))] = (size, one[j], mine[j])
        return real(self, banks, cap_idx, vid_idx)

    rerank.RerankEngine.score_pairs_vtg_packed = spy
    return lambda: setattr(rerank.RerankEngine, "score_pairs_vtg_packed", real)


def dp_rank(rank, world, port, backend, tmp):
    """One rank of phase 13a (gloo, every rank on cuda:0 by choice) or 13c
    (NCCL, one card a rank): phase 3's seeded 7B and inputs and phase 5's
    LoRA tree; the zero-shot and fine-tuned flows at ITEMS, each held to the
    one-process matrices the parent saved in tmp/ref.npz (VTG within
    DP_VTG_TOL on the max and DP_VTG_MEAN_TOL on the mean, TVG within
    TVG_TOL), each VTG pair's pack and step sizes recorded
    (record_vtg_steps); then DP_TRAIN_STEPS data-parallel train
    steps on this rank's part of a B = TRAIN_B batch: the gradient each
    update applies held to the one-process yardstick's (the mean of the
    parts' gradients) within GRADCHECK_TOL per leaf, and the tree after the
    first update too (after later ones it is printed: AdamW moves each
    element by about lr whatever its gradient's size, so an element whose
    gradient is at the rounding level, as the q and k LoRA gradients are
    under near-uniform attention, may move either way). The results go to
    tmp/rank{rank}.pkl for the parent's checks across ranks."""
    import pickle

    import torch

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.utils import distributed as dist

    rank_environment(rank, world, port, rank if backend == "nccl" else 0)
    dist.init_distributed_mode(backend=backend, device="cuda", timeout=DP_GROUP_TIMEOUT_S)
    ref = np.load(os.path.join(tmp, "ref.npz"))
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.backend(),
           "device": torch.cuda.current_device()}
    t = time.time()
    flow = setup_flow()
    out["layers"] = flow[0].llm.num_hidden_layers
    ft = setup_finetuned(flow)
    torch.cuda.synchronize()
    out["init_s"] = time.time() - t
    for name, fine in (("zeroshot", None), ("finetuned", ft)):
        dist.barrier()                 # the ranks start each timed flow together
        fa.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        steps = {}
        undo = record_vtg_steps(steps)
        try:
            _, engine, t2v, v2t, secs = run_flow(flow, ITEMS, finetuned=fine)
        finally:
            undo()
        mats = {"t2v": t2v, "v2t": v2t}
        want = {d: {n: ref[f"{name}/{d}/{n}"] for _, n in VTG_MATRICES + TVG_MATRICES
                    if f"{name}/{d}/{n}" in ref} for d in ("t2v", "v2t")}
        vtg, vtg_fill, vtg_mean = matrix_gaps(mats, want, VTG_MATRICES)
        tvg, tvg_fill, _ = matrix_gaps(mats, want, TVG_MATRICES) if fine else ({}, True, 0.0)
        out[name] = dict(mats=mats, seconds=secs, counts=fa.counts(),
                         prefix_forwards=engine.prefix_forwards, shards=engine.pack_shards,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30, vtg=vtg, tvg=tvg,
                         vtg_mean=vtg_mean, steps=steps)
        assert vtg_fill and tvg_fill, f"rank {rank} {name}: fill cells differ from one process"
        assert max(vtg.values()) <= DP_VTG_TOL and vtg_mean <= DP_VTG_MEAN_TOL and max(
            tvg.values() or [0.0]) <= TVG_TOL, (
            f"rank {rank} {name}: matrices off the one-process run: {vtg} (mean {vtg_mean}) {tvg}")
        del engine
    state, step, split, vocab = dp_train_setup(flow, world)
    gen = dropout_generator(rank)
    torch.cuda.reset_peak_memory_stats()
    out["train"], grads = [], []
    undo = applied_gradients(grads, state.trainable)
    for i in range(DP_TRAIN_STEPS):
        fa.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, flow[1], split[rank], vocab, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        tree = snapshot(state.trainable)
        want = {k: {n: ref[f"train{world}/{i}/{k}/{n}"] for n in tree} for k in ("grad", "tree")}
        gap = {"grad": leaf_gap(grads[-1], want["grad"]), "tree": leaf_gap(tree, want["tree"])}
        out["train"].append(dict(ms=ms, counts=fa.counts(), loss=float(m["loss"]), tree=tree,
                                 gap=gap))
        assert gap["grad"][0] <= GRADCHECK_TOL, f"rank {rank} step {i}: gradient off {gap}"
        assert i > 0 or gap["tree"][0] <= GRADCHECK_TOL, f"rank {rank} step 0: tree off {gap}"
    undo()
    out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def dp_control_rank(rank, world, port, backend, tmp):
    """Phase 13a's control: one gloo rank in a group of one builds phase
    3's 7B and phase 5's LoRA tree and runs the fine-tuned flow at ITEMS:
    every pack in its shard, so every step as phase 5 ran it. Its matrices
    go to tmp/rank0.pkl."""
    import pickle

    import torch

    from blim_tpu_torch.utils import distributed as dist

    rank_environment(rank, world, port, 0)
    dist.init_distributed_mode(backend=backend, device="cuda", timeout=DP_GROUP_TIMEOUT_S)
    flow = setup_flow()
    _, _, t2v, v2t, secs = run_flow(flow, ITEMS, finetuned=setup_finetuned(flow))
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.backend(),
               device=torch.cuda.current_device(), mats={"t2v": t2v, "v2t": v2t},
               seconds=secs)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def dp_cli_rank(rank, world, port, backend, tmp):
    """Phase 13b's process: pipelines.main under a torchrun-style
    environment at world `world` (the backend chosen by main: NCCL on the
    card), a zero-shot eval and a one-epoch training run on tmp/data; then,
    with the group destroyed and the environment gone, the same eval again.
    The results go to tmp/rank{rank}.pkl."""
    import pickle

    from blim_tpu_torch.engine import loop as loop_lib
    from blim_tpu_torch.utils import distributed as dist

    rank_environment(rank, world, port, rank)
    root = os.path.join(tmp, "data")
    common = ["--dataset", "MSRVTT", "--data_root", root, "--scores_dir",
              os.path.join(root, "scores"), "--model_path", os.path.join(tmp, "no_checkpoint"),
              "--topk", str(TOPK), "--cpn"]
    out = {}
    runs = (("eval", ["--eval", "--preset", "--output_dir", os.path.join(tmp, "eval")]),
            ("train", ["--epochs", "1", "--batch_size", "4", "--output_dir",
                       os.path.join(tmp, "train")]),
            ("plain", ["--eval", "--preset", "--output_dir", os.path.join(tmp, "plain")]))
    for name, argv in runs:
        if name == "plain":
            dist.destroy_process_group()
            for k in dist.LAUNCH_ENV:
                os.environ.pop(k)
        dist.calls.clear()
        res, prefix_forwards, times, counts = run_cli(common + argv, "")
        out[name] = dict(table=loop_lib.results_table(res), calls=dict(dist.calls),
                         backend=dist.backend(), world=dist.get_world_size(), wall=times["wall"],
                         epochs=times["epochs"], evals=times["evals"], counts=counts,
                         prefix_forwards=prefix_forwards)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def joined(values, spec):
    return ", ".join(format(v, spec) for v in values)


def vtg_gap_by_step(per, want):
    """The sharded VTG matrices' |rank - one process| (v2t candidate and t2v
    query likelihoods; the prior pass is not sharded), split by whether the
    step that scored a cell's pack had the one-process step's batch size
    (record_vtg_steps): (cells and max |d| where it had, cells and max |d|
    where it had not, {(pack size, one-process g, rank g): cells above
    1e-3})."""
    import collections

    steps = {}
    for o in per:
        steps.update(o["steps"])
    got = per[0]["mats"]
    same, moved, over = [], [], collections.Counter()
    for d, n, key in (("v2t", "candidate_likelihood", lambda r, c: (c, r)),
                      ("t2v", "query_likelihood", lambda r, c: (r, c))):
        w = want[d][n]
        for r, c in zip(*np.nonzero(w != -100.0)):
            size, g_one, g_rank = steps[key(int(r), int(c))]
            gap = abs(float(got[d][n][r, c]) - float(w[r, c]))
            (same if g_one == g_rank else moved).append(gap)
            if gap > 1e-3:
                over[(size, g_one, g_rank)] += 1
    return (len(same), max(same, default=0.0), len(moved), max(moved, default=0.0),
            dict(sorted(over.items())))


def check_dp_ranks(label, results, refs, card):
    """The parent's checks of a group of dp_rank results: the group, each
    rank's launches (B1 = 28 x its prefix forwards; 112 / 56 / 56 B1-lse /
    B3 / B4 a train step), the ranks' matrices and trees identical bit for
    bit, the pack shards disjoint and covering every bucket, their union the
    one-process pack count. Prints the walls, peaks and q/s."""
    world = len(results)
    layers = results[0]["layers"]
    for r, out in enumerate(results):
        if (out["rank"], out["world"]) != (r, world):
            fail(f"{label}: rank {r} reports rank {out['rank']} of {out['world']}")
    for name in ("zeroshot", "finetuned"):
        per = [out[name] for out in results]
        for r, o in enumerate(per):
            expected = dict({k: 0 for k in o["counts"]}, flash_fwd=layers * o["prefix_forwards"])
            if o["counts"] != expected:
                fail(f"{label} {name}: rank {r} launches {o['counts']} != {expected}")
        for d in ("t2v", "v2t"):
            for n, m in per[0]["mats"][d].items():
                if any(not np.array_equal(m, o["mats"][d][n]) for o in per[1:]):
                    fail(f"{label} {name}: {d} {n} differs across the ranks")
        shards = [o["shards"] for o in per]
        if len({len(s) for s in shards}) != 1:
            fail(f"{label} {name}: the ranks saw different bucket lists")
        scored = [0] * world
        for i, entries in enumerate(zip(*shards)):
            if len({(e[0], e[1], e[4]) for e in entries}) != 1:
                fail(f"{label} {name}: bucket {i} differs across the ranks: {entries}")
            edges = [0] + [e[3] for e in entries]
            if any(e[2] != edges[r] for r, e in enumerate(entries)) or edges[-1] != entries[0][4]:
                fail(f"{label} {name}: bucket {i}'s shards do not tile its packs: {entries}")
            for r, e in enumerate(entries):
                scored[r] += e[3] - e[2]
        total = sum(e[4] for e in shards[0])
        if sum(scored) != total or total != refs[name]["packs"]:
            fail(f"{label} {name}: the ranks scored {scored} packs, the one-process run "
                 f"{refs[name]['packs']}")
        secs = [o["seconds"] for o in per]
        print(f"[dp] {label} {name} at {ITEMS} items: per rank {joined(secs, '.2f')} s = "
              f"{joined([ITEMS / x for x in secs], '.3f')} q/s, together {ITEMS / max(secs):.3f}"
              f" q/s (one process, phase {3 if name == 'zeroshot' else 5}: "
              f"{refs[name]['qps']:.3f}); packs scored {scored} of {total} (disjoint, covering); "
              f"B1 launches {[o['counts']['flash_fwd'] for o in per]} = 28 x prefix forwards "
              f"{[o['prefix_forwards'] for o in per]}; peak {joined([o['peak_gib'] for o in per], '.2f')}"
              f" GiB; max|rank - one process| "
              + ", ".join(f"{k} {v:.3e}" for k, v in {**per[0]['vtg'], **per[0]['tvg']}.items())
              + f", VTG mean {per[0]['vtg_mean']:.3e} (tol VTG {DP_VTG_TOL}, mean "
              f"{DP_VTG_MEAN_TOL}, TVG {TVG_TOL}); the ranks' matrices identical bit for "
              f"bit [{card}]", flush=True)
        n_same, same, n_moved, moved, over = vtg_gap_by_step(per, refs[name])
        print(f"[dp] {label} {name}, max|rank - one process| of the sharded VTG cells by the "
              f"step that scored their pack: {n_same} cells in steps of the one-process batch "
              f"size {same:.3e} (tol {DP_SAME_SHAPE_TOL}), {n_moved} in steps of another size "
              f"{moved:.3e}; cells above 1e-3 by (pack size, one-process step, rank step) "
              f"{over} [{card}]", flush=True)
        if same > DP_SAME_SHAPE_TOL:
            fail(f"{label} {name}: cells whose steps kept their batch size are {same:.3e} off "
                 f"the one-process run")
    train_expected = dict({k: 0 for k in results[0]["train"][0]["counts"]},
                          flash_fwd_lse=4 * layers, flash_dq=2 * layers, flash_dkv=2 * layers)
    for i in range(DP_TRAIN_STEPS):
        steps = [out["train"][i] for out in results]
        for r, st in enumerate(steps):
            if st["counts"] != train_expected:
                fail(f"{label} train step {i}: rank {r} launches {st['counts']} != "
                     f"{train_expected}")
        base = steps[0]["tree"]
        if any(not np.array_equal(base[n], st["tree"][n]) for st in steps[1:] for n in base):
            fail(f"{label} train step {i}: the ranks' trainable trees differ")
        (g, g_leaf), (t, t_leaf) = steps[0]["gap"]["grad"], steps[0]["gap"]["tree"]
        print(f"[dp] {label} train step {i}: B = {TRAIN_B // world} a rank, "
              f"{joined([x['ms'] for x in steps], '.1f')} ms, loss "
              f"{joined([x['loss'] for x in steps], '.4f')}; trees identical across the ranks "
              f"bit for bit; against the one-process step on the mean of the parts' gradients, "
              f"worst leaf max|d|/max|yardstick| of the applied gradient {g:.3e} at {g_leaf} (tol "
              f"{GRADCHECK_TOL}), of the tree {t:.3e} at {t_leaf} "
              + (f"(tol {GRADCHECK_TOL})" if i == 0 else "(reported: Adam moves every element by "
                 "~lr whatever its size, so gradient elements at the rounding level can flip)")
              + f"; launches a rank {steps[0]['counts']} [{card}]", flush=True)
    print(f"[dp] {label} train peak per rank "
          f"{joined([o['train_peak_gib'] for o in results], '.2f')} GiB; 7B init per rank "
          f"{joined([o['init_s'] for o in results], '.1f')} s", flush=True)
    return [o["finetuned"]["counts"]["flash_fwd"] for o in results], \
        [o["train"][0]["counts"] for o in results]


def dp_group(tmp, name, world, backend, refs, card):
    """13a (gloo, every rank on cuda:0) or 13c (NCCL, one card a rank): a
    group of dp_rank processes and the parent's checks of it."""
    sub = os.path.join(tmp, name)
    os.makedirs(sub)
    os.symlink(os.path.join(tmp, "ref.npz"), os.path.join(sub, "ref.npz"))
    results, wall = spawn_ranks(dp_rank, world, backend, sub, name)
    placed = [(o["backend"], o["device"]) for o in results]
    want = [(backend, 0 if backend == "gloo" else r) for r in range(world)]
    if sorted(placed, key=lambda x: x[1]) != want:
        fail(f"{name}: ranks on {placed}, expected {want}")
    print(f"[dp] {name}: {world} {backend} ranks on cuda {sorted({d for _, d in placed})} "
          f"({wall:.1f}s spawn to join)"
          + ("; they share one card, so their q/s says nothing about scaling"
             if backend == "gloo" else ""), flush=True)
    return check_dp_ranks(name, results, refs, card)


def dp_cli(tmp, card):
    """13b: pipelines.main under torchrun's environment at world 1 (NCCL),
    held to the same eval without that environment."""
    sub = os.path.join(tmp, "13b")
    os.makedirs(sub)
    write_cli_data(os.path.join(sub, "data"), cli_config())
    (out,), wall = spawn_ranks(dp_cli_rank, 1, "nccl", sub, "13b")
    ev, tr, plain = out["eval"], out["train"], out["plain"]
    print(f"[dp] 13b: pipelines.main with RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT "
          f"set, world {ev['world']}, backend {ev['backend']} ({wall:.1f}s spawn to join): "
          f"zero-shot eval wall {ev['wall']:.2f}s, collectives {ev['calls']}; one epoch wall "
          f"{tr['wall']:.2f}s (epoch {tr['epochs'][0]:.2f}s), collectives {tr['calls']}, "
          f"launches {tr['counts']}; the same eval without the environment: backend "
          f"{plain['backend']}, collectives {plain['calls']}, wall {plain['wall']:.2f}s, table "
          f"{'equal' if plain['table'] == ev['table'] else 'DIFFERENT'} [{card}]", flush=True)
    if ev["backend"] != "nccl" or tr["backend"] != "nccl" or ev["world"] != 1:
        fail(f"13b: the CLI's group is {ev['backend']} at world {ev['world']}, not NCCL at 1")
    if not ev["calls"].get("all_reduce") or not all(
            tr["calls"].get(k) for k in ("all_reduce", "barrier", "broadcast")):
        fail(f"13b: collectives did not run: eval {ev['calls']}, train {tr['calls']}")
    if plain["backend"] is not None or plain["calls"]:
        fail(f"13b: without the environment a group or collectives remained: {plain}")
    if plain["table"] != ev["table"]:
        print(ev["table"], plain["table"], sep="\n", flush=True)
        fail("13b: the eval's table under the launcher differs from the plain run's")


def dp_control(tmp, refs, card):
    """13a's control: dp_control_rank, a gloo group of one on cuda:0, held
    to phase 5's matrices within DP_SAME_SHAPE_TOL."""
    sub = os.path.join(tmp, "13a-control")
    os.makedirs(sub)
    (out,), wall = spawn_ranks(dp_control_rank, 1, "gloo", sub, "13a control")
    gaps, fill, _ = matrix_gaps(out["mats"], refs["finetuned"], VTG_MATRICES + TVG_MATRICES)
    worst = max(gaps.values())
    print(f"[dp] 13a control: 1 {out['backend']} rank on cuda {out['device']} ({wall:.1f}s spawn "
          f"to join), the fine-tuned flow at {ITEMS} items in {out['seconds']:.2f}s; "
          f"max|rank - one process| " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (tol {DP_SAME_SHAPE_TOL}){'; bit for bit' if worst == 0.0 else ''} [{card}]",
          flush=True)
    if (out["world"], out["backend"]) != (1, "gloo") or not fill or worst > DP_SAME_SHAPE_TOL:
        fail(f"13a control: a world-1 rank differs from the one-process run: {gaps}")


def phase_dp(card, refs):
    """Phase 13: data parallel over processes. 13a, DP_WORLD gloo ranks on
    the one card, and a control rank in a group of one; 13b, pipelines.main
    under a torchrun-style environment at world 1 with NCCL; 13c, one NCCL
    rank a card on min(cards, DP_CARDS) cards when the machine has two or
    more. The one-process yardsticks go to a temporary ref.npz that every
    rank reads."""
    import tempfile

    import torch

    t_phase = time.time()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    print(f"[dp] the parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
          f"before spawning; {cards} card(s)", flush=True)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {f"{flow}/{d}/{n}": refs[flow][d][n] for flow in ("zeroshot", "finetuned")
                  for d in ("t2v", "v2t") for n in refs[flow][d]}
        for world, steps in refs["train"].items():
            for i, step in enumerate(steps):
                arrays.update({f"train{world}/{i}/{k}/{n}": a for k in ("grad", "tree")
                               for n, a in step[k].items()})
        np.savez(os.path.join(tmp, "ref.npz"), **arrays)
        del arrays
        records["13a"] = dp_group(tmp, "13a", DP_WORLD, "gloo", refs, card)
        dp_control(tmp, refs, card)
        dp_cli(tmp, card)
        if cards >= 2:
            records["13c"] = dp_group(tmp, "13c", min(cards, DP_CARDS), "nccl", refs, card)
        else:
            print(f"[dp] 13c (NCCL across cards) not run: this machine has {cards} card, and it "
                  f"needs two or more", flush=True)
    print(f"[time] phase 13 (dp) took {time.time() - t_phase:.1f}s", flush=True)
    return records


def vit_attention_bound_ms(clips, s, h, d, with_lse=False):
    """Bound of one B2 launch: q, k, v read once and o written once (and,
    B2-lse, the fp32 lse rows), against 4 S^2 d flops per head and clip
    (QK^T and PV, no pair skipped)."""
    nbytes = 2 * 4 * clips * s * h * d + (4 * clips * h * s if with_lse else 0)
    return roofline_ms(nbytes, 4.0 * clips * h * s * s * d)


def exp_floor_ms(n_exp):
    """The least time the card's SFUs take for n_exp exponentials: 16 a
    clock an SM on 132 SMs, at the clock the bf16 peak implies (989 TFLOP/s
    over 4096 tensor-core flops a clock an SM: 1.829 GHz). At d = 64 a
    dense pair costs 4 d = 256 tensor-core flops and one exponential, so
    this floor equals the tensor-core bound; at d = 128 it is half of it."""
    clock = PEAK_BF16_FLOPS / (SMS * TENSOR_FLOPS_PER_CLOCK)
    return n_exp / (EXP_PER_CLOCK * SMS * clock) * 1e3


def dense_gap(out, q, k, v, lse=None):
    """B2's (or B2-lse's) output against the plain version, VIT_CLIPS clips
    at a time: (max |kernel - plain|, max of |kernel - plain| - ATTN_RTOL
    |plain|, max |lse - plain lse| or 0)."""
    from blim_tpu_torch.kernels import flash_attention as fa

    err = excess = err_lse = 0.0
    for i in range(0, q.shape[0], VIT_CLIPS):
        part = slice(i, i + VIT_CLIPS)
        ref, ref_lse = fa.reference_attention_lse(q[part], k[part], v[part], None, None, False,
                                                  q.shape[-1] ** -0.5)
        diff = (out[part].float() - ref.float()).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - ATTN_RTOL * ref.float().abs()).max().item())
        if lse is not None:
            err_lse = max(err_lse, (lse[part] - ref_lse).abs().max().item())
        del ref, ref_lse, diff
    return err, excess, err_lse


def dense_timing(ms, lib_ms, clips, s, h, d, with_lse=False):
    """The bound, the exponentials' floor and the text that a B2 or B2-lse
    line prints beside its check: the kernel's time, SDPA's in the same run,
    both floors and the share of the bound reached."""
    bound_ms, bound_by = vit_attention_bound_ms(clips, s, h, d, with_lse)
    floor = exp_floor_ms(clips * h * s * s)
    text = (f"kernel {ms:.4f} ms (raw entry point, CUDA graph), sdpa {lib_ms:.4f} ms (CUDA graph; "
            f"kernel {lib_ms / ms:.2f}x faster), bound {bound_ms:.4f} ms ({bound_by}), exponential "
            f"floor {floor:.4f} ms: kernel at {100 * bound_ms / ms:.1f}% of the bound, "
            f"{4.0 * clips * h * s * s * d / ms / 1e9:.1f} TFLOP/s")
    return bound_ms, bound_by, floor, text


def phase_vit_kernel(card):
    """B2 (flash_fwd_dense.cu) against its plain version at the ViT's
    shapes, with times; then B2 and B2-lse at a ragged S, untimed."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    vcfg = ModelConfig().vision                       # (S, H, d) = (3136, 16, 64)
    s, h = vcfg.num_frames * vcfg.patches_per_frame, vcfg.num_attention_heads
    d = vcfg.hidden_size // h

    def packed(clips, seq=s):
        qkv = torch.randn((clips, seq, 3, h, d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def launched_once(call, counter):
        before = fa.counts()
        out = call()
        torch.cuda.synchronize()
        if fa.counts() != dict(before, **{counter: before[counter] + 1}):
            fail(f"{counter}: the wrapper did not launch it once ({before} -> {fa.counts()})")
        return out

    q, k, v = packed(VIT_CLIPS)
    out = launched_once(lambda: fa.flash_attention_dense(q, k, v), "flash_fwd_dense")
    if not torch.isfinite(out).all():
        fail("flash_fwd_dense: non-finite output")
    err, excess, _ = dense_gap(out, q, k, v)
    ms = graph_time_ms(raw_fwd_dense(q, k, v), iters=10, replays=2)
    wrapper_ms = gpu_time_ms(lambda: fa.flash_attention_dense(q, k, v), iters=10)
    plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, None, None, False, d ** -0.5),
                           iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10,
                           replays=2)
    bound_ms, bound_by, floor, timing = dense_timing(ms, lib_ms, VIT_CLIPS, s, h, d)
    print(f"[vit-kernel] flash_fwd_dense {VIT_CLIPS} clips ({VIT_CLIPS}, {s}, {h}, {d}) strided "
          f"views of a packed qkv: max|d|={err:.3e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|) "
          f"{timing}; wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
    if excess > ATTN_ATOL:
        fail(f"flash_fwd_dense: |kernel - plain| exceeds {ATTN_ATOL} + {ATTN_RTOL}|plain| "
             f"(max |d| {err:.3e})")
    record = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, exp_floor_ms=floor, library_ms=lib_ms, max_abs_err=err)
    del q, k, v, qt, kt, vt, out

    clips = EXTRACT_B * 4
    q, k, v = packed(clips)
    out = launched_once(lambda: fa.flash_attention_dense(q, k, v), "flash_fwd_dense")
    err_f, excess_f, _ = dense_gap(out, q, k, v)
    ms_f = graph_time_ms(raw_fwd_dense(q, k, v), iters=5, replays=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_f = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5,
                          replays=1)
    bound_f, _, floor_f, timing = dense_timing(ms_f, lib_f, clips, s, h, d)
    print(f"[vit-kernel] flash_fwd_dense {clips} clips (the featurizer's batch): max|d|="
          f"{err_f:.3e} (plain {VIT_CLIPS} clips at a time) {timing} [{card}]", flush=True)
    if excess_f > ATTN_ATOL:
        fail(f"flash_fwd_dense at {clips} clips: |kernel - plain| exceeds {ATTN_ATOL} + "
             f"{ATTN_RTOL}|plain| (max |d| {err_f:.3e})")
    record["featurizer_batch"] = dict(clips=clips, ms=ms_f, library_ms=lib_f, bound_ms=bound_f,
                                      exp_floor_ms=floor_f, max_abs_err=err_f)
    del q, k, v, qt, kt, vt, out

    q, k, v = packed(2, RAGGED_S)
    out = launched_once(lambda: fa.flash_attention_dense(q, k, v), "flash_fwd_dense")
    out_lse, lse = launched_once(lambda: fa.flash_attention_lse(q, k, v, causal=False),
                                 "flash_fwd_dense_lse")
    err_r, excess_r, _ = dense_gap(out, q, k, v)
    err_rl, excess_rl, err_lse = dense_gap(out_lse, q, k, v, lse)
    finite = all(torch.isfinite(x).all() for x in (out, out_lse, lse))
    print(f"[vit-kernel] flash_fwd_dense and flash_fwd_dense_lse at a ragged S (2, {RAGGED_S}, "
          f"{h}, {d}) ({-(-RAGGED_S // fa.DENSE_Q_ROWS)} q tiles of {fa.DENSE_Q_ROWS} rows, "
          f"{-(-RAGGED_S // fa.DENSE_KV_TILE)} kv tiles of {fa.DENSE_KV_TILE}, both ragged): "
          f"max|d| out {err_r:.3e}, with lse {err_rl:.3e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|), "
          f"lse {err_lse:.3e} (tol {LSE_TOL}), finite {finite} [{card}]", flush=True)
    if not finite or max(excess_r, excess_rl) > ATTN_ATOL or err_lse > LSE_TOL:
        fail(f"flash_fwd_dense at S = {RAGGED_S}: kernel and plain disagree")
    record["ragged"] = dict(shape=[2, RAGGED_S, h, h, d], max_abs_err=max(err_r, err_rl),
                            lse_max_abs_err=err_lse)
    record["max_abs_err"] = max(err, err_f, err_r, err_rl)
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
    return dict(launches=e2e_counts["flash_fwd_dense"], featurizer_vps=vps, e2e_vps=n_ok / e2e_s,
                vit=vit, cfg=cfg)


def vit_grad_kernels(card):
    """Phase 16a: B2-lse, and the fused d 64 backward with its two passes,
    against their plain versions at VIT_CLIPS clips of the ViT's (S, H, d),
    q, k and v strided views of one packed qkv as the tower hands them, with
    times; returns their records."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    vcfg = ModelConfig().vision                       # (S, H, d) = (3136, 16, 64)
    s, h = vcfg.num_frames * vcfg.patches_per_frame, vcfg.num_attention_heads
    d = vcfg.hidden_size // h
    scale = d ** -0.5
    clips = VIT_CLIPS
    shape = f"{clips} clips ({clips}, {s}, {h}, {d}) strided views of a packed qkv"
    qkv = torch.randn((clips, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn((clips, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    records = {}

    # B2-lse
    before = fa.counts()
    out, lse = fa.flash_attention_lse(q, k, v, causal=False)
    torch.cuda.synchronize()
    if fa.counts() != dict(before, flash_fwd_dense_lse=before["flash_fwd_dense_lse"] + 1):
        fail(f"flash_fwd_dense_lse: the wrapper did not launch B2-lse once ({before} -> "
             f"{fa.counts()})")
    ref, ref_lse = fa.reference_attention_lse(q, k, v, None, None, False, scale)
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail("flash_fwd_dense_lse: non-finite output or lse")
    diff = (out.float() - ref.float()).abs()
    err_o = diff.max().item()
    excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    del diff, out, lse
    ms = graph_time_ms(raw_fwd_dense(q, k, v, with_lse=True), iters=10, replays=2)
    wrapper_ms = gpu_time_ms(lambda: fa.flash_attention_lse(q, k, v, causal=False), iters=10)
    plain_ms = gpu_time_ms(lambda: fa.reference_attention_lse(q, k, v, None, None, False, scale),
                           iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    lib_ms = graph_time_ms(sdpa, iters=10, replays=2)   # with grad on, it also keeps its lse
    bound_ms, bound_by, floor, timing = dense_timing(ms, lib_ms, clips, s, h, d, with_lse=True)
    print(f"[vit-grad] flash_fwd_dense_lse {shape}: max|d| out {err_o:.3e} (tol {ATTN_ATOL} + "
          f"{ATTN_RTOL}|plain|), lse {err_lse:.3e} (tol {LSE_TOL}); {timing} (sdpa: its forward "
          f"with grad); wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
    if excess > ATTN_ATOL or err_lse > LSE_TOL:
        fail("flash_fwd_dense_lse: kernel and plain disagree")
    records["flash_fwd_dense_lse"] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          exp_floor_ms=floor, library_ms=lib_ms,
                                          max_abs_err=max(err_o, err_lse))

    # the fused d 64 backward (preprocess, fused kernel, convert) on the plain
    # forward's O and lse, so both sides read the same inputs; run twice
    passes = ("flash_bwd_dense_prep", "flash_bwd_dense", "flash_bwd_dense_convert")
    before = fa.counts()
    got = fa.flash_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False)
    again = fa.flash_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False)
    torch.cuda.synchronize()
    if fa.counts() != dict(before, **{n: before[n] + 2 for n in passes}):
        fail(f"flash_bwd_dense: the wrapper did not launch each of {passes} once a call "
             f"({before} -> {fa.counts()})")
    want = fa.reference_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False, scale)
    errs = {}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            fail(f"{gname} (d 64): non-finite")
        errs[gname] = ((g.float() - w.float()).abs().max().item(), w.float().abs().max().item())
    spread = (got[0].float() - again[0].float()).abs().max().item()
    dkv_repeat = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    del got, again, want

    # the two passes against their plain versions, on the raw calls' own operands
    dq_raw, _, _, delta, acc, call_prep, call_bwd, call_convert = raw_bwd_dense(
        q, k, v, dout, ref, ref_lse)
    call_prep()
    torch.cuda.synchronize()
    want_delta, _ = fa.reference_bwd_dense_prep(ref, dout)
    err_delta = (delta - want_delta).abs().max().item()
    max_delta = want_delta.abs().max().item()
    acc_zeroed = bool((acc == 0).all())
    call_bwd()
    call_convert()
    torch.cuda.synchronize()
    want_dq = fa.reference_bwd_dense_convert(acc, s, scale)
    err_convert = (dq_raw.float() - want_dq.float()).abs().max().item()
    del want_delta, want_dq

    ms_prep = graph_time_ms(call_prep, iters=10, replays=2)
    ms_bwd = graph_time_ms(call_bwd, iters=10, replays=2)
    ms_convert = graph_time_ms(call_convert, iters=10, replays=2)
    ms_wrapper = gpu_time_ms(
        lambda: fa.flash_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False),
        iters=5)
    plain_bwd = gpu_time_ms(lambda: fa.reference_attention_backward(
        q, k, v, None, None, ref, ref_lse, dout, False, scale), iters=2, warmup=1)
    plain_prep = gpu_time_ms(lambda: fa.reference_bwd_dense_prep(ref, dout), iters=5)
    plain_convert = gpu_time_ms(lambda: fa.reference_bwd_dense_convert(acc, s, scale), iters=5)
    lib_bwd = sdpa_backward_ms(sdpa, (qt, kt, vt), dout.transpose(1, 2), iters=5, replays=2)
    b_f, by_f = roofline_ms(*backward_traffic(clips, s, h, h, d, None, None,
                                              causal=False)["flash_bwd_dense"])
    pass_bounds = {n: roofline_ms(*t) for n, t in dense_pass_traffic(clips, s, h, d).items()}
    (b_prep, by_prep), (b_conv, by_conv) = pass_bounds.values()
    print(f"[vit-grad] flash_bwd_dense {shape}: " + ", ".join(
        f"{gname} max|d| {e:.3e} (max|plain| {mx:.3e})" for gname, (e, mx) in errs.items())
        + f" (tol {GRAD_TOL} max|plain|); two runs: dq spread {spread:.3e} (tol {DQ_RUN_SPREAD} "
        f"max|plain|), dk and dv equal bit for bit: {dkv_repeat}; fused kernel {ms_bwd:.4f} ms "
        f"(bound {b_f:.4f}, {by_f}: {100 * b_f / ms_bwd:.1f}%; raw entry point, CUDA graph), "
        f"prep {ms_prep:.4f} ms (bound {b_prep:.4f}, {by_prep}; plain {plain_prep:.4f}; delta "
        f"max|d| {err_delta:.3e} of max|plain| {max_delta:.3e}, accumulator zeroed {acc_zeroed}), "
        f"convert {ms_convert:.4f} ms (bound {b_conv:.4f}, {by_conv}; plain {plain_convert:.4f}; "
        f"max|d| {err_convert:.3e}), wrapper (prep + fused + convert) {ms_wrapper:.4f} ms, plain "
        f"backward {plain_bwd:.4f} ms, sdpa backward (dq+dk+dv) {lib_bwd:.4f} ms (CUDA graph) "
        f"[{card}]", flush=True)
    for gname, (e, mx) in errs.items():
        if e > GRAD_TOL * mx:
            fail(f"{gname} (d 64): |kernel - plain| {e:.3e} > {GRAD_TOL} x {mx:.3e}")
    if spread > DQ_RUN_SPREAD * errs["dq"][1] or not dkv_repeat:
        fail(f"flash_bwd_dense: two runs differ (dq {spread:.3e}; dk, dv equal: {dkv_repeat})")
    if err_delta > DELTA_TOL * max_delta or not acc_zeroed:
        fail(f"flash_bwd_dense_prep: delta off by {err_delta:.3e} or the accumulator not zeroed")
    if err_convert > 0:
        fail(f"flash_bwd_dense_convert: differs from its plain version by {err_convert:.3e}")
    # the plain backward and the library backward compute dq, dk and dv together
    records["flash_bwd_dense"] = dict(
        ms=ms_bwd, wrapper_ms=ms_wrapper, plain_ms=plain_bwd, bound_ms=b_f, bound_by=by_f,
        library_ms=lib_bwd, max_abs_err=max(e for e, _ in errs.values()), dq_run_spread=spread,
        dk_dv_repeat_bitwise=dkv_repeat, plain_and_library_cover="dq+dk+dv",
        wrapper_covers="prep+fused+convert",
        passes={"flash_bwd_dense_prep": dict(ms=ms_prep, plain_ms=plain_prep, bound_ms=b_prep,
                                             bound_by=by_prep, library_ms=None,
                                             max_abs_err=err_delta),
                "flash_bwd_dense_convert": dict(ms=ms_convert, plain_ms=plain_convert,
                                                bound_ms=b_conv, bound_by=by_conv,
                                                library_ms=None, max_abs_err=err_convert)})
    return records


def vit_grad_ragged_check(card):
    """Phase 16a at the image tiles' S = 784 (5 tiles, 16 heads of 64): the
    64-row tiles are ragged too (12.25 of them), where at S = 3136 only the
    128-row ones are. Held to the plain versions like the main shape, not
    timed."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(8)
    n, s, h, d = 5, 784, 16, 64
    qkv = torch.randn((n, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn((n, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v, causal=False)
    ref, ref_lse = fa.reference_attention_lse(q, k, v, None, None, False, d ** -0.5)
    excess = ((out.float() - ref.float()).abs() - ATTN_RTOL * ref.float().abs()).max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    got = fa.flash_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False)
    want = fa.reference_attention_backward(q, k, v, None, None, ref, ref_lse, dout, False,
                                           d ** -0.5)
    rel = {n_: ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
           for n_, g, w in zip(("dq", "dk", "dv"), got, want)}
    finite = all(torch.isfinite(t).all() for t in (out, lse, *got))
    print(f"[vit-grad] B2-lse, flash_bwd_dense at the image tiles' ({n}, {s}, {h}, {d}): out "
          f"excess over {ATTN_RTOL}|plain| {excess:.3e} (tol {ATTN_ATOL}), lse {err_lse:.3e} "
          f"(tol {LSE_TOL}), max|d|/max|plain| " + ", ".join(f"{k_} {x:.3e}" for k_, x in rel.items())
          + f" (tol {GRAD_TOL}), finite {finite} [{card}]", flush=True)
    if not finite or excess > ATTN_ATOL or err_lse > LSE_TOL or max(rel.values()) > GRAD_TOL:
        fail("vit-grad: the d 64 kernels disagree with their plain versions at S = 784")


def tower_grads(tree, clips, w, pos, vcfg, wrt):
    """Gradients of sum(encode_clips(tree, clips).float() * w) with respect
    to the pixels and the stacked block leaves named in `wrt`, under
    autograd from fresh leaves: {"pixels": g, name: g}."""
    import torch

    from blim_tpu_torch.models import umt_vit

    leaves = _tree_map(lambda t: t.detach().requires_grad_(True), tree)
    px = clips.detach().requires_grad_(True)
    loss = (umt_vit.encode_clips(leaves, px, pos, vcfg).float() * w).sum()
    grads = torch.autograd.grad(loss, [px] + [leaves["blocks"][n]["kernel"] for n in wrt])
    return dict(zip(("pixels",) + tuple(wrt), grads))


def vit_grad_tower_check(vit, cfg, card):
    """Phase 16b: the tower's gradient through the kernels against the same
    gradient through the plain attention (fp32, under autograd), at full
    width, GRAD_VIT_LAYERS blocks and GRAD_VIT_CLIPS clips in bf16, on the
    pixels and the first and last blocks' qkv and fc2 kernels; then the same
    with a planted backward fault, which must exceed the limit."""
    import math

    import torch

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import umt_vit

    vcfg = cfg.vision
    layers = GRAD_VIT_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(6)
    small = dict(vit, blocks=_tree_map(lambda t: t[:layers], vit["blocks"]))
    pos = torch.from_numpy(np.asarray(umt_vit.build_pos_tables(vcfg)[0], np.float32)).cuda()
    clips = torch.randn((GRAD_VIT_CLIPS, cfg.mm_local_num_frames, 3, vcfg.image_size,
                         vcfg.image_size), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.5
    w = torch.randn((GRAD_VIT_CLIPS, vcfg.num_frames * vcfg.patches_per_frame,
                     vcfg.hidden_size), generator=gen, device="cuda")
    wrt = ("qkv", "fc2")

    def picked(g):
        out = {"pixels": g["pixels"]}
        for n in wrt:
            out[f"{n}[0]"], out[f"{n}[{layers - 1}]"] = g[n][0], g[n][layers - 1]
        return out

    def gaps(got, want):
        return {n: (got[n].float() - want[n].float()).abs().max().item()
                / want[n].float().abs().max().item() for n in want}

    fa.reset_counts()
    kern = picked(tower_grads(small, clips, w, pos, vcfg, wrt))
    k_counts = fa.counts()
    kernel_mha = umt_vit.multi_head_attention
    umt_vit.multi_head_attention = lambda q, k, v, *, causal, scale: reference_attention(
        q.float(), k.float(), v.float(), None, None, causal, scale).to(q.dtype)
    try:
        fa.reset_counts()
        plain = picked(tower_grads(small, clips, w, pos, vcfg, wrt))
        p_counts = fa.counts()
    finally:
        umt_vit.multi_head_attention = kernel_mha
    clean = gaps(kern, plain)

    backward = fa.flash_attention_backward
    faults = {
        "lse + log 2": lambda q, k, v, km, qm, out, lse, dout, causal, scale: backward(
            q, k, v, km, qm, out, lse + math.log(2.0), dout, causal, scale),
        "dk and dv swapped": lambda *a: (lambda dq, dk, dv: (dq, dv, dk))(*backward(*a)),
    }
    planted = {}
    for name, fault in faults.items():
        fa.flash_attention_backward = fault
        try:
            planted[name] = max(gaps(picked(tower_grads(small, clips, w, pos, vcfg, wrt)),
                                     plain).values())
        finally:
            fa.flash_attention_backward = backward
    expected = dict({k: 0 for k in k_counts}, flash_fwd_dense_lse=layers, flash_bwd_dense=layers,
                    flash_bwd_dense_prep=layers, flash_bwd_dense_convert=layers)
    print(f"[vit-grad] tower gradient, {layers} blocks at full width, {GRAD_VIT_CLIPS} clips, "
          f"bf16: kernels vs plain attention (fp32) max|d|/max|plain| "
          + ", ".join(f"{n} {g:.3e}" for n, g in clean.items())
          + f" (tol {GRAD_TOL}); planted " + ", ".join(f"{n} {g:.3e}" for n, g in planted.items())
          + f" (each must exceed {GRAD_TOL}); launches {k_counts} (expected {expected}), plain "
          f"{p_counts} [{card}]", flush=True)
    if not all(torch.isfinite(g).all() for g in kern.values()):
        fail("vit-grad: non-finite gradient through the kernels")
    if k_counts != expected or any(p_counts.values()):
        fail(f"vit-grad: launches {k_counts} / {p_counts}, expected {expected} / none")
    if max(clean.values()) > GRAD_TOL:
        fail(f"vit-grad: the tower's gradient through the kernels is off the plain one ({clean})")
    if min(planted.values()) <= GRAD_TOL:
        fail(f"vit-grad: a planted backward fault stays inside the limit ({planted})")
    return dict(clean=clean, planted=planted)


def vit_grad_tower_timed(vit, cfg, card):
    """Phase 16c: the whole tower (every block the truncation keeps) forward
    and backward at VIT_CLIPS clips, with respect to the pixels and every
    leaf: one untimed run, then VIT_GRAD_TIMED timed ones, each launching
    B2-lse, the fused backward and its two passes once a block and no other
    kernel."""
    import torch

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import umt_vit

    vcfg = cfg.vision
    depth = vit["blocks"]["qkv"]["kernel"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    pos = torch.from_numpy(np.asarray(umt_vit.build_pos_tables(vcfg)[0], np.float32)).cuda()
    clips = torch.randn((VIT_CLIPS, cfg.mm_local_num_frames, 3, vcfg.image_size,
                         vcfg.image_size), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.5
    w = torch.randn((VIT_CLIPS, vcfg.num_frames * vcfg.patches_per_frame, vcfg.hidden_size),
                    generator=gen, device="cuda")
    leaves = _tree_map(lambda t: t.detach().requires_grad_(True), vit)
    params = list(_leaves(leaves))

    def step():
        px = clips.detach().requires_grad_(True)
        loss = (umt_vit.encode_clips(leaves, px, pos, vcfg).float() * w).sum()
        return torch.autograd.grad(loss, [px] + params)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 2**30
    times, runs = [], []
    for _ in range(VIT_GRAD_TIMED):
        fa.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        runs.append(fa.counts())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = dict({k: 0 for k in runs[0]}, flash_fwd_dense_lse=depth, flash_bwd_dense=depth,
                    flash_bwd_dense_prep=depth, flash_bwd_dense_convert=depth)
    finite = all(torch.isfinite(g).all() for g in grads)
    ms = 1e3 * float(np.mean(times))
    print(f"[vit-grad] whole tower ({depth} blocks) forward + backward at {VIT_CLIPS} clips "
          f"(pixels and {len(params)} leaves): {ms:.1f} ms (mean of {VIT_GRAD_TIMED} after one "
          f"untimed; {', '.join(f'{1e3 * t:.1f}' for t in times)}), peak {peak_gb:.2f} GiB "
          f"({resident_gb:.2f} GiB of it resident before), every gradient finite: {finite}; "
          f"launches a run {runs[0]} (expected {expected}) [{card}]", flush=True)
    if not finite:
        fail("vit-grad: a non-finite gradient through the whole tower")
    if any(c != expected for c in runs):
        fail(f"vit-grad: launches {runs} != expected {expected} a run")
    return dict(launches=runs[-1], ms=ms, peak_gib=peak_gb)


def phase_vit_grad(vit, cfg, card):
    """Phase 16: the UMT tower's gradient on the card."""
    import torch

    t0 = time.time()
    records = vit_grad_kernels(card)
    vit_grad_ragged_check(card)
    torch.cuda.empty_cache()
    check = vit_grad_tower_check(vit, cfg, card)
    torch.cuda.empty_cache()
    tower = vit_grad_tower_timed(vit, cfg, card)
    print(f"[time] phase 16 (vit-grad) took {time.time() - t0:.1f}s", flush=True)
    return dict(records=records, check=check, tower=tower)


def hf_config_json(cfg):
    """A VideoChat-Flash config.json for cfg: the keys from_hf_config_dict
    reads, as the published checkpoint names them."""
    llm = cfg.llm
    return {
        "architectures": ["VideoChatFlashQwenForCausalLM"], "model_type": "videochat_flash_qwen",
        "torch_dtype": "bfloat16", "vocab_size": llm.vocab_size, "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size, "num_hidden_layers": llm.num_hidden_layers,
        "num_attention_heads": llm.num_attention_heads,
        "num_key_value_heads": llm.num_key_value_heads, "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps, "max_position_embeddings": llm.max_position_embeddings,
        "tie_word_embeddings": llm.tie_word_embeddings, "use_sliding_window": False,
        "sliding_window": llm.sliding_window, "max_window_layers": llm.max_window_layers,
        "mm_vision_tower": "umt-hd-large", "mm_vision_select_layer": cfg.vision.return_idx,
        "mm_hidden_size": cfg.mm_hidden_size, "mm_local_num_frames": cfg.mm_local_num_frames,
        "mm_projector_type": cfg.mm_projector_type, "vision_encode_type": cfg.vision_encode_type,
        "mm_patch_merge_type": cfg.mm_patch_merge_type,
        "mm_newline_position": cfg.mm_newline_position, "mm_llm_compress": False,
        "llm_compress_type": cfg.llm_compress_type, "llm_compress_layer_list": [],
        "llm_image_token_ratio_list": [1.0], "tokenizer_padding_side": "left",
    }


def cli_config():
    import dataclasses

    from blim_tpu_torch.core.config import ModelConfig

    cfg = ModelConfig()
    if CLI_LAYERS == cfg.llm.num_hidden_layers:
        return cfg
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=CLI_LAYERS, max_window_layers=CLI_LAYERS))


def seeded_checkpoint_tree(cfg):
    """The seeded 7B and ViT-L tower on the card in bf16 (visual_head fp32):
    what phase 11 writes and what the loaded tree must equal."""
    import torch

    from blim_tpu_torch.checkpoints.convert import init_params, init_vision_tower

    tree = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    tree["vision_tower"] = init_vision_tower(cfg.vision, seed=SEED, dtype=torch.bfloat16,
                                             device="cuda")
    return tree


def peak_rss_gib():
    """This process's lifetime peak resident set in GiB (ru_maxrss)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def write_cli_data(root, cfg):
    """Synthetic MSRVTT root from SEED: CLI_TEST_ITEMS test items (one
    caption a video) and CLI_TRAIN_ITEMS train items over the first videos,
    a features.pack of every video, and the zero-shot and fine-tuned score
    matrices, kept off exact 0.0 and with the true pair ahead (so R@1 > 0
    and a best checkpoint is kept)."""
    from blim_tpu_torch.data.datasets import ANNOTATION_FILES
    from blim_tpu_torch.data.features import FeatureStore

    r = np.random.default_rng((SEED, 11))
    n = CLI_TEST_ITEMS
    ds = os.path.join(root, "MSRVTT")
    os.makedirs(os.path.join(ds, "features"))
    vids = [f"video{i:04d}" for i in range(n)]
    feats = r.standard_normal((n, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)) * 0.5
    FeatureStore.write_pack(os.path.join(ds, "features"), vids, feats.astype(np.float16))
    splits = {"test": zip(vids, make_captions(n, r, CAPTION_TOKENS)),
              "train": zip(vids[:CLI_TRAIN_ITEMS], make_captions(CLI_TRAIN_ITEMS, r,
                                                                 CAPTION_TOKENS))}
    for split, items in splits.items():
        with open(os.path.join(ds, ANNOTATION_FILES["MSRVTT"][split]), "w") as f:
            json.dump([{"video": f"{v}.mp4", "caption": c} for v, c in items], f)
    os.makedirs(os.path.join(root, "scores"))
    for stem in ("msrvtt_zeroshot", "msrvtt"):
        t2v, v2t = (r.standard_normal((n, n)).astype(np.float32) + 0.01 + 2 * np.eye(n, dtype=np.float32)
                    for _ in range(2))
        np.savez(os.path.join(root, "scores", f"{stem}.npz"), t2v=t2v, v2t=v2t)


def check_native_reader(feature_dir, card):
    """The CLI's features.pack through FeatureStore: its reader must be the
    native one, and its gather of every video in a seeded order must equal
    a numpy memmap gather of the same file bit for bit."""
    from blim_tpu_torch.data.features import FeatureStore

    store = FeatureStore(feature_dir)
    with open(os.path.join(feature_dir, "features.idx.json")) as f:
        meta = json.load(f)
    vids = list(meta["index"])
    order = np.random.default_rng((SEED, 14)).permutation(len(vids))
    t = time.perf_counter()
    native = store.load_many([vids[i] for i in order])
    native_s = time.perf_counter() - t
    mm = np.memmap(os.path.join(feature_dir, "features.pack"), dtype=np.dtype(meta["dtype"]),
                   mode="r", shape=(len(vids), *meta["shape"]))
    t = time.perf_counter()
    plain = np.asarray(mm[np.asarray([meta["index"][vids[i]] for i in order])], np.float32)
    memmap_s = time.perf_counter() - t
    same = native.dtype == plain.dtype and native.shape == plain.shape and np.array_equal(
        native.view(np.uint32), plain.view(np.uint32))
    print(f"[cli] features.pack ({len(vids)} videos {tuple(meta['shape'])} {meta['dtype']}) "
          f"through FeatureStore: reader {store.reader!r}; gather of all {len(vids)} in a seeded "
          f"order {native_s * 1e3:.1f} ms, numpy memmap {memmap_s * 1e3:.1f} ms, "
          f"{'equal' if same else 'NOT equal'} bit for bit [{card}]", flush=True)
    if store.reader != "native":
        fail(f"cli: FeatureStore reads features.pack through {store.reader!r}, not the native "
             f"reader (g++ missing?)")
    if not same:
        fail("cli: the native gather differs from the memmap gather")


def check_profile_trace(path, wall, card):
    """Phase 14's --profile_dir check, on phase 11's fine-tuned eval: the
    Chrome trace exists and holds events; prints how many are the card's
    kernels (B1's among them) and the trace's size."""
    if not os.path.exists(path):
        fail(f"--profile_dir wrote no {path}")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = sum("flash" in e.get("name", "") for e in kernels)
    print(f"[dormant] --profile_dir: the fine-tuned CLI eval (wall {wall:.2f}s with the profiler "
          f"on) wrote {os.path.basename(path)}, {size / 2**20:.1f} MiB, {len(events)} events, "
          f"{len(kernels)} of them the card's kernels ({flash} named flash*)"
          + ("" if kernels else ": the profiler recorded no device activity here") + f" [{card}]",
          flush=True)
    if not events:
        fail("--profile_dir: the trace holds no events")


def run_cli(argv, card):
    """pipelines.main.main in-process on the card -> (results, the prefix
    forwards of the engine it built, {wall, peak_gib, evals: [s], epochs:
    [s], train_stats, readers: the `reader` of each FeatureStore gather},
    launch counts of the whole run). The run's rank-0 print replaces
    builtins.print; it is put back after."""
    import argparse
    import builtins
    import gc

    import torch

    from blim_tpu_torch.data.features import FeatureStore
    from blim_tpu_torch.engine import loop as loop_lib
    from blim_tpu_torch.engine import rerank
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.pipelines import main as cli

    engines, times = [], {"evals": [], "epochs": [], "train_stats": [], "readers": []}
    real = (rerank.RerankEngine, loop_lib.val_one_epoch, loop_lib.train_one_epoch, builtins.print,
            FeatureStore.load_many)

    class Engine(real[0]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t)
            if key == "epochs":
                times["train_stats"].append(out[1])
            return out
        return run

    def load_many(store, vids):
        times["readers"].append(store.reader)
        return real[4](store, vids)

    args = argparse.ArgumentParser(parents=[cli.get_args_parser()]).parse_args(argv)
    rerank.RerankEngine = Engine
    loop_lib.val_one_epoch = timed(real[1], "evals")
    loop_lib.train_one_epoch = timed(real[2], "epochs")
    FeatureStore.load_many = load_many
    fa.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        results = cli.main(args)
        torch.cuda.synchronize()
    finally:
        rerank.RerankEngine, loop_lib.val_one_epoch, loop_lib.train_one_epoch, \
            builtins.print, FeatureStore.load_many = real
    times["wall"] = time.perf_counter() - t
    times["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counts = fa.counts()
    prefix_forwards = engines[0].prefix_forwards
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return results, prefix_forwards, times, counts


def phase_cli(card):
    """Phase 11: the train/eval CLI on a checkpoint directory."""
    import argparse
    import tempfile

    import torch

    from blim_tpu_torch.checkpoints import safetensors_io, state_io
    from blim_tpu_torch.checkpoints.convert import (export_hf_state_dict, init_vision_tower,
                                                    load_videochat_flash)
    from blim_tpu_torch.core.config import load_model_config
    from blim_tpu_torch.engine import loop as loop_lib
    from blim_tpu_torch.engine import train as train_lib
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import umt_vit
    from blim_tpu_torch.pipelines import extract

    t_phase = time.time()
    cfg = cli_config()
    layers = cfg.llm.num_hidden_layers
    with tempfile.TemporaryDirectory() as tmp:
        import shutil

        print(f"[cli] temporary directory {tmp}: {shutil.disk_usage(tmp).free / 1e9:.1f} GB "
              f"free; checkpoint depth CLI_LAYERS = {CLI_LAYERS}", flush=True)
        ckpt = os.path.join(tmp, "VideoChat-Flash-Qwen2-7B_res448")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(hf_config_json(cfg), f, indent=2)
        t = time.perf_counter()
        tree = seeded_checkpoint_tree(cfg)
        weight_map = safetensors_io.save_sharded(export_hf_state_dict(tree), ckpt,
                                                 CLI_SHARD_BYTES)
        write_s = time.perf_counter() - t
        n_params = sum(x.numel() for _, x in _named_leaves(tree) if x is not None)
        del tree
        torch.cuda.empty_cache()
        files = sorted(set(weight_map.values()))
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        print(f"[cli] wrote the seeded tree ({n_params / 1e9:.3f}B params, {len(weight_map)} "
              f"tensors) as {len(files)} shards + index, {nbytes / 1e9:.2f} GB, in {write_s:.1f}s",
              flush=True)

        # load it back through the CLI's loader and hold it to the seeded tree
        rss_before = peak_rss_gib()
        torch.cuda.synchronize()
        t = time.perf_counter()
        config = load_model_config(ckpt)
        loaded = load_videochat_flash(ckpt, config, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        rss = peak_rss_gib()
        if config != cfg:
            fail(f"cli: the checkpoint's config.json reads as {config}, not {cfg}")
        want = seeded_checkpoint_tree(cfg)
        got_flat, want_flat = dict(_named_leaves(loaded)), dict(_named_leaves(want))
        if got_flat.keys() != want_flat.keys():
            fail(f"cli: loaded tree keys differ: {sorted(got_flat.keys() ^ want_flat.keys())[:4]}")
        differ = [k for k, w in want_flat.items() if (w is None) != (got_flat[k] is None) or (
            w is not None and (w.dtype != got_flat[k].dtype or w.shape != got_flat[k].shape
                               or not torch.equal(w.reshape(-1).view(torch.uint8),
                                                  got_flat[k].reshape(-1).view(torch.uint8))))]
        del loaded, want, got_flat, want_flat
        torch.cuda.empty_cache()
        print(f"[cli] load_model_config + load_videochat_flash: {nbytes / 1e9:.2f} GB in "
              f"{load_s:.2f}s = {nbytes / 1e9 / load_s:.2f} GB/s, the process's peak host RSS "
              f"{rss:.2f} GiB after it ({rss_before:.2f} GiB before); "
              f"config == ModelConfig(){'' if CLI_LAYERS == 28 else ' at CLI_LAYERS'}, "
              f"{len(differ)} leaves differ from the seeded tree bit for bit [{card}]", flush=True)
        if differ:
            fail(f"cli: loaded leaves differ from the seeded tree: {differ[:4]}")

        root = os.path.join(tmp, "data")
        write_cli_data(root, cfg)
        check_native_reader(os.path.join(root, "MSRVTT", "features"), card)
        out = os.path.join(tmp, "out")
        common = ["--dataset", "MSRVTT", "--data_root", root, "--scores_dir",
                  os.path.join(root, "scores"), "--model_path", ckpt, "--topk", str(TOPK), "--cpn"]

        def blim_row(res):
            return ", ".join(f"{k} {v}" for k, v in res["blim"].items())

        # zero-shot eval
        res, prefix_forwards, times, counts = run_cli(common + ["--eval", "--preset", "--output_dir",
                                                       os.path.join(out, "zeroshot")], card)
        expected = dict({k: 0 for k in counts}, flash_fwd=layers * prefix_forwards)
        print(f"[cli] zero-shot eval (--eval --preset --cpn --topk {TOPK}) on {CLI_TEST_ITEMS} "
              f"items: wall {times['wall']:.2f}s, of it val_one_epoch {times['evals'][0]:.2f}s; peak "
              f"{times['peak_gib']:.2f} GiB; "
              f"launches {counts} (expected {expected} = {layers} x {prefix_forwards} "
              f"prefix forwards); blim: {blim_row(res)} [{card}]", flush=True)
        if counts != expected or not prefix_forwards:
            fail(f"cli zero-shot eval: launches {counts} != expected {expected}")
        print(f"[cli] the zero-shot run's feature gathers read through {times['readers']}",
              flush=True)
        if not times["readers"] or set(times["readers"]) != {"native"}:
            fail(f"cli zero-shot eval: feature gathers read through {times['readers']}, not the "
                 f"native reader")
        with open(os.path.join(out, "zeroshot", "log.txt")) as f:
            if loop_lib.results_table(res) not in f.read():
                fail("cli zero-shot eval: log.txt lacks the results table")

        # one training epoch, its eval, epoch0/ and checkpoint_best/
        train_dir = os.path.join(out, "train")
        res_train, prefix_forwards, times, counts = run_cli(
            common + ["--epochs", "1", "--batch_size", "4", "--output_dir", train_dir], card)
        steps = -(-CLI_TRAIN_ITEMS // 4)
        expected = dict({k: 0 for k in counts}, flash_fwd=layers * prefix_forwards,
                        flash_fwd_lse=steps * 4 * layers, flash_dq=steps * 2 * layers,
                        flash_dkv=steps * 2 * layers)
        stats = times["train_stats"][0]
        print(f"[cli] one training epoch (--epochs 1 --batch_size 4 --cpn --topk {TOPK}): wall "
              f"{times['wall']:.2f}s (peak {times['peak_gib']:.2f} GiB), of it the epoch "
              f"{times['epochs'][0]:.2f}s ({steps} steps, "
              f"{1e3 * times['epochs'][0] / steps:.0f} ms/step) and its eval "
              f"{times['evals'][0]:.2f}s; loss {stats['loss']:.4f} (vtg {stats['vtg_loss']:.4f}, "
              f"tvg {stats['tvg_loss']:.4f}); launches {counts} (expected {expected}: per step "
              f"{4 * layers} flash_fwd_lse, {2 * layers} flash_dq, {2 * layers} flash_dkv); "
              f"blim: {blim_row(res_train)} [{card}]", flush=True)
        if counts != expected:
            fail(f"cli training epoch: launches {counts} != expected {expected}")
        if not all(np.isfinite(v) for v in stats.values()):
            fail(f"cli training epoch: non-finite stats {stats}")
        tcfg = train_lib.TrainConfig()
        n_trainable = state_io.count_params(train_lib.init_trainable(
            torch.Generator().manual_seed(0), cfg, tcfg,
            visual_head=torch.zeros(cfg.llm.hidden_size, cfg.mm_hidden_size)))
        for name in ("epoch0", "checkpoint_best"):
            meta_path = os.path.join(train_dir, name, "meta.json")
            if not os.path.exists(meta_path):
                fail(f"cli training epoch: {name}/ was not written")
            with open(meta_path) as f:
                meta = json.load(f)
            if (meta["epoch"], meta["n_trainable"]) != (0, n_trainable):
                fail(f"cli training epoch: {name}/meta.json has epoch {meta['epoch']}, "
                     f"n_trainable {meta['n_trainable']} (expected 0, {n_trainable})")
        print(f"[cli] epoch0/ and checkpoint_best/ written, meta.json epoch 0, n_trainable "
              f"{n_trainable:,}", flush=True)

        # the fine-tuned eval of the saved best state
        profile_dir = os.path.join(out, "profile")
        res_resumed, prefix_forwards, times, counts = run_cli(
            common + ["--eval", "--resume", os.path.join(train_dir, "checkpoint_best"),
                      "--output_dir", os.path.join(out, "resumed"), "--profile_dir",
                      profile_dir], card)
        expected = dict({k: 0 for k in counts}, flash_fwd=layers * prefix_forwards)
        same = loop_lib.results_table(res_resumed) == loop_lib.results_table(res_train)
        print(f"[cli] fine-tuned eval (--eval --resume checkpoint_best): wall {times['wall']:.2f}s, "
              f"of it val_one_epoch {times['evals'][0]:.2f}s; peak {times['peak_gib']:.2f} GiB; "
              f"launches {counts} (expected "
              f"{expected}); results table {'equal to' if same else 'DIFFERENT from'} the "
              f"epoch's [{card}]", flush=True)
        print(loop_lib.results_table(res_resumed), flush=True)
        if counts != expected:
            fail(f"cli fine-tuned eval: launches {counts} != expected {expected}")
        if not same:
            print(loop_lib.results_table(res_train), flush=True)
            fail("cli: the resumed eval's table differs from the training epoch's")
        check_profile_trace(os.path.join(profile_dir, "trace.json"), times["wall"], card)

        # extract.main on the checkpoint's tower, held to the featurizer on the
        # seeded tower; first, two featurizer runs on one input must agree bit
        # for bit (ToMe's scatter-add is deterministic: projector._merge_sum)
        vid_dir = os.path.join(tmp, "videos_root", "MSRVTT", "videos")
        os.makedirs(vid_dir)
        names = [f"synthetic_{i:03d}" for i in range(CLI_VIDEOS)]
        for name in names:
            open(os.path.join(vid_dir, name + ".mp4"), "wb").close()
        vit = init_vision_tower(cfg.vision, seed=SEED, dtype=torch.bfloat16, device="cuda")
        proc = umt_vit.UMTImageProcessor(size=(cfg.vision.image_size,) * 2)
        featurize = extract.make_featurizer(vit, cfg, device="cuda", device_preprocess=True)
        frames = np.stack([extract.resize_for_upload(synthetic_frames(n), proc, proc.size)
                           for n in names])
        frames = frames.reshape(CLI_VIDEOS, cfg.num_clips, cfg.mm_local_num_frames,
                                *frames.shape[2:])

        def featurize_all():
            return torch.cat([featurize(torch.from_numpy(frames[s: s + 4])).to(torch.float16).cpu()
                              for s in range(0, CLI_VIDEOS, 4)]).float()

        def compare(got, want):
            """(|d|/|want| Frobenius, max|d|, share of clips alike)."""
            d = got - want
            alike = d.abs().amax(dim=(2, 3)) <= TOME_CLIP_TOL * want.abs().amax(dim=(2, 3))
            return ((d.norm() / want.norm()).item(), d.abs().max().item(),
                    alike.float().mean().item())

        twice = compare(featurize_all(), featurize_all())
        read_frames = extract.read_frames
        # the chip machine may lack a video decoder: frames come from the
        # phase 10 maker, named by the file
        extract.read_frames = lambda path, n, max_duration=None: synthetic_frames(
            os.path.splitext(path)[0])
        ex_args = extract.get_args_parser().parse_args([
            "--dataset", "MSRVTT", "--data_root", os.path.join(tmp, "videos_root"),
            "--model_path", ckpt, "--num_frames", "16", "--batch_size", "4"])
        fa.reset_counts()
        t = time.perf_counter()
        try:
            extract.main(ex_args)
            torch.cuda.synchronize()
        finally:
            extract.read_frames = read_frames
        ex_s = time.perf_counter() - t
        ex_counts = fa.counts()
        want = featurize_all()
        feat_dir = os.path.join(tmp, "videos_root", "MSRVTT", "features")
        saved = np.stack([np.load(os.path.join(feat_dir, n + ".npy")) for n in names])
        rel, max_d, alike = compare(torch.from_numpy(saved).float(), want)
        calls = -(-CLI_VIDEOS // 4)
        ex_expected = dict({k: 0 for k in ex_counts},
                           flash_fwd_dense=cfg.vision.depth * calls)
        print(f"[cli] featurizer on the seeded tower, two runs on the same {CLI_VIDEOS} videos: "
              f"max|d| {twice[1]:.3e}, {twice[2]:.4f} of clips alike [{card}]", flush=True)
        if twice[1] != 0.0:
            fail("cli: two featurizer runs on the same videos differ (ToMe not deterministic)")
        print(f"[cli] extract.main --model_path (the checkpoint's tower, bf16) over {CLI_VIDEOS} "
              f"videos, batch 4: {ex_s:.2f}s; saved features "
              f"{tuple(saved.shape)} {saved.dtype} vs the featurizer on the seeded tower: max|d| "
              f"{max_d:.3e}, |d|/|want| (Frobenius) {rel:.3e} (tol {TOWER_TOL}), {alike:.4f} of "
              f"clips alike; launches {ex_counts} (expected {ex_expected}) [{card}]", flush=True)
        if ex_counts != ex_expected:
            fail(f"cli extract.main: launches {ex_counts} != expected {ex_expected}")
        if saved.shape != (CLI_VIDEOS, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size) \
                or not np.isfinite(saved.astype(np.float32)).all() or rel > TOWER_TOL:
            fail("cli extract.main: saved features disagree with the featurizer")
        del vit, featurize
        torch.cuda.empty_cache()
    print(f"[time] phase 11 (cli) took {time.time() - t_phase:.1f}s", flush=True)
    return dict(load_s=load_s, load_gbps=nbytes / 1e9 / load_s)


def importable(names):
    """{name: True/False}: which of the named modules import here."""
    import importlib

    found = {}
    for name in names:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def chat_frames():
    """CHAT_FRAMES + 2 seeded uint8 frames of CHAT_HW: a random base image
    rolling sideways a pixel a frame."""
    rng = np.random.default_rng((SEED, 12))
    base = rng.integers(0, 256, (*CHAT_HW, 3), dtype=np.uint8)
    return [np.roll(base, t, axis=1) for t in range(CHAT_FRAMES + 2)]


def write_chat_video(path):
    """chat_frames() at CHAT_FPS as an MJPG AVI written with OpenCV; False
    when OpenCV cannot open a writer."""
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), CHAT_FPS,
                             (CHAT_HW[1], CHAT_HW[0]))
    if not writer.isOpened():
        return False
    for frame in chat_frames():
        writer.write(frame)
    writer.release()
    return os.path.getsize(path) > 0


def synthetic_load_video(video_path, max_num_frames=512, local_num_frames=4, max_duration=None):
    """load_video's stand-in without a decoder: chat_frames() sampled by
    sample_frame_indices at CHAT_FPS, and the time message load_video writes."""
    from blim_tpu_torch.data.video import sample_frame_indices

    frames = chat_frames()
    idx = sample_frame_indices(len(frames), CHAT_FPS, max_num_frames, local_num_frames)
    return (np.stack([frames[i] for i in idx]),
            f"The video lasts for {len(frames) / CHAT_FPS:.2f} seconds, "
            f"and {len(idx)} frames are uniformly sampled from it.")


class CallTimes:
    """Context that wraps attributes of modules or objects so each call is
    timed on the host clock, the card synchronized before and after, into
    self.s[name]; restores them on exit. `wrap` times a callable passed
    around instead."""

    def __init__(self, targets):
        self.targets = targets          # [(module or object, attribute name)]
        self.s = {name: [] for _, name in targets}

    def wrap(self, fn, name):
        import torch

        self.s.setdefault(name, [])

        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.s[name].append(time.perf_counter() - t)
            return out
        return run

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name in self.targets]
        for obj, name, fn in self.saved:
            setattr(obj, name, self.wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


class CountOps:
    """Context counting the aten ops dispatched inside it (views included),
    into self.n; device-independent."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def llm_decode_bytes(llm):
    """Bytes of the weights one decode step reads: every layer, the final
    norm and the LM head (the one embedding row is left out)."""
    leaves = list(_leaves(llm["layers"])) + [llm["norm"]["scale"], llm["lm_head"]["kernel"]]
    return sum(t.numel() * t.element_size() for t in leaves if t is not None)


def phase_chat(card):
    """Phase 12: chat and generate at 7B, and the image path, on the card."""
    import tempfile

    import torch

    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.data import images, video
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention
    from blim_tpu_torch.models import generation, qwen2, umt_vit
    from blim_tpu_torch.models import videochat_flash as vcf
    from blim_tpu_torch.pipelines import extract

    t_phase = time.time()
    cfg = ModelConfig()
    layers, depth = cfg.llm.num_hidden_layers, cfg.vision.depth
    found = importable(("decord", "cv2", "PIL"))
    print("[chat] video decoders that import here: "
          + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in found.items()), flush=True)
    t = time.perf_counter()
    tree = seeded_checkpoint_tree(cfg)
    torch.cuda.synchronize()
    print(f"[chat] Qwen2-7B + UMT ViT-L res448 seeded in bf16 on the card in "
          f"{time.perf_counter() - t:.2f}s", flush=True)
    tok = ByteFallbackTokenizer()
    proc = umt_vit.UMTImageProcessor(size=(cfg.vision.image_size,) * 2)
    featurize = extract.make_featurizer(tree["vision_tower"], cfg, device="cuda")

    # first use of the tower and of the decoder on the card, outside the clock
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    featurize(torch.randn((1, 1, cfg.mm_local_num_frames, 3, cfg.vision.image_size,
                           cfg.vision.image_size), generator=gen, device="cuda"))
    warm = qwen2.embed_tokens(tree["llm"], torch.randint(0, 256, (1, 300), device="cuda"))
    generation.generate_tokens(tree["llm"], cfg.llm, warm,
                               torch.ones((1, 300), dtype=torch.int32, device="cuda"), 4,
                               [tok.eos_token_id])
    torch.cuda.synchronize()

    # 1. chat end to end at the frame cap; generate's inputs are recorded
    recorded = {}
    real_generate, real_load = vcf.generate, video.load_video

    def recording_generate(params, config, input_ids, video_embeds, *a, **k):
        recorded.update(input_ids=list(input_ids), video_embeds=video_embeds)
        return real_generate(params, config, input_ids, video_embeds, *a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_chat.avi")
        written = found["cv2"] and write_chat_video(path)
        if not written:
            why = ("OpenCV does not import" if not found["cv2"]
                   else "OpenCV could not open an MJPG writer")
            print(f"[chat] load_video replaced by the seeded frames and sample_frame_indices' "
                  f"time message (no video file): {why}", flush=True)
            video.load_video = synthetic_load_video
        timer = CallTimes([(video, "load_video"), (proc, "preprocess"),
                           (generation, "generate_tokens"), (qwen2, "forward_collect_kv")])
        timed_featurize = timer.wrap(featurize, "featurize")
        vcf.generate = recording_generate
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t = time.perf_counter()
        try:
            with timer:
                text, history = vcf.chat(tree, cfg, path, tok, CHAT_PROMPT, timed_featurize, proc,
                                         max_num_frames=CHAT_FRAMES,
                                         max_new_tokens=CHAT_NEW_TOKENS)
                torch.cuda.synchronize()
        finally:
            vcf.generate, video.load_video = real_generate, real_load
        chat_s = time.perf_counter() - t
    chat_counts = fa.counts()
    chat_peak = torch.cuda.max_memory_allocated() / 2**30
    ts = {k: v[0] for k, v in timer.s.items()}
    ids, vid = recorded["input_ids"], recorded["video_embeds"]
    prompt_len = len(ids) - 1 + vid.shape[0]
    chat_expected = dict({k: 0 for k in chat_counts}, flash_fwd=layers, flash_fwd_dense=depth)
    print(f"[chat] chat at the {CHAT_FRAMES}-frame cap ({vid.shape[0]} video tokens, prompt "
          f"{prompt_len} tokens, at most {CHAT_NEW_TOKENS} new tokens, greedy): wall {chat_s:.3f}s "
          f"= load_video {ts['load_video']:.3f}s ({'cv2' if written else 'seeded frames'}) + "
          f"preprocess {ts['preprocess']:.3f}s + featurize {ts['featurize']:.3f}s + prefill "
          f"{ts['forward_collect_kv']:.3f}s + decode "
          f"{ts['generate_tokens'] - ts['forward_collect_kv']:.3f}s + the rest; peak "
          f"{chat_peak:.2f} GiB; launches {chat_counts} (expected {chat_expected}: {layers} a "
          f"prefill, {depth} a tower call); reply {len(text)} chars [{card}]", flush=True)
    if chat_counts != chat_expected:
        fail(f"chat: launches {chat_counts} != expected {chat_expected}")
    if len(history) != 2 or history[0]["content"] != CHAT_PROMPT or history[1]["content"] != text:
        fail(f"chat: the history {history!r} does not hold the turn")
    want_tokens = CHAT_FRAMES // cfg.mm_local_num_frames * cfg.tokens_per_clip
    if tuple(vid.shape) != (want_tokens, cfg.llm.hidden_size) or not torch.isfinite(vid).all():
        fail(f"chat: video embeddings {tuple(vid.shape)} or non-finite")

    # 2. generate on the chat's prompt and video embedding: time to first
    # token, decode ms/token against the weight-read bound, the cache check
    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vcf.generate(tree, cfg, ids, vid, tok, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft.append(time.perf_counter() - t)
    timer = CallTimes([(generation, "generate_tokens"), (qwen2, "forward_collect_kv")])
    fa.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with timer:
        tokens, step_logits = vcf.generate(tree, cfg, ids, vid, tok, max_new_tokens=CHAT_NEW_TOKENS,
                                           return_logits=True)
    gen_counts = fa.counts()
    gen_peak = torch.cuda.max_memory_allocated() / 2**30
    steps = step_logits.shape[0]
    decode_ms = 1e3 * (timer.s["generate_tokens"][0] - timer.s["forward_collect_kv"][0]) / max(
        steps - 1, 1)
    weight_bytes = llm_decode_bytes(tree["llm"])
    bound_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    reply = generation.KeywordsStoppingCriteria(["<|im_end|>"], tok).trim(
        tok.decode(list(tokens), skip_special_tokens=True))
    print(f"[chat] generate on the chat's prompt ({prompt_len} tokens): time to first token "
          + ", ".join(f"{x:.3f}" for x in ttft) + f" s (prefill + LM head + argmax, 3 runs); "
          f"{steps} steps: prefill {timer.s['forward_collect_kv'][0]:.3f}s, decode "
          f"{decode_ms:.2f} ms/token against the weight-read bound {bound_ms:.2f} ms/token "
          f"({weight_bytes / 1e9:.2f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s: "
          f"{bound_ms / decode_ms:.1%} of it); peak {gen_peak:.2f} GiB; launches {gen_counts}; "
          f"reply {'equal to' if reply == text else 'DIFFERENT from'} the chat's [{card}]",
          flush=True)
    if gen_counts != dict({k: 0 for k in gen_counts}, flash_fwd=layers):
        fail(f"generate: launches {gen_counts}, expected {layers} flash_fwd (one prefill)")
    real_step = generation._decode_step
    step_ops = []

    def counted_step(*a):
        with CountOps() as ops:
            out = real_step(*a)
        step_ops.append(ops.n)
        return out

    generation._decode_step = counted_step
    try:
        vcf.generate(tree, cfg, ids, vid, tok, max_new_tokens=2)
    finally:
        generation._decode_step = real_step
    print(f"[chat] one decode step dispatches {step_ops[0]} aten ops (views included): "
          f"{1e3 * decode_ms / step_ops[0]:.1f} us each at {decode_ms:.2f} ms/token [{card}]",
          flush=True)

    def teacher_forced(toks):
        """Full-sequence logits over prompt + toks[:-1] at the steps' positions."""
        llm = tree["llm"]
        ids_np = np.asarray(ids)
        ip = int(np.nonzero(ids_np == -200)[0][0])

        def emb(a):
            return qwen2.embed_tokens(llm, torch.as_tensor(np.asarray(a, np.int64), device="cuda"))

        seq = torch.cat([emb(ids_np[:ip]), vid.to(llm["embed_tokens"]["embedding"].dtype),
                         emb(ids_np[ip + 1:]), emb(toks[: steps - 1])])[None]
        with torch.no_grad():
            hidden = qwen2.forward_hidden(llm, cfg.llm, seq, torch.ones(
                seq.shape[:2], dtype=torch.int32, device="cuda"))
            return qwen2.lm_logits(llm, hidden[:, prompt_len - 1:], cfg.llm)[0]

    fa.reset_counts()
    full = teacher_forced(tokens)
    tf_counts = fa.counts()
    scale = full.abs().max().item()
    err = (step_logits - full).abs().max().item()
    agree = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()

    # planted faults, each re-run through generate and re-checked the same
    # way: 'prefill', the prompt's K/V missing from the cache (slots masked);
    # 'position', every decode step's RoPE position one late
    def prefill_missing(params, config, layers_, emb, cache, cur_len, base_mask, position, *a):
        base_mask = base_mask.clone()
        base_mask[:, :prompt_len] = 0
        return real_step(params, config, layers_, emb, cache, cur_len, base_mask, position, *a)

    def late_position(params, config, layers_, emb, cache, cur_len, base_mask, position, *a):
        return real_step(params, config, layers_, emb, cache, cur_len, base_mask, position + 1, *a)

    faults = {}
    for name, planted in (("prefill", prefill_missing), ("position", late_position)):
        generation._decode_step = planted
        try:
            bad_tokens, bad_logits = vcf.generate(tree, cfg, ids, vid, tok,
                                                  max_new_tokens=CHAT_NEW_TOKENS,
                                                  return_logits=True)
        finally:
            generation._decode_step = real_step
        bad_full = teacher_forced(bad_tokens)
        faults[name] = (bad_logits - bad_full).abs().max().item() / bad_full.abs().max().item()
    print(f"[chat] cache check: the {steps} cached steps' logits vs one teacher-forced full "
          f"forward (B1 launches {tf_counts['flash_fwd']}): max|d| {err:.4e} = {err / scale:.3e} "
          f"of max|logits| {scale:.3f} (tol {DECODE_TOL}), argmax agrees on {agree:.4f} of steps; "
          f"planted faults read: prefill K/V missing {faults['prefill']:.3e}, RoPE position one "
          f"late {faults['position']:.3e} [{card}]", flush=True)
    if not torch.isfinite(step_logits).all() or err > DECODE_TOL * scale:
        fail(f"generate: the cached decode disagrees with the full forward ({err / scale:.3e} > "
             f"{DECODE_TOL})")
    if faults["prefill"] <= DECODE_TOL:
        fail(f"a cache without the prompt's K/V moved the logits by {faults['prefill']:.3e}, not "
             f"above {DECODE_TOL}: the cache check cannot see it")
    if tf_counts != dict({k: 0 for k in tf_counts}, flash_fwd=layers):
        fail(f"teacher-forced forward: launches {tf_counts}")
    del full, bad_full, step_logits, bad_logits, bad_tokens

    # 3. the image path: a seeded image on a 2 x 2 anyres grid plus the base view
    rng = np.random.default_rng((SEED, 13))
    image = rng.integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3), dtype=np.uint8)
    tiles = images.process_anyres_image_nopad(image, proc, IMAGE_GRID)
    fa.reset_counts()
    t = time.perf_counter()
    feats = vcf.encode_image_tiles(tree, cfg, tiles)
    merged = vcf.merge_image_patches(feats, (IMAGE_SIDE, IMAGE_SIDE), cfg, IMAGE_GRID)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t
    image_counts = fa.counts()
    grid = images.get_anyres_image_grid_shape((IMAGE_SIDE, IMAGE_SIDE), IMAGE_GRID,
                                              cfg.vision.image_size)
    tower = tree["vision_tower"]
    pix = torch.from_numpy(tiles).to(device="cuda", dtype=torch.bfloat16)[:, None]
    pos_img = umt_vit.build_pos_tables(cfg.vision)[1]
    with torch.inference_mode():
        kern = umt_vit.encode_clips(tower, pix, pos_img, cfg.vision).float()
        kernel_mha = umt_vit.multi_head_attention
        umt_vit.multi_head_attention = lambda q, k, v, *, causal, scale: reference_attention(
            q, k, v, None, None, causal, scale)
        try:
            plain = umt_vit.encode_clips(tower, pix, pos_img, cfg.vision).float()
        finally:
            umt_vit.multi_head_attention = kernel_mha
    rel = ((kern - plain).norm() / plain.norm()).item()
    n_tiles = 1 + grid[0] * grid[1]
    print(f"[chat] image path: {IMAGE_SIDE}x{IMAGE_SIDE} image -> grid {grid[0]}x{grid[1]} + base "
          f"= {tiles.shape[0]} tiles of {cfg.vision.image_size}^2 ({cfg.vision.patches_per_frame} "
          f"tokens each) -> encode_image_tiles {tuple(feats.shape)} -> merged {tuple(merged.shape)} "
          f"in {image_s:.3f}s; launches {image_counts} (expected {depth} flash_fwd_dense); tower "
          f"through B2 vs plain |d|/|plain| (Frobenius) {rel:.3e} (tol {TOWER_TOL}) [{card}]",
          flush=True)
    if tiles.shape[0] != n_tiles or tuple(merged.shape) != (n_tiles * 64, cfg.llm.hidden_size) \
            or not torch.isfinite(merged).all():
        fail(f"image path: {tiles.shape[0]} tiles, merged {tuple(merged.shape)}")
    if image_counts != dict({k: 0 for k in image_counts}, flash_fwd_dense=depth):
        fail(f"image path: launches {image_counts}")
    if rel > TOWER_TOL:
        fail(f"image path: the tower through B2 disagrees with the plain tower ({rel:.3e})")
    del tree, featurize, vid, recorded, kern, plain, feats, merged, pix
    torch.cuda.empty_cache()

    # 4. B1 at the chat's prefill shape, B2 at the image tiles' shape
    b1 = chat_kernel_b1(prompt_len, card)
    b2 = chat_kernel_b2(n_tiles, card)
    print(f"[time] phase 12 (chat) took {time.time() - t_phase:.1f}s", flush=True)
    b1.update(launches_chat=chat_counts["flash_fwd"], launches_generate=gen_counts["flash_fwd"],
              ttft_s=min(ttft), decode_ms_per_token=decode_ms, decode_bound_ms=bound_ms,
              chat_s=chat_s, chat_peak_gib=chat_peak)
    b2.update(launches_chat=chat_counts["flash_fwd_dense"],
              launches_image=image_counts["flash_fwd_dense"])
    return b1, b2


def chat_kernel_b1(s, card):
    """B1 against its plain version at the chat's prefill shape (B = 1, S,
    causal, all-ones mask), timed like phase 2; then, untimed, at
    RAGGED_PREFILL_S (ragged at a q and a kv tile) under a mask whose runs
    of zeros (RAGGED_PREFILL_HOLES) leave a few interior tiles partly masked
    and their rows zero."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    hq, hkv, d = 28, 4, 128

    def held(seq, mask, what):
        q = torch.randn((1, seq, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((1, seq, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((1, seq, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        before = fa.counts()
        out = fa.flash_attention(q, k, v, key_mask=mask, query_mask=mask)
        torch.cuda.synchronize()
        if fa.counts() != dict(before, flash_fwd=before["flash_fwd"] + 1):
            fail(f"chat B1 {what}: the wrapper did not launch the kernel once")
        if not torch.isfinite(out).all():
            fail(f"chat B1 {what}: non-finite output")
        if (out[mask == 0] != 0).any():
            fail(f"chat B1 {what}: a masked row is not zero")
        ref = reference_attention(q, k, v, mask, mask, True, d ** -0.5)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
        del ref, diff, out
        if excess > ATTN_ATOL:
            fail(f"chat B1 {what}: |kernel - plain| exceeds {ATTN_ATOL} + {ATTN_RTOL}|plain| "
                 f"({err:.3e})")
        return q, k, v, err

    mask = torch.ones((1, s), dtype=torch.int32, device="cuda")
    q, k, v, err = held(s, mask, "at the prefill")
    ms = graph_time_ms(raw_fwd(q, k, v, mask), iters=10, replays=2)
    plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, mask, mask, True, d ** -0.5),
                           iters=2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=10, replays=2)
    bound_ms, bound_by = attention_bound_ms(1, s, hq, hkv, d, mask, mask)
    floor = exp_floor_ms(hq * pairs_visible(mask, mask))
    print(f"[chat] flash_fwd at the chat's prefill (1, {s}, {hq}, {d}), causal, all-ones mask "
          f"({-(-s // 128)} q tiles, the last of {s - 128 * (s // 128)} rows): max|d|={err:.3e} "
          f"(tol {ATTN_ATOL} + {ATTN_RTOL}|plain|) {fwd_timing(ms, lib_ms, bound_ms, bound_by)}, "
          f"exponential floor {floor:.4f} ms; plain {plain_ms:.4f} ms [{card}]", flush=True)
    del q, k, v, qt, kt, vt

    ragged = torch.ones((1, RAGGED_PREFILL_S), dtype=torch.int32, device="cuda")
    for lo, hi in RAGGED_PREFILL_HOLES:
        ragged[:, lo:hi] = 0
    *_, err_ragged = held(RAGGED_PREFILL_S, ragged, f"at S={RAGGED_PREFILL_S}")
    tiles = sorted({lo // 128 for lo, _ in RAGGED_PREFILL_HOLES})
    print(f"[chat] flash_fwd at (1, {RAGGED_PREFILL_S}, {hq}, {d}), causal, keys "
          f"{', '.join(f'{lo}-{hi - 1}' for lo, hi in RAGGED_PREFILL_HOLES)} masked (kv tiles "
          f"{tiles} partly), the last q and kv tile of {RAGGED_PREFILL_S % 128} rows: "
          f"max|d|={err_ragged:.3e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|), masked rows zero "
          f"[{card}]", flush=True)
    return dict(shape=[1, s, hq, hkv, d], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, exp_floor_ms=floor,
                max_abs_err=max(err, err_ragged))


def chat_kernel_b2(n_tiles, card):
    """B2 against its plain version at the image path's shape (tiles, 784,
    16, 64), strided views of a packed qkv, timed like phase 9."""
    import torch
    import torch.nn.functional as F

    from blim_tpu_torch.core.config import ModelConfig
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.kernels.attention import reference_attention

    vcfg = ModelConfig().vision
    s, h = vcfg.patches_per_frame, vcfg.num_attention_heads
    d = vcfg.hidden_size // h
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((n_tiles, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.counts()
    out = fa.flash_attention_dense(q, k, v)
    torch.cuda.synchronize()
    if fa.counts() != dict(before, flash_fwd_dense=before["flash_fwd_dense"] + 1):
        fail("chat B2: the wrapper did not launch B2 once")
    ref = reference_attention(q, k, v, None, None, False, d ** -0.5)
    if not torch.isfinite(out).all():
        fail("chat B2: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
    ms = graph_time_ms(raw_fwd_dense(q, k, v))
    plain_ms = gpu_time_ms(lambda: reference_attention(q, k, v, None, None, False, d ** -0.5))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bound_ms, bound_by, floor, timing = dense_timing(ms, lib_ms, n_tiles, s, h, d)
    q_rows = fa.DENSE_Q_ROWS
    print(f"[chat] flash_fwd_dense at the image tiles ({n_tiles}, {s}, {h}, {d}) "
          f"({-(-s // q_rows)} q tiles of {q_rows} rows, the last of {s - q_rows * (s // q_rows)}; "
          f"{-(-s // fa.DENSE_KV_TILE)} kv tiles of {fa.DENSE_KV_TILE}): max|d|={err:.3e} (tol "
          f"{ATTN_ATOL} + {ATTN_RTOL}|plain|) {timing}; plain {plain_ms:.4f} ms [{card}]",
          flush=True)
    if excess > ATTN_ATOL:
        fail(f"chat B2: |kernel - plain| exceeds {ATTN_ATOL} + {ATTN_RTOL}|plain| ({err:.3e})")
    return dict(shape=[n_tiles, s, h, h, d], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, exp_floor_ms=floor, max_abs_err=err)


def main():
    t_script = time.time()
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
    fine = phase_finetuned(st, card)
    naive = phase_naive(st, fine, card)
    rect = phase_rectangle(st, fine, card)
    t0 = time.time()
    train_records = phase_train_kernels(card)
    train = phase_train(st, card)
    phase_gradcheck(st, card)
    print(f"[time] phases 6-8 (train kernels, train, gradcheck) took {time.time() - t0:.1f}s",
          flush=True)
    dormant = phase_dormant(st, card)
    parity = phase_parity(st, fine, card)
    dp_refs = dp_yardsticks(st, fine)
    b1_launches = st["launches"]
    del st, fine                # the 7B weights: phases 9-10 measure their own peak memory
    torch.cuda.empty_cache()
    t0 = time.time()
    vit_record = phase_vit_kernel(card)
    extract_st = phase_extract(card)
    print(f"[time] phases 9-10 (vit kernel, extract) took {time.time() - t0:.1f}s", flush=True)
    vit_grad = phase_vit_grad(extract_st.pop("vit"), extract_st.pop("cfg"), card)
    torch.cuda.empty_cache()
    phase_cli(card)
    chat_b1, chat_b2 = phase_chat(card)
    dp = phase_dp(card, dp_refs)

    src = "blim_tpu_torch/kernels/csrc/"
    ref = "blim_tpu/kernels/flash_attention.py:"
    dp_b1, dp_train = dp["13a"]
    kernels = [{"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
                "replaces": ref + "42", "launches": b1_launches, **record, "chat": chat_b1,
                "naive_launches": naive["launches"], "dp_finetuned_launches_per_rank": dp_b1,
                "rectangle_launches": rect["launches"],
                "rectangle_tvg_prefix_forwards": rect["tvg_forwards"],
                "rectangle_tvg": rect["b1"], "pdrop_launches": dormant["pdrop_launches"],
                "parity_launches": {"forward_logits": parity["forward_logits"],
                                    "merged_lora": parity["merged_lora"],
                                    "parity_script": parity["script"]["flash_fwd"]}}]
    for name, source, line in (("flash_fwd_lse", "flash_fwd.cu", "121"),
                               ("flash_dq", "flash_bwd.cu", "195"),
                               ("flash_dkv", "flash_bwd.cu", "252")):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + line, "launches": train["counts"][name],
                        **train_records[name],
                        "dp_step_launches_per_rank": [c[name] for c in dp_train],
                        "parity_script_launches": parity["script"][name],
                        "parity_train_shapes_max_abs_err": parity["train_errs"][name]})
        kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], parity["train_errs"][name])
    kernels.append({"name": "flash_fwd_dense", "route": "cuda",
                    "source": src + "flash_fwd_dense.cu", "replaces": ref + "42",
                    "launches": extract_st["launches"], **vit_record, "chat": chat_b2})
    tower_launches = vit_grad["tower"]["launches"]
    for name, source, line in (("flash_fwd_dense_lse", "flash_fwd_dense.cu", "121"),
                               ("flash_bwd_dense", "flash_bwd_dense.cu", "195,252")):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + line, "launches": tower_launches[name],
                        **vit_grad["records"][name]})
    for name, rec in kernels[-1]["passes"].items():
        rec["launches"] = tower_launches[name]
    kernels[-2]["tower_fwd_bwd_ms"] = vit_grad["tower"]["ms"]
    print(f"[time] the whole script took {time.time() - t_script:.1f}s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def dp_yardsticks(st, fine):
    """Phase 13's one-process yardsticks, from this process: the N = ITEMS
    matrices of phases 3 and 5 and DP_TRAIN_STEPS train steps accumulated
    over DP_WORLD parts (and over the cards' parts with two or more cards)."""
    import torch

    t0 = time.time()
    cards = torch.cuda.device_count()
    parts = sorted({DP_WORLD} | ({min(cards, DP_CARDS)} if cards >= 2 else set()))
    refs = {"zeroshot": st["zeroshot"],
            "finetuned": {k: fine[k] for k in ("t2v", "v2t", "packs", "qps")},
            "train": {p: dp_train_reference(st, p) for p in parts}}
    print(f"[time] phase 13's one-process train yardsticks ({parts} parts) took "
          f"{time.time() - t0:.1f}s", flush=True)
    return refs


if __name__ == "__main__":
    main()
