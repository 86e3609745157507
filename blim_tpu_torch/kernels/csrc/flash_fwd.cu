// Flash-attention forward for Hopper (sm_90a) at head dim 128 (the 7B
// decoder): causal or full, masked or dense, GQA, bf16 in / fp32
// accumulate, with or without the fp32 logsumexp rows that the backward
// (flash_bwd.cu) reads. The UMT ViT's d = 64 dense forward (B2, B2-lse) is
// flash_fwd_dense.cu, a design of its own.
//
// Replaces: blim_tpu/kernels/flash_attention.py `_fwd_kernel` (:42-125),
// launched by `_flash_forward` -> pl.pallas_call (:178), in two uses:
//   * B1: without lse in the causal masked mode of every decoder prefix
//     forward (qwen2.forward_collect_kv -> attention.multi_head_attention):
//     the rerank flows' packs and the chat's prefill (generate_tokens);
//   * B1-lse: with lse (`lse_ref`, :121-125, via `_vjp_fwd` :434) for every
//     attention call of the LoRA train step.
//
// Semantics, the same as the TPU kernel and the plain version
// (kernels/attention.py::reference_attention):
//   * query head h reads KV head h / (Hq / Hkv): K/V are never repeated;
//   * a masked key, a key beyond the sequence and (causal) a key after the
//     query get the finite logit -1e30. A row whose visible keys are all
//     masked so far softmaxes to finite garbage instead of NaN; the query
//     mask then zeroes such rows (flash-attn varlen output semantics);
//   * online softmax in fp32 (running max m, running sum l, l clamped at
//     1e-30 before the division); P is cast to bf16 before the P.V product,
//     as the TPU kernel casts p to v's dtype;
//   * rows with query_mask == 0 write zeros; rows beyond S are not written;
//   * with an lse pointer, each row < S also writes m + log(max(l, 1e-30))
//     in fp32, in the scaled-logit domain, as the TPU kernel's lse_ref. A
//     row whose keys are all masked gets about -1e30 + log(n) there (the
//     masked logit is the power of two nearest -1e30, n the keys its tiles
//     visited); the backward multiplies its dO by the query mask, so that
//     value reaches no gradient.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16, 132
// SMs; a visible pair costs 4 d = 512 tensor-core flops and one exp2).
//   * S <= 448 (the rerank packs (4, 341), the train step's (4, 448), the
//     TVG rectangle's (1, 249) and (6, 128), the prior prefix (1, 85)): one
//     launch moves 2-7 MB against ~1 us of tensor-core time, so the bound is
//     bytes (~2 us), and what the kernel pays is latency: a CTA visits one
//     to four kv tiles, so its Q and first K load, one chain of products and
//     softmax per tile and its epilogue are the whole of its time. There the
//     turns below still overlap one consumer's chain with the other's, and
//     the producer reads a tile's key-mask words before it waits for the
//     tile's buffer.
//   * The chat's prefill (1, 8381, 28 / 4): 503.5 GFLOP of visible pairs,
//     0.5091 ms at the bf16 peak, against 60 MB (0.02 ms): bound by
//     operations. 66 q tiles x 28 heads = 1848 CTAs (14 waves of one CTA an
//     SM) visit 61,908 kv tiles, 469 an SM. A tile's two products (64 x 128
//     x 128 per consumer, both consumers) take 2048 clocks of the SM's
//     tensor cores (1.12 us at 1.829 GHz); its 16,384 exponentials 1024
//     clocks of its SFUs (16 a clock), the exponential floor 0.2546 ms. So
//     the kernel runs near its bound only if the tensor cores never wait for
//     a softmax, and no tile does mask work it does not need.
// scripts/ablate_fwd_torch.py times the kernel with one part of its design
// or its work taken out.
//
// Design (FlashAttention-3's forward at d 128, on hopper.cuh's machinery):
//   * A CTA owns kBQ = 128 q rows of one (batch, q-head): two consumer
//     warpgroups of 64 rows and a producer warpgroup, one warp of which
//     issues every TMA load (the Q tile once; K and V tiles of kBK = 128
//     rows through two rings of kStages buffers, each buffer with its own
//     full and empty mbarrier, since a consumer releases K_j before
//     V_(j-1)). 4-D tensor maps over (d, S, H, B), built on the host from
//     the operands' strides, read strided views in place; rows beyond S come
//     back as zeros. In the masked mode the same warp turns each K tile's
//     key mask into 128 bits in shared memory beside it, reading the mask
//     before it waits for the buffer. setmaxnreg moves registers from the
//     producer (kProducerRegs) to the consumers (kConsumerRegs).
//   * Tiles are 128B-swizzled, 64 columns (128 B) a box: d = 128 takes two
//     boxes per tile, stored as two 64-column halves.
//   * Turns at the tensor cores (ping-pong): a consumer issues its products
//     only after the named barrier of its turn (kBarTurn + wg) has been
//     arrived at by the other, and arrives at the other's right after
//     issuing. So one consumer's products run while the other runs its
//     softmax, and the two never drift into running their softmaxes at the
//     same time. Consumer 0 skips its first wait and consumer 1 its last
//     arrival, so the arrivals match the waits.
//   * Inside a consumer, the next tile's QK^T over this tile's softmax: in
//     iteration j it issues S_j = Q K_j^T, rescales O by the previous
//     tile's factor while S_j runs, issues O += P_(j-1) V_(j-1), waits for
//     S_j alone (wgmma_wait<1>) and runs S_j's online softmax while
//     P_(j-1) V_(j-1) is in flight. The first tile's S and the last tile's
//     P V are peeled off the loop, so every product is issued and waited in
//     one iteration and none crosses the loop's back edge (ptxas would then
//     serialize every wgmma of the kernel). Each row still takes O alpha_j,
//     then + P_j V_j, tile by tile in order: the same fp32 operations in the
//     same order as a consumer that waits for each product.
//   * A tile is masked only when it needs it (mask_tile): the last tile a
//     q tile visits (the causal diagonal, or the ragged end of S) by
//     position and key bits, any other only when one of its 128 key bits is
//     0 (a uniform branch on the AND of the four words). The chat's
//     all-ones mask and the packs' interior tiles take the unmasked path.
//   * S = Q K^T is wgmma m64n128k16 with Q and K in shared memory (both
//     K-major); each thread holds two rows of fp32 scores, whose max is a
//     tree and two shuffles over a quad of lanes; the exponentials are exp2
//     with scale * log2(e) folded into one FMA. P goes to bf16 in registers,
//     in the A-operand layout of O += P V, wgmma m64n128k16 with V from
//     shared memory (MN-major, its two halves one operand). O stays in fp32
//     registers: a consumer thread holds S (64 fp32), P (32 bf16 pairs) and
//     O (64) across the loop.
//   * The q tile of a head whose 64-row half lies wholly beyond S (at S =
//     8381, the last tile's second consumer) keeps its turns and mbarrier
//     arrivals in a loop of its own and runs no product.
//   * Grid order: dense, the q tiles of one (batch, head) are neighbours so
//     they share its K/V in L2; causal, the heaviest q tiles (most kv tiles)
//     launch first. Each output row's sum runs over the kv tiles in one
//     fixed order: two runs agree bit for bit.
//   * The epilogue divides by l, zeroes masked query rows and writes bf16
//     pairs straight from registers; with lse, one lane of each quad writes
//     its two rows' lse.

#include "hopper.cuh"

namespace {

constexpr int kD = 128;            // head dim: two 64-column (128 B) swizzled halves
constexpr int kHalves = kD / 64;
constexpr int kBQ = 128;           // q rows per CTA
constexpr int kBK = 128;           // kv rows per tile
constexpr int kConsumers = 2;      // consumer warpgroups, 64 q rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 2;         // buffers of each of the K and V rings
// setmaxnreg's split: at entry every thread has the registers that one CTA
// of kThreads a SM leaves it (65,536 / 384, rounded down to 8: 168); the
// producer warpgroup gives up to kProducerRegs a thread and each consumer
// thread takes kConsumerRegs for S (kBK / 2 fp32), P (kBK / 4 bf16 pairs)
// and O (kD / 2 fp32) across the loop.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarTurn = 1;        // + consumer: named barrier of that consumer's turn
static_assert((kProducerRegs + kConsumers * kConsumerRegs) * 128 <=
                  (65536 / kThreads) / 8 * 8 * kThreads, "register split");
static_assert(kConsumerRegs - (kBK / 2 + kBK / 4 + kD / 2) >= 64, "S, P and O leave room");
static_assert(kBQ == kBK, "the causal tile count assumes square tiles");
static_assert(kBQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");
static_assert(kBK == 128, "the key bits of a tile are four 32-bit words");

// Each operand array is a multiple of 1024 bytes and the struct starts on a
// 1024-byte boundary, as the 128B swizzle requires.
struct Smem {
  bf16 q[kHalves][kBQ * 64];
  bf16 k[kStages][kHalves][kBK * 64];
  bf16 v[kStages][kHalves][kBK * 64];
  uint32_t kbits[kStages][kBK / 32];                 // key mask bits of each K buffer
  uint64_t full_q;
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
  uint64_t empty_k[kStages];
  uint64_t empty_v[kStages];
};

constexpr int smem_bytes() { return (int)sizeof(Smem) + 1024; }  // + alignment slack
static_assert(smem_bytes() <= 232448, "the H100's shared memory a block");

struct Params {
  bf16* o;
  const int* key_mask;    // (B, S), row stride mask_sb; null when dense
  const int* query_mask;
  float* lse;             // (B, Hq, S) with strides lse_sb, lse_sh, unit along S
  long long o_sb, o_ss, o_sh;
  long long mask_sb;
  long long lse_sb, lse_sh;
  int batch;
  int num_heads;          // Hq
  int seq_len;
  int group;              // Hq / Hkv
  float scale;
  int causal;
};

// S = Q K^T for one kv tile: 8 k-steps of m64n128k16 over both halves of d,
// one wgmma group.
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss_n128(s, desc_kmajor(q_rows + (kk / 4) * kBQ * 128, kk),
                  desc_kmajor(k_tile + (kk / 4) * kBK * 128, kk), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile: kBK / 16 k-steps of m64n128k16, P from registers,
// V's two 64-column halves one MN-major operand.
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pa)[kBK / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    wgmma_rs_n128(o, a, desc_mnmajor2(v_tile, kk, kBK * 128));
  }
  wgmma_commit();
}

// The last tile's mask: key bits, keys at or beyond S, and (on the causal
// diagonal) keys after this thread's two rows.
__device__ __forceinline__ void mask_edge(float (&s)[kBK / 2], uint4 bits, int k0, int S, bool diag,
                                          int qpos0, int qpos1, int quad, float neg) {
  const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * quad + e;
      const int kpos = k0 + c;
      const bool vis = kpos < S && ((words[j / 4] >> (c % 32)) & 1u);
      if (!(vis && (!diag || kpos <= qpos0))) s[4 * j + e] = neg;
      if (!(vis && (!diag || kpos <= qpos1))) s[4 * j + 2 + e] = neg;
    }
  }
}

// A loop tile's mask: the masked logit for this thread's columns whose key
// bit is 0 (the shifts by the column inside the word are constants).
__device__ __forceinline__ void mask_keys(float (&s)[kBK / 2], uint4 bits, int quad, float neg) {
  const uint32_t words[4] = {bits.x >> (2 * quad), bits.y >> (2 * quad), bits.z >> (2 * quad),
                             bits.w >> (2 * quad)};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!((words[j / 4] >> (8 * (j % 4) + e)) & 1u)) {
        s[4 * j + e] = neg;
        s[4 * j + 2 + e] = neg;
      }
    }
  }
}

// The rule: kv tile kt of the n_iter a q tile visits is masked by position
// and key bits if it is the last (the causal diagonal, or the ragged end of
// S), by key bits if one of them is 0, and not at all otherwise.
template <bool kMasked>
__device__ __forceinline__ void mask_tile(float (&s)[kBK / 2], uint4 bits, int kt, int n_iter,
                                          int S, bool causal, int qpos0, int qpos1, int quad,
                                          float neg) {
  const bool edge = kt == n_iter - 1 && (causal || (kt + 1) * kBK > S);
  const bool hole = (bits.x & bits.y & bits.z & bits.w) != ~0u;
  if (edge) {
    mask_edge(s, bits, kt * kBK, S, causal, qpos0, qpos1, quad, neg);
  } else if (kMasked && hole) {
    mask_keys(s, bits, quad, neg);
  }
}

// Folds the tile's row maxima (this thread's two rows, over its quad) into
// mx0, mx1; a tree over the row's columns, so the chain is short.
__device__ __forceinline__ void row_max(const float (&s)[kBK / 2], float& mx0, float& mx1) {
  float a[kBK / 8], c[kBK / 8];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    a[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    c[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int w = 1; w < kBK / 8; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < kBK / 8; j += 2 * w) {
      a[j] = fmaxf(a[j], a[j + w]);
      c[j] = fmaxf(c[j], c[j + w]);
    }
  }
  mx0 = fmaxf(mx0, a[0]);
  mx1 = fmaxf(mx1, c[0]);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// s <- exp2(fma(s, scale_log2, -mb)) in place; this thread's row sums.
__device__ __forceinline__ void exp_rows(float (&s)[kBK / 2], float scale_log2, float mb0,
                                         float mb1, float& sum0, float& sum1) {
  sum0 = sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], scale_log2, -mb0));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -mb0));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -mb1));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -mb1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P in bf16 pairs: the A fragments of k-step kk are pa[4kk .. 4kk + 3].
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2], uint32_t (&pa)[kBK / 4]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[kD / 2], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// ---- the kernel ----------------------------------------------------------

template <bool kMasked, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kTileBytes = kBK * kD * 2;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int S = p.seq_len;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int heads_batch = p.num_heads * p.batch;
  int q_tile, bh;
  if (p.causal) {                      // heaviest q tiles first
    q_tile = n_q - 1 - (int)(blockIdx.x / heads_batch);
    bh = blockIdx.x % heads_batch;
  } else {                             // a (batch, head)'s q tiles side by side
    q_tile = blockIdx.x % n_q;
    bh = blockIdx.x / n_q;
  }
  const int h = bh % p.num_heads;
  const int b = bh / p.num_heads;
  const int q0 = q_tile * kBQ;
  const int n_kv = (S + kBK - 1) / kBK;
  const int n_iter = p.causal ? min(q_tile + 1, n_kv) : n_kv;
  const int tid = threadIdx.x;
  // broadcast from lane 0, so the compiler knows it is the same across the
  // warp and the branches on it are not divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full_k[st], 1);
      mbar_init(&sm.full_v[st], 1);
      mbar_init(&sm.empty_k[st], kConsumers * 4);
      mbar_init(&sm.empty_v[st], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp, in the order the consumers take the tiles
    // (K_0, then K_j and V_(j-1), then the last V); its lanes read the key
    // mask, lane 0 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid / 32 == kConsumers * 4) {
      const int lane = tid % 32;
      const int kvh = h / p.group;
      if (lane == 0) {
        mbar_expect_tx(&sm.full_q, kBQ * kD * 2);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) tma_load(sm.q[hf], &tm_q, &sm.full_q, 64 * hf, q0, h, b);
      }
      for (int j = 0; j <= n_iter; ++j) {
        if (j < n_iter) {                      // K_j
          const int st = j % kStages;
          const int k0 = j * kBK;
          uint32_t words[kBK / 32];
          if (kMasked) {
#pragma unroll
            for (int w = 0; w < kBK / 32; ++w) {
              const int kpos = k0 + 32 * w + lane;
              words[w] = __ballot_sync(0xffffffffu,
                                       kpos < S && p.key_mask[b * p.mask_sb + kpos] != 0);
            }
          }
          if (j >= kStages) mbar_wait(&sm.empty_k[st], (j / kStages - 1) & 1);
          if (lane == 0) {
            if (kMasked) {
#pragma unroll
              for (int w = 0; w < kBK / 32; ++w) sm.kbits[st][w] = words[w];
            }
            mbar_expect_tx(&sm.full_k[st], kTileBytes);   // also releases the mask bits
#pragma unroll
            for (int hf = 0; hf < kHalves; ++hf)
              tma_load(sm.k[st][hf], &tm_k, &sm.full_k[st], 64 * hf, k0, kvh, b);
          }
        }
        if (j > 0) {                           // V_(j-1)
          const int jv = j - 1;
          const int st = jv % kStages;
          if (jv >= kStages) mbar_wait(&sm.empty_v[st], (jv / kStages - 1) & 1);
          if (lane == 0) {
            mbar_expect_tx(&sm.full_v[st], kTileBytes);
#pragma unroll
            for (int hf = 0; hf < kHalves; ++hf)
              tma_load(sm.v[st][hf], &tm_v, &sm.full_v[st], 64 * hf, jv * kBK, kvh, b);
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each; S, P and O in registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int t = tid % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int qpos0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // this thread's two rows
  const int qpos1 = qpos0 + 8;
  const int mine = kBarTurn + wg;
  const int next = kBarTurn + (wg + 1) % kConsumers;

  // A consumer whose 64 rows all lie beyond S takes its turns and makes its
  // mbarrier arrivals, which pace it with the other, and runs no product: a
  // loop of its own, so that the other's loop keeps no branch on it.
  if (q0 + 64 * wg >= S) {
    for (int j = 0; j <= n_iter; ++j) {
      if (j < n_iter) mbar_wait(&sm.full_k[j % kStages], (j / kStages) & 1);
      if (wg > 0 || j > 0) named_bar_sync(mine, 256);
      if (j > 0) mbar_wait(&sm.full_v[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      if (wg < kConsumers - 1 || j < n_iter) named_bar_arrive(next, 256);
      if (lane == 0 && j < n_iter) mbar_arrive(&sm.empty_k[j % kStages]);
      if (lane == 0 && j > 0 && j < n_iter) mbar_arrive(&sm.empty_v[(j - 1) % kStages]);
    }
    return;
  }

  const float scale_log2 = p.scale * kLog2e;
  // The masked logit, about -1e30 in the scaled-logit domain. A power of two, so
  // that neg * scale_log2 is exact and the FMA below gives a row whose keys are
  // all masked exponents of exactly 0 (p = 1), not its rounding error.
  const float neg = ldexpf(-1.f, (int)rintf(log2f(-kNegInf / p.scale)));
  const uint32_t q_rows = smem_u32(sm.q[0]) + wg * 64 * 128;
  const uint4 all_visible = make_uint4(~0u, ~0u, ~0u, ~0u);

  float s[kBK / 2];       // S of the tile, then its P in fp32
  uint32_t pa[kBK / 4];   // P of the previous tile in bf16 pairs
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m0, m1;           // running max, unscaled scores
  float l0, l1;           // this thread's share of the running sums
  float alpha0, alpha1;   // O's rescale factor from the last softmax

  // tile 0: S alone (consumer 0 takes the first turn), its softmax
  {
    mbar_wait(&sm.full_q, 0);
    mbar_wait(&sm.full_k[0], 0);
    const uint4 bits = kMasked ? *reinterpret_cast<const uint4*>(sm.kbits[0]) : all_visible;
    if (wg > 0) named_bar_sync(mine, 256);
    wgmma_fence();
    issue_qk(s, q_rows, smem_u32(sm.k[0][0]));
    named_bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[0]);
    mask_tile<kMasked>(s, bits, 0, n_iter, S, p.causal, qpos0, qpos1, quad, neg);
    m0 = m1 = neg;
    row_max(s, m0, m1);
    exp_rows(s, scale_log2, m0 * scale_log2, m1 * scale_log2, l0, l1);
    pack_p(s, pa);
    alpha0 = alpha1 = 1.f;
  }

  // tiles 1 .. n_iter - 1: S_j = Q K_j^T and O += P_(j-1) V_(j-1) in one
  // turn; S_j's softmax while the second product runs
#pragma unroll 1
  for (int j = 1; j < n_iter; ++j) {
    const int st = j % kStages;
    const int sv = (j - 1) % kStages;
    mbar_wait(&sm.full_k[st], (j / kStages) & 1);
    const uint4 bits = kMasked ? *reinterpret_cast<const uint4*>(sm.kbits[st]) : all_visible;
    named_bar_sync(mine, 256);
    wgmma_fence();
    issue_qk(s, q_rows, smem_u32(sm.k[st][0]));
    rescale(o, alpha0, alpha1);
    mbar_wait(&sm.full_v[sv], ((j - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv(o, pa, smem_u32(sm.v[sv][0]));
    named_bar_arrive(next, 256);
    wgmma_wait<1>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[st]);
    mask_tile<kMasked>(s, bits, j, n_iter, S, p.causal, qpos0, qpos1, quad, neg);
    float mx0 = m0, mx1 = m1;
    row_max(s, mx0, mx1);
    alpha0 = fast_exp2((m0 - mx0) * scale_log2);
    alpha1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    float sum0, sum1;
    exp_rows(s, scale_log2, mx0 * scale_log2, mx1 * scale_log2, sum0, sum1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_v[sv]);
    pack_p(s, pa);
  }

  // the last tile's O += P V (consumer 1 makes no arrival after it)
  {
    const int sv = (n_iter - 1) % kStages;
    rescale(o, alpha0, alpha1);
    mbar_wait(&sm.full_v[sv], ((n_iter - 1) / kStages) & 1);
    named_bar_sync(mine, 256);
    wgmma_fence();
    issue_pv(o, pa, smem_u32(sm.v[sv][0]));
    if (wg < kConsumers - 1) named_bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // epilogue: O / l, zero masked queries, bf16 pairs from registers
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float keep0 = 1.f, keep1 = 1.f;
  if (kMasked) {
    if (qpos0 < S) keep0 = p.query_mask[b * p.mask_sb + qpos0] != 0 ? 1.f : 0.f;
    if (qpos1 < S) keep1 = p.query_mask[b * p.mask_sb + qpos1] != 0 ? 1.f : 0.f;
  }
  const float inv0 = keep0 / fmaxf(l0, 1e-30f);
  const float inv1 = keep1 / fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (qpos0 < S) {
      *reinterpret_cast<uint32_t*>(ob + qpos0 * p.o_ss + col) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (qpos1 < S) {
      *reinterpret_cast<uint32_t*>(ob + qpos1 * p.o_ss + col) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (kLse && quad == 0) {
    float* lb = p.lse + b * p.lse_sb + h * p.lse_sh;
    if (qpos0 < S) lb[qpos0] = m0 * p.scale + logf(fmaxf(l0, 1e-30f));
    if (qpos1 < S) lb[qpos1] = m1 * p.scale + logf(fmaxf(l1, 1e-30f));
  }
}

// ---- host side -----------------------------------------------------------

template <bool kMasked, bool kLse>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int grid, cudaStream_t st) {
  constexpr int smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<kMasked, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<kMasked, kLse><<<grid, kThreads, smem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Pointers are device
// pointers of bf16 (B, S, H, head_dim) tensors whose last dim is contiguous,
// 16-byte aligned, with other strides that are multiples of 8 elements;
// masks are int32 (B, S) with unit stride along S, both null for the dense
// variant. `lse` is null (inference) or fp32 (B, Hq, S) with unit stride
// along S. head_dim must be 128 (d = 64 is flash_fwd_dense.cu's). Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another head dim or operands that TMA cannot
// describe.
extern "C" int blim_flash_fwd(const void* q, const void* k, const void* v,
                              const int* key_mask, const int* query_mask, void* out,
                              float* lse, long long lse_sb, long long lse_sh,
                              int batch, int seq_len, int num_q_heads, int num_kv_heads,
                              int head_dim,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              long long mask_sb, float scale, int causal, void* stream) {
  const bool masked = key_mask != nullptr;
  if (head_dim != kD || batch <= 0 || seq_len <= 0 || num_kv_heads <= 0 ||
      num_q_heads % num_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, head_dim, seq_len, num_q_heads, batch, q_ss, q_sh, q_sb, kBQ) ||
      !make_map(&tk, k, head_dim, seq_len, num_kv_heads, batch, k_ss, k_sh, k_sb, kBK) ||
      !make_map(&tv, v, head_dim, seq_len, num_kv_heads, batch, v_ss, v_sh, v_sb, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.o = static_cast<bf16*>(out);
  p.key_mask = key_mask;
  p.query_mask = query_mask;
  p.lse = lse;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.mask_sb = mask_sb;
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.batch = batch;
  p.num_heads = num_q_heads;
  p.seq_len = seq_len;
  p.group = num_q_heads / num_kv_heads;
  p.scale = scale;
  p.causal = causal;

  const int grid = ((seq_len + kBQ - 1) / kBQ) * num_q_heads * batch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked) {
    return (int)(lse ? launch<true, true>(tq, tk, tv, p, grid, st)
                     : launch<true, false>(tq, tk, tv, p, grid, st));
  }
  return (int)(lse ? launch<false, true>(tq, tk, tv, p, grid, st)
                   : launch<false, false>(tq, tk, tv, p, grid, st));
}

// Dynamic shared memory a CTA of the kernel uses at this head dim, in bytes
// (0 for a head dim without an instantiation).
extern "C" int blim_flash_fwd_smem_bytes(int head_dim) {
  return head_dim == kD ? smem_bytes() : 0;
}

extern "C" const char* blim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
