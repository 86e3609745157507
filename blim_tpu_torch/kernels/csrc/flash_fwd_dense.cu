// Flash-attention forward at head dim 64, dense and non-causal, for Hopper
// (sm_90a): every attention of the UMT ViT-L tower, with or without the fp32
// logsumexp rows that the backward (flash_bwd_dense.cu) reads. bf16 in, fp32
// accumulate, bf16 out.
//
// Replaces: blim_tpu/kernels/flash_attention.py `_fwd_kernel` (:42-125),
// launched by `_flash_forward` -> pl.pallas_call (:178), in its dense mode
// (no masks, non-causal: the `dense` branch :140-144 with the unrolled KV
// loop :104-111, picked by the wrapper at :498-510), in two uses:
//   * B2: without lse, every attention of the tower in feature extraction,
//     chat and the image path (umt_vit.vit_block -> multi_head_attention ->
//     flash_attention_dense), q, k, v read in place as strided views of the
//     packed qkv projection (stride 3 x 16 x 64 along S);
//   * B2-lse: with lse (`lse_ref` :121-125, via `_vjp_fwd` :434), every
//     attention of the tower when it is differentiated
//     (FlashAttentionFunction -> flash_attention_lse).
//
// Semantics, the same as the TPU kernel and the plain version
// (kernels/attention.py::reference_attention, flash_attention.py::
// reference_attention_lse): online softmax in fp32 over kv tiles, the scale
// folded into the exponential's fused multiply-add, exp2(fma(s, scale
// log2 e, -m scale log2 e)) with the running max m kept in unscaled scores;
// keys beyond S get the masked logit, the power of two nearest -1e30 in the
// scaled-logit domain; P is cast to bf16 before the P.V product; l is
// clamped at 1e-30 before the division; rows beyond S are not written; with
// an lse pointer, each row < S also writes m scale + log(max(l, 1e-30)).
// Query head h reads K/V head h / (Hq / Hkv) (the ViT has one each).
//
// What bounds it on the card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s). Per
// clip (S = 3136, 16 heads of 64) it does 4 S^2 d H = 40.3 GFLOP and moves
// 25.7 MB: at 8 clips 0.3258 ms of tensor-core time against 0.061 ms of
// HBM time, so it is bound by operations. The softmax's exponentials bind
// it equally: S^2 H a clip (1.259e9 at 8 clips) on the SFUs, 16 a clock an
// SM, take 0.3258 ms at the 1.829 GHz that the 989 TFLOP/s peak implies,
// because a pair costs 4 d = 256 tensor-core flops and the tensor cores do
// 4096 a clock an SM, 256 times the SFUs' 16. The two floors add unless the
// tensor cores run some consumers' products while the SFUs run another's
// exponentials; and a consumer's softmax is a chain (the row max, its
// shuffles, the exponentials, the sums) that is longer than its products.
// scripts/ablate_fwd_dense_torch.py times the kernel with one part of its
// design or work taken out.
//
// Design (FlashAttention-3's forward at d 64, on hopper.cuh's machinery):
//   * A CTA owns kBQ = 192 q rows of one (batch, q-head): three consumer
//     warpgroups of 64 rows and a producer warpgroup, one thread of which
//     issues every TMA load (the Q tile once; K and V tiles through two
//     rings of kStages buffers, each buffer with its own full and empty
//     mbarrier, since a consumer releases K_j before V_(j-1)). 4-D tensor
//     maps over (d, S, H, B), built on the host from the operands' strides,
//     read B2's slices of the packed qkv in place. setmaxnreg moves
//     registers from the producer (32) to the consumers (160).
//   * Turns at the tensor cores (the two-consumer ping-pong, taken round
//     three): a consumer issues its products only after the named barrier
//     of its turn (kBarTurn + wg) has been arrived at by the consumer
//     before it, and arrives at the next one's right after issuing. So the
//     other two consumers' products run while one runs its softmax (a
//     softmax may take up to two turns' products without idling the tensor
//     cores, against one with two consumers), and the consumers never drift
//     into running their exponentials at the same time. Consumer 0 skips its
//     first wait and the last consumer its last arrival, so the arrivals
//     match the waits.
//   * Inside a consumer, the next tile's QK^T over this tile's softmax: in
//     iteration j it issues S_j = Q K_j^T and then O += P_(j-1) V_(j-1)
//     as two wgmma groups, waits for S_j alone (wgmma_wait<1>), runs the
//     online softmax of S_j while P_(j-1) V_(j-1) is in flight, then waits
//     for that and rescales O. Tile 0's S and the last tile's P V are
//     peeled off the loop. Every product is issued and waited in one
//     iteration, so none stays in flight across the loop's back edge
//     (ptxas would then serialize every wgmma of the kernel).
//   * S = Q K^T is wgmma m64n112k16 with Q and K in shared memory (both
//     K-major); the fp32 scores stay in registers (two rows a thread, their
//     max by a tree and two shuffles over a quad of lanes); P goes to bf16
//     in registers in the A-operand layout of O += P V, wgmma m64n64k16 with
//     V from shared memory (MN-major). O stays in fp32 registers. A
//     consumer thread holds S (56 fp32), P (28 bf16 pairs) and O (32)
//     across the loop, under its 160 registers.
//   * The kv tile kBK = 112 rows divides the path's S: 28 tiles at S = 3136
//     and 7 at S = 784, so no product is done on zero rows there (a 128-row
//     tile pads S = 784 to 896). The ragged last tile of any other S gives
//     its keys beyond S the masked logit.
//   * The q tiles: 3136 = 49 x 64 rows, so a head's 17th CTA has one
//     consumer on rows 3072-3135 and two on rows beyond S; at S = 784 the
//     5th CTA holds rows 768-783 (16 of its 192). A consumer with no row
//     below S keeps its turns and its mbarrier arrivals in a loop of its
//     own and runs no product, so the others finish sooner; the active
//     consumers' loop has no branch on it. Grid: a (batch, head)'s
//     q tiles side by side, so they share its K/V in L2: 17 x 16 x clips
//     CTAs at S = 3136 (2176 at 8 clips, 16.5 waves of one CTA an SM), 5 x
//     16 x 5 = 400 at the image tiles (3.03 waves).
//   * Each output row's sum runs over the kv tiles in one fixed order, so
//     two runs agree bit for bit.
//   * The epilogue divides by l and writes bf16 pairs straight from
//     registers; with lse, one lane of each quad writes its two rows' lse.

#include "hopper.cuh"

namespace {

constexpr int kD = 64;             // head dim: one 128-byte swizzled row
constexpr int kBK = 112;           // kv rows a tile
constexpr int kConsumers = 3;      // consumer warpgroups, 64 q rows each
constexpr int kBQ = 64 * kConsumers;   // q rows a CTA
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 4;         // buffers of each of the K and V rings
// setmaxnreg's split of the 65,536 registers: the producer warpgroup keeps
// kProducerRegs a thread, each consumer thread gets kConsumerRegs for S
// (kBK / 2 fp32), P (kBK / 4 bf16 pairs) and O (32) across the loop.
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kBarTurn = 1;        // + consumer: named barrier of that consumer's turn
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register split");
static_assert(kBK % 16 == 0, "P V's k-steps are 16 kv rows");

// Each operand array is a multiple of 1024 bytes from a 1024-byte aligned
// start, as the 128B swizzle requires.
struct Smem {
  bf16 q[kBQ * 64];
  bf16 k[kStages][kBK * 64];
  bf16 v[kStages][kBK * 64];
  uint64_t full_q;
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
  uint64_t empty_k[kStages];
  uint64_t empty_v[kStages];
};

constexpr int smem_bytes() { return (int)sizeof(Smem) + 1024; }   // + alignment slack

struct Params {
  bf16* o;
  float* lse;             // (B, Hq, S) with strides lse_sb, lse_sh, unit along S; or null
  long long o_sb, o_ss, o_sh;
  long long lse_sb, lse_sh;
  int batch;
  int num_heads;          // Hq
  int seq_len;
  int group;              // Hq / Hkv
  float scale;
};

// S = Q K^T for one kv tile: 4 k-steps of m64n112k16, one wgmma group.
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss_n112(s, desc_kmajor(q_rows, kk), desc_kmajor(k_tile, kk), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile: kBK / 16 k-steps of m64n64k16, P from registers.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[kBK / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    wgmma_rs_n64(o, a, desc_mnmajor(v_tile, kk));
  }
  wgmma_commit();
}

// The masked logit for this thread's columns at or beyond `limit` (keys
// beyond S in the ragged last tile).
template <int N>
__device__ __forceinline__ void mask_from(float (&s)[N], int limit, int quad, float neg) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * j + 2 * quad + e >= limit) {
        s[4 * j + e] = neg;
        s[4 * j + 2 + e] = neg;
      }
    }
  }
}

// Folds the tile's row maxima (this thread's two rows, over its quad) into
// mx0, mx1; a tree over the row's columns, so the chain is short.
template <int N>
__device__ __forceinline__ void row_max(const float (&s)[N], float& mx0, float& mx1) {
  float a[N / 4], c[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    a[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    c[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int w = 1; w < N / 4; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < N / 4; j += 2 * w) {
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
template <int N>
__device__ __forceinline__ void exp_rows(float (&s)[N], float scale_log2, float mb0, float mb1,
                                         float& sum0, float& sum1) {
  sum0 = sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], scale_log2, -mb0));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -mb0));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -mb1));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -mb1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P in bf16 pairs: the A fragments of k-step kk are pa[4kk .. 4kk + 3].
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N], uint32_t (&pa)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// ---- the kernel ----------------------------------------------------------

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_dense_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kTileBytes = kBK * kD * 2;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int S = p.seq_len;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int n_kv = (S + kBK - 1) / kBK;
  const int q_tile = blockIdx.x % n_q;   // a (batch, head)'s q tiles side by side
  const int bh = blockIdx.x / n_q;
  const int h = bh % p.num_heads;
  const int b = bh / p.num_heads;
  const int q0 = q_tile * kBQ;
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
    // ---- producer: one thread issues every load, in the order the
    // consumers take them (K_0, then K_j and V_(j-1), then the last V)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == kConsumers * 128) {
      const int kvh = h / p.group;
      mbar_expect_tx(&sm.full_q, kBQ * kD * 2);
      tma_load(sm.q, &tm_q, &sm.full_q, 0, q0, h, b);
      for (int j = 0; j <= n_kv; ++j) {
        if (j < n_kv) {                        // K_j
          const int st = j % kStages;
          if (j >= kStages) mbar_wait(&sm.empty_k[st], (j / kStages - 1) & 1);
          mbar_expect_tx(&sm.full_k[st], kTileBytes);
          tma_load(sm.k[st], &tm_k, &sm.full_k[st], 0, j * kBK, kvh, b);
        }
        if (j > 0) {                           // V_(j-1)
          const int jv = j - 1;
          const int st = jv % kStages;
          if (jv >= kStages) mbar_wait(&sm.empty_v[st], (jv / kStages - 1) & 1);
          mbar_expect_tx(&sm.full_v[st], kTileBytes);
          tma_load(sm.v[st], &tm_v, &sm.full_v[st], 0, jv * kBK, kvh, b);
        }
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
  const float scale_log2 = p.scale * kLog2e;
  // The masked logit, about -1e30 in the scaled-logit domain. A power of two,
  // so that neg * scale_log2 is exact.
  const float neg = ldexpf(-1.f, (int)rintf(log2f(-kNegInf / p.scale)));
  const uint32_t q_rows = smem_u32(sm.q) + wg * 64 * 128;
  const int mine = kBarTurn + wg;
  const int next = kBarTurn + (wg + 1) % kConsumers;

  // A consumer whose 64 rows all lie beyond S (two of the three in a head's
  // last CTA, at S = 3136 and at S = 784) takes its turns and makes its
  // mbarrier arrivals, which pace it with the others, and runs no product:
  // a loop of its own, so that the others' loop keeps no branch on it.
  const bool active = q0 + 64 * wg < S;
  if (!active) {
    for (int j = 0; j <= n_kv; ++j) {
      if (j < n_kv) mbar_wait(&sm.full_k[j % kStages], (j / kStages) & 1);
      if (wg > 0 || j > 0) named_bar_sync(mine, 256);
      if (j > 0) mbar_wait(&sm.full_v[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      if (wg < kConsumers - 1 || j < n_kv) named_bar_arrive(next, 256);
      if (lane == 0 && j < n_kv) mbar_arrive(&sm.empty_k[j % kStages]);
      if (lane == 0 && j > 0 && j < n_kv) mbar_arrive(&sm.empty_v[(j - 1) % kStages]);
    }
    return;
  }

  float s[kBK / 2];       // S of the tile, then its P in fp32
  uint32_t pa[kBK / 4];   // P of the previous tile in bf16 pairs
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0, m1;           // running max, unscaled scores
  float l0, l1;           // this thread's share of the running sums

  // tile 0: S_0 alone (consumer 0 takes the first turn), its softmax
  mbar_wait(&sm.full_q, 0);
  mbar_wait(&sm.full_k[0], 0);
  if (wg > 0) named_bar_sync(mine, 256);
  wgmma_fence();
  issue_qk(s, q_rows, smem_u32(sm.k[0]));
  named_bar_arrive(next, 256);
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(&sm.empty_k[0]);
  if (kBK > S) mask_from(s, S, quad, neg);
  m0 = m1 = neg;
  row_max(s, m0, m1);
  exp_rows(s, scale_log2, m0 * scale_log2, m1 * scale_log2, l0, l1);
  pack_p(s, pa);

  // tiles 1 .. n_kv - 1: S_j = Q K_j^T and O += P_(j-1) V_(j-1) in one
  // turn; S_j's softmax while the second product runs
#pragma unroll 1
  for (int j = 1; j < n_kv; ++j) {
    const int st = j % kStages;
    const int sv = (j - 1) % kStages;
    mbar_wait(&sm.full_k[st], (j / kStages) & 1);
    named_bar_sync(mine, 256);
    wgmma_fence();
    issue_qk(s, q_rows, smem_u32(sm.k[st]));
    mbar_wait(&sm.full_v[sv], ((j - 1) / kStages) & 1);
    issue_pv(o, pa, smem_u32(sm.v[sv]));
    named_bar_arrive(next, 256);
    wgmma_wait<1>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[st]);
    if ((j + 1) * kBK > S) mask_from(s, S - j * kBK, quad, neg);   // the ragged last tile
    float mx0 = m0, mx1 = m1;
    row_max(s, mx0, mx1);
    const float alpha0 = fast_exp2((m0 - mx0) * scale_log2);
    const float alpha1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    float sum0, sum1;
    exp_rows(s, scale_log2, mx0 * scale_log2, mx1 * scale_log2, sum0, sum1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_v[sv]);
    pack_p(s, pa);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }

  // the last tile's O += P V (the last consumer makes no arrival after it)
  {
    const int sv = (n_kv - 1) % kStages;
    mbar_wait(&sm.full_v[sv], ((n_kv - 1) / kStages) & 1);
    named_bar_sync(mine, 256);
    wgmma_fence();
    issue_pv(o, pa, smem_u32(sm.v[sv]));
    if (wg < kConsumers - 1) named_bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // epilogue: O / l, bf16 pairs from registers, rows < S
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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

template <bool kLse>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int grid, cudaStream_t st) {
  constexpr int smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_dense_kernel<kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_dense_kernel<kLse><<<grid, kThreads, smem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. q, k, v are device
// pointers of bf16 (B, S, H, 64) tensors whose last dim is contiguous,
// 16-byte aligned, with other strides (in elements) that are multiples of 8;
// out the same with the strides given. `lse` is null (B2) or fp32 (B, Hq, S)
// with unit stride along S (B2-lse). Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for operands
// that TMA cannot describe.
extern "C" int blim_flash_fwd_dense(const void* q, const void* k, const void* v, void* out,
                                    float* lse, long long lse_sb, long long lse_sh,
                                    int batch, int seq_len, int num_q_heads, int num_kv_heads,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long o_sb, long long o_ss, long long o_sh,
                                    float scale, void* stream) {
  if (batch <= 0 || seq_len <= 0 || num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, kD, seq_len, num_q_heads, batch, q_ss, q_sh, q_sb, kBQ) ||
      !make_map(&tk, k, kD, seq_len, num_kv_heads, batch, k_ss, k_sh, k_sb, kBK) ||
      !make_map(&tv, v, kD, seq_len, num_kv_heads, batch, v_ss, v_sh, v_sb, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.o = static_cast<bf16*>(out);
  p.lse = lse;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.batch = batch;
  p.num_heads = num_q_heads;
  p.seq_len = seq_len;
  p.group = num_q_heads / num_kv_heads;
  p.scale = scale;
  const int grid = ((seq_len + kBQ - 1) / kBQ) * num_q_heads * batch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(lse ? launch<true>(tq, tk, tv, p, grid, st) : launch<false>(tq, tk, tv, p, grid, st));
}

// Dynamic shared memory of the kernel's CTA, in bytes.
extern "C" int blim_flash_fwd_dense_smem_bytes() { return smem_bytes(); }

extern "C" const char* blim_flash_fwd_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
