// Flash-attention forward for Hopper (sm_90a) at head dim 128 (the 7B
// decoder): causal or full, masked or dense, GQA, bf16 in / fp32
// accumulate, with or without the fp32 logsumexp rows that the backward
// (flash_bwd.cu) reads. The head dim is a template parameter, instantiated
// at 128 only; the UMT ViT's d = 64 dense forward (B2, B2-lse) is
// flash_fwd_dense.cu, a design of its own.
//
// Replaces: blim_tpu/kernels/flash_attention.py `_fwd_kernel` (:42-125),
// launched by `_flash_forward` -> pl.pallas_call (:178), in two uses:
//   * B1: without lse in the causal masked mode that every prefix forward of
//     the zero-shot rerank path runs (qwen2.forward_collect_kv ->
//     attention.multi_head_attention); the B1-lse instantiation with the
//     lse store compiled out;
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
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16).
//   B1/B1-lse are bound by bytes. At the main-path shapes (G = 4 packs of
//   S = 341, or the train step's B = 4 of S = 448; Hq 28, Hkv 4, d 128,
//   causal) one launch moves 6-7 MB (q, k, v, o once, lse, masks): ~2 us
//   at 3.35 TB/s against ~1 us of tensor-core time. With at most 4 KV
//   tiles a CTA, what the kernel actually pays is latency: the first
//   tile's load, then a chain of products and the softmax per tile.
//
// Design (FlashAttention-3's shape):
//   * A CTA owns 128 q rows of one (batch, q-head) and runs three
//     warpgroups: two consumers of 64 rows each and one producer.
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232).
//   * The producer's first warp loads the q tile once and streams K and V
//     tiles of 128 rows by TMA (cp.async.bulk.tensor, 4-D maps over
//     (d, S, H, B) built on the host from the operands' strides, so strided
//     views are read in place) into a ring of 2 stages guarded by
//     mbarriers: a full barrier per K and V buffer, an empty barrier that
//     each consumer warp arrives on when its products have read the stage.
//     Rows beyond S come back as zeros. In the masked mode the same warp
//     turns the key mask of each tile into 128 bits in shared memory beside
//     it.
//   * Tiles are 128B-swizzled, 64 columns (128 B) a box: d = 128 takes two
//     boxes per tile, stored as two 64-column halves.
//   * S = Q K^T is wgmma m64n128k16 with Q and K in shared memory (both
//     K-major). The fp32 scores stay in registers: each thread holds two
//     rows, whose max and sum need two shuffles within a quad of lanes; the
//     exponentials are exp2 with scale * log2(e) folded into one FMA.
//   * P goes to bf16 in registers, already in the A-operand layout of the
//     next wgmma: O += P V is wgmma m64n64k16 with A from registers and V
//     from shared memory (MN-major), once per 64-column half of V. O stays
//     in fp32 registers and is rescaled there; no fp32 tile touches shared
//     memory.
//   * Tiles wholly above the causal diagonal are skipped; the diagonal tile,
//     the ragged last tile and (masked mode) every tile mask by position
//     and by the key-mask bits; other tiles run without a mask.
//   * Grid order: dense, the q tiles of one (batch, head) are neighbours so
//     they share its K/V in L2; causal, the heaviest q tiles (most KV
//     tiles) launch first.
//   * The epilogue divides by l, zeroes masked query rows and writes bf16
//     pairs straight from registers; with lse, one lane of each quad writes
//     its two rows' lse.

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;           // q rows per CTA
constexpr int kBK = 128;           // kv rows per tile
constexpr int kConsumers = 2;      // consumer warpgroups, 64 q rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;  // (168 - 40) x 128 = (232 - 168) x 256
constexpr int kConsumerRegs = 232;

static_assert(kBQ == kBK, "the causal tile count assumes square tiles");
static_assert(kBQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");

// Each operand array is a multiple of 1024 bytes and the struct starts on a
// 1024-byte boundary, as the 128B swizzle requires.
template <int kD>
struct Smem {
  static constexpr int kHalves = kD / 64;            // 64-column (128 B) halves
  static constexpr int kStages = 2;
  bf16 q[kHalves][kBQ * 64];
  bf16 k[kStages][kHalves][kBK * 64];
  bf16 v[kStages][kHalves][kBK * 64];
  uint32_t kbits[kStages][kBK / 32];                 // key mask bits per tile
  uint64_t full_q;
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
  uint64_t empty[kStages];
};

template <int kD>
constexpr int smem_bytes() { return (int)sizeof(Smem<kD>) + 1024; }  // + alignment slack

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

// ---- the kernel ----------------------------------------------------------

template <int kD, bool kMasked, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using Sm = Smem<kD>;
  constexpr int kHalves = Sm::kHalves;
  constexpr int kStages = Sm::kStages;
  constexpr int kTileBytes = kBK * kD * 2;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

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
  const int wg = tid / 128;

  if (tid == 0) {
    mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full_k[st], 1);
      mbar_init(&sm.full_v[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp issues every load; the other three idle out
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid / 32 == kConsumers * 4) {
      const int lane = tid % 32;
      const int kvh = h / p.group;
      if (lane == 0) {
        mbar_expect_tx(&sm.full_q, kBQ * kD * 2);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) tma_load(sm.q[hf], &tm_q, &sm.full_q, 64 * hf, q0, h, b);
      }
      for (int kt = 0; kt < n_iter; ++kt) {
        const int st = kt % kStages;
        const int k0 = kt * kBK;
        if (kt >= kStages) mbar_wait(&sm.empty[st], (kt / kStages - 1) & 1);
        uint32_t words[kBK / 32];
        if (kMasked) {
#pragma unroll
          for (int w = 0; w < kBK / 32; ++w) {
            const int kpos = k0 + 32 * w + lane;
            words[w] = __ballot_sync(0xffffffffu,
                                     kpos < S && p.key_mask[b * p.mask_sb + kpos] != 0);
          }
        }
        if (lane == 0) {
          if (kMasked) {
#pragma unroll
            for (int w = 0; w < kBK / 32; ++w) sm.kbits[st][w] = words[w];
          }
          mbar_expect_tx(&sm.full_k[st], kTileBytes);   // also releases the mask bits
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(sm.k[st][hf], &tm_k, &sm.full_k[st], 64 * hf, k0, kvh, b);
          mbar_expect_tx(&sm.full_v[st], kTileBytes);
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(sm.v[st][hf], &tm_v, &sm.full_v[st], 64 * hf, k0, kvh, b);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 q rows each; S, P and O in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int qpos0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // this thread's two rows
    const int qpos1 = qpos0 + 8;
    const float scale_log2 = p.scale * kLog2e;
    // The masked logit, about -1e30 in the scaled-logit domain. A power of two, so
    // that neg * scale_log2 is exact and the FMA below gives a row whose keys are
    // all masked exponents of exactly 0 (p = 1), not its rounding error.
    const float neg = ldexpf(-1.f, (int)rintf(log2f(-kNegInf / p.scale)));
    const uint32_t q_base = smem_u32(sm.q[0]) + wg * 64 * 128;

    float o[kHalves][32];
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
    }
    float m0 = neg, m1 = neg;   // running max, unscaled scores
    float l0 = 0.f, l1 = 0.f;   // this thread's share of the running sums

    mbar_wait(&sm.full_q, 0);
    for (int kt = 0; kt < n_iter; ++kt) {
      const int st = kt % kStages;
      const int parity = (kt / kStages) & 1;
      const int k0 = kt * kBK;

      // S = Q K^T
      float s[kBK / 2];
      mbar_wait(&sm.full_k[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n128(s, desc_kmajor(q_base + (kk / 4) * kBQ * 128, kk),
                      desc_kmajor(smem_u32(sm.k[st][kk / 4]), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks: key bits, the ragged edge, the causal diagonal
      const bool diag = p.causal && kt == q_tile;
      if (kMasked || diag || k0 + kBK > S) {
        uint4 bits = make_uint4(~0u, ~0u, ~0u, ~0u);
        if (kMasked) bits = *reinterpret_cast<const uint4*>(sm.kbits[st]);
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

      // online softmax in registers
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = fast_exp2((m0 - mx0) * scale_log2);
      const float alpha1 = fast_exp2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * scale_log2;
      const float mb1 = mx1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[kBK / 4];   // P in bf16 pairs: the A fragments of k-step kk are pa[4kk .. 4kk+3]
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p00 = fast_exp2(fmaf(s[4 * j], scale_log2, -mb0));
        const float p01 = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -mb0));
        const float p10 = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -mb1));
        const float p11 = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -mb1));
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pa[2 * j] = pack_bf16(p00, p01);
        pa[2 * j + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[hf][4 * j] *= alpha0;
          o[hf][4 * j + 1] *= alpha0;
          o[hf][4 * j + 2] *= alpha1;
          o[hf][4 * j + 3] *= alpha1;
        }
      }

      // O += P V
      mbar_wait(&sm.full_v[st], parity);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(o[hf]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          wgmma_rs_n64(o[hf], a, desc_mnmajor(smem_u32(sm.v[st][hf]), kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(o[hf]);
      if (lane == 0) mbar_arrive(&sm.empty[st]);
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
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * quad;
        if (qpos0 < S) {
          *reinterpret_cast<uint32_t*>(ob + qpos0 * p.o_ss + col) =
              pack_bf16(o[hf][4 * j] * inv0, o[hf][4 * j + 1] * inv0);
        }
        if (qpos1 < S) {
          *reinterpret_cast<uint32_t*>(ob + qpos1 * p.o_ss + col) =
              pack_bf16(o[hf][4 * j + 2] * inv1, o[hf][4 * j + 3] * inv1);
        }
      }
    }
    if (kLse && quad == 0) {
      float* lb = p.lse + b * p.lse_sb + h * p.lse_sh;
      if (qpos0 < S) lb[qpos0] = m0 * p.scale + logf(fmaxf(l0, 1e-30f));
      if (qpos1 < S) lb[qpos1] = m1 * p.scale + logf(fmaxf(l1, 1e-30f));
    }
  }
}

// ---- host side -----------------------------------------------------------

template <int kD, bool kMasked, bool kLse>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int grid, cudaStream_t st) {
  const int smem = smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<kD, kMasked, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<kD, kMasked, kLse><<<grid, kThreads, smem, st>>>(tq, tk, tv, p);
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
  if (head_dim != 128 || batch <= 0 || seq_len <= 0 || num_kv_heads <= 0 ||
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
    return (int)(lse ? launch<128, true, true>(tq, tk, tv, p, grid, st)
                     : launch<128, true, false>(tq, tk, tv, p, grid, st));
  }
  return (int)(lse ? launch<128, false, true>(tq, tk, tv, p, grid, st)
                   : launch<128, false, false>(tq, tk, tv, p, grid, st));
}

// Dynamic shared memory a CTA of the kernel uses at this head dim, in bytes
// (0 for a head dim without an instantiation).
extern "C" int blim_flash_fwd_smem_bytes(int head_dim) {
  return head_dim == 128 ? smem_bytes<128>() : 0;
}

extern "C" const char* blim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
