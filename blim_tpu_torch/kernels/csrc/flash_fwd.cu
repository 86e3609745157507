// Flash-attention forward for Hopper (sm_90a): causal or full, masked or
// dense, GQA, bf16 in / fp32 accumulate, with or without the fp32 logsumexp
// rows that the backward (flash_bwd.cu) reads. One kernel template over the
// head dim: d = 128 (the 7B decoder, every mode) and d = 64 (the UMT ViT,
// dense only).
//
// Replaces: blim_tpu/kernels/flash_attention.py `_fwd_kernel` (:42-125),
// launched by `_flash_forward` -> pl.pallas_call (:178), in three uses:
//   * B1: without lse in the causal masked mode that every prefix forward of
//     the zero-shot rerank path runs (qwen2.forward_collect_kv ->
//     attention.multi_head_attention), d = 128;
//   * B1-lse: with lse (`lse_ref`, :121-125, via `_vjp_fwd` :434) for every
//     attention call of the LoRA train step, d = 128;
//   * B2: dense non-causal, no masks (the `dense` branch :140-144 with the
//     unrolled KV loop :104-111, picked by the wrapper at :498-510), d = 64:
//     every attention of the UMT ViT-L tower in feature extraction
//     (umt_vit.vit_block), q, k, v read in place as strided views of the
//     packed qkv projection.
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
//     row whose keys are all masked gets -1e30 + log(n) there; the backward
//     multiplies its dO by the query mask, so that value reaches no gradient.
//
// What bounds it on the card.
//   * B1/B1-lse. At the main-path shape (B = G packs, S = 341, Hq = 28,
//     Hkv = 4, d = 128, causal) one launch moves ~5.6 MB per pack (q, k, v,
//     o read or written once): ~1.7 us per pack at 3.35 TB/s, against ~0.83
//     GFLOP per pack, ~0.85 us at 989 TFLOP/s. So the floor is memory.
//   * B2 is bound by operations, not bytes. Per clip (S = 3136, 16 heads of
//     64) it does 4 S^2 d H = 40.3 GFLOP and moves 25.7 MB: at 8 clips one
//     launch is 0.326 ms of bf16 tensor-core time against 0.061 ms of HBM
//     time. The design below is far from that floor: its online softmax runs
//     row by row through shared memory between two WMMA products.
//
// Design, first version: right and simple before fast.
//   * One CTA of 4 warps per (batch, q-head, 64-row q tile). The q tile is
//     staged in shared memory once; K/V tiles of 64 rows stream through
//     shared memory, only up to the causal diagonal (tile qi stops at kv
//     tile qi, since both tiles are 64 rows). B2 at S = 3136 has 49 q tiles
//     and visits all 49 K/V tiles from each: 49 x 16 heads x clips CTAs
//     (6,272 at 8 clips, 50,176 at the featurizer's 64), plenty for 132 SMs.
//   * Tensor cores through WMMA (16x16x16 bf16 fragments, fp32 accumulate):
//     S = Q K^T per warp for its 16 rows, then O += P V.
//   * WMMA accumulators hide their row layout, so O lives in shared memory
//     in fp32: each tile rescales the warp's O rows by alpha, then loads them
//     as accumulators, adds P V and stores them back.
//   * Tensors are read in their (B, S, H, D) layout through strides, 16
//     bytes per thread per load; the ragged edge is zero-filled and masked,
//     so any S works without padding copies.
//   * Dynamic shared memory per CTA: ~111 KB at d = 128 (two CTAs per SM),
//     ~70 KB at d = 64 (three CTAs per SM).
// Left for later work: TMA loads, wgmma, a register-resident O, and
// overlapping the next tile's loads with this tile's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kWarps = 4;      // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = kBK + 4;  // fp32 row pitch of the score tile
constexpr int kLdP = kBK + 8;  // bf16 row pitch of the probability tile
constexpr float kNegInf = -1e30f;

// Row pitches that depend on the head dim kD.
template <int kD>
struct Pitch {
  static constexpr int qk = kD + 8;  // bf16 row pitch of the q/k/v tiles
  static constexpr int o = kD + 4;   // fp32 row pitch of the output accumulator
};

static_assert(kBQ == kBK, "the causal tile count assumes square tiles");
static_assert(kBQ == 16 * kWarps, "each warp owns 16 q rows");

// Every array's byte size is a multiple of 32, so each starts 32-byte
// aligned, as WMMA loads and stores require.
template <int kD>
struct __align__(128) Smem {
  bf16 q[kBQ * Pitch<kD>::qk];
  bf16 k[kBK * Pitch<kD>::qk];
  bf16 v[kBK * Pitch<kD>::qk];
  float s[kBQ * kLdS];
  bf16 p[kBQ * kLdP];
  float o[kBQ * Pitch<kD>::o];
  float m[kBQ];
  float l[kBQ];
  float alpha[kBQ];
  int kmask[kBK];
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* key_mask;    // (B, S), row stride mask_sb; null when dense
  const int* query_mask;
  float* lse;             // (B, Hq, S) with strides lse_sb, lse_sh, unit along S; null = none
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long mask_sb;
  long long lse_sb, lse_sh;
  int seq_len;
  int group;              // Hq / Hkv
  float scale;
  int causal;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of one head into a pitched shared tile, 16 bytes a
// thread; rows at or beyond seq_len become zeros.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int row0, int seq_len) {
  constexpr int kChunks = kD / 8;
  constexpr int kLdQK = Pitch<kD>::qk;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq_len) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdQK + c) = val;
  }
}

template <int kD, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kLdQK = Pitch<kD>::qk;
  constexpr int kLdO = Pitch<kD>::o;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<kD>& sm = *reinterpret_cast<Smem<kD>*>(smem_raw);

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = q_tile * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int S = p.seq_len;
  const int row0 = warp * 16;  // this warp's rows within the tile

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  load_tile<kD>(sm.q, qb, p.q_ss, q0, S);
  for (int i = tid; i < kBQ * kLdO; i += kThreads) sm.o[i] = 0.f;
  if (tid < kBQ) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }

  const int n_kv_tiles = (S + kBK - 1) / kBK;
  const int n_iter = p.causal ? min(q_tile + 1, n_kv_tiles) : n_kv_tiles;

  for (int kt = 0; kt < n_iter; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<kD>(sm.k, kb, p.k_ss, k0, S);
    load_tile<kD>(sm.v, vb, p.v_ss, k0, S);
    if (kMasked && tid < kBK) {
      sm.kmask[tid] = (k0 + tid < S) ? p.key_mask[b * p.mask_sb + k0 + tid] : 0;
    }
    __syncthreads();

    // scores for this warp's 16 rows: S = Q K^T (K^T read col-major from K)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sm.q + row0 * kLdQK + kk * 16, kLdQK);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, sm.k + (j * 16) * kLdQK + kk * 16, kLdQK);
          wmma::mma_sync(acc[j], a, kf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        wmma::store_matrix_sync(sm.s + row0 * kLdS + j * 16, acc[j], kLdS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax, one row at a time, two columns a lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qpos = q0 + r;
      float x[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kpos = k0 + c;
        bool vis = kpos < S;
        if (kMasked) vis = vis && sm.kmask[c] != 0;
        if (p.causal) vis = vis && kpos <= qpos;
        x[t] = vis ? sm.s[r * kLdS + c] * p.scale : kNegInf;
      }
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      const float row_sum = warp_sum(p0 + p1);
      sm.p[r * kLdP + lane] = __float2bfloat16(p0);
      sm.p[r * kLdP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();  // every lane has read m[r] before lane 0 rewrites it
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.alpha[r] = alpha;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * alpha + row_sum;
      }
      __syncwarp();
    }

    // rescale this warp's output rows, then O += P V
    for (int i = lane; i < 16 * kD; i += 32) {
      const int r = row0 + i / kD;
      sm.o[r * kLdO + i % kD] *= sm.alpha[r];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, sm.o + row0 * kLdO + j * 16, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sm.p + row0 * kLdP + kk * 16, kLdP);
        wmma::load_matrix_sync(vf, sm.v + (kk * 16) * kLdQK + j * 16, kLdQK);
        wmma::mma_sync(oacc, pf, vf, oacc);
      }
      wmma::store_matrix_sync(sm.o + row0 * kLdO + j * 16, oacc, kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // epilogue: O / l, zero masked queries, 8 bf16 (16 bytes) a thread
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  constexpr int kChunks = kD / 8;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int qpos = q0 + r;
    if (qpos >= S) continue;
    float keep = 1.f;
    if (kMasked) keep = p.query_mask[b * p.mask_sb + qpos] != 0 ? 1.f : 0.f;
    const float inv_l = 1.f / fmaxf(sm.l[r], 1e-30f);
    const float* src = sm.o + r * kLdO + c;
    uint4 packed;
    __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      out2[t] = __floats2bfloat162_rn(src[2 * t] * inv_l * keep, src[2 * t + 1] * inv_l * keep);
    }
    *reinterpret_cast<uint4*>(ob + (long long)qpos * p.o_ss + c) = packed;
  }
  if (p.lse != nullptr && tid < kBQ && q0 + tid < S) {
    p.lse[b * p.lse_sb + h * p.lse_sh + q0 + tid] = sm.m[tid] + logf(fmaxf(sm.l[tid], 1e-30f));
  }
}

template <int kD, bool kMasked>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t st) {
  const size_t smem = sizeof(Smem<kD>);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<kD, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<kD, kMasked><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Pointers are device
// pointers of bf16 (B, S, H, head_dim) tensors whose last dim is contiguous
// and whose other strides are multiples of 8 elements; masks are int32
// (B, S) with unit stride along S, both null for the dense variant. `lse` is
// null (inference) or fp32 (B, Hq, S) with unit stride along S. head_dim 128
// takes every mode; head_dim 64 only the dense inference mode (no masks, no
// lse). Launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a mode that has no instantiation.
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
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(out);
  p.key_mask = key_mask;
  p.query_mask = query_mask;
  p.lse = lse;
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.mask_sb = mask_sb;
  p.seq_len = seq_len;
  p.group = num_q_heads / num_kv_heads;
  p.scale = scale;
  p.causal = causal;

  const dim3 grid((seq_len + kBQ - 1) / kBQ, num_q_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool masked = key_mask != nullptr;
  if (head_dim == 128) {
    return (int)(masked ? launch<128, true>(p, grid, st) : launch<128, false>(p, grid, st));
  }
  if (head_dim == 64 && !masked && query_mask == nullptr && lse == nullptr) {
    return (int)launch<64, false>(p, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a CTA of the kernel uses at this head dim, in bytes
// (0 for a head dim without an instantiation).
extern "C" int blim_flash_fwd_smem_bytes(int head_dim) {
  return head_dim == 128 ? (int)sizeof(Smem<128>) : head_dim == 64 ? (int)sizeof(Smem<64>) : 0;
}

extern "C" const char* blim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
