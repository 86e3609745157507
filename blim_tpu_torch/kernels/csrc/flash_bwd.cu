// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, for the
// causal or full, masked or dense, GQA attention of flash_fwd.cu. bf16 in,
// fp32 accumulate, bf16 out.
//
// Replaces: blim_tpu/kernels/flash_attention.py `_dq_kernel` (:195-249,
// launched by `_flash_backward` -> pl.pallas_call :361-376) and
// `_dkv_kernel` (:252-331, pl.pallas_call :391-412), which the LoRA train
// step runs through `_vjp_bwd` (:442-446) for every attention call of the
// 7B, in both the VTG and the TVG direction.
//
// Math, the same as the TPU kernels and the plain version
// (kernels/flash_attention.py::reference_attention_backward). Inputs: q, k,
// v, dO (already multiplied by the query mask), the forward's fp32 lse rows
// (scaled-logit domain) and delta = rowsum(dO * O) in fp32. For a (query,
// key) pair
//   s  = scale * q.k, or -1e30 where the key is masked, beyond S or (causal)
//        after the query;
//   p  = exp(s - lse);   dp = dO.v;   ds = p (dp - delta), 0 where invisible;
//   dq = scale * sum_k ds k;   dk = scale * sum_q ds q;   dv = sum_q p dO.
// Query head h reads KV head h / (Hq / Hkv); dk and dv sum over the group.
//
// What bounds it on the card. At the train step's VTG shape (B = 4,
// S = 448, Hq = 28, Hkv = 4, d = 128, causal, caption-length right pads)
// flash_dq reads q, k, v, dO, lse, delta once and writes dq once, ~30 MB or
// ~8.9 us at 3.35 TB/s, against 3 products of 2 d flops per visible pair,
// ~7.1 GFLOP or ~7.1 us at 989 TFLOP/s; flash_dkv moves ~33 MB (~10 us)
// against 4 products, ~9.4 GFLOP (~9.5 us). The two floors are within 25%
// of each other, memory the higher.
//
// Design, first version: right and simple before fast.
//   * flash_dq: one CTA of 4 warps per (q tile of 64 rows, q head, batch).
//     q, dO, lse and delta stay in shared memory; K/V tiles of 64 rows
//     stream through it up to the causal diagonal. S = Q K^T and
//     dP = dO V^T per warp for its 16 rows on tensor cores (WMMA, bf16 in,
//     fp32 out), dS in fp32 then bf16, dq += dS K in WMMA accumulators that
//     stay in registers (no rescaling, unlike the forward's O).
//   * flash_dkv: one CTA per (kv tile of 64 rows, kv head, batch) that
//     loops over the 7 q heads of its group and over the q tiles from the
//     causal diagonal on, each warp owning 16 key rows. It works on the
//     transposed tiles S^T = K Q^T and dP^T = V dO^T, so dv += P^T dO and
//     dk += dS^T Q are plain row-major products into register accumulators.
//     No two CTAs write the same rows: no atomics, as in the TPU design,
//     because the sequential group loop sits inside the CTA.
//   * P and dS are rounded to bf16 before their tensor-core products (the
//     TPU kernel keeps them in fp32); the plain version on the card is held
//     to the kernel with a tolerance for that.
//   * Ragged S: rows beyond S load as zeros and are masked invisible, so no
//     padding copies at S = 448 or 256.
// Left for later work: TMA loads, wgmma, overlapping the next tile's loads
// with this tile's math, and more CTAs for dk/dv than the 112 that
// (B, Hkv, S / 64) gives at the VTG shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;         // head dim
constexpr int kB = 64;          // rows of a q tile and of a kv tile
constexpr int kWarps = 4;       // each warp owns 16 rows of the CTA's tile
constexpr int kThreads = kWarps * 32;
constexpr int kLdT = kD + 8;    // bf16 row pitch of the q/k/v/dO tiles
constexpr int kLdS = kB + 4;    // fp32 row pitch of the score tiles
constexpr int kLdP = kB + 8;    // bf16 row pitch of the p/ds tiles
constexpr int kLdAcc = kD + 4;  // fp32 row pitch of the epilogue staging
constexpr float kNegInf = -1e30f;

static_assert(kB == 16 * kWarps, "each warp owns 16 rows");
static_assert(2 * kB * kLdS >= kB * kLdAcc, "the staging fits in the two score tiles");

struct Params {
  const bf16* q;       // (B, S, Hq, 128), contiguous
  const bf16* k;       // (B, S, Hkv, 128)
  const bf16* v;
  const bf16* dout;    // (B, S, Hq, 128), query-mask applied
  const float* lse;    // (B, Hq, S)
  const float* delta;  // (B, Hq, S)
  const int* key_mask; // (B, S), null when dense
  bf16* dq;            // (B, S, Hq, 128)
  bf16* dk;            // (B, S, Hkv, 128)
  bf16* dv;
  int seq_len;
  int num_q_heads;
  int num_kv_heads;
  int group;           // Hq / Hkv
  float scale;
  int causal;
};

// Every array's byte size is a multiple of 32, so each starts 32-byte
// aligned, as WMMA loads and stores require.
struct __align__(128) DqSmem {
  bf16 q[kB * kLdT];
  bf16 dout[kB * kLdT];
  bf16 k[kB * kLdT];
  bf16 v[kB * kLdT];
  float sdp[2 * kB * kLdS];  // S, then dP; the epilogue staging at the end
  bf16 ds[kB * kLdP];
  float lse[kB];
  float delta[kB];
  int kmask[kB];
};

struct __align__(128) DkvSmem {
  bf16 k[kB * kLdT];
  bf16 v[kB * kLdT];
  bf16 q[kB * kLdT];
  bf16 dout[kB * kLdT];
  float sdp[2 * kB * kLdS];  // S^T, then dP^T; the epilogue staging at the end
  bf16 pt[kB * kLdP];
  bf16 dst[kB * kLdP];
  float lse[kB];
  float delta[kB];
  int kmask[kB];
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

// Rows [row0, row0 + 64) of one head into a pitched shared tile, 16 bytes a
// thread; rows at or beyond seq_len become zeros.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int row0, int seq_len) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kB * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq_len) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

// The 16 x 64 product of a warp's 16 rows of `a` (16 x 128, row-major) with
// the 64 rows of `b` read as columns (b^T), stored fp32 into `out`.
__device__ __forceinline__ void rows_times_tile_t(const bf16* a, const bf16* b, float* out) {
  AccFrag acc[kB / 16];
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    ARow af;
    wmma::load_matrix_sync(af, a + kk * 16, kLdT);
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      BCol bf;
      wmma::load_matrix_sync(bf, b + (j * 16) * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    wmma::store_matrix_sync(out + j * 16, acc[j], kLdS, wmma::mem_row_major);
  }
}

// acc (16 x 128, 8 fragments) += a (16 x 64 bf16, pitch kLdP) . b (64 x 128, pitch kLdT)
__device__ __forceinline__ void accumulate_rows(AccFrag (&acc)[kD / 16], const bf16* a,
                                                const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    ARow af;
    wmma::load_matrix_sync(af, a + kk * 16, kLdP);
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      BRow bf;
      wmma::load_matrix_sync(bf, b + (kk * 16) * kLdT + j * 16, kLdT);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// Stage a CTA's 64 x 128 fp32 accumulators (each warp its 16 rows) through
// shared memory and write rows < seq_len, times `mul`, as bf16, 16 bytes a
// thread. `out` points at row 0 of this head; rows are `row_stride` apart.
__device__ __forceinline__ void write_rows(AccFrag (&acc)[kD / 16], float* stage, bf16* out,
                                           long long row_stride, int row0_global, int seq_len,
                                           float mul) {
  const int warp = threadIdx.x / 32;
  __syncthreads();  // every warp is done with the previous contents of `stage`
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    wmma::store_matrix_sync(stage + (warp * 16) * kLdAcc + j * 16, acc[j], kLdAcc,
                            wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kB * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int pos = row0_global + r;
    if (pos >= seq_len) continue;
    const float* src = stage + r * kLdAcc + c;
    uint4 packed;
    __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      out2[t] = __floats2bfloat162_rn(src[2 * t] * mul, src[2 * t + 1] * mul);
    }
    *reinterpret_cast<uint4*>(out + (long long)pos * row_stride + c) = packed;
  }
}

__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = q_tile * kB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int S = p.seq_len;
  const int row0 = warp * 16;
  const long long q_rs = (long long)p.num_q_heads * kD;   // row stride of q, dO, dq
  const long long kv_rs = (long long)p.num_kv_heads * kD;
  const long long q_off = (long long)b * S * q_rs + (long long)h * kD;
  const long long kv_off = (long long)b * S * kv_rs + (long long)kvh * kD;
  const long long stat = ((long long)b * p.num_q_heads + h) * S;

  load_tile(sm.q, p.q + q_off, q_rs, q0, S);
  load_tile(sm.dout, p.dout + q_off, q_rs, q0, S);
  if (tid < kB) {
    const bool in = q0 + tid < S;
    sm.lse[tid] = in ? p.lse[stat + q0 + tid] : 0.f;
    sm.delta[tid] = in ? p.delta[stat + q0 + tid] : 0.f;
  }

  AccFrag dq[kD / 16];
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  float* s = sm.sdp;
  float* dp = sm.sdp + kB * kLdS;
  const int n_kv_tiles = (S + kB - 1) / kB;
  const int n_iter = p.causal ? min(q_tile + 1, n_kv_tiles) : n_kv_tiles;

  for (int kt = 0; kt < n_iter; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile(sm.k, p.k + kv_off, kv_rs, k0, S);
    load_tile(sm.v, p.v + kv_off, kv_rs, k0, S);
    if (tid < kB) {
      const int kpos = k0 + tid;
      sm.kmask[tid] = kpos >= S ? 0 : (p.key_mask ? p.key_mask[(long long)b * S + kpos] : 1);
    }
    __syncthreads();

    rows_times_tile_t(sm.q + row0 * kLdT, sm.k, s + row0 * kLdS);      // S = Q K^T
    rows_times_tile_t(sm.dout + row0 * kLdT, sm.v, dp + row0 * kLdS);  // dP = dO V^T
    __syncwarp();

    // dS for this warp's rows, two columns a lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qpos = q0 + r;
      const float lse = sm.lse[r];
      const float delta = sm.delta[r];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kpos = k0 + c;
        const bool vis = sm.kmask[c] != 0 && (!p.causal || kpos <= qpos);
        const float x = vis ? s[r * kLdS + c] * p.scale : kNegInf;
        const float pr = expf(x - lse);
        const float ds = vis ? pr * (dp[r * kLdS + c] - delta) : 0.f;
        sm.ds[r * kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    accumulate_rows(dq, sm.ds + row0 * kLdP, sm.k);  // dq += dS K
  }

  write_rows(dq, sm.sdp, p.dq + q_off, q_rs, q0, S, p.scale);
}

__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);

  const int kv_tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kv_tile * kB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int S = p.seq_len;
  const int row0 = warp * 16;  // this warp's key rows within the tile
  const long long q_rs = (long long)p.num_q_heads * kD;
  const long long kv_rs = (long long)p.num_kv_heads * kD;
  const long long kv_off = (long long)b * S * kv_rs + (long long)kvh * kD;

  load_tile(sm.k, p.k + kv_off, kv_rs, k0, S);
  load_tile(sm.v, p.v + kv_off, kv_rs, k0, S);
  if (tid < kB) {
    const int kpos = k0 + tid;
    sm.kmask[tid] = kpos >= S ? 0 : (p.key_mask ? p.key_mask[(long long)b * S + kpos] : 1);
  }

  AccFrag dk[kD / 16];
  AccFrag dv[kD / 16];
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  float* st = sm.sdp;
  float* dpt = sm.sdp + kB * kLdS;
  const int n_q_tiles = (S + kB - 1) / kB;
  // causal: q tiles before this kv tile's diagonal see none of its keys;
  // the diagonal tile is partly visible and is masked by position below
  const int qt_start = p.causal ? kv_tile : 0;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const long long q_off = (long long)b * S * q_rs + (long long)h * kD;
    const long long stat = ((long long)b * p.num_q_heads + h) * S;
    for (int qt = qt_start; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // every warp is done with the previous q/dO/p/ds tiles
      load_tile(sm.q, p.q + q_off, q_rs, q0, S);
      load_tile(sm.dout, p.dout + q_off, q_rs, q0, S);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        sm.lse[tid] = in ? p.lse[stat + q0 + tid] : 0.f;
        sm.delta[tid] = in ? p.delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();

      rows_times_tile_t(sm.k + row0 * kLdT, sm.q, st + row0 * kLdS);      // S^T = K Q^T
      rows_times_tile_t(sm.v + row0 * kLdT, sm.dout, dpt + row0 * kLdS);  // dP^T = V dO^T
      __syncwarp();

      // P^T and dS^T for this warp's key rows, two query columns a lane
      for (int rr = 0; rr < 16; ++rr) {
        const int r = row0 + rr;
        const int kpos = k0 + r;
        const bool kvis = sm.kmask[r] != 0;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          const int qpos = q0 + c;
          const bool vis = kvis && qpos < S && (!p.causal || kpos <= qpos);
          const float x = vis ? st[r * kLdS + c] * p.scale : kNegInf;
          const float pr = expf(x - sm.lse[c]);
          const float ds = vis ? pr * (dpt[r * kLdS + c] - sm.delta[c]) : 0.f;
          sm.pt[r * kLdP + c] = __float2bfloat16(pr);
          sm.dst[r * kLdP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      accumulate_rows(dv, sm.pt + row0 * kLdP, sm.dout);  // dv += P^T dO
      accumulate_rows(dk, sm.dst + row0 * kLdP, sm.q);    // dk += dS^T Q
    }
  }

  write_rows(dk, sm.sdp, p.dk + kv_off, kv_rs, k0, S, p.scale);
  write_rows(dv, sm.sdp, p.dv + kv_off, kv_rs, k0, S, 1.f);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* key_mask,
                   int seq_len, int num_q_heads, int num_kv_heads, float scale, int causal) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.key_mask = key_mask;
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.seq_len = seq_len;
  p.num_q_heads = num_q_heads;
  p.num_kv_heads = num_kv_heads;
  p.group = num_q_heads / num_kv_heads;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. Every tensor is
// contiguous: q, dO, dq (B, S, Hq, 128) and k, v, dk, dv (B, S, Hkv, 128) in
// bf16; lse and delta (B, Hq, S) fp32; key_mask (B, S) int32 or null for the
// dense variant. Each launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int blim_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* key_mask,
                             void* dq, int batch, int seq_len, int num_q_heads,
                             int num_kv_heads, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, key_mask, seq_len, num_q_heads,
                         num_kv_heads, scale, causal);
  p.dq = static_cast<bf16*>(dq);
  const dim3 grid((seq_len + kB - 1) / kB, num_q_heads, batch);
  const size_t smem = sizeof(DqSmem);
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int blim_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, const int* key_mask,
                              void* dk, void* dv, int batch, int seq_len, int num_q_heads,
                              int num_kv_heads, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, key_mask, seq_len, num_q_heads,
                         num_kv_heads, scale, causal);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const dim3 grid((seq_len + kB - 1) / kB, num_kv_heads, batch);
  const size_t smem = sizeof(DkvSmem);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a CTA uses, in bytes: flash_dkv's if `dkv`, else flash_dq's.
extern "C" int blim_flash_bwd_smem_bytes(int dkv) {
  return dkv ? (int)sizeof(DkvSmem) : (int)sizeof(DqSmem);
}

extern "C" const char* blim_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
