// Flash-attention backward at head dim 64, dense and non-causal, for Hopper
// (sm_90a): the UMT ViT-L tower's gradient. One fused kernel computes dq,
// dk and dv (flash_bwd_dense), between two small passes: a preprocess
// (delta = rowsum(dO * O), and the fp32 dQ accumulator zeroed) and a
// convert (the accumulator scaled and cast to bf16 dq). bf16 in, fp32
// accumulate, bf16 out.
//
// Replaces: blim_tpu/kernels/flash_attention.py `_dq_kernel` (:195-249,
// pl.pallas_call :361) and `_dkv_kernel` (:252-331, pl.pallas_call :391) in
// their dense mode (:357-360, :378-383), run through `_vjp_bwd` (:442-446)
// for every attention of the tower when it is differentiated
// (umt_vit.encode_clips under autograd), 16 q heads on 16 K/V heads. The
// TPU computes dq and dk/dv in two kernels, each recomputing S = Q K^T,
// dP = dO V^T and P for every (query, key) pair; the preprocess replaces
// the two XLA ops ahead of them (dO * O summed over d), the convert the
// cast of dq.
//
// Math, the same as the TPU kernels and the plain version
// (kernels/flash_attention.py::reference_attention_backward): for a pair,
//   p  = exp(scale q.k - lse);   dp = dO.v;   ds = p (dp - delta);
//   dq = scale sum_k ds k;   dk = scale sum_q ds q;   dv = sum_q p dO,
// with p = 0 where the query or the key lies beyond S. P and dS go to bf16
// before their products, as in flash_bwd.cu.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). At
// 8 clips of (3136, 16, 64) the five products (S, dP, dV, dK, dQ) are
// 10 d flops a pair, 8.06e11 flops or 0.815 ms, against 363 MB of bytes
// (q, k, v, dO, dq, dk, dv once, lse and delta), 0.108 ms: bound by
// operations. At d = 64 a pair's exponential is not cheap beside its
// products: 1.26e9 of them, ~0.33 ms on the SFUs, which the design keeps
// to one a pair. The products are 64 x 64 tiles, short enough that their
// latency and the waits between them, not the tensor cores' rate, set the
// pace; scripts/ablate_bwd_dense_torch.py times the kernel with the dQ
// product, the dQ reduction, the exponentials or the barriers between the
// consumers taken out.
//
// Design (FlashAttention-3's backward shape, hopper.cuh's machinery):
//   * A CTA owns 128 kv rows of one (clip, head): 25 CTAs a head at
//     S = 3136, side by side in the grid (3200 CTAs at 8 clips), so the
//     CTAs that stream one head's Q and dO share them in L2, and the head's
//     dQ accumulator (0.8 MB) stays there while they add into it.
//   * Three warpgroups: two consumers of 64 kv rows each, and a producer
//     whose first warp issues the TMA loads (K and V once; 64-row Q and dO
//     tiles with their lse and delta through a 3-stage mbarrier ring);
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240).
//   * Per q tile, each consumer computes S^T = K Q^T and dP^T = V dO^T
//     (both operands in shared memory) as two wgmma groups, and P^T =
//     exp2(fma(S^T, scale log2 e, -lse log2 e)) once, while dP^T is still
//     in flight; then dV += P^T dO from registers while it computes dS^T =
//     P^T (dP^T - delta), and dK += dS^T Q, as flash_bwd.cu's flash_dkv.
//   * dS^T also goes to shared memory as bf16, [kv][q], 128B-swizzled, in
//     one of two buffers (even and odd q tiles). The dQ tile (64 q x 64 d,
//     fp32) = dS K over the CTA's 128 kv rows is one wgmma chain with both
//     operands MN-major in shared memory. Consumer 0 owns the even tiles'
//     dQ, consumer 1 the odd ones': the owner waits on a named barrier for
//     the other's rows of dS^T, the other only arrives, and waits before
//     it overwrites the buffer two tiles later. The consumers are not held
//     in step, so one's exponentials can run beside the other's products.
//   * dQ across kv tiles: the owner stages its dQ tile in shared memory
//     (16 KB) and one thread adds it into the fp32 accumulator in global
//     memory with one bulk reduction (cp.reduce.async.bulk .add.f32, done
//     in L2). The accumulator is (B, H, ceil(S / 64), 16 KB tiles), a tile
//     laid out as the staging is: float4 (j, t) = thread t's accumulator
//     registers 4j .. 4j + 3 (see dq_acc_offset below), so the staging
//     stores are conflict-free. 16 KB a (kv tile, q tile) pair: 2.5 GB of
//     fp32 adds at 8 clips, in L2.
//   * The ragged edges: S = 3136 leaves half a 128-row kv tile, S = 784
//     (the image tiles) a quarter of a 64-row q tile. Rows beyond S come
//     back from TMA as zeros; their pairs get p = 0 (a zero q row against
//     lse = 0 would otherwise give p = 1). dk, dv and dq are written for
//     rows < S only; the accumulator's padded rows take zeros.
//   * Order of the sums: the bulk reductions of a q tile's 25 kv tiles land
//     in L2 in the order the CTAs reach them, which changes from run to
//     run, so dq can differ in its last bits between runs (fp32 sums of
//     bf16 products, ~1e-6 relative, far inside chip_smoke.py's GRAD_TOL of
//     3e-2 x max|plain|; the bf16 cast usually absorbs it). dk and dv are
//     summed in registers in a fixed order and repeat bit for bit.

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;      // consumer warpgroups, 64 kv rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kD = 64;             // head dim: one 128-byte swizzled row
constexpr int kKvRows = 128;       // kv rows a CTA
constexpr int kQRows = 64;         // q rows a streamed tile
constexpr int kStages = 3;         // the Q / dO ring
constexpr int kTileFloats = kQRows * kD;   // one dQ tile of the accumulator
// setmaxnreg's split of the 168 registers a thread gets at entry: the
// consumers hold dK and dV (64 fp32), S^T and dP^T (64),
// P^T and dS^T in bf16 (32) and a dQ tile (32), kept across the loop so
// that no register of an asynchronous product is written in a branch.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert((168 - kProducerRegs) * 128 == (kConsumerRegs - 168) * 256, "register split");
static_assert(kKvRows == 64 * kConsumers, "each consumer warpgroup owns 64 kv rows");

// Named barriers (0 is __syncthreads): dS^T buffer b complete, buffer b
// read by its owner's dQ product, and each consumer's staging written.
constexpr int kBarDsFull = 1;      // + b
constexpr int kBarDsFree = 3;      // + b
constexpr int kBarStage = 5;       // + consumer

struct Params {
  const float* lse;      // (B, H, S), contiguous
  const float* delta;    // (B, H, S), contiguous
  float* dq_acc;         // (B, H, ceil(S / 64), kTileFloats)
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int batch;
  int heads;
  int seq_len;
  float scale;
};

// Each swizzled array is a multiple of 1024 bytes from a 1024-byte aligned
// start, as the 128B swizzle requires.
struct Smem {
  bf16 k[kKvRows * 64];                 // the CTA's K and V rows, [row][d]
  bf16 v[kKvRows * 64];
  bf16 q[kStages][kQRows * 64];         // the ring of Q and dO tiles, [row][d]
  bf16 dout[kStages][kQRows * 64];
  bf16 ds[2][kKvRows * kQRows];         // dS^T of the even and odd q tiles, [kv][q]
  float dq[kConsumers][kTileFloats];    // each consumer's dQ tile on its way out
  float lse2[kStages][kQRows];          // lse * log2(e) of the tile's q rows
  float delta[kStages][kQRows];
  uint64_t full_kv;                     // K and V
  uint64_t full[kStages];               // Q, dO, lse2, delta
  uint64_t empty[kStages];
};

constexpr int smem_bytes() { return (int)sizeof(Smem) + 1024; }   // + alignment slack

__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<Smem*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// The byte offset of (row, col) in a [row][64 bf16] 128B-swizzled tile.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Where element (row r, column c) of a dQ tile lies among its floats: the
// staging's order, float4 (j, t) holding accumulator registers 4j .. 4j + 3
// of consumer thread t (rows 16 (t / 32) + (t % 32) / 4 and that + 8,
// columns 8 j + 2 (t % 4) + {0, 1}).
__device__ __forceinline__ int dq_acc_offset(int r, int c) {
  const int t = 32 * (r / 16) + 4 * (r % 8) + (c % 8) / 2;
  return ((c / 8) * 128 + t) * 4 + 2 * ((r % 16) / 8) + (c % 2);
}

// ---- the fused kernel --------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dense_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = aligned_smem(smem_raw);

  const int S = p.seq_len;
  const int n_kv = (S + kKvRows - 1) / kKvRows;
  const int n_q = (S + kQRows - 1) / kQRows;
  const int kv_tile = blockIdx.x % n_kv;     // a (clip, head)'s kv tiles side by side
  const int bh = blockIdx.x / n_kv;
  const int h = bh % p.heads;
  const int b = bh / p.heads;
  const int k0 = kv_tile * kKvRows;
  const int tid = threadIdx.x;
  // broadcast from lane 0, so the compiler knows it is the same across the
  // warp: branches on it (and on a consumer's ownership of a tile's dQ) are
  // then not divergent, and ptxas need not serialize the wgmma inside them
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(&sm.full_kv, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
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
      if (lane == 0) {
        mbar_expect_tx(&sm.full_kv, 2 * kKvRows * kD * 2);
        tma_load(sm.k, &tm_k, &sm.full_kv, 0, k0, h, b);
        tma_load(sm.v, &tm_v, &sm.full_kv, 0, k0, h, b);
      }
      const long long stat = ((long long)b * p.heads + h) * S;
      for (int it = 0; it < n_q; ++it) {
        const int st = it % kStages;
        const int q0 = it * kQRows;
        float lse2[kQRows / 32], delta[kQRows / 32];   // read before the wait, so its latency overlaps it
#pragma unroll
        for (int i = 0; i < kQRows / 32; ++i) {
          const int r = q0 + lane + 32 * i;
          lse2[i] = r < S ? p.lse[stat + r] * kLog2e : 0.f;
          delta[i] = r < S ? p.delta[stat + r] : 0.f;
        }
        if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
#pragma unroll
        for (int i = 0; i < kQRows / 32; ++i) {
          sm.lse2[st][lane + 32 * i] = lse2[i];
          sm.delta[st][lane + 32 * i] = delta[i];
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&sm.full[st], 2 * kQRows * kD * 2);   // also releases lse2, delta
          tma_load(sm.q[st], &tm_q, &sm.full[st], 0, q0, h, b);
          tma_load(sm.dout[st], &tm_do, &sm.full[st], 0, q0, h, b);
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumers: 64 kv rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int t = tid % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row0 = 64 * wg + 16 * (t / 32) + lane / 4;   // this thread's two kv rows
  const int row1 = row0 + 8;
  const bool kvis0 = k0 + row0 < S;
  const bool kvis1 = k0 + row1 < S;
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t k_smem = smem_u32(sm.k);
  float* acc = p.dq_acc + ((long long)b * p.heads + h) * n_q * kTileFloats;

  float dk[32], dv[32], dq[32];   // dq: the owner's dQ tile, overwritten by each product
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = dq[i] = 0.f;

  const uint32_t k_rows = k_smem + wg * 64 * 128;           // this warpgroup's K and V rows
  const uint32_t v_rows = smem_u32(sm.v) + wg * 64 * 128;
  mbar_wait(&sm.full_kv, 0);

  for (int it = 0; it < n_q; ++it) {
    const int st = it % kStages;
    const int parity = (it / kStages) & 1;
    const int q0 = it * kQRows;
    const int buf = it & 1;                 // consumer `buf` owns this tile's dQ
    const bool owner = wg == buf;
    const uint32_t q_smem = smem_u32(sm.q[st]);
    const uint32_t do_smem = smem_u32(sm.dout[st]);

    // S^T = K Q^T and dP^T = V dO^T (64 kv rows x the tile's 64 q rows) in
    // two groups, so that P^T's exponentials run while dP^T is in flight
    float s[32], dp[32];
    mbar_wait(&sm.full[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(s, desc_kmajor(k_rows, kk), desc_kmajor(q_smem, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(dp, desc_kmajor(v_rows, kk), desc_kmajor(do_smem, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T, lse per column (a q row), kept in s in fp32; a pair whose q or
    // kv row lies beyond S gets p = 0
    const bool ragged = q0 + kQRows > S || k0 + kKvRows > S;
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[st][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
      }
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool qin = q0 + c + e < S;
          if (!(kvis0 && qin)) s[4 * j + e] = 0.f;
          if (!(kvis1 && qin)) s[4 * j + 2 + e] = 0.f;
        }
      }
      pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }

    // dV += P^T dO while dP^T completes
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_rs_n64(dv, a, desc_mnmajor(do_smem, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta), delta per column; dK += dS^T Q
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][8 * j + 2 * quad]);
      da[2 * j] = pack_bf16(s[4 * j] * (dp[4 * j] - dl.x), s[4 * j + 1] * (dp[4 * j + 1] - dl.y));
      da[2 * j + 1] =
          pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - dl.x), s[4 * j + 3] * (dp[4 * j + 3] - dl.y));
    }
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
      wgmma_rs_n64(dk, a, desc_mnmajor(q_smem, kk));
    }
    wgmma_commit();

    // this warpgroup's rows of dS^T into the tile's buffer, once the
    // owner's product of two tiles ago has read it
    if (!owner && it >= 2) named_bar_sync(kBarDsFree + buf, 256);
    {
      uint8_t* ds = reinterpret_cast<uint8_t*>(sm.ds[buf]);
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ds + swizzled(row0, 8 * j + 2 * quad)) = da[2 * j];
        *reinterpret_cast<uint32_t*>(ds + swizzled(row1, 8 * j + 2 * quad)) = da[2 * j + 1];
      }
    }
    fence_proxy_async();

    // the owner: dQ tile = dS K over the CTA's 128 kv rows, once the other
    // warpgroup's rows of dS^T are in (and its staging is free: the bulk
    // reduction it issued two tiles ago has read it)
    if (owner) {
      if (t == 0) bulk_wait_read<0>();
      __syncwarp();
      named_bar_sync(kBarDsFull + buf, 256);
      const uint32_t ds_smem = smem_u32(sm.ds[buf]);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvRows / 16; ++kk) {
        wgmma_ss_n64_mnmajor(dq, desc_mnmajor(ds_smem, kk), desc_mnmajor(k_smem, kk), kk > 0);
      }
      wgmma_commit();
    } else {
      named_bar_arrive(kBarDsFull + buf, 256);
    }
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    __syncwarp();
    if (owner) {
      fence_regs(dq);
      if (it + 2 < n_q) named_bar_arrive(kBarDsFree + buf, 256);
      float* stage = sm.dq[wg];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<float4*>(stage + (j * 128 + t) * 4) =
            make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_proxy_async();
      named_bar_sync(kBarStage + wg, 128);
      if (t == 0) {
        bulk_reduce_add_f32(acc + (long long)it * kTileFloats, stage, kTileFloats * 4);
        bulk_commit();
      }
      __syncwarp();
    }
  }
  if (t == 0) bulk_wait_all();

  // epilogue: dK (scaled) and dV as bf16 pairs from registers, rows < S
  bf16* dk_out = p.dk + b * p.dk_sb + h * p.dk_sh;
  bf16* dv_out = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (kvis0) {
      *reinterpret_cast<uint32_t*>(dk_out + (k0 + row0) * p.dk_ss + col) =
          pack_bf16(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + (k0 + row0) * p.dv_ss + col) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (kvis1) {
      *reinterpret_cast<uint32_t*>(dk_out + (k0 + row1) * p.dk_ss + col) =
          pack_bf16(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + (k0 + row1) * p.dv_ss + col) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// ---- the preprocess and convert passes ----------------------------------------

constexpr int kPassThreads = 256;  // 8 threads a (clip, position, head) row of 64

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in fp32 (8 bf16 pairs a
// thread, then a sum over the row's 8 threads), and every float of the dQ
// accumulator set to 0.
__global__ void __launch_bounds__(kPassThreads)
flash_bwd_dense_prep_kernel(const bf16* out, const bf16* dout, float* delta, float* dq_acc,
                            int batch, int seq_len, int heads, long long o_sb, long long o_ss,
                            long long o_sh, long long g_sb, long long g_ss, long long g_sh,
                            long long acc_vec4) {
  const long long rows = (long long)batch * seq_len * heads;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned group = 0xFFu << (threadIdx.x & 24);   // the 8 lanes of this thread's row
  for (long long i = first; i < rows * 8; i += stride) {
    const long long row = i >> 3;
    const int part = (int)(i & 7);
    const int h = (int)(row % heads);
    const long long bs = row / heads;
    const int s = (int)(bs % seq_len);
    const long long b = bs / seq_len;
    const uint4 o = *reinterpret_cast<const uint4*>(out + b * o_sb + s * o_ss + h * o_sh + 8 * part);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + b * g_sb + s * g_ss + h * g_sh + 8 * part);
    const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
    const uint32_t gw[4] = {g.x, g.y, g.z, g.w};
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
      sum = fmaf(gf.x, of.x, sum);
      sum = fmaf(gf.y, of.y, sum);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(group, sum, off, 8);
    if (part == 0) delta[(b * heads + h) * seq_len + s] = sum;
  }
  float4* acc = reinterpret_cast<float4*>(dq_acc);
  for (long long i = first; i < acc_vec4; i += stride) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq[b, s, h, :] = bf16(scale * the accumulator's row), rows < S.
__global__ void __launch_bounds__(kPassThreads)
flash_bwd_dense_convert_kernel(const float* dq_acc, bf16* dq, int batch, int seq_len, int heads,
                               long long sb, long long ss, long long sh, float scale) {
  const long long rows = (long long)batch * seq_len * heads;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int n_q = (seq_len + kQRows - 1) / kQRows;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < rows * 8; i += stride) {
    const long long row = i >> 3;
    const int part = (int)(i & 7);
    const int h = (int)(row % heads);
    const long long bs = row / heads;
    const int s = (int)(bs % seq_len);
    const long long b = bs / seq_len;
    const float* tile = dq_acc + ((b * heads + h) * n_q + s / kQRows) * kTileFloats;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // columns 8 part + 2 e, + 1: one float2 of the tile
      const float2 x = *reinterpret_cast<const float2*>(tile + dq_acc_offset(s % kQRows, 8 * part + 2 * e));
      w[e] = pack_bf16(x.x * scale, x.y * scale);
    }
    *reinterpret_cast<uint4*>(dq + b * sb + s * ss + h * sh + 8 * part) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Floats of the dQ accumulator: a 64 x 64 tile a (clip, head, q tile).
long long acc_floats(int batch, int seq_len, int heads) {
  return (long long)batch * heads * ((seq_len + kQRows - 1) / kQRows) * kTileFloats;
}

int pass_blocks(long long threads) {
  const long long blocks = (threads + kPassThreads - 1) / kPassThreads;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. q, dO, k, v, O are
// bf16 (B, S, H, 64) with a contiguous last dim, 16-byte aligned, other
// strides (in elements) multiples of 8 (strided views such as the ViT's
// slices of its packed qkv are read in place); lse and delta fp32 (B, H, S)
// contiguous; dq_acc fp32 (B, H, ceil(S / 64), 4096), contiguous; dq,
// dk, dv bf16 with the strides given and a contiguous last dim. Each
// launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for operands that TMA cannot describe.

extern "C" int blim_flash_bwd_dense_prep(const void* out, const void* dout, float* delta,
                                         float* dq_acc, int batch, int seq_len, int heads,
                                         long long o_sb, long long o_ss, long long o_sh,
                                         long long do_sb, long long do_ss, long long do_sh,
                                         void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  const long long vec4 = acc_floats(batch, seq_len, heads) / 4;
  const long long rows8 = (long long)batch * seq_len * heads * 8;
  flash_bwd_dense_prep_kernel<<<pass_blocks(rows8 > vec4 ? rows8 : vec4), kPassThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, dq_acc, batch,
      seq_len, heads, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, vec4);
  return (int)cudaGetLastError();
}

extern "C" int blim_flash_bwd_dense(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, float* dq_acc, void* dk,
                                    void* dv, int batch, int seq_len, int heads,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long do_sb, long long do_ss, long long do_sh,
                                    long long dk_sb, long long dk_ss, long long dk_sh,
                                    long long dv_sb, long long dv_ss, long long dv_sh,
                                    float scale, void* stream) {
  CUtensorMap maps[4];
  if (batch <= 0 || seq_len <= 0 || heads <= 0 ||
      !make_map(&maps[0], q, kD, seq_len, heads, batch, q_ss, q_sh, q_sb, kQRows) ||
      !make_map(&maps[1], dout, kD, seq_len, heads, batch, do_ss, do_sh, do_sb, kQRows) ||
      !make_map(&maps[2], k, kD, seq_len, heads, batch, k_ss, k_sh, k_sb, kKvRows) ||
      !make_map(&maps[3], v, kD, seq_len, heads, batch, v_ss, v_sh, v_sb, kKvRows)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.dq_acc = dq_acc;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.batch = batch;
  p.heads = heads;
  p.seq_len = seq_len;
  p.scale = scale;
  constexpr int smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = ((seq_len + kKvRows - 1) / kKvRows) * heads * batch;
  flash_bwd_dense_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

extern "C" int blim_flash_bwd_dense_convert(const float* dq_acc, void* dq, int batch, int seq_len,
                                            int heads, long long dq_sb, long long dq_ss,
                                            long long dq_sh, float scale, void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  flash_bwd_dense_convert_kernel<<<pass_blocks((long long)batch * seq_len * heads * 8),
                                   kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dq_acc, static_cast<bf16*>(dq), batch, seq_len, heads, dq_sb, dq_ss, dq_sh, scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the fused kernel's CTA, in bytes.
extern "C" int blim_flash_bwd_dense_smem_bytes() { return smem_bytes(); }

extern "C" const char* blim_flash_bwd_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
