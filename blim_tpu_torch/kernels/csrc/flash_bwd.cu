// Flash-attention backward for Hopper (sm_90a): dq (flash_dq), and dk/dv
// (flash_dkv), for the causal or full, masked or dense, GQA attention of
// flash_fwd.cu at head dim 128. bf16 in, fp32 accumulate, bf16 out.
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
// An invisible pair gets p = 0 here, where the TPU kernel gets
// exp(-1e30 - lse): the same except in a row whose keys are all invisible
// (TVG's left pads), where that is 1/n but dO is 0 (the query mask zeroes
// such rows on every path), so dv is the same. Computing it instead would
// take exp2 of an FMA between two values near -1.4e30 whose fp32 rounding
// errors (~1e23) do not cancel: inf, then inf x 0 = NaN in dv.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). At
// the train step's VTG shape (B = 4, S = 448, Hq = 28, Hkv = 4, d = 128,
// causal, caption-length right pads) flash_dq reads q, dO (12.85 MB each),
// k, v (1.84 MB each), lse and delta (0.40 MB) and writes dq (12.85 MB):
// ~42.6 MB or ~12.7 us, against 3 products of 2 d flops per visible pair,
// ~7.1 GFLOP or ~7.1 us. flash_dkv reads q, dO, k, v, lse, delta and writes
// dk, dv: ~33.4 MB (~10.0 us) against 4 products, ~9.4 GFLOP (~9.5 us).
// Both are bound by bytes, within 1.8x and 1.05x of their flop floors.
//
// Design (FlashAttention-3's shape, the forward's machinery in hopper.cuh):
// three warpgroups a CTA, two consumers of 64 rows each and a producer whose
// first warp issues every TMA load into an mbarrier ring; setmaxnreg moves
// registers from the producer (40; flash_dkv 24) to the consumers (232;
// flash_dkv 240). Tiles are 128B-swizzled 64-column halves. Every product
// is wgmma; the fp32 tiles S, dP (or their transposes) stay in registers,
// and P and dS go to bf16 in registers, already in the A-operand layout of
// the product that follows (the forward's P.V step: m64n64k16, A from
// registers, B MN-major from shared memory, once per 64-column half).
//   * flash_dq: a CTA owns 128 q rows of one (batch, q head); Q, dO once,
//     then K and V tiles of 64 rows stream through a 2-stage ring up to the
//     causal diagonal, with the key-mask bits beside them. S = Q K^T and
//     dP = dO V^T (m64n64k16, both operands K-major in shared memory),
//     P = exp2(fma(S, scale log2 e, -lse log2 e)), dS = P (dP - delta) to
//     bf16, dQ += dS K. dQ (64 fp32 a thread) is scaled and written as bf16
//     pairs from registers. Grid ceil(S / 128) x Hq x B = 448 CTAs at VTG,
//     heaviest q tiles first; critical path 7 kv tiles of 64 (q tile 3).
//   * flash_dkv: a CTA owns 128 kv rows of one (batch, kv head) and one q
//     head of its GQA group: the group's 7 q heads are 7 CTAs of one
//     thread-block cluster (cudaLaunchKernelEx, cluster 7 x 1 x 1; in
//     general the largest divisor of the group <= 8, each CTA then walking
//     group / cluster heads). K and V load once; Q and dO tiles of 64 rows
//     with their lse and delta stream through a 2-stage ring from the causal
//     diagonal on. S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers
//     with lse and delta per column, dV += P^T dO and dK += dS^T Q; dK and dV
//     are 64 + 64 fp32 registers a thread. Grid (7, ceil(S / 128) x Hkv x B)
//     = 448 CTAs at VTG in 64 clusters, heaviest kv tiles first; critical
//     path 7 q tiles of 64 (kv tile 0).
//   * The group's sum: each CTA stores its partial dK and dV (fp32, 128 x
//     128 each) over its own spent tiles in shared memory; after a cluster
//     barrier CTA r sums rows' share r of the 7 partials in rank order
//     through distributed shared memory (mapa + ld.shared::cluster), scales
//     dK and writes bf16. Deterministic like the TPU design: no atomics, no
//     extra HBM bytes.
//   * Causal: tiles wholly past the diagonal are skipped; the diagonal
//     tiles, the ragged edge (rows beyond S come back from TMA as zeros and
//     are invisible) and, with a key mask, every tile are masked.

#include "hopper.cuh"

namespace {

constexpr int kD = 128;            // head dim
constexpr int kHalves = kD / 64;   // 64-column (128 B) halves of a tile
constexpr int kConsumers = 2;      // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
// setmaxnreg's split of the 168 registers a thread gets at entry:
// (168 - 40) x 128 = (232 - 168) x 256 for flash_dq; flash_dkv's consumers
// hold dK and dV (128 fp32) besides S^T and dP^T (64) and take 240.
constexpr int kDqProducerRegs = 40;
constexpr int kDqConsumerRegs = 232;
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;
static_assert((168 - kDkvProducerRegs) * 128 == (kDkvConsumerRegs - 168) * 256, "register split");

constexpr int kDqRows = 128;       // flash_dq: q rows a CTA
constexpr int kDqKv = 64;          //           kv rows a streamed tile
constexpr int kDqStages = 2;
constexpr int kDkvRows = 128;      // flash_dkv: kv rows a CTA
constexpr int kDkvQ = 64;          //            q rows a streamed tile
constexpr int kDkvStages = 2;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kPitch = kD + 8;     // fp32 row pitch of the partials: float2 stores conflict-free

static_assert(kDqRows == 64 * kConsumers && kDkvRows == 64 * kConsumers,
              "each consumer warpgroup owns 64 rows");

struct Params {
  const float* lse;      // (B, Hq, S), contiguous
  const float* delta;    // (B, Hq, S), contiguous
  const int* key_mask;   // (B, S), row stride mask_sb; null when dense
  bf16* out0;            // dq, or dk
  bf16* out1;            // dv
  long long o0_sb, o0_ss, o0_sh;
  long long o1_sb, o1_ss, o1_sh;
  long long mask_sb;
  int batch;
  int num_q_heads;
  int num_kv_heads;
  int seq_len;
  int group;             // Hq / Hkv
  int cluster;           // flash_dkv: CTAs (q heads) a cluster
  float scale;
  int causal;
};

// Each tile array is a multiple of 1024 bytes and the structs start on a
// 1024-byte boundary, as the 128B swizzle requires.
struct DqSmem {
  bf16 q[kHalves][kDqRows * 64];
  bf16 dout[kHalves][kDqRows * 64];
  bf16 k[kDqStages][kHalves][kDqKv * 64];
  bf16 v[kDqStages][kHalves][kDqKv * 64];
  uint32_t kbits[kDqStages][kDqKv / 32];   // key mask bits per tile
  uint64_t full_q;                         // Q and dO
  uint64_t full_k[kDqStages];
  uint64_t full_v[kDqStages];
  uint64_t empty[kDqStages];
};

struct DkvTiles {
  bf16 k[kHalves][kDkvRows * 64];
  bf16 v[kHalves][kDkvRows * 64];
  bf16 q[kDkvStages][kHalves][kDkvQ * 64];
  bf16 dout[kDkvStages][kHalves][kDkvQ * 64];
};
struct DkvPartials {                       // this CTA's share of the group's sum
  float dk[kDkvRows * kPitch];
  float dv[kDkvRows * kPitch];
};
struct DkvSmem {
  union {
    DkvTiles t;                            // the main loop's tiles
    DkvPartials part;                      // after it, over the spent tiles
  };
  float lse2[kDkvStages][kDkvQ];           // lse * log2(e) of the tile's q rows
  float delta[kDkvStages][kDkvQ];
  uint64_t full_kv;
  uint64_t full[kDkvStages];               // Q, dO, lse, delta
  uint64_t empty[kDkvStages];
};

constexpr int kDqSmemBytes = (int)sizeof(DqSmem) + 1024;    // + alignment slack
constexpr int kDkvSmemBytes = (int)sizeof(DkvSmem) + 1024;

template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<T*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// ---- flash_dq --------------------------------------------------------------

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const Params p) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);

  const int S = p.seq_len;
  const int n_q = (S + kDqRows - 1) / kDqRows;
  const int heads_batch = p.num_q_heads * p.batch;
  int q_tile, bh;
  if (p.causal) {                      // heaviest q tiles first
    q_tile = n_q - 1 - (int)(blockIdx.x / heads_batch);
    bh = blockIdx.x % heads_batch;
  } else {                             // a (batch, head)'s q tiles side by side
    q_tile = blockIdx.x % n_q;
    bh = blockIdx.x / n_q;
  }
  const int h = bh % p.num_q_heads;
  const int b = bh / p.num_q_heads;
  const int q0 = q_tile * kDqRows;
  const int n_kv = (S + kDqKv - 1) / kDqKv;
  const int n_iter = p.causal ? min(2 * q_tile + 2, n_kv) : n_kv;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&sm.full_k[st], 1);
      mbar_init(&sm.full_v[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp issues every load; the other three idle out
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kDqProducerRegs));
    if (tid / 32 == kConsumers * 4) {
      const int lane = tid % 32;
      const int kvh = h / p.group;
      if (lane == 0) {
        mbar_expect_tx(&sm.full_q, 2 * kDqRows * kD * 2);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(sm.q[hf], &tm_q, &sm.full_q, 64 * hf, q0, h, b);
          tma_load(sm.dout[hf], &tm_do, &sm.full_q, 64 * hf, q0, h, b);
        }
      }
      for (int kt = 0; kt < n_iter; ++kt) {
        const int st = kt % kDqStages;
        const int k0 = kt * kDqKv;
        uint32_t words[kDqKv / 32];   // read before the wait, so its latency overlaps it
        if (kMasked) {
#pragma unroll
          for (int w = 0; w < kDqKv / 32; ++w) {
            const int kpos = k0 + 32 * w + lane;
            words[w] = __ballot_sync(0xffffffffu,
                                     kpos < S && p.key_mask[b * p.mask_sb + kpos] != 0);
          }
        }
        if (kt >= kDqStages) mbar_wait(&sm.empty[st], (kt / kDqStages - 1) & 1);
        if (lane == 0) {
          if (kMasked) {
#pragma unroll
            for (int w = 0; w < kDqKv / 32; ++w) sm.kbits[st][w] = words[w];
          }
          mbar_expect_tx(&sm.full_k[st], kDqKv * kD * 2);   // also releases the mask bits
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(sm.k[st][hf], &tm_k, &sm.full_k[st], 64 * hf, k0, kvh, b);
          mbar_expect_tx(&sm.full_v[st], kDqKv * kD * 2);
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(sm.v[st][hf], &tm_v, &sm.full_v[st], 64 * hf, k0, kvh, b);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 q rows each; S, dP, dS and dQ in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kDqConsumerRegs));
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int qpos0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // this thread's two rows
    const int qpos1 = qpos0 + 8;
    const float scale_log2 = p.scale * kLog2e;
    const long long stat = ((long long)b * p.num_q_heads + h) * S;
    const float lse0 = qpos0 < S ? p.lse[stat + qpos0] * kLog2e : 0.f;
    const float lse1 = qpos1 < S ? p.lse[stat + qpos1] * kLog2e : 0.f;
    const float delta0 = qpos0 < S ? p.delta[stat + qpos0] : 0.f;
    const float delta1 = qpos1 < S ? p.delta[stat + qpos1] : 0.f;
    const uint32_t q_base = smem_u32(sm.q[0]) + wg * 64 * 128;
    const uint32_t do_base = smem_u32(sm.dout[0]) + wg * 64 * 128;
    constexpr uint32_t kHalfQ = kDqRows * 128;   // bytes between the two halves of Q, dO

    float dq[kHalves][32];
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[hf][i] = 0.f;
    }

    mbar_wait(&sm.full_q, 0);
    for (int kt = 0; kt < n_iter; ++kt) {
      const int st = kt % kDqStages;
      const int parity = (kt / kDqStages) & 1;
      const int k0 = kt * kDqKv;

      // S = Q K^T, dP = dO V^T
      float s[32], dp[32];
      mbar_wait(&sm.full_k[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(s, desc_kmajor(q_base + (kk / 4) * kHalfQ, kk),
                     desc_kmajor(smem_u32(sm.k[st][kk / 4]), kk), kk > 0);
      }
      mbar_wait(&sm.full_v[st], parity);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc_kmajor(do_base + (kk / 4) * kHalfQ, kk),
                     desc_kmajor(smem_u32(sm.v[st][kk / 4]), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P and dS; invisible pairs (key bits, the ragged edge, the causal
      // diagonal) get p = 0
      const bool masked = kMasked || (p.causal && k0 + kDqKv > q0) || k0 + kDqKv > S;
      uint32_t words[kDqKv / 32] = {~0u, ~0u};
      if (kMasked) {
        words[0] = sm.kbits[st][0];
        words[1] = sm.kbits[st][1];
      }
      uint32_t da[16];   // dS in bf16 pairs: the A fragments of k-step kk are da[4kk .. 4kk+3]
#pragma unroll
      for (int j = 0; j < kDqKv / 8; ++j) {
        float d0[2], d1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse0));
          float p1 = fast_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -lse1));
          if (masked) {
            const int c = 8 * j + 2 * quad + e;
            const int kpos = k0 + c;
            const bool vis = kpos < S && ((words[j / 4] >> (c % 32)) & 1u);
            if (!(vis && (!p.causal || kpos <= qpos0))) p0 = 0.f;
            if (!(vis && (!p.causal || kpos <= qpos1))) p1 = 0.f;
          }
          d0[e] = p0 * (dp[4 * j + e] - delta0);
          d1[e] = p1 * (dp[4 * j + 2 + e] - delta1);
        }
        da[2 * j] = pack_bf16(d0[0], d0[1]);
        da[2 * j + 1] = pack_bf16(d1[0], d1[1]);
      }

      // dQ += dS K
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(dq[hf]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKv / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          wgmma_rs_n64(dq[hf], a, desc_mnmajor(smem_u32(sm.k[st][hf]), kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(dq[hf]);
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }

    // epilogue: scale, bf16 pairs from registers, rows < S
    bf16* out = p.out0 + b * p.o0_sb + h * p.o0_sh;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * quad;
        if (qpos0 < S) {
          *reinterpret_cast<uint32_t*>(out + qpos0 * p.o0_ss + col) =
              pack_bf16(dq[hf][4 * j] * p.scale, dq[hf][4 * j + 1] * p.scale);
        }
        if (qpos1 < S) {
          *reinterpret_cast<uint32_t*>(out + qpos1 * p.o0_ss + col) =
              pack_bf16(dq[hf][4 * j + 2] * p.scale, dq[hf][4 * j + 3] * p.scale);
        }
      }
    }
  }
}

// ---- flash_dkv -------------------------------------------------------------

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const Params p) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);

  const int S = p.seq_len;
  const int n_q = (S + kDkvQ - 1) / kDkvQ;
  const int rank = blockIdx.x;         // the cluster spans grid x: its rank
  const int kv_batch = p.num_kv_heads * p.batch;
  const int kv_tile = blockIdx.y / kv_batch;   // heaviest (lowest) kv tiles first
  const int kvh = blockIdx.y % kv_batch % p.num_kv_heads;
  const int b = blockIdx.y % kv_batch / p.num_kv_heads;
  const int k0 = kv_tile * kDkvRows;
  const int j0 = p.causal ? k0 / kDkvQ : 0;    // the first q tile that sees a key of this tile
  const int per_head = n_q - j0;
  const int n_items = p.group / p.cluster * per_head;   // (q head, q tile) pairs of this CTA
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    mbar_init(&sm.full_kv, 1);
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp issues every load; the other three idle until
    // the cluster's reduction, whose two barriers every thread joins
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kDkvProducerRegs));
    if (tid / 32 == kConsumers * 4) {
      const int lane = tid % 32;
      if (lane == 0) {
        mbar_expect_tx(&sm.full_kv, 2 * kDkvRows * kD * 2);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(sm.t.k[hf], &tm_k, &sm.full_kv, 64 * hf, k0, kvh, b);
          tma_load(sm.t.v[hf], &tm_v, &sm.full_kv, 64 * hf, k0, kvh, b);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kDkvStages;
        const int h = kvh * p.group + (it / per_head) * p.cluster + rank;
        const int q0 = (j0 + it % per_head) * kDkvQ;
        const long long stat = ((long long)b * p.num_q_heads + h) * S;
        float lse2[kDkvQ / 32], delta[kDkvQ / 32];   // read before the wait, so its latency overlaps it
#pragma unroll
        for (int i = 0; i < kDkvQ / 32; ++i) {
          const int r = q0 + lane + 32 * i;
          lse2[i] = r < S ? p.lse[stat + r] * kLog2e : 0.f;
          delta[i] = r < S ? p.delta[stat + r] : 0.f;
        }
        if (it >= kDkvStages) mbar_wait(&sm.empty[st], (it / kDkvStages - 1) & 1);
#pragma unroll
        for (int i = 0; i < kDkvQ / 32; ++i) {
          sm.lse2[st][lane + 32 * i] = lse2[i];
          sm.delta[st][lane + 32 * i] = delta[i];
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&sm.full[st], 2 * kDkvQ * kD * 2);   // also releases lse2, delta
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf) {
            tma_load(sm.t.q[st][hf], &tm_q, &sm.full[st], 64 * hf, q0, h, b);
            tma_load(sm.t.dout[st][hf], &tm_do, &sm.full[st], 64 * hf, q0, h, b);
          }
        }
        __syncwarp();
      }
    }
    cluster_sync();   // the partials are written
    cluster_sync();   // and read
  } else {
    // ---- consumers: 64 kv rows each; S^T, dP^T, P^T, dS^T, dK, dV in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kDkvConsumerRegs));
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int row0 = 64 * wg + 16 * (t / 32) + lane / 4;   // this thread's two kv rows
    const int row1 = row0 + 8;
    const int kpos0 = k0 + row0;
    const int kpos1 = k0 + row1;
    const bool kvis0 = kpos0 < S && (!kMasked || p.key_mask[b * p.mask_sb + kpos0] != 0);
    const bool kvis1 = kpos1 < S && (!kMasked || p.key_mask[b * p.mask_sb + kpos1] != 0);
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t k_base = smem_u32(sm.t.k[0]) + wg * 64 * 128;
    const uint32_t v_base = smem_u32(sm.t.v[0]) + wg * 64 * 128;
    constexpr uint32_t kHalfKv = kDkvRows * 128;   // bytes between the two halves of K, V

    float dk[kHalves][32], dv[kHalves][32];
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[hf][i] = dv[hf][i] = 0.f;
    }

    mbar_wait(&sm.full_kv, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % kDkvStages;
      const int parity = (it / kDkvStages) & 1;
      const int q0 = (j0 + it % per_head) * kDkvQ;

      // S^T = K Q^T, dP^T = V dO^T
      float s[32], dp[32];
      mbar_wait(&sm.full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(s, desc_kmajor(k_base + (kk / 4) * kHalfKv, kk),
                     desc_kmajor(smem_u32(sm.t.q[st][kk / 4]), kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc_kmajor(v_base + (kk / 4) * kHalfKv, kk),
                     desc_kmajor(smem_u32(sm.t.dout[st][kk / 4]), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T, lse and delta per column (query); invisible pairs get p = 0
      const bool masked = kMasked || (p.causal && q0 < k0 + kDkvRows) || q0 + kDkvQ > S ||
                          k0 + kDkvRows > S;
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < kDkvQ / 8; ++j) {
        float p0[2], p1[2], d0[2], d1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          const float l2 = sm.lse2[st][c];
          const float dl = sm.delta[st][c];
          p0[e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -l2));
          p1[e] = fast_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -l2));
          if (masked) {
            const int qpos = q0 + c;
            const bool qin = qpos < S;
            if (!(kvis0 && qin && (!p.causal || kpos0 <= qpos))) p0[e] = 0.f;
            if (!(kvis1 && qin && (!p.causal || kpos1 <= qpos))) p1[e] = 0.f;
          }
          d0[e] = p0[e] * (dp[4 * j + e] - dl);
          d1[e] = p1[e] * (dp[4 * j + 2 + e] - dl);
        }
        pa[2 * j] = pack_bf16(p0[0], p0[1]);
        pa[2 * j + 1] = pack_bf16(p1[0], p1[1]);
        da[2 * j] = pack_bf16(d0[0], d0[1]);
        da[2 * j + 1] = pack_bf16(d1[0], d1[1]);
      }

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        fence_regs(dv[hf]);
        fence_regs(dk[hf]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          wgmma_rs_n64(dv[hf], a, desc_mnmajor(smem_u32(sm.t.dout[st][hf]), kk));
        }
      }
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          wgmma_rs_n64(dk[hf], a, desc_mnmajor(smem_u32(sm.t.q[st][hf]), kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        fence_regs(dv[hf]);
        fence_regs(dk[hf]);
      }
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }

    // this CTA's partials over the spent tiles, once both warpgroups are past
    // their last product (every load the producer issued has been consumed)
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * quad;
        *reinterpret_cast<float2*>(&sm.part.dk[row0 * kPitch + col]) =
            make_float2(dk[hf][4 * j], dk[hf][4 * j + 1]);
        *reinterpret_cast<float2*>(&sm.part.dk[row1 * kPitch + col]) =
            make_float2(dk[hf][4 * j + 2], dk[hf][4 * j + 3]);
        *reinterpret_cast<float2*>(&sm.part.dv[row0 * kPitch + col]) =
            make_float2(dv[hf][4 * j], dv[hf][4 * j + 1]);
        *reinterpret_cast<float2*>(&sm.part.dv[row1 * kPitch + col]) =
            make_float2(dv[hf][4 * j + 2], dv[hf][4 * j + 3]);
      }
    }
    cluster_sync();

    // the group's sum: CTA `rank` takes its share of the 128 x 32 float4s of
    // each tile and adds the cluster's partials in rank order
    constexpr int kVec = kDkvRows * kD / 4;
    const int lo = rank * kVec / p.cluster;
    const int hi = (rank + 1) * kVec / p.cluster;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* part = which ? sm.part.dv : sm.part.dk;
      bf16* out = which ? p.out1 + b * p.o1_sb + kvh * p.o1_sh : p.out0 + b * p.o0_sb + kvh * p.o0_sh;
      const long long out_ss = which ? p.o1_ss : p.o0_ss;
      const float mul = which ? 1.f : p.scale;
      for (int f = lo + tid; f < hi; f += kConsumers * 128) {   // tid: 0-255 here
        const int row = f / (kD / 4);
        const int col = 4 * (f % (kD / 4));
        const uint32_t addr = smem_u32(part + row * kPitch + col);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < p.cluster; ++r) {
          const float4 x = cluster_load4(cluster_map(addr, r));
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        if (k0 + row < S) {
          *reinterpret_cast<uint2*>(out + (k0 + row) * out_ss + col) =
              make_uint2(pack_bf16(acc.x * mul, acc.y * mul), pack_bf16(acc.z * mul, acc.w * mul));
        }
      }
    }
    cluster_sync();   // no CTA leaves while another still reads its partials
  }
}

// ---- host side -----------------------------------------------------------

// The largest divisor of the GQA group that is a portable cluster size.
int cluster_size(int group) {
  for (int c = kMaxCluster; c > 1; --c) {
    if (group % c == 0) return c;
  }
  return 1;
}

Params make_params(const float* lse, const float* delta, const int* key_mask, int batch,
                   int seq_len, int num_q_heads, int num_kv_heads, long long mask_sb,
                   float scale, int causal) {
  Params p = {};
  p.lse = lse;
  p.delta = delta;
  p.key_mask = key_mask;
  p.mask_sb = mask_sb;
  p.batch = batch;
  p.num_q_heads = num_q_heads;
  p.num_kv_heads = num_kv_heads;
  p.seq_len = seq_len;
  p.group = num_q_heads / num_kv_heads;
  p.cluster = cluster_size(p.group);
  p.scale = scale;
  p.causal = causal;
  return p;
}

bool valid(int batch, int seq_len, int num_q_heads, int num_kv_heads) {
  return batch > 0 && seq_len > 0 && num_kv_heads > 0 && num_q_heads % num_kv_heads == 0;
}

template <bool kMasked>
cudaError_t launch_dq(const CUtensorMap* maps, const Params& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = ((p.seq_len + kDqRows - 1) / kDqRows) * p.num_q_heads * p.batch;
  flash_dq_kernel<kMasked><<<grid, kThreads, kDqSmemBytes, st>>>(maps[0], maps[1], maps[2],
                                                                  maps[3], p);
  return cudaGetLastError();
}

cudaLaunchConfig_t dkv_config(const Params& p, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, ((p.seq_len + kDkvRows - 1) / kDkvRows) * p.num_kv_heads * p.batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kDkvSmemBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kMasked>
cudaError_t launch_dkv(const CUtensorMap* maps, const Params& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dkv_config(p, st, &attr);
  err = cudaLaunchKernelEx(&cfg, flash_dkv_kernel<kMasked>, maps[0], maps[1], maps[2], maps[3], p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Tensor maps of q, dO (boxes of q_rows) and k, v (boxes of kv_rows).
bool make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
               int batch, int seq_len, int num_q_heads, int num_kv_heads,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long do_sb, long long do_ss, long long do_sh, int q_rows, int kv_rows) {
  return make_map(&maps[0], q, kD, seq_len, num_q_heads, batch, q_ss, q_sh, q_sb, q_rows) &&
         make_map(&maps[1], dout, kD, seq_len, num_q_heads, batch, do_ss, do_sh, do_sb, q_rows) &&
         make_map(&maps[2], k, kD, seq_len, num_kv_heads, batch, k_ss, k_sh, k_sb, kv_rows) &&
         make_map(&maps[3], v, kD, seq_len, num_kv_heads, batch, v_ss, v_sh, v_sb, kv_rows);
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. q, dO (B, S, Hq, 128)
// and k, v (B, S, Hkv, 128) are bf16 with a contiguous last dim, 16-byte
// aligned, other strides (in elements) multiples of 8; lse and delta fp32
// (B, Hq, S) contiguous; key_mask int32 (B, S) with unit stride along S and
// row stride mask_sb, or null for the dense variant; the outputs bf16 with
// the strides given and a contiguous last dim. Each launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// shapes or operands that TMA cannot describe.
extern "C" int blim_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* key_mask,
                             void* dq, int batch, int seq_len, int num_q_heads,
                             int num_kv_heads,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long do_sb, long long do_ss, long long do_sh,
                             long long dq_sb, long long dq_ss, long long dq_sh,
                             long long mask_sb, float scale, int causal, void* stream) {
  CUtensorMap maps[4];
  if (!valid(batch, seq_len, num_q_heads, num_kv_heads) ||
      !make_maps(maps, q, k, v, dout, batch, seq_len, num_q_heads, num_kv_heads, q_sb, q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, kDqRows, kDqKv)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = make_params(lse, delta, key_mask, batch, seq_len, num_q_heads, num_kv_heads,
                         mask_sb, scale, causal);
  p.out0 = static_cast<bf16*>(dq);
  p.o0_sb = dq_sb; p.o0_ss = dq_ss; p.o0_sh = dq_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(key_mask ? launch_dq<true>(maps, p, st) : launch_dq<false>(maps, p, st));
}

extern "C" int blim_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, const int* key_mask,
                              void* dk, void* dv, int batch, int seq_len, int num_q_heads,
                              int num_kv_heads,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long do_sb, long long do_ss, long long do_sh,
                              long long dk_sb, long long dk_ss, long long dk_sh,
                              long long dv_sb, long long dv_ss, long long dv_sh,
                              long long mask_sb, float scale, int causal, void* stream) {
  CUtensorMap maps[4];
  if (!valid(batch, seq_len, num_q_heads, num_kv_heads) ||
      !make_maps(maps, q, k, v, dout, batch, seq_len, num_q_heads, num_kv_heads, q_sb, q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, kDkvQ, kDkvRows)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = make_params(lse, delta, key_mask, batch, seq_len, num_q_heads, num_kv_heads,
                         mask_sb, scale, causal);
  p.out0 = static_cast<bf16*>(dk);
  p.out1 = static_cast<bf16*>(dv);
  p.o0_sb = dk_sb; p.o0_ss = dk_ss; p.o0_sh = dk_sh;
  p.o1_sb = dv_sb; p.o1_ss = dv_ss; p.o1_sh = dv_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(key_mask ? launch_dkv<true>(maps, p, st) : launch_dkv<false>(maps, p, st));
}

// Dynamic shared memory a CTA uses, in bytes: flash_dkv's if `dkv`, else flash_dq's.
extern "C" int blim_flash_bwd_smem_bytes(int dkv) {
  return dkv ? kDkvSmemBytes : kDqSmemBytes;
}

// flash_dkv's cluster size for a GQA group, and how many such clusters of
// the masked kernel the card can hold at once (cudaOccupancyMaxActiveClusters),
// packed as cluster_size * 1000 + clusters; negative on a CUDA error.
extern "C" int blim_flash_dkv_cluster_occupancy(int group) {
  Params p = {};
  p.group = group;
  p.cluster = cluster_size(group);
  p.seq_len = kDkvRows;
  p.num_kv_heads = 1;
  p.batch = 1;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dkv_config(p, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, flash_dkv_kernel<true>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return p.cluster * 1000 + clusters;
}

extern "C" const char* blim_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
