// The fused pre-LN ViT block backward for Hopper (sm_90a), bound through
// plain C functions and loaded with ctypes (ops/vit_block.py).
//
// Replaces the TPU kernel distributed_training_comparison_tpu/ops/vit_block.py
// ::_block_bwd_kernel (K6, vit_block.py:181), which recomputes the block's
// forward from x, then produces dx and all twelve parameter gradients, the
// gradients in fp32 VMEM accumulators carried across a sequential row grid.
// Hopper's blocks run in parallel in no order, and no reduction of a
// training kernel here uses atomics (two calls must give bit-identical
// gradients), so every parameter gradient is a two-pass reduction: fp32
// partials per row chunk, then a fixed-order sum over the chunks.  The
// chain (ops/vit_block.py::_bwd_chain) is, per block:
//
// - block_ln: LayerNorm rows (fp32 statistics by E[x^2] - mu^2, eps 1e-6),
//   rounded to the compute dtype: LN1(x) and LN2(r1), which the weight
//   gradients read; K5's block_gemm and block_attention recompute qkv, o,
//   r1 and the pre-gelu up.
// - block_gemm_dgrad: C = G . W, the TPU kernel's _gemm_T (vit_block.py:113;
//   W the fp32 nn.Linear weight (K, N), rounded to the compute dtype, in up
//   to three row segments).  Epilogues: round (dO); gelu backward against
//   up, rounded, with gelu(up) rounded as a second output (dup and the
//   recomputed hmid); fp32 (dLN2, dLN1).
// - block_ln_bwd: per row, base + (dxhat - mean(dxhat) - xhat mean(dxhat
//   xhat)) / sigma with dxhat = dln gamma, fp32, written in fp32 and/or
//   rounded (dr1 and its rounded copy; dx), and per block of rows the
//   partials of dgamma = sum dln xhat and dbeta = sum dln.
// - block_gemm_wgrad: dW = G^T . A, the TPU kernel's _acc_T (vit_block.py:
//   120), per chunk of rows into fp32 partials (one block per output tile
//   and chunk), with the bias column sums of a second source taken by the
//   blocks of the first input tile.
// - block_attention_bwd: per (item, head) with P recomputed by the exact
//   softmax of K5 (head_bwd's numerics): one kernel owns 64 query rows (P,
//   delta = sum_j dp P on the fp32 P, dq = round(ds scale) . K) and writes
//   each row's max, sum and delta to an fp32 scratch; a second owns 64 keys
//   and walks the query tiles for dk = round(ds scale)^T . Q and dv =
//   round(P)^T . dO.  No atomics.
// - block_grad_reduce: every partial summed over its chunks in order, one
//   launch for all twelve gradients, each thread's loads a batch of chunks
//   ahead of its adds.
//
// What bounds it: at the vit_tiny --patch-size 2 train shape (B 128, S 256,
// dim 192, 3 heads, bf16: 32768 rows) a block's backward is ~110 GFLOP
// (forward recompute 35.4, data and weight gradients 58.0, attention
// backward 16.1) against ~41 MB of x, dy, dx, parameters and gradients, so
// operations bound the whole (~0.111 ms at 989 TFLOP/s).  Each launch alone
// is bound by bytes: a GEMM does NK / (N + K) = 96-154 FLOP a byte of its
// operands, under the H100's ~295, and its intermediates round-trip
// through device memory.  The bf16 GEMMs are built for that
// (block_gemm.cuh):
// - block_gemm_dgrad (dgrad_wgmma) is weight-stationary, as block_gemm: a
//   block converts its slab of W to bf16 once (gathering 8 rows of k for a
//   column into one 16-byte chunk, the loads coalesced along n) and streams
//   G through a 4-stage TMA ring a consumer warpgroup; every product a
//   wgmma, the epilogue on the accumulators.
// - block_gemm_wgrad (wgrad_wgmma) lands each 64-row step of G and A as TMA
//   boxes in their row-major layout, and wgmma reads both MN-major (the
//   transpose bits): no transposed staging.  A 4-stage ring, one producer
//   warp, two consumer warpgroups of 64 output rows; the bias column sums
//   are read from the landed G tile (from global memory, a step ahead, for
//   another source) under the products and added in a fixed order.
// The attention backward is bound by bytes (qkv, dO in, dqkv out: 88 MB at
// the train shape, 0.026 ms at 3.35 TB/s, against 16.1 GFLOP, 0.016 ms at
// 989 TFLOP/s).  The bf16 kernels (attn_dq_wgmma, attn_dkv_wgmma, on
// attention_tiles.cuh) read each input once per block into swizzled tiles
// and run every product on wgmma.  One kernel cannot hold a key tile's dK
// and dV accumulators beside the scores and dP of a query tile within the
// registers of the four warpgroups that S 256 needs (S, dP, dK, dV: 128
// registers a thread at 512 threads, the whole file), so the backward stays
// two launches with the statistics scratch.  The dq kernel's warpgroups
// split the keys (up to S 256 four of one tile each, above two of three or
// four) and hold P and, up to S 256, dP in registers: Q.K^T and dO.V^T once
// each (dO.V^T twice above S 256), dS.K; up to S 256 its blocks are
// persistent, one an SM, and stage the next query tile's inputs under the
// current one's products.  The dk/dv kernel works in the transposed frame,
// so P^T and dS^T are A fragments from registers: K.Q^T, V.dO^T, P^T.dO,
// dS^T.Q; its two warpgroups own 64 keys each and share one staging of Q
// and dO.  Seven products per (64-query, 64-key) tile pair (eight above S
// 256), against ten for the mma.sync pair they replace.  The elementwise
// softmax work, not the products, takes most of their time (PERF.md).
// fp32 runs SIMT tiles with no TF32.

#include <type_traits>

#include "attention_tiles.cuh"
#include "block_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

constexpr float kGeluC = 0.7978845608028654f, kGeluA = 0.044715f;

// jax.nn.gelu's tanh approximation and its derivative, in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = kGeluC * (x + kGeluA * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kGeluC * (x + kGeluA * (x * x * x)));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * x * x);
}

// ------------------------------------------------------------- block_ln

constexpr int kRowWarps = 8;  // rows per block of the row kernels: one warp each

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows(const T* x, const float* g, const float* b, T* y, int m, int n) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + static_cast<long long>(row) * n;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float v = to_f(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / n;
  const float rs = 1.f / sqrtf(ss / n - mu * mu + kLnEps);
  T* yr = y + static_cast<long long>(row) * n;
  for (int c = lane; c < n; c += 32) yr[c] = from_f<T>((to_f(xr[c]) - mu) * rs * g[c] + b[c]);
}

// ------------------------------------------------ the fp32 GEMM mainloop

constexpr int kBM = 128;  // the fp32 kernels: output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kGemmThreads = 256;
constexpr int kFBK = 16;        // fp32: K per stage

// fp32: each thread owns 4 rows x 8 columns of the kBM x kBN tile; the
// stagers fill as[kFBK][kBM + 4] and bs[kFBK][kBN + 4] (k-major)
template <typename StageA, typename StageB>
__device__ __forceinline__ void mainloop_f32(float (&acc)[4][8], float (*as)[kBM + 4],
                                             float (*bs)[kBN + 4], int kdim, StageA stage_a,
                                             StageB stage_b) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += kFBK) {
    stage_a(k0);
    stage_b(k0);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kFBK; ++kc) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kc][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kc][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kc][tx * 8 + 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ block_gemm_dgrad

struct DgradParams {
  const void* g;     // (m, k) compute dtype
  const float* w[3]; // rows of W (k, n): seg rows each, fp32
  const void* up;    // (m, n) compute dtype, mode 1
  void* hmid;        // (m, n) compute dtype, mode 1
  void* c;           // (m, n): compute dtype (modes 0, 1) or fp32 (mode 2)
  int m, n, k, seg, mode;
};

__device__ __forceinline__ const float* w_row(const DgradParams& p, int kr) {
  if (kr < p.seg) return p.w[0] + static_cast<long long>(kr) * p.n;
  if (kr < 2 * p.seg) return p.w[1] + static_cast<long long>(kr - p.seg) * p.n;
  return p.w[2] + static_cast<long long>(kr - 2 * p.seg) * p.n;
}

template <typename T>
__device__ __forceinline__ void dgrad_store(const DgradParams& p, float acc, int row, int col) {
  const long long i = static_cast<long long>(row) * p.n + col;
  if (p.mode == 2) {
    static_cast<float*>(p.c)[i] = acc;
    return;
  }
  const float v = rnd<T>(acc);
  if (p.mode == 0) {
    static_cast<T*>(p.c)[i] = from_f<T>(v);
    return;
  }
  const float u = to_f(static_cast<const T*>(p.up)[i]);
  static_cast<T*>(p.c)[i] = from_f<T>(gelu_tanh_grad(u) * v);
  static_cast<T*>(p.hmid)[i] = from_f<T>(gelu_tanh(u));
}

// K6's data-gradient products in bf16, weight-stationary (block_gemm.cuh):
// C = G . W with W (k, n) converted once per block into the K-major slab of
// BN columns (8 rows of k gathered a chunk), G streamed through the rings;
// the epilogue is dgrad_store's on pairs of columns.
template <int BN>
__global__ void __launch_bounds__(bgemm::kThreads, 1)
    dgrad_wgmma(const DgradParams p, const __grid_constant__ CUtensorMap tg) {
  using namespace bgemm;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const WsBlock B(gemm_smem, p.m, p.k, BN);
  ws_start<BN, false>(B, &tg, p.w, p.seg, p.n, p.k);

  const int tid = threadIdx.x, n0 = B.n0;
  const int lane = tid % 32, wq = tid % 128 / 32, g = lane / 4, t4 = lane % 4;
  auto begin = [](int) {};
  auto multiply = [&](float* acc, uint32_t stage, int kc) { mma_ss<BN>(acc, B.base, stage, kc); };
  auto epilogue = [&](float (&acc)[BN / 2], int m0) {
    // this thread's rows 16 wq + g + 8 i, columns n0 + 8 j + 2 t4 and + 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 16 * wq + g + 8 * i;
      const bool ok = row < p.m;
      const long long at = static_cast<long long>(row) * p.n + n0;
      if (p.mode == 2) {  // fp32: a quad's float2 stores cover whole 32-byte sectors
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          if (ok && n0 + 8 * j + 2 * t4 < p.n)
            *reinterpret_cast<float2*>(static_cast<float*>(p.c) + at + 8 * j + 2 * t4) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        continue;
      }
      uint32_t u2[BN / 8], out[BN / 8], hm[BN / 8];  // up is loaded before any store
      if (p.mode == 1) load_row<BN>(u2, static_cast<const bf16*>(p.up) + at, p.n - n0, ok);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float v0 = rnd<bf16>(acc[4 * j + 2 * i]), v1 = rnd<bf16>(acc[4 * j + 2 * i + 1]);
        if (p.mode == 0) {
          out[j] = pack_f32_to_bf16(v0, v1);
          continue;
        }
        const float x0 = __uint_as_float(u2[j] << 16), x1 = __uint_as_float(u2[j] & 0xffff0000u);
        out[j] = pack_f32_to_bf16(gelu_tanh_grad(x0) * v0, gelu_tanh_grad(x1) * v1);
        hm[j] = pack_f32_to_bf16(gelu_tanh(x0), gelu_tanh(x1));
      }
      store_row<BN>(out, static_cast<bf16*>(p.c) + at, p.n - n0, ok);
      if (p.mode == 1) store_row<BN>(hm, static_cast<bf16*>(p.hmid) + at, p.n - n0, ok);
    }
  };
  ws_consume<BN>(B, &tg, begin, multiply, epilogue);
}

__global__ void __launch_bounds__(kGemmThreads) dgrad_f32(const DgradParams p) {
  __shared__ __align__(16) float as[kFBK][kBM + 4];
  __shared__ __align__(16) float bs[kFBK][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN, tid = threadIdx.x;
  const float* g = static_cast<const float*>(p.g);
  auto stage_a = [&](int k0) {
    for (int c = tid; c < kBM * kFBK; c += kGemmThreads) {
      const int r = c / kFBK, kc = c % kFBK;
      as[kc][r] = m0 + r < p.m && k0 + kc < p.k ? g[static_cast<long long>(m0 + r) * p.k + k0 + kc] : 0.f;
    }
  };
  auto stage_b = [&](int k0) {
    for (int c = tid; c < kBN * kFBK; c += kGemmThreads) {
      const int kc = c / kBN, nn = c % kBN;
      bs[kc][nn] = k0 + kc < p.k && n0 + nn < p.n ? w_row(p, k0 + kc)[n0 + nn] : 0.f;
    }
  };
  float acc[4][8];
  mainloop_f32(acc, as, bs, p.k, stage_a, stage_b);
  const int tx = tid % 8, ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 8 + j;
      if (row < p.m && col < p.n) dgrad_store<float>(p, acc[i][j], row, col);
    }
}

// ------------------------------------------------------ block_gemm_wgrad

struct WgradParams {
  const void* g;     // (m, n_out) compute dtype
  const void* a;     // (m, n_in) compute dtype
  const void* bsrc;  // (m, n_out): fp32 when bsrc_f32, else compute dtype
  int bsrc_f32;
  float* part_w;     // (chunks, n_out, n_in)
  float* part_b;     // (chunks, n_out)
  int m, n_out, n_in, chunk;
};

// the bias column sums of rows [r0, r1) for columns [o0, o0 + kBM), by
// the blocks of the first input tile: two threads a column, each taking
// alternate rows, combined in a fixed order
__device__ void bias_partial(const WgradParams& p, int r0, int r1, int o0, float* red) {
  const int o = threadIdx.x % kBM, half = threadIdx.x / kBM;
  float s = 0.f;
  if (o0 + o < p.n_out) {
    for (int r = r0 + half; r < r1; r += 2) {
      const long long i = static_cast<long long>(r) * p.n_out + o0 + o;
      s += p.bsrc_f32 ? static_cast<const float*>(p.bsrc)[i]
                      : to_f(static_cast<const bf16*>(p.bsrc)[i]);
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (half == 0 && o0 + o < p.n_out)
    p.part_b[static_cast<long long>(blockIdx.z) * p.n_out + o0 + o] = red[o] + red[o + kBM];
  __syncthreads();
}

// K6's weight-gradient products in bf16: per row chunk (blockIdx.z), an
// output tile of 128 rows of out (two consumer warpgroups of 64) by BN
// columns of in.  Each 64-row step of the chunk lands as TMA boxes of G (64
// rows x 64 out, one a warpgroup) and of A (64 rows x BN in) in their
// row-major layout, and wgmma reads both MN-major (dW = G^T . A): no
// transposed staging.  A 4-stage ring, one producer warp.  The blocks of
// the first input tile also take the bias column sums of their 128 out
// columns: each thread sums 4 columns over every 8th row of a step, under
// the step's products, from the landed G tile where the source is G, else
// from global memory, its loads for the next step in flight; the 8 row
// phases are added in order.
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 2;  // warpgroups of 64 output rows
constexpr int kWgThreads = 128 * kWgConsumers + 32;

template <int BN>
__host__ __device__ constexpr int wgrad_stage_bytes() {
  return (kWgConsumers + BN / 64) * bgemm::kStageBytes;  // G boxes, then A boxes
}

template <int BN>
__host__ __device__ constexpr int wgrad_smem() {  // ring, bias sums, barriers, alignment slack
  return kWgStages * wgrad_stage_bytes<BN>() + 8 * 128 * 4 + 2 * kWgStages * 8 + 1024;
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad_wgmma(const WgradParams p, const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap ta) {
  using namespace bgemm;
  constexpr int kStage = wgrad_stage_bytes<BN>();
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const uint32_t raw = smem_u32(gemm_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(gemm_smem + (base - raw) + kWgStages * kStage);
  const uint32_t full = base + kWgStages * kStage + 8 * 128 * 4;
  const uint32_t empty = full + 8 * kWgStages;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BN, o0 = blockIdx.y * kRows * kWgConsumers;
  const int r0 = blockIdx.z * p.chunk, r1 = min(r0 + p.chunk, p.m);
  const int steps = (r1 - r0 + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWgConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 128 * kWgConsumers) {  // the producer warp
    if (tid == 128 * kWgConsumers) {
      for (int st = 0; st < steps; ++st) {
        const int s = st % kWgStages, r = r0 + st * kRows;
        const uint32_t stage = base + s * kStage;
        if (st >= kWgStages) mbar_wait(empty + 8 * s, ((st / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStage);
#pragma unroll
        for (int w = 0; w < kWgConsumers; ++w)
          tma_load(stage + w * kStageBytes, &tg, o0 + w * kRows, r, 0, 0, full + 8 * s);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(stage + (kWgConsumers + j) * kStageBytes, &ta, i0 + 64 * j, r, 0, 0, full + 8 * s);
      }
    }
    return;
  }

  const int w = tid / 128, lane = tid % 32, wq = tid % 128 / 32, g = lane / 4, t4 = lane % 4;
  // the bias sums: 4 columns from ocol, rows ph + 8 j of each step; where
  // the source is G itself, read from the landed stage, else loaded from
  // global memory a step ahead
  const bool bias = blockIdx.x == 0 && p.part_b != nullptr;
  const bool from_g = p.bsrc == p.g && !p.bsrc_f32;
  const int ph = tid % 128 / 16, ocol = o0 + w * kRows + 4 * (tid % 16);
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  uint4 buf[8];
  auto load_bias = [&](int st) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + st * kRows + ph + 8 * j;
      buf[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row >= r1 || ocol >= p.n_out) continue;
      const long long at = static_cast<long long>(row) * p.n_out + ocol;
      if (p.bsrc_f32) {
        buf[j] = *reinterpret_cast<const uint4*>(static_cast<const float*>(p.bsrc) + at);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.bsrc) + at);
        buf[j] = make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
      }
    }
  };
  auto add_stage = [&](uint32_t gbox, int st) {  // this warpgroup's G box: 64 rows x 64 columns, swizzled
    const int c = 4 * (tid % 16);  // the box column of this thread's 4
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ph + 8 * j;
      if (r0 + st * kRows + r >= r1) continue;  // rows of the next chunk, or past m: zeros
      uint2 v;
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(v.x), "=r"(v.y)
                   : "r"(gbox + r * 128 + (((c / 8) ^ (r % 8)) << 4) + (c % 8) * 2));
      bsum[0] += __uint_as_float(v.x << 16);
      bsum[1] += __uint_as_float(v.x & 0xffff0000u);
      bsum[2] += __uint_as_float(v.y << 16);
      bsum[3] += __uint_as_float(v.y & 0xffff0000u);
    }
  };
  auto add_bias = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bsum[0] += __uint_as_float(buf[j].x);
      bsum[1] += __uint_as_float(buf[j].y);
      bsum[2] += __uint_as_float(buf[j].z);
      bsum[3] += __uint_as_float(buf[j].w);
    }
  };

  float acc[BN / 2];
  if (bias && !from_g) load_bias(0);
  for (int st = 0; st < steps; ++st) {
    const int s = st % kWgStages;
    mbar_wait(full + 8 * s, (st / kWgStages) & 1);
    const uint32_t stage = base + s * kStage;
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {  // 16 rows, 2 KB, a k-step
      wgmma_ss<BN, 1, 1>(acc, smem_desc(stage + w * kStageBytes + kk * 2048, kStageBytes, 1024),
                         smem_desc(stage + kWgConsumers * kStageBytes + kk * 2048, kStageBytes, 1024),
                         st > 0 || kk > 0);
    }
    wgmma_commit();
    if (bias && from_g) {  // under the products
      add_stage(stage + w * kStageBytes, st);
    } else if (bias) {
      add_bias();
      if (st + 1 < steps) load_bias(st + 1);
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  float* out = p.part_w + static_cast<long long>(blockIdx.z) * p.n_out * p.n_in;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = i0 + 8 * j + 2 * t4;
    if (col >= p.n_in) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = o0 + w * kRows + 16 * wq + g + 8 * i;
      if (o < p.n_out)
        *reinterpret_cast<float2*>(out + static_cast<long long>(o) * p.n_in + col) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
  if (bias) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[ph * 128 + w * kRows + 4 * (tid % 16) + q] = bsum[q];
    named_sync(1, 128 * kWgConsumers);
    if (tid < 128 && o0 + tid < p.n_out) {
      float total = 0.f;
      for (int q = 0; q < 8; ++q) total += red[q * 128 + tid];
      p.part_b[static_cast<long long>(blockIdx.z) * p.n_out + o0 + tid] = total;
    }
  }
}

__global__ void __launch_bounds__(kGemmThreads) wgrad_f32(const WgradParams p) {
  __shared__ __align__(16) float as[kFBK][kBM + 4];
  __shared__ __align__(16) float bs[kFBK][kBN + 4];
  __shared__ float red[kGemmThreads];
  const int o0 = blockIdx.y * kBM, i0 = blockIdx.x * kBN, tid = threadIdx.x;
  const int r0 = blockIdx.z * p.chunk, r1 = min(r0 + p.chunk, p.m);
  const float* g = static_cast<const float*>(p.g);
  const float* a = static_cast<const float*>(p.a);
  if (blockIdx.x == 0 && p.part_b) bias_partial(p, r0, r1, o0, red);
  auto stage_a = [&](int k0) {  // as[r][o] = G[r][o]: coalesced in o
    for (int c = tid; c < kBM * kFBK; c += kGemmThreads) {
      const int kc = c / kBM, o = c % kBM, r = r0 + k0 + kc;
      as[kc][o] = r < r1 && o0 + o < p.n_out ? g[static_cast<long long>(r) * p.n_out + o0 + o] : 0.f;
    }
  };
  auto stage_b = [&](int k0) {
    for (int c = tid; c < kBN * kFBK; c += kGemmThreads) {
      const int kc = c / kBN, i = c % kBN, r = r0 + k0 + kc;
      bs[kc][i] = r < r1 && i0 + i < p.n_in ? a[static_cast<long long>(r) * p.n_in + i0 + i] : 0.f;
    }
  };
  float acc[4][8];
  mainloop_f32(acc, as, bs, r1 - r0, stage_a, stage_b);
  float* out = p.part_w + static_cast<long long>(blockIdx.z) * p.n_out * p.n_in;
  const int tx = tid % 8, ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + ty * 4 + i, in = i0 + tx * 8 + j;
      if (o < p.n_out && in < p.n_in) out[static_cast<long long>(o) * p.n_in + in] = acc[i][j];
    }
}

// ---------------------------------------------------------- block_ln_bwd

struct LnBwdParams {
  const float* dln;  // (m, n) fp32
  const void* xin;   // (m, n) compute dtype: the LayerNorm's input
  const float* gamma;
  const void* base;  // (m, n): fp32 when base_f32, else compute dtype
  int base_f32;
  float* out_f32;    // (m, n) or null
  void* out_c;       // (m, n) compute dtype
  float* part_g;     // (chunks, n)
  float* part_b;
  int m, n, chunk;
};

// one block per chunk of rows, a warp per row; lane owns columns lane + 32 j
template <typename T, int NJ>
__global__ void __launch_bounds__(kRowWarps * 32) ln_bwd(const LnBwdParams p) {
  __shared__ float red[kRowWarps * 1024];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * p.chunk, r1 = min(r0 + p.chunk, p.m);
  float pg[NJ], pb[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) pg[j] = pb[j] = 0.f;
  for (int row = r0 + warp; row < r1; row += kRowWarps) {
    const long long base = static_cast<long long>(row) * p.n;
    const T* xr = static_cast<const T*>(p.xin) + base;
    float x[NJ], dl[NJ];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      x[j] = c < p.n ? to_f(xr[c]) : 0.f;
      dl[j] = c < p.n ? p.dln[base + c] : 0.f;
      s += x[j];
      ss += x[j] * x[j];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / p.n;
    const float rs = 1.f / sqrtf(ss / p.n - mu * mu + kLnEps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      x[j] = (x[j] - mu) * rs;  // xhat
      const float dxh = c < p.n ? dl[j] * p.gamma[c] : 0.f;
      m1 += dxh;
      m2 += dxh * x[j];
      if (c < p.n) {
        pg[j] += dl[j] * x[j];
        pb[j] += dl[j];
      }
    }
    m1 = warp_sum(m1) / p.n;
    m2 = warp_sum(m2) / p.n;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c >= p.n) continue;
      const float dxh = dl[j] * p.gamma[c];
      const float b = p.base_f32 ? static_cast<const float*>(p.base)[base + c]
                                 : to_f(static_cast<const T*>(p.base)[base + c]);
      const float v = b + (dxh - m1 - x[j] * m2) * rs;
      if (p.out_f32) p.out_f32[base + c] = v;
      static_cast<T*>(p.out_c)[base + c] = from_f<T>(v);
    }
  }
  // the warps' partials summed in warp order
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < p.n) red[warp * p.n + c] = pass ? pb[j] : pg[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.n; c += kRowWarps * 32) {
      float t = 0.f;
      for (int w = 0; w < kRowWarps; ++w) t += red[w * p.n + c];
      (pass ? p.part_b : p.part_g)[static_cast<long long>(blockIdx.x) * p.n + c] = t;
    }
    __syncthreads();
  }
}

// --------------------------------------------------- block_attention_bwd

struct AttnBwdParams {
  const void* qkv;  // (batch * seq, 3 * dim), q | k | v, heads head-major in each
  const void* dout; // (batch * seq, dim)
  void* dqkv;       // (batch * seq, 3 * dim)
  float* stats;     // (batch * seq, heads, 3): row max, row sum, delta = sum dp P
  int seq, dim, heads;
  float scale;
};

constexpr int kAttnThreads = 128;  // the fp32 kernels
constexpr int kHeadDim = 64;       // bf16: the one head dim of a zoo model the fusion gate fuses
constexpr int kDkvWarpgroups = 2;  // bf16 dk/dv: 64-key tiles a block, sharing its Q and dO

// acc[i] += sum over a 64-column tile of a.b on this thread's row i
__device__ __forceinline__ void add_row_dots(float (&acc)[2], const float (&a)[32], const float (&b)[32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[i] += a[4 * n + 2 * i + e] * b[4 * n + 2 * i + e];
}

// d (dP of a tile) <- P (dP - delta) scale: dS of head_bwd before its rounding
__device__ __forceinline__ void form_ds(float (&d)[32], const float (&pr)[32], const float (&delta)[2],
                                        float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * n + 2 * i + e;
        d[k] = pr[k] * (d[k] - delta[i]) * scale;
      }
}

// shared memory of attn_dq_wgmma<NTW, WG>: a stage per query tile in
// flight (Q and dO, 64 rows each; K and V, all of the item's keys, NTW x WG
// tiles), two where they fit, so that the next tile's loads run under the
// current one's products; the row exchange (3 slots); the dQ partials of
// warpgroups past the first; alignment slack
template <int NTW, int WG>
struct DqLayout {
  static constexpr int kKeyRows = 64 * NTW * WG;
  static constexpr int kStage = 2 * box_bytes<64>() + 2 * box_bytes<kKeyRows>();
  static constexpr int kRest = 3 * WG * 64 * 4 + (WG - 1) * (kHeadDim / 2) * kWarpgroup * 4 + 1024;
  static constexpr int kStages = 2 * kStage + kRest <= 227 * 1024 ? 2 : 1;
  static constexpr int kBytes = kStages * kStage + kRest;
};

// dynamic shared memory of attn_dkv_wgmma<NT, WG>: K and V (64 rows a
// warpgroup), Q and dO (all of the item's queries, NT tiles), each query's
// statistics (float4), alignment slack
template <int NT, int WG>
__host__ __device__ constexpr int dkv_wgmma_smem() {
  return 2 * box_bytes<64 * WG>() + 2 * box_bytes<64 * NT>() + 64 * NT * 16 + 1024;
}

// K6's attention backward in bf16 at head dim 64, first kernel: for each
// query tile of 64 rows (one (item, head, query tile) at a time, the block
// persistent over tiles blockIdx.x, + gridDim.x, ...), dq and each row's
// max, sum and delta = sum_j dp P into the fp32 scratch.  Q, dO, and K and V
// of the whole item, come by cp.async into swizzled tiles, once a tile, the
// next tile's into the other stage under this one's products (where two
// stages fit).  Each of the WG warpgroups owns NTW 64-key tiles: S = Q.K^T
// by wgmma into registers, once; P in fp32 by softmax_rows (each row's max
// and sum combined across the warpgroups in warpgroup order); dP = dO.V^T,
// held beside P where it fits (NTW <= 2), else formed again for dS; delta
// on the fp32 P, combined the same way; dS = P (dP - delta) scale rounded to
// bf16 as the A fragments of dQ = dS.K (K MN-major); the warpgroups' dQ
// partials added in warpgroup order and rounded once.
template <int NTW, int WG>
__global__ void __launch_bounds__(kWarpgroup * WG, 1) attn_dq_wgmma(const AttnBwdParams p, int tiles) {
  using L = DqLayout<NTW, WG>;
  constexpr int D = kHeadDim, KROWS = L::kKeyRows, kAll = kWarpgroup * WG;
  constexpr int kTile = box_bytes<64>();  // one 64-row tile: 8 KB
  constexpr bool kHoldDp = NTW <= 2;      // dP of every own tile fits beside P: dO.V^T once
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base + L::kStages * L::kStage - raw));
  float* part = red + 3 * WG * 64;
  const int tid = threadIdx.x, t0 = tid / kWarpgroup * NTW, nq = (p.seq + 63) / 64;
  const long long ld = 3LL * p.dim;
  // tile u: query tile u % nq of head u / nq % heads of item u / (nq heads);
  // a stage holds Q, dO, K, V
  auto issue = [&](int u, uint32_t st) {
    const int m0 = u % nq * 64, h = u / nq % p.heads;
    const long long row0 = static_cast<long long>(u / nq / p.heads) * p.seq;
    const bf16* item = static_cast<const bf16*>(p.qkv) + row0 * ld + h * D;
    load_swizzled<D, 64, kAll>(st, item + m0 * ld, ld, p.seq - m0, tid);
    load_swizzled<D, 64, kAll>(st + kTile, static_cast<const bf16*>(p.dout) + (row0 + m0) * p.dim + h * D,
                               p.dim, p.seq - m0, tid);
    load_swizzled<D, KROWS, kAll>(st + 2 * kTile, item + p.dim, ld, p.seq, tid);
    load_swizzled<D, KROWS, kAll>(st + 2 * kTile + box_bytes<KROWS>(), item + 2 * p.dim, ld, p.seq, tid);
    cp_async_commit();
  };
  const SharedRows<WG> rows{red};
  int u = blockIdx.x;
  if (L::kStages == 2 && u < tiles) issue(u, base);
#pragma unroll 1
  for (int k = 0; u < tiles; ++k, u += gridDim.x) {
    const uint32_t qs = base + (L::kStages == 2 ? (k & 1) * L::kStage : 0);
    if constexpr (L::kStages == 2) {
      if (u + static_cast<int>(gridDim.x) < tiles) {
        issue(u + gridDim.x, base + ((k + 1) & 1) * L::kStage);  // the stage the last tile freed
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
    } else {
      issue(u, qs);
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t dos = qs + kTile, ks = qs + 2 * kTile, vs = ks + box_bytes<KROWS>();
    const int m0 = u % nq * 64, h = u / nq % p.heads;
    const long long row0 = static_cast<long long>(u / nq / p.heads) * p.seq;

    float s[NTW][32], mx[2], sum[2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NTW; ++j) wgmma_abt<D, 64, KROWS>(s[j], qs, ks + (t0 + j) * kTile);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NTW; ++j) fence_regs<32>(s[j]);
    softmax_rows(s, p.scale, [&](int, int col) { return 64 * t0 + col < p.seq; }, 64, rows, mx, sum);

    // delta = sum_j dp P over the row's whole key set, on the fp32 P
    float delta[2] = {0.f, 0.f};
    float dp[kHoldDp ? NTW : 1][32];
    if constexpr (kHoldDp) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NTW; ++j) wgmma_abt<D, 64, KROWS>(dp[j], dos, vs + (t0 + j) * kTile);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        fence_regs<32>(dp[j]);
        add_row_dots(delta, s[j], dp[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        wgmma_fence();
        wgmma_abt<D, 64, KROWS>(dp[0], dos, vs + (t0 + j) * kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dp[0]);
        add_row_dots(delta, s[j], dp[0]);
      }
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    rows.template combine<false>(delta, 2);

    // dS = P (dP - delta) scale, rounded: the A fragments of dQ += dS.K, own tile by tile
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      float(&d)[32] = dp[kHoldDp ? j : 0];
      if constexpr (!kHoldDp) {
        wgmma_fence();
        wgmma_abt<D, 64, KROWS>(d, dos, vs + (t0 + j) * kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(d);
      }
      form_ds(d, s[j], delta, p.scale);
      uint32_t da[4][4];
      pack_a(da, d);
      fence_regs<D / 2>(dq);
      fence_regs<16>(&da[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, da[kk], desc_mnmajor<KROWS>(ks + (t0 + j) * kTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
      fence_regs<16>(&da[0][0]);
    }
    // after its barrier no warp reads this tile's stage: the next issue may refill it
    sum_partials<WG>(dq, part);
    if (tid < kWarpgroup) {
      store_acc<D>(static_cast<bf16*>(p.dqkv) + (row0 + m0) * ld + h * D, dq, ld, p.seq - m0);
      if (tid % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + acc_row(i);
          if (row >= p.seq) continue;
          float* st = p.stats + ((row0 + row) * p.heads + h) * 3;
          st[0] = mx[i];
          st[1] = sum[i];
          st[2] = delta[i];
        }
      }
    }
    if constexpr (L::kStages == 1) break;  // a block a tile: no state carried to a next one
  }
}

// K6's attention backward in bf16 at head dim 64, second kernel: dk and dv
// of the 64 WG keys [64 WG blockIdx.x, + 64 WG) of item blockIdx.z, head
// blockIdx.y, warpgroup w owning the w-th 64, in the transposed frame (rows
// keys, columns queries).  K and V of the block's keys, and Q and dO of the
// whole item (one cp.async group a query tile, consumed in order as they
// land), come once for all its warpgroups; the statistics the dq kernel
// wrote are staged per query with the correctly rounded reciprocal of the
// sum.  For each query tile: S^T = K.Q^T and dP^T = V.dO^T by wgmma (both
// K-major), P^T = exp(s scale - max) / sum in fp32 (div_by) and dS^T = P^T
// (dP^T - delta) scale, each rounded to bf16 as the A fragments of dV +=
// P^T.dO and dK += dS^T.Q (dO and Q MN-major): four products, no
// shared-memory round trip for P or dS.  Keys and queries past S take P = 0.
template <int NT, int WG>
__global__ void __launch_bounds__(kWarpgroup * WG, 1) attn_dkv_wgmma(const AttnBwdParams p) {
  constexpr int D = kHeadDim, QROWS = 64 * NT, KROWS = 64 * WG, kAll = kWarpgroup * WG;
  constexpr int kTile = box_bytes<64>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + box_bytes<KROWS>(), qs = vs + box_bytes<KROWS>();
  const uint32_t dos = qs + box_bytes<QROWS>();
  float4* st = reinterpret_cast<float4*>(smem_raw + (dos + box_bytes<QROWS>() - raw));
  const int tid = threadIdx.x, w = tid / kWarpgroup, h = blockIdx.y;
  const int n0 = blockIdx.x * KROWS, k0 = n0 + 64 * w;  // the block's keys, this warpgroup's
  const long long ld = 3LL * p.dim, row0 = static_cast<long long>(blockIdx.z) * p.seq;
  const bf16* item = static_cast<const bf16*>(p.qkv) + row0 * ld + h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + row0 * p.dim + h * D;
  load_swizzled<D, KROWS, kAll>(ks, item + p.dim + n0 * ld, ld, p.seq - n0, tid);
  load_swizzled<D, KROWS, kAll>(vs, item + 2 * p.dim + n0 * ld, ld, p.seq - n0, tid);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    load_swizzled<D, 64, kAll>(qs + i * kTile, item + i * 64 * ld, ld, p.seq - i * 64, tid);
    load_swizzled<D, 64, kAll>(dos + i * kTile, dog + i * 64 * p.dim, p.dim, p.seq - i * 64, tid);
    cp_async_commit();
  }
  const float* stats = p.stats + row0 * p.heads * 3 + h * 3;
  for (int r = tid; r < QROWS; r += kAll) {
    const float* sr = stats + static_cast<long long>(r) * p.heads * 3;
    st[r] = r < p.seq ? make_float4(sr[0], sr[1], 1.f / sr[1], sr[2]) : make_float4(0.f, 1.f, 1.f, 0.f);
  }

  const uint32_t kw = ks + w * kTile, vw = vs + w * kTile;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    cp_async_wait_at_most(NT - 1 - i);  // query tile i and those before it
    fence_proxy_async();
    __syncthreads();
    float sc[32], dp[32];
    wgmma_fence();
    wgmma_abt<D, KROWS, QROWS>(sc, kw, qs + i * kTile);
    wgmma_abt<D, KROWS, QROWS>(dp, vw, dos + i * kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool key = k0 + acc_row(r) < p.seq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 64 * i + acc_col(n, e), k = 4 * n + 2 * r + e;
          const float4 t = st[q];  // max, sum, 1 / sum, delta
          const float pr = key && q < p.seq ? div_by(expf(sc[k] * p.scale - t.x), t.y, t.z) : 0.f;
          sc[k] = pr;
          dp[k] = pr * (dp[k] - t.w) * p.scale;
        }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, sc);
    pack_a(da, dp);
    fence_regs<D / 2>(dk);
    fence_regs<D / 2>(dv);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&da[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], desc_mnmajor<QROWS>(dos + i * kTile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, da[kk], desc_mnmajor<QROWS>(qs + i * kTile, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dk);
    fence_regs<D / 2>(dv);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&da[0][0]);
  }
  bf16* out = static_cast<bf16*>(p.dqkv) + (row0 + k0) * ld + h * D;
  store_acc<D>(out + p.dim, dk, ld, p.seq - k0);
  store_acc<D>(out + 2 * p.dim, dv, ld, p.seq - k0);
}

constexpr int kFM = 32;  // fp32: rows (queries or keys) per block, 4 threads per row
constexpr int kFN = 32;  // fp32: keys or queries per tile

template <int D>
constexpr int attn_f32_smem() {
  return (4 * kFM * (D + 1) + 2 * kFM * (kFN + 1) + kFN * 3) * 4;
}

// fp32 dq and statistics: 32 query rows, a quad of threads per row
template <int D>
__global__ void __launch_bounds__(kAttnThreads) attn_dq_f32(const AttnBwdParams p) {
  constexpr int LD = D + 1, PER = kFN / 4, OUT = D / 4;
  extern __shared__ float fsmem[];
  float* qs = fsmem;
  float* dos = qs + kFM * LD;
  float* ks = dos + kFM * LD;
  float* vs = ks + kFN * LD;
  float* ps = vs + kFN * LD;
  const int m0 = blockIdx.x * kFM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / 4, t = tid % 4;
  const long long ld = 3LL * p.dim;
  const float* item = static_cast<const float*>(p.qkv) + static_cast<long long>(b) * p.seq * ld;
  const float* qg = item + h * D;
  const float* kg = item + p.dim + h * D;
  const float* vg = item + 2 * p.dim + h * D;
  const float* dog = static_cast<const float*>(p.dout) + static_cast<long long>(b) * p.seq * p.dim + h * D;
  for (int c = tid; c < kFM * D; c += kAttnThreads) {
    const int rr = c / D, d = c % D;
    const bool ok = m0 + rr < p.seq;
    qs[rr * LD + d] = ok ? qg[(m0 + rr) * ld + d] : 0.f;
    dos[rr * LD + d] = ok ? dog[static_cast<long long>(m0 + rr) * p.dim + d] : 0.f;
  }
  auto load_kv = [&](int n0, bool with_v) {
    __syncthreads();
    for (int c = tid; c < kFN * D; c += kAttnThreads) {
      const int rr = c / D, d = c % D;
      const bool ok = n0 + rr < p.seq;
      ks[rr * LD + d] = ok ? kg[(n0 + rr) * ld + d] : 0.f;
      if (with_v) vs[rr * LD + d] = ok ? vg[(n0 + rr) * ld + d] : 0.f;
    }
    __syncthreads();
  };
  auto dots = [&](float (&s)[PER], const float* a, const float* bm) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + 4 * i;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(a[r * LD + d], bm[c * LD + d], x);
      s[i] = x;
    }
  };
  auto scores = [&](float (&s)[PER], int n0) {
    dots(s, qs, ks);
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = n0 + t + 4 * i < p.seq ? s[i] * p.scale : kNegInf;
  };
  float mx = kNegInf, sum = 0.f;
  for (int n0 = 0; n0 < p.seq; n0 += kFN) {
    load_kv(n0, false);
    float s[PER];
    scores(s, n0);
    float m = mx;
#pragma unroll
    for (int i = 0; i < PER; ++i) m = fmaxf(m, s[i]);
    m = quad_max(m);
    float add = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) add += expf(s[i] - m);
    sum = sum * expf(mx - m) + add;
    mx = m;
  }
  const float total = quad_sum(sum);
  auto probs = [&](float (&s)[PER], float (&dp)[PER], int n0) {
    load_kv(n0, true);
    scores(s, n0);
    dots(dp, dos, vs);
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = expf(s[i] - mx) / total;
  };
  float dl = 0.f;
  for (int n0 = 0; n0 < p.seq; n0 += kFN) {
    float s[PER], dp[PER];
    probs(s, dp, n0);
#pragma unroll
    for (int i = 0; i < PER; ++i) dl += s[i] * dp[i];
  }
  const float delta = quad_sum(dl);
  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < p.seq; n0 += kFN) {
    float s[PER], dp[PER];
    probs(s, dp, n0);
#pragma unroll
    for (int i = 0; i < PER; ++i) ps[r * (kFN + 1) + t + 4 * i] = s[i] * (dp[i] - delta) * p.scale;
    __syncwarp();  // a row's quad lives in one warp
    for (int c = 0; c < kFN; ++c) {
      const float pc = ps[r * (kFN + 1) + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) acc[i] = fmaf(pc, ks[c * LD + t + 4 * i], acc[i]);
    }
    __syncwarp();
  }
  if (m0 + r < p.seq) {
    const long long row = static_cast<long long>(b) * p.seq + m0 + r;
    float* dq = static_cast<float*>(p.dqkv) + row * ld + h * D;
#pragma unroll
    for (int i = 0; i < OUT; ++i) dq[t + 4 * i] = acc[i];
    if (t == 0) {
      float* st = p.stats + (row * p.heads + h) * 3;
      st[0] = mx;
      st[1] = total;
      st[2] = delta;
    }
  }
}

// fp32 dk and dv: 32 keys, a quad of threads per key, walking query tiles
template <int D>
__global__ void __launch_bounds__(kAttnThreads) attn_dkv_f32(const AttnBwdParams p) {
  constexpr int LD = D + 1, PER = kFN / 4, OUT = D / 4;
  extern __shared__ float fsmem[];
  float* ks = fsmem;
  float* vs = ks + kFM * LD;
  float* qs = vs + kFM * LD;
  float* dos = qs + kFN * LD;
  float* ps = dos + kFN * LD;
  float* dss = ps + kFM * (kFN + 1);
  float* st = dss + kFM * (kFN + 1);
  const int n0 = blockIdx.x * kFM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / 4, t = tid % 4;
  const long long ld = 3LL * p.dim;
  const float* item = static_cast<const float*>(p.qkv) + static_cast<long long>(b) * p.seq * ld;
  const float* qg = item + h * D;
  const float* kg = item + p.dim + h * D;
  const float* vg = item + 2 * p.dim + h * D;
  const float* dog = static_cast<const float*>(p.dout) + static_cast<long long>(b) * p.seq * p.dim + h * D;
  const float* stats = p.stats + static_cast<long long>(b) * p.seq * p.heads * 3 + h * 3;
  for (int c = tid; c < kFM * D; c += kAttnThreads) {
    const int rr = c / D, d = c % D;
    const bool ok = n0 + rr < p.seq;
    ks[rr * LD + d] = ok ? kg[(n0 + rr) * ld + d] : 0.f;
    vs[rr * LD + d] = ok ? vg[(n0 + rr) * ld + d] : 0.f;
  }
  float dk[OUT], dv[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = 0; q0 < p.seq; q0 += kFN) {
    __syncthreads();
    for (int c = tid; c < kFN * D; c += kAttnThreads) {
      const int rr = c / D, d = c % D;
      const bool ok = q0 + rr < p.seq;
      qs[rr * LD + d] = ok ? qg[(q0 + rr) * ld + d] : 0.f;
      dos[rr * LD + d] = ok ? dog[static_cast<long long>(q0 + rr) * p.dim + d] : 0.f;
    }
    for (int i = tid; i < kFN * 3; i += kAttnThreads) {
      const int rr = i / 3;
      st[i] = q0 + rr < p.seq ? stats[static_cast<long long>(q0 + rr) * p.heads * 3 + i % 3] : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + 4 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(ks[r * LD + d], qs[c * LD + d], s);
        dp = fmaf(vs[r * LD + d], dos[c * LD + d], dp);
      }
      const float pr = q0 + c < p.seq ? expf(s * p.scale - st[3 * c]) / st[3 * c + 1] : 0.f;
      ps[r * (kFN + 1) + c] = pr;
      dss[r * (kFN + 1) + c] = pr * (dp - st[3 * c + 2]) * p.scale;
    }
    __syncwarp();
    for (int c = 0; c < kFN; ++c) {
      const float pc = ps[r * (kFN + 1) + c], dc = dss[r * (kFN + 1) + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) {
        dv[i] = fmaf(pc, dos[c * LD + t + 4 * i], dv[i]);
        dk[i] = fmaf(dc, qs[c * LD + t + 4 * i], dk[i]);
      }
    }
  }
  if (n0 + r < p.seq) {
    float* kr = static_cast<float*>(p.dqkv) + (static_cast<long long>(b) * p.seq + n0 + r) * ld +
                p.dim + h * D;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      kr[t + 4 * i] = dk[i];
      kr[p.dim + t + 4 * i] = dv[i];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const AttnBwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kAttnThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_attention_bwd_f32(const AttnBwdParams& p, int batch, cudaStream_t s) {
  const dim3 grid((p.seq + kFM - 1) / kFM, p.heads, batch);
  cudaError_t err = launch(attn_dq_f32<D>, grid, attn_f32_smem<D>(), s, p);
  if (err != cudaSuccess) return err;
  return launch(attn_dkv_f32<D>, grid, attn_f32_smem<D>(), s, p);
}

// bf16: the dq kernel over 64-key tiles split between its WG warpgroups,
// then the dk/dv kernel over NT query tiles
template <int NTW, int WG, int NT>
cudaError_t launch_attention_bwd_wgmma(const AttnBwdParams& p, int batch, cudaStream_t s) {
  static_assert(NTW * WG >= NT, "the dq kernel's tiles cover the keys");
  using Dq = DqLayout<NTW, WG>;
  constexpr int kDkvBytes = dkv_wgmma_smem<NT, kDkvWarpgroups>();
  int sms = 0;
  cudaError_t err = bgemm::prepare<&attn_dq_wgmma<NTW, WG>>(Dq::kBytes, &sms);
  if (err == cudaSuccess) err = bgemm::prepare<&attn_dkv_wgmma<NT, kDkvWarpgroups>>(kDkvBytes, &sms);
  if (err != cudaSuccess) return err;
  // dq: with two stages a block an SM, persistent over the tiles; with one, a block a tile
  const int tiles = (p.seq + 63) / 64 * p.heads * batch;
  attn_dq_wgmma<NTW, WG><<<Dq::kStages == 2 && sms < tiles ? sms : tiles, kWarpgroup * WG, Dq::kBytes, s>>>(
      p, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((p.seq + 64 * kDkvWarpgroups - 1) / (64 * kDkvWarpgroups), p.heads, batch);
  attn_dkv_wgmma<NT, kDkvWarpgroups><<<kv_grid, kWarpgroup * kDkvWarpgroups, kDkvBytes, s>>>(p);
  return cudaGetLastError();
}

// the dq kernel up to four key tiles (S <= 256): four warpgroups of one
// tile; up to eight (S <= 512): two of three or four
cudaError_t launch_attention_bwd_bf16(const AttnBwdParams& p, int batch, cudaStream_t s) {
  switch ((p.seq + 63) / 64) {
    case 1: return launch_attention_bwd_wgmma<1, 4, 1>(p, batch, s);
    case 2: return launch_attention_bwd_wgmma<1, 4, 2>(p, batch, s);
    case 3: return launch_attention_bwd_wgmma<1, 4, 3>(p, batch, s);
    case 4: return launch_attention_bwd_wgmma<1, 4, 4>(p, batch, s);
    case 5: return launch_attention_bwd_wgmma<3, 2, 5>(p, batch, s);
    case 6: return launch_attention_bwd_wgmma<3, 2, 6>(p, batch, s);
    case 7: return launch_attention_bwd_wgmma<4, 2, 7>(p, batch, s);
    case 8: return launch_attention_bwd_wgmma<4, 2, 8>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the bf16 dq kernel (kernel 0) or dk/dv kernel
// (kernel 1) for items of seq tokens (0 above 512)
int attention_bwd_bf16_smem(int kernel, int seq) {
  switch ((seq + 63) / 64) {
    case 1: return kernel ? dkv_wgmma_smem<1, kDkvWarpgroups>() : DqLayout<1, 4>::kBytes;
    case 2: return kernel ? dkv_wgmma_smem<2, kDkvWarpgroups>() : DqLayout<1, 4>::kBytes;
    case 3: return kernel ? dkv_wgmma_smem<3, kDkvWarpgroups>() : DqLayout<1, 4>::kBytes;
    case 4: return kernel ? dkv_wgmma_smem<4, kDkvWarpgroups>() : DqLayout<1, 4>::kBytes;
    case 5: return kernel ? dkv_wgmma_smem<5, kDkvWarpgroups>() : DqLayout<3, 2>::kBytes;
    case 6: return kernel ? dkv_wgmma_smem<6, kDkvWarpgroups>() : DqLayout<3, 2>::kBytes;
    case 7: return kernel ? dkv_wgmma_smem<7, kDkvWarpgroups>() : DqLayout<4, 2>::kBytes;
    case 8: return kernel ? dkv_wgmma_smem<8, kDkvWarpgroups>() : DqLayout<4, 2>::kBytes;
    default: return 0;
  }
}

// ----------------------------------------------------- block_grad_reduce
//
// dst[i] = sum over c in order of src[c * size + i] for every partial, in
// fp32 from 0, each add rounded in turn: the bits of a sequential fp32 sum,
// which a plain in-order sum reproduces exactly.  Bound by bytes (each
// partial read once: 59 MB at the train_tiny shape, 0.018 ms at 3.35
// TB/s).  An element's adds are a chain, so a thread issues the loads of a
// batch of chunks (128 bytes of them) before it adds them in order: the
// chain waits on chunks / batch round trips to memory, not on chunks.  The
// host's schedule (ops/vit_block.py::grad_reduce_plan) gives each partial
// its own blocks, sized by its elements: 4 adjacent elements a thread
// (16-byte loads, 8 chunks a batch) where a partial has few chunks (the
// weight gradients' 32), one element a thread (32 chunks a batch) where it
// has many (the LayerNorm partials' 256 of 192 elements), so that the long
// chains have four times the threads; their blocks come first.

constexpr int kMaxSegments = 16;
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 8;  // 16-byte loads a thread keeps in flight

struct ReduceParams {
  long long src[kMaxSegments], dst[kMaxSegments], size[kMaxSegments];
  int chunks[kMaxSegments], vec[kMaxSegments];
  int first_block[kMaxSegments + 1];  // partial s takes blocks [first_block[s], first_block[s + 1])
  int n;
};

// elements [VEC t, VEC t + VEC) of one partial summed over its chunks in order
template <int VEC, int BATCH>
__device__ __forceinline__ void sum_in_order(const float* src, float* dst, long long size, int chunks,
                                             long long t) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const V* at = reinterpret_cast<const V*>(src) + t;
  const long long step = size / VEC;  // one chunk on
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  auto add = [&](const V& v) {
    if constexpr (VEC == 4) {
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    } else {
      acc[0] += v;
    }
  };
  int c = 0;
  for (; c + BATCH <= chunks; c += BATCH) {
    V v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = __ldg(at + (c + u) * step);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) add(v[u]);
  }
  for (; c < chunks; ++c) add(__ldg(at + c * step));
  if constexpr (VEC == 4) {
    reinterpret_cast<float4*>(dst)[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    dst[t] = acc[0];
  }
}

__global__ void __launch_bounds__(kReduceThreads) grad_reduce(const ReduceParams p) {
  // this block's partial: the last whose first block is at or before it,
  // its fields read at constant indices (a parameter array indexed at run
  // time would be copied to local memory)
  long long src = p.src[0], dst = p.dst[0], size = p.size[0];
  int chunks = p.chunks[0], vec = p.vec[0], first = p.first_block[0];
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k)
    if (k < p.n && static_cast<int>(blockIdx.x) >= p.first_block[k]) {
      src = p.src[k];
      dst = p.dst[k];
      size = p.size[k];
      chunks = p.chunks[k];
      vec = p.vec[k];
      first = p.first_block[k];
    }
  const long long t = static_cast<long long>(blockIdx.x - first) * kReduceThreads + threadIdx.x;
  const float* in = reinterpret_cast<const float*>(src);
  float* out = reinterpret_cast<float*>(dst);
  if (vec == 4) {
    if (t < size / 4) sum_in_order<4, kReduceBatch>(in, out, size, chunks, t);
  } else if (t < size) {
    sum_in_order<1, 4 * kReduceBatch>(in, out, size, chunks, t);
  }
}

template <typename Kernel, typename Params>
cudaError_t launch_gemm(Kernel kernel, dim3 grid, cudaStream_t s, const Params& p) {
  kernel<<<grid, kGemmThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// the bf16 GEMMs: their tensor maps encoded here, per call; 0 on success,
// a cudaError_t, or minus the CUresult of a map that failed to encode
template <int BN>
int launch_dgrad_bf16(const DgradParams& p, cudaStream_t s) {
  using namespace bgemm;
  const int kpad = padded_depth(p.k);
  if (kpad * BN * 2 > kSlabBytes) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tg;
  const CUresult r = encode_rows(&tg, p.g, p.m, p.k);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = prepare<&dgrad_wgmma<BN>>(ws_most_bytes(BN), &sms);
  if (err != cudaSuccess) return err;
  dgrad_wgmma<BN><<<ws_grid(p.m, p.n, BN, sms), kThreads, WsLayout(kpad, BN).bytes, s>>>(p, tg);
  return cudaGetLastError();
}

template <int BN>
int launch_wgrad_bf16(const WgradParams& p, cudaStream_t s) {
  using namespace bgemm;
  if (p.chunk % kRows) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tg, ta;
  CUresult r = encode_rows(&tg, p.g, p.m, p.n_out);
  if (r == CUDA_SUCCESS) r = encode_rows(&ta, p.a, p.m, p.n_in);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = prepare<&wgrad_wgmma<BN>>(wgrad_smem<BN>(), &sms);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_in + BN - 1) / BN, (p.n_out + kRows * kWgConsumers - 1) / (kRows * kWgConsumers),
                  (p.m + p.chunk - 1) / p.chunk);
  wgrad_wgmma<BN><<<grid, kWgThreads, wgrad_smem<BN>(), s>>>(p, tg, ta);
  return cudaGetLastError();
}

}  // namespace

// y = LayerNorm(x) rounded to the compute dtype, rows of n (fp32 gamma, beta).
// Returns the launch's cudaError_t (0 on success), as every function here.
extern "C" int vit_block_ln(const void* x, const void* g, const void* b, void* y, int m, int n,
                            int is_bf16, void* stream) {
  const dim3 grid((m + kRowWarps - 1) / kRowWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16)
    ln_rows<bf16><<<grid, kRowWarps * 32, 0, s>>>(static_cast<const bf16*>(x), gf, bf,
                                                  static_cast<bf16*>(y), m, n);
  else
    ln_rows<float><<<grid, kRowWarps * 32, 0, s>>>(static_cast<const float*>(x), gf, bf,
                                                   static_cast<float*>(y), m, n);
  return cudaGetLastError();
}

// c (m, n) = g (m, k) . W (k, n), W's rows from w0/w1/w2 (seg rows each,
// fp32 (seg, n)); mode 0 rounds, 1 applies the gelu backward against up
// and writes gelu(up) to hmid, 2 writes fp32.  k and n multiples of 16.
// bf16 runs the weight-stationary kernel with slabs of bn columns (8, 16,
// 32 or 64; a bf16 slab of padded k by bn at most kSlabBytes); fp32
// ignores bn.  0 on success, a cudaError_t, or minus a map's CUresult.
extern "C" int vit_block_dgrad(const void* g, const void* w0, const void* w1, const void* w2,
                               const void* up, void* hmid, void* c, int m, int n, int k, int seg,
                               int mode, int is_bf16, int bn, void* stream) {
  DgradParams p{};
  p.g = g;
  p.w[0] = static_cast<const float*>(w0);
  p.w[1] = static_cast<const float*>(w1);
  p.w[2] = static_cast<const float*>(w2);
  p.up = up;
  p.hmid = hmid;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.seg = seg;
  p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (bn) {
      case 8: return launch_dgrad_bf16<8>(p, s);
      case 16: return launch_dgrad_bf16<16>(p, s);
      case 32: return launch_dgrad_bf16<32>(p, s);
      case 64: return launch_dgrad_bf16<64>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  return launch_gemm(dgrad_f32, grid, s, p);
}

// out = base + LayerNorm-backward(dln) for the LayerNorm of xin with scale
// gamma, in fp32 (out_f32, may be null) and rounded (out_c); per chunk of
// rows the partials of dgamma and dbeta.  n up to 1024.
extern "C" int vit_block_ln_bwd(const void* dln, const void* xin, const void* gamma,
                                const void* base, int base_f32, void* out_f32, void* out_c,
                                void* part_g, void* part_b, int m, int n, int chunk, int is_bf16,
                                void* stream) {
  LnBwdParams p{static_cast<const float*>(dln), xin, static_cast<const float*>(gamma), base,
                base_f32, static_cast<float*>(out_f32), out_c, static_cast<float*>(part_g),
                static_cast<float*>(part_b), m, n, chunk};
  if (n > 1024) return cudaErrorInvalidValue;
  const dim3 grid((m + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (n + 31) / 32;
#define LN_BWD_CASE(NJ)                                                           \
  if (nj <= NJ) {                                                                 \
    if (is_bf16) ln_bwd<bf16, NJ><<<grid, kRowWarps * 32, 0, s>>>(p);             \
    else ln_bwd<float, NJ><<<grid, kRowWarps * 32, 0, s>>>(p);                    \
    return cudaGetLastError();                                                    \
  }
  LN_BWD_CASE(2)
  LN_BWD_CASE(4)
  LN_BWD_CASE(8)
  LN_BWD_CASE(16)
  LN_BWD_CASE(32)
#undef LN_BWD_CASE
  return cudaErrorInvalidValue;
}

// per chunk of rows, part_w = g^T . a (fp32 (chunks, n_out, n_in)) and
// part_b = the column sums of bsrc (fp32 (chunks, n_out)).  n_out and n_in
// multiples of 16, chunk a multiple of 64.  bf16 runs tiles of bn input
// columns (64, 128 or 192); fp32 ignores bn.
extern "C" int vit_block_wgrad(const void* g, const void* a, const void* bsrc, int bsrc_f32,
                               void* part_w, void* part_b, int m, int n_out, int n_in, int chunk,
                               int is_bf16, int bn, void* stream) {
  WgradParams p{g, a, bsrc, bsrc_f32, static_cast<float*>(part_w), static_cast<float*>(part_b),
                m, n_out, n_in, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (bn) {
      case 64: return launch_wgrad_bf16<64>(p, s);
      case 128: return launch_wgrad_bf16<128>(p, s);
      case 192: return launch_wgrad_bf16<192>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const dim3 grid((n_in + kBN - 1) / kBN, (n_out + kBM - 1) / kBM, (m + chunk - 1) / chunk);
  return launch_gemm(wgrad_f32, grid, s, p);
}

// dynamic shared memory of the bf16 block_gemm_dgrad kernel at depth k and
// slab width bn (0 if the slab is above kSlabBytes), and of
// block_gemm_wgrad's at tile width bn
extern "C" int vit_block_dgrad_smem(int k, int bn) {
  const int kpad = bgemm::padded_depth(k);
  return kpad * bn * 2 > bgemm::kSlabBytes ? 0 : bgemm::WsLayout(kpad, bn).bytes;
}

extern "C" int vit_block_wgrad_smem(int bn) {
  return bn == 64 ? wgrad_smem<64>() : bn == 128 ? wgrad_smem<128>() : bn == 192 ? wgrad_smem<192>() : 0;
}

// dqkv (batch * seq, 3 * heads * head_dim) of the packed attention for the
// output cotangent dout (batch * seq, heads * head_dim); stats is fp32
// scratch (batch * seq, heads, 3).  Launches the dq kernel, which writes
// each query row's statistics there, then the dk/dv kernel, which reads
// them.  bf16 takes head_dim 64 and seq up to 512; fp32 head_dim a multiple
// of 16 up to 128.
extern "C" int vit_block_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                       int batch, int seq, int heads, int head_dim, float scale,
                                       int is_bf16, void* stream) {
  const AttnBwdParams p{qkv, dout, dqkv, static_cast<float*>(stats), seq, heads * head_dim,
                        heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return head_dim == kHeadDim ? launch_attention_bwd_bf16(p, batch, s) : cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return launch_attention_bwd_f32<16>(p, batch, s);
    case 32: return launch_attention_bwd_f32<32>(p, batch, s);
    case 48: return launch_attention_bwd_f32<48>(p, batch, s);
    case 64: return launch_attention_bwd_f32<64>(p, batch, s);
    case 80: return launch_attention_bwd_f32<80>(p, batch, s);
    case 96: return launch_attention_bwd_f32<96>(p, batch, s);
    case 112: return launch_attention_bwd_f32<112>(p, batch, s);
    case 128: return launch_attention_bwd_f32<128>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the bf16 attention backward's dq kernel (kernel
// 0) or dk/dv kernel (kernel 1) for items of seq tokens (0 above 512)
extern "C" int vit_block_attention_bwd_smem(int kernel, int seq) { return attention_bwd_bf16_smem(kernel, seq); }

// desc: n groups of (src pointer, dst pointer, chunks, size, elements a
// thread (1 or 4), first block) in launch order, `blocks` in all
// (ops/vit_block.py::grad_reduce_plan); dst[i] = sum over c in order of
// src[c * size + i].  n up to 16; 4 elements a thread needs 16-byte aligned
// pointers and size a multiple of 4.
extern "C" int vit_block_grad_reduce(const long long* desc, int n, int blocks, void* stream) {
  if (n < 1 || n > kMaxSegments || blocks < 1) return cudaErrorInvalidValue;
  ReduceParams p{};
  p.n = n;
  for (int i = 0; i < n; ++i) {
    const long long* g = desc + 6 * i;
    p.src[i] = g[0];
    p.dst[i] = g[1];
    p.chunks[i] = static_cast<int>(g[2]);
    p.size[i] = g[3];
    p.vec[i] = static_cast<int>(g[4]);
    p.first_block[i] = static_cast<int>(g[5]);
    if (p.vec[i] != 1 && (p.vec[i] != 4 || (p.src[i] | p.dst[i]) % 16 || p.size[i] % 4))
      return cudaErrorInvalidValue;
  }
  p.first_block[n] = blocks;
  grad_reduce<<<blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
