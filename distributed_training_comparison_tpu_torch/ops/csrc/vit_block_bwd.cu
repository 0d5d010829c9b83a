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
//   r1 and the pre-gelu up.  A persistent grid, a half-warp a row (the row
//   kernels, below).
// - block_gemm_dgrad: C = G . W, the TPU kernel's _gemm_T (vit_block.py:113;
//   W the fp32 nn.Linear weight (K, N), rounded to the compute dtype, in up
//   to three row segments).  Epilogues: round (dO); gelu backward against
//   up, rounded, with gelu(up) rounded as a second output (dup and the
//   recomputed hmid); fp32 (dLN2, dLN1).
// - block_ln_bwd: per row, base + (dxhat - mean(dxhat) - xhat mean(dxhat
//   xhat)) / sigma with dxhat = dln gamma, fp32, written in fp32 and/or
//   rounded (dr1 and its rounded copy; dx), and per block of rows the
//   partials of dgamma = sum dln xhat and dbeta = sum dln, in an order
//   fixed by the schedule (ln_bwd, below).
// - block_gemm_wgrad: dW = G^T . A, the TPU kernel's _acc_T (vit_block.py:
//   120), per chunk of rows into fp32 partials (one block per output tile
//   and chunk), with the bias column sums of a second source taken by the
//   blocks of the first input tile.
// - block_attention_bwd: per (item, head) with P recomputed by the exact
//   softmax of K5 (head_bwd's numerics): one kernel owns 64 query rows (P,
//   delta = sum_j dp P on the fp32 P, dq = round(ds scale) . K) and writes
//   each row's max, sum and delta to an fp32 scratch; a second owns 64 keys
//   and walks the query tiles for dk = round(ds scale)^T . Q and dv =
//   round(P)^T . dO.  No atomics.  fp32 runs the same two launches in
//   3xTF32 (block_attn_dq_tf32x3, block_attn_dkv_tf32x3, below), the first
//   computing each row's statistics in a pass of its own.
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
// fp32 (the entry point's default precision) runs every product in 3xTF32
// on wgmma (tf32x3.cuh: each fp32 operand split into two tf32 terms, three
// tf32 products an fp32 one, fp32 accuracy): dgrad_tf32x3 and wgrad_tf32x3
// on block_gemm_tf32.cuh's core (B' K-major in shared memory: dgrad's W and
// both of wgrad's operands transposed as they are staged; wgrad's bias
// column sums loaded a stage ahead and added under the products, in a fixed
// order), and the attention's block_attn_dq_tf32x3 and
// block_attn_dkv_tf32x3 (below).

#include <type_traits>

#include "attention_tiles.cuh"
#include "block_gemm.cuh"
#include "block_gemm_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

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

// ------------------------------------------------------ the row kernels

// block_ln (ln_rows) and block_ln_bwd (ln_bwd) do no products and a few
// operations an element, so bytes bound them.  Each moves every byte once:
// a row goes from its loads to its stores in registers, read and written
// through 16-byte (fp32) or 8-byte (bf16) vectors of four columns a lane,
// and every load of a row is issued before its first reduction.  A row
// group of G lanes takes a row: a half-warp for rows of up to
// kLnNarrowMaxN columns (192, the train paths' width: 3 vectors a lane),
// two rows in flight each, so a warp holds four; a warp for wider rows,
// one in flight (two rows of 256 columns a half-warp need more registers
// than two blocks an SM leave a thread, and spill).  Lane l's vector v
// holds columns 4 (l + G v) to + 3: n is a multiple of 16, so a vector
// lies wholly inside the row or wholly past it.  gamma (and beta) sit in
// registers, loaded once a thread.
constexpr int kLnThreads = 256;       // both kernels' blocks
constexpr int kLnNarrowMaxN = 192;    // rows up to this wide take a half-warp
constexpr int kLnNarrowLanes = 16;
constexpr int kLnNarrowInFlight = 2;  // rows a row group holds at once
constexpr int kLnWideLanes = 32;
constexpr int kLnWideInFlight = 1;
constexpr int kLnRowsBlocksPerSM = 3;  // ln_rows' persistent grid, at most (narrow rows)

// G lanes a row, NV vectors a lane, RIF rows in flight a row group
template <int G_, int NV_, int RIF_>
struct LnSchedule {
  static constexpr int G = G_, NV = NV_, RIF = RIF_, kGroups = kLnThreads / G_;
};

// f(the LnSchedule of rows of n columns), n a multiple of 16 up to 1024
template <typename F>
int with_ln_schedule(int n, F&& f) {
  constexpr int narrow = 4 * kLnNarrowLanes, wide = 4 * kLnWideLanes;
  if (n <= kLnNarrowMaxN) {
    switch ((n + narrow - 1) / narrow) {
      case 1: return f(LnSchedule<kLnNarrowLanes, 1, kLnNarrowInFlight>{});
      case 2: return f(LnSchedule<kLnNarrowLanes, 2, kLnNarrowInFlight>{});
      case 3: return f(LnSchedule<kLnNarrowLanes, 3, kLnNarrowInFlight>{});
    }
  } else {
    switch ((n + wide - 1) / wide) {
      case 2: return f(LnSchedule<kLnWideLanes, 2, kLnWideInFlight>{});
      case 3: return f(LnSchedule<kLnWideLanes, 3, kLnWideInFlight>{});
      case 4: return f(LnSchedule<kLnWideLanes, 4, kLnWideInFlight>{});
      case 5: return f(LnSchedule<kLnWideLanes, 5, kLnWideInFlight>{});
      case 6: return f(LnSchedule<kLnWideLanes, 6, kLnWideInFlight>{});
      case 7: return f(LnSchedule<kLnWideLanes, 7, kLnWideInFlight>{});
      case 8: return f(LnSchedule<kLnWideLanes, 8, kLnWideInFlight>{});
    }
  }
  return cudaErrorInvalidValue;
}

// the sum of x over a row group's G lanes, on each of them (the xor
// shuffles stay inside an aligned group of G lanes)
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// four consecutive elements, in fp32
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {  // each rounded to nearest
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// lane's columns: which of its NV vectors lie inside a row of n, and the
// fp32 vector at those columns of src (zeros past the row)
template <int G, int NV>
__device__ __forceinline__ void row_vectors(bool (&on)[NV], float (&v)[NV][4], const float* src, int lane,
                                            int n) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = 4 * (lane + G * j);
    on[j] = c < n;
    if (on[j]) load4(v[j], src + c);
    else v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
  }
}

// ------------------------------------------------------------- block_ln

// y = LayerNorm(x) rounded to T (fp32 statistics, E[x^2] - mu^2).  A
// persistent grid of B blocks, as many an SM as fit up to
// kLnRowsBlocksPerSM (ln_rows_grid): block b takes rows [b m / B,
// (b + 1) m / B), so that every SM moves as many rows within a few, and
// its row group g takes rows lo + (t kGroups + g) RIF + k, k < RIF, for
// t = 0, 1, ...
template <typename T, int G, int NV, int RIF>
__global__ void __launch_bounds__(kLnThreads, G == kLnNarrowLanes ? kLnRowsBlocksPerSM : 1)
    ln_rows(const T* x, const float* gamma, const float* beta, T* y, int m, int n) {
  constexpr int kGroups = kLnThreads / G;
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * m / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * m / gridDim.x);
  bool on[NV];
  float ga[NV][4], be[NV][4];
  row_vectors<G, NV>(on, ga, gamma, lane, n);
  row_vectors<G, NV>(on, be, beta, lane, n);
  const int steps = (hi - lo + kGroups * RIF - 1) / (kGroups * RIF);  // the same for the block
  for (int t = 0; t < steps; ++t) {
    const int row0 = lo + (t * kGroups + group) * RIF;
    float xv[RIF][NV][4], s[RIF], ss[RIF];
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      const T* xr = x + static_cast<long long>(row0 + k) * n;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (row0 + k < hi && on[j]) load4(xv[k][j], xr + 4 * (lane + G * j));
        else xv[k][j][0] = xv[k][j][1] = xv[k][j][2] = xv[k][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      s[k] = ss[k] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[k] += xv[k][j][e];
          ss[k] += xv[k][j][e] * xv[k][j][e];
        }
      s[k] = group_sum<G>(s[k]);
      ss[k] = group_sum<G>(ss[k]);
    }
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      if (row0 + k >= hi) continue;
      const float mu = s[k] / n;
      const float rs = 1.f / sqrtf(ss[k] / n - mu * mu + kLnEps);
      T* yr = y + static_cast<long long>(row0 + k) * n;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!on[j]) continue;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = (xv[k][j][e] - mu) * rs * ga[j][e] + be[j][e];
        store4(yr + 4 * (lane + G * j), o);
      }
    }
  }
}

// ln_rows' grid for m rows: a block a kGroups RIF rows, at most as many
// blocks as fit on the card at once (the occupancy of that instantiation,
// up to kLnRowsBlocksPerSM an SM)
template <typename T, int G, int NV, int RIF>
int ln_rows_grid(int m, int sms) {
  static const int per_sm = [] {
    int b = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, ln_rows<T, G, NV, RIF>, kLnThreads, 0);
    return b < 1 ? 1 : b < kLnRowsBlocksPerSM ? b : kLnRowsBlocksPerSM;
  }();
  const int need = (m + kLnThreads / G * RIF - 1) / (kLnThreads / G * RIF);
  return need < per_sm * sms ? need : per_sm * sms;
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

// K6's data-gradient products in bf16, weight-stationary (block_gemm.cuh):
// C = G . W with W (k, n) converted once per block into the K-major slab of
// BN columns (8 rows of k gathered a chunk), G streamed through the rings;
// the epilogue, on pairs of columns: rounded (mode 0), the gelu backward
// against up with gelu(up) beside it, both rounded (mode 1), fp32 (mode 2).
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

// K6's data-gradient products in fp32, 3xTF32 on wgmma (block_gemm_tf32.cuh's
// core): A' the rows of G as stored; B' W (k, n, in row segments)
// transposed as the producer splits it, so that its row j is column j of W.
// The epilogue stores the product (modes 0 and 2 alike: the compute dtype's
// rounding is none), or the gelu backward against up with gelu(up) beside
// it (mode 1).
__global__ void __launch_bounds__(tgemm::kThreads, 1) dgrad_tf32x3(const DgradParams p) {
  using namespace tgemm;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const float* g = static_cast<const float*>(p.g);
  const Operand G{{g, g, g}, p.m, p.k, p.m};
  const Operand Wt{{p.w[0], p.w[1], p.w[2]}, p.seg, p.n, p.n};
  float* out = static_cast<float*>(p.c);
  run<false, true>(
      aligned_smem(gemm_smem), G, Wt, Tiles(p.m, p.n, p.k, p.k).at(blockIdx.x), nullptr, nullptr, [](int) {},
      [] {}, [&](const float (&acc)[32], int row, int col) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row + 8 * i;
          if (r >= p.m) continue;
#pragma unroll
          for (int n = 0; n < kBN / 8; ++n) {
            const int cc = col + 8 * n;
            if (cc >= p.n) continue;
            const long long at = static_cast<long long>(r) * p.n + cc;
            float v0 = acc[4 * n + 2 * i], v1 = acc[4 * n + 2 * i + 1];
            if (p.mode == 1) {
              const float2 u = *reinterpret_cast<const float2*>(static_cast<const float*>(p.up) + at);
              *reinterpret_cast<float2*>(static_cast<float*>(p.hmid) + at) =
                  make_float2(gelu_tanh(u.x), gelu_tanh(u.y));
              v0 = gelu_tanh_grad(u.x) * v0;
              v1 = gelu_tanh_grad(u.y) * v1;
            }
            *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
          }
        }
      });
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

// K6's weight-gradient products in fp32, 3xTF32 on wgmma (block_gemm_tf32.cuh's
// core): per row chunk (blockIdx.z), A' = G^T and B' = A^T, both read
// transposed (A' by the consumers from its landed rows, B' as the producer
// splits it), the chunk's rows their depth; a tile 192 rows of out by 64
// columns of in.  A tile of the first 64 input columns also sums the bias
// source's columns over its chunk: each consumer thread 4 columns over
// every 8th row of a stage, its loads issued before it waits for the
// stage; the 8 row phases added in order at the tile's end.
__global__ void __launch_bounds__(tgemm::kThreads, 1) wgrad_tf32x3(const WgradParams p) {
  using namespace tgemm;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  unsigned char* smem = aligned_smem(gemm_smem);
  const float* g = static_cast<const float*>(p.g);
  const float* a = static_cast<const float*>(p.a);
  const Operand Gt{{g, g, g}, p.m, p.n_out, p.n_out};
  const Operand At{{a, a, a}, p.m, p.n_in, p.n_in};
  const float* bsrc = static_cast<const float*>(p.bsrc);
  const Tile t = Tiles(p.n_out, p.n_in, p.m, p.chunk).at(blockIdx.x);
  // a tile of the first input columns sums the bias source's columns
  const bool bias = t.n0 == 0 && p.part_b != nullptr;
  // a consumer thread's bias columns ocol .. + 3, and rows ph + 8j of a stage
  const int ct = static_cast<int>(threadIdx.x) - 128;
  const int ph = ct % 128 / 16, ocol = t.m0 + ct / 128 * 64 + 4 * (ct % 16);
  float4 buf[4];
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  run<true, true>(
      smem, Gt, At, t, nullptr, nullptr,
      [&](int v) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = t.k0 + v * kBK + ph + 8 * j;
          buf[j] = bias && r < t.k1 && ocol < p.n_out
                       ? __ldg(reinterpret_cast<const float4*>(bsrc + static_cast<long long>(r) * p.n_out + ocol))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      },
      [&] {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bsum[0] += buf[j].x;
          bsum[1] += buf[j].y;
          bsum[2] += buf[j].z;
          bsum[3] += buf[j].w;
        }
      },
      [&](const float (&acc)[32], int row, int col) {
        float* out = p.part_w + static_cast<long long>(t.z) * p.n_out * p.n_in;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int o = row + 8 * i;
          if (o >= p.n_out) continue;
#pragma unroll
          for (int n = 0; n < kBN / 8; ++n) {
            const int cc = col + 8 * n;
            if (cc < p.n_in)
              *reinterpret_cast<float2*>(out + static_cast<long long>(o) * p.n_in + cc) =
                  make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
          }
        }
        if (!bias) return;
        float* red = reinterpret_cast<float*>(smem + kRedAt);
#pragma unroll
        for (int q = 0; q < 4; ++q) red[ph * kBM + ocol - t.m0 + q] = bsum[q];
        bgemm::named_sync(2, 128 * kConsumers);
        if (ct < kBM && t.m0 + ct < p.n_out) {
          float total = 0.f;
          for (int q = 0; q < 8; ++q) total += red[q * kBM + ct];
          p.part_b[static_cast<long long>(t.z) * p.n_out + t.m0 + ct] = total;
        }
      });
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

// One block per chunk of rows [r0, r1): row group g of its kGroups takes
// rows r0 + (t kGroups + g) RIF + k, k < RIF, for t = 0, 1, ...; the dln,
// x and base loads of its RIF rows are all issued before the first
// reduction.  The partials: each row group adds its rows into its own fp32
// slices of shared memory (n columns for dgamma, n for dbeta), one row
// after another in the order above (t, then k); then the block sums the
// kGroups slices in group order, from 0, a column a thread.  So a chunk's
// dbeta is, per column, sum over g of (sum of dln over g's rows, in order),
// in fp32, an order the tests mirror bit for bit.  No atomics: two calls
// give identical bits.
template <typename T, int G, int NV, int RIF>
__global__ void __launch_bounds__(kLnThreads, G == kLnNarrowLanes ? 2 : 1) ln_bwd(const LnBwdParams p) {
  extern __shared__ __align__(16) float ln_part[];  // (2, kGroups, n): dgamma's slices, then dbeta's
  constexpr int kGroups = kLnThreads / G;
  const int lane = threadIdx.x % G, group = threadIdx.x / G, n = p.n;
  const int r0 = blockIdx.x * p.chunk, r1 = min(r0 + p.chunk, p.m);
  float* pg = ln_part + group * n;
  float* pb = ln_part + (kGroups + group) * n;
  bool on[NV];
  float ga[NV][4];
  row_vectors<G, NV>(on, ga, p.gamma, lane, n);
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!on[j]) continue;
    store4(pg + 4 * (lane + G * j), zero);
    store4(pb + 4 * (lane + G * j), zero);
  }
  const int steps = (r1 - r0 + kGroups * RIF - 1) / (kGroups * RIF);  // the same for every thread
  for (int t = 0; t < steps; ++t) {
    const int row0 = r0 + (t * kGroups + group) * RIF;
    float dl[RIF][NV][4], xh[RIF][NV][4], bs[RIF][NV][4];
    bool ok[RIF];
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      ok[k] = row0 + k < r1;
      const long long at = static_cast<long long>(row0 + k) * n;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = 4 * (lane + G * j);
        if (ok[k] && on[j]) {
          load4(dl[k][j], p.dln + at + c);
          load4(xh[k][j], static_cast<const T*>(p.xin) + at + c);
          if (p.base_f32) load4(bs[k][j], static_cast<const float*>(p.base) + at + c);
          else load4(bs[k][j], static_cast<const T*>(p.base) + at + c);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) dl[k][j][e] = xh[k][j][e] = bs[k][j][e] = 0.f;
        }
      }
    }
    // the statistics (fp32, E[x^2] - mu^2), then xhat in place of x and the
    // two means of the backward
    float rs[RIF], m1[RIF], m2[RIF];
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s += xh[k][j][e];
          ss += xh[k][j][e] * xh[k][j][e];
        }
      s = group_sum<G>(s);
      ss = group_sum<G>(ss);
      const float mu = s / n;
      rs[k] = 1.f / sqrtf(ss / n - mu * mu + kLnEps);
      m1[k] = m2[k] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xh[k][j][e] = (xh[k][j][e] - mu) * rs[k];
          const float dxh = dl[k][j][e] * ga[j][e];
          m1[k] += dxh;
          m2[k] += dxh * xh[k][j][e];
        }
      m1[k] = group_sum<G>(m1[k]) / n;
      m2[k] = group_sum<G>(m2[k]) / n;
    }
    // this row group's partials, its rows in order
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!on[j]) continue;
      const int c = 4 * (lane + G * j);
      float sg[4], sb[4];
      load4(sg, pg + c);
      load4(sb, pb + c);
#pragma unroll
      for (int k = 0; k < RIF; ++k) {
        if (!ok[k]) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sg[e] += dl[k][j][e] * xh[k][j][e];
          sb[e] += dl[k][j][e];
        }
      }
      store4(pg + c, sg);
      store4(pb + c, sb);
    }
#pragma unroll
    for (int k = 0; k < RIF; ++k) {
      if (!ok[k]) continue;
      const long long at = static_cast<long long>(row0 + k) * n;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!on[j]) continue;
        const int c = 4 * (lane + G * j);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = bs[k][j][e] + (dl[k][j][e] * ga[j][e] - m1[k] - xh[k][j][e] * m2[k]) * rs[k];
        if (p.out_f32) store4(p.out_f32 + at + c, o);
        store4(static_cast<T*>(p.out_c) + at + c, o);
      }
    }
  }
  __syncthreads();
  const long long at = static_cast<long long>(blockIdx.x) * n;
  for (int c = threadIdx.x; c < n; c += kLnThreads) {
    float tg = 0.f, tb = 0.f;
    for (int w = 0; w < kGroups; ++w) {
      tg += ln_part[w * n + c];
      tb += ln_part[(kGroups + w) * n + c];
    }
    p.part_g[at + c] = tg;
    p.part_b[at + c] = tb;
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

// ------------------------------------------- block_attention_bwd, fp32
//
// K6's attention backward in fp32: 3xTF32 on wgmma, on tf32x3.cuh's split,
// ring and products, the schedules of flash_bwd_dq_tf32x3 and
// flash_bwd_dkv_tf32x3 (flash_attention_bwd.cu) over the packed qkv, dO and
// dqkv, two launches with the statistics scratch between them, as in bf16.
// The head dim D (a multiple of 16 up to 128) is padded to DP, 64 or 128:
// no copy takes a column at or past D, so the padding is zeros, and no store
// writes one.  Non-causal.
// - block_attn_dq_tf32x3: a block owns 128 query rows of one (item, head),
//   two consumer warpgroups of 64 holding their Q and dO rows raw in the A
//   fragments' order.  A first pass over the 64-key tiles computes S =
//   Q.K^T and dP = dO.V^T (K and V as DP / 32 natural slots each) and, on
//   the accumulators, each row's running max, sum of exp and sum of P dP,
//   rescaled as the max grows: the row's max and sum, the softmax's, and
//   delta = sum_j P dP, which it writes to the scratch.  The second pass is
//   flash_bwd_dq_tf32x3's: S and dP again, dS = P (dP - delta) scale with P
//   = exp(S scale - lse), dQ += dS.K_j (K transposed, 2 x DP / 64 slots), a
//   fresh accumulator a tile.
// - block_attn_dkv_tf32x3: a block owns 128 keys, two consumer warpgroups of
//   64 holding their K and V rows; per 32-query tile S^T = K.Q_i^T and dP^T
//   = V.dO_i^T (one natural slot of Q_i and dO_i per 32 columns), P^T and
//   dS^T on the accumulators from the scratch's statistics by column, dV +=
//   P^T.dO_i and dK += dS^T.Q_i (dO_i and Q_i transposed, DP / 64 slots
//   each), fresh accumulators a tile.
// Nine products per (64-query, 64-key) tile pair (the statistics pass's
// two on top of flash's seven: the wrapper gets no log-sum-exp from the
// forward), each three tf32 products.  No atomics: each block owns its
// output rows, and every sum runs in a fixed order.

constexpr int kTf32Rows = 128;    // query rows (dq) or keys (dk/dv) a block: two consumer warpgroups of 64
constexpr int kTf32Keys = 64;     // dq: keys a streamed tile
constexpr int kTf32Queries = 32;  // dk/dv: queries a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct AttnBwdF32Params {
  const float* qkv;   // (batch * seq, 3 * dim)
  const float* dout;  // (batch * seq, dim)
  float* dqkv;        // (batch * seq, 3 * dim)
  float* stats;       // (batch * seq, heads, 3): row max, row sum, delta = sum dp P
  int seq, dim, heads, head_dim;
  float scale;
};

template <int DP>
using Tf32AttnBwd = Tf32Layout<DP, 4>;  // own rows: 2 warpgroups x 2 tensors

// a consumer thread's A fragments of rows row0 and row0 + 8 (`len` true
// rows) of a (S, D) fp32 slice with row stride ss, raw, into its own float4
// of each k-step; columns at or past `cols` are zeros
template <int DP>
__device__ __forceinline__ void load_own_cols(unsigned char* own, const float* g, long long ss, int row0, int len,
                                              int cols, int t) {
#pragma unroll 4
  for (int ks = 0; ks < DP / 8; ++ks) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * frag_row(e), col = 8 * ks + t + 4 * frag_col(e);
      x[e] = row < len && col < cols ? g[row * ss + col] : 0.f;
    }
    *reinterpret_cast<float4*>(own + ks * kFrag) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(384, 1) block_attn_dq_tf32x3(const AttnBwdF32Params p) {
  using L = Tf32AttnBwd<DP>;
  constexpr int kN = kTf32Keys;
  constexpr int kStatsTile = 2 * (DP / 32);              // slots a key tile, first pass: K, V
  constexpr int kDqTile = 2 * (DP / 32) + 2 * (DP / 64);  // second pass: K, V, K transposed
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  const int m0 = blockIdx.x * kTf32Rows, h = blockIdx.y, D = p.head_dim;
  const int nk = (p.seq + kN - 1) / kN;
  const int tid = threadIdx.x;
  const long long ld = 3LL * p.dim, item = static_cast<long long>(blockIdx.z) * p.seq;
  const float* qg = p.qkv + item * ld + h * D;
  const float* kg = qg + p.dim;
  const float* vg = qg + 2 * p.dim;
  const float* dog = p.dout + item * p.dim + h * D;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const bool first = u < nk * kStatsTile;
      const int w = first ? u : u - nk * kStatsTile, per = first ? kStatsTile : kDqTile;
      const int r = w % per, n0 = w / per * kN;
      if (r < 2 * (DP / 32)) {
        const bool is_v = r >= DP / 32;
        return SlotSrc{is_v ? vg : kg, is_v ? vg : kg, ld, ld, n0, p.seq, 32 * (is_v ? r - DP / 32 : r), false};
      }
      const int idx = r - 2 * (DP / 32);  // column block idx / 2, key chunk idx % 2
      return SlotSrc{kg, kg, ld, ld, n0 + 32 * (idx % 2), p.seq, 64 * (idx / 2), true};
    };
    produce<kSlotRows, true>(slot_of, nk * (kStatsTile + kDqTile), sbase + L::kRingAt, bars, tid, D);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + 64 * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  unsigned char* const own_q = sbase + 2 * c * L::kOwnTensor + (tid % 128) * 16;
  unsigned char* const own_do = own_q + L::kOwnTensor;
  load_own_cols<DP>(own_q, qg, ld, row0, p.seq, D, t);
  load_own_cols<DP>(own_do, dog, p.dim, row0, p.seq, D, t);  // read back by this thread alone
  const uint32_t ring = base + L::kRingAt;
  const float sl2 = p.scale * kLog2e;

  // first pass: each row's max (in units of scale·log2e), and this thread's
  // shares of its sum of exp and of sum P dP, rescaled as the max grows
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f}, w_run[2] = {0.f, 0.f};
  int u = 0;
  for (int j = 0; j < nk; ++j) {
    float s[kN / 2], dp[kN / 2];
    scores<DP>(s, own_q, ring, bars, u, lane);
    scores<DP>(dp, own_do, ring, bars, u, lane);
    const int n0 = j * kN;
    if (n0 + kN > p.seq) {  // the last tile: keys past S
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * n + 2 * t + (e & 1) >= p.seq) s[4 * n + e] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      const float m_new = fmaxf(m_run[i], quad_max(mx) * sl2);
      const float alpha = exp2f(m_run[i] - m_new);
      float sum = 0.f, wsum = 0.f;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * n + 2 * i + e;
          const float pr = exp2f(fmaf(s[k], sl2, -m_new));
          sum += pr;
          wsum += pr * dp[k];
        }
      l_run[i] = l_run[i] * alpha + sum;
      w_run[i] = w_run[i] * alpha + wsum;
      m_run[i] = m_new;
    }
  }
  float mx[2], sum[2], lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = m_run[i] * kLn2;  // the row's max of scale·S
    sum[i] = fmaxf(quad_sum(l_run[i]), 1e-30f);
    lse[i] = mx[i] + logf(sum[i]);
    delta[i] = quad_sum(w_run[i]) / sum[i];
  }

  // second pass: dS = P (dP - delta) scale into s, then dQ += dS.K_j
  float dq[DP / 64][32];
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[hh][i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    float s[kN / 2], dp[kN / 2];
    scores<DP>(s, own_q, ring, bars, u, lane);
    scores<DP>(dp, own_do, ring, bars, u, lane);
    const int n0 = j * kN;
    const bool masked = n0 + kN > p.seq;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = expf(fmaf(s[4 * n + e], p.scale, -lse[i]));
        if (masked && n0 + 8 * n + 2 * t + (e & 1) >= p.seq) pr = 0.f;
        s[4 * n + e] = pr * (dp[4 * n + e] - delta[i]) * p.scale;
      }
    }
    uint32_t big[kN / 8][4], small[kN / 8][4];
    acc_frags<kN / 8>(big, small, s);
    sums<DP, kN / 8>(dq, big, small, ring, bars, u, lane);
  }

  float* dqg = p.dqkv + item * ld + h * D;
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh) store_f32_cols(dqg, ld, row0, p.seq, 64 * hh, D - 64 * hh, dq[hh], t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.seq) continue;
      float* st = p.stats + ((item + row) * p.heads + h) * 3;
      st[0] = mx[i];
      st[1] = sum[i];
      st[2] = delta[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(384, 1) block_attn_dkv_tf32x3(const AttnBwdF32Params p) {
  using L = Tf32AttnBwd<DP>;
  constexpr int kM = kTf32Queries;
  constexpr int kPerTile = DP / 32 + 2 * (DP / 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  const int n0 = blockIdx.x * kTf32Rows, h = blockIdx.y, D = p.head_dim;
  const int nt = (p.seq + kM - 1) / kM;
  const int tid = threadIdx.x;
  const long long ld = 3LL * p.dim, item = static_cast<long long>(blockIdx.z) * p.seq;
  const float* qg = p.qkv + item * ld + h * D;
  const float* kg = qg + p.dim;
  const float* vg = qg + 2 * p.dim;
  const float* dog = p.dout + item * p.dim + h * D;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int r = u % kPerTile, m = u / kPerTile * kM;
      if (r < DP / 32) return SlotSrc{qg, dog, ld, p.dim, m, p.seq, 32 * r, false};
      const int idx = r - DP / 32;
      const bool is_q = idx >= DP / 64;  // dO_i^T first (for dV), then Q_i^T (for dK)
      return SlotSrc{is_q ? qg : dog, is_q ? qg : dog, is_q ? ld : p.dim, is_q ? ld : p.dim, m, p.seq,
                     64 * (is_q ? idx - DP / 64 : idx), true};
    };
    produce<kM, true>(slot_of, nt * kPerTile, sbase + L::kRingAt, bars, tid, D);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + 64 * c + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
  unsigned char* const own_k = sbase + 2 * c * L::kOwnTensor + (tid % 128) * 16;
  unsigned char* const own_v = own_k + L::kOwnTensor;
  load_own_cols<DP>(own_k, kg, ld, key0, p.seq, D, t);
  load_own_cols<DP>(own_v, vg, ld, key0, p.seq, D, t);  // read back by this thread alone
  const uint32_t ring = base + L::kRingAt;
  const float* stats = p.stats + item * p.heads * 3 + h * 3;

  float dk[DP / 64][32], dv[DP / 64][32];
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;

  int u = 0;
  for (int it = 0; it < nt; ++it) {
    const int m = it * kM;
    float s[kM / 2], dp[kM / 2];
    // S^T and dP^T: per slot, two k-steps' fragments in flight (a k-step's
    // K and V fragments reused two k-steps later, after their products)
#pragma unroll
    for (int cc = 0; cc < DP / 32; ++cc) {
      consumer_wait(bars, u);
      const uint32_t slot = ring + (u % kRing) * kSlotBytes;
      uint32_t kb[2][4], ksm[2][4], vb[2][4], vsm[2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int f = kk & 1;
        if (kk >= 2) {
          wgmma_wait<1>();
          fence_regs<4>(kb[f]);
          fence_regs<4>(ksm[f]);
          fence_regs<4>(vb[f]);
          fence_regs<4>(vsm[f]);
        }
        split4(*reinterpret_cast<const float4*>(own_k + (4 * cc + kk) * kFrag), kb[f], ksm[f]);
        split4(*reinterpret_cast<const float4*>(own_v + (4 * cc + kk) * kFrag), vb[f], vsm[f]);
        wgmma_fence();
        const int acc = cc > 0 || kk > 0;
        wgmma_3xtf32<kM>(s, kb[f], ksm[f], slot + kk * 32, acc);              // Q_i rows
        wgmma_3xtf32<kM>(dp, vb[f], vsm[f], slot + kM * 128 + kk * 32, acc);  // dO_i rows
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<kM / 2>(s);
      fence_regs<kM / 2>(dp);
      fence_regs<8>(&kb[0][0]);
      fence_regs<8>(&ksm[0][0]);
      fence_regs<8>(&vb[0][0]);
      fence_regs<8>(&vsm[0][0]);
      consumer_release(bars, u, lane);
      ++u;
    }
    // P^T into s and dS^T into dp, the statistics by the accumulator's column (query)
#pragma unroll
    for (int n = 0; n < kM / 8; ++n) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int q = m + 8 * n + 2 * t + e2;
        const bool in = q < p.seq;
        const float* st = stats + static_cast<long long>(in ? q : 0) * p.heads * 3;
        const float lse = in ? st[0] + logf(st[1]) : 0.f, delta = in ? st[2] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + e2;
          const float pr = in ? expf(fmaf(s[4 * n + e], p.scale, -lse)) : 0.f;
          s[4 * n + e] = pr;
          dp[4 * n + e] = pr * (dp[4 * n + e] - delta) * p.scale;
        }
      }
    }
    uint32_t big[kM / 8][4], small[kM / 8][4];
    acc_frags<kM / 8>(big, small, s);
    sums<DP, kM / 8>(dv, big, small, ring, bars, u, lane);
    acc_frags<kM / 8>(big, small, dp);
    sums<DP, kM / 8>(dk, big, small, ring, bars, u, lane);
  }

  float* out = p.dqkv + item * ld + h * D;
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh) {
    store_f32_cols(out + p.dim, ld, key0, p.seq, 64 * hh, D - 64 * hh, dk[hh], t);
    store_f32_cols(out + 2 * p.dim, ld, key0, p.seq, 64 * hh, D - 64 * hh, dv[hh], t);
  }
}

template <int DP>
cudaError_t launch_attention_bwd_tf32x3(const AttnBwdF32Params& p, int batch, cudaStream_t s) {
  constexpr int kBytes = Tf32AttnBwd<DP>::kBytes;
  int sms = 0;
  cudaError_t err = bgemm::prepare<&block_attn_dq_tf32x3<DP>>(kBytes, &sms);
  if (err == cudaSuccess) err = bgemm::prepare<&block_attn_dkv_tf32x3<DP>>(kBytes, &sms);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTf32Rows - 1) / kTf32Rows, p.heads, batch);
  block_attn_dq_tf32x3<DP><<<grid, 384, kBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  block_attn_dkv_tf32x3<DP><<<grid, 384, kBytes, s>>>(p);
  return cudaGetLastError();
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

// y = LayerNorm(x) rounded to the compute dtype, rows of n (a multiple of 16
// up to 1024; fp32 gamma, beta).  Returns the launch's cudaError_t (0 on
// success), as every function here.
extern "C" int vit_block_ln(const void* x, const void* g, const void* b, void* y, int m, int n,
                            int is_bf16, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  return with_ln_schedule(n, [&](auto sched) {
    using S = decltype(sched);
    if (is_bf16)
      ln_rows<bf16, S::G, S::NV, S::RIF><<<ln_rows_grid<bf16, S::G, S::NV, S::RIF>(m, sms), kLnThreads, 0, s>>>(
          static_cast<const bf16*>(x), gf, bf, static_cast<bf16*>(y), m, n);
    else
      ln_rows<float, S::G, S::NV, S::RIF><<<ln_rows_grid<float, S::G, S::NV, S::RIF>(m, sms), kLnThreads, 0, s>>>(
          static_cast<const float*>(x), gf, bf, static_cast<float*>(y), m, n);
    return static_cast<int>(cudaGetLastError());
  });
}

// c (m, n) = g (m, k) . W (k, n), W's rows from w0/w1/w2 (seg rows each,
// fp32 (seg, n)); mode 0 rounds, 1 applies the gelu backward against up
// and writes gelu(up) to hmid, 2 writes fp32.  k and n multiples of 16.
// bf16 runs the weight-stationary kernel with slabs of bn columns (8, 16,
// 32 or 64; a bf16 slab of padded k by bn at most kSlabBytes); fp32 runs
// the 3xTF32 kernel and ignores bn.  0 on success, a cudaError_t, or minus
// a map's CUresult.
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
  return tgemm::launch<&dgrad_tf32x3>(tgemm::Tiles(m, n, k, k), s, p);
}

// out = base + LayerNorm-backward(dln) for the LayerNorm of xin with scale
// gamma, in fp32 (out_f32, may be null) and rounded (out_c); per chunk of
// rows the partials of dgamma and dbeta.  n a multiple of 16 up to 1024.
extern "C" int vit_block_ln_bwd(const void* dln, const void* xin, const void* gamma,
                                const void* base, int base_f32, void* out_f32, void* out_c,
                                void* part_g, void* part_b, int m, int n, int chunk, int is_bf16,
                                void* stream) {
  LnBwdParams p{static_cast<const float*>(dln), xin, static_cast<const float*>(gamma), base,
                base_f32, static_cast<float*>(out_f32), out_c, static_cast<float*>(part_g),
                static_cast<float*>(part_b), m, n, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_ln_schedule(n, [&](auto sched) {
    using S = decltype(sched);
    auto kernel = is_bf16 ? ln_bwd<bf16, S::G, S::NV, S::RIF> : ln_bwd<float, S::G, S::NV, S::RIF>;
    const int smem = 2 * S::kGroups * n * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(m + chunk - 1) / chunk, kLnThreads, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  });
}

// per chunk of rows, part_w = g^T . a (fp32 (chunks, n_out, n_in)) and
// part_b = the column sums of bsrc (fp32 (chunks, n_out)).  n_out and n_in
// multiples of 16, chunk a multiple of 64.  bf16 runs tiles of bn input
// columns (64, 128 or 192); fp32 runs the 3xTF32 kernel and ignores bn.
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
  return tgemm::launch<&wgrad_tf32x3>(tgemm::Tiles(n_out, n_in, m, chunk), s, p);
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
// them.  bf16 takes head_dim 64 and seq up to 512 (attn_dq_wgmma,
// attn_dkv_wgmma); fp32 head_dim a multiple of 16 up to 128
// (block_attn_dq_tf32x3, block_attn_dkv_tf32x3, the head dim padded to 64
// or 128) and any seq.
extern "C" int vit_block_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                       int batch, int seq, int heads, int head_dim, float scale,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const AttnBwdParams p{qkv, dout, dqkv, static_cast<float*>(stats), seq, heads * head_dim, heads, scale};
    return head_dim == kHeadDim ? launch_attention_bwd_bf16(p, batch, s) : cudaErrorInvalidValue;
  }
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return cudaErrorInvalidValue;
  const AttnBwdF32Params p{static_cast<const float*>(qkv), static_cast<const float*>(dout), static_cast<float*>(dqkv),
                           static_cast<float*>(stats), seq, heads * head_dim, heads, head_dim, scale};
  return head_dim <= 64 ? launch_attention_bwd_tf32x3<64>(p, batch, s) : launch_attention_bwd_tf32x3<128>(p, batch, s);
}

// dynamic shared memory of the bf16 attention backward's dq kernel (kernel
// 0) or dk/dv kernel (kernel 1) for items of seq tokens (0 above 512)
extern "C" int vit_block_attention_bwd_smem(int kernel, int seq) { return attention_bwd_bf16_smem(kernel, seq); }

// dynamic shared memory of the fp32 (3xTF32) attention backward's kernels
// (both take one layout) at head dim head_dim (0 if it is not taken)
extern "C" int vit_block_attention_bwd_tf32x3_smem(int head_dim) {
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return 0;
  return head_dim <= 64 ? Tf32AttnBwd<64>::kBytes : Tf32AttnBwd<128>::kBytes;
}

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
