// Per-head attention pieces for Hopper (sm_90a), shared by the short-sequence
// attention's one-tile kernels (attention_small.cu, K10/K11) and the fused
// ViT block's attention (vit_block_fwd.cu, vit_block_bwd.cu): 16-byte
// cp.async loads into the 128-byte-swizzled tiles a wgmma descriptor reads,
// the descriptors of those tiles read K-major and MN-major, the score product
// S = A.B^T, the exact softmax of head_fwd over rows held by one or more
// warpgroups, and the stores of a wgmma accumulator.
//
// A tile of ROWS rows and D bf16 columns is D / 64 boxes of ROWS rows x 128
// bytes (hopper_common.cuh): 16-byte chunk c of row r lies at byte
// (c / 8) * box + r * 128 + ((c % 8) ^ (r % 8)) * 16.  A 64-row sub-tile that
// starts at a multiple of 64 rows of a D-64 tile is itself such a tile.
//
// Per thread of a warpgroup, accumulator element 4n + 2i + e of a 64 x N
// product is row 16 warp + g + 8i, column 8n + 2t + e (g = lane / 4, t =
// lane % 4): each thread holds 2 rows, and a row's values sit in the 4
// threads of a quad.

#pragma once

#include "hopper_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite "-inf": exp gives exactly 0
constexpr int kWarpgroup = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes from gmem to the shared address dst
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the same for an n known only after unrolling (0 <= n < 8)
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// x / d, correctly rounded, given r = 1 / d correctly rounded: one
// refinement of x r (Markstein), so the same bits as the IEEE quotient
// wherever it is not subnormal, for a multiply and two FMAs instead of a
// division an element
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  return fmaf(fmaf(-q, d, x), r, q);
}

// rows [0, ROWS) of a (rows, D) column slice of g (row stride ld) into a
// swizzled tile of ROWS-row boxes by the THREADS threads of the block (this
// one is tid); rows at or past `valid` are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_swizzled(uint32_t tile, const __nv_bfloat16* g, long long ld,
                                              int valid, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    cp_async16(tile + (c / 8) * box_bytes<ROWS>() + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               g + (ok ? r * ld : 0) + c * 8, ok);
  }
}

// commits this thread's cp.async since the last commit, waits until at most
// PENDING groups are in flight, and, after the barrier, every thread's landed
// tiles are visible to the async proxy the wgmma products read through
template <int PENDING = 0>
__device__ __forceinline__ void tiles_landed() {
  cp_async_commit();
  cp_async_wait<PENDING>();
  fence_proxy_async();
  __syncthreads();
}

// descriptor of k-step kk of a tile of ROWS-row boxes read K-major (the
// tile's columns are the depth): 16 columns, 32 bytes along the swizzled row,
// the next 64 columns one box on; SBO steps 8 rows
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * box_bytes<ROWS>() + (kk % 4) * 32, 16, 1024);
}

// descriptor of k-step kk of a tile of ROWS-row boxes read MN-major (the
// tile's rows are the depth): 16 rows, 2 KB on; LBO steps the next 64
// columns (one box), SBO 8 rows
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, box_bytes<ROWS>(), 1024);
}

// S (64 x 64 fp32 accumulator) = A.B^T over D: A's 64 rows at `a` in a tile
// of A_ROWS-row boxes, B's 64 rows at `b` in one of B_ROWS-row boxes, both
// K-major
template <int D, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void wgmma_abt(float* s, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(s, desc_kmajor<A_ROWS>(a, kk), desc_kmajor<B_ROWS>(b, kk), kk > 0);
}

__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x % kWarpgroup / 32) + (threadIdx.x % 32) / 4 + 8 * i;
}
__device__ __forceinline__ int acc_col(int n, int e) { return 8 * n + 2 * (threadIdx.x % 4) + e; }

// The 64 query rows that the WG warpgroups of a block share, each holding
// the scores of its own key tiles: a row's partial (max or sum) is combined
// across the warpgroups through slot `slot` of `red` (WG x 64 floats a
// slot, each slot written once), in warpgroup order, so that every
// warpgroup gets the same value.  One warpgroup has nothing to combine.
template <int WG>
struct SharedRows {
  float* red;

  template <bool MAX>
  __device__ __forceinline__ void combine(float (&v)[2], int slot) const {
    if constexpr (WG > 1) {
      float* r = red + slot * WG * 64;
      const int w = threadIdx.x / kWarpgroup;
      if (threadIdx.x % 4 == 0) {
        r[w * 64 + acc_row(0)] = v[0];
        r[w * 64 + acc_row(1)] = v[1];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = r[acc_row(i)];
#pragma unroll
        for (int u = 1; u < WG; ++u) x = MAX ? fmaxf(x, r[u * 64 + acc_row(i)]) : x + r[u * 64 + acc_row(i)];
        v[i] = x;
      }
    }
  }
};

// s (raw scores of this warpgroup's 64 rows against its NT 64-key tiles) ->
// the exact fp32 P of head_fwd: times the scale, keys that keep(row, col)
// rejects at -1e30 (row in [0, 64), col in [0, 64 NT) over the tiles), e =
// exp(s - max) over the row's whole key set (all WG warpgroups' tiles), e /
// sum(e).  Rows at or past pad_from take P = 0.  mx and sum return each of
// this thread's two rows' max and sum.  The quotient is div_by's.
template <int NT, int WG, typename Keep>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][32], float scale, Keep keep, int pad_from,
                                             const SharedRows<WG>& rows, float (&mx)[2], float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = acc_row(i);
    mx[i] = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * n + 2 * i + e];
          x = keep(row, 64 * j + acc_col(n, e)) ? x * scale : kNegInf;
          mx[i] = fmaxf(mx[i], x);
        }
    mx[i] = quad_max(mx[i]);
  }
  rows.template combine<true>(mx, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * n + 2 * i + e];
          x = expf(x - mx[i]);
          sum[i] += x;
        }
    sum[i] = quad_sum(sum[i]);
  }
  rows.template combine<false>(sum, 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool pad = acc_row(i) >= pad_from;
    const float r = 1.f / sum[i];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * n + 2 * i + e];
          x = pad ? 0.f : div_by(x, sum[i], r);
        }
  }
}

// a 64 x 64 accumulator rounded to bf16: two adjacent 8-column blocks are
// exactly the A fragment of a 16-deep step
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_f32_to_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// a 64 x 64 accumulator rounded to bf16 into a swizzled 64-row tile (row =
// the accumulator's row); the eight rows of a warp's store fall on distinct
// 16-byte chunks, so a store has no bank conflict
__device__ __forceinline__ void store_swizzled(uint32_t tile, const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = acc_row(i);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t dst = tile + row * 128 + ((n ^ (row % 8)) << 4) + (threadIdx.x % 4) * 4;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(pack_f32_to_bf16(x[4 * n + 2 * i], x[4 * n + 2 * i + 1]))
                   : "memory");
    }
  }
}

// a 64 x D accumulator rounded to bf16 into rows [0, rows) of g (row stride ld)
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* g, const float (&x)[D / 2], long long ld, int rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = acc_row(i);
    if (row >= rows) continue;
    __nv_bfloat16* r = g + row * ld;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(r + acc_col(n, 0)) = pack_f32_to_bf16(x[4 * n + 2 * i], x[4 * n + 2 * i + 1]);
  }
}

// The WG warpgroups' partial accumulators of one 64 x N output summed into
// warpgroup 0's, in warpgroup order, through `buf` ((WG - 1) N x 128 floats,
// element-major so that a warp's accesses fall on distinct banks)
template <int WG, int N>
__device__ __forceinline__ void sum_partials(float (&acc)[N], float* buf) {
  if constexpr (WG > 1) {
    const int w = threadIdx.x / kWarpgroup, lane = threadIdx.x % kWarpgroup;
    if (w > 0) {
#pragma unroll
      for (int r = 0; r < N; ++r) buf[((w - 1) * N + r) * kWarpgroup + lane] = acc[r];
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int u = 1; u < WG; ++u)
#pragma unroll
        for (int r = 0; r < N; ++r) acc[r] += buf[((u - 1) * N + r) * kWarpgroup + lane];
    }
  }
}

}  // namespace
