// Hopper (sm_90a) pieces shared by the grouped expert FFN's bf16 kernels:
// the forward (moe_gmm_fwd.cu::moe_ffn_fwd_wgmma, K7) and the weight
// gradients (moe_gmm_bwd.cu::moe_ffn_dw_wgmma, K9).  Both are built on the
// shared Hopper helpers (hopper_common.cuh's mbarriers and TMA loads,
// block_gemm.cuh's wgmma and named barriers, attention_tiles.cuh's tile
// descriptors and accumulator maps) and on moe_gmm_common.cuh's kept ranges
// and tanh gelu; this header adds K7's expert-aligned units of work, the
// exact zeros of the rows no expert keeps, zeroed tile rows and the order
// in which a warpgroup's accumulator is stored.
//
// Thread roles: two warpgroups (256 threads), the first thread of the first
// also issuing every TMA load; one block an SM, up to 255 registers a
// thread (a third warpgroup or a producer warp would cap them at 168: ptxas
// sizes the register file for whole warpgroups).
//
// Tiles are 128-byte-swizzled boxes of 64 rows by 64 bf16 columns
// (hopper_common.cuh).  A 64 x 192 tile of x or dy is three boxes side by
// side (box j: columns 64j..64j+63), and so is a 64 x 192 slice of W2[e]
// (64 hidden rows); a 192 x 64 slice of W1[e] (the d rows of one 64-column
// hidden chunk) is three boxes stacked, one 192-row tile.  A k-step of 16
// rows of such a tile read MN-major is 2 KB on, across the boxes
// (desc_mnmajor); a k-step of 16 columns read K-major is 32 bytes along the
// swizzled row, the next box after 64 (desc_kmajor).

#pragma once

#include "attention_tiles.cuh"
#include "block_gemm.cuh"
#include "moe_gmm_common.cuh"

namespace {
namespace moeh {

using bf16 = __nv_bfloat16;

constexpr int kD = 192;                      // the model width (vit_moe's, MOE_DISPATCH_D)
constexpr int kRows = 64;                    // token rows of a tile: a warpgroup's wgmma M
constexpr int kChunk = 64;                   // hidden columns of a chunk: one box
constexpr int kConsumers = 2;                // warpgroups
constexpr int kThreads = 128 * kConsumers;
constexpr int kUnitRows = kConsumers * kRows;    // K7's unit: a tile for each consumer warpgroup
constexpr int kBox = box_bytes<kRows>();     // 8 KB
constexpr int kTile = kD / 64 * kBox;        // 24 KB: 64 x 192, or 192 x 64
constexpr int kAcc = kD / 2;                 // a 64 x 192 fp32 accumulator: 96 registers a thread

// the halves of a bf16 pair as floats (the first element in the low half)
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// jax.nn.gelu's tanh approximation and its derivative at x from one tanh,
// each as moe_gmm_common.cuh's gelu_tanh and gelu_tanh_grad write it
__device__ __forceinline__ void gelu_and_grad(float x, float& g, float& gp) {
  const float t = tanhf(moe::kGeluC * (x + moe::kGeluA * (x * x * x)));
  g = x * (0.5f * (1.f + t));
  gp = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * moe::kGeluC * (1.f + 3.f * moe::kGeluA * x * x);
}

// K7's unit u: rows [lo, hi) of expert e's kept range, at most kUnitRows,
// units numbered expert by expert, ceil(kept / kUnitRows) each
// (ops/moe_gmm.py::expert_tiles mirrors it).  False past the last unit.
// There are fewer than ceil(n / kUnitRows) + E units: the launch's grid.
__device__ __forceinline__ bool expert_unit(const int* st, int ne, int cap, int n, int u, int& e, int& lo,
                                            int& hi) {
  for (e = 0; e < ne; ++e) {
    moe::kept_range(st, e, cap, n, lo, hi);
    const int units = hi > lo ? (hi - lo + kUnitRows - 1) / kUnitRows : 0;
    if (u < units) {
      lo += u * kUnitRows;
      hi = min(hi, lo + kUnitRows);
      return true;
    }
    u -= units;
  }
  return false;
}

// whether row r (< n) lies in an expert's kept range
__device__ __forceinline__ bool row_kept(const int* st, int ne, int cap, int r) {
  for (int e = 0; e < ne; ++e)
    if (r >= st[e] && r < st[e + 1]) return r - st[e] < cap;
  return false;  // padding past starts[E]
}

// The rows of y (n, kD) in no expert's kept range (dropped past the
// capacity, padding past starts[E]) written as exact zeros: block b takes
// the 64-row blocks b, b + grid, ...; `flag` is kRows bytes of shared memory.
// Every thread of the block takes part.
__device__ __forceinline__ void zero_unkept(bf16* y, const int* st, int ne, int cap, int n,
                                            unsigned char* flag) {
  for (int r0 = blockIdx.x * kRows; r0 < n; r0 += gridDim.x * kRows) {
    if (threadIdx.x < kRows) flag[threadIdx.x] = r0 + threadIdx.x < n && !row_kept(st, ne, cap, r0 + threadIdx.x);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kD / 8; i += blockDim.x) {
      const int r = i / (kD / 8);
      if (flag[r])
        *reinterpret_cast<uint4*>(y + static_cast<long long>(r0 + r) * kD + (i % (kD / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }
}

// rows [from, 64) of a 64 x 192 tile at `tile` (generic address of shared
// memory) set to zero by the 128 threads of a warpgroup (`lane` 0..127); the
// swizzle permutes 16-byte chunks within a row, so whole rows are whole
// 128-byte lines
__device__ __forceinline__ void zero_rows(unsigned char* tile, int from, int lane) {
  const int per_box = (kRows - from) * 8;
  for (int i = lane; i < kD / 64 * per_box; i += 128)
    *reinterpret_cast<uint4*>(tile + (i / per_box) * kBox + (from + i % per_box / 8) * 128 + (i % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
}

// The elements of a warpgroup's 64 x 192 fp32 accumulator, in pairs of
// adjacent columns: emit(row, col, v, v_next)
template <typename Emit>
__device__ __forceinline__ void each_output(const float (&acc)[kAcc], Emit emit) {
  const int t2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) emit(acc_row(i), 8 * nb + t2, acc[4 * nb + 2 * i], acc[4 * nb + 2 * i + 1]);
}

}  // namespace moeh
}  // namespace
