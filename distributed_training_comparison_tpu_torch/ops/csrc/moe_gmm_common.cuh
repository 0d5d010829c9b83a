// Shared pieces of the grouped expert FFN kernels (moe_gmm_fwd.cu, K7;
// moe_gmm_bwd.cu, K8 and K9): element conversions at the compute dtype's
// rounding points, the tanh gelu and its derivative and the experts' kept
// ranges, which the Hopper kernels (moe_gmm_hopper.cuh; the fp32 K7 and K9
// on tf32x3.cuh) use too; and, for the fp32 K8 alone, tile staging into
// shared memory and a block-level product over shared-memory tiles.
//
// Every product of the fp32 K8 runs through `Tile`: SIMT FMAs whose accumulator takes
// the mma.sync m16n8k16 fragment layout's (row, column) ownership.
// Operands are read from shared memory through a row stride and a column
// stride, so a transposed operand costs no copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace moe {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // 4 warps a block
constexpr int kRows = 64;        // token rows a tile
constexpr int kHC = 32;          // hidden columns a chunk
constexpr int kPad = 8;          // elements of padding at the end of a shared-memory row
constexpr int kMaxExperts = 64;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to the compute dtype, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

constexpr float kGeluC = 0.7978845608028654f, kGeluA = 0.044715f;

// jax.nn.gelu's tanh approximation, in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.f + tanhf(kGeluC * (x + kGeluA * (x * x * x)))));
}

// its derivative, in fp32
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kGeluC * (x + kGeluA * (x * x * x)));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * x * x);
}

// expert e's kept rows [lo, hi): the first min(count, cap) rows of its
// group, never past n
__device__ __forceinline__ void kept_range(const int* starts, int e, int cap, int n, int& lo,
                                           int& hi) {
  lo = starts[e];
  hi = min(lo + min(starts[e + 1] - lo, cap), n);
}

// rows [r0, r0 + rows) x cols of a row-major global matrix (row stride gld
// elements) into shared memory (row stride sld); a row is read only where
// lo <= its global index < hi, and is zero elsewhere.  cols * sizeof(T) and
// sld * sizeof(T) are multiples of 16, g and s 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage(T* s, int sld, const T* g, long long gld, int r0, int rows,
                                      int cols, int lo, int hi) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = cols / kVec;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, col = (c % chunks) * kVec;
    const int gr = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= lo && gr < hi) v = *reinterpret_cast<const uint4*>(g + gr * gld + col);
    *reinterpret_cast<uint4*>(s + r * sld + col) = v;
  }
}

// An M x N fp32 accumulator spread over the block's 4 warps, WM warps down
// the rows and 4 / WM across the columns; element i of acc[mt][nt] sits at
// (row(mt, i), col(nt, i)), the m16n8k16 C-fragment layout.
template <typename T, int M, int N, int WM>
struct Tile {
  static_assert(std::is_same<T, float>::value, "the bf16 kernels are moe_gmm_hopper.cuh's");
  static constexpr int WN = kThreads / 32 / WM;
  static constexpr int MT = M / 16 / WM;
  static constexpr int NT = N / 8 / WN;
  static_assert(MT * 16 * WM == M && NT * 8 * WN == N, "tile does not split over the warps");

  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }

  __device__ __forceinline__ static int row(int mt, int i) {
    const int wm = (threadIdx.x / 32) % WM, g = (threadIdx.x % 32) >> 2;
    return (wm * MT + mt) * 16 + g + 8 * (i >> 1);
  }

  __device__ __forceinline__ static int col(int nt, int i) {
    const int wn = (threadIdx.x / 32) / WM, t = threadIdx.x & 3;
    return (wn * NT + nt) * 8 + t * 2 + (i & 1);
  }

  // acc += A . B over depth K, A(r, k) = a[r * ars + k * acs] (M x K),
  // B(k, c) = b[k * brs + c * bcs] (K x N), both in shared memory.
  __device__ __forceinline__ void mma(const T* a, int ars, int acs, const T* b, int brs, int bcs,
                                      int K) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int wm = (threadIdx.x / 32) % WM, wn = (threadIdx.x / 32) / WM;
    for (int k = 0; k < K; ++k) {
      float av[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (wm * MT + mt) * 16 + g;
        av[mt][0] = a[r * ars + k * acs];
        av[mt][1] = a[(r + 8) * ars + k * acs];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = (wn * NT + nt) * 8 + t * 2;
        const float b0 = b[k * brs + c * bcs], b1 = b[k * brs + (c + 1) * bcs];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] = fmaf(av[mt][0], b0, acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(av[mt][0], b1, acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(av[mt][1], b0, acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(av[mt][1], b1, acc[mt][nt][3]);
        }
      }
    }
  }
};

// shared-memory bytes of `rows` rows of `cols` elements each, padded
template <typename T>
constexpr int smem_rows(int rows, int cols) {
  return rows * (cols + kPad) * static_cast<int>(sizeof(T));
}

// launch with `smem` bytes of dynamic shared memory; the launch's error
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the kernels' model widths: vit_moe's 192 (a multiple of 64 is what the
// tiles need; add a case when a model of another width runs the kernels)
#define MOE_DISPATCH_D(d, ...)                      \
  switch (d) {                                     \
    case 192: { constexpr int D = 192; __VA_ARGS__ } \
    default: return cudaErrorInvalidValue;         \
  }

}  // namespace moe
