// Shared pieces of the grouped expert FFN kernels (moe_gmm_fwd.cu, K7;
// moe_gmm_bwd.cu, K8 and K9): element conversions at the compute dtype's
// rounding points, the tanh gelu and its derivative and the experts' kept
// ranges, on which the Hopper kernels (moe_gmm_hopper.cuh; the fp32 K7-K9
// on tf32x3.cuh) build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

using bf16 = __nv_bfloat16;

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

}  // namespace moe
