// The grouped expert FFN forward for Hopper (sm_90a), bound through a plain
// C function and loaded with ctypes (ops/moe_gmm.py::grouped_ffn_fwd).
//
// Replaces the TPU kernel distributed_training_comparison_tpu/ops/moe_gmm.py
// ::_ffn_kernel (K7, moe_gmm.py:71, called through _row_grid_call at :200):
//
//   y[r] = gelu(x[r] . W1[e] + b1[e]) . W2[e] + b2[e]
//
// for every row r of the expert-sorted tokens that lies in expert e's kept
// range [starts[e], starts[e] + min(count_e, cap)); every other row (past
// an expert's capacity, or padding past starts[E]) is exactly 0.  Numerics
// of the TPU kernel: each product accumulates in fp32 over its whole depth
// and is rounded to the compute dtype once, before its bias add; the bias
// add is rounded to the compute dtype; the tanh gelu is taken in fp32 on
// the rounded sum and rounded once (ops/vit_block.py's K5 rounds its gelu
// at the same point).
//
// Design.  One block of 128 threads owns a 64-row tile of the sorted
// tokens.  It reads `starts` itself and loops over the experts whose kept
// range overlaps its tile (a tile at a group boundary runs two or more; the
// TPU kernel pays the same duplicate work).  For each such expert it walks
// the hidden dimension in chunks of 32 columns: W1[e][:, chunk] and
// W2[e][chunk, :] are staged in shared memory, the (64, 32) chunk of the
// activation is formed on chip (product, bias, gelu, rounded), and its
// product with W2[e][chunk, :] accumulates into a (64, d) fp32 accumulator
// in registers.  The (rows, hidden) activation never reaches device memory,
// as it never leaves VMEM on the TPU.  After the whole hidden sum the block
// rounds once, adds b2 and writes only the rows in the expert's mask; a
// row belongs to at most one expert, so the writes are disjoint, and rows
// in no mask are written as 0.0.  bf16 runs on mma.sync m16n8k16 (fp32
// accumulate), fp32 on SIMT FMAs (moe_gmm_common.cuh).
//
// What bounds it: 4.K.d.h operations for the K kept rows against reading
// x, the weights and writing y.  At vit_moe's serve shape (bucket 32: n
// 2048, d 192, h 768, E 8, cap 320, bf16) that is ~1.2 GFLOP against ~6
// MB, so bytes bound it (~2 us at 3.35 TB/s).  This kernel is far from
// it: every block re-reads its experts' weights from L2 (8 x 0.6 MB in
// bf16 fit the 50 MB L2 easily), the weight tiles are staged synchronously
// with no cp.async pipeline, and operands pass through shared memory as
// scalar pairs where they are transposed; wgmma, TMA and a persistent
// expert-major schedule are later work.

#include "moe_gmm_common.cuh"

namespace {

using namespace moe;

struct FwdParams {
  const void* x;    // (n, d) expert-sorted tokens
  const void* w1;   // (E, d, h)
  const void* b1;   // (E, h)
  const void* w2;   // (E, h, d)
  const void* b2;   // (E, d)
  const int* starts;  // (E + 1,)
  void* y;          // (n, d)
  int n, h, e, cap;
};

template <typename T, int D>
constexpr int fwd_smem() {
  return smem_rows<T>(kRows, D) + smem_rows<T>(D, kHC) + smem_rows<T>(kHC, D) +
         smem_rows<T>(kRows, kHC);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) moe_gmm_fwd_kernel(const FwdParams p) {
  constexpr int LDX = D + kPad, LDW1 = kHC + kPad, LDW2 = D + kPad, LDH = kHC + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (kRows, D): the tile's tokens
  T* w1s = xs + kRows * LDX;               // (D, kHC): W1[e][:, chunk]
  T* w2s = w1s + D * LDW1;                 // (kHC, D): W2[e][chunk, :]
  T* hs = w2s + kHC * LDW2;                // (kRows, kHC): gelu chunk
  __shared__ int st[kMaxExperts + 1];
  __shared__ unsigned char kept[kRows];

  const int r0 = blockIdx.x * kRows;
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* b2 = static_cast<const T*>(p.b2);
  T* y = static_cast<T*>(p.y);
  for (int i = threadIdx.x; i <= p.e; i += kThreads) st[i] = p.starts[i];
  for (int i = threadIdx.x; i < kRows; i += kThreads) kept[i] = 0;
  stage(xs, LDX, x, D, r0, kRows, D, 0, p.n);
  __syncthreads();

  using OutTile = Tile<T, kRows, D, 4>;
  using HTile = Tile<T, kRows, kHC, 4>;
  for (int e = 0; e < p.e; ++e) {
    int lo, hi;
    kept_range(st, e, p.cap, p.n, lo, hi);
    if (hi <= lo || hi <= r0 || lo >= r0 + kRows) continue;  // the same for every thread
    const long long wbase = static_cast<long long>(e) * D * p.h;
    OutTile out;
    out.zero();
    for (int c = 0; c < p.h; c += kHC) {
      stage(w1s, LDW1, w1 + wbase + c, p.h, 0, D, kHC, 0, D);
      stage(w2s, LDW2, w2 + wbase + static_cast<long long>(c) * D, D, 0, kHC, D, 0, kHC);
      __syncthreads();
      HTile hacc;
      hacc.zero();
      hacc.mma(xs, LDX, 1, w1s, LDW1, 1, D);
#pragma unroll
      for (int nt = 0; nt < HTile::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = HTile::row(0, i), cc = HTile::col(nt, i);
          const float bias = to_f(b1[static_cast<long long>(e) * p.h + c + cc]);
          const float v = rnd<T>(rnd<T>(hacc.acc[0][nt][i]) + bias);
          hs[r * LDH + cc] = from_f<T>(gelu_tanh(v));
        }
      __syncthreads();
      out.mma(hs, LDH, 1, w2s, LDW2, 1, kHC);
      __syncthreads();  // the next chunk overwrites w1s, w2s and hs
    }
#pragma unroll
    for (int nt = 0; nt < OutTile::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = OutTile::row(0, i), cc = OutTile::col(nt, i), gr = r0 + r;
        if (gr < lo || gr >= hi) continue;
        const float bias = to_f(b2[static_cast<long long>(e) * D + cc]);
        y[static_cast<long long>(gr) * D + cc] = from_f<T>(rnd<T>(out.acc[0][nt][i]) + bias);
        if (cc == 0) kept[r] = 1;
      }
  }
  __syncthreads();
  // rows in no expert's kept range: exactly 0
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, gr = r0 + r;
    if (gr < p.n && !kept[r]) y[static_cast<long long>(gr) * D + i % D] = from_f<T>(0.f);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t s) {
  const dim3 grid((p.n + kRows - 1) / kRows);
  return launch(moe_gmm_fwd_kernel<T, D>, grid, fwd_smem<T, D>(), s, p);
}

}  // namespace

// y = the grouped FFN of the expert-sorted tokens x (n, d) over the experts'
// W1 (E, d, h), b1 (E, h), W2 (E, h, d), b2 (E, d), all contiguous in the
// compute dtype (bf16 when is_bf16, else fp32), starts (E + 1,) int32 on
// the device, capacity cap.  d is 192, h a multiple of 32,
// E at most 64, n at least 1, every pointer 16-byte aligned (checked by the
// caller).  Returns the launch's cudaError_t (0 on success).
extern "C" int moe_gmm_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* starts, void* y, int n, int d, int h,
                           int e, int cap, int is_bf16, void* stream) {
  const FwdParams p{x, w1, b1, w2, b2, static_cast<const int*>(starts), y, n, h, e, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOE_DISPATCH_D(d, return is_bf16 ? launch_fwd<bf16, D>(p, s) : launch_fwd<float, D>(p, s);)
}
