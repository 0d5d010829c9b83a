// The grouped expert FFN backward for Hopper (sm_90a), bound through plain
// C functions and loaded with ctypes (ops/moe_gmm.py::grouped_ffn_dx,
// grouped_ffn_dw).
//
// Replaces the TPU kernels of distributed_training_comparison_tpu/ops/
// moe_gmm.py: _dx_kernel (K8, moe_gmm.py:114, called through
// _row_grid_call at :200) and _dw_kernel (K9, :144, called through _dw_call
// at :250).  Both recompute the forward's pre-gelu activation from x, as
// _dh_chain (:96) does, with the forward's rounding points (moe_gmm_fwd.cu):
//
//   h1 = round(x . W1[e][:, c]) + b1[e][c]   (the add rounded)
//   dg = round(dym . W2[e][c, :]^T)          (dym: dy on the kept rows, 0 elsewhere)
//   dh = round(gelu'(h1) . dg)               (fp32, rounded once)
//   g  = round(gelu(h1))
//   dx = round(sum_c dh . W1[e][:, c]^T)
//   dW1[e] = xm^T . dh,  db1[e] = colsum(dh),  dW2[e] = g^T . dym,  db2[e] = colsum(dym)
//
// every product accumulated in fp32 over its whole depth; the weight and
// bias gradients are written in fp32 (the wrapper casts them to the weights'
// dtype, as _gmm_core_bwd does).
//
// moe_gmm_dx (K8): the forward's grid, one block per 64-row tile, looping
// over the experts whose kept range overlaps the tile and, per expert, over
// the hidden dimension in chunks of 32.  dy is staged masked to the
// expert's kept rows, so every other row's dh is exactly 0 and the (64, d)
// fp32 accumulator can sum over the experts and round once at the end: a
// row gets a nonzero term from one expert only.  Dropped and padding rows
// come out 0.
//
// moe_gmm_dw (K9): the TPU accumulates over a sequential (expert, row tile)
// grid in VMEM.  Hopper's blocks run in no order, and atomics would make
// the sums' order, and so the gradients' bits, vary from run to run (the
// JAX package's parity rail replays bitwise).  So one block owns one
// (32-column chunk c of the hidden dimension, expert e) output tile of
// either dW1 (blockIdx.z 0: dW1[e][:, c] and db1[e][c]) or dW2 (1:
// dW2[e][c, :], and db2[e] in the chunk-0 block), and walks that expert's
// kept rows in 64-row steps in a fixed order, recomputing the dh or g
// columns it needs.  No partials, no reduction pass, no atomics: two calls
// give bit-identical gradients.  Empty groups (starts[e] == starts[e + 1],
// possibly == n under router collapse) run no step and write zeros; nothing
// past n is read.  The recompute: the dW1 blocks form h1 and dg, the dW2
// blocks h1 again, so K9 does 5 products of K.d.h MACs against the 4 of
// its bound (h1, dg, dW1, dW2): 1.25x, with no boundary-tile duplication
// since each block walks its own expert's rows.
//
// What bounds them: K8 6.K.d.h operations (h1, dg, dx), K9 8.K.d.h (h1, dg,
// dW1, dW2) for the K kept rows, against x, dy and the weights read and dx
// or the fp32 gradients written; at the vit_moe train shape (n 16384, d
// 192, h 768, E 8, cap 2560, bf16) operations bound both (~15 and ~20 us
// at 989 TFLOP/s).  These kernels are far from that: mma.sync from
// shared-memory tiles loaded as scalar pairs where an operand is
// transposed, synchronous staging, 128 threads a block and K9's 384 blocks
// each re-reading its expert's rows; wgmma/TMA, ldmatrix.trans and a
// split of K9's row walk with a fixed-order second pass are later work.

#include "moe_gmm_common.cuh"

namespace {

using namespace moe;

struct BwdParams {
  const void* x;    // (n, d) expert-sorted tokens
  const void* dy;   // (n, d) cotangent of the forward's output
  const void* w1;   // (E, d, h)
  const void* b1;   // (E, h)
  const void* w2;   // (E, h, d)
  const int* starts;  // (E + 1,)
  void* dx;         // (n, d), compute dtype
  float* dw1;       // (E, d, h) fp32
  float* db1;       // (E, h)
  float* dw2;       // (E, h, d)
  float* db2;       // (E, d)
  int n, h, e, cap;
};

template <typename T, int D>
constexpr int bwd_smem() {
  return 2 * smem_rows<T>(kRows, D) + smem_rows<T>(D, kHC) + smem_rows<T>(kHC, D) +
         smem_rows<T>(kRows, kHC);
}

// h1 and dg of one (64-row, 32-column) chunk: h1 = xs . W1 chunk (w1s, (D,
// kHC)), dg = dys . W2 chunk^T (w2s, (kHC, D)), both raw fp32 sums
template <typename T, int D>
__device__ __forceinline__ void chunk_products(Tile<T, kRows, kHC, 4>& h1, Tile<T, kRows, kHC, 4>* dg,
                                               const T* xs, const T* dys, const T* w1s, const T* w2s) {
  constexpr int LDX = D + kPad, LDW1 = kHC + kPad, LDW2 = D + kPad;
  h1.zero();
  h1.mma(xs, LDX, 1, w1s, LDW1, 1, D);
  if (dg) {
    dg->zero();
    // B(k = i, c = j) = W2[c + j][i] = w2s[j * LDW2 + i]
    dg->mma(dys, LDX, 1, w2s, 1, LDW2, D);
  }
}

// ------------------------------------------------------------------ K8

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) moe_gmm_dx_kernel(const BwdParams p) {
  constexpr int LDX = D + kPad, LDW1 = kHC + kPad, LDW2 = D + kPad, LDH = kHC + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (kRows, D)
  T* dys = xs + kRows * LDX;               // (kRows, D), masked to the expert's kept rows
  T* w1s = dys + kRows * LDX;              // (D, kHC)
  T* w2s = w1s + D * LDW1;                 // (kHC, D)
  T* dhs = w2s + kHC * LDW2;               // (kRows, kHC)
  __shared__ int st[kMaxExperts + 1];

  const int r0 = blockIdx.x * kRows;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* w2 = static_cast<const T*>(p.w2);
  for (int i = threadIdx.x; i <= p.e; i += kThreads) st[i] = p.starts[i];
  stage(xs, LDX, x, D, r0, kRows, D, 0, p.n);
  __syncthreads();

  using DxTile = Tile<T, kRows, D, 4>;
  using HTile = Tile<T, kRows, kHC, 4>;
  DxTile dx;
  dx.zero();
  for (int e = 0; e < p.e; ++e) {
    int lo, hi;
    kept_range(st, e, p.cap, p.n, lo, hi);
    if (hi <= lo || hi <= r0 || lo >= r0 + kRows) continue;  // the same for every thread
    const long long wbase = static_cast<long long>(e) * D * p.h;
    stage(dys, LDX, dy, D, r0, kRows, D, lo, hi);
    for (int c = 0; c < p.h; c += kHC) {
      stage(w1s, LDW1, w1 + wbase + c, p.h, 0, D, kHC, 0, D);
      stage(w2s, LDW2, w2 + wbase + static_cast<long long>(c) * D, D, 0, kHC, D, 0, kHC);
      __syncthreads();
      HTile h1, dg;
      chunk_products<T, D>(h1, &dg, xs, dys, w1s, w2s);
#pragma unroll
      for (int nt = 0; nt < HTile::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = HTile::row(0, i), cc = HTile::col(nt, i);
          const float bias = to_f(b1[static_cast<long long>(e) * p.h + c + cc]);
          const float hv = rnd<T>(rnd<T>(h1.acc[0][nt][i]) + bias);
          dhs[r * LDH + cc] = from_f<T>(gelu_tanh_grad(hv) * rnd<T>(dg.acc[0][nt][i]));
        }
      __syncthreads();
      // B(k = j, c = i) = W1[i][c + j] = w1s[i * LDW1 + j]
      dx.mma(dhs, LDH, 1, w1s, 1, LDW1, kHC);
      __syncthreads();  // the next chunk (or expert) overwrites the tiles
    }
  }
  T* dxo = static_cast<T*>(p.dx);
#pragma unroll
  for (int nt = 0; nt < DxTile::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = r0 + DxTile::row(0, i);
      if (gr < p.n) dxo[static_cast<long long>(gr) * D + DxTile::col(nt, i)] = from_f<T>(dx.acc[0][nt][i]);
    }
}

// ------------------------------------------------------------------ K9

// one (chunk, expert) tile of dW1 (kDw1) or dW2, walking the expert's kept
// rows [lo, hi) in 64-row steps
template <typename T, int D, bool kDw1>
__device__ __forceinline__ void dw_tile(const BwdParams& p, int e, int c, int lo, int hi, T* xs,
                                        T* dys, const T* w1s, const T* w2s, T* hs) {
  constexpr int LDX = D + kPad, LDH = kHC + kPad;
  // dW1[e][:, c] (D x kHC) or dW2[e][c, :] (kHC x D)
  using Acc = typename std::conditional<kDw1, Tile<T, D, kHC, 4>, Tile<T, kHC, D, 2>>::type;
  using HTile = Tile<T, kRows, kHC, 4>;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const T* b1 = static_cast<const T*>(p.b1);
  // the column sums: db1[e][c] (kHC), or db2[e] (D) in the chunk-0 block
  const int sums = kDw1 ? kHC : (c == 0 ? D : 0);
  float colsum[(D + kThreads - 1) / kThreads] = {};
  Acc acc;
  acc.zero();
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    __syncthreads();  // every thread is done with the previous step's tiles
    stage(xs, LDX, x, D, r0, kRows, D, lo, hi);
    stage(dys, LDX, dy, D, r0, kRows, D, lo, hi);
    __syncthreads();
    HTile h1, dg;
    chunk_products<T, D>(h1, kDw1 ? &dg : nullptr, xs, dys, w1s, w2s);
#pragma unroll
    for (int nt = 0; nt < HTile::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = HTile::row(0, i), cc = HTile::col(nt, i);
        const float bias = to_f(b1[static_cast<long long>(e) * p.h + c + cc]);
        const float hv = rnd<T>(rnd<T>(h1.acc[0][nt][i]) + bias);
        if constexpr (kDw1) {
          hs[r * LDH + cc] = from_f<T>(gelu_tanh_grad(hv) * rnd<T>(dg.acc[0][nt][i]));
        } else {
          hs[r * LDH + cc] = from_f<T>(gelu_tanh(hv));
        }
      }
    __syncthreads();
    if constexpr (kDw1) {
      // dW1 += xm^T . dh: A(i, r) = xs[r * LDX + i], B(r, j) = hs[r * LDH + j]
      acc.mma(xs, 1, LDX, hs, LDH, 1, kRows);
    } else {
      // dW2 += g^T . dym: A(j, r) = hs[r * LDH + j], B(r, i) = dys[r * LDX + i]
      acc.mma(hs, 1, LDH, dys, LDX, 1, kRows);
    }
    // column sums in row order: each column's thread adds its rows in turn
    for (int k = 0; k * kThreads + static_cast<int>(threadIdx.x) < sums; ++k) {
      const int j = k * kThreads + threadIdx.x;
      for (int r = 0; r < kRows; ++r) colsum[k] += to_f(kDw1 ? hs[r * LDH + j] : dys[r * LDX + j]);
    }
  }
  if constexpr (kDw1) {
    float* dw1 = p.dw1 + static_cast<long long>(e) * D * p.h;
#pragma unroll
    for (int mt = 0; mt < Acc::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Acc::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dw1[static_cast<long long>(Acc::row(mt, i)) * p.h + c + Acc::col(nt, i)] = acc.acc[mt][nt][i];
  } else {
    float* dw2 = p.dw2 + static_cast<long long>(e) * p.h * D;
#pragma unroll
    for (int mt = 0; mt < Acc::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Acc::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dw2[static_cast<long long>(c + Acc::row(mt, i)) * D + Acc::col(nt, i)] = acc.acc[mt][nt][i];
  }
  for (int k = 0; k * kThreads + static_cast<int>(threadIdx.x) < sums; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if constexpr (kDw1) {
      p.db1[static_cast<long long>(e) * p.h + c + j] = colsum[k];
    } else {
      p.db2[static_cast<long long>(e) * D + j] = colsum[k];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) moe_gmm_dw_kernel(const BwdParams p) {
  constexpr int LDX = D + kPad, LDW1 = kHC + kPad, LDW2 = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (kRows, D), masked to the kept rows
  T* dys = xs + kRows * LDX;               // (kRows, D), masked to the kept rows
  T* w1s = dys + kRows * LDX;              // (D, kHC)
  T* w2s = w1s + D * LDW1;                 // (kHC, D)
  T* hs = w2s + kHC * LDW2;                // (kRows, kHC): dh or g

  const int c = blockIdx.x * kHC, e = blockIdx.y;
  int lo, hi;
  kept_range(p.starts, e, p.cap, p.n, lo, hi);
  const long long wbase = static_cast<long long>(e) * D * p.h;
  stage(w1s, LDW1, static_cast<const T*>(p.w1) + wbase + c, p.h, 0, D, kHC, 0, D);
  stage(w2s, LDW2, static_cast<const T*>(p.w2) + wbase + static_cast<long long>(c) * D, D, 0, kHC,
        D, 0, kHC);
  if (blockIdx.z == 0) {
    dw_tile<T, D, true>(p, e, c, lo, hi, xs, dys, w1s, w2s, hs);
  } else {
    dw_tile<T, D, false>(p, e, c, lo, hi, xs, dys, w1s, w2s, hs);
  }
}

template <typename T, int D>
cudaError_t launch_dx(const BwdParams& p, cudaStream_t s) {
  const dim3 grid((p.n + kRows - 1) / kRows);
  return launch(moe_gmm_dx_kernel<T, D>, grid, bwd_smem<T, D>(), s, p);
}

template <typename T, int D>
cudaError_t launch_dw(const BwdParams& p, cudaStream_t s) {
  const dim3 grid(p.h / kHC, p.e, 2);
  return launch(moe_gmm_dw_kernel<T, D>, grid, bwd_smem<T, D>(), s, p);
}

}  // namespace

// dx of the grouped FFN (moe_gmm_fwd's arguments plus dy (n, d) in the
// compute dtype) into dx (n, d).  The same shape rules as moe_gmm_fwd.
// Returns the launch's cudaError_t (0 on success).
extern "C" int moe_gmm_dx(const void* x, const void* dy, const void* w1, const void* b1,
                          const void* w2, const void* starts, void* dx, int n, int d, int h, int e,
                          int cap, int is_bf16, void* stream) {
  BwdParams p{};
  p.x = x;
  p.dy = dy;
  p.w1 = w1;
  p.b1 = b1;
  p.w2 = w2;
  p.starts = static_cast<const int*>(starts);
  p.dx = dx;
  p.n = n;
  p.h = h;
  p.e = e;
  p.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOE_DISPATCH_D(d, return is_bf16 ? launch_dx<bf16, D>(p, s) : launch_dx<float, D>(p, s);)
}

// dW1 (E, d, h), db1 (E, h), dW2 (E, h, d), db2 (E, d) of the grouped FFN,
// fp32, contiguous; every element written.  The same shape rules as
// moe_gmm_fwd.  Returns the launch's cudaError_t (0 on success).
extern "C" int moe_gmm_dw(const void* x, const void* dy, const void* w1, const void* b1,
                          const void* w2, const void* starts, void* dw1, void* db1, void* dw2,
                          void* db2, int n, int d, int h, int e, int cap, int is_bf16,
                          void* stream) {
  BwdParams p{};
  p.x = x;
  p.dy = dy;
  p.w1 = w1;
  p.b1 = b1;
  p.w2 = w2;
  p.starts = static_cast<const int*>(starts);
  p.dw1 = static_cast<float*>(dw1);
  p.db1 = static_cast<float*>(db1);
  p.dw2 = static_cast<float*>(dw2);
  p.db2 = static_cast<float*>(db2);
  p.n = n;
  p.h = h;
  p.e = e;
  p.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOE_DISPATCH_D(d, return is_bf16 ? launch_dw<bf16, D>(p, s) : launch_dw<float, D>(p, s);)
}
