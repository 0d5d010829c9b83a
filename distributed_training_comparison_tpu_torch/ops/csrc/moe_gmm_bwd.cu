// The grouped expert FFN backward for Hopper (sm_90a), bound through plain
// C functions and loaded with ctypes (ops/moe_gmm.py::grouped_ffn_dx,
// grouped_ffn_dw).
//
// Replaces the TPU kernels of distributed_training_comparison_tpu/ops/
// moe_gmm.py: _dx_kernel (K8, moe_gmm.py:114, called through
// _row_grid_call at :189, pallas_call at :200) and _dw_kernel (K9, :144,
// called through _dw_call at :213, pallas_call at :250).  Both recompute
// the forward's pre-gelu activation from x, as _dh_chain (:96) does, with
// the forward's rounding points (moe_gmm_fwd.cu):
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
// dtype, as _gmm_core_bwd does).  Hopper's blocks run in no order, and
// atomics would make the sums' order, and so the gradients' bits, vary from
// run to run (the JAX package's parity rail replays bitwise): every sum here
// has one owner and a fixed order, and two calls give bit-identical results.
//
// What bounds them: K8 6.K.d.h operations (h1, dg, dx), K9 8.K.d.h (h1, dg,
// dW1, dW2) for the K kept rows, against x, dy and the weights read and dx
// or the fp32 gradients written; at the vit_moe train shape (n 16384, d
// 192, h 768, E 8, cap 2560, bf16) operations bound both (~15 and ~20 us
// at 989 TFLOP/s).
//
// moe_gmm_dx_kernel (K8, both dtypes) and moe_gmm_dw_kernel (K9 in fp32)
// are the first port, on moe_gmm_common.cuh's mma.sync / SIMT tiles: K8
// takes the forward's grid of 64-row tiles, looping over the experts whose
// kept range overlaps the tile and over the hidden dimension in chunks of
// 32, dy staged masked to the expert's kept rows, one (64, d) fp32
// accumulator rounded once; the fp32 K9 has one block per (32-column chunk,
// expert) tile of dW1 or dW2 (blockIdx.z), walking the expert's kept rows,
// 5 products where the bound counts 4.
//
// bf16 K9: moe_ffn_dw_wgmma (moe_gmm_hopper.cuh).  One owner per (expert e,
// 64-column hidden chunk c) holds W1[e][:, c] (192 x 64) and W2[e][c, :]
// (64 x 192) stationary in shared memory and walks the expert's kept rows
// in 64-row steps, x and dy landing through a 3-stage TMA ring as they lie
// in memory (the block's first thread issues the loads; the warpgroups meet
// at every step, so a stage is refilled once both are past it).  It works
// in the transposed frame, so that dh and g come out of the products as A
// fragments: its first warpgroup forms h1^T = W1c^T . x^T (A read
// MN-major), its second dg^T = W2c . dym^T (both K-major), both m64n64
// wgmma over d; the two round at their points and trade the halves through
// shared memory, each forms gelu and gelu' for half the elements from one
// tanh and they trade again, then the first runs dW1c^T += dh^T . x, the
// second dW2c += g^T . dym, each three m64n64 wgmma from registers over the
// landed tile read MN-major: 4 products a step, where the first port ran
// 5, and each warpgroup holds one 64 x 192 fp32
// accumulator (96 registers; one holding both would need 192 beside the
// step's fragments).  The next step's first product runs under this step's
// gelu.  The rows of the last step past the kept end are zeroed in shared
// memory before its products (the xm / dym masking).  db1 is summed from dh
// in registers, db2 (the chunk-0 owners) from the landed dy tiles under the
// products, both in a fixed order.  At vit_moe's 96 owners (8 x 12) the
// card's 132 SMs are not all busy and the experts at capacity walk the
// longest, so each owner's walk splits over a cluster of two CTAs
// (kDwCluster; ops/moe_gmm.py::dw_walks mirrors the split), whose fp32
// partial gradients are summed through distributed shared memory in rank
// order: no atomics, one launch.  A CTA whose share of a short walk is
// empty contributes zeros.

#include "moe_gmm_common.cuh"
#include "moe_gmm_hopper.cuh"

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

// ------------------------------------------------------------------ bf16 K9

struct DwArgs {
  const bf16* b1;     // (E, h)
  const int* starts;  // (E + 1,)
  float* dw1;         // (E, d, h)
  float* db1;         // (E, h)
  float* dw2;         // (E, h, d)
  float* db2;         // (E, d)
  int n, h, e, cap;
};

constexpr int kDwStages = 3;
constexpr int kDwStage = 2 * moeh::kTile;  // the step's x tile, then its dy tile
constexpr int kXchBuf = 16 * 128 * 4;      // a warpgroup's 64 x 64 half of a step, packed to bf16: 8 KB
constexpr int kDwCluster = 2;              // CTAs an owner's row walk is split over (a cluster)
constexpr int kPartial = moeh::kAcc * 128 * 4;  // a warpgroup's accumulator in shared memory: 48 KB

// W1 and W2 slices, the ring, the exchange (two steps' buffers; after the
// walk db2's row-phase sums), the bias partials, the barriers, 1 KB of
// alignment slack: 226 KB
constexpr int dw_smem() {
  return 2 * moeh::kTile + kDwStages * kDwStage + 4 * kXchBuf + 256 * 4 + 8 * (kDwStages + 1) + 1024;
}

// every thread of every CTA of the cluster arrives (release) and waits
// (acquire): shared memory written before is visible to the cluster's reads after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// the fp32 at shared address `addr` of this CTA's window summed over the
// cluster's CTAs, in rank order
__device__ __forceinline__ float sum_at(uint32_t addr) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kDwCluster; ++q) {
    uint32_t remote;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(q));
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
    s = q == 0 ? v : s + v;
  }
  return s;
}

// a warpgroup's 64 x 192 accumulator as a partial at `buf`: element r of
// thread t at byte (r * 128 + t) * 4, so a warp's accesses fall on distinct banks
__device__ __forceinline__ void put_partial(uint32_t buf, const float (&acc)[moeh::kAcc]) {
  const int t = threadIdx.x % kWarpgroup;
#pragma unroll
  for (int r = 0; r < moeh::kAcc; ++r)
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(buf + (r * kWarpgroup + t) * 4), "f"(acc[r]) : "memory");
}

// The elements of a warpgroup's 64 x 192 output summed over the cluster's
// partials at `buf` in rank order, in pairs of adjacent columns: emit(row,
// col, v, v_next); CTA `rank` takes the 8-column blocks rank, rank +
// kDwCluster, ...
template <typename Emit>
__device__ __forceinline__ void each_summed_output(uint32_t buf, int rank, Emit emit) {
  const uint32_t mine = buf + (threadIdx.x % kWarpgroup) * 4;
  const int t2 = 2 * (threadIdx.x % 4);
  for (int nb = rank; nb < moeh::kD / 8; nb += kDwCluster)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 4 * nb + 2 * i;
      emit(acc_row(i), 8 * nb + t2, sum_at(mine + r * kWarpgroup * 4), sum_at(mine + (r + 1) * kWarpgroup * 4));
    }
}

__global__ void __cluster_dims__(kDwCluster, 1, 1) __launch_bounds__(moeh::kThreads, 1)
    moe_ffn_dw_wgmma(const DwArgs p, const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw1,
                     const __grid_constant__ CUtensorMap tw2) {
  using moeh::kBox;
  using moeh::kTile;
  constexpr int S = kDwStages, kD = moeh::kD;
  extern __shared__ __align__(1024) unsigned char dw_smem_raw[];
  const uint32_t base = (smem_u32(dw_smem_raw) + 1023) & ~1023u;
  const uint32_t w1c = base, w2c = w1c + kTile, ring = w2c + kTile, xch = ring + S * kDwStage;
  const uint32_t colsum = xch, dbuf = xch + 4 * kXchBuf;
  const uint32_t full = dbuf + 256 * 4, wfull = full + 8 * S;
  const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;
  const int rank = blockIdx.x % kDwCluster, owner = blockIdx.x / kDwCluster;
  const int nc = p.h / moeh::kChunk, e = owner / nc, c = owner % nc;
  int lo, hi;
  kept_range(p.starts, e, p.cap, p.n, lo, hi);
  const int steps = hi > lo ? (hi - lo + moeh::kRows - 1) / moeh::kRows : 0;
  // this CTA's steps of the owner's walk: [k0, k0 + nk)
  const int k0 = rank * steps / kDwCluster, nk = (rank + 1) * steps / kDwCluster - k0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step k's x and dy tiles into stage k % S, completing on its full barrier
  auto load_step = [&](int k) {
    const int s = k % S, r0 = lo + moeh::kRows * (k0 + k);
    const uint32_t stage = ring + s * kDwStage;
    mbar_expect_tx(full + 8 * s, kDwStage);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(stage + j * kBox, &tx, 64 * j, r0, 0, 0, full + 8 * s);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(stage + kTile + j * kBox, &tdy, 64 * j, r0, 0, 0, full + 8 * s);
  };
  if (tid == 0 && nk > 0) {  // the weight slices and the ring's first steps
    mbar_expect_tx(wfull, 2 * kTile);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(w1c + j * kBox, &tw1, moeh::kChunk * c, e * kD + 64 * j, 0, 0, wfull);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(w2c + j * kBox, &tw2, 64 * j, e * p.h + moeh::kChunk * c, 0, 0, wfull);
    for (int k = 0; k < S && k < nk; ++k) load_step(k);
  }

  // warpgroup 0: dW1[e][:, c]^T (64 hidden x 192); warpgroup 1: dW2[e][c, :]
  float acc[moeh::kAcc];
  float rsum[2] = {0.f, 0.f};  // warpgroup 0: db1 of the thread's two hidden rows, its columns
  float bsum[12];              // warpgroup 1 of a chunk-0 owner: db2 of 12 columns, rows ph + 8j
#pragma unroll
  for (int i = 0; i < 12; ++i) bsum[i] = 0.f;
  const bool db2_here = c == 0 && w == 1;
  // the walk of warpgroup W (a compile-time role, so that each warpgroup's
  // wgmma sequence is straight-line code)
  auto walk = [&](auto role) {
    constexpr int W = decltype(role)::value;
    const bf16* b1 = p.b1 + static_cast<long long>(e) * p.h + moeh::kChunk * c;
    const float bias[2] = {to_f(b1[acc_row(0)]), to_f(b1[acc_row(1)])};
    float pa[32];
    uint32_t a[16] = {};
    // the step's first product: h1^T = W1c^T . x^T (warpgroup 0, W1c read
    // MN-major) or dg^T = W2c . dym^T (warpgroup 1), over d; the rows past
    // the kept end of this warpgroup's tile zeroed first
    auto issue_p1 = [&](int k) {
      const int s = k % S, r0 = lo + moeh::kRows * (k0 + k);
      const uint32_t tile = ring + s * kDwStage + W * kTile;  // x, or dy
      mbar_wait(full + 8 * s, (k / S) & 1);
      if (hi - r0 < moeh::kRows) {
        moeh::zero_rows(dw_smem_raw + (tile - smem_u32(dw_smem_raw)), hi - r0, wt);
        fence_proxy_async();
        bgemm::named_sync(2 + W, 128);
      }
      fence_regs<32>(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if constexpr (W == 0) {
          bgemm::wgmma_ss<64, 1, 0>(pa, desc_mnmajor<64>(w1c, kk), desc_kmajor<64>(tile, kk), kk > 0);
        } else {
          bgemm::wgmma_ss<64, 0, 0>(pa, desc_kmajor<64>(w2c, kk), desc_kmajor<64>(tile, kk), kk > 0);
        }
      }
      wgmma_commit();
    };
    mbar_wait(wfull, 0);
    issue_p1(0);
    for (int k = 0; k < nk; ++k) {
      wgmma_wait<0>();  // step k's first product, and step k - 1's second
      fence_regs<32>(pa);
      fence_regs<moeh::kAcc>(acc);
      fence_regs<16>(a);  // read by that second product until the wait
      // this warpgroup's half rounded at its point, to the exchange (pair q:
      // elements 2q, 2q + 1, hidden row half q % 2): h1 = round(round(h1) +
      // b1), dg = round(dg)
      const uint32_t mine = xch + ((k % 2) * 2 + W) * kXchBuf + wt * 4;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        float v0 = pa[2 * q], v1 = pa[2 * q + 1];
        if constexpr (W == 0) {
          v0 = rnd<bf16>(v0) + bias[q % 2];
          v1 = rnd<bf16>(v1) + bias[q % 2];
        }
        moeh::st_shared(mine + q * 512, pack_f32_to_bf16(v0, v1));
      }
      if (k + 1 < nk) issue_p1(k + 1);  // under this step's gelu
      bgemm::named_sync(1, 128 * moeh::kConsumers);  // both halves of step k are in
      // past the barrier both warpgroups are done with step k - 1's stage:
      // step k - 1 + S takes it
      if (W == 0 && wt == 0 && k >= 1 && k - 1 + S < nk) load_step(k - 1 + S);
      // gelu and its derivative share a tanh: this warpgroup takes pairs
      // [8W, 8W + 8) of both and hands the other warpgroup its half (the
      // first needs every dh, the second every g) through the slots only
      // it has read: g over h1's, dh over dg's
      const uint32_t hx = xch + (k % 2) * 2 * kXchBuf + wt * 4, gx = hx + kXchBuf;
#pragma unroll
      for (int q = 8 * W; q < 8 * W + 8; ++q) {
        const uint32_t hw = moeh::ld_shared(hx + q * 512), gw = moeh::ld_shared(gx + q * 512);
        float g0, d0, g1, d1;
        moeh::gelu_and_grad(moeh::lo_f(hw), g0, d0);
        moeh::gelu_and_grad(moeh::hi_f(hw), g1, d1);
        const uint32_t dh = pack_f32_to_bf16(d0 * moeh::lo_f(gw), d1 * moeh::hi_f(gw));  // round(gelu'(h1) dg)
        const uint32_t g = pack_f32_to_bf16(g0, g1);                                     // round(gelu(h1))
        a[q] = W == 0 ? dh : g;
        moeh::st_shared(W == 0 ? hx + q * 512 : gx + q * 512, W == 0 ? g : dh);
      }
      bgemm::named_sync(1, 128 * moeh::kConsumers);  // both halves of dh and g are in
#pragma unroll
      for (int q = 8 * (1 - W); q < 8 * (1 - W) + 8; ++q) a[q] = moeh::ld_shared((W == 0 ? gx : hx) + q * 512);
      if constexpr (W == 0) {  // db1: dh's row sums
#pragma unroll
        for (int q = 0; q < 16; ++q) rsum[q % 2] += moeh::lo_f(a[q]) + moeh::hi_f(a[q]);
      }
      // dW1c^T += dh^T . x, or dW2c += g^T . dym: A from registers, the
      // landed tile read MN-major, three 64-column products
      const uint32_t tile = ring + (k % S) * kDwStage + W * kTile;
      fence_regs<16>(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pp = 0; pp < kD / 64; ++pp)
          bgemm::wgmma_rs<64, 1>(acc + 32 * pp, a + 4 * kk, desc_mnmajor<64>(tile + pp * kBox, kk), k > 0 || kk > 0);
      wgmma_commit();
      if (W == 1 && db2_here) {  // dy's column sums from the landed tile, under the products
        const int ph = wt / 16, cb = 4 * (wt % 16);
#pragma unroll
        for (int j = 0; j < kD / 64; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int r = ph + 8 * jj;
            uint32_t v0, v1;
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(v0), "=r"(v1)
                         : "r"(tile + j * kBox + r * 128 + (((cb / 8) ^ (r % 8)) << 4) + (cb % 8) * 2));
            bsum[4 * j] += moeh::lo_f(v0);
            bsum[4 * j + 1] += moeh::hi_f(v0);
            bsum[4 * j + 2] += moeh::lo_f(v1);
            bsum[4 * j + 3] += moeh::hi_f(v1);
          }
      }
    }
    wgmma_wait<0>();
    fence_regs<moeh::kAcc>(acc);
    fence_regs<16>(a);
  };
  if (nk == 0) {  // no rows: zero gradients
#pragma unroll
    for (int r = 0; r < moeh::kAcc; ++r) acc[r] = 0.f;
  } else if (w == 0) {
    walk(std::integral_constant<int, 0>{});
  } else {
    walk(std::integral_constant<int, 1>{});
  }

  // the bias gradients of this CTA's rows: db1 over each quad (warpgroup 0),
  // db2 over the 8 row phases in order (warpgroup 1 of a chunk-0 owner)
  float db[2] = {0.f, 0.f};
  bgemm::named_sync(1, 128 * moeh::kConsumers);  // the walk is over: the exchange is free
  if (w == 0) {
    db[0] = quad_sum(rsum[0]);
    db[1] = quad_sum(rsum[1]);
  } else if (db2_here) {
    const int ph = wt / 16, cb = 4 * (wt % 16);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        moeh::st_shared(colsum + (ph * kD + 64 * j + cb + q) * 4, __float_as_uint(bsum[4 * j + q]));
    bgemm::named_sync(3, 128);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = wt + 128 * u;
      if (col >= kD) continue;
      float total = 0.f;
      for (int q = 0; q < 8; ++q) total += __uint_as_float(moeh::ld_shared(colsum + (q * kD + col) * 4));
      db[u] = total;
    }
  }
  // the cluster's partials summed in rank order, each output written once
  put_partial(ring + w * kPartial, acc);
  if (w == 0 && tid % 4 == 0) {
    moeh::st_shared(dbuf + acc_row(0) * 4, __float_as_uint(db[0]));
    moeh::st_shared(dbuf + acc_row(1) * 4, __float_as_uint(db[1]));
  } else if (db2_here) {
    moeh::st_shared(dbuf + (64 + wt) * 4, __float_as_uint(db[0]));
    if (wt + 128 < kD) moeh::st_shared(dbuf + (64 + wt + 128) * 4, __float_as_uint(db[1]));
  }
  cluster_sync();
  if (w == 0) {
    float* dw1 = p.dw1 + static_cast<long long>(e) * kD * p.h + moeh::kChunk * c;
    each_summed_output(ring, rank, [&](int row, int col, float v0, float v1) {
      dw1[static_cast<long long>(col) * p.h + row] = v0;
      dw1[static_cast<long long>(col + 1) * p.h + row] = v1;
    });
    if (rank == 0 && tid % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        p.db1[static_cast<long long>(e) * p.h + moeh::kChunk * c + acc_row(i)] = sum_at(dbuf + acc_row(i) * 4);
    }
  } else {
    float* dw2 = p.dw2 + (static_cast<long long>(e) * p.h + moeh::kChunk * c) * kD;
    each_summed_output(ring + kPartial, rank, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(dw2 + row * kD + col) = make_float2(v0, v1);
    });
    if (rank == 0 && db2_here) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = wt + 128 * u;
        if (col < kD)
          p.db2[static_cast<long long>(e) * kD + col] = sum_at(dbuf + (64 + col) * 4);
      }
    }
  }
  cluster_sync();  // no CTA leaves while another reads its partials
}

// 0 on success, a cudaError_t, or minus the CUresult of a map that failed to encode
int launch_dw_bf16(const void* x, const void* dy, const void* w1, const void* w2, const DwArgs& p,
                   cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tdy, tw1, tw2;
  CUresult r = bgemm::encode_rows(&tx, x, p.n, moeh::kD);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&tdy, dy, p.n, moeh::kD);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&tw1, w1, p.e * moeh::kD, p.h);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&tw2, w2, p.e * p.h, moeh::kD);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_dw_wgmma>(dw_smem(), &sms);
  if (err != cudaSuccess) return err;
  moe_ffn_dw_wgmma<<<p.e * (p.h / moeh::kChunk) * kDwCluster, moeh::kThreads, dw_smem(), s>>>(p, tx, tdy, tw1, tw2);
  return cudaGetLastError();
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
// moe_gmm_fwd.  Returns 0 on success, a cudaError_t, or minus the CUresult
// of a tensor map that failed to encode.
extern "C" int moe_gmm_dw(const void* x, const void* dy, const void* w1, const void* b1,
                          const void* w2, const void* starts, void* dw1, void* db1, void* dw2,
                          void* db2, int n, int d, int h, int e, int cap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d != moeh::kD) return cudaErrorInvalidValue;
    const DwArgs p{static_cast<const bf16*>(b1), static_cast<const int*>(starts), static_cast<float*>(dw1),
                   static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
                   n, h, e, cap};
    return launch_dw_bf16(x, dy, w1, w2, p, s);
  }
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
  MOE_DISPATCH_D(d, return launch_dw<float, D>(p, s);)
}

// the dynamic shared memory of a moe_ffn_dw_wgmma launch (any shape)
extern "C" int moe_ffn_dw_wgmma_smem() { return dw_smem(); }
