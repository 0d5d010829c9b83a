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
// fp32 K8: moe_ffn_dx_tf32x3, 3xTF32 on wgmma (tf32x3.cuh; 6.K.d.h fp32
// operations at 165 TFLOP/s, 0.083 ms at the train shape), on K7's
// expert-aligned units and roles: a producer warpgroup and two consumer
// warpgroups of 64 rows (setmaxnreg 56 / 224).  The producer streams the
// expert's weights through the ring of 16 KB split slots, 18 a 64-column
// hidden chunk: W1[e][:, c]ᵀ transposed as it lands (h1's B, as K7's), W2[e][c,
// :] as it lies (K-major over d: dg's B) and W1[e][:, c] as it lies (K-major
// over the chunk's hidden columns: dx's B).  x and dy of both warpgroups as
// raw fragments (192 KB) do not fit beside the ring, so each warpgroup holds
// its dy tile (48 KB) and the first 32 columns of its x tile (8 KB) in shared
// memory and reads the rest of x's fragments from L2 a slot ahead of their
// products (x stays in L2: its 12 reads a unit are ~150 MB of L2 traffic at
// the train shape, whole 32-byte sectors, where dy's natural-order fragments
// would read half sectors).  Per chunk a warpgroup runs h1 = x . W1c and dg =
// dy . W2cᵀ over d in one accumulator each, dh = gelu'(h1 + b1) dg in fp32 on
// the accumulators (one tanh an element), then dx += dh . W1cᵀ: dh's big and
// small fragments from the accumulator, reordered within each quad by two
// shuffles a pair to the natural slots' contraction order, each 64-column
// block of dx the chunk's products in a fresh accumulator added to the total
// in fp32 (the tensor cores truncate; dx, 64 x 192, is 96 registers).  Each
// row sums its chunks in order and is written once: no atomics, two calls
// are bit-identical.  A NaN in x or dy reaches its row (the split keeps it).
// Shared memory: dy 96 KB, x's heads 16 KB, 6 slots 96 KB: 209 KB.
//
// fp32 K9: moe_ffn_dw_tf32x3, 3xTF32 on wgmma (tf32x3.cuh; 8.K.d.h fp32
// operations at 165 TFLOP/s, 0.11 ms at the train shape), on the bf16
// kernel's owners, transposed frame and cluster split (below).  A producer
// warpgroup streams each 64-row step's x and dy through tf32x3.cuh's ring of
// split slots twice: natural (K-major over d, the B of the recompute
// products h1ᵀ = W1cᵀ . xᵀ and dgᵀ = W2c . dymᵀ) and transposed as they
// land (K-major over the rows, in the accumulator's fragment order, the B of
// dW1cᵀ += dhᵀ . x and dW2c += gᵀ . dym, whose A comes from the
// accumulators): tf32 wgmma reads shared memory K-major only, and landing a
// tile twice costs the producer a copy where a transpose in shared memory
// would cost the consumers a pass and a barrier.  Each consumer warpgroup
// holds its weight slice as raw A fragments (48 KB) and splits a k-step at a
// time.  The tensor cores round each accumulation toward zero, and a CTA's
// walk reaches 1280 rows at cap 2560: each step's products go to a fresh
// accumulator added in fp32 to the warpgroup's total (96 registers beside
// the fresh 32 and a slot's fragments 32, of setmaxnreg's 224; the step's
// dhᵀ or gᵀ waits in shared memory).  Shared memory: the two slices 96 KB, 6 slots 96 KB, the exchange
// 32 KB.
//
// bf16 K8: moe_ffn_dx_wgmma (moe_gmm_hopper.cuh), K7's design with a third
// product.  A block owns one of K7's expert-aligned units (up to 128 rows
// of one expert's kept range, a 64-row tile for each of its two consumer
// warpgroups; grid ceil(n / 128) + E from shapes alone), so no tile spans
// two experts and dy needs no mask: a tile's rows past the kept end compute
// values that are never stored (every row's dx depends on that row alone).
// The x and dy tiles land once (TMA); the expert's weights stream in
// 64-column hidden chunks through two rings, W1[e][:, c] (192 x 64) in 3
// stages and W2[e][c, :] (64 x 192) in 2.  Per chunk a warpgroup runs h1 =
// x . W1c (W1c read MN-major), then dg = dym . W2c^T (W2c K-major) and,
// under it, gelu'(round(round(h1) + b1)) in fp32 in h1's registers; then dh
// = round(gelu' . round(dg)) packed to bf16 A fragments and dx += dh . W1c^T
// from registers (W1c read K-major: the landed slice read a second way),
// with the next chunk's h1 issued behind it.  dx, 64 x 192 fp32, is 96
// registers; h1 and dg 32 each.  Shared memory holds the four 24 KB tiles
// (96 KB) beside the rings (120 KB): a single ring of W1c + W2c stages (48
// KB each) fits 2 stages, not 3, and would refill a stage only a part of a
// chunk before its slice is read; the split rings free W2c's stage as soon
// as dg lands and W1c's a chunk ahead.  Each output sums its hidden chunks
// in order in one accumulator and is written once: no atomics, two calls
// are bit-identical.  Every block first writes exact zeros to the rows no
// expert keeps among its share of the 64-row blocks.
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

#include <type_traits>

#include "moe_gmm_common.cuh"
#include "moe_gmm_hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace moe;

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

// The bf16 backward kernels' tensor maps: x and dy (n, d), W1 as (E d, h)
// and W2 as (E h, d) rows.  CUDA_SUCCESS, or the CUresult of the first map
// that failed to encode.
struct BwdMaps {
  alignas(64) CUtensorMap x, dy, w1, w2;
};

CUresult encode_bwd_maps(BwdMaps& m, const void* x, const void* dy, const void* w1, const void* w2, int n, int e,
                         int h) {
  CUresult r = bgemm::encode_rows(&m.x, x, n, moeh::kD);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&m.dy, dy, n, moeh::kD);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&m.w1, w1, e * moeh::kD, h);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&m.w2, w2, e * h, moeh::kD);
  return r;
}

// 0 on success, a cudaError_t, or minus the CUresult of a map that failed to encode
int launch_dw_bf16(const void* x, const void* dy, const void* w1, const void* w2, const DwArgs& p,
                   cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  BwdMaps m;
  const CUresult r = encode_bwd_maps(m, x, dy, w1, w2, p.n, p.e, p.h);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_dw_wgmma>(dw_smem(), &sms);
  if (err != cudaSuccess) return err;
  moe_ffn_dw_wgmma<<<p.e * (p.h / moeh::kChunk) * kDwCluster, moeh::kThreads, dw_smem(), s>>>(p, m.x, m.dy, m.w1,
                                                                                                 m.w2);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 K9

// A step's slots, in this order: x and dy natural (64 rows x 32 of d; six
// pairs, columns 32 j ..: x, then dy), then x and dy transposed (64 of d x
// 32 rows; six pairs, column block j / 2, rows 32 (j % 2) ..: x, then dy).
// Warpgroup W reads the slots of its tensor (0: x, 1: dy) and releases the
// others unread.
constexpr int kDwF32Slots = 4 * moeh::kD / 32;
constexpr int kDwF32Own = moeh::kD / 8 * kFrag;         // a 64 x 192 weight slice, raw fragments: 48 KB
constexpr int kDwF32RingAt = moeh::kConsumers * kDwF32Own;
constexpr int kDwF32Xch = 32 * kWarpgroup * 4;          // a warpgroup's 64 x 64 fp32 accumulator: 16 KB
constexpr int kDwF32XchAt = kDwF32RingAt + kRing * kSlotBytes;
constexpr int kDwF32Bars = kDwF32XchAt + moeh::kConsumers * kDwF32Xch;
constexpr int kDwF32Bytes = kDwF32Bars + 2 * kRing * 8 + 1024;  // the barriers, alignment slack: 225 KB
static_assert(moeh::kConsumers * kPartial <= kRing * kSlotBytes, "the partials reuse the ring");

struct DwF32Args {
  const float* x;     // (n, d) expert-sorted tokens
  const float* dy;    // (n, d)
  const float* w1;    // (E, d, h)
  const float* b1;    // (E, h)
  const float* w2;    // (E, h, d)
  const int* starts;  // (E + 1,)
  float* dw1;         // (E, d, h)
  float* db1;         // (E, h)
  float* dw2;         // (E, h, d)
  float* db2;         // (E, d)
  int n, h, e, cap;
};

// a consumer thread's A fragments of rows r and r + 8 of a 64 x 192 weight
// slice A(i, k) = a[i rs + k ks], raw fp32, its float4 of each k-step
__device__ __forceinline__ void load_w_frags(unsigned char* own, const float* a, long long rs, long long ks, int r,
                                             int t) {
#pragma unroll 4
  for (int kk = 0; kk < moeh::kD / 8; ++kk) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __ldg(a + (r + 8 * frag_row(e)) * rs + (8 * kk + t + 4 * frag_col(e)) * ks);
    *reinterpret_cast<float4*>(own + kk * kFrag) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// the slot u, another warpgroup's, released unread once it landed
__device__ __forceinline__ void pass_slot(uint32_t bars, int& u, int lane) {
  consumer_wait(bars, u);
  consumer_release(bars, u, lane);
  ++u;
}

// One owner per (expert e, 64-column hidden chunk c), its walk over e's
// kept rows split over a cluster of kDwCluster CTAs (dw_walks), as the bf16
// kernel.  Warpgroup 0 of a CTA produces; warpgroup 1 (W 0) holds W1[e][:,
// c]ᵀ and warpgroup 2 (W 1) W2[e][c, :] as raw A fragments (48 KB each).
// Per 64-row step: h1ᵀ = W1cᵀ . xᵀ (W 0) and dgᵀ = W2c . dymᵀ (W 1) over d,
// B the natural slots; the two trade h1 + b1 and dg through shared memory
// and each forms what its weight product needs, dhᵀ = gelu'(h1 + b1) dgᵀ
// (W 0) or gᵀ = gelu(h1 + b1) (W 1); then dW1cᵀ += dhᵀ . x (W 0) and dW2c
// += gᵀ . dym (W 1), A from those values, B the transposed slots, each
// 64-column block's step in a fresh accumulator added to the warpgroup's
// fp32 total (96 registers).  Rows past the kept end land as zeros.  db1
// sums dh in registers, db2 (the columns this owner takes: the experts' db2
// split over their chunks) sums dy from device memory after the walk; the
// cluster's partials are summed through distributed shared memory in rank
// order.
__global__ void __cluster_dims__(kDwCluster, 1, 1) __launch_bounds__(384, 1) moe_ffn_dw_tf32x3(const DwF32Args p) {
  constexpr int kD = moeh::kD;
  extern __shared__ __align__(1024) unsigned char dwf_smem[];
  const uint32_t raw = smem_u32(dwf_smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = dwf_smem + (base - raw);
  const uint32_t ring = base + kDwF32RingAt, xch = base + kDwF32XchAt, bars = base + kDwF32Bars;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kDwCluster, owner = blockIdx.x / kDwCluster;
  const int nc = p.h / moeh::kChunk, e = owner / nc, c0 = moeh::kChunk * (owner % nc);
  int lo, hi;
  kept_range(p.starts, e, p.cap, p.n, lo, hi);
  const int steps = hi > lo ? (hi - lo + moeh::kRows - 1) / moeh::kRows : 0;
  // this CTA's steps of the owner's walk: [k0, k0 + nk), its rows [first, last)
  const int k0 = rank * steps / kDwCluster, nk = (rank + 1) * steps / kDwCluster - k0;
  const int first = lo + moeh::kRows * k0, last = min(first + moeh::kRows * nk, hi);
  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int s = u % kDwF32Slots, r0 = first + moeh::kRows * (u / kDwF32Slots);
      const float* src = s % 2 ? p.dy : p.x;
      if (s < kDwF32Slots / 2) return SlotSrc{src, src, kD, kD, r0, hi, 32 * (s / 2), false};
      const int j = (s - kDwF32Slots / 2) / 2;
      return SlotSrc{src, src, kD, kD, r0 + 32 * (j % 2), hi, 64 * (j / 2), true};
    };
    produce<kSlotRows>(slot_of, nk * kDwF32Slots, sbase + kDwF32RingAt, bars, tid);
    cluster_sync();  // the partials are in
    cluster_sync();  // no CTA leaves while another reads its partials
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int w = tid / 128 - 1, wt = tid % 128, lane = tid % 32, t = lane % 4;
  const int hrow = acc_row(0);  // this thread's hidden rows of the chunk: hrow, hrow + 8
  unsigned char* const own = sbase + w * kDwF32Own + wt * 16;
  float total[moeh::kAcc];  // dW1cᵀ (W 0) or dW2c (W 1): 64 hidden rows x 192
#pragma unroll
  for (int i = 0; i < moeh::kAcc; ++i) total[i] = 0.f;
  float rsum[2] = {0.f, 0.f};  // W 0: db1 of rows hrow, hrow + 8 over this thread's columns

  // the walk of warpgroup W (a compile-time role: each warpgroup's wgmma
  // sequence is straight-line code)
  auto walk = [&](auto role) {
    constexpr int W = decltype(role)::value;
    if constexpr (W == 0) {
      load_w_frags(own, p.w1 + static_cast<long long>(e) * kD * p.h + c0, 1, p.h, hrow, t);
    } else {
      load_w_frags(own, p.w2 + (static_cast<long long>(e) * p.h + c0) * kD, kD, 1, hrow, t);
    }
    const uint32_t mine = xch + W * kDwF32Xch + wt * 4, theirs = xch + (1 - W) * kDwF32Xch + wt * 4;
    int u = 0;
    for (int k = 0; k < nk; ++k) {
      // h1ᵀ or dgᵀ (64 hidden x the step's 64 rows) over d: element 4n + 2i
      // + j is hidden row hrow + 8i, step row 8n + 2t + j
      float pa[32];
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        if constexpr (W == 1) pass_slot(bars, u, lane);
        consumer_wait(bars, u);
        const uint32_t slot = ring + (u % kRing) * kSlotBytes;
        uint32_t big[4][4], small[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          split4(*reinterpret_cast<const float4*>(own + (4 * j + kk) * kFrag), big[kk], small[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_3xtf32<64>(pa, big[kk], small[kk], slot + kk * 32, j > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(pa);
        fence_regs<16>(&big[0][0]);
        fence_regs<16>(&small[0][0]);
        consumer_release(bars, u, lane);
        ++u;
        if constexpr (W == 0) pass_slot(bars, u, lane);
      }
      // trade h1 + b1 (fp32: the kernel's rounding points round nothing)
      // and dg, then dh = gelu'(h1 + b1) dg (W 0) or g = gelu(h1 + b1) (W 1)
      // in place; element r of thread wt at (r 128 + wt) 4: distinct banks
      float bias[2] = {0.f, 0.f};  // b1 of this thread's two hidden rows
      if constexpr (W == 0) {
        bias[0] = __ldg(p.b1 + static_cast<long long>(e) * p.h + c0 + hrow);
        bias[1] = __ldg(p.b1 + static_cast<long long>(e) * p.h + c0 + hrow + 8);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if constexpr (W == 0) pa[r] += bias[(r >> 1) & 1];
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(mine + r * kWarpgroup * 4), "f"(pa[r]) : "memory");
      }
      bgemm::named_sync(2, 256);  // both are in
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float o;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(o) : "r"(theirs + r * kWarpgroup * 4) : "memory");
        if constexpr (W == 0) {
          pa[r] = gelu_tanh_grad(pa[r]) * o;
          rsum[(r >> 1) & 1] += pa[r];
        } else {
          pa[r] = gelu_tanh(o);
        }
      }
      bgemm::named_sync(3, 256);  // both are read: each may overwrite its own
      // dhᵀ or gᵀ parked in this warpgroup's buffer, read back by each thread
      // alone: 32 registers free for the weight products
#pragma unroll
      for (int r = 0; r < 32; ++r)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(mine + r * kWarpgroup * 4), "f"(pa[r]) : "memory");
      // dW1cᵀ += dhᵀ . x or dW2c += gᵀ . dym over the step's rows, a 64-column
      // block at a time; A fragments of 32 rows a slot
#pragma unroll
      for (int pp = 0; pp < kD / 64; ++pp) {
        float part[32];
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          if constexpr (W == 1) pass_slot(bars, u, lane);
          uint32_t big[4][4], small[4][4];
          {
            float a[16];
#pragma unroll
            for (int r = 0; r < 16; ++r)
              asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(a[r]) : "r"(mine + (16 * kc + r) * kWarpgroup * 4) : "memory");
            acc_frags<4>(big, small, a);
          }
          consumer_wait(bars, u);
          const uint32_t slot = ring + (u % kRing) * kSlotBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_3xtf32<64>(part, big[kk], small[kk], slot + kk * 32, kc > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(part);
          fence_regs<16>(&big[0][0]);
          fence_regs<16>(&small[0][0]);
          consumer_release(bars, u, lane);
          ++u;
          if constexpr (W == 0) pass_slot(bars, u, lane);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) total[32 * pp + i] += part[i];
      }
    }
  };
  if (w == 0) {
    walk(std::integral_constant<int, 0>{});
  } else {
    walk(std::integral_constant<int, 1>{});
  }

  // the bias gradients of this CTA's rows into the exchange (db1 at 0, db2
  // at 64 on): db1 over each quad (W 0); db2 over this owner's share of
  // dy's columns, the 4-column groups [g0, g0 + gn), each thread summing
  // every P-th row of one group, the P row phases then added in order (W 1)
  bgemm::named_sync(4, 256);  // the walk is over: the ring and the exchange are free
  unsigned char* const xs = sbase + kDwF32XchAt;
  const int groups = (kD / 4 + nc - 1) / nc, g0 = min(groups * (owner % nc), kD / 4);
  const int gn = min(groups, kD / 4 - g0);
  if (w == 0) {
    const float db[2] = {quad_sum(rsum[0]), quad_sum(rsum[1])};
    if (t == 0) {
      reinterpret_cast<float*>(xs)[hrow] = db[0];
      reinterpret_cast<float*>(xs)[hrow + 8] = db[1];
    }
  } else if (gn > 0) {
    const int P = kWarpgroup / gn, q = wt % gn, ph = wt / gn;
    float4* const phases = reinterpret_cast<float4*>(xs + 1024);  // (P, gn)
    if (ph < P) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = first + ph; r < last; r += P) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p.dy + static_cast<long long>(r) * kD) + g0 + q);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      phases[ph * gn + q] = sum;
    }
    bgemm::named_sync(5, 128);
    for (int col = wt; col < 4 * gn; col += kWarpgroup) {
      float sum = 0.f;
      for (int f = 0; f < P; ++f) sum += reinterpret_cast<const float*>(phases + f * gn)[col];
      reinterpret_cast<float*>(xs)[64 + col] = sum;
    }
  }
  // the cluster's partials summed in rank order, each output written once
  put_partial(ring + w * kPartial, total);
  cluster_sync();
  if (w == 0) {
    float* dw1 = p.dw1 + static_cast<long long>(e) * kD * p.h + c0;
    each_summed_output(ring, rank, [&](int row, int col, float v0, float v1) {
      dw1[static_cast<long long>(col) * p.h + row] = v0;
      dw1[static_cast<long long>(col + 1) * p.h + row] = v1;
    });
    if (rank == 0 && t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) p.db1[static_cast<long long>(e) * p.h + c0 + hrow + 8 * i] = sum_at(xch + (hrow + 8 * i) * 4);
    }
  } else {
    float* dw2 = p.dw2 + (static_cast<long long>(e) * p.h + c0) * kD;
    each_summed_output(ring + kPartial, rank, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(dw2 + row * kD + col) = make_float2(v0, v1);
    });
    if (rank == 0)
      for (int col = wt; col < 4 * gn; col += kWarpgroup)
        p.db2[static_cast<long long>(e) * kD + 4 * g0 + col] = sum_at(xch + (64 + col) * 4);
  }
  cluster_sync();  // no CTA leaves while another reads its partials
}

// 0 on success, else a cudaError_t
int launch_dw_f32(const DwF32Args& p, cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_dw_tf32x3>(kDwF32Bytes, &sms);
  if (err != cudaSuccess) return err;
  moe_ffn_dw_tf32x3<<<p.e * (p.h / moeh::kChunk) * kDwCluster, 384, kDwF32Bytes, s>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 K8

struct DxArgs {
  const bf16* b1;     // (E, h)
  const int* starts;  // (E + 1,)
  bf16* dx;           // (n, d)
  int n, h, e, cap;
};

constexpr int kDxW1Stages = 3;  // W1[e][:, c]: read by h1, then a chunk later by dx
constexpr int kDxW2Stages = 2;  // W2[e][c, :]: read by dg alone

// the x and dy tiles of both warpgroups, the W1 and W2 rings, their full
// and empty barriers and the tiles' barrier, 1 KB of alignment slack: 217 KB
constexpr int dx_smem() {
  return 2 * moeh::kConsumers * moeh::kTile + (kDxW1Stages + kDxW2Stages) * moeh::kTile +
         8 * (2 * (kDxW1Stages + kDxW2Stages) + 1) + 1024;
}

__global__ void __launch_bounds__(moeh::kThreads, 1)
    moe_ffn_dx_wgmma(const DxArgs p, const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw1,
                     const __grid_constant__ CUtensorMap tw2) {
  using moeh::kBox;
  using moeh::kTile;
  constexpr int S1 = kDxW1Stages, S2 = kDxW2Stages, kD = moeh::kD;
  extern __shared__ __align__(1024) unsigned char dx_smem_raw[];
  __shared__ int st[kMaxExperts + 1];
  __shared__ unsigned char dropped[moeh::kRows];
  const uint32_t base = (smem_u32(dx_smem_raw) + 1023) & ~1023u;
  // warpgroup v's x tile at xt + v kTile, its dy tile at dyt + v kTile
  const uint32_t xt = base, dyt = xt + moeh::kConsumers * kTile;
  const uint32_t w1r = dyt + moeh::kConsumers * kTile, w2r = w1r + S1 * kTile;
  const uint32_t full1 = w2r + S2 * kTile, empty1 = full1 + 8 * S1;
  const uint32_t full2 = empty1 + 8 * S1, empty2 = full2 + 8 * S2, tfull = empty2 + 8 * S2;
  const int tid = threadIdx.x, w = tid / 128, lane = tid % 32;

  for (int i = tid; i <= p.e; i += blockDim.x) st[i] = p.starts[i];
  __syncthreads();
  moeh::zero_unkept(p.dx, st, p.e, p.cap, p.n, dropped);
  int e = 0, lo = 0, hi = 0;
  const bool has = moeh::expert_unit(st, p.e, p.cap, p.n, blockIdx.x, e, lo, hi);
  // warpgroup v's tile: rows [lo + 64 v, min(lo + 64 v + 64, hi)); the
  // second is empty where the unit has 64 rows or fewer
  const int active = has ? (hi - lo > moeh::kRows ? 2 : 1) : 0;
  const int nloc = p.h / moeh::kChunk;
  if (tid == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(full1 + 8 * s, 1);
      mbar_init(empty1 + 8 * s, 4 * (active > 0 ? active : 1));  // the active warpgroups' warps
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(full2 + 8 * s, 1);
      mbar_init(empty2 + 8 * s, 4 * (active > 0 ? active : 1));
    }
    mbar_init(tfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk i's W1 slice (three boxes stacked) or W2 slice (three side by
  // side) into its ring's stage i % S, completing on that stage's full barrier
  auto load_w1 = [&](int i) {
    const uint32_t bar = full1 + 8 * (i % S1), dst = w1r + (i % S1) * kTile;
    mbar_expect_tx(bar, kTile);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(dst + j * kBox, &tw1, moeh::kChunk * i, e * kD + 64 * j, 0, 0, bar);
  };
  auto load_w2 = [&](int i) {
    const uint32_t bar = full2 + 8 * (i % S2), dst = w2r + (i % S2) * kTile;
    mbar_expect_tx(bar, kTile);
#pragma unroll
    for (int j = 0; j < kD / 64; ++j) tma_load(dst + j * kBox, &tw2, 64 * j, e * p.h + moeh::kChunk * i, 0, 0, bar);
  };
  if (tid == 0 && active > 0) {  // the x and dy tiles and the rings' first chunks
    mbar_expect_tx(tfull, 2 * active * kTile);
    for (int v = 0; v < active; ++v)
#pragma unroll
      for (int j = 0; j < kD / 64; ++j) {
        tma_load(xt + v * kTile + j * kBox, &tx, 64 * j, lo + moeh::kRows * v, 0, 0, tfull);
        tma_load(dyt + v * kTile + j * kBox, &tdy, 64 * j, lo + moeh::kRows * v, 0, 0, tfull);
      }
    for (int i = 0; i < S1 && i < nloc; ++i) load_w1(i);
    for (int i = 0; i < S2 && i < nloc; ++i) load_w2(i);
  }

  float dx[moeh::kAcc];  // written first by the first chunk's products
  if (w < active) {  // a warpgroup with rows
    const uint32_t xw = xt + w * kTile, dyw = dyt + w * kTile;
    const bf16* b1 = p.b1 + static_cast<long long>(e) * p.h;
    float h[32], dg[32], gp[32];
    uint32_t a[16] = {}, bias[8];
    // this thread's b1 pairs of chunk i (columns 8 nb + 2 t, + 1)
    auto load_bias = [&](int i) {
      const bf16* bc = b1 + moeh::kChunk * i + 2 * (tid % 4);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) bias[nb] = __ldg(reinterpret_cast<const unsigned int*>(bc + 8 * nb));
    };
    // h1 = x . W1[e][:, chunk i], K-major x against the MN-major W1 slice
    auto issue_h = [&](int i) {
      mbar_wait(full1 + 8 * (i % S1), (i / S1) & 1);
      fence_regs<32>(h);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        bgemm::wgmma_ss<64, 0, 1>(h, desc_kmajor<64>(xw, kk), desc_mnmajor<64>(w1r + (i % S1) * kTile, kk), kk > 0);
      wgmma_commit();
    };
    load_bias(0);
    mbar_wait(tfull, 0);
    issue_h(0);
    for (int i = 0; i < nloc; ++i) {
      wgmma_wait<0>();  // chunk i's h1, and chunk i - 1's dx product
      fence_regs<32>(h);
      fence_regs<moeh::kAcc>(dx);
      fence_regs<16>(a);  // read by that product until the wait
      if (i > 0 && lane == 0) mbar_arrive(empty1 + 8 * ((i - 1) % S1));  // chunk i - 1's W1 slice is free
      // dg = dym . W2[e][chunk i, :]^T over d: the dy tile and the W2 slice
      // both K-major
      const int s2 = i % S2;
      mbar_wait(full2 + 8 * s2, (i / S2) & 1);
      fence_regs<32>(dg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        bgemm::wgmma_ss<64, 0, 0>(dg, desc_kmajor<64>(dyw, kk), desc_kmajor<64>(w2r + s2 * kTile, kk), kk > 0);
      wgmma_commit();
      // the W1 ring refilled: chunk i + 2 into chunk i - 1's stage once
      // every warpgroup with rows has released it
      if (tid == 0 && i >= 1 && i + 2 < nloc) {
        mbar_wait(empty1 + 8 * ((i - 1) % S1), ((i - 1) / S1) & 1);
        load_w1(i + 2);
      }
      // gelu'(h1) in fp32 under dg, h1 = round(round(x . W1c) + b1);
      // element 4 nb + 2 i2 (+ 1) is column 8 nb + 2 t (+ 1).  Into registers
      // of its own: an accumulator written while a wgmma is in flight
      // serializes every wgmma (ptxas C7515)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int k = 4 * nb + 2 * i2;
          gp[k] = gelu_tanh_grad(rnd<bf16>(rnd<bf16>(h[k]) + moeh::lo_f(bias[nb])));
          gp[k + 1] = gelu_tanh_grad(rnd<bf16>(rnd<bf16>(h[k + 1]) + moeh::hi_f(bias[nb])));
        }
      if (i + 1 < nloc) load_bias(i + 1);
      wgmma_wait<0>();  // dg
      fence_regs<32>(dg);
      if (lane == 0) mbar_arrive(empty2 + 8 * s2);  // chunk i's W2 slice is free
      // dh = round(gelu'(h1) . round(dg)): the A fragments of the 16-deep steps
#pragma unroll
      for (int q = 0; q < 16; ++q)
        a[q] = pack_f32_to_bf16(gp[2 * q] * rnd<bf16>(dg[2 * q]), gp[2 * q + 1] * rnd<bf16>(dg[2 * q + 1]));
      // dx += dh . W1[e][:, chunk i]^T from registers, the landed W1 slice
      // read K-major: three 64-column products, one a box of d rows
      const uint32_t w1s = w1r + (i % S1) * kTile;
      fence_regs<16>(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pp = 0; pp < kD / 64; ++pp)
          bgemm::wgmma_rs<64, 0>(dx + 32 * pp, a + 4 * kk, desc_kmajor<64>(w1s + pp * kBox, kk), i > 0 || kk > 0);
      wgmma_commit();
      if (i + 1 < nloc) issue_h(i + 1);  // behind dx, on the tensor cores
      // the W2 ring refilled: chunk i + 2 into chunk i's stage once every
      // warpgroup with rows has its dg
      if (tid == 0 && i + 2 < nloc) {
        mbar_wait(empty2 + 8 * s2, (i / S2) & 1);
        load_w2(i + 2);
      }
    }
    wgmma_wait<0>();
    fence_regs<moeh::kAcc>(dx);
    fence_regs<16>(a);

    // dx rounded once, stored to the tile's rows
    const int r0 = lo + moeh::kRows * w, rows = min(hi - r0, moeh::kRows);
    bf16* out = p.dx + static_cast<long long>(r0) * kD;
    moeh::each_output(dx, [&](int row, int col, float v0, float v1) {
      if (row < rows) *reinterpret_cast<uint32_t*>(out + row * kD + col) = pack_f32_to_bf16(v0, v1);
    });
  }
}

// 0 on success, a cudaError_t, or minus the CUresult of a map that failed to encode
int launch_dx_bf16(const void* x, const void* dy, const void* w1, const void* w2, const DxArgs& p,
                   cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  BwdMaps m;
  const CUresult r = encode_bwd_maps(m, x, dy, w1, w2, p.n, p.e, p.h);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_dx_wgmma>(dx_smem(), &sms);
  if (err != cudaSuccess) return err;
  const int units = (p.n + moeh::kUnitRows - 1) / moeh::kUnitRows + p.e;
  moe_ffn_dx_wgmma<<<units, moeh::kThreads, dx_smem(), s>>>(p, m.x, m.dy, m.w1, m.w2);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 K8

// A hidden chunk's slots, in the consumers' order: W1[e][:, chunk]ᵀ (six: 64
// hidden columns x 32 of d, transposed as they land: h1's B), W2[e][chunk, :]
// (six: 64 hidden rows x 32 of d, as it lies: dg's B), then W1[e][:, chunk]
// (six: 64 of d x 32 hidden columns, as it lies, column block major: dx's B).
constexpr int kDxF32Slots = 3 * moeh::kD / 32;
constexpr int kDxF32Own = moeh::kD / 8 * kFrag;   // a warpgroup's dy tile, raw fragments: 48 KB
constexpr int kDxF32Head = 4 * kFrag;             // its x tile's first 32 columns: 8 KB
constexpr int kDxF32HeadAt = moeh::kConsumers * kDxF32Own;
constexpr int kDxF32RingAt = kDxF32HeadAt + moeh::kConsumers * kDxF32Head;
constexpr int kDxF32Bars = kDxF32RingAt + kRing * kSlotBytes;
constexpr int kDxF32Bytes = kDxF32Bars + 2 * kRing * 8 + 1024;  // the barriers, alignment slack: 209 KB

struct DxF32Args {
  const float* x;     // (n, d) expert-sorted tokens
  const float* dy;    // (n, d)
  const float* w1;    // (E, d, h)
  const float* b1;    // (E, h)
  const float* w2;    // (E, h, d)
  const int* starts;  // (E + 1,)
  float* dx;          // (n, d)
  int n, h, e, cap;
};

// a consumer thread's A fragments of dy rows `row` and `row + 8` (zeros at or
// past `end`), raw fp32, in the natural slots' contraction order: element e
// of k-step kk is column 8 kk + t + 4 frag_col(e) of row row + 8 frag_row(e)
__device__ __forceinline__ void load_dy_frags(unsigned char* own, const float* dy, int row, int end, int t) {
  const float* r0 = dy + static_cast<long long>(row) * moeh::kD + t;
  const float* r8 = r0 + 8 * moeh::kD;
#pragma unroll 4
  for (int kk = 0; kk < moeh::kD / 8; ++kk) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < end) v.x = __ldg(r0 + 8 * kk), v.z = __ldg(r0 + 8 * kk + 4);
    if (row + 8 < end) v.y = __ldg(r8 + 8 * kk), v.w = __ldg(r8 + 8 * kk + 4);
    *reinterpret_cast<float4*>(own + kk * kFrag) = v;
  }
}

// the raw A fragments of x rows r0 and r8 (their columns 2t on; zeros where
// not `in`) for k-steps 4 cc .. 4 cc + 3, in the transposed slots'
// contraction order: element e of k-step kk is column 8 kk + 2t + frag_col(e)
// of row r0, or r8 where frag_row(e) is 1 (moe_gmm_fwd.cu's load_x_frags)
__device__ __forceinline__ void fetch_x_frags(float4 (&f)[4], const float* r0, const float* r8, bool in0, bool in8,
                                              int cc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = 8 * (4 * cc + kk);
    const float2 a = in0 ? __ldg(reinterpret_cast<const float2*>(r0 + col)) : make_float2(0.f, 0.f);
    const float2 b = in8 ? __ldg(reinterpret_cast<const float2*>(r8 + col)) : make_float2(0.f, 0.f);
    f[kk] = make_float4(a.x, b.x, a.y, b.y);
  }
}

// acc (64 x 64, fresh) = x rows . W1[e][:, chunk] over d, B the chunk's six
// transposed W1ᵀ slots.  x's A fragments: the first slot's from shared
// memory (`head`, the same every chunk), the others read from device memory
// (L2) a slot ahead of their products and split as they are used.
__device__ __forceinline__ void h1_over_d(float* acc, const unsigned char* head, const float* r0, const float* r8,
                                          bool in0, bool in8, uint32_t ring, uint32_t bars, int& u, int lane) {
  float4 raw[2][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) raw[0][kk] = *reinterpret_cast<const float4*>(head + kk * kFrag);
#pragma unroll
  for (int cc = 0; cc < moeh::kD / 32; ++cc) {
    if (cc + 1 < moeh::kD / 32) fetch_x_frags(raw[(cc + 1) & 1], r0, r8, in0, in8, cc + 1);
    consumer_wait(bars, u);
    const uint32_t slot = ring + (u % kRing) * kSlotBytes;
    uint32_t big[4][4], small[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split4(raw[cc & 1][kk], big[kk], small[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_3xtf32<64>(acc, big[kk], small[kk], slot + kk * 32, cc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    fence_regs<16>(&big[0][0]);
    fence_regs<16>(&small[0][0]);
    consumer_release(bars, u, lane);
    ++u;
  }
}

// A 64 x 64 fp32 accumulator as big and small tf32 A fragments of 8 k-steps
// in the natural slots' contraction order: fragment element e of k-step n is
// column 8n + t + 4 frag_col(e) of row g + 8 frag_row(e), which quad thread
// (t + 4 frag_col(e)) / 2 holds as its element 4n + 2 frag_row(e) + t % 2.
// Two shuffles a pair of elements: in the first, quad thread s sends its
// element of parity s / 2 and thread t reads thread t / 2 + 2 (t % 2); in
// the second, parity 1 - s / 2 from thread t / 2 + 2 (1 - t % 2).  An even
// thread reads its column t from the first and t + 4 from the second, an odd
// one the other way round.
__device__ __forceinline__ void acc_frags_natural(uint32_t (*big)[4], uint32_t (*small)[4], const float* x,
                                                  int lane) {
  const int t = lane & 3, quad = lane & ~3, half = t >> 1, odd = t & 1;
  const int src1 = quad | half | (odd << 1), src2 = quad | half | ((odd ^ 1) << 1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v0 = x[4 * n + 2 * i], v1 = x[4 * n + 2 * i + 1];
      const float s1 = __shfl_sync(0xffffffffu, half ? v1 : v0, src1);
      const float s2 = __shfl_sync(0xffffffffu, half ? v0 : v1, src2);
      split_tf32(odd ? s2 : s1, big[n][i], small[n][i]);          // column t, row g + 8i
      split_tf32(odd ? s1 : s2, big[n][2 + i], small[n][2 + i]);  // column t + 4
    }
  }
}

// One block a unit of K7's (expert_unit), as the bf16 kernel.  Warpgroup 0
// produces the ring; consumer warpgroup c takes the unit's rows lo + 64 c ..
// and holds its dy tile (raw A fragments, natural order) and the first 32
// columns of its x tile (raw, in the transposed slots' order) in shared
// memory.  Per 64-column hidden chunk: h1 = x . W1c (x's other columns from
// L2) and dg = dy . W2cᵀ over d, one accumulator each; dh = gelu'(h1 + b1) dg
// in fp32 in dg's registers; dh's fragments reordered to the natural
// contraction order (acc_frags_natural); then dx += dh . W1cᵀ, each 64-column
// block of dx the chunk's products in a fresh accumulator added to the total
// in fp32 (sums).  Each row of dx sums its chunks in order and is written
// once.
__global__ void __launch_bounds__(384, 1) moe_ffn_dx_tf32x3(const DxF32Args p) {
  constexpr int kD = moeh::kD;
  extern __shared__ __align__(1024) unsigned char dxf_smem[];
  __shared__ int st[kMaxExperts + 1];
  __shared__ unsigned char dropped[moeh::kRows];
  const uint32_t raw = smem_u32(dxf_smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = dxf_smem + (base - raw);
  const uint32_t ring = base + kDxF32RingAt, bars = base + kDxF32Bars;
  const int tid = threadIdx.x;

  for (int i = tid; i <= p.e; i += blockDim.x) st[i] = p.starts[i];
  __syncthreads();
  moeh::zero_unkept(p.dx, st, p.e, p.cap, p.n, dropped);
  int e = 0, lo = 0, hi = 0;
  if (!moeh::expert_unit(st, p.e, p.cap, p.n, blockIdx.x, e, lo, hi)) return;  // past the last unit
  const int total = p.h / moeh::kChunk * kDxF32Slots;
  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    const float* w1 = p.w1 + static_cast<long long>(e) * kD * p.h;
    const float* w2 = p.w2 + static_cast<long long>(e) * p.h * kD;
    auto slot_of = [&](int u) {
      const int r = u % kDxF32Slots, c0 = u / kDxF32Slots * moeh::kChunk;
      if (r < kD / 32)  // slot row n: W1[e] column c0 + n over rows (d) 32 r ..
        return SlotSrc{w1, w1, p.h, p.h, 32 * r, kD, c0, true};
      if (r < 2 * kD / 32)  // slot row n: W2[e] row c0 + n, columns (d) 32 (r - 6) ..
        return SlotSrc{w2, w2, kD, kD, c0, p.h, 32 * (r - kD / 32), false};
      // slot row n: W1[e] row 64 (q / 2) + n, columns (hidden) c0 + 32 (q % 2) ..
      const int q = r - 2 * kD / 32;
      return SlotSrc{w1, w1, p.h, p.h, 64 * (q / 2), kD, c0 + 32 * (q % 2), false};
    };
    produce<kSlotRows>(slot_of, total, sbase + kDxF32RingAt, bars, tid);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1, wt = tid % 128, lane = tid % 32, t = lane % 4;
  const int row0 = lo + moeh::kRows * c;  // this warpgroup's tile: rows row0 .. min(row0 + 64, hi)
  int u = 0;
  if (row0 >= hi) {  // a unit of 64 rows or fewer: the second warpgroup only releases the slots
    for (; u < total; ++u) {
      consumer_wait(bars, u);
      consumer_release(bars, u, lane);
    }
    return;
  }
  const int row = row0 + 16 * (wt / 32) + lane / 4;  // this thread's rows: row and row + 8
  unsigned char* const own = sbase + c * kDxF32Own + wt * 16;
  unsigned char* const head = sbase + kDxF32HeadAt + c * kDxF32Head + wt * 16;
  load_dy_frags(own, p.dy, row, hi, t);  // read back by this thread alone, as is the head
  const bool in0 = row < hi, in8 = row + 8 < hi;
  const float* x0 = p.x + static_cast<long long>(in0 ? row : lo) * kD + 2 * t;
  const float* x8 = p.x + static_cast<long long>(in8 ? row + 8 : lo) * kD + 2 * t;
  {
    float4 f[4];
    fetch_x_frags(f, x0, x8, in0, in8, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) *reinterpret_cast<float4*>(head + kk * kFrag) = f[kk];
  }
  const float* b1 = p.b1 + static_cast<long long>(e) * p.h + 2 * t;

  float dx[kD / 64][32];
#pragma unroll
  for (int hh = 0; hh < kD / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dx[hh][i] = 0.f;
  for (int c0 = 0; c0 < p.h; c0 += moeh::kChunk) {
    // h1 and dg over d (element 4n + 2i + j: hidden column c0 + 8n + 2t + j
    // of row + 8i), then dh = gelu'(h1 + b1) dg in fp32, in dg's registers
    float h1[32], dg[32];
    h1_over_d(h1, head, x0, x8, in0, in8, ring, bars, u, lane);
    scores<kD>(dg, own, ring, bars, u, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * n));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dg[4 * n + 2 * i] *= gelu_tanh_grad(h1[4 * n + 2 * i] + bb.x);
        dg[4 * n + 2 * i + 1] *= gelu_tanh_grad(h1[4 * n + 2 * i + 1] + bb.y);
      }
    }
    // dx += dh . W1[e][:, chunk]ᵀ, dh's fragments in the natural slots' order
    uint32_t big[8][4], small[8][4];
    acc_frags_natural(big, small, dg, lane);
    sums<kD, 8>(dx, big, small, ring, bars, u, lane);
  }
#pragma unroll
  for (int hh = 0; hh < kD / 64; ++hh) store_f32(p.dx, kD, row, hi, 64 * hh, dx[hh], t);
}

// 0 on success, else a cudaError_t
int launch_dx_f32(const DxF32Args& p, cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_dx_tf32x3>(kDxF32Bytes, &sms);
  if (err != cudaSuccess) return err;
  const int blocks = (p.n + moeh::kUnitRows - 1) / moeh::kUnitRows + p.e;
  moe_ffn_dx_tf32x3<<<blocks, 384, kDxF32Bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dx of the grouped FFN (moe_gmm_fwd's arguments plus dy (n, d) in the
// compute dtype) into dx (n, d).  moe_gmm_fwd's shape rules.
// Returns 0 on success, a cudaError_t, or minus the CUresult of a tensor
// map that failed to encode.
extern "C" int moe_gmm_dx(const void* x, const void* dy, const void* w1, const void* b1,
                          const void* w2, const void* starts, void* dx, int n, int d, int h, int e,
                          int cap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != moeh::kD) return cudaErrorInvalidValue;
  if (is_bf16) {
    const DxArgs p{static_cast<const bf16*>(b1), static_cast<const int*>(starts), static_cast<bf16*>(dx),
                   n, h, e, cap};
    return launch_dx_bf16(x, dy, w1, w2, p, s);
  }
  const DxF32Args p{static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(w1),
                    static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const int*>(starts),
                    static_cast<float*>(dx), n, h, e, cap};
  return launch_dx_f32(p, s);
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
  if (d != moeh::kD) return cudaErrorInvalidValue;
  const DwF32Args p{static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(w1),
                    static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const int*>(starts),
                    static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dw2),
                    static_cast<float*>(db2), n, h, e, cap};
  return launch_dw_f32(p, s);
}

// the dynamic shared memory of a moe_ffn_dx_wgmma or moe_ffn_dw_wgmma launch (any shape)
extern "C" int moe_ffn_dx_wgmma_smem() { return dx_smem(); }
extern "C" int moe_ffn_dw_wgmma_smem() { return dw_smem(); }
