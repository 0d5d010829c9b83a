// The grouped expert FFN forward for Hopper (sm_90a), bound through a plain
// C function and loaded with ctypes (ops/moe_gmm.py::grouped_ffn_fwd).
//
// Replaces the TPU kernel distributed_training_comparison_tpu/ops/moe_gmm.py
// ::_ffn_kernel (K7, moe_gmm.py:71, called through _row_grid_call at :189,
// pallas_call at :200):
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
// What bounds it: 4.K.d.h operations for the K kept rows against reading x,
// the weights and writing y.  At vit_moe's serve shape (bucket 32: n 2048,
// d 192, h 768, E 8, cap 320, bf16) that is ~1.2 GFLOP against ~6 MB, so
// bytes bound it (~2 us at 3.35 TB/s); at the train shape (n 16384, cap
// 2560) ~9 GFLOP, so operations (~9 us at 989 TFLOP/s).
//
// bf16: moe_ffn_fwd_wgmma (moe_gmm_hopper.cuh).  A block owns a unit of up
// to 128 rows of one expert's kept range (expert-aligned: no unit straddles
// two experts, so no row runs another expert's MLP), a 64-row tile for each
// of its two consumer warpgroups, and finds the unit itself from `starts`;
// the host sizes the grid from shapes alone, ceil(n / 128) + E units.  The
// block's first thread lands each warpgroup's x tile once (TMA, 128-byte
// swizzle) and streams the expert's weights through a 3-stage ring, a
// 64-column hidden chunk a stage, refilling a stage once both warpgroups
// have released it: W1[e][:, chunk] (192 x 64) and W2[e][chunk, :] (64 x
// 192), both read MN-major as they lie in memory.  Per chunk a warpgroup
// runs h = x . W1 chunk (an m64n64 wgmma, 32 registers), adds the bias and
// rounds in registers, issues the next chunk's h under this chunk's gelu,
// packs gelu(h) to bf16 A fragments and runs y += g . W2 chunk from
// registers (three m64n64 wgmma, K1's P.V form): the activation never
// leaves the registers.  y, 64 x 192 fp32, is 96 registers a thread; the
// block's two warpgroups get up to 255 a thread, one block an SM.
// The weights (0.59 MB an expert in bf16) are read from L2 once a unit; the
// two warpgroups share each landed chunk and their gelu runs under each
// other's products.  Each output sums its hidden chunks in order in one
// accumulator, so it rounds exactly as a sequential fp32 sum (cuBLAS's,
// under the gather dispatch) does.  Every block first writes exact zeros
// to the rows no expert keeps among its share of the 64-row blocks.  At the
// serve buckets the units are fewer than the SMs (bucket 32: about 20 of
// 132); a cluster of 4 CTAs a unit, each summing a quarter of the hidden
// chunks, its fp32 partials added through distributed shared memory, was
// tried and not kept: it changed the summation order enough to move
// serve_moe's logits off the gather dispatch's by one bf16 ulp (PERF.md).
//
// fp32: moe_gmm_fwd_kernel (the first port, on moe_gmm_common.cuh's SIMT
// tiles).  One block of 128 threads owns a 64-row tile of the sorted
// tokens, loops over the experts whose kept range overlaps it and, per
// expert, over the hidden dimension in chunks of 32: W1 and W2 chunks
// staged in shared memory, the gelu chunk formed on chip, a (64, d) fp32
// accumulator in registers; rows in no expert's range are written as 0.

#include "moe_gmm_common.cuh"
#include "moe_gmm_hopper.cuh"

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

// ------------------------------------------------------------------ bf16

struct FfnArgs {
  const bf16* b1;     // (E, h)
  const bf16* b2;     // (E, d)
  const int* starts;  // (E + 1,)
  bf16* y;            // (n, d)
  int n, h, e, cap;
};

constexpr int kFwdStages = 3;
constexpr int kFwdStage = 2 * moeh::kTile;  // W1[e][:, chunk] (192 x 64), then W2[e][chunk, :] (64 x 192)

// the x tiles, the ring, its barriers and the x barrier, 1 KB of alignment slack
constexpr int ffn_fwd_smem() {
  return moeh::kConsumers * moeh::kTile + kFwdStages * kFwdStage + 8 * (2 * kFwdStages + 1) + 1024;
}

__global__ void __launch_bounds__(moeh::kThreads, 1)
    moe_ffn_fwd_wgmma(const FfnArgs p, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2) {
  using moeh::kBox;
  using moeh::kTile;
  constexpr int S = kFwdStages;
  extern __shared__ __align__(1024) unsigned char ffn_smem[];
  __shared__ int st[kMaxExperts + 1];
  __shared__ unsigned char dropped[moeh::kRows];
  const uint32_t base = (smem_u32(ffn_smem) + 1023) & ~1023u;
  const uint32_t xt = base, ring = xt + moeh::kConsumers * kTile;
  const uint32_t full = ring + S * kFwdStage, empty = full + 8 * S, xfull = empty + 8 * S;
  const int tid = threadIdx.x, w = tid / 128, lane = tid % 32;

  for (int i = tid; i <= p.e; i += blockDim.x) st[i] = p.starts[i];
  __syncthreads();
  moeh::zero_unkept(p.y, st, p.e, p.cap, p.n, dropped);
  int e = 0, lo = 0, hi = 0;
  const bool has = moeh::expert_unit(st, p.e, p.cap, p.n, blockIdx.x, e, lo, hi);
  // warpgroup v's tile: rows [lo + 64 v, min(lo + 64 v + 64, hi)); the
  // second is empty where the unit has 64 rows or fewer
  const int active = has ? (hi - lo > moeh::kRows ? 2 : 1) : 0;
  const int nloc = p.h / moeh::kChunk;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * (active > 0 ? active : 1));  // the active warpgroups' warps
    }
    mbar_init(xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk i's W1 and W2 slices into stage i % S, completing on its full barrier
  auto load_chunk = [&](int i) {
    const int s = i % S, c = i;
    const uint32_t stage = ring + s * kFwdStage;
    mbar_expect_tx(full + 8 * s, kFwdStage);
#pragma unroll
    for (int j = 0; j < moeh::kD / 64; ++j)
      tma_load(stage + j * kBox, &tw1, moeh::kChunk * c, e * moeh::kD + 64 * j, 0, 0, full + 8 * s);
#pragma unroll
    for (int j = 0; j < moeh::kD / 64; ++j)
      tma_load(stage + kTile + j * kBox, &tw2, 64 * j, e * p.h + moeh::kChunk * c, 0, 0, full + 8 * s);
  };
  if (tid == 0 && active > 0) {  // the x tiles and the ring's first chunks
    mbar_expect_tx(xfull, active * kTile);
    for (int v = 0; v < active; ++v)
#pragma unroll
      for (int j = 0; j < moeh::kD / 64; ++j)
        tma_load(xt + v * kTile + j * kBox, &tx, 64 * j, lo + moeh::kRows * v, 0, 0, xfull);
    for (int i = 0; i < S && i < nloc; ++i) load_chunk(i);
  }

  float y[moeh::kAcc];  // written first by the first chunk's products
  if (w < active) {  // a warpgroup with rows
    const uint32_t xw = xt + w * kTile;
    const bf16* b1 = p.b1 + static_cast<long long>(e) * p.h;
    float h[32];
    uint32_t pre[16], a[16] = {}, bias[8], bias_next[8] = {};
    // this thread's b1 pairs of chunk i (columns 8 nb + 2 t, + 1), loaded a
    // chunk ahead
    auto load_bias = [&](uint32_t (&b)[8], int i) {
      const bf16* bc = b1 + moeh::kChunk * i + 2 * (tid % 4);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) b[nb] = __ldg(reinterpret_cast<const unsigned int*>(bc + 8 * nb));
    };
    load_bias(bias, 0);
    // h = x . W1[e][:, chunk i], K-major x against the MN-major W1 slice
    auto issue_h = [&](int i) {
      const int s = i % S;
      mbar_wait(full + 8 * s, (i / S) & 1);
      fence_regs<32>(h);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < moeh::kD / 16; ++kk)
        bgemm::wgmma_ss<64, 0, 1>(h, desc_kmajor<64>(xw, kk), desc_mnmajor<64>(ring + s * kFwdStage, kk), kk > 0);
      wgmma_commit();
    };
    mbar_wait(xfull, 0);
    issue_h(0);
    for (int i = 0; i < nloc; ++i) {
      wgmma_wait<0>();  // chunk i's h, and chunk i - 1's y product
      fence_regs<32>(h);
      fence_regs<moeh::kAcc>(y);
      fence_regs<16>(a);  // read by that product until the wait
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % S));  // chunk i - 1's stage is free
      // the pre-gelu activation: round(h) + b1, rounded; pair q holds
      // elements 2q, 2q + 1 (8-column block q / 2, row half q % 2)
      if (i + 1 < nloc) load_bias(bias_next, i + 1);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
          pre[2 * nb + i2] = pack_f32_to_bf16(rnd<bf16>(h[4 * nb + 2 * i2]) + moeh::lo_f(bias[nb]),
                                              rnd<bf16>(h[4 * nb + 2 * i2 + 1]) + moeh::hi_f(bias[nb]));
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) bias[nb] = bias_next[nb];
      if (i + 1 < nloc) issue_h(i + 1);  // under this chunk's gelu
      // gelu in fp32, rounded once: the A fragments of the 16-deep steps
#pragma unroll
      for (int q = 0; q < 16; ++q)
        a[q] = pack_f32_to_bf16(gelu_tanh(moeh::lo_f(pre[q])), gelu_tanh(moeh::hi_f(pre[q])));
      // y += g . W2[e][chunk i, :], three 64-column products from registers
      const uint32_t w2s = ring + (i % S) * kFwdStage + kTile;
      fence_regs<16>(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pp = 0; pp < moeh::kD / 64; ++pp)
          bgemm::wgmma_rs<64, 1>(y + 32 * pp, a + 4 * kk, desc_mnmajor<64>(w2s + pp * kBox, kk), i > 0 || kk > 0);
      wgmma_commit();
      // the ring refilled: chunk i - 1 + S into chunk i - 1's stage once
      // every warpgroup with rows has released it
      if (tid == 0 && i >= 1 && i - 1 + S < nloc) {
        mbar_wait(empty + 8 * ((i - 1) % S), ((i - 1) / S) & 1);
        load_chunk(i - 1 + S);
      }
    }
    wgmma_wait<0>();
    fence_regs<moeh::kAcc>(y);
    fence_regs<16>(a);
  }

  // y rounded, b2 added and rounded, stored to the tile's rows
  if (w < active) {
    const int r0 = lo + moeh::kRows * w, rows = min(hi - r0, moeh::kRows);
    const bf16* b2 = p.b2 + static_cast<long long>(e) * moeh::kD;
    bf16* out = p.y + static_cast<long long>(r0) * moeh::kD;
    moeh::each_output(y, [&](int row, int col, float v0, float v1) {
      if (row >= rows) return;
      const uint32_t bb = __ldg(reinterpret_cast<const unsigned int*>(b2 + col));
      *reinterpret_cast<uint32_t*>(out + row * moeh::kD + col) =
          pack_f32_to_bf16(rnd<bf16>(v0) + moeh::lo_f(bb), rnd<bf16>(v1) + moeh::hi_f(bb));
    });
  }
}

// 0 on success, a cudaError_t, or minus the CUresult of a map that failed to encode
int launch_ffn_bf16(const void* x, const void* w1, const void* w2, const FfnArgs& p, cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tw1, tw2;
  CUresult r = bgemm::encode_rows(&tx, x, p.n, moeh::kD);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&tw1, w1, p.e * moeh::kD, p.h);
  if (r == CUDA_SUCCESS) r = bgemm::encode_rows(&tw2, w2, p.e * p.h, moeh::kD);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_fwd_wgmma>(ffn_fwd_smem(), &sms);
  if (err != cudaSuccess) return err;
  const int units = (p.n + moeh::kUnitRows - 1) / moeh::kUnitRows + p.e;
  moe_ffn_fwd_wgmma<<<units, moeh::kThreads, ffn_fwd_smem(), s>>>(p, tx, tw1, tw2);
  return cudaGetLastError();
}

}  // namespace

// y = the grouped FFN of the expert-sorted tokens x (n, d) over the experts'
// W1 (E, d, h), b1 (E, h), W2 (E, h, d), b2 (E, d), all contiguous in the
// compute dtype (bf16 when is_bf16, else fp32), starts (E + 1,) int32 on
// the device, capacity cap.  d is 192, h a multiple of 64 in bf16 (32 in
// fp32), E at most 64, n at least 1, every pointer 16-byte aligned (checked
// by the caller).  Returns 0 on success, a cudaError_t, or minus the
// CUresult of a tensor map that failed to encode.
extern "C" int moe_gmm_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* starts, void* y, int n, int d, int h,
                           int e, int cap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d != moeh::kD) return cudaErrorInvalidValue;
    const FfnArgs p{static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<const int*>(starts),
                    static_cast<bf16*>(y), n, h, e, cap};
    return launch_ffn_bf16(x, w1, w2, p, s);
  }
  const FwdParams p{x, w1, b1, w2, b2, static_cast<const int*>(starts), y, n, h, e, cap};
  MOE_DISPATCH_D(d, return launch_fwd<float, D>(p, s);)
}

// the dynamic shared memory of a moe_ffn_fwd_wgmma launch (any shape)
extern "C" int moe_ffn_fwd_wgmma_smem() { return ffn_fwd_smem(); }
