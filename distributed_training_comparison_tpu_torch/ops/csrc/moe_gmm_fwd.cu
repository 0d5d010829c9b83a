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
// fp32: moe_ffn_fwd_tf32x3, 3xTF32 on wgmma (tf32x3.cuh: each fp32
// operand split into big and small tf32 halves, each product three tf32
// products; 165 TFLOP/s of fp32 work at most, so at the train shape's ~9.2
// GFLOP a bound of 0.056 ms).  The bf16 kernel's units and grid; a producer
// warpgroup and two consumer warpgroups of 64 rows (setmaxnreg 56 / 224).
// tf32 wgmma reads shared memory K-major only, and both weight slices lie
// MN-major, so the producer streams them through tf32x3.cuh's ring of 16 KB
// split slots transposed as they land (SlotSrc::trans), twelve a 64-column
// hidden chunk: W1[e][:, chunk]ᵀ (64 hidden columns x 32 of d, six), then
// W2[e][chunk, :]ᵀ (64 of d x 32 hidden rows, two for each 64-column block
// of y).  A transposed slot stores its contraction axis in the order the
// accumulator's fragments read it (0, 2, 4, 6, 1, 3, 5, 7), so the x tile,
// each warpgroup's own 64 rows read once into shared memory (48 KB) as raw
// A fragments, is laid out in that order too (a pair of adjacent columns
// one 8-byte load) and split a k-step at a time.  Per chunk a warpgroup
// runs h = x . W1 chunk (m64n64k8, one accumulator over d's 192), g =
// gelu(h + b1) on the accumulator, then y += g . W2 chunk with g's big and
// small fragments taken from the accumulator (acc_frags) and each 64-column
// block's chunk summed in a fresh accumulator added to y in fp32 (the
// tensor cores round each accumulation toward zero; PERF.md has the
// drift): y, 64 x 192 fp32, is 96 registers.  Each output sums its hidden
// chunks in order and is written once: two calls are bit-identical.  A
// NaN in x reaches its row (the split keeps it).  Shared memory: x 96 KB +
// 6 slots 96 KB.

#include "moe_gmm_common.cuh"
#include "moe_gmm_hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace moe;

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

// ------------------------------------------------------------------ fp32

// a hidden chunk's slots: W1[e][:, chunk]ᵀ (six: 32 of d each), then
// W2[e][chunk, :]ᵀ (six: column block major, two 32-row halves each)
constexpr int kFwdF32Slots = 2 * moeh::kD / 32;
using FwdF32 = Tf32Layout<moeh::kD, moeh::kConsumers>;  // x: 64 rows a consumer warpgroup, raw fragments

struct FfnF32Args {
  const float* x;     // (n, d) expert-sorted tokens
  const float* w1;    // (E, d, h)
  const float* b1;    // (E, h)
  const float* w2;    // (E, h, d)
  const float* b2;    // (E, d)
  const int* starts;  // (E + 1,)
  float* y;           // (n, d)
  int n, h, e, cap;
};

// a consumer thread's A fragments of x rows `row` and `row + 8` (zeros at or
// past `end`), raw fp32, in the transposed slots' contraction order: element
// e of k-step kk is column 8 kk + 2t + frag_col(e) of row row + 8 frag_row(e)
__device__ __forceinline__ void load_x_frags(unsigned char* own, const float* x, int row, int end, int t) {
  const float* r0 = x + static_cast<long long>(row) * moeh::kD + 2 * t;
  const float* r8 = r0 + 8 * moeh::kD;
#pragma unroll 4
  for (int kk = 0; kk < moeh::kD / 8; ++kk) {
    float2 a = make_float2(0.f, 0.f), b = a;
    if (row < end) a = __ldg(reinterpret_cast<const float2*>(r0 + 8 * kk));
    if (row + 8 < end) b = __ldg(reinterpret_cast<const float2*>(r8 + 8 * kk));
    *reinterpret_cast<float4*>(own + kk * kFrag) = make_float4(a.x, b.x, a.y, b.y);
  }
}

__global__ void __launch_bounds__(384, 1) moe_ffn_fwd_tf32x3(const FfnF32Args p) {
  constexpr int kD = moeh::kD;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  __shared__ int st[kMaxExperts + 1];
  __shared__ unsigned char dropped[moeh::kRows];
  const uint32_t raw = smem_u32(f32_smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = f32_smem + (base - raw);
  const uint32_t ring = base + FwdF32::kRingAt, bars = base + FwdF32::kBars;
  const int tid = threadIdx.x;

  for (int i = tid; i <= p.e; i += blockDim.x) st[i] = p.starts[i];
  __syncthreads();
  moeh::zero_unkept(p.y, st, p.e, p.cap, p.n, dropped);
  int e = 0, lo = 0, hi = 0;
  if (!moeh::expert_unit(st, p.e, p.cap, p.n, blockIdx.x, e, lo, hi)) return;  // past the last unit
  const int total = p.h / moeh::kChunk * kFwdF32Slots;
  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    const float* w1 = p.w1 + static_cast<long long>(e) * kD * p.h;
    const float* w2 = p.w2 + static_cast<long long>(e) * p.h * kD;
    auto slot_of = [&](int u) {
      const int r = u % kFwdF32Slots, c0 = u / kFwdF32Slots * moeh::kChunk;
      if (r < kD / 32)  // slot row n: W1[e] column c0 + n over rows (d) 32 r ..
        return SlotSrc{w1, w1, p.h, p.h, 32 * r, kD, c0, true};
      // slot row n: W2[e] column 64 (q / 2) + n over rows (hidden) c0 + 32 (q % 2) ..
      const int q = r - kD / 32;
      return SlotSrc{w2, w2, kD, kD, c0 + 32 * (q % 2), p.h, 64 * (q / 2), true};
    };
    produce<kSlotRows>(slot_of, total, sbase + FwdF32::kRingAt, bars, tid);
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
  unsigned char* const own = sbase + c * FwdF32::kOwnTensor + wt * 16;
  load_x_frags(own, p.x, row, hi, t);  // read back by this thread alone
  const float* b1 = p.b1 + static_cast<long long>(e) * p.h + 2 * t;

  float y[kD / 64][32];
#pragma unroll
  for (int hh = 0; hh < kD / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[hh][i] = 0.f;
  for (int c0 = 0; c0 < p.h; c0 += moeh::kChunk) {
    // h = x . W1[e][:, chunk] over d, one accumulator; then g = gelu(h + b1)
    // in fp32 in its registers (element 4n + 2i + j: hidden column c0 + 8n +
    // 2t + j of row + 8i)
    float hacc[32];
    scores<kD>(hacc, own, ring, bars, u, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * n));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        hacc[4 * n + 2 * i] = gelu_tanh(hacc[4 * n + 2 * i] + bb.x);
        hacc[4 * n + 2 * i + 1] = gelu_tanh(hacc[4 * n + 2 * i + 1] + bb.y);
      }
    }
    // y += g . W2[e][chunk, :], g's fragments from the accumulator
    uint32_t big[8][4], small[8][4];
    acc_frags<8>(big, small, hacc);
    sums<kD, 8>(y, big, small, ring, bars, u, lane);
  }

  // y + b2, stored to the tile's rows
  const float* b2 = p.b2 + static_cast<long long>(e) * kD + 2 * t;
#pragma unroll
  for (int hh = 0; hh < kD / 64; ++hh) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 64 * hh + 8 * n));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        y[hh][4 * n + 2 * i] += bb.x;
        y[hh][4 * n + 2 * i + 1] += bb.y;
      }
    }
    store_f32(p.y, kD, row, hi, 64 * hh, y[hh], t);
  }
}

// 0 on success, else a cudaError_t
int launch_ffn_f32(const FfnF32Args& p, cudaStream_t s) {
  if (p.h % moeh::kChunk) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&moe_ffn_fwd_tf32x3>(FwdF32::kBytes, &sms);
  if (err != cudaSuccess) return err;
  const int blocks = (p.n + moeh::kUnitRows - 1) / moeh::kUnitRows + p.e;
  moe_ffn_fwd_tf32x3<<<blocks, 384, FwdF32::kBytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// y = the grouped FFN of the expert-sorted tokens x (n, d) over the experts'
// W1 (E, d, h), b1 (E, h), W2 (E, h, d), b2 (E, d), all contiguous in the
// compute dtype (bf16 when is_bf16, else fp32), starts (E + 1,) int32 on
// the device, capacity cap.  d is 192, h a multiple of 64, E at most 64, n
// at least 1, every pointer 16-byte aligned (checked by the caller).  Returns 0 on success, a cudaError_t, or minus the
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
  if (d != moeh::kD) return cudaErrorInvalidValue;
  const FfnF32Args p{static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
                     static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const int*>(starts),
                     static_cast<float*>(y), n, h, e, cap};
  return launch_ffn_f32(p, s);
}

// the dynamic shared memory of a moe_ffn_fwd_wgmma launch (any shape)
extern "C" int moe_ffn_fwd_wgmma_smem() { return ffn_fwd_smem(); }
