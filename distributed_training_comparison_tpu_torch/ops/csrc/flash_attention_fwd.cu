// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// function and loaded with ctypes (ops/attention.py::flash_attention).
//
// Replaces the TPU kernels distributed_training_comparison_tpu/ops/attention.py
// ::_fwd_kernel (K1, all of K/V resident per (batch·head, query block)) and
// ::_fwd_kernel_tiled (K2, the same function on a (bh, nq, nk) grid with the
// softmax state in scratch).  One kernel covers both: a thread block owns one
// (batch, head, query tile) and loops over K/V tiles staged in shared memory,
// so K2's sequential grid dimension becomes that in-block loop and nothing is
// carried between blocks.
//
// Semantics (those of mha_reference): out = softmax(q·kᵀ·scale)·v and
// lse = logsumexp(q·kᵀ·scale); scores, the running max and sum and the output
// accumulator are fp32; P is rounded to the value dtype before P·V; masked
// scores take the finite -1e30 and the row sum is floored at 1e-30.  Causal is
// square (row >= col).  The true key length is masked in the tiles that reach
// past it, so no padding is ever read as data.
//
// What bounds it on this card: at the serving shape (bh = 32, S = 4096,
// D = 128, bf16) the work is 4·bh·S²·D = 2.75e11 FLOP against 134.7 MB of
// traffic, 2,040 FLOP per byte, far past the H100's ~295 FLOP/byte ridge: it
// is bound by tensor-core operations, not bytes, and only wgmma reaches the
// tensor cores' full rate.  The bf16 design:
// - A block owns 128 query rows: two consumer warpgroups of 64 rows each and
//   one producer warpgroup, 384 threads.  Every K/V byte staged in shared
//   memory serves 128 queries.
// - K/V tiles of 128 keys (D 64 and 128 alike: one m64n128 score product
//   of 64 accumulator registers, one box shape for Q, K and V) stream
//   through a 2-stage ring in shared memory.  One producer thread issues TMA
//   loads (cp.async.bulk.tensor, 4-D maps (D, S, H, B), boxes of 64 columns
//   by 128 rows under 128-byte swizzle; a D-128 tile is two boxes) that
//   complete on "full" mbarriers; each consumer warp releases a stage on an
//   "empty" mbarrier when its wgmma has read it.  Q is loaded once by TMA.
//   Rows past the tensor's true length are zero-filled by TMA, never read.
//   Shared memory at D 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB (plus
//   barriers and 1 KB of alignment slack) of the 227 KB a block may use; at
//   D 64 half that.  One block per SM either way: 384 threads at 168
//   registers fill the register file.
// - setmaxnreg moves registers from the producer warpgroup (24 a thread) to
//   the consumers (240): S and O are 64 fp32 registers each at D 128.
// - S = Q·Kᵀ by wgmma m64n128k16, both operands K-major in shared memory
//   under 128-byte swizzle; O += P·V by wgmma m64nDk16 with A = P from
//   registers (the fp32 accumulator of S packed pairwise to bf16 is exactly
//   the A fragment) and B = V, MN-major (D contiguous), read transposed.
// - The online softmax runs on the accumulator registers with exp2f and
//   scale·log2e folded into one multiply-add; masks only on the tiles that
//   reach past the key length or straddle the diagonal; tiles wholly above
//   the diagonal are never loaded; causal blocks start with the longest.
// - Each warpgroup issues Q·K_jᵀ and P_{j-1}·V_{j-1} together and computes
//   tile j's exponentials while the second runs, and the two warpgroups
//   take turns to issue (ping-pong on two named barriers), so one's softmax
//   overlaps the other's products.
// Persistent blocks are left for a later change.
//
// fp32 inputs run a separate SIMT kernel that computes in fp32 throughout
// (no TF32), for the non-AMP serving path and as an exact cross-check.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite "-inf": fully-masked rows stay NaN-free
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int sq, skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ bf16

constexpr int kBM = 128;            // query rows per block: 2 consumer warpgroups x 64
constexpr int kBN = 128;            // keys per tile
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kBoxCols = 64;        // bf16 columns of a TMA box: 128 bytes, the swizzle width
constexpr int kBoxBytes = kBoxCols * kBN * 2;  // a box of 128 rows
static_assert(kBM == kBN, "Q and K/V tiles share one box shape and one tile size");
constexpr int kConsumerWarps = 8;   // arrivals that release a ring stage
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536

template <int D>
struct Layout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int kTile = D / kBoxCols * kBoxBytes;  // 128 rows x D
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 128 + 1024;  // barriers, alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D map at (c0, c1, c2, c3), innermost first, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// rows [row0, row0 + 128) of one (batch, head) slice: D / 64 boxes side by side
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int row0, int h, int b,
                                          uint32_t bar) {
  mbar_expect_tx(bar, Layout<D>::kTile);
#pragma unroll
  for (int i = 0; i < D / kBoxCols; ++i) tma_load(dst + i * kBoxBytes, map, i * kBoxCols, row0, h, b, bar);
}

// wgmma shared-memory descriptor under 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still running (groups finish in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous window between issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f32_to_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Block: warpgroup 0 produces (one thread issues every TMA load), warpgroups 1
// and 2 consume, each owning 64 query rows.  Per thread of a consumer, the
// accumulators s (64 x 128 scores) and o (64 x D) hold, for each 8-column
// block n, rows g and g + 8 of the warp's 16 at columns 8n + 2t and + 1
// (g = lane / 4, t = lane % 4): s[4n + 2i + e] is row g + 8i, column 8n + 2t + e.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_bf16(const Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  // causal: the longest blocks (the last query tiles) go first
  const int mb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: keys past the tile's last row contribute nothing, and are never loaded
  const int kv_end = p.causal ? min(p.skv, m0 + kBM) : p.skv;
  const int nk = (kv_end + kBN - 1) / kBN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      load_tile<D>(base + L::kQ, &tq, m0, h, b, q_full);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        // a stage's previous use is released when all 8 consumer warps arrived
        if (j >= kStages) mbar_wait(k_empty(st), ph ^ 1);
        load_tile<D>(base + L::kK + st * L::kTile, &tk, j * kBN, h, b, k_full(st));
        if (j >= kStages) mbar_wait(v_empty(st), ph ^ 1);
        load_tile<D>(base + L::kV + st * L::kTile, &tv, j * kBN, h, b, v_full(st));
      }
    }
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_loc = 64 * c + 16 * warp + g;  // this thread's first row in the tile
  const int row[2] = {m0 + r_loc, m0 + r_loc + 8};
  const float sl2 = p.scale * kLog2e;
  const uint32_t q_wg = base + L::kQ + c * 64 * 128;  // the warpgroup's 64 rows of every box

  float s[kBN / 2];          // scores of the current key tile, then its P
  uint32_t pa[kBN / 16][4];  // P of the previous tile in bf16: the A fragments of P·V
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in units of scale·log2e
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum
  float alpha[2];                       // this tile's rescale of O and l

  // S = Q·K_jᵀ: k-steps of 16 columns (32 bytes) along the swizzled 128-byte rows
  auto issue_qk = [&](int st) {
    const uint32_t ks = base + L::kK + st * L::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_m64n128k16_ss(s, smem_desc(q_wg + off, 16, 1024), smem_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P·V: V is MN-major (D contiguous); 16 keys (2 KB of rows) a step,
  // the next 64 columns of D one box (LBO) on, 8-key groups 1 KB apart (SBO)
  auto issue_pv = [&](int st) {
    const uint32_t vs = base + L::kV + st * L::kTile;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = smem_desc(vs + kk * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs(o, pa[kk], dv);
      } else {
        wgmma_m64n64k16_rs(o, pa[kk], dv);
      }
    }
    wgmma_commit();
  };
  // the online softmax of key tile j on s: masks, the running max and sum,
  // s turned into the unnormalized P, alpha to rescale O
  auto softmax = [&](int j) {
    const int n0 = j * kBN;
    // mask only the tiles that reach past the key length or straddle the diagonal
    if (n0 + kBN > p.skv || (p.causal && n0 + kBN - 1 > m0 + 64 * c)) {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * n + 2 * t + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[e >> 1]);
          if (!ok) s[4 * n + e] = kNegInf;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      // the max of the raw scores, scaled (scale > 0): p = 2^(s·scale·log2e - m)
      const float m_new = fmaxf(m_run[i], quad_max(mx) * sl2);
      alpha[i] = exp2f(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        s[4 * n + 2 * i] = exp2f(fmaf(s[4 * n + 2 * i], sl2, -m_new));
        s[4 * n + 2 * i + 1] = exp2f(fmaf(s[4 * n + 2 * i + 1], sl2, -m_new));
        sum += s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
      }
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
    }
  };
  // P rounded to bf16: the score accumulators of two adjacent 8-key blocks
  // are exactly the A fragment of a 16-key step
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_f32_to_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_f32_to_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_f32_to_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_f32_to_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto fence_all = [&]() {
    fence_regs<kBN / 2>(s);
    fence_regs<D / 2>(o);
    fence_regs<kBN / 4>(&pa[0][0]);
  };
  // ping-pong: the two consumer warpgroups take turns to issue their
  // products (named barriers 1 and 2), so one's softmax runs while the
  // other's products hold the tensor cores; warpgroup 0 goes first
  auto turn_begin = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory"); };
  auto turn_end = [&](bool last) {  // the last turn of warpgroup 1 hands over to no one
    if (c == 0 || !last) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
  };
  if (c == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  // tile 0: scores, softmax, P (O is still zero)
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  turn_begin();
  fence_all();
  wgmma_fence();
  issue_qk(0);
  turn_end(nk == 1);
  wgmma_wait<0>();
  fence_regs<kBN / 2>(s);
  if (lane == 0) mbar_arrive(k_empty(0));  // this warp is done with K_0
  softmax(0);
  pack_p();
  // tile j: Q·K_jᵀ and P_{j-1}·V_{j-1} issued together; tile j's
  // exponentials overlap the second
  for (int j = 1; j < nk; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(k_full(st), (j / kStages) & 1);
    mbar_wait(v_full(prev), ((j - 1) / kStages) & 1);
    turn_begin();
    fence_all();
    wgmma_fence();
    issue_qk(st);
    issue_pv(prev);
    turn_end(j == nk - 1);
    wgmma_wait<1>();  // S_j has landed; P_{j-1}·V_{j-1} may still run
    fence_regs<kBN / 2>(s);
    if (lane == 0) mbar_arrive(k_empty(st));  // this warp is done with K_j
    softmax(j);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<kBN / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(v_empty(prev));  // this warp is done with V_{j-1}
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    pack_p();
  }
  const int last = (nk - 1) % kStages;
  mbar_wait(v_full(last), ((nk - 1) / kStages) & 1);
  fence_all();
  wgmma_fence();
  issue_pv(last);
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  fence_regs<kBN / 4>(&pa[0][0]);

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + (static_cast<long long>(b) * gridDim.y + h) * p.sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = fmaxf(quad_sum(l_run[i]), 1e-30f);
    if (row[i] >= p.sq) continue;
    const float inv = 1.f / l;
    __nv_bfloat16* orow = og + row[i] * p.o_ss + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_f32_to_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
    if (t == 0) lg[row[i]] = (m_run[i] + log2f(l)) * kLn2;
  }
}

constexpr int kThreads = 128;  // fp32 kernel: threads per block

// ------------------------------------------------------------------ fp32

constexpr int kFM = 32;  // query rows per block: 4 threads per row
constexpr int kFN = 32;  // keys per tile

template <int D>
constexpr int f32_smem_bytes() {
  return (kFM * (D + 1) + 2 * kFN * (D + 1) + kFM * (kFN + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int LD = D + 1;  // odd stride: a warp's 8 rows fall on distinct banks
  constexpr int PER = kFN / 4;
  constexpr int OUT = D / 4;
  extern __shared__ float fsmem[];
  float* qs = fsmem;
  float* ks = qs + kFM * LD;
  float* vs = ks + kFN * LD;
  float* ps = vs + kFN * LD;

  const int m0 = blockIdx.x * kFM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 4, t = tid % 4;  // row of the tile, lane of the row's quad
  const int row = m0 + r;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int c = tid; c < kFM * D; c += kThreads) {
    const int rr = c / D, d = c % D;
    qs[rr * LD + d] = m0 + rr < p.sq ? qg[(m0 + rr) * p.q_ss + d] : 0.f;
  }
  const int kv_end = p.causal ? min(p.skv, m0 + kFM) : p.skv;
  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kFN) {
    __syncthreads();
    for (int c = tid; c < kFN * D; c += kThreads) {
      const int rr = c / D, d = c % D;
      const bool ok = n0 + rr < p.skv;
      ks[rr * LD + d] = ok ? kg[(n0 + rr) * p.k_ss + d] : 0.f;
      vs[rr * LD + d] = ok ? vg[(n0 + rr) * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    float s[PER];
    float mx = m_run;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + 4 * i;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(qs[r * LD + d], ks[c * LD + d], x);
      x *= p.scale;
      const int col = n0 + c;
      if (col >= p.skv || (p.causal && col > row)) x = kNegInf;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = quad_max(mx);
    const float alpha = exp2f((m_run - mx) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float e = exp2f((s[i] - mx) * kLog2e);
      sum += e;
      ps[r * (kFN + 1) + t + 4 * i] = e;
    }
    l_run = l_run * alpha + sum;
    m_run = mx;
    __syncwarp();  // a row's quad lives in one warp: its P row is visible now
#pragma unroll
    for (int i = 0; i < OUT; ++i) acc[i] *= alpha;
    for (int c = 0; c < kFN; ++c) {
      const float pc = ps[r * (kFN + 1) + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) acc[i] = fmaf(pc, vs[c * LD + t + 4 * i], acc[i]);
    }
  }
  const float l = fmaxf(quad_sum(l_run), 1e-30f);
  if (row < p.sq) {
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int i = 0; i < OUT; ++i) og[t + 4 * i] = acc[i] / l;
    if (t == 0) p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.sq + row] = m_run + logf(l);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled lives in libcuda, not the runtime; the runtime hands
// out its entry point, so the library links only the runtime, as every other
// one does
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                       : nullptr;
  }();
  return fn;
}

// a bf16 (B, H, S, D) view as the 4-D map (D, S, H, B): element strides
// (sb, sh, ss, 1), boxes of 64 columns by 128 rows under 128-byte swizzle;
// rows past s are out of bounds and land as zeros.  A dimension of size 1 is
// never stepped, so it takes the stride of one row, D elements, whatever the
// view says; the others must be whole 16-byte rows (ops/attention.py::_kernel_operand).
CUresult encode(CUtensorMap* map, const void* x, int d, int s, int h, int b, long long sb, long long sh,
                long long ss) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const auto bytes = [d](int n, long long stride) { return static_cast<cuuint64_t>(n > 1 ? stride : d) * 2; };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {bytes(s, ss), bytes(h, sh), bytes(b, sb)};
  const cuuint32_t box[4] = {kBoxCols, kBN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 0 on success, a cudaError_t if the launch failed, -CUresult if a map did not encode
template <int D>
int launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, p.q, D, p.sq, heads, batch, p.q_sb, p.q_sh, p.q_ss);
  if (r == CUDA_SUCCESS) r = encode(&tk, p.k, D, p.skv, heads, batch, p.k_sb, p.k_sh, p.k_ss);
  if (r == CUDA_SUCCESS) r = encode(&tv, p.v, D, p.skv, heads, batch, p.v_sb, p.v_sh, p.v_ss);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const auto kernel = flash_fwd_bf16<D>;
  const int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, 384, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/out are (B, H, S, D) with unit stride over D and the given element
// strides for batch, head and sequence (bf16: multiples of 8 and 16-byte
// aligned, checked by the caller); lse is contiguous fp32 (B, H, Sq).
// Returns 0 on success, the launch's cudaError_t, or minus the CUresult of a
// tensor map that failed to encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int heads, int sq, int skv, int head_dim,
                                   long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                   long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                                   float scale, int causal, int is_bf16, void* stream) {
  const Params p{q,    k,    v,    out,  static_cast<float*>(lse),
                 sq,   skv,  q_sb, q_sh, q_ss,
                 k_sb, k_sh, k_ss, v_sb, v_sh,
                 v_ss, o_sb, o_sh, o_ss, scale,
                 causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (head_dim == 64) return launch_bf16<64>(p, batch, heads, s);
    if (head_dim == 128) return launch_bf16<128>(p, batch, heads, s);
  } else {
    const dim3 grid((sq + kFM - 1) / kFM, heads, batch);
    if (head_dim == 64) return launch(flash_fwd_f32<64>, grid, f32_smem_bytes<64>(), s, p);
    if (head_dim == 128) return launch(flash_fwd_f32<128>, grid, f32_smem_bytes<128>(), s, p);
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the bf16 kernel at head dim `head_dim` (0 if it is not taken)
extern "C" int flash_attention_fwd_smem(int head_dim) {
  return head_dim == 64 ? Layout<64>::kBytes : head_dim == 128 ? Layout<128>::kBytes : 0;
}
