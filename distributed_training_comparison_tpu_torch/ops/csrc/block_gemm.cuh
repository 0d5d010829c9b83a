// The GEMM core of the fused ViT block chains for Hopper (sm_90a), shared by
// vit_block_fwd.cu (block_gemm: K5's four products, K6's three recompute
// products) and vit_block_bwd.cu (block_gemm_dgrad, block_gemm_wgrad): the
// generic wgmma, the weight-stationary walk (a bf16 weight slab converted
// once per block, the activation streamed through a TMA ring) and its slab.
//
// At the fused block's shapes every product is skinny (M 8192-32768 rows,
// N and K 192-768), so each is bound by bytes: what matters is that A is
// read from device memory once, that loads run ahead of the products, and
// that no weight is converted from fp32 more than once per block.
//
// Weight-stationary layout (block_gemm, block_gemm_dgrad).  A block owns one
// slab of BN output columns for the whole call and holds B for those
// columns, all of K, in shared memory as bf16: kpad / 64 boxes of BN rows by
// 128 bytes under the 128-byte swizzle (16-byte chunk c of row j at box
// c / 8, j * 128 + ((c % 8) ^ (j % 8)) * 16), which wgmma reads K-major.
// Its four consumer warpgroups each walk their own 64-row tiles of A
// (t = unit, unit + units, ...: fixed by the block's index, never by a
// counter), and each has a ring of kStages stages of one 64 x 64 bf16 box,
// fed by TMA from the warpgroup's first thread, kStages chunks ahead; rows
// past M and columns past K land as zeros.

#pragma once

#include "hopper_common.cuh"

namespace {
namespace bgemm {

constexpr int kRows = 64;                        // rows of an A tile: one warpgroup's wgmma M
constexpr int kDepth = 64;                       // columns of a ring stage: one 128-byte box
constexpr int kStageBytes = box_bytes<kRows>();  // 8 KB
constexpr int kStages = 4;                       // ring stages a consumer warpgroup
constexpr int kConsumers = 4;                    // consumer warpgroups a block, one block an SM
// no producer warps: each warpgroup's first thread feeds its ring, so a
// block is 512 threads, 16 warps to hide the epilogue's latencies, at up to
// 128 registers a thread: slabs are at most 64 columns (a 32-register
// accumulator), and a slab of 128 or 192 would spill
constexpr int kThreads = 128 * kConsumers;
// the largest bf16 weight slab a block holds beside its 128 KB of rings;
// ops/vit_block.py::SLAB_BYTES picks slab widths under it, and the launch
// refuses any above it
constexpr int kSlabBytes = 96 * 1024;

// D (fp32, 64 x N) += A (bf16, 64 x 16) · B (bf16, 16 x N), both from shared
// memory through descriptors; TA / TB set read A / B MN-major (transposed).
// `acc` = 0 overwrites D.  Per thread of the warpgroup, d[4n + 2i + e] is row
// 16·warp + g + 8i, column 8n + 2t + e (g = lane / 4, t = lane % 4).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int acc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 || N == 192, "wgmma_ss takes N 8-192");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
}

// D (fp32, 64 x N) += A (bf16, 64 x 16, from registers: the accumulator's
// fragment layout, two adjacent 8-column blocks packed pairwise) · B (bf16,
// 16 x N, from shared memory; TB set reads it MN-major)
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int acc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma_rs takes N 8-64");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// k rounded up to whole boxes
__host__ __device__ constexpr int padded_depth(int k) { return (k + kDepth - 1) / kDepth * kDepth; }

// byte offsets of a weight-stationary block's shared memory from its
// 1024-aligned base: the slab, the rings, the barriers, the slab's bn
// epilogue values (block_gemm's rounded bias); `bytes` with 1 KB of
// alignment slack
struct WsLayout {
  int ring, bars, bias, bytes;
  __host__ __device__ WsLayout(int kpad, int bn)
      : ring(kpad * bn * 2),
        bars(ring + kConsumers * kStages * kStageBytes),
        bias(bars + 2 * kConsumers * kStages * 8),
        bytes(bias + bn * 4 + 1024) {}
};

// row `row` of a matrix whose rows lie in up to three segments of `seg`
// rows each, `ld` elements a row (compares, not a division by seg)
__device__ __forceinline__ const float* weight_row(const float* const* w, int seg, int row, int ld) {
  if (row < seg) return w[0] + static_cast<long long>(row) * ld;
  if (row < 2 * seg) return w[1] + static_cast<long long>(row - seg) * ld;
  return w[2] + static_cast<long long>(row - 2 * seg) * ld;
}

// The bf16 slab of B for output columns [n0, n0 + BN), kpad deep, written by
// the block's threads (`ct` the thread's index), kBatch units' loads in
// flight together, in the
// swizzled K-major layout above, zero past n and k.  W is fp32 in up to three
// row segments: `w_rows_are_n` (block_gemm) reads W (n, k), a row per output
// column, 8 columns of k a 16-byte chunk; otherwise (block_gemm_dgrad) W is
// (k, n), and a chunk gathers 8 rows of k for one column, the loads
// coalesced along n across the threads.
template <int BN, bool W_ROWS_ARE_N>
__device__ __forceinline__ void load_slab(unsigned char* slab, const float* const* w, int seg, int n0,
                                          int n, int k, int kpad, int ct) {
  constexpr int kBatch = 4;  // units whose loads are in flight together
  const int chunks = kpad / 8;  // 16-byte chunks of a slab row
  for (int u0 = ct; u0 < BN * chunks; u0 += kBatch * kThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = u0 + q * kThreads;
      const int j = W_ROWS_ARE_N ? u / chunks : u % BN;
      const int c = W_ROWS_ARE_N ? u % chunks : u / BN;
      const int col = n0 + j, k0 = 8 * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[q][e] = 0.f;
      if (u >= BN * chunks || col >= n || k0 >= k) continue;
      if constexpr (W_ROWS_ARE_N) {
        const float* row = weight_row(w, seg, col, k) + k0;
        const float4 lo = __ldg(reinterpret_cast<const float4*>(row));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(row + 4));
        v[q][0] = lo.x; v[q][1] = lo.y; v[q][2] = lo.z; v[q][3] = lo.w;
        v[q][4] = hi.x; v[q][5] = hi.y; v[q][6] = hi.z; v[q][7] = hi.w;
      } else {  // k is a multiple of 16 and seg of 8: the 8 rows are in one segment
        const float* row = weight_row(w, seg, k0, n) + col;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[q][e] = __ldg(row + static_cast<long long>(e) * n);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = u0 + q * kThreads;
      if (u >= BN * chunks) break;
      const int j = W_ROWS_ARE_N ? u / chunks : u % BN;
      const int c = W_ROWS_ARE_N ? u % chunks : u / BN;
      *reinterpret_cast<uint4*>(slab + (c / 8) * BN * 128 + j * 128 + (((c % 8) ^ (j % 8)) << 4)) =
          make_uint4(pack_f32_to_bf16(v[q][0], v[q][1]), pack_f32_to_bf16(v[q][2], v[q][3]),
                     pack_f32_to_bf16(v[q][4], v[q][5]), pack_f32_to_bf16(v[q][6], v[q][7]));
    }
  }
}

// A weight-stationary block: its shared memory (from the 1024-aligned base),
// this thread's consumer warpgroup and its ring, and the walk's geometry.
// Item j of a warpgroup's walk is k-chunk j % nk of its tile
// unit + (j / nk) * units, in stage j % kStages.
struct WsBlock {
  unsigned char* smem;  // the aligned base, generic
  uint32_t base;        // the same, shared-window address
  WsLayout L;
  int w, n0, m_tiles, nk, unit, units;
  uint32_t ring, full, empty;
  __device__ WsBlock(unsigned char* raw, int m, int k, int bn)
      : smem(raw + (((smem_u32(raw) + 1023) & ~1023u) - smem_u32(raw))),
        base((smem_u32(raw) + 1023) & ~1023u),
        L(padded_depth(k), bn),
        w(threadIdx.x / 128),
        n0(blockIdx.x * bn),
        m_tiles((m + kRows - 1) / kRows),
        nk(padded_depth(k) / kDepth),
        unit(w * gridDim.y + blockIdx.y),
        units(kConsumers * gridDim.y),
        ring(base + L.ring + w * kStages * kStageBytes),
        full(base + L.bars + 8 * w * kStages),
        empty(full + 8 * kConsumers * kStages) {}

  // item j's 64 x 64 box of A into its stage (one thread), once the
  // warpgroup's four warps have released the stage's previous item
  __device__ __forceinline__ void load(const CUtensorMap* map, int j) const {
    const int t = unit + j / nk * units;
    if (t >= m_tiles) return;
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, kStageBytes);
    tma_load(ring + s * kStageBytes, map, j % nk * kDepth, t * kRows, 0, 0, full + 8 * s);
  }
};

// The block's start: thread 0 initialises the barriers, each warpgroup's
// first thread puts its first kStages items in flight, and all threads
// convert the slab (load_slab), fence it for the async proxy and sync.
template <int BN, bool W_ROWS_ARE_N>
__device__ __forceinline__ void ws_start(const WsBlock& B, const CUtensorMap* map, const float* const* w,
                                         int seg, int n, int k) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kStages; ++i) {
      mbar_init(B.base + B.L.bars + 8 * i, 1);
      mbar_init(B.base + B.L.bars + 8 * (kConsumers * kStages + i), 4);  // a warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x % 128 == 0)
    for (int j = 0; j < kStages; ++j) B.load(map, j);
  load_slab<BN, W_ROWS_ARE_N>(B.smem, w, seg, B.n0, n, k, B.nk * kDepth, threadIdx.x);
  fence_proxy_async();
  named_sync(1, kThreads);  // the slab is whole and visible to wgmma
}

// The consumer warpgroup's walk: per tile `begin(m0)`; per k-chunk the
// landed stage, `multiply(acc, stage, kc)` starting its four wgmma k-steps (the
// first of a tile overwrites acc), then the stage released and refilled
// kStages items on; after the tile's last chunk `epilogue(acc, m0)`.
template <int BN, typename Begin, typename Multiply, typename Epilogue>
__device__ __forceinline__ void ws_consume(const WsBlock& B, const CUtensorMap* map, Begin begin,
                                           Multiply multiply, Epilogue epilogue) {
  const int lane = threadIdx.x % 32;
  float acc[BN / 2];
  int it = 0;
  for (int t = B.unit; t < B.m_tiles; t += B.units) {
    begin(t * kRows);
    for (int kc = 0; kc < B.nk; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(B.full + 8 * s, (it / kStages) & 1);
      fence_regs<BN / 2>(acc);
      wgmma_fence();
      multiply(acc, B.ring + s * kStageBytes, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(B.empty + 8 * s);  // this warp is done with the stage
      if (threadIdx.x % 128 == 0) B.load(map, it + kStages);
    }
    epilogue(acc, t * kRows);
  }
}

// Within each quad of a warp (t = lane % 4): thread t's x[e] becomes thread
// e's x[t], a 4 x 4 transpose of 32-bit words (its own inverse).  The
// accumulator layout gives thread t the words 4j + t of a row's slab
// columns (columns 8j + 2t and + 1 packed to bf16); after the transpose of
// words 4u .. 4u + 3 thread t holds words 16u + 4t .. + 3: 16 contiguous
// bytes, a quad 64, so a warp's store covers whole 32-byte sectors.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4]) {
  const int t = threadIdx.x % 4;
  uint32_t y[4] = {x[0], x[1], x[2], x[3]};
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int k = t ^ r;  // the partner: send it our word k, take its word t into y[k]
    const uint32_t send = k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = e == k ? got : y[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = y[e];
}

// One row of a slab of BN bf16 columns between the accumulator layout,
// w[j] (j < BN / 8: columns 8j + 2t, + 1), and memory at `row` (the slab's
// first column): at BN a multiple of 32 through quad_transpose, 16 bytes a
// thread, else 4.  Columns at or past `cols` (from the slab's first, a
// multiple of 8) are neither read (0) nor written, nor is a row that is not
// `ok`; every thread of the quad takes part.
template <int BN>
__device__ __forceinline__ void store_row(const uint32_t (&w)[BN / 8], __nv_bfloat16* row, int cols, bool ok) {
  const int t = threadIdx.x % 4;
  if constexpr (BN % 32 == 0) {
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      uint32_t x[4] = {w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3]};
      quad_transpose(x);
      if (ok && 32 * u + 8 * t < cols)
        *reinterpret_cast<uint4*>(row + 32 * u + 8 * t) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (ok && 8 * j + 2 * t < cols) *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) = w[j];
  }
}

template <int BN>
__device__ __forceinline__ void load_row(uint32_t (&w)[BN / 8], const __nv_bfloat16* row, int cols, bool ok) {
  const int t = threadIdx.x % 4;
  if constexpr (BN % 32 == 0) {
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok && 32 * u + 8 * t < cols) v = __ldg(reinterpret_cast<const uint4*>(row + 32 * u + 8 * t));
      uint32_t x[4] = {v.x, v.y, v.z, v.w};
      quad_transpose(x);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[4 * u + e] = x[e];
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      w[j] = ok && 8 * j + 2 * t < cols ? __ldg(reinterpret_cast<const unsigned int*>(row + 8 * j + 2 * t)) : 0u;
  }
}

// the four k-steps of a landed chunk with A and B both K-major from shared
// memory: A the stage, B the slab's box kc
template <int BN>
__device__ __forceinline__ void mma_ss(float* acc, uint32_t slab, uint32_t stage, int kc) {
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    wgmma_ss<BN, 0, 0>(acc, smem_desc(stage + kk * 32, 16, 1024),
                       smem_desc(slab + kc * BN * 128 + kk * 32, 16, 1024), kc > 0 || kk > 0);
  }
}

// the weight-stationary grid: one slab of BN columns per blockIdx.x, and per
// slab a block for each 64-row tile up to the card's SMs between the slabs
// (one block an SM fits in shared memory); past that each block's
// warpgroups walk the tiles
inline dim3 ws_grid(int m, int n, int bn, int sms) {
  const int slabs = (n + bn - 1) / bn;
  const int tiles = (m + kRows - 1) / kRows;
  const int per_slab = tiles < sms / slabs ? tiles : sms / slabs;
  return dim3(slabs, per_slab > 0 ? per_slab : 1);
}

// Before a launch of KERNEL on the current device: its dynamic shared memory
// limit raised to `most` bytes (once per device), and the device's SM count
template <auto KERNEL>
cudaError_t prepare(int most, int* sms) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the largest weight-stationary layout at slab width bn
inline int ws_most_bytes(int bn) { return WsLayout(kSlabBytes / (2 * bn), bn).bytes; }

// a row-major bf16 (rows, cols) matrix as a 4-D map whose boxes are 64
// columns by 64 rows: rows past `rows` and columns past `cols` land as zeros
inline CUresult encode_rows(CUtensorMap* map, const void* x, int rows, int cols) {
  return encode(map, x, cols, rows, 1, 1, 0, 0, cols, kRows);
}

}  // namespace bgemm
}  // namespace
