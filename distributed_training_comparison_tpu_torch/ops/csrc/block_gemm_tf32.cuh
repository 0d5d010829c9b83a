// The fused ViT block chains' fp32 GEMMs for Hopper (sm_90a) in 3xTF32 on
// wgmma, shared by vit_block_fwd.cu (block_gemm_tf32x3: K5's four products,
// K6's three recompute products) and vit_block_bwd.cu (dgrad_tf32x3,
// wgrad_tf32x3).  One core computes
//
//     C[i, j] = epilogue( sum over k of pro(A')[i, k] · B'[j, k] )
//
// with B' K-major in shared memory, where tf32 wgmma reads it (the
// transpose bits exist for 16-bit types alone), and A' from registers.  The
// three launches differ only in where each operand's tiles come from,
// natural or transposed, and in their epilogues:
//
//   launch        A' (kBM rows)              B' (kBN rows)               depth
//   block_gemm    LN(A), A (M, K) as stored  W (N, K) as stored          K
//   dgrad         G (M, K) as stored         W (K, N), transposed        K
//   wgrad         G (rows, out), transposed  A (rows, in), transposed    a chunk's rows
//
// The arithmetic is tf32x3.cuh's, the flash kernels': each fp32 operand
// x splits into big = tf32(x) + x·0 and small = tf32(x - big), and each
// product is small·big + big·small + big·big in fp32 (fp32 accuracy at
// three times the tf32 operations, 165 TFLOP/s of fp32 work at most).
//
// What bounds it: at vit_tiny --patch-size 2's shapes (M 8192-32768 rows, N
// and K 192-768, dim 192) a product does 2MNK fp32 operations, 6MNK tf32
// ones, on 4M(K + N) bytes: 144-231 tf32 FLOP a byte, above the card's
// 148 (495 TFLOP/s over 3.35 TB/s), so operations bound it.  Shared memory
// is the next limit: an m64n64k8 tf32 wgmma with both operands in shared
// memory reads 4 KB in its 32 cycles, the SM's whole 128 bytes a cycle.
// The design:
// - A block owns a 192 x 64 output tile (all of 192, 576 and 768 are whole
//   tiles both ways): three consumer warpgroups of 64 rows and one producer
//   warpgroup.  Each output element is written once: no atomics, and two
//   calls give the same bits.
// - The depth streams through a ring of kStages stages of 32 (one 128-byte
//   swizzle row of tf32).  The producer copies each stage's fp32 tiles with
//   cp.async (16-byte copies, kAhead stages in flight) and splits B' in
//   place: a natural tile lands where its big chunks go (chunk j of row r
//   at chunk j ^ (r % 8) of the row's 128 bytes); a transposed one as 4 x 4
//   blocks, each thread's four 16-byte source rows landing in the small
//   half where its four output chunks go, then transposed in registers, so
//   no thread reads another's copies and no barrier is needed.
// - A' is split by the consumers, in registers: each k-step's fragment (4
//   words a thread) is read from the landed fp32 tile, normalised where the
//   LayerNorm is given, split, and fed to three m64n64k8 wgmma (small·big,
//   big·small, big·big) with B' from shared memory; the next k-step's
//   fragment is formed under them, and a stage's twelve products are one
//   commit group.  So each A' element is read from shared
//   memory once, not three times, the producer splits a quarter of the
//   stage, and the LayerNorm's row statistics (E[x^2] - mu^2, fp32) are
//   taken by each quad for its two rows while the first copies land.
// - The tensor cores round each accumulation toward zero, so a sum over
//   depth drifts with its length (1.7e-4 of a row's rms over 4096 in one
//   accumulator, PERF.md): each kSumStages stages (64 depths: a weight
//   gradient's 1024-row chunk is 16 of them) go to a fresh accumulator,
//   added to the total in fp32.
// - Weight-stationary slabs (the bf16 design) do not carry over: a split
//   element takes 8 bytes, so a 96 KB slab would hold 16 columns at depth
//   768 and the activations would be re-read 12 times.  Here both operands
//   stream, and A' is read once per 64 output columns (from L2 after the
//   first): at mlp_down's shape, batch 128 (M 32768, K 768, N 192), 3 x
//   100.7 MB of A plus 0.6 MB of W a block row, 0.30 GB in all.

#pragma once

#include "block_gemm.cuh"
#include "tf32x3.cuh"

namespace {
namespace tgemm {

constexpr int kConsumers = 3;                  // consumer warpgroups of 64 output rows
constexpr int kBM = 64 * kConsumers;           // output rows (A' rows) of a block
constexpr int kBN = 64;                        // output columns (B' rows) of a block
constexpr int kBK = 32;                        // depth of a stage: 128 bytes of tf32 a row
constexpr int kStages = 4;                     // stages of the ring
constexpr int kAhead = 3;                      // stages whose copies are in flight while one is split
constexpr int kSumStages = 2;                  // stages a fresh accumulator takes: 64 depths
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kLdT = kBM + 8;                  // floats a depth row of a transposed A' tile
// A' as it landed (fp32): natural, kBM rows of 128 bytes in the swizzled
// chunk order; transposed, kBK depth rows of kLdT floats
constexpr int kARawBytes = (kBK * kLdT * 4 + 1023) / 1024 * 1024;
constexpr int kBBytes = kBN * 128;             // B' big (then B' small): kBN rows of kBK tf32
constexpr int kStageBytes = kARawBytes + 2 * kBBytes;

// dynamic shared memory, byte offsets from the 1024-aligned base: the ring;
// the bias sums' row phases (wgrad); the barriers: "full" of stage s at
// 8·s (the 128 producer threads arrive), "empty" at 8·(kStages + s) (the
// consumer warps arrive)
constexpr int kRedAt = kStages * kStageBytes;
constexpr int kBarsAt = kRedAt + 8 * kBM * 4;
constexpr int kSmemBytes = kBarsAt + 2 * kStages * 8 + 1024;  // with alignment slack

// One operand, as element (row i, depth k) of A' or B'.  Natural: row i of
// the source, depth k along it, a source row being weight_row(base, seg, i,
// ld).  Transposed: source row k (weight_row(base, seg, k, ld)), column i.
// Rows at or past `rows` and depths at or past the tile's end are zeros;
// `rows`, `ld` and a natural operand's depth are multiples of 4.
struct Operand {
  const float* base[3];
  int seg, ld, rows;
};

// One output tile: A' rows m0 .., B' rows n0 .., depths [k0, k1), and its
// depth chunk z (the weight gradient's row chunk; 0 elsewhere)
struct Tile {
  int m0, n0, k0, k1, z;
};

// The tiles of one launch, one a block: kBM x kBN output tiles over
// `rows_a` x `rows_b`, each depth chunk of `chunk` (the whole depth, but for
// the weight gradient's row chunks) a tile of its own; B' tiles fastest, so
// that the blocks running together share their A' rows in L2.
struct Tiles {
  int m_tiles, n_tiles, depth, chunk, count;
  __host__ __device__ Tiles(int rows_a, int rows_b, int depth_, int chunk_)
      : m_tiles((rows_a + kBM - 1) / kBM),
        n_tiles((rows_b + kBN - 1) / kBN),
        depth(depth_),
        chunk(chunk_),
        count(m_tiles * n_tiles * ((depth_ + chunk_ - 1) / chunk_)) {}
  __device__ Tile at(int ti) const {
    const int rest = ti / n_tiles, z = rest / m_tiles, k0 = z * chunk;
    return Tile{rest % m_tiles * kBM, ti % n_tiles * kBN, k0, min(k0 + chunk, depth), z};
  }
};

__device__ __forceinline__ int stages_of(const Tile& t) { return (t.k1 - t.k0 + kBK - 1) / kBK; }

__device__ __forceinline__ void copy16(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float lds(uint32_t at) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(at));
  return x;
}

// big over `off` of a tile, small at the same place of the small half
__device__ __forceinline__ void store_split(unsigned char* tile, int off, float4 x) {
  uint32_t big[4], small[4];
  split4(x, big, small);
  *reinterpret_cast<uint4*>(tile + off) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(tile + kBBytes + off) = make_uint4(small[0], small[1], small[2], small[3]);
}

// where chunk j (depths 4j .. 4j + 3) of tile row r lives: 128-byte
// swizzle, K-major, as wgmma reads it
__device__ __forceinline__ int chunk_at(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// The producer thread's copies of A''s stage tile (kBM rows from i0,
// depths k0 .. k0 + 31), fp32 as it is: natural, 16-byte chunk (r, j) a
// copy, r = f / 8, j = f % 8, at chunk_at(r, j); transposed, depth row kr
// and 4 rows 4c .. 4c + 3 a copy, kr = f / 48, c = f % 48, at kr·kLdT + 4c.
template <bool TRANS>
__device__ __forceinline__ void copy_a(uint32_t tile, const Operand& o, int i0, int k0, int k1, int tid) {
#pragma unroll
  for (int q = 0; q < kBM / 16; ++q) {
    const int f = tid + 128 * q;
    if constexpr (!TRANS) {
      const int r = f >> 3, j = f & 7, i = i0 + r, k = k0 + 4 * j;
      const bool in = i < o.rows && k < k1;
      copy16(tile + chunk_at(r, j), in ? bgemm::weight_row(o.base, o.seg, i, o.ld) + k : o.base[0], in);
    } else {
      const int kr = f / (kBM / 4), c = f % (kBM / 4), i = i0 + 4 * c, k = k0 + kr;
      const bool in = i < o.rows && k < k1;
      copy16(tile + (kr * kLdT + 4 * c) * 4, in ? bgemm::weight_row(o.base, o.seg, k, o.ld) + i : o.base[0], in);
    }
  }
}

// The producer thread's copies of B''s stage tile (kBN rows from i0):
// natural, chunk (r, j) into its big chunk's place; transposed, 4 x 4 blocks
// (rows 4b .. 4b + 3, depth chunk j), b = f / 8, j = f % 8, the four source
// rows k0 + 4j + e landing at the small-half places of rows 4b + e.
template <bool TRANS>
__device__ __forceinline__ void copy_b(uint32_t tile, const Operand& o, int i0, int k0, int k1, int tid) {
  if constexpr (!TRANS) {
#pragma unroll
    for (int q = 0; q < kBN / 16; ++q) {
      const int f = tid + 128 * q, r = f >> 3, j = f & 7, i = i0 + r, k = k0 + 4 * j;
      const bool in = i < o.rows && k < k1;
      copy16(tile + chunk_at(r, j), in ? bgemm::weight_row(o.base, o.seg, i, o.ld) + k : o.base[0], in);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBN / 64; ++q) {
      const int f = tid + 128 * q, b = f >> 3, j = f & 7, i = i0 + 4 * b;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * j + e;
        const bool in = i < o.rows && k < k1;
        copy16(tile + kBBytes + chunk_at(4 * b + e, j),
               in ? bgemm::weight_row(o.base, o.seg, k, o.ld) + i : o.base[0], in);
      }
    }
  }
}

// The same thread splits the B' chunks it copied, in place: natural, each
// chunk; transposed, each 4 x 4 block read whole, transposed, and each
// output row's chunk split into its places.  A quarter-warp's eight
// threads take eight depth chunks of one row (or block row): eight
// distinct 16-byte bank groups.
template <bool TRANS>
__device__ __forceinline__ void split_b(unsigned char* tile, int tid) {
  if constexpr (!TRANS) {
#pragma unroll
    for (int q = 0; q < kBN / 16; ++q) {
      const int f = tid + 128 * q, off = chunk_at(f >> 3, f & 7);
      store_split(tile, off, *reinterpret_cast<const float4*>(tile + off));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBN / 64; ++q) {
      const int f = tid + 128 * q, b = f >> 3, j = f & 7;
      float4 v[4];  // v[e]: depth 4j + e of rows 4b .. 4b + 3
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = *reinterpret_cast<const float4*>(tile + kBBytes + chunk_at(4 * b + e, j));
      store_split(tile, chunk_at(4 * b, j), make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
      store_split(tile, chunk_at(4 * b + 1, j), make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
      store_split(tile, chunk_at(4 * b + 2, j), make_float4(v[0].z, v[1].z, v[2].z, v[3].z));
      store_split(tile, chunk_at(4 * b + 3, j), make_float4(v[0].w, v[1].w, v[2].w, v[3].w));
    }
  }
}

// A block's run over its tile.  The producer warpgroup (threads 0-127)
// copies each stage's tiles and splits B'.  Consumer warpgroup c (threads
// 128 (c + 1) on) takes A' rows m0 + 64c .. + 63: per k-step of 8 it reads
// its A fragments from the landed fp32 tile (4 words a thread, one 32-bit
// load each, 32 distinct banks a warp), applies the LayerNorm where `ln_g`
// is given (its rows' fp32 statistics taken first, a quad per row pair,
// under the producer's first copies), splits them in registers and issues
// the three m64n64k8 products with B' from shared memory; the next k-step's
// fragments are formed under them.  It calls fetch(v) before waiting for
// stage v and add() after, then finish(acc, row, col) at the end, where
// acc[4n + 2i + e] is the output at (row + 8i, col + 8n + e).  `smem` is the
// 1024-aligned base of kSmemBytes of dynamic shared memory.  One block a
// tile.
template <bool TRANS_A, bool TRANS_B, typename Fetch, typename Add, typename Finish>
__device__ __forceinline__ void run(unsigned char* smem, const Operand& A, const Operand& B, const Tile& tile,
                                    const float* ln_g, const float* ln_b, Fetch fetch, Add add, Finish finish) {
  const uint32_t base = smem_u32(smem), bars = base + kBarsAt;
  const int tid = threadIdx.x;
  const int total = stages_of(tile);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 128);
      mbar_init(bars + 8 * (kStages + s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    auto issue = [&](int w) {  // stage w's copies, as one cp.async group
      if (w < total) {
        const int s = w % kStages, k0 = tile.k0 + w * kBK;
        // a stage's previous use is released when every consumer warp arrived
        if (w >= kStages) mbar_wait(bars + 8 * (kStages + s), ((w / kStages) & 1) ^ 1);
        const uint32_t at = base + s * kStageBytes;
        copy_a<TRANS_A>(at, A, tile.m0, k0, tile.k1, tid);
        copy_b<TRANS_B>(at + kARawBytes, B, tile.n0, k0, tile.k1, tid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group keeps the count
    };
#pragma unroll
    for (int w = 0; w < kAhead; ++w) issue(w);
    for (int u = 0; u < total; ++u) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");  // stage u's copies landed
      split_b<TRANS_B>(smem + (u % kStages) * kStageBytes + kARawBytes, tid);
      fence_proxy_async();
      mbar_arrive(bars + 8 * (u % kStages));
      issue(u + kAhead);
    }
    return;
  }

  const int c = tid / 128 - 1, warp = tid % 128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 64 * c + 16 * warp + g;  // this thread's A' rows: r0 and r0 + 8 of the tile
  // the LayerNorm statistics of rows r0, r0 + 8: a quad's four threads each
  // sum every fourth 16-byte chunk, then the quad combines them
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (ln_g) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tile.m0 + r0 + 8 * i;
      float s = 0.f, ss = 0.f;
      if (row < A.rows) {
        const float* ar = A.base[0] + static_cast<long long>(row) * A.ld;
#pragma unroll 6
        for (int k = 4 * t; k < tile.k1; k += 16) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(ar + k));
          s += x.x + x.y + x.z + x.w;
          ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      mu[i] = s / tile.k1;
      rs[i] = 1.f / sqrtf(ss / tile.k1 - mu[i] * mu[i] + 1e-6f);
    }
  }
  // where fragment element e (row r0 + 8(e & 1), depth 8kk + t + 4(e >> 1))
  // of k-step kk lies in a landed A' tile
  auto a_at = [&](uint32_t at, int kk, int e) -> uint32_t {
    const int r = r0 + 8 * (e & 1), kc = 2 * kk + (e >> 1);
    if constexpr (TRANS_A) return at + ((8 * kk + t + 4 * (e >> 1)) * kLdT + r) * 4;
    return at + r * 128 + ((kc ^ g) << 4) + 4 * t;
  };

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  for (int u = 0; u < total; ++u) {
    const int s = u % kStages, k0 = tile.k0 + u * kBK;
    fetch(u);
    mbar_wait(bars + 8 * s, (u / kStages) & 1);
    add();
    const uint32_t at = base + s * kStageBytes;
    uint32_t big[kBK / 8][4], small[kBK / 8][4];
    fence_regs<32>(part);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = lds(a_at(at, kk, e));
        if (ln_g) {
          const int k = k0 + 8 * kk + t + 4 * (e >> 1);
          const float gm = k < tile.k1 ? __ldg(ln_g + k) : 0.f, bt = k < tile.k1 ? __ldg(ln_b + k) : 0.f;
          x = (x - mu[e & 1]) * rs[e & 1] * gm + bt;
        }
        split_tf32(x, big[kk][e], small[kk][e]);
      }
      fence_regs<4>(big[kk]);
      fence_regs<4>(small[kk]);
      wgmma_fence();
      wgmma_3xtf32<64>(part, big[kk], small[kk], at + kARawBytes + kk * 32, u % kSumStages > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(part);
    fence_regs<4 * kBK / 8>(&big[0][0]);
    fence_regs<4 * kBK / 8>(&small[0][0]);
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));  // this warp is done with the stage
    if (u % kSumStages == kSumStages - 1 || u == total - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
  }
  finish(acc, tile.m0 + r0, tile.n0 + 2 * t);
}

// the 1024-aligned base of a kernel's dynamic shared memory
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + (((smem_u32(raw) + 1023) & ~1023u) - smem_u32(raw));
}

// the launch of a 3xTF32 GEMM kernel over `tiles`, a block a tile: its
// dynamic shared memory limit raised (once per device), then the grid
template <auto KERNEL, typename Params>
cudaError_t launch(const Tiles& tiles, cudaStream_t stream, const Params& p) {
  int sms = 0;
  const cudaError_t err = bgemm::prepare<KERNEL>(kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  KERNEL<<<tiles.count, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tgemm
}  // namespace
