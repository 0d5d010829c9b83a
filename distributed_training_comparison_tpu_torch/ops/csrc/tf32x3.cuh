// 3xTF32 on wgmma: the fp32 building blocks shared by the flash-attention
// forward (flash_attention_fwd.cu, flash_fwd_tf32x3) and backward
// (flash_attention_bwd.cu, flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3),
// the fused ViT block's attention (vit_block_fwd.cu, block_attn_tf32x3;
// vit_block_bwd.cu, block_attn_dq_tf32x3 and block_attn_dkv_tf32x3) and,
// through block_gemm_tf32.cuh, its GEMMs.
//
// Each fp32 operand x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna's rounding: to nearest, ties away, the low 13 mantissa bits
// zero), and each product a·b is small_a·big_b + big_a·small_b +
// big_a·big_b accumulated in fp32: the dropped small·small term and the
// rounding of small leave |x - big - small| <= 2^-22 |x|, fp32 accuracy.
// Three tf32 products at 495 TFLOP/s dense are 165 TFLOP/s of fp32 work,
// 2.5x the 67 of fp32 SIMT; the kernels are bound by those operations.
//
// tf32 wgmma (m64nNk8) reads shared-memory operands K-major only (the
// transpose bits exist for 16-bit types alone), and a big and a small copy
// of a 64 x 128 fp32 tile are 64 KB, so the kernels keep:
// - A in registers or in slots of its own.  A block's own rows (64 a
//   consumer warpgroup, two consumer warpgroups) are read from device
//   memory once: the backward's two own tensors a warpgroup raw in the
//   A-fragment order, split a k-step at a time; the forward's Q split once
//   into slots laid out as the ring's (`wgmma_3xtf32_ss`).  A operands made
//   on the card (P, dS) come from the accumulators (`acc_frags`), whose
//   layout the fragments follow through a permutation of the contraction
//   axis (below).
// - B in one ring of 16 KB slots: 64 rows x 32 tf32 columns (one 128-byte
//   swizzle row), big then small, K-major under 128-byte swizzle.  A
//   producer warpgroup (`produce`) copies each slot's fp32 tile from device
//   memory into the slot with cp.async (16-byte copies, three slots in
//   flight a thread), then splits it in place, transposed where the
//   product contracts over the sequence (64 columns of D x 32 rows of the
//   sequence a slot, `SlotSrc::trans`).
// - The tf32 A fragment holds (row g, col t), (g + 8, t), (g, t + 4),
//   (g + 8, t + 4) of an 8-column k-step, where the fp32 accumulator holds
//   columns 2t and 2t + 1: taken from the accumulator, fragment position t
//   is column 2t and t + 4 is 2t + 1, so the transposed slots store the
//   contraction axis in that order within each group of 8 (rows 0, 2, 4,
//   6, 1, 3, 5, 7) and no shuffle is needed.
// - Each consumer warpgroup waits for its products at the end of every
//   slot and releases it; the other warpgroup's products fill that gap.
// The tensor cores' fp32 accumulation rounds toward zero: a long sum over
// the sequence takes each tile's products in a fresh accumulator and adds
// it to the total in fp32 (`sums`), so its error does not grow with S.

#pragma once

#include "hopper_common.cuh"

namespace {

constexpr int kRing = 6;                          // slots
constexpr int kSlotRows = 64;                     // rows of a slot: wgmma's N (or two 32-row halves)
constexpr int kHalfBytes = kSlotRows * 32 * 4;    // the big half: 64 rows x 128 bytes; small follows
constexpr int kSlotBytes = 2 * kHalfBytes;
constexpr int kFrag = 128 * 16;                   // one k-step of a warpgroup's A fragments, raw fp32

// setmaxnreg moves registers within the block's launch allocation (384 x
// 168 = 64,512): 128 x 56 + 256 x 224 is all of it (at 40 / 232 ptxas
// spills in dkv at D 128; at 48 / 232 the consumers' increase waits
// forever)
constexpr int kF32ProducerRegs = 56;
constexpr int kF32ConsumerRegs = 224;

// Dynamic shared memory of a 3xTF32 kernel, byte offsets from its
// 1024-aligned base: OWN tensors of own rows (one tensor of one consumer
// warpgroup: 64 rows x D fp32 in fragment order), the ring, then its
// barriers: "full" of slot s at bars + 8·s (the 128 producer threads
// arrive), "empty" at bars + 8·(kRing + s) (the 8 consumer warps arrive).
template <int D, int OWN>
struct Tf32Layout {
  static constexpr int kOwnTensor = D / 8 * kFrag;
  static constexpr int kRingAt = OWN * kOwnTensor;
  static constexpr int kBars = kRingAt + kRing * kSlotBytes;
  static constexpr int kBytes = kBars + 2 * kRing * 8 + 1024;  // barriers, alignment slack
};

// thread 0 initialises the ring's barriers; the block waits for them
__device__ __forceinline__ void ring_init(uint32_t bars, int tid) {
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bars + 8 * s, 128);
      mbar_init(bars + 8 * (kRing + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A-fragment element e of a thread: row g + 8·frag_row(e), column t + 4·frag_col(e)
__device__ __forceinline__ constexpr int frag_row(int e) { return e & 1; }
__device__ __forceinline__ constexpr int frag_col(int e) { return e >> 1; }

// tf32(x) rounded to nearest, ties away from zero, the low 13 bits zero:
// what cvt.rna.tf32.f32 computes for finite x and inf, as an integer add and
// mask on the bits (the conversion instruction runs at a fraction of the
// integer rate, and the kernels split every operand element they read).
// Not for a NaN: the add carries its payload into the exponent or the sign
// (0x7FFFFFFF, the card's NaN, becomes -0).
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// big = tf32(x), small = tf32(x - big).  big adds x·0, exact for finite x
// (the zeros share the sign of x and of its rounding) and NaN for a NaN or
// an inf, so such an operand makes its products NaN instead of dropping out
// of them; one FMA where a test of the exponent and a select cost the
// kernels a fifth of their time.  small of a NaN is then -0, which big
// outweighs.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  const float b = __fmaf_rn(x, 0.0f, __uint_as_float(to_tf32(x)));
  big = __float_as_uint(b);
  small = to_tf32(x - b);
}

__device__ __forceinline__ void split4(const float4 x, uint32_t* big, uint32_t* small) {
  split_tf32(x.x, big[0], small[0]);
  split_tf32(x.y, big[1], small[1]);
  split_tf32(x.z, big[2], small[2]);
  split_tf32(x.w, big[3], small[3]);
}

// a 64 x 8·K8 fp32 accumulator as big and small tf32 A fragments of K8
// k-steps: fragment element e is column 2t + frag_col(e) of row g + 8·frag_row(e)
template <int K8>
__device__ __forceinline__ void acc_frags(uint32_t (*big)[4], uint32_t (*small)[4], const float* x) {
#pragma unroll
  for (int n = 0; n < K8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[4 * n + 2 * frag_row(e) + frag_col(e)], big[n][e], small[n][e]);
  }
}

// D (fp32, 64 x N) += A (tf32, 64 x 8, registers) · B (tf32, 8 x N, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_m64n32k8(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// D (fp32, 64 x 64) += A (tf32, 64 x 8) · B (tf32, 8 x 64), both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_m64n64k8_ss(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// the three tf32 products of one fp32 k-step with A split in shared memory
// too (a slot's layout: big at a_at, small kHalfBytes on)
__device__ __forceinline__ void wgmma_3xtf32_ss(float* d, uint32_t a_at, uint32_t b_at, int acc) {
  const uint64_t ab = smem_desc(a_at, 16, 1024), as = smem_desc(a_at + kHalfBytes, 16, 1024);
  const uint64_t bb = smem_desc(b_at, 16, 1024), bs = smem_desc(b_at + kHalfBytes, 16, 1024);
  wgmma_tf32_m64n64k8_ss(d, as, bb, acc);
  wgmma_tf32_m64n64k8_ss(d, ab, bs, 1);
  wgmma_tf32_m64n64k8_ss(d, ab, bb, 1);
}

// the three tf32 products of one fp32 k-step: small·big, big·small, big·big
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float* d, const uint32_t* big, const uint32_t* small,
                                             uint32_t b_at, int acc) {
  const uint64_t bb = smem_desc(b_at, 16, 1024), bs = smem_desc(b_at + kHalfBytes, 16, 1024);
  if constexpr (N == 64) {
    wgmma_tf32_m64n64k8(d, small, bb, acc);
    wgmma_tf32_m64n64k8(d, big, bs, 1);
    wgmma_tf32_m64n64k8(d, big, bb, 1);
  } else {
    static_assert(N == 32, "the 3xTF32 products take N 32 or 64");
    wgmma_tf32_m64n32k8(d, small, bb, acc);
    wgmma_tf32_m64n32k8(d, big, bs, 1);
    wgmma_tf32_m64n32k8(d, big, bb, 1);
  }
}

// Where a slot's fp32 tile comes from.  Natural (K-major over D): slot row
// r < SPLIT is row row0 + r of `a`, the others row row0 + r - SPLIT of `b`,
// columns col0 .. col0 + 31.  Transposed: slot row n is column col0 + n of
// `a` (64 of them), its 32 tf32 columns rows row0 .. row0 + 31 of `a` in the
// fragments' order.  Rows at or past `len` are zeros.
struct SlotSrc {
  const float* a;
  const float* b;
  long long a_ss, b_ss;
  int row0, len, col0;
  bool trans;
};

// where a producer thread's 16-byte chunk i of a slot lands, raw: natural,
// at its place in the big half (chunk j of row r at chunk j ^ (r % 8) of the
// row's 128 bytes); transposed, row `lane` (of 32) of a 64-column staging
// tile in the small half, 16 chunks a row, swizzled so that a quarter-warp
// reading one chunk index of 8 rows hits 8 distinct bank groups
__device__ __forceinline__ int raw_at(bool trans, int tid, int i) {
  if (trans) {
    const int lane = tid & 31, c = 4 * (tid >> 5) + i;
    return kHalfBytes + (lane * 16 + (c ^ (lane & 7))) * 16;
  }
  const int f = tid + 128 * i, r = f >> 3;
  return r * 128 + (((f & 7) ^ (r & 7)) << 4);
}

// the producer thread's four 16-byte copies of a slot, as one cp.async group;
// rows past the length land as zeros (source size 0), and with COLS so do
// columns at or past `cols` (a multiple of 4: a head dim under the slots'
// width, whose neighbours are the next head's)
template <int SPLIT, bool COLS = false>
__device__ __forceinline__ void slot_issue(uint32_t slot, const SlotSrc& s, int tid, int cols = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* src = s.a;
    long long ss = s.a_ss;
    int row, col;
    if (s.trans) {
      row = s.row0 + (tid & 31);
      col = s.col0 + 4 * (4 * (tid >> 5) + i);
    } else {
      const int f = tid + 128 * i, r = f >> 3;
      col = s.col0 + 4 * (f & 7);
      row = s.row0 + r;
      if (r >= SPLIT) src = s.b, ss = s.b_ss, row -= SPLIT;
    }
    const bool in = row < s.len && (!COLS || col < cols);
    const float* from = src + (in ? row * ss + col : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(slot + raw_at(s.trans, tid, i)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// split a landed slot in place.  Natural: each thread splits the chunks it
// copied (big over the raw values, small at the same place of the small
// half).  Transposed: each thread reads the chunks it copied, the producer
// warpgroup syncs (the stores overwrite the staging tile), and the warp's 32
// lanes, the 32 contraction rows, each store one 4-byte element of a slot
// row (all 32 banks); row `key` goes to position key / 2 within its group
// of 8, plus 4 if odd: the accumulator's column order as the fragments
// read it.
__device__ __forceinline__ void slot_split(unsigned char* slot, bool trans, int tid) {
  uint32_t big[4], small[4];
  if (!trans) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = raw_at(false, tid, i);
      split4(*reinterpret_cast<const float4*>(slot + off), big, small);
      *reinterpret_cast<uint4*>(slot + off) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(slot + kHalfBytes + off) = make_uint4(small[0], small[1], small[2], small[3]);
    }
    return;
  }
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = *reinterpret_cast<const float4*>(slot + raw_at(true, tid, i));
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // every staged chunk is read
  const int key = tid & 31;
  const int kp = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split4(v[i], big, small);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * (4 * (tid >> 5) + i) + e;
      const int off = n * 128 + (((kp >> 2) ^ (n & 7)) << 4) + ((kp & 3) << 2);
      *reinterpret_cast<uint32_t*>(slot + off) = big[e];
      *reinterpret_cast<uint32_t*>(slot + kHalfBytes + off) = small[e];
    }
  }
}

// The producer warpgroup: fills slots 0 .. total - 1 in the consumers' order,
// slot u in stage u % kRing, with the copies of kAhead slots in flight a
// thread; a slot is split once its copies landed.  A stage is full when all
// 128 threads stored and fenced their writes for the async proxy.
constexpr int kAhead = 3;

template <int SPLIT, bool COLS = false, typename SlotOf>
__device__ __forceinline__ void produce(SlotOf slot_of, int total, unsigned char* ring, uint32_t bars, int tid,
                                        int cols = 0) {
  const uint32_t ring_at = smem_u32(ring);
  auto issue = [&](int w) {
    if (w >= total) {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group keeps the count
      return;
    }
    const int st = w % kRing;
    // a stage's previous use is released when all 8 consumer warps arrived
    if (w >= kRing) mbar_wait(bars + 8 * (kRing + st), ((w / kRing) & 1) ^ 1);
    slot_issue<SPLIT, COLS>(ring_at + st * kSlotBytes, slot_of(w), tid, cols);
  };
  for (int w = 0; w < kAhead; ++w) issue(w);
  for (int u = 0; u < total; ++u) {
    issue(u + kAhead);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");  // slot u's copies landed
    slot_split(ring + (u % kRing) * kSlotBytes, slot_of(u).trans, tid);
    fence_proxy_async();
    mbar_arrive(bars + 8 * (u % kRing));
  }
}

__device__ __forceinline__ void consumer_wait(uint32_t bars, int u) {
  mbar_wait(bars + 8 * (u % kRing), (u / kRing) & 1);
}

__device__ __forceinline__ void consumer_release(uint32_t bars, int u, int lane) {
  if (lane == 0) mbar_arrive(bars + 8 * (kRing + u % kRing));  // this warp is done with the stage
}

// acc[hh] (columns 64·hh .. of D) += A · this tile's transposed slots, A
// from fragments of K8 k-steps, K8 / 4 slots a column block (slot order:
// column block major).  The tensor cores round each accumulation toward
// zero, so summing a whole sequence in one accumulator drifts with its
// length (1.7e-4 of a row's rms at S 4096); each tile's products go to a
// fresh accumulator, added to the total in fp32.
template <int D, int K8>
__device__ __forceinline__ void sums(float (*acc)[32], uint32_t (*big)[4], uint32_t (*small)[4], uint32_t ring,
                                     uint32_t bars, int& u, int lane) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
    float part[32];
#pragma unroll
    for (int kc = 0; kc < K8 / 4; ++kc) {
      consumer_wait(bars, u);
      const uint32_t slot = ring + (u % kRing) * kSlotBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_3xtf32<64>(part, big[4 * kc + kk], small[4 * kc + kk], slot + kk * 32, kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(part);
      fence_regs<4 * K8>(&big[0][0]);
      fence_regs<4 * K8>(&small[0][0]);
      consumer_release(bars, u, lane);
      ++u;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] += part[i];
  }
}

// acc (64 x 64, fresh) = own rows · slots' rowsᵀ over D: D / 32 slots of 32
// columns, the own rows a thread's A fragments raw in shared memory (kFrag a
// k-step), each k-step split as it is read
template <int D>
__device__ __forceinline__ void scores(float* acc, const unsigned char* own, uint32_t ring, uint32_t bars,
                                       int& u, int lane) {
#pragma unroll
  for (int cc = 0; cc < D / 32; ++cc) {
    consumer_wait(bars, u);
    const uint32_t slot = ring + (u % kRing) * kSlotBytes;
    uint32_t big[4][4], small[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      split4(*reinterpret_cast<const float4*>(own + (4 * cc + kk) * kFrag), big[kk], small[kk]);
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

// a warpgroup's 64 x 64 fp32 accumulator block hh into rows row0 and row0 + 8
__device__ __forceinline__ void store_f32(float* base, long long ld, int row0, int len, int col0,
                                          const float* acc, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + 8 * i >= len) continue;
    float* out = base + (row0 + 8 * i) * ld + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

// the same, columns at or past `cols` (from the block's first) not written
__device__ __forceinline__ void store_f32_cols(float* base, long long ld, int row0, int len, int col0, int cols,
                                               const float* acc, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + 8 * i >= len) continue;
    float* out = base + (row0 + 8 * i) * ld + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (8 * n + 2 * t < cols)
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

}  // namespace
