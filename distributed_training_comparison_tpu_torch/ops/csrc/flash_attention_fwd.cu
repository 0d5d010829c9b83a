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
// fp32 inputs (the entry point's default precision, without --amp: vit_long
// served and trained in fp32) run flash_fwd_tf32x3, the same function on
// wgmma in 3xTF32: each fp32 operand splits into big = tf32(x) and small =
// tf32(x - big), and each fp32 product is three tf32 products (small·big,
// big·small, big·big), fp32 accuracy at three times the TF32 operations.
// At the fp32 serving shape (bh 32, S 4096, D 128) that is 8.2e11 tf32
// FLOP, 1.67 ms at 495 TFLOP/s, against 134 MB of traffic: bound by
// operations.  tf32 wgmma reads shared memory K-major only and a split
// tile takes twice the room, so the design differs from the bf16 one
// (tf32x3.cuh, shared with the 3xTF32 backward): 128 query rows a block,
// Q split once into shared memory (S's products read both operands from
// there), K and V split once by a producer warpgroup into a cp.async ring of
// big/small slots (V transposed, its keys permuted to the fragments' order
// so that P goes from the accumulator to A with no shuffle), 64-key tiles,
// each tile's P·V in a fresh accumulator added to O in fp32 (the tensor
// cores round their sums toward zero).  The semantics are those above, with
// P kept in fp32 (split like every operand) and out and lse in fp32.

#include "tf32x3.cuh"

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
constexpr int kBoxBytes = box_bytes<kBN>();  // a box of 128 rows
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
      load_tile<D, kBN>(base + L::kQ, &tq, m0, h, b, q_full);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        // a stage's previous use is released when all 8 consumer warps arrived
        if (j >= kStages) mbar_wait(k_empty(st), ph ^ 1);
        load_tile<D, kBN>(base + L::kK + st * L::kTile, &tk, j * kBN, h, b, k_full(st));
        if (j >= kStages) mbar_wait(v_empty(st), ph ^ 1);
        load_tile<D, kBN>(base + L::kV + st * L::kTile, &tv, j * kBN, h, b, v_full(st));
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

// ------------------------------------------------------------------ fp32
//
// 3xTF32 on wgmma, on tf32x3.cuh's split, ring and products (its header
// says how they work).  Per 64-key tile a consumer warpgroup computes S =
// Q·K_jᵀ over D from D / 32 natural slots of K_j (64 keys x 32 of D), runs
// the online softmax on S's accumulator, and adds P·V_j from 2 x D / 64
// transposed slots of V_j (64 of D x 32 keys, the keys in the fragments'
// order): eight slots a tile at D 128, four at D 64.  Each consumer
// warpgroup splits its 64 Q rows once into D / 32 slots of its own, laid
// out as the ring's, so S's products take A from shared memory too: the
// consumers split nothing a slot, and each slot's products queue behind
// the previous slot's (the backward's A fragments, split a k-step at a
// time, make each slot wait for its own products).  Shared memory at
// D 128: Q 128 KB split + 6 slots (96 KB) = 224 KB, the backward's.
// Registers (setmaxnreg 56 / 224, the backward's split of the launch
// allocation): O 64 + S 32 + P's fragments 64 + the tile's partial O 32.

constexpr int kTf32Keys = 64;  // keys per streamed K/V tile: the slots' rows

template <int D>
using Tf32Fwd = Tf32Layout<D, 4>;  // own rows: Q of 2 warpgroups, split: big and small

// Block: warpgroup 0 produces, warpgroups 1 and 2 consume, each owning 64
// query rows.  Per 64-key tile j each consumer warpgroup: S = Q·K_jᵀ
// (3xTF32 m64n64k8), the masks, the running max and sum, P = exp2(S·scale·
// log2e - m) on the accumulator, O rescaled by alpha, then O += P·V_j, the
// tile's products in a fresh accumulator.  Accumulator maps as in
// flash_fwd_bf16: o[hh][4n + 2i + e] is row g + 8i, column 64·hh + 8n + 2t + e.
template <int D>
__global__ void __launch_bounds__(384, 1) flash_fwd_tf32x3(const Params p) {
  using L = Tf32Fwd<D>;
  constexpr int kN = kTf32Keys;
  constexpr int kPerTile = D / 32 + 2 * (D / 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  // causal: the longest blocks (the last query tiles) go first
  const int mb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: keys past the block's last row contribute nothing, and are never loaded
  const int kv_end = p.causal ? min(p.skv, m0 + kBM) : p.skv;
  const int nk = (kv_end + kN - 1) / kN;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int r = u % kPerTile, n0 = u / kPerTile * kN;
      if (r < D / 32) return SlotSrc{kg, kg, p.k_ss, p.k_ss, n0, p.skv, 32 * r, false};
      const int idx = r - D / 32;  // column block idx / 2, key chunk idx % 2
      return SlotSrc{vg, vg, p.v_ss, p.v_ss, n0 + 32 * (idx % 2), p.skv, 64 * (idx / 2), true};
    };
    produce<kSlotRows>(slot_of, nk * kPerTile, sbase + L::kRingAt, bars, tid);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + 64 * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const int row[2] = {row0, row0 + 8};
  const float sl2 = p.scale * kLog2e;
  // the warpgroup's 64 Q rows split once into D / 32 slots of its own, as
  // the producer splits K
  const int wtid = tid % 128;
  const uint32_t q_at = base + c * (D / 32) * kSlotBytes;
#pragma unroll
  for (int cc = 0; cc < D / 32; ++cc)
    slot_issue<kSlotRows>(q_at + cc * kSlotBytes,
                          SlotSrc{qg, qg, p.q_ss, p.q_ss, m0 + 64 * c, p.sq, 32 * cc, false}, wtid);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int cc = 0; cc < D / 32; ++cc) slot_split(sbase + (q_at - base) + cc * kSlotBytes, false, wtid);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");  // the warpgroup's Q is split
  const uint32_t ring = base + L::kRingAt;

  float o[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in units of scale·log2e
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum

  int u = 0;
  for (int j = 0; j < nk; ++j) {
    // S = Q·K_jᵀ: each slot's products queued behind the previous slot's,
    // which is released once they have run
    float s[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
      consumer_wait(bars, u + cc);
      const uint32_t slot = ring + ((u + cc) % kRing) * kSlotBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_3xtf32_ss(s, q_at + cc * kSlotBytes + kk * 32, slot + kk * 32, cc > 0 || kk > 0);
      wgmma_commit();
      if (cc > 0) {
        wgmma_wait<1>();
        consumer_release(bars, u + cc - 1, lane);
      }
    }
    wgmma_wait<0>();
    fence_regs<kN / 2>(s);
    consumer_release(bars, u + D / 32 - 1, lane);
    u += D / 32;
    // masks only on the tiles that reach past the key length or straddle the diagonal
    const int n0 = j * kN;
    if (n0 + kN > p.skv || (p.causal && n0 + kN - 1 > m0 + 64 * c)) {
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * n + 2 * t + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[e >> 1]);
          if (!ok) s[4 * n + e] = kNegInf;
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      // the max of the raw scores, scaled (scale > 0): p = 2^(s·scale·log2e - m)
      const float m_new = fmaxf(m_run[i], quad_max(mx) * sl2);
      alpha[i] = exp2f(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
        s[4 * n + 2 * i] = exp2f(fmaf(s[4 * n + 2 * i], sl2, -m_new));
        s[4 * n + 2 * i + 1] = exp2f(fmaf(s[4 * n + 2 * i + 1], sl2, -m_new));
        sum += s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
      }
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
    }
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
    uint32_t big[kN / 8][4], small[kN / 8][4];
    acc_frags<kN / 8>(big, small, s);
    sums<D, kN / 8>(o, big, small, ring, bars, u, lane);
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + (static_cast<long long>(b) * gridDim.y + h) * p.sq;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = fmaxf(quad_sum(l_run[i]), 1e-30f);
    inv[i] = 1.f / l;
    if (t == 0 && row[i] < p.sq) lg[row[i]] = (m_run[i] + log2f(l)) * kLn2;
  }
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] *= inv[(i >> 1) & 1];
    store_f32(og, p.o_ss, row0, p.sq, 64 * hh, o[hh], t);
  }
}

template <int D>
int launch_tf32x3(const Params& p, int batch, int heads, cudaStream_t stream) {
  const auto kernel = flash_fwd_tf32x3<D>;
  const int smem = Tf32Fwd<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.sq + kBM - 1) / kBM, heads, batch), 384, smem, stream>>>(p);
  return cudaGetLastError();
}

// 0 on success, a cudaError_t if the launch failed, -CUresult if a map did not encode
template <int D>
int launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, p.q, D, p.sq, heads, batch, p.q_sb, p.q_sh, p.q_ss, kBM);
  if (r == CUDA_SUCCESS) r = encode(&tk, p.k, D, p.skv, heads, batch, p.k_sb, p.k_sh, p.k_ss, kBN);
  if (r == CUDA_SUCCESS) r = encode(&tv, p.v, D, p.skv, heads, batch, p.v_sb, p.v_sh, p.v_ss, kBN);
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
    if (head_dim == 64) return launch_tf32x3<64>(p, batch, heads, s);
    if (head_dim == 128) return launch_tf32x3<128>(p, batch, heads, s);
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the bf16 kernel at head dim `head_dim` (0 if it is not taken)
extern "C" int flash_attention_fwd_smem(int head_dim) {
  return head_dim == 64 ? Layout<64>::kBytes : head_dim == 128 ? Layout<128>::kBytes : 0;
}

// dynamic shared memory of the fp32 (3xTF32) kernel at head dim `head_dim` (0 if it is not taken)
extern "C" int flash_attention_fwd_tf32x3_smem(int head_dim) {
  return head_dim == 64 ? Tf32Fwd<64>::kBytes : head_dim == 128 ? Tf32Fwd<128>::kBytes : 0;
}
