// Short-sequence multi-head self-attention for Hopper (sm_90a): forward
// (K10) and backward (K11), bound through plain C functions and loaded with
// ctypes (ops/attention_small.py).
//
// Replaces the TPU kernels distributed_training_comparison_tpu/ops/
// attention_small.py::_fwd_kernel (K10, attention_small.py:160) and
// ::_bwd_kernel (K11, :168), both launched through the one pl.pallas_call
// in _call (:186) under the custom VJP _small_core (:202-224).  The TPU
// kernels stack tb items into one (tb*S, tb*S) score matmul, masked
// block-diagonally, to fill a 128x128 matrix unit.  The cross-item blocks
// are exact zeros, so per-(item, head) attention is the same function, and
// that is what these kernels compute.  q, k, v, the output and the
// gradients are the packed (B*S, H*D) row-major views of the (B, S, H, D)
// projections (row stride H*D): no head-split copy is made.
//
// Semantics, those of head_fwd / head_bwd: fp32 scores times the scale,
// keys past S and (under causal) past the row at -1e30 before the max, the
// exact softmax e / sum(e) over the row's whole key set after its max, P
// rounded to bf16 before P.V and before P^T.dO, dp and ds in fp32 with
// ds = P (dp - sum_j dp P) on the fp32 P, ds.scale rounded to bf16 before
// dS.K and dS^T.Q, each output and gradient accumulated in fp32 and rounded
// once.  Each output element is written by one block in a fixed order (no
// atomics), so K11 is bit-identical from call to call.
//
// The rule on S, the same in both C entry points: bf16 items of S <= 64 (one
// 64-key tile: vit_tiny and vit_small at 32 px and patch 4) run the one-tile
// kernels; bf16 items of S > 64 (vit_small --patch-size 2 pinned to
// fused_small: 256 tokens) run the tiled kernels; fp32 runs the 3xTF32
// kernels (below) at every S.  A rule on the shape, not a fallback.  The
// tiled kernels hold a query tile's scores in registers up to a resident
// number of keys and sweep the keys twice past it (their section below).
//
// What bounds the one-tile kernels (bf16, S 64, D 64, 3 heads): bytes.  The
// forward reads q, k, v and writes o, 4 S D B H x 2 bytes against 4 S^2 D
// B H flops: 25.2 MB (7.5 us at 3.35 TB/s) against 0.81 GFLOP (0.8 us at
// 989 TFLOP/s) at the train shape (B 256), 3.1 MB (0.94 us) at the serve
// shape (B 32), where 96 (item, head) pairs leave the card latency-bound.
// The backward reads q, k, v, dO and writes dq, dk, dv: 44 MB (13.1 us)
// against 2.0 GFLOP.  The design reads each input once and keeps everything
// else on chip:
// - attn_small_fwd_onetile (K10): one warpgroup (128 threads) per (item,
//   head) owns the item's 64 query rows and its whole key range.  Q, K and V
//   are fetched together by cp.async (16 bytes a thread, every load in
//   flight at once, one wait) into 64-row tiles under the 128-byte swizzle a
//   wgmma descriptor reads; rows past S are zero-filled.  S = Q.K^T by wgmma
//   m64n64k16 from shared memory (both K-major); the masks, the row max and
//   sum in registers (quad shuffles), in one pass with no rescaling; P =
//   e / sum rounded to bf16 is the A fragment of O = P.V (wgmma, A from
//   registers, V MN-major).  The scores are computed once.
// - attn_small_bwd_onetile (K11): one kernel, one warpgroup per (item,
//   head), as the TPU's _bwd_kernel computes all three gradients of a head.
//   Q, K, V and dO are fetched together.  S = Q.K^T and dP = dO.V^T (wgmma,
//   one commit group); P in fp32 as in K10, delta = sum_j dp P and dS in
//   registers; round(P) and round(dS) go to two swizzled 64 x 64 tiles
//   (each lane applies the XOR swizzle itself, then the proxy fence and a
//   barrier); dQ = dS.K (A from registers, K MN-major), dV = P^T.dO and
//   dK = dS^T.Q (both operands MN-major from shared memory, A read
//   transposed).  The scores are computed once; no statistic leaves the
//   block, so no scratch is allocated.
// - Query rows past S compute P = 0 and are not written; keys past S take
//   p = exp(-1e30 - max) = 0 exactly.  Shared memory: 3 (forward) or 4
//   (backward) D-wide 64-row tiles, plus 16 KB of P and dS tiles, and 1 KB
//   of alignment slack: 25 / 49 KB at D 64, several blocks an SM.
//
// The one-tile kernels' device helpers (the swizzled loads, descriptors,
// score product, softmax and stores) are attention_tiles.cuh's, shared with
// the fused ViT block's attention.
//
// The tiled bf16 kernels (S > 64), attn_small_fwd_bf16, then for K11
// attn_small_dq_bf16 (dq, and each row's max, sum and delta into an fp32
// scratch) and attn_small_dkv_bf16 (dk, dv from them), run every product
// as a wgmma on the same swizzled tiles; their section below says how.
//
// fp32 (vit_tiny without --amp, the default precision) runs every product
// on the tensor cores as three tf32 products (tf32x3.cuh: x = big + small,
// a.b = small.big + big.small + big.big, fp32 accuracy): the forward
// attn_small_fwd_f32, then K11 as attn_small_dq_f32 (dq, and each query
// row's max, sum and delta into the fp32 scratch) and attn_small_dkv_f32
// (dk, dv from them), one warpgroup a block and 64 rows of an (item, head).
// What bounds them at the train shape (B 256, S 64, 3 heads of 64): bytes.
// The forward moves 50.3 MB (15.0 us at 3.35 TB/s) against 0.81 GFLOP, 4.9
// us as 3xTF32 at 165 TFLOP/s; the backward 88.1 MB (26.3 us) against 2.0
// GFLOP (12.2 us).  So each kernel reads its inputs once a block and forms
// each product once: the forward S once (the softmax in registers, at one
// tile with nothing to rescale), dq S and dP once with the row statistics
// from the registers, dk/dv S^T and dP^T once from those statistics; and
// the blocks stay small enough for two or three an SM to overlap one's
// copies with another's products (the section's header below).
// PR 6's SIMT kernels, which this replaces, formed the forward's scores
// twice and the backward's four times with two shared loads an FMA.

#include "attention_tiles.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

struct Params {
  const void* q;     // (batch * seq, ld) each, one head's D columns at h * D
  const void* k;
  const void* v;
  const void* dout;  // backward: the output cotangent, (batch * seq, ld)
  void* o;           // forward: the output; backward: dq
  void* dk;          // backward
  void* dv;
  float* stats;      // backward scratch (batch * seq, heads, 3): row max, row sum, delta
  int seq, heads, ld;
  float scale;
  int causal;
};

// query `row` sees key `col`: inside the item, and at or before the row under causal
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.seq && (!p.causal || col <= row);
}

// end of the keys that the query rows [row0, row0 + rows) see
__device__ __forceinline__ int key_end(const Params& p, int row0, int rows) {
  return p.causal ? min(p.seq, row0 + rows) : p.seq;
}

__device__ __forceinline__ long long head_base(const Params& p, int b, int h, int d) {
  return static_cast<long long>(b) * p.seq * p.ld + h * d;
}

// ------------------------------------------------- fp32: 3xTF32 on wgmma
//
// One warpgroup a block owns 64 rows of one (item, head): query rows in
// attn_small_fwd_f32 and attn_small_dq_f32, key rows in attn_small_dkv_f32.
// Its own rows, the products' A operands (Q; Q and dO; K and V), land raw
// in shared memory in the A-fragment order (4-byte cp.async, each thread
// its own float4 a k-step) and are split a k-step at a time as they are
// read.  The streamed operands land in tf32x3.cuh's 16 KB slots (big then
// small, K-major under the 128-byte swizzle) by its slot_issue and are split
// in place by slot_split: natural (D the depth) for the products over D,
// transposed (the sequence the depth, in the fragments' order 0, 2, 4, 6,
// 1, 3, 5, 7) for those over the sequence, whose A operands (P, dS and
// their transposes) come from the accumulators through acc_frags.  There
// is no producer warpgroup: at 64 tokens a block's keys are one tile, so a
// block runs its copies, splits and products in series, and the blocks an
// SM holds fill each other's gaps.  So the slots of the products over D
// take the transposed operands once those products are done (copied while
// the softmax runs), which keeps the forward and dk/dv kernels at 49 and 65
// KB and at most 168 registers at head dim 64, three blocks an SM (the dq
// kernel, 97 KB, runs two: its S and dP read K and V together).

constexpr int kF32Rows = 64;     // rows a block: one warpgroup's wgmma M
constexpr int kF32Keys = 64;     // keys a tile (forward, dq): wgmma N 64
constexpr int kF32Queries = 32;  // queries a tile (dk/dv): wgmma N 32, Q and dO rows in one slot
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory: SLOTS slots, then OWN tensors of own rows (D / 8
// k-steps of kFrag bytes each), then slack for the 1024-byte alignment
template <int D, int SLOTS, int OWN>
struct F32Layout {
  static constexpr int kOwnAt = SLOTS * kSlotBytes;
  static constexpr int kOwnTensor = D / 8 * kFrag;
  static constexpr int kBytes = kOwnAt + OWN * kOwnTensor + 1024;
};
template <int D>
using FwdF32 = F32Layout<D, D / 32, 1>;  // K, then V^T; Q
template <int D>
using DqF32 = F32Layout<D, 2 * (D / 32), 2>;  // K, V (then K^T); Q, dO
template <int D>
using DkvF32 = F32Layout<D, D / 32, 2>;  // Q and dO, then dO^T and Q^T; K, V

// this thread's A fragments of rows row0 and row0 + 8 of a (len, D) head
// slice (row stride ld), raw, into its float4 of each k-step at `own`
// (kFrag bytes a k-step); rows at or past len land as zeros.  Committed
// with the next slot's group.
template <int D>
__device__ __forceinline__ void own_issue(uint32_t own, const float* g, long long ld, int row0, int len, int t) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * frag_row(e), col = 8 * ks + t + 4 * frag_col(e);
      const bool in = row < len;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(own + ks * kFrag + 4 * e),
                   "l"(g + (in ? row * ld + col : 0)), "r"(in ? 4 : 0)
                   : "memory");
    }
}

// wait for this thread's copies, split the landed slots (n_natural from
// `natural`, n_trans from `trans`) in place, and make them visible to the
// block's wgmma
__device__ __forceinline__ void land_slots(unsigned char* natural, int n_natural, unsigned char* trans,
                                           int n_trans, int tid) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int i = 0; i < n_natural; ++i) slot_split(natural + i * kSlotBytes, false, tid);
  for (int i = 0; i < n_trans; ++i) slot_split(trans + i * kSlotBytes, true, tid);
  fence_proxy_async();
  __syncthreads();
}

// acc (64 x N, fresh) = own rows · rowsᵀ of the natural slots at `slots`
// over D (D / 32 slots of 32 columns; N 32 reads 32 rows from `slots`, so
// a caller offsets it by 32 rows for the others), the own k-steps split KK
// at a time (a commit group each); with TWO, acc2 from own2 and slots2 in
// the same commit groups
template <int D, int N, bool TWO, int KK = 4>
__device__ __forceinline__ void own_products(float* acc, const unsigned char* own, uint32_t slots, float* acc2,
                                             const unsigned char* own2, uint32_t slots2) {
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += KK) {
    uint32_t big[KK][4], small[KK][4], big2[KK][4], small2[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      split4(*reinterpret_cast<const float4*>(own + (k0 + kk) * kFrag), big[kk], small[kk]);
      if constexpr (TWO) split4(*reinterpret_cast<const float4*>(own2 + (k0 + kk) * kFrag), big2[kk], small2[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int ks = k0 + kk, acc_in = ks > 0;  // k-step ks: 32 bytes into slot ks / 4
      wgmma_3xtf32<N>(acc, big[kk], small[kk], slots + ks / 4 * kSlotBytes + ks % 4 * 32, acc_in);
      if constexpr (TWO)
        wgmma_3xtf32<N>(acc2, big2[kk], small2[kk], slots2 + ks / 4 * kSlotBytes + ks % 4 * 32, acc_in);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    fence_regs<4 * KK>(&big[0][0]);
    fence_regs<4 * KK>(&small[0][0]);
    if constexpr (TWO) {
      fence_regs<N / 2>(acc2);
      fence_regs<4 * KK>(&big2[0][0]);
      fence_regs<4 * KK>(&small2[0][0]);
    }
  }
}

// acc[hh] (columns 64·hh .. of D) += A · the transposed slots at `slots`,
// A the fragments of K8 k-steps (8·K8 of the sequence), K8 / 4 slots a
// column block, column block major.  The tensor cores round each
// accumulation toward zero, so a call's products go to a fresh accumulator
// added to acc in fp32 (tf32x3.cuh's sums, without the ring).
template <int D, int K8>
__device__ __forceinline__ void trans_sums(float (*acc)[32], uint32_t (*big)[4], uint32_t (*small)[4],
                                           uint32_t slots) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
    float part[32];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < K8 / 4; ++kc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_3xtf32<64>(part, big[4 * kc + kk], small[4 * kc + kk],
                         slots + (hh * (K8 / 4) + kc) * kSlotBytes + kk * 32, kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(part);
    fence_regs<4 * K8>(&big[0][0]);
    fence_regs<4 * K8>(&small[0][0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] += part[i];
  }
}

// s (this thread's 32 accumulator scores of query rows row0 and row0 + 8
// against the keys from n0) times scale·log2e, keys the rows do not see at
// -1e30
__device__ __forceinline__ void mask_scores(float (&s)[32], const Params& p, int row0, int n0, int t, float sl2) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * n + e] = visible(p, row0 + 8 * (e >> 1), n0 + 8 * n + 2 * t + (e & 1)) ? s[4 * n + e] * sl2 : kNegInf;
}

// the largest of a row's scores (i 0: row0, 1: row0 + 8), over its quad
__device__ __forceinline__ float row_max(const float (&s)[32], int i) {
  float mx = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
  return quad_max(mx);
}

// K10 in fp32: a block per 64 query rows of one (item, head).  Per 64-key
// tile (one at S <= 64): K as D / 32 natural slots, S = Q.K^T once; then
// the same slots take V as 2 · D / 64 transposed ones while the softmax
// runs online in registers (at one tile: the row max and sum, nothing to
// rescale); O += P.V in a fresh accumulator a tile.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1) attn_small_fwd_f32(const Params p) {
  using L = FwdF32<D>;
  constexpr int KS = D / 32;  // K's natural slots; V^T takes as many (2 key chunks a column block)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const int m0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = (tid % 32) >> 2, t = tid & 3, row0 = m0 + 16 * (tid / 32) + g;
  const long long hb = head_base(p, b, h, D);
  const float* kg = static_cast<const float*>(p.k) + hb;
  const float* vg = static_cast<const float*>(p.v) + hb;
  const unsigned char* own = sbase + L::kOwnAt + tid * 16;
  own_issue<D>(base + L::kOwnAt + tid * 16, static_cast<const float*>(p.q) + hb, p.ld, row0, p.seq, t);
  const int nk = (key_end(p, m0, kF32Rows) + kF32Keys - 1) / kF32Keys;
  const float sl2 = p.scale * kLog2e;

  float o[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in units of scale·log2e
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum
  for (int j = 0; j < nk; ++j) {
    const int n0 = j * kF32Keys;
    if (j > 0) __syncthreads();  // every warp's products are done with the last tile's slots
#pragma unroll
    for (int cc = 0; cc < KS; ++cc)
      slot_issue<kSlotRows>(base + cc * kSlotBytes, SlotSrc{kg, kg, p.ld, p.ld, n0, p.seq, 32 * cc, false}, tid);
    land_slots(sbase, KS, nullptr, 0, tid);

    float s[32];
    own_products<D, 64, false>(s, own, base, nullptr, nullptr, 0);
    __syncthreads();  // every warp's S is done with K: its slots take V^T
#pragma unroll
    for (int i = 0; i < KS; ++i)
      slot_issue<kSlotRows>(base + i * kSlotBytes,
                            SlotSrc{vg, vg, p.ld, p.ld, n0 + 32 * (i % 2), p.seq, 64 * (i / 2), true}, tid);
    mask_scores(s, p, row0, n0, t, sl2);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], row_max(s, i));
      alpha[i] = exp2f(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * i + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
    }
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
    uint32_t big[kF32Keys / 8][4], small[kF32Keys / 8][4];
    acc_frags<kF32Keys / 8>(big, small, s);
    land_slots(nullptr, 0, sbase, KS, tid);
    trans_sums<D, kF32Keys / 8>(o, big, small, base);
  }

  float* og = static_cast<float*>(p.o) + hb;
  const float inv[2] = {1.f / quad_sum(l_run[0]), 1.f / quad_sum(l_run[1])};
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] *= inv[(i >> 1) & 1];
    store_f32(og, p.ld, row0, p.seq, 64 * hh, o[hh], t);
  }
}

// K11's dq in fp32, and each query row's statistics: a block per 64 query
// rows of one (item, head).  Per 64-key tile, K and V as natural slots:
// S = Q.K^T and dP = dO.V^T once each, in one commit group a slot.  At one
// tile (S <= 64) the row's max and sum, P = e / sum, delta = sum_j P dP and
// dS = P (dP - delta) scale come from the registers; past one tile a first
// pass over the key tiles gathers the statistics online.  Once dP is done
// the V slots take K transposed (copied while the softmax runs) for
// dQ += dS.K, a fresh accumulator a tile.  Each row's max (of scale·S),
// sum and delta go to the scratch.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) attn_small_dq_f32(const Params p) {
  using L = DqF32<D>;
  constexpr int KS = D / 32;  // natural slots of a tensor; K^T takes as many (2 key chunks a column block)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t k_at = base, v_at = base + KS * kSlotBytes;  // v_at: V, then K^T
  const int m0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = (tid % 32) >> 2, t = tid & 3, row0 = m0 + 16 * (tid / 32) + g;
  const long long hb = head_base(p, b, h, D);
  const float* kg = static_cast<const float*>(p.k) + hb;
  const float* vg = static_cast<const float*>(p.v) + hb;
  const unsigned char* own_q = sbase + L::kOwnAt + tid * 16;
  const unsigned char* own_do = own_q + L::kOwnTensor;
  own_issue<D>(base + L::kOwnAt + tid * 16, static_cast<const float*>(p.q) + hb, p.ld, row0, p.seq, t);
  own_issue<D>(base + L::kOwnAt + L::kOwnTensor + tid * 16, static_cast<const float*>(p.dout) + hb, p.ld, row0,
               p.seq, t);
  const int nk = (key_end(p, m0, kF32Rows) + kF32Keys - 1) / kF32Keys;
  const float sl2 = p.scale * kLog2e;

  // the key tile at n0: K and V into natural slots, S (scaled by log2e,
  // masked) and dP
  auto scores_dp = [&](float (&s)[32], float (&dp)[32], int n0) {
#pragma unroll
    for (int cc = 0; cc < KS; ++cc) {
      slot_issue<kSlotRows>(k_at + cc * kSlotBytes, SlotSrc{kg, kg, p.ld, p.ld, n0, p.seq, 32 * cc, false}, tid);
      slot_issue<kSlotRows>(v_at + cc * kSlotBytes, SlotSrc{vg, vg, p.ld, p.ld, n0, p.seq, 32 * cc, false}, tid);
    }
    land_slots(sbase, 2 * KS, nullptr, 0, tid);
    own_products<D, 64, true>(s, own_q, k_at, dp, own_do, v_at);
    mask_scores(s, p, row0, n0, t, sl2);
  };

  // per row: its max of S in units of scale·log2e, its sum of exp2(s - max), delta
  float m2[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (nk > 1) {  // the statistics pass: online over the key tiles
    float w_run[2] = {0.f, 0.f};
    for (int j = 0; j < nk; ++j) {
      if (j > 0) __syncthreads();
      float s[32], dp[32];
      scores_dp(s, dp, j * kF32Keys);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m2[i], row_max(s, i));
        const float alpha = exp2f(m2[i] - m_new);
        float l = 0.f, w = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * n + 2 * i + e;
            const float pr = exp2f(s[k] - m_new);
            l += pr;
            w += pr * dp[k];
          }
        sum[i] = sum[i] * alpha + l;
        w_run[i] = w_run[i] * alpha + w;
        m2[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = quad_sum(sum[i]);
      delta[i] = quad_sum(w_run[i]) / sum[i];
    }
    __syncthreads();  // the second pass's copies take the slots
  }

  float dq[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[hh][i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int n0 = j * kF32Keys;
    if (j > 0) __syncthreads();
    float s[32], dp[32];
    scores_dp(s, dp, n0);
    __syncthreads();  // every warp's dP is done with V: its slots take K^T
#pragma unroll
    for (int i = 0; i < KS; ++i)
      slot_issue<kSlotRows>(v_at + i * kSlotBytes,
                            SlotSrc{kg, kg, p.ld, p.ld, n0 + 32 * (i % 2), p.seq, 64 * (i / 2), true}, tid);
    // P = e / sum and dS = P (dP - delta) scale into dp, while K^T lands
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (nk == 1) m2[i] = row_max(s, i);
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * i + e];
          x = exp2f(x - m2[i]);
          l += x;
        }
      if (nk == 1) sum[i] = quad_sum(l);
      const float inv = 1.f / sum[i];
      float w = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * n + 2 * i + e;
          s[k] *= inv;
          w += s[k] * dp[k];
        }
      if (nk == 1) delta[i] = quad_sum(w);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * n + 2 * i + e;
          dp[k] = s[k] * (dp[k] - delta[i]) * p.scale;
        }
    }
    land_slots(nullptr, 0, sbase + KS * kSlotBytes, KS, tid);
    uint32_t big[kF32Keys / 8][4], small[kF32Keys / 8][4];
    acc_frags<kF32Keys / 8>(big, small, dp);
    trans_sums<D, kF32Keys / 8>(dq, big, small, v_at);
  }

  float* dqg = static_cast<float*>(p.o) + hb;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) store_f32(dqg, p.ld, row0, p.seq, 64 * hh, dq[hh], t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.seq) continue;
      float* st = p.stats + ((static_cast<long long>(b) * p.seq + row) * p.heads + h) * 3;
      st[0] = m2[i] * kLn2;
      st[1] = sum[i];
      st[2] = delta[i];
    }
  }
}

// K11's dk and dv in fp32: a block per 64 keys of one (item, head), walking
// 32-query tiles (under causal from the block's first key).  A tile's Q and
// dO rows share D / 32 natural slots (32 rows each) for S^T = K.Q^T and
// dP^T = V.dO^T, each formed once; once those are done the same slots take
// dO^T and Q^T (D / 64 transposed slots each, copied while P^T and dS^T are
// formed by column from the scratch) for dV += P^T.dO and dK += dS^T.Q,
// fresh accumulators a tile.  Reusing the slots, and splitting the own
// rows two k-steps a commit group, keeps a block at 65 KB and at most 168
// registers at head dim 64: three blocks an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1) attn_small_dkv_f32(const Params p) {
  using L = DkvF32<D>;
  constexpr int QN = kF32Queries, KS = D / 32, TS = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const int n0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = (tid % 32) >> 2, t = tid & 3, key0 = n0 + 16 * (tid / 32) + g;
  const long long hb = head_base(p, b, h, D);
  const float* qg = static_cast<const float*>(p.q) + hb;
  const float* dog = static_cast<const float*>(p.dout) + hb;
  const unsigned char* own_k = sbase + L::kOwnAt + tid * 16;
  const unsigned char* own_v = own_k + L::kOwnTensor;
  own_issue<D>(base + L::kOwnAt + tid * 16, static_cast<const float*>(p.k) + hb, p.ld, key0, p.seq, t);
  own_issue<D>(base + L::kOwnAt + L::kOwnTensor + tid * 16, static_cast<const float*>(p.v) + hb, p.ld, key0,
               p.seq, t);
  const float* stats = p.stats + (static_cast<long long>(b) * p.seq * p.heads + h) * 3;

  float dk[D / 64][32], dv[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;
  // under causal no query before this block's first key sees any of its keys
  const int q_first = p.causal ? n0 : 0;
  for (int q0 = q_first; q0 < p.seq; q0 += QN) {
    if (q0 > q_first) __syncthreads();  // every warp is done with the last tile's slots
#pragma unroll
    for (int cc = 0; cc < KS; ++cc)
      slot_issue<QN>(base + cc * kSlotBytes, SlotSrc{qg, dog, p.ld, p.ld, q0, p.seq, 32 * cc, false}, tid);
    land_slots(sbase, KS, nullptr, 0, tid);
    float s[QN / 2], dp[QN / 2];
    own_products<D, QN, true, 2>(s, own_k, base, dp, own_v, base + QN * 128);  // 2 k-steps a group: registers
    __syncthreads();  // every warp's products are done with the natural slots: they take dO^T, Q^T
#pragma unroll
    for (int hh = 0; hh < TS; ++hh) {
      slot_issue<QN>(base + hh * kSlotBytes, SlotSrc{dog, dog, p.ld, p.ld, q0, p.seq, 64 * hh, true}, tid);
      slot_issue<QN>(base + (TS + hh) * kSlotBytes, SlotSrc{qg, qg, p.ld, p.ld, q0, p.seq, 64 * hh, true}, tid);
    }
    // P^T into s and dS^T into dp, the statistics by the accumulator's column (query)
#pragma unroll
    for (int n = 0; n < QN / 8; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int q = q0 + 8 * n + 2 * t + e2;
        const bool in = q < p.seq;
        const float* st = stats + static_cast<long long>(in ? q : 0) * p.heads * 3;
        const float lse = in ? st[0] + logf(st[1]) : 0.f, delta = in ? st[2] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n + 2 * i + e2;
          const bool seen = in && (!p.causal || key0 + 8 * i <= q);
          const float pr = seen ? expf(fmaf(s[e], p.scale, -lse)) : 0.f;
          s[e] = pr;
          dp[e] = pr * (dp[e] - delta) * p.scale;
        }
      }
    land_slots(nullptr, 0, sbase, 2 * TS, tid);
    uint32_t big[QN / 8][4], small[QN / 8][4];
    acc_frags<QN / 8>(big, small, s);
    trans_sums<D, QN / 8>(dv, big, small, base);
    acc_frags<QN / 8>(big, small, dp);
    trans_sums<D, QN / 8>(dk, big, small, base + TS * kSlotBytes);
  }

  float* dkg = static_cast<float*>(p.dk) + hb;
  float* dvg = static_cast<float*>(p.dv) + hb;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
    store_f32(dkg, p.ld, key0, p.seq, 64 * hh, dk[hh], t);
    store_f32(dvg, p.ld, key0, p.seq, 64 * hh, dv[hh], t);
  }
}

// ----------------------------------------------- bf16, one key tile (S <= 64)

constexpr int kOneTile = 64;  // the longest item the one-tile kernels take: one 64-key tile
constexpr int kTileBox = box_bytes<kOneTile>();  // 64 rows x 128 bytes: 8 KB

template <int D>
__host__ __device__ constexpr int onetile_fwd_smem() {
  return 3 * tile_bytes<D, kOneTile>() + 1024;  // Q, K, V; alignment slack
}

template <int D>
__host__ __device__ constexpr int onetile_bwd_smem() {
  return 4 * tile_bytes<D, kOneTile>() + 2 * kTileBox + 1024;  // Q, K, V, dO; P, dS; slack
}

// K10 for one (item, head) of S <= 64: blockIdx.x = item * heads + head
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 3) attn_small_fwd_onetile(const Params p) {
  constexpr int kT = tile_bytes<D, kOneTile>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u, ks = qs + kT, vs = ks + kT;
  const int h = blockIdx.x % p.heads, b = blockIdx.x / p.heads;
  const long long base = head_base(p, b, h, D);
  load_swizzled<D, kOneTile, kThreads>(qs, static_cast<const bf16*>(p.q) + base, p.ld, p.seq, threadIdx.x);
  load_swizzled<D, kOneTile, kThreads>(ks, static_cast<const bf16*>(p.k) + base, p.ld, p.seq, threadIdx.x);
  load_swizzled<D, kOneTile, kThreads>(vs, static_cast<const bf16*>(p.v) + base, p.ld, p.seq, threadIdx.x);
  tiles_landed();

  float s[1][32], mx[2], sum[2];
  wgmma_fence();
  wgmma_abt<D, kOneTile, kOneTile>(s[0], qs, ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s[0]);
  // rows past seq are not written
  softmax_rows(s, p.scale, [&](int row, int col) { return visible(p, row, col); }, kOneTile,
               SharedRows<1>{nullptr}, mx, sum);
  uint32_t pa[4][4];
  pack_a(pa, s[0]);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  fence_regs<D / 2>(o);
  fence_regs<16>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], desc_mnmajor<kOneTile>(vs, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  fence_regs<16>(&pa[0][0]);
  store_acc<D>(static_cast<bf16*>(p.o) + base, o, p.ld, p.seq);
}

// K11 for one (item, head) of S <= 64: dq, dk and dv in one kernel
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2) attn_small_bwd_onetile(const Params p) {
  constexpr int kT = tile_bytes<D, kOneTile>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u, ks = qs + kT, vs = ks + kT, dos = vs + kT;
  const uint32_t ps = dos + kT, dss = ps + kTileBox;
  const int h = blockIdx.x % p.heads, b = blockIdx.x / p.heads;
  const long long base = head_base(p, b, h, D);
  load_swizzled<D, kOneTile, kThreads>(qs, static_cast<const bf16*>(p.q) + base, p.ld, p.seq, threadIdx.x);
  load_swizzled<D, kOneTile, kThreads>(ks, static_cast<const bf16*>(p.k) + base, p.ld, p.seq, threadIdx.x);
  load_swizzled<D, kOneTile, kThreads>(vs, static_cast<const bf16*>(p.v) + base, p.ld, p.seq, threadIdx.x);
  load_swizzled<D, kOneTile, kThreads>(dos, static_cast<const bf16*>(p.dout) + base, p.ld, p.seq, threadIdx.x);
  tiles_landed();

  // S = Q.K^T and dP = dO.V^T in one commit group
  float s1[1][32], dp[32], mx[2], sum[2];
  float(&s)[32] = s1[0];
  wgmma_fence();
  wgmma_abt<D, kOneTile, kOneTile>(s, qs, ks);
  wgmma_abt<D, kOneTile, kOneTile>(dp, dos, vs);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
  fence_regs<32>(dp);
  // P = 0 on rows past seq: they add nothing to dK, dV
  softmax_rows(s1, p.scale, [&](int row, int col) { return visible(p, row, col); }, p.seq,
               SharedRows<1>{nullptr}, mx, sum);
  // ds = P (dp - delta) scale, delta = sum_j dp P on the fp32 P
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float dl = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) dl += s[4 * n + 2 * i] * dp[4 * n + 2 * i] + s[4 * n + 2 * i + 1] * dp[4 * n + 2 * i + 1];
    const float delta = quad_sum(dl);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * n + 2 * i + e;
        dp[j] = s[j] * (dp[j] - delta) * p.scale;
      }
  }
  // round(P) and round(dS) into swizzled tiles for the transposed products,
  // round(dS) as the A fragments of dQ
  store_swizzled(ps, s);
  store_swizzled(dss, dp);
  uint32_t da[4][4];
  pack_a(da, dp);
  fence_proxy_async();
  __syncthreads();

  // dQ = dS.K (K MN-major: keys are the depth) and dV = P^T.dO
  float dq[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  fence_regs<D / 2>(dq);
  fence_regs<16>(&da[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, da[kk], desc_mnmajor<kOneTile>(ks, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_mn<D>(dv, desc_mnmajor<kOneTile>(ps, kk), desc_mnmajor<kOneTile>(dos, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(dq);
  fence_regs<D / 2>(dv);
  fence_regs<16>(&da[0][0]);
  store_acc<D>(static_cast<bf16*>(p.o) + base, dq, p.ld, p.seq);
  store_acc<D>(static_cast<bf16*>(p.dv) + base, dv, p.ld, p.seq);

  // dK = dS^T.Q
  float dk[D / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_mn<D>(dk, desc_mnmajor<kOneTile>(dss, kk), desc_mnmajor<kOneTile>(qs, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(dk);
  store_acc<D>(static_cast<bf16*>(p.dk) + base, dk, p.ld, p.seq);
}

// -------------------------------------------- bf16, S > 64: tiled, wgmma
//
// Every product a wgmma: S and dP (and the dk/dv kernel's S^T and dP^T)
// from shared memory, both operands K-major; P, dS and their transposes as
// A fragments from the accumulators, against V, K, dO or Q read MN-major.
// Q, K, V and dO tiles of 64 rows come by 16-byte cp.async into the
// 128-byte-swizzled tiles of attention_tiles.cuh, one tile of D columns a
// 64-row block of one (item, head).  Scores are in units of scale·log2e
// (exp2); each row's max, sum and delta are combined across a block's
// warpgroups through shared memory in warpgroup order, and the warpgroups'
// partial outputs are added in warpgroup order: no atomics, so both
// launches of K11 are bit-identical from call to call.
//
// The rule on the shape: a warpgroup holds one 64 x 64 score tile (and dP
// tile) a key tile it owns, so a block holds the scores of a resident
// number of keys in registers: kFwdResidentKeys for the forward (two
// warpgroups of two tiles); for dq kDqResidentKeys (four warpgroups of
// one) at head dim 64 for items of at most kLongItem tokens, else
// kDqResidentKeysLong (two).  A query tile that sees at most that many
// keys (all S of them, or under causal those up to its last row) forms
// its scores once, with the exact max and sum from the registers.  A
// longer one walks its keys in chunks of that many twice: a first sweep
// gathers each row's max and sum (dq: and sum_j e dp) online, the second
// forms P = e / sum with them.  Either way P is the exact e / sum of
// head_fwd before it is rounded.  Items of more than kLongItem tokens take
// builds of the same kernels with that second sweep (template argument
// LONG): they hold its running sums beside the scores, so they run fewer
// warpgroups an SM and may use more registers; items up to kLongItem, the
// vit_small --patch-size 2 paths', take builds without it.
//
// What bounds them at vit_small --patch-size 2's train shape (B 128, S 256,
// 6 heads of 64): bytes.  The forward moves 100.7 MB (0.030 ms at 3.35
// TB/s) against 12.9 GFLOP (0.013 ms at 989 TFLOP/s), the backward 176.2 MB
// (0.053 ms) against 32.2 GFLOP; both also run an exp and a handful of FMAs
// per score on the CUDA cores, as much work again as the products.  So
// each block reads its operands once, forms each product once, keeps
// several warpgroups an SM in flight and lets copies land under products:
// - attn_small_fwd_bf16: a block per 64 query rows of an (item, head), two
//   warpgroups splitting the key tiles (tile j to warpgroup j % 2).  Q and
//   K come in one cp.async group and V in a second that lands under
//   S = Q.K^T; O = P.V with P from registers; the two O partials added
//   through shared memory over K's tiles.  74 KB at D 64: two blocks an SM.
// - attn_small_dq_bf16: one warpgroup a key tile, the block persistent over
//   the (item, head, 64-query tile) tiles with two stages of Q, dO, K and V,
//   so the next tile's copies land under this one's products.  S and dP once
//   a key tile; P, delta = sum_j dp P and dS = P (dp - delta) scale from the
//   registers; dQ = round(dS).K; each row's max (of scale·S), sum and delta
//   into the scratch.
// - attn_small_dkv_bf16: one warpgroup a block owns 64 keys (its K and V
//   once) and streams the query tiles with their statistics through a
//   two-stage ring; S^T = K.Q^T and dP^T = V.dO^T by wgmma, P^T and dS^T in
//   registers, dV += round(P^T).dO and dK += round(dS^T).Q, a 32-query
//   half at a time.  67.5 KB at D 64, three blocks an SM: dK is summed a
//   half at a time in shared memory there, which keeps 168 registers
//   enough (at D 128, two blocks an SM, dK in registers).

constexpr int kTileRows = 64;             // rows of a query or key tile: wgmma M, one swizzled tile
constexpr int kLongItem = 256;            // items past it take the LONG builds
constexpr int kFwdResidentKeys = 256;     // keys whose scores a forward block holds
constexpr int kDqResidentKeys = 256;      // keys whose S and dP a dq block holds: head dim 64, items to kLongItem
constexpr int kDqResidentKeysLong = 128;  // ... otherwise
constexpr int kFwdWarpgroups = 2;

// 2^x on the multi-function unit, subnormal results flushed to 0: a P term
// below 2^-126 of its row's largest (exp2f adds a rescale for those)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// this thread's 32 scores of a 64 x 64 tile (query rows from row0, keys from
// key0) times scale·log2e; keys a row does not see at -1e30.  A tile whose
// keys every row sees (inside the item, and under causal none past the
// tile's first row) takes no test.
__device__ __forceinline__ void mask_tile(float (&s)[32], const Params& p, int row0, int key0, float sl2) {
  if (key0 + kTileRows <= p.seq && (!p.causal || key0 + kTileRows - 1 <= row0)) {
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] *= sl2;
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * i + e];
        x = visible(p, row0 + acc_row(i), key0 + acc_col(n, e)) ? x * sl2 : kNegInf;
      }
}

// the largest of this thread's scores of row i (0: its first, 1: its
// second) over NT tiles, not yet over the quad
template <int NT>
__device__ __forceinline__ float own_row_max(const float (&s)[NT][32], int i) {
  float m = kNegInf;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) m = fmaxf(m, fmaxf(s[j][4 * n + 2 * i], s[j][4 * n + 2 * i + 1]));
  return m;
}

// s <- exp2(s - m[row]) over NT tiles; returns this thread's share of each row's sum
template <int NT>
__device__ __forceinline__ void exp_rows(float (&s)[NT][32], const float (&m)[2], float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * n + 2 * i + e];
          x = ex2(x - m[i]);
          sum[i] += x;
        }
  }
}

// s <- s / sum[row], correctly rounded (div_by)
template <int NT>
__device__ __forceinline__ void normalize_rows(float (&s)[NT][32], const float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float r = 1.f / sum[i];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * n + 2 * i + e];
          x = div_by(x, sum[i], r);
        }
  }
}

// rows [row0, row0 + 64) of one head's column slice at g (row stride ld)
// into a swizzled 64-row tile by the block's THREADS threads; rows at or
// past seq zero-filled
template <int D, int THREADS>
__device__ __forceinline__ void load_tile64(uint32_t tile, const bf16* g, long long ld, int row0, int seq, int tid) {
  load_swizzled<D, kTileRows, THREADS>(tile, g + row0 * ld, ld, seq - row0, tid);
}

template <int D>
struct TiledFwd {
  static constexpr int kTile = tile_bytes<D, kTileRows>();
  static constexpr int kChunk = kFwdResidentKeys / kTileRows;  // key tiles a chunk: 4
  static constexpr int kEach = kChunk / kFwdWarpgroups;        // of them a warpgroup's: 2
  // dynamic shared memory for items of seq tokens: Q, then K and V of a
  // chunk (as many tiles as the item has, up to kChunk), the row exchange
  // (2 slots), alignment slack; the O partial of the second warpgroup
  // lands over K's tiles (at least two: S > 64)
  __host__ __device__ static constexpr int bytes(int seq) {
    return (1 + 2 * (seq > kFwdResidentKeys ? kChunk : (seq + kTileRows - 1) / kTileRows)) * kTile +
           2 * kFwdWarpgroups * 64 * 4 + 1024;
  }
};

// K10 in bf16 past one key tile: the 64 query rows [64 blockIdx.x, + 64) of
// item blockIdx.z, head blockIdx.y, against every key they see.  The key
// tiles of a chunk go to the two warpgroups in turn (tile j to j % 2), so
// that under causal the tiles a query tile sees are split evenly.  The
// LONG build (items past kLongItem) sweeps the keys twice where a query
// tile sees more than kFwdResidentKeys of them.
template <int D, bool LONG>
__global__ void __launch_bounds__(kWarpgroup * kFwdWarpgroups, D == 64 && !LONG ? 2 : 1) attn_small_fwd_bf16(const Params p) {
  using L = TiledFwd<D>;
  constexpr int WG = kFwdWarpgroups, NT = L::kEach, CK = L::kChunk, kT = L::kTile, kAll = kWarpgroup * WG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const int ct = min(CK, (p.seq + kTileRows - 1) / kTileRows);  // K (and V) tiles held
  const uint32_t qs = (raw + 1023) & ~1023u, ks = qs + kT, vs = ks + ct * kT;
  float* red = reinterpret_cast<float*>(smem_raw + (vs + ct * kT - raw));
  float* part = reinterpret_cast<float*>(smem_raw + (ks - raw));
  const int m0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, w = tid / kWarpgroup;
  const long long hb = head_base(p, b, h, D);
  const bf16* kg = static_cast<const bf16*>(p.k) + hb;
  const bf16* vg = static_cast<const bf16*>(p.v) + hb;
  const int nkt = (key_end(p, m0, kTileRows) + kTileRows - 1) / kTileRows;  // key tiles the rows see
  const int nch = (nkt + CK - 1) / CK;
  const float sl2 = p.scale * kLog2e;
  const SharedRows<WG> rows{red};

  // chunk c's key tiles below nkt (no more than ct) into K's (and V's) tiles
  auto load_chunk = [&](int c, bool keys, bool values) {
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int t = c * CK + j;
      if (t >= nkt) break;
      if (keys) load_tile64<D, kAll>(ks + j * kT, kg, p.ld, t * kTileRows, p.seq, tid);
      if (values) load_tile64<D, kAll>(vs + j * kT, vg, p.ld, t * kTileRows, p.seq, tid);
    }
  };
  // this warpgroup's tiles of chunk c (chunk tile w + WG i): S = Q.K^T,
  // masked and scaled; a tile past nkt all -1e30
  float s[NT][32];
  auto scores = [&](int c) {
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (c * CK + w + WG * i < nkt) wgmma_abt<D, kTileRows, kTileRows>(s[i], qs, ks + (w + WG * i) * kT);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      fence_regs<32>(s[i]);
      const int t = c * CK + w + WG * i;
      if (t < nkt) {
        mask_tile(s[i], p, m0, t * kTileRows, sl2);
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) s[i][k] = kNegInf;
      }
    }
  };
  // O += round(P).V over this warpgroup's tiles of chunk c
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  auto pv = [&](int c) {
    uint32_t pa[NT][4][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) pack_a(pa[i], s[i]);
    fence_regs<D / 2>(o);
    fence_regs<16 * NT>(&pa[0][0][0]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (c * CK + w + WG * i < nkt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[i][kk], desc_mnmajor<kTileRows>(vs + (w + WG * i) * kT, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<16 * NT>(&pa[0][0][0]);
  };

  float mx[2], sum[2];
  // past kFwdResidentKeys keys (LONG): two sweeps over the chunks
  auto sweep_twice = [&]() {
    // first sweep: each row's max and sum online over the chunks
    float l[2] = {0.f, 0.f};
    mx[0] = mx[1] = kNegInf;
    for (int c = 0; c < nch; ++c) {
      if (c > 0) {
        __syncthreads();  // every warpgroup's S is done with the last chunk's K
        load_chunk(c, true, false);
        tiles_landed<0>();
      }
      scores(c);
      float cm[2] = {quad_max(own_row_max(s, 0)), quad_max(own_row_max(s, 1))};
      rows.template combine<true>(cm, 0);
      float add[2];
      const float m_new[2] = {fmaxf(mx[0], cm[0]), fmaxf(mx[1], cm[1])};
      exp_rows(s, m_new, add);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * ex2(mx[i] - m_new[i]) + add[i];
        mx[i] = m_new[i];
      }
    }
    sum[0] = quad_sum(l[0]);
    sum[1] = quad_sum(l[1]);
    rows.template combine<false>(sum, 1);
    // second sweep: P = e / sum, O += round(P).V a chunk at a time
    for (int c = 0; c < nch; ++c) {
      __syncthreads();  // every warpgroup is done with the last chunk's K and V
      load_chunk(c, true, true);
      tiles_landed<0>();
      scores(c);
      float ignored[2];
      exp_rows(s, mx, ignored);
      normalize_rows(s, sum);
      pv(c);
    }
  };
  load_tile64<D, kAll>(qs, static_cast<const bf16*>(p.q) + hb, p.ld, m0, p.seq, tid);
  load_chunk(0, true, false);
  cp_async_commit();
  if (nch == 1) load_chunk(0, false, true);  // V lands under S
  tiles_landed<1>();
  bool swept = false;
  if constexpr (LONG) {
    if (nch > 1) {
      swept = true;
      sweep_twice();
    }
  }
  if (!swept) {
    // the scores once: the row's max and sum over its whole key set
    scores(0);
    mx[0] = quad_max(own_row_max(s, 0));
    mx[1] = quad_max(own_row_max(s, 1));
    rows.template combine<true>(mx, 0);
    exp_rows(s, mx, sum);
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    rows.template combine<false>(sum, 1);
    normalize_rows(s, sum);
    tiles_landed<0>();  // V
    pv(0);
  }
  __syncthreads();  // every warpgroup's S is done with K: the O partial lands there
  sum_partials<WG, D / 2>(o, part);
  if (w == 0) store_acc<D>(static_cast<bf16*>(p.o) + hb + static_cast<long long>(m0) * p.ld, o, p.ld, p.seq - m0);
}

template <int D, bool LONG>
struct TiledDq {
  static constexpr int kResident = D == 64 && !LONG ? kDqResidentKeys : kDqResidentKeysLong;
  static constexpr bool kTwoSweeps = LONG || kResident < kLongItem;  // a query tile may see more keys
  static constexpr int kWarpgroups = kResident / kTileRows;
  static constexpr int kThreads = kWarpgroup * kWarpgroups;
  static constexpr int kTile = tile_bytes<D, kTileRows>();
  static constexpr int kStage = (2 + 2 * kWarpgroups) * kTile;  // Q, dO; K and V of a chunk
  // the row exchange (3 slots), the dQ partials of warpgroups past the first, alignment slack
  static constexpr int kRest = 3 * kWarpgroups * 64 * 4 + (kWarpgroups - 1) * (D / 2) * kWarpgroup * 4 + 1024;
  static constexpr int kBytes = 2 * kStage + kRest;
  static_assert(kBytes <= 227 * 1024, "two stages fit");
};

// K11's dq in bf16 past one key tile, and each query row's statistics: the
// block persistent over the tiles u = blockIdx.x, + gridDim.x, ... (tile u:
// query tile u % nq of head u / nq % heads of item u / (nq heads)), the next
// tile's Q, dO and first chunk of K and V copied into the other stage while
// this one's products run.  Warpgroup w owns key tile w of each chunk.
template <int D, bool LONG>
__global__ void __launch_bounds__(D == 64 && !LONG ? 512 : 256, 1) attn_small_dq_bf16(const Params p, int tiles) {
  using L = TiledDq<D, LONG>;
  constexpr int WG = L::kWarpgroups, kT = L::kTile, kAll = L::kThreads;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base + 2 * L::kStage - raw));
  float* part = red + 3 * WG * 64;
  const int tid = threadIdx.x, w = tid / kWarpgroup, nq = (p.seq + kTileRows - 1) / kTileRows;
  const float sl2 = p.scale * kLog2e;
  const SharedRows<WG> rows{red};
  const bf16* const q = static_cast<const bf16*>(p.q);
  const bf16* const dout = static_cast<const bf16*>(p.dout);
  const bf16* const kg0 = static_cast<const bf16*>(p.k);
  const bf16* const vg0 = static_cast<const bf16*>(p.v);

  // K and V tiles of chunk c (those below the key end) of the tile at head base hb
  auto issue_kv = [&](long long hb, int nkt, int c, uint32_t st) {
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      const int t = c * WG + j;
      if (t >= nkt) break;
      load_tile64<D, kAll>(st + (2 + j) * kT, kg0 + hb, p.ld, t * kTileRows, p.seq, tid);
      load_tile64<D, kAll>(st + (2 + WG + j) * kT, vg0 + hb, p.ld, t * kTileRows, p.seq, tid);
    }
  };
  auto head_of = [&](int u) { return head_base(p, u / nq / p.heads, u / nq % p.heads, D); };
  auto key_tiles = [&](int u) { return (key_end(p, u % nq * kTileRows, kTileRows) + kTileRows - 1) / kTileRows; };
  // tile u's Q, dO and first chunk into stage st, one commit group
  auto issue = [&](int u, uint32_t st) {
    const long long hb = head_of(u);
    const int m0 = u % nq * kTileRows;
    load_tile64<D, kAll>(st, q + hb, p.ld, m0, p.seq, tid);
    load_tile64<D, kAll>(st + kT, dout + hb, p.ld, m0, p.seq, tid);
    issue_kv(hb, key_tiles(u), 0, st);
    cp_async_commit();
  };

  int u = blockIdx.x;
  if (u < tiles) issue(u, base);
#pragma unroll 1
  for (int it = 0; u < tiles; ++it, u += gridDim.x) {
    const uint32_t st = base + (it & 1) * L::kStage;
    if (u + static_cast<int>(gridDim.x) < tiles) {
      issue(u + gridDim.x, base + ((it + 1) & 1) * L::kStage);  // the stage the last tile freed
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const long long hb = head_of(u);
    const int m0 = u % nq * kTileRows, nkt = key_tiles(u), nch = (nkt + WG - 1) / WG;
    const uint32_t qs = st, dos = st + kT, kw = st + (2 + w) * kT, vw = st + (2 + WG + w) * kT;

    // this warpgroup's key tile of chunk c: S (scaled, masked) and dP, or
    // -1e30 and 0 past the key end
    float s[1][32], dp[32];
    auto sdp = [&](int c) {
      const int t = c * WG + w;
      if (t < nkt) {
        wgmma_fence();
        wgmma_abt<D, kTileRows, kTileRows>(s[0], qs, kw);
        wgmma_abt<D, kTileRows, kTileRows>(dp, dos, vw);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(s[0]);
        fence_regs<32>(dp);
        mask_tile(s[0], p, m0, t * kTileRows, sl2);
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) s[0][k] = kNegInf, dp[k] = 0.f;
      }
    };
    // chunk c > 0, or chunk 0 again, into this tile's stage
    auto reload = [&](int c) {
      __syncthreads();  // every warpgroup is done with the stage's K and V
      issue_kv(hb, nkt, c, st);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    };
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    // dQ += round(P (dP - delta) scale).K over this warpgroup's tile of chunk c (s holds P)
    float mx[2], sum[2], delta[2];
    auto dq_step = [&](int c) {
      if (c * WG + w >= nkt) return;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * n + 2 * i + e;
            dp[k] = s[0][k] * (dp[k] - delta[i]) * p.scale;
          }
      uint32_t da[4][4];
      pack_a(da, dp);
      fence_regs<D / 2>(dq);
      fence_regs<16>(&da[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, da[kk], desc_mnmajor<kTileRows>(kw, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
      fence_regs<16>(&da[0][0]);
    };

    // past the resident keys: two sweeps over the chunks
    auto sweep_twice = [&]() {
      // first sweep: each row's max, sum and sum_j e dp online over the chunks
      float l[2] = {0.f, 0.f}, wsum[2] = {0.f, 0.f};
      mx[0] = mx[1] = kNegInf;
      for (int c = 0; c < nch; ++c) {
        if (c > 0) reload(c);
        sdp(c);
        float cm[2] = {quad_max(own_row_max(s, 0)), quad_max(own_row_max(s, 1))};
        rows.template combine<true>(cm, 0);
        const float m_new[2] = {fmaxf(mx[0], cm[0]), fmaxf(mx[1], cm[1])};
        float add[2];
        exp_rows(s, m_new, add);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) x += s[0][4 * n + 2 * i] * dp[4 * n + 2 * i] + s[0][4 * n + 2 * i + 1] * dp[4 * n + 2 * i + 1];
          const float alpha = ex2(mx[i] - m_new[i]);
          l[i] = l[i] * alpha + add[i];
          wsum[i] = wsum[i] * alpha + x;
          mx[i] = m_new[i];
        }
      }
      sum[0] = quad_sum(l[0]);
      sum[1] = quad_sum(l[1]);
      rows.template combine<false>(sum, 1);
      delta[0] = quad_sum(wsum[0]);
      delta[1] = quad_sum(wsum[1]);
      rows.template combine<false>(delta, 2);
      delta[0] /= sum[0];
      delta[1] /= sum[1];
      // second sweep: P = e / sum, dS and dQ a chunk at a time
      for (int c = 0; c < nch; ++c) {
        reload(c);
        sdp(c);
        float ignored[2];
        exp_rows(s, mx, ignored);
        normalize_rows(s, sum);
        dq_step(c);
      }
    };
    bool swept = false;
    if constexpr (L::kTwoSweeps) {
      if (nch > 1) {
        swept = true;
        sweep_twice();
      }
    }
    if (!swept) {
      // S and dP once: the statistics from the registers
      sdp(0);
      mx[0] = quad_max(own_row_max(s, 0));
      mx[1] = quad_max(own_row_max(s, 1));
      rows.template combine<true>(mx, 0);
      exp_rows(s, mx, sum);
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
      rows.template combine<false>(sum, 1);
      normalize_rows(s, sum);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) x += s[0][4 * n + 2 * i] * dp[4 * n + 2 * i] + s[0][4 * n + 2 * i + 1] * dp[4 * n + 2 * i + 1];
        delta[i] = quad_sum(x);
      }
      rows.template combine<false>(delta, 2);
      dq_step(0);
    }
    // the barrier in sum_partials: after it no warp reads this tile's stage,
    // so the next iteration's issue may refill it
    sum_partials<WG, D / 2>(dq, part);
    if (w == 0) {
      store_acc<D>(static_cast<bf16*>(p.o) + hb + static_cast<long long>(m0) * p.ld, dq, p.ld, p.seq - m0);
      if (tid % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + acc_row(i);
          if (row >= p.seq) continue;
          float* o = p.stats + ((static_cast<long long>(u / nq / p.heads) * p.seq + row) * p.heads + u / nq % p.heads) * 3;
          o[0] = mx[i] * kLn2;
          o[1] = sum[i];
          o[2] = delta[i];
        }
      }
    }
  }
}

// D (fp32, 64 x 32) += A (bf16, 64 x 16) · B (bf16, 16 x 32), both K-major
// in shared memory; acc 0 overwrites D.  d[4n + 2i + e] is row 16·warp +
// g + 8i, column 8n + 2t + e (n < 4), as hopper_common.cuh's wider forms.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <int D>
struct TiledDkv {
  static constexpr int kTile = tile_bytes<D, kTileRows>();
  static constexpr int kStats = kTileRows * 3 * 4;  // a query tile's (max, sum, delta) as the scratch holds them
  // S^T and dP^T a 32-query half of a query tile at a time (wgmma N 32).
  // Head dim 64: dK summed a half at a time into shared memory in fp32 (each
  // thread its own elements), so that three blocks an SM hold their
  // registers (168 a thread) with no spill; whole 64-query products, or dK
  // in registers, spilled there.  Head dim 128: two blocks an SM, dK in
  // registers.
  static constexpr bool kDkShared = D == 64;
  static constexpr int kQueries = 32;  // queries a product of S^T (wgmma N)
  // K, V; two stages of Q and dO; two of statistics; the statistics as
  // float4 (max·log2e, sum, 1 / sum, delta); dK's sum; alignment slack
  static constexpr int kBytes =
      2 * kTile + 4 * kTile + 2 * kStats + kTileRows * 16 + (kDkShared ? D / 2 * kWarpgroup * 4 : 0) + 1024;
};

// K11's dk and dv in bf16 past one key tile: the 64 keys [64 blockIdx.x,
// + 64) of item blockIdx.z, head blockIdx.y, in the transposed frame (rows
// keys, columns queries), one warpgroup.  The query tiles (under causal from
// the block's first key) stream through two stages with their statistics:
// tile i + 1's copies are in flight while tile i's products run.
template <int D>
__global__ void __launch_bounds__(kWarpgroup, D == 64 ? 3 : 2) attn_small_dkv_bf16(const Params p) {
  using L = TiledDkv<D>;
  constexpr int kT = L::kTile, QW = L::kQueries, NH = kTileRows / QW, KS = QW / 16;
  constexpr bool kDkShared = L::kDkShared;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + kT, ring = vs + kT;  // stage i: Q at ring + 2 i kT, dO after it
  float* raw_stats = reinterpret_cast<float*>(smem_raw + (ring + 4 * kT - raw));
  float4* st = reinterpret_cast<float4*>(raw_stats + 2 * kTileRows * 3);
  float* dk_sum = reinterpret_cast<float*>(st + kTileRows) + threadIdx.x;  // element r at dk_sum[r 128]
  const int n0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long hb = head_base(p, b, h, D);
  const bf16* qg = static_cast<const bf16*>(p.q) + hb;
  const bf16* dog = static_cast<const bf16*>(p.dout) + hb;
  const float* stats = p.stats + (static_cast<long long>(b) * p.seq * p.heads + h) * 3;
  const float sl2 = p.scale * kLog2e;
  const int q_first = p.causal ? n0 : 0;  // under causal no query before the block's first key sees its keys
  const int nt = (p.seq - q_first + kTileRows - 1) / kTileRows;

  // query tile i with its statistics into stage i % 2, one commit group
  auto issue = [&](int i) {
    const int q0 = q_first + i * kTileRows;
    const uint32_t qs = ring + (i & 1) * 2 * kT;
    load_tile64<D, kWarpgroup>(qs, qg, p.ld, q0, p.seq, tid);
    load_tile64<D, kWarpgroup>(qs + kT, dog, p.ld, q0, p.seq, tid);
    const uint32_t dst = smem_u32(raw_stats + (i & 1) * kTileRows * 3);
    for (int e = tid; e < kTileRows * 3; e += kWarpgroup) {
      const int r = e / 3;
      const bool in = q0 + r < p.seq;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4 * e),
                   "l"(stats + (in ? static_cast<long long>(q0 + r) * p.heads * 3 + e % 3 : 0)), "r"(in ? 4 : 0)
                   : "memory");
    }
    cp_async_commit();
  };
  load_tile64<D, kWarpgroup>(ks, static_cast<const bf16*>(p.k) + hb, p.ld, n0, p.seq, tid);
  load_tile64<D, kWarpgroup>(vs, static_cast<const bf16*>(p.v) + hb, p.ld, n0, p.seq, tid);
  issue(0);  // one group with K and V

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if constexpr (kDkShared) {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk_sum[r * kWarpgroup] = 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {
      issue(i + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    // a query past S (its Q and dO rows zero) takes max 0, sum 1 and delta
    // 0: its P^T and dS^T terms are finite and meet zero rows of dO and Q
    if (tid < kTileRows) {
      const float* r = raw_stats + (i & 1) * kTileRows * 3 + 3 * tid;
      st[tid] = q_first + i * kTileRows + tid < p.seq ? make_float4(r[0] * kLog2e, r[1], 1.f / r[1], r[2])
                                                      : make_float4(0.f, 1.f, 1.f, 0.f);
    }
    __syncthreads();
    const int q0 = q_first + i * kTileRows;
    const uint32_t qs = ring + (i & 1) * 2 * kT;  // Q, then dO at qs + kT
    // keys past S compute rows of dK and dV that are not stored, queries
    // past S meet zero rows: only causal keys after a query need a mask,
    // in the tile on the diagonal
    const bool masked = p.causal && q0 < n0 + kTileRows - 1;
    // S^T = K.Q^T and dP^T = V.dO^T of the tile's queries [QW h, QW h + QW):
    // wgmma N QW, both operands K-major, one commit group
    float sc[QW / 2], dp[QW / 2];
    auto sdp_t = [&](int h) {
      const uint32_t q_at = qs + h * QW * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n32k16_ss(sc, desc_kmajor<kTileRows>(ks, kk), desc_kmajor<kTileRows>(q_at, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n32k16_ss(dp, desc_kmajor<kTileRows>(vs, kk), desc_kmajor<kTileRows>(q_at + kT, kk), kk > 0);
      wgmma_commit();
    };
    sdp_t(0);
    wgmma_wait<0>();
    fence_regs<QW / 2>(sc);
    fence_regs<QW / 2>(dp);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      // P^T = exp2(s scale log2e - max) / sum and dS^T = P^T (dP^T - delta)
      // scale, the statistics by the accumulator's column (query), each
      // 16-query k-step rounded into its A fragments
      uint32_t pa[KS][4], da[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n = 2 * kk; n < 2 * kk + 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = QW * h + acc_col(n, e), qr = q0 + c;
            const float4 t = st[c];  // max·log2e, sum, 1 / sum, delta
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int k = 4 * n + 2 * r + e;
              float pr = div_by(ex2(sc[k] * sl2 - t.x), t.y, t.z);
              if (masked && n0 + acc_row(r) > qr) pr = 0.f;
              sc[k] = pr;
              dp[k] = pr * (dp[k] - t.w) * p.scale;
            }
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = pack_f32_to_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
          da[kk][j] = pack_f32_to_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
        }
      }
      // dV += round(P^T).dO and dK += round(dS^T).Q over the k-steps (dO
      // and Q MN-major).  With dK in shared memory the products go to a
      // fresh accumulator added there, and the next half's S^T and dP^T
      // follow the add (registers); otherwise they follow in the next
      // commit group.
      if constexpr (kDkShared) {
#pragma unroll
        for (int r = 0; r < D / 2; ++r) dk[r] = 0.f;
      }
      fence_regs<D / 2>(dk);
      fence_regs<D / 2>(dv);
      fence_regs<4 * KS>(&pa[0][0]);
      fence_regs<4 * KS>(&da[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wgmma_rs<D>(dv, pa[kk], desc_mnmajor<kTileRows>(qs + kT, KS * h + kk));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wgmma_rs<D>(dk, da[kk], desc_mnmajor<kTileRows>(qs, KS * h + kk));
      wgmma_commit();
      if (!kDkShared && h + 1 < NH) sdp_t(h + 1);
      wgmma_wait<0>();
      fence_regs<D / 2>(dk);
      fence_regs<D / 2>(dv);
      fence_regs<4 * KS>(&pa[0][0]);
      fence_regs<4 * KS>(&da[0][0]);
      if constexpr (kDkShared) {
#pragma unroll
        for (int r = 0; r < D / 2; ++r) dk_sum[r * kWarpgroup] += dk[r];
        if (h + 1 < NH) {
          sdp_t(h + 1);
          wgmma_wait<0>();
        }
      }
      if (h + 1 < NH) {
        fence_regs<QW / 2>(sc);
        fence_regs<QW / 2>(dp);
      }
    }
    __syncthreads();  // every warp is done with stage i % 2 and the float4 statistics: tile i + 2 refills them
  }
  if constexpr (kDkShared) {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk[r] = dk_sum[r * kWarpgroup];
  }
  bf16* dkg = static_cast<bf16*>(p.dk) + hb + static_cast<long long>(n0) * p.ld;
  bf16* dvg = static_cast<bf16*>(p.dv) + hb + static_cast<long long>(n0) * p.ld;
  store_acc<D>(dkg, dk, p.ld, p.seq - n0);
  store_acc<D>(dvg, dv, p.ld, p.seq - n0);
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the rule on S (see the header): one key tile in bf16 takes the one-tile kernels
bool one_tile(const Params& p, int is_bf16) { return is_bf16 && p.seq <= kOneTile; }

// the tiled bf16 forward (S > kOneTile): a block per 64 query rows
template <int D, bool LONG>
cudaError_t launch_fwd_tiled(const Params& p, int batch, cudaStream_t s) {
  const int smem = TiledFwd<D>::bytes(p.seq);
  const cudaError_t err =
      cudaFuncSetAttribute(attn_small_fwd_bf16<D, LONG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTileRows - 1) / kTileRows, p.heads, batch);
  attn_small_fwd_bf16<D, LONG><<<grid, kWarpgroup * kFwdWarpgroups, smem, s>>>(p);
  return cudaGetLastError();
}

// the tiled bf16 backward (S > kOneTile): the dq kernel, persistent with a
// block an SM, then the dk/dv kernel, a block per 64 keys of an (item, head)
template <int D, bool LONG>
cudaError_t launch_bwd_tiled(const Params& p, int batch, cudaStream_t s) {
  using Dq = TiledDq<D, LONG>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_small_dq_bf16<D, LONG>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_small_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TiledDkv<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int nq = (p.seq + kTileRows - 1) / kTileRows, tiles = nq * p.heads * batch;
  attn_small_dq_bf16<D, LONG><<<min(tiles, sms), Dq::kThreads, Dq::kBytes, s>>>(p, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_small_dkv_bf16<D><<<dim3(nq, p.heads, batch), kWarpgroup, TiledDkv<D>::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const Params& p, int batch, int is_bf16, cudaStream_t s) {
  if (one_tile(p, is_bf16))
    return launch(attn_small_fwd_onetile<D>, dim3(batch * p.heads), onetile_fwd_smem<D>(), s, p);
  if (is_bf16) return p.seq > kLongItem ? launch_fwd_tiled<D, true>(p, batch, s) : launch_fwd_tiled<D, false>(p, batch, s);
  const dim3 grid((p.seq + kF32Rows - 1) / kF32Rows, p.heads, batch);
  return launch(attn_small_fwd_f32<D>, grid, FwdF32<D>::kBytes, s, p);
}

template <int D>
cudaError_t launch_bwd(const Params& p, int batch, int is_bf16, cudaStream_t s) {
  if (one_tile(p, is_bf16))
    return launch(attn_small_bwd_onetile<D>, dim3(batch * p.heads), onetile_bwd_smem<D>(), s, p);
  if (p.stats == nullptr) return cudaErrorInvalidValue;  // the tiled and fp32 kernels need it
  if (is_bf16) return p.seq > kLongItem ? launch_bwd_tiled<D, true>(p, batch, s) : launch_bwd_tiled<D, false>(p, batch, s);
  const dim3 grid((p.seq + kF32Rows - 1) / kF32Rows, p.heads, batch);
  cudaError_t err = launch(attn_small_dq_f32<D>, grid, DqF32<D>::kBytes, s, p);
  if (err != cudaSuccess) return err;
  return launch(attn_small_dkv_f32<D>, grid, DkvF32<D>::kBytes, s, p);
}

}  // namespace

// K10: o = attention(q, k, v) per (item, head) over the packed rows: q, k,
// v and o are contiguous (batch * seq, heads * head_dim) in the compute
// dtype (bf16 when is_bf16, else fp32), 16-byte aligned; head_dim 64 or
// 128; causal 0/1.  Returns the launch's cudaError_t (0 on success).
extern "C" int attention_small_fwd(const void* q, const void* k, const void* v, void* o,
                                   int batch, int seq, int heads, int head_dim, float scale,
                                   int causal, int is_bf16, void* stream) {
  const Params p{q, k, v, nullptr, o, nullptr, nullptr, nullptr,
                 seq, heads, heads * head_dim, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_fwd<64>(p, batch, is_bf16, s);
    case 128: return launch_fwd<128>(p, batch, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

// K11: dq, dk, dv of attention_small_fwd for the output cotangent dout, all
// laid out as q.  bf16 at seq <= 64: one kernel, and stats is not read (may
// be null).  Otherwise stats is fp32 scratch (batch * seq, heads, 3), and
// the call launches the dq kernel, then the dk/dv kernel, which reads the
// statistics the first wrote.  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int attention_small_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, void* stats, int batch, int seq,
                                   int heads, int head_dim, float scale, int causal, int is_bf16,
                                   void* stream) {
  const Params p{q, k, v, dout, dq, dk, dv, static_cast<float*>(stats),
                 seq, heads, heads * head_dim, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_bwd<64>(p, batch, is_bf16, s);
    case 128: return launch_bwd<128>(p, batch, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the one-tile kernels at head dim `head_dim` (0 if
// it is not taken): the forward's, or with `backward` the backward's
extern "C" int attention_small_onetile_smem(int backward, int head_dim) {
  if (head_dim == 64) return backward ? onetile_bwd_smem<64>() : onetile_fwd_smem<64>();
  if (head_dim == 128) return backward ? onetile_bwd_smem<128>() : onetile_fwd_smem<128>();
  return 0;
}

// dynamic shared memory of the tiled bf16 kernels (S > 64) for items of seq
// tokens at head dim head_dim (0 if it is not taken): kernel 0 the forward,
// 1 the dq kernel, 2 the dk/dv kernel
extern "C" int attention_small_tiled_smem(int kernel, int head_dim, int seq) {
  if (head_dim != 64 && head_dim != 128) return 0;
  const bool d64 = head_dim == 64;
  switch (kernel) {
    case 0: return d64 ? TiledFwd<64>::bytes(seq) : TiledFwd<128>::bytes(seq);
    case 1: {
      const bool long_item = seq > kLongItem;
      return d64 ? (long_item ? TiledDq<64, true>::kBytes : TiledDq<64, false>::kBytes)
                 : (long_item ? TiledDq<128, true>::kBytes : TiledDq<128, false>::kBytes);
    }
    case 2: return d64 ? TiledDkv<64>::kBytes : TiledDkv<128>::kBytes;
    default: return 0;
  }
}
