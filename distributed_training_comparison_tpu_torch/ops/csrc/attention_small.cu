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
// 64-key tile: vit_tiny and vit_small at 32 px and patch 4, every shape the
// zoo sends to fused_small) run the one-tile kernels; bf16 items of S > 64
// (tests and the smoke script's multi-tile case only) run the tiled
// kernels; fp32 runs the 3xTF32 kernels (below) at every S.  A rule on the
// shape, not a fallback.
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
// The tiled bf16 kernels (S > 64) run on mma.sync m16n8k16: a block per
// (item, head, 64-query tile) with an exact two-sweep softmax, the backward
// as a dq kernel that writes each row's max, sum and delta to an fp32
// scratch and a dk/dv kernel that reads them.
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

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// row and column of accumulator element e of 8-wide tile n in this thread's
// mma fragment, within the block's 64 rows (4 warps x 16)
__device__ __forceinline__ int mma_row(int e) {
  return (threadIdx.x / 32) * 16 + ((threadIdx.x % 32) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int mma_col(int n, int e) {
  return n * 8 + ((threadIdx.x % 32) & 3) * 2 + (e & 1);
}

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

// rows [row0, row0 + ROWS) of one head's (seq, D) column slice (row stride
// ld) into shared memory with row stride D + 8; rows past len zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* smem, const bf16* g, long long ld, int row0,
                                          int len) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < len;
    cp_async16(smem_u32(smem + r * (D + 8) + col), g + (valid ? (row0 + r) * ld : 0) + col, valid);
  }
}

// c (16 rows x NT*8) = A . B^T: A this warp's 16 rows at `a`, B NT*8 rows
// at `b`, both (rows, D) in shared memory with row stride D + 8
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* a, const bf16* b) {
  constexpr int LDS = D + 8;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* a0 = a + g * LDS + kk * 16 + t * 2;
    const uint32_t af[4] = {lds32(a0), lds32(a0 + 8 * LDS), lds32(a0 + 8), lds32(a0 + 8 * LDS + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b0 = b + (n * 8 + g) * LDS + kk * 16 + t * 2;
      const uint32_t bf[2] = {lds32(b0), lds32(b0 + 8)};
      mma_16816(c[n], af, bf);
    }
  }
}

// c (16 rows x D) += round(x) . B: x this warp's 16 x KN accumulator tile
// (rounded to bf16 here), B (KN rows, D) in shared memory, stride D + 8
template <int D, int KN>
__device__ __forceinline__ void mma_xb(float (&c)[D / 8][4], const float (&x)[KN / 8][4],
                                       const bf16* b) {
  constexpr int LDS = D + 8;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    // two adjacent 8-wide accumulator tiles are exactly the A fragment of a 16-deep step
    const uint32_t xa[4] = {
        pack_f32_to_bf16(x[2 * kk][0], x[2 * kk][1]),
        pack_f32_to_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_f32_to_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_f32_to_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
    const bf16* b0 = b + (kk * 16 + t * 2) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* bn = b0 + n * 8;
      const uint32_t bf[2] = {pack_bf16(bn[0], bn[LDS]), pack_bf16(bn[8 * LDS], bn[9 * LDS])};
      mma_16816(c[n], xa, bf);
    }
  }
}

// this warp's 16 rows (starting at m0 + frag_row) of a (16 x D) accumulator
// into the bf16 rows of g (row stride ld), rows past seq left alone
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, const float (&acc)[D / 8][4], int m0,
                                           const Params& p) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + mma_row(2 * i);
    if (row >= p.seq) continue;
    bf16* r = g + static_cast<long long>(row) * p.ld + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(r + n * 8) = pack_f32_to_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

__device__ __forceinline__ long long head_base(const Params& p, int b, int h, int d) {
  return static_cast<long long>(b) * p.seq * p.ld + h * d;
}

// ------------------------------------------------------------- K10 forward

constexpr int kTile = 64;  // bf16: query rows per block (4 warps x 16), keys per tile

template <int D>
constexpr int fwd_bf16_smem() {
  return 3 * kTile * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_small_fwd_bf16(const Params p) {
  constexpr int LDS = D + 8, NS = kTile / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * LDS;
  bf16* vs = ks + kTile * LDS;
  const int m0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long base = head_base(p, b, h, D);
  const bf16* kg = static_cast<const bf16*>(p.k) + base;
  const bf16* vg = static_cast<const bf16*>(p.v) + base;
  const int kend = key_end(p, m0, kTile);

  load_rows<D, kTile>(qs, static_cast<const bf16*>(p.q) + base, p.ld, m0, p.seq);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* q0 = qs + (wr + g) * LDS + kk * 16 + t * 2;
    qf[kk][0] = lds32(q0);
    qf[kk][1] = lds32(q0 + 8 * LDS);
    qf[kk][2] = lds32(q0 + 8);
    qf[kk][3] = lds32(q0 + 8 * LDS + 8);
  }
  // scaled scores of this warp's rows against the key tile at n0, masked
  auto scores = [&](float (&s)[NS][4], int n0) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* k0 = ks + (n * 8 + g) * LDS + kk * 16 + t * 2;
        const uint32_t bf[2] = {lds32(k0), lds32(k0 + 8)};
        mma_16816(s[n], qf[kk], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = visible(p, m0 + mma_row(e), n0 + mma_col(n, e)) ? s[n][e] * p.scale : kNegInf;
    }
  };

  // sweep 1: each row's max and sum of exp(s - max) over the key tiles
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};  // sum: this thread's share
  for (int n0 = 0; n0 < kend; n0 += kTile) {
    load_rows<D, kTile>(ks, kg, p.ld, n0, p.seq);
    cp_async_wait_all();
    __syncthreads();
    float s[NS][4];
    scores(s, n0);
    __syncthreads();  // every warp is done with this K tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = mx[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) m = fmaxf(m, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      m = quad_max(m);
      float add = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) add += expf(s[n][2 * i] - m) + expf(s[n][2 * i + 1] - m);
      sum[i] = sum[i] * expf(mx[i] - m) + add;
      mx[i] = m;
    }
  }
  const float total[2] = {quad_sum(sum[0]), quad_sum(sum[1])};

  // sweep 2: P = exp(s - max) / sum rounded to bf16, P.V accumulated in fp32
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int n0 = 0; n0 < kend; n0 += kTile) {
    load_rows<D, kTile>(ks, kg, p.ld, n0, p.seq);
    load_rows<D, kTile>(vs, vg, p.ld, n0, p.seq);
    cp_async_wait_all();
    __syncthreads();
    float s[NS][4];
    scores(s, n0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - mx[e >> 1]) / total[e >> 1];
    mma_xb<D, kTile>(acc, s, vs);
    __syncthreads();  // every warp is done with this K and V tile
  }
  store_rows<D>(static_cast<bf16*>(p.o) + base, acc, m0, p);
}

// ------------------------------------------------------------ K11 backward

template <int D, int KN>
constexpr int bwd_bf16_smem() {
  return (2 * kTile + 2 * KN) * (D + 8) * 2 + KN * 3 * 4;
}

// dq for 64 query rows of one (item, head), and the rows' statistics
template <int D, int KN>
__global__ void __launch_bounds__(kThreads) attn_small_dq_bf16(const Params p) {
  constexpr int LDS = D + 8, NS = KN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * LDS;
  bf16* ks = dos + kTile * LDS;
  bf16* vs = ks + KN * LDS;
  const int m0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16;
  const long long base = head_base(p, b, h, D);
  const bf16* kg = static_cast<const bf16*>(p.k) + base;
  const bf16* vg = static_cast<const bf16*>(p.v) + base;
  const int kend = key_end(p, m0, kTile);
  load_rows<D, kTile>(qs, static_cast<const bf16*>(p.q) + base, p.ld, m0, p.seq);
  load_rows<D, kTile>(dos, static_cast<const bf16*>(p.dout) + base, p.ld, m0, p.seq);

  // scaled scores of this warp's rows against the key tile at n0, masked
  auto scores = [&](float (&s)[NS][4], int n0) {
    mma_abt<D, NS>(s, qs + wr * LDS, ks);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = visible(p, m0 + mma_row(e), n0 + mma_col(n, e)) ? s[n][e] * p.scale : kNegInf;
  };

  // sweep 1: each row's max and sum of exp(s - max), as the forward's
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < kend; n0 += KN) {
    load_rows<D, KN>(ks, kg, p.ld, n0, p.seq);
    cp_async_wait_all();
    __syncthreads();
    float s[NS][4];
    scores(s, n0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = mx[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) m = fmaxf(m, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      m = quad_max(m);
      float add = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) add += expf(s[n][2 * i] - m) + expf(s[n][2 * i + 1] - m);
      sum[i] = sum[i] * expf(mx[i] - m) + add;
      mx[i] = m;
    }
  }
  const float total[2] = {quad_sum(sum[0]), quad_sum(sum[1])};

  // P = exp(s - max) / sum (fp32) and dp = dO . V^T of the key tile at n0
  auto probs = [&](float (&s)[NS][4], float (&dp)[NS][4], int n0) {
    load_rows<D, KN>(ks, kg, p.ld, n0, p.seq);
    load_rows<D, KN>(vs, vg, p.ld, n0, p.seq);
    cp_async_wait_all();
    __syncthreads();
    scores(s, n0);
    mma_abt<D, NS>(dp, dos + wr * LDS, vs);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - mx[e >> 1]) / total[e >> 1];
  };

  // sweep 2: delta = sum_j dp P
  float dl[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < kend; n0 += KN) {
    float s[NS][4], dp[NS][4];
    probs(s, dp, n0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dl[e >> 1] += s[n][e] * dp[n][e];
    __syncthreads();
  }
  const float delta[2] = {quad_sum(dl[0]), quad_sum(dl[1])};

  // sweep 3: dq = round(P (dp - delta) scale) . K
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int n0 = 0; n0 < kend; n0 += KN) {
    float s[NS][4], dp[NS][4];
    probs(s, dp, n0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - delta[e >> 1]) * p.scale;
    mma_xb<D, KN>(acc, s, ks);
    __syncthreads();
  }
  store_rows<D>(static_cast<bf16*>(p.o) + base, acc, m0, p);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + mma_row(2 * i);
      if (row >= p.seq) continue;
      float* st = p.stats + ((static_cast<long long>(b) * p.seq + row) * p.heads + h) * 3;
      st[0] = mx[i];
      st[1] = total[i];
      st[2] = delta[i];
    }
  }
}

// dk and dv for 64 keys of one (item, head), walking the query tiles in
// the transposed frame: rows are keys, columns queries
template <int D, int QN>
__global__ void __launch_bounds__(kThreads) attn_small_dkv_bf16(const Params p) {
  constexpr int LDS = D + 8, NS = QN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * LDS;
  bf16* qs = vs + kTile * LDS;
  bf16* dos = qs + QN * LDS;
  float* st = reinterpret_cast<float*>(dos + QN * LDS);
  const int n0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16;
  const long long base = head_base(p, b, h, D);
  const bf16* qg = static_cast<const bf16*>(p.q) + base;
  const bf16* dog = static_cast<const bf16*>(p.dout) + base;
  const float* stats = p.stats + static_cast<long long>(b) * p.seq * p.heads * 3 + h * 3;
  load_rows<D, kTile>(ks, static_cast<const bf16*>(p.k) + base, p.ld, n0, p.seq);
  load_rows<D, kTile>(vs, static_cast<const bf16*>(p.v) + base, p.ld, n0, p.seq);
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // under causal no query before this block's first key sees any of its keys
  for (int q0 = p.causal ? n0 / QN * QN : 0; q0 < p.seq; q0 += QN) {
    load_rows<D, QN>(qs, qg, p.ld, q0, p.seq);
    load_rows<D, QN>(dos, dog, p.ld, q0, p.seq);
    for (int i = threadIdx.x; i < QN * 3; i += kThreads) {
      const int r = i / 3;
      st[i] = q0 + r < p.seq ? stats[static_cast<long long>(q0 + r) * p.heads * 3 + i % 3] : 1.f;
    }
    cp_async_wait_all();
    __syncthreads();
    float s[NS][4], dp[NS][4];
    mma_abt<D, NS>(s, ks + wr * LDS, qs);
    mma_abt<D, NS>(dp, vs + wr * LDS, dos);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mma_col(n, e);
        const bool seen = q0 + i < p.seq && visible(p, q0 + i, n0 + mma_row(e));
        const float pr = seen ? expf(s[n][e] * p.scale - st[3 * i]) / st[3 * i + 1] : 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - st[3 * i + 2]) * p.scale;
      }
    mma_xb<D, QN>(dv, s, dos);
    mma_xb<D, QN>(dk, dp, qs);
    __syncthreads();
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + base, dk, n0, p);
  store_rows<D>(static_cast<bf16*>(p.dv) + base, dv, n0, p);
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

template <int D>
cudaError_t launch_fwd(const Params& p, int batch, int is_bf16, cudaStream_t s) {
  if (one_tile(p, is_bf16))
    return launch(attn_small_fwd_onetile<D>, dim3(batch * p.heads), onetile_fwd_smem<D>(), s, p);
  if (is_bf16) {
    const dim3 grid((p.seq + kTile - 1) / kTile, p.heads, batch);
    return launch(attn_small_fwd_bf16<D>, grid, fwd_bf16_smem<D>(), s, p);
  }
  const dim3 grid((p.seq + kF32Rows - 1) / kF32Rows, p.heads, batch);
  return launch(attn_small_fwd_f32<D>, grid, FwdF32<D>::kBytes, s, p);
}

template <int D>
cudaError_t launch_bwd(const Params& p, int batch, int is_bf16, cudaStream_t s) {
  if (one_tile(p, is_bf16))
    return launch(attn_small_bwd_onetile<D>, dim3(batch * p.heads), onetile_bwd_smem<D>(), s, p);
  if (p.stats == nullptr) return cudaErrorInvalidValue;  // the tiled and fp32 kernels need it
  if (is_bf16) {
    constexpr int KN = D <= 64 ? 64 : 32;  // key (query) tile: fewer accumulators at large D
    const dim3 grid((p.seq + kTile - 1) / kTile, p.heads, batch);
    cudaError_t err = launch(attn_small_dq_bf16<D, KN>, grid, bwd_bf16_smem<D, KN>(), s, p);
    if (err != cudaSuccess) return err;
    return launch(attn_small_dkv_bf16<D, KN>, grid, bwd_bf16_smem<D, KN>(), s, p);
  }
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
