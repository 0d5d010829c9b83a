// Flash-attention backward for Hopper (sm_90a): two kernels, bound through
// plain C functions and loaded with ctypes (ops/attention.py::
// flash_attention_dq and ::flash_attention_dkv).
//
// Replaces the TPU kernels of distributed_training_comparison_tpu/ops/
// attention.py::_flash_bwd:
//   - flash_bwd_dq  replaces _dq_kernel  (K3): dq = sum_j ds·K;
//   - flash_bwd_dkv replaces _dkv_kernel (K4): dV = sum_i pᵀ·dO, dK = sum_i dsᵀ·Q.
// with p = exp(s - lse), s = q·kᵀ·scale, ds = p·(dO·Vᵀ + adj)·scale and
// adj = dlse - delta, delta = rowsum(dO∘O): the row terms arrive from the
// caller, as delta is computed outside the Pallas kernels too.  On the TPU
// the streamed block axis is a sequential grid dimension accumulating into
// VMEM scratch.  Here blocks run in parallel and in no order, so each block
// owns its output tile and loops over the other side inside the block:
//   - dq:  one block per (batch, head, 64 query rows), looping over 64-key
//          tiles, dq accumulated in fp32 registers;
//   - dkv: one block per (batch, head, 64 keys), looping over 32-query tiles,
//          dk and dv accumulated in fp32 registers.
// No atomics: each output element is written once by one block, so the pair
// is deterministic run to run (the parity rail's replay gate is bitwise).
// A key tile that no query tile visits still writes its zeros.
//
// Rounding is JAX's: scores, p, dp and ds are fp32; p is rounded to dO's
// dtype for pᵀ·dO and ds to the input dtype for ds·K and dsᵀ·Q; the outputs
// are rounded once from their fp32 sums.  Masked pairs (keys past the true
// key length, keys above the causal diagonal, queries past the true query
// length) take p = 0.  Causal is square (row >= col).
//
// What bounds it on this card: at the training shape (bh = 64, S = 4096,
// D = 128, bf16) dq does 3 products (6·bh·S²·D = 8.2e11 FLOP) and dk/dv 4
// (1.1e12 FLOP) against ~200 MB of traffic each, thousands of FLOP per byte:
// both are bound by tensor-core operations.  The design keeps S×S out of
// device memory (scores, p and ds live in registers), runs every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) and turns
// the fp32 score accumulators of two adjacent 8-column tiles directly into
// the A operand of the next 16-deep product, as the forward does.  Splitting
// dq from dk/dv recomputes s and dp (the pair does 14·bh·S²·D where one
// kernel with atomic dq would do 10) in exchange for determinism.  Tiles are
// single-buffered; wgmma, TMA and pipelined loads are left for a later change.
//
// fp32 inputs run separate SIMT kernels computed in fp32 throughout (no
// TF32), for the default-precision training path and as a cross-check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, Sq) contiguous fp32
  const float* adj;  // (B, H, Sq) contiguous fp32: dlse - delta
  void* dq;
  void* dk;
  void* dv;
  int sq, skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  float scale;
  int causal;
};

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// c += a·b for one 16x8x16 tile: a row-major 16x16 bf16 (4 regs), b column-major
// 16x8 bf16 (2 regs), c 16x8 fp32 (4 regs); fragment layouts per the PTX ISA.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_to_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (rows r0..r0+15, columns c0..c0+15) of a row-major smem tile
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile, int lds, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * lds + c0 + t * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * lds);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * lds + 8);
}

// B fragment of Xᵀ for rows n0..n0+7 of a row-major smem tile X, depth
// columns c0..c0+15 (the B operand of X·Yᵀ products: contiguous pairs)
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const __nv_bfloat16* tile, int lds,
                                            int n0, int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (n0 + g) * lds + c0 + t * 2;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B fragment of X for depth rows k0..k0+15 and columns n0..n0+7 of a
// row-major smem tile X (the B operand of P·X products: strided pairs)
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const __nv_bfloat16* tile, int lds,
                                            int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = tile + (k0 + t * 2) * lds + n0 + g;
  b[0] = pack_bf16(p[0], p[lds]);
  b[1] = pack_bf16(p[8 * lds], p[9 * lds]);
}

// rows [row0, row0 + ROWS) of a (len, D) slice with row stride `ld` into smem
// with row stride D + 8 (the pad spreads a quad's rows over distinct banks);
// rows past `len` are zero-filled, so padding holds 0, not stale data.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g, long long ld,
                                          int row0, int len, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < len;
    const __nv_bfloat16* src = g + (valid ? (row0 + r) * ld : 0) + col;
    cp_async16(smem + r * (D + 8) + col, src, valid);
  }
}

// a warp's 16 x (8·N) fp32 accumulators as bf16 pairs: this thread's two
// rows `row`, skipping rows past `len`
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld, const int row[2],
                                           int len, const float (&acc)[N][4], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= len) continue;
    __nv_bfloat16* out = base + row[i] * ld + t * 2;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_f32_to_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

constexpr int kQM = 64;  // dq: query rows per block, 4 warps x 16
constexpr int kQN = 64;  // dq: keys per tile
constexpr int kKN = 64;  // dkv: keys per block, 4 warps x 16
constexpr int kKM = 32;  // dkv: query rows per tile

template <int D>
constexpr int dq_bf16_smem_bytes() {
  return (2 * kQM + 2 * kQN) * (D + 8) * 2;
}

template <int D>
constexpr int dkv_bf16_smem_bytes() {
  return 2 * kKM * 4 + (2 * kKN + 2 * kKM) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(const Params p) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int NS = kQN / 8;  // 8-key score tiles per key tile
  constexpr int NO = D / 8;    // 8-wide dq tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kQM * LDS;
  __nv_bfloat16* ks = dos + kQM * LDS;
  __nv_bfloat16* vs = ks + kQN * LDS;

  const int m0 = blockIdx.x * kQM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;

  load_tile<D, kQM>(qs, qg, p.q_ss, m0, p.sq, tid);
  load_tile<D, kQM>(dos, dog, p.do_ss, m0, p.sq, tid);
  cp_async_commit();

  const int row[2] = {m0 + wr + g, m0 + wr + g + 8};
  float lse2[2], adj[2];
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < p.sq;
    lse2[i] = ok ? p.lse[rows_at + row[i]] * kLog2e : 0.f;
    adj[i] = ok ? p.adj[rows_at + row[i]] : 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // causal: keys past the tile's last row contribute nothing
  const int kv_end = p.causal ? min(p.skv, m0 + kQM) : p.skv;
  for (int n0 = 0; n0 < kv_end; n0 += kQN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kQN>(ks, kg, p.k_ss, n0, p.skv, tid);
    load_tile<D, kQN>(vs, vg, p.v_ss, n0, p.skv, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, LDS, wr, kk * 16, g, t);
      load_a(da, dos, LDS, wr, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kb[2], vb[2];
        load_b_rows(kb, ks, LDS, n * 8, kk * 16, g, t);
        load_b_rows(vb, vs, LDS, n * 8, kk * 16, g, t);
        mma_16816(s[n], qa, kb);
        mma_16816(dp[n], da, vb);
      }
    }

    // ds = p·(dp + adj)·scale, p = exp(s·scale - lse); masked pairs take p = 0
    const bool needs_mask = n0 + kQN > p.skv || (p.causal && n0 + kQN - 1 > m0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[n][e] * scale2 - lse2[e >> 1]);
        if (needs_mask) {
          const int col = n0 + n * 8 + t * 2 + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[e >> 1]);
          pr = ok ? pr : 0.f;
        }
        s[n][e] = pr * (dp[n][e] + adj[e >> 1]) * p.scale;
      }
    }

    // dq += ds·K: ds (rounded to bf16) is the A operand straight from registers
#pragma unroll
    for (int kk = 0; kk < kQN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32_to_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_f32_to_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_f32_to_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32_to_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t kb[2];
        load_b_cols(kb, ks, LDS, kk * 16, n * 8, g, t);
        mma_16816(acc[n], a, kb);
      }
    }
  }
  cp_async_wait_all();

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows(dqg, p.dq_ss, row, p.sq, acc, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(const Params p) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int NS = kKM / 8;  // 8-query score tiles per query tile
  constexpr int NO = D / 8;    // 8-wide dk/dv tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lse_s = reinterpret_cast<float*>(smem_raw);  // pre-scaled by log2(e)
  float* adj_s = lse_s + kKM;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(adj_s + kKM);
  __nv_bfloat16* vs = ks + kKN * LDS;
  __nv_bfloat16* qs = vs + kKN * LDS;
  __nv_bfloat16* dos = qs + kKM * LDS;

  const int n0 = blockIdx.x * kKN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;

  load_tile<D, kKN>(ks, kg, p.k_ss, n0, p.skv, tid);
  load_tile<D, kKN>(vs, vg, p.v_ss, n0, p.skv, tid);
  cp_async_commit();

  const int key[2] = {n0 + wr + g, n0 + wr + g + 8};
  const float scale2 = p.scale * kLog2e;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // causal: queries before the tile's first key see none of its keys
  const int q_begin = p.causal ? (n0 / kKM) * kKM : 0;
  for (int m0 = q_begin; m0 < p.sq; m0 += kKM) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, kKM>(qs, qg, p.q_ss, m0, p.sq, tid);
    load_tile<D, kKM>(dos, dog, p.do_ss, m0, p.sq, tid);
    cp_async_commit();
    if (tid < kKM) {
      const bool ok = m0 + tid < p.sq;
      lse_s[tid] = ok ? p.lse[rows_at + m0 + tid] * kLog2e : 0.f;
      adj_s[tid] = ok ? p.adj[rows_at + m0 + tid] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // transposed scores: sᵀ = K·Qᵀ and dpᵀ = V·dOᵀ, 16 keys x 32 queries per warp
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, LDS, wr, kk * 16, g, t);
      load_a(va, vs, LDS, wr, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t qb[2], db[2];
        load_b_rows(qb, qs, LDS, n * 8, kk * 16, g, t);
        load_b_rows(db, dos, LDS, n * 8, kk * 16, g, t);
        mma_16816(st[n], ka, qb);
        mma_16816(dpt[n], va, db);
      }
    }

    // pᵀ and dsᵀ; a tile needs the mask where it reaches past the query
    // length or where some of its queries precede some of the block's keys
    const bool needs_mask = m0 + kKM > p.sq || (p.causal && m0 < n0 + kKN - 1);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + t * 2 + (e & 1);
        float pr = exp2f(st[n][e] * scale2 - lse_s[qc]);
        if (needs_mask) {
          const int qrow = m0 + qc;
          const bool ok = qrow < p.sq && (!p.causal || qrow >= key[e >> 1]);
          pr = ok ? pr : 0.f;
        }
        st[n][e] = pr;
        dpt[n][e] = pr * (dpt[n][e] + adj_s[qc]) * p.scale;
      }
    }

    // dv += pᵀ·dO and dk += dsᵀ·Q, the A operands straight from registers
#pragma unroll
    for (int kk = 0; kk < kKM / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32_to_bf16(st[2 * kk][0], st[2 * kk][1]),
          pack_f32_to_bf16(st[2 * kk][2], st[2 * kk][3]),
          pack_f32_to_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_f32_to_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]),
      };
      const uint32_t da[4] = {
          pack_f32_to_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_f32_to_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_f32_to_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_f32_to_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t ob[2], qb[2];
        load_b_cols(ob, dos, LDS, kk * 16, n * 8, g, t);
        load_b_cols(qb, qs, LDS, kk * 16, n * 8, g, t);
        mma_16816(dv[n], pa, ob);
        mma_16816(dk[n], da, qb);
      }
    }
  }
  cp_async_wait_all();

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows(dkg, p.dk_ss, key, p.skv, dk, t);
  store_rows(dvg, p.dv_ss, key, p.skv, dv, t);
}

// ------------------------------------------------------------------ fp32

constexpr int kFR = 32;  // rows of the block's own side: 4 threads per row
constexpr int kFT = 32;  // rows of each streamed tile

template <int D>
constexpr int dq_f32_smem_bytes() {
  return (2 * kFR * (D + 1) + 2 * kFT * (D + 1) + kFR * (kFT + 1)) * 4;
}

template <int D>
constexpr int dkv_f32_smem_bytes() {
  return (2 * kFR * (D + 1) + 2 * kFT * (D + 1) + 2 * kFR * (kFT + 1) + 2 * kFT) * 4;
}

// rows [row0, row0 + ROWS) of a (len, D) fp32 slice into smem rows of D + 1
// (the odd stride puts a warp's 8 rows on distinct banks); zeros past len
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* smem, const float* g, long long ld, int row0,
                                              int len, int tid) {
  for (int c = tid; c < ROWS * D; c += kThreads) {
    const int r = c / D, d = c % D;
    smem[r * (D + 1) + d] = row0 + r < len ? g[(row0 + r) * ld + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(const Params p) {
  constexpr int LD = D + 1;
  constexpr int PER = kFT / 4;
  constexpr int OUT = D / 4;
  extern __shared__ float fsmem[];
  float* qs = fsmem;
  float* dos = qs + kFR * LD;
  float* ks = dos + kFR * LD;
  float* vs = ks + kFT * LD;
  float* ds_s = vs + kFT * LD;

  const int m0 = blockIdx.x * kFR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 4, t = tid % 4;  // row of the tile, lane of the row's quad
  const int row = m0 + r;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;

  load_tile_f32<D, kFR>(qs, qg, p.q_ss, m0, p.sq, tid);
  load_tile_f32<D, kFR>(dos, dog, p.do_ss, m0, p.sq, tid);
  const float lse = row < p.sq ? p.lse[rows_at + row] : 0.f;
  const float adj = row < p.sq ? p.adj[rows_at + row] : 0.f;
  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;

  const int kv_end = p.causal ? min(p.skv, m0 + kFR) : p.skv;
  for (int n0 = 0; n0 < kv_end; n0 += kFT) {
    __syncthreads();
    load_tile_f32<D, kFT>(ks, kg, p.k_ss, n0, p.skv, tid);
    load_tile_f32<D, kFT>(vs, vg, p.v_ss, n0, p.skv, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + 4 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[r * LD + d], ks[c * LD + d], s);
        dp = fmaf(dos[r * LD + d], vs[c * LD + d], dp);
      }
      const int col = n0 + c;
      const bool ok = col < p.skv && (!p.causal || col <= row);
      const float pr = ok ? expf(s * p.scale - lse) : 0.f;
      ds_s[r * (kFT + 1) + c] = pr * (dp + adj) * p.scale;
    }
    __syncwarp();  // a row's quad lives in one warp: its ds row is visible now
    for (int c = 0; c < kFT; ++c) {
      const float ds = ds_s[r * (kFT + 1) + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) acc[i] = fmaf(ds, ks[c * LD + t + 4 * i], acc[i]);
    }
  }
  if (row < p.sq) {
    float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss;
#pragma unroll
    for (int i = 0; i < OUT; ++i) dqg[t + 4 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(const Params p) {
  constexpr int LD = D + 1;
  constexpr int PER = kFT / 4;
  constexpr int OUT = D / 4;
  extern __shared__ float fsmem[];
  float* ks = fsmem;
  float* vs = ks + kFR * LD;
  float* qs = vs + kFR * LD;
  float* dos = qs + kFT * LD;
  float* p_s = dos + kFT * LD;
  float* ds_s = p_s + kFR * (kFT + 1);
  float* lse_s = ds_s + kFR * (kFT + 1);
  float* adj_s = lse_s + kFT;

  const int n0 = blockIdx.x * kFR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 4, t = tid % 4;  // key of the tile, lane of the key's quad
  const int key = n0 + r;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;

  load_tile_f32<D, kFR>(ks, kg, p.k_ss, n0, p.skv, tid);
  load_tile_f32<D, kFR>(vs, vg, p.v_ss, n0, p.skv, tid);
  float dk[OUT], dv[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) dk[i] = dv[i] = 0.f;

  // causal: queries before the tile's first key see none of its keys
  const int q_begin = p.causal ? n0 : 0;
  for (int m0 = q_begin; m0 < p.sq; m0 += kFT) {
    __syncthreads();
    load_tile_f32<D, kFT>(qs, qg, p.q_ss, m0, p.sq, tid);
    load_tile_f32<D, kFT>(dos, dog, p.do_ss, m0, p.sq, tid);
    if (tid < kFT) {
      const bool ok = m0 + tid < p.sq;
      lse_s[tid] = ok ? p.lse[rows_at + m0 + tid] : 0.f;
      adj_s[tid] = ok ? p.adj[rows_at + m0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + 4 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(ks[r * LD + d], qs[c * LD + d], s);
        dp = fmaf(vs[r * LD + d], dos[c * LD + d], dp);
      }
      const int qrow = m0 + c;
      const bool ok = qrow < p.sq && (!p.causal || qrow >= key);
      const float pr = ok ? expf(s * p.scale - lse_s[c]) : 0.f;
      p_s[r * (kFT + 1) + c] = pr;
      ds_s[r * (kFT + 1) + c] = pr * (dp + adj_s[c]) * p.scale;
    }
    __syncwarp();  // a key's quad lives in one warp: its p and ds rows are visible now
    for (int c = 0; c < kFT; ++c) {
      const float pr = p_s[r * (kFT + 1) + c];
      const float ds = ds_s[r * (kFT + 1) + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) {
        dv[i] = fmaf(pr, dos[c * LD + t + 4 * i], dv[i]);
        dk[i] = fmaf(ds, qs[c * LD + t + 4 * i], dk[i]);
      }
    }
  }
  if (key < p.skv) {
    float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + key * p.dk_ss;
    float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + key * p.dv_ss;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      dkg[t + 4 * i] = dk[i];
      dvg[t + 4 * i] = dv[i];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/dout and the gradients are (B, H, S, D) with unit stride over D and
// the given element strides for batch, head and sequence (bf16: multiples of
// 8 and 16-byte aligned, checked by the caller); lse and adj = dlse - delta
// are contiguous fp32 (B, H, Sq).  Each returns the launch's cudaError_t.

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* adj, void* dq, int batch,
                                      int heads, int sq, int skv, int head_dim, long long q_sb,
                                      long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                      long long do_sb, long long do_sh, long long do_ss,
                                      long long dq_sb, long long dq_sh, long long dq_ss, float scale,
                                      int causal, int is_bf16, void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout;
  p.lse = static_cast<const float*>(lse), p.adj = static_cast<const float*>(adj);
  p.dq = dq;
  p.sq = sq, p.skv = skv;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.do_sb = do_sb, p.do_sh = do_sh, p.do_ss = do_ss;
  p.dq_sb = dq_sb, p.dq_sh = dq_sh, p.dq_ss = dq_ss;
  p.scale = scale, p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((sq + kQM - 1) / kQM, heads, batch);
    if (head_dim == 64) return launch(flash_bwd_dq_bf16<64>, grid, dq_bf16_smem_bytes<64>(), s, p);
    if (head_dim == 128) return launch(flash_bwd_dq_bf16<128>, grid, dq_bf16_smem_bytes<128>(), s, p);
  } else {
    const dim3 grid((sq + kFR - 1) / kFR, heads, batch);
    if (head_dim == 64) return launch(flash_bwd_dq_f32<64>, grid, dq_f32_smem_bytes<64>(), s, p);
    if (head_dim == 128) return launch(flash_bwd_dq_f32<128>, grid, dq_f32_smem_bytes<128>(), s, p);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* adj, void* dk, void* dv,
                                       int batch, int heads, int sq, int skv, int head_dim,
                                       long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                       long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                       long long v_ss, long long do_sb, long long do_sh,
                                       long long do_ss, long long dk_sb, long long dk_sh,
                                       long long dk_ss, long long dv_sb, long long dv_sh,
                                       long long dv_ss, float scale, int causal, int is_bf16,
                                       void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout;
  p.lse = static_cast<const float*>(lse), p.adj = static_cast<const float*>(adj);
  p.dk = dk, p.dv = dv;
  p.sq = sq, p.skv = skv;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.do_sb = do_sb, p.do_sh = do_sh, p.do_ss = do_ss;
  p.dk_sb = dk_sb, p.dk_sh = dk_sh, p.dk_ss = dk_ss;
  p.dv_sb = dv_sb, p.dv_sh = dv_sh, p.dv_ss = dv_ss;
  p.scale = scale, p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((skv + kKN - 1) / kKN, heads, batch);
    if (head_dim == 64) return launch(flash_bwd_dkv_bf16<64>, grid, dkv_bf16_smem_bytes<64>(), s, p);
    if (head_dim == 128)
      return launch(flash_bwd_dkv_bf16<128>, grid, dkv_bf16_smem_bytes<128>(), s, p);
  } else {
    const dim3 grid((skv + kFR - 1) / kFR, heads, batch);
    if (head_dim == 64) return launch(flash_bwd_dkv_f32<64>, grid, dkv_f32_smem_bytes<64>(), s, p);
    if (head_dim == 128)
      return launch(flash_bwd_dkv_f32<128>, grid, dkv_f32_smem_bytes<128>(), s, p);
  }
  return cudaErrorInvalidValue;
}
