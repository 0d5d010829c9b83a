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
// is bound by tensor-core operations, not bytes.  The design therefore keeps
// S×S out of device memory (online softmax, scores live in registers), feeds
// both products to the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), keeps the Q fragments in registers for the whole key loop, and
// overlaps the next K tile's copy (cp.async) with the softmax and P·V of the
// current one.  wgmma, TMA and warp specialisation, which the full tensor-core
// rate needs, are left for a later change.
//
// fp32 inputs run a separate SIMT kernel that computes in fp32 throughout
// (no TF32), for the non-AMP serving path and as an exact cross-check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite "-inf": fully-masked rows stay NaN-free
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

constexpr int kBM = 64;       // query rows per block: 4 warps x 16 rows
constexpr int kBN = 64;       // keys per tile
constexpr int kThreads = 128;

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBM + 2 * kBN) * (D + 8) * 2;
}

// rows [row0, row0 + ROWS) of a (len, D) slice with row stride `ld` into smem
// with row stride D + 8 (the pad spreads a quad's rows over distinct banks);
// rows past `len` are zero-filled, so padding keys hold 0, not stale data.
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;   // k-steps of Q·Kᵀ over the head dim
  constexpr int NS = kBN / 8;  // 8-wide score tiles per key tile
  constexpr int NO = D / 8;    // 8-wide output tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBM * LDS;
  __nv_bfloat16* vs = ks + kBN * LDS;

  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int wr = warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // causal: keys past the tile's last row contribute nothing
  const int kv_end = p.causal ? min(p.skv, m0 + kBM) : p.skv;
  const int nk = (kv_end + kBN - 1) / kBN;

  load_tile<D, kBM>(qs, qg, p.q_ss, m0, p.sq, tid);
  load_tile<D, kBN>(ks, kg, p.k_ss, 0, p.skv, tid);
  cp_async_commit();
  load_tile<D, kBN>(vs, vg, p.v_ss, 0, p.skv, tid);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  const int row[2] = {m0 + wr + g, m0 + wr + g + 8};

  for (int j = 0; j < nk; ++j) {
    const int n0 = j * kBN;
    cp_async_wait<1>();  // Q and K_j have landed (V_j may still be in flight)
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* q0 = qs + (wr + g) * LDS + kk * 16 + t * 2;
        qf[kk][0] = lds32(q0);
        qf[kk][1] = lds32(q0 + 8 * LDS);
        qf[kk][2] = lds32(q0 + 8);
        qf[kk][3] = lds32(q0 + 8 * LDS + 8);
      }
    }
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* k0 = ks + (n * 8 + g) * LDS + kk * 16 + t * 2;
        const uint32_t bf[2] = {lds32(k0), lds32(k0 + 8)};
        mma_16816(s[n], qf[kk], bf);
      }
    }
    __syncthreads();  // every warp is done with K_j: stream K_{j+1} behind the softmax
    if (j + 1 < nk) load_tile<D, kBN>(ks, kg, p.k_ss, n0 + kBN, p.skv, tid);
    cp_async_commit();

    // mask only the tiles that reach past the key length or straddle the diagonal
    const bool needs_mask = n0 + kBN > p.skv || (p.causal && n0 + kBN - 1 > m0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (needs_mask) {
          const int col = n0 + n * 8 + t * 2 + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[e >> 1]);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = quad_max(mx);
      const float alpha = exp2f((m_run[i] - mx) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * i] = exp2f((s[n][2 * i] - mx) * kLog2e);
        s[n][2 * i + 1] = exp2f((s[n][2 * i + 1] - mx) * kLog2e);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = mx;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

    cp_async_wait<1>();  // V_j has landed (K_{j+1} may still be in flight)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      // the score accumulators of two adjacent 8-key tiles are exactly the
      // A fragment of a 16-key step: no shuffle, no shared-memory round trip
      const uint32_t pa[4] = {
          pack_f32_to_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_f32_to_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_f32_to_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32_to_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* v0 = vs + (kk * 16 + t * 2) * LDS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vn = v0 + n * 8;
        const uint32_t bf[2] = {pack_bf16(vn[0], vn[LDS]), pack_bf16(vn[8 * LDS], vn[9 * LDS])};
        mma_16816(acc[n], pa, bf);
      }
    }
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < nk) load_tile<D, kBN>(vs, vg, p.v_ss, n0 + kBN, p.skv, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + (static_cast<long long>(b) * gridDim.y + h) * p.sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = fmaxf(quad_sum(l_run[i]), 1e-30f);
    if (row[i] >= p.sq) continue;
    const float inv = 1.f / l;
    __nv_bfloat16* orow = og + row[i] * p.o_ss + t * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_f32_to_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (t == 0) lg[row[i]] = m_run[i] + logf(l);
  }
}

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

}  // namespace

// q/k/v/out are (B, H, S, D) with unit stride over D and the given element
// strides for batch, head and sequence (bf16: multiples of 8 and 16-byte
// aligned, checked by the caller); lse is contiguous fp32 (B, H, Sq).
// Returns the launch's cudaError_t (0 on success).
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
    const dim3 grid((sq + kBM - 1) / kBM, heads, batch);
    if (head_dim == 64) return launch(flash_fwd_bf16<64>, grid, bf16_smem_bytes<64>(), s, p);
    if (head_dim == 128) return launch(flash_fwd_bf16<128>, grid, bf16_smem_bytes<128>(), s, p);
  } else {
    const dim3 grid((sq + kFM - 1) / kFM, heads, batch);
    if (head_dim == 64) return launch(flash_fwd_f32<64>, grid, f32_smem_bytes<64>(), s, p);
    if (head_dim == 128) return launch(flash_fwd_f32<128>, grid, f32_smem_bytes<128>(), s, p);
  }
  return cudaErrorInvalidValue;
}
