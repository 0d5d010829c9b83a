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

#include "hopper_common.cuh"

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
