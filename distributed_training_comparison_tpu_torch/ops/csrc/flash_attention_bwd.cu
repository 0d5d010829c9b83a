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
//   - dq:  one block per (batch, head, 128 query rows), looping over
//          128-key K/V tiles, dq accumulated in fp32 registers;
//   - dkv: one block per (batch, head, 128 keys), looping over 64-query
//          Q/dO tiles, dk and dv accumulated in fp32 registers.
// No atomics: each output element is written once by one block, in a fixed
// loop order, so the pair is deterministic run to run (the parity rail's
// replay gate is bitwise).  A key tile that no query tile visits still
// writes its zeros.
//
// Rounding is JAX's: scores, p, dp and ds are fp32; p is rounded to dO's
// dtype for pᵀ·dO and ds to the input dtype for ds·K and dsᵀ·Q; the outputs
// are rounded once from their fp32 sums.  Masked pairs (keys past the true
// key length, keys above the causal diagonal, queries past the true query
// length) take p = 0 by an explicit mask, never from zero-filled rows.
// Causal is square (row >= col).
//
// What bounds it on this card: at the training shape (bh = 64, S = 4096,
// D = 128, bf16) dq does 3 products (6·bh·S²·D = 8.2e11 FLOP) and dk/dv 4
// (1.1e12 FLOP) against ~200 MB of traffic each, thousands of FLOP per byte:
// both are bound by tensor-core operations, and only wgmma reaches the
// tensor cores' full rate.  Splitting dq from dk/dv recomputes s and dp (the
// pair does 14·bh·S²·D where one kernel with atomic dq would do 10) in
// exchange for determinism.  The bf16 design, the forward's
// (flash_attention_fwd.cu) building blocks from hopper_common.cuh:
// - A block is one producer warpgroup and two consumer warpgroups, 384
//   threads, one block per SM.  The block's own 128 rows (dq: Q and dO;
//   dkv: K and V) are loaded once by TMA, 64 rows to each consumer
//   warpgroup, so every streamed byte in shared memory serves 128 rows.
// - The streamed side runs through a 2-stage ring: one producer thread
//   issues TMA loads (4-D maps (D, S, H, B), 64-column boxes under
//   128-byte swizzle, rows past the true length zero-filled) that complete
//   on "full" mbarriers; each consumer warp releases a stage on an "empty"
//   mbarrier when the wgmma reading it has finished.  dkv's lse and adj,
//   64 of each a query tile, are indexed by column: a producer warp writes
//   them beside the tile (lse pre-scaled by log2 e) and arrives on the same
//   full barrier.
// - setmaxnreg moves registers from the producer (40 a thread) to the
//   consumers (232).  dq holds S, dP and dQ (64 fp32 registers each at
//   D 128: 128-key tiles, m64n128); dkv holds Sᵀ and dPᵀ (32 each: 64-query
//   tiles, m64n64) and dK and dV (64 each at D 128).
// - Every product is a wgmma.  Scores: S = Q·Kᵀ, dP = dO·Vᵀ (dq) and
//   Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (dkv), both operands K-major (D contiguous) in
//   shared memory.  Sums: dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q, with A
//   from registers (the fp32 accumulator packed pairwise to bf16 is the A
//   fragment) and B MN-major (D contiguous), read transposed, as the
//   forward reads V.
// - Masks only on the tiles that reach past a true length or straddle the
//   diagonal; causal dq never loads key tiles wholly above the diagonal,
//   and causal dkv starts at the first query tile that sees its keys.
// The two consumer warpgroups run unsynchronised, so one's exponentials
// overlap the other's products.  Persistent blocks are left for a later
// change.
//
// fp32 inputs (the default-precision training path, without --amp) run
// flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3: the same products on
// wgmma in 3xTF32, each fp32 product as three tf32 products (the fp32
// section below).

#include "tf32x3.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

constexpr int kOwnRows = 128;   // a block's own rows: 2 consumer warpgroups x 64
constexpr int kWgRows = 64;     // a consumer warpgroup's rows (wgmma's M)
constexpr int kDqKeys = 128;    // dq: keys per streamed K/V tile
constexpr int kDkvRows = 64;    // dkv: queries per streamed Q/dO tile
constexpr int kStages = 2;      // depth of the ring
constexpr int kConsumerWarps = 8;  // arrivals that release a ring stage
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536

// rows `row` and `row + 8` of a warpgroup's 64 x D fp32 accumulator as bf16,
// skipping rows past `len` (the accumulator map of hopper_common.cuh)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld, int row, int len,
                                           const float* acc, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= len) continue;
    __nv_bfloat16* out = base + (row + 8 * i) * ld + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) = pack_f32_to_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

// a 64 x N fp32 accumulator rounded to bf16 A fragments of N / 16 k-steps
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32_to_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_f32_to_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_f32_to_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_f32_to_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// byte offset of k-step kk (16 columns of D) in a K-major tile of ROWS-row boxes
template <int ROWS>
__device__ __forceinline__ uint32_t k_step(int kk) {
  return (kk / 4) * box_bytes<ROWS>() + (kk % 4) * 32;
}

template <int D>
struct DqLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int kOwn = tile_bytes<D, kOwnRows>();  // Q or dO: the block's 128 rows
  static constexpr int kTile = tile_bytes<D, kDqKeys>();  // K or V: one 128-key tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kOwn;
  static constexpr int kK = 2 * kOwn;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 128 + 1024;  // barriers, alignment slack
};

// Block: warpgroup 0 produces (one thread issues every TMA load), warpgroups
// 1 and 2 consume, each owning 64 query rows.  Per key tile j, each consumer
// warpgroup: S = Q·K_jᵀ and dP = dO·V_jᵀ (wgmma m64n128k16, ss), then
// dS = P∘(dP + adj)·scale with P = 2^(S·scale·log2e - lse·log2e) on the
// accumulators, then dQ += dS·K_j (m64nDk16, rs; K_j read MN-major).
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_bf16(const Params p, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  using L = DqLayout<D>;
  constexpr int kN = kDqKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t own_full = base + L::kBars;
  auto k_full = [&](int s) { return own_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return own_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return own_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return own_full + 8 * (1 + 3 * kStages + s); };

  // causal: the longest blocks (the last query tiles) go first
  const int mb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kOwnRows;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: keys past the block's last row contribute nothing, and are never loaded
  const int kv_end = p.causal ? min(p.skv, m0 + kOwnRows) : p.skv;
  const int nk = (kv_end + kN - 1) / kN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own_full, 1);
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
      mbar_expect_tx(own_full, 2 * L::kOwn);
      tma_tile<D, kOwnRows>(base + L::kQ, &tq, m0, h, b, own_full);
      tma_tile<D, kOwnRows>(base + L::kDO, &tdo, m0, h, b, own_full);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        // a stage's previous use is released when all 8 consumer warps arrived
        if (j >= kStages) mbar_wait(k_empty(st), ph ^ 1);
        load_tile<D, kN>(base + L::kK + st * L::kTile, &tk, j * kN, h, b, k_full(st));
        if (j >= kStages) mbar_wait(v_empty(st), ph ^ 1);
        load_tile<D, kN>(base + L::kV + st * L::kTile, &tv, j * kN, h, b, v_full(st));
      }
    }
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + kWgRows * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const int row[2] = {row0, row0 + 8};
  const float sl2 = p.scale * kLog2e;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;
  float lse2[2], adj[2];  // lse in units of log2, and dlse - delta, of the thread's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < p.sq;
    lse2[i] = ok ? p.lse[rows_at + row[i]] * kLog2e : 0.f;
    adj[i] = ok ? p.adj[rows_at + row[i]] : 0.f;
  }
  const uint32_t wg = c * kWgRows * 128;  // the warpgroup's 64 rows of every own box
  const uint32_t q_wg = base + L::kQ + wg, do_wg = base + L::kDO + wg;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(own_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const uint32_t ks = base + L::kK + st * L::kTile, vs = base + L::kV + st * L::kTile;
    float s[kN / 2], dp[kN / 2];  // fresh each tile: the first k-step overwrites them
    mbar_wait(k_full(st), ph);
    mbar_wait(v_full(st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = k_step<kOwnRows>(kk);
      wgmma_m64n128k16_ss(s, smem_desc(q_wg + off, 16, 1024), smem_desc(ks + k_step<kN>(kk), 16, 1024),
                          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = k_step<kOwnRows>(kk);
      wgmma_m64n128k16_ss(dp, smem_desc(do_wg + off, 16, 1024), smem_desc(vs + k_step<kN>(kk), 16, 1024),
                          kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kN / 2>(s);
    fence_regs<kN / 2>(dp);
    if (lane == 0) mbar_arrive(v_empty(st));  // this warp is done with V_j

    // ds = p·(dp + adj)·scale into s; masks only on the tiles that reach past
    // the key length or straddle the diagonal
    const int n0 = j * kN;
    const bool masked = n0 + kN > p.skv || (p.causal && n0 + kN - 1 > m0 + kWgRows * c);
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = exp2f(fmaf(s[4 * n + e], sl2, -lse2[i]));
        if (masked) {
          const int col = n0 + 8 * n + 2 * t + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[i]);
          pr = ok ? pr : 0.f;
        }
        s[4 * n + e] = pr * (dp[4 * n + e] + adj[i]) * p.scale;
      }
    }
    // dq += ds·K_j: ds rounded to bf16 is the A operand; K_j is MN-major
    // (D contiguous): 16 keys (2 KB of rows) a step, the next 64 columns of
    // D one box on (LBO), 8-key groups 1 KB apart (SBO)
    uint32_t da[kN / 16][4];
    pack_a<kN>(da, s);
    fence_regs<D / 2>(dq);
    fence_regs<kN / 4>(&da[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<D>(dq, da[kk], smem_desc(ks + kk * 16 * 128, box_bytes<kN>(), 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    fence_regs<kN / 4>(&da[0][0]);
    if (lane == 0) mbar_arrive(k_empty(st));  // this warp is done with K_j
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<D>(dqg, p.dq_ss, row0, p.sq, dq, t);
}

template <int D>
struct DkvLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int kOwn = tile_bytes<D, kOwnRows>();   // K or V: the block's 128 keys
  static constexpr int kTile = tile_bytes<D, kDkvRows>();  // Q or dO: one 64-query tile
  static constexpr int kRowBytes = 2 * kDkvRows * 4;       // a tile's lse·log2e and adj, fp32
  static constexpr int kK = 0;
  static constexpr int kV = kOwn;
  static constexpr int kQ = 2 * kOwn;
  static constexpr int kDO = kQ + kStages * kTile;
  static constexpr int kRows = kDO + kStages * kTile;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  static constexpr int kBytes = kBars + 128 + 1024;  // barriers, alignment slack
};

// Block: warpgroup 0 produces (one thread issues every TMA load, its warp
// stages each tile's lse and adj), warpgroups 1 and 2 consume, each owning
// 64 keys.  Per query tile i, each consumer warpgroup: Sᵀ = K·Q_iᵀ and
// dPᵀ = V·dO_iᵀ (wgmma m64n64k16, ss), then Pᵀ and dSᵀ on the accumulators
// with lse and adj by column (query), then dV += Pᵀ·dO_i and dK += dSᵀ·Q_i
// (m64nDk16, rs; Q_i and dO_i read MN-major).
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_bf16(const Params p, const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv) {
  using L = DkvLayout<D>;
  constexpr int kM = kDkvRows;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // lse·log2e then adj of stage s, written and read as ordinary shared memory
  auto row_terms = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows) + s * 2 * kM;
  };
  const uint32_t own_full = base + L::kBars;
  auto full = [&](int s) { return own_full + 8 * (1 + s); };
  auto empty = [&](int s) { return own_full + 8 * (1 + kStages + s); };

  const int n0 = blockIdx.x * kOwnRows;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: queries before the block's first key see none of its keys
  const int m_first = p.causal ? n0 / kM * kM : 0;
  const int nt = p.sq > m_first ? (p.sq - m_first + kM - 1) / kM : 0;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // full when its TMA bytes landed, after the arrival that expected them
      // and one from each of the 32 lanes that stage its row terms
      mbar_init(full(s), 1 + 32);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(own_full, 2 * L::kOwn);
        tma_tile<D, kOwnRows>(base + L::kK, &tk, n0, h, b, own_full);
        tma_tile<D, kOwnRows>(base + L::kV, &tv, n0, h, b, own_full);
      }
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int m = m_first + i * kM;
        if (i >= kStages) mbar_wait(empty(st), ph ^ 1);
        if (tid == 0) {
          mbar_expect_tx(full(st), 2 * L::kTile);
          tma_tile<D, kM>(base + L::kQ + st * L::kTile, &tq, m, h, b, full(st));
          tma_tile<D, kM>(base + L::kDO + st * L::kTile, &tdo, m, h, b, full(st));
        }
        float* terms = row_terms(st);
#pragma unroll
        for (int e = 0; e < kM / 32; ++e) {
          const int q = m + tid + 32 * e;
          const bool ok = q < p.sq;
          terms[tid + 32 * e] = ok ? p.lse[rows_at + q] * kLog2e : 0.f;
          terms[kM + tid + 32 * e] = ok ? p.adj[rows_at + q] : 0.f;
        }
        mbar_arrive(full(st));
      }
    }
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + kWgRows * c + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
  const int key[2] = {key0, key0 + 8};
  const int wg_last_key = n0 + kWgRows * c + kWgRows - 1;
  const float sl2 = p.scale * kLog2e;
  const uint32_t wg = c * kWgRows * 128;  // the warpgroup's 64 keys of every own box
  const uint32_t k_wg = base + L::kK + wg, v_wg = base + L::kV + wg;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(own_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int m = m_first + i * kM;
    const uint32_t qs = base + L::kQ + st * L::kTile, dos = base + L::kDO + st * L::kTile;
    float s[kM / 2], dp[kM / 2];  // fresh each tile: the first k-step overwrites them
    mbar_wait(full(st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t own = k_step<kOwnRows>(kk), off = k_step<kM>(kk);
      wgmma_m64n64k16_ss(s, smem_desc(k_wg + own, 16, 1024), smem_desc(qs + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t own = k_step<kOwnRows>(kk), off = k_step<kM>(kk);
      wgmma_m64n64k16_ss(dp, smem_desc(v_wg + own, 16, 1024), smem_desc(dos + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kM / 2>(s);
    fence_regs<kM / 2>(dp);

    // pᵀ into s and dsᵀ into dp, lse and adj by the accumulator's column;
    // masks only on the tiles that reach past the query length or hold a
    // query before one of the warpgroup's keys
    const float* terms = row_terms(st);
    const bool masked = m + kM > p.sq || (p.causal && m < wg_last_key);
#pragma unroll
    for (int n = 0; n < kM / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(terms + 8 * n + 2 * t);
      const float2 a2 = *reinterpret_cast<const float2*>(terms + kM + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = e & 1 ? l2.y : l2.x;
        const float adj = e & 1 ? a2.y : a2.x;
        float pr = exp2f(fmaf(s[4 * n + e], sl2, -lse2));
        if (masked) {
          const int q = m + 8 * n + 2 * t + (e & 1);
          const bool ok = q < p.sq && (!p.causal || q >= key[e >> 1]);
          pr = ok ? pr : 0.f;
        }
        s[4 * n + e] = pr;
        dp[4 * n + e] = pr * (dp[4 * n + e] + adj) * p.scale;
      }
    }
    // dv += pᵀ·dO_i and dk += dsᵀ·Q_i: pᵀ and dsᵀ rounded to bf16 are the A
    // operands; dO_i and Q_i are MN-major (D contiguous): 16 queries (2 KB of
    // rows) a step, the next 64 columns of D one box on (LBO), 8-query groups
    // 1 KB apart (SBO)
    uint32_t pa[kM / 16][4], da[kM / 16][4];
    pack_a<kM>(pa, s);
    pack_a<kM>(da, dp);
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    fence_regs<kM / 4>(&pa[0][0]);
    fence_regs<kM / 4>(&da[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], smem_desc(dos + kk * 16 * 128, box_bytes<kM>(), 1024));
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wgmma_rs<D>(dk, da[kk], smem_desc(qs + kk * 16 * 128, box_bytes<kM>(), 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    fence_regs<kM / 4>(&pa[0][0]);
    fence_regs<kM / 4>(&da[0][0]);
    __syncwarp();  // every lane has read the stage's row terms
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with stage st
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<D>(dkg, p.dk_ss, key0, p.skv, dk, t);
  store_rows<D>(dvg, p.dv_ss, key0, p.skv, dv, t);
}

// 0 on success, a cudaError_t if the launch failed, -CUresult if a map did not
// encode.  Q and dO are read in tiles of Q_ROWS rows, K and V of KV_ROWS.
template <int D, int Q_ROWS, int KV_ROWS, typename Kernel>
int launch_bf16(Kernel kernel, int smem, int grid_x, const Params& p, int batch, int heads,
                cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tdo, tk, tv;
  CUresult r = encode(&tq, p.q, D, p.sq, heads, batch, p.q_sb, p.q_sh, p.q_ss, Q_ROWS);
  if (r == CUDA_SUCCESS) r = encode(&tdo, p.dout, D, p.sq, heads, batch, p.do_sb, p.do_sh, p.do_ss, Q_ROWS);
  if (r == CUDA_SUCCESS) r = encode(&tk, p.k, D, p.skv, heads, batch, p.k_sb, p.k_sh, p.k_ss, KV_ROWS);
  if (r == CUDA_SUCCESS) r = encode(&tv, p.v, D, p.skv, heads, batch, p.v_sb, p.v_sh, p.v_ss, KV_ROWS);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, heads, batch), 384, smem, stream>>>(p, tq, tdo, tk, tv);
  return cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int grid_x = (p.sq + kOwnRows - 1) / kOwnRows;
  return launch_bf16<D, kOwnRows, kDqKeys>(flash_bwd_dq_bf16<D>, DqLayout<D>::kBytes, grid_x, p, batch,
                                          heads, stream);
}

template <int D>
int launch_dkv_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int grid_x = (p.skv + kOwnRows - 1) / kOwnRows;
  return launch_bf16<D, kDkvRows, kOwnRows>(flash_bwd_dkv_bf16<D>, DkvLayout<D>::kBytes, grid_x, p, batch,
                                           heads, stream);
}

// ------------------------------------------------------------------ fp32
//
// 3xTF32 on wgmma, on tf32x3.cuh's split, ring and products (its header
// says how they work).  The kernels' schedules: dq streams K_j and V_j as
// scores B (64 keys x 32 of D) and K_jᵀ (64 of D x 32 keys) for dQ +=
// dS·K_j, twelve slots a 64-key tile at D 128; dkv streams one slot per 32
// columns of D holding Q_i (rows 0-31) and dO_i (rows 32-63) as scores B,
// then dO_iᵀ and Q_iᵀ (64 of D x 32 queries), eight slots a 32-query tile.
// The own rows: dq Q and dO, dkv K and V, 64 a consumer warpgroup.
// Shared memory at D 128: 128 KB of own rows + 6 slots (96 KB) = 224 KB.
// Registers: setmaxnreg gives the producer 56 and the consumers 224 (dq
// holds dQ 64 + S 32 + dP 32 + fragments; dkv dK 64 + dV 64 + Sᵀ 16 + dPᵀ
// 16 + two k-steps of fragments in flight, then a tile's partial dV or dK
// 32 + P or dS fragments 32).  The long sums (dQ over keys, dK and dV over
// queries) take each tile's products in a fresh accumulator.

constexpr int kDqKeysF32 = 64;                    // dq: keys per streamed tile
constexpr int kDkvRowsF32 = 32;                   // dkv: queries per streamed tile

template <int D>
using Tf32Bwd = Tf32Layout<D, 4>;  // own rows: 2 warpgroups x 2 tensors

// a consumer thread's A fragments of rows row0 and row0 + 8 (`len` true rows)
// of a (S, D) fp32 slice, raw, into its own float4 of each k-step
template <int D>
__device__ __forceinline__ void load_own(unsigned char* own, const float* g, long long ss, int row0, int len,
                                         int t) {
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * frag_row(e);
      x[e] = row < len ? g[row * ss + 8 * ks + t + 4 * frag_col(e)] : 0.f;
    }
    *reinterpret_cast<float4*>(own + ks * kFrag) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Block: warpgroup 0 produces, warpgroups 1 and 2 consume, each owning 64
// query rows.  Per 64-key tile j each consumer warpgroup: S = Q·K_jᵀ and
// dP = dO·V_jᵀ (3xTF32 m64n64k8 over D: 8 slots at D 128), dS = P∘(dP +
// adj)·scale with P = exp(S·scale - lse) on the accumulators, then dQ +=
// dS·K_j (4 transposed slots: two 64-column halves x two 32-key chunks).
template <int D>
__global__ void __launch_bounds__(384, 1) flash_bwd_dq_tf32x3(const Params p) {
  using L = Tf32Bwd<D>;
  constexpr int kN = kDqKeysF32;
  constexpr int kPerTile = 2 * (D / 32) + 2 * (D / 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  // causal: the longest blocks (the last query tiles) go first
  const int mb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kOwnRows;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: keys past the block's last row contribute nothing, and are never loaded
  const int kv_end = p.causal ? min(p.skv, m0 + kOwnRows) : p.skv;
  const int nk = (kv_end + kN - 1) / kN;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int r = u % kPerTile, n0 = u / kPerTile * kN;
      if (r < 2 * (D / 32)) {
        const bool is_v = r >= D / 32;
        const float* g = is_v ? vg : kg;
        const long long ss = is_v ? p.v_ss : p.k_ss;
        return SlotSrc{g, g, ss, ss, n0, p.skv, 32 * (is_v ? r - D / 32 : r), false};
      }
      const int idx = r - 2 * (D / 32);  // column block idx / 2, key chunk idx % 2
      return SlotSrc{kg, kg, p.k_ss, p.k_ss, n0 + 32 * (idx % 2), p.skv, 64 * (idx / 2), true};
    };
    produce<kSlotRows>(slot_of, nk * kPerTile, sbase + L::kRingAt, bars, tid);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + kWgRows * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const int row[2] = {row0, row0 + 8};
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;
  float lse[2], adj[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < p.sq;
    lse[i] = ok ? p.lse[rows_at + row[i]] : 0.f;
    adj[i] = ok ? p.adj[rows_at + row[i]] : 0.f;
  }
  unsigned char* const own_q = sbase + 2 * c * L::kOwnTensor + (tid % 128) * 16;
  unsigned char* const own_do = own_q + L::kOwnTensor;
  load_own<D>(own_q, qg, p.q_ss, row0, p.sq, t);
  load_own<D>(own_do, dog, p.do_ss, row0, p.sq, t);  // read back by this thread alone
  const uint32_t ring = base + L::kRingAt;

  float dq[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[hh][i] = 0.f;

  int u = 0;
  for (int j = 0; j < nk; ++j) {
    float s[kN / 2], dp[kN / 2];
    scores<D>(s, own_q, ring, bars, u, lane);
    scores<D>(dp, own_do, ring, bars, u, lane);
    // ds = p·(dp + adj)·scale into s; masks only on the tiles that reach past
    // the key length or straddle the diagonal
    const int n0 = j * kN;
    const bool masked = n0 + kN > p.skv || (p.causal && n0 + kN - 1 > m0 + kWgRows * c);
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = expf(fmaf(s[4 * n + e], p.scale, -lse[i]));
        if (masked) {
          const int col = n0 + 8 * n + 2 * t + (e & 1);
          const bool ok = col < p.skv && (!p.causal || col <= row[i]);
          pr = ok ? pr : 0.f;
        }
        s[4 * n + e] = pr * (dp[4 * n + e] + adj[i]) * p.scale;
      }
    }
    uint32_t big[kN / 8][4], small[kN / 8][4];
    acc_frags<kN / 8>(big, small, s);
    sums<D, kN / 8>(dq, big, small, ring, bars, u, lane);
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) store_f32(dqg, p.dq_ss, row0, p.sq, 64 * hh, dq[hh], t);
}

// Block: warpgroup 0 produces, warpgroups 1 and 2 consume, each owning 64
// keys.  Per 32-query tile i each consumer warpgroup: Sᵀ = K·Q_iᵀ and dPᵀ =
// V·dO_iᵀ (3xTF32 m64n32k8 over D, one slot of Q_i and dO_i per 32 columns),
// Pᵀ and dSᵀ on the accumulators with lse and adj by column (query), then
// dV += Pᵀ·dO_i and dK += dSᵀ·Q_i (m64n64k8, a transposed slot per 64
// columns of D each).
template <int D>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_tf32x3(const Params p) {
  using L = Tf32Bwd<D>;
  constexpr int kM = kDkvRowsF32;
  constexpr int kPerTile = D / 32 + 2 * (D / 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  const int n0 = blockIdx.x * kOwnRows;
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: queries before the block's first key see none of its keys
  const int m_first = p.causal ? n0 / kM * kM : 0;
  const int nt = p.sq > m_first ? (p.sq - m_first + kM - 1) / kM : 0;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int r = u % kPerTile, m = m_first + u / kPerTile * kM;
      if (r < D / 32) return SlotSrc{qg, dog, p.q_ss, p.do_ss, m, p.sq, 32 * r, false};
      const int idx = r - D / 32;
      const bool is_q = idx >= D / 64;  // dO_iᵀ first (for dV), then Q_iᵀ (for dK)
      const float* g = is_q ? qg : dog;
      const long long ss = is_q ? p.q_ss : p.do_ss;
      return SlotSrc{g, g, ss, ss, m, p.sq, 64 * (is_q ? idx - D / 64 : idx), true};
    };
    produce<kM>(slot_of, nt * kPerTile, sbase + L::kRingAt, bars, tid);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + kWgRows * c + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
  const int key[2] = {key0, key0 + 8};
  const int wg_last_key = n0 + kWgRows * c + kWgRows - 1;
  const long long rows_at = (static_cast<long long>(b) * gridDim.y + h) * p.sq;
  unsigned char* const own_k = sbase + 2 * c * L::kOwnTensor + (tid % 128) * 16;
  unsigned char* const own_v = own_k + L::kOwnTensor;
  load_own<D>(own_k, kg, p.k_ss, key0, p.skv, t);
  load_own<D>(own_v, vg, p.v_ss, key0, p.skv, t);  // read back by this thread alone
  const uint32_t ring = base + L::kRingAt;

  float dk[D / 64][32], dv[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;

  int u = 0;
  for (int it = 0; it < nt; ++it) {
    const int m = m_first + it * kM;
    float s[kM / 2], dp[kM / 2];
    // Sᵀ and dPᵀ: per slot, two k-steps' fragments in flight (a k-step's
    // K and V fragments reused two k-steps later, after their products)
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
      consumer_wait(bars, u);
      const uint32_t slot = ring + (u % kRing) * kSlotBytes;
      uint32_t kb[2][4], ksm[2][4], vb[2][4], vsm[2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int f = kk & 1;
        if (kk >= 2) {
          wgmma_wait<1>();
          fence_regs<4>(kb[f]);
          fence_regs<4>(ksm[f]);
          fence_regs<4>(vb[f]);
          fence_regs<4>(vsm[f]);
        }
        split4(*reinterpret_cast<const float4*>(own_k + (4 * cc + kk) * kFrag), kb[f], ksm[f]);
        split4(*reinterpret_cast<const float4*>(own_v + (4 * cc + kk) * kFrag), vb[f], vsm[f]);
        wgmma_fence();
        const int acc = cc > 0 || kk > 0;
        wgmma_3xtf32<kM>(s, kb[f], ksm[f], slot + kk * 32, acc);               // Q_i rows
        wgmma_3xtf32<kM>(dp, vb[f], vsm[f], slot + kM * 128 + kk * 32, acc);   // dO_i rows
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<kM / 2>(s);
      fence_regs<kM / 2>(dp);
      fence_regs<8>(&kb[0][0]);
      fence_regs<8>(&ksm[0][0]);
      fence_regs<8>(&vb[0][0]);
      fence_regs<8>(&vsm[0][0]);
      consumer_release(bars, u, lane);
      ++u;
    }
    // pᵀ into s and dsᵀ into dp, lse and adj by the accumulator's column;
    // masks only on the tiles that reach past the query length or hold a
    // query before one of the warpgroup's keys
    const bool masked = m + kM > p.sq || (p.causal && m < wg_last_key);
#pragma unroll
    for (int n = 0; n < kM / 8; ++n) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int q = m + 8 * n + 2 * t + e2;
        const bool in = q < p.sq;
        const float lse = in ? p.lse[rows_at + q] : 0.f;
        const float adj = in ? p.adj[rows_at + q] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + e2;
          float pr = expf(fmaf(s[4 * n + e], p.scale, -lse));
          if (masked) {
            const bool ok = in && (!p.causal || q >= key[i]);
            pr = ok ? pr : 0.f;
          }
          s[4 * n + e] = pr;
          dp[4 * n + e] = pr * (dp[4 * n + e] + adj) * p.scale;
        }
      }
    }
    uint32_t big[kM / 8][4], small[kM / 8][4];
    acc_frags<kM / 8>(big, small, s);
    sums<D, kM / 8>(dv, big, small, ring, bars, u, lane);
    acc_frags<kM / 8>(big, small, dp);
    sums<D, kM / 8>(dk, big, small, ring, bars, u, lane);
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
    store_f32(dkg, p.dk_ss, key0, p.skv, 64 * hh, dk[hh], t);
    store_f32(dvg, p.dv_ss, key0, p.skv, 64 * hh, dv[hh], t);
  }
}

template <int D, typename Kernel>
int launch_tf32x3(Kernel kernel, int grid_x, const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = Tf32Bwd<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, heads, batch), 384, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/dout and the gradients are (B, H, S, D) with unit stride over D and
// the given element strides for batch, head and sequence (bf16: multiples of
// 8 and 16-byte aligned, checked by the caller); lse and adj = dlse - delta
// are contiguous fp32 (B, H, Sq).  Each returns 0 on success, the launch's
// cudaError_t, or minus the CUresult of a bf16 tensor map that failed to
// encode.

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
    if (head_dim == 64) return launch_dq_bf16<64>(p, batch, heads, s);
    if (head_dim == 128) return launch_dq_bf16<128>(p, batch, heads, s);
  } else {
    const int grid_x = (sq + kOwnRows - 1) / kOwnRows;
    if (head_dim == 64) return launch_tf32x3<64>(flash_bwd_dq_tf32x3<64>, grid_x, p, batch, heads, s);
    if (head_dim == 128) return launch_tf32x3<128>(flash_bwd_dq_tf32x3<128>, grid_x, p, batch, heads, s);
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
    if (head_dim == 64) return launch_dkv_bf16<64>(p, batch, heads, s);
    if (head_dim == 128) return launch_dkv_bf16<128>(p, batch, heads, s);
  } else {
    const int grid_x = (skv + kOwnRows - 1) / kOwnRows;
    if (head_dim == 64) return launch_tf32x3<64>(flash_bwd_dkv_tf32x3<64>, grid_x, p, batch, heads, s);
    if (head_dim == 128) return launch_tf32x3<128>(flash_bwd_dkv_tf32x3<128>, grid_x, p, batch, heads, s);
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the kernels at head dim `head_dim` (0 if it is not taken)
extern "C" int flash_attention_bwd_dq_smem(int head_dim) {
  return head_dim == 64 ? DqLayout<64>::kBytes : head_dim == 128 ? DqLayout<128>::kBytes : 0;
}

extern "C" int flash_attention_bwd_dkv_smem(int head_dim) {
  return head_dim == 64 ? DkvLayout<64>::kBytes : head_dim == 128 ? DkvLayout<128>::kBytes : 0;
}

// the same for both fp32 kernels, which share one layout
extern "C" int flash_attention_bwd_tf32x3_smem(int head_dim) {
  return head_dim == 64 ? Tf32Bwd<64>::kBytes : head_dim == 128 ? Tf32Bwd<128>::kBytes : 0;
}
