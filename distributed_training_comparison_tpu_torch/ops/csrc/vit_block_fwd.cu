// The fused pre-LN ViT block forward for Hopper (sm_90a), bound through
// plain C functions and loaded with ctypes (ops/vit_block.py).
//
// Replaces the TPU kernel distributed_training_comparison_tpu/ops/vit_block.py
// ::_block_fwd_kernel (K5, vit_block.py:166), which keeps a 512-row tile and
// every block weight in VMEM and runs LN1 -> qkv -> MHA -> out-proj + x ->
// LN2 -> gelu MLP + r1 in one body.  On Hopper neither fits in a block's
// 227 KB of shared memory (vit_tiny's bf16 weights alone are ~0.84 MiB, one
// item's K/V 192 KiB), so K5 is a chain of two kernels with its numerics:
//
// - block_gemm: C = epilogue(prologue(A) . W^T), the TPU kernel's _gemm
//   (vit_block.py:105), launched four times per block (LN1 + qkv; out-proj
//   + bias + x; LN2 + up + gelu; down + bias + r1).  Prologue: LayerNorm
//   over whole rows with fp32 statistics by E[x^2] - mu^2 (eps 1e-6),
//   gamma/beta in fp32, the row rounded to the compute dtype before the
//   product.  W is read as the fp32 nn.Linear weight (N, K), rounded to the
//   compute dtype, in up to three row segments (the q/k/v projections,
//   without a concatenation).  Epilogue: fp32 accumulator -> compute dtype
//   -> + bias (rounded to the compute dtype) -> optionally the tanh gelu
//   (fp32, rounded once) or + residual.
// - block_attention: one block per (item, head, 64-query tile), q/k/v read
//   as column slices of the packed (B*S, 3*dim) qkv.  The softmax is exact,
//   as _softmax_small's (attention_small.py::head_fwd): fp32 scores times
//   the scale, keys past S at -1e30, P = exp(s - max) / sum over the row's
//   whole key set, rounded to the compute dtype before P.V, O accumulated in
//   fp32 and rounded once.  Non-causal.
//
// What bounds block_gemm: at the vit_tiny --patch-size 2 shapes (M 8192 rows
// at serve bucket 32, 32768 in training; K and N 192-768) a product does
// 2MNK operations on the 2M(K + N) bytes of A and C, NK / (N + K) = 96-154
// FLOP a byte, under the H100's ~295: every launch is bound by bytes (the
// four together move ~56 MB at the serve shape, 0.017 ms at 3.35 TB/s).
// The bf16 design (block_gemm_wgmma, block_gemm.cuh) answers that:
// - weight-stationary: a block owns one slab of up to 192 output columns for
//   the whole call and converts its fp32 W to bf16 once, into shared memory
//   in the swizzled layout wgmma reads; its grid is at most one block an SM,
//   each walking row tiles in an order fixed by its index;
// - A streams through one 4-stage TMA ring a consumer warpgroup (64 rows x
//   64 columns a stage, 128-byte swizzle), fed by a producer warp, so loads
//   run ahead of the products; rows past M and columns past K land as zeros;
// - every product is a wgmma m64nBNk16 from shared memory, fp32 in registers;
// - the LayerNorm prologue reads a tile's row statistics once (not once per
//   64-column block) and normalises each landed chunk in place;
// - the epilogue runs on the accumulators and stores the rounded result.
// fp32 (the entry point's default precision) runs block_gemm_tf32x3, the
// same function in 3xTF32 on wgmma (block_gemm_tf32.cuh): each product
// three tf32 products of split operands, fp32 accuracy; 192 x 64 output
// tiles, A' and W streamed through a ring the producer warpgroup fills with
// cp.async and splits in place, the LayerNorm applied as A' is split.  The
// chain still round-trips qkv and the MLP activation hmid through device
// memory; fusing those is later work.
//
// What bounds block_attention: bytes.  At the serve shape (B 32, S 256, 3
// heads of 64) it reads qkv and writes o, 4 B S dim x 2 bytes = 12.6 MB
// (0.0038 ms at 3.35 TB/s), against 4 B S^2 dim = 1.6 GFLOP (0.0016 ms at
// 989 TFLOP/s).  The bf16 design (block_attn_wgmma) reads each input once
// per block and keeps the rest on chip: a block per (item, head, 64-query
// tile) stages Q, and K and V of the whole item (32 KB each at S 256), once;
// every product is a wgmma (the helpers of attention_tiles.cuh); a row's
// every score is held in registers, so Q.K^T runs once and the max, the sum
// and P come in one pass: up to S 128 in one warpgroup, above in two that
// split the keys (two tiles each up to S 256, 64 registers of scores a
// thread, so that two blocks fit an SM; three or four above) and combine
// each row's max and sum, then their O partials, through shared memory in a
// fixed order.  Two products per (64-query, 64-key) tile pair: Q.K^T and
// P.V.  fp32 runs block_attn_tf32x3 (below): 3xTF32 on wgmma, the flash
// forward's schedule over the packed qkv, 128 query rows a block.

#include "attention_tiles.cuh"
#include "block_gemm.cuh"
#include "block_gemm_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jax.nn.gelu's tanh approximation, in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

// ------------------------------------------------------------ block_gemm

struct GemmParams {
  const void* a;        // (m, k) compute dtype, contiguous
  const float* w[3];    // row segments of W (n, k): seg rows each, fp32
  const float* bias[3]; // their biases, fp32
  const float* ln_g;    // LayerNorm prologue (fp32, k) or null
  const float* ln_b;
  const void* res;      // residual (m, n) compute dtype, or null
  void* c;              // (m, n) compute dtype
  int m, n, k, seg;
  int gelu;
};

// the 16 bytes of `v` as 8 floats
__device__ __forceinline__ void chunk_floats(uint4 v, float (&out)[8], bf16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its fp32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// K5's products in bf16, weight-stationary (block_gemm.cuh): blockIdx.x owns
// the slab of output columns [BN * blockIdx.x, + BN), converted from W once;
// each warpgroup walks its 64-row tiles of A through its ring.  With the
// LayerNorm prologue the A fragments are normalised in registers: a quad's
// four threads share two rows, whose fp32 statistics (E[x^2] - mu^2) they
// take from the rows in global memory, each a quarter of the columns; each
// k-step's fragment is read from the landed stage, normalised (gamma, beta
// fp32), rounded to bf16 and fed to wgmma from registers, so no thread
// waits on another's.  The epilogue loads its residual before any store,
// then rounds the accumulator, adds the rounded bias, rounds, and applies
// the gelu or adds the residual, rounded.
template <int BN>
__global__ void __launch_bounds__(bgemm::kThreads, 1)
    block_gemm_wgmma(const GemmParams p, const __grid_constant__ CUtensorMap ta) {
  using namespace bgemm;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const WsBlock B(gemm_smem, p.m, p.k, BN);
  float* bias = reinterpret_cast<float*>(B.smem + B.L.bias);  // the slab's rounded bias
  if (threadIdx.x < BN) {
    const int col = B.n0 + threadIdx.x;
    bias[threadIdx.x] = col < p.n ? round_bf16(__ldg(weight_row(p.bias, p.seg, col, 1))) : 0.f;
  }
  ws_start<BN, true>(B, &ta, p.w, p.seg, p.n, p.k);  // its closing barrier covers the bias

  const int tid = threadIdx.x, n0 = B.n0;
  const int lane = tid % 32, wq = tid % 128 / 32, g = lane / 4, t4 = lane % 4;
  const bf16* a = static_cast<const bf16*>(p.a);
  float mu[2], rs[2];  // LayerNorm statistics of this thread's rows 16 wq + g + 8 i
  auto begin = [&](int m0) {
    if (!p.ln_g) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 16 * wq + g + 8 * i;
      float s = 0.f, ss = 0.f;
      if (row < p.m) {
        const bf16* ar = a + static_cast<long long>(row) * p.k;
#pragma unroll 6
        for (int c = 8 * t4; c < p.k; c += 32) {
          float x[8];
          chunk_floats(*reinterpret_cast<const uint4*>(ar + c), x, bf16());
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s += x[e];
            ss += x[e] * x[e];
          }
        }
      }
      s = quad_sum(s);
      ss = quad_sum(ss);
      mu[i] = s / p.k;
      rs[i] = 1.f / sqrtf(ss / p.k - mu[i] * mu[i] + kLnEps);
    }
  };
  auto multiply = [&](float* acc, uint32_t stage, int kc) {
    if (!p.ln_g) {
      mma_ss<BN>(acc, B.base, stage, kc);
      return;
    }
    // A's fragment of k-step kk: rows 16 wq + g + 8 i, columns 16 kk + 2 t4 + 8 h
    // (+ 0, 1), i.e. 16-byte chunk 2 kk + h of the swizzled row, bytes 4 t4 on
    uint32_t frag[kDepth / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kc * kDepth + 16 * kk + 8 * h + 2 * t4;
        const float2 gm = k < p.k ? __ldg(reinterpret_cast<const float2*>(p.ln_g + k)) : float2{0.f, 0.f};
        const float2 bt = k < p.k ? __ldg(reinterpret_cast<const float2*>(p.ln_b + k)) : float2{0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * wq + g + 8 * i;
          uint32_t x2;
          asm volatile("ld.shared.u32 %0, [%1];\n"
                       : "=r"(x2)
                       : "r"(stage + r * 128 + (((2 * kk + h) ^ (r % 8)) << 4) + 4 * t4));
          const float x0 = __uint_as_float(x2 << 16), x1 = __uint_as_float(x2 & 0xffff0000u);
          frag[kk][2 * h + i] = pack_f32_to_bf16((x0 - mu[i]) * rs[i] * gm.x + bt.x,
                                                 (x1 - mu[i]) * rs[i] * gm.y + bt.y);
        }
      }
    }
    fence_regs<kDepth / 4>(&frag[0][0]);
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      wgmma_rs<BN, 0>(acc, frag[kk], smem_desc(B.base + kc * BN * 128 + kk * 32, 16, 1024),
                      kc > 0 || kk > 0);
    }
    fence_regs<kDepth / 4>(&frag[0][0]);
  };
  auto epilogue = [&](float (&acc)[BN / 2], int m0) {
    // this thread's rows 16 wq + g + 8 i, columns n0 + 8 j + 2 t4 and + 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 16 * wq + g + 8 * i;
      const long long at = static_cast<long long>(row) * p.n + n0;
      uint32_t r2[BN / 8], out[BN / 8];  // the residual is loaded before any store
      if (p.res) load_row<BN>(r2, static_cast<const bf16*>(p.res) + at, p.n - n0, row < p.m);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t4);
        float v0 = round_bf16(round_bf16(acc[4 * j + 2 * i]) + b.x);
        float v1 = round_bf16(round_bf16(acc[4 * j + 2 * i + 1]) + b.y);
        if (p.gelu) {
          v0 = round_bf16(gelu_tanh(v0));
          v1 = round_bf16(gelu_tanh(v1));
        }
        if (p.res) {
          v0 = round_bf16(v0 + __uint_as_float(r2[j] << 16));
          v1 = round_bf16(v1 + __uint_as_float(r2[j] & 0xffff0000u));
        }
        out[j] = pack_f32_to_bf16(v0, v1);
      }
      store_row<BN>(out, static_cast<bf16*>(p.c) + at, p.n - n0, row < p.m);
    }
  };
  ws_consume<BN>(B, &ta, begin, multiply, epilogue);
}

// K5's products in fp32, 3xTF32 on wgmma (block_gemm_tf32.cuh's core): A'
// the activation rows as stored, normalised as they are split where the
// LayerNorm is given; B' the weight rows as stored, in their segments.  The
// epilogue adds the bias, then applies the tanh gelu or adds the residual,
// all in fp32 (the compute dtype's roundings are none).
__global__ void __launch_bounds__(tgemm::kThreads, 1) block_gemm_tf32x3(const GemmParams p) {
  using namespace tgemm;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const float* a = static_cast<const float*>(p.a);
  const Operand A{{a, a, a}, p.m, p.k, p.m};
  const Operand W{{p.w[0], p.w[1], p.w[2]}, p.seg, p.k, p.n};
  float* out = static_cast<float*>(p.c);
  const float* res = static_cast<const float*>(p.res);
  run<false, false>(
      aligned_smem(gemm_smem), A, W, Tiles(p.m, p.n, p.k, p.k).at(blockIdx.x), p.ln_g, p.ln_b, [](int) {}, [] {},
      [&](const float (&acc)[32], int row, int col) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
          const int cc = col + 8 * n;
          if (cc >= p.n) continue;
          const float* bias = bgemm::weight_row(p.bias, p.seg, cc, 1);  // cc and cc + 1: one segment
          const float b0 = __ldg(bias), b1 = __ldg(bias + 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = row + 8 * i;
            if (r >= p.m) continue;
            const long long at = static_cast<long long>(r) * p.n + cc;
            float v0 = acc[4 * n + 2 * i] + b0, v1 = acc[4 * n + 2 * i + 1] + b1;
            if (p.gelu) {
              v0 = gelu_tanh(v0);
              v1 = gelu_tanh(v1);
            }
            if (res) {
              const float2 r2 = *reinterpret_cast<const float2*>(res + at);
              v0 += r2.x;
              v1 += r2.y;
            }
            *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
          }
        }
      });
}

// ------------------------------------------------------- block_attention

struct AttnParams {
  const void* qkv;  // (batch * seq, 3 * dim), q | k | v, heads head-major in each
  void* o;          // (batch * seq, dim)
  int seq, dim;
  float scale;
};

constexpr int kHeadDim = 64;     // bf16: the one head dim of a zoo model the fusion gate fuses

// blocks an SM that block_attn_wgmma<NTW, WG> is built for: two of two
// warpgroups holding two key tiles each (128 registers a thread)
__host__ __device__ constexpr int attn_blocks_per_sm(int ntw, int wg) { return wg == 2 && ntw <= 2 ? 2 : 1; }

// dynamic shared memory of block_attn_wgmma<NTW, WG>: Q (64 rows), K and V
// (all of the item's keys, NTW x WG tiles), the row exchange (2 slots), the
// O partials of warpgroups past the first, alignment slack
template <int NTW, int WG>
__host__ __device__ constexpr int attn_wgmma_smem() {
  return box_bytes<64>() + 2 * box_bytes<64 * NTW * WG>() + 2 * WG * 64 * 4 +
         (WG - 1) * (kHeadDim / 2) * kWarpgroup * 4 + 1024;
}

// K5's attention in bf16 at head dim 64: the 64 query rows [64 blockIdx.x,
// + 64) of item blockIdx.z, head blockIdx.y, against every key of the item.
// Q, K and V come by cp.async into 128-byte-swizzled tiles, K and V whole
// and once (V lands under the score product).  Each of the WG warpgroups
// owns NTW 64-key tiles: S = Q.K^T by wgmma from shared memory (both
// K-major) into registers, the scores once; the row max and sum over the
// row's whole key set (combined across the warpgroups through shared memory
// in warpgroup order), P = e / sum rounded to bf16 as the A fragments of
// O = P.V (V MN-major); the warpgroups' O partials are added in warpgroup
// order and rounded once.  Keys past S are masked; query rows past S are
// computed on zero rows and not written.
template <int NTW, int WG>
__global__ void __launch_bounds__(kWarpgroup * WG, attn_blocks_per_sm(NTW, WG)) block_attn_wgmma(const AttnParams p) {
  constexpr int D = kHeadDim, KROWS = 64 * NTW * WG, kAll = kWarpgroup * WG;
  constexpr int kTile = box_bytes<64>();  // one 64-row tile: 8 KB
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u, ks = qs + kTile, vs = ks + box_bytes<KROWS>();
  float* red = reinterpret_cast<float*>(smem_raw + (vs + box_bytes<KROWS>() - raw));
  float* part = red + 2 * WG * 64;
  const int m0 = blockIdx.x * 64, h = blockIdx.y, tid = threadIdx.x, t0 = tid / kWarpgroup * NTW;
  const long long ld = 3LL * p.dim;
  const bf16* item = static_cast<const bf16*>(p.qkv) + static_cast<long long>(blockIdx.z) * p.seq * ld + h * D;
  load_swizzled<D, 64, kAll>(qs, item + m0 * ld, ld, p.seq - m0, tid);
  load_swizzled<D, KROWS, kAll>(ks, item + p.dim, ld, p.seq, tid);
  cp_async_commit();
  load_swizzled<D, KROWS, kAll>(vs, item + 2 * p.dim, ld, p.seq, tid);
  tiles_landed<1>();  // Q and K; V may still be in flight

  float s[NTW][32], mx[2], sum[2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NTW; ++j) wgmma_abt<D, 64, KROWS>(s[j], qs, ks + (t0 + j) * kTile);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NTW; ++j) fence_regs<32>(s[j]);
  softmax_rows(s, p.scale, [&](int, int col) { return 64 * t0 + col < p.seq; }, 64, SharedRows<WG>{red},
               mx, sum);
  uint32_t pa[NTW][4][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) pack_a(pa[j], s[j]);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  tiles_landed<0>();  // V
  fence_regs<D / 2>(o);
  fence_regs<16 * NTW>(&pa[0][0][0]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[j][kk], desc_mnmajor<KROWS>(vs + (t0 + j) * kTile, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  fence_regs<16 * NTW>(&pa[0][0][0]);
  sum_partials<WG>(o, part);
  if (tid < kWarpgroup)
    store_acc<D>(static_cast<bf16*>(p.o) + (static_cast<long long>(blockIdx.z) * p.seq + m0) * p.dim + h * D, o,
                 p.dim, p.seq - m0);
}

// the bf16 block_gemm: A's map encoded here, per call
template <int BN>
int launch_gemm_bf16(const GemmParams& p, cudaStream_t s) {
  using namespace bgemm;
  const int kpad = padded_depth(p.k);
  if (kpad * BN * 2 > kSlabBytes) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap ta;
  const CUresult r = encode_rows(&ta, p.a, p.m, p.k);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int sms = 0;
  const cudaError_t err = prepare<&block_gemm_wgmma<BN>>(ws_most_bytes(BN), &sms);
  if (err != cudaSuccess) return err;
  block_gemm_wgmma<BN><<<ws_grid(p.m, p.n, BN, sms), bgemm::kThreads, WsLayout(kpad, BN).bytes, s>>>(p, ta);
  return cudaGetLastError();
}

template <int NTW, int WG>
cudaError_t launch_attention_wgmma(const AttnParams& p, int batch, int heads, cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&block_attn_wgmma<NTW, WG>>(attn_wgmma_smem<NTW, WG>(), &sms);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + 63) / 64, heads, batch);
  block_attn_wgmma<NTW, WG><<<grid, kWarpgroup * WG, attn_wgmma_smem<NTW, WG>(), s>>>(p);
  return cudaGetLastError();
}

// bf16: items of up to two key tiles take one warpgroup, which holds a
// query row's every score (S <= 128); up to four (S <= 256), two warpgroups
// of two tiles each; up to eight (S <= 512), two of three or four
cudaError_t launch_attention_bf16(const AttnParams& p, int batch, int heads, cudaStream_t s) {
  switch ((p.seq + 63) / 64) {
    case 1: return launch_attention_wgmma<1, 1>(p, batch, heads, s);
    case 2: return launch_attention_wgmma<2, 1>(p, batch, heads, s);
    case 3:
    case 4: return launch_attention_wgmma<2, 2>(p, batch, heads, s);
    case 5:
    case 6: return launch_attention_wgmma<3, 2>(p, batch, heads, s);
    case 7:
    case 8: return launch_attention_wgmma<4, 2>(p, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

int attention_bf16_smem(int seq) {
  switch ((seq + 63) / 64) {
    case 1: return attn_wgmma_smem<1, 1>();
    case 2: return attn_wgmma_smem<2, 1>();
    case 3:
    case 4: return attn_wgmma_smem<2, 2>();
    case 5:
    case 6: return attn_wgmma_smem<3, 2>();
    case 7:
    case 8: return attn_wgmma_smem<4, 2>();
    default: return 0;
  }
}

// ------------------------------------------------ block_attention, fp32
//
// K5's attention in fp32: 3xTF32 on wgmma, on tf32x3.cuh's split, ring and
// products, flash_fwd_tf32x3's schedule (flash_attention_fwd.cu) over the
// packed qkv: a block owns 128 query rows of one (item, head), two consumer
// warpgroups of 64 and a producer warpgroup.  Each consumer warpgroup
// splits its Q rows once into slots of its own; per 64-key tile K runs
// through the ring as DP / 32 natural slots (S = Q.K^T, each score computed
// once) and V as 2 x DP / 64 transposed ones, the keys in the fragments'
// order (O += P.V, a fresh accumulator a tile); the softmax is online, in
// fp32, rescaling O by each tile's change of the row max.  The head dim D
// (a multiple of 16 up to 128) is padded to DP, 64 or 128: the copies take
// no column at or past D (the next head's), so the padding is zeros, and
// the stores write none.  Non-causal; keys past S are masked, query rows
// past S computed on zero rows and not written.

constexpr int kTf32Rows = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int kTf32Keys = 64;   // keys a streamed tile: the slots' rows
constexpr float kLog2e = 1.4426950408889634f;

struct AttnF32Params {
  const float* qkv;  // (batch * seq, 3 * dim)
  float* o;          // (batch * seq, dim)
  int seq, dim, head_dim;
  float scale;
};

template <int DP>
using Tf32Attn = Tf32Layout<DP, 4>;  // own rows: Q of 2 warpgroups, split: big and small

template <int DP>
__global__ void __launch_bounds__(384, 1) block_attn_tf32x3(const AttnF32Params p) {
  using L = Tf32Attn<DP>;
  constexpr int kN = kTf32Keys;
  constexpr int kPerTile = DP / 32 + 2 * (DP / 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  const int m0 = blockIdx.x * kTf32Rows, h = blockIdx.y, D = p.head_dim;
  const int nk = (p.seq + kN - 1) / kN;
  const int tid = threadIdx.x;
  const long long ld = 3LL * p.dim;
  const float* qg = p.qkv + static_cast<long long>(blockIdx.z) * p.seq * ld + h * D;
  const float* kg = qg + p.dim;
  const float* vg = qg + 2 * p.dim;

  ring_init(bars, tid);

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    auto slot_of = [&](int u) {
      const int r = u % kPerTile, n0 = u / kPerTile * kN;
      if (r < DP / 32) return SlotSrc{kg, kg, ld, ld, n0, p.seq, 32 * r, false};
      const int idx = r - DP / 32;  // column block idx / 2, key chunk idx % 2
      return SlotSrc{vg, vg, ld, ld, n0 + 32 * (idx % 2), p.seq, 64 * (idx / 2), true};
    };
    produce<kSlotRows, true>(slot_of, nk * kPerTile, sbase + L::kRingAt, bars, tid, D);
    return;  // the two roles never reconverge, or setmaxnreg would not hold
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  const int c = tid / 128 - 1;  // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + 64 * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const float sl2 = p.scale * kLog2e;
  // the warpgroup's 64 Q rows split once into DP / 32 slots of its own
  const int wtid = tid % 128;
  const uint32_t q_at = base + c * (DP / 32) * kSlotBytes;
#pragma unroll
  for (int cc = 0; cc < DP / 32; ++cc)
    slot_issue<kSlotRows, true>(q_at + cc * kSlotBytes,
                                SlotSrc{qg, qg, ld, ld, m0 + 64 * c, p.seq, 32 * cc, false}, wtid, D);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int cc = 0; cc < DP / 32; ++cc) slot_split(sbase + (q_at - base) + cc * kSlotBytes, false, wtid);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");  // the warpgroup's Q is split
  const uint32_t ring = base + L::kRingAt;

  float o[DP / 64][32];
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in units of scale·log2e
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum

  int u = 0;
  for (int j = 0; j < nk; ++j) {
    // S = Q.K_j^T: each slot's products queued behind the previous slot's
    float s[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < DP / 32; ++cc) {
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
    consumer_release(bars, u + DP / 32 - 1, lane);
    u += DP / 32;
    const int n0 = j * kN;
    if (n0 + kN > p.seq) {  // the last tile: keys past S
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * n + 2 * t + (e & 1) >= p.seq) s[4 * n + e] = kNegInf;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
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
    for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
    uint32_t big[kN / 8][4], small[kN / 8][4];
    acc_frags<kN / 8>(big, small, s);
    sums<DP, kN / 8>(o, big, small, ring, bars, u, lane);
  }

  float* og = p.o + static_cast<long long>(blockIdx.z) * p.seq * p.dim + h * D;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(quad_sum(l_run[i]), 1e-30f);
#pragma unroll
  for (int hh = 0; hh < DP / 64; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] *= inv[(i >> 1) & 1];
    store_f32_cols(og, p.dim, row0, p.seq, 64 * hh, D - 64 * hh, o[hh], t);
  }
}

template <int DP>
cudaError_t launch_attention_tf32x3(const AttnF32Params& p, int batch, int heads, cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = bgemm::prepare<&block_attn_tf32x3<DP>>(Tf32Attn<DP>::kBytes, &sms);
  if (err != cudaSuccess) return err;
  block_attn_tf32x3<DP><<<dim3((p.seq + kTf32Rows - 1) / kTf32Rows, heads, batch), 384, Tf32Attn<DP>::kBytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C = epilogue(prologue(A) . W^T) over contiguous row-major tensors: A (m, k)
// and C, res (m, n) in the compute dtype (bf16 when is_bf16, else fp32); W's
// rows n come from w0/w1/w2 (seg rows each, fp32 (seg, k)), with biases
// b0/b1/b2; ln_g/ln_b (fp32, k) or null; res or null; gelu 0/1.  k and n are
// multiples of 16 and every pointer 16-byte aligned (checked by the caller).
// bf16 runs the weight-stationary kernel with slabs of bn columns (8, 16,
// 32 or 64; a bf16 slab of padded k by bn at most kSlabBytes); fp32 runs
// the 3xTF32 kernel and ignores bn.  Returns 0 on success, the launch's
// cudaError_t, or minus the CUresult of a tensor map that failed to encode.
extern "C" int vit_block_gemm(const void* a, const void* w0, const void* w1, const void* w2,
                              const void* b0, const void* b1, const void* b2, const void* ln_g,
                              const void* ln_b, const void* res, void* c, int m, int n, int k,
                              int seg, int gelu, int is_bf16, int bn, void* stream) {
  GemmParams p{};
  p.a = a;
  p.w[0] = static_cast<const float*>(w0);
  p.w[1] = static_cast<const float*>(w1);
  p.w[2] = static_cast<const float*>(w2);
  p.bias[0] = static_cast<const float*>(b0);
  p.bias[1] = static_cast<const float*>(b1);
  p.bias[2] = static_cast<const float*>(b2);
  p.ln_g = static_cast<const float*>(ln_g);
  p.ln_b = static_cast<const float*>(ln_b);
  p.res = res;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.seg = seg;
  p.gelu = gelu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (bn) {
      case 8: return launch_gemm_bf16<8>(p, s);
      case 16: return launch_gemm_bf16<16>(p, s);
      case 32: return launch_gemm_bf16<32>(p, s);
      case 64: return launch_gemm_bf16<64>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return tgemm::launch<&block_gemm_tf32x3>(tgemm::Tiles(m, n, k, k), s, p);
}

// dynamic shared memory of the bf16 block_gemm kernel at depth k and slab
// width bn (0 if the slab is above kSlabBytes)
extern "C" int vit_block_gemm_smem(int k, int bn) {
  const int kpad = bgemm::padded_depth(k);
  return kpad * bn * 2 > bgemm::kSlabBytes ? 0 : bgemm::WsLayout(kpad, bn).bytes;
}

// dynamic shared memory of the fp32 (3xTF32) block_gemm kernel, any shape
extern "C" int vit_block_gemm_tf32x3_smem() { return tgemm::kSmemBytes; }

// Attention of the packed qkv (batch * seq, 3 * heads * head_dim) into o
// (batch * seq, heads * head_dim), both contiguous and 16-byte aligned.  bf16
// takes head_dim 64 and seq up to 512 (block_attn_wgmma); fp32 head_dim a
// multiple of 16 up to 128 (block_attn_tf32x3, the head dim padded to 64 or
// 128) and any seq.  Returns the launch's cudaError_t (0 on success).
extern "C" int vit_block_attention(const void* qkv, void* o, int batch, int seq, int heads,
                                   int head_dim, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const AttnParams p{qkv, o, seq, heads * head_dim, scale};
    return head_dim == kHeadDim ? launch_attention_bf16(p, batch, heads, s) : cudaErrorInvalidValue;
  }
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return cudaErrorInvalidValue;
  const AttnF32Params p{static_cast<const float*>(qkv), static_cast<float*>(o), seq, heads * head_dim, head_dim,
                        scale};
  return head_dim <= 64 ? launch_attention_tf32x3<64>(p, batch, heads, s)
                        : launch_attention_tf32x3<128>(p, batch, heads, s);
}

// dynamic shared memory of the bf16 attention kernel for items of seq
// tokens (0 above 512)
extern "C" int vit_block_attention_smem(int seq) { return attention_bf16_smem(seq); }

// dynamic shared memory of the fp32 (3xTF32) attention kernel at head dim
// head_dim (0 if it is not taken)
extern "C" int vit_block_attention_tf32x3_smem(int head_dim) {
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return 0;
  return head_dim <= 64 ? Tf32Attn<64>::kBytes : Tf32Attn<128>::kBytes;
}
