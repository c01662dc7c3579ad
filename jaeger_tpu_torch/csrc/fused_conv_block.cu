// Fused SAME conv1d + bias/DYT + mask + residual + activation for Hopper.
//
// Port of the Pallas TPU kernel jaeger_tpu/ops/pallas_conv.py:70
// fused_conv_block (body `_kernel`, :40-63). For x (N, L, C) channels-last
// and w (K, C, C):
//
//   acc[n, l, :] = sum_j x[n, l + j - pad_l, :] @ w[j]        (f32 accumulate)
//   y = acc (+ bias) ; DYT: y = tanh(y * alpha) * gamma + beta
//   y = out_mask ? y : +0.0 ; y += residual ; y = act(y)      (written in x's type)
//
// SAME padding, stride 1, dilation 1, pad_l = (K - 1) / 2. Halo rows outside
// [0, L) and rows whose in_mask is false read as zero (the masked conv's input
// pre-zero). Every pointer but x, w and out may be null.
//
// What bounds it on the H100: at the flagship shape (N = 12288, L = 500,
// C = 128, K = 5) one call is 1.0e12 bf16 FLOPs, 1.0e12 / 989 TFLOP/s =
// 1.018 ms, against 3.15 GB of bf16 in and out (0.94 ms at 3.35 TB/s): bound
// by operations. The conv2 form also reads the residual, 4.72 GB / 3.35 TB/s
// = 1.409 ms: bound by bytes.
//
// bf16: conv_bf16_wgmma, a persistent warp-specialised kernel.
//  * Schedule: about one CTA per SM (the count comes from the wrapper). CTA b
//    owns output column block b % n_cb (CB channels) and walks the tiles
//    (n, 64 positions) b / n_cb, + G / n_cb, ...; neighbouring CTAs take the
//    same x tile for other column blocks, so they share it in L2.
//  * Weights resident: each CTA stages w[:, :, col0:col0+CB] once, transposed
//    to K-major (C_out rows of C_in, the layout wgmma's B descriptor reads
//    without the transpose bit) and swizzled, and keeps it in shared memory
//    for every tile. (The old kernel restaged all K*C*C weights per 128
//    positions, 8.1 GB of L2 traffic per call with nothing in flight.)
//  * x tiles with their halo by TMA: a 3-D tensor map over (N, L, C), boxes
//    of 64 + K - 1 rows x KW channels (KW = 64, 32 or 16, the swizzle width:
//    128, 64 or 32 bytes). Halo rows before 0 and past L - 1 are outside the
//    tensor and arrive as zeros, never as the neighbouring sequence's rows.
//    A ring of 2-4 stages with full/empty mbarriers, fed by one thread of the
//    producer warpgroup.
//  * wgmma m64nCBk16, f32 accumulators in registers. A (x rows shifted by tap
//    j) comes from registers via ldmatrix at swizzle-aware addresses: a
//    shared-memory descriptor cannot start at row j of a swizzled tile unless
//    j % 8 == 0, and the shift is exactly what the conv needs. Rows that
//    in_mask masks are zeroed in the A registers. B (w[j]) comes from a
//    descriptor over the resident weights. wgmmas go in groups of one
//    KW-channel chunk (KW / 16 steps); two A register sets let the next
//    group's ldmatrix overlap the running group (wait_group 1). (The old
//    WMMA tiles reloaded every B fragment through the register file, ~1.5 MB of shared
//    memory reads per CTA, and mma.sync cannot reach the tensor-core rate.)
//  * Epilogue from the accumulator registers: the per-channel bias, alpha,
//    gamma and beta come from shared memory (staged once per CTA), not from
//    global memory per element; alpha * bias is folded into the DYT's FMA;
//    tanh is tanh.approx.f32 (one MUFU op; its relative error, about 2^-11,
//    is below bf16's output rounding of 2^-8). The residual and out_mask
//    rows are loaded into registers before the products, so their latency
//    hides behind them. The output tile goes through the x stage it was
//    computed from (swizzled, conflict-free) and out by a TMA store, which
//    clips rows past L; the stage returns to the producer once TMA has read
//    it. (The old epilogue did two tanhf and four global parameter loads per
//    element through an f32 staging tile, and stored 4 bytes a thread.)
//  * Overlap: two consumer warpgroups take the CTA's tiles in turn and pass
//    the tensor cores to each other with named barriers once their products
//    are issued, so one warpgroup's epilogue runs while the other's wgmmas
//    run. (The old kernel ran load, five tap rounds and epilogue in series
//    within a CTA.)
//  * Threads: 2 consumer warpgroups + 1 producer warpgroup = 384, one CTA
//    per SM. setmaxnreg gives the producer 40 registers a thread and each
//    consumer 232 (128 x (40 + 2 x 232) = 64,512 of the SM's 65,536): a
//    warpgroup's 64 x 128 f32 accumulator is 64 registers a thread, two sets
//    of 4 A fragments 32 and the prefetched residual 32.
//  * Shared memory (flagship, C = 128, K = 5, CB = 128, KW = 64, 3 stages):
//    weights 5 * 128 * 128 * 2 = 163,840 B; ring 3 x (2 chunks x 9,216 B,
//    68 rows x 128 B rounded up to 1 KB) = 55,296 B; parameters 4 * CB * 4 =
//    2,048 B; barriers 48 B; alignment slack 1,024 B: 222,256 of 232,448 B.
//    The plan (CB, KW, stages, bytes) is made in one place, the wrapper's
//    conv_plan (ops/fused_conv.py); the entry below recomputes the layout and
//    refuses a plan that disagrees with it.
//
// f32: conv_f32_fma, plain FMAs in full precision (no TF32), one CTA per (row,
// 64 positions, column block), input tile and one weight tap at a time in
// shared memory. Not on the default (bf16) path.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (jaeger_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int ACT_NONE = 0;
constexpr int ACT_RELU = 1;
constexpr int ACT_TANH = 2;
constexpr int ACT_GELU = 3;       // exact erf form
constexpr int ACT_GELU_TANH = 4;  // tanh approximation

struct Params {
  const void* x;
  const void* w;
  const float* bias;       // (C,) or null
  const float* dyt;        // (3, C): alpha, gamma, beta rows, or null
  const uint8_t* in_mask;  // (N, L) or null
  const uint8_t* out_mask; // (N, L) or null
  const void* residual;    // (N, L, C) in x's type, or null
  void* out;               // (N, L, C) in x's type
  int L;
  int C;
  int K;
  int act;
};

__device__ __forceinline__ float act_fn(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.f);
    case ACT_TANH:
      return tanhf(y);
    case ACT_GELU:
      return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));
    case ACT_GELU_TANH: {
      const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.f + tanhf(u));
    }
    case ACT_NONE:
    default:
      return y;
  }
}

__device__ __forceinline__ float epilogue(float acc, const Params& p, int c,
                                          long long row, float res) {
  float y = acc;
  if (p.bias) y += p.bias[c];
  if (p.dyt) y = tanhf(y * p.dyt[c]) * p.dyt[p.C + c] + p.dyt[2 * p.C + c];
  if (p.out_mask && !p.out_mask[row]) y = 0.f;
  if (p.residual) y += res;
  return act_fn(y, p.act);
}

// ---------------------------------------------------------------------------
// bf16: persistent wgmma kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TL = 64;                      // output rows per tile: wgmma M
constexpr int CONSUMERS = 2;                // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int SMEM_LIMIT = 232448;          // dynamic shared memory per block

// Shared-memory layout, byte offsets from a 1024-byte aligned base:
// [weights: K * (C / KW) regions of CB rows x KW * 2 bytes]
// [x ring: stages x (C / KW) regions of rows x KW * 2 bytes, each 1 KB aligned]
// [bias, alpha, gamma, beta: 4 x CB f32] [full, empty mbarriers: 2 x stages]
struct Layout {
  int stages;
  int rows;         // TL + K - 1
  int n_cb;         // C / CB column blocks
  int l_tiles;      // ceil(L / TL)
  int m_tiles;      // n_rows * l_tiles
  uint32_t region;  // bytes of one x chunk
  uint32_t stage;   // bytes of one ring stage
  uint32_t tx;      // TMA bytes per stage
  uint32_t off_x, off_par, off_bar, bytes;
};

inline uint32_t align1k(uint32_t v) { return (v + 1023u) & ~1023u; }

// false if (cb, kw, stages) cannot hold this shape
bool make_layout(int n_rows, int L, int C, int K, int cb, int kw, int stages,
                 Layout* lay) {
  if (kw != 16 && kw != 32 && kw != 64) return false;
  if (C % kw || C % cb || stages < 2 || stages > 4) return false;
  // the TMA box is at most 256 rows; the in_mask bits fit one 64-bit word
  if (TL + K - 1 > 256 || K + TL / 8 > 64) return false;
  lay->stages = stages;
  lay->rows = TL + K - 1;
  lay->n_cb = C / cb;
  lay->l_tiles = (L + TL - 1) / TL;
  lay->m_tiles = n_rows * lay->l_tiles;
  lay->region = align1k((uint32_t)lay->rows * kw * 2);
  lay->stage = (uint32_t)(C / kw) * lay->region;
  lay->tx = (uint32_t)lay->rows * C * 2;
  lay->off_x = align1k((uint32_t)K * C * cb * 2);
  lay->off_par = lay->off_x + stages * lay->stage;
  lay->off_bar = lay->off_par + 16u * cb;
  lay->bytes = lay->off_bar + 16u * stages + 1024u;  // + alignment slack
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int CB, int KW>
__global__ void __launch_bounds__(THREADS, 1)
conv_bf16_wgmma(Params p, Layout lay, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap omap) {
  using namespace hopper;
  constexpr int R = CB / 2;  // accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int C = p.C, K = p.K, L = p.L, S = lay.stages;
  constexpr uint32_t RB = KW * 2;  // bytes per swizzled row
  const int nkc = C / KW;
  const int pad_l = (K - 1) / 2;
  const int tid = threadIdx.x;
  const int col0 = (blockIdx.x % lay.n_cb) * CB;
  const int m_first = blockIdx.x / lay.n_cb;
  const int m_step = gridDim.x / lay.n_cb;
  const int n_local = m_first < lay.m_tiles
                          ? (lay.m_tiles - m_first + m_step - 1) / m_step
                          : 0;
  const uint32_t x_s = base + lay.off_x;
  const uint32_t bar_s = base + lay.off_bar;
  float* par = reinterpret_cast<float*>(sbase + lay.off_par);

  // resident weights: w[j][ci][col0 + co] -> region (j, ci / KW), row co,
  // column ci % KW (K-major), swizzled like a TMA load of that width
  {
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
    constexpr int VEC = CB / 8;
    for (int i = tid; i < K * C * VEC; i += THREADS) {
      const int v = i % VEC, jc = i / VEC;  // jc = j * C + ci
      const int ci = jc % C, j = jc / C;
      const int4 val =
          *reinterpret_cast<const int4*>(w + (long long)jc * C + col0 + v * 8);
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&val);
      unsigned char* region = sbase + (uint32_t)(j * nkc + ci / KW) * CB * RB;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t off = (uint32_t)(v * 8 + t) * RB + (ci % KW) * 2;
        *reinterpret_cast<unsigned short*>(region + swizzle(off, RB)) = e[t];
      }
    }
    // par: bias (alpha * bias with DYT, folded into one FMA), alpha, gamma,
    // beta of this column block
    for (int c = tid; c < CB; c += THREADS) {
      const float b = p.bias ? p.bias[col0 + c] : 0.f;
      par[c] = b;
      if (p.dyt) {
        par[c] = p.dyt[col0 + c] * b;
        par[CB + c] = p.dyt[col0 + c];
        par[2 * CB + c] = p.dyt[C + col0 + c];
        par[3 * CB + c] = p.dyt[2 * C + col0 + c];
      }
    }
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_s + 8 * s, 1);             // full: the producer's arrival
      mbar_init(bar_s + 8 * (S + s), 1);       // empty: the storing thread
    }
    fence_barrier_init();
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      for (int i = 0; i < n_local; ++i) {
        const int s = i % S;
        const int m = m_first + i * m_step;
        const int n = m / lay.l_tiles, l0 = (m % lay.l_tiles) * TL;
        mbar_wait(bar_s + 8 * (S + s), ((i / S) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_s + 8 * s, lay.tx);
        for (int kc = 0; kc < nkc; ++kc)
          tma_load_3d(x_s + s * lay.stage + kc * lay.region, &xmap,
                      bar_s + 8 * s, kc * KW, l0 - pad_l, n);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    // ---- consumer warpgroups: tiles wg, wg + 2, ... of this CTA ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;       // fragment rows r0 and r0 + 8
    const int lrow = 16 * warp + (lane & 15);  // ldmatrix row of this lane
    const int lcol = (lane >> 4) * 8;          // ldmatrix column of this lane
    const int c_lane = 2 * (lane % 4);         // accumulator column in 8
    const int chunks = K * nkc;  // (tap, KW-channel chunk) pairs
    const uint64_t desc0 = smem_desc(base, RB);
    const uint32_t wtap = (uint32_t)nkc * CB * RB;  // weight bytes per tap
    const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.residual);
    float acc[R] = {};

    // the warpgroups take turns issuing their products (named barriers 1 and
    // 2): warpgroup 0 goes first
    if (wg == 1) named_bar_arrive(1, 2 * 128);
    for (int i = wg; i < n_local; i += CONSUMERS) {
      const int s = i % S;
      const int m = m_first + i * m_step;
      const int n = m / lay.l_tiles, l0 = (m % lay.l_tiles) * TL;
      // the epilogue's residual pairs ([2q]: row r0, [2q + 1]: row r0 + 8)
      // and out_mask bytes, loaded now so that they arrive during the
      // products
      const bool v0 = l0 + r0 < L, v1 = l0 + r0 + 8 < L;
      const long long row0 = (long long)n * L + l0 + r0;
      uint32_t rv[CB / 4];
      if (res) {
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          const uint32_t* r = reinterpret_cast<const uint32_t*>(
              res + row0 * C + col0 + 8 * q + c_lane);
          rv[2 * q] = v0 ? r[0] : 0u;
          rv[2 * q + 1] = v1 ? r[4 * C] : 0u;  // 8 rows of C bf16 further
        }
      }
      const bool z0 = p.out_mask && v0 && !p.out_mask[row0];
      const bool z1 = p.out_mask && v1 && !p.out_mask[row0 + 8];
      // bit t: the input row r0 + t of the tile (position l0 - pad_l + r0 + t)
      uint64_t keep = ~0ull;
      if (p.in_mask) {
        keep = 0;
        const uint8_t* mrow = p.in_mask + (long long)n * L;
        for (int t = 0; t < K + 8; ++t) {
          const int pos = l0 - pad_l + r0 + t;
          if (pos >= 0 && pos < L && mrow[pos]) keep |= 1ull << t;
        }
      }
      mbar_wait(bar_s + 8 * s, (i / S) & 1);
      const uint32_t xs = x_s + s * lay.stage;

      // One chunk: tap j, channels KW kc .. KW kc + KW - 1, KS = KW / 16
      // k16 steps. A: the x rows shifted by j, by ldmatrix at swizzled
      // addresses (row r of the chunk at r * RB, its 16-byte units XORed
      // with bits 7.. of r * RB); masked rows zeroed in the registers.
      // Returns the B descriptor of the chunk's first step; step t adds
      // 32 t bytes, (32 t) >> 4 = 2 t in the descriptor.
      constexpr int KS = KW / 16;
      const bool masked = p.in_mask != nullptr;
      int cj = 0, ckc = 0;  // the next chunk to load
      auto load_chunk = [&](uint32_t(&a)[KS][4]) -> uint64_t {
        const uint32_t row = lrow + cj;
        const uint32_t rbase = xs + ckc * lay.region + row * RB;
        const uint32_t sw = (((row * RB) >> 7) & (RB / 16 - 1)) << 4;
#pragma unroll
        for (int t = 0; t < KS; ++t)
          ldmatrix_x4(a[t], rbase + (((t * 16 + lcol) * 2) ^ sw));
        if (masked) {
          const bool z0 = !((keep >> cj) & 1), z1 = !((keep >> (cj + 8)) & 1);
#pragma unroll
          for (int t = 0; t < KS; ++t) {
            if (z0) a[t][0] = a[t][2] = 0u;
            if (z1) a[t][1] = a[t][3] = 0u;
          }
        }
        const uint64_t d = desc0 + ((cj * wtap + ckc * CB * RB) >> 4);
        if (++ckc == nkc) {
          ckc = 0;
          ++cj;
        }
        return d;
      };
      auto issue_chunk = [&](uint32_t(&a)[KS][4], uint64_t d, bool first) {
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < KS; ++t)
          wgmma_bf16_rs(acc, a[t], d + 2 * t, !(first && t == 0));
        wgmma_commit();
      };
      // two register sets: one chunk's wgmmas run while the next chunk's A
      // fragments are loaded, up to 2 KS wgmmas in flight
      uint32_t aA[KS][4], aB[KS][4];
      uint64_t dA = load_chunk(aA), dB;
      // wait for this warpgroup's turn on the tensor cores
      named_bar_sync(1 + wg, 2 * 128);
      for (int ch = 0;; ch += 2) {
        fence_regs(acc);
        issue_chunk(aA, dA, ch == 0);
        if (ch + 1 >= chunks) break;
        wgmma_wait<1>();  // chunk ch - 1, the last reader of set B, is done
        dB = load_chunk(aB);
        issue_chunk(aB, dB, false);
        if (ch + 2 >= chunks) break;
        wgmma_wait<1>();  // chunk ch, the last reader of set A, is done
        dA = load_chunk(aA);
      }
      // the products are issued: the other warpgroup (whose next tile is
      // i + 1) takes the tensor cores while this one runs its epilogue
      if (i + 1 < n_local) named_bar_arrive(2 - wg, 2 * 128);
      wgmma_wait<0>();
      fence_regs(acc);

      // ---- epilogue: column 8 q + c_lane (+1) of rows r0 (acc[4q], [4q+1])
      // and r0 + 8 (acc[4q+2], [4q+3]) ----
      if (p.dyt) {
        // tanh(alpha * (acc + bias)) * gamma + beta
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          const int c = 8 * q + c_lane;
          const float2 ab = *reinterpret_cast<const float2*>(par + c);
          const float2 al = *reinterpret_cast<const float2*>(par + CB + c);
          const float2 ga = *reinterpret_cast<const float2*>(par + 2 * CB + c);
          const float2 be = *reinterpret_cast<const float2*>(par + 3 * CB + c);
#pragma unroll
          for (int h = 0; h < 4; h += 2) {
            acc[4 * q + h] =
                fmaf(tanh_approx(fmaf(acc[4 * q + h], al.x, ab.x)), ga.x, be.x);
            acc[4 * q + h + 1] = fmaf(
                tanh_approx(fmaf(acc[4 * q + h + 1], al.y, ab.y)), ga.y, be.y);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          const float2 b =
              *reinterpret_cast<const float2*>(par + 8 * q + c_lane);
          acc[4 * q] += b.x;
          acc[4 * q + 1] += b.y;
          acc[4 * q + 2] += b.x;
          acc[4 * q + 3] += b.y;
        }
      }
      if (z0 || z1) {
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          if (z0) acc[4 * q] = acc[4 * q + 1] = 0.f;
          if (z1) acc[4 * q + 2] = acc[4 * q + 3] = 0.f;
        }
      }
      if (res) {
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // bf16 -> f32 is a 16-bit shift
            acc[4 * q + 2 * h] += __uint_as_float(rv[2 * q + h] << 16);
            acc[4 * q + 2 * h + 1] +=
                __uint_as_float(rv[2 * q + h] & 0xffff0000u);
          }
        }
      }
      switch (p.act) {
        case ACT_RELU:
#pragma unroll
          for (int e = 0; e < R; ++e) acc[e] = fmaxf(acc[e], 0.f);
          break;
        case ACT_TANH:
#pragma unroll
          for (int e = 0; e < R; ++e) acc[e] = tanh_approx(acc[e]);
          break;
        case ACT_GELU:
#pragma unroll
          for (int e = 0; e < R; ++e)
            acc[e] = 0.5f * acc[e] * (1.f + erff(acc[e] * 0.7071067811865476f));
          break;
        case ACT_GELU_TANH:
#pragma unroll
          for (int e = 0; e < R; ++e) {
            // 0.5 y (1 + tanh(sqrt(2 / pi) (y + 0.044715 y^3)))
            const float y = acc[e], hy = 0.5f * y;
            const float u =
                y * fmaf(0.7978845608028654f * 0.044715f, y * y,
                         0.7978845608028654f);
            acc[e] = fmaf(hy, tanh_approx(u), hy);
          }
          break;
        default:
          break;
      }
      // The stage's x rows are consumed: it takes the output tile, in
      // chunks of OW channels, 64 rows x OW * 2 bytes each, swizzled to that
      // width, and one thread stores it with TMA (rows past L are clipped),
      // waits until TMA has read it and hands the stage back to the
      // producer.
      constexpr int OW = CB < 64 ? CB : 64;
      constexpr uint32_t ORB = OW * 2;
      unsigned char* tile = sbase + (xs - base);
      named_bar_sync(3 + wg, 128);  // every warp's ldmatrix reads are done
#pragma unroll
      for (int q = 0; q < CB / 8; ++q) {
        unsigned char* chunk = tile + (8 * q / OW) * 8192;
        const uint32_t cc = (8 * q % OW + c_lane) * 2;
        *reinterpret_cast<__nv_bfloat162*>(
            chunk + swizzle(r0 * ORB + cc, ORB)) =
            __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            chunk + swizzle((r0 + 8) * ORB + cc, ORB)) =
            __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
      }
      fence_proxy_async();  // the generic writes before TMA reads them
      named_bar_sync(3 + wg, 128);
      if (tid % 128 == 0) {
        for (int oc = 0; oc < CB / OW; ++oc)
          tma_store_3d(&omap, xs + oc * 8192, col0 + oc * OW, l0, n);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(bar_s + 8 * (S + s));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA in full precision. CB * 4 threads; thread (c, g) computes column c
// for rows 16g..16g+15 of the CTA's 64 positions.
// ---------------------------------------------------------------------------

constexpr int F_TL = 64;
constexpr int F_RPT = 16;

__global__ void __launch_bounds__(512)
conv_f32_fma(Params p, int l_tiles, int CB) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, K = p.K, L = p.L;
  const int rows_in = F_TL + K - 1;
  float* xs = reinterpret_cast<float*>(smem);  // rows_in x C
  float* ws = xs + rows_in * C;                // C x CB

  const int n = blockIdx.x / l_tiles;
  const int l0 = (blockIdx.x % l_tiles) * F_TL;
  const int col0 = blockIdx.y * CB;
  const int pad_l = (K - 1) / 2;
  const int tid = threadIdx.x;
  const int c = tid % CB;
  const int g = tid / CB;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  for (int i = tid; i < rows_in * C; i += blockDim.x) {
    const int r = i / C, ci = i - r * C;
    const int pos = l0 - pad_l + r;
    float v = 0.f;
    if (pos >= 0 && pos < L) {
      const long long row = (long long)n * L + pos;
      if (!p.in_mask || p.in_mask[row]) v = x[row * C + ci];
    }
    xs[i] = v;
  }

  float acc[F_RPT];
#pragma unroll
  for (int r = 0; r < F_RPT; ++r) acc[r] = 0.f;

  for (int j = 0; j < K; ++j) {
    __syncthreads();
    const float* wj = w + (long long)j * C * C + col0;
    for (int i = tid; i < C * CB; i += blockDim.x) {
      const int ci = i / CB, cc = i - ci * CB;
      ws[i] = wj[(long long)ci * C + cc];
    }
    __syncthreads();
    const float* xr = xs + (g * F_RPT + j) * C;
    for (int ci = 0; ci < C; ++ci) {
      const float wv = ws[ci * CB + c];
#pragma unroll
      for (int r = 0; r < F_RPT; ++r) acc[r] = fmaf(xr[r * C + ci], wv, acc[r]);
    }
  }

  const float* res = static_cast<const float*>(p.residual);
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < F_RPT; ++r) {
    const int l = l0 + g * F_RPT + r;
    if (l >= L) continue;
    const long long row = (long long)n * L + l;
    const long long off = row * C + col0 + c;
    out[off] = epilogue(acc[r], p, col0 + c, row, res ? res[off] : 0.f);
  }
}

cudaError_t launch_f32(const Params& p, int n_rows, cudaStream_t stream) {
  const int CB = p.C <= 128 ? p.C : 128;
  const int l_tiles = (p.L + F_TL - 1) / F_TL;
  const size_t smem = ((size_t)(F_TL + p.K - 1) * p.C + (size_t)p.C * CB) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      conv_f32_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(n_rows * l_tiles), (unsigned)(p.C / CB));
  conv_f32_fma<<<grid, CB * (F_TL / F_RPT), smem, stream>>>(p, l_tiles, CB);
  return cudaGetLastError();
}

template <int CB, int KW>
cudaError_t launch_bf16(const Params& p, const Layout& lay, int n_rows,
                        int sms, cudaStream_t stream) {
  // x: boxes of the tile's rows plus halo x KW channels; out: 64 rows x OW
  CUtensorMap xmap, omap;
  if (!hopper::encode_bf16_3d(&xmap, p.x, (uint64_t)p.C, (uint64_t)p.L,
                              (uint64_t)n_rows, (uint32_t)KW,
                              (uint32_t)lay.rows) ||
      !hopper::encode_bf16_3d(&omap, p.out, (uint64_t)p.C, (uint64_t)p.L,
                              (uint64_t)n_rows, CB < 64 ? CB : 64, TL))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bf16_wgmma<CB, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (e != cudaSuccess) return e;
  // persistent: as many CTAs per column block as fit one per SM, no more
  // than there are tiles
  int per_cb = sms / lay.n_cb;
  if (per_cb < 1) per_cb = 1;
  if (per_cb > lay.m_tiles) per_cb = lay.m_tiles;
  conv_bf16_wgmma<CB, KW><<<per_cb * lay.n_cb, THREADS, lay.bytes, stream>>>(
      p, lay, xmap, omap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
// bf16 takes the launch plan of ops/fused_conv.py::conv_plan: cb output
// channels per CTA (16, 32, 64 or 128), kw channels per x / weight chunk,
// `stages` ring stages and smem_bytes of shared memory, which must equal the
// layout this file computes; sms is the card's SM count. f32 ignores them and
// takes C % 16 == 0 with C <= 128 or C % 128 == 0.
extern "C" int jt_fused_conv_block(int dtype, const void* x, const void* w,
                                   const void* bias, const void* dyt,
                                   const void* in_mask, const void* out_mask,
                                   const void* residual, void* out, int n_rows,
                                   int L, int C, int K, int act, int cb, int kw,
                                   int stages, int smem_bytes, int sms,
                                   void* stream) {
  if (n_rows <= 0 || L <= 0 || K <= 0 || C <= 0 || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.dyt = static_cast<const float*>(dyt);
  p.in_mask = static_cast<const uint8_t*>(in_mask);
  p.out_mask = static_cast<const uint8_t*>(out_mask);
  p.residual = residual;
  p.out = out;
  p.L = L;
  p.C = C;
  p.K = K;
  p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (C > 128 && C % 128 != 0) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(p, n_rows, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Layout lay;
  if (!make_layout(n_rows, L, C, K, cb, kw, stages, &lay) ||
      lay.bytes != (uint32_t)smem_bytes || sms <= 0)
    return (int)cudaErrorInvalidValue;
  // KW = 64 when C % 64 == 0, else 32 when C % 32 == 0 (then CB <= 32),
  // else 16 (then CB = 16)
  switch (kw * 1000 + cb) {
    case 64128: return (int)launch_bf16<128, 64>(p, lay, n_rows, sms, s);
    case 64064: return (int)launch_bf16<64, 64>(p, lay, n_rows, sms, s);
    case 64032: return (int)launch_bf16<32, 64>(p, lay, n_rows, sms, s);
    case 64016: return (int)launch_bf16<16, 64>(p, lay, n_rows, sms, s);
    case 32032: return (int)launch_bf16<32, 32>(p, lay, n_rows, sms, s);
    case 32016: return (int)launch_bf16<16, 32>(p, lay, n_rows, sms, s);
    case 16016: return (int)launch_bf16<16, 16>(p, lay, n_rows, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
