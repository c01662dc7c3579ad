// Int8 conv1d on the tensor cores for Hopper: s8 x s8 -> s32, two epilogues.
//
// Port of the Pallas TPU kernel experiments/pallas_int8_conv.py::
// int8_conv_layer (pl.pallas_call at :67-69, body `_kernel` at :41-63),
// extended to MaskedConv1D's int8 branch (jaeger_tpu/models/layers.py
// :228-262). For x (N, L, C_in) channels-last and w (K, C_in, C_out) int8:
//
//   acc[n, l, :] = sum_j q[n, l + j*d - pad_l, :] @ w[j]      (int32, exact)
//
// stride 1, any dilation d and kernel size K, SAME (pad_l = d(K-1)/2, L_out
// = L) or VALID (pad_l = 0, L_out = L - d(K-1)). Halo rows outside [0, L)
// and rows whose in_mask is false read as q = 0. One mainloop, two forms:
//
// * requant (x int8, q = x): out = clip(rint(f32(acc) * scale), -127, 127)
//   as int8, `scale` one combined f32 scalar: the Pallas kernel's function.
// * dequant (x bf16 or f32): x is quantized in shared memory,
//   q = clip(rint(f32(x) * inv_act), -127, 127), so no int8 copy of the
//   activation reaches device memory; the epilogue computes
//   y = f32(acc) * dq[c] (dq = w_scale * act_scale), then bias, DYT,
//   out_mask, residual and activation in f32 (PR 1's order), written in x's
//   type. Rounding is half to even (__float2int_rn), as jnp.round and
//   torch.round; the multiplies and the bias add are explicit _rn
//   operations, so no FMA contraction changes them.
//
// What bounds it on the H100: at the Pallas chip shape (N = 12288 rows,
// L = 500, C = 128, K = 5) the requant form does 1.007e12 int8 operations,
// 0.51 ms at the 1,979 TOP/s dense int8 peak, against 1.57 GB of int8 in and
// out, 0.47 ms at 3.35 TB/s: bound by operations. The dequant form reads and
// writes bf16 (3.15 GB, 0.94 ms; 1.41 ms with the conv2 form's residual),
// so it is bound by bytes, and the int8 products buy nothing over the bf16
// kernel's 1.02 ms bound unless activations stay int8 between layers.
//
// Two routes, chosen before launch by ops/int8_conv.py::int8_plan; the
// entry below recomputes the plan's layout and refuses one that disagrees.
//
// Route "wgmma" (int8_wgmma<T, CB, KB>: requant, and dequant in bf16, with
// C_in % 32 == 0 and 64 + d(K-1) <= 256 rows), on the schedule of
// fused_conv_block.cu's conv_bf16_wgmma:
//  * Persistent: about one CTA per SM (the count comes from the wrapper).
//    CTA b owns output column block b % n_cb (CB channels) and walks the
//    tiles (n, 64 output positions) b / n_cb, + G / n_cb, ...
//  * Weights resident: each CTA stages w[:, :, col0:col0+CB] once, transposed
//    to K-major (CB rows of C_in bytes; 8-bit wgmma has no transpose bit, so
//    B must be K-major) by 4 x 4 byte transposes, in regions of KB = 128, 64
//    or 32 bytes of C_in swizzled to that width, and keeps them for all its
//    tiles: 5 * 128 * 128 = 81,920 B at the flagship shape, half the bf16
//    kernel's. (The first, simple kernel restaged all of them per 128
//    positions, about 4.5 GB of L2 reads per call.) dq, bias and the DYT
//    rows of the column block are staged once per CTA in shared memory too.
//  * x tiles by TMA: a 3-D tensor map over (N, L, C_in), boxes of 64 + d(K-1)
//    rows by XW channels (the s8 box is KB bytes wide, the bf16 one 64 or
//    32 channels), swizzled to their width. Halo rows before 0 and past
//    L - 1 arrive as TMA's zero fill, never as the neighbouring sequence;
//    VALID starts the box at l0. One thread of the producer warpgroup keeps
//    a ring of 2-4 stages full under full / empty mbarriers.
//  * Quantized once per tile (dequant) by the other three warps of the
//    producer warpgroup: they turn each bf16 stage into an s8 tile in a
//    ring of three (16 channels a step, two steps in flight: two 16-byte
//    loads, one 16-byte store), write zeros for rows whose in_mask is false
//    (the masked pre-zero, once), hand the stage back to TMA and the s8
//    tile to the consumers. The rounding runs on the FP32 pipe (see
//    quant8x4), not in __float2int_rn, whose conversion unit runs at a
//    quarter of that rate and was the bound. Quantizing after each tap's
//    ldmatrix instead would convert every element K times. The requant form
//    reads its s8 stage as it is.
//  * Products: wgmma m64nCBk32 .s32.s8.s8, A from registers, B from
//    descriptors over the resident weights. A (the s8 rows shifted by tap j,
//    rows r + j*d) comes by ldmatrix at swizzle-aware addresses: a b16
//    ldmatrix_x4 of 32-byte row slices hands each thread exactly the s8 k32
//    A fragment, no shuffle. A k32 step is 32 bytes, +2 in the descriptor.
//    The wgmmas of one KB-byte chunk (KB / 32 steps) form a group that is
//    retired before the next chunk's fragments are loaded into the same
//    registers: with a second register set loaded under a running group (the
//    bf16 kernel's scheme) ptxas serializes every s8 wgmma (warning C7513).
//  * Two consumer warpgroups take the CTA's tiles in turn and pass the
//    tensor cores to each other with named barriers once their last chunk
//    is issued, so one warpgroup's epilogue runs under the other's wgmmas.
//    No setmaxnreg: 384 threads get 168 registers each, and moving
//    registers to the consumers (which removes their small spill) measured
//    slower.
//  * Epilogue from the s32 accumulators: |acc| < 127^2 * K * C_in, below
//    2^24 at the flagship shape, so __int2float_rn is exact, as JAX's
//    acc.astype(f32). requant: clip(rint(f32(acc) * scale)), bit-equal to
//    the plain version. dequant: f32(acc) * dq[c] then + bias (both _rn),
//    DYT (tanh.approx.f32: the output is bf16, whose rounding of 2^-8 is
//    above its 2^-11), out_mask, residual, activation. The residual tile
//    comes by TMA into the warpgroup's output buffer while the products run
//    (no registers held across them); the output is written over it
//    (swizzled, so the stores are conflict-free) and leaves by a TMA store
//    that clips rows past L_out; the buffer is reused once TMA has read it.
//  * Shared memory (flagship dequant, C = 128, K = 5, CB = 128, KB = 128,
//    4 stages): weights 81,920 B; ring 4 x 18,432 (two 64-channel bf16
//    chunks of 68 rows, each rounded up to 1 KB); s8 tiles 3 x 9,216; output
//    buffers 2 x 16,384; parameters 5 * CB * 4 = 2,560; mbarriers 16 * 4 +
//    16 * 3 + 16; alignment slack 1,024: 219,776 of 232,448 B.
//
// Route "mma" (int8_conv_mma<T, NT>: f32 dequant, C_in % 32 != 0, or a
// shape whose weights and two stages do not fit): the first, simple kernel.
// One CTA of 8 warps computes 128 output positions of one row for a block of
// CB output channels; it stages the input tile plus its d(K-1) halo in
// shared memory (quantized on the way in) and as many taps of w as fit,
// transposed to (C_out, C_in), and runs mma.sync m16n8k32 (k16 for a C_in
// tail of 16).
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

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory per block

struct Params {
  const void* x;            // (N, L, C_in): int8 (requant), bf16 or f32
  const int8_t* w;          // (K, C_in, C_out)
  const float* scale;       // requant: (1,) combined scale; dequant: dq (C_out,)
  const float* inv_act;     // dequant: (1,) f32(1 / act_scale)
  const float* bias;        // (C_out,) or null
  const float* dyt;         // (3, C_out): alpha, gamma, beta rows, or null
  const uint8_t* in_mask;   // (N, L) or null
  const uint8_t* out_mask;  // (N, L_out) or null
  const void* residual;     // (N, L_out, C_out) in x's type, or null
  void* out;                // (N, L_out, C_out): int8 (requant) or x's type
  int L, L_out, C_in, C_out, K, dil, pad_l, act, taps_per_stage;
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

__device__ __forceinline__ int clip127(int q) { return min(max(q, -127), 127); }

// q = clip(rint(v * inv), -127, 127) as the low byte
__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  return (uint32_t)(clip127(__float2int_rn(__fmul_rn(v, inv))) & 0xff);
}

// The same byte for four values, on the FP32 pipe: rint(clip(y)) equals
// clip(rint(y)) for integer bounds, and adding 1.5 * 2^23 rounds to an
// integer half to even (the add's own rounding) and leaves it, two's
// complement, in the low mantissa bits. (__float2int_rn is a conversion
// at a quarter of the FP32 rate, which the quantizers were bound by.)
__device__ __forceinline__ uint32_t quant8x4(float a, float b, float c,
                                            float d, float inv) {
  const float m = 12582912.f;  // 1.5 * 2^23
  auto q = [&](float v) {
    return __float_as_uint(
        __fadd_rn(fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f), m));
  };
  return __byte_perm(__byte_perm(q(a), q(b), 0x0040),
                     __byte_perm(q(c), q(d), 0x0040), 0x5410);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 32-bit words v0..v3, word r holding bytes (row r, cols 0..3), to
// (col c, rows 0..3) in word c: a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t v0, uint32_t v1,
                                           uint32_t v2, uint32_t v3,
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(v0, v1, 0x5140), t1 = __byte_perm(v2, v3, 0x5140);
  const uint32_t t2 = __byte_perm(v0, v1, 0x7362), t3 = __byte_perm(v2, v3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// route "wgmma": persistent s8 wgmma kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TL = 64;                          // output rows per tile: wgmma M
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int QTHREADS = 96;  // quantizers: warps 1-3 of the producer warpgroup
constexpr int QSLOTS = 3;     // s8 tiles between quantizers and consumers

// Shared-memory layout, byte offsets from a 1024-byte aligned base:
// [weights: K * (C_in / KB) regions of CB rows x KB bytes]
// [x ring: stages x (C_in / XW) chunks of rows x XW elements, each 1 KB aligned]
// [dequant only: QSLOTS s8 tiles of (C_in / KB) chunks of rows x KB bytes]
// [2 output buffers of 64 rows x CB elements]
// [dq, bias, alpha, gamma, beta: 5 x CB f32]
// [full, empty mbarriers of the ring; dequant: full, empty of the s8 tiles,
//  one residual mbarrier per consumer warpgroup]
struct Layout {
  int stages;
  int rows;          // TL + d(K - 1)
  int n_cb;          // C_out / CB column blocks
  int l_tiles;       // ceil(L_out / TL)
  int m_tiles;       // n_rows * l_tiles
  uint32_t xregion;  // bytes of one x chunk of the ring
  uint32_t stage;    // bytes of one ring stage
  uint32_t tx;       // TMA bytes per stage
  uint32_t aregion;  // bytes of one s8 chunk (rows x KB)
  uint32_t out_wg;   // bytes of one warpgroup's output buffer
  uint32_t off_x, off_a, off_out, off_par, off_bar, bytes;
};

inline uint32_t align1k(uint32_t v) { return (v + 1023u) & ~1023u; }

// false if (cb, kb, stages) cannot hold this shape; esize: 1 (requant) or
// 2 (bf16 dequant)
bool make_layout(int esize, int n_rows, int L_out, int C_in, int C_out, int K,
                 int dil, int cb, int kb, int stages, Layout* lay) {
  if (kb != 32 && kb != 64 && kb != 128) return false;
  if (cb != 16 && cb != 32 && cb != 64 && cb != 128) return false;
  if (C_in % kb || C_out % cb || stages < 2 || stages > 8) return false;
  const int rows = TL + dil * (K - 1);
  if (rows > 256) return false;  // the TMA box is at most 256 rows
  const int xw = esize == 1 ? kb : (kb < 64 ? kb : 64);
  lay->stages = stages;
  lay->rows = rows;
  lay->n_cb = C_out / cb;
  lay->l_tiles = (L_out + TL - 1) / TL;
  lay->m_tiles = n_rows * lay->l_tiles;
  lay->xregion = align1k((uint32_t)(rows * xw * esize));
  lay->stage = (uint32_t)(C_in / xw) * lay->xregion;
  lay->tx = (uint32_t)(rows * C_in * esize);
  lay->aregion = align1k((uint32_t)(rows * kb));
  lay->out_wg = (uint32_t)(TL * cb * esize);
  lay->off_x = align1k((uint32_t)(K * C_in * cb));
  lay->off_a = lay->off_x + stages * lay->stage;
  lay->off_out = lay->off_a +
                 (esize == 1 ? 0u : QSLOTS * (C_in / kb) * lay->aregion);
  lay->off_par = lay->off_out + CONSUMERS * lay->out_wg;
  lay->off_bar = lay->off_par + 20u * cb;
  lay->bytes = lay->off_bar + 16u * stages +
               (esize == 1 ? 0u : 16u * QSLOTS + 8u * CONSUMERS) +
               1024u;  // + alignment slack
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

// T = int8_t: requant form; T = __nv_bfloat16: dequant form.
template <typename T, int CB, int KB>
__global__ void __launch_bounds__(THREADS, 1)
int8_wgmma(Params p, Layout lay, const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap omap,
           const __grid_constant__ CUtensorMap rmap) {
  using namespace hopper;
  constexpr bool REQUANT = sizeof(T) == 1;
  constexpr int R = CB / 2;      // accumulator registers per thread
  constexpr int KS = KB / 32;    // k32 steps per chunk
  constexpr int XW = REQUANT ? KB : (KB < 64 ? KB : 64);  // x box channels
  constexpr uint32_t XRB = XW * sizeof(T);                // x box row bytes
  constexpr int OMAX = 128 / sizeof(T);
  constexpr int OW = CB < OMAX ? CB : OMAX;  // output box channels
  constexpr uint32_t ORB = OW * sizeof(T);   // output box row bytes
  constexpr uint32_t OCHUNK = TL * ORB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int C = p.C_in, K = p.K, S = lay.stages, dil = p.dil;
  const int nkc = C / KB;
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

  // resident weights: w[j][ci][col0 + co] -> region (j, ci / KB), row co,
  // byte ci % KB (K-major), swizzled like a TMA load of that width; each
  // item moves a 4 x 4 byte block
  {
    constexpr int NQ = CB / 4;
    const int cq = C / 4;
    for (int i = tid; i < K * cq * NQ; i += THREADS) {
      const int n4 = i % NQ, jc = i / NQ;  // jc = j * cq + c4
      const int c4 = jc % cq, j = jc / cq;
      const int8_t* src =
          p.w + ((long long)j * C + 4 * c4) * p.C_out + col0 + 4 * n4;
      uint32_t o[4];
      transpose4(ld32(src), ld32(src + p.C_out), ld32(src + 2 * p.C_out),
                 ld32(src + 3 * p.C_out), o);
      unsigned char* region =
          sbase + (uint32_t)(j * nkc + 4 * c4 / KB) * CB * KB;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(
            region + swizzle((uint32_t)(4 * n4 + e) * KB + (4 * c4) % KB, KB)) =
            o[e];
    }
    // par: dq, bias, alpha, gamma, beta of this column block
    for (int c = tid; c < CB; c += THREADS) {
      par[c] = REQUANT ? 0.f : p.scale[col0 + c];
      par[CB + c] = p.bias ? p.bias[col0 + c] : 0.f;
      if (p.dyt) {
        par[2 * CB + c] = p.dyt[col0 + c];
        par[3 * CB + c] = p.dyt[p.C_out + col0 + c];
        par[4 * CB + c] = p.dyt[2 * p.C_out + col0 + c];
      }
    }
  }
  // the dequant form's mbarriers follow the ring's: the s8 tiles' full and
  // empty ones, then one residual barrier per consumer warpgroup
  const uint32_t qbar_s = bar_s + 16 * S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_s + 8 * s, 1);  // full: the producer's arrival
      // empty: the consumer's release (requant), every quantizer's
      mbar_init(bar_s + 8 * (S + s), REQUANT ? 1 : QTHREADS);
    }
    if (!REQUANT) {
      for (int q = 0; q < QSLOTS; ++q) {
        mbar_init(qbar_s + 8 * q, QTHREADS);      // full: every quantizer
        mbar_init(qbar_s + 8 * (QSLOTS + q), 1);  // empty: the consumer
      }
      for (int w = 0; w < CONSUMERS; ++w)
        mbar_init(qbar_s + 16 * QSLOTS + 8 * w, 1);  // residual tile
    }
    fence_barrier_init();
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    const int pt = tid - CONSUMERS * 128;
    if (pt == 0) {
      // ---- producer: one thread keeps the ring full ----
      for (int i = 0; i < n_local; ++i) {
        const int s = i % S;
        const int m = m_first + i * m_step;
        const int n = m / lay.l_tiles, l0 = (m % lay.l_tiles) * TL;
        mbar_wait(bar_s + 8 * (S + s), ((i / S) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_s + 8 * s, lay.tx);
        for (int xc = 0; xc < C / XW; ++xc)
          tma_load_3d(x_s + s * lay.stage + xc * lay.xregion, &xmap,
                      bar_s + 8 * s, xc * XW, l0 - p.pad_l, n);
      }
    } else if (!REQUANT && pt >= 32) {
      // ---- quantizers (dequant): every tile's bf16 stage into an s8
      // tile, 16 channels a step; row r of the tile is input position
      // l0 - pad_l + r; rows that in_mask masks are written as zeros ----
      const int qt = pt - 32;
      const float inv = *p.inv_act;
      const int upr = C / 16;  // 16-channel units per row
      // where this thread's units start, and how far QTHREADS units move
      const int r_first = qt / upr, c_first = (qt % upr) * 16;
      const int step_r = QTHREADS / upr, step_c = (QTHREADS % upr) * 16;
      for (int i = 0; i < n_local; ++i) {
        const int s = i % S, qs = i % QSLOTS;
        const int m = m_first + i * m_step;
        const int n = m / lay.l_tiles, l0 = (m % lay.l_tiles) * TL;
        const uint8_t* mrow =
            p.in_mask ? p.in_mask + (long long)n * p.L : nullptr;
        const unsigned char* stage = sbase + lay.off_x + s * lay.stage;
        unsigned char* tile = sbase + lay.off_a + qs * nkc * lay.aregion;
        mbar_wait(bar_s + 8 * s, (i / S) & 1);
        mbar_wait(qbar_s + 8 * (QSLOTS + qs), ((i / QSLOTS) & 1) ^ 1);
        // units u = qt, qt + QTHREADS, ... as (row r, 16 channels from c0),
        // two a step so that their loads overlap
        int r = r_first, c0 = c_first;
        for (int u = qt; u < lay.rows * upr; u += 2 * QTHREADS) {
          uint4 h[2][2];
          int rr[2], cc[2];
          bool ok[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rr[e] = r;
            cc[e] = c0;
            const int pos = l0 - p.pad_l + r;
            ok[e] = u + e * QTHREADS < lay.rows * upr &&
                    !(mrow && pos >= 0 && pos < p.L && !mrow[pos]);
            if (ok[e]) {
              const unsigned char* src = stage + (c0 / XW) * lay.xregion;
              const uint32_t off = (uint32_t)r * XRB + (c0 % XW) * 2;
              h[e][0] = *reinterpret_cast<const uint4*>(src + swizzle(off, XRB));
              h[e][1] =
                  *reinterpret_cast<const uint4*>(src + swizzle(off + 16, XRB));
            }
            r += step_r;
            c0 += step_c;
            if (c0 >= C) {
              c0 -= C;
              ++r;
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (u + e * QTHREADS >= lay.rows * upr) break;
            uint4 q = make_uint4(0u, 0u, 0u, 0u);
            if (ok[e]) {
              const __nv_bfloat162* b =
                  reinterpret_cast<const __nv_bfloat162*>(h[e]);
              uint32_t w4[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 f0 = __bfloat1622float2(b[2 * k]);
                const float2 f1 = __bfloat1622float2(b[2 * k + 1]);
                w4[k] = quant8x4(f0.x, f0.y, f1.x, f1.y, inv);
              }
              q = make_uint4(w4[0], w4[1], w4[2], w4[3]);
            }
            *reinterpret_cast<uint4*>(
                tile + (cc[e] / KB) * lay.aregion +
                swizzle((uint32_t)rr[e] * KB + cc[e] % KB, KB)) = q;
          }
        }
        mbar_arrive(bar_s + 8 * (S + s));  // this thread's reads are done
        mbar_arrive(qbar_s + 8 * qs);      // and its part of the s8 tile
      }
    }
    return;
  }

  // ---- consumer warpgroups: tiles wg, wg + 2, ... of this CTA ----
  const int wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;           // fragment rows r0, r0 + 8
  const int lrow = 16 * warp + (lane & 15);      // ldmatrix row of this lane
  const uint32_t lcol = (uint32_t)(lane >> 4) * 16;  // its byte in a k32 step
  const int c_lane = 2 * (lane % 4);             // accumulator column in 8
  const int chunks = K * nkc;                    // (tap, KB-byte chunk) pairs
  const uint64_t desc0 = smem_desc(base, KB);
  const uint32_t wtap = (uint32_t)nkc * CB * KB;  // weight bytes per tap
  const uint32_t out_s = base + lay.off_out + wg * lay.out_wg;
  unsigned char* out_tile = sbase + (out_s - base);
  const float qscale = REQUANT ? *p.scale : 0.f;
  const uint32_t rbar = qbar_s + 16 * QSLOTS + 8 * wg;
  int acc[R];

  // the warpgroups take turns issuing their products (named barriers 1 and
  // 2): warpgroup 0 goes first
  if (wg == 1) named_bar_arrive(1, 2 * 128);
  for (int i = wg; i < n_local; i += CONSUMERS) {
    const int m = m_first + i * m_step;
    const int n = m / lay.l_tiles, l0 = (m % lay.l_tiles) * TL;
    const bool v0 = l0 + r0 < p.L_out, v1 = l0 + r0 + 8 < p.L_out;
    const long long row0 = (long long)n * p.L_out + l0 + r0;
    // the dequant epilogue's out_mask bytes, and its residual tile, which
    // TMA brings into the output buffer (rows past L_out as zeros) while
    // the products run, once the last store has read the buffer
    bool z0 = false, z1 = false;
    if constexpr (!REQUANT) {
      z0 = p.out_mask && v0 && !p.out_mask[row0];
      z1 = p.out_mask && v1 && !p.out_mask[row0 + 8];
      if (p.residual && wt == 0) {
        bulk_wait_read<0>();
        mbar_arrive_expect_tx(rbar, lay.out_wg);
        for (int oc = 0; oc < CB / OW; ++oc)
          tma_load_3d(out_s + oc * OCHUNK, &rmap, rbar, col0 + oc * OW, l0, n);
      }
    }
    // A is the s8 stage as TMA wrote it (requant) or the quantizers' s8
    // tile (dequant); `release` hands it back once the products have read it
    uint32_t a_base, release;
    if constexpr (REQUANT) {
      const int s = i % S;
      mbar_wait(bar_s + 8 * s, (i / S) & 1);
      a_base = x_s + s * lay.stage;
      release = bar_s + 8 * (S + s);
    } else {
      const int qs = i % QSLOTS;
      mbar_wait(qbar_s + 8 * qs, (i / QSLOTS) & 1);
      a_base = base + lay.off_a + qs * nkc * lay.aregion;
      release = qbar_s + 8 * (QSLOTS + qs);
    }

    // One chunk: tap j, bytes KB kc .. KB kc + KB - 1 of C_in, KS k32 steps.
    // A: the s8 rows shifted by j * d, by ldmatrix at swizzled addresses
    // (row r of the chunk at r * KB, its 16-byte units XORed with bits 7..
    // of r * KB). Returns the B descriptor of the chunk's first step; step
    // t adds 32 t bytes, (32 t) >> 4 = 2 t in the descriptor.
    int cj = 0, ckc = 0;  // the next chunk to load
    auto load_chunk = [&](uint32_t(&a)[KS][4]) -> uint64_t {
      const uint32_t row = lrow + cj * dil;
      const uint32_t rbase = a_base + ckc * lay.aregion + row * KB;
      const uint32_t sw = (((row * KB) >> 7) & (KB / 16 - 1)) << 4;
#pragma unroll
      for (int t = 0; t < KS; ++t)
        ldmatrix_x4(a[t], rbase + ((t * 32 + lcol) ^ sw));
      const uint64_t d = desc0 + ((cj * wtap + ckc * CB * KB) >> 4);
      if (++ckc == nkc) {
        ckc = 0;
        ++cj;
      }
      return d;
    };
    // One A register set: each chunk's wgmmas are retired before the set
    // is reloaded. With a second set loaded while a chunk runs, as the bf16
    // kernel does, ptxas serializes every s8 wgmma (warning C7513).
    uint32_t a[KS][4];
    uint64_t d = load_chunk(a);
    // wait for this warpgroup's turn on the tensor cores
    named_bar_sync(1 + wg, 2 * 128);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch) d = load_chunk(a);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KS; ++t)
        wgmma_s8_rs(acc, a[t], d + 2 * t, ch > 0 || t > 0);
      wgmma_commit();
      // the last products are issued: the other warpgroup (whose next tile
      // is i + 1) takes the tensor cores while this one runs its epilogue
      if (ch + 1 == chunks && i + 1 < n_local)
        named_bar_arrive(2 - wg, 2 * 128);
      wgmma_wait<0>();
      fence_regs(a);
    }
    named_bar_sync(3 + wg, 128);  // every warp's ldmatrix reads are done
    if (wt == 0) mbar_arrive(release);
    fence_regs(acc);

    // ---- epilogue: column 8 q + c_lane (+1) of rows r0 (acc[4q], [4q+1])
    // and r0 + 8 (acc[4q+2], [4q+3]), into the output buffer (chunks of OW
    // channels, 64 rows x ORB bytes, swizzled to that width) ----
    if (wt == 0) bulk_wait_read<0>();  // the last store has read the buffer
    named_bar_sync(3 + wg, 128);
    if constexpr (REQUANT) {
#pragma unroll
      for (int q = 0; q < CB / 8; ++q) {
        unsigned char* chunk = out_tile + (8 * q / OW) * OCHUNK;
        const uint32_t cc = 8 * q % OW + c_lane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          char2 v;
          v.x = (signed char)clip127(__float2int_rn(
              __fmul_rn(__int2float_rn(acc[4 * q + 2 * h]), qscale)));
          v.y = (signed char)clip127(__float2int_rn(
              __fmul_rn(__int2float_rn(acc[4 * q + 2 * h + 1]), qscale)));
          *reinterpret_cast<char2*>(
              chunk + swizzle((r0 + 8 * h) * ORB + cc, ORB)) = v;
        }
      }
    } else {
      float y[R];
#pragma unroll
      for (int q = 0; q < CB / 8; ++q) {
        const int c = 8 * q + c_lane;
        const float2 dq = *reinterpret_cast<const float2*>(par + c);
        const float2 b = *reinterpret_cast<const float2*>(par + CB + c);
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          y[4 * q + h] =
              __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * q + h]), dq.x), b.x);
          y[4 * q + h + 1] = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * q + h + 1]), dq.y), b.y);
        }
      }
      if (p.dyt) {
        // tanh(alpha * y) * gamma + beta
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          const int c = 8 * q + c_lane;
          const float2 al = *reinterpret_cast<const float2*>(par + 2 * CB + c);
          const float2 ga = *reinterpret_cast<const float2*>(par + 3 * CB + c);
          const float2 be = *reinterpret_cast<const float2*>(par + 4 * CB + c);
#pragma unroll
          for (int h = 0; h < 4; h += 2) {
            y[4 * q + h] = fmaf(tanh_approx(y[4 * q + h] * al.x), ga.x, be.x);
            y[4 * q + h + 1] =
                fmaf(tanh_approx(y[4 * q + h + 1] * al.y), ga.y, be.y);
          }
        }
      }
      if (z0 || z1) {
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          if (z0) y[4 * q] = y[4 * q + 1] = 0.f;
          if (z1) y[4 * q + 2] = y[4 * q + 3] = 0.f;
        }
      }
      if (p.residual) {
        // the residual pairs at the places this thread writes its output
        mbar_wait(rbar, (i / CONSUMERS) & 1);
#pragma unroll
        for (int q = 0; q < CB / 8; ++q) {
          const unsigned char* chunk = out_tile + (8 * q / OW) * OCHUNK;
          const uint32_t cc = (8 * q % OW + c_lane) * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // bf16 -> f32 is a 16-bit shift
            const uint32_t rv = *reinterpret_cast<const uint32_t*>(
                chunk + swizzle((r0 + 8 * h) * ORB + cc, ORB));
            y[4 * q + 2 * h] += __uint_as_float(rv << 16);
            y[4 * q + 2 * h + 1] += __uint_as_float(rv & 0xffff0000u);
          }
        }
      }
      switch (p.act) {
        case ACT_RELU:
#pragma unroll
          for (int e = 0; e < R; ++e) y[e] = fmaxf(y[e], 0.f);
          break;
        case ACT_TANH:
#pragma unroll
          for (int e = 0; e < R; ++e) y[e] = tanh_approx(y[e]);
          break;
        case ACT_GELU:
#pragma unroll
          for (int e = 0; e < R; ++e)
            y[e] = 0.5f * y[e] * (1.f + erff(y[e] * 0.7071067811865476f));
          break;
        case ACT_GELU_TANH:
#pragma unroll
          for (int e = 0; e < R; ++e) {
            // 0.5 y (1 + tanh(sqrt(2 / pi) (y + 0.044715 y^3)))
            const float v = y[e], hv = 0.5f * v;
            const float u = v * fmaf(0.7978845608028654f * 0.044715f, v * v,
                                     0.7978845608028654f);
            y[e] = fmaf(hv, tanh_approx(u), hv);
          }
          break;
        default:
          break;
      }
#pragma unroll
      for (int q = 0; q < CB / 8; ++q) {
        unsigned char* chunk = out_tile + (8 * q / OW) * OCHUNK;
        const uint32_t cc = (8 * q % OW + c_lane) * 2;
        *reinterpret_cast<__nv_bfloat162*>(
            chunk + swizzle(r0 * ORB + cc, ORB)) =
            __floats2bfloat162_rn(y[4 * q], y[4 * q + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            chunk + swizzle((r0 + 8) * ORB + cc, ORB)) =
            __floats2bfloat162_rn(y[4 * q + 2], y[4 * q + 3]);
      }
    }
    fence_proxy_async();  // the generic writes before TMA reads them
    named_bar_sync(3 + wg, 128);
    if (wt == 0) {
      // rows past L_out are clipped by the store
      for (int oc = 0; oc < CB / OW; ++oc)
        tma_store_3d(&omap, out_s + oc * OCHUNK, col0 + oc * OW, l0, n);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait_read<0>();  // shared memory outlives the stores
}

template <typename T, int CB, int KB>
cudaError_t launch_wgmma(const Params& p, const Layout& lay, int n_rows,
                         int sms, cudaStream_t stream) {
  constexpr bool REQUANT = sizeof(T) == 1;
  constexpr int XW = REQUANT ? KB : (KB < 64 ? KB : 64);
  constexpr int OMAX = 128 / sizeof(T);
  constexpr int OW = CB < OMAX ? CB : OMAX;
  // x: boxes of the tile's rows plus halo x XW channels; out: 64 rows x OW
  // residual: the output's boxes (the out map again when there is none)
  CUtensorMap xmap, omap, rmap;
  auto encode = REQUANT ? hopper::encode_s8_3d : hopper::encode_bf16_3d;
  if (!encode(&xmap, p.x, (uint64_t)p.C_in, (uint64_t)p.L, (uint64_t)n_rows,
              (uint32_t)XW, (uint32_t)lay.rows) ||
      !encode(&omap, p.out, (uint64_t)p.C_out, (uint64_t)p.L_out,
              (uint64_t)n_rows, (uint32_t)OW, (uint32_t)TL) ||
      !encode(&rmap, p.residual ? p.residual : p.out, (uint64_t)p.C_out,
              (uint64_t)p.L_out, (uint64_t)n_rows, (uint32_t)OW,
              (uint32_t)TL))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      int8_wgmma<T, CB, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (e != cudaSuccess) return e;
  // persistent: as many CTAs per column block as fit one per SM, no more
  // than there are tiles
  int per_cb = sms / lay.n_cb;
  if (per_cb < 1) per_cb = 1;
  if (per_cb > lay.m_tiles) per_cb = lay.m_tiles;
  int8_wgmma<T, CB, KB><<<per_cb * lay.n_cb, THREADS, lay.bytes, stream>>>(
      p, lay, xmap, omap, rmap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wgmma(const Params& p, const Layout& lay, int kb, int cb,
                           int n_rows, int sms, cudaStream_t s) {
  switch (kb * 1000 + cb) {
    case 128128: return launch_wgmma<T, 128, 128>(p, lay, n_rows, sms, s);
    case 128064: return launch_wgmma<T, 64, 128>(p, lay, n_rows, sms, s);
    case 128032: return launch_wgmma<T, 32, 128>(p, lay, n_rows, sms, s);
    case 128016: return launch_wgmma<T, 16, 128>(p, lay, n_rows, sms, s);
    case 64128: return launch_wgmma<T, 128, 64>(p, lay, n_rows, sms, s);
    case 64064: return launch_wgmma<T, 64, 64>(p, lay, n_rows, sms, s);
    case 64032: return launch_wgmma<T, 32, 64>(p, lay, n_rows, sms, s);
    case 64016: return launch_wgmma<T, 16, 64>(p, lay, n_rows, sms, s);
    case 32128: return launch_wgmma<T, 128, 32>(p, lay, n_rows, sms, s);
    case 32064: return launch_wgmma<T, 64, 32>(p, lay, n_rows, sms, s);
    case 32032: return launch_wgmma<T, 32, 32>(p, lay, n_rows, sms, s);
    case 32016: return launch_wgmma<T, 16, 32>(p, lay, n_rows, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// route "mma": the first, simple mma.sync kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int M_TL = 128;    // output positions per CTA
constexpr int M_WARPS = 8;   // 16 positions per warp
constexpr int M_PAD = 16;    // shared-memory row padding, bytes
constexpr int M_TARGET = 112 * 1024;  // two CTAs per SM when it fits

__device__ __forceinline__ void mma_k32(int (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Input rows l0 - pad_l .. l0 - pad_l + rows_in - 1 of row n, quantized
// into xs (rows_in x C_in int8, row stride ld). Outside [0, L) or masked: 0.
template <typename T>
__device__ void load_x_tile(const Params& p, int8_t* xs, int ld, int n, int l0,
                            int rows_in, float inv) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte load
  const int vec = p.C_in / EPV;
  const T* x = static_cast<const T*>(p.x);
  for (int i = threadIdx.x; i < rows_in * vec; i += blockDim.x) {
    const int r = i / vec, v = i - r * vec;
    const int pos = l0 - p.pad_l + r;
    int4 raw = make_int4(0, 0, 0, 0);
    if (pos >= 0 && pos < p.L) {
      const long long row = (long long)n * p.L + pos;
      if (!p.in_mask || p.in_mask[row])
        raw = *reinterpret_cast<const int4*>(x + row * p.C_in + v * EPV);
    }
    int8_t* dst = xs + r * ld + v * EPV;
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<int4*>(dst) = raw;
    } else if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t q[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        q[2 * e] = quant8(f.x, inv);
        q[2 * e + 1] = quant8(f.y, inv);
      }
      uint2 packed;
      packed.x = pack4(q[0], q[1], q[2], q[3]);
      packed.y = pack4(q[4], q[5], q[6], q[7]);
      *reinterpret_cast<uint2*>(dst) = packed;
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
      *reinterpret_cast<uint32_t*>(dst) = pack4(
          quant8(f[0], inv), quant8(f[1], inv), quant8(f[2], inv),
          quant8(f[3], inv));
    }
  }
}

// Taps j0 .. j0 + taps - 1 of w, columns col0 .. col0 + CB - 1, transposed
// into ws[(jj * CB + n) * ld + ci]. Each item moves a 4 x 4 byte block.
template <int CB>
__device__ void load_w_taps(const Params& p, int8_t* ws, int ld, int j0,
                            int taps, int col0) {
  constexpr int NQ = CB / 4;
  const int cq = p.C_in / 4;
  for (int i = threadIdx.x; i < taps * cq * NQ; i += blockDim.x) {
    const int jj = i / (cq * NQ);
    const int rem = i - jj * cq * NQ;
    const int c4 = rem / NQ, n4 = rem - c4 * NQ;
    const int8_t* src =
        p.w + ((long long)(j0 + jj) * p.C_in + 4 * c4) * p.C_out + col0 + 4 * n4;
    uint32_t o[4];
    transpose4(ld32(src), ld32(src + p.C_out), ld32(src + 2 * p.C_out),
               ld32(src + 3 * p.C_out), o);
    int8_t* dst = ws + (jj * CB + 4 * n4) * ld + 4 * c4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + e * ld) = o[e];
  }
}

__device__ __forceinline__ float dequant_epilogue(int a, const Params& p, int c,
                                                  long long row, float res) {
  float y = __fmul_rn(__int2float_rn(a), p.scale[c]);
  if (p.bias) y = __fadd_rn(y, p.bias[c]);
  if (p.dyt)
    y = tanhf(y * p.dyt[c]) * p.dyt[p.C_out + c] + p.dyt[2 * p.C_out + c];
  if (p.out_mask && !p.out_mask[row]) y = 0.f;
  if (p.residual) y += res;
  return act_fn(y, p.act);
}

// T = int8_t: requant form; T = __nv_bfloat16 / float: dequant form.
template <typename T, int NT>
__global__ void __launch_bounds__(M_WARPS * 32)
int8_conv_mma(Params p, int l_tiles) {
  constexpr int CB = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = p.C_in + M_PAD;
  const int span = p.dil * (p.K - 1);
  const int rows_in = M_TL + span;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* ws = xs + ((rows_in * ld + 15) & ~15);

  const int n = blockIdx.x / l_tiles;
  const int l0 = (blockIdx.x % l_tiles) * M_TL;
  const int col0 = blockIdx.y * CB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float inv = 1.f;  // the requant form loads int8 as it is
  if constexpr (sizeof(T) != 1) inv = *p.inv_act;
  load_x_tile<T>(p, xs, ld, n, l0, rows_in, inv);

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

  for (int j0 = 0; j0 < p.K; j0 += p.taps_per_stage) {
    const int taps = min(p.taps_per_stage, p.K - j0);
    __syncthreads();  // the last stage's taps are consumed
    load_w_taps<CB>(p, ws, ld, j0, taps, col0);
    __syncthreads();  // x tile and taps complete
    for (int jj = 0; jj < taps; ++jj) {
      // output position m reads input tile row m + j * d
      const int8_t* a0p = xs + (warp * 16 + g + (j0 + jj) * p.dil) * ld + 4 * t;
      const int8_t* a1p = a0p + 8 * ld;
      const int8_t* bp = ws + (jj * CB + g) * ld + 4 * t;
      int kk = 0;
      for (; kk + 32 <= p.C_in; kk += 32) {
        const uint32_t a0 = ld32(a0p + kk), a1 = ld32(a1p + kk);
        const uint32_t a2 = ld32(a0p + kk + 16), a3 = ld32(a1p + kk + 16);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int8_t* b = bp + nt * 8 * ld + kk;
          mma_k32(acc[nt], a0, a1, a2, a3, ld32(b), ld32(b + 16));
        }
      }
      if (kk < p.C_in) {  // C_in % 32 == 16
        const uint32_t a0 = ld32(a0p + kk), a1 = ld32(a1p + kk);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_k16(acc[nt], a0, a1, ld32(bp + nt * 8 * ld + kk));
      }
    }
  }

  // accumulator (nt, e): position warp * 16 + g + 8 * (e / 2),
  // channel col0 + nt * 8 + 2 * t + (e % 2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = l0 + warp * 16 + g + 8 * h;
    if (l >= p.L_out) continue;
    const long long row = (long long)n * p.L_out + l;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + nt * 8 + 2 * t;
      const long long off = row * p.C_out + c;
      const int a0 = acc[nt][2 * h], a1 = acc[nt][2 * h + 1];
      if constexpr (sizeof(T) == 1) {
        const float s = *p.scale;
        char2 q;
        q.x = (signed char)clip127(__float2int_rn(__fmul_rn(__int2float_rn(a0), s)));
        q.y = (signed char)clip127(__float2int_rn(__fmul_rn(__int2float_rn(a1), s)));
        *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + off) = q;
      } else if constexpr (sizeof(T) == 2) {
        float r0 = 0.f, r1 = 0.f;
        if (p.residual) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(p.residual) + off);
          r0 = __low2float(rv);
          r1 = __high2float(rv);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + off) =
            __floats2bfloat162_rn(dequant_epilogue(a0, p, c, row, r0),
                                  dequant_epilogue(a1, p, c + 1, row, r1));
      } else {
        float2 r = make_float2(0.f, 0.f);
        if (p.residual)
          r = *reinterpret_cast<const float2*>(static_cast<const float*>(p.residual) + off);
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
            make_float2(dequant_epilogue(a0, p, c, row, r.x),
                        dequant_epilogue(a1, p, c + 1, row, r.y));
      }
    }
  }
}

// Shared memory of the mma kernel with column block cb: the x tile and as
// many weight taps as fit (two CTAs per SM when one tap fits beside the
// tile in M_TARGET); 0 if not even one tap fits. Sets *taps.
size_t mma_smem(const Params& p, int cb, int* taps) {
  const size_t ld = (size_t)p.C_in + M_PAD;
  const size_t xs_bytes =
      ((size_t)(M_TL + p.dil * (p.K - 1)) * ld + 15) & ~(size_t)15;
  const size_t tap_bytes = (size_t)cb * ld;
  if (xs_bytes + tap_bytes > (size_t)SMEM_LIMIT) return 0;
  const size_t budget =
      xs_bytes + tap_bytes <= (size_t)M_TARGET ? M_TARGET : SMEM_LIMIT;
  const int tps = (int)((budget - xs_bytes) / tap_bytes);
  *taps = tps < p.K ? tps : p.K;
  return xs_bytes + (size_t)*taps * tap_bytes;
}

template <typename T, int NT>
cudaError_t launch_mma(Params p, size_t smem, int n_rows, cudaStream_t stream) {
  constexpr int CB = 8 * NT;
  cudaError_t e = cudaFuncSetAttribute(int8_conv_mma<T, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int l_tiles = (p.L_out + M_TL - 1) / M_TL;
  const dim3 grid((unsigned)((long long)n_rows * l_tiles), (unsigned)(p.C_out / CB));
  int8_conv_mma<T, NT><<<grid, M_WARPS * 32, smem, stream>>>(p, l_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(const Params& p, int cb, size_t smem, int n_rows,
                         cudaStream_t s) {
  switch (cb) {
    case 128: return launch_mma<T, 16>(p, smem, n_rows, s);
    case 64: return launch_mma<T, 8>(p, smem, n_rows, s);
    case 32: return launch_mma<T, 4>(p, smem, n_rows, s);
    case 16: return launch_mma<T, 2>(p, smem, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (dequant form), 2 = int8 (requant
// form). C_in and C_out must be multiples of 16. The launch plan of
// ops/int8_conv.py::int8_plan: route 1 = wgmma (cb output channels per CTA,
// kw bytes of C_in per weight / s8 chunk, `stages` ring stages; not f32),
// route 0 = mma (cb; kw and stages 0); smem_bytes must equal the layout
// this file computes for it. sms is the card's SM count. Returns a
// cudaError_t (0 = success).
extern "C" int jt_int8_conv(int in_dtype, const void* x, const void* w,
                            const void* scale, const void* inv_act,
                            const void* bias, const void* dyt,
                            const void* in_mask, const void* out_mask,
                            const void* residual, void* out, int n_rows, int L,
                            int L_out, int C_in, int C_out, int K, int dil,
                            int pad_l, int act, int route, int cb, int kw,
                            int stages, int smem_bytes, int sms, void* stream) {
  if (n_rows <= 0 || L <= 0 || L_out <= 0 || K <= 0 || dil <= 0 || pad_l < 0 ||
      C_in <= 0 || C_out <= 0 || C_in % 16 != 0 || C_out % 16 != 0 ||
      cb <= 0 || C_out % cb != 0 || in_dtype < 0 || in_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.inv_act = static_cast<const float*>(inv_act);
  p.bias = static_cast<const float*>(bias);
  p.dyt = static_cast<const float*>(dyt);
  p.in_mask = static_cast<const uint8_t*>(in_mask);
  p.out_mask = static_cast<const uint8_t*>(out_mask);
  p.residual = residual;
  p.out = out;
  p.L = L;
  p.L_out = L_out;
  p.C_in = C_in;
  p.C_out = C_out;
  p.K = K;
  p.dil = dil;
  p.pad_l = pad_l;
  p.act = act;
  p.taps_per_stage = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (in_dtype == 0 || sms <= 0) return (int)cudaErrorInvalidValue;
    Layout lay;
    if (!make_layout(in_dtype == 2 ? 1 : 2, n_rows, L_out, C_in, C_out, K, dil,
                     cb, kw, stages, &lay) ||
        lay.bytes != (uint32_t)smem_bytes)
      return (int)cudaErrorInvalidValue;
    return in_dtype == 2
               ? (int)dispatch_wgmma<int8_t>(p, lay, kw, cb, n_rows, sms, s)
               : (int)dispatch_wgmma<__nv_bfloat16>(p, lay, kw, cb, n_rows,
                                                    sms, s);
  }
  if (route != 0 || kw != 0 || stages != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem(p, cb, &p.taps_per_stage);
  if (smem == 0 || smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  switch (in_dtype) {
    case 0: return (int)dispatch_mma<float>(p, cb, smem, n_rows, s);
    case 1: return (int)dispatch_mma<__nv_bfloat16>(p, cb, smem, n_rows, s);
    default: return (int)dispatch_mma<int8_t>(p, cb, smem, n_rows, s);
  }
}
