// Int8 conv1d on the tensor cores for Hopper: s8 x s8 -> s32, two epilogues.
//
// Port of the Pallas TPU kernel experiments/pallas_int8_conv.py::
// int8_conv_layer (pl.pallas_call at :67-69, body `_kernel` at :41-63),
// extended to MaskedConv1D's int8 branch (jaeger_tpu/models/layers.py
// :228-262). For x (N, L, C_in) channels-last and w (K, C_in, C_out) int8:
//
//   acc[n, l, :] = sum_j q[n, l*s + j*d - pad_l, :] @ w[j]    (int32, exact)
//
// any dilation d and kernel size K, SAME (at stride s = 1 pad_l = d(K-1)/2,
// L_out = L) or VALID (pad_l = 0, L_out = L - d(K-1)); the "ragged" route
// also takes s > 1 (pad_l and L_out from the wrapper, XLA's SAME or VALID).
// Halo rows outside [0, L) and rows whose in_mask is false read as q = 0.
// One mainloop, two forms:
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
// Three routes, chosen before launch by ops/int8_conv.py::int8_plan; the
// entry below recomputes the plan's layout and refuses one that disagrees.
// "wgmma" and "mma" take C_in and C_out multiples of 16 at stride 1,
// "ragged" the rest, on one of its two kernels.
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
// Route "ragged" (C_in or C_out not a multiple of 16, C_in < 16 included,
// and every stride above 1; all three forms). Its two shapes on the paths
// are bound by bytes: the dvf template's conv (one-hot nucleotides, C_in 4,
// C_out 500, K 10, VALID, bf16, N 2048 rows of L 500: 40.2 G int8
// operations, 0.020 ms at 1,979 TOP/s, against 1.01 GB of bf16 output,
// 0.300 ms at 3.35 TB/s) and a strided residual conv1 at the flagship's
// width (C 128, K 5, stride 2, N 12288, L 500: 0.50 T operations, 0.25 ms,
// against 2.36 GB of bf16 in and out, 0.70 ms). Two kernels:
//
// int8_ragged<T, CB, MINB> (the resident kernel) wherever its layout fits
// (ragged_resident; every shape on the paths):
//  * Weights resident: a CTA owns a column block of CB output channels
//    (16, 32, 64 or 128; the last block cut at C_out) with all K taps,
//    staged once with 16-byte loads (4-byte or single-byte ones where
//    C_out's alignment does not allow them) and 4 x 4 byte transposes,
//    K-major in regions of kb = 128, 64 or 32 contraction bytes swizzled to
//    that width. The contraction is tap-major, kk = j * cp + c (cp = C_in
//    rounded up to 4), padded with zeros to kp, a multiple of 32.
//  * Two warpgroups (one where two do not fit) take the CTA's tiles of 64
//    output positions in turn and never wait for each other. Each keeps a
//    ring of one or two x stages: a tile's 63 s + d(K-1) + 1 input rows as
//    they lie in device memory (one contiguous span), copied by 16-byte
//    cp.async of the 16-byte aligned span around them (any C_in, any
//    alignment), its in_mask bytes beside them. The next tile's copy is
//    issued as soon as a stage is quantized and lands while this tile's
//    products, epilogue and stores run.
//  * Quantized once into an s8 tile (a 4-channel word a step; rows outside
//    [0, L), masked rows and channels past C_in as 0) whose rows are padded
//    so that the A loads are conflict-free (ragged_pitch).
//  * Products: s8 wgmma m64nCBk32 with B the resident weights and A from
//    registers: a thread's four 32-bit A words of a k32 step come from the
//    s8 tile at row r * s + j * d through a table of contraction offsets
//    (any cp, any stride); up to four steps a group, retired before A is
//    reloaded (a second A register set under a running group makes ptxas
//    serialize every s8 wgmma, warning C7513).
//  * Epilogue from the accumulators, the staged kernel's f32 operations in
//    its order, into an output image in shared memory, then to device
//    memory as streaming stores of the widest unit a row of the column
//    block allows (16 bytes at C_out 128 in bf16, 8 at C_out 500).
//
// int8_ragged_staged<T, CB, VEC> (the route's first kernel, PR 10) where
// the x stages and all K taps do not fit (a C_in near 1000):
//  * Persistent CTAs of 8 warps over tiles of 64 output positions for a
//    column block; the tile's input rows loaded element by element,
//    quantized as x is read, into an s8 tile with the channels padded to
//    cp; the weights staged as many taps a stage as fit in 112 KB (else in
//    227 KB), restaged every tile when that is fewer than K.
//  * The same tap-major contraction through the offset table, mma.sync
//    m16n8k32 (each warp 16 rows by CB / 2 columns), the s32 sums through
//    shared memory, an epilogue of VEC channels a thread (4 when 4 divides
//    C_out) on consecutive channels of a row.
//  It ran the paths' shapes before the resident kernel (NVIDIA H100 80GB
//  HBM3, 700 W): 1.064 ms at the dvf shape, 28 % of its bound (each tile
//  one serial chain: x load, products, s32 through shared memory,
//  epilogue), and 23.67 ms at the stride shape, 3 % (its 3 taps a stage
//  restaged every tile, byte by byte).

// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (jaeger_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  int L, L_out, C_in, C_out, K, dil, stride, pad_l, act, taps_per_stage;
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

// ---------------------------------------------------------------------------
// route "ragged", staged kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int RG_TL = 64;        // output rows per tile
constexpr int RG_THREADS = 256;  // 8 warps: 4 row groups of 16 x 2 column halves
constexpr int RG_WPAD = 16;      // weight row padding, bytes
constexpr int RG_OPAD = 8;       // accumulator row padding, words
constexpr int RG_TARGET = 112 * 1024;  // two CTAs per SM when one tap fits
constexpr int RG_MIN_CTAS = 4;  // CTAs per SM the registers must allow (64 each)

// Cycle probes (a build with -DJT_RAGGED_CYCLES only; chip_smoke.py
// --ragged): one thread of each CTA (of each warpgroup in the resident
// kernel) adds the clock64 cycles of each phase of its tiles, its tile
// count and 1 to g_rg_cycles; jt_int8_ragged_cycles reads and clears the
// sums.
#ifdef JT_RAGGED_CYCLES
constexpr int RG_PHASES = 6;
__device__ unsigned long long g_rg_cycles[RG_PHASES + 2];
#define RG_CLOCK_INIT(on)                              \
  const bool rg_on = (on);                             \
  long long rg_t = clock64(), rg_sum[RG_PHASES] = {};  \
  long long rg_tiles = 0
#define RG_MARK(i)                                \
  do {                                            \
    if (rg_on) {                                  \
      const long long rg_now = clock64();         \
      rg_sum[i] += rg_now - rg_t;                 \
      rg_t = rg_now;                              \
    }                                             \
  } while (0)
#define RG_TILE() (rg_tiles += rg_on)
#define RG_CLOCK_FLUSH()                                                 \
  do {                                                                   \
    if (rg_on) {                                                         \
      for (int i = 0; i < RG_PHASES; ++i)                                \
        atomicAdd(&g_rg_cycles[i], (unsigned long long)rg_sum[i]);       \
      atomicAdd(&g_rg_cycles[RG_PHASES], (unsigned long long)rg_tiles);  \
      atomicAdd(&g_rg_cycles[RG_PHASES + 1], 1ull);                      \
    }                                                                    \
  } while (0)
#else
#define RG_CLOCK_INIT(on) do {} while (0)
#define RG_MARK(i) do {} while (0)
#define RG_TILE() do {} while (0)
#define RG_CLOCK_FLUSH() do {} while (0)
#endif

// Shared-memory layout of the ragged route, byte offsets:
// [x tile: rows = 63 * stride + dil * (K - 1) + 1 input rows x cp s8 (cp =
//  C_in rounded up to 4), padded to 16 bytes]
// [weights: cb rows (output channels) x ldw = kp + 16 bytes, where kp =
//  taps * cp rounded up to 32 is one stage's contraction, tap-major]
// [accumulators: 64 rows x (cb + 8) s32]
// [contraction offsets: kp s32, each index's x tile offset from its row]
// [epilogue parameters: dq (or the requant scale), bias, alpha, gamma, beta
//  of the column block, 5 x cb f32]
struct RaggedLayout {
  int cp, rows, taps, kp, ldw, ldo;
  uint32_t off_w, off_o, off_k, off_p, bytes;
};

RaggedLayout ragged_layout(int C_in, int K, int dil, int stride, int cb,
                           int taps) {
  RaggedLayout lay;
  lay.cp = (C_in + 3) & ~3;
  lay.rows = (RG_TL - 1) * stride + dil * (K - 1) + 1;
  lay.taps = taps;
  lay.kp = (taps * lay.cp + 31) & ~31;
  lay.ldw = lay.kp + RG_WPAD;
  lay.ldo = cb + RG_OPAD;
  lay.off_w = ((uint32_t)(lay.rows * lay.cp) + 15u) & ~15u;
  lay.off_o = lay.off_w + (uint32_t)(cb * lay.ldw);
  lay.off_k = lay.off_o + (uint32_t)(RG_TL * lay.ldo * 4);
  lay.off_p = lay.off_k + (uint32_t)(lay.kp * 4);
  lay.bytes = lay.off_p + (uint32_t)(5 * cb * 4);
  return lay;
}

// Output channels per CTA: the smallest of 16, 32, 64 that holds C_out, else
// 128 (the last column block predicated).
int ragged_cb(int C_out) {
  return C_out <= 16 ? 16 : C_out <= 32 ? 32 : C_out <= 64 ? 64 : 128;
}

// Taps per weight stage: all K when they fit in RG_TARGET (in SMEM_LIMIT
// when one tap alone does not fit there), else as many as fit; 0 when not
// even one tap fits.
int ragged_taps(int C_in, int K, int dil, int stride, int cb) {
  const uint32_t one = ragged_layout(C_in, K, dil, stride, cb, 1).bytes;
  if (one > (uint32_t)SMEM_LIMIT) return 0;
  const uint32_t budget =
      one <= (uint32_t)RG_TARGET ? (uint32_t)RG_TARGET : (uint32_t)SMEM_LIMIT;
  int taps = 1;
  while (taps < K &&
         ragged_layout(C_in, K, dil, stride, cb, taps + 1).bytes <= budget)
    ++taps;
  return taps;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// VEC consecutive elements (VEC = 4 or 1) in one load or store; the caller
// keeps them VEC-element aligned
template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    r[0] = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float (&r)[VEC]) {
  if constexpr (VEC == 1) {
    r[0] = __bfloat162float(*src);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&y)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  else
    *dst = y[0];
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float (&y)[VEC]) {
  if constexpr (VEC == 1) {
    *dst = __float2bfloat16_rn(y[0]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(int8_t* dst, const int (&q)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<uint32_t*>(dst) =
        pack4(q[0] & 0xff, q[1] & 0xff, q[2] & 0xff, q[3] & 0xff);
  else
    *dst = (int8_t)q[0];
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int* src, int (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    a[0] = *src;
  }
}

// The dequant epilogue of one tile for the thread's VEC channels (their
// parameters at par[i * CB], i = 0..4): rows r, r + RSTEP, ... below r_end,
// output element offset `off` at row r. dequant_epilogue's operations, with
// the activation a template argument.
template <typename T, int CB, int VEC, int RSTEP, int ACT>
__device__ __forceinline__ void ragged_dequant_rows(const Params& p,
                                                    const int* os, int ldo,
                                                    const float* par, int r,
                                                    int r_end, long long row,
                                                    long long off) {
  float dq[VEC], bias[VEC], alpha[VEC], gamma[VEC], beta[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    dq[v] = par[v];
    bias[v] = par[CB + v];
    alpha[v] = par[2 * CB + v];
    gamma[v] = par[3 * CB + v];
    beta[v] = par[4 * CB + v];
  }
  const long long step = (long long)RSTEP * p.C_out;
  for (; r < r_end; r += RSTEP, row += RSTEP, off += step) {
    int a[VEC];
    load_vec<VEC>(os + r * ldo, a);
    float y[VEC], res[VEC];
    if (p.residual) load_vec<VEC>(static_cast<const T*>(p.residual) + off, res);
    const bool zero = p.out_mask && !p.out_mask[row];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float u = __fmul_rn(__int2float_rn(a[v]), dq[v]);
      if (p.bias) u = __fadd_rn(u, bias[v]);
      if (p.dyt) u = tanhf(u * alpha[v]) * gamma[v] + beta[v];
      if (zero) u = 0.f;
      if (p.residual) u += res[v];
      y[v] = act_fn(u, ACT);
    }
    store_vec<VEC>(static_cast<T*>(p.out) + off, y);
  }
}

// T = int8_t: requant form; T = __nv_bfloat16 / float: dequant form. CTA
// (blockIdx.x, blockIdx.y) computes column block blockIdx.y (CB channels,
// the last one cut at C_out) of the tiles (n, 64 positions) blockIdx.x,
// + gridDim.x, ... VEC (4 when it divides C_out, else 1) is the epilogue's
// channels per thread: one load and one store of VEC elements.
template <typename T, int CB, int VEC>
__global__ void __launch_bounds__(RG_THREADS, RG_MIN_CTAS)
int8_ragged_staged(Params p, RaggedLayout lay, int l_tiles, int m_tiles) {
  constexpr int NT = CB / 16;  // n8 tiles of a warp's column half
  constexpr int TPR = CB / VEC;            // epilogue threads per row
  constexpr int RSTEP = RG_THREADS / TPR;  // rows per epilogue pass
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + lay.off_w);
  int* os = reinterpret_cast<int*>(smem + lay.off_o);
  int* koff = reinterpret_cast<int*>(smem + lay.off_k);
  float* par = reinterpret_cast<float*>(smem + lay.off_p);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;          // the thread's first row
  const int c_warp = (warp >> 2) * (CB / 2);   // the warp's first column
  const int col0 = blockIdx.y * CB;
  const int ncols = min(CB, p.C_out - col0);
  const int C = p.C_in, cp = lay.cp, K = p.K;
  const int n_x = lay.rows * cp;  // x tile elements
  const int row_step = p.stride * cp;  // tile bytes between output rows
  const int n_stages = (K + lay.taps - 1) / lay.taps;
  const T* x = static_cast<const T*>(p.x);
  float inv = 1.f;  // the requant form loads int8 as it is
  if constexpr (sizeof(T) != 1) inv = *p.inv_act;
  // the epilogue's channels: the thread's VEC channels ec .. ec + VEC - 1
  // of the column block (all past C_out or none: VEC divides C_out)
  const int ec = (tid % TPR) * VEC;
  const bool e_live = ec < ncols;
  RG_CLOCK_INIT(tid == 0);

  for (int m = blockIdx.x; m < m_tiles; m += gridDim.x) {
    const int n = m / l_tiles, l0 = (m - n * l_tiles) * RG_TL;
    const long long xrow0 = (long long)n * p.L;
    RG_TILE();
    __syncthreads();  // the last tile's reads of xs and os are done
    RG_MARK(0);
    // the tile's input rows l0 * stride - pad_l .. + rows - 1, quantized,
    // with channels C_in .. cp - 1, rows outside [0, L) and masked rows 0:
    // one contiguous span of x, consecutive threads on consecutive elements
    for (int i = tid; i < n_x; i += RG_THREADS) {
      const int r = i / cp, c = i - r * cp;
      const int pos = l0 * p.stride - p.pad_l + r;
      int q = 0;
      if (c < C && pos >= 0 && pos < p.L &&
          (!p.in_mask || p.in_mask[xrow0 + pos])) {
        const T v = x[(xrow0 + pos) * C + c];
        if constexpr (sizeof(T) == 1)
          q = v;
        else
          q = clip127(__float2int_rn(__fmul_rn(to_f32(v), inv)));
      }
      xs[i] = (int8_t)q;
    }
    RG_MARK(1);
    if (m == (int)blockIdx.x) {
      // the column block's epilogue parameters, once a CTA
      for (int c = tid; c < CB; c += RG_THREADS) {
        const int cc = col0 + c;
        const bool live = c < ncols;
        par[c] = sizeof(T) == 1 ? *p.scale : live ? p.scale[cc] : 0.f;
        par[CB + c] = live && p.bias ? p.bias[cc] : 0.f;
        par[2 * CB + c] = live && p.dyt ? p.dyt[cc] : 0.f;
        par[3 * CB + c] = live && p.dyt ? p.dyt[p.C_out + cc] : 0.f;
        par[4 * CB + c] = live && p.dyt ? p.dyt[2 * p.C_out + cc] : 0.f;
      }
    }
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

    for (int s = 0; s < n_stages; ++s) {
      const int j0 = s * lay.taps;
      const int tn = min(lay.taps, K - j0);
      if (n_stages > 1 || m == (int)blockIdx.x) {
        if (s > 0) __syncthreads();  // the last stage's reads are done
        // w[j0 + j][c][col0 + nn] -> ws[nn * ldw + j * cp + c]; zeros past
        // the stage's taps, C_in and C_out
        for (int i = tid; i < CB * lay.kp; i += RG_THREADS) {
          const int kk = i / CB, nn = i - kk * CB;
          const int j = kk / cp, c = kk - j * cp;
          int8_t v = 0;
          if (j < tn && c < C && nn < ncols)
            v = p.w[((long long)(j0 + j) * C + c) * p.C_out + col0 + nn];
          ws[nn * lay.ldw + kk] = v;
        }
        // contraction index kk = j * cp + c reads x tile row r + (j0 + j) *
        // d, channel c: its offset from row r, or -1 past the stage's taps
        for (int kk = tid; kk < lay.kp; kk += RG_THREADS) {
          const int j = kk / cp;
          koff[kk] = j < tn ? (j0 + j) * p.dil * cp + (kk - j * cp) : -1;
        }
      }
      __syncthreads();  // x tile, weights, offsets, parameters complete
      RG_MARK(2);
      // a 4-byte group of the contraction never straddles taps (cp % 4 ==
      // 0); output row r reads from tile row r * stride on
      const int8_t* xr = xs + r0 * row_step;
      for (int kk = 0; kk < lay.kp; kk += 32) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = koff[kk + 16 * h + 4 * t];
          a[2 * h] = o >= 0 ? ld32(xr + o) : 0u;
          a[2 * h + 1] = o >= 0 ? ld32(xr + o + 8 * row_step) : 0u;
        }
        const int8_t* bp = ws + (c_warp + g) * lay.ldw + kk + 4 * t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (c_warp + nt * 8 < ncols) {  // the same for the whole warp
            const int8_t* b = bp + nt * 8 * lay.ldw;
            mma_k32(acc[nt], a[0], a[1], a[2], a[3], ld32(b), ld32(b + 16));
          }
        }
      }
      RG_MARK(3);
    }
    // accumulator (nt, e): row r0 + 8 * (e / 2), column c_warp + nt * 8 +
    // 2t + e % 2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = c_warp + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(os + r0 * lay.ldo + c) =
          make_int2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<int2*>(os + (r0 + 8) * lay.ldo + c) =
          make_int2(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    RG_MARK(4);
    // epilogue: a row's channels on consecutive threads, VEC a thread; the
    // tail of C_out and rows past L_out are not stored
    if (!e_live) continue;
    const int r_first = tid / TPR;
    const int r_end = min(RG_TL, p.L_out - l0);
    const long long row = (long long)n * p.L_out + l0 + r_first;
    const long long off = row * p.C_out + col0 + ec;
    const int* o = os + ec;
    if constexpr (sizeof(T) == 1) {
      const float sc = par[0];
      for (int r = r_first; r < r_end; r += RSTEP) {
        int a[VEC], q[VEC];
        load_vec<VEC>(o + r * lay.ldo, a);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          q[v] = clip127(__float2int_rn(__fmul_rn(__int2float_rn(a[v]), sc)));
        store_vec<VEC>(static_cast<int8_t*>(p.out) + off +
                           (long long)(r - r_first) * p.C_out,
                       q);
      }
    } else {
      const float* pc = par + ec;
      switch (p.act) {
        case ACT_RELU:
          ragged_dequant_rows<T, CB, VEC, RSTEP, ACT_RELU>(
              p, o, lay.ldo, pc, r_first, r_end, row, off);
          break;
        case ACT_TANH:
          ragged_dequant_rows<T, CB, VEC, RSTEP, ACT_TANH>(
              p, o, lay.ldo, pc, r_first, r_end, row, off);
          break;
        case ACT_GELU:
          ragged_dequant_rows<T, CB, VEC, RSTEP, ACT_GELU>(
              p, o, lay.ldo, pc, r_first, r_end, row, off);
          break;
        case ACT_GELU_TANH:
          ragged_dequant_rows<T, CB, VEC, RSTEP, ACT_GELU_TANH>(
              p, o, lay.ldo, pc, r_first, r_end, row, off);
          break;
        default:
          ragged_dequant_rows<T, CB, VEC, RSTEP, ACT_NONE>(
              p, o, lay.ldo, pc, r_first, r_end, row, off);
          break;
      }
    }
    RG_MARK(5);
  }
  RG_CLOCK_FLUSH();
}

template <typename T, int CB, int VEC>
cudaError_t launch_staged(const Params& p, const RaggedLayout& lay,
                          int n_rows, int sms, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_ragged_staged<T, CB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_ragged_staged<T, CB, VEC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, int8_ragged_staged<T, CB, VEC>, RG_THREADS, lay.bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int l_tiles = (p.L_out + RG_TL - 1) / RG_TL;
  const long long m_tiles = (long long)n_rows * l_tiles;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_cb = (p.C_out + CB - 1) / CB;
  // persistent: the CTAs that fit on the card at once, shared out over the
  // column blocks, no more than there are tiles
  long long gx = (long long)sms * per_sm / n_cb;
  if (gx < 1) gx = 1;
  if (gx > m_tiles) gx = m_tiles;
  int8_ragged_staged<T, CB, VEC><<<dim3((unsigned)gx, (unsigned)n_cb),
                                   RG_THREADS, lay.bytes, stream>>>(
      p, lay, l_tiles, (int)m_tiles);
  return cudaGetLastError();
}

template <typename T, int CB>
cudaError_t staged_vec(const Params& p, const RaggedLayout& lay, int n_rows,
                       int sms, cudaStream_t s) {
  if (p.C_out % 4 == 0) return launch_staged<T, CB, 4>(p, lay, n_rows, sms, s);
  return launch_staged<T, CB, 1>(p, lay, n_rows, sms, s);
}

template <typename T>
cudaError_t dispatch_staged(const Params& p, const RaggedLayout& lay, int cb,
                            int n_rows, int sms, cudaStream_t s) {
  switch (cb) {
    case 128: return staged_vec<T, 128>(p, lay, n_rows, sms, s);
    case 64: return staged_vec<T, 64>(p, lay, n_rows, sms, s);
    case 32: return staged_vec<T, 32>(p, lay, n_rows, sms, s);
    case 16: return staged_vec<T, 16>(p, lay, n_rows, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// route "ragged", resident kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int RR_SLACK = 48;  // bytes around a stage's 16-byte span

// Shared-memory layout of the resident kernel, byte offsets from a 1024-byte
// aligned base:
// [weights: kp / kb regions of cb rows x kb bytes (K-major, swizzled to kb)]
// [contraction offsets: kp / 8 pairs of s32]
// [epilogue parameters: 5 x cb f32]
// [per warpgroup (`wgs` of them): `ring` x stages (rows x C_in elements of x, as they lie in
//  device memory, plus RR_SLACK), `ring` in_mask stages (rows bytes plus
//  RR_SLACK), the s8 tile (rows x pitch) and the output image (64 rows x
//  opitch bytes)]
struct ResidentLayout {
  int cp, rows, kp, kb, pitch, ring, wgs;
  uint32_t xstage, mstage, s8, opitch, off_k, off_p, off_wg, wg_bytes, bytes;
};

inline uint32_t round16(uint32_t v) { return (v + 15u) & ~15u; }

// s8 tile row bytes: cp, padded when cp % 16 == 0 so that stride * pitch / 4
// is 4 mod 8 (the eight rows of an A fragment on eight distinct 4-bank
// groups: conflict-free 32-bit loads)
int ragged_pitch(int cp, int stride) {
  if (cp % 16) return cp;
  for (int pad = 0; pad < 32; pad += 4)
    if (stride * ((cp + pad) / 4) % 8 == 4) return cp + pad;
  return cp;
}

ResidentLayout resident_layout(int C_in, int K, int dil, int stride, int esize,
                               int cb, int wgs, int ring) {
  ResidentLayout lay;
  lay.cp = (C_in + 3) & ~3;
  lay.rows = (RG_TL - 1) * stride + dil * (K - 1) + 1;
  lay.kp = (K * lay.cp + 31) & ~31;
  lay.kb = lay.kp % 128 == 0 ? 128 : lay.kp % 64 == 0 ? 64 : 32;
  lay.pitch = ragged_pitch(lay.cp, stride);
  lay.ring = ring;
  lay.wgs = wgs;
  lay.xstage = round16((uint32_t)lay.rows * C_in * esize + RR_SLACK);
  lay.mstage = round16((uint32_t)lay.rows + RR_SLACK);
  lay.s8 = round16((uint32_t)(lay.rows * lay.pitch));
  lay.opitch = (uint32_t)(cb + 8) * esize;
  lay.off_k = (uint32_t)(lay.kp * cb);
  lay.off_p = lay.off_k + (uint32_t)lay.kp;  // kp / 8 pairs of s32
  lay.off_wg = lay.off_p + 20u * cb;
  lay.wg_bytes = ring * (lay.xstage + lay.mstage) + lay.s8 + RG_TL * lay.opitch;
  lay.bytes = lay.off_wg + wgs * lay.wg_bytes + 1024u;  // + alignment slack
  return lay;
}

// The first resident layout that fits of two warpgroups with two x stages
// each, then one stage; one warpgroup with two, then one; false when none
// fits (the staged kernel takes the shape).
bool ragged_resident(int C_in, int K, int dil, int stride, int esize, int cb,
                     ResidentLayout* lay) {
  for (int wgs = 2; wgs >= 1; --wgs)
    for (int ring = 2; ring >= 1; --ring) {
      *lay = resident_layout(C_in, K, dil, stride, esize, cb, wgs, ring);
      if (lay->bytes <= (uint32_t)SMEM_LIMIT) return true;
    }
  return false;
}

// four quantized channels from a 4-element aligned group of x in shared
// memory (T's bytes as they lie in device memory)
__device__ __forceinline__ uint32_t quant_group(const int8_t* s, float) {
  return *reinterpret_cast<const uint32_t*>(s);
}
__device__ __forceinline__ uint32_t quant_group(const __nv_bfloat16* s,
                                                float inv) {
  const uint2 v = *reinterpret_cast<const uint2*>(s);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return quant8x4(lo.x, lo.y, hi.x, hi.y, inv);
}
__device__ __forceinline__ uint32_t quant_group(const float* s, float inv) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  return quant8x4(v.x, v.y, v.z, v.w, inv);
}
// the same one element at a time, channels from `live` on as 0
template <typename T>
__device__ __forceinline__ uint32_t quant_elems(const T* s, int live,
                                                float inv) {
  uint32_t q = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < live) {
      uint32_t b;
      if constexpr (sizeof(T) == 1)
        b = (uint8_t)s[e];
      else
        b = quant8(to_f32(s[e]), inv);
      q |= b << (8 * e);
    }
  }
  return q;
}

// Quantize a tile's x stage (row r at xd + r * rowbytes, its in_mask byte
// at md[r]) into the s8 tile (row r at s8 + r * pitch): units of G words
// (4 channels each) a step, two units a thread in flight (their loads, then
// their stores). G = 4: 16 channels of aligned vectors (C_in % 16 == 0);
// G = 1: one 4-channel group, as an aligned vector (vec) or element by
// element with the channels past C_in as 0.
template <typename T, int G>
__device__ __forceinline__ void quantize_tile(const Params& p,
                                              const unsigned char* xd,
                                              const unsigned char* md,
                                              int8_t* s8, int pos0, int rows,
                                              int pitch, long long rowbytes,
                                              int wpr, bool vec, float inv,
                                              int wt) {
  const int upr = wpr / G;  // units a row
  const int units = rows * upr;
  const int dr = 128 / upr, dc = 128 % upr;
  int r = wt / upr, c = wt - (wt / upr) * upr;
  for (int u = wt; u < units; u += 2 * 128) {
    int rr[2], cc[2];
    uint32_t q[2][G];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rr[e] = r;
      cc[e] = c;
      const int pos = pos0 + r;
#pragma unroll
      for (int k = 0; k < G; ++k) q[e][k] = 0;
      if (u + 128 * e < units && pos >= 0 && pos < p.L &&
          (!p.in_mask || md[r])) {
        const T* src = reinterpret_cast<const T*>(xd + r * rowbytes) + 4 * G * c;
        if constexpr (G == 4) {
#pragma unroll
          for (int k = 0; k < 4; ++k) q[e][k] = quant_group(src + 4 * k, inv);
        } else {
          q[e][0] = vec ? quant_group(src, inv)
                        : quant_elems(src, p.C_in - 4 * c, inv);
        }
      }
      r += dr;
      c += dc;
      if (c >= upr) {
        c -= upr;
        ++r;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (u + 128 * e >= units) break;
#pragma unroll
      for (int k = 0; k < G; ++k)
        *reinterpret_cast<uint32_t*>(s8 + rr[e] * pitch + 4 * (G * cc[e] + k)) =
            q[e][k];
    }
  }
}

// NS k32 steps from step q: A fragments (rows r and r + 8 of the warp, the
// s8 tile rows r * stride + j * d at the contraction offsets of the step's
// bytes 4t and 16 + 4t), then NS wgmmas on the resident weights, retired
// before A is reloaded. FIRST: the tile's first steps, whose first wgmma
// overwrites acc.
template <int NS, bool FIRST, int R>
__device__ __forceinline__ void resident_steps(int (&acc)[R],
                                               const int8_t* arow, int a8,
                                               const int2* koff, int t, int q,
                                               uint64_t desc0, int kb_log2,
                                               uint32_t region) {
  uint32_t a[NS][4];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const int2 o = koff[4 * (q + u) + t];
    const int o0 = o.x, o1 = o.y;
    a[u][0] = o0 >= 0 ? ld32(arow + o0) : 0u;
    a[u][1] = o0 >= 0 ? ld32(arow + a8 + o0) : 0u;
    a[u][2] = o1 >= 0 ? ld32(arow + o1) : 0u;
    a[u][3] = o1 >= 0 ? ld32(arow + a8 + o1) : 0u;
  }
  if (!FIRST) hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const uint32_t kk = 32u * (q + u);
    const uint32_t off = (kk >> kb_log2) * region + (kk & ((1u << kb_log2) - 1));
    if (FIRST && u == 0)
      hopper::wgmma_s8_rs_first(acc, a[u], desc0 + (off >> 4));
    else
      hopper::wgmma_s8_rs(acc, a[u], desc0 + (off >> 4), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(a);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack_pair<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dequant epilogue of a warpgroup's tile from its accumulators into
// the output image: thread (warp, g, t) holds rows rl = 16 warp + g and rl
// + 8, columns 8 j + 2t (+1); dq, bias, DYT, out_mask (z), residual,
// activation in f32, each multiply and the bias add an explicit _rn
// operation. PLAIN: a bias and nothing else before the activation (the
// forms on the paths), the column pair's dq and bias loaded once for both
// rows, the activation ACT; else the activation p.act, chosen at run time.
template <typename T, int CB, int ACT, bool PLAIN>
__device__ __forceinline__ void resident_dequant_as(
    const Params& p, const int (&acc)[CB / 2], const float* par,
    unsigned char* img, uint32_t opitch, int rl, int t, const bool (&z)[2],
    long long row0, int l_live, int ncols, int col0) {
#pragma unroll
  for (int j = 0; j < CB / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 dq = *reinterpret_cast<const float2*>(par + c);
    float2 bias = make_float2(0.f, 0.f);
    if (PLAIN) bias = *reinterpret_cast<const float2*>(par + CB + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float u = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]),
                            e ? dq.y : dq.x);
        if (PLAIN) {
          u = __fadd_rn(u, e ? bias.y : bias.x);
          y[e] = act_fn(u, ACT);
        } else {
          if (p.bias) u = __fadd_rn(u, par[CB + c + e]);
          if (p.dyt)
            u = tanhf(u * par[2 * CB + c + e]) * par[3 * CB + c + e] +
                par[4 * CB + c + e];
          if (z[h]) u = 0.f;
          if (p.residual && r < l_live && c + e < ncols)
            u += to_f32(static_cast<const T*>(p.residual)
                            [(row0 + r) * p.C_out + col0 + c + e]);
          y[e] = act_fn(u, p.act);
        }
      }
      unsigned char* dst = img + r * opitch + c * sizeof(T);
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = pack_pair<T>(y[0], y[1]);
    }
    // no column's parameters loaded ahead of the last column's stores: 64
    // accumulators leave room for no more at 128 registers
    asm volatile("" ::: "memory");
  }
}

template <typename T, int CB>
__device__ __forceinline__ void resident_dequant(
    const Params& p, const int (&acc)[CB / 2], const float* par,
    unsigned char* img, uint32_t opitch, int rl, int t, const bool (&z)[2],
    long long row0, int l_live, int ncols, int col0) {
#define RG_DEQUANT(ACT, PLAIN)                                            \
  resident_dequant_as<T, CB, ACT, PLAIN>(p, acc, par, img, opitch, rl, t, \
                                         z, row0, l_live, ncols, col0)
  if (!p.bias || p.dyt || p.out_mask || p.residual) {
    RG_DEQUANT(ACT_NONE, false);
    return;
  }
  switch (p.act) {
    case ACT_RELU: RG_DEQUANT(ACT_RELU, true); break;
    case ACT_TANH: RG_DEQUANT(ACT_TANH, true); break;
    case ACT_GELU: RG_DEQUANT(ACT_GELU, true); break;
    case ACT_GELU_TANH: RG_DEQUANT(ACT_GELU_TANH, true); break;
    default: RG_DEQUANT(ACT_NONE, true); break;
  }
#undef RG_DEQUANT
}

// rows 0 .. rows - 1 of the image (units of U bytes, `upr` a row) to device
// memory, row r at og + r * gpitch, as streaming stores (plain ones below 4
// bytes), two units a thread in flight
template <int U>
__device__ __forceinline__ void copy_image(const unsigned char* img,
                                           uint32_t opitch, char* og,
                                           long long gpitch, int rows,
                                           int upr, int wt) {
  using V = typename std::conditional<
      U == 16, uint4,
      typename std::conditional<
          U == 8, uint2,
          typename std::conditional<
              U == 4, unsigned int,
              typename std::conditional<U == 2, unsigned short,
                                        unsigned char>::type>::type>::type>::
      type;
  const int dr = 128 / upr, dc = 128 % upr;
  int r = wt / upr, c = wt - (wt / upr) * upr;
  while (r < rows) {
    int rr[2], cc[2];
    V v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rr[e] = r;
      cc[e] = c;
      if (r < rows) v[e] = *reinterpret_cast<const V*>(img + r * opitch + c * U);
      r += dr;
      c += dc;
      if (c >= upr) {
        c -= upr;
        ++r;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (rr[e] >= rows) break;
      V* dst = reinterpret_cast<V*>(og + rr[e] * gpitch + cc[e] * U);
      if constexpr (U >= 4)
        __stcs(dst, v[e]);
      else
        *dst = v[e];
    }
  }
}

// T = int8_t: requant form; T = __nv_bfloat16 / float: dequant form. CTA
// (blockIdx.x, blockIdx.y) owns column block blockIdx.y (CB channels, the
// last cut at C_out) with its K taps resident, and its tiles (n, 64 output
// positions) blockIdx.x, + gridDim.x, ...: warpgroup wg takes every second
// one from the wg-th (with two warpgroups). MINB: the CTAs an SM the
// registers must allow (2: at most 128 a thread; 1 where the layout leaves
// room for one CTA only).
template <typename T, int CB, int MINB>
__global__ void __launch_bounds__(256, MINB)
int8_ragged(Params p, ResidentLayout lay, int l_tiles, int m_tiles) {
  using namespace hopper;
  constexpr bool REQUANT = sizeof(T) == 1;
  constexpr int ES = sizeof(T);
  constexpr int R = CB / 2;  // accumulator registers a thread
  // k32 steps a wgmma group: two when 64 accumulators must share 128
  // registers with the rest
  constexpr int NSMAX = CB == 128 && MINB == 2 ? 2 : 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);
  int2* koff = reinterpret_cast<int2*>(sb + lay.off_k);
  float* par = reinterpret_cast<float*>(sb + lay.off_p);
  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = blockIdx.y * CB;
  const int ncols = min(CB, p.C_out - col0);
  const int C = p.C_in, K = p.K, cp = lay.cp, S = p.stride;
  const long long rowbytes = (long long)C * ES;
  unsigned char* wgs = sb + lay.off_wg + wg * lay.wg_bytes;
  unsigned char* mst = wgs + lay.ring * lay.xstage;
  int8_t* s8 = reinterpret_cast<int8_t*>(mst + lay.ring * lay.mstage);
  unsigned char* img = reinterpret_cast<unsigned char*>(s8) + lay.s8;
  const int m_step = lay.wgs * gridDim.x;
  const int m_first = blockIdx.x + wg * gridDim.x;
  const int n_local =
      m_first < m_tiles ? (m_tiles - m_first + m_step - 1) / m_step : 0;
  const uintptr_t xg = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t mg = reinterpret_cast<uintptr_t>(p.in_mask);

  // Tile li's rows pos0 .. pos0 + rows - 1 (those inside [0, L)) into x
  // stage li % ring, the in_mask bytes beside them: the 16-byte aligned span
  // around them, placed so that shared memory matches device memory mod 16
  // (x row r at stage + 16 + (x + (n L + pos0) * rowbytes) % 16 + r *
  // rowbytes); then one cp.async group, empty past the last tile.
  auto issue = [&](int li) {
    if (li < n_local) {
      const int m = m_first + li * m_step;
      const int n = m / l_tiles, l0 = (m - n * l_tiles) * RG_TL;
      const int pos0 = l0 * S - p.pad_l;
      const int lo = max(pos0, 0), hi = min(pos0 + lay.rows, p.L);
      const long long row_lo = (long long)n * p.L + lo;
      const long long row_hi = (long long)n * p.L + hi;
      const int st = li % lay.ring;
      {
        const uintptr_t ga = xg + row_lo * rowbytes, gb = xg + row_hi * rowbytes;
        const uintptr_t a16 = ga & ~(uintptr_t)15;
        const uint32_t dst = smem_u32(wgs + st * lay.xstage) + 16u +
                             (uint32_t)((xg + ((long long)n * p.L + pos0) *
                                                  rowbytes) & 15) +
                             (uint32_t)((lo - pos0) * rowbytes) -
                             (uint32_t)(ga - a16);
        const int chunks = (int)((((gb + 15) & ~(uintptr_t)15) - a16) >> 4);
        for (int i = wt; i < chunks; i += 128)
          cp_async16(dst + 16u * i, reinterpret_cast<const void*>(a16 + 16u * i));
      }
      if (p.in_mask) {
        const uintptr_t ga = mg + row_lo, gb = mg + row_hi;
        const uintptr_t a16 = ga & ~(uintptr_t)15;
        const uint32_t dst = smem_u32(mst + st * lay.mstage) + 16u +
                             (uint32_t)((mg + (long long)n * p.L + pos0) & 15) +
                             (uint32_t)(lo - pos0) - (uint32_t)(ga - a16);
        const int chunks = (int)((((gb + 15) & ~(uintptr_t)15) - a16) >> 4);
        for (int i = wt; i < chunks; i += 128)
          cp_async16(dst + 16u * i, reinterpret_cast<const void*>(a16 + 16u * i));
      }
    }
    cp_async_commit();
  };
  for (int li = 0; li < lay.ring; ++li) issue(li);

  // resident weights: w[j][c][col0 + nn] -> B row nn, contraction byte kk =
  // j * cp + c (region kk / kb, swizzled to kb), zeros past C_in, C_out and
  // K * cp; an item is 4 channels x 16 output channels: four 16-byte loads
  // (4-byte or single-byte ones where C_out's alignment does not allow them)
  // and four 4 x 4 byte transposes
  const int kb_log2 = lay.kb == 128 ? 7 : lay.kb == 64 ? 6 : 5;
  const uint32_t region = (uint32_t)CB * lay.kb;
  {
    const int c4n = cp / 4;
    const bool al16 = p.C_out % 16 == 0 &&
                      (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
    const bool al4 = p.C_out % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(p.w) & 3) == 0;
    auto put = [&](int nn, int kk, uint32_t v) {
      *reinterpret_cast<uint32_t*>(
          sb + (kk >> kb_log2) * region +
          swizzle((uint32_t)nn * lay.kb + (kk & (lay.kb - 1)), lay.kb)) = v;
    };
    for (int i = tid; i < K * c4n * (CB / 16); i += blockDim.x) {
      const int b = i % (CB / 16), jc = i / (CB / 16);
      const int j = jc / c4n, c4 = jc - j * c4n;
      uint32_t v[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e, n0 = 16 * b;
        const int8_t* src = p.w + ((long long)j * C + c) * p.C_out + col0 + n0;
        if (c >= C || n0 >= ncols) {
#pragma unroll
          for (int u = 0; u < 4; ++u) v[e][u] = 0u;
        } else if (al16 && n0 + 16 <= ncols) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(src);
          v[e][0] = w4.x; v[e][1] = w4.y; v[e][2] = w4.z; v[e][3] = w4.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int nu = n0 + 4 * u;
            if (al4 && nu + 4 <= ncols) {
              v[e][u] = ld32(src + 4 * u);
            } else {
              uint32_t x4 = 0;
              for (int k = 0; k < 4; ++k)
                if (nu + k < ncols) x4 |= (uint32_t)(uint8_t)src[4 * u + k] << (8 * k);
              v[e][u] = x4;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t o[4];
        transpose4(v[0][u], v[1][u], v[2][u], v[3][u], o);
#pragma unroll
        for (int e = 0; e < 4; ++e) put(16 * b + 4 * u + e, j * cp + 4 * c4, o[e]);
      }
    }
    // the contraction's padding K * cp .. kp - 1
    const int kz = (lay.kp - K * cp) / 4;
    for (int i = tid; i < CB * kz; i += blockDim.x)
      put(i / kz, K * cp + 4 * (i % kz), 0u);
    // the 4-byte group at contraction byte kk reads s8 row r * stride + j *
    // d, channel c, at this offset from row r * stride, or nothing (-1) past
    // K * cp; entry 4 q + t holds step q's groups 4t and 16 + 4t
    auto group = [&](int kk) {
      const int j = kk / cp;
      return j < K ? j * p.dil * lay.pitch + (kk - j * cp) : -1;
    };
    for (int i = tid; i < lay.kp / 8; i += blockDim.x) {
      const int kk = 32 * (i / 4) + 4 * (i % 4);
      koff[i] = make_int2(group(kk), group(kk + 16));
    }
    for (int c = tid; c < CB; c += blockDim.x) {
      const int cc = col0 + c;
      const bool live = c < ncols;
      par[c] = REQUANT ? *p.scale : live ? p.scale[cc] : 0.f;
      par[CB + c] = live && p.bias ? p.bias[cc] : 0.f;
      par[2 * CB + c] = live && p.dyt ? p.dyt[cc] : 0.f;
      par[3 * CB + c] = live && p.dyt ? p.dyt[p.C_out + cc] : 0.f;
      par[4 * CB + c] = live && p.dyt ? p.dyt[2 * p.C_out + cc] : 0.f;
    }
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)
  __syncthreads();

  float inv = 1.f;  // the requant form copies int8 as it is
  if constexpr (!REQUANT) inv = *p.inv_act;
  // x in 4-channel groups as aligned vectors; in 16-channel ones
  const bool vec = C % 4 == 0 && (xg & (4 * ES - 1)) == 0;
  const bool v16 = C % 16 == 0 && (xg & 15) == 0;
  const uint64_t desc0 = smem_desc(base, lay.kb);
  const int nsteps = lay.kp / 32;
  const int rl = 16 * warp + g;  // the thread's accumulator rows rl, rl + 8
  const int8_t* arow = s8 + rl * S * lay.pitch;
  const int a8 = 8 * S * lay.pitch;
  const long long gpitch = (long long)p.C_out * ES;
  const int seg = ncols * ES;  // bytes of a row of the column block
  uint32_t ubits = (uint32_t)(reinterpret_cast<uintptr_t>(p.out) + col0 * ES) |
                   (uint32_t)gpitch | (uint32_t)seg | lay.opitch | 16u;
  const int U = (int)(ubits & (0u - ubits));
  const int upr = seg / U;
  RG_CLOCK_INIT(wt == 0);

  for (int li = 0; li < n_local; ++li) {
    const int m = m_first + li * m_step;
    const int n = m / l_tiles, l0 = (m - n * l_tiles) * RG_TL;
    const int pos0 = l0 * S - p.pad_l;
    const int st = li % lay.ring;
    RG_TILE();
    // tile li's x has landed (every thread's copies), and the last tile's
    // s8 reads and image stores are done
    if (lay.ring == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    named_bar_sync(1 + wg, 128);
    RG_MARK(0);
    {
      // quantize: s8 words from x rows; rows outside [0, L), rows in_mask
      // masks and channels past C_in as 0
      const unsigned char* xd =
          wgs + st * lay.xstage + 16 +
          ((xg + ((long long)n * p.L + pos0) * rowbytes) & 15);
      const unsigned char* md =
          mst + st * lay.mstage + 16 + ((mg + (long long)n * p.L + pos0) & 15);
      if (v16)
        quantize_tile<T, 4>(p, xd, md, s8, pos0, lay.rows, lay.pitch,
                            rowbytes, cp / 4, true, inv, wt);
      else
        quantize_tile<T, 1>(p, xd, md, s8, pos0, lay.rows, lay.pitch,
                            rowbytes, cp / 4, vec, inv, wt);
    }
    named_bar_sync(1 + wg, 128);  // the s8 tile is complete; stage st free
    RG_MARK(1);
    issue(li + lay.ring);
    const long long row0 = (long long)n * p.L_out + l0;
    const int l_live = min(RG_TL, p.L_out - l0);
    bool z[2] = {false, false};
    if constexpr (!REQUANT) {
      if (p.out_mask) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          z[h] = rl + 8 * h < l_live && !p.out_mask[row0 + rl + 8 * h];
      }
    }
    int acc[R];
    int q = nsteps >= NSMAX ? NSMAX : nsteps >= 2 ? 2 : 1;
    if (q == NSMAX)
      resident_steps<NSMAX, true>(acc, arow, a8, koff, t, 0, desc0, kb_log2,
                                  region);
    else if (q == 2)
      resident_steps<2, true>(acc, arow, a8, koff, t, 0, desc0, kb_log2, region);
    else
      resident_steps<1, true>(acc, arow, a8, koff, t, 0, desc0, kb_log2, region);
    for (; q + NSMAX <= nsteps; q += NSMAX)
      resident_steps<NSMAX, false>(acc, arow, a8, koff, t, q, desc0, kb_log2,
                                   region);
    if (q + 2 <= nsteps) {
      resident_steps<2, false>(acc, arow, a8, koff, t, q, desc0, kb_log2,
                               region);
      q += 2;
    }
    if (q < nsteps)
      resident_steps<1, false>(acc, arow, a8, koff, t, q, desc0, kb_log2,
                               region);
    fence_regs(acc);
    RG_MARK(2);
    if constexpr (REQUANT) {
      const float sc = par[0];
#pragma unroll
      for (int j = 0; j < CB / 8; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          char2 v;
          v.x = (signed char)clip127(__float2int_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc)));
          v.y = (signed char)clip127(__float2int_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc)));
          *reinterpret_cast<char2*>(img + (rl + 8 * h) * lay.opitch + c) = v;
        }
      }
    } else {
      resident_dequant<T, CB>(p, acc, par, img, lay.opitch, rl, t, z, row0,
                              l_live, ncols, col0);
    }
    named_bar_sync(1 + wg, 128);  // the image is complete
    RG_MARK(3);
    char* og = static_cast<char*>(p.out) + (row0 * p.C_out + col0) * ES;
    switch (U) {
      case 16: copy_image<16>(img, lay.opitch, og, gpitch, l_live, upr, wt); break;
      case 8: copy_image<8>(img, lay.opitch, og, gpitch, l_live, upr, wt); break;
      case 4: copy_image<4>(img, lay.opitch, og, gpitch, l_live, upr, wt); break;
      case 2: copy_image<2>(img, lay.opitch, og, gpitch, l_live, upr, wt); break;
      default: copy_image<1>(img, lay.opitch, og, gpitch, l_live, upr, wt); break;
    }
    RG_MARK(4);
  }
  cp_async_wait<0>();
  RG_CLOCK_FLUSH();
}

template <typename T, int CB, int MINB>
cudaError_t launch_resident(const Params& p, const ResidentLayout& lay,
                            int n_rows, int sms, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_ragged<T, CB, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_ragged<T, CB, MINB>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, int8_ragged<T, CB, MINB>, 128 * lay.wgs, lay.bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int l_tiles = (p.L_out + RG_TL - 1) / RG_TL;
  const long long m_tiles = (long long)n_rows * l_tiles;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_cb = (p.C_out + CB - 1) / CB;
  // persistent: the CTAs that fit on the card at once, shared out over the
  // column blocks, each with at least one tile a warpgroup where there are
  // enough
  long long gx = (long long)sms * per_sm / n_cb;
  if (gx > (m_tiles + lay.wgs - 1) / lay.wgs)
    gx = (m_tiles + lay.wgs - 1) / lay.wgs;
  if (gx < 1) gx = 1;
  int8_ragged<T, CB, MINB><<<dim3((unsigned)gx, (unsigned)n_cb),
                             128 * lay.wgs, lay.bytes, stream>>>(
      p, lay, l_tiles, (int)m_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_resident(const Params& p, const ResidentLayout& lay,
                              int cb, int n_rows, int sms, cudaStream_t s) {
  switch (cb) {
    // 128 output channels: the registers a thread may use depend on whether
    // two CTAs' layouts fit on an SM
    case 128:
      return 2 * lay.bytes <= (uint32_t)SMEM_LIMIT
                 ? launch_resident<T, 128, 2>(p, lay, n_rows, sms, s)
                 : launch_resident<T, 128, 1>(p, lay, n_rows, sms, s);
    case 64: return launch_resident<T, 64, 2>(p, lay, n_rows, sms, s);
    case 32: return launch_resident<T, 32, 2>(p, lay, n_rows, sms, s);
    case 16: return launch_resident<T, 16, 2>(p, lay, n_rows, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The ragged route's cycle sums since the last call (phases, tiles, CTAs:
// RG_PHASES + 2 values) into `host`, then cleared; cudaErrorNotSupported
// unless built with -DJT_RAGGED_CYCLES.
extern "C" int jt_int8_ragged_cycles(unsigned long long* host) {
#ifdef JT_RAGGED_CYCLES
  cudaError_t e = cudaMemcpyFromSymbol(host, g_rg_cycles, sizeof(g_rg_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[RG_PHASES + 2] = {};
  return (int)cudaMemcpyToSymbol(g_rg_cycles, zero, sizeof(zero));
#else
  (void)host;
  return (int)cudaErrorNotSupported;
#endif
}

// in_dtype: 0 = float32, 1 = bfloat16 (dequant form), 2 = int8 (requant
// form). The launch plan of ops/int8_conv.py::int8_plan: route 1 = wgmma (cb
// output channels per CTA, kw bytes of C_in per weight / s8 chunk, `stages`
// ring stages; not f32), route 0 = mma (cb; kw and stages 0), both with
// C_in and C_out multiples of 16 and stride 1; route 2 = ragged (cb =
// ragged_cb(C_out), kw the stage's contraction bytes, `stages` the taps per
// weight stage), for any C_in, C_out and stride. pad_l and L_out are the
// wrapper's (XLA's SAME or VALID). smem_bytes must equal the layout this
// file computes
// for the plan. sms is the card's SM count. Returns a cudaError_t (0 =
// success).
extern "C" int jt_int8_conv(int in_dtype, const void* x, const void* w,
                            const void* scale, const void* inv_act,
                            const void* bias, const void* dyt,
                            const void* in_mask, const void* out_mask,
                            const void* residual, void* out, int n_rows, int L,
                            int L_out, int C_in, int C_out, int K, int dil,
                            int stride, int pad_l, int act, int route, int cb,
                            int kw,
                            int stages, int smem_bytes, int sms, void* stream) {
  if (n_rows <= 0 || L <= 0 || L_out <= 0 || K <= 0 || dil <= 0 ||
      stride <= 0 || pad_l < 0 || C_in <= 0 || C_out <= 0 || cb <= 0 ||
      in_dtype < 0 || in_dtype > 2)
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
  p.stride = stride;
  p.pad_l = pad_l;
  p.act = act;
  p.taps_per_stage = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (sms <= 0 || cb != ragged_cb(C_out)) return (int)cudaErrorInvalidValue;
    ResidentLayout rl;
    if (ragged_resident(C_in, K, dil, stride, in_dtype == 0 ? 4 : 3 - in_dtype,
                        cb, &rl)) {
      if (rl.kp != kw || stages != K || rl.bytes != (uint32_t)smem_bytes)
        return (int)cudaErrorInvalidValue;
      switch (in_dtype) {
        case 0: return (int)dispatch_resident<float>(p, rl, cb, n_rows, sms, s);
        case 1:
          return (int)dispatch_resident<__nv_bfloat16>(p, rl, cb, n_rows, sms,
                                                       s);
        default:
          return (int)dispatch_resident<int8_t>(p, rl, cb, n_rows, sms, s);
      }
    }
    const int taps = ragged_taps(C_in, K, dil, stride, cb);
    if (taps == 0 || taps != stages) return (int)cudaErrorInvalidValue;
    const RaggedLayout lay = ragged_layout(C_in, K, dil, stride, cb, taps);
    if (lay.kp != kw || lay.bytes != (uint32_t)smem_bytes)
      return (int)cudaErrorInvalidValue;
    switch (in_dtype) {
      case 0: return (int)dispatch_staged<float>(p, lay, cb, n_rows, sms, s);
      case 1:
        return (int)dispatch_staged<__nv_bfloat16>(p, lay, cb, n_rows, sms, s);
      default: return (int)dispatch_staged<int8_t>(p, lay, cb, n_rows, sms, s);
    }
  }
  if (C_in % 16 != 0 || C_out % 16 != 0 || C_out % cb != 0 || stride != 1)
    return (int)cudaErrorInvalidValue;
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
