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
// bf16, every shape the resident layout cannot hold: conv_bf16_stream<CB>
// (route wgmma_stream). The Pallas kernel takes any C and K; the resident
// kernel needs C % 16 == 0 (wgmma's K step), K <= 56 (the in_mask bits of a
// fragment in one word, TMA boxes of at most 256 rows) and the k * C * CB
// weights beside two whole-C x stages (C 1024 at K 5 does not fit).
//  * What bounds it (L 500): C 200, K 5 at N 12288 2.46e12 FLOPs, 2.485
//    ms (operations); C 40 / 37, K 3 at N 12288 0.98 / 0.91 GB of bf16 in
//    and out, 0.293 / 0.271 ms (bytes); C 1024, K 5 at N 1536 8.143 ms and
//    C 128, K 61 1.552 ms (operations).
//  * Column blocks cut to C: CB (the wgmma N, a multiple of 16 up to 256)
//    is C / ceil(C / 256) rounded up to 16, so C <= 256 runs one column
//    block (C 200: 208 columns, x read once) and C 1024 four of 256. The
//    products of a k16 step go as wgmma instructions of 128 and 64 columns
//    and one of the remaining 48, 32 or 16 (hopper.cuh
//    wgmma_bf16_rs_mn_n), so 16 instances cover every width.
//  * Schedule: persistent, one CTA an SM. A cluster of `cluster` CTAs (2
//    for streamed weights copied by TMA whose rows are not 128-byte
//    aligned, C % 64 != 0, where multicast measured faster; else 1) owns
//    column block cluster % n_cb and walks groups of `cluster`
//    neighbouring 128-row tiles (one 64-row wgmma M for each of the two
//    consumer warpgroups), rank r the group's tile r; every CTA of a
//    cluster walks as many groups, a tile past the last being a ghost
//    (zeros in, nothing out).
//    A tile is a sequence of weight steps: its tap blocks (all K taps up to
//    129, the most a 256-row TMA box holds with its 128 rows, else evened
//    out) by its 64-channel chunks (the last zero past C) by the block's
//    taps.
//  * Two rings. An x stage holds a (tap block, chunk): 128 + taps - 1 rows
//    x 64 channels (128-byte rows, swizzled) and those rows' 256 in_mask
//    bytes; it serves every tap of the block. A weight stage holds one
//    step: the chunk's 64 input rows of tap j x the block's columns, in
//    64-column blocks as w stores them (MN-major, read by wgmma through
//    smem_desc_mn with the transpose bit: no transpose anywhere). Where
//    all K * ceil(C / 64) steps of a tile fit the weight ring beside 2-4
//    x stages (C 40, K 3: 24 KB), they are copied once and stay resident.
//  * Producer (C % 8 == 0): one elected thread of the third warpgroup
//    issues TMA copies against mbar_arrive_expect_tx: x through a 3-D map
//    over (C, L, N), so rows outside [0, L) and channels past C arrive as
//    zeros, never as the neighbouring sequence's rows (the next warp
//    copies the rows' in_mask bytes beside them: no tensor map describes
//    rows of L bytes unless L % 16 == 0); the weights through a 3-D map
//    over (C_out, C_in, K), each rank of a cluster copying its 64 /
//    cluster input rows of every column block and multicasting them to
//    every CTA of the cluster (each weight box read from L2 once a
//    cluster, not once a tile). A weight stage is refilled once the
//    consumer warps of every CTA of the cluster have released it (remote
//    arrivals on the issuing CTA's empty barrier). Rows that no tensor
//    map describes (C % 8 != 0) are copied by the warpgroup's 128 threads
//    with 2-byte loads into the same layouts, cluster 1.
//  * Consumers: A (the x rows shifted by the tap) from registers by
//    ldmatrix at swizzled addresses, rows that in_mask masks zeroed in the
//    registers from the stage's mask bytes (any K); B the weight stage's
//    descriptor. A step's k16 steps (the last chunk's only those it holds:
//    13 of 16 at C 200) go in one wgmma group, and one group stays in
//    flight across the steps: a step issues its group, waits for the one
//    before (wait_group 1) and then hands that group's stages back; the
//    pipe drains only at a tile's end, before its epilogue. Two A
//    register sets alternate.
//  * Epilogue: the resident kernel's (epilogue_regs), the residual pairs
//    and out_mask bytes asked for at a tile's first step (CB <= 128: into
//    registers; wider: their lines into L2, loaded before the epilogue);
//    stored from the registers (bf16 pairs where C is even, else single
//    elements), rows past L and columns past C not at all.
//  * L2: each weight box is read once a cluster; at C 200 (one column
//    block) the weights of a call are 5 * 200 * 200 * 2 B a tile over
//    49,152 tiles, about 20 GB, 10 GB with a cluster of 2. On the H100
//    the kernel reaches 40 % of its bound at C 200 and 64-71 % at C 1024
//    (chip_smoke.py --domain); a deeper weight ring still makes it faster
//    (--sweep), so the weights' delivery sets its pace.
// f32: conv_f32_ring, a persistent kernel of plain FMAs in full precision
// (never TF32: the f32 route is the one held against the reference's f32).
// Taken by predict / train / taxonomy --precision float32 and by the f32
// data gradient, for every (C, k) the f32 forward takes.
//  * What bounds it: at the flagship shape a call is 1.0e12 FLOPs, 15.0 ms
//    at the card's 67 TFLOP/s f32 rate outside the tensor cores, against
//    6.3 GB of f32 in and out (1.9 ms at 3.35 TB/s; conv2 9.4 GB, 2.8 ms):
//    bound by operations (at k 11 2.2e12 FLOPs, 33.1 ms), so the design is
//    about keeping the FMA pipes fed from registers. (The first f32 kernel
//    started a CTA per 64 positions that restaged all k * C * CB weights
//    one tap at a time, about 32 GB of L2 reads a call behind two barriers
//    a tap, and issued a shared load for every FMA: 18-19 % of the bound,
//    81 ms at k 5 and 173 ms at k 11.)
//  * Schedule: about one CTA per SM (the count comes from the wrapper),
//    each owning column block b % n_cb (CB = 64, 32 or 16 channels, the
//    plan's). Its 8 warps are workers: warp w of CTA b walks the units (n,
//    32 positions) w', w' + W, ... of the column block (w' its worker
//    index, W the workers), so a sequence of 500 positions wastes 12 rows,
//    not a tile's worth.
//  * Tap blocks: a unit's k taps are cut into blocks of at most 9, of near
//    equal size (k 11: 5 + 6), each a pass over the unit's channels; the
//    accumulators stay in registers across the blocks.
//  * Weights resident where all k taps of the column block fit beside the
//    ring (k * C * CB f32: 163,840 B at C = 128, k = 5, CB = 64; C 128 to
//    k 11 at CB 32): each CTA stages them once with the per-channel bias,
//    alpha, gamma, beta, and after that one __syncthreads the warps never
//    meet again. Past that (C 128 from k 12, C 256 from k 6) the weights
//    are streamed: two buffers of one tap block (of at most `taps`: 3 at
//    C 128, CB 64), the CTA's warps walk their units in step, and the first
//    ring stage of each block carries the block's weights, copied by the
//    whole CTA with cp.async into the buffer the block before last used;
//    one __syncthreads at each block start makes them visible and frees
//    the other buffer. (On the H100 a streamed CB 64 ran 53 % of the f32
//    peak where resident weights fit only at CB 16, 45 %: the wrapper's
//    plan prefers it.) Up to 9 taps with resident weights (one block) the
//    kernel is built without the block bookkeeping (TAPS false).
//  * A ring per warp: stages of its unit's tap block window, 32 + block -
//    1 rows (halo included, starting at the block's first tap) x 16
//    channels (64-byte rows), 2-4 of them, filled by the warp's own lanes
//    with 16-byte cp.async copies, one group a stage, S - 1 stages ahead
//    and across block and unit boundaries, so the next loads run under
//    this stage's products and epilogue; __syncwarp is the only barrier
//    with resident weights. Rows before 0, past L - 1 or masked by in_mask
//    are zero filled by the copy itself (src-size 0).
//  * Register blocking: lane (tr, tc) owns 8 rows (8 tr ..) x CB / 8
//    columns (8 VW g + VW tc .., VW = 4 or 2): 64 f32 accumulators at CB
//    64. For 4 channels it loads the window of its 8 + kb - 1 rows once
//    (float4 each) and reuses it for all kb taps of the block (tap j of row
//    r is window row r + j), and each weight float4 of (tap, channel) feeds
//    32 FMAs: 13 shared loads per 320 FMAs at k 5. The tap loop is a
//    template of the block's taps (1..9) chosen once a stage, so the window
//    stays in registers.
//  * Bank conflicts: a row's 16-byte unit u is stored at u ^ ((row >> 3) &
//    3), so the four row groups of a warp (rows 8 apart, 64-byte rows) read
//    four different bank quarters; the lanes of a row group read the same
//    address (a broadcast). The weight reads of a warp are 8 consecutive
//    16-byte units of one row.
//  * Epilogue from the accumulator registers after the last block, in the
//    plain version's order (bias, DYT with tanhf, out_mask, residual,
//    activation with erff / tanhf): the residual and out_mask of the
//    thread's 8 rows are loaded first, all at once (the residual lines were
//    prefetched into L2 at the start of the unit's last stage), then each
//    step runs over all 64 values behind one uniform branch: per-element
//    branches on the activation and the options cost more than the
//    products' 69 % rate left (measured on the H100). float4 stores: a
//    warp writes 128 contiguous bytes a row. While one warp runs its
//    epilogue, the others multiply.
//  * Route f32_ring_pad (the RAG instances): C % 16 != 0 counts the
//    channels up to Cp, C rounded up to 16: the last ring stage and the
//    weight rows past C are zero filled (16-byte copies where C % 4 == 0,
//    else 4-byte ones), the last column block is cut at C, and the
//    residual, stores and parameters past C are skipped. Where one tap of
//    Cp x CB weights does not fit (C past about 1,560), the streamed
//    weights come in groups of kw channels, a group's first stage carrying
//    them as a tap block's does. Bound (L 500, N 1536): C 40, K 3 7.4e9
//    FLOPs, 0.110 ms (operations).
//  * The plan (CB, weight taps, stages, bytes) is made in one place, the
//    wrapper's conv_plan / f32_plan; the entry recomputes the layout and
//    refuses a plan that disagrees.
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

// The epilogue on a consumer warpgroup's accumulator fragment, in the plain
// version's order: columns 8 q + c_lane (+1) of rows r0 (acc[4q], [4q+1])
// and r0 + 8 (acc[4q+2], [4q+3]) of a CB-column block; par holds the block's
// bias (alpha * bias with DYT), alpha, gamma and beta, rv the residual's
// bf16 pairs ([2q]: row r0, [2q+1]: row r0 + 8) when res, z0 / z1 the rows
// that out_mask zeroes.
template <int CB>
__device__ __forceinline__ void epilogue_regs(float (&acc)[CB / 2],
                                              const float* par,
                                              const Params& p, bool z0,
                                              bool z1, bool res,
                                              const uint32_t (&rv)[CB / 4],
                                              int c_lane) {
  constexpr int R = CB / 2;
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

      // ---- epilogue from the registers ----
      epilogue_regs<CB>(acc, par, p, z0, z1, res != nullptr, rv, c_lane);
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
// bf16, every other shape: conv_bf16_stream (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int ST_TM = TL * CONSUMERS;  // output rows a tile: both warpgroups'
constexpr int ST_KW = 64;              // input channels a chunk: 128-byte rows
constexpr int ST_MAX_TAPS = 256 - ST_TM + 1;  // a TMA box holds <= 256 rows
constexpr uint32_t ST_BLOCK = ST_KW * 128;  // 64 weight columns of a chunk
constexpr uint32_t ST_MASK = 256;           // an x stage's in_mask bytes

// Shared-memory layout, byte offsets from a 1024-byte aligned base:
// [x ring: stages x (ST_TM + taps - 1 rows x 128 bytes, swizzled, then those
//  rows' in_mask bytes), each 1 KB aligned]
// [weight ring: wstages x ceil(CB / 64) blocks of 64 input rows x 64 output
//  columns (128 bytes, swizzled: MN-major)]
// [bias, alpha, gamma, beta: 4 x CB f32]
// [mbarriers: x full, x empty (stages each), w full, w empty (wstages each)]
struct StreamLayout {
  int stages, wstages, cluster;
  int taps;          // the most taps a block: x rows ST_TM + taps - 1
  int nblk;          // tap blocks: taps [b K / nblk, (b + 1) K / nblk)
  int nkc;           // ceil(C / ST_KW) input-channel chunks
  int n_cb;          // ceil(C / CB) column blocks
  int blocks;        // ceil(CB / 64) weight blocks a stage
  int steps;         // weight steps a tile: K * nkc
  int resident;      // every step's weights stay in the ring
  int l_tiles;       // ceil(L / ST_TM)
  int m_tiles;       // n_rows * l_tiles
  uint32_t xrows;    // bytes of an x stage's rows: its mask's offset
  uint32_t xstage, wstage;
  uint32_t off_w, off_par, off_bar, bytes;
};

// false if (cb, kw, taps, stages, wstages, cluster) cannot hold this shape
bool make_stream_layout(int n_rows, int L, int C, int K, int cb, int kw,
                        int taps, int stages, int wstages, int cluster,
                        StreamLayout* lay) {
  if (kw != ST_KW || cb < 16 || cb > 256 || cb % 16) return false;
  if (stages < 2 || stages > 4 || wstages < 1) return false;
  if (taps < 1 || taps > K || taps > ST_MAX_TAPS) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4) return false;
  lay->stages = stages;
  lay->wstages = wstages;
  lay->cluster = cluster;
  lay->taps = taps;
  lay->nblk = (K + taps - 1) / taps;
  lay->nkc = (C + ST_KW - 1) / ST_KW;
  lay->n_cb = (C + cb - 1) / cb;
  lay->blocks = (cb + 63) / 64;
  lay->steps = K * lay->nkc;
  lay->resident = lay->steps <= wstages;
  // multicast: TMA copies (C % 8 == 0) of streamed weights
  if (cluster > 1 && (C % 8 || lay->resident)) return false;
  lay->l_tiles = (L + ST_TM - 1) / ST_TM;
  lay->m_tiles = n_rows * lay->l_tiles;
  lay->xrows = (uint32_t)(ST_TM + taps - 1) * 128;
  lay->xstage = align1k(lay->xrows + ST_MASK);
  lay->wstage = (uint32_t)lay->blocks * ST_BLOCK;
  lay->off_w = stages * lay->xstage;
  lay->off_par = lay->off_w + wstages * lay->wstage;
  lay->off_bar = lay->off_par + 16u * cb;
  lay->bytes = lay->off_bar + 16u * (stages + wstages) + 1024u;  // + slack
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

// 8 bf16 from global to a 16-byte shared-memory unit by 2-byte loads, zeros
// where `live` is false or past the first `n` elements (rows that no tensor
// map describes: C % 8 != 0)
__device__ __forceinline__ void copy8_bf16(unsigned char* dst,
                                           const __nv_bfloat16* src,
                                           bool live, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t lo = live && 2 * h < n ? s[2 * h] : 0u;
    const uint32_t hi = live && 2 * h + 1 < n ? s[2 * h + 1] : 0u;
    v[h] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// a bf16 pair of (row, col) and (row, col + 1) as one word (col + 1 past C:
// zero); `pair`: C is even, so the pair is 4-byte aligned
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* src,
                                              bool pair, bool second) {
  if (pair) return *reinterpret_cast<const uint32_t*>(src);
  const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
  return (uint32_t)e[0] | (second ? (uint32_t)e[1] << 16 : 0u);
}

template <int CB>
__global__ void __launch_bounds__(THREADS, 1)
conv_bf16_stream(Params p, StreamLayout lay, int n_rows,
                 const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap) {
  using namespace hopper;
  constexpr int R = CB / 2;          // accumulator registers per thread
  constexpr bool PRE = CB <= 128;    // residual prefetched into registers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int C = p.C, K = p.K, L = p.L;
  const int S = lay.stages, WS = lay.wstages, CS = lay.cluster;
  const bool tma = C % 8 == 0;
  const int pad_l = (K - 1) / 2;
  const int tid = threadIdx.x;
  // CTA b is rank b % CS of cluster b / CS; the cluster owns column block
  // cluster % n_cb and walks groups of CS neighbouring tiles, rank r the
  // group's tile r. Every CTA of a cluster walks as many groups: a tile past
  // m_tiles is a ghost (zeros in, nothing out) that keeps them in step.
  const int rank = CS > 1 ? (int)cluster_ctarank() : 0;
  const int clu = blockIdx.x / CS;
  const int col0 = (clu % lay.n_cb) * CB;
  const int g_first = clu / lay.n_cb;
  const int g_step = gridDim.x / CS / lay.n_cb;
  const int groups = (lay.m_tiles + CS - 1) / CS;
  const int n_iter =
      g_first < groups ? (groups - g_first + g_step - 1) / g_step : 0;
  const uint32_t x0 = base, w0 = base + lay.off_w;
  const uint32_t bar = base + lay.off_bar;
  const uint32_t xfull = bar, xempty = bar + 8 * S;
  const uint32_t wfull = bar + 16 * S, wempty = wfull + 8 * WS;
  float* par = reinterpret_cast<float*>(sbase + lay.off_par);

  // par: bias (alpha * bias with DYT), alpha, gamma, beta of this column
  // block, zero past C
  for (int c = tid; c < CB; c += THREADS) {
    const int col = col0 + c;
    const bool in = col < C;
    const float b = p.bias && in ? p.bias[col] : 0.f;
    par[c] = b;
    if (p.dyt) {
      par[c] = in ? p.dyt[col] * b : 0.f;
      par[CB + c] = in ? p.dyt[col] : 0.f;
      par[2 * CB + c] = in ? p.dyt[C + col] : 0.f;
      par[3 * CB + c] = in ? p.dyt[2 * C + col] : 0.f;
    }
  }
  const bool masked = p.in_mask != nullptr;
  if (tid == 0) {
    // full: the TMA thread's arrival (its bytes) and, with in_mask, the 32
    // threads that copy its bytes; or every copying thread
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + 8 * s, tma ? 1 + (masked ? 32 : 0) : 128);
      mbar_init(xempty + 8 * s, CONSUMERS * 4);  // every consumer warp
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(wfull + 8 * s, tma ? 1 : 128);
      // every consumer warp of every CTA the stage's copies go to
      mbar_init(wempty + 8 * s, CONSUMERS * 4 * CS);
    }
    fence_barrier_init();
  }
  // every CTA's barriers are set before any multicast or remote arrival
  if (CS > 1)
    cluster_sync();
  else
    __syncthreads();

  auto tile_of = [&](int i, int& n, int& l0) {
    const int m = (g_first + i * g_step) * CS + rank;
    const bool ghost = m >= lay.m_tiles;
    n = ghost ? n_rows : m / lay.l_tiles;
    l0 = ghost ? 0 : (m % lay.l_tiles) * ST_TM;
    return !ghost;
  };

  if (tid >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread issues each stage's TMA copies
    // (C % 8 == 0; its warp copies the x stage's in_mask bytes), or all
    // 128 copy it by 2-byte loads ----
    setmaxnreg_dec<56>();
    const int pt = tid - CONSUMERS * 128;
    // the threads that walk the steps: all 128 copying, or TMA's one
    // (thread 0) and, with in_mask, the 32 of the next warp that copy the
    // mask bytes (they never hold up the weights' copies)
    const bool issuer = tma && pt == 0;
    const bool masker = tma && masked && pt >= 32 && pt < 64;
    if (!tma || issuer || masker) {
      const int mt = tma ? pt - 32 : pt;  // this thread's first mask row
      const int copiers = tma ? 32 : 128;
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
      const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
      const int rows = ST_TM + lay.taps - 1;
      const uint16_t mc = (uint16_t)((1u << CS) - 1);
      const int wrows = ST_KW / CS;  // input rows of a block each rank copies
      int sx = 0, px = 0, sw = 0, pw = 0;
      for (int i = 0; i < n_iter; ++i) {
        int n, l0;
        const bool live_tile = tile_of(i, n, l0);
        int st = 0;  // the tile's weight step
        for (int tb = 0; tb < lay.nblk; ++tb) {
          const int j0 = tb * K / lay.nblk, kb = (tb + 1) * K / lay.nblk - j0;
          for (int kc = 0; kc < lay.nkc; ++kc) {
            const int c0 = kc * ST_KW;
            // x: input row r of the stage is position l0 - pad_l + j0 + r;
            // rows outside [0, L) and channels past C arrive as zeros
            mbar_wait(xempty + 8 * sx, px ^ 1);
            const uint32_t xs = x0 + sx * lay.xstage;
            unsigned char* xd = sbase + (xs - base);
            if (issuer) {
              mbar_arrive_expect_tx(xfull + 8 * sx, lay.xrows);
              tma_load_3d(xs, &xmap, xfull + 8 * sx, c0, l0 - pad_l + j0, n);
            }
            if (!tma) {
              for (int u = pt; u < rows * 8; u += 128) {
                const int r = u / 8, cu = u % 8;
                const int pos = l0 - pad_l + j0 + r, c = c0 + 8 * cu;
                const long long row = (long long)n * L + pos;
                copy8_bf16(xd + swizzle(r * 128 + cu * 16, 128),
                           x + row * C + c,
                           live_tile && pos >= 0 && pos < L && c < C, C - c);
              }
              fence_proxy_async();  // the generic writes before wgmma
            }
            if (masked && !issuer) {
              // the rows' in_mask bytes (read by the consumers' generic
              // loads: no proxy fence), all loaded before any is stored, so
              // that their latencies overlap
              constexpr int MR = (int)ST_MASK / 32;  // rows a thread at most
              unsigned char v[MR];
#pragma unroll
              for (int k = 0; k < MR; ++k) {
                const int r = mt + k * copiers;
                const int pos = l0 - pad_l + j0 + r;
                v[k] = r < rows && live_tile && pos >= 0 && pos < L
                           ? __ldg(p.in_mask + (long long)n * L + pos)
                           : 0;
              }
#pragma unroll
              for (int k = 0; k < MR; ++k) {
                const int r = mt + k * copiers;
                if (r < rows) xd[lay.xrows + r] = v[k];
              }
            }
            if (!issuer) mbar_arrive(xfull + 8 * sx);
            if (++sx == S) {
              sx = 0;
              px ^= 1;
            }
            // the block's taps of this chunk, a weight step each: rows
            // c0 .. c0 + 63 of w[j0 + j], the column block's CB columns
            // as they are stored (MN-major), zero past C
            for (int j = 0; j < kb; ++j, ++st) {
              // resident: already in the ring; TMA: the issuer's work
              if ((lay.resident && i > 0) || masker) continue;
              const int s = lay.resident ? st : sw;
              if (!lay.resident) mbar_wait(wempty + 8 * sw, pw ^ 1);
              const uint32_t ws = w0 + s * lay.wstage;
              if (tma) {
                mbar_arrive_expect_tx(wfull + 8 * s, lay.wstage);
                for (int b = 0; b < lay.blocks; ++b) {
                  if (CS > 1)
                    tma_load_3d_multicast(
                        ws + b * ST_BLOCK + rank * wrows * 128, &wmap,
                        wfull + 8 * s, col0 + 64 * b, c0 + rank * wrows,
                        j0 + j, mc);
                  else
                    tma_load_3d(ws + b * ST_BLOCK, &wmap, wfull + 8 * s,
                                col0 + 64 * b, c0, j0 + j);
                }
              } else {
                unsigned char* wd = sbase + (ws - base);
                for (int u = pt; u < lay.blocks * ST_KW * 8; u += 128) {
                  const int b = u / (ST_KW * 8), ri = (u / 8) % ST_KW;
                  const int uu = u % 8;
                  const int ci = c0 + ri, co = col0 + 64 * b + 8 * uu;
                  copy8_bf16(
                      wd + b * ST_BLOCK + swizzle(ri * 128 + uu * 16, 128),
                      w + ((long long)(j0 + j) * C + ci) * C + co,
                      ci < C && co < C, C - co);
                }
                fence_proxy_async();
                mbar_arrive(wfull + 8 * s);
              }
              if (!lay.resident && ++sw == WS) {
                sw = 0;
                pw ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<224>();
    // ---- consumer warpgroups: rows 64 wg .. of every tile ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = TL * wg + 16 * warp + lane / 4;  // fragment rows r0, r0 + 8
    const int lrow = TL * wg + 16 * warp + (lane & 15);  // ldmatrix row
    const int lcol = (lane >> 4) * 8;  // ldmatrix column of this lane
    const int c_lane = 2 * (lane % 4);  // accumulator column in 8
    const bool pair = C % 2 == 0;
    const int last_ks = (C - (lay.nkc - 1) * ST_KW + 15) / 16;
    const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.residual);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    // B of stage s, k16 step t: rows 16 t of its blocks (16 * 128 bytes);
    // the blocks ST_BLOCK apart
    const uint64_t wdesc = smem_desc_mn(w0, 128, ST_BLOCK);
    float acc[R];
    uint32_t rv[CB / 4];
    int sx = 0, px = 0, sw = 0, pw = 0;
    // a stage goes back once the group that read it last has retired: its
    // x stage's empty barrier in this CTA, its weight stage's in every CTA
    // the stage's copies went to
    auto release = [&](int s_w, int s_x) {
      __syncwarp();
      if (lane == 0) {
        if (s_x >= 0) mbar_arrive(xempty + 8 * s_x);
        if (s_w >= 0) {
          if (CS > 1) {
            for (int r = 0; r < CS; ++r)
              mbar_arrive_cluster(cluster_map(wempty + 8 * s_w, r));
          } else {
            mbar_arrive(wempty + 8 * s_w);
          }
        }
      }
    };
    for (int i = 0; i < n_iter; ++i) {
      int n, l0;
      const bool live_tile = tile_of(i, n, l0);
      const int l = l0 + r0;
      const bool v0 = live_tile && l < L, v1 = live_tile && l + 8 < L;
      const long long row0 = (long long)n * L + l;
      // the epilogue's inputs, asked for now so that they arrive during
      // the products: the residual pairs ([2q]: row r0, [2q + 1]: row
      // r0 + 8) in registers (CB <= 128), else their lines into L2; the
      // out_mask bytes
      if (res) {
        if constexpr (PRE) {
#pragma unroll
          for (int q = 0; q < CB / 8; ++q) {
            const int col = col0 + 8 * q + c_lane;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              rv[2 * q + h] = (h ? v1 : v0) && col < C
                                  ? load_pair(res + (row0 + 8 * h) * C + col,
                                              pair, col + 1 < C)
                                  : 0u;
          }
        } else {
          const int col = col0 + 64 * (lane % 4);
          if (col < C && col < col0 + CB) {
            if (v0) prefetch_l2(res + row0 * C + col);
            if (v1) prefetch_l2(res + (row0 + 8) * C + col);
          }
        }
      }
      const bool z0 = p.out_mask && v0 && !p.out_mask[row0];
      const bool z1 = p.out_mask && v1 && !p.out_mask[row0 + 8];

      // The tile's weight steps, chunks of a tap block outer, its taps
      // inner. A step: A (the x rows shifted by the tap j, ldmatrix at
      // swizzled addresses; in_mask rows zeroed in the registers), B the
      // step's weights; the chunk's k16 steps (the last chunk's only those
      // it holds) in one wgmma group. One group stays in flight across the
      // steps: a step waits for the group before it, then hands its
      // stages back.
      int tb = 0, kc = 0, j = 0;
      int j0 = 0, kb = K / lay.nblk;
      // KS k16 products on the A set a and the weights at descriptor d,
      // straight-line (a wgmma under a branch of its own makes ptxas add
      // register fences before every wgmma of the kernel)
      auto issue = [&](auto ks_c, uint32_t(&a)[4][4], uint64_t d, int st) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < decltype(ks_c)::value; ++t)
          wgmma_bf16_rs_mn_n<CB>(acc, a[t], d + 128 * t, ST_BLOCK >> 4,
                                 !(st == 0 && t == 0));
        wgmma_commit();
      };
      // One weight step: A (the x rows shifted by the tap, ldmatrix at
      // swizzled addresses, in_mask rows zeroed), its group of products,
      // then the group before it retires and that group's stages go back.
      int prev_w = -1, prev_x = -1;
      auto step = [&](uint32_t(&a)[4][4], int st) {
        const int ks = kc + 1 < lay.nkc ? 4 : last_ks;
        if (j == 0) {
          mbar_wait(xfull + 8 * sx, px);
          if (!tma) fence_proxy_async();
        }
        const int s = lay.resident ? st : sw;
        mbar_wait(wfull + 8 * s, lay.resident ? 0 : pw);
        if (!tma) fence_proxy_async();
        const uint32_t xs = x0 + sx * lay.xstage;
        const uint32_t row = lrow + j;
        const uint32_t rbase = xs + row * 128;
        const uint32_t sw7 = (row & 7) << 4;
        // all four k16 slices (past C the stage holds zeros)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          ldmatrix_x4(a[t], rbase + (((t * 16 + lcol) * 2) ^ sw7));
        if (masked) {
          const unsigned char* mk = sbase + (xs - base) + lay.xrows;
          const uint32_t k0 = mk[r0 + j] ? ~0u : 0u;
          const uint32_t k1 = mk[r0 + 8 + j] ? ~0u : 0u;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            a[t][0] &= k0;
            a[t][2] &= k0;
            a[t][1] &= k1;
            a[t][3] &= k1;
          }
        }
        const uint64_t d = wdesc + ((s * lay.wstage) >> 4);
        switch (ks) {
          case 1: issue(std::integral_constant<int, 1>(), a, d, st); break;
          case 2: issue(std::integral_constant<int, 2>(), a, d, st); break;
          case 3: issue(std::integral_constant<int, 3>(), a, d, st); break;
          default: issue(std::integral_constant<int, 4>(), a, d, st); break;
        }
        if (st > 0) {
          wgmma_wait<1>();  // the step before: its stages may go
          release(prev_w, prev_x);
        }
        prev_w = lay.resident ? -1 : sw;
        prev_x = j + 1 == kb ? sx : -1;
        if (!lay.resident && ++sw == WS) {
          sw = 0;
          pw ^= 1;
        }
        if (++j == kb) {
          j = 0;
          if (++sx == S) {
            sx = 0;
            px ^= 1;
          }
          if (++kc == lay.nkc) {
            kc = 0;
            ++tb;
            j0 = tb * K / lay.nblk;
            kb = (tb + 1) * K / lay.nblk - j0;
          }
        }
      };
      // two A register sets: a step's fragments load while the step
      // before runs
      uint32_t aA[4][4], aB[4][4];
      for (int st = 0;; st += 2) {
        step(aA, st);
        if (st + 1 >= lay.steps) break;
        step(aB, st + 1);
        if (st + 2 >= lay.steps) break;
      }
      wgmma_wait<0>();  // the tile's last group
      fence_regs(acc);
      release(prev_w, prev_x);

      // ---- the tile's epilogue from the registers, stored from them:
      // columns col0 + 8 q + c_lane (+1) of rows r0 and r0 + 8, those past
      // L or C not at all ----
      if constexpr (!PRE) {
        if (res) {
#pragma unroll
          for (int q = 0; q < CB / 8; ++q) {
            const int col = col0 + 8 * q + c_lane;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              rv[2 * q + h] = (h ? v1 : v0) && col < C
                                  ? load_pair(res + (row0 + 8 * h) * C + col,
                                              pair, col + 1 < C)
                                  : 0u;
          }
        }
      }
      epilogue_regs<CB>(acc, par, p, z0, z1, res != nullptr, rv, c_lane);
#pragma unroll
      for (int q = 0; q < CB / 8; ++q) {
        const int col = col0 + 8 * q + c_lane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? v1 : v0) || col >= C) continue;
          __nv_bfloat16* o = out + (row0 + 8 * h) * C + col;
          const float a0 = acc[4 * q + 2 * h], a1 = acc[4 * q + 2 * h + 1];
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(a0, a1);
          } else {
            o[0] = __float2bfloat16_rn(a0);
            if (col + 1 < C) o[1] = __float2bfloat16_rn(a1);
          }
        }
      }
    }
  }
  // no CTA leaves while another may still copy into it or arrive on its
  // barriers
  if (CS > 1) cluster_sync();
}

// ---------------------------------------------------------------------------
// f32: conv_f32_ring, the persistent FMA kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int R_RT = 8;         // output rows per thread
constexpr int R_WM = 4 * R_RT;  // output rows per warp unit: 4 row groups
constexpr int R_CK = 16;        // channels per ring stage: 64-byte rows
constexpr int R_KMAX = 9;       // taps a ring stage and the window hold

// warps a CTA: more would cap the registers below what 8 rows x CB / 8
// columns of accumulators, the tap window and the weights in flight need
// (12 or 16 warps spilled and ran slower on the H100)
constexpr int R_WARPS = 8;
constexpr int R_THREADS = 32 * R_WARPS;

// A unit's k taps are cut into nblk tap blocks, block b the taps [b K /
// nblk, (b + 1) K / nblk): at most R_KMAX each where the weights are
// resident, at most `taps` where they are streamed. RAG (route
// f32_ring_pad): the channels are counted up to Cp, C rounded up to R_CK,
// and the weights may be streamed in groups of gk chunks (gk R_CK
// channels).
// Shared-memory layout, byte offsets from a 16-byte aligned base:
// [weights: K * Cp rows of CB f32 (resident), or two buffers of taps * Cp
// (or taps * gk R_CK) rows of CB f32 (streamed)] [bias, alpha, gamma, beta:
// 4 x CB f32]
// [x rings: R_WARPS warps x stages x (R_WM + the largest block - 1) rows x
// R_CK f32]
struct RingLayout {
  int stages;
  int taps;     // weight taps a buffer holds: K when resident
  int stream;   // 1: the weights are streamed a tap block at a time
  int nblk;     // tap blocks a unit
  int rows;     // R_WM + the largest block - 1: a warp's stage
  int n_cb;     // Cp / CB column blocks
  int nkc;      // Cp / R_CK channel chunks a tap block
  int gk;       // channel chunks a weight buffer holds: nkc but in groups
  int ngrp;     // weight groups a tap block: ceil(nkc / gk)
  int l_units;  // ceil(L / R_WM)
  long long units;  // n_rows * l_units warp units
  uint32_t stage, wbuf, off_par, off_x, bytes;
};

// false if (cb, taps, stages, kw) cannot hold this shape; taps < K streams
// the weights in blocks of at most `taps` (the largest block: two buffers,
// two ring stages, so a block's weights land with the stage before its
// first), kw > 0 in groups of kw channels (rag only); rag: C need not be a
// multiple of R_CK or cb
bool make_ring_layout(int n_rows, int L, int C, int K, int cb, int taps,
                      int stages, int kw, bool rag, RingLayout* lay) {
  if (K < 1 || taps < 1 || taps > K) return false;
  const int cp = (C + R_CK - 1) / R_CK * R_CK;
  if ((cb != 16 && cb != 32 && cb != 64) || cp % cb) return false;
  if (rag ? kw < 0 || kw % R_CK || kw >= cp : C % R_CK || kw) return false;
  if (stages < 2 || stages > 4) return false;
  const bool stream = taps < K || kw > 0;
  lay->nblk = (K + (stream ? taps : R_KMAX) - 1) / (stream ? taps : R_KMAX);
  const int block = (K + lay->nblk - 1) / lay->nblk;
  if (stream && (taps > R_KMAX || block != taps || stages != 2)) return false;
  lay->stages = stages;
  lay->taps = taps;
  lay->stream = stream;
  lay->rows = R_WM + block - 1;
  lay->n_cb = cp / cb;
  lay->nkc = cp / R_CK;
  lay->gk = kw ? kw / R_CK : lay->nkc;
  lay->ngrp = (lay->nkc + lay->gk - 1) / lay->gk;
  lay->l_units = (L + R_WM - 1) / R_WM;
  lay->units = (long long)n_rows * lay->l_units;
  lay->stage = (uint32_t)lay->rows * R_CK * 4;
  lay->wbuf = (uint32_t)taps * (kw ? kw : cp) * cb * 4;
  lay->off_par = (stream ? 2u : 1u) * lay->wbuf;
  lay->off_x = lay->off_par + 16u * cb;
  lay->bytes = lay->off_x + R_WARPS * stages * lay->stage;
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

// The byte offset of (row, 16-byte unit u) in a warp's stage: the unit is
// XORed with bits 3-4 of the row, so the four row groups of a warp (rows 8
// apart, 64-byte rows) read four different bank quarters.
__device__ __forceinline__ uint32_t ring_off(int row, int u) {
  return (uint32_t)row * (R_CK * 4) + ((u ^ ((row >> 3) & 3)) << 4);
}

// The products of one ring stage (R_CK channels) for K taps. The thread's
// window is rows 8 tr .. 8 tr + R_RT + K - 2 of its warp's stage, 4
// channels at a time in registers: tap j of output row r reads window row
// r + j, so each window value feeds every tap without a second shared
// load, and each weight float4 feeds R_RT rows. wc: the weights of the
// stage's first channel at this thread's first column; tap j is tap_stride
// floats further, channel c cb further.
template <int K, int CT>
__device__ __forceinline__ void ring_products(float (&acc)[R_RT][CT],
                                              const unsigned char* xs,
                                              const float* __restrict__ wc,
                                              int tap_stride, int cb, int tr) {
  constexpr int VW = CT >= 4 ? 4 : 2, NG = CT / VW, W = R_RT + K - 1;
  const unsigned char* xr = xs + tr * R_RT * (R_CK * 4);
#pragma unroll 1
  for (int c4 = 0; c4 < R_CK / 4; ++c4) {
    // ring_off of window row i: (8 tr + i) >> 3 & 3 is (tr + i / 8) & 3
    const int o0 = (c4 ^ tr) << 4, o1 = (c4 ^ ((tr + 1) & 3)) << 4;
    float4 a[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      a[i] = *reinterpret_cast<const float4*>(xr + i * (R_CK * 4) +
                                              (i < 8 ? o0 : o1));
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* wr = wc + (4 * c4 + cc) * cb;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float b[CT];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = wr + j * tap_stride + g * 8 * VW;
          if constexpr (VW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            b[4 * g] = v.x;
            b[4 * g + 1] = v.y;
            b[4 * g + 2] = v.z;
            b[4 * g + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(src);
            b[2 * g] = v.x;
            b[2 * g + 1] = v.y;
          }
        }
#pragma unroll
        for (int r = 0; r < R_RT; ++r) {
          const float4& v = a[r + j];
          const float av = cc == 0 ? v.x : cc == 1 ? v.y : cc == 2 ? v.z : v.w;
#pragma unroll
          for (int e = 0; e < CT; ++e) acc[r][e] = fmaf(av, b[e], acc[r][e]);
        }
      }
    }
  }
}

// TAPS false: one resident tap block (k <= 9), the tap-block bookkeeping
// compiled out. RAG (route f32_ring_pad): C % 16 != 0 or weights streamed
// in channel groups; every copy, load and store past C is guarded (zero
// filled or skipped) and C is read at any alignment.
template <int CB, bool TAPS, bool RAG>
__global__ void __launch_bounds__(R_THREADS, 1)
conv_f32_ring(Params p, RingLayout lay) {
  constexpr int CT = CB / 8;  // columns a thread: 8, 4 or 2
  constexpr int VW = CT >= 4 ? 4 : 2, NG = CT / VW;
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* ws = reinterpret_cast<float*>(smem_f);
  float* par = reinterpret_cast<float*>(smem_f + lay.off_par);

  const int C = p.C, K = p.K, L = p.L, S = lay.stages, nkc = lay.nkc;
  const int nblk = TAPS ? lay.nblk : 1;
  const bool stream = TAPS && lay.stream;
  const int pad_l = (K - 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = (blockIdx.x % lay.n_cb) * CB;
  // warp units (n, 32 rows) of this column block: worker w of W walks
  // units w, w + W, ...; with streamed weights the CTA's warps walk in
  // step, as many rounds as its first worker has units
  const long long first = (long long)(blockIdx.x / lay.n_cb) * R_WARPS;
  const long long worker = first + warp;
  const long long workers = (long long)(gridDim.x / lay.n_cb) * R_WARPS;
  const long long lead = stream ? first : worker;
  const int n_local =
      lead < lay.units ? (int)((lay.units - lead + workers - 1) / workers)
                       : 0;
  // (unit, tap block, channel chunk) stages to walk
  const int total = n_local * nblk * nkc;
  const float* x = static_cast<const float*>(p.x);
  const float* __restrict__ res = static_cast<const float*>(p.residual);
  float* __restrict__ out = static_cast<float*>(p.out);
  // this warp's ring: rows l0 - pad_l .. of each of its units
  const unsigned char* xring =
      smem_f + lay.off_x + (size_t)warp * S * lay.stage;
  const uint32_t x_s = hopper::smem_u32(xring);

  // resident weights w[j][ci][col0 .. col0 + CB), row j * C + ci, and the
  // epilogue's parameters of this column block
  const float* w = static_cast<const float*>(p.w);
  constexpr int V = CB / 4;
  // RAG: the weights' rows (per tap) and the channels of a streamed buffer
  const int cp = nkc * R_CK;
  const int wrows = RAG && stream ? lay.gk * R_CK : cp;
  if constexpr (RAG) {
    // resident weights as rows j * Cp + ci, zero past C either way
    for (int i = tid; i < (stream ? 0 : K * cp * CB); i += R_THREADS) {
      const int col = col0 + i % CB, jc = i / CB, ci = jc % cp;
      ws[i] = ci < C && col < C
                  ? w[((long long)(jc / cp) * C + ci) * C + col]
                  : 0.f;
    }
    for (int c = tid; c < CB; c += R_THREADS) {
      const bool in = col0 + c < C;
      par[c] = p.bias && in ? p.bias[col0 + c] : 0.f;
      if (p.dyt) {
        par[CB + c] = in ? p.dyt[col0 + c] : 0.f;
        par[2 * CB + c] = in ? p.dyt[C + col0 + c] : 0.f;
        par[3 * CB + c] = in ? p.dyt[2 * C + col0 + c] : 0.f;
      }
    }
  } else {
    for (int i = tid; i < (stream ? 0 : K * C * V); i += R_THREADS) {
      const int v = i % V, jc = i / V;
      reinterpret_cast<float4*>(ws)[i] = *reinterpret_cast<const float4*>(
          w + (long long)jc * C + col0 + 4 * v);
    }
    for (int c = tid; c < CB; c += R_THREADS) {
      par[c] = p.bias ? p.bias[col0 + c] : 0.f;
      if (p.dyt) {
        par[CB + c] = p.dyt[col0 + c];
        par[2 * CB + c] = p.dyt[C + col0 + c];
        par[3 * CB + c] = p.dyt[2 * C + col0 + c];
      }
    }
  }
  // resident weights: the only CTA-wide barrier, after it the warps run
  // apart; streamed weights: one more at the start of each tap block
  __syncthreads();

  // ---- this warp's ring: lane copies 16-byte units of stage rows lane /
  // 4 + 8 mm (unit lane % 4) with cp.async: the rows of tap block tb of the
  // unit start at its first tap's input row; rows before 0, past L - 1 or
  // masked by in_mask are zero filled. One cp.async group a stage, empty
  // past the last one. Streamed weights: the first stage of block tb of
  // round i also carries the block's weights into buffer (i nblk + tb) % 2,
  // copied by the whole CTA. ----
  const int cu = lane & 3, row_a = lane >> 2;
  const uint32_t w_s = hopper::smem_u32(smem_f);
  uint32_t pvalid = 0;  // bit mm: row row_a + 8 mm of the producer's tile
  long long pbase = 0;  // global row of the warp's stage row 0
  // (unit round, tap block, chunk) of the next stage to issue: issue is
  // called for q = 0, 1, 2, ... in turn
  int qi = 0, qtb = 0, qkc = 0;
  auto issue = [&](int q) {
    if (q < total) {
      const int i = qi, tb = qtb, kc = qkc;
      if (++qkc == nkc) {
        qkc = 0;
        if (++qtb == nblk) {
          qtb = 0;
          ++qi;
        }
      }
      if (kc == 0) {
        const long long u = worker + i * workers;
        const int j0 = TAPS ? tb * K / nblk : 0;
        pvalid = 0;
        if (u < lay.units) {
          const long long n = u / lay.l_units;
          const int p0 = (int)(u - n * lay.l_units) * R_WM - pad_l + j0;
          pbase = (long long)n * L + p0;
          for (int mm = 0; row_a + 8 * mm < lay.rows; ++mm) {
            const int pos = p0 + row_a + 8 * mm;
            if (pos >= 0 && pos < L &&
                (!p.in_mask || p.in_mask[(long long)n * L + pos]))
              pvalid |= 1u << mm;
          }
        }
        if (!RAG && stream) {
          const int kb = (tb + 1) * K / nblk - j0;
          const uint32_t dst =
              w_s + (uint32_t)((i * nblk + tb) & 1) * lay.wbuf;
          for (int v = tid; v < kb * C * V; v += R_THREADS)
            hopper::cp_async16_zfill(
                dst + (uint32_t)v * 16u,
                w + ((long long)j0 * C + v / V) * C + col0 + 4 * (v % V),
                true);
        }
      }
      if (RAG && stream && kc % lay.gk == 0) {
        // group g of block tb: taps j0 .., channels g wrows .., into buffer
        // ((i nblk + tb) ngrp + g) % 2; 4-byte copies where C % 4 != 0
        const int g = kc / lay.gk;
        const int j0 = tb * K / nblk, kb = (tb + 1) * K / nblk - j0;
        const uint32_t dst =
            w_s + (uint32_t)(((i * nblk + tb) * lay.ngrp + g) & 1) * lay.wbuf;
        for (int v = tid; v < kb * wrows * V; v += R_THREADS) {
          const int ci = g * wrows + (v / V) % wrows, col = col0 + 4 * (v % V);
          const float* src =
              w + ((long long)(j0 + v / (V * wrows)) * C + ci) * C + col;
          if (C % 4 == 0) {
            const bool ok = ci < C && col < C;
            hopper::cp_async16_zfill(dst + (uint32_t)v * 16u, ok ? src : w,
                                     ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = ci < C && col + e < C;
              hopper::cp_async4_zfill(dst + (uint32_t)v * 16u + 4 * e,
                                      ok ? src + e : w, ok);
            }
          }
        }
      }
      const uint32_t st = x_s + (uint32_t)(q % S) * lay.stage;
      for (int mm = 0; row_a + 8 * mm < lay.rows; ++mm) {
        const int row = row_a + 8 * mm;
        const bool ok = (pvalid >> mm) & 1u;
        if constexpr (RAG) {
          // channels past C zero filled; 4-byte copies where C % 4 != 0
          const int c = kc * R_CK + 4 * cu;
          const float* src = x + (pbase + row) * C + c;
          if (C % 4 == 0) {
            hopper::cp_async16_zfill(st + ring_off(row, cu),
                                     ok && c < C ? src : x, ok && c < C);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hopper::cp_async4_zfill(st + ring_off(row, cu) + 4 * e,
                                      ok && c + e < C ? src + e : x,
                                      ok && c + e < C);
          }
        } else {
          const float* src =
              ok ? x + (pbase + row) * C + kc * R_CK + 4 * cu : x;
          hopper::cp_async16_zfill(st + ring_off(row, cu), src, ok);
        }
      }
    }
    hopper::cp_async_commit();
  };

  // ---- the products: lane (tr, tc) = (lane / 8, lane % 8) owns rows 8
  // tr .. + 7 of the unit and columns 8 VW g + VW tc .. + VW - 1 of the
  // block (g < NG) ----
  const int tr = lane / 8, tc = lane % 8;
  const int rb = tr * R_RT;
  float acc[R_RT][CT];
#pragma unroll
  for (int r = 0; r < R_RT; ++r)
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[r][e] = 0.f;

  // (unit round, tap block, chunk) of stage q, the block's taps and
  // weights
  int ni = 0, ntb = 0, nkc_ = 0;
  int j0 = 0, kb = K;
  const float* wb = ws;
  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    // stage q has landed (this lane's copies, then the warp's), and stage
    // q - 1 is free: every lane of the warp has finished its products.
    // Streamed weights, first stage of a block: the block's weights have
    // landed (every thread's copies) and every warp is past the block
    // before, whose buffer the next block's copies (issued below) take.
    const int i = ni, tb = ntb, kc = nkc_;
    if (++nkc_ == nkc) {
      nkc_ = 0;
      if (++ntb == nblk) {
        ntb = 0;
        ++ni;
      }
    }
    // RAG: a streamed buffer holds one group of gk chunks
    const bool wstart = RAG && stream ? kc % lay.gk == 0 : kc == 0;
    if (TAPS && wstart) {
      // the block's taps: from the resident weights, or its buffer
      j0 = tb * K / nblk;
      kb = (tb + 1) * K / nblk - j0;
      if constexpr (RAG)
        wb = stream ? ws + (size_t)(((i * nblk + tb) * lay.ngrp +
                                     kc / lay.gk) & 1) * (lay.wbuf / 4)
                    : ws + (size_t)j0 * cp * CB;
      else
        wb = stream ? ws + (size_t)((i * nblk + tb) & 1) * (lay.wbuf / 4)
                    : ws + (size_t)j0 * C * CB;
    }
    if (S == 2)
      hopper::cp_async_wait<0>();
    else if (S == 3)
      hopper::cp_async_wait<1>();
    else
      hopper::cp_async_wait<2>();
    if (stream && wstart)
      __syncthreads();
    else
      __syncwarp();
    issue(q + S - 1);
    const long long u = worker + i * workers;
    if (stream && u >= lay.units) continue;  // a round past this warp's units
    const bool last = tb == nblk - 1 && kc == nkc - 1;
    const long long n = last ? u / lay.l_units : 0;
    const int l0 = (int)(u - n * lay.l_units) * R_WM;
    if (res && last && tc == 0) {
      // the epilogue's residual rows into L2 while the last products run
#pragma unroll
      for (int r = 0; r < R_RT; ++r)
        if (l0 + rb + r < L)
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (!RAG || col0 + g * 8 * VW < C)
              hopper::prefetch_l2(res + (n * L + l0 + rb + r) * C + col0 +
                                  g * 8 * VW);
    }
    const unsigned char* xs = xring + (size_t)(q % S) * lay.stage;
    // the weights of the stage's chunk; tap j is CW * CB floats further
    const int CW = RAG ? wrows : C;
    const float* wc =
        wb + (RAG ? kc % (wrows / R_CK) : kc) * R_CK * CB + tc * VW;
    switch (kb) {
      case 1: ring_products<1, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 2: ring_products<2, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 3: ring_products<3, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 4: ring_products<4, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 5: ring_products<5, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 6: ring_products<6, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 7: ring_products<7, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      case 8: ring_products<8, CT>(acc, xs, wc, CW * CB, CB, tr); break;
      default: ring_products<9, CT>(acc, xs, wc, CW * CB, CB, tr); break;
    }
    if (!last) continue;

    // ---- epilogue of unit i from the registers (the warp's next stages
    // are in flight, the other warps run their products): the residual
    // and out_mask of all 8 rows are loaded first (rows past L read row
    // l0, and are not stored), then each step (bias, DYT, out_mask,
    // residual, activation) runs over all the values behind one uniform
    // branch ----
    float rv[R_RT][CT];
    bool keep[R_RT];
    const float* rbase = res ? res : static_cast<const float*>(p.x);
#pragma unroll
    for (int r = 0; r < R_RT; ++r) {
      const int l = l0 + rb + r;
      const long long row = n * L + (l < L ? l : l0);
      keep[r] = !p.out_mask || p.out_mask[row];
      if (RAG && res) {
        // column by column, none past C
#pragma unroll
        for (int e = 0; e < CT; ++e) {
          const int col = col0 + (e / VW) * 8 * VW + tc * VW + e % VW;
          rv[r][e] = col < C ? rbase[row * C + col] : 0.f;
        }
      } else if (res) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = rbase + row * C + col0 + g * 8 * VW + tc * VW;
          if constexpr (VW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            rv[r][4 * g] = v.x;
            rv[r][4 * g + 1] = v.y;
            rv[r][4 * g + 2] = v.z;
            rv[r][4 * g + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(src);
            rv[r][2 * g] = v.x;
            rv[r][2 * g + 1] = v.y;
          }
        }
      }
    }
    // column e of the thread is cix(e) of the block
    auto cix = [&](int e) { return (e / VW) * 8 * VW + tc * VW + e % VW; };
    if (p.bias) {
#pragma unroll
      for (int e = 0; e < CT; ++e) {
        const float b = par[cix(e)];
#pragma unroll
        for (int r = 0; r < R_RT; ++r) acc[r][e] += b;
      }
    }
    if (p.dyt) {
#pragma unroll
      for (int e = 0; e < CT; ++e) {
        const float al = par[CB + cix(e)], ga = par[2 * CB + cix(e)],
                    be = par[3 * CB + cix(e)];
#pragma unroll
        for (int r = 0; r < R_RT; ++r)
          acc[r][e] = tanhf(acc[r][e] * al) * ga + be;
      }
    }
    if (p.out_mask) {
#pragma unroll
      for (int r = 0; r < R_RT; ++r)
#pragma unroll
        for (int e = 0; e < CT; ++e)
          if (!keep[r]) acc[r][e] = 0.f;
    }
    if (res) {
#pragma unroll
      for (int r = 0; r < R_RT; ++r)
#pragma unroll
        for (int e = 0; e < CT; ++e) acc[r][e] += rv[r][e];
    }
    switch (p.act) {
      case ACT_RELU:
#pragma unroll
        for (int r = 0; r < R_RT; ++r)
#pragma unroll
          for (int e = 0; e < CT; ++e) acc[r][e] = fmaxf(acc[r][e], 0.f);
        break;
      case ACT_TANH:
#pragma unroll
        for (int r = 0; r < R_RT; ++r)
#pragma unroll
          for (int e = 0; e < CT; ++e) acc[r][e] = tanhf(acc[r][e]);
        break;
      case ACT_GELU:
#pragma unroll
        for (int r = 0; r < R_RT; ++r)
#pragma unroll
          for (int e = 0; e < CT; ++e)
            acc[r][e] = act_fn(acc[r][e], ACT_GELU);
        break;
      case ACT_GELU_TANH:
#pragma unroll
        for (int r = 0; r < R_RT; ++r)
#pragma unroll
          for (int e = 0; e < CT; ++e)
            acc[r][e] = act_fn(acc[r][e], ACT_GELU_TANH);
        break;
      default:
        break;
    }
#pragma unroll
    for (int r = 0; r < R_RT; ++r) {
      const int l = l0 + rb + r;
      if (RAG && l < L) {
        // column by column, none past C
#pragma unroll
        for (int e = 0; e < CT; ++e) {
          const int col = col0 + (e / VW) * 8 * VW + tc * VW + e % VW;
          if (col < C) out[(n * L + l) * C + col] = acc[r][e];
        }
      } else if (l < L) {
        float* dst = out + (n * L + l) * C + col0 + tc * VW;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if constexpr (VW == 4)
            *reinterpret_cast<float4*>(dst + g * 8 * VW) =
                make_float4(acc[r][4 * g], acc[r][4 * g + 1],
                            acc[r][4 * g + 2], acc[r][4 * g + 3]);
          else
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[r][0], acc[r][1]);
        }
      }
#pragma unroll
      for (int e = 0; e < CT; ++e) acc[r][e] = 0.f;
    }
  }
  hopper::cp_async_wait<0>();
}

template <int CB, bool TAPS, bool RAG>
cudaError_t launch_ring(const Params& p, const RingLayout& lay, int sms,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_f32_ring<CB, TAPS, RAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (e != cudaSuccess) return e;
  // persistent: as many CTAs per column block as fit one per SM, no more
  // than its warps have units
  long long per_cb = sms / lay.n_cb;
  const long long need = (lay.units + R_WARPS - 1) / R_WARPS;
  if (per_cb > need) per_cb = need;
  if (per_cb < 1) per_cb = 1;
  conv_f32_ring<CB, TAPS, RAG><<<(unsigned)(per_cb * lay.n_cb), R_THREADS,
                                 lay.bytes, stream>>>(p, lay);
  return cudaGetLastError();
}

template <int CB, bool RAG>
cudaError_t launch_f32_ring(const Params& p, const RingLayout& lay, int sms,
                            cudaStream_t stream) {
  return lay.nblk > 1 || lay.stream
             ? launch_ring<CB, true, RAG>(p, lay, sms, stream)
             : launch_ring<CB, false, RAG>(p, lay, sms, stream);
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

template <int CB>
cudaError_t launch_stream(const Params& p, const StreamLayout& lay,
                          int n_rows, int sms, cudaStream_t stream) {
  // C % 8 == 0: x boxes of a tap block's rows x ST_KW channels, weight
  // boxes of 64 output columns x the ST_KW / cluster input rows a rank
  // copies (both swizzled to 128 bytes; rows past L, channels and columns
  // past C arrive as zeros)
  CUtensorMap xmap = {}, wmap = {};
  if (p.C % 8 == 0 &&
      (!hopper::encode_bf16_3d(&xmap, p.x, (uint64_t)p.C, (uint64_t)p.L,
                               (uint64_t)n_rows, ST_KW,
                               (uint32_t)(ST_TM + lay.taps - 1)) ||
       !hopper::encode_bf16_3d(&wmap, p.w, (uint64_t)p.C, (uint64_t)p.C,
                               (uint64_t)p.K, 64,
                               (uint32_t)(ST_KW / lay.cluster))))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bf16_stream<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)lay.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lay.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = lay.cluster > 1 ? 1 : 0;
  // persistent: as many clusters per column block as can be resident at
  // once (one CTA an SM), no more than it has groups of tiles
  int clusters = sms;
  if (lay.cluster > 1) {
    e = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)conv_bf16_stream<CB>, &cfg);
    if (e != cudaSuccess) return e;
  }
  int per_cb = clusters / lay.n_cb;
  if (per_cb < 1) per_cb = 1;
  const int groups = (lay.m_tiles + lay.cluster - 1) / lay.cluster;
  if (per_cb > groups) per_cb = groups;
  cfg.gridDim = dim3((unsigned)(per_cb * lay.n_cb * lay.cluster));
  void* args[] = {(void*)&p, (void*)&lay, (void*)&n_rows, (void*)&xmap,
                  (void*)&wmap};
  e = cudaLaunchKernelExC(&cfg, (const void*)conv_bf16_stream<CB>, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
// Every C >= 1 and K >= 1, with the launch plan of
// ops/fused_conv.py::conv_plan; smem_bytes must equal the layout this file
// computes for it, and sms is the card's SM count. bf16, taps = 0 (route
// wgmma): cb output channels per CTA (16, 32, 64 or 128), kw channels per x
// / weight chunk, `stages` ring stages. bf16, taps > 0 (route
// wgmma_stream): cb 128, 64 or 32, kw 64, 32 or 16, taps a tap block,
// stages 2-4. f32 (routes f32_ring, f32_ring_pad: C % 16 != 0 or kw > 0):
// cb 64, 32 or 16, taps the weight taps a buffer holds (K: resident; fewer:
// streamed in tap blocks of at most taps, stages 2), kw 0 or the channels a
// streamed weight group holds, stages 2-4.
extern "C" int jt_fused_conv_block(int dtype, const void* x, const void* w,
                                   const void* bias, const void* dyt,
                                   const void* in_mask, const void* out_mask,
                                   const void* residual, void* out, int n_rows,
                                   int L, int C, int K, int act, int cb, int kw,
                                   int taps, int stages, int wstages,
                                   int cluster, int smem_bytes, int sms,
                                   void* stream) {
  if (n_rows <= 0 || L <= 0 || K <= 0 || C <= 0 || sms <= 0)
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
    const bool rag = C % R_CK != 0 || kw > 0;
    RingLayout lay;
    if (!make_ring_layout(n_rows, L, C, K, cb, taps, stages, kw, rag, &lay) ||
        lay.bytes != (uint32_t)smem_bytes)
      return (int)cudaErrorInvalidValue;
    switch (cb * 2 + rag) {
      case 128: return (int)launch_f32_ring<64, false>(p, lay, sms, s);
      case 64: return (int)launch_f32_ring<32, false>(p, lay, sms, s);
      case 32: return (int)launch_f32_ring<16, false>(p, lay, sms, s);
      case 129: return (int)launch_f32_ring<64, true>(p, lay, sms, s);
      case 65: return (int)launch_f32_ring<32, true>(p, lay, sms, s);
      default: return (int)launch_f32_ring<16, true>(p, lay, sms, s);
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (taps > 0) {
    StreamLayout lay;
    if (!make_stream_layout(n_rows, L, C, K, cb, kw, taps, stages, wstages,
                            cluster, &lay) ||
        lay.bytes != (uint32_t)smem_bytes)
      return (int)cudaErrorInvalidValue;
    // the column widths of conv_plan's stream_plan (STREAM_WIDTHS)
    switch (cb) {
      case 16: return (int)launch_stream<16>(p, lay, n_rows, sms, s);
      case 32: return (int)launch_stream<32>(p, lay, n_rows, sms, s);
      case 48: return (int)launch_stream<48>(p, lay, n_rows, sms, s);
      case 64: return (int)launch_stream<64>(p, lay, n_rows, sms, s);
      case 80: return (int)launch_stream<80>(p, lay, n_rows, sms, s);
      case 96: return (int)launch_stream<96>(p, lay, n_rows, sms, s);
      case 112: return (int)launch_stream<112>(p, lay, n_rows, sms, s);
      case 128: return (int)launch_stream<128>(p, lay, n_rows, sms, s);
      case 144: return (int)launch_stream<144>(p, lay, n_rows, sms, s);
      case 160: return (int)launch_stream<160>(p, lay, n_rows, sms, s);
      case 176: return (int)launch_stream<176>(p, lay, n_rows, sms, s);
      case 192: return (int)launch_stream<192>(p, lay, n_rows, sms, s);
      case 208: return (int)launch_stream<208>(p, lay, n_rows, sms, s);
      case 224: return (int)launch_stream<224>(p, lay, n_rows, sms, s);
      case 240: return (int)launch_stream<240>(p, lay, n_rows, sms, s);
      case 256: return (int)launch_stream<256>(p, lay, n_rows, sms, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Layout lay;
  if (!make_layout(n_rows, L, C, K, cb, kw, stages, &lay) ||
      lay.bytes != (uint32_t)smem_bytes)
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
