// conv_wgrad: the weight and bias gradients of the fused conv block.
//
// Backward of jaeger_tpu/ops/pallas_conv.py::fused_conv_block (the Pallas
// kernel has no VJP; JAX trains its convs through XLA). For x (N, L, C)
// channels-last, the DYT input's gradient du (N, L, C) and k taps with SAME
// padding (pad_l = (k - 1) / 2):
//
//   dW[j][ci][co] = sum_{n, l} xt[n, l + j - pad_l, ci] * du[n, l, co]
//   db[co]        = sum_{n, l} du[n, l, co]
//
// where xt is x with rows outside [0, L) and rows where in_mask is false read
// as zero (the forward convolves x * in_mask). dW is (k, C, C) f32, db (C,)
// f32.
//
// What bounds it on the H100: a GEMM with a tiny output (k * C * C) and a
// long contraction (K = N * L rows). At the train shape (N = 1536, L = 500,
// C = 128, k = 5) it is 1.26e11 bf16 FLOPs (0.127 ms at 989 TFLOP/s) against
// 393 MB of bf16 in (0.117 ms at 3.35 TB/s): both bounds matter.
//
// bf16: wgrad_bf16, a persistent warp-specialised wgmma kernel.
//  * Schedule: the 64-row tiles (n, l0..l0+63) are cut into `groups`
//    contiguous shares, one per group of G CTAs (G = C/64 ci blocks x C/CO
//    co blocks, CO = 128 where it divides C, else 64; G = 2 at C = 128). The
//    G CTAs of a group are neighbours in the grid and walk the same tiles in
//    the same order: each copies its own 64 ci of x (no other CTA of the
//    group copies them), and the du tile the group shares is read from HBM
//    once and from L2 by the others. About one CTA per SM (groups x G <= the
//    SM count, from the wrapper's plan).
//  * Each CTA keeps its whole block of dW, k taps x 64 ci x CO co in f32, in
//    the registers of two consumer warpgroups over all of its tiles (5 x 64
//    x 128 f32 = 160 registers a thread at C = 128). A warpgroup owns (k -
//    1) / 2 whole taps (wgmma m64nCOk16) and one half of the middle tap
//    (m64n(CO/2)k16): warpgroup 0 taps 0 .. and the middle tap's first co
//    half, warpgroup 1 the rest. Per 16-row step that is (k + 1) / 2 A
//    fragments a warpgroup (the middle one loaded by both) and B reads of
//    k * CO * 32 bytes for the CTA: about 100 bytes of shared memory per
//    cycle against the tensor cores' 320 cycles a step, where the split by
//    co block reads every A twice (128 bytes a cycle).
//  * The products: A = x^T (64 ci x 16 rows), from registers by
//    ldmatrix.trans at the rows shifted by tap j (a descriptor cannot start
//    at row j of a swizzled tile). B = du (16 rows x CO co), MN-major (co
//    contiguous), from a shared-memory descriptor with the transpose bit
//    (hopper.cuh smem_desc_mn, wgmma_bf16_rs_mn).
//  * A ring of 4 stages with full / empty mbarriers. One producer thread
//    loads per tile, by TMA from 3-D tensor maps over (N, L, C): the x halo
//    box (64 + k - 1 rows x 64 ci, 128-byte swizzle; rows before 0 and past
//    L - 1 arrive as zeros, never the neighbouring sequence's rows) and two
//    du boxes (64 rows x CO/2 co, 128 or 64-byte swizzle; rows past L
//    zero). TMA cannot apply a row mask: with in_mask, a second producer
//    warp zeroes the masked rows of each landed x tile in shared memory
//    (ballots of the tile's mask bytes, loaded three tiles ahead into one
//    of four register sets; a row is 128 contiguous bytes whatever the
//    swizzle) and hands the tile to the consumers on a third barrier.
//    (Zeroing the A registers instead, from mask words, cost the consumers
//    10 % at the train shape.) Two more
//    producer warps sum db over the du tile in row order (the group's
//    ci-block-0 CTA, CO columns). The consumers only load A and issue
//    products.
//  * Each warpgroup issues one wgmma group per two 16-row steps (3 % faster
//    than one) from one of two A register sets; the next group's
//    ldmatrix runs while a group is in flight, and a stage goes back to the
//    producer once the groups that read it have retired (each consumer warp
//    and db warp arrives).
//  * Every CTA writes its partial blocks (dW rows ci0.., columns co0..; db
//    columns) into the group's slot, and a second kernel sums the slots in
//    group order: no float atomics, the same bits run to run.
//  * Threads: 2 consumer warpgroups + 1 producer warpgroup = 384, one CTA
//    per SM; setmaxnreg gives the producers 40 registers and the consumers
//    232.
//  * Shared memory (C = 128, k = 5): 4 stages x (9,216 B x + 16,384 B du) +
//    mbarriers + 1 KB alignment slack = 103,520 B. The plan (groups, CO,
//    stages, bytes) is made in one place, the wrapper's
//    wgrad_plan (ops/fused_conv_grad.py); the entry below recomputes the
//    layout and refuses a plan that disagrees with it.
// The bf16 kernel is built for the shapes the training configs give it: k 3
// and 5, C a multiple of 64.
//
// f32 (plain FMAs, never TF32), every C % 16 == 0: wgrad_f32_ring<B> for
// blocks of 128 and 64 channels, its sibling wgrad_f32_taps<B, NT> for the
// other block widths (the same design with several taps a CTA; kept apart
// because one template for both ran 3.7 % slower at B 128 on the H100, its
// register spills moved).
//  * What bounds it: at the train shape 1.26e11 FLOPs, 1.88 ms at the
//    card's 67 TFLOP/s f32 rate, against 0.79 GB of f32 in (0.24 ms):
//    operations; at C 96 7.08e10 FLOPs (1.06 ms); at C 16 the bytes (0.10
//    GB, 0.030 ms). (The first f32 kernel gave each thread one output and
//    two global loads per FMA: 1 % of the bound, 173 ms at C 128 and
//    95.2 ms at C 96.)
//  * Blocks: the CTA's ci and co block B is 128 or 64 where it divides C,
//    else the largest of 112, 96, 80, 48, 32, 16 that does; where B is
//    narrow a CTA takes several taps (NT = 8 at B 16, 4 at 32, 2 at 48, else
//    1; the k taps cut into ceil(k / NT) blocks of near equal size), so a
//    thread still owns 16 or more outputs and reads its du rows once for
//    all of them.
//  * Schedule: groups of ceil(k / NT) x (C / B)^2 CTAs, one per (tap block,
//    ci block, co block), neighbours in the grid, walking the same
//    contiguous share of the N * L rows, two CTAs an SM (the plan's groups).
//  * A cp.async ring of 32-row stages (2 by default): for each tap j of the
//    CTA the B ci of x already shifted by it, so the products need no halo:
//    row r of the tap's rows holds x[n, l + j - pad] for du row (n, l), zero
//    filled by the copy where that position is outside [0, L) or in_mask is
//    false; then the B co of du. A thread's copies keep their rows'
//    (sequence, position) and move them on by 32 a stage, without a
//    division.
//  * Register blocking: thread (ti, to) of 16 x 8 accumulates, for each tap,
//    B / 16 ci x B / 8 co (8 x 16 f32 at B 128, 6 x 12 at B 96), the ci
//    XV-vectors 16 XV apart and the co DV-vectors 8 DV apart (XV, DV = 4 or
//    2 where B allows): a row's du values feed B / 16 FMAs of every tap, its
//    x values B / 8; a quarter-warp's du reads are contiguous.
//  * db in the (tap block 0, ci block 0) CTAs: thread (ti, to) sums rows ti
//    and ti + 16 of each stage, and the 16 row groups' sums are added in ti
//    order through shared memory at the end.
//  * Partials of each row share go to the share's slot and the second pass
//    sums them in share order, as for bf16: the same bits run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TL = 64;  // du rows per tile: the products' K step is 16 of them

struct Args {
  const void* x;            // (N, L, C)
  const void* du;           // (N, L, C)
  const uint8_t* in_mask;   // (N, L) or null
  float* part_w;            // (S, K, C, C)
  float* part_b;            // (S, C)
  int n_rows;               // N
  int L;
  int C;
  int K;
  int pad;                  // (K - 1) / 2
  int tiles_per_row;        // ceil(L / TL)
  long long n_tiles;        // N * tiles_per_row
  long long n_rows_total;   // N * L
};

// ---------------------------------------------------------------------------
// bf16: persistent wgmma kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int CI = 64;                       // ci per CTA: the wgmma M
constexpr int STEPS = 2;                     // 16-row steps per wgmma group
constexpr int THREADS = 3 * 128;             // 2 consumer + 1 producer WG
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory per block

// Shared-memory layout, byte offsets from a 1024-byte aligned base:
// [ring: stages x (x halo box, 1 KB aligned | du box 0 | du box 1)]
// [full, empty, masked mbarriers: 3 x stages x 8 B]
struct Layout {
  int stages;
  int rows;         // TL + K - 1
  int n_ci;         // C / 64 ci blocks
  int group;        // CTAs that share a tile: n_ci * C / co_block
  uint32_t x_bytes, box_bytes, stage, tx, off_bar, bytes;
};

inline uint32_t align1k(uint32_t v) { return (v + 1023u) & ~1023u; }

// false if (co_block, stages) cannot hold this shape
bool make_layout(int C, int K, int co_block, int stages, Layout* lay) {
  if (co_block != 64 && co_block != 128) return false;
  if (C % CI || C % co_block || stages < 2 || stages > 4) return false;
  if (K != 3 && K != 5) return false;
  lay->stages = stages;
  lay->rows = TL + K - 1;
  lay->n_ci = C / CI;
  lay->group = lay->n_ci * (C / co_block);
  lay->x_bytes = align1k((uint32_t)lay->rows * CI * 2);
  lay->box_bytes = (uint32_t)TL * co_block;  // 64 rows x co_block / 2 bf16
  lay->stage = lay->x_bytes + 2 * lay->box_bytes;
  lay->tx = (uint32_t)lay->rows * CI * 2 + 2 * lay->box_bytes;
  lay->off_bar = stages * lay->stage;
  lay->bytes = lay->off_bar + 24u * stages + 1024u;  // + alignment slack
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

// One consumer warpgroup WG: taps (K - 1) / 2 whole and half of the middle
// tap, over the CTA's tiles, STEPS 16-row steps to a wgmma group. Writes its
// partial block of dW at the end. Masked rows are zero in the tile already
// (the mask warp), so `ready` is the mask warp's barrier, or the TMA's
// without in_mask.
template <int K, int CO, int WG>
__device__ __forceinline__ void consume(const Args& a, const Layout& lay,
                                        uint32_t ring, uint32_t bar_s,
                                        uint32_t ready, int n_local, int grp,
                                        int ci0, int co0) {
  using namespace hopper;
  constexpr int HW = CO / 2;                 // co of one du box
  constexpr uint32_t DRB = HW * 2;           // du box row bytes
  constexpr int NF = (K - 1) / 2;            // whole taps of this warpgroup
  constexpr int JM = (K - 1) / 2;            // the middle tap
  constexpr int NA = NF + 1;                 // A fragments a step
  constexpr int GROUPS = TL / 16 / STEPS;    // wgmma groups a tile (even)
  const int S = lay.stages;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int q = lane >> 3, r8 = lane & 7, t4 = lane & 3, g = lane >> 2;

  // tap of A fragment tt: warpgroup 0 has taps 0 .. JM (the half last),
  // warpgroup 1 taps JM .. K - 1 (the half first)
  auto tap = [](int tt) { return WG == 0 ? tt : JM + tt; };
  // ldmatrix.trans address of this lane in a halo tile, tap tt, step 0:
  // matrix q covers rows (q >> 1) * 8 .. + 7 and ci 16 warp + (q & 1) * 8;
  // the 128-byte swizzle XORs the 16-byte chunk with the row's low 3 bits
  uint32_t xoff[NA];
#pragma unroll
  for (int tt = 0; tt < NA; ++tt) {
    const int row = tap(tt) + (q >> 1) * 8 + r8;
    const int chunk = warp * 2 + (q & 1);
    xoff[tt] = (uint32_t)row * 128 + ((chunk ^ (row & 7)) << 4);
  }

  float accF[NF][CO / 2];
  float accH[CO / 4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < CO / 2; ++e) accF[f][e] = 0.f;
#pragma unroll
  for (int e = 0; e < CO / 4; ++e) accH[e] = 0.f;

  // the A fragments of group gi: [st * NA + tt] for its steps st, rows
  // 16 step + tap + {2 t4, 2 t4 + 1} in registers 0 and 1, + 8 in 2 and 3
  auto load_a = [&](uint32_t(&av)[STEPS * NA][4], uint32_t xs, int gi) {
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int tt = 0; tt < NA; ++tt)
        ldmatrix_x4_trans(av[st * NA + tt],
                          xs + (gi * STEPS + st) * 16 * 128 + xoff[tt]);
  };
  // one wgmma group: per step the whole taps over both du boxes (n CO) and
  // the half tap over this warpgroup's box (n CO / 2); a step's rows start
  // 16 step * DRB bytes into each box
  auto issue = [&](uint32_t(&av)[STEPS * NA][4], uint32_t ds, int gi) {
#pragma unroll
    for (int f = 0; f < NF; ++f) fence_regs(accF[f]);
    fence_regs(accH);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const uint32_t d0 = ds + (gi * STEPS + st) * 16 * DRB;
      const uint64_t dfull = smem_desc_mn(d0, DRB, lay.box_bytes);
      const uint64_t dhalf = smem_desc_mn(d0 + WG * lay.box_bytes, DRB,
                                          lay.box_bytes);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        wgmma_bf16_rs_mn(accF[f], av[st * NA + (WG == 0 ? f : f + 1)], dfull,
                         1);
      wgmma_bf16_rs_mn(accH, av[st * NA + (WG == 0 ? NF : 0)], dhalf, 1);
    }
    wgmma_commit();
  };
  // each warp hands a stage back once its groups that read it retired
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_s + 8 * (S + s));
  };

  // two register sets: a group's wgmmas run while the next group's A
  // fragments are loaded
  uint32_t aA[STEPS * NA][4], aB[STEPS * NA][4];
  int prev = 0;
  for (int i = 0; i < n_local; ++i) {
    const int s = i % S;
    mbar_wait(ready + 8 * s, (i / S) & 1);
    const uint32_t xs = ring + s * lay.stage;
    const uint32_t ds = xs + lay.x_bytes;
#pragma unroll
    for (int gi = 0; gi < GROUPS; gi += 2) {
      load_a(aA, xs, gi);
      issue(aA, ds, gi);
      wgmma_wait<1>();  // the group before is done: set B is free
      fence_regs(aB);
      if (gi == 0 && i > 0) release(prev);  // the previous tile is done
      load_a(aB, xs, gi + 1);
      issue(aB, ds, gi + 1);
      wgmma_wait<1>();
      fence_regs(aA);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(aB);
#pragma unroll
  for (int f = 0; f < NF; ++f) fence_regs(accF[f]);
  fence_regs(accH);
  if (n_local > 0) release(prev);

  // partial block: accumulator 4 q + {0, 1} at (ci g, co 8 q + 2 t4 + {0, 1}),
  // 4 q + {2, 3} at ci g + 8
  const long long C = a.C;
  float* pw = a.part_w + (long long)grp * a.K * C * C;
  const int ci = ci0 + 16 * warp + g;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    float* p0 = pw + ((long long)tap(WG == 0 ? f : f + 1) * C + ci) * C + co0 +
                2 * t4;
#pragma unroll
    for (int qq = 0; qq < CO / 8; ++qq) {
      *reinterpret_cast<float2*>(p0 + 8 * qq) =
          make_float2(accF[f][4 * qq], accF[f][4 * qq + 1]);
      *reinterpret_cast<float2*>(p0 + 8 * C + 8 * qq) =
          make_float2(accF[f][4 * qq + 2], accF[f][4 * qq + 3]);
    }
  }
  float* p0 = pw + ((long long)JM * C + ci) * C + co0 + WG * HW + 2 * t4;
#pragma unroll
  for (int qq = 0; qq < HW / 8; ++qq) {
    *reinterpret_cast<float2*>(p0 + 8 * qq) =
        make_float2(accH[4 * qq], accH[4 * qq + 1]);
    *reinterpret_cast<float2*>(p0 + 8 * C + 8 * qq) =
        make_float2(accH[4 * qq + 2], accH[4 * qq + 3]);
  }
}

template <int K, int CO>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_bf16(Args a, Layout lay, const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap dmap) {
  using namespace hopper;
  constexpr int HW = CO / 2;
  constexpr uint32_t DRB = HW * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int S = lay.stages, L = a.L;
  const int tid = threadIdx.x;
  const int grp = blockIdx.x / lay.group;     // the tile share
  const int member = blockIdx.x % lay.group;  // (ci block, co block)
  const int cib = member % lay.n_ci;
  const int ci0 = cib * CI, co0 = (member / lay.n_ci) * CO;
  const int n_groups = gridDim.x / lay.group;
  const long long t_begin = a.n_tiles * grp / n_groups;
  const int n_local = (int)(a.n_tiles * (grp + 1) / n_groups - t_begin);
  const uint32_t ring = base;
  // barriers: full (TMA), empty (consumers, db), masked (the mask warp)
  const uint32_t bar_s = base + lay.off_bar;
  const uint32_t bar_m = bar_s + 16 * S;
  const bool masked = a.in_mask != nullptr;
  const bool does_bias = cib == 0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_s + 8 * s, 1);                          // expect_tx
      mbar_init(bar_s + 8 * (S + s), does_bias ? 10 : 8);   // each warp
      mbar_init(bar_m + 8 * s, 1);                          // the mask warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    setmaxnreg_dec<40>();
    const int warp = (tid - 256) / 32, lane = tid % 32;
    if (warp == 0) {
      // ---- one thread keeps the ring full ----
      if (lane == 0) {
        for (int i = 0; i < n_local; ++i) {
          const int s = i % S;
          const long long t = t_begin + i;
          const int n = (int)(t / a.tiles_per_row);
          const int l0 = (int)(t % a.tiles_per_row) * TL;
          const uint32_t st = ring + s * lay.stage;
          mbar_wait(bar_s + 8 * (S + s), ((i / S) & 1) ^ 1);
          mbar_arrive_expect_tx(bar_s + 8 * s, lay.tx);
          tma_load_3d(st, &xmap, bar_s + 8 * s, ci0, l0 - a.pad, n);
          tma_load_3d(st + lay.x_bytes, &dmap, bar_s + 8 * s, co0, l0, n);
          tma_load_3d(st + lay.x_bytes + lay.box_bytes, &dmap, bar_s + 8 * s,
                      co0 + HW, l0, n);
        }
      }
    } else if (warp == 1) {
      // ---- rows that in_mask masks: zeroed in the x tile once it landed
      // (TMA cannot apply a row mask), then the tile goes to the consumers
      // on the `masked` barrier ----
      if (masked) {
        // this lane's mask bytes of halo rows 32 k + lane of local tile i
        // (1 outside [0, L) and past the halo: nothing to zero there)
        auto fetch = [&](int i, uint32_t(&m)[3]) {
          const long long t = t_begin + i;
          const long long n = t / a.tiles_per_row;
          const int l0 = (int)(t % a.tiles_per_row) * TL;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int r = 32 * k + lane, pos = l0 - a.pad + r;
            m[k] = r < lay.rows && pos >= 0 && pos < L
                       ? (uint32_t)a.in_mask[n * L + pos]
                       : 1u;
          }
        };
        // zero tile i's masked rows (each 128 contiguous bytes, whatever
        // the swizzle) once it landed, and hand it to the consumers
        auto apply = [&](int i, const uint32_t(&m)[3]) {
          const int s = i % S;
          unsigned char* xt = sbase + s * lay.stage;
          mbar_wait(bar_s + 8 * s, (i / S) & 1);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            uint32_t z = __ballot_sync(0xffffffffu, m[k] == 0u);
            while (z) {
              const int r = 32 * k + __ffs(z) - 1;
              z &= z - 1;
              *reinterpret_cast<uint32_t*>(xt + r * 128 + 4 * lane) = 0u;
            }
          }
          fence_proxy_async();  // before TMA overwrites the stage
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_m + 8 * s);
        };
        // MD register sets: tile i's bytes are loaded MD - 1 tiles ahead,
        // so the warp's pace is not the loads' latency
        constexpr int MD = 4;
        uint32_t m[MD][3];
#pragma unroll
        for (int j = 0; j < MD - 1; ++j)
          if (j < n_local) fetch(j, m[j]);
        for (int i = 0; i < n_local; i += MD) {
#pragma unroll
          for (int j = 0; j < MD; ++j) {
            if (i + j >= n_local) break;
            if (i + j + MD - 1 < n_local)
              fetch(i + j + MD - 1, m[(j + MD - 1) % MD]);
            apply(i + j, m[j]);
          }
        }
      }
    } else if (does_bias) {
      // ---- db: warp 2 + b sums du box b's columns 2 lane, 2 lane + 1 over
      // the tile's rows in order (rows past L were zero filled) ----
      const int b = warp - 2;
      const bool active = 2 * lane < HW;
      float s0 = 0.f, s1 = 0.f;
      for (int i = 0; i < n_local; ++i) {
        const int s = i % S;
        mbar_wait(bar_s + 8 * s, (i / S) & 1);
        if (active) {
          const unsigned char* box =
              sbase + s * lay.stage + lay.x_bytes + b * lay.box_bytes;
#pragma unroll 8
          for (int r = 0; r < TL; ++r) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                box + swizzle(r * DRB + 4 * lane, DRB));
            s0 += __uint_as_float(v << 16);
            s1 += __uint_as_float(v & 0xffff0000u);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_s + 8 * (S + s));
      }
      if (active) {
        float* pb = a.part_b + (long long)grp * a.C + co0 + b * HW + 2 * lane;
        pb[0] = s0;
        pb[1] = s1;
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const uint32_t ready = masked ? bar_m : bar_s;
    if (tid < 128)
      consume<K, CO, 0>(a, lay, ring, bar_s, ready, n_local, grp, ci0, co0);
    else
      consume<K, CO, 1>(a, lay, ring, bar_s, ready, n_local, grp, ci0, co0);
  }
}

// ---------------------------------------------------------------------------
// f32: wgrad_f32_ring, persistent FMA outer products (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 128;  // 16 x 8 threads, two CTAs an SM
constexpr int F_WR = 32;        // rows a ring stage

// The ci and co block B of C channels: 128 or 64 where they divide C, else
// the largest of 112, 96, 80, 48, 32 and 16 that does (a thread then owns
// B / 16 x B / 8 outputs of each of its CTA's taps)
inline int f32_block(int C) {
  if (C % 128 == 0) return 128;
  if (C % 64 == 0) return 64;
  const int blocks[] = {112, 96, 80, 48, 32};
  for (int b : blocks)
    if (C % b == 0) return b;
  return 16;
}

// The most taps of a CTA for block B: several where B is narrow, so that
// the CTA's du rows are read once for all of them and a thread still owns
// 16 or more outputs
__host__ __device__ constexpr int f32_taps(int B) {
  return B == 16 ? 8 : B == 32 ? 4 : B == 48 ? 2 : 1;
}

// The stage layout: for each of the CTA's taps F_WR x rows (already shifted
// by the tap, masked rows zero), then F_WR du rows, each B f32 of the CTA's
// ci / co block.
__host__ __device__ inline uint32_t f32_stage_bytes(int B) {
  return (uint32_t)(f32_taps(B) + 1) * F_WR * B * 4;
}

// false unless (co_block, stages, smem) is the f32 ring plan of C
bool f32_ring_fits(int C, int co_block, int stages, int smem_bytes) {
  return co_block == f32_block(C) && stages >= 2 && stages <= 4 &&
         (uint32_t)smem_bytes == stages * f32_stage_bytes(co_block) &&
         smem_bytes <= SMEM_LIMIT;
}

// V floats from shared memory into d (V = 1, 2 or 4, aligned to V floats)
template <int V>
__device__ __forceinline__ void load_v(float* d, const float* s) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = *s;
  }
}

// CTA (grp, member): member = (j * nb + cib) * nb + cob for tap j, ci block
// cib and co block cob of B channels (nb = C / B); the group's CTAs walk
// the rows [R grp / groups, R (grp + 1) / groups) of the R = N * L rows.
template <int B>
__global__ void __launch_bounds__(F_THREADS, 2)
wgrad_f32_ring(Args a, int stages) {
  constexpr int TI = B / 16;   // ci a thread: 8 or 4
  constexpr int TO = B / 8;    // co a thread: 16 or 8
  constexpr int U = B / 4;     // 16-byte units a row
  extern __shared__ __align__(16) unsigned char smem_w[];
  const uint32_t ring = hopper::smem_u32(smem_w);
  const float* ringf = reinterpret_cast<const float*>(smem_w);
  const int S = stages;
  const int C = a.C, L = a.L, nb = C / B;
  const int group = a.K * nb * nb;
  const int grp = blockIdx.x / group, member = blockIdx.x % group;
  const int cob = member % nb, cib = (member / nb) % nb;
  const int j = member / (nb * nb);
  const int n_groups = gridDim.x / group;
  const long long r_begin = a.n_rows_total * grp / n_groups;
  const long long r_end = a.n_rows_total * (grp + 1) / n_groups;
  const int total = (int)((r_end - r_begin + F_WR - 1) / F_WR);
  const int shift = j - a.pad;
  const bool does_bias = j == 0 && cib == 0;
  const float* x = static_cast<const float*>(a.x);
  const float* du = static_cast<const float*>(a.du);
  const int tid = threadIdx.x;

  // ---- the ring: each thread copies units idx = tid + 128 m of a stage,
  // x rows first (row (idx / U) % F_WR, unit idx % U), du rows after; rows
  // past the share, x rows outside [0, L) or masked are zero filled. issue
  // is called for q = 0, 1, 2, ... in turn: the (sequence, position) of
  // each x row this thread copies moves on by F_WR rows a call. ----
  constexpr int XM = F_WR * U / F_THREADS;  // x rows a thread copies
  int xn[XM], xl[XM];
#pragma unroll
  for (int m = 0; m < XM; ++m) {
    const long long g = r_begin + (tid + F_THREADS * m) / U;
    xn[m] = (int)(g / L);
    xl[m] = (int)(g - (long long)xn[m] * L);
  }
  auto issue = [&](int q) {
    if (q < total) {
      const uint32_t st = ring + (uint32_t)(q % S) * f32_stage_bytes(B);
      const long long g0 = r_begin + (long long)q * F_WR;
#pragma unroll
      for (int m = 0; m < 2 * XM; ++m) {
        const int idx = tid + F_THREADS * m;
        const int r = (idx / U) % F_WR, u = idx % U;
        bool ok = g0 + r < r_end;
        const float* src = x;
        if (m < XM) {
          const int pos = xl[m] + shift;
          ok = ok && pos >= 0 && pos < L &&
               (a.in_mask == nullptr ||
                a.in_mask[(long long)xn[m] * L + pos]);
          if (ok) src = x + ((long long)xn[m] * L + pos) * C + cib * B + 4 * u;
        } else if (ok) {
          src = du + (g0 + r) * C + cob * B + 4 * u;
        }
        hopper::cp_async16_zfill(st + (uint32_t)idx * 16u, src, ok);
      }
    }
    hopper::cp_async_commit();
#pragma unroll
    for (int m = 0; m < XM; ++m) {
      xl[m] += F_WR;
      while (xl[m] >= L) {
        xl[m] -= L;
        ++xn[m];
      }
    }
  };

  // ---- the products: thread (ti, to) = (tid / 8, tid % 8) owns ci 64 g +
  // 4 ti + e (g < TI / 4) and co 32 h + 4 to + e (h < TO / 4) of the block:
  // each row's 16-byte x unit feeds 4 TO FMAs, each du unit 4 TI ----
  const int ti = tid / 8, to = tid % 8;
  float acc[TI][TO];
  float dbs[TO];
#pragma unroll
  for (int e = 0; e < TO; ++e) {
    dbs[e] = 0.f;
#pragma unroll
    for (int i = 0; i < TI; ++i) acc[i][e] = 0.f;
  }
  auto load4 = [](float* d, const float* s) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  };

  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    if (S == 2)
      hopper::cp_async_wait<0>();
    else if (S == 3)
      hopper::cp_async_wait<1>();
    else
      hopper::cp_async_wait<2>();
    __syncthreads();
    issue(q + S - 1);
    const float* xs = ringf + (size_t)(q % S) * (2 * F_WR * B);
    const float* ds = xs + F_WR * B;
#pragma unroll 4
    for (int r = 0; r < F_WR; ++r) {
      float xv[TI], dv[TO];
#pragma unroll
      for (int g = 0; g < TI / 4; ++g)
        load4(xv + 4 * g, xs + r * B + 64 * g + 4 * ti);
#pragma unroll
      for (int h = 0; h < TO / 4; ++h)
        load4(dv + 4 * h, ds + r * B + 32 * h + 4 * to);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int e = 0; e < TO; ++e) acc[i][e] = fmaf(xv[i], dv[e], acc[i][e]);
    }
    if (does_bias) {
      // db: this thread sums rows ti and ti + 16 of the stage, in order
#pragma unroll
      for (int rr = 0; rr < F_WR; rr += 16) {
        float dv[TO];
#pragma unroll
        for (int h = 0; h < TO / 4; ++h)
          load4(dv + 4 * h, ds + (rr + ti) * B + 32 * h + 4 * to);
#pragma unroll
        for (int e = 0; e < TO; ++e) dbs[e] += dv[e];
      }
    }
  }
  hopper::cp_async_wait<0>();

  // partial block: dW[j][cib B + ci][cob B + co] of this row share
  const long long CC = C;
  float* pw = a.part_w + ((long long)grp * a.K + j) * CC * CC;
#pragma unroll
  for (int g = 0; g < TI / 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = cib * B + 64 * g + 4 * ti + e;
#pragma unroll
      for (int h = 0; h < TO / 4; ++h) {
        const int co = cob * B + 32 * h + 4 * to;
        *reinterpret_cast<float4*>(pw + ci * CC + co) =
            make_float4(acc[4 * g + e][4 * h], acc[4 * g + e][4 * h + 1],
                        acc[4 * g + e][4 * h + 2], acc[4 * g + e][4 * h + 3]);
      }
    }
  if (does_bias) {
    // the 16 row groups' sums of each co, added in ti order
    __syncthreads();  // every thread is past its last ring read
    float* red = reinterpret_cast<float*>(smem_w);  // 16 x B
#pragma unroll
    for (int h = 0; h < TO / 4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[ti * B + 32 * h + 4 * to + e] = dbs[4 * h + e];
    __syncthreads();
    for (int co = tid; co < B; co += F_THREADS) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * B + co];
      a.part_b[(long long)grp * C + cob * B + co] = sum;
    }
  }
}

// The sibling for the other block widths (C % 64 != 0), several taps a CTA
// where B is narrow.
// CTA (grp, member): member = (tb * nb + cib) * nb + cob for tap block tb
// (taps [tb K / nblk, (tb + 1) K / nblk) of the nblk = ceil(K / NT) blocks,
// at most NT each), ci block cib and co block cob of B channels (nb = C /
// B); the group's CTAs walk the rows [R grp / groups, R (grp + 1) / groups)
// of the R = N * L rows.
template <int B, int NT>
__global__ void __launch_bounds__(F_THREADS, 2)
wgrad_f32_taps(Args a, int stages) {
  constexpr int TI = B / 16;   // ci a thread, each tap
  constexpr int TO = B / 8;    // co a thread, each tap
  // ci of thread ti: 16 XV g + XV ti + e (e < XV); co of thread to: 8 DV h
  // + DV to + e (e < DV): a quarter-warp's loads are neighbours
  constexpr int XV = B % 64 == 0 ? 4 : B % 32 == 0 ? 2 : 1;
  constexpr int DV = B % 32 == 0 ? 4 : 2;
  constexpr int U = B / 4;                  // 16-byte units a row
  constexpr int XR = NT * F_WR;             // x rows a stage
  constexpr int XM = XR * U / F_THREADS;    // x units a thread copies
  constexpr int DM = F_WR * U / F_THREADS;  // du units a thread copies
  static_assert(XR * U % F_THREADS == 0 && F_WR * U % F_THREADS == 0,
                "B % 16 == 0");
  extern __shared__ __align__(16) unsigned char smem_w[];
  const uint32_t ring = hopper::smem_u32(smem_w);
  const float* ringf = reinterpret_cast<const float*>(smem_w);
  const int S = stages;
  const int C = a.C, L = a.L, K = a.K, nb = C / B;
  const int nblk = (K + NT - 1) / NT;
  const int group = nblk * nb * nb;
  const int grp = blockIdx.x / group, member = blockIdx.x % group;
  const int cob = member % nb, cib = (member / nb) % nb;
  const int tb = member / (nb * nb);
  const int j0 = tb * K / nblk, nt = (tb + 1) * K / nblk - j0;
  const int shift = j0 - a.pad;
  const int n_groups = gridDim.x / group;
  const long long r_begin = a.n_rows_total * grp / n_groups;
  const long long r_end = a.n_rows_total * (grp + 1) / n_groups;
  const int total = (int)((r_end - r_begin + F_WR - 1) / F_WR);
  const bool does_bias = tb == 0 && cib == 0;
  const float* x = static_cast<const float*>(a.x);
  const float* du = static_cast<const float*>(a.du);
  const int tid = threadIdx.x;

  // ---- the ring: each thread copies units idx = tid + 128 m of a stage, x
  // rows first (tap idx / (F_WR U), row (idx / U) % F_WR, unit idx % U), du
  // rows after; rows past the share, taps past the block, x rows outside
  // [0, L) or masked are zero filled. issue is called for q = 0, 1, 2, ...
  // in turn: the (sequence, position) of each x row this thread copies
  // moves on by F_WR rows a call. ----
  int xn[XM], xl[XM];
#pragma unroll
  for (int m = 0; m < XM; ++m) {
    const long long g = r_begin + ((tid + F_THREADS * m) / U) % F_WR;
    xn[m] = (int)(g / L);
    xl[m] = (int)(g - (long long)xn[m] * L);
  }
  auto issue = [&](int q) {
    if (q < total) {
      const uint32_t st = ring + (uint32_t)(q % S) * f32_stage_bytes(B);
      const long long g0 = r_begin + (long long)q * F_WR;
#pragma unroll
      for (int m = 0; m < XM; ++m) {
        const int idx = tid + F_THREADS * m;
        const int t = NT == 1 ? 0 : idx / (F_WR * U);
        const int r = (idx / U) % F_WR, u = idx % U;
        const int pos = xl[m] + shift + t;
        const bool ok = (NT == 1 || t < nt) && g0 + r < r_end && pos >= 0 &&
                        pos < L &&
                        (a.in_mask == nullptr ||
                         a.in_mask[(long long)xn[m] * L + pos]);
        const float* src =
            ok ? x + ((long long)xn[m] * L + pos) * C + cib * B + 4 * u : x;
        hopper::cp_async16_zfill(st + (uint32_t)idx * 16u, src, ok);
      }
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const int idx = tid + F_THREADS * m;
        const int r = idx / U, u = idx % U;
        const bool ok = g0 + r < r_end;
        const float* src = ok ? du + (g0 + r) * C + cob * B + 4 * u : du;
        hopper::cp_async16_zfill(st + (uint32_t)(XR * U + idx) * 16u, src,
                                 ok);
      }
    }
    hopper::cp_async_commit();
#pragma unroll
    for (int m = 0; m < XM; ++m) {
      xl[m] += F_WR;
      while (xl[m] >= L) {
        xl[m] -= L;
        ++xn[m];
      }
    }
  };

  // ---- the products: thread (ti, to) = (tid / 8, tid % 8) owns, for each
  // tap t of its block, ci 16 XV g + XV ti + e and co 8 DV h + DV to + e:
  // each row's du values feed TI FMAs of every tap, each x value TO ----
  const int ti = tid / 8, to = tid % 8;
  float acc[NT][TI][TO];
  float dbs[TO];
#pragma unroll
  for (int e = 0; e < TO; ++e) {
    dbs[e] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < TI; ++i) acc[t][i][e] = 0.f;
  }

  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    if (S == 2)
      hopper::cp_async_wait<0>();
    else if (S == 3)
      hopper::cp_async_wait<1>();
    else
      hopper::cp_async_wait<2>();
    __syncthreads();
    issue(q + S - 1);
    const float* xs = ringf + (size_t)(q % S) * (XR + F_WR) * B;
    const float* ds = xs + XR * B;
#pragma unroll 4
    for (int r = 0; r < F_WR; ++r) {
      // x of tap 0, then the row's du, then the other taps' x
      float xv[TI], dv[TO];
#pragma unroll
      for (int g = 0; g < TI / XV; ++g)
        load_v<XV>(xv + XV * g, xs + r * B + 16 * XV * g + XV * ti);
#pragma unroll
      for (int h = 0; h < TO / DV; ++h)
        load_v<DV>(dv + DV * h, ds + r * B + 8 * DV * h + DV * to);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t > 0) {
          if (t >= nt) break;
#pragma unroll
          for (int g = 0; g < TI / XV; ++g)
            load_v<XV>(xv + XV * g,
                       xs + (t * F_WR + r) * B + 16 * XV * g + XV * ti);
        }
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int e = 0; e < TO; ++e)
            acc[t][i][e] = fmaf(xv[i], dv[e], acc[t][i][e]);
      }
    }
    if (does_bias) {
      // db: this thread sums rows ti and ti + 16 of the stage, in order
#pragma unroll
      for (int rr = 0; rr < F_WR; rr += 16) {
        float dv[TO];
#pragma unroll
        for (int h = 0; h < TO / DV; ++h)
          load_v<DV>(dv + DV * h, ds + (rr + ti) * B + 8 * DV * h + DV * to);
#pragma unroll
        for (int e = 0; e < TO; ++e) dbs[e] += dv[e];
      }
    }
  }
  hopper::cp_async_wait<0>();

  // partial block: dW[j0 + t][cib B + ci][cob B + co] of this row share
  const long long CC = C;
  float* pw = a.part_w + (long long)grp * K * CC * CC;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (NT > 1 && t >= nt) break;
#pragma unroll
    for (int g = 0; g < TI / XV; ++g)
#pragma unroll
      for (int e = 0; e < XV; ++e) {
        const int ci = cib * B + 16 * XV * g + XV * ti + e;
        const int i = XV * g + e;
#pragma unroll
        for (int h = 0; h < TO / DV; ++h) {
          float* dst = pw + ((long long)(j0 + t) * CC + ci) * CC + cob * B +
                       8 * DV * h + DV * to;
          if constexpr (DV == 4)
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[t][i][4 * h], acc[t][i][4 * h + 1],
                            acc[t][i][4 * h + 2], acc[t][i][4 * h + 3]);
          else
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[t][i][2 * h], acc[t][i][2 * h + 1]);
        }
      }
  }
  if (does_bias) {
    // the 16 row groups' sums of each co, added in ti order
    __syncthreads();  // every thread is past its last ring read
    float* red = reinterpret_cast<float*>(smem_w);  // 16 x B
#pragma unroll
    for (int h = 0; h < TO / DV; ++h)
#pragma unroll
      for (int e = 0; e < DV; ++e)
        red[ti * B + 8 * DV * h + DV * to + e] = dbs[DV * h + e];
    __syncthreads();
    for (int co = tid; co < B; co += F_THREADS) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * B + co];
      a.part_b[(long long)grp * C + cob * B + co] = sum;
    }
  }
}

template <int B>
cudaError_t launch_f32_ring(const Args& a, int groups, int stages,
                            int smem_bytes, cudaStream_t stream) {
  constexpr int NT = f32_taps(B);
  void (*kernel)(Args, int);
  if constexpr (B % 64 == 0)
    kernel = wgrad_f32_ring<B>;
  else
    kernel = wgrad_f32_taps<B, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  const int nb = a.C / B;
  const int nblk = (a.K + NT - 1) / NT;
  kernel<<<groups * nblk * nb * nb, F_THREADS, smem_bytes, stream>>>(a,
                                                                     stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// second pass: sum the partials over the row splits, in split order
// ---------------------------------------------------------------------------

// dW's n_w elements from part_w, then db's C from part_b, in one launch
__global__ void reduce_splits(const float* part_w, const float* part_b,
                              float* dw, float* db, long long n_w, int C,
                              int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_w + C) return;
  const bool w = i < n_w;
  const float* part = w ? part_w + i : part_b + (i - n_w);
  const long long stride = w ? n_w : C;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * stride];
  if (w)
    dw[i] = s;
  else
    db[i - n_w] = s;
}

template <int K, int CO>
cudaError_t launch_bf16(const Args& a, const Layout& lay, int groups,
                        cudaStream_t stream) {
  // x: boxes of the tile's rows plus halo x 64 ci; du: 64 rows x CO / 2 co
  CUtensorMap xmap, dmap;
  if (!hopper::encode_bf16_3d(&xmap, a.x, (uint64_t)a.C, (uint64_t)a.L,
                              (uint64_t)a.n_rows, (uint32_t)CI,
                              (uint32_t)lay.rows) ||
      !hopper::encode_bf16_3d(&dmap, a.du, (uint64_t)a.C, (uint64_t)a.L,
                              (uint64_t)a.n_rows, (uint32_t)(CO / 2),
                              (uint32_t)TL))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_bf16<K, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (e != cudaSuccess) return e;
  wgrad_bf16<K, CO><<<groups * lay.group, THREADS, lay.bytes, stream>>>(
      a, lay, xmap, dmap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_w (groups, K, C, C) and part_b
// (groups, C) are scratch; dw (K, C, C) and db (C,) receive the sums. bf16
// takes the launch plan of ops/fused_conv_grad.py::wgrad_plan: `groups` tile
// shares of C/64 x C/co_block CTAs each, co_block 64 or 128 dividing C,
// `stages` ring stages and smem_bytes of shared memory, which must equal the
// layout this file computes; K in {3, 5}. f32, any odd K and C % 16 == 0:
// groups row shares of ceil(K / NT) x (C / B)^2 CTAs, co_block = B (f32_block
// of C, NT = f32_taps of B), `stages` 2-4 and smem_bytes = stages x (NT + 1)
// x 32 x B x 4. Returns a cudaError_t (0 = success).
extern "C" int jt_conv_wgrad(int dtype, const void* x, const void* du,
                             const void* in_mask, void* part_w, void* part_b,
                             void* dw, void* db, int n_rows, int L, int C,
                             int K, int groups, int co_block, int stages,
                             int smem_bytes, void* stream) {
  if (n_rows <= 0 || L <= 0 || C <= 0 || C % 16 != 0 || K <= 0 ||
      K % 2 == 0 || groups <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.du = du;
  a.in_mask = static_cast<const uint8_t*>(in_mask);
  a.part_w = static_cast<float*>(part_w);
  a.part_b = static_cast<float*>(part_b);
  a.n_rows = n_rows;
  a.L = L;
  a.C = C;
  a.K = K;
  a.pad = (K - 1) / 2;
  a.tiles_per_row = (L + TL - 1) / TL;
  a.n_tiles = (long long)n_rows * a.tiles_per_row;
  a.n_rows_total = (long long)n_rows * L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    if (!f32_ring_fits(C, co_block, stages, smem_bytes))
      return (int)cudaErrorInvalidValue;
    switch (co_block) {
      case 128: e = launch_f32_ring<128>(a, groups, stages, smem_bytes, s);
        break;
      case 112: e = launch_f32_ring<112>(a, groups, stages, smem_bytes, s);
        break;
      case 96: e = launch_f32_ring<96>(a, groups, stages, smem_bytes, s);
        break;
      case 80: e = launch_f32_ring<80>(a, groups, stages, smem_bytes, s);
        break;
      case 64: e = launch_f32_ring<64>(a, groups, stages, smem_bytes, s);
        break;
      case 48: e = launch_f32_ring<48>(a, groups, stages, smem_bytes, s);
        break;
      case 32: e = launch_f32_ring<32>(a, groups, stages, smem_bytes, s);
        break;
      default: e = launch_f32_ring<16>(a, groups, stages, smem_bytes, s);
        break;
    }
  } else if (dtype == 1) {
    Layout lay;
    if (!make_layout(C, K, co_block, stages, &lay) ||
        lay.bytes != (uint32_t)smem_bytes || groups > a.n_tiles)
      return (int)cudaErrorInvalidValue;
    switch (K * 1000 + co_block) {
      case 3064: e = launch_bf16<3, 64>(a, lay, groups, s); break;
      case 3128: e = launch_bf16<3, 128>(a, lay, groups, s); break;
      case 5064: e = launch_bf16<5, 64>(a, lay, groups, s); break;
      case 5128: e = launch_bf16<5, 128>(a, lay, groups, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const long long n_w = (long long)K * C * C;
  reduce_splits<<<(unsigned)((n_w + C + 255) / 256), 256, 0, s>>>(
      a.part_w, a.part_b, static_cast<float*>(dw), static_cast<float*>(db),
      n_w, C, groups);
  return (int)cudaGetLastError();
}
