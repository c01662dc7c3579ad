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
// Design:
// * the rows are split over gridDim.x CTAs (about two per SM together with
//   the column blocks), each CTA walking 64-row tiles (n, l0..l0+63) with a
//   stride of gridDim.x; gridDim.y enumerates (ci block, co block) pairs of
//   CB = 64 channels, so every CTA keeps a (k, 64, 64) block of dW in
//   registers across all of its tiles;
// * per tile, x's 64 + k - 1 rows (the halo; rows outside [0, L) and masked
//   rows zero filled) and du's 64 rows are copied into shared memory with
//   cp.async (rows padded by 16 bytes: conflict-free ldmatrix), into one of
//   two buffers: the next tile's copies are in flight while the products of
//   this one run;
// * db: each thread sums one column over a quarter of the tile's rows; the
//   four partials are added in a fixed order at the end;
// * each warp owns 16 ci x 32 co of the block; per 16-row step it loads its
//   du fragments once (ldmatrix.trans: B = du[row][co]) and, for each tap j,
//   its x fragment from the rows shifted by j (ldmatrix.trans: A =
//   x[row + j][ci]^T) and issues mma.sync m16n8k16 bf16 -> f32;
// * every CTA writes its partial block, and a second kernel sums the
//   partials over the row splits in a fixed order: no float atomics, so a
//   train step gives the same bits run to run.
// The bf16 kernel is built for the shapes the training configs give it: k 3
// and 5, C a multiple of 64. f32 inputs take plain FMAs (one output element
// per thread, any odd k, C % 16 == 0), never TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;  // du rows per tile

struct Args {
  const void* x;            // (N, L, C)
  const void* du;           // (N, L, C)
  const uint8_t* in_mask;   // (N, L) or null
  float* part_w;            // (S, K, C, C)
  float* part_b;            // (S, C)
  int L;
  int C;
  int K;
  int pad;                  // (K - 1) / 2
  int tiles_per_row;        // ceil(L / TL)
  long long n_tiles;        // N * tiles_per_row
  long long n_rows_total;   // N * L
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, asynchronous; ok = false writes zeros
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(smem)), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int CB = 64;                       // channels per ci / co block
constexpr int NW = 32;                       // co columns per warp
constexpr int THREADS = (CB / 16) * (CB / NW) * 32;
constexpr int LD = CB + 8;                   // padded row, in elements
constexpr int BGROUPS = THREADS / CB;        // db row groups per tile

template <int K>
__global__ void __launch_bounds__(THREADS) wgrad_bf16(Args a) {
  constexpr int XROWS = TL + K - 1;
  constexpr int NT = NW / 8;                 // n8 tiles per warp
  __shared__ __align__(16) __nv_bfloat16 xs[2][XROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 ds[2][TL * LD];
  __shared__ float bsum[THREADS];

  const int n_blk = a.C / CB;
  const int ci0 = (blockIdx.y / n_blk) * CB;
  const int co0 = (blockIdx.y % n_blk) * CB;
  const bool does_bias = ci0 == 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = (warp % (CB / 16)) * 16;    // warp's ci rows in the block
  const int nb = (warp / (CB / 16)) * NW;    // warp's co columns
  const int q = lane / 8;
  const int r8 = lane % 8;

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* du = static_cast<const __nv_bfloat16*>(a.du);

  float acc[K][NT][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
  float bacc = 0.f;
  const int bcol = threadIdx.x % CB;         // db: this thread's column
  const int brow = (threadIdx.x / CB) * (TL / BGROUPS);  // and first row

  constexpr int CHUNKS = CB / 8;             // 16-byte chunks per row
  // one tile's copies into buffer buf, committed as one group
  auto load = [&](long long tile, int buf) {
    const long long n = tile / a.tiles_per_row;
    const int l0 = (int)(tile % a.tiles_per_row) * TL;
    for (int i = threadIdx.x; i < XROWS * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS;
      const int cc = (i % CHUNKS) * 8;
      const int l = l0 - a.pad + r;
      const bool ok = l >= 0 && l < a.L &&
                      (a.in_mask == nullptr || a.in_mask[n * a.L + l]);
      cp_async_16(&xs[buf][r * LD + cc],
                  ok ? x + (n * a.L + l) * a.C + ci0 + cc : x, ok);
    }
    for (int i = threadIdx.x; i < TL * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS;
      const int cc = (i % CHUNKS) * 8;
      const int l = l0 + r;
      const bool ok = l < a.L;
      cp_async_16(&ds[buf][r * LD + cc],
                  ok ? du + (n * a.L + l) * a.C + co0 + cc : du, ok);
    }
    cp_async_commit();
  };

  int buf = 0;
  if (blockIdx.x < a.n_tiles) load(blockIdx.x, 0);
  for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    if (tile + gridDim.x < a.n_tiles)
      load(tile + gridDim.x, buf ^ 1);
    else
      cp_async_commit();  // an empty group: wait_group 1 still means "this
                          // tile's copies have landed"
    cp_async_wait_1();
    __syncthreads();
    const __nv_bfloat16* xb = xs[buf];
    const __nv_bfloat16* db = ds[buf];
    if (does_bias) {
      // rows past L were zero filled
#pragma unroll
      for (int r = 0; r < TL / BGROUPS; ++r)
        bacc += __bfloat162float(db[(brow + r) * LD + bcol]);
    }
#pragma unroll
    for (int k0 = 0; k0 < TL; k0 += 16) {
      // B = du[row][co]: matrices (rows +0, cols +0), (rows +8, cols +0),
      // (rows +0, cols +8), (rows +8, cols +8) -> b0b1, b2b3 of n tiles
      // 2p and 2p + 1
      uint32_t b[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, db + (k0 + (q & 1) * 8 + r8) * LD + nb + 16 * p + (q >> 1) * 8);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // A = x[row + j][ci]^T: matrices (rows +0, ci +0), (rows +0,
        // ci +8), (rows +8, ci +0), (rows +8, ci +8) -> a0a1 .. a6a7
        uint32_t av[4];
        ldmatrix_x4_trans(
            av, xb + (k0 + j + (q >> 1) * 8 + r8) * LD + m0 + (q & 1) * 8);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16(acc[j][t], av, b[t][0], b[t][1]);
      }
    }
    __syncthreads();  // buf is read before the next round's copies refill it
    buf ^= 1;
  }

  // partial block: c0 c1 at (ci g, co 2t, 2t+1), c2 c3 at (ci g + 8, ...)
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long C = a.C;
  float* pw = a.part_w + (long long)blockIdx.x * a.K * C * C;
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int co = co0 + nb + t * 8 + 2 * t4;
      const int ci = ci0 + m0 + g;
      float* p0 = pw + ((long long)j * C + ci) * C + co;
      float* p1 = p0 + 8 * C;
      p0[0] = acc[j][t][0];
      p0[1] = acc[j][t][1];
      p1[0] = acc[j][t][2];
      p1[1] = acc[j][t][3];
    }
  if (does_bias) {
    bsum[threadIdx.x] = bacc;
    __syncthreads();
    if (threadIdx.x < CB) {
      float s = 0.f;
#pragma unroll
      for (int g2 = 0; g2 < BGROUPS; ++g2) s += bsum[g2 * CB + threadIdx.x];
      a.part_b[(long long)blockIdx.x * C + co0 + threadIdx.x] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: one output element per thread, plain FMAs
// ---------------------------------------------------------------------------

__global__ void wgrad_f32(Args a, long long rows_per_split) {
  const long long C = a.C;
  const long long n_w = (long long)a.K * C * C;
  const long long idx = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= n_w + C) return;
  const long long r0 = (long long)blockIdx.x * rows_per_split;
  long long r1 = r0 + rows_per_split;
  if (r1 > a.n_rows_total) r1 = a.n_rows_total;
  const float* x = static_cast<const float*>(a.x);
  const float* du = static_cast<const float*>(a.du);
  float acc = 0.f;
  if (idx < n_w) {
    const int j = (int)(idx / (C * C));
    const int ci = (int)((idx / C) % C);
    const int co = (int)(idx % C);
    for (long long r = r0; r < r1; ++r) {
      const long long n = r / a.L;
      const int l = (int)(r % a.L) + j - a.pad;
      if (l < 0 || l >= a.L) continue;
      const long long xr = n * a.L + l;
      if (a.in_mask != nullptr && !a.in_mask[xr]) continue;
      acc = fmaf(x[xr * C + ci], du[r * C + co], acc);
    }
    a.part_w[(long long)blockIdx.x * n_w + idx] = acc;
  } else {
    const int co = (int)(idx - n_w);
    for (long long r = r0; r < r1; ++r) acc += du[r * C + co];
    a.part_b[(long long)blockIdx.x * C + co] = acc;
  }
}

// ---------------------------------------------------------------------------
// second pass: sum the partials over the row splits, in split order
// ---------------------------------------------------------------------------

__global__ void reduce_splits(const float* part, float* out, long long n,
                              int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * n + i];
  out[i] = s;
}

template <int K>
cudaError_t launch_bf16(const Args& a, int splits, cudaStream_t stream) {
  const int n_blk = a.C / CB;
  const dim3 grid((unsigned)splits, (unsigned)(n_blk * n_blk));
  wgrad_bf16<K><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_w (splits, K, C, C) and part_b
// (splits, C) are scratch; dw (K, C, C) and db (C,) receive the sums. bf16
// takes cb = 64 (the channel block, dividing C) and K in {3, 5}; f32 any odd
// K (cb 0). Returns a cudaError_t (0 = success).
extern "C" int jt_conv_wgrad(int dtype, const void* x, const void* du,
                             const void* in_mask, void* part_w, void* part_b,
                             void* dw, void* db, int n_rows, int L, int C,
                             int K, int cb, int splits, void* stream) {
  if (n_rows <= 0 || L <= 0 || C <= 0 || C % 16 != 0 || K <= 0 ||
      K % 2 == 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.du = du;
  a.in_mask = static_cast<const uint8_t*>(in_mask);
  a.part_w = static_cast<float*>(part_w);
  a.part_b = static_cast<float*>(part_b);
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
    const long long n_out = (long long)K * C * C + C;
    const long long per = (a.n_rows_total + splits - 1) / splits;
    const dim3 grid((unsigned)splits, (unsigned)((n_out + 255) / 256));
    wgrad_f32<<<grid, 256, 0, s>>>(a, per);
    e = cudaGetLastError();
  } else if (dtype == 1) {
    if (cb != CB || C % CB != 0) return (int)cudaErrorInvalidValue;
    switch (K) {
      case 3: e = launch_bf16<3>(a, splits, s); break;
      case 5: e = launch_bf16<5>(a, splits, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const long long n_w = (long long)K * C * C;
  reduce_splits<<<(unsigned)((n_w + 255) / 256), 256, 0, s>>>(
      a.part_w, static_cast<float*>(dw), n_w, splits);
  reduce_splits<<<(unsigned)((C + 255) / 256), 256, 0, s>>>(
      a.part_b, static_cast<float*>(db), C, splits);
  return (int)cudaGetLastError();
}
