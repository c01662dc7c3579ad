// Fused SAME conv1d + bias/DYT + mask + residual + activation for Hopper.
//
// Port of the Pallas TPU kernel jaeger_tpu/ops/pallas_conv.py::fused_conv_block
// (body `_kernel`, :40-63). For x (N, L, C) channels-last and w (K, C, C):
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
// C = 128, K = 5) one call is 1.0e12 bf16 FLOPs against 3.1 GB of bf16 in and
// out, about 1.0 ms at the tensor-core peak and 0.9 ms at HBM rate, so it is
// compute bound once the tensor cores are busy. This first version is the
// simple one: one CTA per (row, 128-position tile) stages its input tile plus
// the K - 1 halo in shared memory, streams w[j] through shared memory tap by
// tap, runs the K shifted GEMMs on the tensor cores with WMMA (mma.sync,
// bf16 in, f32 accumulate) and applies the whole epilogue from an f32 staging
// tile, so the activation is read once and written once. The f32 variant uses
// plain FMAs (no TF32). wgmma, TMA and a persistent schedule come later.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (jaeger_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
// bf16: WMMA 16x16x16 tiles. 8 warps; warp w owns output rows 16w..16w+15 of
// the CTA's 128 positions and all CB = 16 * NT columns of its column block.
// ---------------------------------------------------------------------------

constexpr int BF_TL = 128;
constexpr int BF_WARPS = 8;
constexpr int PAD_BF = 16;  // bf16 row padding: keeps rows 32-byte aligned
constexpr int PAD_F = 8;    // f32 staging row padding

template <int NT>
__global__ void __launch_bounds__(BF_WARPS * 32)
conv_bf16_wmma(Params p, int l_tiles) {
  using namespace nvcuda;
  constexpr int CB = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, K = p.K, L = p.L;
  const int xs_ld = C + PAD_BF;
  const int ws_ld = CB + PAD_BF;
  const int os_ld = CB + PAD_F;
  const int rows_in = BF_TL + K - 1;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + rows_in * xs_ld;
  float* os = reinterpret_cast<float*>(smem);  // reused after the MMA loop

  const int n = blockIdx.x / l_tiles;
  const int l0 = (blockIdx.x % l_tiles) * BF_TL;
  const int col0 = blockIdx.y * CB;
  const int pad_l = (K - 1) / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  // input tile plus halo, 16 bytes a thread; masked and outside rows are 0
  const int xvec = C / 8;
  for (int i = tid; i < rows_in * xvec; i += blockDim.x) {
    const int r = i / xvec, v = i - r * xvec;
    const int pos = l0 - pad_l + r;
    int4 val = make_int4(0, 0, 0, 0);
    if (pos >= 0 && pos < L) {
      const long long row = (long long)n * L + pos;
      if (!p.in_mask || p.in_mask[row])
        val = *reinterpret_cast<const int4*>(x + row * C + v * 8);
    }
    *reinterpret_cast<int4*>(xs + r * xs_ld + v * 8) = val;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.f);

  const int wvec = CB / 8;
  for (int j = 0; j < K; ++j) {
    __syncthreads();  // the last tap's weights are consumed; x tile complete
    const __nv_bfloat16* wj = w + (long long)j * C * C + col0;
    for (int i = tid; i < C * wvec; i += blockDim.x) {
      const int ci = i / wvec, v = i - ci * wvec;
      *reinterpret_cast<int4*>(ws + ci * ws_ld + v * 8) =
          *reinterpret_cast<const int4*>(wj + (long long)ci * C + v * 8);
    }
    __syncthreads();
    const __nv_bfloat16* a_base = xs + (warp * 16 + j) * xs_ld;
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + kk, xs_ld);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ws + kk * ws_ld + t * 16, ws_ld);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }
  __syncthreads();  // every warp is done with xs / ws before os reuses them
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(os + warp * 16 * os_ld + t * 16, acc[t], os_ld,
                            wmma::mem_row_major);
  __syncthreads();

  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.residual);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  constexpr int HALF = CB / 2;
  for (int i = tid; i < BF_TL * HALF; i += blockDim.x) {
    const int r = i / HALF, c = (i - r * HALF) * 2;
    const int l = l0 + r;
    if (l >= L) continue;
    const long long row = (long long)n * L + l;
    const long long off = row * C + col0 + c;
    float r0 = 0.f, r1 = 0.f;
    if (res) {
      const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + off);
      r0 = __low2float(rv);
      r1 = __high2float(rv);
    }
    const float y0 = epilogue(os[r * os_ld + c], p, col0 + c, row, r0);
    const float y1 = epilogue(os[r * os_ld + c + 1], p, col0 + c + 1, row, r1);
    *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(y0, y1);
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

template <int NT>
cudaError_t launch_bf16(const Params& p, int n_rows, cudaStream_t stream) {
  constexpr int CB = 16 * NT;
  const int l_tiles = (p.L + BF_TL - 1) / BF_TL;
  const size_t tiles = (size_t)(BF_TL + p.K - 1) * (p.C + PAD_BF) * 2 +
                       (size_t)p.C * (CB + PAD_BF) * 2;
  const size_t staging = (size_t)BF_TL * (CB + PAD_F) * 4;
  const size_t smem = tiles > staging ? tiles : staging;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bf16_wmma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(n_rows * l_tiles), (unsigned)(p.C / CB));
  conv_bf16_wmma<NT><<<grid, BF_WARPS * 32, smem, stream>>>(p, l_tiles);
  return cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
// C must be a multiple of 16 and either at most 128 or a multiple of 128.
extern "C" int jt_fused_conv_block(int dtype, const void* x, const void* w,
                                   const void* bias, const void* dyt,
                                   const void* in_mask, const void* out_mask,
                                   const void* residual, void* out, int n_rows,
                                   int L, int C, int K, int act, void* stream) {
  if (n_rows <= 0 || L <= 0 || K <= 0 || C <= 0 || C % 16 != 0 ||
      (C > 128 && C % 128 != 0))
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
  if (dtype == 0) return (int)launch_f32(p, n_rows, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch ((C <= 128 ? C : 128) / 16) {
    case 1: return (int)launch_bf16<1>(p, n_rows, s);
    case 2: return (int)launch_bf16<2>(p, n_rows, s);
    case 3: return (int)launch_bf16<3>(p, n_rows, s);
    case 4: return (int)launch_bf16<4>(p, n_rows, s);
    case 5: return (int)launch_bf16<5>(p, n_rows, s);
    case 6: return (int)launch_bf16<6>(p, n_rows, s);
    case 7: return (int)launch_bf16<7>(p, n_rows, s);
    default: return (int)launch_bf16<8>(p, n_rows, s);
  }
}
