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
// * dequant (x bf16 or f32): x is quantized as it is loaded into shared
//   memory, q = clip(rint(f32(x) * inv_act), -127, 127), so no int8 copy of
//   the activation reaches device memory; the epilogue computes
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
// This first version is the simple one. One CTA of 8 warps computes 128
// output positions of one row for a block of CB output channels. It stages
// the input tile plus its d(K-1) halo in shared memory (quantized on the
// way in), and as many taps of w as fit (all K at the flagship shape),
// transposed to (C_out, C_in) so that every mma operand is one 32-bit
// shared-memory load. Each warp runs mma.sync m16n8k32 (k16 for a C_in tail
// of 16) over its 16 positions and all CB channels and applies the epilogue
// straight from its accumulator registers. wgmma, TMA loads, a multi-stage
// ring and a persistent schedule are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (jaeger_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ACT_NONE = 0;
constexpr int ACT_RELU = 1;
constexpr int ACT_TANH = 2;
constexpr int ACT_GELU = 3;       // exact erf form
constexpr int ACT_GELU_TANH = 4;  // tanh approximation

constexpr int TL = 128;    // output positions per CTA
constexpr int WARPS = 8;   // 16 positions per warp
constexpr int PAD = 16;    // shared-memory row padding, bytes
constexpr int SMEM_TARGET = 112 * 1024;  // two CTAs per SM when it fits

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

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

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

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
    const uint32_t v0 = ld32(src), v1 = ld32(src + p.C_out),
                   v2 = ld32(src + 2 * p.C_out), v3 = ld32(src + 3 * p.C_out);
    const uint32_t t0 = __byte_perm(v0, v1, 0x5140), t1 = __byte_perm(v2, v3, 0x5140);
    const uint32_t t2 = __byte_perm(v0, v1, 0x7362), t3 = __byte_perm(v2, v3, 0x7362);
    int8_t* dst = ws + (jj * CB + 4 * n4) * ld + 4 * c4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + ld) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * ld) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * ld) = __byte_perm(t2, t3, 0x7632);
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
__global__ void __launch_bounds__(WARPS * 32)
int8_conv_mma(Params p, int l_tiles) {
  constexpr int CB = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = p.C_in + PAD;
  const int span = p.dil * (p.K - 1);
  const int rows_in = TL + span;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* ws = xs + ((rows_in * ld + 15) & ~15);

  const int n = blockIdx.x / l_tiles;
  const int l0 = (blockIdx.x % l_tiles) * TL;
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

template <typename T, int NT>
cudaError_t launch(Params p, int n_rows, cudaStream_t stream) {
  constexpr int CB = 8 * NT;
  const int ld = p.C_in + PAD;
  const size_t xs_bytes =
      ((size_t)(TL + p.dil * (p.K - 1)) * ld + 15) & ~(size_t)15;
  const size_t tap_bytes = (size_t)CB * ld;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (xs_bytes + tap_bytes > (size_t)optin) return cudaErrorInvalidValue;
  const size_t budget =
      xs_bytes + tap_bytes <= (size_t)SMEM_TARGET ? SMEM_TARGET : optin;
  int tps = (int)((budget - xs_bytes) / tap_bytes);
  p.taps_per_stage = tps < p.K ? tps : p.K;
  const size_t smem = xs_bytes + (size_t)p.taps_per_stage * tap_bytes;
  e = cudaFuncSetAttribute(int8_conv_mma<T, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int l_tiles = (p.L_out + TL - 1) / TL;
  const dim3 grid((unsigned)((long long)n_rows * l_tiles), (unsigned)(p.C_out / CB));
  int8_conv_mma<T, NT><<<grid, WARPS * 32, smem, stream>>>(p, l_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cb(const Params& p, int n_rows, cudaStream_t s) {
  // the widest channel block of 128, 64, 32 or 16 that divides C_out
  if (p.C_out % 128 == 0) return launch<T, 16>(p, n_rows, s);
  if (p.C_out % 64 == 0) return launch<T, 8>(p, n_rows, s);
  if (p.C_out % 32 == 0) return launch<T, 4>(p, n_rows, s);
  return launch<T, 2>(p, n_rows, s);
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (dequant form), 2 = int8 (requant
// form). C_in and C_out must be multiples of 16. Returns a cudaError_t
// (0 = success).
extern "C" int jt_int8_conv(int in_dtype, const void* x, const void* w,
                            const void* scale, const void* inv_act,
                            const void* bias, const void* dyt,
                            const void* in_mask, const void* out_mask,
                            const void* residual, void* out, int n_rows, int L,
                            int L_out, int C_in, int C_out, int K, int dil,
                            int pad_l, int act, void* stream) {
  if (n_rows <= 0 || L <= 0 || L_out <= 0 || K <= 0 || dil <= 0 || pad_l < 0 ||
      C_in <= 0 || C_out <= 0 || C_in % 16 != 0 || C_out % 16 != 0)
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
  switch (in_dtype) {
    case 0: return (int)launch_cb<float>(p, n_rows, s);
    case 1: return (int)launch_cb<__nv_bfloat16>(p, n_rows, s);
    case 2: return (int)launch_cb<int8_t>(p, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
