// conv_epilogue_bwd: the backward of the fused conv block's epilogue.
//
// Part of the backward of jaeger_tpu/ops/pallas_conv.py::fused_conv_block
// (the Pallas kernel has no VJP; JAX trains its convs through XLA). The
// forward's epilogue is s = o * (g * tanh(a * u) + be) + r, y = act(s) (DYT
// form; without DYT s = o * u + r), with o the out mask. From dy, u, r and
// o, with t = tanh(a * u) and ds = dy * act'(s), one pass writes
//
//   dr = ds        du = o * ds * g * a * (1 - t^2)   (without DYT: o * ds)
//
// in dy's type and the per-channel f32 sums da = sum o ds g u (1 - t^2),
// dg = sum o ds t, dbe = sum o ds.
//
// What bounds it on the H100: bytes. At the train shape (N * L = 768,000
// rows, C = 128, bf16) the conv2 form reads dy, u, r and writes du, dr:
// 983 MB, 0.294 ms at 3.35 TB/s; the conv1 form (no residual) 590 MB,
// 0.176 ms. The arithmetic (two tanh an element with gelu_tanh) has to hide
// under the stream.
//
// Design:
//  * Persistent: about two CTAs per SM, each on a contiguous range of row
//    chunks (R rows, R * row bytes <= 8 KB); the chunks are cut in the
//    wrapper's plan (ops/fused_conv_grad.py::epilogue_plan), which the entry
//    below recomputes and refuses when it disagrees.
//  * A producer warp's one thread streams each chunk's dy, u (and r) rows,
//    contiguous in (N * L, C), into a ring of 4 stages with 1-D bulk copies
//    (cp.async.bulk, completion on the stage's full mbarrier): nothing
//    spends registers or instructions on the loads, and up to 4 chunks are
//    in flight per CTA. The loads carry an L2 evict-first policy and du, dr
//    go out as streaming stores (st.global.cs): every byte passes once, and
//    the hints took the conv2 form from 0.38-0.40 to 0.37 ms.
//  * 8 consumer warps: thread t owns the 4-channel column vector t % V of a
//    row (V = C / 4; 16 bytes of f32, 8 of bf16) and rows t / V, + 256 / V,
//    ... of each chunk, so its channels never change: alpha, gamma, beta
//    stay in registers and so do its partial sums (4 channels, not 8: at
//    two CTAs an SM ptxas allows 96 registers, and 8 bf16 channels
//    spilled). Its out-mask bits for the chunk are loaded before it waits
//    for the chunk. It reads its vectors from shared memory (neighbouring
//    threads, neighbouring vectors: no bank conflicts) and writes du and dr
//    with one vector store each.
//  * The pass is bound by instruction issue as much as by bytes (the old
//    Triton pass took 0.66 ms for 590 MB and 0.70 ms for 983 MB), so the
//    arithmetic is cut: tanh is 1 - 2 / (2^x2 + 1) as ex2, add, rcp and
//    one fma (about 2e-7 absolute, exact at both ends; the old pass took an
//    IEEE division), with x2's constants folded per channel (2 alpha log2 e)
//    or into the polynomial (gelu_tanh); it feeds the f32 sums over all rows
//    as well as du, so tanh.approx (2^-11 relative) is not used.
//  * Sums: per CTA, the row groups' partials are added in group order
//    through shared memory and written to the CTA's slot; a second kernel in
//    the same entry adds the slots in CTA order. No float atomics: the same
//    bits run to run.

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

constexpr int CONSUMERS = 256;                 // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp
constexpr int MAX_CHUNK_BYTES = 8192;          // R * row bytes
constexpr int STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

struct Params {
  const void* dy;          // (rows, C)
  const void* u;           // (rows, C)
  const void* r;           // (rows, C) or null
  const uint8_t* om;       // (rows,) or null
  const float* dyt;        // (3, C): alpha, gamma, beta, or null
  void* du;                // (rows, C)
  void* dr;                // (rows, C) or null
  float* part;             // (ctas, 3, C) when dyt
  long long rows;
  int C;
};

struct Layout {
  int R;             // rows per chunk
  int ntens;         // 2 + (residual)
  int row_bytes;
  long long chunks;
  uint32_t stage, off_bar, bytes;
};

// false if the shape cannot take this plan
bool make_layout(long long rows, int C, int esize, bool has_r, int R,
                 int stages, Layout* lay) {
  if (C <= 0 || C % 16 || rows <= 0 || stages != STAGES) return false;
  const int row_bytes = C * esize;
  if (C / 4 > CONSUMERS) return false;  // V = C / 4 vectors a row <= 256
  int want = 64;  // the largest power of two <= 64 with R * row bytes <= 8 KB
  while (want > 1 && want * row_bytes > MAX_CHUNK_BYTES) want /= 2;
  if (R != want) return false;
  lay->R = R;
  lay->ntens = has_r ? 3 : 2;
  lay->row_bytes = row_bytes;
  lay->chunks = (rows + R - 1) / R;
  lay->stage = (uint32_t)lay->ntens * R * row_bytes;
  lay->off_bar = stages * lay->stage;
  // after the last chunk the ring (and the barriers) take the row groups'
  // partial sums: 3 x (256 / V) x C f32
  const uint32_t red = 3u * (CONSUMERS / (C / 4)) * C * 4;
  lay->bytes = lay->off_bar + 16u * stages;
  if (lay->bytes < red) lay->bytes = red;
  return lay->bytes <= (uint32_t)SMEM_LIMIT;
}

constexpr float TWO_LOG2E = 2.8853900817779268f;  // 2 / ln 2
constexpr float GELU_C = 0.7978845608028654f;      // sqrt(2 / pi)

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1) from x2 = 2 x log2 e: ex2, add,
// rcp, fma (about 2e-7 absolute); 2^x2 overflows to inf (-> 1) and to 0
// (-> -1) at the ends
__device__ __forceinline__ float tanh_x2(float x2) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x2));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

template <int ACT>
__device__ __forceinline__ float act_grad(float s) {
  if (ACT == ACT_RELU) return s > 0.f ? 1.f : 0.f;
  if (ACT == ACT_TANH) {
    const float th = tanh_x2(TWO_LOG2E * s);
    return fmaf(-th, th, 1.f);
  }
  if (ACT == ACT_GELU)
    return 0.5f * (1.f + erff(s * 0.7071067811865476f)) +
           s * __expf(-0.5f * s * s) * 0.3989422804014327f;
  if (ACT == ACT_GELU_TANH) {
    // z = tanh(c (s + 0.044715 s^3));
    // d = (1 + z) / 2 + s (1 - z^2) c (1 + 3 * 0.044715 s^2) / 2
    const float s2 = s * s;
    const float z = tanh_x2(
        s * fmaf(TWO_LOG2E * GELU_C * 0.044715f, s2, TWO_LOG2E * GELU_C));
    const float q = s * fmaf(0.5f * GELU_C * 0.134145f, s2, 0.5f * GELU_C);
    return fmaf(q, fmaf(-z, z, 1.f), fmaf(0.5f, z, 0.5f));
  }
  return 1.f;
}

// a thread's vector of 4 channels (16 bytes of f32, 8 of bf16) <-> floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using VT = uint4;
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  using VT = uint2;
  __device__ static void unpack(const uint2& v, float (&f)[4]) {
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // bf16 -> f32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint2 pack(const float (&f)[4]) {
    uint32_t w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint2(w[0], w[1]);
  }
};

template <typename T, int ACT, bool DYT>
__global__ void __launch_bounds__(THREADS, 2)
conv_epilogue_bwd(Params p, Layout lay) {
  using namespace hopper;
  using VT = typename Vec<T>::VT;
  constexpr int E = 4;                    // channels a vector
  constexpr int VB = sizeof(VT);          // its bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const uint32_t bar = sb + lay.off_bar;
  const int tid = threadIdx.x;
  const int R = lay.R;
  const long long c_begin = lay.chunks * blockIdx.x / gridDim.x;
  const int n_local =
      (int)(lay.chunks * (blockIdx.x + 1) / gridDim.x - c_begin);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);                      // full: expect_tx
      mbar_init(bar + 8 * (STAGES + s), CONSUMERS / 32);  // empty: each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- one thread streams the chunks into the ring ----
    if (tid == CONSUMERS) {
      const unsigned char* src[3] = {
          static_cast<const unsigned char*>(p.dy),
          static_cast<const unsigned char*>(p.u),
          static_cast<const unsigned char*>(p.r)};
      const uint64_t once = l2_evict_first();  // every byte is read once
      for (int i = 0; i < n_local; ++i) {
        const int s = i % STAGES;
        const long long r0 = (c_begin + i) * R;
        const long long nr = p.rows - r0 < R ? p.rows - r0 : R;
        const uint32_t bytes = (uint32_t)(nr * lay.row_bytes);
        mbar_wait(bar + 8 * (STAGES + s), ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar + 8 * s, lay.ntens * bytes);
        for (int k = 0; k < lay.ntens; ++k)
          bulk_load(sb + s * lay.stage + k * R * lay.row_bytes,
                    src[k] + r0 * lay.row_bytes, bytes, bar + 8 * s, once);
      }
    }
    return;
  }

  // ---- consumers: column vector vc of rows rg, rg + RG, ... ----
  const int C = p.C;
  const int V = C / E;
  const int RG = CONSUMERS / V;
  const int vc = tid % V, rg = tid / V;
  const bool active = rg < RG;
  const bool has_r = p.r != nullptr;
  const int c0 = vc * E;
  // alpha, 2 alpha log2 e (tanh's ex2 argument), gamma, beta; the sums
  float al[E], al2[E], ga[E], be[E], sa[E], sg[E], sbe[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    al[e] = al2[e] = ga[e] = be[e] = sa[e] = sg[e] = sbe[e] = 0.f;
    if (DYT && active) {
      al[e] = p.dyt[c0 + e];
      al2[e] = TWO_LOG2E * al[e];
      ga[e] = p.dyt[C + c0 + e];
      be[e] = p.dyt[2 * C + c0 + e];
    }
  }
  T* du = static_cast<T*>(p.du);
  T* dr = static_cast<T*>(p.dr);

  for (int i = 0; i < n_local; ++i) {
    const int s = i % STAGES;
    const long long r0 = (c_begin + i) * R;
    const int nr = (int)(p.rows - r0 < R ? p.rows - r0 : R);
    // this thread's out-mask bits for the chunk, loaded before the wait
    // (loading them a chunk ahead cost more registers than it saved)
    uint32_t obits = ~0u;
    if (p.om != nullptr && active) {
      obits = 0;
      for (int r = rg, k = 0; r < nr; r += RG, ++k)
        obits |= (uint32_t)(__ldg(p.om + r0 + r) != 0) << k;
    }
    mbar_wait(bar + 8 * s, (i / STAGES) & 1);
    if (active) {
      const unsigned char* st = smem + s * lay.stage + vc * VB;
#pragma unroll 1  // one row's vectors live at a time: no spills at 2 CTAs
      for (int r = rg, k = 0; r < nr; r += RG, ++k) {
        const uint32_t off = r * lay.row_bytes;
        float fdy[E], fu[E], fr[E], fdu[E], fds[E];
        Vec<T>::unpack(*reinterpret_cast<const VT*>(st + off), fdy);
        Vec<T>::unpack(
            *reinterpret_cast<const VT*>(st + R * lay.row_bytes + off), fu);
        if (has_r)
          Vec<T>::unpack(
              *reinterpret_cast<const VT*>(st + 2 * R * lay.row_bytes + off),
              fr);
        const bool o = (obits >> k) & 1;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float v = fu[e];
          float t = 0.f, y = v;
          if (DYT) {
            t = tanh_x2(al2[e] * v);
            y = fmaf(ga[e], t, be[e]);
          }
          float sv = o ? y : 0.f;
          if (has_r) sv += fr[e];
          const float ds = fdy[e] * act_grad<ACT>(sv);
          const float ods = o ? ds : 0.f;
          fds[e] = ds;
          if (DYT) {
            const float g = ods * (ga[e] * fmaf(-t, t, 1.f));
            fdu[e] = g * al[e];
            sa[e] = fmaf(g, v, sa[e]);
            sg[e] = fmaf(ods, t, sg[e]);
            sbe[e] += ods;
          } else {
            fdu[e] = ods;
          }
        }
        const long long at = (r0 + r) * C + c0;
        // streaming stores: du and dr are read again only by later kernels
        __stcs(reinterpret_cast<VT*>(du + at), Vec<T>::pack(fdu));
        if (has_r) __stcs(reinterpret_cast<VT*>(dr + at), Vec<T>::pack(fds));
      }
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(bar + 8 * (STAGES + s));
  }

  if (DYT) {
    // the row groups' partials, added in group order; the ring and the
    // barriers are free (every chunk was consumed)
    float* red = reinterpret_cast<float*>(smem);
    named_bar_sync(1, CONSUMERS);
    if (active) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        red[(0 * RG + rg) * C + c0 + e] = sa[e];
        red[(1 * RG + rg) * C + c0 + e] = sg[e];
        red[(2 * RG + rg) * C + c0 + e] = sbe[e];
      }
    }
    named_bar_sync(1, CONSUMERS);
    for (int i = tid; i < 3 * C; i += CONSUMERS) {
      const int k = i / C, ch = i % C;
      float acc = 0.f;
      for (int g = 0; g < RG; ++g) acc += red[(k * RG + g) * C + ch];
      p.part[(long long)blockIdx.x * 3 * C + i] = acc;
    }
  }
}

// sums the partials over the CTAs, in CTA order
__global__ void reduce_parts(const float* part, float* out, int n, int parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += part[(long long)k * n + i];
  out[i] = s;
}

template <typename T, int ACT, bool DYT>
cudaError_t launch(const Params& p, const Layout& lay, int ctas,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_epilogue_bwd<T, ACT, DYT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (e != cudaSuccess) return e;
  conv_epilogue_bwd<T, ACT, DYT><<<ctas, THREADS, lay.bytes, stream>>>(p, lay);
  return cudaGetLastError();
}

template <typename T, bool DYT>
cudaError_t launch_act(const Params& p, const Layout& lay, int act, int ctas,
                       cudaStream_t s) {
  switch (act) {
    case ACT_NONE: return launch<T, ACT_NONE, DYT>(p, lay, ctas, s);
    case ACT_RELU: return launch<T, ACT_RELU, DYT>(p, lay, ctas, s);
    case ACT_TANH: return launch<T, ACT_TANH, DYT>(p, lay, ctas, s);
    case ACT_GELU: return launch<T, ACT_GELU, DYT>(p, lay, ctas, s);
    case ACT_GELU_TANH: return launch<T, ACT_GELU_TANH, DYT>(p, lay, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dy, u (and residual, du, dr) are (rows, C)
// in that type, out_mask (rows,) bytes or null, dyt (3, C) f32 or null;
// without a residual dr is null; with dyt, part (ctas, 3, C) is scratch and
// ddyt (3, C) receives the sums. The plan (rows_per_chunk, stages, ctas,
// smem_bytes) is ops/fused_conv_grad.py::epilogue_plan's and must equal the
// layout this file computes. act: 0 none, 1 relu, 2 tanh, 3 gelu (erf), 4
// gelu (tanh). Returns a cudaError_t (0 = success).
extern "C" int jt_conv_epilogue_bwd(int dtype, const void* dy, const void* u,
                                    const void* residual, const void* out_mask,
                                    const void* dyt, void* du, void* dr,
                                    void* part, void* ddyt, int rows, int C,
                                    int act, int rows_per_chunk, int stages,
                                    int ctas, int smem_bytes, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Layout lay;
  if (!make_layout(rows, C, dtype == 1 ? 2 : 4, residual != nullptr,
                   rows_per_chunk, stages, &lay) ||
      lay.bytes != (uint32_t)smem_bytes || ctas <= 0 || ctas > lay.chunks ||
      (residual != nullptr) != (dr != nullptr) ||
      (dyt != nullptr && (part == nullptr || ddyt == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.dy = dy;
  p.u = u;
  p.r = residual;
  p.om = static_cast<const uint8_t*>(out_mask);
  p.dyt = static_cast<const float*>(dyt);
  p.du = du;
  p.dr = dr;
  p.part = static_cast<float*>(part);
  p.rows = rows;
  p.C = C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1)
    e = dyt ? launch_act<__nv_bfloat16, true>(p, lay, act, ctas, s)
            : launch_act<__nv_bfloat16, false>(p, lay, act, ctas, s);
  else
    e = dyt ? launch_act<float, true>(p, lay, act, ctas, s)
            : launch_act<float, false>(p, lay, act, ctas, s);
  if (e != cudaSuccess || dyt == nullptr) return (int)e;
  reduce_parts<<<(3 * C + 255) / 256, 256, 0, s>>>(
      p.part, static_cast<float*>(ddyt), 3 * C, ctas);
  return (int)cudaGetLastError();
}
