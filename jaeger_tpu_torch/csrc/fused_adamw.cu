// fused_adamw: the Keras-form Adam / AdamW update of a train step over all
// of its leaves, in two launches.
//
// Replaces no Pallas kernel: the JAX package's update is optax's chain in
// jaeger_tpu/train/optimizers.py (clip_by_norm per leaf, then Keras Adam /
// AdamW), which XLA fuses into a few loops. The port's plain version is
// Optimizer.update in jaeger_tpu_torch/train/optimizers.py, leaf by leaf
// (about 25 small launches a leaf and one blocking copy of a CPU scalar per
// leaf); this kernel exists because that walk, not the card, set the train
// step's pace. For each leaf, with ss its gradient's sum of squares and m the
// clip norm:
//
//   g' = g * (m / max(sqrt(ss), m))          (rcp(max(...)) * m, as torch)
//   mu = b1 mu + (1 - b1) g'     nu = b2 nu + (1 - b2) g'^2
//   u  = alpha mu / (sqrt(nu) + eps) + wd p       p += u * (-lr)
//
// and the step's gradient norm sqrt(sum over leaves of ss), the leaves
// added in flax order (optax.global_norm of the unclipped gradients).
//
// What bounds it on the H100: bytes. The flagship's 684,629 f32 parameters:
// read p, g, mu, nu, write p, mu, nu: 19.2 MB, 5.7 us at 3.35 TB/s. The two
// launches cost about as much again.
//
// Design:
//  * The leaf table (p, g, mu, nu, size, first chunk) is the kernels'
//    parameter block, passed by value (__grid_constant__: read in place,
//    never copied to local memory): no copy to the card before a launch. At
//    most MAX_LEAVES leaves fit the 4 KB block; the wrapper
//    (ops/fused_adamw.py::leaf_tables) cuts more into several tables, in
//    flax order, each launched as the pair below.
//  * A leaf is cut into chunks of CHUNK elements, one block a chunk.
//    Launch 1 (adamw_sumsq) writes each chunk's sum of squares of g and
//    whether it is its leaf's last chunk to a scratch slot of its own: no
//    atomics. Launch 2 (adamw_update) adds its leaf's slots in chunk order,
//    forms the clip factor and updates its chunk in place; one extra block
//    of the last table's launch adds every slot of the step, leaf by leaf
//    in flax order, into the gradient norm. Every sum has one fixed order:
//    the same bits run to run.
//  * Every operation is written with __fmul_rn / __fadd_rn / __fdiv_rn /
//    __fsqrt_rn, which the compiler never contracts into an FMA, so each
//    rounding is the one an eager torch op on the card makes: where no
//    clip engages (or none is set) the result is the per-leaf update's bits;
//    where it does, the factor's sum of squares is added in another order
//    than torch.sum's and the results differ by a few ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;          // elements a block
constexpr int MAX_LEAVES = 80;       // leaves a table (4 KB parameter block)

constexpr int FLAG_CLIP = 1;         // clip each leaf to norm `clip`
constexpr int FLAG_DECAY = 2;        // add wd * p (AdamW)
constexpr int FLAG_NORM = 4;         // this table's launch 2 writes the norm

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  long long n;      // elements
  int chunk0;       // first chunk, counted over the step's tables
  int chunks;       // ceil(n / CHUNK)
};

struct Table {
  float lr;         // the update is u * (-lr)
  float alpha;      // sqrt(1 - b2^t) / (1 - b1^t)
  float b1;
  float c1;         // 1 - b1, rounded from double
  float b2;
  float c2;         // 1 - b2, rounded from double
  float eps;
  float wd;
  float clip;
  int flags;
  int leaves;       // leaves in this table
  int chunks;       // chunks of this table's leaves
  int chunk0;       // the first leaf's chunk0
  int total_chunks; // chunks of the step (the norm block's walk)
  float2* partials; // (total_chunks,): sum of squares, last-chunk flag
  float* norm;      // () f32: the gradient norm
  Leaf leaf[MAX_LEAVES];
};

static_assert(sizeof(Leaf) == 48, "Leaf layout");
static_assert(sizeof(Table) <= 4096, "the table must fit a parameter block");

// The leaf holding chunk `c` of this table (its chunks are contiguous, in
// leaf order); every thread of a block asks with the same c.
__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int li = 0;
  while (li + 1 < t.leaves && t.leaf[li + 1].chunk0 - t.chunk0 <= c) ++li;
  return li;
}

// The block's sum of v in one fixed order: a butterfly within each warp,
// then the warps' sums in warp order. Returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) sh[warp] = v;
  __syncthreads();
  float s = sh[0];
  for (int w = 1; w < THREADS / 32; ++w) s = __fadd_rn(s, sh[w]);
  return s;
}

__global__ void __launch_bounds__(THREADS)
adamw_sumsq(const __grid_constant__ Table t) {
  __shared__ float sh[THREADS / 32];
  const int c = blockIdx.x;
  const Leaf& L = t.leaf[leaf_of(t, c)];
  const int k = c + t.chunk0 - L.chunk0;
  const long long begin = (long long)k * CHUNK;
  const long long end = min(begin + CHUNK, L.n);
  float acc = 0.f;
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    const float g = L.g[i];
    acc = __fadd_rn(acc, __fmul_rn(g, g));
  }
  const float ss = block_sum(acc, sh);
  if (threadIdx.x == 0)
    t.partials[t.chunk0 + c] = make_float2(ss, k == L.chunks - 1 ? 1.f : 0.f);
}

// Thread 0's sum, in order, of `count` slots from `first`; the block stages
// them in shared memory THREADS at a time. `leaf_ends` adds the slots leaf
// by leaf (a leaf's slots first, then the leaf's sum into the total).
__device__ float ordered_sum(const float2* partials, int first, int count,
                             bool leaf_ends, float2* sh) {
  float total = 0.f, leaf = 0.f;
  for (int base = 0; base < count; base += THREADS) {
    __syncthreads();
    if (base + (int)threadIdx.x < count)
      sh[threadIdx.x] = partials[first + base + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = min(THREADS, count - base);
      for (int j = 0; j < n; ++j) {
        leaf = __fadd_rn(leaf, sh[j].x);
        if (leaf_ends && sh[j].y != 0.f) {
          total = __fadd_rn(total, leaf);
          leaf = 0.f;
        }
      }
    }
  }
  return leaf_ends ? total : leaf;
}

__global__ void __launch_bounds__(THREADS)
adamw_update(const __grid_constant__ Table t) {
  __shared__ float2 sh[THREADS];
  __shared__ float scale;
  const int c = blockIdx.x;
  if (c == t.chunks) {              // the norm block (FLAG_NORM only)
    const float total = ordered_sum(t.partials, 0, t.total_chunks, true, sh);
    if (threadIdx.x == 0) *t.norm = __fsqrt_rn(total);
    return;
  }
  const Leaf& L = t.leaf[leaf_of(t, c)];
  const int k = c + t.chunk0 - L.chunk0;
  const bool clip = t.flags & FLAG_CLIP;
  if (clip) {
    const float ss = ordered_sum(t.partials, L.chunk0, L.chunks, false, sh);
    if (threadIdx.x == 0) {
      // torch: m / clamp_min(sqrt(ss), m) is reciprocal(clamp) * m, and
      // clamp_min passes a NaN through
      const float n = __fsqrt_rn(ss);
      const float d = (n != n || n > t.clip) ? n : t.clip;
      scale = __fmul_rn(__fdiv_rn(1.f, d), t.clip);
    }
    __syncthreads();
  }
  const bool decay = t.flags & FLAG_DECAY;
  const float s = clip ? scale : 1.f;
  const float neg_lr = -t.lr;
  const long long begin = (long long)k * CHUNK;
  const long long end = min(begin + CHUNK, L.n);
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    float g = L.g[i];
    if (clip) g = __fmul_rn(g, s);
    const float m = __fadd_rn(__fmul_rn(L.mu[i], t.b1), __fmul_rn(g, t.c1));
    const float v = __fadd_rn(__fmul_rn(L.nu[i], t.b2),
                              __fmul_rn(__fmul_rn(g, g), t.c2));
    const float p = L.p[i];
    float u = __fdiv_rn(__fmul_rn(t.alpha, m),
                        __fadd_rn(__fsqrt_rn(v), t.eps));
    if (decay) u = __fadd_rn(u, __fmul_rn(p, t.wd));
    L.mu[i] = m;
    L.nu[i] = v;
    L.p[i] = __fadd_rn(p, __fmul_rn(u, neg_lr));
  }
}

}  // namespace

// sizeof(Table): the wrapper's ctypes layout must have the same size.
extern "C" int jt_fused_adamw_table_bytes() { return (int)sizeof(Table); }

// One table's launch pair on `stream`. `table` points at a host Table of
// `table_bytes` bytes (refused unless sizeof(Table)); returns the first
// CUDA error of the two launches, or cudaErrorInvalidValue for a table the
// kernels cannot take.
extern "C" int jt_fused_adamw(const void* table, int table_bytes,
                              void* stream) {
  if (table == nullptr || table_bytes != (int)sizeof(Table))
    return (int)cudaErrorInvalidValue;
  const Table& t = *static_cast<const Table*>(table);
  if (t.leaves < 1 || t.leaves > MAX_LEAVES || t.chunks < 1 ||
      t.chunk0 < 0 || t.chunk0 + t.chunks > t.total_chunks ||
      t.partials == nullptr || ((t.flags & FLAG_NORM) && t.norm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adamw_sumsq<<<t.chunks, THREADS, 0, s>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw_update<<<t.chunks + ((t.flags & FLAG_NORM) ? 1 : 0), THREADS, 0, s>>>(t);
  return (int)cudaGetLastError();
}
