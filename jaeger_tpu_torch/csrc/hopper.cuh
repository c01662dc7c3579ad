// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor maps and loads, 1-D bulk copies, wgmma descriptors (K-major and
// MN-major) and instructions (bf16 and s8, A from registers), ldmatrix,
// cp.async.
//
// Header only; each helper is a thin wrapper around one PTX instruction
// (or, on the host, one driver call), so a kernel reads as the sequence of
// hardware operations it issues. The host side gets cuTensorMapEncodeTiled
// through the runtime's driver entry point, so a library that includes this
// header needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory addresses, fences, mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes mbarrier.init visible to the other threads and to the TMA unit
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also tells the barrier to wait for `bytes` of TMA data
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// spins until the barrier's current phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// named barrier `id` (1-15) over `threads` threads: wait for all of them, or
// only count this warp's arrival
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// moves registers between warpgroups: the calling warpgroup drops to, or
// rises to, N registers a thread (all its warps execute it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// 3-D tiled load of one box at (c0, c1, c2) into shared memory; completion
// is reported to `bar` as transaction bytes. Coordinates may be negative or
// past the end: those elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 3-D tiled store of one box from shared memory to (c0, c1, c2); elements
// outside the tensor are not written. Tracked by the bulk async-group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// an L2 policy that evicts the lines it covers first (data read once)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory under the L2 cache policy `policy`
// (l2_evict_first); completion is reported to `bar` as transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N committed bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from global to shared memory (both 16-byte aligned), cached in
// L2 only; tracked by this thread's cp.async groups
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// the same, or 16 zero bytes when `valid` is false (src is then not read:
// a row outside the tensor or masked out)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// asks L2 to fetch the line of `p` (global memory)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed cp.async groups are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the TMA swizzle of a byte offset inside a 1024-byte aligned region whose
// rows are `row_bytes` = 32, 64 or 128 wide (CU_TENSOR_MAP_SWIZZLE_32B /
// 64B / 128B): the 16-byte chunk index is XORed with bits 7.. of the offset
// (16-byte rows: unchanged)
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t row_bytes) {
  const uint32_t mask = row_bytes / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// rows of 16 bytes are one 16-byte unit: nothing to swizzle
inline CUtensorMapSwizzle swizzle_mode(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                           : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A (d2, d1, d0) row-major tensor (d0 contiguous) of `type` elements of
// `esize` bytes cut into boxes of (1, box1, box0) elements, box0 * esize
// bytes wide and swizzled to that width (16, 32, 64 or 128 bytes).
// Elements outside the tensor load as zeros. Returns false on failure.
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                      uint32_t esize, const void* base, uint64_t d0,
                      uint64_t d1, uint64_t d2, uint32_t box0, uint32_t box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * esize, d0 * d1 * esize};  // bytes
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode((int)(box0 * esize)),
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint32_t box0,
                           uint32_t box1) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d0, d1, d2,
                   box0, box1);
}

// int8 data: TMA moves bytes, and its zero fill is the int8 zero
inline bool encode_s8_3d(CUtensorMap* map, const void* base, uint64_t d0,
                         uint64_t d1, uint64_t d2, uint32_t box0,
                         uint32_t box1) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, d0, d1, d2,
                   box0, box1);
}

// ---------------------------------------------------------------------------
// ldmatrix, wgmma
// ---------------------------------------------------------------------------

// four 8x8 b16 matrices; lane i supplies the row address of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed: lane i's register j holds the elements
// (2 (i % 4), 2 (i % 4) + 1) of column i / 4 of matrix j, as stored
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Shared-memory matrix descriptor of a K-major operand whose rows are
// `row_bytes` = 32, 64 or 128 wide and swizzled to that width (the layout a
// TMA load with the same swizzle writes): start address, leading byte offset
// 1 (unused when a k16 slice lies inside one swizzled row), stride byte
// offset = 8 rows, layout type 1 / 2 / 3 for 128 / 64 / 32-byte swizzle.
// Stepping along K inside a row adds (bytes >> 4) to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// Descriptor of an MN-major operand (N contiguous, K the row axis: rows of
// `row_bytes` = 64 or 128 bytes of N elements, swizzled to that width as a
// TMA load with the same swizzle writes them): leading byte offset =
// `atom_stride` bytes from one row_bytes-wide block of N to the next (used
// when N spans more than one block), stride byte offset = 8 rows (the next
// group of 8 K), layout type 1 / 2 for 128 / 64-byte swizzle. Stepping 16 K
// (rows) adds 16 * row_bytes bytes. For the 16-bit types with the
// transpose bit set (wgmma_bf16_rs_mn).
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr,
                                                 uint32_t row_bytes,
                                                 uint32_t atom_stride) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((atom_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma instructions that own them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the same for register A fragments: keeps them live, so that the register
// allocator does not reuse them, until the wgmma_wait that retires their
// readers (else ptxas serializes every wgmma, warning C7513)
template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int t = 0; t < S; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[t][i])::"memory");
}

// d (64 x N, f32) (+)= a (64 x 16 bf16, registers: the mma.sync m16n8k16
// A fragment of each warp's 16 rows) * b (16 x N bf16, K-major descriptor);
// scale_d = 0 overwrites d. N = 2 * R.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %13, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// The same products with B MN-major (smem_desc_mn: the transpose bit set):
// d (64 x N, f32) += a (64 x 16 bf16, registers) * b (16 x N bf16, stored
// 16 rows of N contiguous elements); scale_d = 0 overwrites d. N = 2 * R.
__device__ __forceinline__ void wgmma_bf16_rs_mn(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_rs_mn(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_rs_mn(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// d (64 x N, s32) (+)= a (64 x 32 s8, registers: the mma.sync m16n8k32 A
// fragment of each warp's 16 rows, which a b16 ldmatrix_x4 of 32-byte row
// slices gives as it is) * b (32 x N s8, K-major descriptor; 8-bit types
// have no transpose); scale_d = 0 overwrites d. N = 2 * R.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs(int (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// The same product that overwrites d (scale_d = 0) and reads none of it:
// d is an output only, so its registers hold nothing live before the first
// wgmma of a tile (the epilogue's last read of them ends their life); early
// clobbers, so that no input shares a register with d, which the
// asynchronous product writes while it may still read a.

__device__ __forceinline__ void wgmma_s8_rs_first(int (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %13, p;\n}\n"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]),
        "=&r"(d[6]), "=&r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(0), "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs_first(int (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p;\n}\n"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]),
        "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]), "=&r"(d[10]), "=&r"(d[11]),
        "=&r"(d[12]), "=&r"(d[13]), "=&r"(d[14]), "=&r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(0), "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs_first(int (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p;\n}\n"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]),
        "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]), "=&r"(d[10]), "=&r"(d[11]),
        "=&r"(d[12]), "=&r"(d[13]), "=&r"(d[14]), "=&r"(d[15]), "=&r"(d[16]), "=&r"(d[17]),
        "=&r"(d[18]), "=&r"(d[19]), "=&r"(d[20]), "=&r"(d[21]), "=&r"(d[22]), "=&r"(d[23]),
        "=&r"(d[24]), "=&r"(d[25]), "=&r"(d[26]), "=&r"(d[27]), "=&r"(d[28]), "=&r"(d[29]),
        "=&r"(d[30]), "=&r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(0), "l"(desc));
}

__device__ __forceinline__ void wgmma_s8_rs_first(int (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p;\n}\n"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]),
        "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]), "=&r"(d[10]), "=&r"(d[11]),
        "=&r"(d[12]), "=&r"(d[13]), "=&r"(d[14]), "=&r"(d[15]), "=&r"(d[16]), "=&r"(d[17]),
        "=&r"(d[18]), "=&r"(d[19]), "=&r"(d[20]), "=&r"(d[21]), "=&r"(d[22]), "=&r"(d[23]),
        "=&r"(d[24]), "=&r"(d[25]), "=&r"(d[26]), "=&r"(d[27]), "=&r"(d[28]), "=&r"(d[29]),
        "=&r"(d[30]), "=&r"(d[31]), "=&r"(d[32]), "=&r"(d[33]), "=&r"(d[34]), "=&r"(d[35]),
        "=&r"(d[36]), "=&r"(d[37]), "=&r"(d[38]), "=&r"(d[39]), "=&r"(d[40]), "=&r"(d[41]),
        "=&r"(d[42]), "=&r"(d[43]), "=&r"(d[44]), "=&r"(d[45]), "=&r"(d[46]), "=&r"(d[47]),
        "=&r"(d[48]), "=&r"(d[49]), "=&r"(d[50]), "=&r"(d[51]), "=&r"(d[52]), "=&r"(d[53]),
        "=&r"(d[54]), "=&r"(d[55]), "=&r"(d[56]), "=&r"(d[57]), "=&r"(d[58]), "=&r"(d[59]),
        "=&r"(d[60]), "=&r"(d[61]), "=&r"(d[62]), "=&r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(0), "l"(desc));
}

}  // namespace hopper
