// Hopper (sm_90a) building blocks for the hand-written kernels of csrc/:
// TMA tile loads and stores described by a CUtensorMap, mbarriers that
// count arrivals and the bytes a TMA load brings, and wgmma warpgroup
// products whose shared-memory operands are read through 64-bit matrix
// descriptors.  Raw PTX, as the rest of csrc/; a kernel including this
// header must be built for sm_90a (wgmma exists only there).
//
// Layout convention: every shared-memory tile that a wgmma reads was
// written by a TMA load with a 128-byte swizzle, as rows of 64 bf16
// (128 bytes), 8 rows to a 1024-byte swizzle atom; a tile wider than 64
// columns is several such boxes one after the other.  The descriptors
// below describe exactly that layout.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// after the inits, before any thread or the TMA unit uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to wait for `bytes` more bytes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed (the
// n-th completion has parity n & 1).  A phase that never completes (a
// load that never arrives) traps after about 20 s at the H100's clock
// instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 40000000000LL) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// a box of a 4-d tensor map into shared memory; completion (its bytes)
// is reported to `bar`.  Coordinates innermost first, in elements.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// a box from shared memory into a 4-d tensor map; elements outside the
// tensor are not written.  Call fence_proxy_async() and a barrier over
// the writing threads first, and tma_store_wait() before the shared
// memory is reused or the block exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// makes this thread's ordinary shared-memory writes visible to the TMA
// unit and to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed groups of this warpgroup still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: call it on
// the accumulators (and register A operands) before wgmma_fence and after
// wgmma_wait, so that the compiler neither reads them early nor reuses
// them while the product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Matrix descriptor of a tile written by a 128-byte-swizzled TMA load
// (layout type 1).  Offsets in bytes.
// - K-major operand (the reduction axis contiguous, as Q and K of
//   Q K^T): `sbo` = 1024, the stride of 8-row groups; `lbo` unused.  The
//   k-th 16-wide slice of a 64-column box starts 32 k bytes further.
// - MN-major operand (the output axis contiguous, as V in P V): `sbo` =
//   1024, the stride of 8-row groups along the reduction axis; `lbo` =
//   the stride of the 64-column boxes along N.  The k-th 16-row slice
//   starts 2048 k bytes further.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_byte_addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_byte_addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

#define HK_R32                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HK_R64                                                                          \
  HK_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HK_D8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HK_D32(d) HK_D8(d, 0), HK_D8(d, 8), HK_D8(d, 16), HK_D8(d, 24)
#define HK_D64(d) HK_D32(d), HK_D8(d, 32), HK_D8(d, 40), HK_D8(d, 48), HK_D8(d, 56)

// d (64 x N, f32) = A B + (scale_d ? d : 0), A (64 x 16) and B (16 x N)
// bf16 in shared memory; TA / TB = 1 for an MN-major A / B.  The
// accumulator fragment: warp w of the warpgroup holds rows 16w + lane/4
// (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]) of columns
// 8j + 2 (lane%4) and the next.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HK_R32
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : HK_D32(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HK_R64
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : HK_D64(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// d (64 x N, f32) = A B + (scale_d ? d : 0), A (64 x 16) bf16 in
// registers in the accumulator fragment's layout, packed in pairs: a[0]
// rows lane/4, columns 2 (lane%4) and the next; a[1] the same 8 rows
// further; a[2], a[3] the same 8 columns further.  B (16 x N) in shared
// memory, TB = 1 for MN-major.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HK_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HK_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HK_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HK_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
}

#undef HK_R32
#undef HK_R64
#undef HK_D8
#undef HK_D32
#undef HK_D64

// 2^x on the special-function unit (ex2.approx: relative error about
// 2^-22; results below 2^-126 flush to 0, and 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, found through cudart at
// run time: the libraries link cudart statically and not libcuda; null
// if the installed libcuda lacks it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over 4 dims (innermost first, `stride_bytes` of dims
// 1..3) read or written in boxes of `box` elements with the 128-byte
// swizzle; elements outside the tensor load as zeros.  The base must be
// 16-byte aligned, the strides multiples of 16 bytes and box[0] = 64.
// Returns false if cuTensorMapEncodeTiled refuses.
inline bool tensor_map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                          const uint64_t (&stride_bytes)[3], const uint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  cuuint64_t d[4], s[3];
  cuuint32_t bx[4];
  for (int i = 0; i < 4; ++i) d[i] = dims[i], bx[i] = box[i];
  for (int i = 0; i < 3; ++i) s[i] = stride_bytes[i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, s, bx,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
