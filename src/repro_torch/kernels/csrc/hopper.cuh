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
// below describe exactly that layout.  A head dim that is not a whole
// number of boxes (80, zamba2-2.7b's) is laid out as the next whole one
// (`box_cols`): its tensor maps keep the true inner extent, so TMA fills
// the columns past it with zeros on every load and drops them on every
// store.  MLA's q/k head dim 192 is laid out as 256, its v (`v_dim`) at
// 128.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The columns a head of head dim D takes in shared memory and in the
// products: whole 64-column boxes.  D 64, 128 and 256 are whole boxes;
// D 80 takes two boxes, as D 128 does: the boxes' columns 80-127 load as
// zeros (the tensor maps' inner extent is 80), so S = Q K^T and O += P V
// read zeros there, and a store drops them.  D 192 (MLA's q and k: 128
// + 64 rope columns) takes D 256's four boxes, of which three hold
// columns: the bodies load and store those three, S = Q K^T stops after
// its 12 k-steps, and the fourth box's columns enter only output
// columns that are never stored.  Fails to build at a head dim that no
// body is laid out for.
template <int D>
__host__ __device__ constexpr int box_cols() {
  static_assert(D == 64 || D == 80 || D == 128 || D == 192 || D == 256,
                "a head dim the bodies are laid out for: 64, 80, 128, 192 or 256");
  return D == 80 ? 128 : D == 192 ? 256 : D;
}

// v's head dim for q/k head dim D: D, except MLA's 192, whose v (and so
// o, dO and dv) has 128 columns
template <int D>
__host__ __device__ constexpr int v_dim() {
  return D == 192 ? 128 : D;
}

// the 64-column boxes that hold a row of D columns (the rest of a
// box_cols<D>() layout is never loaded or stored)
template <int D>
__host__ __device__ constexpr int data_boxes() {
  return (D + 63) / 64;
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

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory, both 16-byte aligned; completion (its bytes) is reported to `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
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

#define HK_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HK_R32                                                                            \
  HK_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
         "%31"
#define HK_R64                                                                          \
  HK_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HK_R128                                                                          \
  HK_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
         "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "   \
         "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
         "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "     \
         "%123, %124, %125, %126, %127"
#define HK_D8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HK_D16(d) HK_D8(d, 0), HK_D8(d, 8)
#define HK_D32(d) HK_D16(d), HK_D8(d, 16), HK_D8(d, 24)
#define HK_D64(d) HK_D32(d), HK_D8(d, 32), HK_D8(d, 40), HK_D8(d, 48), HK_D8(d, 56)
#define HK_D128(d)                                                                      \
  HK_D64(d), HK_D8(d, 64), HK_D8(d, 72), HK_D8(d, 80), HK_D8(d, 88), HK_D8(d, 96),      \
      HK_D8(d, 104), HK_D8(d, 112), HK_D8(d, 120)

// d (64 x N, f32) = A B + (scale_d ? d : 0), A (64 x 16) and B (16 x N)
// bf16 in shared memory; TA / TB = 1 for an MN-major A / B.  The
// accumulator fragment: warp w of the warpgroup holds rows 16w + lane/4
// (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]) of columns
// 8j + 2 (lane%4) and the next.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss: N 16, 32, 64 or 128");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : HK_D8(d, 0)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HK_R16
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : HK_D16(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
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
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma_rs: N 16, 32, 64, 128 or 256");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : HK_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HK_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : HK_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HK_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HK_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HK_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HK_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HK_R128
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : HK_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
}

#undef HK_R16
#undef HK_R32
#undef HK_R64
#undef HK_R128
#undef HK_D8
#undef HK_D16
#undef HK_D32
#undef HK_D64
#undef HK_D128

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
// f32 operands on the bf16 tensor cores, as three bf16 pieces
// ---------------------------------------------------------------------------
//
// x = x0 + x1 + x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0
// - x1): each difference is exact in f32, and the three pieces carry
// f32's 24 bits of mantissa (their sum is within 2^-24 |x| of x).  An f32
// product A B is then the sum over the pairs i + j <= 2 of A_i B_j: six
// bf16 wgmma products, each product exact; the terms dropped (i + j > 2)
// are of order 2^-24 |A| |B|.  The tensor cores' f32 accumulation does
// not round to nearest (a step can drop an ulp of the running sum, the
// same way each time), so a long sum is best accumulated in partials
// added in f32 (flash_attention_bwd.cu's add_partial).  NP = 1 is a bf16
// operand as it is.

// the number of piece pairs (i, j), i + j < np, of a product on np pieces
__host__ __device__ constexpr int n_pairs(int np) { return np * (np + 1) / 2; }

// pair k in the order of their sums, the smallest terms first; np = 3:
// (0,2) (1,1) (2,0) (0,1) (1,0) (0,0)
__host__ __device__ constexpr int pair_i(int np, int k) {
  for (int lv = np - 1; lv >= 0; --lv) {
    if (k <= lv) return k;
    k -= lv + 1;
  }
  return 0;
}
__host__ __device__ constexpr int pair_j(int np, int k) {
  for (int lv = np - 1; lv >= 0; --lv) {
    if (k <= lv) return lv - k;
    k -= lv + 1;
  }
  return 0;
}

// the NP bf16 pieces of (lo, hi), each packed as a wgmma A-register pair
template <int NP>
__device__ __forceinline__ void pack_bf16_pieces(float lo, float hi, uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    lo -= f.x;
    hi -= f.y;
  }
}

// Up to four (B, S, heads, D) f32 tensors (any strides, D contiguous),
// each into its pieces: a contiguous bf16 (3, B, S, heads, D), which a
// tensor map reads as (B' = 3 B, S, heads, D), piece p of batch b at p B + b.
struct SplitArgs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  long long sb[4], ss[4], sh[4];
  int heads[4];
};

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[4], int i) {  // no local-memory copy of `a`
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// eight elements of a row a thread (two float4 loads where the row is
// 16-byte aligned, one 16-byte store a piece); blockIdx.y: the tensor
template <int D>
__global__ void __launch_bounds__(256) split3_kernel(const __grid_constant__ SplitArgs a, int B,
                                                      int S) {
  static_assert(D % 8 == 0, "eight elements of one row a thread");
  const int x = blockIdx.y;
  const int heads = pick(a.heads, x);
  const long long n = static_cast<long long>(B) * S * heads * D;
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= n) return;
  const unsigned row = static_cast<unsigned>(i / D);  // (b, s, h)
  const unsigned h = row % heads, bs = row / heads;
  const long long s = bs % S, b = bs / S;
  const float* src =
      pick(a.src, x) + b * pick(a.sb, x) + s * pick(a.ss, x) + h * pick(a.sh, x) + i % D;
  float v[8];
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e];
  }
  uint32_t out[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t w[3];
    pack_bf16_pieces<3>(v[2 * e], v[2 * e + 1], w);
#pragma unroll
    for (int p = 0; p < 3; ++p) out[p][e] = w[p];
  }
  __nv_bfloat16* dst = pick(a.dst, x) + i;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint4*>(dst + p * n) = make_uint4(out[p][0], out[p][1], out[p][2], out[p][3]);
}

// launches split3_kernel over the first n of `a`'s tensors
inline cudaError_t split3(const SplitArgs& a, int n, int B, int S, int D, cudaStream_t st) {
  int heads = 0;
  for (int x = 0; x < n; ++x) heads = a.heads[x] > heads ? a.heads[x] : heads;
  const dim3 grid(
      static_cast<unsigned>((static_cast<long long>(B) * S * heads * D / 8 + 255) / 256), n);
  if (D == 64)
    split3_kernel<64><<<grid, 256, 0, st>>>(a, B, S);
  else if (D == 80)
    split3_kernel<80><<<grid, 256, 0, st>>>(a, B, S);
  else if (D == 128)
    split3_kernel<128><<<grid, 256, 0, st>>>(a, B, S);
  else if (D == 192)
    split3_kernel<192><<<grid, 256, 0, st>>>(a, B, S);
  else if (D == 256)
    split3_kernel<256><<<grid, 256, 0, st>>>(a, B, S);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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

// a (B, S, H, D) bf16 tensor (strides in elements, D contiguous) as a map
// over (D, H, S, B), read or written in boxes of 64 columns x `rows` rows
// of one head
inline bool bhsd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                     long long sb, long long ss, long long sh, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sh) * 2, static_cast<uint64_t>(ss) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return tensor_map_4d(map, base, dims, strides, box);
}

}  // namespace hopper
