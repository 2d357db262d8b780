// Pieces the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: blocks of NT threads loading rows of f32 or bf16 into f32 shared
// memory, writing outputs in either dtype, a block-wide prefix sum; and for
// the bodies on one warpgroup, their tile shapes, the chunk cumsum and the
// forming of an f32 tile's bf16 pieces in swizzled shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;       // threads per block, a 16 x 16 grid (ty, tx)

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [0, rows) of `n` elements (n % 4 == 0) from src (row stride
// src_stride) into dst (row stride dst_stride) as f32; rows >= valid are 0
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* src,
                                          long long src_stride, int rows, int valid, int n) {
  const int quads = n / 4;
  for (int e = threadIdx.x; e < rows * quads; e += NT) {
    const int r = e / quads, q = e - r * quads;
    const float4 v = r < valid ? load4<T>(src + r * src_stride + 4 * q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * dst_stride + 4 * q) = v;
  }
}

// inclusive prefix sum of one value per thread over the block
__device__ __forceinline__ float block_inclusive_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    float s = lane < NT / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < NT / 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < NT / 32) wsum[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += wsum[w - 1];
  __syncthreads();   // wsum is free again for the caller
  return v;
}

// dts[i] = dt of step i of the chunk (0 past S) and acs[i] its inclusive
// cumsum of dt A, for i < L <= 256, by 128 threads taking two steps each,
// in one fixed order: every pass that calls it (the forward's bf16 body and
// the backward's wgmma body) computes the same bits.
__device__ __forceinline__ void chunk_cumsum(const float* dtc, int dt_ss, int valid, float A,
                                             int L, float* dts, float* acs, float* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int i0 = 2 * t;
  const float d0 = i0 < valid ? dtc[static_cast<long long>(i0) * dt_ss] : 0.f;
  const float d1 = i0 + 1 < valid ? dtc[static_cast<long long>(i0 + 1) * dt_ss] : 0.f;
  const float a0 = d0 * A, a1 = d1 * A;
  float v = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  float ex = __shfl_up_sync(0xffffffffu, v, 1);   // this lane's exclusive prefix
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  float base = 0.f;
  for (int k = 0; k < w; ++k) base += wsum[k];
  ex = lane == 0 ? base : base + ex;
  if (i0 < L) {
    dts[i0] = d0;
    acs[i0] = ex + a0;
  }
  if (i0 + 1 < L) {
    dts[i0 + 1] = d1;
    acs[i0 + 1] = (ex + a0) + a1;
  }
}

// the wgmma bodies: one warpgroup a block, 64-row tiles, P 64
constexpr int WG = 128;          // threads of a block: one warpgroup
constexpr int TR = 64;           // rows of a tile: a wgmma's M, a TMA box's rows
constexpr int WP = 64;           // P of the body: one 128-byte box row
constexpr int BOX = TR * 128;    // bytes of a 64 x 64 bf16 box

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// eight f32 values as NPA bf16 pieces (hopper::pack_bf16_pieces), each
// piece's eight in one 16-byte chunk of a swizzled box row
template <int NPA>
__device__ __forceinline__ void store_pieces8(uint8_t* dst, int piece_bytes, int r, int c8,
                                              const float (&v)[8]) {
  uint32_t w[4][NPA];
#pragma unroll
  for (int e = 0; e < 4; ++e) hopper::pack_bf16_pieces<NPA>(v[2 * e], v[2 * e + 1], w[e]);
  const int off = r * 128 + (((c8 >> 3) ^ (r & 7)) << 4);  // the 128-byte swizzle
#pragma unroll
  for (int pc = 0; pc < NPA; ++pc)
    *reinterpret_cast<uint4*>(dst + pc * piece_bytes + off) =
        make_uint4(w[0][pc], w[1][pc], w[2][pc], w[3][pc]);
}

// this thread's share of rows r0 .. r0 + 63 (zeros at and past `valid`)
// of a chunk's (steps, 64) tensor at `src` (row stride `ss` elements):
// eight elements of each of four rows
template <typename T>
__device__ __forceinline__ void tile_rows(float (&v)[4][8], const T* src, long long ss, int r0,
                                          int valid) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = threadIdx.x + u * WG, row = r0 + (i >> 3);
    if (row < valid) {
      load8(src + row * ss + (i & 7) * 8, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
    }
  }
}

// tile_rows' share, row i times f[r0 + i], as NPA pieces into swizzled 64 x
// 64 boxes at `dst`, BOX bytes apart
template <int NPA>
__device__ __forceinline__ void scaled_pieces(uint8_t* dst, float (&v)[4][8], int r0,
                                              const float* f) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = threadIdx.x + u * WG, r = i >> 3;
    const float s = f[r0 + r];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[u][k] *= s;
    store_pieces8<NPA>(dst, BOX, r, (i & 7) * 8, v[u]);
  }
}

}  // namespace
