// Pieces the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: blocks of NT threads loading rows of f32 or bf16 into f32 shared
// memory, writing outputs in either dtype, a block-wide prefix sum, and the
// chunk cumsum of the bodies on one warpgroup.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace
