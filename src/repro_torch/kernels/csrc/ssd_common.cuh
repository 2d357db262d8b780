// Pieces the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: blocks of NT threads loading rows of f32 or bf16 into f32 shared
// memory, writing outputs in either dtype, and a block-wide prefix sum.
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

}  // namespace
