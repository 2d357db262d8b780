// Fused softmax cross-entropy over the vocabulary for Hopper (sm_90a),
// forward and backward, f32 and bf16 logits.
//
// Replaces the TPU kernel `fused_xent` (body `_kernel`) in the JAX
// package's kernels/fused_xent.py: per-token nll = lse(logits) -
// logits[label], with the vocabulary streamed through an online max and
// denominator in f32 and the label's logit picked in the tile that holds
// it, so no (T, V) temporary is ever written.  A label outside [0, V)
// picks 0, as the Pallas kernel's `hit` mask does.  The backward of the
// JAX package is the vjp of `xent_ref`; here it is a kernel of its own:
// d logits = (exp(x - lse) - onehot(label)) * g, from the row lse that
// the forward writes beside the nll.
//
// Design.  One block of 256 threads per row.  The TPU's sequential
// vocab grid axis becomes a loop over 4096-column tiles inside the
// block; each thread takes 16 columns of a tile as 16-byte vector loads
// (4 f32 or 8 bf16 per load) and keeps its own running max and sum,
// and one shuffle + shared-memory reduction merges the 256 partial
// (max, sum, pick) triples at the end.  Columns past V are masked, not
// padded.  Rows whose length or base is not a multiple of the vector
// take the scalar loads.
//
// Bound on the H100.  Both passes are memory-bound: the forward reads
// the logits once (T*V elements) and writes 8 bytes a row; the backward
// reads them once and writes d logits once.  At the training shape
// (T = 3904, V = 32768) that is 512 MB (f32) or 256 MB (bf16) per pass
// against 3.35 TB/s; the few flops per element are far below the ridge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NT = 256;             // threads per block (one row)
constexpr int PER_THREAD = 16;      // columns per thread per tile
constexpr int TILE = NT * PER_THREAD;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements at p (16-byte aligned when VEC > 1) as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f<T>(*p);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Per row t: m = max, l = sum exp(x - m), pick = x[label]; then
// lse = m + log l and nll = lse - pick.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) xent_fwd_kernel(const T* __restrict__ logits,
                                                      const int* __restrict__ labels,
                                                      float* __restrict__ nll,
                                                      float* __restrict__ lse, int V) {
  constexpr int UNROLL = PER_THREAD / VEC;
  const int t = blockIdx.x;
  const T* x = logits + static_cast<long long>(t) * V;
  const int label = labels[t];
  float m = NEG_INF, l = 0.f, pick = 0.f;

  for (int c0 = 0; c0 < V; c0 += TILE) {  // vocab tiles, in order
    float xv[UNROLL][VEC];
    bool in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // every load of the tile in flight at once
      const int col = c0 + (u * NT + threadIdx.x) * VEC;
      in[u] = col < V;  // V % VEC == 0: a vector is wholly in or out
      if (in[u]) load_vec<T, VEC>(x + col, xv[u]);
    }
    float mt = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!in[u]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) mt = fmaxf(mt, xv[u][e]);
    }
    l *= expf(m - mt);
    m = mt;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!in[u]) continue;
      const int col = c0 + (u * NT + threadIdx.x) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        l += expf(xv[u][e] - m);
        if (col + e == label) pick = xv[u][e];
      }
    }
  }

  // merge the 256 (m, l, pick): warps by shuffles, then warp 0 over warps
  __shared__ float sm[NT / 32], sl[NT / 32], sp[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    pick += __shfl_xor_sync(0xffffffffu, pick, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
    sp[warp] = pick;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < NT / 32 ? sm[lane] : NEG_INF;
    l = lane < NT / 32 ? sl[lane] : 0.f;
    pick = lane < NT / 32 ? sp[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      const float mn = fmaxf(m, m2);
      l = l * expf(m - mn) + l2 * expf(m2 - mn);
      m = mn;
      pick += __shfl_xor_sync(0xffffffffu, pick, off);
    }
    if (lane == 0) {
      const float r = m + logf(l);
      lse[t] = r;
      nll[t] = r - pick;
    }
  }
}

// d logits[t, c] = (exp(x - lse[t]) - (c == label)) * g[t], in T
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) xent_bwd_kernel(const T* __restrict__ logits,
                                                      const int* __restrict__ labels,
                                                      const float* __restrict__ lse,
                                                      const float* __restrict__ g,
                                                      T* __restrict__ dlogits, int V) {
  constexpr int UNROLL = PER_THREAD / VEC;
  const int t = blockIdx.x;
  const long long base = static_cast<long long>(t) * V;
  const T* x = logits + base;
  T* dx = dlogits + base;
  const int label = labels[t];
  const float r = lse[t], gt = g[t];

  for (int c0 = 0; c0 < V; c0 += TILE) {
    float xv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int col = c0 + (u * NT + threadIdx.x) * VEC;
      if (col < V) load_vec<T, VEC>(x + col, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int col = c0 + (u * NT + threadIdx.x) * VEC;
      if (col >= V) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        xv[u][e] = (expf(xv[u][e] - r) - (col + e == label ? 1.f : 0.f)) * gt;
      store_vec<T, VEC>(dx + col, xv[u]);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* logits, const int* labels, float* nll, float* lse, int T_,
                       int V, bool vec, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec)
    xent_fwd_kernel<T, VEC><<<T_, NT, 0, st>>>(static_cast<const T*>(logits), labels, nll,
                                               lse, V);
  else
    xent_fwd_kernel<T, 1><<<T_, NT, 0, st>>>(static_cast<const T*>(logits), labels, nll, lse,
                                             V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const int* labels, const float* lse, const float* g,
                       void* dlogits, int T_, int V, bool vec, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec)
    xent_bwd_kernel<T, VEC><<<T_, NT, 0, st>>>(static_cast<const T*>(logits), labels, lse, g,
                                               static_cast<T*>(dlogits), V);
  else
    xent_bwd_kernel<T, 1><<<T_, NT, 0, st>>>(static_cast<const T*>(logits), labels, lse, g,
                                             static_cast<T*>(dlogits), V);
  return cudaGetLastError();
}

}  // namespace

// logits: (T, V) contiguous; labels: (T,) int32; nll, lse: (T,) f32.
// dtype: 0 = float32, 1 = bfloat16.  vec: every row starts on a 16-byte
// boundary and V is a multiple of 16 bytes' worth of elements.  Returns
// a cudaError_t (0 = launched).
extern "C" int fused_xent_fwd(const void* logits, const int* labels, float* nll, float* lse,
                              int T, int V, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  if (dtype == 0) return launch_fwd<float>(logits, labels, nll, lse, T, V, vec, st);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(logits, labels, nll, lse, T, V, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dlogits: (T, V) contiguous in the logits' dtype; g: (T,) f32.
extern "C" int fused_xent_bwd(const void* logits, const int* labels, const float* lse,
                              const float* g, void* dlogits, int T, int V, int dtype, int vec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  if (dtype == 0) return launch_bwd<float>(logits, labels, lse, g, dlogits, T, V, vec, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(logits, labels, lse, g, dlogits, T, V, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
