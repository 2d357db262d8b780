// Paged-attention decode for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `paged_attention_fwd` (body `_kernel`) in the
// JAX package's kernels/paged_attention.py: one query token per
// sequence against K/V pages of a pool (NP, P, Hkv, D), addressed
// through a block table (B, maxp); keys 0..pos are live, with an
// optional sliding window and logit softcap; online softmax in f32.
//
// Design.  The pages of each sequence are cut into splits of `pps`
// pages, and one thread block per (kv head, sequence, split) serves all
// `rep` query heads of that kv head, so each page of K/V is read once for
// the rep heads (rep = 12 for starcoder2-3b; any rep in the dispatch
// table below).  A block reads its own table row (the TPU kernel's
// scalar prefetch); its eight warps take the split's pages round robin,
// each warp a whole page at a time with its own running (m, l, acc); the
// warps' states are merged through shared memory and written as the
// split's partial state, and a second kernel merges the splits (the
// TPU's sequential page axis becomes this two-pass reduction).  Pages
// past `pos` or wholly behind the window are never read, and their
// splits launch blocks that exit at once.  Table slots past an
// allocation hold the trash page 0, and the page range stops at table
// column maxp - 1 whatever a stale `pos` of an inactive slot says, so
// every read stays inside the pool and the table.
//
// Bound on the H100: bytes.  Each live key is read once as K and once
// as V, 2*Hkv*D*itemsize bytes per token of every sequence, against
// 4*H*D flops per token: ~1 flop/byte, so the bound is live KV bytes
// over 3.35 TB/s.  The splits are what fill the card: 8 starcoder2
// sequences give 16 (kv head, sequence) pairs, but ~128 blocks at
// ~1000 tokens each.  The partial states add 4*(D+2) bytes per
// (query head, split), written once and read once: at pps = 8 and
// starcoder2's 12 query heads per kv head that is ~20% on top of the KV
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NW = 8;  // warps per block
constexpr int TU = 4;  // tokens whose K/V loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements in one vector load (N * sizeof(T) in {4, 8, 16})
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* ptr, float* out) {
  constexpr int BYTES = N * sizeof(T);
  using V = typename std::conditional<
      BYTES == 16, uint4,
      typename std::conditional<BYTES == 8, uint2, unsigned int>::type>::type;
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "vector width");
  const V raw = *reinterpret_cast<const V*>(ptr);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

struct Params {
  const void* q;      // (B, H, D) contiguous
  const void* k;      // (NP, P, Hkv, D) contiguous
  const void* v;
  const int* tables;  // (B, maxp)
  const int* pos;     // (B,)
  void* o;            // (B, H, D)
  float* part_ml;     // (B, H, nsplit, 2): running max and denominator
  float* part_acc;    // (B, H, nsplit, D): unnormalised accumulator
  int H, Hkv, P, maxp, pps, nsplit;
  int window;         // <= 0: no window
  float softcap;
  float scale;
};

// the live pages of a sequence: the one holding pos and the ones before
// it, back to the window's first key; never past the table's last column
__device__ __forceinline__ void live_pages(const Params& p, int pos, int* lo, int* hi) {
  *hi = pos < 0 ? -1 : min(pos / p.P, p.maxp - 1);
  *lo = p.window > 0 ? max(0, pos - p.window + 1) / p.P : 0;
}

// One block per (kv head, sequence, split of `pps` pages); its warps take
// the split's live pages round robin and the block writes the merged
// partial state of its split.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(NW * 32) paged_partial_kernel(Params p) {
  constexpr int EPL = D / 32;  // elements of D per lane
  extern __shared__ float smem[];
  float* ms = smem;                 // [NW][REP]
  float* ls = ms + NW * REP;        // [NW][REP]
  float* accs = ls + NW * REP;      // [NW][REP][D]

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int pos = p.pos[b];
  int j_lo, j_hi;
  live_pages(p, pos, &j_lo, &j_hi);
  const int s_lo = split * p.pps;
  const int j0 = max(j_lo, s_lo), j1 = min(j_hi, s_lo + p.pps - 1);
  if (j0 > j1) return;  // nothing live here; the combine skips this split

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const int P = p.P;
  const long long tok_s = (long long)p.Hkv * D;
  const long long page_s = (long long)P * tok_s;

  float q[REP][EPL], acc[REP][EPL], m[REP], l[REP];
  const T* qb = static_cast<const T*>(p.q) + ((long long)b * p.H + g * REP) * D;
#pragma unroll
  for (int i = 0; i < REP; ++i) {
    load_f<T, EPL>(qb + i * D + d0, q[i]);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  const int* trow = p.tables + (long long)b * p.maxp;
  const T* kbase = static_cast<const T*>(p.k) + g * D + d0;
  const T* vbase = static_cast<const T*>(p.v) + g * D + d0;
  for (int j = j0 + warp; j <= j1; j += NW) {
    const long long page_off = (long long)trow[j] * page_s;
    for (int t0 = 0; t0 < P; t0 += TU) {
      float kx[TU][EPL], vx[TU][EPL];
      bool live[TU];
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const int t = t0 + u;
        const int kpos = j * P + t;
        live[u] = t < P && kpos <= pos && (p.window <= 0 || kpos > pos - p.window);
        if (live[u]) {
          load_f<T, EPL>(kbase + page_off + t * tok_s, kx[u]);
          load_f<T, EPL>(vbase + page_off + t * tok_s, vx[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        if (!live[u]) continue;  // uniform across the warp
#pragma unroll
        for (int i = 0; i < REP; ++i) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(q[i][e], kx[u][e], s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          s *= p.scale;
          if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
          const float m_new = fmaxf(m[i], s);
          const float alpha = expf(m[i] - m_new);
          const float pw = expf(s - m_new);
          l[i] = l[i] * alpha + pw;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(acc[i][e], alpha, pw * vx[u][e]);
          m[i] = m_new;
        }
      }
    }
  }

  // merge the warps' (m, l, acc) and write the split's partial state
#pragma unroll
  for (int i = 0; i < REP; ++i) {
    if (lane == 0) {
      ms[warp * REP + i] = m[i];
      ls[warp * REP + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) accs[(warp * REP + i) * D + d0 + e] = acc[i][e];
  }
  __syncthreads();
  const long long row0 = ((long long)b * p.H + g * REP) * p.nsplit + split;  // head i: + i*nsplit
  for (int idx = threadIdx.x; idx < REP * D; idx += NW * 32) {
    const int i = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ms[w * REP + i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(ms[w * REP + i] - mx);
      lsum += ls[w * REP + i] * f;
      a += accs[(w * REP + i) * D + d] * f;
    }
    const long long row = row0 + (long long)i * p.nsplit;
    p.part_acc[row * D + d] = a;
    if (d == 0) {
      p.part_ml[row * 2] = mx;
      p.part_ml[row * 2 + 1] = lsum;
    }
  }
}

// One block per (query head, sequence), one thread per element of D:
// merges the live splits' partial states and normalises.
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_combine_kernel(Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  int j_lo, j_hi;
  live_pages(p, p.pos[b], &j_lo, &j_hi);
  const long long row0 = ((long long)b * p.H + h) * p.nsplit;
  float mx = NEG_INF, lsum = 0.f, a = 0.f;
  if (j_lo <= j_hi) {
    const int s0 = j_lo / p.pps, s1 = j_hi / p.pps;
    for (int s = s0; s <= s1; ++s) mx = fmaxf(mx, p.part_ml[(row0 + s) * 2]);
    for (int s = s0; s <= s1; ++s) {
      const float f = expf(p.part_ml[(row0 + s) * 2] - mx);
      lsum += p.part_ml[(row0 + s) * 2 + 1] * f;
      a += p.part_acc[(row0 + s) * D + d] * f;
    }
  }
  static_cast<T*>(p.o)[((long long)b * p.H + h) * D + d] = from_f<T>(a / fmaxf(lsum, 1e-37f));
}

template <typename T, int D, int REP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = NW * REP * (D + 2) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_partial_kernel<T, D, REP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  paged_partial_kernel<T, D, REP><<<dim3(p.Hkv, B, p.nsplit), NW * 32, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<T, D><<<dim3(p.H, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(const Params& p, int rep, int B, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<T, D, 1>(p, B, st);
    case 2: return launch<T, D, 2>(p, B, st);
    case 3: return launch<T, D, 3>(p, B, st);
    case 4: return launch<T, D, 4>(p, B, st);
    case 6: return launch<T, D, 6>(p, B, st);
    case 8: return launch<T, D, 8>(p, B, st);
    case 12: return launch<T, D, 12>(p, B, st);
    case 16: return launch<T, D, 16>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_ml / part_acc: f32 scratch of
// (B, H, nsplit, 2) and (B, H, nsplit, D), nsplit = ceil(maxp / pps).
// Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const int* tables, const int* pos, void* o,
                                   void* part_ml, void* part_acc,
                                   int B, int H, int Hkv, int D, int P, int maxp, int pps,
                                   int dtype, int window, float softcap, float scale,
                                   void* stream) {
  const int nsplit = (maxp + pps - 1) / pps;
  Params p{q, k_pages, v_pages, tables, pos, o,
           static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           H, Hkv, P, maxp, pps, nsplit, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  if (dtype == 0 && D == 64) return by_rep<float, 64>(p, rep, B, st);
  if (dtype == 0 && D == 128) return by_rep<float, 128>(p, rep, B, st);
  if (dtype == 1 && D == 64) return by_rep<__nv_bfloat16, 64>(p, rep, B, st);
  if (dtype == 1 && D == 128) return by_rep<__nv_bfloat16, 128>(p, rep, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
