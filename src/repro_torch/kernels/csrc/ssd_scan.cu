// Mamba2 SSD chunked scan for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces the TPU kernel `ssd_scan` (body `_kernel`) in the JAX package's
// kernels/ssd_scan.py.  Per (batch b, head h) and per chunk of L steps:
//   acs   = cumsum(dt * A)                      (inclusive, restarted per chunk)
//   y     = exp(acs) * (C . state)              (inter-chunk)
//         + ((C B^T) o exp(mask(acs_l - acs_s)) o dt_s) x   (intra-chunk, s <= l)
//   state = exp(acs_L) * state + B^T diag(exp(acs_L - acs) * dt) x
// with B and C read from group h / (H / G).  The exponent is masked to -inf
// above the diagonal BEFORE the exp: there the difference is positive and
// overflows f32 for long chunks.  y is written in x's dtype, the final
// state in f32.  A ragged S is not padded in memory: steps past S load as
// zeros (dt = 0: decay 1, no update), are skipped where a whole tile lies
// past S, and are never stored.
//
// Design.  The TPU kernel's sequential chunk axis (its (N, P) state carried
// in a VMEM scratch from one grid step to the next) becomes a loop over
// chunks inside one block, with the state in shared memory.  The P columns
// of the state and of y are independent of each other, so each block takes
// 16 of them: one block of 256 threads (a 16 x 16 grid) per (16-column
// slice, h, b).  At the serving shape (B 1, H 24, P 64) that is 96 blocks
// on 132 SMs; each block recomputes the chunk's C B^T for its 16 columns.
// Per chunk the block holds in shared memory, all in f32: dt, acs and the
// state-update weights (L each), x's 16 columns (L x 16), the state
// (N x 16), all of B (L x N, padded rows) and one row tile of C (TL x N);
// the L x L score block is taken in TL x TL tiles (TL = 64, or 32 when L is
// not a multiple of 64), only those on or below the diagonal, each masked,
// decayed and scaled into a TL x TL tile that multiplies x.  At L = 256 and
// N = 128 that is 209 KB of the 227 KB a block may have.  All four
// products run on the CUDA cores in f32 from register tiles (4 x 4 for the
// scores at TL = 64), reading 16-byte rows of shared memory.
//
// Bound on the H100.  The products are about 33.6 MFLOP per chunk and head
// (the Pallas body's four, C B^T and its product with x taken in full):
// 0.048 ms at S = 1024, H = 24 against 67 TFLOP/s f32, above the 0.0023
// ms to move x, y, B, C, dt and the state at 3.35 TB/s, so the kernel is
// bound by operations.  This design is far from that bound: it runs on the
// CUDA cores, not the tensor cores, and launches B * H * P / 16 blocks,
// 96 at the serving shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;       // threads per block, a 16 x 16 grid (ty, tx)
constexpr int PC = 16;        // columns of P per block (one per tx)
constexpr int MAX_N = 128;    // d_state
constexpr int NR = MAX_N / 16;  // state rows per thread in the update
constexpr int MAX_L = NT;     // one thread per step in the cumsum

struct Params {
  const void* x;       // (B, S, H, P)
  const float* dt;     // (B, S, H)
  const float* A;      // (H,)
  const void* Bm;      // (B, S, G, N)
  const void* Cm;      // (B, S, G, N)
  void* y;             // (B, S, H, P)
  float* fstate;       // (B, H, N, P)
  int S, H, P, G, N, L;
};

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
  return v;
}

__host__ __device__ constexpr int seg_stride(int TL) { return TL + 4; }

// shared-memory floats of one block (every array a multiple of 4 floats)
__host__ __device__ constexpr int smem_floats(int L, int N, int TL) {
  return 3 * L + L * PC + N * PC + (L + TL) * (N + 4) + TL * seg_stride(TL) + 8;
}

static_assert(smem_floats(MAX_L, MAX_N, 64) * 4 <= 232448, "a block has 227 KB");

template <typename T, int TL>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(Params p) {
  constexpr int RM = TL / 16;             // tile rows (and score columns) per thread
  constexpr int SS = seg_stride(TL);
  extern __shared__ __align__(16) float sm[];
  const int L = p.L, N = p.N, NS = N + 4;
  float* acs = sm;                        // [L]   cumsum(dt * A) within the chunk
  float* dts = acs + L;                   // [L]
  float* wdec = dts + L;                  // [L]   exp(acs_L - acs) * dt
  float* xs = wdec + L;                   // [L][PC]
  float* st = xs + L * PC;                // [N][PC]  the carried state
  float* Bs = st + N * PC;                // [L][NS]  B of the whole chunk
  float* Cs = Bs + L * NS;                // [TL][NS] one row tile of C
  float* seg = Cs + TL * NS;              // [TL][SS]
  float* wsum = seg + TL * SS;            // [8]

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const float A = p.A[h];
  const long long x_ss = static_cast<long long>(p.H) * p.P;     // x, y step stride
  const long long bc_ss = static_cast<long long>(p.G) * N;       // B, C step stride
  const long long x_off = (static_cast<long long>(b) * p.S * p.H + h) * p.P + blockIdx.x * PC;
  const T* x = static_cast<const T*>(p.x) + x_off;
  T* y = static_cast<T*>(p.y) + x_off;
  const long long bc_off = (static_cast<long long>(b) * p.S * p.G + g) * N;
  const T* Bg = static_cast<const T*>(p.Bm) + bc_off;
  const T* Cg = static_cast<const T*>(p.Cm) + bc_off;
  const float* dtg = p.dt + static_cast<long long>(b) * p.S * p.H + h;

  for (int i = t; i < N * PC; i += NT) st[i] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += L) {
    const int valid = min(L, p.S - c0);   // steps of this chunk inside S
    float a = 0.f;
    if (t < L) {
      const float d = t < valid ? dtg[static_cast<long long>(c0 + t) * p.H] : 0.f;
      dts[t] = d;
      a = d * A;
    }
    a = block_inclusive_scan(a, wsum);
    if (t < L) acs[t] = a;
    load_rows<T>(xs, PC, x + c0 * x_ss, x_ss, L, valid, PC);
    load_rows<T>(Bs, NS, Bg + c0 * bc_ss, bc_ss, L, valid, N);
    __syncthreads();
    const float acs_last = acs[L - 1];
    if (t < L) wdec[t] = expf(acs_last - acs[t]) * dts[t];

    for (int l0 = 0; l0 < valid; l0 += TL) {   // row tiles of y
      load_rows<T>(Cs, NS, Cg + (c0 + l0) * bc_ss, bc_ss, TL, valid - l0, N);
      __syncthreads();
      // inter-chunk: exp(acs_l) * (C . state)
      float yacc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) yacc[i] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float s4[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) s4[k] = st[(n + k) * PC + tx];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * NS + n);
          yacc[i] = fmaf(cv.x, s4[0], fmaf(cv.y, s4[1], fmaf(cv.z, s4[2], fmaf(cv.w, s4[3], yacc[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) yacc[i] *= expf(acs[l0 + ty + 16 * i]);

      // intra-chunk: source tiles on and below the diagonal
      for (int s0 = 0; s0 <= l0; s0 += TL) {
        float sc[RM][RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RM; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[RM], bv[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            cv[i] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * NS + n);
#pragma unroll
          for (int j = 0; j < RM; ++j)
            bv[j] = *reinterpret_cast<const float4*>(Bs + (s0 + tx + 16 * j) * NS + n);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RM; ++j)
              sc[i][j] = fmaf(cv[i].x, bv[j].x, fmaf(cv[i].y, bv[j].y,
                         fmaf(cv[i].z, bv[j].z, fmaf(cv[i].w, bv[j].w, sc[i][j]))));
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < RM; ++j) {
            const int s = s0 + tx + 16 * j;
            const float decay = expf(s <= l ? acs[l] - acs[s] : -INFINITY);
            seg[(ty + 16 * i) * SS + tx + 16 * j] = sc[i][j] * decay * dts[s];
          }
        }
        __syncthreads();
        for (int s = 0; s < TL; s += 4) {
          float x4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) x4[k] = xs[(s0 + s + k) * PC + tx];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float4 sv = *reinterpret_cast<const float4*>(seg + (ty + 16 * i) * SS + s);
            yacc[i] = fmaf(sv.x, x4[0], fmaf(sv.y, x4[1], fmaf(sv.z, x4[2], fmaf(sv.w, x4[3], yacc[i]))));
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int l = c0 + l0 + ty + 16 * i;
        if (l < p.S) y[l * x_ss + tx] = from_f<T>(yacc[i]);
      }
    }

    // state update: exp(acs_L) * state + B^T (wdec o x)
    float acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    for (int s = 0; s < valid; ++s) {
      const float wx = wdec[s] * xs[s * PC + tx];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        if (ty + 16 * i < N) acc[i] = fmaf(Bs[s * NS + ty + 16 * i], wx, acc[i]);
    }
    const float carry = expf(acs_last);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int n = ty + 16 * i;
      if (n < N) st[n * PC + tx] = carry * st[n * PC + tx] + acc[i];
    }
    __syncthreads();
  }

  float* fs = p.fstate + (static_cast<long long>(b) * p.H + h) * N * p.P + blockIdx.x * PC;
  for (int i = t; i < N * PC; i += NT) fs[(i / PC) * p.P + i % PC] = st[i];
}

template <typename T, int TL>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, TL>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    const int most = smem_floats(MAX_L, MAX_N, TL) * static_cast<int>(sizeof(float));
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int smem = smem_floats(p.L, p.N, TL) * static_cast<int>(sizeof(float));
  dim3 grid(p.P / PC, p.H, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Params& p, int B, cudaStream_t stream) {
  if (p.L % 64 == 0) return launch<T, 64>(p, B, stream);
  return launch<T, 32>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are f32.  All tensors contiguous; x, B, C 16-byte aligned.  Takes
// L a multiple of 32 up to 256, N a multiple of 4 up to 128, P a multiple
// of 16, H a multiple of G.  Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, void* y, float* fstate, int B, int S, int H, int P,
                            int G, int N, int L, int dtype, void* stream) {
  if (L % 32 || L > MAX_L || N % 4 || N > MAX_N || P % PC || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fstate, S, H, P, G, N, L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_t<float>(p, B, st));
  if (dtype == 1) return static_cast<int>(launch_t<__nv_bfloat16>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
