// Flash attention backward for Hopper (sm_90a), f32 and bf16.
//
// The JAX package has no Pallas backward: its `kernels/ops.py` takes the
// vjp of the pure-jnp `flash_attention_ref` (`_fa_bwd`), which XLA
// compiles.  This is the same recompute written as kernels: the forward
// keeps q, k, v, o and the row log-sum-exp (B, H, S) in f32, and the
// backward recomputes the softmax weights tile by tile,
//   P  = exp(scale * q k^T - lse)             (0 where masked)
//   dP = dO v^T,   Delta = rowsum(dO * O),   dS = P * (dP - Delta)
//   dV = P^T dO,   dK = scale * dS^T q,      dQ = scale * dS k,
// so no (S, S) score or probability matrix ever reaches device memory.
// Causal or not, any GQA ratio (kv head = h / rep: dK and dV sum over the
// rep query heads of their kv head), D in {64, 128}, ragged S.  Window
// and logit softcap are refused by the wrapper.
//
// No atomics: dQ has its own pass over the q tiles (it recomputes S and
// dP, seven products instead of FlashAttention-2's five with a float
// atomicAdd), so every gradient is the same bit for bit from run to run.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  Five (S, S, D)
// products per (batch, head): 10 S^2 D flops against ~(8 H + 6 Hkv) S D
// elements of traffic, far above the ridge: the tensor cores.  At
// bert-mlm-120m's attention (B 32, S 512, H 12, D 64) that is 0.065 ms,
// 0.091 ms for the seven products this design computes.  Measured there
// (PERF.md), the 2 x 100.7M exponentials cost little; the three gradient
// products, which each warpgroup waits for before its next tile, cost
// most.
//
// bf16 body, two launches, both on csrc/hopper.cuh: every tile comes by
// TMA (128-byte swizzle, 64-row boxes, rows past S filled with zeros),
// every product is a wgmma with f32 accumulators, and thread 0 keeps a
// ring of stages full ("full" mbarriers count the TMA bytes, "empty" ones
// the consumer warps that released a stage; it refills at the start of
// each iteration what every warp released in the previous one).
//   1. dq: one block per (128 q rows, head, batch), two consumer
//      warpgroups of 64 rows.  Q, dO and O arrive once; each thread folds
//      Delta = rowsum(dO O) of its two rows out of shared memory and writes
//      it, with lse * log2(e), for pass 2 as each q tile's 64 lse and 64
//      Delta values (rows past S: lse +inf, so P = 0 there, and Delta 0).
//      K and V tiles of 64 keys stream through the ring; per tile S = Q K^T
//      and dP = dO V^T are issued together (K-major operands), P =
//      exp2(S scale log2 e - lse log2 e) is computed while dP runs, then
//      dS = P (dP - Delta) goes to bf16 pairs in registers, the A operand
//      of dQ += dS K (K read MN-major from the same tile).
//   2. dkdv: one block per (128 keys, kv head, batch), two consumer
//      warpgroups of 64 keys.  K and V arrive once; the q tiles of every
//      rep head of the kv head stream through one ring (its index runs
//      over rep heads x q tiles, so GQA needs no second loop), each stage
//      Q, dO and the tile's lse and Delta (a 512-byte bulk copy).  Per
//      tile the transposed products S^T = K Q^T and dP^T = V dO^T leave
//      P^T and dS^T in the accumulator layout, which is the register A
//      layout of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major).
// Masks are compile-time variants chosen per tile and block, so no branch
// on the thread lies near a wgmma (ptxas serializes the products in a
// divergent path, its warning C7520, and waits for them at any join):
// full tiles run none; causal diagonal tiles, and in dq the tile holding
// S's ragged end, select 0 for hidden scores.  Keys past S need no mask
// in dkdv (their dK and dV rows are never stored) and rows past S none
// anywhere (their lse is +inf).  Epilogues scale, round to bf16, write
// into the warpgroup's own input rows of shared memory and store by TMA,
// which drops rows past S.  dq fits two blocks an SM at D 64; dkdv holds
// dK and dV (64 x D f32 each per warpgroup) and runs one.
//
// f32 body (the exactness path): three launches, Delta by one warp per
// row, then dq and dkdv blocks of four warps per 64-row tile with the same
// tiles on the CUDA cores in f32 (a 4 x 8 score tile and a 4 x D/8 output
// tile per thread, tiles in shared memory at an odd row stride), exact to
// the f32 reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block of dq / dkdv
constexpr int SLD = 65;  // row stride of the (64 x 64) score tiles in smem

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  // scratch: the f32 body's Delta (B, H, S); the bf16 body's lse * log2(e)
  // and Delta as (B, H, ceil(S / 64), 2, 64), written by its dq pass
  float* delta;
  void* dq;          // (B, S, H, D) contiguous
  void* dk;          // (B, S, Hkv, D) contiguous
  void* dv;
  long long q_sb, q_ss, q_sh;  // input strides in elements; D is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int B, S, H, Hkv;
  int causal;
  float scale;
};

// rows [s0, s0 + 64) of one head of x (strides sb/ss, head base applied)
// into smem rows of stride D + 1, zero past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int s0,
                                          int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int s = s0 + r;
    dst[r * (D + 1) + d] = s < S ? to_f<T>(src[s * ss + d]) : 0.f;
  }
}

// ---------------------------------------------------------------- delta
template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_rows = static_cast<long long>(p.B) * p.S * p.H;
  if (row >= n_rows) return;
  const int h = row % p.H;
  const int s = (row / p.H) % p.S;
  const int b = row / (static_cast<long long>(p.H) * p.S);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < D; i += 32) acc = fmaf(to_f<T>(o[i]), to_f<T>(d[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.S + s] = acc;
}

// Scores and dP of the (64 q rows x 64 keys) tile: this thread's rows
// r*4 + i, keys c + 8j, then P and dS in place (sc <- P, dp <- dS).
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse_s,
                                          const float* dl_s, int q0, int k0, int r, int c,
                                          const Params& p, float (&sc)[4][8],
                                          float (&dp)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[8], vb[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(r * 4 + i) * (D + 1) + d];
      da[i] = dOs[(r * 4 + i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kb[j] = Ks[(c + 8 * j) * (D + 1) + d];
      vb[j] = Vs[(c + 8 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + c + 8 * j;
      bool ok = qi < p.S && kj < p.S;
      if (p.causal) ok = ok && kj <= qi;
      const float pw = ok ? expf(sc[i][j] * p.scale - lse_s[r * 4 + i]) : 0.f;
      sc[i][j] = pw;
      dp[i][j] = pw * (dp[i][j] - dl_s[r * 4 + i]);
    }
  }
}

// ------------------------------------------------------------- f32: dq
template <int D>
constexpr int dq_smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * SLD + 2 * 64) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_f32_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + 64 * (D + 1);
  float* Ks = dOs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* dSs = Vs + 64 * (D + 1);
  float* lse_s = dSs + 64 * SLD;
  float* dl_s = lse_s + 64;

  const int tid = threadIdx.x;
  const int r = tid >> 3, c = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int hk = h / (p.H / p.Hkv);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * S;

  load_tile<T, D>(Qs, qp, p.q_ss, q0, S);
  load_tile<T, D>(dOs, dop, p.do_ss, q0, S);
  if (tid < 64) {
    const int s = q0 + tid;
    lse_s[tid] = s < S ? p.lse[row0 + s] : 0.f;
    dl_s[tid] = s < S ? p.delta[row0 + s] : 0.f;
  }

  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) acc[i][jj] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kp, p.k_ss, k0, S);
    load_tile<T, D>(Vs, vp, p.v_ss, k0, S);
    __syncthreads();
    float sc[4][8], ds[4][8];
    tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, r, c, p, sc, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dSs[(r * 4 + i) * SLD + c + 8 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(r * 4 + i) * SLD + kk];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const float kv = Ks[kk * (D + 1) + c + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(a[i], kv, acc[i][jj]);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + (static_cast<long long>(b) * S * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r * 4 + i;
    if (qi >= S) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      dqp[static_cast<long long>(qi) * p.H * D + c + 8 * jj] = from_f<T>(acc[i][jj] * p.scale);
  }
}

// ----------------------------------------------------------- f32: dkdv
template <int D>
constexpr int dkdv_smem_bytes() {
  return (4 * 64 * (D + 1) + 2 * 64 * SLD + 2 * 64) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_f32_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + 64 * (D + 1);
  float* Qs = Vs + 64 * (D + 1);
  float* dOs = Qs + 64 * (D + 1);
  float* Ps = dOs + 64 * (D + 1);
  float* dSs = Ps + 64 * SLD;
  float* lse_s = dSs + 64 * SLD;
  float* dl_s = lse_s + 64;

  const int tid = threadIdx.x;
  const int r = tid >> 3, c = tid & 7;  // scores: q rows r*4+i, keys c+8j
  const int k0 = blockIdx.x * BK;       // dK/dV: keys r*4+i, columns c+8jj
  const int hk = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int rep = p.H / p.Hkv;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D>(Ks, kp, p.k_ss, k0, S);
  load_tile<T, D>(Vs, vp, p.v_ss, k0, S);

  float dk[4][D / 8], dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int qt_lo = p.causal ? k0 / BQ : 0;  // q tiles that see a key of this tile
  const int n_qt = (S + BQ - 1) / BQ;
  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * S;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(Qs, qp, p.q_ss, q0, S);
      load_tile<T, D>(dOs, dop, p.do_ss, q0, S);
      if (tid < 64) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? p.lse[row0 + s] : 0.f;
        dl_s[tid] = s < S ? p.delta[row0 + s] : 0.f;
      }
      __syncthreads();
      float sc[4][8], ds[4][8];
      tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, r, c, p, sc, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Ps[(r * 4 + i) * SLD + c + 8 * j] = sc[i][j];
          dSs[(r * 4 + i) * SLD + c + 8 * j] = ds[i][j];
        }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[qq * SLD + r * 4 + i];
          sa[i] = dSs[qq * SLD + r * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const float dov = dOs[qq * (D + 1) + c + 8 * jj];
          const float qv = Qs[qq * (D + 1) + c + 8 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][jj] = fmaf(pa[i], dov, dv[i][jj]);
            dk[i][jj] = fmaf(sa[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  const long long kv_row = static_cast<long long>(p.Hkv) * D;
  T* dkp = static_cast<T*>(p.dk) + (static_cast<long long>(b) * S * p.Hkv + hk) * D;
  T* dvp = static_cast<T*>(p.dv) + (static_cast<long long>(b) * S * p.Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + r * 4 + i;
    if (kj >= S) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      dkp[kj * kv_row + c + 8 * jj] = from_f<T>(dk[i][jj] * p.scale);
      dvp[kj * kv_row + c + 8 * jj] = from_f<T>(dv[i][jj]);
    }
  }
}



// ---------------------------------------------------------------------------
// bf16 body: TMA ring and wgmma; see the header.
// ---------------------------------------------------------------------------

constexpr int WNT = 256;                   // two consumer warpgroups
constexpr int BOX = 64;                    // columns of a box: 128 bytes of bf16, the swizzle span
constexpr int TILE = 64;                   // rows of every box: a warpgroup's rows, a q or k tile
constexpr int BOX_BYTES = TILE * BOX * 2;
constexpr int STAT_BYTES = 2 * TILE * 4;   // a q tile's lse * log2(e) and Delta
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Stages;
template <>
struct Stages<64> {  // dq at two blocks an SM
  static constexpr int DQ = 3, DKDV = 3, DQ_BLOCKS = 2;
};
template <>
struct Stages<128> {
  static constexpr int DQ = 2, DKDV = 3, DQ_BLOCKS = 1;
};

// dq: Q, dO and O of the block's 128 rows as (warpgroup, box) boxes of 64
// rows, then K and V of each stage (box x of stage s at s * NB + x), then
// the barriers; bytes from a 1024-aligned base
template <int D>
struct DqSmem {
  static constexpr int NB = D / BOX, STAGES = Stages<D>::DQ;
  static constexpr int Q = 0, DO = 2 * NB * BOX_BYTES, O = 4 * NB * BOX_BYTES;
  static constexpr int K = 6 * NB * BOX_BYTES;
  static constexpr int V = K + STAGES * NB * BOX_BYTES;
  static constexpr int BAR = V + STAGES * NB * BOX_BYTES;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// dkdv: K and V of the block's 128 keys as (warpgroup, box) boxes, then Q
// and dO of each stage, each stage's lse and Delta, then the barriers
template <int D>
struct KvSmem {
  static constexpr int NB = D / BOX, STAGES = Stages<D>::DKDV;
  static constexpr int K = 0, V = 2 * NB * BOX_BYTES, Q = 4 * NB * BOX_BYTES;
  static constexpr int DO = Q + STAGES * NB * BOX_BYTES;
  static constexpr int STAT = DO + STAGES * NB * BOX_BYTES;
  static constexpr int BAR = STAT + STAGES * STAT_BYTES;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_addr(p) & 1023)) & 1023);
}

// 16-wide slice kk of the reduction axis of a K-major operand: a tile of
// 64 rows stored as D/64 boxes from `base`
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  return hopper::desc_sw128(base + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024);
}

// 16-row slice kc of an MN-major operand read from the same kind of tile
// (its rows the reduction axis, its D/64 boxes along N)
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kc) {
  return hopper::desc_sw128(base + kc * 16 * 128, BOX_BYTES, 1024);
}

// rowsum(a * b) of row rl of a warpgroup's boxes at `a` and `b`: the four
// threads of the row (t = 0..3) take 16-byte chunks t and t + 4 of each
// box (chunk c of row rl lies at c ^ (rl % 8): the swizzle) and add
template <int NB>
__device__ __forceinline__ float row_dot(const uint8_t* a, const uint8_t* b, int rl, int t) {
  float acc = 0.f;
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int c = t; c < 8; c += 4) {
      const int off = x * BOX_BYTES + rl * 128 + ((c ^ (rl % 8)) * 16);
      const uint4 av = *reinterpret_cast<const uint4*>(a + off);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 af = __bfloat1622float2(a2[e]), bf = __bfloat1622float2(b2[e]);
        acc = fmaf(af.x, bf.x, acc);
        acc = fmaf(af.y, bf.y, acc);
      }
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// A warpgroup's 64 x D accumulator times `scale`, in bf16, into its D/64
// boxes at `box`, swizzled as a TMA box expects; this thread holds rows
// rl0 and rl0 + 8, columns 8 j + 2 t and the next
template <int D>
__device__ __forceinline__ void acc_to_boxes(uint8_t* box, const float (&acc)[D / 2],
                                             float scale, int rl0, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(box + (j / 8) * BOX_BYTES + (rl0 + 8 * r) * 128 +
                                         ((j % 8) ^ g) * 16 + t * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
}

// the D/64 boxes at `box` to rows row .. row + 63 of head h of a map;
// after every thread of the warpgroup wrote its part (call from one thread)
template <int NB>
__device__ __forceinline__ void store_boxes(const CUtensorMap* map, const uint8_t* box, int h,
                                            int row, int b) {
#pragma unroll
  for (int x = 0; x < NB; ++x) hopper::tma_store_4d(map, box + x * BOX_BYTES, x * BOX, h, row, b);
  hopper::tma_store_commit();
  hopper::tma_store_wait();
}

// Pass 1: dQ, and each row's Delta and lse * log2(e) for pass 2.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WNT, Stages<D>::DQ_BLOCKS)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdq,
                    Params p) {
  using L = DqSmem<D>;
  constexpr int NB = L::NB, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* kv_full = qo_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group / column pair
  const int S = p.S;
  // Block order as the forward's: causal, the heads fastest and the q
  // tiles with the most keys first; otherwise a head's q tiles together,
  // so that its K and V come from device memory once and then from L2
  const int nq = (S + 2 * TILE - 1) / (2 * TILE);
  int h, b, q0;
  if (CAUSAL) {
    h = blockIdx.x % p.H;
    b = blockIdx.x / p.H % p.B;
    q0 = (nq - 1 - static_cast<int>(blockIdx.x / (p.H * p.B))) * 2 * TILE;
  } else {
    q0 = blockIdx.x % nq * 2 * TILE;
    h = blockIdx.x / nq % p.H;
    b = blockIdx.x / (nq * p.H);
  }
  const int hk = h / (p.H / p.Hkv);
  const int n_tiles = CAUSAL ? (min(q0 + 2 * TILE, S) - 1) / TILE + 1 : (S + TILE - 1) / TILE;

  // K and V of key tile i into stage i % STAGES (thread 0 only)
  auto load_kv = [&](int i) {
    const int s = i % STAGES;
    hopper::mbar_expect_tx(&kv_full[s], 2 * NB * BOX_BYTES);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      hopper::tma_load_4d(sm + L::K + (s * NB + x) * BOX_BYTES, &tk, &kv_full[s], x * BOX, hk,
                          i * TILE, b);
      hopper::tma_load_4d(sm + L::V + (s * NB + x) * BOX_BYTES, &tv, &kv_full[s], x * BOX, hk,
                          i * TILE, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], WNT / 32);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(qo_full, 6 * NB * BOX_BYTES);
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        const int off = (w * NB + x) * BOX_BYTES;
        hopper::tma_load_4d(sm + L::Q + off, &tq, qo_full, x * BOX, h, q0 + w * TILE, b);
        hopper::tma_load_4d(sm + L::DO + off, &tdo, qo_full, x * BOX, h, q0 + w * TILE, b);
        hopper::tma_load_4d(sm + L::O + off, &to, qo_full, x * BOX, h, q0 + w * TILE, b);
      }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }

  // this warpgroup's rows r0 .. r0 + 63; this thread's r0 + rl0 and r0 + rl0 + 8
  const int r0 = q0 + wg * TILE;
  const int rl0 = warp * 16 + g;
  const uint32_t q_s = hopper::smem_addr(sm + L::Q + wg * NB * BOX_BYTES);
  const uint32_t do_s = hopper::smem_addr(sm + L::DO + wg * NB * BOX_BYTES);
  const uint32_t k_s = hopper::smem_addr(sm + L::K);
  const uint32_t v_s = hopper::smem_addr(sm + L::V);
  const float scale2 = p.scale * LOG2E;

  // Delta and lse * log2(e) of this thread's rows (past S: 0 and +inf, so
  // that P = 0), and both for pass 2, by the first thread of each row
  hopper::mbar_wait(qo_full, 0);
  const int n_qt = (S + TILE - 1) / TILE;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = rl0 + 8 * r, row = r0 + rl;
    const float d = row_dot<NB>(sm + L::O + wg * NB * BOX_BYTES,
                                sm + L::DO + wg * NB * BOX_BYTES, rl, t);
    dl[r] = row < S ? d : 0.f;
    lse2[r] = row < S ? p.lse[(static_cast<long long>(b) * p.H + h) * S + row] * LOG2E : INFINITY;
    if (t == 0 && row < n_qt * TILE) {
      float* st = p.delta + ((static_cast<long long>(b) * p.H + h) * n_qt + row / TILE) * 2 * TILE;
      st[rl] = lse2[r];
      st[TILE + rl] = dl[r];
    }
  }

  float s[TILE / 2], dp[TILE / 2], dq[D / 2];
  uint32_t da[TILE / 16][4];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) hopper::fence_regs(da[kc]);
  };

  // An iteration issues S = Q K^T and dP = dO V^T, waits for S, computes P
  // while dP runs, waits for dP, packs dS and issues dQ += dS K, waits for
  // it and releases the stage.  Every branch around a wgmma depends on
  // the block alone, so a warpgroup that sees none of a tile's keys
  // computes it all the same, with P = 0.
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, k0 = i * TILE;
    // refill the stage that every warp released in the previous iteration
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_tiles) {
      hopper::mbar_wait(&kv_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_kv(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t kst = k_s + st * NB * BOX_BYTES, vst = v_s + st * NB * BOX_BYTES;
      hopper::mbar_wait(&kv_full[st], (i / STAGES) & 1);
      fence_all();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<TILE, 0, 0>(s, kmajor(q_s, kk), kmajor(kst, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<TILE, 0, 0>(dp, kmajor(do_s, kk), kmajor(vst, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      // s[x]: row r0 + rl0 + 8 ((x >> 1) & 1), key k0 + 8 (x / 4) + 2 t + (x & 1)
#pragma unroll
      for (int x = 0; x < TILE / 2; ++x) {
        const int r = (x >> 1) & 1;
        s[x] = hopper::exp2_approx(fmaf(s[x], scale2, -lse2[r]));
        if constexpr (decltype(masked)::value) {
          const int key = k0 + (x / 4) * 8 + 2 * t + (x & 1);
          s[x] = key >= S || (CAUSAL && key > r0 + rl0 + 8 * r) ? 0.f : s[x];
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int x = 0; x < TILE / 2; ++x)
        dp[x] = s[x] * (dp[x] - dl[(x >> 1) & 1]);  // dq: dS = P (dP - Delta)
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          da[kc][e] = hopper::pack_bf16(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1]);
      fence_all();
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc)
        hopper::wgmma_rs<D, 1>(dq, da[kc], mnmajor(kst, kc), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[st]);
    };
    // the causal diagonal, and the tile holding S's ragged end
    if (k0 + TILE > S || (CAUSAL && k0 + TILE - 1 > q0))
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  if (r0 >= S) return;  // the whole warpgroup lies past S
  acc_to_boxes<D>(sm + L::Q + wg * NB * BOX_BYTES, dq, p.scale, rl0, g, t);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) store_boxes<NB>(&tdq, sm + L::Q + wg * NB * BOX_BYTES, h, r0, b);
}

// Pass 2: dK and dV, reading the lse and Delta that pass 1 wrote.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WNT, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv, Params p) {
  using L = KvSmem<D>;
  constexpr int NB = L::NB, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int S = p.S;
  // Block order: causal, the key tiles that the most q tiles see first;
  // otherwise a kv head's key tiles together (its q and dO from L2)
  const int nk = (S + 2 * TILE - 1) / (2 * TILE);
  int kt, hk, b;
  if (CAUSAL) {
    hk = blockIdx.x % p.Hkv;
    b = blockIdx.x / p.Hkv % p.B;
    kt = blockIdx.x / (p.Hkv * p.B);
  } else {
    kt = blockIdx.x % nk;
    hk = blockIdx.x / nk % p.Hkv;
    b = blockIdx.x / (nk * p.Hkv);
  }
  const int k0 = kt * 2 * TILE;
  const int rep = p.H / p.Hkv;
  const int n_qt = (S + TILE - 1) / TILE;
  const int qt_lo = CAUSAL ? k0 / TILE : 0;  // the first q tile that sees a key of the block
  const int nq = n_qt - qt_lo;
  const int n_iter = rep * nq;  // the ring runs over rep heads x q tiles

  // Q, dO, lse and Delta of iteration i into stage i % STAGES (thread 0 only)
  auto load_q = [&](int i) {
    const int s = i % STAGES, h = hk * rep + i / nq, qt = qt_lo + i % nq;
    hopper::mbar_expect_tx(&q_full[s], 2 * NB * BOX_BYTES + STAT_BYTES);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      hopper::tma_load_4d(sm + L::Q + (s * NB + x) * BOX_BYTES, &tq, &q_full[s], x * BOX, h,
                          qt * TILE, b);
      hopper::tma_load_4d(sm + L::DO + (s * NB + x) * BOX_BYTES, &tdo, &q_full[s], x * BOX, h,
                          qt * TILE, b);
    }
    hopper::bulk_load(sm + L::STAT + s * STAT_BYTES,
                      p.delta + ((static_cast<long long>(b) * p.H + h) * n_qt + qt) * 2 * TILE,
                      STAT_BYTES, &q_full[s]);
  };
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], WNT / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_full, 4 * NB * BOX_BYTES);
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        const int off = (w * NB + x) * BOX_BYTES;
        hopper::tma_load_4d(sm + L::K + off, &tk, kv_full, x * BOX, hk, k0 + w * TILE, b);
        hopper::tma_load_4d(sm + L::V + off, &tv, kv_full, x * BOX, hk, k0 + w * TILE, b);
      }
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_q(i);
  }

  // this warpgroup's keys k0 + 64 wg ..; this thread's key0 and key0 + 8
  const int rl0 = warp * 16 + g;
  const int key0 = k0 + wg * TILE + rl0;
  const uint32_t k_s = hopper::smem_addr(sm + L::K + wg * NB * BOX_BYTES);
  const uint32_t v_s = hopper::smem_addr(sm + L::V + wg * NB * BOX_BYTES);
  const uint32_t q_s = hopper::smem_addr(sm + L::Q);
  const uint32_t do_s = hopper::smem_addr(sm + L::DO);
  const float scale2 = p.scale * LOG2E;

  float s[TILE / 2], dp[TILE / 2], dk[D / 2], dv[D / 2];
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
      hopper::fence_regs(pa[kc]);
      hopper::fence_regs(da[kc]);
    }
  };
  hopper::mbar_wait(kv_full, 0);

  // An iteration issues S^T = K Q^T and dP^T = V dO^T, waits for S^T,
  // computes P^T while dP^T runs, waits, forms dS^T, packs both and issues
  // dV += P^T dO and dK += dS^T Q, waits for them and releases the stage.
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % STAGES, q0 = (qt_lo + i % nq) * TILE;
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_iter) {
      hopper::mbar_wait(&q_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_q(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t qst = q_s + st * NB * BOX_BYTES, dost = do_s + st * NB * BOX_BYTES;
      const float* lse2 = reinterpret_cast<const float*>(sm + L::STAT + st * STAT_BYTES);
      const float* dl = lse2 + TILE;
      hopper::mbar_wait(&q_full[st], (i / STAGES) & 1);
      fence_all();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<TILE, 0, 0>(s, kmajor(k_s, kk), kmajor(qst, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<TILE, 0, 0>(dp, kmajor(v_s, kk), kmajor(dost, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      // s[4 j + e]: key key0 + 8 (e >> 1), q row q0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          s[x] = hopper::exp2_approx(fmaf(s[x], scale2, -(e & 1 ? l.y : l.x)));
          if constexpr (decltype(masked)::value)
            s[x] = key0 + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1) ? 0.f : s[x];
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x));  // dS^T
      }
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kc][e] = hopper::pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
          da[kc][e] = hopper::pack_bf16(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1]);
        }
      fence_all();
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc)
        hopper::wgmma_rs<D, 1>(dv, pa[kc], mnmajor(dost, kc), 1);
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc)
        hopper::wgmma_rs<D, 1>(dk, da[kc], mnmajor(qst, kc), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) hopper::mbar_arrive(&q_empty[st]);
    };
    // causal: the q tiles that hold a row before one of the block's keys
    if (CAUSAL && k0 + 2 * TILE - 1 > q0)
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  const int kr0 = k0 + wg * TILE;
  if (kr0 >= S) return;  // the whole warpgroup lies past S
  acc_to_boxes<D>(sm + L::K + wg * NB * BOX_BYTES, dk, p.scale, rl0, g, t);
  acc_to_boxes<D>(sm + L::V + wg * NB * BOX_BYTES, dv, 1.f, rl0, g, t);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) {
    store_boxes<NB>(&tdk, sm + L::K + wg * NB * BOX_BYTES, hk, kr0, b);
    store_boxes<NB>(&tdv, sm + L::V + wg * NB * BOX_BYTES, hk, kr0, b);
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t set_smem(K kernel, int smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <int D, bool CAUSAL>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  auto dq = dq_wgmma_kernel<D, CAUSAL>;
  auto dkdv = dkdv_wgmma_kernel<D, CAUSAL>;
  static bool dq_ok = false, dkdv_ok = false;
  cudaError_t e;
  if ((e = set_smem(dq, DqSmem<D>::BYTES, &dq_ok)) != cudaSuccess) return e;
  if ((e = set_smem(dkdv, KvSmem<D>::BYTES, &dkdv_ok)) != cudaSuccess) return e;
  // the gradients are contiguous
  const long long q_row = static_cast<long long>(p.H) * D;
  const long long kv_row = static_cast<long long>(p.Hkv) * D;
  CUtensorMap tq, tdo, to, tk, tv, tdq, tdk, tdv;
  if (!hopper::bhsd_map(&tq, p.q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, TILE) ||
      !hopper::bhsd_map(&tdo, p.dout, p.B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, TILE) ||
      !hopper::bhsd_map(&to, p.o, p.B, p.S, p.H, D, p.o_sb, p.o_ss, p.o_sh, TILE) ||
      !hopper::bhsd_map(&tk, p.k, p.B, p.S, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh, TILE) ||
      !hopper::bhsd_map(&tv, p.v, p.B, p.S, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh, TILE) ||
      !hopper::bhsd_map(&tdq, p.dq, p.B, p.S, p.H, D, p.S * q_row, q_row, D, TILE) ||
      !hopper::bhsd_map(&tdk, p.dk, p.B, p.S, p.Hkv, D, p.S * kv_row, kv_row, D, TILE) ||
      !hopper::bhsd_map(&tdv, p.dv, p.B, p.S, p.Hkv, D, p.S * kv_row, kv_row, D, TILE))
    return cudaErrorInvalidValue;
  const unsigned n2 = (p.S + 2 * TILE - 1) / (2 * TILE);
  dq<<<n2 * p.H * p.B, WNT, DqSmem<D>::BYTES, st>>>(tq, tdo, to, tk, tv, tdq, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv<<<n2 * p.Hkv * p.B, WNT, KvSmem<D>::BYTES, st>>>(tq, tdo, tk, tv, tdk, tdv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  static bool dq_ok = false, dkdv_ok = false;
  const long long n_rows = static_cast<long long>(p.B) * p.S * p.H;
  delta_kernel<float, D><<<static_cast<unsigned>((n_rows * 32 + 255) / 256), 256, 0, st>>>(p);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(dq_f32_kernel<float, D>, dq_smem_bytes<D>(), &dq_ok)) != cudaSuccess) return e;
  dq_f32_kernel<float, D><<<dim3((p.S + BQ - 1) / BQ, p.H, p.B), NT, dq_smem_bytes<D>(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(dkdv_f32_kernel<float, D>, dkdv_smem_bytes<D>(), &dkdv_ok)) != cudaSuccess)
    return e;
  dkdv_f32_kernel<float, D>
      <<<dim3((p.S + BK - 1) / BK, p.Hkv, p.B), NT, dkdv_smem_bytes<D>(), st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_f32<D>(p, st);
  if (dtype == 1) return p.causal ? launch_bf16<D, true>(p, st) : launch_bf16<D, false>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Inputs (B, S, H|Hkv, D) with the given strides (elements, D contiguous);
// lse (B, H, S) f32 from the forward; delta f32 scratch of B H ceil(S/64)
// 128 elements; dq, dk, dv contiguous in the inputs' dtype.  dtype: 0 =
// float32, 1 = bfloat16 (then q, k, v, o and dout must start on a 16-byte
// boundary with strides of whole 16 bytes: the TMA's rule).  Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long o_sb, long long o_ss,
                                   long long o_sh, long long do_sb, long long do_ss,
                                   long long do_sh, int B, int S, int H, int Hkv, int D,
                                   int dtype, int causal, float scale, void* stream) {
  Params p{q,    k,    v,    o,    dout, lse,  delta, dq,    dk,    dv,    q_sb,  q_ss,
           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  o_sb,  o_ss,  o_sh,  do_sb, do_ss,
           do_sh, B,   S,    H,    Hkv,  causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  if (D == 64) return static_cast<int>(launch_d<64>(p, dtype, st));
  if (D == 128) return static_cast<int>(launch_d<128>(p, dtype, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
