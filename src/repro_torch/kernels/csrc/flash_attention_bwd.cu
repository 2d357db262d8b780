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
// Design.  Three launches, no atomics, so every gradient is the same bit
// for bit from run to run:
//   1. delta: one warp per (b, s, h) row computes Delta.
//   2. dq: one block per (q tile of 64 rows, head, batch) loops over the
//      k tiles that the mask leaves and accumulates its dQ tile in
//      registers (the separate pass over q tiles replaces the float
//      atomicAdd of FlashAttention-2's single pass).
//   3. dkdv: one block per (k tile of 64 keys, kv head, batch) loops over
//      the rep query heads and the q tiles that see its keys, and
//      accumulates its dK and dV tiles in registers.
// Two bodies, chosen by dtype:
// - bf16 (the training path): four warps, each owning 16 rows of the
//   block's tile; every product is an mma.sync m16n8k16 bf16 product with
//   f32 accumulators, operands fetched from shared memory by ldmatrix
//   (rows padded by 16 bytes).  dkdv computes the transposed tiles
//   S^T = K q^T and dP^T = V dO^T, so that P^T and dS^T come out of the
//   accumulators already in the A-operand layout of dV = P^T dO and
//   dK = dS^T q; dq takes dS straight from its accumulators for dQ = dS K.
//   P and dS are rounded to bf16 as operands of those three products,
//   as the forward rounds P for P.V.  Tiles arrive by cp.async.
// - f32: the same tiles on the CUDA cores in f32 (a 4 x 8 score tile and
//   a 4 x D/8 output tile per thread, tiles in shared memory at an odd
//   row stride), exact to the f32 reference.
//
// Bound on the H100.  Five (S, S, D) products per (batch, head): 10 S^2 D
// flops against ~(8 H + 6 Hkv) S D elements of traffic, far above the
// ridge, so the bound is the 989 TFLOP/s bf16 tensor-core peak.  These
// kernels do seven products (dq recomputes S and dP) with mma.sync, not
// wgmma, and load each tile without double buffering: a share of that
// peak, the rest for a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block of dq / dkdv
constexpr int SLD = 65;  // row stride of the (64 x 64) score tiles in smem

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem, bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; pred false
// zero-fills the 16 bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 x 16) of columns 16 kc .. 16 kc + 15 of a warp's
// 16 x 64 accumulator tile, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[8][4], int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S), written by pass 1
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


// ------------------------------------------------------- bf16 on mma.sync
using bf16 = __nv_bfloat16;

template <int D>
constexpr int mma_smem_bytes() {
  return 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;  // four bf16 tiles, lse and delta
}

// rows [s0, s0 + 64) of one head into smem rows of D + 8 elements, by
// cp.async (the caller commits and waits); rows past S zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long ss,
                                                int s0, int S) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async16(dst + r * (D + 8) + c, in ? src + s * ss + c : src, in);
  }
}

// lse and delta of the 64 rows from q0 (0 past S)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s, const Params& p,
                                               long long row0, int q0) {
  if (threadIdx.x < 64) {
    const int s = q0 + threadIdx.x;
    lse_s[threadIdx.x] = s < p.S ? p.lse[row0 + s] : 0.f;
    dl_s[threadIdx.x] = s < p.S ? p.delta[row0 + s] : 0.f;
  }
}

// c[8][4] += A (this warp's 16 rows of As, over D) times B^T, where B is
// the 64 rows of Bs (both row-major in smem, row stride D + 8)
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const bf16* As, const bf16* Bs,
                                        int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, As + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kc * 16 +
                   (lane >> 4) * 8, false);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];  // B fragments of n tiles 2np (b0, b1) and 2np + 1 (b2, b3)
      ldsm_x4(b, Bs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                     ((lane >> 3) & 1) * 8, false);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += A (a warp's 16 x 64 accumulator tile, rounded to bf16)
// times Bs (64 rows x D, row-major in smem)
template <int D>
__device__ __forceinline__ void mma_acc_b(float (&acc)[D / 8][4], const float (&c)[8][4],
                                          const bf16* Bs, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    acc_to_a(a, c, kc);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];  // B fragments of output tiles 2dp (b0, b1) and 2dp + 1 (b2, b3)
      ldsm_x4(b, Bs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                     (lane >> 4) * 8, true);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// dq: each warp owns q rows q0 + 16 warp + {g, g + 8}
template <int D>
__global__ void __launch_bounds__(NT) dq_mma_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + 64 * LD;
  bf16* Ks = dOs + 64 * LD;
  bf16* Vs = Ks + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + 64 * LD);
  float* dl_s = lse_s + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int hk = h / (p.H / p.Hkv);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * S;

  load_tile_async<D>(Qs, qp, p.q_ss, q0, S);
  load_tile_async<D>(dOs, dop, p.do_ss, q0, S);
  load_row_stats(lse_s, dl_s, p, row0, q0);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int rloc[2] = {warp * 16 + g, warp * 16 + g + 8};

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < kt_hi; ++kt) {  // every k tile adds to dq
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile_async<D>(Ks, kp, p.k_ss, k0, S);
    load_tile_async<D>(Vs, vp, p.v_ss, k0, S);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    float sc[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = ds[j][e] = 0.f;
    mma_abt<D>(sc, Qs, Ks, warp, lane);
    mma_abt<D>(ds, dOs, Vs, warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = rloc[e >> 1];
        const int qi = q0 + rl, kj = k0 + j * 8 + 2 * t + (e & 1);
        bool ok = qi < S && kj < S;
        if (p.causal) ok = ok && kj <= qi;
        const float pw = ok ? expf(sc[j][e] * p.scale - lse_s[rl]) : 0.f;
        ds[j][e] = pw * (ds[j][e] - dl_s[rl]);
      }
    mma_acc_b<D>(acc, ds, Ks, lane);
  }

  bf16* dqp = static_cast<bf16*>(p.dq) + (static_cast<long long>(b) * S * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rloc[r];
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<long long>(qi) * p.H * D + j * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
  }
}

// dk, dv: each warp owns keys k0 + 16 warp + {g, g + 8}
template <int D>
__global__ void __launch_bounds__(NT) dkdv_mma_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + 64 * LD;
  bf16* Qs = Vs + 64 * LD;
  bf16* dOs = Qs + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + 64 * LD);
  float* dl_s = lse_s + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int rep = p.H / p.Hkv;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_async<D>(Ks, kp, p.k_ss, k0, S);
  load_tile_async<D>(Vs, vp, p.v_ss, k0, S);
  asm volatile("cp.async.commit_group;\n" ::);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  const int qt_lo = p.causal ? k0 / BQ : 0;  // q tiles that see a key of this tile
  const int n_qt = (S + BQ - 1) / BQ;
  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr;
    const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * S;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile_async<D>(Qs, qp, p.q_ss, q0, S);
      load_tile_async<D>(dOs, dop, p.do_ss, q0, S);
      asm volatile("cp.async.commit_group;\n" ::);
      load_row_stats(lse_s, dl_s, p, row0, q0);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      // S^T and dP^T: rows are this warp's keys, columns the tile's q rows
      float sc[8][4], ds[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = ds[j][e] = 0.f;
      mma_abt<D>(sc, Ks, Qs, warp, lane);
      mma_abt<D>(ds, Vs, dOs, warp, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t + (e & 1);
          const int qi = q0 + ql, kj = key[e >> 1];
          bool ok = qi < S && kj < S;
          if (p.causal) ok = ok && kj <= qi;
          const float pw = ok ? expf(sc[j][e] * p.scale - lse_s[ql]) : 0.f;
          sc[j][e] = pw;
          ds[j][e] = pw * (ds[j][e] - dl_s[ql]);
        }
      mma_acc_b<D>(dv, sc, dOs, lane);  // dV += P^T dO
      mma_acc_b<D>(dk, ds, Qs, lane);   // dK += dS^T q
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const long long kv_row = static_cast<long long>(p.Hkv) * D;
  bf16* dkp = static_cast<bf16*>(p.dk) + (static_cast<long long>(b) * S * p.Hkv + hk) * D;
  bf16* dvp = static_cast<bf16*>(p.dv) + (static_cast<long long>(b) * S * p.Hkv + hk) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key[r];
    if (kj >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + kj * kv_row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kj * kv_row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <typename DQ, typename DKDV>
cudaError_t launch_passes(const Params& p, cudaStream_t st, DQ dq, int dq_smem, bool* dq_ok,
                          DKDV dkdv, int dkdv_smem, bool* dkdv_ok) {
  cudaError_t e;
  if ((e = set_smem(dq, dq_smem, dq_ok)) != cudaSuccess) return e;
  dq<<<dim3((p.S + BQ - 1) / BQ, p.H, p.B), NT, dq_smem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(dkdv, dkdv_smem, dkdv_ok)) != cudaSuccess) return e;
  dkdv<<<dim3((p.S + BK - 1) / BK, p.Hkv, p.B), NT, dkdv_smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t st) {
  static bool dq_ok = false, dkdv_ok = false;
  const long long n_rows = static_cast<long long>(p.B) * p.S * p.H;
  delta_kernel<T, D><<<static_cast<unsigned>((n_rows * 32 + 255) / 256), 256, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (sizeof(T) == 2)
    return launch_passes(p, st, dq_mma_kernel<D>, mma_smem_bytes<D>(), &dq_ok,
                         dkdv_mma_kernel<D>, mma_smem_bytes<D>(), &dkdv_ok);
  else
    return launch_passes(p, st, dq_f32_kernel<T, D>, dq_smem_bytes<D>(), &dq_ok,
                         dkdv_f32_kernel<T, D>, dkdv_smem_bytes<D>(), &dkdv_ok);
}

}  // namespace

// Inputs (B, S, H|Hkv, D) with the given strides (elements, D contiguous);
// lse (B, H, S) f32 from the forward; delta (B, H, S) f32 scratch; dq, dk,
// dv contiguous in the inputs' dtype.  dtype: 0 = float32, 1 = bfloat16
// (then every row of q, k, v, o and dout must start on a 16-byte
// boundary).  Returns a cudaError_t (0 = launched).
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
  if (dtype == 0 && D == 64) return launch<float, 64>(p, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, st);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
