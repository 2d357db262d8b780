// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), f32 and bf16.
//
// Replaces the backward the JAX package takes of its TPU kernel `ssd_scan`
// (kernels/ssd_scan.py): `_ssd_bwd` in kernels/ops.py, the jax.vjp of the
// oracle `ssd_ref`.  It computes what that vjp computes, not the forward
// carried backwards.  Per (batch b, head h, chunk of L steps), with acs the
// chunk's inclusive cumsum of dt A, acs_L its value at the chunk's end,
// E[l,s] = exp(acs_l - acs_s) for s <= l (the exponent masked to -inf above
// the diagonal BEFORE the exp, as in the forward), w_s = exp(acs_L - acs_s)
// dt_s, S the state entering the chunk and dS the gradient of the state
// leaving it:
//   dx_s  = sum_{l>=s} (C_l.B_s) E dt_s gy_l + w_s B_s dS
//   dC_l  = exp(acs_l) S gy_l + sum_{s<=l} (gy_l.x_s) E dt_s B_s
//   dB_s  = sum_{l>=s} (gy_l.x_s) E dt_s C_l + w_s dS x_s
//   ddt_s = sum_{l>=s} (gy_l.x_s)(C_l.B_s) E + exp(acs_L - acs_s) B_s.dS.x_s
//           + A da_s,   dA = sum over batch, chunks and steps of dt_s da_s
// where da is the reverse cumsum within the chunk of the gradient of acs:
// y's inter-chunk term at l, each intra pair at l and (negated) at s, the
// state update at s and at L, and the state's decay exp(acs_L) <dS, S> at L.
// dB and dC sum the heads of their group.  kernels/ref.py has each pass in
// plain code (ssd_chunk_states + ssd_carry, ssd_chunk_state_grads +
// ssd_carry_grads, ssd_chunk_grads, ssd_head_sums).
//
// Five launches, no atomics: every sum is taken in one fixed order, so the
// gradients repeat bit for bit (the resume gates depend on it).
//   1. ssd_bwd_state: one block per (chunk, head, batch) takes the chunk's
//      cumsum and writes its own state update U_c = sum_s w_s B_s x_s^T,
//      its decay exp(acs_L), and V_c = sum_l exp(acs_l) C_l gy_l^T, what
//      y's inter-chunk term sends back to the state entering the chunk.
//   2. ssd_bwd_carry: the only sequential part, elementwise on (N, P) in
//      chunk order: state_in(c + 1) = exp(acs_L(c)) state_in(c) + U_c
//      forwards (from zeros), dS_out(c - 1) = exp(acs_L(c)) dS_out(c) + V_c
//      backwards from dS_out(last) = the final state's gradient; each
//      replaces its U_c or V_c in place.
//   3. ssd_bwd_grad: one block per (chunk, head, batch).  Two sweeps over
//      the causal pairs of TL-row tiles (TL = 64, or 32 when L is not a
//      multiple of 64): sweep 1 holds an s tile and walks the l tiles on or
//      after it (dx, dB, ddt's direct terms and acs's gradient at s, plus
//      the state terms of the s rows from dS), sweep 2 holds an l tile and
//      walks the s tiles on or before it (dC, acs's gradient at l, plus the
//      inter-chunk terms from S).  Each pair recomputes C B^T and gy x^T
//      on the CUDA cores in f32 from register tiles.  Then the reverse
//      cumsum gives ddt and the block's partial of dA.  dB and dC go out
//      per head in f32.
//   4. ssd_bwd_heads: dB and dC as the sums of each group's heads, in head
//      order, in the inputs' dtype.
//   5. ssd_bwd_dA: dA as the sum of its (batch, chunk) partials, in order.
// A ragged S is not padded in memory: steps past S load as zeros (dt = 0:
// E and w stay finite and every product with them vanishes), so the last
// chunk's acs_L is its last real step's, and nothing past S is stored.
// Every operand is read as f32 and all arithmetic is f32, for both dtypes:
// the only bf16 roundings are those of dx, dB and dC on the way out.
//
// Bound on the H100 (67 TFLOP/s f32 outside the tensor cores, 989 bf16,
// 3.35 TB/s).  The function needs, per (batch, head, chunk of n steps),
// five products over the chunk's (n, N, P): U_c, V_c, B dS, dS x and S gy;
// over the n (n + 1) / 2 causal pairs, gy x^T (P) and M^T gy for dx (P).
// Per (batch, group, chunk) it needs C B^T over the pairs and the weighted
// sums for dB and dC (N each): those are linear in the pair weights, so the
// weights summed over the group's heads serve them once.  At mamba2-130m's
// train shape (B 16, S 1024, H 24, P 64, G 1, N 128, L 256) that is 46.8
// GFLOP, 0.70 ms at the f32 peak, 0.047 ms at the bf16 one; moving the
// inputs and the gradients once takes 0.055 ms in bf16, its bound there.
// This body runs every product on the CUDA cores in f32, and the dB and dC
// sums per head: a simple kernel that is right, far from the bf16 bound (a
// wgmma / TMA redesign is ROADMAP B4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "ssd_common.cuh"

namespace {

constexpr int MAX_N = 128;       // d_state
constexpr int NR = MAX_N / 16;   // columns of N per thread (n = tx + 16 j)
constexpr int MAX_L = NT;        // one thread per step in the cumsums

struct Params {
  const void* x;        // (B, S, H, P)
  const float* dt;      // (B, S, H)
  const float* A;       // (H,)
  const void* Bm;       // (B, S, G, N)
  const void* Cm;       // (B, S, G, N)
  const void* gy;       // (B, S, H, P)
  const float* gstate;  // (B, H, N, P)
  void* dx;             // (B, S, H, P)
  float* ddt;           // (B, S, H)
  float* dA;            // (H,)
  void* dB;             // (B, S, G, N)
  void* dC;             // (B, S, G, N)
  float* states;        // (B, nc, H, N, P): U_c after pass 1, state_in(c) after pass 2
  float* dstates;       // (B, nc, H, N, P): V_c after pass 1, dS_out(c) after pass 2
  float* dBh;           // (B, S, H, N): dB of each head
  float* dCh;           // (B, S, H, N): dC of each head
  float* cdec;          // (B, nc, H): exp(acs_L) of each chunk
  float* dAp;           // (B, nc, H): the chunks' partials of dA
  int B, S, H, P, G, N, L, nc;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// the sum of one value per thread over the block, in one fixed order;
// valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) wsum[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < NT / 32; ++k) s += wsum[k];
  __syncthreads();
  return s;
}

// the chunk's dt (0 past S), acs = its inclusive cumsum of dt A, w_s =
// exp(acs_L - acs_s) dt_s and e_l = exp(acs_l), for the L steps of chunk c;
// acs_L = acs[L - 1], which past S keeps the last real step's value.  Every
// pass computes the same bits.
__device__ __forceinline__ void chunk_setup(const Params& p, int b, int c, int h, int valid,
                                            float* dts, float* acs, float* wv, float* ev,
                                            float* wsum) {
  const int t = threadIdx.x, L = p.L;
  float a = 0.f;
  if (t < L) {
    const float d =
        t < valid ? p.dt[(static_cast<long long>(b) * p.S + c * L + t) * p.H + h] : 0.f;
    dts[t] = d;
    a = d * p.A[h];
  }
  a = block_inclusive_scan(a, wsum);
  if (t < L) acs[t] = a;
  __syncthreads();
  const float last = acs[L - 1];
  if (t < L) {
    wv[t] = expf(last - acs[t]) * dts[t];
    ev[t] = expf(acs[t]);
  }
  __syncthreads();
}

// shared-memory floats of pass 1 (every array a multiple of 4 floats)
__host__ __device__ constexpr int state_smem(int L, int N, int P, int TL) {
  return 4 * L + 8 + 2 * TL * (N + 4) + 2 * TL * (P + 4);
}

// shared-memory floats of pass 3
__host__ __device__ constexpr int grad_smem(int L, int N, int P, int TL) {
  return 7 * L + 16 + N * (P + 4) + 2 * TL * (N + 4) + 2 * TL * (P + 4) + 3 * TL * (TL + 4);
}

static_assert(grad_smem(MAX_L, MAX_N, 64, 64) * 4 <= 232448, "a block has 227 KB");

// pass 1: U_c, V_c and the decay of one (chunk, head, batch).  Thread (ty,
// tx) owns rows n = ty + 16 i and columns p = tx + 16 j of both.
template <typename T, int TL, int PJ>
__global__ void __launch_bounds__(NT) ssd_bwd_state_kernel(Params p) {
  constexpr int P = 16 * PJ, XS = P + 4;
  extern __shared__ __align__(16) float sm[];
  const int L = p.L, N = p.N, NS = N + 4;
  float* dts = sm;
  float* acs = dts + L;
  float* wv = acs + L;
  float* ev = wv + L;
  float* wsum = ev + L;     // [8]
  float* Bt = wsum + 8;     // [TL][NS]
  float* Ct = Bt + TL * NS;
  float* xt = Ct + TL * NS;  // [TL][XS], w_s x_s
  float* gt = xt + TL * XS;  // [TL][XS], e_l gy_l

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int c0 = c * L, valid = min(L, p.S - c0);
  chunk_setup(p, b, c, h, valid, dts, acs, wv, ev, wsum);

  const long long xss = static_cast<long long>(p.H) * P, bss = static_cast<long long>(p.G) * N;
  const long long xo = (static_cast<long long>(b) * p.S + c0) * xss + static_cast<long long>(h) * P;
  const long long bo = (static_cast<long long>(b) * p.S + c0) * bss + static_cast<long long>(g) * N;
  const T* x = static_cast<const T*>(p.x) + xo;
  const T* gy = static_cast<const T*>(p.gy) + xo;
  const T* Bg = static_cast<const T*>(p.Bm) + bo;
  const T* Cg = static_cast<const T*>(p.Cm) + bo;

  float U[NR][PJ], V[NR][PJ];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) U[i][j] = V[i][j] = 0.f;

  for (int s0 = 0; s0 < valid; s0 += TL) {
    const int rows = min(TL, valid - s0);
    load_rows<T>(Bt, NS, Bg + s0 * bss, bss, TL, rows, N);
    load_rows<T>(Ct, NS, Cg + s0 * bss, bss, TL, rows, N);
    load_rows<T>(xt, XS, x + s0 * xss, xss, TL, rows, P);
    load_rows<T>(gt, XS, gy + s0 * xss, xss, TL, rows, P);
    __syncthreads();
    for (int e = t; e < rows * P; e += NT) {
      const int r = e / P, q = e - r * P;
      xt[r * XS + q] *= wv[s0 + r];
      gt[r * XS + q] *= ev[s0 + r];
    }
    __syncthreads();
    for (int s = 0; s < rows; ++s) {
      float xv[PJ], gv[PJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        xv[j] = xt[s * XS + tx + 16 * j];
        gv[j] = gt[s * XS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int n = ty + 16 * i;
        if (n < N) {
          const float bn = Bt[s * NS + n], cn = Ct[s * NS + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            U[i][j] = fmaf(bn, xv[j], U[i][j]);
            V[i][j] = fmaf(cn, gv[j], V[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  const long long so = ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * P;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int n = ty + 16 * i;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        p.states[so + n * P + tx + 16 * j] = U[i][j];
        p.dstates[so + n * P + tx + 16 * j] = V[i][j];
      }
    }
  }
  if (t == 0) p.cdec[(static_cast<long long>(b) * p.nc + c) * p.H + h] = expf(acs[L - 1]);
}

// pass 2: the forward carry of the states and the reverse carry of their
// gradients, 4 elements of (N, P) a thread, in chunk order
__global__ void __launch_bounds__(NT) ssd_bwd_carry_kernel(Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int np = p.N * p.P;
  const int e = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e >= np) return;
  const long long cs = static_cast<long long>(p.H) * np;   // chunk stride
  const long long base = (static_cast<long long>(b) * p.nc * p.H + h) * np + e;
  const float* dec = p.cdec + static_cast<long long>(b) * p.nc * p.H + h;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < p.nc; ++c) {
    float4* q = reinterpret_cast<float4*>(p.states + base + c * cs);
    const float4 u = *q;
    *q = st;
    const float d = dec[c * p.H];
    st = make_float4(fmaf(d, st.x, u.x), fmaf(d, st.y, u.y), fmaf(d, st.z, u.z),
                     fmaf(d, st.w, u.w));
  }
  float4 r = *reinterpret_cast<const float4*>(p.gstate + (static_cast<long long>(b) * p.H + h) * np + e);
  for (int c = p.nc - 1; c >= 0; --c) {
    float4* q = reinterpret_cast<float4*>(p.dstates + base + c * cs);
    const float4 v = *q;
    *q = r;
    const float d = dec[c * p.H];  // exp(acs_L) of the chunk, carried back
    r = make_float4(fmaf(d, r.x, v.x), fmaf(d, r.y, v.y), fmaf(d, r.z, v.z), fmaf(d, r.w, v.w));
  }
}

// the (l tile, s tile) pair's products in registers, thread (ty, tx) at rows
// l = l0 + ty + 16 i and columns s = s0 + tx + 16 j: CB = C_l.B_s, G =
// gy_l.x_s; then R = G CB E, W = G E dt_s and (when M is given) M = CB E
// dt_s, each a [TL][TL + 4] tile in shared memory
template <int TL, int PJ>
__device__ __forceinline__ void pair_tiles(const float* Ct, const float* Bt, const float* gt,
                                           const float* xt, int N, const float* acs,
                                           const float* dts, int l0, int s0, float* Rt,
                                           float* Mt, float* Wt) {
  constexpr int RM = TL / 16, XS = 16 * PJ + 4, SS = TL + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, NS = N + 4;
  float cb[RM][RM], gg[RM][RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) cb[i][j] = gg[i][j] = 0.f;
  for (int n = 0; n < N; n += 4) {
    float4 cv[RM], bv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) cv[i] = *reinterpret_cast<const float4*>(Ct + (ty + 16 * i) * NS + n);
#pragma unroll
    for (int j = 0; j < RM; ++j) bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * NS + n);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) cb[i][j] = dot4(cv[i], bv[j], cb[i][j]);
  }
#pragma unroll
  for (int q = 0; q < 16 * PJ; q += 4) {
    float4 gv[RM], xv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) gv[i] = *reinterpret_cast<const float4*>(gt + (ty + 16 * i) * XS + q);
#pragma unroll
    for (int j = 0; j < RM; ++j) xv[j] = *reinterpret_cast<const float4*>(xt + (tx + 16 * j) * XS + q);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) gg[i][j] = dot4(gv[i], xv[j], gg[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int l = l0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int s = s0 + tx + 16 * j;
      const float e = expf(s <= l ? acs[l] - acs[s] : -INFINITY);
      const float d = dts[s];
      const int k = (ty + 16 * i) * SS + tx + 16 * j;
      Rt[k] = gg[i][j] * cb[i][j] * e;
      Wt[k] = gg[i][j] * e * d;
      if (Mt) Mt[k] = cb[i][j] * e * d;
    }
  }
}

// pass 3: every gradient of one (chunk, head, batch); see the header
template <typename T, int TL, int PJ>
__global__ void __launch_bounds__(NT) ssd_bwd_grad_kernel(Params p) {
  constexpr int P = 16 * PJ, XS = P + 4, RM = TL / 16, SS = TL + 4;
  extern __shared__ __align__(16) float sm[];
  const int L = p.L, N = p.N, NS = N + 4;
  float* dts = sm;
  float* acs = dts + L;
  float* wv = acs + L;
  float* ev = wv + L;
  float* dacs = ev + L;      // the gradient of acs, then (after the scan) da
  float* ddt = dacs + L;     // ddt's direct terms
  float* qv = ddt + L;       // the state update's terms of acs's gradient at s
  float* wsum = qv + L;      // [16]
  float* St = wsum + 16;     // [N][XS]: dS in sweep 1, S in sweep 2
  float* Bt = St + N * XS;   // [TL][NS]
  float* Ct = Bt + TL * NS;
  float* xt = Ct + TL * NS;  // [TL][XS]
  float* gt = xt + TL * XS;
  float* Rt = gt + TL * XS;  // [TL][SS]
  float* Mt = Rt + TL * SS;
  float* Wt = Mt + TL * SS;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int c0 = c * L, valid = min(L, p.S - c0), nt = (valid + TL - 1) / TL;
  for (int i = t; i < L; i += NT) dacs[i] = ddt[i] = qv[i] = 0.f;
  chunk_setup(p, b, c, h, valid, dts, acs, wv, ev, wsum);

  const long long xss = static_cast<long long>(p.H) * P, bss = static_cast<long long>(p.G) * N;
  const long long hss = static_cast<long long>(p.H) * N;
  const long long xo = (static_cast<long long>(b) * p.S + c0) * xss + static_cast<long long>(h) * P;
  const long long bo = (static_cast<long long>(b) * p.S + c0) * bss + static_cast<long long>(g) * N;
  const long long ho = (static_cast<long long>(b) * p.S + c0) * hss + static_cast<long long>(h) * N;
  const long long so = ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * P;
  const T* x = static_cast<const T*>(p.x) + xo;
  const T* gy = static_cast<const T*>(p.gy) + xo;
  const T* Bg = static_cast<const T*>(p.Bm) + bo;
  const T* Cg = static_cast<const T*>(p.Cm) + bo;
  T* dx = static_cast<T*>(p.dx) + xo;
  float* dBh = p.dBh + ho;
  float* dCh = p.dCh + ho;
  load_rows<float>(St, XS, p.dstates + so, P, N, N, P);

  // sweep 1: each s tile against the l tiles on or after it
  for (int st = 0; st < nt; ++st) {
    const int s0 = st * TL;
    load_rows<T>(Bt, NS, Bg + s0 * bss, bss, TL, valid - s0, N);
    load_rows<T>(xt, XS, x + s0 * xss, xss, TL, valid - s0, P);
    float adx[RM][PJ], adB[RM][NR];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) adx[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < NR; ++j) adB[i][j] = 0.f;
    }
    for (int lt = st; lt < nt; ++lt) {
      const int l0 = lt * TL, lrows = min(TL, valid - l0);
      load_rows<T>(Ct, NS, Cg + l0 * bss, bss, TL, lrows, N);
      load_rows<T>(gt, XS, gy + l0 * xss, xss, TL, lrows, P);
      __syncthreads();
      pair_tiles<TL, PJ>(Ct, Bt, gt, xt, N, acs, dts, l0, s0, Rt, Mt, Wt);
      __syncthreads();
      // thread (ty, tx) owns rows s = s0 + ty + 16 i: dx += M^T gy, dB += W^T C
      for (int l = 0; l < lrows; ++l) {
        float m[RM], w[RM], gv[PJ];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          m[i] = Mt[l * SS + ty + 16 * i];
          w[i] = Wt[l * SS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) gv[j] = gt[l * XS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) adx[i][j] = fmaf(m[i], gv[j], adx[i][j]);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            const float cn = Ct[l * NS + n];
#pragma unroll
            for (int i = 0; i < RM; ++i) adB[i][j] = fmaf(w[i], cn, adB[i][j]);
          }
        }
      }
      if (t < TL) {  // R's column sums: ddt's intra term, acs's gradient at s
        float cs = 0.f;
        for (int l = 0; l < lrows; ++l) cs += Rt[l * SS + t];
        ddt[s0 + t] += cs;
        dacs[s0 + t] -= dts[s0 + t] * cs;
      }
      __syncthreads();
    }
    // the state update's terms of the s rows: B_s dS, and dS x_s
    {
      float bds[RM][PJ];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) bds[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bn[RM], sv[PJ];
#pragma unroll
        for (int i = 0; i < RM; ++i) bn[i] = Bt[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = St[n * XS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) bds[i][j] = fmaf(bn[i], sv[j], bds[i][j]);
      }
      float sB[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ws = wv[s0 + ty + 16 * i];
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          adx[i][j] = fmaf(ws, bds[i][j], adx[i][j]);
          a = fmaf(bds[i][j], xt[(ty + 16 * i) * XS + tx + 16 * j], a);
        }
        sB[i] = a;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)   // B_s.dS.x_s over the 16 lanes of a row
#pragma unroll
        for (int o = 8; o; o >>= 1) sB[i] += __shfl_xor_sync(0xffffffffu, sB[i], o);
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int s = s0 + ty + 16 * i;
          ddt[s] += expf(acs[L - 1] - acs[s]) * sB[i];
          const float q = wv[s] * sB[i];
          dacs[s] -= q;
          qv[s] = q;
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int n = tx + 16 * j;
        if (n < N) {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < P; q += 4)
              a = dot4(*reinterpret_cast<const float4*>(St + n * XS + q),
                       *reinterpret_cast<const float4*>(xt + (ty + 16 * i) * XS + q), a);
            adB[i][j] = fmaf(wv[s0 + ty + 16 * i], a, adB[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int s = s0 + ty + 16 * i;
      if (s < valid) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) dx[s * xss + tx + 16 * j] = from_f<T>(adx[i][j]);
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (tx + 16 * j < N) dBh[s * hss + tx + 16 * j] = adB[i][j];
      }
    }
    __syncthreads();
  }

  // the state's decay: exp(acs_L) <dS, S>, then S in place of dS
  float dot = 0.f;
  for (int e = t; e < N * P; e += NT) {
    const int n = e / P, q = e - n * P;
    dot = fmaf(St[n * XS + q], p.states[so + e], dot);
  }
  dot = block_sum(dot, wsum);   // thread 0's
  load_rows<float>(St, XS, p.states + so, P, N, N, P);

  // sweep 2: each l tile against the s tiles on or before it
  for (int lt = 0; lt < nt; ++lt) {
    const int l0 = lt * TL, lrows = min(TL, valid - l0);
    load_rows<T>(Ct, NS, Cg + l0 * bss, bss, TL, lrows, N);
    load_rows<T>(gt, XS, gy + l0 * xss, xss, TL, lrows, P);
    float adC[RM][NR];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) adC[i][j] = 0.f;
    for (int st = 0; st <= lt; ++st) {
      const int s0 = st * TL, srows = min(TL, valid - s0);
      load_rows<T>(Bt, NS, Bg + s0 * bss, bss, TL, srows, N);
      load_rows<T>(xt, XS, x + s0 * xss, xss, TL, srows, P);
      __syncthreads();
      pair_tiles<TL, PJ>(Ct, Bt, gt, xt, N, acs, dts, l0, s0, Rt, nullptr, Wt);
      __syncthreads();
      // thread (ty, tx) owns rows l = l0 + ty + 16 i: dC += W B
      for (int s = 0; s < srows; ++s) {
        float w[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) w[i] = Wt[(ty + 16 * i) * SS + s];
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            const float bn = Bt[s * NS + n];
#pragma unroll
            for (int i = 0; i < RM; ++i) adC[i][j] = fmaf(w[i], bn, adC[i][j]);
          }
        }
      }
      if (t < TL) {  // R dt's row sums: acs's gradient at l
        float rs = 0.f;
        for (int s = 0; s < srows; ++s) rs = fmaf(Rt[t * SS + s], dts[s0 + s], rs);
        dacs[l0 + t] += rs;
      }
      __syncthreads();
    }
    // the inter-chunk term: u_l = S gy_l; dC_l += e_l u_l, acs_l's gradient
    // += e_l C_l.u_l
    float cu[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) cu[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int n = tx + 16 * j;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < P; q += 4)
            a = dot4(*reinterpret_cast<const float4*>(St + n * XS + q),
                     *reinterpret_cast<const float4*>(gt + (ty + 16 * i) * XS + q), a);
          adC[i][j] = fmaf(ev[l0 + ty + 16 * i], a, adC[i][j]);
          cu[i] = fmaf(Ct[(ty + 16 * i) * NS + n], a, cu[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int o = 8; o; o >>= 1) cu[i] += __shfl_xor_sync(0xffffffffu, cu[i], o);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i) dacs[l0 + ty + 16 * i] += ev[l0 + ty + 16 * i] * cu[i];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l < valid) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (tx + 16 * j < N) dCh[l * hss + tx + 16 * j] = adC[i][j];
      }
    }
    __syncthreads();
  }

  // acs_L's gradient: the state update's terms and the decay's
  if (t == 0) {
    float q = 0.f;
    for (int s = 0; s < valid; ++s) q += qv[s];
    dacs[L - 1] += q + expf(acs[L - 1]) * dot;
  }
  __syncthreads();
  // da_s = sum over i >= s of dacs_i: a scan of the reversed chunk
  float v = t < L ? dacs[L - 1 - t] : 0.f;
  v = block_inclusive_scan(v, wsum);
  if (t < L) dacs[L - 1 - t] = v;
  __syncthreads();
  float part = 0.f;
  if (t < valid) {
    const float da = dacs[t];
    p.ddt[(static_cast<long long>(b) * p.S + c0 + t) * p.H + h] = fmaf(p.A[h], da, ddt[t]);
    part = dts[t] * da;
  }
  part = block_sum(part, wsum);
  if (t == 0) p.dAp[(static_cast<long long>(b) * p.nc + c) * p.H + h] = part;
}

// pass 4: dB and dC, each a sum of its group's heads in head order
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_heads_kernel(Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long long>(p.B) * p.S * p.G * p.N) return;
  const int rep = p.H / p.G;
  const long long row = i / p.N;   // (b, s, g)
  const int n = static_cast<int>(i - row * p.N);
  const long long head0 = (row / p.G * p.H + (row % p.G) * rep) * p.N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) sb += p.dBh[head0 + r * p.N];  // dB: the group's heads, in order
  for (int r = 0; r < rep; ++r) sc += p.dCh[head0 + r * p.N];
  static_cast<T*>(p.dB)[i] = from_f<T>(sb);
  static_cast<T*>(p.dC)[i] = from_f<T>(sc);
}

// pass 5: dA, the sum of its (batch, chunk) partials in order
__global__ void __launch_bounds__(NT) ssd_bwd_dA_kernel(Params p) {
  for (int h = threadIdx.x; h < p.H; h += NT) {
    float s = 0.f;
    for (long long k = 0; k < static_cast<long long>(p.B) * p.nc; ++k) s += p.dAp[k * p.H + h];
    p.dA[h] = s;
  }
}

template <typename T, int TL, int PJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int P = 16 * PJ;
  auto k1 = ssd_bwd_state_kernel<T, TL, PJ>;
  auto k3 = ssd_bwd_grad_kernel<T, TL, PJ>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         state_smem(MAX_L, MAX_N, P, TL) * 4);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               grad_smem(MAX_L, MAX_N, P, TL) * 4);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(p.nc, p.H, p.B);
  k1<<<grid, NT, state_smem(p.L, p.N, P, TL) * 4, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  ssd_bwd_carry_kernel<<<dim3((p.N * P / 4 + NT - 1) / NT, p.H, p.B), NT, 0, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  k3<<<grid, NT, grad_smem(p.L, p.N, P, TL) * 4, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  const long long n_heads = static_cast<long long>(p.B) * p.S * p.G * p.N;
  ssd_bwd_heads_kernel<T><<<static_cast<unsigned>((n_heads + NT - 1) / NT), NT, 0, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  ssd_bwd_dA_kernel<<<1, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int TL>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  if (p.P == 16) return launch<T, TL, 1>(p, stream);
  if (p.P == 32) return launch<T, TL, 2>(p, stream);
  return launch<T, TL, 4>(p, stream);
}

template <typename T>
cudaError_t launch_t(const Params& p, cudaStream_t stream) {
  if (p.L % 64 == 0) return launch_p<T, 64>(p, stream);
  return launch_p<T, 32>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, gy and dx, dB, dC); dt, A,
// gstate, ddt and dA are f32.  All tensors contiguous and 16-byte aligned.
// Takes L a multiple of 32 up to 256, N a multiple of 4 up to 128, P 16,
// 32 or 64, H a multiple of G.  `work` is f32 scratch of 2 B nc H N P + 2 B
// S H N + 2 B nc H floats, nc = ceil(S / L).  Returns a cudaError_t (0 =
// launched).
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const void* gy, const float* gstate, void* dx,
                            float* ddt, float* dA, void* dB, void* dC, float* work, int B, int S,
                            int H, int P, int G, int N, int L, int dtype, void* stream) {
  if (L % 32 || L < 32 || L > MAX_L || N % 4 || N < 4 || N > MAX_N ||
      (P != 16 && P != 32 && P != 64) || G < 1 || H % G || B < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const long long n_states = static_cast<long long>(B) * nc * H * N * P;
  const long long n_heads = static_cast<long long>(B) * S * H * N;
  Params p{x, dt, A, Bm, Cm, gy, gstate, dx, ddt, dA, dB, dC,
           work, work + n_states, work + 2 * n_states, work + 2 * n_states + n_heads,
           work + 2 * n_states + 2 * n_heads,
           work + 2 * n_states + 2 * n_heads + static_cast<long long>(B) * nc * H,
           B, S, H, P, G, N, L, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_t<float>(p, st));
  if (dtype == 1) return static_cast<int>(launch_t<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
