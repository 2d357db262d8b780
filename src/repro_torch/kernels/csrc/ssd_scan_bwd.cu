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
// No atomics: every sum is taken in one fixed order, so the gradients
// repeat bit for bit (the resume gates depend on it).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s; f32 operands as three
// bf16 pieces run at a sixth of that, the CUDA cores at 67).  The function
// needs, per (batch, head, chunk of n steps), five products over the
// chunk's (n, N, P): U_c, V_c, B dS, dS x and S gy; over the n (n + 1) / 2
// causal pairs, gy x^T (P) and M^T gy for dx (P).  Per (batch, group,
// chunk) it needs C B^T over the pairs and the weighted sums for dB and dC
// (N each): those are linear in the pair weights, so the weights summed
// over the group's heads serve them once.  At mamba2-130m's train shape (B
// 16, S 1024, H 24, P 64, G 1, N 128, L 256) that is 46.8 GFLOP: 0.047 ms
// at the bf16 peak, 0.284 ms at a sixth of it (0.698 on the CUDA cores);
// moving the inputs and the gradients once takes 0.055 ms in bf16, its
// bound there.
//
// wgmma body (P 64, N 64 or 128, L a multiple of 64 up to 256: every SSM
// config of the repo; `kernels/ssd_scan.py:bwd_wgmma_body` is the same
// rule), both dtypes.  Every operand tile is loaded by TMA (128-byte
// swizzle, rows past S filled with zeros), every product is a wgmma of one
// warpgroup with f32 accumulators.  bf16 inputs are exact operands; f32
// ones are first split into three bf16 pieces (hopper::split3), each
// product the sum over the piece pairs i + j <= 2.  The pair weights M and
// W enter as hi + lo, two bf16 terms within 2^-16 of them, as the
// forward's w x does; the carried states and what they sum (w x, e gy) as
// three pieces, f32's precision, since acs's gradient takes their terms
// and its sums into dA cancel (NPX).
//   1. ssd_bwd_state_wgmma: per (chunk, head, batch) and side, U_c = B^T
//      diag(w) x or V_c = C^T diag(e) gy over 64-step tiles (B^T read
//      MN-major), and the chunk's decay exp(acs_L).
//   2. ssd_bwd_carry: the only sequential part, elementwise on (N, P) in
//      chunk order: state_in(c + 1) = exp(acs_L(c)) state_in(c) + U_c
//      forwards (from zeros), dS_out(c - 1) = exp(acs_L(c)) dS_out(c) + V_c
//      backwards from dS_out(last) = the final state's gradient; each
//      replaces its U_c or V_c in place.
//   3. ssd_bwd_pair_wgmma, two launches, one block per (64-row tile,
//      chunk, head, batch), 6144 at the train shape: sweep 1 holds B_s and
//      x_s and walks the l tiles on or after s: P1 = B_s C_l^T and P2 =
//      x_s gy_l^T, then in registers R = P2 P1 E (its row sums: ddt's and
//      acs's terms at s), M = P1 E dt_s and W = P2 E dt_s, which as the
//      register A operand give dx_s += M gy_l and dB_s += W C_l (gy and C
//      read MN-major); before the walk the state terms w_s B_s dS and w_s
//      x_s dS^T, with B_s . dS x_s.  Sweep 2 holds C_l and gy_l and walks
//      the s tiles on or before l: dC_l += W B_s, acs's terms at l, and
//      first e_l gy_l S^T with C_l . S gy_l.  The diagonal tile takes the
//      compile-time mask variant (the exponent masked before the exp).
//      dB and dC go out per head in f32.
//   4. ssd_bwd_tail: per (chunk, head, batch), acs's gradient from the two
//      sweeps (plus the state update's and the decay's terms at the chunk's
//      end), its reverse cumsum da, ddt = direct terms + A da, dA's partial.
//   5. ssd_bwd_heads and ssd_bwd_dA: dB and dC as the sums of each group's
//      heads, in head order, in the inputs' dtype; dA as the sum of its
//      (batch, chunk) partials, in order.
// One block per tile rather than per (chunk, group) with the group's heads
// summed inside: the latter gives 64 blocks for 132 SMs at the train shape
// (B 16, 4 chunks, G 1); this gives 6144 a sweep.
//
// CUDA-core body (the reduced test shapes: P 16 or 32, N 8 or 16, chunk 32
// or 96): five launches, every operand read as f32 and all arithmetic f32
// for both dtypes (the only bf16 roundings are those of dx, dB and dC on
// the way out).
//   1. ssd_bwd_state: one block per (chunk, head, batch) takes the chunk's
//      cumsum and writes its own state update U_c = sum_s w_s B_s x_s^T,
//      its decay exp(acs_L), and V_c = sum_l exp(acs_l) C_l gy_l^T.
//   2. ssd_bwd_carry, as above.
//   3. ssd_bwd_grad: one block per (chunk, head, batch).  Two sweeps over
//      the causal pairs of TL-row tiles (TL = 64, or 32 when L is not a
//      multiple of 64), as the wgmma body's, each pair recomputing C B^T
//      and gy x^T on the CUDA cores in f32 from register tiles.  Then the
//      reverse cumsum gives ddt and the block's partial of dA.
//   4., 5. ssd_bwd_heads and ssd_bwd_dA, as above.
// A ragged S is not padded in memory: steps past S load as zeros (dt = 0:
// E and w stay finite and every product with them vanishes), so the last
// chunk's acs_L is its last real step's, and nothing past S is stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
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
  // the wgmma body's scratch: per chunk (B, nc, H) and step of it, ddt's
  // direct terms, acs's gradient from the s and from the l sweep, and the
  // state update's terms of acs_L's gradient; f32 inputs' pieces
  float* ddt1;
  float* dacs1;
  float* dacs2;
  float* qv;
  __nv_bfloat16* pieces;  // (3, B, S, H, P) of x, then of gy; (3, B, S, G, N) of B, then of C
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

// ---------------------------------------------------------------------------
// wgmma body (P 64, N 64 or 128, L a multiple of 64 up to 256: every SSM
// config of the repo; kernels/ssd_scan.py:bwd_wgmma_body is the same rule),
// f32 inputs as NP = 3 bf16 pieces, bf16 as they are (NP = 1); see the
// header.  Every block is one warpgroup.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr bool wgmma_shape(int P, int N, int L) {
  return P == WP && (N == 64 || N == 128) && L % TR == 0 && L >= TR && L <= 256;
}

// the pieces an intermediate f32 operand enters a product as, in both
// dtypes (an input is NP pieces).  The pair weights M and W: hi + lo (NPA),
// whose sum is within 2^-16 of them; they feed dx, dB and dC alone.  The
// carried states and what they sum (w x, e gy): three (NPX), f32's
// precision, since they give acs's gradient its state terms C_l . S gy_l
// and B_s . dS x_s, whose sums into dA cancel: with hi + lo there a bf16
// gate case (B 2, S 700, H 8, G 2) read dA 1.44x the gate's 1e-4 of its
// largest value against the function in f64, and three pieces hold it
// near the plain f32 version's own error (PERF.md §6).  dx's state term
// w_s B_s dS takes the state's first two pieces (hi + lo), as dx's M terms.
constexpr int NPA = 2;
constexpr int NPX = 3;

// the piece pairs (i, j) of a product of an na-piece operand and an
// nb-piece one that carry f32's precision, i + j <= 2, the smallest first
__host__ __device__ constexpr int n_pairs2(int na, int nb) {
  int n = 0;
  for (int lv = 2; lv >= 0; --lv)
    for (int i = 0; i <= lv; ++i) n += i < na && lv - i < nb;
  return n;
}
__host__ __device__ constexpr int pair2_i(int na, int nb, int k) {
  for (int lv = 2; lv >= 0; --lv)
    for (int i = 0; i <= lv; ++i)
      if (i < na && lv - i < nb && k-- == 0) return i;
  return 0;
}
__host__ __device__ constexpr int pair2_j(int na, int nb, int k) {
  for (int lv = 2; lv >= 0; --lv)
    for (int i = 0; i <= lv; ++i)
      if (i < na && lv - i < nb && k-- == 0) return lv - i;
  return 0;
}

// an f32 (N, 64) state as NPA pieces, each N swizzled rows of 128 bytes
// (read MN-major as the B of B_s dS, K-major as the B of x_s dS^T)
template <int NPA>
__device__ __forceinline__ void state_tile(uint8_t* dst, const float* src, int N) {
  for (int i = threadIdx.x; i < N * 8; i += WG) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    float v[8];
    load8(src + r * WP + c8, v);
    store_pieces8<NPA>(dst, N * 128, r, c8, v);
  }
}

// columns n and n + 1 (n even) of row r of a tile held as NP pieces of NB
// swizzled boxes each ([piece][box]), summed back to f32
template <int NP, int NB>
__device__ __forceinline__ float2 tile_pair(const uint8_t* m, int r, int n) {
  const int cc = n % 64, off = r * 128 + ((((cc >> 3) ^ (r & 7)) << 4) | ((cc & 7) * 2));
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int pc = NP - 1; pc >= 0; --pc) {  // the smallest piece first
    const uint32_t w = *reinterpret_cast<const uint32_t*>(m + (pc * NB + n / 64) * BOX + off);
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    acc.x += f.x;
    acc.y += f.y;
  }
  return acc;
}

// pass 1 of the body, shared memory from a 1024-aligned base: two stages
// of a 64-step tile (NP pieces of the N / 64 boxes of B or C, then the NPX
// pieces of w x or e gy), f32 dt, acs and the row weights (256 each), 4
// warp sums, the barriers
template <int NP, int N>
struct StateSmem {
  static constexpr int NB = N / 64;
  static constexpr int VEC = NP * NB * BOX, STAGE_B = VEC + NPX * BOX;
  static constexpr int F = 2 * STAGE_B;
  static constexpr int BAR = F + (3 * 256 + 4) * 4;
  static constexpr int BYTES = BAR + 8 * 2 + 1024;
};

// pass 1: U_c = B^T diag(w) x (blockIdx.z even) or V_c = C^T diag(e) gy
// (odd) of one (chunk, head, batch), and the chunk's decay.  The 64-step
// tiles of B or C come by TMA through two stages; the threads read each
// tile's x (gy) one tile ahead into registers, form w x (e gy) in f32 and
// write its hi and lo beside them; U or V (N x 64) accumulates over the
// tiles on the tensor cores, B^T read MN-major, each pair of pieces a
// product.
template <int NP, int N>
__global__ void __launch_bounds__(WG)
    ssd_bwd_state_wgmma_kernel(const __grid_constant__ CUtensorMap tb,
                               const __grid_constant__ CUtensorMap tc, Params p) {
  using T = std::conditional_t<NP == 1, __nv_bfloat16, float>;
  using Ly = StateSmem<NP, N>;
  constexpr int NB = Ly::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + Ly::F);
  float* acs = dts + 256;
  float* fv = acs + 256;
  float* wsum = fv + 256;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Ly::BAR);

  const int tid = threadIdx.x, L = p.L;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int c0 = c * L, valid = min(L, p.S - c0), nt = (valid + TR - 1) / TR;
  const int g = h / (p.H / p.G);
  const CUtensorMap* tm = which ? &tc : &tb;
  const long long xss = static_cast<long long>(p.H) * WP;
  const T* vec = static_cast<const T*>(which ? p.gy : p.x) +
                 (static_cast<long long>(b) * p.S + c0) * xss + h * WP;
  auto load = [&](int j) {  // B's (or C's) tile j into stage j % 2 (thread 0)
    uint8_t* dst = sm + (j & 1) * Ly::STAGE_B;
    hopper::mbar_expect_tx(&full[j & 1], Ly::VEC);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NB; ++x)
        hopper::tma_load_4d(dst + (pc * NB + x) * BOX, tm, &full[j & 1], x * 64, g, c0 + j * TR,
                            pc * p.B + b);
  };
  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(2, nt); ++j) load(j);
  chunk_cumsum(p.dt + (static_cast<long long>(b) * p.S + c0) * p.H + h, p.H, valid, p.A[h], L,
               dts, acs, wsum);
  __syncthreads();
  const float acs_L = acs[L - 1];
  for (int i = tid; i < L; i += WG)
    fv[i] = which ? expf(acs[i]) : expf(acs_L - acs[i]) * dts[i];  // e, or w
  if (tid == 0 && which == 0)
    p.cdec[(static_cast<long long>(b) * p.nc + c) * p.H + h] = expf(acs_L);
  __syncthreads();

  float u[NB][32], rows[4][8];
  tile_rows<T>(rows, vec, xss, 0, valid);
  for (int j = 0; j < nt; ++j) {
    uint8_t* stage = sm + (j & 1) * Ly::STAGE_B;
    scaled_pieces<NPX>(stage + Ly::VEC, rows, j * TR, fv);
    if (j + 1 < nt) tile_rows<T>(rows, vec, xss, (j + 1) * TR, valid);  // in flight meanwhile
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::mbar_wait(&full[j & 1], (j >> 1) & 1);
    const uint32_t ms = hopper::smem_addr(stage), vs = hopper::smem_addr(stage + Ly::VEC);
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) hopper::fence_regs(u[mt]);
    hopper::wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < NB; ++mt)
#pragma unroll
      for (int k = 0; k < n_pairs2(NP, NPX); ++k)
#pragma unroll
        for (int kc = 0; kc < TR / 16; ++kc)
          hopper::wgmma_ss<64, 1, 1>(
              u[mt],
              hopper::desc_sw128(ms + (pair2_i(NP, NPX, k) * NB + mt) * BOX + kc * 2048, BOX, 1024),
              hopper::desc_sw128(vs + pair2_j(NP, NPX, k) * BOX + kc * 2048, BOX, 1024),
              j > 0 || k > 0 || kc > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) hopper::fence_regs(u[mt]);
    __syncthreads();  // every thread is past the stage: refill it
    if (tid == 0 && j + 2 < nt) load(j + 2);
  }

  // rows 16 warp + lane / 4 (+ 8) of box mt, columns 8 j + 2 (lane % 4)
  const int warp = tid / 32, lane = tid % 32;
  float* out = (which ? p.dstates : p.states) +
               ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * WP;
#pragma unroll
  for (int mt = 0; mt < NB; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = mt * 64 + warp * 16 + lane / 4 + 8 * r;
#pragma unroll
      for (int j = 0; j < WP / 8; ++j)
        *reinterpret_cast<float2*>(out + n * WP + 8 * j + 2 * (lane % 4)) =
            make_float2(u[mt][4 * j + 2 * r], u[mt][4 * j + 2 * r + 1]);
    }
}

// pass 3 of the body, shared memory from a 1024-aligned base: the
// resident tile's mat (B or C: NP pieces of N / 64 boxes) and vec (x or
// gy: NP pieces of a box), two stages of a streamed tile (per piece its N
// / 64 mat boxes, then its vec box), the state's NPX pieces (N rows each),
// f32 dt and acs (256 each) and 4 warp sums, the barriers.  The state lies
// in the stages it fits in, ALIAS of them (f32: stage 1; bf16: both), and
// their first tiles are loaded once the state terms are done: f32 at N 128
// takes 216 KB so, bf16 at N 128 72 KB.
template <int NP, int N>
struct PairSmem {
  static constexpr int NB = N / 64, STAGES = 2;
  static constexpr int RM = 0, RV = RM + NP * NB * BOX, STG = RV + NP * BOX;
  static constexpr int STAGE_B = NP * (NB + 1) * BOX, STATE_B = NPX * N * 128;
  static constexpr int ALIAS = STATE_B <= STAGE_B ? 1 : STATE_B <= STAGES * STAGE_B ? STAGES : 0;
  static constexpr int ST = STG + (ALIAS == 1 ? STAGE_B : ALIAS ? 0 : STAGES * STAGE_B);
  static constexpr int F = STG + STAGES * STAGE_B + (ALIAS ? 0 : STATE_B);
  static constexpr int BAR = F + (2 * 256 + 4) * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

static_assert(PairSmem<3, 128>::BYTES <= 232448 && StateSmem<3, 128>::BYTES <= 232448,
              "a block has 227 KB");

// pass 3: the tile pairs of one chunk, one block per (64-row tile, chunk,
// head, batch).  SW = 1: the block holds B_s and x_s of an s tile and
// walks the l tiles on or after it: dx_s, this head's dB_s, ddt's direct
// terms and acs's gradient at s.  SW = 2: it holds C_l and gy_l of an l
// tile and walks the s tiles on or before it: this head's dC_l and acs's
// gradient at l.  Maps: the resident tile's mat and vec, the streamed
// tiles' mat and vec (piece pc of batch b at pc B + b).  Per streamed
// tile, P1 = mat_res mat_str^T (C B over N) and P2 = vec_res vec_str^T (gy x
// over P) on wgmma, with E = exp(acs_l - acs_s) (the exponent masked before
// the exp on the diagonal tile, a compile-time variant) and dt_s:
//   SW 1 (rows s, columns l): R = P2 P1 E summed along the row;
//        M = P1 E dt_s and W = P2 E dt_s, each as NPA pieces the register
//        A of dx_s += M gy_l and dB_s += W C_l (gy and C read MN-major);
//   SW 2 (rows l, columns s): R dt_s summed along the row; W = P2 E dt_s
//        the A of dC_l += W B_s.
// Before the walk, the state terms: SW 1: dB_s = w_s x_s dS^T and dx_s =
// w_s B_s dS, with B_s . dS x_s for ddt and acs; SW 2: dC_l = e_l gy_l
// S^T, with C_l . S gy_l for acs.
template <int NP, int N, int SW>
__global__ void __launch_bounds__(WG)
    ssd_bwd_pair_wgmma_kernel(const __grid_constant__ CUtensorMap rmat,
                              const __grid_constant__ CUtensorMap rvec,
                              const __grid_constant__ CUtensorMap smat,
                              const __grid_constant__ CUtensorMap svec, Params p) {
  using T = std::conditional_t<NP == 1, __nv_bfloat16, float>;
  using Ly = PairSmem<NP, N>;
  constexpr int NB = Ly::NB, STAGES = Ly::STAGES;
  const int L = p.L, R = L / TR;
  // block order: the heads fastest, then chunks, batches, and the tiles
  // with the most partners first
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int c = idx % p.nc;
  idx /= p.nc;
  const int b = idx % p.B;
  const int ti = SW == 1 ? idx / p.B : R - 1 - idx / p.B;  // the resident tile
  const int c0 = c * L, valid = min(L, p.S - c0), r0 = ti * TR;
  if (r0 >= valid) return;  // the whole tile lies past S
  const int nt = (valid + TR - 1) / TR;
  const int first = SW == 1 ? ti : 0;  // the streamed tiles first .. first + n_str - 1
  const int n_str = SW == 1 ? nt - ti : ti + 1;
  const int g = h / (p.H / p.G);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + Ly::F);
  float* acs = dts + 256;
  float* wsum = acs + 256;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(sm + Ly::BAR);
  uint64_t* full = res_full + 1;   // [s]: the streamed tile in stage s arrived
  uint64_t* empty = full + STAGES;  // [s]: every warp is done with stage s

  const int tid = threadIdx.x;
  auto load_tile = [&](int i) {  // streamed tile first + i into stage i % STAGES (thread 0)
    const int s = i % STAGES, row = c0 + (first + i) * TR;
    uint8_t* dst = sm + Ly::STG + s * Ly::STAGE_B;
    hopper::mbar_expect_tx(&full[s], Ly::STAGE_B);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
#pragma unroll
      for (int x = 0; x < NB; ++x)
        hopper::tma_load_4d(dst + (pc * (NB + 1) + x) * BOX, &smat, &full[s], x * 64, g, row,
                            pc * p.B + b);
      hopper::tma_load_4d(dst + (pc * (NB + 1) + NB) * BOX, &svec, &full[s], 0, h, row,
                          pc * p.B + b);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(res_full, NP * (NB + 1) * BOX);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
#pragma unroll
      for (int x = 0; x < NB; ++x)
        hopper::tma_load_4d(sm + Ly::RM + (pc * NB + x) * BOX, &rmat, res_full, x * 64, g, c0 + r0,
                            pc * p.B + b);
      hopper::tma_load_4d(sm + Ly::RV + pc * BOX, &rvec, res_full, 0, h, c0 + r0, pc * p.B + b);
    }
    for (int i = 0; i < min(STAGES - Ly::ALIAS, n_str); ++i) load_tile(i);
  }
  chunk_cumsum(p.dt + (static_cast<long long>(b) * p.S + c0) * p.H + h, p.H, valid, p.A[h], L,
               dts, acs, wsum);
  const long long so = ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * WP;
  state_tile<NPX>(sm + Ly::ST, (SW == 1 ? p.dstates : p.states) + so, N);
  hopper::fence_proxy_async();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rw0 = warp * 16 + lane / 4;  // this thread's rows rw0 and rw0 + 8 of the tile
  const float acs_L = acs[L - 1];
  float acs_r[2], dt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acs_r[r] = acs[r0 + rw0 + 8 * r];
    dt_r[r] = dts[r0 + rw0 + 8 * r];
  }
  const uint32_t rm0 = hopper::smem_addr(sm + Ly::RM), rv0 = hopper::smem_addr(sm + Ly::RV);
  const uint32_t sts = hopper::smem_addr(sm + Ly::ST);
  constexpr int NPS = n_pairs2(NP, NPX);  // pairs of an input and the state (o2)

  // o2: dB_s (SW 1) or dC_l (SW 2), N columns; o1: dx_s (SW 1), 64 columns
  constexpr int O1 = SW == 1 ? 32 : 1;
  float o2[N / 2], o1[O1];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) o2[x] = 0.f;
#pragma unroll
  for (int x = 0; x < O1; ++x) o1[x] = 0.f;
  hopper::mbar_wait(res_full, 0);
  hopper::fence_regs(o2);
  hopper::fence_regs(o1);
  hopper::wgmma_fence();
  // o2 = vec state^T, the state read K-major, a piece pair an iteration:
  // unrolled, f32's six pairs left the f32 N-128 sweep 1 (255 registers)
  // an 8-byte spill
#pragma unroll 1
  for (int k = 0; k < NPS; ++k)
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk)
      hopper::wgmma_ss<N, 0, 0>(o2, hopper::desc_sw128(rv0 + pair2_i(NP, NPX, k) * BOX + kk * 32, 16, 1024),
                                hopper::desc_sw128(sts + pair2_j(NP, NPX, k) * N * 128 + kk * 32, 16, 1024),
                                k > 0 || kk > 0);
  if constexpr (SW == 1) {
    // dx's state term alone: the state's hi + lo (its first two pieces)
    // hold dx, as they hold M's and W's terms of it
#pragma unroll
    for (int k = 0; k < n_pairs2(NP, NPA); ++k)  // o1 = B_s dS, dS read MN-major
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hopper::wgmma_ss<64, 0, 1>(
            o1,
            hopper::desc_sw128(rm0 + (pair2_i(NP, NPA, k) * NB + kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
            hopper::desc_sw128(sts + pair2_j(NP, NPA, k) * N * 128 + kk * 2048, BOX, 1024),
            k > 0 || kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o2);
  hopper::fence_regs(o1);
  if constexpr (Ly::ALIAS > 0) {  // the state is read: its stages take their first tiles
    __syncthreads();
    if (tid == 0)
      for (int i = STAGES - Ly::ALIAS; i < min(STAGES, n_str); ++i) load_tile(i);
  }
  // q: the rows' mat . o2 (SW 1: B_s . dS x_s; SW 2: C_l . S gy_l), then
  // o2 and o1 scaled by the rows' weights (SW 1: w_s; SW 2: e_l)
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 m = tile_pair<NP, NB>(sm + Ly::RM, rw0 + 8 * r, 8 * j + 2 * t);
      q[r] = fmaf(m.y, o2[4 * j + 2 * r + 1], fmaf(m.x, o2[4 * j + 2 * r], q[r]));
    }
  // the rows' state terms of ddt and of acs's gradient go to the scratch
  // now (the walk's sums are added to them at the end): nothing of them
  // stays in registers across the walk
  const long long srow = ((static_cast<long long>(b) * p.nc + c) * p.H + h) * L;
  float rowf[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q[r] += __shfl_xor_sync(0xffffffffu, q[r], 1);
    q[r] += __shfl_xor_sync(0xffffffffu, q[r], 2);
    const float to_end = expf(acs_L - acs_r[r]);
    rowf[r] = SW == 1 ? to_end * dt_r[r] : expf(acs_r[r]);
    const long long at = srow + r0 + rw0 + 8 * r;
    if (t == 0) {
      if constexpr (SW == 1) {
        p.ddt1[at] = to_end * q[r];
        p.qv[at] = rowf[r] * q[r];
        p.dacs1[at] = -(rowf[r] * q[r]);
      } else {
        p.dacs2[at] = rowf[r] * q[r];
      }
    }
  }
#pragma unroll
  for (int x = 0; x < N / 2; ++x) o2[x] *= rowf[(x >> 1) & 1];
  if constexpr (SW == 1)
#pragma unroll
    for (int x = 0; x < 32; ++x) o1[x] *= rowf[(x >> 1) & 1];

  float p1[32], p2[32], rs[2] = {0.f, 0.f};
  uint32_t pa[NPA][TR / 16][4];
  auto fence_pa = [&] {
#pragma unroll
    for (int pc = 0; pc < NPA; ++pc)
#pragma unroll
      for (int kc = 0; kc < TR / 16; ++kc) hopper::fence_regs(pa[pc][kc]);
  };
  auto pack = [&](const float (&v)[32]) {  // v's NPA pieces as register A fragments
#pragma unroll
    for (int kc = 0; kc < TR / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t w[NPA];
        hopper::pack_bf16_pieces<NPA>(v[8 * kc + 2 * e], v[8 * kc + 2 * e + 1], w);  // M's or W's pieces
#pragma unroll
        for (int pc = 0; pc < NPA; ++pc) pa[pc][kc][e] = w[pc];
      }
  };
  // acc += pa (64 x 64 rows of the tile by the streamed tile's rows) times
  // `box` (the streamed rows by ON columns, MN-major, its ON / 64 boxes
  // BOX bytes apart, its pieces (NB + 1) BOX apart)
  auto product = [&](auto& acc, uint32_t box, auto on) {
    constexpr int ON = decltype(on)::value;
    fence_pa();
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < n_pairs2(NPA, NP); ++k) {
      uint32_t bk = box;  // opaque a pair at a time: its descriptors are computed as issued
      asm volatile("" : "+r"(bk));
#pragma unroll
      for (int kc = 0; kc < TR / 16; ++kc)
        hopper::wgmma_rs<ON, 1>(acc, pa[pair2_i(NPA, NP, k)][kc],
                                hopper::desc_sw128(bk + pair2_j(NPA, NP, k) * (NB + 1) * BOX +
                                                       kc * 2048, BOX, 1024),
                                1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_pa();
  };

  for (int i = 0; i < n_str; ++i) {
    const int st = i % STAGES, o0 = (first + i) * TR;  // the streamed tile's first step
    // refill the stage that every warp released in the previous iteration
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_str) {
      hopper::mbar_wait(&empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_tile(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t stg = hopper::smem_addr(sm + Ly::STG + st * Ly::STAGE_B);
      hopper::mbar_wait(&full[st], (i / STAGES) & 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) p1[x] = p2[x] = 0.f;  // the last tile's are dead
      hopper::fence_regs(p1);
      hopper::fence_regs(p2);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < hopper::n_pairs(NP); ++k) {  // P1 = mat_res mat_str^T over N
        // the addresses opaque a pair at a time: the compiler would otherwise
        // compute every descriptor of the tile up front and hold them
        uint32_t rm = rm0, rv = rv0, sg = stg;
        asm volatile("" : "+r"(rm), "+r"(rv), "+r"(sg));
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          hopper::wgmma_ss<64, 0, 0>(
              p1,
              hopper::desc_sw128(rm + (hopper::pair_i(NP, k) * NB + kk / 4) * BOX + (kk % 4) * 32,
                                 16, 1024),
              hopper::desc_sw128(sg + (hopper::pair_j(NP, k) * (NB + 1) + kk / 4) * BOX +
                                     (kk % 4) * 32, 16, 1024),
              k > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < WP / 16; ++kk)  // P2 = vec_res vec_str^T over P
          hopper::wgmma_ss<64, 0, 0>(
              p2, hopper::desc_sw128(rv + hopper::pair_i(NP, k) * BOX + kk * 32, 16, 1024),
              hopper::desc_sw128(sg + (hopper::pair_j(NP, k) * (NB + 1) + NB) * BOX + kk * 32,
                                 16, 1024),
              k > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(p1);
      hopper::fence_regs(p2);
      // x: row rw0 + 8 ((x >> 1) & 1) of the tile, column 8 (x / 4) + 2 t +
      // (x & 1) of the streamed tile
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1, col = o0 + 8 * (x >> 2) + 2 * t + (x & 1);
        const int row = r0 + rw0 + 8 * r;
        const int l = SW == 1 ? col : row, s = SW == 1 ? row : col;
        float ex = acs[l] - acs[s];
        if constexpr (decltype(masked)::value) ex = s <= l ? ex : -INFINITY;
        const float e = expf(ex);
        const float rr = p2[x] * p1[x] * e;
        if constexpr (SW == 1) {
          rs[r] += rr;
          const float wgt = e * dt_r[r];
          p1[x] *= wgt;  // M
          p2[x] *= wgt;  // W
        } else {
          const float d = dts[s];
          rs[r] = fmaf(rr, d, rs[r]);
          p2[x] *= e * d;  // W
        }
      }
      if constexpr (SW == 1) {
        pack(p1);
        product(o1, stg + NB * BOX, std::integral_constant<int, 64>{});  // dx_s += M gy_l
      }
      pack(p2);
      product(o2, stg, std::integral_constant<int, N>{});  // dB_s += W C_l, dC_l += W B_s
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    };
    if ((SW == 1 && i == 0) || (SW == 2 && i == n_str - 1))
      step(std::true_type{});  // the diagonal tile
    else
      step(std::false_type{});
  }

  // the rows' sums over the four threads of each row, then the outputs;
  // nothing past S is stored
  const long long xss = static_cast<long long>(p.H) * WP, hss = static_cast<long long>(p.H) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    const int step = r0 + rw0 + 8 * r;
    if (t == 0) {  // the same thread wrote the state terms
      if constexpr (SW == 1) {
        p.ddt1[srow + step] += rs[r];
        p.dacs1[srow + step] -= dt_r[r] * rs[r];
      } else {
        p.dacs2[srow + step] += rs[r];
      }
    }
    if (step >= valid) continue;
    const long long at = static_cast<long long>(b) * p.S + c0 + step;
    float* o2row = (SW == 1 ? p.dBh : p.dCh) + at * hss + static_cast<long long>(h) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(o2row + 8 * j + 2 * t) =
          make_float2(o2[4 * j + 2 * r], o2[4 * j + 2 * r + 1]);
    if constexpr (SW == 1) {
      T* dxrow = static_cast<T*>(p.dx) + at * xss + h * WP;
#pragma unroll
      for (int j = 0; j < WP / 8; ++j) {
        if constexpr (NP == 1)
          *reinterpret_cast<__nv_bfloat162*>(dxrow + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o1[4 * j + 2 * r], o1[4 * j + 2 * r + 1]);
        else
          *reinterpret_cast<float2*>(dxrow + 8 * j + 2 * t) =
              make_float2(o1[4 * j + 2 * r], o1[4 * j + 2 * r + 1]);
      }
    }
  }
}

// pass 4 of the body: per (chunk, head, batch), acs's gradient from the two
// sweeps' rows (steps past S count 0), plus at the chunk's end the state
// update's terms (the sum of qv) and the decay's exp(acs_L) <dS, S>; its
// reverse cumsum da; ddt = the direct terms + A da, and dA's partial
// sum_s dt_s da_s.  Every sum in one fixed order.
__global__ void __launch_bounds__(NT) ssd_bwd_tail_kernel(Params p) {
  __shared__ float da[MAX_L];
  __shared__ float wsum[16];
  const int t = threadIdx.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, L = p.L;
  const int c0 = c * L, valid = min(L, p.S - c0);
  const long long blk = (static_cast<long long>(b) * p.nc + c) * p.H + h;
  const long long srow = blk * L, so = blk * p.N * p.P;
  float dot = 0.f;
  for (int e = t; e < p.N * p.P; e += NT) dot = fmaf(p.dstates[so + e], p.states[so + e], dot);
  dot = block_sum(dot, wsum);  // thread 0's
  float q = t < valid ? p.qv[srow + t] : 0.f;
  q = block_sum(q, wsum);
  if (t < L) da[t] = t < valid ? p.dacs1[srow + t] + p.dacs2[srow + t] : 0.f;
  __syncthreads();
  if (t == 0) da[L - 1] += q + p.cdec[blk] * dot;
  __syncthreads();
  float v = t < L ? da[L - 1 - t] : 0.f;  // da_s = the sum over i >= s
  v = block_inclusive_scan(v, wsum);
  if (t < L) da[L - 1 - t] = v;
  __syncthreads();
  float part = 0.f;
  if (t < valid) {
    const long long at = (static_cast<long long>(b) * p.S + c0 + t) * p.H + h;
    p.ddt[at] = fmaf(p.A[h], da[t], p.ddt1[srow + t]);
    part = p.dt[at] * da[t];
  }
  part = block_sum(part, wsum);
  if (t == 0) p.dAp[blk] = part;
}

template <int NP, int N>
cudaError_t launch_wgmma(const Params& p, const void* const (&in)[4], cudaStream_t stream) {
  using SL = StateSmem<NP, N>;
  using PL = PairSmem<NP, N>;
  auto k1 = ssd_bwd_state_wgmma_kernel<NP, N>;
  auto k3 = ssd_bwd_pair_wgmma_kernel<NP, N, 1>;
  auto k4 = ssd_bwd_pair_wgmma_kernel<NP, N, 2>;
  static bool configured = false;  // once, before any graph capture
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, SL::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // x, gy (NP B, S, H, 64) and B, C (NP B, S, G, N): the inputs, or their pieces
  const long long xs = static_cast<long long>(p.H) * WP, bs = static_cast<long long>(p.G) * N;
  CUtensorMap tx, tgy, tb, tc;
  if (!hopper::bhsd_map(&tx, in[0], NP * p.B, p.S, p.H, WP, p.S * xs, xs, WP, TR) ||
      !hopper::bhsd_map(&tgy, in[1], NP * p.B, p.S, p.H, WP, p.S * xs, xs, WP, TR) ||
      !hopper::bhsd_map(&tb, in[2], NP * p.B, p.S, p.G, N, p.S * bs, bs, N, TR) ||
      !hopper::bhsd_map(&tc, in[3], NP * p.B, p.S, p.G, N, p.S * bs, bs, N, TR))
    return cudaErrorInvalidValue;
  k1<<<dim3(p.nc, p.H, 2 * p.B), WG, SL::BYTES, stream>>>(tb, tc, p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  ssd_bwd_carry_kernel<<<dim3((N * WP / 4 + NT - 1) / NT, p.H, p.B), NT, 0, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  const unsigned n_pair = static_cast<unsigned>(p.L / TR) * p.B * p.nc * p.H;
  k3<<<n_pair, WG, PL::BYTES, stream>>>(tb, tx, tc, tgy, p);  // s tiles: B, x held; C, gy stream
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  k4<<<n_pair, WG, PL::BYTES, stream>>>(tc, tgy, tb, tx, p);  // l tiles: C, gy held; B, x stream
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  ssd_bwd_tail_kernel<<<dim3(p.nc, p.H, p.B), NT, 0, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  const long long n_heads = static_cast<long long>(p.B) * p.S * p.G * N;
  ssd_bwd_heads_kernel<std::conditional_t<NP == 1, __nv_bfloat16, float>>
      <<<static_cast<unsigned>((n_heads + NT - 1) / NT), NT, 0, stream>>>(p);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  ssd_bwd_dA_kernel<<<1, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

// f32 inputs: x, gy, B and C into their three pieces in the scratch first
template <int N>
cudaError_t launch_wgmma_f32(const Params& p, cudaStream_t stream) {
  const long long nx = static_cast<long long>(p.B) * p.S * p.H * WP;
  const long long nb = static_cast<long long>(p.B) * p.S * p.G * N;
  __nv_bfloat16* px = p.pieces;
  __nv_bfloat16* pgy = px + 3 * nx;
  __nv_bfloat16* pb = pgy + 3 * nx;
  __nv_bfloat16* pcm = pb + 3 * nb;
  const long long xs = static_cast<long long>(p.H) * WP, bs = static_cast<long long>(p.G) * N;
  const hopper::SplitArgs ax{{static_cast<const float*>(p.x), static_cast<const float*>(p.gy)},
                             {px, pgy},
                             {p.S * xs, p.S * xs},
                             {xs, xs},
                             {WP, WP},
                             {p.H, p.H}};
  const hopper::SplitArgs ab{{static_cast<const float*>(p.Bm), static_cast<const float*>(p.Cm)},
                             {pb, pcm},
                             {p.S * bs, p.S * bs},
                             {bs, bs},
                             {N, N},
                             {p.G, p.G}};
  cudaError_t e = hopper::split3(ax, 2, p.B, p.S, WP, stream);
  if (e == cudaSuccess) e = hopper::split3(ab, 2, p.B, p.S, N, stream);
  if (e != cudaSuccess) return e;
  return launch_wgmma<3, N>(p, {px, pgy, pb, pcm}, stream);
}

cudaError_t launch_body(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return p.N == 64 ? launch_wgmma<1, 64>(p, {p.x, p.gy, p.Bm, p.Cm}, stream)
                     : launch_wgmma<1, 128>(p, {p.x, p.gy, p.Bm, p.Cm}, stream);
  return p.N == 64 ? launch_wgmma_f32<64>(p, stream) : launch_wgmma_f32<128>(p, stream);
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
// S H N + 2 B nc H floats, nc = ceil(S / L), and at the wgmma body's shapes
// (wgmma_shape) 4 B nc H L more from the next multiple of 4 floats on,
// then with f32 inputs 3 (B S H P + B S G N) floats (the bf16 pieces of x,
// gy, B and C).  Returns a cudaError_t (0 = launched).
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
  const long long n_chunks = static_cast<long long>(B) * nc * H, n_steps = n_chunks * L;
  float* tail = work + (2 * n_states + 2 * n_heads + 2 * n_chunks + 3) / 4 * 4;
  Params p{x, dt, A, Bm, Cm, gy, gstate, dx, ddt, dA, dB, dC,
           work, work + n_states, work + 2 * n_states, work + 2 * n_states + n_heads,
           work + 2 * n_states + 2 * n_heads, work + 2 * n_states + 2 * n_heads + n_chunks,
           tail, tail + n_steps, tail + 2 * n_steps, tail + 3 * n_steps,
           reinterpret_cast<__nv_bfloat16*>(tail + 4 * n_steps),
           B, S, H, P, G, N, L, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype == 0 || dtype == 1) && wgmma_shape(P, N, L))
    return static_cast<int>(launch_body(p, dtype, st));
  if (dtype == 0) return static_cast<int>(launch_t<float>(p, st));
  if (dtype == 1) return static_cast<int>(launch_t<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
