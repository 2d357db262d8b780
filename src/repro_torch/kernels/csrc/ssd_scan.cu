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
// Bound on the H100 (989 TFLOP/s bf16, 67 f32, 3.35 TB/s; f32 operands as
// three bf16 pieces run at a sixth of the bf16 peak).  The function
// needs, per (batch, head, chunk of n steps), C . state (n N P
// multiply-adds), the masked product with x over the causal triangle
// (n (n + 1) / 2 P) and B^T x (n N P), and C B^T over the triangle (n (n +
// 1) / 2 N) once per (batch, group, chunk).  At mamba2-130m's prefill (B 1,
// S 1024, H 24, P 64, G 1, N 128, L 256) that is 1.24 GFLOP: 0.0013 ms in
// bf16; in f32 0.0075 ms on three pieces, 0.0186 on the CUDA cores;
// moving x, y, B, C, dt and the state once takes 0.0023 ms in bf16, so
// the bf16 scan is bound by bytes, the f32 one by operations.  At its
// train shape (B 16) the f32 scan is 19.9 GFLOP and 232 MB: 0.121 ms on
// three pieces, 0.297 on the CUDA cores, 0.069 by bytes.
//
// bf16 body (P 64, N 64 or 128, L 64, 128, 192 or 256: every SSM config of
// the repo; kernels/ssd_scan.py:wgmma_body is the same rule), three
// launches on csrc/hopper.cuh, every operand tile loaded by TMA (128-byte
// swizzle, rows past S filled with zeros), every product a wgmma of one
// warpgroup with f32 accumulators:
//   1. ssd_state_wgmma: one block per (chunk, head, batch) computes the
//      chunk's cumsum, its own state update U_c = B^T diag(w) x with w =
//      exp(acs_L - acs) dt, and its decay exp(acs_L), into f32 scratch
//      after the final state (3.1 MB at the serve shape: it stays in L2).
//      B^T is B's box read MN-major (transpose bit).  w x is rounded to
//      bf16 as hi + lo, two bf16 terms whose sum is within 2^-16 of w x,
//      and both are multiplied: the state update is as exact as f32 for
//      the price of a second product (the state is the first state of
//      every decode step that follows).
//   2. ssd_carry: the only sequential part, state_in(c + 1) = exp(acs_L(c))
//      state_in(c) + U_c, elementwise on (N, P) in f32 in chunk order, one
//      thread per 4 elements of each (batch, head); U_c is replaced in
//      place by state_in(c), which also goes out in bf16 for pass 3, and
//      the last state is the final state.  Its work grows with the chunk
//      count (32 chunks at S 8192), its loads are issued four chunks at a
//      time.
//   3. ssd_out_wgmma: one block per (64-row tile, chunk, head, batch), 384
//      at the serve shape, the tiles with the most key tiles first (the
//      longest processing time first).  Thread 0 loads the C tile, the bf16
//      state_in (one box of N rows: the MN-major operand of C . state), and
//      the key tiles of B and x on or below the diagonal through a ring of
//      3 stages (full and empty mbarriers; 107 KB at N 128, two blocks an
//      SM), while the block takes the cumsum; then it computes y = exp(acs_l)
//      (C . state_in) + sum over key tiles of map(C B^T) x, as the flash
//      forward computes softmax(Q K^T) V: S = C B^T by wgmma (K-major
//      operands), map(S) = S exp(acs_l - acs_s) dt_s in registers (the
//      exponent masked before the exp on the diagonal tile alone, a
//      compile-time variant, so no branch on the thread lies near a
//      wgmma), packed to bf16 as the register A operand of y += map(S) x
//      (x MN-major).  S of tile j and the product of tile j - 1 are issued
//      together.  y goes out by one TMA store, which drops rows past S.
//   C B^T is recomputed by each head (G = 1 at mamba2-130m): 1.0 GFLOP of
//   the 2.7 this body issues at the serve shape, about 1 us at peak;
//   sharing it would take the scores through device memory and a pass of
//   their own.
// The bf16 roundings it adds to the f32 arithmetic: map(S) and state_in as
// wgmma operands (each within 2^-8 of its part of y's absolute terms) and
// the hi + lo residual of w x (2^-16); chip_smoke.py's gate names each.
//
// f32 body (the bf16 body's shapes), the same three passes on three bf16
// pieces of every f32 operand (csrc/hopper.cuh: x = x0 + x1 + x2 carries
// f32's 24 bits; a product is the six piece pairs i + j <= 2, smallest
// first), so it adds no bf16 rounding to the f32 arithmetic:
//   0. hopper::split3 writes x, B and C as three bf16 pieces each into the
//      scratch (a (3 B, S, heads, D) tensor each, read by TMA).
//   1. ssd_state_f32_wgmma: U_c = B^T diag(w) x over 64-step tiles through
//      two stages, B's pieces by TMA and w x formed in f32 from x and
//      written as its three pieces beside them; a tile's six products go
//      into a fresh partial added to U in f32 (the tensor cores'
//      accumulation does not round to nearest, so a long sum in one
//      accumulator would drift).
//   2. ssd_carry_pieces: the carry in f32, state_in also going out as its
//      three pieces.
//   3. ssd_out_f32_wgmma: one block per 64-row tile (195 KB at N 128, one
//      an SM): y = exp(acs_l) (C . state_in) first, state_in's pieces in
//      the second B stage; then per key tile S = C B^T, map(S) in f32
//      registers packed as three pieces of the register A operand, and
//      map(S) x as a fresh partial added to y in f32.  B's and x's pieces
//      have rings of two stages each: S of tile j and the product of tile
//      j - 1 are issued together, so B_j is free a tile before x_j and the
//      next B tile loads a whole tile ahead.  y goes out in f32 from the
//      registers.  C B^T is again recomputed by each head.
// Its scratch: 302 MB a call at the train shape (kernels/ssd_scan.py:
// work_floats).
//
// One-pass body, for the shapes the three-pass bodies do not take (the
// reduced test configs: P 16 or 32, N 8 or 16, chunk 32 or 96), both
// dtypes: the TPU kernel's sequential chunk axis
// becomes a loop over chunks inside one block, with the state in shared
// memory.  One block of 256 threads (a 16 x 16 grid) per (16 columns of
// P, h, b), 96 blocks at the serving shape; per chunk the block holds in
// shared memory, all in f32, dt, acs and the state-update weights, x's 16
// columns, the state, all of B and one row tile of C (209 KB at L 256, N
// 128), and takes the score block in TL x TL tiles (TL = 64, or 32 when L
// is not a multiple of 64) on and below the diagonal.  All four products
// run on the CUDA cores in f32 from register tiles, so it is exact to the
// f32 reference and far from the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

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


// ---------------------------------------------------------------------------
// bf16 body: three passes on TMA loads and wgmma products; see the header.
// ---------------------------------------------------------------------------

constexpr int CARRY_NT = 256;      // threads of a carry block

__host__ __device__ constexpr bool wgmma_shape(int P, int N, int L) {
  return P == WP && (N == 64 || N == 128) && L % TR == 0 && L >= TR && L <= 256;
}

struct WParams {
  const float* dt;   // (B, S, H)
  const float* A;    // (H,)
  float* fstate;     // (B, H, N, P), then the scratch below
  float* states;     // (B, nc, H, N, P): U_c after pass 1, state_in(c) after pass 2
  __nv_bfloat16* states_bf;   // (B, nc, H, N, P): state_in(c) in bf16, from pass 2
  float* cdec;       // (B, nc, H): exp(acs_L) of each chunk
  int B, S, H, G, N, L, nc;
};

// pass 1 shared memory, bytes from a 1024-aligned base: B of the chunk
// (N / 64 boxes of L rows), (w x)_hi (in place of x), (w x)_lo, then f32
// dt, acs, w (L each), 4 warp sums and the barrier
__host__ __device__ constexpr int state_smem(int N, int L) {
  return (N / 64 + 2) * L * 128 + (3 * L + 4) * 4 + 8 + 1024;
}

template <int N>
__global__ void __launch_bounds__(WG) ssd_state_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                                             const __grid_constant__ CUtensorMap tb,
                                                             WParams p) {
  constexpr int NB = N / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int L = p.L;
  uint8_t* Bs = sm;
  uint8_t* Xh = Bs + NB * L * 128;
  uint8_t* Xl = Xh + L * 128;
  float* dts = reinterpret_cast<float*>(Xl + L * 128);
  float* acs = dts + L;
  float* wdec = acs + L;
  float* wsum = wdec + L;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 4);

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L;
  const int valid = min(L, p.S - c0);
  const int nt = (valid + TR - 1) / TR;   // 64-row tiles holding steps inside S
  const int g = h / (p.H / p.G);
  if (tid == 0) {
    hopper::mbar_init(full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(full, nt * (NB + 1) * BOX);
    for (int j = 0; j < nt; ++j) {
#pragma unroll
      for (int x = 0; x < NB; ++x)
        hopper::tma_load_4d(Bs + x * L * 128 + j * BOX, &tb, full, x * 64, g, c0 + j * TR, b);
      hopper::tma_load_4d(Xh + j * BOX, &tx, full, 0, h, c0 + j * TR, b);
    }
  }
  chunk_cumsum(p.dt + (static_cast<long long>(b) * p.S + c0) * p.H + h, p.H, valid, p.A[h], L,
               dts, acs, wsum);
  __syncthreads();
  const float acs_last = acs[L - 1];
  for (int i = tid; i < L; i += WG) wdec[i] = expf(acs_last - acs[i]) * dts[i];
  if (tid == 0) p.cdec[(static_cast<long long>(b) * p.nc + c) * p.H + h] = expf(acs_last);
  __syncthreads();
  hopper::mbar_wait(full, 0);
  // w x as hi + lo in bf16: a 16-byte chunk of the swizzled box holds 8
  // columns of one row, so chunk i is row i / 8 in any swizzle
  for (int i = tid; i < nt * TR * 8; i += WG) {
    uint4* ph = reinterpret_cast<uint4*>(Xh) + i;
    const uint4 v = *ph;
    const float w = wdec[i >> 3];
    const uint32_t e[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&e[k]));
      const float f0 = f.x * w, f1 = f.y * w;
      hi[k] = hopper::pack_bf16(f0, f1);
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[k]));
      lo[k] = hopper::pack_bf16(f0 - r.x, f1 - r.y);
    }
    *ph = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(Xl)[i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // U_c (N x P) = B^T (w x): M = the N rows of B^T (box mt of B, read
  // MN-major), K = the chunk's steps, 16 a product, hi and lo in turn
  float u[NB][32];
  const uint32_t b_smem = hopper::smem_addr(Bs), xh = hopper::smem_addr(Xh),
                 xl = hopper::smem_addr(Xl);
  for (int j = 0; j < nt; ++j) {
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) hopper::fence_regs(u[mt]);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < TR / 16; ++k) {
      const int kk = j * (TR / 16) + k;
#pragma unroll
      for (int mt = 0; mt < NB; ++mt) {
        const uint64_t da = hopper::desc_sw128(b_smem + mt * L * 128 + kk * 2048, L * 128, 1024);
        hopper::wgmma_ss<64, 1, 1>(u[mt], da, hopper::desc_sw128(xh + kk * 2048, BOX, 1024),
                                   kk > 0);
        hopper::wgmma_ss<64, 1, 1>(u[mt], da, hopper::desc_sw128(xl + kk * 2048, BOX, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) hopper::fence_regs(u[mt]);
  }

  // rows 16 warp + lane / 4 (+ 8) of box mt, columns 8 j + 2 (lane % 4)
  const int warp = tid / 32, lane = tid % 32;
  float* U = p.states + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * WP;
#pragma unroll
  for (int mt = 0; mt < NB; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = mt * 64 + warp * 16 + lane / 4 + 8 * r;
#pragma unroll
      for (int j = 0; j < WP / 8; ++j)
        *reinterpret_cast<float2*>(U + n * WP + 8 * j + 2 * (lane % 4)) =
            make_float2(u[mt][4 * j + 2 * r], u[mt][4 * j + 2 * r + 1]);
    }
}

// pass 2: four elements of the (N, P) state of one (batch, head) a thread
__global__ void __launch_bounds__(CARRY_NT) ssd_carry_kernel(WParams p) {
  const int n4 = p.N * WP / 4;
  const int q = blockIdx.x * CARRY_NT + threadIdx.x;
  if (q >= n4) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = static_cast<long long>(p.H) * n4;   // float4s from chunk to chunk
  float4* u = reinterpret_cast<float4*>(p.states) +
              (static_cast<long long>(b) * p.nc * p.H + h) * n4 + q;
  uint2* ubf = reinterpret_cast<uint2*>(p.states_bf) +
               (static_cast<long long>(b) * p.nc * p.H + h) * n4 + q;
  const float* dec = p.cdec + static_cast<long long>(b) * p.nc * p.H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += 4) {
    float4 v[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        v[k] = u[(c0 + k) * step];
        d[k] = dec[(c0 + k) * p.H];  // exp(acs_L) of the chunk
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        u[(c0 + k) * step] = s;      // the state entering the chunk, and in bf16
        ubf[(c0 + k) * step] =
            make_uint2(hopper::pack_bf16(s.x, s.y), hopper::pack_bf16(s.z, s.w));
        s = make_float4(fmaf(d[k], s.x, v[k].x), fmaf(d[k], s.y, v[k].y),
                        fmaf(d[k], s.z, v[k].z), fmaf(d[k], s.w, v[k].w));
      }
  }
  reinterpret_cast<float4*>(p.fstate)[(static_cast<long long>(b) * p.H + h) * n4 + q] = s;
}

// pass 3 shared memory, bytes from a 1024-aligned base: the C tile (N / 64
// boxes), state_in as bf16 (N rows of 128 bytes), KS stages of a key tile
// (N / 64 boxes of B, then its box of x), then f32 dt and acs (L each), 4
// warp sums and 1 + 2 KS barriers.  KS = 3: 107 KB at N 128, two blocks an
// SM; a 4-tile chunk refills one stage.
constexpr int KS = 3;
__host__ __device__ constexpr int out_smem(int N, int L) {
  return (2 * (N / 64) + KS * (N / 64 + 1)) * BOX + (2 * L + 4) * 4 + 8 * (1 + 2 * KS) + 1024;
}

template <int N>
__global__ void __launch_bounds__(WG) ssd_out_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                                           const __grid_constant__ CUtensorMap tb,
                                                           const __grid_constant__ CUtensorMap tc,
                                                           const __grid_constant__ CUtensorMap ty,
                                                           const __grid_constant__ CUtensorMap ts,
                                                           WParams p) {
  constexpr int NB = N / 64;
  const int L = p.L, R = L / TR;
  // block order: the heads fastest, then chunks, batches, and the row
  // tiles with the most key tiles first
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int c = idx % p.nc;
  idx /= p.nc;
  const int b = idx % p.B;
  const int r = R - 1 - idx / p.B;        // row tile; key tiles 0 .. r
  const int c0 = c * L, l0 = r * TR;
  const int valid = min(L, p.S - c0);
  if (l0 >= valid) return;                // the whole tile lies past S
  const int g = h / (p.H / p.G);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Cs = sm;
  uint8_t* St = Cs + NB * BOX;
  uint8_t* Kt = St + NB * BOX;            // stage s: B at (s (NB + 1) + x) boxes, x after
  float* dts = reinterpret_cast<float*>(Kt + KS * (NB + 1) * BOX);
  float* acs = dts + L;
  float* wsum = acs + L;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(wsum + 4);
  uint64_t* full = c_full + 1;            // [s]: key tile in stage s arrived
  uint64_t* empty = full + KS;            // [s]: every warp is done with stage s

  const int tid = threadIdx.x;
  // key tile j into stage j % KS (thread 0 only)
  auto load_tile = [&](int j) {
    uint8_t* dst = Kt + (j % KS) * (NB + 1) * BOX;
    uint64_t* bar = &full[j % KS];
    hopper::mbar_expect_tx(bar, (NB + 1) * BOX);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_load_4d(dst + x * BOX, &tb, bar, x * 64, g, c0 + j * TR, b);
    hopper::tma_load_4d(dst + NB * BOX, &tx, bar, 0, h, c0 + j * TR, b);
  };
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < KS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(c_full, 2 * NB * BOX);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_load_4d(Cs + x * BOX, &tc, c_full, x * 64, g, c0 + l0, b);
    hopper::tma_load_4d(St, &ts, c_full, 0, 0, c * p.H + h, b);   // state_in, N rows
    for (int j = 0; j < min(KS, r + 1); ++j) load_tile(j);
  }
  chunk_cumsum(p.dt + (static_cast<long long>(b) * p.S + c0) * p.H + h, p.H, valid, p.A[h], L,
               dts, acs, wsum);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = l0 + warp * 16 + lane / 4;   // this thread's rows row0, row0 + 8
  const float acs_row[2] = {acs[row0], acs[row0 + 8]};
  const uint32_t c_smem = hopper::smem_addr(Cs), st_smem = hopper::smem_addr(St),
                 k_smem = hopper::smem_addr(Kt);
  float y[32], s[32];
  uint32_t pa[TR / 16][4];
  auto c_desc = [&](int kk) {   // C, K-major: k-step kk in box kk / 4
    return hopper::desc_sw128(c_smem + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024);
  };
  auto issue_inter = [&] {      // y = C . state_in
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::wgmma_ss<64, 0, 1>(y, c_desc(kk), hopper::desc_sw128(st_smem + kk * 2048, BOX, 1024),
                                 kk > 0);
    hopper::wgmma_commit();
  };
  auto issue_s = [&](int j) {   // s = C B_j^T, both K-major
    const uint32_t bs = k_smem + (j % KS) * (NB + 1) * BOX;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::wgmma_ss<64, 0, 0>(
          s, c_desc(kk), hopper::desc_sw128(bs + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
          kk > 0);
    hopper::wgmma_commit();
  };
  auto issue_px = [&](int j) {  // y += map(s) x_j, x MN-major
    const uint32_t xs = k_smem + ((j % KS) * (NB + 1) + NB) * BOX;
#pragma unroll
    for (int kc = 0; kc < TR / 16; ++kc)
      hopper::wgmma_rs<64, 1>(y, pa[kc], hopper::desc_sw128(xs + kc * 2048, BOX, 1024), 1);
    hopper::wgmma_commit();
  };
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(y);
#pragma unroll
    for (int kc = 0; kc < TR / 16; ++kc) hopper::fence_regs(pa[kc]);
  };
  // s[x]: row row0 + 8 ((x >> 1) & 1), key 64 j + 8 (x / 4) + 2 t + (x & 1)
  auto map = [&](int j, auto masked) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int key = j * TR + (x / 4) * 8 + 2 * t + (x & 1);
      float e = acs_row[(x >> 1) & 1] - acs[key];
      if constexpr (decltype(masked)::value)
        e = key <= row0 + 8 * ((x >> 1) & 1) ? e : -INFINITY;
      s[x] = s[x] * expf(e) * dts[key];
    }
  };
  auto pack = [&] {
#pragma unroll
    for (int kc = 0; kc < TR / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kc][e] = hopper::pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
  };

  // y = exp(acs_l) (C . state_in) and S of key tile 0, issued together
  auto first = [&](auto masked) {
    hopper::mbar_wait(c_full, 0);
    hopper::mbar_wait(&full[0], 0);
    fence_all();
    hopper::wgmma_fence();
    issue_inter();
    issue_s(0);
    hopper::wgmma_wait<0>();
    fence_all();
#pragma unroll
    for (int x = 0; x < 32; ++x) y[x] *= expf(acs_row[(x >> 1) & 1]);
    map(0, masked);
    pack();
  };
  if (r == 0)
    first(std::true_type{});
  else
    first(std::false_type{});
  // S of tile j with the product of tile j - 1; the diagonal tile r
  // masked.  At the start of iteration j thread 0 refills the stage that
  // every warp released at the end of iteration j - 1 (tile j - 2's).
  for (int j = 1; j <= r; ++j) {
    if (tid == 0 && j >= 2 && j - 2 + KS <= r) {
      hopper::mbar_wait(&empty[(j - 2) % KS], ((j - 2) / KS) & 1);
      load_tile(j - 2 + KS);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      hopper::mbar_wait(&full[j % KS], (j / KS) & 1);
      fence_all();
      hopper::wgmma_fence();
      issue_s(j);
      issue_px(j - 1);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      map(j, masked);
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) hopper::mbar_arrive(&empty[(j - 1) % KS]);   // tile j - 1 done
      pack();
    };
    if (j == r)
      step(std::true_type{});
    else
      step(std::false_type{});
  }
  fence_all();
  hopper::wgmma_fence();
  issue_px(r);
  hopper::wgmma_wait<0>();
  fence_all();

  // y in bf16 into the C tile's first box (every product is done),
  // swizzled as the TMA box expects, then one TMA store
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = warp * 16 + lane / 4 + 8 * hr;
#pragma unroll
    for (int j = 0; j < WP / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(Cs + rl * 128 + ((j ^ (rl & 7)) * 16) + t * 4) =
          __floats2bfloat162_rn(y[4 * j + 2 * hr], y[4 * j + 2 * hr + 1]);
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    hopper::tma_store_4d(&ty, Cs, 0, h, c0 + l0, b);
    hopper::tma_store_commit();
    hopper::tma_store_wait();
  }
}

// passes: a mask of the bf16 body's passes to run (1 state, 2 carry, 4
// out); the scan is all three, the card tests run one at a time
template <int N>
cudaError_t launch_wgmma(const Params& p, int B, int passes, cudaStream_t stream) {
  auto k1 = ssd_state_wgmma_kernel<N>;
  auto k3 = ssd_out_wgmma_kernel<N>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         state_smem(N, 256));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem(N, 256));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int S = p.S, H = p.H, G = p.G, L = p.L;
  const int nc = (S + L - 1) / L;
  CUtensorMap tx, tb, tc, ty;
  const long long xs = static_cast<long long>(H) * WP, bs = static_cast<long long>(G) * N;
  if (!hopper::bhsd_map(&tx, p.x, B, S, H, WP, S * xs, xs, WP, TR) ||
      !hopper::bhsd_map(&tb, p.Bm, B, S, G, N, S * bs, bs, N, TR) ||
      !hopper::bhsd_map(&tc, p.Cm, B, S, G, N, S * bs, bs, N, TR) ||
      !hopper::bhsd_map(&ty, p.y, B, S, H, WP, S * xs, xs, WP, TR))
    return cudaErrorInvalidValue;
  const long long n_states = static_cast<long long>(B) * nc * H * N * WP;
  float* states = p.fstate + static_cast<long long>(B) * H * N * WP;
  __nv_bfloat16* states_bf = reinterpret_cast<__nv_bfloat16*>(states + n_states);
  const WParams w{p.dt,      p.A, p.fstate, states, states_bf,
                  reinterpret_cast<float*>(states_bf + n_states), B, S, H, G, N, L, nc};
  // state_in in bf16 as (P, N, nc H, B), read in boxes of one (N, P) state
  CUtensorMap ts;
  const uint64_t s_dims[4] = {WP, static_cast<uint64_t>(N), static_cast<uint64_t>(nc) * H,
                              static_cast<uint64_t>(B)};
  const uint64_t s_strides[3] = {WP * 2, static_cast<uint64_t>(N) * WP * 2,
                                 static_cast<uint64_t>(nc) * H * N * WP * 2};
  const uint32_t s_box[4] = {WP, static_cast<uint32_t>(N), 1, 1};
  if (!hopper::tensor_map_4d(&ts, states_bf, s_dims, s_strides, s_box))
    return cudaErrorInvalidValue;
  if (passes & 1) {
    k1<<<dim3(nc, H, B), WG, state_smem(N, L), stream>>>(tx, tb, w);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  if (passes & 2) {
    const dim3 grid((N * WP / 4 + CARRY_NT - 1) / CARRY_NT, H, B);
    ssd_carry_kernel<<<grid, CARRY_NT, 0, stream>>>(w);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  if (passes & 4) {
    k3<<<B * H * nc * (L / TR), WG, out_smem(N, L), stream>>>(tx, tb, tc, ty, ts, w);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t launch_bf16_body(const Params& p, int B, int passes, cudaStream_t stream) {
  if (p.N == 64) return launch_wgmma<64>(p, B, passes, stream);
  return launch_wgmma<128>(p, B, passes, stream);
}

// ---------------------------------------------------------------------------
// f32 body: the bf16 body's three passes with every f32 operand, and every
// f32 intermediate, as three bf16 pieces; see the header.
// ---------------------------------------------------------------------------

constexpr int NP = 3;   // the bf16 pieces of an f32 operand (hopper::split3)

// pass 1 shared memory, bytes from a 1024-aligned base: two stages of a
// 64-step tile (the NP pieces of B's N / 64 boxes, then the NP pieces of w
// x), f32 dt, acs and w (256 each), 4 warp sums, the barriers: 148 KB at N
// 128
template <int N>
struct StateF32Smem {
  static constexpr int NB = N / 64;
  static constexpr int VEC = NP * NB * BOX, STAGE_B = VEC + NP * BOX;
  static constexpr int F = 2 * STAGE_B;
  static constexpr int BAR = F + (3 * 256 + 4) * 4;
  static constexpr int BYTES = BAR + 8 * 2 + 1024;
};

// pass 1 in f32: U_c = B^T diag(w) x of one (chunk, head, batch), and the
// chunk's decay.  The 64-step tiles of B's pieces come by TMA through two
// stages; the threads read each tile's x in f32 one tile ahead, form w x
// and write its NP pieces beside them.  A tile's six piece products go
// into a fresh partial, added to U in f32 (the tensor cores' accumulation
// does not round to nearest).
template <int N>
__global__ void __launch_bounds__(WG) ssd_state_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tb,
                                                                 const float* x, WParams p) {
  using Ly = StateF32Smem<N>;
  constexpr int NB = Ly::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + Ly::F);
  float* acs = dts + 256;
  float* wdec = acs + 256;
  float* wsum = wdec + 256;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Ly::BAR);

  const int tid = threadIdx.x, L = p.L;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L, valid = min(L, p.S - c0), nt = (valid + TR - 1) / TR;
  const int g = h / (p.H / p.G);
  const long long xss = static_cast<long long>(p.H) * WP;
  const float* xc = x + (static_cast<long long>(b) * p.S + c0) * xss + h * WP;
  auto load = [&](int j) {  // B's pieces of tile j into stage j % 2 (thread 0)
    uint8_t* dst = sm + (j & 1) * Ly::STAGE_B;
    hopper::mbar_expect_tx(&full[j & 1], Ly::VEC);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        hopper::tma_load_4d(dst + (pc * NB + q) * BOX, &tb, &full[j & 1], q * 64, g, c0 + j * TR,
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
  for (int i = tid; i < L; i += WG) wdec[i] = expf(acs_L - acs[i]) * dts[i];
  if (tid == 0) p.cdec[(static_cast<long long>(b) * p.nc + c) * p.H + h] = expf(acs_L);
  __syncthreads();

  float u[NB][32], part[NB][32], rows[4][8];
#pragma unroll
  for (int mt = 0; mt < NB; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e) u[mt][e] = 0.f;
  tile_rows<float>(rows, xc, xss, 0, valid);
  for (int j = 0; j < nt; ++j) {
    uint8_t* stage = sm + (j & 1) * Ly::STAGE_B;
    scaled_pieces<NP>(stage + Ly::VEC, rows, j * TR, wdec);
    if (j + 1 < nt) tile_rows<float>(rows, xc, xss, (j + 1) * TR, valid);  // in flight meanwhile
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::mbar_wait(&full[j & 1], (j >> 1) & 1);
    const uint32_t ms = hopper::smem_addr(stage), vs = hopper::smem_addr(stage + Ly::VEC);
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) hopper::fence_regs(part[mt]);
    hopper::wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < NB; ++mt)
#pragma unroll
      for (int k = 0; k < hopper::n_pairs(NP); ++k)
#pragma unroll
        for (int kc = 0; kc < TR / 16; ++kc)
          hopper::wgmma_ss<64, 1, 1>(
              part[mt],
              hopper::desc_sw128(ms + (hopper::pair_i(NP, k) * NB + mt) * BOX + kc * 2048, BOX,
                                 1024),
              hopper::desc_sw128(vs + hopper::pair_j(NP, k) * BOX + kc * 2048, BOX, 1024),
              k > 0 || kc > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) {
      hopper::fence_regs(part[mt]);
#pragma unroll
      for (int e = 0; e < 32; ++e) u[mt][e] += part[mt][e];   // U += this tile's partial
    }
    __syncthreads();  // every thread is past the stage: refill it
    if (tid == 0 && j + 2 < nt) load(j + 2);
  }

  // rows 16 warp + lane / 4 (+ 8) of box mt, columns 8 j + 2 (lane % 4)
  const int warp = tid / 32, lane = tid % 32;
  float* U = p.states + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * WP;
#pragma unroll
  for (int mt = 0; mt < NB; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = mt * 64 + warp * 16 + lane / 4 + 8 * r;
#pragma unroll
      for (int j = 0; j < WP / 8; ++j)
        *reinterpret_cast<float2*>(U + n * WP + 8 * j + 2 * (lane % 4)) =
            make_float2(u[mt][4 * j + 2 * r], u[mt][4 * j + 2 * r + 1]);
    }
}

// pass 2 in f32: the carry of the bf16 body, with state_in going out as its
// NP pieces (piece m of the (B, nc, H, N, P) states at m B nc H N P)
__global__ void __launch_bounds__(CARRY_NT) ssd_carry_pieces_kernel(WParams p) {
  const int n4 = p.N * WP / 4;
  const int q = blockIdx.x * CARRY_NT + threadIdx.x;
  if (q >= n4) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = static_cast<long long>(p.H) * n4;   // float4s from chunk to chunk
  const long long piece = static_cast<long long>(p.B) * p.nc * step;   // from piece to piece
  float4* u = reinterpret_cast<float4*>(p.states) +
              (static_cast<long long>(b) * p.nc * p.H + h) * n4 + q;
  uint2* pieces = reinterpret_cast<uint2*>(p.states_bf) +
                  (static_cast<long long>(b) * p.nc * p.H + h) * n4 + q;
  const float* dec = p.cdec + static_cast<long long>(b) * p.nc * p.H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += 4) {
    float4 v[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        v[k] = u[(c0 + k) * step];
        d[k] = dec[(c0 + k) * p.H];
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        u[(c0 + k) * step] = s;      // the state entering the chunk, and its pieces
        const float e[4] = {s.x, s.y, s.z, s.w};
        uint32_t out[NP][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t w[NP];
          hopper::pack_bf16_pieces<NP>(e[2 * i], e[2 * i + 1], w);  // state_in's pieces
#pragma unroll
          for (int m = 0; m < NP; ++m) out[m][i] = w[m];
        }
#pragma unroll
        for (int m = 0; m < NP; ++m)
          pieces[m * piece + (c0 + k) * step] = make_uint2(out[m][0], out[m][1]);
        s = make_float4(fmaf(d[k], s.x, v[k].x), fmaf(d[k], s.y, v[k].y),
                        fmaf(d[k], s.z, v[k].z), fmaf(d[k], s.w, v[k].w));
      }
  }
  reinterpret_cast<float4*>(p.fstate)[(static_cast<long long>(b) * p.H + h) * n4 + q] = s;
}

// pass 3 shared memory, bytes from a 1024-aligned base: the C tile's NP
// pieces of N / 64 boxes (MAT bytes), two stages of a key tile's B pieces
// (MAT each; stage 1 holds state_in's NP pieces of N rows, MAT bytes too,
// until C . state_in is done), two stages of its x pieces (NP boxes each),
// then f32 dt and acs (256 each), 4 warp sums and 9 barriers: 195 KB at N
// 128, one block an SM.
template <int N>
struct OutF32Smem {
  static constexpr int NB = N / 64;
  static constexpr int MAT = NP * NB * BOX;
  static constexpr int BS = MAT, XS = 3 * MAT, F = XS + 2 * NP * BOX;
  static constexpr int BAR = F + (2 * 256 + 4) * 4;
  static constexpr int BYTES = BAR + 8 * 9 + 1024;
};

static_assert(StateF32Smem<128>::BYTES <= 232448 && OutF32Smem<128>::BYTES <= 232448,
              "a block has 227 KB");

// pass 3 in f32: y of one 64-row tile as the bf16 out pass computes it,
// every product the six piece pairs, smallest first.  y = exp(acs_l) (C .
// state_in) first; then per key tile j, S = C B_j^T, map(S) in f32
// registers as the NP pieces of the register A operand, and map(S) x_j as a
// fresh partial added to y in f32.  B's and x's pieces come through two
// rings of their own: S of tile j and the product of tile j - 1 are issued
// together, so B_j is released a tile before x_j and the next B tile is
// loaded a whole tile ahead.  y goes out in f32 from the registers.
template <int N>
__global__ void __launch_bounds__(WG)
    ssd_out_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tb,
                             const __grid_constant__ CUtensorMap tc,
                             const __grid_constant__ CUtensorMap ts, WParams p, float* yout) {
  using Ly = OutF32Smem<N>;
  constexpr int NB = Ly::NB;
  const int L = p.L, R = L / TR;
  // block order: the heads fastest, then chunks, batches, and the row
  // tiles with the most key tiles first
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int c = idx % p.nc;
  idx /= p.nc;
  const int b = idx % p.B;
  const int r = R - 1 - idx / p.B;        // row tile; key tiles 0 .. r
  const int c0 = c * L, l0 = r * TR;
  const int valid = min(L, p.S - c0);
  if (l0 >= valid) return;                // the whole tile lies past S
  const int g = h / (p.H / p.G);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + Ly::F);
  float* acs = dts + 256;
  float* wsum = acs + 256;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(sm + Ly::BAR);   // C and state_in arrived
  uint64_t* b_full = c_full + 1;    // [s]: B's pieces of a key tile in B stage s arrived
  uint64_t* b_empty = b_full + 2;   // [s]: every warp is done with B stage s
  uint64_t* x_full = b_empty + 2;   // [s]: x's pieces of a key tile in x stage s arrived
  uint64_t* x_empty = x_full + 2;   // [s]: every warp is done with x stage s

  const int tid = threadIdx.x;
  auto load_b = [&](int j) {  // B's pieces of key tile j into B stage j % 2 (thread 0)
    uint8_t* dst = sm + Ly::BS + (j & 1) * Ly::MAT;
    hopper::mbar_expect_tx(&b_full[j & 1], Ly::MAT);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        hopper::tma_load_4d(dst + (pc * NB + q) * BOX, &tb, &b_full[j & 1], q * 64, g,
                            c0 + j * TR, pc * p.B + b);
  };
  auto load_x = [&](int j) {  // x's pieces of key tile j into x stage j % 2 (thread 0)
    uint8_t* dst = sm + Ly::XS + (j & 1) * NP * BOX;
    hopper::mbar_expect_tx(&x_full[j & 1], NP * BOX);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
      hopper::tma_load_4d(dst + pc * BOX, &tx, &x_full[j & 1], 0, h, c0 + j * TR, pc * p.B + b);
  };
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&b_full[s], 1);
      hopper::mbar_init(&b_empty[s], WG / 32);
      hopper::mbar_init(&x_full[s], 1);
      hopper::mbar_init(&x_empty[s], WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(c_full, 2 * Ly::MAT);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
#pragma unroll
      for (int q = 0; q < NB; ++q)
        hopper::tma_load_4d(sm + (pc * NB + q) * BOX, &tc, c_full, q * 64, g, c0 + l0,
                            pc * p.B + b);
      hopper::tma_load_4d(sm + Ly::BS + Ly::MAT + pc * NB * BOX, &ts, c_full, 0, 0, c * p.H + h,
                          pc * p.B + b);   // state_in's piece pc, N rows, in B stage 1
    }
    load_b(0);
    load_x(0);
    if (r >= 1) load_x(1);
  }
  chunk_cumsum(p.dt + (static_cast<long long>(b) * p.S + c0) * p.H + h, p.H, valid, p.A[h], L,
               dts, acs, wsum);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = l0 + warp * 16 + lane / 4;   // this thread's rows row0, row0 + 8
  const float acs_row[2] = {acs[row0], acs[row0 + 8]};
  const uint32_t c_smem = hopper::smem_addr(sm), b_smem = hopper::smem_addr(sm + Ly::BS),
                 x_smem = hopper::smem_addr(sm + Ly::XS);
  const uint32_t st_smem = b_smem + Ly::MAT;
  float y[32], o[32], s[32];
  uint32_t pa[NP][TR / 16][4];
  auto c_desc = [&](int pc, int kk) {   // C's piece pc, K-major: k-step kk in box kk / 4
    return hopper::desc_sw128(c_smem + (pc * NB + kk / 4) * BOX + (kk % 4) * 32, 16, 1024);
  };
  auto issue_inter = [&] {      // o = C . state_in, state_in MN-major
#pragma unroll
    for (int k = 0; k < hopper::n_pairs(NP); ++k)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hopper::wgmma_ss<64, 0, 1>(
            o, c_desc(hopper::pair_i(NP, k), kk),
            hopper::desc_sw128(st_smem + hopper::pair_j(NP, k) * NB * BOX + kk * 2048, BOX, 1024),
            k > 0 || kk > 0);
    hopper::wgmma_commit();
  };
  auto issue_s = [&](int j) {   // s = C B_j^T, both K-major
    const uint32_t bs = b_smem + (j & 1) * Ly::MAT;
#pragma unroll
    for (int k = 0; k < hopper::n_pairs(NP); ++k)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hopper::wgmma_ss<64, 0, 0>(
            s, c_desc(hopper::pair_i(NP, k), kk),
            hopper::desc_sw128(bs + (hopper::pair_j(NP, k) * NB + kk / 4) * BOX + (kk % 4) * 32,
                               16, 1024),
            k > 0 || kk > 0);
    hopper::wgmma_commit();
  };
  auto issue_px = [&](int j) {  // o = map(S_j) x_j, x MN-major
    const uint32_t xs = x_smem + (j & 1) * NP * BOX;
#pragma unroll
    for (int k = 0; k < hopper::n_pairs(NP); ++k)
#pragma unroll
      for (int kc = 0; kc < TR / 16; ++kc)
        hopper::wgmma_rs<64, 1>(o, pa[hopper::pair_i(NP, k)][kc],
                                hopper::desc_sw128(xs + hopper::pair_j(NP, k) * BOX + kc * 2048,
                                                   BOX, 1024),
                                k > 0 || kc > 0);
    hopper::wgmma_commit();
  };
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(o);
#pragma unroll
    for (int m = 0; m < NP; ++m)
#pragma unroll
      for (int kc = 0; kc < TR / 16; ++kc) hopper::fence_regs(pa[m][kc]);
  };
  // s[x]: row row0 + 8 ((x >> 1) & 1), key 64 j + 8 (x / 4) + 2 t + (x & 1)
  auto map = [&](int j, auto masked) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int key = j * TR + (x / 4) * 8 + 2 * t + (x & 1);
      float e = acs_row[(x >> 1) & 1] - acs[key];
      if constexpr (decltype(masked)::value)
        e = key <= row0 + 8 * ((x >> 1) & 1) ? e : -INFINITY;
      s[x] = s[x] * expf(e) * dts[key];
    }
  };
  auto pack = [&] {             // map(S) as NP pieces of the register A operand
#pragma unroll
    for (int kc = 0; kc < TR / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t w[NP];
        hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // map(S)'s pieces
#pragma unroll
        for (int m = 0; m < NP; ++m) pa[m][kc][e] = w[m];
      }
  };
  auto add_o = [&] {
#pragma unroll
    for (int x = 0; x < 32; ++x) y[x] += o[x];
  };

  // y = exp(acs_l) (C . state_in), which frees B stage 1 for key tile 1;
  // then S of key tile 0
  auto first = [&](auto masked) {
    hopper::mbar_wait(c_full, 0);
    hopper::mbar_wait(&b_full[0], 0);
    fence_all();
    hopper::wgmma_fence();
    issue_inter();
    hopper::wgmma_wait<0>();
    fence_all();
    if (lane == 0) hopper::mbar_arrive(&b_empty[1]);   // state_in read
    if (tid == 0 && r >= 1) {
      hopper::mbar_wait(&b_empty[1], 0);
      load_b(1);
    }
    __syncwarp();
    hopper::wgmma_fence();
    issue_s(0);
#pragma unroll
    for (int x = 0; x < 32; ++x) y[x] = o[x] * expf(acs_row[(x >> 1) & 1]);
    hopper::wgmma_wait<0>();
    fence_all();
    if (lane == 0) hopper::mbar_arrive(&b_empty[0]);   // B_0 read
    map(0, masked);
    pack();
  };
  if (r == 0)
    first(std::true_type{});
  else
    first(std::false_type{});
  // S of key tile j with the product of tile j - 1; the diagonal tile r
  // masked.  B_k's release is the (k + 1) / 2-th of its stage (B stage 1
  // released state_in first), x_k's the k / 2-th: at the start of
  // iteration j thread 0 loads B_{j+1} over B_{j-1} and x_j over x_{j-2},
  // each released at the end of iteration j - 1.
  for (int j = 1; j <= r; ++j) {
    if (tid == 0) {
      if (j + 1 <= r) {
        hopper::mbar_wait(&b_empty[(j + 1) & 1], (j >> 1) & 1);
        load_b(j + 1);
      }
      if (j >= 2) {
        hopper::mbar_wait(&x_empty[j & 1], ((j - 2) >> 1) & 1);
        load_x(j);
      }
    }
    __syncwarp();
    auto step = [&](auto masked) {
      hopper::mbar_wait(&b_full[j & 1], (j >> 1) & 1);
      hopper::mbar_wait(&x_full[(j - 1) & 1], ((j - 1) >> 1) & 1);
      fence_all();
      hopper::wgmma_fence();
      issue_s(j);
      issue_px(j - 1);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      map(j, masked);
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) {
        hopper::mbar_arrive(&b_empty[j & 1]);         // B_j read
        hopper::mbar_arrive(&x_empty[(j - 1) & 1]);   // x_{j-1} read
      }
      add_o();
      pack();
    };
    if (j == r)
      step(std::true_type{});
    else
      step(std::false_type{});
  }
  hopper::mbar_wait(&x_full[r & 1], (r >> 1) & 1);
  fence_all();
  hopper::wgmma_fence();
  issue_px(r);
  hopper::wgmma_wait<0>();
  fence_all();
  add_o();

  // y in f32 straight from the registers: a warp's store covers 8 rows of
  // 32 bytes; rows past S are not written
  float* yt = yout + ((static_cast<long long>(b) * p.S + c0 + l0) * p.H + h) * WP;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = warp * 16 + lane / 4 + 8 * hr;
    if (l0 + rl < valid) {
#pragma unroll
      for (int j = 0; j < WP / 8; ++j)
        *reinterpret_cast<float2*>(yt + static_cast<long long>(rl) * p.H * WP + 8 * j + 2 * t) =
            make_float2(y[4 * j + 2 * hr], y[4 * j + 2 * hr + 1]);
    }
  }
}

// the f32 body's passes (`passes` as launch_wgmma's).  Its scratch follows
// the bf16 body's layout with state_in's NP pieces in place of its bf16
// copy, then (from a multiple of 4 floats) the NP pieces of x, B and C
template <int N>
cudaError_t launch_f32_wgmma(const Params& p, int B, int passes, cudaStream_t stream) {
  using SL = StateF32Smem<N>;
  using OL = OutF32Smem<N>;
  auto k1 = ssd_state_f32_wgmma_kernel<N>;
  auto k3 = ssd_out_f32_wgmma_kernel<N>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, SL::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, OL::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int S = p.S, H = p.H, G = p.G, L = p.L;
  const int nc = (S + L - 1) / L;
  const long long n_states = static_cast<long long>(B) * nc * H * N * WP;
  float* states = p.fstate + static_cast<long long>(B) * H * N * WP;
  __nv_bfloat16* st_pieces = reinterpret_cast<__nv_bfloat16*>(states + n_states);
  float* cdec = reinterpret_cast<float*>(st_pieces + NP * n_states);
  const long long n_dec = (static_cast<long long>(B) * nc * H + 3) / 4 * 4;
  const long long xs = static_cast<long long>(H) * WP, bs = static_cast<long long>(G) * N;
  __nv_bfloat16* px = reinterpret_cast<__nv_bfloat16*>(cdec + n_dec);
  __nv_bfloat16* pb = px + static_cast<long long>(NP) * B * S * xs;
  __nv_bfloat16* pcm = pb + static_cast<long long>(NP) * B * S * bs;
  const WParams w{p.dt, p.A, p.fstate, states, st_pieces, cdec, B, S, H, G, N, L, nc};
  // the pieces as (NP B, S, heads, D): piece m of batch b at m B + b
  CUtensorMap tx, tb, tc, ts;
  if (!hopper::bhsd_map(&tx, px, NP * B, S, H, WP, S * xs, xs, WP, TR) ||
      !hopper::bhsd_map(&tb, pb, NP * B, S, G, N, S * bs, bs, N, TR) ||
      !hopper::bhsd_map(&tc, pcm, NP * B, S, G, N, S * bs, bs, N, TR))
    return cudaErrorInvalidValue;
  // state_in's pieces as (P, N, nc H, NP B), read in boxes of one (N, P) state
  const uint64_t s_dims[4] = {WP, static_cast<uint64_t>(N), static_cast<uint64_t>(nc) * H,
                              static_cast<uint64_t>(NP) * B};
  const uint64_t s_strides[3] = {WP * 2, static_cast<uint64_t>(N) * WP * 2,
                                 static_cast<uint64_t>(nc) * H * N * WP * 2};
  const uint32_t s_box[4] = {WP, static_cast<uint32_t>(N), 1, 1};
  if (!hopper::tensor_map_4d(&ts, st_pieces, s_dims, s_strides, s_box))
    return cudaErrorInvalidValue;
  if (passes & 1) {   // x, B and C into their pieces, then the state pass
    const hopper::SplitArgs ax{{static_cast<const float*>(p.x)}, {px}, {S * xs}, {xs}, {WP}, {H}};
    const hopper::SplitArgs abc{{static_cast<const float*>(p.Bm), static_cast<const float*>(p.Cm)},
                                {pb, pcm},
                                {S * bs, S * bs},
                                {bs, bs},
                                {N, N},
                                {G, G}};
    cudaError_t e = hopper::split3(ax, 1, B, S, WP, stream);
    if (e == cudaSuccess) e = hopper::split3(abc, 2, B, S, N, stream);
    if (e != cudaSuccess) return e;
    k1<<<dim3(nc, H, B), WG, SL::BYTES, stream>>>(tb, static_cast<const float*>(p.x), w);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  if (passes & 2) {
    const dim3 grid((N * WP / 4 + CARRY_NT - 1) / CARRY_NT, H, B);
    ssd_carry_pieces_kernel<<<grid, CARRY_NT, 0, stream>>>(w);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  if (passes & 4) {
    k3<<<B * H * nc * (L / TR), WG, OL::BYTES, stream>>>(tx, tb, tc, ts, w, static_cast<float*>(p.y));
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t launch_f32_body(const Params& p, int B, int passes, cudaStream_t stream) {
  if (p.N == 64) return launch_f32_wgmma<64>(p, B, passes, stream);
  return launch_f32_wgmma<128>(p, B, passes, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are f32.  All tensors contiguous; x, B, C 16-byte aligned.  Takes
// L a multiple of 32 up to 256, N a multiple of 4 up to 128, P a multiple
// of 16, H a multiple of G.  At P 64, N 64 or 128 and L a multiple of 64
// (wgmma_shape) both dtypes run their three-pass body, whose scratch
// follows the final state in `fstate` (16-byte aligned), nc = ceil(S / L):
// the chunk states (B, nc, H, N, P) f32; in bf16 their bf16 copy, in f32
// their three bf16 pieces (3, B, nc, H, N, P); the chunk decays (B, nc, H)
// f32; and in f32, from the next multiple of 4 floats, the three bf16
// pieces of x (3, B, S, H, P), of B and of C (3, B, S, G, N) each.
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, void* y, float* fstate, int B, int S, int H, int P,
                            int G, int N, int L, int dtype, void* stream) {
  if (L % 32 || L > MAX_L || N % 4 || N > MAX_N || P % PC || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fstate, S, H, P, G, N, L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool body = wgmma_shape(P, N, L);
  if (dtype == 0 && body) return static_cast<int>(launch_f32_body(p, B, 7, st));
  if (dtype == 0) return static_cast<int>(launch_t<float>(p, B, st));
  if (dtype == 1 && body) return static_cast<int>(launch_bf16_body(p, B, 7, st));
  if (dtype == 1) return static_cast<int>(launch_t<__nv_bfloat16>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// One or more passes of the three-pass body of `dtype` (`passes`: 1 state,
// in f32 after splitting x, B and C into their pieces; 2 carry; 4 out),
// each reading what the one before it left in `fstate`'s scratch: the card
// tests hold each pass against its plain version.  Same arguments and
// layout as ssd_scan_fwd; at the bodies' shapes only.
extern "C" int ssd_scan_passes(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, void* y, float* fstate, int B, int S, int H, int P,
                               int G, int N, int L, int dtype, int passes, void* stream) {
  if (!wgmma_shape(P, N, L) || G < 1 || H % G || passes < 1 || passes > 7 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fstate, S, H, P, G, N, L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_f32_body(p, B, passes, st)
                                     : launch_bf16_body(p, B, passes, st));
}
