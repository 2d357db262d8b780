// Flash attention forward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_kernel`) in the
// JAX package's kernels/flash_attention.py: tiled online-softmax
// attention with causal / sliding-window masks, logit softcap, any GQA
// ratio (kv head = h / rep), masked logits at the finite -2e38, f32
// running max / denominator / accumulator, out = acc / max(l, 1e-37).
// On request it also writes each row's log-sum-exp m + log(max(l, 1e-37))
// as (B, H, S) f32, which the backward (flash_attention_bwd.cu) reads.
// The TPU's sequential k grid axis becomes a loop over k tiles inside the
// block; tiles that the causal / window mask hides completely are never
// visited, and S need not be a multiple of a tile.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
// - serving prefill (starcoder2-3b: B 1, S <= 1024, H 24, Hkv 2, D 128,
//   causal): 4 S^2 D H / 2 flops against (2 H + 2 Hkv) S D bf16 elements,
//   far above the ~295 flop/byte ridge: the tensor cores (6.5 us at S 1024);
// - training (bert-mlm-120m: B 32, S 512, H 12, D 64, not causal): 25.8
//   GFLOP in 26 us against 101 MB of q, k, v, o and lse in 30 us: bytes,
//   with the products close behind.  At D 64 the 100.7M exponentials
//   need as long on the special-function units (16 a clock per SM) as
//   the products on the tensor cores; measured, the softmax and the
//   products add up rather than overlap, above the loads' own time.
//
// bf16 body (`flash_fwd_wgmma_kernel`), built on csrc/hopper.cuh (times,
// and the measurements behind each choice, in PERF.md):
// - a block takes 128 q rows of one (head, batch) as two consumer
//   warpgroups of 64 rows.  Causal: the heads run fastest and the q tiles
//   with the most unmasked keys first (longest processing time first),
//   so the longest blocks start in the first wave.  Otherwise the q tiles
//   of one head run together, so that K and V come from device memory
//   once and then from L2;
// - thread 0 loads Q once and the K and V tiles through a ring of
//   shared-memory stages with TMA (128-byte swizzle, rows past S filled
//   with zeros).  Each stage has a "full" mbarrier for K and one for V
//   (expect_tx bytes) and an "empty" one for each, on which every
//   consumer warp arrives when the products reading it are done (V is
//   read an iteration after K).  At the start of each iteration thread 0
//   refills what every warp released in the previous one, so the loads
//   run a stage ahead and it never waits for a warp more than an
//   iteration behind.  No producer warp: 2, 3 or 4 stages run equally
//   fast, so the consumers do not wait on loads;
// - S = Q K^T is a wgmma m64nBKk16 with both operands in shared memory
//   (K-major descriptors); P goes from the f32 S fragment to bf16 pairs in
//   registers, the A layout of O += P V, a wgmma m64nDk16 with V MN-major
//   (transpose bit).  S of tile i and P V of tile i - 1 are issued
//   together.  No branch on the thread surrounds a wgmma: ptxas
//   serializes the products in a divergent path (its warning C7520);
// - softmax in base 2 (log2 e folded into the scale, ex2.approx); the
//   masks are applied only on the tiles that need one (a causal diagonal,
//   a window's edge, the tile holding S's ragged end), chosen once per
//   tile and block, and softcap is a template choice, so that no branch
//   lies between a product's issue and its wait (ptxas waits at every
//   join); softcap, when set, applies to every tile with the accurate
//   tanhf (tanh.approx's ~2^-11 error times a softcap of 30 would pass
//   the bf16 gate's 2^-8);
// - the epilogue writes O / max(l, 1e-37) in bf16 into the warpgroup's
//   Q rows of shared memory (swizzled, conflict-free) and stores them
//   with one TMA store per 64-column box, which drops rows past S.
// Tiles: D 64 takes 64 keys a tile and 3 stages (66 KB) in at most 128
// registers a thread, so two blocks share an SM and one block's prologue
// and epilogue overlap the other's products (128 keys at one block an SM
// run slower); D 128 takes 128 keys and 2 stages (162 KB), one block
// an SM, 64 + 64 f32 accumulators a thread.
//
// f32 body (`flash_fwd_f32_kernel`, the exactness path): one block of
// four warps per (q tile of 64 rows, head, batch), the same tiles on the
// CUDA cores in f32 (a 4x8 score tile and a 4x(D/8) output tile per
// thread), exact to the f32 reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// f32 body
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) or null
  long long q_sb, q_ss, q_sh;  // strides in elements; the D axis is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, S, H, Hkv;
  int causal;
  int window;  // <= 0: no window
  float softcap;
  float scale;
};

// the f32 body's row log-sum-exp (B, H, S); its grid is (q tile, head, batch)
__device__ __noinline__ void store_lse(const Params& p, int row, float m, float lsum) {
  p.lse[(static_cast<long long>(blockIdx.z) * p.H + blockIdx.y) * p.S + row] = m + logf(lsum);
}

// f32 body: a 4x8 score tile and a 4x(D/8) output tile per thread.
template <int D>
constexpr int smem_floats() {
  return D * (BQ + 4) + BK * (D + 1) + BK * D + BK * (BQ + 4);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(Params p) {
  constexpr int QT_LD = BQ + 4;  // Qt[d][q]: float4 reads of 4 rows
  constexpr int K_LD = D + 1;    // Ks[k][d]: odd stride, conflict-free columns
  constexpr int PT_LD = BQ + 4;  // Pt[k][q]
  constexpr int NJ = D / 32;     // float4 column groups of the output tile
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + D * QT_LD;
  float* Vs = Ks + BK * K_LD;
  float* Pt = Vs + BK * D;

  const int tid = threadIdx.x;
  const int r = tid >> 3;  // this thread's rows: r*4 .. r*4+3
  const int c = tid & 7;   // score columns c + 8j; output columns c*4 + 32jj + e
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int hk = h / (p.H / p.Hkv);

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int qi = idx / D, d = idx % D;
    const int s = q0 + qi;
    Qt[d * QT_LD + qi] = s < S ? qp[s * p.q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < NJ * 4; ++x) acc[i][x] = 0.f;
  }

  // k tiles that hold at least one unmasked key of this q tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int kk = idx / D, d = idx % D;
      const int s = k0 + kk;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = kp[s * p.k_ss + d];
        vx = vp[s * p.v_ss + d];
      }
      Ks[kk * K_LD + d] = kx;
      Vs[kk * D + d] = vx;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QT_LD + r * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(c + 8 * j) * K_LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qa[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + c + 8 * j;
        float s = sc[i][j] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool ok = kj < S;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && kj > qi - p.window;
        sc[i][j] = ok ? s : NEG_INF;
        mt = fmaxf(mt, sc[i][j]);
      }
      // the 8 threads of a row are 8 neighbouring lanes
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // a key past S is no key at all; a masked key keeps the JAX
        // kernel's arithmetic (exp(-2e38 - m), wiped by a later alpha)
        const float pj = (k0 + c + 8 * j < S) ? expf(sc[i][j] - m_new) : 0.f;
        sc[i][j] = pj;
        rs += pj;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < NJ * 4; ++x) acc[i][x] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) Pt[(c + 8 * j) * PT_LD + r * 4 + i] = sc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[kk * PT_LD + r * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[kk * D + c * 4 + 32 * jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pa[i], vv.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pa[i], vv.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pa[i], vv.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pa[i], vv.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r * 4 + i;
    if (qi >= S) continue;
    const float lsum = fmaxf(l[i], 1e-37f);
    if constexpr (LSE)
      if (c == 0) store_lse(p, qi, m[i], lsum);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[qi * p.o_ss + c * 4 + 32 * jj + e] = acc[i][jj * 4 + e] / lsum;
  }
}


// ---------------------------------------------------------------------------
// bf16 body: TMA ring and wgmma; see the header.
// ---------------------------------------------------------------------------

constexpr int WQ = 128;    // q rows of a block
constexpr int WNT = 256;   // two consumer warpgroups
constexpr int BOX = 64;    // columns of a TMA box (128 bytes of bf16: the swizzle span)

template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int BK = 64, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct Tiles<128> {
  static constexpr int BK = 128, STAGES = 2, MIN_BLOCKS = 1;
};

// shared memory, in bytes from a 1024-aligned base: Q as D/64 boxes of
// WQ rows, then K of every stage, then V of every stage (box b of stage s
// at (s * D/64 + b) boxes), then the barriers
template <int D>
struct Smem {
  static constexpr int NB = D / BOX, BK = Tiles<D>::BK, STAGES = Tiles<D>::STAGES;
  static constexpr int Q_BOX = WQ * BOX * 2, KV_BOX = BK * BOX * 2;
  static constexpr int K = NB * Q_BOX;
  static constexpr int V = K + STAGES * NB * KV_BOX;
  static constexpr int BAR = V + STAGES * NB * KV_BOX;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(WNT, Tiles<D>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, Params p) {
  using L = Smem<D>;
  constexpr int NB = L::NB, BK = L::BK, STAGES = L::STAGES;
  static_assert(STAGES >= 2, "V of tile i is refilled two iterations after its use");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group / column pair
  // Block order.  Causal: the heads fastest and the q tiles with the most
  // unmasked keys first, so the longest blocks start in the first wave.
  // Otherwise (equal blocks): the q tiles of one head, then the heads of
  // one kv head, together, so that their K and V are read from device
  // memory once and then from L2.
  const int nq = (p.S + WQ - 1) / WQ;
  int h, b, q0;
  if (p.causal) {
    h = blockIdx.x % p.H;
    b = blockIdx.x / p.H % p.B;
    q0 = (nq - 1 - static_cast<int>(blockIdx.x / (p.H * p.B))) * WQ;
  } else {
    q0 = blockIdx.x % nq * WQ;
    h = blockIdx.x / nq % p.H;
    b = blockIdx.x / (nq * p.H);
  }
  const int S = p.S;
  const int hk = h / (p.H / p.Hkv);
  const int q_last = min(q0 + WQ, S) - 1;
  const int kt_hi = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  const int n_tiles = kt_hi - kt_lo;

  // K, or V, of tile kt_lo + i into stage i % STAGES (thread 0 only)
  auto load_k = [&](int i) {
    const int s = i % STAGES, k0 = (kt_lo + i) * BK;
    hopper::mbar_expect_tx(&k_full[s], NB * L::KV_BOX);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_load_4d(sm + L::K + (s * NB + x) * L::KV_BOX, &tk, &k_full[s], x * BOX, hk,
                          k0, b);
  };
  auto load_v = [&](int i) {
    const int s = i % STAGES, k0 = (kt_lo + i) * BK;
    hopper::mbar_expect_tx(&v_full[s], NB * L::KV_BOX);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_load_4d(sm + L::V + (s * NB + x) * L::KV_BOX, &tv, &v_full[s], x * BOX, hk,
                          k0, b);
  };
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], WNT / 32);  // every consumer warp
      hopper::mbar_init(&v_empty[s], WNT / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_full, NB * L::Q_BOX);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_load_4d(sm + x * L::Q_BOX, &tq, q_full, x * BOX, h, q0, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) {
      load_k(i);
      load_v(i);
    }
  }

  // this warpgroup's rows r0 .. r0 + 63; this thread's rows row0, row0 + 8
  const int r0 = q0 + wg * 64;
  const int row0 = r0 + warp * 16 + g;
  const uint32_t q_smem = hopper::smem_addr(sm) + wg * 64 * 128;
  const uint32_t k_smem = hopper::smem_addr(sm + L::K);
  const uint32_t v_smem = hopper::smem_addr(sm + L::V);
  // scores go to base 2: s * scale * log2(e), or with a softcap c
  // tanh(s * scale / c) * c * log2(e)
  const float pre = CAP ? p.scale / p.softcap : p.scale * LOG2E;
  const float post = p.softcap * LOG2E;

  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  hopper::mbar_wait(q_full, 0);

  // this block's tile at k0 holds a masked key or a key past S
  auto needs_mask = [&](int k0) {
    return k0 + BK > S || (p.causal && k0 + BK - 1 > q0) ||
           (p.window > 0 && k0 <= q0 + WQ - 1 - p.window);
  };
  // Scores to weights in place, with the running max and sum; alpha: the
  // factor of the rows' earlier sums.  No branch between a product's issue
  // and its wait (softcap and the mask are compile-time choices here, the
  // mask a select per score): ptxas waits for the product at any join.
  auto softmax = [&](int k0, float (&alpha)[2], auto masked) {
    if constexpr (CAP) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) s[x] = tanhf(s[x] * pre) * post;
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) s[x] *= pre;
    }
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        // s[x]: row row0 + 8 ((x >> 1) & 1), key k0 + 8 (x / 4) + 2 t + (x & 1).
        // A key past S is no key at all; a masked key keeps the JAX
        // kernel's arithmetic (exp(-2e38 - m), wiped by a later alpha)
        const int key = k0 + (x / 4) * 8 + 2 * t + (x & 1);
        const int row = row0 + ((x >> 1) & 1) * 8;
        const bool hidden = (p.causal && key > row) || (p.window > 0 && key <= row - p.window);
        s[x] = key >= S ? -INFINITY : hidden ? NEG_INF : s[x];
      }
    }
    float mt[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], s[x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a row are four neighbouring lanes
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = hopper::exp2_approx(m[r] - mt[r]);
      m[r] = mt[r];
    }
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      s[x] = hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);
      rs[(x >> 1) & 1] += s[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  };
  // S = Q K^T of the tile in stage st, issued
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK, 0, 0>(
          s, hopper::desc_sw128(q_smem + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, 1024),
          hopper::desc_sw128(k_smem + (st * NB + kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, 1024),
          kk > 0);
    hopper::wgmma_commit();
  };
  // O += P V of the tile in stage st, issued; P in bf16 pairs, keys
  // 16 kc .. 16 kc + 15 the A operand of step kc
  uint32_t pa[BK / 16][4];
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
      hopper::wgmma_rs<D, 1>(
          o, pa[kc],
          hopper::desc_sw128(v_smem + st * NB * L::KV_BOX + kc * 16 * 128, L::KV_BOX, 1024), 1);
    hopper::wgmma_commit();
  };
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) hopper::fence_regs(pa[kc]);
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kc][e] = hopper::pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
  };

  // An iteration issues S_i = Q K_i^T and O += P_{i-1} V_{i-1}, waits for
  // S_i, computes P_i, then waits for the product (ptxas places that wait
  // at the row max's first shuffle), rescales O and packs P_i; then K_i
  // and V_{i-1} are released.
  // Every branch around a wgmma depends on the block alone, so a
  // warpgroup whose rows see none of a tile's keys computes it all the
  // same: its weights come out 0, or are wiped by a later alpha.
  float alpha[2];
  auto first = [&](auto masked) {
    hopper::mbar_wait(&k_full[0], 0);
    fence_all();
    hopper::wgmma_fence();
    issue_qk(0);
    hopper::wgmma_wait<0>();
    fence_all();
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    softmax(kt_lo * BK, alpha, masked);
    rescale_and_pack(alpha);
  };
  if (needs_mask(kt_lo * BK))
    first(std::true_type{});
  else
    first(std::false_type{});
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % STAGES, pst = (i - 1) % STAGES;
    // refill the stages that every warp released in the previous
    // iteration: K of tile i - 1, V of tile i - 2
    if (tid == 0) {
      if (i - 1 + STAGES < n_tiles) {
        hopper::mbar_wait(&k_empty[pst], ((i - 1) / STAGES) & 1);
        load_k(i - 1 + STAGES);
      }
      if (i >= 2 && i - 2 + STAGES < n_tiles) {
        hopper::mbar_wait(&v_empty[(i - 2) % STAGES], ((i - 2) / STAGES) & 1);
        load_v(i - 2 + STAGES);
      }
    }
    __syncwarp();
    auto step = [&](auto masked) {
      hopper::mbar_wait(&k_full[st], (i / STAGES) & 1);
      hopper::mbar_wait(&v_full[pst], ((i - 1) / STAGES) & 1);
      fence_all();
      hopper::wgmma_fence();
      issue_qk(st);
      issue_pv(pst);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      softmax((kt_lo + i) * BK, alpha, masked);
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) {
        hopper::mbar_arrive(&k_empty[st]);
        hopper::mbar_arrive(&v_empty[pst]);
      }
      rescale_and_pack(alpha);
    };
    if (needs_mask((kt_lo + i) * BK))
      step(std::true_type{});
    else
      step(std::false_type{});
  }
  {  // the last tile's product
    const int pst = (n_tiles - 1) % STAGES;
    hopper::mbar_wait(&v_full[pst], ((n_tiles - 1) / STAGES) & 1);
    fence_all();
    hopper::wgmma_fence();
    issue_pv(pst);
    hopper::wgmma_wait<0>();
    fence_all();
  }

  if (r0 >= S) return;  // the whole warpgroup lies past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lsum = fmaxf(l[r], 1e-37f);
    // O into this warpgroup's Q rows, swizzled as the TMA box expects:
    // 16-byte chunk c of row rl at chunk c ^ (rl % 8)
    const int rl = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(sm + (j / 8) * L::Q_BOX + (wg * 64 + rl) * 128 +
                                         ((j % 8) ^ g) * 16 + t * 4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / lsum, o[4 * j + 2 * r + 1] / lsum);
    if constexpr (LSE)
      if (t == 0 && row0 + 8 * r < S)
        p.lse[(static_cast<long long>(b) * p.H + h) * S + row0 + 8 * r] =
            m[r] * LN2 + logf(lsum);
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int x = 0; x < NB; ++x)
      hopper::tma_store_4d(&to, sm + x * L::Q_BOX + wg * 64 * 128, x * BOX, h, r0, b);
    hopper::tma_store_commit();
    hopper::tma_store_wait();
  }
}

template <int D, bool LSE, bool CAP>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  auto kernel = flash_fwd_wgmma_kernel<D, LSE, CAP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!hopper::bhsd_map(&tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, WQ) ||
      !hopper::bhsd_map(&tk, p.k, B, p.S, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh, Tiles<D>::BK) ||
      !hopper::bhsd_map(&tv, p.v, B, p.S, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh, Tiles<D>::BK) ||
      !hopper::bhsd_map(&to, p.o, B, p.S, p.H, D, p.o_sb, p.o_ss, p.o_sh, 64))
    return cudaErrorInvalidValue;
  const dim3 grid(p.H * B * ((p.S + WQ - 1) / WQ));
  kernel<<<grid, WNT, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <int D, bool LSE>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_f32_kernel<D, LSE>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int B, int dtype, cudaStream_t st) {
  const bool lse = p.lse != nullptr;
  if (dtype == 0) return lse ? launch_f32<D, true>(p, B, st) : launch_f32<D, false>(p, B, st);
  if (dtype == 1) {
    if (p.softcap > 0.f)
      return lse ? launch_bf16<D, true, true>(p, B, st) : launch_bf16<D, false, true>(p, B, st);
    return lse ? launch_bf16<D, true, false>(p, B, st) : launch_bf16<D, false, false>(p, B, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (then q, k, v must start on a 16-byte
// boundary with strides of whole 16 bytes: the TMA's rule).  lse: (B, H,
// S) f32, or null for none.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   int B, int S, int H, int Hkv, int D, int dtype,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  Params p{q, k, v, o, lse,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           B, S, H, Hkv, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(p, B, dtype, st);
  if (D == 128) return launch_d<128>(p, B, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
