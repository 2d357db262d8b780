// Flash attention forward for Hopper (sm_90a), bf16 and f32, on wgmma.
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
// an SM, 64 + 64 f32 accumulators a thread; D 256 (gemma3) 64 keys and 2
// stages (192 KB), 128 + 32 f32 accumulators of O and S a thread, O += P V
// one wgmma m64n256k16 a 16-key step.
// D 80 (zamba2-2.7b's shared attention, MHA 32 / 32): laid out as D 128
// (`hopper::box_cols`), two boxes a row whose tensor maps have an inner
// extent of 80, so TMA fills columns 80-127 with zeros on every load and
// the store drops them: S = Q K^T stops after the 5 k-steps of the true
// head dim (no column past 80 enters a score, so the body does not rely
// on the zeros: O's columns past 80 are never stored), O += P V runs at
// N 128 over V's zero columns (a wgmma
// m64n80k16 would save 3/8 of it; V's MN-major tile then spans two swizzle
// atoms), and nothing is copied or padded in device memory.  Its tiles are
// D 128's: the same shared memory and registers a thread.
// D 192 with v at 128 (deepseek-v2-lite's MLA, 16 / 16 heads: q and k are
// 128 nope + 64 rope columns, v 128): q and k laid out as D 256
// (`hopper::box_cols`) in D 256's tiles, their tensor maps at an inner
// extent of 192, of which the three boxes that hold columns are loaded
// (the fourth is never loaded nor read); S = Q K^T stops after the 12
// k-steps of 192.  V, O and their maps are 128 wide (`hopper::v_dim`):
// V takes two boxes a stage and O += P V runs at N 128, so the product
// does no work on columns V does not have.  Nothing is padded or copied
// in device memory; the f32 pre-pass splits q and k at 192 and v at 128.
//
//
// f32 body (`flash_fwd_f32_wgmma_kernel`, the exactness path, the train
// CLI's dtype): the same body (`fwd_body`) on the bf16 tensor cores, its
// operands as three bf16 pieces each (csrc/hopper.cuh).
// - A pre-pass of the same C call (`hopper::split3`) writes q, k and v as
//   pieces x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) into
//   the wrapper's bf16 scratch, one (3, B, S, heads, D) tensor each, which
//   the bf16 tensor maps read unchanged (piece p of batch b at p B + b);
//   so the f32 inputs need no TMA alignment.  P is split in registers,
//   straight from the f32 accumulator, into three A fragments.
// - S = sum over i + j <= 2 of Q_i K_j^T and O += sum of P_i V_j: six bf16
//   wgmma products each, the smallest terms first, every product exact;
//   the terms dropped (i + j > 2) are of order 2^-24 |A| |B|, as are the
//   pieces' own rounding.  Softmax, the running max and sum and lse stay
//   f32.  O accumulates on the tensor cores (their accumulation does not
//   round to nearest, but S / BK tiles of six products, each rescaled by
//   alpha, stay far inside the bar: PERF.md).
// - Bound: six passes at 989 TFLOP/s, 165 TFLOP/s effective (2.5x the CUDA
//   cores' 67): 0.156 ms for bert-mlm-120m's 25.8 GFLOP at B 32, S 512.
// - The bf16 body's approximations, held against the f32 bar of 2e-5
//   (|O| <= max |v|, about 4 for normal inputs): ex2.approx's relative
//   error of about 2^-22 moves each weight, and so O, by 2.4e-7 of its
//   size; folding scale * log2(e) into one f32 factor errs by 2^-24 of
//   the exponent (|s scale| < 20 here: under 1e-6 of a weight); the
//   -2e38 of a hidden key and -inf past S give exactly 0, as in f32.  The
//   softcap keeps the accurate tanhf.  Measured on the card, the f32
//   gate's worst error (PERF.md) is the card's own accumulation order on
//   top of these.
// - Tiles: D 64 as bf16 with 3 stages (198 KB, one block an SM); D 128
//   takes 32-key tiles and 2 stages (198 KB); D 256 one consumer warpgroup
//   (Q's pieces are 96 KB for its 64 rows) and 16-key tiles in 2 stages
//   (192 KB).  O is stored in f32 from the fragment, 8 bytes a store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

constexpr int BOX = 64;    // columns of a TMA box (128 bytes of bf16: the swizzle span)

// Tiles of the body whose operands are NP bf16 pieces (1: bf16 inputs;
// 3: f32 inputs, see hopper.cuh).  WG: consumer warpgroups of a block, 64
// q rows each.  D 80 holds D 128's shared-memory layout and accumulators
// (hopper::box_cols), so it takes D 128's key tiles and stages.
template <int D, int NP>
struct Tiles;
template <>
struct Tiles<64, 1> {
  static constexpr int BK = 64, STAGES = 3, MIN_BLOCKS = 2, WG = 2;
};
template <>
struct Tiles<80, 1> {
  static constexpr int BK = 128, STAGES = 2, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<128, 1> {
  static constexpr int BK = 128, STAGES = 2, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<256, 1> {  // 128 + 32 + 16 f32 registers of O, S and P a thread
  static constexpr int BK = 64, STAGES = 2, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<64, 3> {
  static constexpr int BK = 64, STAGES = 3, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<80, 3> {
  static constexpr int BK = 32, STAGES = 2, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<128, 3> {
  static constexpr int BK = 32, STAGES = 2, MIN_BLOCKS = 1, WG = 2;
};
template <>
struct Tiles<256, 3> {  // Q's three pieces: 96 KB for one warpgroup's 64 rows
  static constexpr int BK = 16, STAGES = 2, MIN_BLOCKS = 1, WG = 1;
};
// D 192 (MLA): D 256's layout of q and k (hopper::box_cols), so its tiles
template <int NP>
struct Tiles<192, NP> : Tiles<256, NP> {};

// shared memory, in bytes from a 1024-aligned base: Q as NP pieces of NB
// boxes of WQ rows, then K of every stage, then V of every stage (box x of
// piece p of stage s at ((s * NP + p) * NB + x) boxes, NBV boxes for V),
// then the barriers; NB = box_cols / 64, the boxes of a row (2 at D 80, 4
// at D 192, of which NBL = 3 hold columns); NBV: V's (v_dim's) boxes
template <int D, int NP>
struct Smem {
  static constexpr int NB = hopper::box_cols<D>() / BOX, NBL = hopper::data_boxes<D>();
  static constexpr int DV = hopper::v_dim<D>(), NBV = hopper::box_cols<DV>() / BOX;
  static constexpr int BK = Tiles<D, NP>::BK, STAGES = Tiles<D, NP>::STAGES;
  static constexpr int WQ = 64 * Tiles<D, NP>::WG, WNT = 128 * Tiles<D, NP>::WG;  // q rows, threads
  static constexpr int Q_BOX = WQ * BOX * 2, KV_BOX = BK * BOX * 2;
  static constexpr int K = NP * NB * Q_BOX;
  static constexpr int V = K + STAGES * NP * NB * KV_BOX;
  static constexpr int BAR = V + STAGES * NP * NBV * KV_BOX;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

// The body of both kernels; tq, tk, tv read the operands' pieces (B' =
// NP B, piece p of batch b at p B + b), `to` writes a bf16 O (NP = 1).
template <int D, int NP, bool LSE, bool CAP>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& to,
                                         const Params& p) {
  using L = Smem<D, NP>;
  constexpr int NB = L::NB, NBL = L::NBL, NBV = L::NBV, DV = L::DV;
  constexpr int BK = L::BK, STAGES = L::STAGES, NPAIR = hopper::n_pairs(NP);
  constexpr int WQ = L::WQ, WNT = L::WNT;
  constexpr int DP = NBV * BOX;  // O's columns: v's boxes (zeros past DV)
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
    hopper::mbar_expect_tx(&k_full[s], NP * NBL * L::KV_BOX);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x)
        hopper::tma_load_4d(sm + L::K + ((s * NP + pc) * NB + x) * L::KV_BOX, &tk, &k_full[s],
                            x * BOX, hk, k0, pc * p.B + b);
  };
  auto load_v = [&](int i) {
    const int s = i % STAGES, k0 = (kt_lo + i) * BK;
    hopper::mbar_expect_tx(&v_full[s], NP * NBV * L::KV_BOX);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBV; ++x)
        hopper::tma_load_4d(sm + L::V + ((s * NP + pc) * NBV + x) * L::KV_BOX, &tv, &v_full[s],
                            x * BOX, hk, k0, pc * p.B + b);
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
    hopper::mbar_expect_tx(q_full, NP * NBL * L::Q_BOX);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x)
        hopper::tma_load_4d(sm + (pc * NB + x) * L::Q_BOX, &tq, q_full, x * BOX, h, q0,
                            pc * p.B + b);
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

  float o[DP / 2], s[BK / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
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
  // S = Q K^T of the tile in stage st, issued: the sum over the piece
  // pairs (i, j) of Q_i K_j^T, smallest first, over the D / 16 k-steps of
  // the true head dim
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int k = 0; k < NPAIR; ++k)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK, 0, 0>(
            s,
            hopper::desc_sw128(
                q_smem + (hopper::pair_i(NP, k) * NB + kk / 4) * L::Q_BOX + (kk % 4) * 32, 16,
                1024),
            hopper::desc_sw128(
                k_smem + ((st * NP + hopper::pair_j(NP, k)) * NB + kk / 4) * L::KV_BOX +
                    (kk % 4) * 32,
                16, 1024),
            k > 0 || kk > 0);
    hopper::wgmma_commit();
  };
  // O += P V of the tile in stage st, issued: over the piece pairs, P_i in
  // bf16 pairs (keys 16 kc .. 16 kc + 15 the A operand of step kc) and V_j
  uint32_t pa[NP][BK / 16][4];
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int k = 0; k < NPAIR; ++k)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        hopper::wgmma_rs<DP, 1>(
            o, pa[hopper::pair_i(NP, k)][kc],
            hopper::desc_sw128(
                v_smem + (st * NP + hopper::pair_j(NP, k)) * NBV * L::KV_BOX + kc * 16 * 128,
                L::KV_BOX, 1024),
            1);
    hopper::wgmma_commit();
  };
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(o);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) hopper::fence_regs(pa[pc][kc]);
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t w[NP];
        hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // P's pieces
#pragma unroll
        for (int pc = 0; pc < NP; ++pc) pa[pc][kc][e] = w[pc];
      }
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
    const int row = row0 + 8 * r;
    if constexpr (NP == 1) {
      // O's DV columns into this warpgroup's Q rows, swizzled as the TMA box
      // expects: 16-byte chunk c of row rl at chunk c ^ (rl % 8)
      const int rl = warp * 16 + g + 8 * r;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(sm + (j / 8) * L::Q_BOX + (wg * 64 + rl) * 128 +
                                           ((j % 8) ^ g) * 16 + t * 4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / lsum, o[4 * j + 2 * r + 1] / lsum);
    } else if (row < S) {  // f32 O straight from the fragment, 8 bytes a store
      float* orow = static_cast<float*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r] / lsum, o[4 * j + 2 * r + 1] / lsum);
    }
    if constexpr (LSE)
      if (t == 0 && row < S)
        p.lse[(static_cast<long long>(b) * p.H + h) * S + row] = m[r] * LN2 + logf(lsum);
  }
  if constexpr (NP == 1) {
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (tid % 128 == 0) {
#pragma unroll
      for (int x = 0; x < hopper::data_boxes<DV>(); ++x)
        hopper::tma_store_4d(&to, sm + x * L::Q_BOX + wg * 64 * 128, x * BOX, h, r0, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait();
    }
  }
}

// bf16 q, k, v and O
template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(Smem<D, 1>::WNT, Tiles<D, 1>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, Params p) {
  fwd_body<D, 1, LSE, CAP>(tq, tk, tv, to, p);
}

// f32 q, k, v (read as their three bf16 pieces) and O; `to` is not read
template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(Smem<D, 3>::WNT, Tiles<D, 3>::MIN_BLOCKS)
    flash_fwd_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to, Params p) {
  fwd_body<D, 3, LSE, CAP>(tq, tk, tv, to, p);
}

// The bf16 operands the kernel reads: q, k, v as (NP B, S, heads, D) with
// strides in elements, D contiguous.
struct Operands {
  const void* ptr[3];
  long long stride[3][3];
};

template <int D, int NP, bool LSE, bool CAP>
cudaError_t launch(const Params& p, const Operands& x, cudaStream_t stream) {
  constexpr int smem = Smem<D, NP>::BYTES;
  auto kernel = [] {
    if constexpr (NP == 1)
      return flash_fwd_wgmma_kernel<D, LSE, CAP>;
    else
      return flash_fwd_f32_wgmma_kernel<D, LSE, CAP>;
  }();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr int DV = hopper::v_dim<D>();
  const int nb = NP * p.B, BK = Tiles<D, NP>::BK, WQ = Smem<D, NP>::WQ;
  // each map at its tensor's true inner extent: D for q and k, DV for v
  // and o
  auto map = [&](CUtensorMap* m, int i, int heads, int cols, int rows) {
    return hopper::bhsd_map(m, x.ptr[i], nb, p.S, heads, cols, x.stride[i][0], x.stride[i][1],
                            x.stride[i][2], rows);
  };
  CUtensorMap tq, tk, tv, to{};
  if (!map(&tq, 0, p.H, D, WQ) || !map(&tk, 1, p.Hkv, D, BK) || !map(&tv, 2, p.Hkv, DV, BK) ||
      (NP == 1 && !hopper::bhsd_map(&to, p.o, p.B, p.S, p.H, DV, p.o_sb, p.o_ss, p.o_sh, 64)))
    return cudaErrorInvalidValue;
  const dim3 grid(p.H * p.B * ((p.S + WQ - 1) / WQ));
  kernel<<<grid, Smem<D, NP>::WNT, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

// the softcap is built at the head dims D == DV (MLA has none)
template <int D, int NP>
cudaError_t launch_opts(const Params& p, const Operands& x, cudaStream_t st) {
  const bool lse = p.lse != nullptr;
  if (p.softcap > 0.f) {
    if constexpr (hopper::v_dim<D>() != D) return cudaErrorInvalidValue;
    else
      return lse ? launch<D, NP, true, true>(p, x, st) : launch<D, NP, false, true>(p, x, st);
  }
  return lse ? launch<D, NP, true, false>(p, x, st) : launch<D, NP, false, false>(p, x, st);
}

template <int D>
cudaError_t launch_d(const Params& p, int dtype, void* pieces, cudaStream_t st) {
  if (dtype == 1)
    return launch_opts<D, 1>(p, {{p.q, p.k, p.v}, {{p.q_sb, p.q_ss, p.q_sh},
                                                        {p.k_sb, p.k_ss, p.k_sh},
                                                        {p.v_sb, p.v_ss, p.v_sh}}}, st);
  if (dtype != 0 || pieces == nullptr) return cudaErrorInvalidValue;
  // f32: q, k, v into their pieces, one (3, B, S, heads, D) bf16 tensor
  // each (v's D is DV), one after the other in the caller's scratch
  constexpr int DV = hopper::v_dim<D>();
  const long long rq = static_cast<long long>(p.S) * p.H * D, rk = static_cast<long long>(p.S) * p.Hkv * D;
  const long long rv = static_cast<long long>(p.S) * p.Hkv * DV;
  __nv_bfloat16* pq = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* pk = pq + 3 * p.B * rq;
  __nv_bfloat16* pv = pk + 3 * p.B * rk;
  const hopper::SplitArgs a{{static_cast<const float*>(p.q), static_cast<const float*>(p.k),
                             DV == D ? static_cast<const float*>(p.v) : nullptr, nullptr},
                            {pq, pk, pv, nullptr},
                            {p.q_sb, p.k_sb, p.v_sb, 0},
                            {p.q_ss, p.k_ss, p.v_ss, 0},
                            {p.q_sh, p.k_sh, p.v_sh, 0},
                            {p.H, p.Hkv, p.Hkv, 0}};
  cudaError_t e = hopper::split3(a, DV == D ? 3 : 2, p.B, p.S, D, st);
  if (e != cudaSuccess) return e;
  if constexpr (DV != D) {  // v at its own head dim
    const hopper::SplitArgs av{{static_cast<const float*>(p.v), nullptr, nullptr, nullptr},
                               {pv, nullptr, nullptr, nullptr},
                               {p.v_sb, 0, 0, 0},
                               {p.v_ss, 0, 0, 0},
                               {p.v_sh, 0, 0, 0},
                               {p.Hkv, 0, 0, 0}};
    if ((e = hopper::split3(av, 1, p.B, p.S, DV, st)) != cudaSuccess) return e;
  }
  return launch_opts<D, 3>(p, {{pq, pk, pv}, {{rq, static_cast<long long>(p.H) * D, D},
                                               {rk, static_cast<long long>(p.Hkv) * D, D},
                                               {rv, static_cast<long long>(p.Hkv) * DV, DV}}}, st);
}

}  // namespace

// dtype: 0 = float32 (then `pieces` is bf16 scratch of 3 B S ((H + Hkv) D +
// Hkv Dv) elements for q, k and v as three bf16 pieces each), 1 = bfloat16 (then q,
// k, v must start on a 16-byte boundary with strides of whole 16 bytes:
// the TMA's rule).  lse: (B, H, S) f32, or null for none.  Returns a
// cudaError_t (0 = launched).  `pieces` comes last, after the stream, so
// that a caller passing it can drive a build of an earlier source; `Dv`
// (v's and o's head dim: D, or 128 at MLA's D 192) after it, likewise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   int B, int S, int H, int Hkv, int D, int dtype,
                                   int causal, int window, float softcap, float scale,
                                   void* stream, void* pieces, int Dv) {
  Params p{q, k, v, o, lse,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           B, S, H, Hkv, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128) return launch_d<192>(p, dtype, pieces, st);
  if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch_d<64>(p, dtype, pieces, st);
  if (D == 80) return launch_d<80>(p, dtype, pieces, st);
  if (D == 128) return launch_d<128>(p, dtype, pieces, st);
  if (D == 256) return launch_d<256>(p, dtype, pieces, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
