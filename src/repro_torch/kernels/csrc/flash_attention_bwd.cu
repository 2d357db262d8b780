// Flash attention backward for Hopper (sm_90a), f32 and bf16, on wgmma.
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
// With a logit softcap c the scores are c tanh(scale q k^T / c), and with
// t = tanh(scale q k^T / c) (the forward's lse is that of the capped
// scores)
//   P  = exp(c t - lse),   dS = P * (dP - Delta) * (1 - t^2),
// the rest as above: dS carries the cap's derivative, dV does not.
// Causal or not, with a sliding window or not (key j is seen by row i
// when i - W < j, and j <= i if causal), any GQA ratio (kv head = h /
// rep: dK and dV sum over the rep query heads of their kv head), D in
// {64, 80, 128, 256}, ragged S.  The softcap is built at D 128 and causal
// (gemma2's attention), in both dtypes; the wrapper refuses the others.
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
// dK and dV (64 x D f32 each per warpgroup) and runs one.  D 256 (gemma3,
// `Shape<256, 1>`): one warpgroup a block, 32-key dq stages (dQ alone is
// 128 f32 registers a thread) and 32-row dkdv stages, and dkdv splits dK
// and dV into two halves of 128 columns, a block each (NH): both halves
// recompute S^T and dP^T over the whole head dim, so dkdv does 1.5x the
// products of one pass, in 176 registers instead of 300.  A sliding
// window: dq visits only the key tiles that meet (q - W, q], dkdv only
// the q tiles that meet [k, k + W); tiles across the window's edge take
// the masked variant.
// D 80 (zamba2-2.7b, MHA 32 / 32, causal): laid out as D 128
// (`hopper::box_cols`), two boxes a row whose tensor maps have an inner
// extent of 80, so every load fills columns 80-127 with zeros and every
// store drops them.  S, dP (and their transposes) stop after the 5
// k-steps of the true head dim; the bf16 Delta = rowsum(dO O) sums whole
// boxes, so it relies on the zeros; dQ += dS K, dV += P^T dO and dK += dS^T Q
// run at N 128 over the zero columns (their columns past 80 stay 0 and
// are never written: the TMA store drops them, the f32 epilogue stores 80
// columns).  Its shapes are D 128's, whose shared memory and registers it
// holds.
// D 192 with v at 128 (deepseek-v2-lite's MLA, 16 / 16 heads, causal):
// q and k laid out as D 256 (`hopper::box_cols`) in D 256's shapes, their
// maps (and dq's, dk's) at an inner extent of 192, v, o, dO and dv at 128
// (`hopper::v_dim`).  Only the boxes that hold columns are loaded: three
// of q and k, two of v, o and dO; the rest of a 256 layout is never
// loaded, and enters only output columns that are never stored.  S (and
// S^T) stop after the 12 k-steps of 192, dP (and dP^T) after the 8 of
// 128; Delta sums v's two boxes.  dQ += dS K runs at N 256 (columns
// 192-255 dropped), and dkdv's two column halves take dK's columns 0-127
// and 128-191 and dV's 0-127: the second half's dV product runs over
// columns V does not have, and its store is skipped.  The f32 bodies
// (`Shape<256, 3>`'s resident tiles) hold dO and V in f32 at 128 columns,
// and dQ and dK in registers alone (192 columns: RREG).
// The softcap is a compile-time choice of both passes (CAP), as in the
// forward, so that no branch on it lies near a wgmma.  Each pass computes
// t with the accurate tanhf while dP runs (tanh.approx's ~2^-11 times a
// cap of 50 would miss the f32 bar), and 1 - t^2 as one fma (rounded once;
// where |t| is near 1 its absolute error stays an ulp or two of t).  dq
// keeps P (1 - t^2) in the score registers, since it needs P for nothing
// else; dkdv keeps t there and forms P = exp2(c log2(e) t - lse log2(e))
// and dS^T once dP^T is in, so neither pass holds a register array more.
//
// f32 body (`dq_f32_wgmma_kernel`, `dkdv_f32_wgmma_kernel`: the exactness
// path, the train CLI's dtype): the same two passes (`dq_body`,
// `dkdv_body`) on the bf16 tensor cores, every operand as three bf16
// pieces (csrc/hopper.cuh), no atomics, so bit-exact resume still holds.
// - A pre-pass of the same C call (`hopper::split3`) writes q, k, v and
//   dO as pieces x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)
//   into the wrapper's bf16 scratch (one (3, B, S, heads, D) tensor each,
//   read by the bf16 tensor maps, piece p of batch b at p B + b).  P and
//   dS are split in registers into three A fragments each.
// - Each of the seven products is the sum over i + j <= 2 of the pieces'
//   bf16 products, the smallest first, each exact: the terms dropped are
//   of order 2^-24 |A| |B|.  Delta = rowsum(dO O) is exact f32 arithmetic
//   on the f32 O and dO, read from device memory by dq (no O tile in
//   shared memory); P, dS and lse stay f32.
// - The gradients' long sums (dQ over the keys; dK and dV over rep heads
//   x S rows) do not accumulate on the tensor cores: each tile's products
//   go into a fresh 64-column f32 partial, which an f32 add (round to
//   nearest) brings into the gradient (`add_partial`).  The tensor cores'
//   accumulation drops up to an ulp of the running sum a step, always the
//   same way; summed over the whole chain (six pieces a product, rep x S
//   rows) it put GQA and S-512 cases at up to 2.8x the 2e-5 bar on the
//   card, and 0.48x with the partials (PERF.md §6).
// - Bound: five products at 989 / 6 TFLOP/s (six bf16 passes each, 2.5x
//   the CUDA cores' 67): 0.391 ms at bert-mlm-120m's B 32, S 512; the
//   seven this design computes take 0.55 ms at that rate.
// - The approximations against the f32 bar of 2e-5: ex2.approx (relative
//   2^-22) and lse * log2(e) in f32 (2^-24 of |lse|, under 1e-6 of a
//   weight at |lse| < 20) move P by about 1e-6 of itself; the f32 sums of
//   each product in another order than the reference's carry 2^-24 of
//   each term's size.
// - Shapes (`Shape`): D 64 keeps the bf16 tiles with two stages (dq 193
//   KB, dkdv 194 KB, one block an SM).  D 128 takes one consumer warpgroup
//   a block (the three pieces of two warpgroups' resident tiles would
//   need 288 KB), 32-key dq stages and 32-row dkdv stages (193 KB each).
//   dkdv forms P^T and dS^T, then holds P^T's pieces and dS^T's in turn in
//   one set of A registers for dV += P^T dO and dK += dS^T Q; the
//   gradients are stored in f32 from the fragments.
// - D 256 (`Shape<256, 3>`, gemma3's f32 training): the pieces of one
//   warpgroup's two resident tiles would take 192 KB, so dq holds Q's
//   pieces (96 KB, by TMA) and dO in f32 (64 KB, loaded once by the
//   block's threads), and dkdv's dK block K's pieces and V in f32.  S = Q
//   K^T (S^T = K Q^T) reads the pieces from shared memory; dP = dO V^T
//   (dP^T = V dO^T) takes the f32 tile as the register A operand, each
//   16-column slice's three pieces formed as it is issued, while S and
//   the slice before run (`hybrid_products`, `a_pieces`).  dP's pair (0,
//   0) accumulates apart from the five smaller pairs, the two added in
//   f32, so that the tensor cores' inexact accumulation over the 96 steps
//   of a 256-long product runs at the product's size for 16 of them only
//   (S sums the pairs smallest first, as the D-128 bodies do).  The
//   streamed side comes as pieces by TMA in 16-row tiles, one stage.  dq
//   holds dQ whole; dkdv takes dV and dK in two blocks, each over the
//   whole head dim: the dK block as above (`dk_res_body`), the dV block,
//   which needs K alone, with K's pieces and two stages (`dv_res_body`).
//   A gradient keeps three quarters of a thread's values in registers and
//   the rest in shared memory (the whole in registers spilled).  Forming
//   the pieces in registers, 16 keys or q rows a tile, sets the pace
//   (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  // scratch: each row's lse * log2(e) and Delta as (B, H, ceil(S / 64), 2,
  // 64), written by the dq pass
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
  int window;  // <= 0: no window
  float softcap;  // > 0: the logit softcap (CAP bodies only)
};

constexpr int BOX = 64;                    // columns of a box: 128 bytes of bf16, the swizzle span
constexpr int TILE = 64;                   // a warpgroup's rows or keys; the q tiles of the scratch
constexpr int BOX_BYTES = TILE * BOX * 2;
constexpr float LOG2E = 1.4426950408889634f;

// Shapes of the bodies whose operands are NP bf16 pieces (1: bf16 inputs;
// 3: f32 inputs, see hopper.cuh).  WG: consumer warpgroups of a block (64
// q rows in dq, 64 keys in dkdv, each); DQ_BK: keys of a dq stage; QT: q
// rows of a dkdv stage; DQ_BLOCKS: dq blocks an SM (launch bounds); NH:
// the parts of the head dim that dkdv splits dK and dV into, a block each
// (each recomputes S^T and dP^T over the whole head dim); RES: of the two
// resident tiles (Q and dO in dq, K and V in dkdv) one is held as pieces
// and the other in f32, its pieces formed 16 columns at a time as the
// register A operand of dP (`hybrid_products`), and dkdv's two blocks take
// dV and dK (`dv_res_body`, `dk_res_body`).
struct ShapeBase {
  static constexpr bool RES = false;
  static constexpr int RREG = 0;  // RES only
};
template <int D, int NP>
struct Shape;
template <>
struct Shape<64, 1> : ShapeBase {
  static constexpr int WG = 2, DQ_BK = 64, DQ_STAGES = 3, DQ_BLOCKS = 2, QT = 64, KV_STAGES = 3,
                       NH = 1;
};
// D 80: D 128's layout (hopper::box_cols) and so D 128's tiles
template <>
struct Shape<80, 1> : ShapeBase {
  static constexpr int WG = 2, DQ_BK = 64, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 64, KV_STAGES = 3,
                       NH = 1;
};
template <>
struct Shape<128, 1> : ShapeBase {
  static constexpr int WG = 2, DQ_BK = 64, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 64, KV_STAGES = 3,
                       NH = 1;
};
// D 256: dQ alone is 128 f32 registers a thread, and dK and dV of 64 keys
// x 256 would be 256, so one warpgroup, 32-row tiles, and dK and dV in
// two halves of 128 columns
template <>
struct Shape<256, 1> : ShapeBase {
  static constexpr int WG = 1, DQ_BK = 32, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 32, KV_STAGES = 3,
                       NH = 2;
};
template <>
struct Shape<64, 3> : ShapeBase {
  static constexpr int WG = 2, DQ_BK = 64, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 64, KV_STAGES = 2,
                       NH = 1;
};
template <>
struct Shape<80, 3> : ShapeBase {  // D 128's layout: one warpgroup, as there
  static constexpr int WG = 1, DQ_BK = 32, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 32, KV_STAGES = 2,
                       NH = 1;
};
template <>
struct Shape<128, 3> : ShapeBase {  // one warpgroup: the resident pieces of two would need 288 KB
  static constexpr int WG = 1, DQ_BK = 32, DQ_STAGES = 2, DQ_BLOCKS = 1, QT = 32, KV_STAGES = 2,
                       NH = 1;
};
// f32 at D 256: the three pieces of both of one warpgroup's resident
// tiles would take 192 KB, so one (Q in dq, K in dkdv's dK block) is held
// as pieces (96 KB) and the other (dO, V) stays f32 (64 KB, RES); the
// streamed side comes as pieces in 16-row tiles, one stage (48 KB).  dQ is
// one block's; dkdv takes dV and dK in two blocks (NH), each over the
// whole head dim (`dv_res_body`, `dk_res_body`).  A gradient keeps its
// first RREG values a thread (columns 0 .. 191) in registers and the rest
// in shared memory (16 KB, each thread its own elements): 128 accumulator
// registers a thread left ptxas too few for the rest and it spilled.
template <>
struct Shape<256, 3> {
  static constexpr int WG = 1, DQ_BK = 16, DQ_STAGES = 1, DQ_BLOCKS = 1, QT = 16, KV_STAGES = 1,
                       NH = 2, RREG = 96;
  static constexpr bool RES = true;
};
// D 192 (MLA): D 256's layout of q and k (hopper::box_cols), so its shapes
template <int NP>
struct Shape<192, NP> : Shape<256, NP> {};

// dq: Q, dO (and with bf16 inputs O) of the block's rows as (warpgroup,
// piece, box) boxes of 64 rows, then K and V of each stage (box x of piece
// p of stage s at (s * NP + p) * NB + x, DQ_BK rows a box), then the
// barriers; bytes from a 1024-aligned base.  NB = box_cols / 64, the
// boxes of a row (2 at D 80)
template <int D, int NP>
struct DqSmem {
  static constexpr int NB = hopper::box_cols<D>() / BOX;
  static constexpr int WG = Shape<D, NP>::WG, BK = Shape<D, NP>::DQ_BK;
  static constexpr int STAGES = Shape<D, NP>::DQ_STAGES, KB = BK * BOX * 2;
  // the resident Q's pieces (boxes), then dO's: pieces, or (RES) 64 rows
  // of D floats
  static constexpr bool RES = Shape<D, NP>::RES;
  static constexpr int DOB = RES ? WG * TILE * D * 4 : WG * NP * NB * BOX_BYTES;
  static constexpr int Q = 0, DO = WG * NP * NB * BOX_BYTES, O = DO + DOB;
  static constexpr int K = O + (NP == 1 ? DOB : 0);  // f32 inputs: Delta from device memory
  static constexpr int V = K + STAGES * NP * NB * KB;
  // RES: dQ's values past the first RREG a thread
  static constexpr int ACC = V + STAGES * NP * NB * KB;
  static constexpr int BAR = ACC + (RES ? WG * 128 * (D / 2 - Shape<D, NP>::RREG) * 4 : 0);
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// dkdv: K and V of the block's keys as (warpgroup, piece, box) boxes, then
// Q and dO of each stage (QT rows a box), each stage's lse and Delta, then
// the barriers
template <int D, int NP>
struct KvSmem {
  static constexpr int NB = hopper::box_cols<D>() / BOX;
  static constexpr int WG = Shape<D, NP>::WG, QT = Shape<D, NP>::QT;
  static constexpr int STAGES = Shape<D, NP>::KV_STAGES, QB = QT * BOX * 2, STAT_B = 2 * QT * 4;
  // the resident K's pieces (boxes), then V's: pieces, or (RES) 64 rows
  // of D floats
  static constexpr bool RES = Shape<D, NP>::RES;
  static constexpr int VB = RES ? WG * TILE * D * 4 : WG * NP * NB * BOX_BYTES;
  static constexpr int K = 0, V = WG * NP * NB * BOX_BYTES, Q = V + VB;
  static constexpr int DO = Q + STAGES * NP * NB * QB;
  static constexpr int STAT = DO + STAGES * NP * NB * QB;
  // RES: dK's values past the first RREG a thread
  static constexpr int ACC = STAT + STAGES * STAT_B;
  static constexpr int BAR = ACC + (RES ? WG * 128 * (D / 2 - Shape<D, NP>::RREG) * 4 : 0);
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// dkdv's dV block of a RES shape (dv_res_body): K's pieces as (piece, box)
// boxes of 64 keys, then Q and dO of two stages, each stage's lse and
// Delta, dV's shared half, the barriers
template <int D>
struct DvSmem {
  static constexpr int NP = 3, NB = hopper::box_cols<D>() / BOX, QT = Shape<D, 3>::QT,
                       STAGES = 2;
  static constexpr int QB = QT * BOX * 2, STAT_B = 2 * QT * 4;
  static constexpr int K = 0, Q = NP * NB * BOX_BYTES, DO = Q + STAGES * NP * NB * QB;
  static constexpr int STAT = DO + STAGES * NP * NB * QB;
  static constexpr int ACC = STAT + STAGES * STAT_B;
  static constexpr int BAR = ACC + TILE * D / 2 * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

static_assert(DqSmem<256, 3>::BYTES <= 232448 && KvSmem<256, 3>::BYTES <= 232448 &&
                  DvSmem<256>::BYTES <= 232448 && DvSmem<192>::BYTES <= 232448,
              "a block has 227 KB");

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_addr(p) & 1023)) & 1023);
}

// 16-wide slice kk of the reduction axis of a K-major operand: a tile of
// ROWS rows stored as D/64 boxes from `base`
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  return hopper::desc_sw128(base + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
}

// 16-row slice kc of an MN-major operand read from the same kind of tile
// (its ROWS rows the reduction axis, its D/64 boxes along N)
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kc) {
  return hopper::desc_sw128(base + kc * 16 * 128, ROWS * 128, 1024);
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

// rowsum(dO * O) of row `row` of head h, batch b, exact in f32 from the
// f32 tensors in device memory (0 past S): the four threads of the row
// (t = 0..3) take every fourth element and add
template <int D>
__device__ __forceinline__ float row_dot_f32(const Params& p, int b, int h, int row, int t) {
  float acc = 0.f;
  if (row < p.S) {
    const float* o = static_cast<const float*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
    const float* d = static_cast<const float*>(p.dout) + b * p.do_sb + row * p.do_ss + h * p.do_sh;
#pragma unroll
    for (int i = t; i < D; i += 4) acc = fmaf(o[i], d[i], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// The first D columns of a warpgroup's 64-row accumulator times `scale`,
// in bf16, into its boxes at `box`, swizzled as a TMA box expects; this
// thread holds rows rl0 and rl0 + 8, columns 8 j + 2 t and the next
template <int D, int N>
__device__ __forceinline__ void acc_to_boxes(uint8_t* box, const float (&acc)[N],
                                             float scale, int rl0, int g, int t) {
  static_assert(D / 2 <= N, "D columns of the accumulator");
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(box + (j / 8) * BOX_BYTES + (rl0 + 8 * r) * 128 +
                                         ((j % 8) ^ g) * 16 + t * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
}

// The first W columns of a 64-row accumulator times `scale` in f32
// straight into rows row0 and row0 + 8 (this thread's), columns col0 ..
// col0 + W - 1, of head h of a contiguous (B, S, heads, D) tensor, 8 bytes
// a store; rows past S are dropped
template <int D, int W, int N>
__device__ __forceinline__ void acc_to_f32(float* out, const float (&acc)[N], float scale,
                                           int b, int S, int heads, int h, int row0, int t,
                                           int col0) {
  static_assert(W / 2 <= N && W <= D, "W columns of the accumulator, inside the row");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + row) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// The shared-memory part of an accumulator split at RREG values
// (add_partial's layout: columns 2 RREG .. D - 1) times `scale` into rows
// row0 and row0 + 8 of head h of a contiguous (B, S, heads, D) f32 tensor,
// as acc_to_f32<D, 2 RREG> stores the register part; rows past S dropped
template <int D, int RREG>
__device__ __forceinline__ void sacc_to_f32(float* out, const float* sacc, float scale, int b,
                                            int S, int heads, int h, int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + row) * heads + h) * D;
#pragma unroll
    for (int j = RREG / 4; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r - RREG;  // the pair (i, i + 1) of the shared values
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
          make_float2(sacc[i * 128 + threadIdx.x % 128] * scale,
                      sacc[(i + 1) * 128 + threadIdx.x % 128] * scale);
    }
  }
}

// NB boxes at `box` to rows row .. row + 63 of head h of a map, from
// column col0, the first n of them (the boxes that hold the map's
// columns); after every thread of the warpgroup wrote its part (call from
// one thread)
template <int NB>
__device__ __forceinline__ void store_boxes(const CUtensorMap* map, const uint8_t* box, int h,
                                            int row, int b, int col0 = 0, int n = NB) {
#pragma unroll
  for (int x = 0; x < NB; ++x)
    if (x < n) hopper::tma_store_4d(map, box + x * BOX_BYTES, col0 + x * BOX, h, row, b);
  hopper::tma_store_commit();
  hopper::tma_store_wait();
}

// acc (64 x D, f32) += A B over the NP-piece pairs, A (64 x K) the pieces
// in registers and B (K x D) MN-major from `b`, its pieces `piece` bytes
// apart and its 64-column boxes `box` bytes apart: per PW columns (64, or
// 32 where registers are short) into a fresh partial on the tensor cores,
// then added in f32, so that their accumulation (which does not round to
// nearest: each step can drop up to an ulp of the running sum, always the
// same way) spans one tile's products instead of the whole sum.  Each
// column's sum is the same at either width.  Waits for its products.
//
// RREG < D / 2: `acc` holds the thread's first RREG values (columns 0 ..
// 2 RREG - 1) and `sacc` (shared memory, 128 floats a value, thread t at t)
// the rest.
template <int D, int NP, int K, int PW = 64, int RREG = D / 2>
__device__ __forceinline__ void add_partial(float (&acc)[RREG], uint32_t (&a)[NP][K / 16][4],
                                            uint32_t b0, int piece, int box,
                                            float* sacc = nullptr) {
  static_assert(PW == 64 || PW == 32, "64- or 32-column partials");
  float part[PW / 2];
#pragma unroll
  for (int h = 0; h < D / PW; ++h) {
    // box h * PW / 64, from byte h % (64 / PW) * PW * 2 of its rows; the
    // address opaque a partial at a time: no descriptor is computed early
    uint32_t b = b0 + (h * PW / 64) * box + (h % (64 / PW)) * PW * 2;
    asm volatile("" : "+r"(b));
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int kc = 0; kc < K / 16; ++kc) hopper::fence_regs(a[pc][kc]);
    hopper::fence_regs(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < hopper::n_pairs(NP); ++k)
#pragma unroll
      for (int kc = 0; kc < K / 16; ++kc)
        hopper::wgmma_rs<PW, 1>(part, a[hopper::pair_i(NP, k)][kc],
                                mnmajor<K>(b + hopper::pair_j(NP, k) * piece, kc),
                                k > 0 || kc > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    // part[x]: rows as the accumulator's, columns h PW + 8 (x / 4) + 2 t +
    // (x & 1): acc's element 4 j + e holds column 8 j + 2 t + (e & 1)
#pragma unroll
    for (int x = 0; x < PW / 2; ++x) {
      const int i = PW / 2 * h + x;  // the thread's i-th value
      if (i < RREG)
        acc[i] += part[x];
      else
        sacc[(i - RREG) * 128 + threadIdx.x % 128] += part[x];
    }
  }
}

// Rows row0 .. row0 + 63 of head h, batch b, of an f32 (B, S, heads, D)
// tensor into `dst` (64 x D floats, RES), by the 128 threads of the
// warpgroup; zeros past S.  Column c of row r lies at r D + (c ^ 8 (r % 4)):
// the eight rows of an A fragment's 8-byte reads then meet every bank twice,
// the least a warp's 256 bytes take.
template <int D>
__device__ __forceinline__ void resident_f32(float* dst, const void* src, long long sb,
                                             long long ss, long long sh, int b, int h, int row0,
                                             int S) {
  const float* base = static_cast<const float*>(src) + b * sb + h * sh;
  const bool vec = ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(ss * 4)) & 15) == 0;
  for (int i = threadIdx.x % 128; i < TILE * D / 4; i += 128) {
    const int r = i / (D / 4), c = i % (D / 4) * 4, row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) {
      const float* x = base + row * ss + c;
      v = vec ? *reinterpret_cast<const float4*>(x) : make_float4(x[0], x[1], x[2], x[3]);
    }
    *reinterpret_cast<float4*>(dst + r * D + (c ^ ((r & 3) << 3))) = v;
  }
}

// The three bf16 pieces of this thread's A fragment of the 16-column slice
// kk of a resident f32 tile at shared address `x` (resident_f32's layout):
// rows rl0 and rl0 + 8, columns 16 kk + 2 t and the next, and the same 8
// columns further
template <int D>
__device__ __forceinline__ void a_pieces(uint32_t (&a)[3][4], uint32_t x, int rl0, int kk,
                                         int t) {
  // the address and the swizzle, opaque a slice at a time: the compiler
  // would otherwise compute the offsets of every slice once, ahead of the
  // tile loop, and hold all of them in registers
  int sw = (rl0 & 3) << 3;  // (r & 3) << 3 of both rows
  asm volatile("" : "+r"(sw), "+r"(x));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    constexpr int NP = 3;
    const int r = rl0 + 8 * (e & 1), c = 16 * kk + 2 * t + 8 * (e >> 1);
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y)
                 : "r"(x + 4u * static_cast<uint32_t>(r * D + (c ^ sw))));
    uint32_t w[NP];
    hopper::pack_bf16_pieces<NP>(v.x, v.y, w);  // the resident tile's pieces
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) a[pc][e] = w[pc];
  }
}

// S = Xa Ya^T and dP = Xb Yb^T (64 x N each, f32 on pieces) of a RES body:
// Xa's pieces resident in shared memory (64 rows as (piece, box) boxes from
// xa, K-major), Xb resident in f32 at xb (A from registers, each
// 16-column slice's pieces formed as it is issued), Ya and Yb the streamed
// tiles' pieces (N rows, K-major, `piece` bytes apart).  S is the sum over
// the piece pairs, the smallest first, over the whole head dim, one commit
// group, as the D-128 bodies form it; dP per slice the six pairs, the pair
// (0, 0) into `d` and the five smaller into `d_lo` (the caller adds the
// two in f32), so that the tensor cores' accumulation, which drops up to
// an ulp of the running sum a step, runs 16 steps at the size of the
// product and the other 80 at 2^-8 of it.  A slice's pieces are formed
// while S and the slice before run, in two register sets in turn.
// Returns with the products in flight (the caller waits with
// wgmma_wait<0>).
// DV: the head dim of dP's operands (Xb's columns), D that of S's.
template <int N, int D, int DV = D>
__device__ __forceinline__ void hybrid_products(float (&s)[N / 2], float (&d)[N / 2],
                                                float (&d_lo)[N / 2], uint32_t xa, uint32_t xb,
                                                uint32_t ya, uint32_t yb, int piece, int rl0,
                                                int t) {
  constexpr int NP = 3, NB = hopper::box_cols<D>() / BOX;
  static_assert(D % 64 == 0 && DV % 64 == 0, "the resident-tile bodies hold whole boxes");
  uint32_t a[2][3][4];
  // the last tile's sums are dead: zeros, so that no register stays live
  // across the tile for them
#pragma unroll
  for (int x = 0; x < N / 2; ++x) s[x] = d[x] = d_lo[x] = 0.f;
  hopper::fence_regs(s);
  hopper::fence_regs(d);
  hopper::fence_regs(d_lo);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < hopper::n_pairs(NP); ++k) {
    uint32_t xk = xa, yk = ya;  // opaque a pair at a time: no descriptor is computed early
    asm volatile("" : "+r"(xk), "+r"(yk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<N, 0, 0>(s, kmajor<TILE>(xk + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                                kmajor<N>(yk + hopper::pair_j(NP, k) * piece, kk), k > 0 || kk > 0);
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    uint32_t (&x)[3][4] = a[kk & 1];
    if (kk >= 2) hopper::wgmma_wait<1>();  // the slice two back is done: its set is free
    a_pieces<DV>(x, xb, rl0, kk, t);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc) hopper::fence_regs(x[pc]);
    // the streamed tile's address, opaque a slice at a time, so that no
    // slice's descriptors are computed (and held in registers) before it
    uint32_t y = yb;
    asm volatile("" : "+r"(y));
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < hopper::n_pairs(3); ++k) {
      const int i = hopper::pair_i(3, k), j = hopper::pair_j(3, k);
      if (i == 0 && j == 0)
        hopper::wgmma_rs<N, 0>(d, x[0], kmajor<N>(y, kk), kk > 0);
      else
        hopper::wgmma_rs<N, 0>(d_lo, x[i], kmajor<N>(y + j * piece, kk), kk > 0 || k > 0);
    }
    hopper::wgmma_commit();
  }
}

// Pass 1: dQ, and each row's Delta and lse * log2(e) for pass 2.  The maps
// read the operands' pieces (B' = NP B, piece p of batch b at p B + b); O
// (read for Delta) and dQ (written) are maps of bf16 tensors (NP = 1).
// CAP: the scores are softcapped (see the header).
template <int D, int NP, bool CAUSAL, bool CAP>
__device__ __forceinline__ void dq_body(const CUtensorMap& tq, const CUtensorMap& tdo,
                                        const CUtensorMap& to, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const CUtensorMap& tdq,
                                        const Params& p) {
  using L = DqSmem<D, NP>;
  constexpr int NB = L::NB, STAGES = L::STAGES, WG = L::WG, BK = L::BK, KB = L::KB;
  constexpr int ROWS = WG * TILE, NPAIR = hopper::n_pairs(NP);
  constexpr int DP = NB * BOX;  // dQ's columns: the head dim's boxes (zeros past D)
  // v's head dim; the boxes loaded of a q or k row and of a v, o or dO row
  constexpr int DV = hopper::v_dim<D>(), NBL = hopper::data_boxes<D>();
  constexpr int NBO = hopper::data_boxes<DV>();
  constexpr bool RES = Shape<D, NP>::RES;
  static_assert(!RES || (NP == 3 && WG == 1), "a resident f32 tile: f32 inputs, one warpgroup");
  static_assert(!(CAP && RES), "no softcap in the resident-tile bodies");
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
  const int nq = (S + ROWS - 1) / ROWS;
  int h, b, q0;
  if (CAUSAL) {
    h = blockIdx.x % p.H;
    b = blockIdx.x / p.H % p.B;
    q0 = (nq - 1 - static_cast<int>(blockIdx.x / (p.H * p.B))) * ROWS;
  } else {
    q0 = blockIdx.x % nq * ROWS;
    h = blockIdx.x / nq % p.H;
    b = blockIdx.x / (nq * p.H);
  }
  const int hk = h / (p.H / p.Hkv);
  // the key tiles that meet the rows' keys: (q - W, q] (causal), up to S
  const int kt_hi = CAUSAL ? (min(q0 + ROWS, S) - 1) / BK + 1 : (S + BK - 1) / BK;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  const int n_tiles = kt_hi - kt_lo;

  // K and V of key tile kt_lo + i into stage i % STAGES (thread 0 only)
  auto load_kv = [&](int i) {
    const int s = i % STAGES;
    i += kt_lo;
    hopper::mbar_expect_tx(&kv_full[s], NP * (NBL + NBO) * KB);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x) {
        const int off = ((s * NP + pc) * NB + x) * KB;
        hopper::tma_load_4d(sm + L::K + off, &tk, &kv_full[s], x * BOX, hk, i * BK, pc * p.B + b);
        if (x < NBO)
          hopper::tma_load_4d(sm + L::V + off, &tv, &kv_full[s], x * BOX, hk, i * BK,
                              pc * p.B + b);
      }
  };
  if (tid == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], WG * 4);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {  // RES: Q's pieces alone (dO is read in f32 below)
    hopper::mbar_expect_tx(qo_full,
                           (NBL + (NP == 1 ? 2 : RES ? 0 : 1) * NBO) * WG * NP * BOX_BYTES);
    for (int w = 0; w < WG; ++w)
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
#pragma unroll
        for (int x = 0; x < NBL; ++x) {
          const int off = ((w * NP + pc) * NB + x) * BOX_BYTES, row = q0 + w * TILE;
          hopper::tma_load_4d(sm + L::Q + off, &tq, qo_full, x * BOX, h, row, pc * p.B + b);
          if (x >= NBO) continue;
          if constexpr (!RES)
            hopper::tma_load_4d(sm + L::DO + off, &tdo, qo_full, x * BOX, h, row, pc * p.B + b);
          if constexpr (NP == 1)
            hopper::tma_load_4d(sm + L::O + off, &to, qo_full, x * BOX, h, row, b);
        }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }

  // this warpgroup's rows r0 .. r0 + 63; this thread's r0 + rl0 and r0 + rl0 + 8
  const int r0 = q0 + wg * TILE;
  const int rl0 = warp * 16 + g;
  const uint32_t q_s = hopper::smem_addr(sm + L::Q + wg * NP * NB * BOX_BYTES);
  const uint32_t do_s = hopper::smem_addr(sm + L::DO + wg * NP * NB * BOX_BYTES);
  const uint32_t k_s = hopper::smem_addr(sm + L::K);
  const uint32_t v_s = hopper::smem_addr(sm + L::V);
  const float scale2 = p.scale * LOG2E;
  // CAP: t = tanh(s scale / c), the capped score in base 2 t c log2(e)
  const float pre = CAP ? p.scale / p.softcap : 0.f, post = CAP ? p.softcap * LOG2E : 0.f;

  // Delta and lse * log2(e) of this thread's rows (past S: 0 and +inf, so
  // that P = 0), and both for pass 2, by the first thread of each row
  const uint32_t dof = hopper::smem_addr(sm + L::DO);
  if constexpr (RES) {  // the rows' dO in f32, while Q's pieces and the first stage load
    resident_f32<DV>(reinterpret_cast<float*>(sm + L::DO), p.dout, p.do_sb, p.do_ss, p.do_sh, b,
                     h, r0, S);
    hopper::named_barrier(1, 128);
  }
  hopper::mbar_wait(qo_full, 0);
  const int n_qt = (S + TILE - 1) / TILE;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = rl0 + 8 * r, row = r0 + rl;
    float d;
    if constexpr (NP == 1)
      d = row_dot<NBO>(sm + L::O + wg * NB * BOX_BYTES, sm + L::DO + wg * NB * BOX_BYTES, rl, t);
    else
      d = row_dot_f32<DV>(p, b, h, row, t);
    dl[r] = row < S ? d : 0.f;
    lse2[r] = row < S ? p.lse[(static_cast<long long>(b) * p.H + h) * S + row] * LOG2E : INFINITY;
    if (t == 0 && row < n_qt * TILE) {
      float* st = p.delta + ((static_cast<long long>(b) * p.H + h) * n_qt + row / TILE) * 2 * TILE;
      st[rl] = lse2[r];
      st[TILE + rl] = dl[r];
    }
  }

  // RES: dQ's first RREG values a thread here, the others in shared memory
  constexpr int DQR = RES ? Shape<D, NP>::RREG : DP / 2;
  float s[BK / 2], dp[BK / 2], dq[DQR];
  float dp_lo[RES ? BK / 2 : 1];  // RES: dP's small piece pairs
  uint32_t da[NP][BK / 16][4];
  float* sacc = reinterpret_cast<float*>(sm + L::ACC);
#pragma unroll
  for (int x = 0; x < DQR; ++x) dq[x] = 0.f;
  if constexpr (RES)
    for (int x = 0; x < D / 2 - DQR; ++x) sacc[x * 128 + tid % 128] = 0.f;
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(dq);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) hopper::fence_regs(da[pc][kc]);
  };

  // An iteration issues S = Q K^T and dP = dO V^T, waits for S, computes P
  // while dP runs, waits for dP, packs dS and issues dQ += dS K, waits for
  // it and releases the stage; each product the sum over the piece pairs
  // (i, j), smallest first.  Every branch around a wgmma depends on the
  // block alone, so a warpgroup that sees none of a tile's keys computes
  // it all the same, with P = 0.
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, k0 = (kt_lo + i) * BK;
    // refill the stage that every warp released in the previous iteration
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_tiles) {
      hopper::mbar_wait(&kv_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_kv(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t kst = k_s + st * NP * NB * KB, vst = v_s + st * NP * NB * KB;
      hopper::mbar_wait(&kv_full[st], (i / STAGES) & 1);
      if constexpr (RES) {  // S, and dP whole: dp + dp_lo
        hybrid_products<BK, D, DV>(s, dp, dp_lo, q_s, dof, kst, vst, NB * KB, rl0, t);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::fence_regs(dp_lo);
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) dp[x] += dp_lo[x];
      } else {
        fence_all();
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < NPAIR; ++k)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::wgmma_ss<BK, 0, 0>(
                s, kmajor<TILE>(q_s + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                kmajor<BK>(kst + hopper::pair_j(NP, k) * NB * KB, kk), k > 0 || kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int k = 0; k < NPAIR; ++k)
#pragma unroll
          for (int kk = 0; kk < DV / 16; ++kk)
            hopper::wgmma_ss<BK, 0, 0>(
                dp, kmajor<TILE>(do_s + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                kmajor<BK>(vst + hopper::pair_j(NP, k) * NB * KB, kk), k > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
      }
      // s[x]: row r0 + rl0 + 8 ((x >> 1) & 1), key k0 + 8 (x / 4) + 2 t + (x & 1)
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int r = (x >> 1) & 1;
        if constexpr (CAP) {
          const float th = tanhf(s[x] * pre);  // t
          s[x] = hopper::exp2_approx(fmaf(th, post, -lse2[r])) * fmaf(-th, th, 1.f);  // dq: P (1 - t^2)
        } else {
          s[x] = hopper::exp2_approx(fmaf(s[x], scale2, -lse2[r]));
        }
        if constexpr (decltype(masked)::value) {
          const int key = k0 + (x / 4) * 8 + 2 * t + (x & 1), row = r0 + rl0 + 8 * r;
          const bool behind = p.window > 0 && key <= row - p.window;  // dq: outside the window
          s[x] = key >= S || (CAUSAL && key > row) || behind ? 0.f : s[x];
        }
      }
      if constexpr (!RES) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
      }
#pragma unroll
      for (int x = 0; x < BK / 2; ++x)
        dp[x] = s[x] * (dp[x] - dl[(x >> 1) & 1]);  // dq: dS = P (dP - Delta)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[NP];
          hopper::pack_bf16_pieces<NP>(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1], w);  // dS's pieces
#pragma unroll
          for (int pc = 0; pc < NP; ++pc) da[pc][kc][e] = w[pc];
        }
      if constexpr (NP == 1) {
        fence_all();
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
          hopper::wgmma_rs<DP, 1>(dq, da[0][kc], mnmajor<BK>(kst, kc), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_all();
      } else {
        // dQ += dS K (RES: over D's columns alone)
        add_partial<RES ? D : DP, NP, BK, RES ? 32 : 64, DQR>(dq, da, kst, NB * KB, KB, sacc);
      }
      if (lane == 0) hopper::mbar_arrive(&kv_empty[st]);
    };
    // the causal diagonal, the window's edge, and the tile holding S's
    // ragged end; tiles wholly outside the window are never visited
    if (k0 + BK > S || (CAUSAL && k0 + BK - 1 > q0) ||
        (p.window > 0 && k0 <= q0 + ROWS - 1 - p.window))
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  if (r0 >= S) return;  // the whole warpgroup lies past S
  if constexpr (NP == 1) {
    acc_to_boxes<D>(sm + L::Q + wg * NB * BOX_BYTES, dq, p.scale, rl0, g, t);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (tid % 128 == 0) store_boxes<NBL>(&tdq, sm + L::Q + wg * NB * BOX_BYTES, h, r0, b);
  } else {
    acc_to_f32<D, RES ? 2 * DQR : D>(static_cast<float*>(p.dq), dq, p.scale, b, S, p.H, h,
                                     r0 + rl0, t, 0);
    if constexpr (RES)
      sacc_to_f32<D, DQR>(static_cast<float*>(p.dq), sacc, p.scale, b, S, p.H, h, r0 + rl0, t);
  }
}

// Pass 2: dK and dV, reading the lse and Delta that pass 1 wrote.  The
// maps read the operands' pieces; dK and dV are written through maps of
// bf16 tensors (NP = 1).  MASKED: the body holds the masked variant of a
// tile (a causal diagonal, a window's edge); without either it holds the
// unmasked one alone, as the encoder's kernel did before windows.  CAP:
// the scores are softcapped (see the header).
template <int D, int NP, bool CAUSAL, bool MASKED, bool CAP>
__device__ __forceinline__ void dkdv_body(const CUtensorMap& tq, const CUtensorMap& tdo,
                                          const CUtensorMap& tk, const CUtensorMap& tv,
                                          const CUtensorMap& tdk, const CUtensorMap& tdv,
                                          const Params& p) {
  using L = KvSmem<D, NP>;
  constexpr int NB = L::NB, STAGES = L::STAGES, WG = L::WG, QT = L::QT, QB = L::QB;
  constexpr int KEYS = WG * TILE, NPAIR = hopper::n_pairs(NP);
  // this block's columns of dK and dV (their products' N): at D 80 the
  // two boxes, zeros past 80
  constexpr int NH = Shape<D, NP>::NH, DH = hopper::box_cols<D>() / NH;
  static_assert(NP == 1 || NH == 1, "the f32 epilogue stores whole rows");
  static_assert(D % NH == 0 && DH % BOX == 0, "a block's columns are whole boxes");
  // v's head dim; the boxes loaded of a q or k row and of a v or dO row
  constexpr int DV = hopper::v_dim<D>(), NBL = hopper::data_boxes<D>();
  constexpr int NBO = hopper::data_boxes<DV>();
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
  const int nk = (S + KEYS - 1) / KEYS;
  const int part = blockIdx.x % NH, bid = blockIdx.x / NH;  // columns part * DH ..
  int kt, hk, b;
  if (CAUSAL) {
    hk = bid % p.Hkv;
    b = bid / p.Hkv % p.B;
    kt = bid / (p.Hkv * p.B);
  } else {
    kt = bid % nk;
    hk = bid / nk % p.Hkv;
    b = bid / (nk * p.Hkv);
  }
  const int k0 = kt * KEYS;
  const int rep = p.H / p.Hkv;
  const int n_qt = (S + QT - 1) / QT;        // q tiles of QT rows
  const int n_st = (S + TILE - 1) / TILE;    // the scratch's q tiles of 64 rows
  const int qt_lo = CAUSAL ? k0 / QT : 0;    // the first q tile that sees a key of the block
  // and the last: rows past the block's last key by W - 1 or more see none
  const int qt_hi = p.window > 0 ? min(n_qt, (k0 + KEYS - 2 + p.window) / QT + 1) : n_qt;
  const int nq = qt_hi - qt_lo;
  const int n_iter = rep * nq;  // the ring runs over rep heads x q tiles

  // Q, dO, lse and Delta of iteration i into stage i % STAGES (thread 0 only)
  auto load_q = [&](int i) {
    const int s = i % STAGES, h = hk * rep + i / nq, qt = qt_lo + i % nq;
    hopper::mbar_expect_tx(&q_full[s], NP * (NBL + NBO) * QB + L::STAT_B);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x) {
        const int off = ((s * NP + pc) * NB + x) * QB;
        hopper::tma_load_4d(sm + L::Q + off, &tq, &q_full[s], x * BOX, h, qt * QT, pc * p.B + b);
        if (x < NBO)
          hopper::tma_load_4d(sm + L::DO + off, &tdo, &q_full[s], x * BOX, h, qt * QT,
                              pc * p.B + b);
      }
    const float* stat = p.delta + ((static_cast<long long>(b) * p.H + h) * n_st + qt * QT / TILE) *
                                      2 * TILE + qt * QT % TILE;
    uint8_t* dst = sm + L::STAT + s * L::STAT_B;
    if constexpr (QT == TILE) {
      hopper::bulk_load(dst, stat, L::STAT_B, &q_full[s]);
    } else {  // this tile's part of the scratch tile's lse, then of its Delta
      hopper::bulk_load(dst, stat, QT * 4, &q_full[s]);
      hopper::bulk_load(dst + QT * 4, stat + TILE, QT * 4, &q_full[s]);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], WG * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_full, WG * NP * (NBL + NBO) * BOX_BYTES);
    for (int w = 0; w < WG; ++w)
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
#pragma unroll
        for (int x = 0; x < NBL; ++x) {
          const int off = ((w * NP + pc) * NB + x) * BOX_BYTES, key = k0 + w * TILE;
          hopper::tma_load_4d(sm + L::K + off, &tk, kv_full, x * BOX, hk, key, pc * p.B + b);
          if (x < NBO)
            hopper::tma_load_4d(sm + L::V + off, &tv, kv_full, x * BOX, hk, key, pc * p.B + b);
        }
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_q(i);
  }

  // this warpgroup's keys k0 + 64 wg ..; this thread's key0 and key0 + 8
  const int rl0 = warp * 16 + g;
  const int key0 = k0 + wg * TILE + rl0;
  const uint32_t k_s = hopper::smem_addr(sm + L::K + wg * NP * NB * BOX_BYTES);
  const uint32_t v_s = hopper::smem_addr(sm + L::V + wg * NP * NB * BOX_BYTES);
  const uint32_t q_s = hopper::smem_addr(sm + L::Q);
  const uint32_t do_s = hopper::smem_addr(sm + L::DO);
  const uint32_t col = part * (DH / BOX) * QB;  // this block's columns of a q or dO tile
  const float scale2 = p.scale * LOG2E;
  const float pre = CAP ? p.scale / p.softcap : 0.f, post = CAP ? p.softcap * LOG2E : 0.f;

  // P^T and dS^T as A operands: bf16 inputs keep both (one commit for dV
  // and dK); on pieces `pa` holds P^T's and then dS^T's
  float s[QT / 2], dp[QT / 2], dk[DH / 2], dv[DH / 2];
  uint32_t pa[NP][QT / 16][4], da[QT / 16][4];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dk[x] = dv[x] = 0.f;
  auto fence_pa = [&] {
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) hopper::fence_regs(pa[pc][kc]);
  };
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    fence_pa();
    if constexpr (NP == 1)
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) hopper::fence_regs(da[kc]);
  };
  hopper::mbar_wait(kv_full, 0);

  // An iteration issues S^T = K Q^T and dP^T = V dO^T, waits for S^T,
  // computes P^T while dP^T runs, waits, forms dS^T, packs both and issues
  // dV += P^T dO and dK += dS^T Q, waits for them and releases the stage.
  // On pieces, dV is issued as soon as P^T is packed, and dS^T is formed
  // while it runs.
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % STAGES, q0 = (qt_lo + i % nq) * QT;
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_iter) {
      hopper::mbar_wait(&q_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_q(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t qst = q_s + st * NP * NB * QB, dost = do_s + st * NP * NB * QB;
      const float* lse2 = reinterpret_cast<const float*>(sm + L::STAT + st * L::STAT_B);
      const float* dl = lse2 + QT;
      hopper::mbar_wait(&q_full[st], (i / STAGES) & 1);
      fence_all();
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < NPAIR; ++k)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<QT, 0, 0>(s, kmajor<TILE>(k_s + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                                     kmajor<QT>(qst + hopper::pair_j(NP, k) * NB * QB, kk),
                                     k > 0 || kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int k = 0; k < NPAIR; ++k)
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          hopper::wgmma_ss<QT, 0, 0>(dp, kmajor<TILE>(v_s + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                                     kmajor<QT>(dost + hopper::pair_j(NP, k) * NB * QB, kk),
                                     k > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      // s[4 j + e]: key key0 + 8 (e >> 1), q row q0 + 8 j + 2 t + (e & 1)
      auto hidden = [&](int j, int e) {
        const int key = key0 + 8 * (e >> 1), row = q0 + 8 * j + 2 * t + (e & 1);
        return (CAUSAL && key > row) || (p.window > 0 && key <= row - p.window);
      };
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          if constexpr (CAP) {  // t while dP^T runs; P^T with dS^T below
            s[x] = tanhf(s[x] * pre);
          } else {
            const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
            s[x] = hopper::exp2_approx(fmaf(s[x], scale2, -(e & 1 ? l.y : l.x)));
            if constexpr (decltype(masked)::value) s[x] = hidden(j, e) ? 0.f : s[x];
          }
        }
      }
      auto form_ds = [&] {
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            if constexpr (CAP) {  // s holds t: P^T, and dS^T = P^T (dP^T - Delta) (1 - t^2)
              const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
              const float th = s[x];
              float pt = hopper::exp2_approx(fmaf(th, post, -(e & 1 ? l.y : l.x)));
              if constexpr (decltype(masked)::value) pt = hidden(j, e) ? 0.f : pt;
              dp[x] = pt * (dp[x] - (e & 1 ? d.y : d.x)) * fmaf(-th, th, 1.f);  // dkdv: dS^T
              s[x] = pt;
            } else {
              dp[x] = s[x] * (dp[x] - (e & 1 ? d.y : d.x));  // dS^T
            }
          }
        }
      };
      if constexpr (NP == 1) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        form_ds();
#pragma unroll
        for (int kc = 0; kc < QT / 16; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[0][kc][e] = hopper::pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
            da[kc][e] = hopper::pack_bf16(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1]);
          }
        fence_all();
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < QT / 16; ++kc)
          hopper::wgmma_rs<DH, 1>(dv, pa[0][kc], mnmajor<QT>(dost + col, kc), 1);
#pragma unroll
        for (int kc = 0; kc < QT / 16; ++kc)
          hopper::wgmma_rs<DH, 1>(dk, da[kc], mnmajor<QT>(qst + col, kc), 1);
        hopper::wgmma_commit();
      } else {  // dV and dK each through per-64-column partials (add_partial)
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        form_ds();
#pragma unroll
        for (int kc = 0; kc < QT / 16; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t w[NP];
            hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // P^T's pieces
#pragma unroll
            for (int pc = 0; pc < NP; ++pc) pa[pc][kc][e] = w[pc];
          }
        add_partial<DH, NP, QT>(dv, pa, dost + col, NB * QB, QB);
#pragma unroll
        for (int kc = 0; kc < QT / 16; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t w[NP];
            hopper::pack_bf16_pieces<NP>(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1], w);  // dS^T's pieces
#pragma unroll
            for (int pc = 0; pc < NP; ++pc) pa[pc][kc][e] = w[pc];
          }
        add_partial<DH, NP, QT>(dk, pa, qst + col, NB * QB, QB);
      }
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) hopper::mbar_arrive(&q_empty[st]);
    };
    // causal: the q tiles that hold a row before one of the block's keys;
    // a window: those that hold a row W or more past one of them
    if constexpr (MASKED) {
      if ((CAUSAL && k0 + KEYS - 1 > q0) || (p.window > 0 && k0 <= q0 + QT - 1 - p.window))
        step(std::true_type{});
      else
        step(std::false_type{});
    } else {
      step(std::false_type{});
    }
  }

  const int kr0 = k0 + wg * TILE;
  if (kr0 >= S) return;  // the whole warpgroup lies past S
  if constexpr (NP == 1) {
    // a block's DH columns (D's, DV's alone when it takes all of them);
    // the store takes the boxes that hold the gradient's columns
    acc_to_boxes<NH == 1 ? D : DH>(sm + L::K + wg * NB * BOX_BYTES, dk, p.scale, rl0, g, t);
    acc_to_boxes<NH == 1 ? DV : DH>(sm + L::V + wg * NB * BOX_BYTES, dv, 1.f, rl0, g, t);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (tid % 128 == 0) {
      store_boxes<DH / BOX>(&tdk, sm + L::K + wg * NB * BOX_BYTES, hk, kr0, b, part * DH,
                            (D - part * DH + BOX - 1) / BOX);
      store_boxes<DH / BOX>(&tdv, sm + L::V + wg * NB * BOX_BYTES, hk, kr0, b, part * DH,
                            (DV - part * DH + BOX - 1) / BOX);
    }
  } else {
    acc_to_f32<D, D>(static_cast<float*>(p.dk), dk, p.scale, b, S, p.Hkv, hk, key0, t, 0);
    acc_to_f32<DV, DV>(static_cast<float*>(p.dv), dv, 1.f, b, S, p.Hkv, hk, key0, t, 0);
  }
}

// Pass 2 of a RES shape (f32 at D 256): per (64 keys, kv head, batch) two
// blocks, one a gradient over the whole head dim (dv_res_body the other).
// The dK block: the same ring over rep heads x q tiles as dkdv_body, one
// warpgroup; S^T = K Q^T and dP^T = V dO^T with K and V f32 in shared
// memory (hybrid_products: K's pieces by TMA from split3's scratch, V in
// f32), then dK += dS^T Q.
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dk_res_body(const CUtensorMap& tq, const CUtensorMap& tdo,
                                            const CUtensorMap& tk, const Params& p) {
  using L = KvSmem<D, 3>;
  constexpr int NP = 3, NB = L::NB, STAGES = L::STAGES, QT = L::QT, QB = L::QB;
  constexpr int RREG = Shape<D, NP>::RREG;
  constexpr int DV = hopper::v_dim<D>(), NBL = hopper::data_boxes<D>();
  constexpr int NBO = hopper::data_boxes<DV>();
  static_assert(L::WG == 1 && Shape<D, NP>::NH == 2, "a block a gradient, one warpgroup");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int S = p.S, nk = (S + TILE - 1) / TILE, bid = blockIdx.x / 2;
  int kt, hk, b;
  if (CAUSAL) {
    hk = bid % p.Hkv;
    b = bid / p.Hkv % p.B;
    kt = bid / (p.Hkv * p.B);
  } else {
    kt = bid % nk;
    hk = bid / nk % p.Hkv;
    b = bid / (nk * p.Hkv);
  }
  const int k0 = kt * TILE, rep = p.H / p.Hkv;
  const int n_qt = (S + QT - 1) / QT, n_st = (S + TILE - 1) / TILE;
  const int qt_lo = CAUSAL ? k0 / QT : 0;
  const int qt_hi = p.window > 0 ? min(n_qt, (k0 + TILE - 2 + p.window) / QT + 1) : n_qt;
  const int nq = qt_hi - qt_lo, n_iter = rep * nq;

  auto load_q = [&](int i) {  // as dkdv_body's: Q, dO, lse and Delta of iteration i
    const int s = i % STAGES, h = hk * rep + i / nq, qt = qt_lo + i % nq;
    hopper::mbar_expect_tx(&q_full[s], NP * (NBL + NBO) * QB + L::STAT_B);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x) {
        const int off = ((s * NP + pc) * NB + x) * QB;
        hopper::tma_load_4d(sm + L::Q + off, &tq, &q_full[s], x * BOX, h, qt * QT, pc * p.B + b);
        if (x < NBO)
          hopper::tma_load_4d(sm + L::DO + off, &tdo, &q_full[s], x * BOX, h, qt * QT,
                              pc * p.B + b);
      }
    const float* stat = p.delta + ((static_cast<long long>(b) * p.H + h) * n_st + qt * QT / TILE) *
                                      2 * TILE + qt * QT % TILE;
    uint8_t* dst = sm + L::STAT + s * L::STAT_B;
    hopper::bulk_load(dst, stat, QT * 4, &q_full[s]);
    hopper::bulk_load(dst + QT * 4, stat + TILE, QT * 4, &q_full[s]);
  };
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_full, NP * NBL * BOX_BYTES);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x)
        hopper::tma_load_4d(sm + L::K + (pc * NB + x) * BOX_BYTES, &tk, kv_full, x * BOX, hk, k0,
                            pc * p.B + b);
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_q(i);
  }
  // the keys' V in f32, while K's pieces and the first stage load
  resident_f32<DV>(reinterpret_cast<float*>(sm + L::V), p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, k0,
                   S);
  hopper::named_barrier(1, 128);
  hopper::mbar_wait(kv_full, 0);

  const int rl0 = warp * 16 + lane / 4, key0 = k0 + rl0;
  const uint32_t k_s = hopper::smem_addr(sm + L::K), vf = hopper::smem_addr(sm + L::V);
  const uint32_t q_s = hopper::smem_addr(sm + L::Q), do_s = hopper::smem_addr(sm + L::DO);
  const float scale2 = p.scale * LOG2E;
  // dK's first RREG values a thread here, the others in shared memory
  float s[QT / 2], dp[QT / 2], dp_lo[QT / 2], acc[RREG];
  uint32_t pa[NP][QT / 16][4];
  float* sacc = reinterpret_cast<float*>(sm + L::ACC);
#pragma unroll
  for (int x = 0; x < RREG; ++x) acc[x] = 0.f;
  for (int x = 0; x < D / 2 - RREG; ++x) sacc[x * 128 + tid] = 0.f;

  for (int i = 0; i < n_iter; ++i) {
    const int st = i % STAGES, q0 = (qt_lo + i % nq) * QT;
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_iter) {
      hopper::mbar_wait(&q_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_q(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t qst = q_s + st * NP * NB * QB, dost = do_s + st * NP * NB * QB;
      const float* lse2 = reinterpret_cast<const float*>(sm + L::STAT + st * L::STAT_B);
      const float* dl = lse2 + QT;
      hopper::mbar_wait(&q_full[st], (i / STAGES) & 1);
      hybrid_products<QT, D, DV>(s, dp, dp_lo, k_s, vf, qst, dost, NB * QB, rl0, t);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::fence_regs(dp_lo);
      // s[4 j + e]: key key0 + 8 (e >> 1), q row q0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float pt = hopper::exp2_approx(fmaf(s[x], scale2, -(e & 1 ? l.y : l.x)));
          if constexpr (decltype(masked)::value) {
            const int key = key0 + 8 * (e >> 1), row = q0 + 8 * j + 2 * t + (e & 1);
            pt = (CAUSAL && key > row) || (p.window > 0 && key <= row - p.window) ? 0.f : pt;
          }
          s[x] = pt * (dp[x] + dp_lo[x] - (e & 1 ? d.y : d.x));  // dS^T = P^T (dP^T - Delta)
        }
      }
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[NP];
          hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // dS^T's pieces
#pragma unroll
          for (int pc = 0; pc < NP; ++pc) pa[pc][kc][e] = w[pc];
        }
      add_partial<D, NP, QT, 32, RREG>(acc, pa, qst, NB * QB, QB, sacc);  // dK += dS^T Q
      if (lane == 0) hopper::mbar_arrive(&q_empty[st]);
    };
    if constexpr (MASKED) {
      if ((CAUSAL && k0 + TILE - 1 > q0) || (p.window > 0 && k0 <= q0 + QT - 1 - p.window))
        step(std::true_type{});
      else
        step(std::false_type{});
    } else {
      step(std::false_type{});
    }
  }
  if (k0 >= S) return;
  acc_to_f32<D, 2 * RREG>(static_cast<float*>(p.dk), acc, p.scale, b, S, p.Hkv, hk, key0, t, 0);
  sacc_to_f32<D, RREG>(static_cast<float*>(p.dk), sacc, p.scale, b, S, p.Hkv, hk, key0, t);
}

// The dV block of a RES shape (dk_res_body the other): S^T = K Q^T and dV
// += P^T dO need K alone,
// so the block holds K's three pieces (96 KB, by TMA from split3's
// scratch) and reads them as the shared-memory A operand, as the D-128
// body does, with no pieces to form: per q tile S^T is the sum over the
// piece pairs, the smallest first, over the whole head dim, then P^T's
// pieces give dV += P^T dO in 32-column partials (dV's upper half in
// shared memory).  Two stages of Q and dO.
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dv_res_body(const CUtensorMap& tq, const CUtensorMap& tdo,
                                            const CUtensorMap& tk, const Params& p) {
  using L = DvSmem<D>;
  constexpr int NP = 3, NB = L::NB, STAGES = L::STAGES, QT = L::QT, QB = L::QB;
  constexpr int NPAIR = hopper::n_pairs(NP);
  constexpr int DV = hopper::v_dim<D>(), NBL = hopper::data_boxes<D>();
  constexpr int NBO = hopper::data_boxes<DV>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int S = p.S, nk = (S + TILE - 1) / TILE, bid = blockIdx.x / 2;
  int kt, hk, b;
  if (CAUSAL) {
    hk = bid % p.Hkv;
    b = bid / p.Hkv % p.B;
    kt = bid / (p.Hkv * p.B);
  } else {
    kt = bid % nk;
    hk = bid / nk % p.Hkv;
    b = bid / (nk * p.Hkv);
  }
  const int k0 = kt * TILE, rep = p.H / p.Hkv;
  const int n_qt = (S + QT - 1) / QT, n_st = (S + TILE - 1) / TILE;
  const int qt_lo = CAUSAL ? k0 / QT : 0;
  const int qt_hi = p.window > 0 ? min(n_qt, (k0 + TILE - 2 + p.window) / QT + 1) : n_qt;
  const int nq = qt_hi - qt_lo, n_iter = rep * nq;

  auto load_q = [&](int i) {  // Q, dO, lse and Delta of iteration i, as dkdv_body's
    const int s = i % STAGES, h = hk * rep + i / nq, qt = qt_lo + i % nq;
    hopper::mbar_expect_tx(&q_full[s], NP * (NBL + NBO) * QB + L::STAT_B);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x) {
        const int off = ((s * NP + pc) * NB + x) * QB;
        hopper::tma_load_4d(sm + L::Q + off, &tq, &q_full[s], x * BOX, h, qt * QT, pc * p.B + b);
        if (x < NBO)
          hopper::tma_load_4d(sm + L::DO + off, &tdo, &q_full[s], x * BOX, h, qt * QT,
                              pc * p.B + b);
      }
    const float* stat = p.delta + ((static_cast<long long>(b) * p.H + h) * n_st + qt * QT / TILE) *
                                      2 * TILE + qt * QT % TILE;
    uint8_t* dst = sm + L::STAT + s * L::STAT_B;
    hopper::bulk_load(dst, stat, QT * 4, &q_full[s]);
    hopper::bulk_load(dst + QT * 4, stat + TILE, QT * 4, &q_full[s]);
  };
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_full, NP * NBL * BOX_BYTES);
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
#pragma unroll
      for (int x = 0; x < NBL; ++x)
        hopper::tma_load_4d(sm + L::K + (pc * NB + x) * BOX_BYTES, &tk, kv_full, x * BOX, hk, k0,
                            pc * p.B + b);
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_q(i);
  }

  const int rl0 = warp * 16 + lane / 4, key0 = k0 + rl0;
  const uint32_t k_s = hopper::smem_addr(sm + L::K);
  const uint32_t q_s = hopper::smem_addr(sm + L::Q), do_s = hopper::smem_addr(sm + L::DO);
  const float scale2 = p.scale * LOG2E;
  // dV (DV columns): a thread's first DV / 4 values here, the rest in
  // shared memory
  float s[QT / 2], acc[DV / 4];
  uint32_t pa[NP][QT / 16][4];
  float* sacc = reinterpret_cast<float*>(sm + L::ACC);
#pragma unroll
  for (int x = 0; x < DV / 4; ++x) acc[x] = 0.f;
  for (int x = 0; x < DV / 4; ++x) sacc[x * 128 + tid] = 0.f;
  hopper::mbar_wait(kv_full, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int st = i % STAGES, q0 = (qt_lo + i % nq) * QT;
    if (tid == 0 && i >= 1 && i - 1 + STAGES < n_iter) {
      hopper::mbar_wait(&q_empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      load_q(i - 1 + STAGES);
    }
    __syncwarp();
    auto step = [&](auto masked) {
      const uint32_t qst = q_s + st * NP * NB * QB, dost = do_s + st * NP * NB * QB;
      const float* lse2 = reinterpret_cast<const float*>(sm + L::STAT + st * L::STAT_B);
      hopper::mbar_wait(&q_full[st], (i / STAGES) & 1);
#pragma unroll
      for (int x = 0; x < QT / 2; ++x) s[x] = 0.f;  // the last tile's are dead
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < NPAIR; ++k) {  // S^T = K Q^T, a pair at a time
        uint32_t ks = k_s, qs = qst;  // opaque: no pair's descriptors are computed early
        asm volatile("" : "+r"(ks), "+r"(qs));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<QT, 0, 0>(s, kmajor<TILE>(ks + hopper::pair_i(NP, k) * NB * BOX_BYTES, kk),
                                     kmajor<QT>(qs + hopper::pair_j(NP, k) * NB * QB, kk),
                                     k > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      // s[4 j + e]: key key0 + 8 (e >> 1), q row q0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          s[x] = hopper::exp2_approx(fmaf(s[x], scale2, -(e & 1 ? l.y : l.x)));
          if constexpr (decltype(masked)::value) {
            const int key = key0 + 8 * (e >> 1), row = q0 + 8 * j + 2 * t + (e & 1);
            s[x] = (CAUSAL && key > row) || (p.window > 0 && key <= row - p.window) ? 0.f : s[x];
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[NP];
          hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // dV block: P^T's pieces
#pragma unroll
          for (int pc = 0; pc < NP; ++pc) pa[pc][kc][e] = w[pc];
        }
      add_partial<DV, NP, QT, 32, DV / 4>(acc, pa, dost, NB * QB, QB, sacc);  // dV += P^T dO
      if (lane == 0) hopper::mbar_arrive(&q_empty[st]);
    };
    if constexpr (MASKED) {
      if ((CAUSAL && k0 + TILE - 1 > q0) || (p.window > 0 && k0 <= q0 + QT - 1 - p.window))
        step(std::true_type{});
      else
        step(std::false_type{});
    } else {
      step(std::false_type{});
    }
  }
  if (k0 >= S) return;
  acc_to_f32<DV, DV / 2>(static_cast<float*>(p.dv), acc, 1.f, b, S, p.Hkv, hk, key0, t, 0);
  sacc_to_f32<DV, DV / 4>(static_cast<float*>(p.dv), sacc, 1.f, b, S, p.Hkv, hk, key0, t);
}

// bf16 inputs and gradients; CAP: the softcapped scores
template <int D, bool CAUSAL, bool CAP>
__global__ void __launch_bounds__(Shape<D, 1>::WG * 128, Shape<D, 1>::DQ_BLOCKS)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdq,
                    Params p) {
  dq_body<D, 1, CAUSAL, CAP>(tq, tdo, to, tk, tv, tdq, p);
}

template <int D, bool CAUSAL, bool MASKED, bool CAP>
__global__ void __launch_bounds__(Shape<D, 1>::WG * 128, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv, Params p) {
  dkdv_body<D, 1, CAUSAL, MASKED, CAP>(tq, tdo, tk, tv, tdk, tdv, p);
}

// f32 inputs (read as their three bf16 pieces) and gradients; `to`, `tdq`,
// `tdk` and `tdv` are not read
template <int D, bool CAUSAL, bool CAP>
__global__ void __launch_bounds__(Shape<D, 3>::WG * 128, Shape<D, 3>::DQ_BLOCKS)
    dq_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap to,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdq, Params p) {
  dq_body<D, 3, CAUSAL, CAP>(tq, tdo, to, tk, tv, tdq, p);
}

template <int D, bool CAUSAL, bool MASKED, bool CAP>
__global__ void __launch_bounds__(Shape<D, 3>::WG * 128, 1)
    dkdv_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdk,
                          const __grid_constant__ CUtensorMap tdv, Params p) {
  static_assert(!(CAP && Shape<D, 3>::RES), "no softcap in the resident-tile bodies");
  if constexpr (Shape<D, 3>::RES) {  // even blocks dV, odd ones dK
    if (blockIdx.x % 2 == 0)
      dv_res_body<D, CAUSAL, MASKED>(tq, tdo, tk, p);
    else
      dk_res_body<D, CAUSAL, MASKED>(tq, tdo, tk, p);
  } else {
    dkdv_body<D, 3, CAUSAL, MASKED, CAP>(tq, tdo, tk, tv, tdk, tdv, p);
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

// The bf16 operands the kernels read: q, k, v, o (bf16 inputs only) and
// dout as (NP B, S, heads, D) with strides in elements, D contiguous.
struct Operands {
  const void* ptr[5];
  long long stride[5][3];
};

template <int D, int NP, bool CAUSAL, bool CAP>
cudaError_t launch(const Params& p, const Operands& x, cudaStream_t st) {
  using T = Shape<D, NP>;
  // dkdv's masked tile variant only where a causal diagonal or a window's
  // edge needs it (the unmasked kernel alone runs the encoder's backward)
  const bool masked = CAUSAL || p.window > 0;
  auto [dq, dkdv] = [masked] {
    if constexpr (NP == 1)
      return std::make_pair(dq_wgmma_kernel<D, CAUSAL, CAP>,
                            masked ? dkdv_wgmma_kernel<D, CAUSAL, true, CAP>
                                   : dkdv_wgmma_kernel<D, CAUSAL, CAUSAL, CAP>);
    else
      return std::make_pair(dq_f32_wgmma_kernel<D, CAUSAL, CAP>,
                            masked ? dkdv_f32_wgmma_kernel<D, CAUSAL, true, CAP>
                                   : dkdv_f32_wgmma_kernel<D, CAUSAL, CAUSAL, CAP>);
  }();
  static bool dq_ok = false, dkdv_ok[2] = {false, false};
  cudaError_t e;
  if ((e = set_smem(dq, DqSmem<D, NP>::BYTES, &dq_ok)) != cudaSuccess) return e;
  // a RES shape's dV and dK blocks take different layouts: the larger
  constexpr int kv_bytes = [] {
    if constexpr (T::RES)
      return DvSmem<D>::BYTES > KvSmem<D, NP>::BYTES ? DvSmem<D>::BYTES : KvSmem<D, NP>::BYTES;
    else
      return KvSmem<D, NP>::BYTES;
  }();
  if ((e = set_smem(dkdv, kv_bytes, &dkdv_ok[masked])) != cudaSuccess) return e;
  // the inputs' maps' inner extent is the true head dim: at D 80 the
  // second box's columns 80-127 load as zeros, which Delta sums over
  constexpr int MAP_COLS = D;  // the inner extent of the q, k, v, o and dO maps
  // v, o and dO at v's head dim (MLA: 128 at D 192)
  constexpr int DV = hopper::v_dim<D>(), MAP_COLS_V = MAP_COLS - D + DV;
  auto map = [&](CUtensorMap* m, int i, int heads, int rows) {
    const int cols = i == 0 || i == 1 ? MAP_COLS : MAP_COLS_V;
    return hopper::bhsd_map(m, x.ptr[i], NP * p.B, p.S, heads, cols, x.stride[i][0],
                            x.stride[i][1], x.stride[i][2], rows);
  };
  // dq reads 64-row boxes of q and dO and DQ_BK-row ones of k and v; dkdv
  // 64-row boxes of k and v and QT-row ones of q and dO
  CUtensorMap tq, tdo, tk, tv, tq2, tdo2, tk2, tv2, to{}, tdq{}, tdk{}, tdv{};
  bool ok = map(&tq, 0, p.H, TILE) && map(&tdo, 4, p.H, TILE) && map(&tk, 1, p.Hkv, T::DQ_BK) &&
            map(&tv, 2, p.Hkv, T::DQ_BK) && map(&tq2, 0, p.H, T::QT) &&
            map(&tdo2, 4, p.H, T::QT) && map(&tk2, 1, p.Hkv, TILE) && map(&tv2, 2, p.Hkv, TILE);
  if constexpr (NP == 1) {  // O and the gradients, bf16 and contiguous
    const long long q_row = static_cast<long long>(p.H) * D;
    const long long kv_row = static_cast<long long>(p.Hkv) * D;
    const long long v_row = static_cast<long long>(p.Hkv) * DV;
    ok = ok && map(&to, 3, p.H, TILE) &&
         hopper::bhsd_map(&tdq, p.dq, p.B, p.S, p.H, D, p.S * q_row, q_row, D, TILE) &&
         hopper::bhsd_map(&tdk, p.dk, p.B, p.S, p.Hkv, D, p.S * kv_row, kv_row, D, TILE) &&
         hopper::bhsd_map(&tdv, p.dv, p.B, p.S, p.Hkv, DV, p.S * v_row, v_row, DV, TILE);
  }
  if (!ok) return cudaErrorInvalidValue;
  const unsigned n2 = (p.S + T::WG * TILE - 1) / (T::WG * TILE);
  dq<<<n2 * p.H * p.B, T::WG * 128, DqSmem<D, NP>::BYTES, st>>>(tq, tdo, to, tk, tv, tdq, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv<<<n2 * p.Hkv * p.B * T::NH, T::WG * 128, kv_bytes, st>>>(tq2, tdo2, tk2, tv2, tdk, tdv,
                                                                p);
  return cudaGetLastError();
}

// The softcap is built at D 128 and causal alone (gemma2), MLA's D 192
// causal alone, without it; the wrapper refuses the rest
template <int D, int NP>
cudaError_t launch_causal(const Params& p, const Operands& x, cudaStream_t st) {
  if constexpr (D == 192) {
    if (p.softcap > 0.f || !p.causal) return cudaErrorInvalidValue;
    return launch<D, NP, true, false>(p, x, st);
  } else {
    if (p.softcap > 0.f) {
      if constexpr (D == 128)
        if (p.causal) return launch<D, NP, true, true>(p, x, st);
      return cudaErrorInvalidValue;
    }
    return p.causal ? launch<D, NP, true, false>(p, x, st) : launch<D, NP, false, false>(p, x, st);
  }
}

template <int D>
cudaError_t launch_d(const Params& p, int dtype, void* pieces, cudaStream_t st) {
  if (dtype == 1)
    return launch_causal<D, 1>(p, {{p.q, p.k, p.v, p.o, p.dout},
                                   {{p.q_sb, p.q_ss, p.q_sh}, {p.k_sb, p.k_ss, p.k_sh},
                                    {p.v_sb, p.v_ss, p.v_sh}, {p.o_sb, p.o_ss, p.o_sh},
                                    {p.do_sb, p.do_ss, p.do_sh}}}, st);
  if (dtype != 0 || pieces == nullptr) return cudaErrorInvalidValue;
  // f32: q, k, v and dO into their pieces, one (3, B, S, heads, D) bf16
  // tensor each (v's and dO's D is DV), one after the other in the
  // caller's scratch; Delta (and at D 256 and 192 the resident tiles) read
  // the f32 tensors
  constexpr int DV = hopper::v_dim<D>();
  const long long rq = static_cast<long long>(p.S) * p.H * D;
  const long long rk = static_cast<long long>(p.S) * p.Hkv * D;
  const long long rv = static_cast<long long>(p.S) * p.Hkv * DV;
  const long long rdo = static_cast<long long>(p.S) * p.H * DV;
  __nv_bfloat16* pq = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* pk = pq + 3 * p.B * rq;
  __nv_bfloat16* pv = pk + 3 * p.B * rk;
  __nv_bfloat16* pdo = pv + 3 * p.B * rv;
  const hopper::SplitArgs a{
      {static_cast<const float*>(p.q), static_cast<const float*>(p.k),
       static_cast<const float*>(p.v), static_cast<const float*>(p.dout)},
      {pq, pk, pv, pdo},
      {p.q_sb, p.k_sb, p.v_sb, p.do_sb},
      {p.q_ss, p.k_ss, p.v_ss, p.do_ss},
      {p.q_sh, p.k_sh, p.v_sh, p.do_sh},
      {p.H, p.Hkv, p.Hkv, p.H}};
  cudaError_t e;
  if constexpr (DV == D) {
    e = hopper::split3(a, 4, p.B, p.S, D, st);
  } else {  // q and k at D, then v and dO at DV
    const hopper::SplitArgs av{{a.src[2], a.src[3], nullptr, nullptr},
                               {pv, pdo, nullptr, nullptr},
                               {p.v_sb, p.do_sb, 0, 0},
                               {p.v_ss, p.do_ss, 0, 0},
                               {p.v_sh, p.do_sh, 0, 0},
                               {p.Hkv, p.H, 0, 0}};
    e = hopper::split3(a, 2, p.B, p.S, D, st);
    if (e == cudaSuccess) e = hopper::split3(av, 2, p.B, p.S, DV, st);
  }
  if (e != cudaSuccess) return e;
  const long long sq[3] = {rq, static_cast<long long>(p.H) * D, D};
  const long long sk[3] = {rk, static_cast<long long>(p.Hkv) * D, D};
  const long long sv[3] = {rv, static_cast<long long>(p.Hkv) * DV, DV};
  const long long sdo[3] = {rdo, static_cast<long long>(p.H) * DV, DV};
  return launch_causal<D, 3>(p, {{pq, pk, pv, nullptr, pdo},
                                 {{sq[0], sq[1], sq[2]}, {sk[0], sk[1], sk[2]},
                                  {sv[0], sv[1], sv[2]}, {0, 0, 0}, {sdo[0], sdo[1], sdo[2]}}}, st);
}

}  // namespace

// Inputs (B, S, H|Hkv, D) with the given strides (elements, D contiguous;
// v, o and dout at Dv); lse (B, H, S) f32 from the forward; delta f32
// scratch of B H ceil(S/64) 128 elements; dq, dk, dv contiguous in the
// inputs' dtype.  dtype: 0 = float32 (then `pieces` is bf16 scratch of 3 B
// S ((H + Hkv) D + (H + Hkv) Dv) elements for q, k, v and dout as three
// bf16 pieces each), 1 = bfloat16 (then q,
// k, v, o and dout must start on a 16-byte boundary with strides of whole
// 16 bytes: the TMA's rule).  window: <= 0 for none.  Returns a
// cudaError_t (0 = launched).  softcap: > 0 for the logit softcap (built
// at D 128, causal).
// `pieces`, `window`, `softcap` and `Dv` (v's head dim: D, or 128 at MLA's
// D 192, causal, no softcap) come last, after the stream, so that a caller
// passing them can drive a build of an earlier source.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long o_sb, long long o_ss,
                                   long long o_sh, long long do_sb, long long do_ss,
                                   long long do_sh, int B, int S, int H, int Hkv, int D,
                                   int dtype, int causal, float scale, void* stream,
                                   void* pieces, int window, float softcap, int Dv) {
  Params p{q,    k,    v,    o,    dout, lse,  delta, dq,    dk,    dv,    q_sb,  q_ss,
           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  o_sb,  o_ss,  o_sh,  do_sb, do_ss,
           do_sh, B,   S,    H,    Hkv,  causal, scale, window, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  if (D == 192 && Dv == 128) return static_cast<int>(launch_d<192>(p, dtype, pieces, st));
  if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return static_cast<int>(launch_d<64>(p, dtype, pieces, st));
  if (D == 80) return static_cast<int>(launch_d<80>(p, dtype, pieces, st));
  if (D == 128) return static_cast<int>(launch_d<128>(p, dtype, pieces, st));
  if (D == 256) return static_cast<int>(launch_d<256>(p, dtype, pieces, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
