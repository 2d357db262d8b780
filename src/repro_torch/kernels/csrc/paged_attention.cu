// Paged-attention decode for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `paged_attention_fwd` (body `_kernel`) in the
// JAX package's kernels/paged_attention.py: one query token per
// sequence against K/V pages of a pool (NP, P, Hkv, D), addressed
// through a block table (B, maxp); keys 0..pos are live, with an
// optional sliding window and logit softcap; online softmax in f32.
//
// Both bodies cut the pages of each sequence into splits, and one
// thread block per (kv head, sequence, split) serves all `rep` query
// heads of that kv head, so each page of K/V is read once for the rep
// heads (rep = 12 for starcoder2-3b).  A block reads its own table row
// (the TPU kernel's scalar prefetch) and writes its split's partial
// state (running max m in natural-log units, denominator l, unnormalised
// accumulator) to the f32 scratch; a second kernel, `paged_combine`,
// merges the splits in a fixed order (the TPU's sequential page axis
// becomes this two-pass reduction).  Pages past `pos` or wholly behind
// the window are never read, and their splits launch blocks that exit at
// once.  Table slots past an allocation hold the trash page 0, and the
// page range stops at table column maxp - 1 whatever a stale `pos` of an
// inactive slot says, so every read stays inside the pool and the table.
//
// Bound on the H100: bytes.  Each live key is read once as K and once
// as V, 2*Hkv*D*itemsize bytes per token of every sequence, against
// 4*H*D flops per token: ~1 flop/byte, so the bound is live KV bytes
// over 3.35 TB/s (0.0024 ms for 8 starcoder2 sequences of ~1000 tokens).
// At that size the time is latency: the table read, the loads' round
// trip and the softmax chain of each block, then the combine launch.
//
// bf16 body (`paged_wgmma_kernel`; the shapes of `wgmma_shape`, which
// kernels/paged_attention.py:wgmma_body mirrors), built on csrc/hopper.cuh:
// - split: SPLIT_KEYS = 64 keys, one stage (4 pages at P 16).  8
//   starcoder2 sequences of ~1000 tokens give 2 x 8 x 16 = 256 blocks
//   with live pages, two to an SM, every byte requested at once.  The
//   partial states cost 4*(D+2) bytes per (query head, split), written
//   once and read once by the combine: at rep 12 and D 128 that is 38% on
//   top of the split's 32 KB of K/V, and stays in L2;
// - producer: warp 4.  Each lane reads one table entry of the split's
//   live pages before the barriers are set up, then issues that page's K
//   and V boxes (64 columns x P rows of one kv head, a 4-d TMA box of the
//   pool as it is) into its slot of the stage.  P-row page boxes at
//   P in {8, 16, 32, 64} start on 1024-byte boundaries, so the pages of a
//   stage stacked in shared memory have the layout of one 64-row
//   128-byte-swizzled box, which `desc_sw128` describes.  Every stage of
//   the split is requested before the first wait (with one stage a
//   split, the whole split), so no slot is reused and there are no
//   "empty" barriers;
// - consumer: warpgroup 0.  Q's rep rows are loaded once into a 64-row
//   swizzled tile (rows past rep zero: computed, never written).  S = Q
//   K^T is a wgmma m64n64k16 over D / 16 steps; the per-column mask (key
//   outside [key_lo, key_hi], which folds in the window, pos and the
//   table's end), the softcap (tanh(s * scale / cap) * cap, after the
//   scale, as the JAX kernel) and the online softmax in base 2 run in
//   registers in f32; O += P V is a wgmma m64nDk16 with P packed to bf16
//   from registers and V read MN-major.  The mask is a select on every
//   score of every stage, so a window needs no variant and no branch;
//   softcap is a template choice (nothing branches between a product's
//   issue and its wait).  V rows of page slots past the split's last page
//   are zeroed before the products (their P is 0, and 0 x NaN is NaN);
// - products: at rep 12, 52 of wgmma's 64 rows are padding.  At the serve
//   shape the products are ~0.5 GFLOP, 0.5 us at peak against 2.4 us of
//   bytes: the tensor cores are there to take the per-token shuffle
//   chain of the CUDA-core body off the critical path;
// - host: the K and V tensor maps are cached by (base, NP, P, Hkv, D):
//   an engine's pools never move, so a tick encodes none;
// - D 256 (gemma3's global layers): a page is four 64-column boxes, O a
//   wgmma m64n256k16 a 16-key step, 128 + 32 f32 accumulators a thread;
// - D 80 (zamba2-2.7b's shared attention, rep 1): laid out as D 128
//   (`hopper::box_cols`), a page two boxes whose pool map has an inner
//   extent of 80, so TMA fills columns 80-127 with zeros; S = Q K^T stops
//   after the head dim's 5 k-steps (Q's columns past 80 are never read),
//   O += P V runs at N 128 over V's zero columns, and the partial state
//   stores 80 columns.
//
// f32 body (`paged_partial_kernel`, any rep of the dispatch table below,
// and bf16 outside `wgmma_shape`): eight warps take the split's pages
// round robin, each a whole page at a time with its own running (m, l,
// acc), a score a warp-shuffle dot product; the warps' states merge
// through shared memory.  Its split is the caller's `pps` pages.  A lane
// holds EPL elements of a row, EPL = D / 32 where 32 divides D; at D 80,
// four elements on each of 20 lanes (the other 12 hold zeros).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <vector>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int NW = 8;  // warps per block of the f32 body
constexpr int TU = 4;  // tokens whose K/V loads are issued together (f32 body)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements in vector loads of up to 16 bytes (N * sizeof(T)
// in {4, 8, 16} or a multiple of 16)
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* ptr, float* out) {
  constexpr int BYTES = N * sizeof(T) < 16 ? N * sizeof(T) : 16, PER = BYTES / sizeof(T);
  using V = typename std::conditional<
      BYTES == 16, uint4,
      typename std::conditional<BYTES == 8, uint2, unsigned int>::type>::type;
  static_assert((BYTES == 16 && N % PER == 0) || BYTES == 8 || BYTES == 4, "vector width");
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    const V raw = reinterpret_cast<const V*>(ptr)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f(e[i]);
  }
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
  // elements of D per lane, whole vector loads: D / 32, or at D 80 four
  // on the first LANES = 20 lanes
  constexpr int EPL = D % 32 == 0 ? D / 32 : 4;
  constexpr int LANES = D / EPL;
  static_assert((D == 64 || D == 80 || D == 128 || D == 256) && LANES * EPL == D &&
                    LANES <= 32,
                "a head dim the lanes are laid out for");
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
  const bool holds = lane < LANES;  // the lane holds elements of D
  const int d0 = holds ? lane * EPL : 0;
  const int P = p.P;
  const long long tok_s = (long long)p.Hkv * D;
  const long long page_s = (long long)P * tok_s;

  float q[REP][EPL], acc[REP][EPL], m[REP], l[REP];
  const T* qb = static_cast<const T*>(p.q) + ((long long)b * p.H + g * REP) * D;
#pragma unroll
  for (int i = 0; i < REP; ++i) {
    if (holds) {
      load_f<T, EPL>(qb + i * D + d0, q[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[i][e] = 0.f;
    }
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
        if (live[u] && holds) {
          load_f<T, EPL>(kbase + page_off + t * tok_s, kx[u]);
          load_f<T, EPL>(vbase + page_off + t * tok_s, vx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.f;
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
    if (holds)
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

// ---------------------------------------------------------------------------
// bf16 body: pages gathered by TMA, scored and summed by wgmma; see the header.
// ---------------------------------------------------------------------------

constexpr int BOX = 64;                 // columns of a TMA box (128 bytes of bf16)
constexpr int BOX_BYTES = 64 * 128;     // a 64-row box
constexpr int STAGE_KEYS = 64;          // keys of a stage: S's N, P V's depth
constexpr int SPLIT_KEYS = 64;          // keys of a split (kernels/paged_attention.py)
constexpr int STAGES = SPLIT_KEYS / STAGE_KEYS;
constexpr int PRODUCER = 4;             // the producer warp, after the consumer warpgroup
constexpr int WNT = 160;
static_assert(SPLIT_KEYS % STAGE_KEYS == 0 && SPLIT_KEYS / 8 <= 32,
              "a split is whole stages, one producer lane a page");

__host__ __device__ constexpr bool wgmma_shape(int D, int P, int rep) {
  return (D == 64 || D == 80 || D == 128 || D == 256) &&
         (P == 8 || P == 16 || P == 32 || P == 64) && rep >= 1 && rep <= 16;
}

// shared memory, in bytes from a 1024-aligned base: Q as NB boxes of 64
// rows, then K of every stage, then V of every stage (box x of stage i at
// (i * NB + x) boxes; page slot u of a stage at rows u*P of each box),
// then the barriers; NB = box_cols / 64, the boxes of a row (2 at D 80)
template <int D>
struct WSmem {
  static constexpr int NB = hopper::box_cols<D>() / BOX;
  static constexpr int K = NB * BOX_BYTES;
  static constexpr int V = K + STAGES * NB * BOX_BYTES;
  static constexpr int BAR = V + STAGES * NB * BOX_BYTES;
  static constexpr int BYTES = BAR + 8 * 2 * STAGES + 1024;  // + alignment slack
};

template <int D, bool CAP>
__global__ void __launch_bounds__(WNT) paged_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                                                          const __grid_constant__ CUtensorMap tv,
                                                          Params p) {
  using L = WSmem<D>;
  constexpr int NB = L::NB;
  constexpr int DP = NB * BOX;  // O's columns: the head dim's boxes (zeros past D)
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  // broadcast from lane 0, so that ptxas sees every branch below that
  // depends on pos as warp-uniform (no wgmma in a divergent path)
  const int pos = __shfl_sync(0xffffffffu, p.pos[b], 0);
  int j_lo, j_hi;
  live_pages(p, pos, &j_lo, &j_hi);
  const int s_lo = split * p.pps;
  const int j0 = max(j_lo, s_lo), j1 = min(j_hi, s_lo + p.pps - 1);
  if (j0 > j1) return;  // nothing live here; the combine skips this split

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* v_full = k_full + STAGES;

  const int P = p.P;
  const int sp = STAGE_KEYS / P;                  // pages a stage
  const int n_pages = j1 - j0 + 1;
  const int n_st = (n_pages + sp - 1) / sp;       // stages of this split
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int tid = threadIdx.x;

  // producer lanes read their page's table entry under the barriers' setup
  int page_id = 0;
  if (warp == PRODUCER && lane < n_pages) page_id = p.tables[(long long)b * p.maxp + j0 + lane];
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == PRODUCER) {
    // every stage of the split requested before the first wait: lane u
    // loads page j0 + u into slot u % sp of stage u / sp
    const uint32_t page_bytes = NB * P * 128;
    if (lane == 0) {
      for (int i = 0; i < n_st; ++i) {
        const uint32_t bytes = min(sp, n_pages - i * sp) * page_bytes;
        hopper::mbar_expect_tx(&k_full[i], bytes);
        hopper::mbar_expect_tx(&v_full[i], bytes);
      }
    }
    __syncwarp();
    if (lane < n_pages) {
      const int i = lane / sp, row = (lane % sp) * P;
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        hopper::tma_load_4d(sm + L::K + (i * NB + x) * BOX_BYTES + row * 128, &tk, &k_full[i],
                            x * BOX, g, 0, page_id);
        hopper::tma_load_4d(sm + L::V + (i * NB + x) * BOX_BYTES + row * 128, &tv, &v_full[i],
                            x * BOX, g, 0, page_id);
      }
    }
    return;
  }

  // the consumer warpgroup.  Q: rows 0..rep-1 the kv head's query heads,
  // rows past rep zero, 16-byte chunk c of row r at chunk c ^ (r % 8) (the
  // TMA box's swizzle)
  const int rep = p.H / p.Hkv;
  const uint4* qg = static_cast<const uint4*>(p.q) + ((long long)b * p.H + g * rep) * (D / 8);
  for (int c = tid; c < 64 * D / 8; c += 128) {
    const int r = c / (D / 8), ch = c % (D / 8);
    const uint4 val = r < rep ? qg[r * (D / 8) + ch] : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sm + (ch / 8) * BOX_BYTES + r * 128 + ((ch % 8) ^ (r % 8)) * 16) =
        val;
  }
  // V rows of the last stage's slots past the split's last page
  const int zero_from = (n_pages - (n_st - 1) * sp) * P;
  if (zero_from < STAGE_KEYS) {
    for (int c = tid; c < NB * (STAGE_KEYS - zero_from) * 8; c += 128) {
      const int x = c / ((STAGE_KEYS - zero_from) * 8), rc = c % ((STAGE_KEYS - zero_from) * 8);
      *reinterpret_cast<uint4*>(sm + L::V + ((n_st - 1) * NB + x) * BOX_BYTES +
                                (zero_from + rc / 8) * 128 + (rc % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  hopper::fence_proxy_async();  // the writes above, before the products read them
  hopper::named_barrier(1, 128);

  // the live keys of this block; the window, pos and the table's end in one range
  const int key_lo = max(j0 * P, p.window > 0 ? pos - p.window + 1 : 0);
  const int key_hi = min(pos, (j1 + 1) * P - 1);
  const int gr = lane / 4, t = lane % 4;  // fragment row group / column pair
  // scores go to base 2: s * scale * log2(e), or with a softcap c
  // tanh(s * scale / c) * c * log2(e)
  const float pre = CAP ? p.scale / p.softcap : p.scale * LOG2E;
  const float post = p.softcap * LOG2E;
  const uint32_t q_smem = hopper::smem_addr(sm);
  const uint32_t k_smem = hopper::smem_addr(sm + L::K);
  const uint32_t v_smem = hopper::smem_addr(sm + L::V);

  float o[DP / 2], s[STAGE_KEYS / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  uint32_t pa[STAGE_KEYS / 16][4];
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < STAGE_KEYS / 16; ++kc) hopper::fence_regs(pa[kc]);
  };

  for (int i = 0; i < n_st; ++i) {
    // S = Q K^T of stage i
    hopper::mbar_wait(&k_full[i], 0);
    fence_all();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<STAGE_KEYS, 0, 0>(
          s, hopper::desc_sw128(q_smem + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024),
          hopper::desc_sw128(k_smem + (i * NB + kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024),
          kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all();

    // s[x]: row 16 warp + gr + 8 ((x >> 1) & 1), key key0 + 8 (x / 4) + 2 t + (x & 1)
    const int key0 = (j0 + i * sp) * P;
    if constexpr (CAP) {
#pragma unroll
      for (int x = 0; x < STAGE_KEYS / 2; ++x) s[x] = tanhf(s[x] * pre) * post;
    } else {
#pragma unroll
      for (int x = 0; x < STAGE_KEYS / 2; ++x) s[x] *= pre;
    }
#pragma unroll
    for (int x = 0; x < STAGE_KEYS / 2; ++x) {
      const int key = key0 + (x / 4) * 8 + 2 * t + (x & 1);
      s[x] = key < key_lo || key > key_hi ? NEG_INF : s[x];
    }
    float mt[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int x = 0; x < STAGE_KEYS / 2; ++x) mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], s[x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a row are four neighbouring lanes
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = hopper::exp2_approx(m[r] - mt[r]);
      m[r] = mt[r];
    }
#pragma unroll
    for (int x = 0; x < STAGE_KEYS / 2; ++x) {
      s[x] = hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);
      rs[(x >> 1) & 1] += s[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
    for (int kc = 0; kc < STAGE_KEYS / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kc][e] = hopper::pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);

    // O += P V of stage i; keys 16 kc .. 16 kc + 15 the A operand of step kc
    hopper::mbar_wait(&v_full[i], 0);
    fence_all();
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < STAGE_KEYS / 16; ++kc)
      hopper::wgmma_rs<DP, 1>(
          o, pa[kc],
          hopper::desc_sw128(v_smem + i * NB * BOX_BYTES + kc * 16 * 128, BOX_BYTES, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all();
  }

  // the rep live rows' partial state (warp 0 holds rows 0-15)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + gr + 8 * r;
    if (row < rep) {
      const long long prow = ((long long)b * p.H + g * rep + row) * p.nsplit + split;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(p.part_acc + prow * D + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (t == 0) {
        p.part_ml[prow * 2] = m[r] * LN2;  // the combine's natural-log units
        p.part_ml[prow * 2 + 1] = l[r];
      }
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
  if constexpr (D == 256) {  // gemma3's rep is 2; at rep 12 and 16 a thread would spill 5 KB
    switch (rep) {
      case 1: return launch<T, D, 1>(p, B, st);
      case 2: return launch<T, D, 2>(p, B, st);
      case 4: return launch<T, D, 4>(p, B, st);
      case 8: return launch<T, D, 8>(p, B, st);
      default: return cudaErrorInvalidValue;
    }
  }
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

// The tensor map of a bf16 pool (NP, P, Hkv, D), read in boxes of one
// page of one kv head (64 columns x P rows).  Cached by (base, NP, P, Hkv,
// D), which fix the map: an engine's pools never move, so a decode tick
// encodes none.  False if the encode fails.
bool pool_map(const void* base, int NP, int P, int Hkv, int D, CUtensorMap* out) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    int NP, P, Hkv, D;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.base == base && e.NP == NP && e.P == P && e.Hkv == Hkv && e.D == D) {
      *out = e.map;
      return true;
    }
  Entry e{{}, base, NP, P, Hkv, D};
  if (!hopper::bhsd_map(&e.map, base, NP, P, Hkv, D, static_cast<long long>(P) * Hkv * D,
                        static_cast<long long>(Hkv) * D, D, P))
    return false;
  if (cache.size() >= 1024) cache.erase(cache.begin());  // oldest first
  cache.push_back(e);
  *out = e.map;
  return true;
}

template <int D, bool CAP>
cudaError_t launch_wgmma(const Params& p, int B, int NP, cudaStream_t stream) {
  constexpr int smem = WSmem<D>::BYTES;
  auto kernel = paged_wgmma_kernel<D, CAP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tk, tv;
  if (!pool_map(p.k, NP, p.P, p.Hkv, D, &tk) || !pool_map(p.v, NP, p.P, p.Hkv, D, &tv))
    return cudaErrorInvalidValue;
  kernel<<<dim3(p.Hkv, B, p.nsplit), WNT, smem, stream>>>(tk, tv, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<__nv_bfloat16, D><<<dim3(p.H, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_cap(const Params& p, int B, int NP, cudaStream_t st) {
  return p.softcap > 0.f ? launch_wgmma<D, true>(p, B, NP, st)
                         : launch_wgmma<D, false>(p, B, NP, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_ml / part_acc: f32 scratch of
// (B, H, nsplit, 2) and (B, H, nsplit, D), nsplit = ceil(maxp / pps) for
// the f32 body, whose split is `pps` pages; the bf16 body, at the shapes
// of `wgmma_shape`, splits at SPLIT_KEYS keys whatever `pps` says, and
// then needs nsplit = ceil(maxp / (SPLIT_KEYS / P)), the pools (NP pages)
// and q on 16-byte boundaries.  NP comes last, after the stream: a
// library built from the entry without it ignores it.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const int* tables, const int* pos, void* o,
                                   void* part_ml, void* part_acc,
                                   int B, int H, int Hkv, int D, int P, int maxp, int pps,
                                   int dtype, int window, float softcap, float scale,
                                   void* stream, int NP) {
  const int rep = H / Hkv;
  if (dtype == 1 && wgmma_shape(D, P, rep)) pps = SPLIT_KEYS / P;
  const int nsplit = (maxp + pps - 1) / pps;
  Params p{q, k_pages, v_pages, tables, pos, o,
           static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           H, Hkv, P, maxp, pps, nsplit, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && wgmma_shape(D, P, rep))
    return D == 64    ? by_cap<64>(p, B, NP, st)
           : D == 80  ? by_cap<80>(p, B, NP, st)
           : D == 128 ? by_cap<128>(p, B, NP, st)
                      : by_cap<256>(p, B, NP, st);
  if (dtype == 0 && D == 64) return by_rep<float, 64>(p, rep, B, st);
  if (dtype == 0 && D == 80) return by_rep<float, 80>(p, rep, B, st);
  if (dtype == 0 && D == 128) return by_rep<float, 128>(p, rep, B, st);
  if (dtype == 0 && D == 256) return by_rep<float, 256>(p, rep, B, st);
  if (dtype == 1 && D == 64) return by_rep<__nv_bfloat16, 64>(p, rep, B, st);
  if (dtype == 1 && D == 80) return by_rep<__nv_bfloat16, 80>(p, rep, B, st);
  if (dtype == 1 && D == 128) return by_rep<__nv_bfloat16, 128>(p, rep, B, st);
  if (dtype == 1 && D == 256) return by_rep<__nv_bfloat16, 256>(p, rep, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
