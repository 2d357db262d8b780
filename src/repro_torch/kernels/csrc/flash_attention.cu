// Flash attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_kernel`) in the
// JAX package's kernels/flash_attention.py: tiled online-softmax
// attention with causal / sliding-window masks, logit softcap, any GQA
// ratio (kv head = h / rep), masked logits at the finite -2e38, f32
// running max / denominator / accumulator, out = acc / max(l, 1e-37).
//
// Design.  One thread block of four warps per (q tile of 64 rows, head,
// batch).  The TPU's sequential k grid axis becomes a loop over 64-key
// tiles inside the block; m, l and acc live in registers, so nothing
// carries between blocks.  Tiles that the causal / window mask hides
// completely are never visited (the loop bounds do what the JAX
// kernel's `pl.when` does).  S need not be a multiple of the tile: rows
// past S are not stored and keys past S are dropped from the softmax.
//
// Two bodies, chosen by dtype:
// - bf16 (the serving path): each warp owns 16 query rows; Q.K^T and
//   P.V run on the tensor cores as mma.sync m16n8k16 bf16 products with
//   f32 accumulators, operands fetched from shared memory by ldmatrix
//   (rows padded by 16 bytes, so its reads are free of bank conflicts);
//   P goes from the score accumulators to the A operand in registers,
//   rounded to bf16.  K/V tiles arrive by cp.async into two buffers, the
//   next tile's copy in flight while the current one is computed, and
//   the q tiles with the most unmasked keys are started first.
// - f32: the same tiles on the CUDA cores in f32 (a 4x8 score tile and
//   a 4x(D/8) output tile per thread), exact to the f32 reference.
//
// Bound on the H100.  At the serving shapes (S <= 1024, D = 128) the
// work is compute: 4*S*S*D*H flops (halved when causal) against
// (2*H + 2*Hkv)*S*D elements of traffic, far above the ~295 flop/byte
// ridge, so the bound is the 989 TFLOP/s bf16 tensor-core peak.
// mma.sync reaches only part of it; the wgmma / TMA pipeline with
// warp-specialised producers is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // strides in elements; the D axis is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H, Hkv;
  int causal;
  int window;  // <= 0: no window
  float softcap;
  float scale;
};

// f32 body: a 4x8 score tile and a 4x(D/8) output tile per thread.
template <int D>
constexpr int smem_floats() {
  return D * (BQ + 4) + BK * (D + 1) + BK * D + BK * (BQ + 4);
}

template <int D>
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
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[qi * p.o_ss + c * 4 + 32 * jj + e] = acc[i][jj * 4 + e] / lsum;
  }
}


// bf16 body: 4 warps x 16 query rows; see the header.
template <int D>
constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * (D + 8) * 2;  // Q, and K and V twice (double buffer)
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;    // smem row stride (elements): +16 B per row
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  constexpr int NKT = BK / 8;  // n tiles of the score block
  constexpr int NDT = D / 8;   // n tiles of the output block
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Ks0 = Qs + BQ * LD;  // buffer b: Ks0 + b * 2 * BK * LD, V right after K
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  // the last q tiles see the most keys under a causal mask: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int hk = h / (p.H / p.Hkv);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int s = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(qp + s * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();
  // this warp's Q rows as A fragments, kept for every k tile
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(qf[kc], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kc * 16 +
                        (lane >> 4) * 8, false);

  float o[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  // K/V tile kt into buffer `into`, asynchronously; keys past S zero-filled
  auto load_kv = [&](int kt, int into) {
    bf16* Kb = Ks0 + into * 2 * BK * LD;
    bf16* Vb = Kb + BK * LD;
    for (int idx = tid; idx < BK * CPR; idx += NT) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      const int s = kt * BK + r;
      const bool in = s < S;
      cp_async16(Kb + r * LD + c, in ? kp + s * p.k_ss + c : kp, in);
      cp_async16(Vb + r * LD + c, in ? vp + s * p.v_ss + c : vp, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    const int buf = (kt - kt_lo) & 1;
    // the other buffer was last read in the previous iteration, which
    // ended in a barrier: prefetch the next tile into it, then wait for
    // this tile only
    if (kt + 1 < kt_hi) {
      load_kv(kt + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* Ks = Ks0 + buf * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;

    float sc[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t kb[4];  // B fragments of key tiles 2np (kb0, kb1) and 2np+1 (kb2, kb3)
        ldsm_x4(kb, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                        ((lane >> 3) & 1) * 8, false);
        mma_bf16(sc[2 * np], qf[kc], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qf[kc], kb[2], kb[3]);
      }

    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float s = sc[j][e] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool ok = key < S;
        if (p.causal) ok = ok && key <= row[r];
        if (p.window > 0) ok = ok && key > row[r] - p.window;
        sc[j][e] = ok ? s : NEG_INF;
        mt[r] = fmaxf(mt[r], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a row are four neighbouring lanes
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float pw = key < S ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = pw;
        rs[e >> 1] += pw;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // score tiles 2kc, 2kc+1 are the A fragment of keys 16kc .. 16kc+15
      const uint32_t pf[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t vb[4];  // B fragments of output tiles 2dp (vb0, vb1) and 2dp+1 (vb2, vb3)
        ldsm_x4(vb, Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                        (lane >> 4) * 8, true);
        mma_bf16(o[2 * dp], pf, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float lsum = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + row[r] * p.o_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * r] / lsum, o[j][2 * r + 1] / lsum);
  }
}

template <typename K>
cudaError_t launch_kernel(K kernel, int smem, const Params& p, int B, cudaStream_t stream,
                          bool* configured) {
  if (!*configured) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *configured = true;
  }
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  static bool configured = false;
  return launch_kernel(flash_fwd_f32_kernel<D>, smem_floats<D>() * sizeof(float), p, B,
                       stream, &configured);
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  static bool configured = false;
  return launch_kernel(flash_fwd_mma_kernel<D>, mma_smem_bytes<D>(), p, B, stream,
                       &configured);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (then every row of q, k, v must start on
// a 16-byte boundary).  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   int B, int S, int H, int Hkv, int D, int dtype,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  Params p{q, k, v, o,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           S, H, Hkv, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(p, B, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(p, B, st);
  if (dtype == 1 && D == 64) return launch_bf16<64>(p, B, st);
  if (dtype == 1 && D == 128) return launch_bf16<128>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
