// Flash-attention backward for Hopper, sm_90a: K2 (dK, dV) and K3 (dQ).
//
// Replaces the TPU kernels veles_tpu/ops/flash_attention.py:_dkv_kernel
// and _dq_kernel, launched by _pallas_bwd. Given q, k, v, dO [B, T, H, D]
// and the forward's f32 residuals l (row sum), m (row max) and
// Di = rowsum(dO * O) [B, H, T], each recomputes the probabilities
// p = exp(s * scale - m) / l tile by tile (rows with l == 0 take
// 1/l = 0) and never writes the [T, T] score matrix:
//
//   K2, per key tile:   dV += p^T dO,  dP = dO V^T,
//                       dS = p (dP - Di) scale,  dK += dS^T Q
//   K3, per query tile: dP = dO V^T,  dS = p (dP - Di) scale,  dQ += dS K
//
// What bounds them on this card: operations. At the training shape
// (2048 tokens, D = 128, causal) K2 does four and K3 three products of
// T^2/2 x D per (sequence, head) against a few MB of traffic, far above
// the H100's ~295 FLOP/byte ridge.
//
// What this design does about it: the TPU kernels carry dK/dV (or dQ)
// in VMEM scratch across a sequential grid axis; here one thread block
// per (64-row tile, head, sequence) loops over the other axis itself,
// so the accumulators stay in f32 registers and are written once. No
// atomics: the dK/dV and dQ split is the reference's own. Causal tiles
// that cannot see each other are never loaded, and the heaviest tiles
// launch first.
//
// - bfloat16 (the training path): four warps on mma.sync m16n8k16 (bf16
//   in, f32 accumulate), each owning 16 rows of the block's tile end to
//   end. K2 computes the transposed score tile s^T = K Q^T per warp, so
//   p^T and dS^T are already A fragments in registers for dV += p^T dO
//   and dK += dS^T Q (the register re-packing K1 does for P.V); K3 is
//   K1's loop with P.V replaced by dS.K. The block's own K and V (K2) or
//   Q and dO (K3) stay in shared memory and are read as fragments per
//   k-step, which keeps the two D-wide accumulators of K2 (128 f32
//   registers a thread at D = 128) clear of spills. Left for later: TMA,
//   a pipelined tile ring and wgmma.
// - float32 (the parity path): 256 threads on FMA units over shared
//   memory tiles, full f32 products, as the plain version computes.
//
// Numerics mirror the plain PyTorch version (_plain_bwd in
// ops/flash_attention.py): scores, p, dP and dS in f32; dS rounded to
// the input dtype before dK and dQ (and, on the bf16 path, p before dV,
// as the Pallas kernel does); masked entries (causal, keys or queries
// past T) contribute exactly 0.

#include "flash_common.cuh"

namespace {

using namespace veles_flash;

// m, 1/l (0 where l == 0) and Di of rows [r0, r0 + 64) into smem;
// rows past t_len get 1/l = 0, so their p is 0
__device__ inline void load_stats(float* m_s, float* li_s, float* di_s,
                                  const float* m, const float* l,
                                  const float* di, int64_t base, int r0,
                                  int t_len, int tid, int n_threads) {
  for (int i = tid; i < 64; i += n_threads) {
    float mv = 0.f, li = 0.f, dv = 0.f;
    if (r0 + i < t_len) {
      const float lf = l[base + r0 + i];
      mv = m[base + r0 + i];
      li = lf == 0.f ? 0.f : 1.f / lf;
      dv = di[base + r0 + i];
    }
    m_s[i] = mv;
    li_s[i] = li;
    di_s[i] = dv;
  }
}

struct Strides {
  int64_t q[3], k[3], v[3], d_o[3], o1[3], o2[3];  // (b, t, h) each
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync (four warps x 16 rows)
// ---------------------------------------------------------------------------

// four operand tiles and three stat rows
template <int D> struct MmaLayout {
  static constexpr size_t bytes =
      4 * MmaTile<D>::bytes + 3 * 64 * sizeof(float);
};

// K2: one block per (64-key tile, head, sequence)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ d_o,
    const float* __restrict__ l, const float* __restrict__ m,
    const float* __restrict__ di, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int t_len, int n_heads, Strides st, int causal,
    float scale) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int NS = BQ / 8;  // 8-query n-tiles of s^T
  constexpr int NO = D / 8;   // 8-dim n-tiles of dK, dV

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + 64 * LD;
  bf16* qs = vs + 64 * LD;
  bf16* dos = qs + 64 * LD;
  float* m_s = reinterpret_cast<float*>(dos + 64 * LD);
  float* li_s = m_s + 64;
  float* di_s = li_s + 64;

  const int k0 = int(blockIdx.x) * BK;  // the first key tiles see most
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;

  load_tile<D>(ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, t_len, tid);
  load_tile<D>(vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, t_len, tid);
  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* dob = d_o + b * st.d_o[0] + h * st.d_o[2];

  // keys of c0,c1 (key[0]) and c2,c3 (key[1]) of every fragment
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* kw = ks + warp * 16 * LD;
  const bf16* vw = vs + warp * 16 * LD;

  float dkf[NO][4], dvf[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkf[n][e] = dvf[n][e] = 0.f;

  const int n_q = (t_len + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(qs, qb, st.q[1], q0, t_len, tid);
    load_tile<D>(dos, dob, st.d_o[1], q0, t_len, tid);
    load_stats(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid,
               MMA_THREADS);
    __syncthreads();

    // s^T = K_w Q^T and dP^T = V_w dO^T, [16 keys x 64 queries]
    float sf[NS][4], dpf[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[j][e] = dpf[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, kw, kk, g, tq);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_nk(sf[j], a, qs + (j * 8 + g) * LD + kk * 16 + tq * 2);
      frag_a<LD>(a, vw, kk, g, tq);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_nk(dpf[j], a, dos + (j * 8 + g) * LD + kk * 16 + tq * 2);
    }

    // p^T into sf, dS^T into dpf
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + tq * 2 + (e & 1);
        const int kr = key[e >> 1];
        const bool ok = kr < t_len && (!causal || kr <= q0 + qi);
        const float p =
            ok ? expf(sf[j][e] * scale - m_s[qi]) * li_s[qi] : 0.f;
        sf[j][e] = p;
        dpf[j][e] = p * (dpf[j][e] - di_s[qi]) * scale;
      }

    // dV += p^T dO and dK += dS^T Q: the k-dim is the query; dO[q][d]
    // and Q[q][d] are the col-major B operands
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      frag_from_acc(pa, sf[2 * kk], sf[2 * kk + 1]);
      frag_from_acc(sa, dpf[2 * kk], dpf[2 * kk + 1]);
      const bf16* dr = dos + (kk * 16 + tq * 2) * LD + g;
      const bf16* qr = qs + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        mma_kn<LD>(dvf[n], pa, dr + n * 8);
        mma_kn<LD>(dkf[n], sa, qr + n * 8);
      }
    }
  }

  bf16* dkb = dk + b * st.o1[0] + h * st.o1[2];
  bf16* dvb = dv + b * st.o2[0] + h * st.o2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= t_len) continue;
    bf16* kr = dkb + int64_t(key[i]) * st.o1[1] + tq * 2;
    bf16* vr = dvb + int64_t(key[i]) * st.o2[1] + tq * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(kr + n * 8) =
          __floats2bfloat162_rn(dkf[n][2 * i], dkf[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vr + n * 8) =
          __floats2bfloat162_rn(dvf[n][2 * i], dvf[n][2 * i + 1]);
    }
  }
}

// K3: one block per (64-query tile, head, sequence)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ d_o,
    const float* __restrict__ l, const float* __restrict__ m,
    const float* __restrict__ di, bf16* __restrict__ dq, int t_len,
    int n_heads, Strides st, int causal, float scale) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int KD = D / 16;
  constexpr int NS = BK / 8;  // 8-key n-tiles of s
  constexpr int NO = D / 8;   // 8-dim n-tiles of dQ

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + 64 * LD;
  bf16* ks = dos + 64 * LD;
  bf16* vs = ks + 64 * LD;
  float* m_s = reinterpret_cast<float*>(vs + 64 * LD);
  float* li_s = m_s + 64;
  float* di_s = li_s + 64;

  const int n_q = (t_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - int(blockIdx.x)) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;

  load_tile<D>(qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, t_len, tid);
  load_tile<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[2], st.d_o[1], q0,
               t_len, tid);
  load_stats(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid, MMA_THREADS);
  __syncthreads();

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // tile rows
  const float m_r[2] = {m_s[rl[0]], m_s[rl[1]]};
  const float li_r[2] = {li_s[rl[0]], li_s[rl[1]]};
  const float di_r[2] = {di_s[rl[0]], di_s[rl[1]]};
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* dow = dos + warp * 16 * LD;
  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];

  float dqf[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqf[n][e] = 0.f;

  int n_k = (t_len + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_len) - 1) / BK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(ks, kb, st.k[1], k0, t_len, tid);
    load_tile<D>(vs, vb, st.v[1], k0, t_len, tid);
    __syncthreads();

    // s = Q_w K^T and dP = dO_w V^T, [16 queries x 64 keys]
    float sf[NS][4], dpf[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[j][e] = dpf[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, qw, kk, g, tq);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_nk(sf[j], a, ks + (j * 8 + g) * LD + kk * 16 + tq * 2);
      frag_a<LD>(a, dow, kk, g, tq);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_nk(dpf[j], a, vs + (j * 8 + g) * LD + kk * 16 + tq * 2);
    }

    // dS into sf
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = k0 + j * 8 + tq * 2 + (e & 1);
        const bool ok = kp < t_len && (!causal || kp <= q0 + rl[i]);
        const float p = ok ? expf(sf[j][e] * scale - m_r[i]) * li_r[i] : 0.f;
        sf[j][e] = p * (dpf[j][e] - di_r[i]) * scale;
      }

    // dQ += dS K: K[key][d] is the col-major B
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      frag_from_acc(sa, sf[2 * kk], sf[2 * kk + 1]);
      const bf16* kr = ks + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) mma_kn<LD>(dqf[n], sa, kr + n * 8);
    }
  }

  bf16* dqb = dq + b * st.o1[0] + h * st.o1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= t_len) continue;
    bf16* r = dqb + int64_t(row) * st.o1[1] + tq * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(r + n * 8) =
          __floats2bfloat162_rn(dqf[n][2 * i], dqf[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA units over shared-memory tiles (16 x 16 threads)
// ---------------------------------------------------------------------------

template <int D> struct FmaLayout {
  static constexpr int KS = FmaTile<D>::KS;
  static constexpr int PS = 64 + 1;
  static constexpr size_t tile = size_t(64) * KS * sizeof(float);
  static constexpr size_t p_tile = size_t(64) * PS * sizeof(float);
  // four operand tiles, two score tiles (K2) and three stat rows
  static constexpr size_t bytes = 4 * tile + 2 * p_tile + 3 * 64 * 4;
};

// K2, float32
template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_bwd_dkv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ d_o,
    const float* __restrict__ l, const float* __restrict__ m,
    const float* __restrict__ di, float* __restrict__ dk,
    float* __restrict__ dv, int t_len, int n_heads, Strides st, int causal,
    float scale) {
  using L = FmaLayout<D>;
  constexpr int KS = L::KS;
  constexpr int PS = L::PS;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + 64 * KS;
  float* qs = vs + 64 * KS;
  float* dos = qs + 64 * KS;
  float* pt = dos + 64 * KS;   // p^T [key][query]
  float* dst = pt + 64 * PS;   // dS^T [key][query]
  float* m_s = dst + 64 * PS;
  float* li_s = m_s + 64;
  float* di_s = li_s + 64;

  const int k0 = int(blockIdx.x) * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;

  load_tile_f32<D>(ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, t_len,
                   tid);
  load_tile_f32<D>(vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, t_len,
                   tid);
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* dob = d_o + b * st.d_o[0] + h * st.d_o[2];

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_q = (t_len + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile_f32<D>(qs, qb, st.q[1], q0, t_len, tid);
    load_tile_f32<D>(dos, dob, st.d_o[1], q0, t_len, tid);
    load_stats(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid,
               FMA_THREADS);
    __syncthreads();

    // s^T and dP^T for keys ty*4+i, queries tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * KS + d];
        vv[i] = vs[(ty * 4 + i) * KS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * KS + d];
        ov[j] = dos[(tx + 16 * j) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
      const int kp = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const bool ok = kp < t_len && (!causal || kp <= q0 + qc);
        const float p =
            ok ? expf(s[i][j] * scale - m_s[qc]) * li_s[qc] : 0.f;
        pt[kr * PS + qc] = p;
        dst[kr * PS + qc] = p * (dp[i][j] - di_s[qc]) * scale;
      }
    }
    __syncthreads();

    // dV += p^T dO, dK += dS^T Q for keys ty*4+i, columns tx+16j
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * PS + qq];
        sv[i] = dst[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float ov = dos[qq * KS + tx + 16 * j];
        const float qv = qs[qq * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][j] = fmaf(pv[i], ov, dva[i][j]);
          dka[i][j] = fmaf(sv[i], qv, dka[i][j]);
        }
      }
    }
  }

  float* dkb = dk + b * st.o1[0] + h * st.o1[2];
  float* dvb = dv + b * st.o2[0] + h * st.o2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[int64_t(kp) * st.o1[1] + tx + 16 * j] = dka[i][j];
      dvb[int64_t(kp) * st.o2[1] + tx + 16 * j] = dva[i][j];
    }
  }
}

// K3, float32
template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_bwd_dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ d_o,
    const float* __restrict__ l, const float* __restrict__ m,
    const float* __restrict__ di, float* __restrict__ dq, int t_len,
    int n_heads, Strides st, int causal, float scale) {
  using L = FmaLayout<D>;
  constexpr int KS = L::KS;
  constexpr int PS = L::PS;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + 64 * KS;
  float* ks = dos + 64 * KS;
  float* vs = ks + 64 * KS;
  float* ps = vs + 64 * KS;  // dS [query][key]
  float* m_s = ps + 2 * 64 * PS;
  float* li_s = m_s + 64;
  float* di_s = li_s + 64;

  const int n_q = (t_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - int(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;

  load_tile_f32<D>(qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, t_len,
                   tid);
  load_tile_f32<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[2], st.d_o[1], q0,
                   t_len, tid);
  load_stats(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid, FMA_THREADS);
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_k = (t_len + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_len) - 1) / BK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32<D>(ks, kb, st.k[1], k0, t_len, tid);
    load_tile_f32<D>(vs, vb, st.v[1], k0, t_len, tid);
    __syncthreads();

    // s and dP for queries ty*4+i, keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * KS + d];
        ov[i] = dos[(ty * 4 + i) * KS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * KS + d];
        vv[j] = vs[(tx + 16 * j) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < t_len && (!causal || kp <= q0 + r);
        const float p = ok ? expf(s[i][j] * scale - m_s[r]) * li_s[r] : 0.f;
        ps[r * PS + c] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K for queries ty*4+i, columns tx+16j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[kk * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
      }
    }
  }

  float* dqb = dq + b * st.o1[0] + h * st.o1[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[int64_t(t) * st.o1[1] + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *d_o;
  const float *l, *m, *di;
  void *o1, *o2;  // dK, dV (K2) or dQ (K3)
  int64_t b, t, h;
  Strides st;
  int causal;
  float scale;
};

template <typename T, typename Kernel>
cudaError_t launch_dkv(Kernel kernel, size_t smem_bytes, int threads,
                       bool& configured, const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = configure(kernel, smem_bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned((a.t + BK - 1) / BK), unsigned(a.h),
                  unsigned(a.b)};
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_o), a.l, a.m,
      a.di, static_cast<T*>(a.o1), static_cast<T*>(a.o2), int(a.t),
      int(a.h), a.st, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, size_t smem_bytes, int threads,
                      bool& configured, const Args& a,
                      cudaStream_t stream) {
  cudaError_t err = configure(kernel, smem_bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned((a.t + BQ - 1) / BQ), unsigned(a.h),
                  unsigned(a.b)};
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_o), a.l, a.m,
      a.di, static_cast<T*>(a.o1), int(a.t), int(a.h), a.st, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(bool dkv, int dtype, const Args& a,
                     cudaStream_t stream) {
  static bool cfg[4] = {false, false, false, false};
  if (dtype == 1)
    return dkv ? launch_dkv<bf16>(flash_bwd_dkv_mma_kernel<D>,
                                  MmaLayout<D>::bytes, MMA_THREADS, cfg[0],
                                  a, stream)
               : launch_dq<bf16>(flash_bwd_dq_mma_kernel<D>,
                                 MmaLayout<D>::bytes, MMA_THREADS, cfg[1],
                                 a, stream);
  if (dtype == 0)
    return dkv ? launch_dkv<float>(flash_bwd_dkv_fma_kernel<D>,
                                   FmaLayout<D>::bytes, FMA_THREADS, cfg[2],
                                   a, stream)
               : launch_dq<float>(flash_bwd_dq_fma_kernel<D>,
                                  FmaLayout<D>::bytes, FMA_THREADS, cfg[3],
                                  a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch(bool dkv, int64_t d, int dtype, const Args& a,
                   void* stream) {
  if (a.t <= 0 || a.b <= 0 || a.h <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<32>(dkv, dtype, a, s);
    case 64:
      return launch_d<64>(dkv, dtype, a, s);
    case 128:
      return launch_d<128>(dkv, dtype, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, dO, dK, dV: [B, T, H, D] with unit stride on D; strides in
// elements, (b, t, h) for q, k, v, dO, dK, dV in that order. bfloat16
// operands need 16-byte aligned q, k, v, dO rows. l, m, di: [B, H, T]
// f32, contiguous. dtype: 0 = float32, 1 = bfloat16. Returns the CUDA
// error of the launch (0 = launched).
int veles_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* d_o, const void* l, const void* m,
                        const void* di, void* dk, void* dv, int64_t b,
                        int64_t t, int64_t h, int64_t d, int64_t qsb,
                        int64_t qst, int64_t qsh, int64_t ksb, int64_t kst,
                        int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
                        int64_t osb, int64_t ost, int64_t osh, int64_t dksb,
                        int64_t dkst, int64_t dksh, int64_t dvsb,
                        int64_t dvst, int64_t dvsh, int causal, float scale,
                        int dtype, void* stream) {
  const Args a{q, k, v, d_o,
               static_cast<const float*>(l), static_cast<const float*>(m),
               static_cast<const float*>(di), dk, dv, b, t, h,
               Strides{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                       {osb, ost, osh}, {dksb, dkst, dksh},
                       {dvsb, dvst, dvsh}},
               causal, scale};
  return launch(true, d, dtype, a, stream);
}

// As veles_flash_bwd_dkv, with the one output dQ [B, T, H, D].
int veles_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* d_o, const void* l, const void* m,
                       const void* di, void* dq, int64_t b, int64_t t,
                       int64_t h, int64_t d, int64_t qsb, int64_t qst,
                       int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh,
                       int64_t vsb, int64_t vst, int64_t vsh, int64_t osb,
                       int64_t ost, int64_t osh, int64_t dqsb, int64_t dqst,
                       int64_t dqsh, int causal, float scale, int dtype,
                       void* stream) {
  const Args a{q, k, v, d_o,
               static_cast<const float*>(l), static_cast<const float*>(m),
               static_cast<const float*>(di), dq, nullptr, b, t, h,
               Strides{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                       {osb, ost, osh}, {dqsb, dqst, dqsh}, {0, 0, 0}},
               causal, scale};
  return launch(false, d, dtype, a, stream);
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
