// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel veles_tpu/ops/flash_attention.py:_fwd_kernel,
// launched by _pallas_fwd: blocked online-softmax attention over
// q, k, v [B, T, H, D], causal or not, writing O in the input dtype
// plus the f32 softmax residuals l (row sum) and m (row max) [B, H, T].
//
// What bounds it on this card: operations. A 2048-token causal
// prefill at D = 128 is ~8.6 GFLOP per (sequence, layer) against
// ~3 MB of q/k/v/o traffic, far above the H100's ~295 FLOP/byte
// ridge, so the tensor cores are the ceiling.
//
// What this design does about it: the TPU kernel's sequential K-tile
// grid axis with VMEM scratch becomes a loop over K tiles inside one
// thread block per (64-row q tile, head, batch); the running m, l and
// the O accumulator stay in f32 and never reach device memory. Causal
// tiles above the diagonal are never loaded, and the heaviest q tiles
// launch first so the tail of the grid is short.
//
// - bfloat16 (the serving path): four warps, each owning 16 query rows
//   end to end. S = Q K^T and O += P V run on the tensor cores through
//   mma.sync m16n8k16 (bf16 in, f32 accumulate); Q stays in registers
//   as A fragments, the score tile stays in registers and is re-packed
//   in place as the A operand of P V (the FlashAttention-2 register
//   layout), and each row's softmax statistics reduce within its quad
//   of lanes. Left for later: wgmma, TMA loads and a pipelined K/V
//   ring (the tiles load synchronously), which the full tensor-core
//   rate needs.
// - float32 (the parity path): 256 threads on FMA units over shared
//   memory tiles, full f32 products, as the plain version computes.
//
// Numerics mirror the plain PyTorch version (ops/flash_attention.py):
// scores and statistics in f32, masked scores at the finite
// MASK_VALUE with their probabilities forced to 0, p rounded to the
// input dtype before the P.V product, rows with l == 0 written as
// zeros with the canonical residual m = 0.

#include "flash_common.cuh"

namespace {

using namespace veles_flash;

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync (four warps x 16 query rows)
// ---------------------------------------------------------------------------

template <int D> struct MmaLayout {
  static constexpr size_t bytes = 3 * MmaTile<D>::bytes;  // q, k, v
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int t_len,
    int n_heads, int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb,
    int64_t kst, int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
    int64_t osb, int64_t ost, int64_t osh, int causal, float scale) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int KD = D / 16;  // k-steps of S = Q K^T over the head dim
  constexpr int NS = BK / 8;  // 8-key n-tiles of the score tile
  constexpr int NO = D / 8;   // 8-dim n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + 64 * LD;
  bf16* vs = ks + 64 * LD;

  const int n_q = (t_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - int(blockIdx.x)) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and B column) in the quad
  const int tq = lane & 3;  // lane within the quad

  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  load_tile<D>(qs, q + b * qsb + h * qsh, qst, q0, t_len, tid);
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole kernel
  const int r0 = warp * 16 + g;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    frag_a<LD>(qf[kk], qs + warp * 16 * LD, kk, g, tq);
  // rows of c0,c1 (row[0]) and c2,c3 (row[1]) of every fragment
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  float of[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
  float m_r[2] = {MASK_VALUE, MASK_VALUE};
  float l_r[2] = {0.f, 0.f};

  int n_k = (t_len + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_len) - 1) / BK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(ks, kb, kst, k0, t_len, tid);
    load_tile<D>(vs, vb, vst, k0, t_len, tid);
    __syncthreads();

    float sf[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sf[j][0] = sf[j][1] = sf[j][2] = sf[j][3] = 0.f;
      const bf16* kr = ks + (j * 8 + g) * LD + tq * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) mma_nk(sf[j], qf[kk], kr + kk * 16);
    }

    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const bool ok = key < t_len && (!causal || key <= row[e >> 1]);
        sf[j][e] = ok ? sf[j][e] * scale : MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], sf[j][e]);
      }
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new[i]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const bool ok = key < t_len && (!causal || key <= row[e >> 1]);
        const float p = ok ? expf(sf[j][e] - m_new[e >> 1]) : 0.f;
        rs[e >> 1] += p;
        sf[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
      m_r[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      of[n][0] *= alpha[0];
      of[n][1] *= alpha[0];
      of[n][2] *= alpha[1];
      of[n][3] *= alpha[1];
    }

    // O += P V: the score fragments of keys [16 kk, 16 kk + 16) are
    // the A fragment of k-step kk; V[key][d] is the col-major B
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      frag_from_acc(pa, sf[2 * kk], sf[2 * kk + 1]);
      const bf16* vr = vs + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) mma_kn<LD>(of[n], pa, vr + n * 8);
    }
  }

  bf16* ob = o + b * osb + h * osh;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = l_r[i] == 0.f ? 1.f : 1.f / l_r[i];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= t_len) continue;
    bf16* orow = ob + int64_t(row[i]) * ost + tq * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(of[n][2 * i] * inv[i],
                                of[n][2 * i + 1] * inv[i]);
    if (tq == 0) {
      const int64_t at = (int64_t(b) * n_heads + h) * t_len + row[i];
      l_out[at] = l_r[i];
      m_out[at] = l_r[i] == 0.f ? 0.f : m_r[i];
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA units over shared-memory tiles (16 x 16 threads)
// ---------------------------------------------------------------------------

// q and k tiles take the padded rows; v is read along rows only
template <int D> struct FmaLayout {
  static constexpr int KS = FmaTile<D>::KS;
  static constexpr int PS = BK + 1;
  static constexpr size_t q_bytes = size_t(BQ) * KS * sizeof(float);
  static constexpr size_t k_bytes = size_t(BK) * KS * sizeof(float);
  static constexpr size_t v_bytes = size_t(BK) * D * sizeof(float);
  static constexpr size_t p_bytes = size_t(BQ) * PS * sizeof(float);
  static constexpr size_t bytes =
      q_bytes + k_bytes + v_bytes + p_bytes + 3 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_fwd_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int t_len,
    int n_heads, int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb,
    int64_t kst, int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
    int64_t osb, int64_t ost, int64_t osh, int causal, float scale) {
  using L = FmaLayout<D>;
  constexpr int KS = L::KS;
  constexpr int PS = L::PS;
  constexpr int DJ = D / 16;  // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + L::q_bytes);
  float* vs = reinterpret_cast<float*>(smem + L::q_bytes + L::k_bytes);
  float* ps = reinterpret_cast<float*>(smem + L::q_bytes + L::k_bytes +
                                       L::v_bytes);
  float* m_s = ps + BQ * PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int n_q = (t_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - int(blockIdx.x)) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  float* ob = o + b * osb + h * osh;

  load_tile_f32<D>(qs, qb, qst, q0, t_len, tid);
  if (tid < BQ) {
    m_s[tid] = MASK_VALUE;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_k = (t_len + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_len) - 1) / BK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += FMA_THREADS) {
      const int r = idx / D, c = idx % D;
      const int t = k0 + r;
      const bool in = t < t_len;
      ks[r * KS + c] = in ? kb[int64_t(t) * kst + c] : 0.f;
      vs[r * D + c] = in ? vb[int64_t(t) * vst + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * KS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < t_len && (!causal || kp <= q0 + r);
        ps[r * PS + c] = ok ? s[i][j] * scale : MASK_VALUE;
      }
    }
    __syncthreads();

    // online softmax: four lanes per row, each over 16 keys
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      const int qp = q0 + r;
      const float m_prev = m_s[r];
      float mx = MASK_VALUE;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj)
        mx = fmaxf(mx, ps[r * PS + part * (BK / 4) + jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) {
        const int c = part * (BK / 4) + jj;
        const int kp = k0 + c;
        const bool ok = kp < t_len && (!causal || kp <= qp);
        const float p = ok ? expf(ps[r * PS + c] - m_next) : 0.f;
        sum += p;
        ps[r * PS + c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_next;
      }
    }
    __syncthreads();

    // O = alpha * O + P V for rows ty*4+i, columns tx+16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= t_len) continue;
    const float lf = l_s[r];
    const float inv = lf == 0.f ? 1.f : 1.f / lf;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[int64_t(t) * ost + tx + 16 * j] = acc[i][j] * inv;
  }
  if (tid < BQ && q0 + tid < t_len) {
    const float lf = l_s[tid];
    const int64_t at = (int64_t(b) * n_heads + h) * t_len + q0 + tid;
    l_out[at] = lf;
    m_out[at] = lf == 0.f ? 0.f : m_s[tid];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float *l, *m;
  int64_t b, t, h;
  int64_t st[12];
  int causal;
  float scale;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem_bytes, int threads,
                   bool& configured, const Args& a, cudaStream_t stream) {
  const cudaError_t err = configure(kernel, smem_bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned((a.t + BQ - 1) / BQ), unsigned(a.h),
                  unsigned(a.b)};
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.l, a.m, int(a.t),
      int(a.h), a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11], a.causal,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const Args& a, cudaStream_t stream) {
  static bool mma_configured = false, fma_configured = false;
  if (dtype == 1)
    return launch<bf16>(flash_fwd_mma_kernel<D>, MmaLayout<D>::bytes,
                        MMA_THREADS, mma_configured, a, stream);
  if (dtype == 0)
    return launch<float>(flash_fwd_fma_kernel<D>, FmaLayout<D>::bytes,
                         FMA_THREADS, fma_configured, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o: [B, T, H, D] with unit stride on D; strides in elements,
// (b, t, h) for q, k, v, o in that order. bfloat16 operands need
// 16-byte aligned q, k, v rows (base and strides in multiples of 8
// elements). l, m: [B, H, T] f32, contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns the CUDA error of the launch (0 = launched).
int veles_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* l, void* m, int64_t b, int64_t t, int64_t h,
                    int64_t d, int64_t qsb, int64_t qst, int64_t qsh,
                    int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                    int64_t vst, int64_t vsh, int64_t osb, int64_t ost,
                    int64_t osh, int causal, float scale, int dtype,
                    void* stream) {
  if (t <= 0 || b <= 0 || h <= 0) return 0;
  const Args a{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m),
               b, t, h,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<32>(dtype, a, s);
    case 64:
      return launch_d<64>(dtype, a, s);
    case 128:
      return launch_d<128>(dtype, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
