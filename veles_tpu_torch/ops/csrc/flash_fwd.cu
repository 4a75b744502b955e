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
// thread block per (128-row q tile, head, sequence); the running m, l
// and the O accumulator stay in f32 registers and never reach device
// memory. Causal tiles above the diagonal are never loaded, and the
// heaviest q tiles of every head launch first so the tail of the grid
// is short.
//
// - bfloat16 (the serving and training path), 384 threads in three
//   warpgroups (flash_hopper.cuh has the building blocks):
//   - one producer warp loads the block's Q tile once and streams
//     128-key K and V tiles through a three-stage ring in shared memory
//     (225 KB with Q at D = 128) with TMA, straight from the
//     [B, T, H, D] view through its strides (no copy of a strided QKV
//     view, rows past T zero-filled); full/empty mbarriers hand each
//     stage over, and setmaxnreg gives its registers to the consumers;
//   - two consumer warpgroups own 64 query rows each: S = Q K^T is one
//     chain of wgmma m64n128k16 with both operands in shared memory,
//     and O += P V a chain of wgmma m64nDk16 with P from registers (the
//     score accumulator re-packed to bf16 A fragments in place) and V
//     read MN-major through the descriptor's transpose. While one
//     warpgroup runs its softmax, the other's products run.
//   - only tiles on the causal diagonal or past T evaluate the mask;
//     the softmax works in base 2 with scale * log2(e) folded into one
//     multiply-add, and stores m in natural units.
// - float32 (the parity path): 256 threads on FMA units over shared
//   memory tiles, full f32 products, as the plain version computes.
//
// Numerics mirror the plain PyTorch version (ops/flash_attention.py):
// scores and statistics in f32, masked probabilities exactly 0, p
// rounded to the input dtype before the P.V product, rows with l == 0
// written as zeros with the canonical residual m = 0.

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace veles_flash;
using namespace veles_hopper;

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------

constexpr int TMA_THREADS = 384;   // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage

template <int D> struct FwdTma {
  static constexpr int BM = 128;  // query rows per block
  static constexpr int BN = 128;  // keys per tile
  static constexpr int STAGES = 3;
  typedef Tile<BM, D> QTile;
  typedef Tile<BN, D> KvTile;
  static constexpr uint32_t KV_OFF = QTile::BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * KvTile::BYTES;  // K then V
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * STAGE_BYTES;
  // barriers (full, empty per stage; Q) and the alignment slack
  static constexpr size_t bytes = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// One consumer warpgroup's update of its 64 rows by one key tile: the
// online softmax of the scores s (raw Q.K products, the wgmma
// accumulator layout) into p in place, the row statistics m2 (base-2
// units) and l, and the rescale of the output accumulator.
template <int BN, int D, bool MASKED>
__device__ inline void softmax_tile(float (&s)[BN / 2], float (&o)[D / 2],
                                    float (&m2)[2], float (&l)[2],
                                    const int (&row)[2], int k0, int tq,
                                    int t_len, int causal, float c) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        if (key >= t_len || (causal && key > row[e >> 1]))
          s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float mb[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m2[i], mx[i] * c);
    // a row with nothing to attend yet keeps p = 0 and its sums
    mb[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = exp2f(m2[i] - mb[i]);
    m2[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * j + e], c, -mb[e >> 1]));
      rs[e >> 1] += p;
      s[4 * j + e] = p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = alpha[i] * l[i] + rs[i];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(TMA_THREADS, 1) flash_fwd_tma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int t_len,
    int n_heads, int64_t osb, int64_t ost, int64_t osh, int causal,
    float scale) {
  using L = FwdTma<D>;
  constexpr int BM = L::BM, BN = L::BN, STAGES = L::STAGES;
  typedef typename L::QTile QTile;
  typedef typename L::KvTile KvTile;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_q = (t_len + BM - 1) / BM;
  const int q0 = (n_q - 1 - int(blockIdx.z)) * BM;  // heavy tiles first
  int n_k = (t_len + BN - 1) / BN;
  if (causal) n_k = min(n_k, (min(q0 + BM, t_len) - 1) / BN + 1);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread starts every load
    regs_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_expect_tx(q_full, QTile::BYTES);
      QTile::load(smem, &q_map, q_full, h, q0, b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        unsigned char* ks = smem + L::KV_OFF + st * L::STAGE_BYTES;
        mbar_expect_tx(&full[st], L::STAGE_BYTES);
        KvTile::load(ks, &k_map, &full[st], h, kt * BN, b);
        KvTile::load(ks + KvTile::BYTES, &v_map, &full[st], h, kt * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup w: query rows [q0 + 64 w, q0 + 64 w + 64)
  regs_inc<240>();
  const int w = tid / 128 - 1;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = q0 + 64 * w;
  // rows of d[4 j + 0, 1] (row[0]) and d[4 j + 2, 3] (row[1])
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const float c = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(smem);

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES;
    const uint32_t k_base = q_base + L::KV_OFF + st * L::STAGE_BYTES;
    const uint32_t v_base = k_base + KvTile::BYTES;
    mbar_wait(&full[st], (kt / STAGES) & 1);

    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BN>::ss(s, QTile::k_major(q_base, 64 * w, kk),
                    KvTile::k_major(k_base, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = kt * BN;
    if ((causal && k0 + BN - 1 > r0) || k0 + BN > t_len)
      softmax_tile<BN, D, true>(s, acc, m2, l_r, row, k0, tq, t_len, causal,
                                c);
    else
      softmax_tile<BN, D, false>(s, acc, m2, l_r, row, k0, tq, t_len,
                                 causal, c);

    // O += P V: the score accumulator of keys [16 kk, 16 kk + 16) is
    // the A fragment of k-step kk
    uint32_t pa[BN / 16][4];
    pack_a<BN>(pa, s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      Wgmma<D>::rs(acc, pa[kk], KvTile::mn_major(v_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= t_len) continue;
    const float inv = l_r[i] == 0.f ? 1.f : 1.f / l_r[i];
    bf16* orow = ob + int64_t(row[i]) * ost + tq * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                acc[4 * j + 2 * i + 1] * inv);
    if (tq == 0) {
      const int64_t at = (int64_t(b) * n_heads + h) * t_len + row[i];
      l_out[at] = l_r[i];
      m_out[at] = l_r[i] == 0.f ? 0.f : m2[i] * LN2;
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
  const int64_t* maps;  // bf16: the q, k, v tensor-map layouts
};

template <int D>
int launch_tma(const Args& a, cudaStream_t stream) {
  using L = FwdTma<D>;
  static bool configured = false;
  const void* ptrs[3] = {a.q, a.k, a.v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t* layout = a.maps + i * LAYOUT_LEN;
    if (!layout_matches(layout, D, i == 0 ? L::BM : L::BN))
      return cudaErrorInvalidValue;
    const int rc = encode_map(&maps[i], ptrs[i], layout);
    if (rc != 0) return rc;
  }
  const cudaError_t err =
      configure(flash_fwd_tma_kernel<D>, L::bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned(a.h), unsigned(a.b),
                  unsigned((a.t + L::BM - 1) / L::BM)};
  flash_fwd_tma_kernel<D><<<grid, TMA_THREADS, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(a.o), a.l, a.m,
      int(a.t), int(a.h), a.st[9], a.st[10], a.st[11], a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
int launch_fma(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      configure(flash_fwd_fma_kernel<D>, FmaLayout<D>::bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned((a.t + BQ - 1) / BQ), unsigned(a.h),
                  unsigned(a.b)};
  flash_fwd_fma_kernel<D><<<grid, FMA_THREADS, FmaLayout<D>::bytes,
                            stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.l, a.m,
      int(a.t), int(a.h), a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11],
      a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1 && a.maps != nullptr) return launch_tma<D>(a, stream);
  if (dtype == 0) return launch_fma<D>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o: [B, T, H, D] with unit stride on D; strides in elements,
// (b, t, h) for q, k, v, o in that order. l, m: [B, H, T] f32,
// contiguous. dtype: 0 = float32, 1 = bfloat16. bfloat16 operands are
// read through TMA: `maps` holds the q, k, v layouts (3 x 12 int64, from
// ops/flash_attention.py:tma_layout, whose box rows must be this
// kernel's tiles); float32 takes maps = NULL. Returns 0 when launched,
// else the CUDA error of the launch or ENCODE_ERROR +
// cuTensorMapEncodeTiled's CUresult.
int veles_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* l, void* m, int64_t b, int64_t t, int64_t h,
                    int64_t d, int64_t qsb, int64_t qst, int64_t qsh,
                    int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                    int64_t vst, int64_t vsh, int64_t osb, int64_t ost,
                    int64_t osh, int causal, float scale, int dtype,
                    const int64_t* maps, void* stream) {
  if (t <= 0 || b <= 0 || h <= 0) return 0;
  const Args a{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m),
               b, t, h,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               causal, scale, maps};
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

// Dynamic shared memory of the bf16 kernel at head dim d (bytes; 0 for
// an unsupported d): ptxas reports static shared memory only.
int64_t veles_flash_fwd_smem(int64_t d) {
  return d == 32 ? FwdTma<32>::bytes
                 : d == 64 ? FwdTma<64>::bytes
                           : d == 128 ? FwdTma<128>::bytes : 0;
}

const char* veles_error_string(int code) { return error_string(code); }

}  // extern "C"
