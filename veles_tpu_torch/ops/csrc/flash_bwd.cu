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
// per tile of rows, head and sequence loops over the other axis itself,
// so the accumulators stay in f32 registers and are written once. No
// atomics: the dK/dV and dQ split is the reference's own. Causal tiles
// that cannot see each other are never loaded, and the heaviest tiles
// launch first.
//
// - K3 and K2, bfloat16 (the training path), on the building blocks of
//   flash_hopper.cuh: TMA loads the tiles straight from the
//   [B, T, H, D] views through their strides (rows past T zero-filled)
//   into a ring of stages guarded by full/empty mbarriers, and every
//   product is a wgmma chain (m64nNk16): score tiles with both operands
//   K-major in shared memory, the gradient products with A re-packed
//   from the f32 score accumulator in registers and B read MN-major (the
//   descriptor's transpose). Only diagonal and ragged tiles evaluate the
//   mask; p is exp2 of one multiply-add against m in base 2.
//   - K3 (DqTma): a producer warpgroup (setmaxnreg down to 24) loads Q
//     and dO once and streams 64-key K and V tiles through a ring; per
//     tile s = Q K^T, dP = dO V^T, dS in the accumulators, dQ += dS K.
//     Up to D = 128: 384 threads, two consumer warpgroups of 64 query
//     rows, four stages. At D = 256 (as K1's 256-wide instance): one
//     consumer warpgroup, 256 threads, two stages (197,672 bytes of
//     shared memory, 228 registers a thread; dQ alone is 128 registers
//     a thread, and ptxas gives a 384-thread block 168).
//   - K2 (DkvTma), up to D = 128: 256 threads, one block per 128-key
//     tile; K and V load once, 64-row Q and dO tiles stream through a
//     three-stage ring. It computes the transposed tiles s^T = K_w Q^T
//     and dP^T = V_w dO^T (64 keys of warpgroup w by 64 queries), so p^T
//     and dS^T are A fragments of dV += p^T dO and dK += dS^T Q, with dO
//     and Q as the MN-major B. Each consumer thread holds both D-wide
//     f32 accumulators (dK and dV: 128 registers at D = 128) to the end,
//     ~245 registers in all: more than ptxas grants a thread of a
//     384-thread block (168, whatever setmaxnreg hands a warpgroup
//     later), so K2 has no producer warpgroup. Warp 0 loads besides
//     computing: it refills the stage of tile it - 1 after tile it, so
//     the warpgroups may drift a tile apart. The row statistics m, 1/l
//     and Di are per column of these tiles: the loading warp stages them
//     with each Q/dO stage (m in base 2, 1/l = 0 past T), counted in the
//     stage's full barrier; their global loads start a tile before the
//     fill, so no warp waits for them.
//   - K2 at D = 256 (flash_bwd_dkv_split_kernel): that layout would
//     need ~331 KB of shared memory and 256 accumulator registers a
//     thread. Chosen: one block per 64-key tile whose two warpgroups
//     split the work instead of the keys. Warpgroup 0 computes
//     s^T = K Q^T, turns it into p^T and owns dV += p^T dO; warpgroup 1
//     computes dP^T = V dO^T and owns dK += dS^T Q. p^T goes from one to
//     the other through a 64 x 64 f32 tile in shared memory, each thread
//     writing and reading the accumulator slots it holds (the layouts
//     match), under two named barriers (written, read). K and V stay
//     resident, two stages of 64-row Q/dO stream (215,592 bytes); each
//     thread holds one 128-register accumulator and a 32-register score
//     tile or two (224 registers). The loader is warp 4: warpgroup 1
//     finishes a tile last, so it refills the stage it just released.
//     Not chosen: two blocks splitting D, each recomputing s^T and dP^T
//     over the full D (1.5x the products).
// - float32 (the parity path): 256 threads on FMA units over shared
//   memory tiles, full f32 products, as the plain version computes. Up
//   to D = 128 both tiles of a block are 64 rows; at D = 256 four 64-row
//   padded tiles alone would take 263 KB, so the streamed tiles (Q/dO of
//   K2, K/V of K3) are 32 rows (215,040 bytes).
// - Head dims: instances of width 32, 64, 128 and 256; a head dim d (a
//   multiple of 8 up to 256) runs on the next width, its columns past d
//   read as zeros (TMA's out-of-bounds fill for bf16, masked loads for
//   f32) and never stored. A zero column leaves s and dP as they are and
//   gives zero in dQ, dK and dV, so the padded instance is exact; the
//   softmax scale is the caller's 1 / sqrt(d).
//
// Numerics mirror the plain PyTorch version (_plain_bwd in
// ops/flash_attention.py): scores, p, dP and dS in f32; dS rounded to
// the input dtype before dK and dQ (and, on the bf16 path, p before dV,
// as the Pallas kernel does); masked entries (causal, keys or queries
// past T) contribute exactly 0.

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace veles_flash;
using namespace veles_hopper;

constexpr float LOG2E = 1.4426950408889634f;

// m, 1/l (0 where l == 0) and Di of rows [r0, r0 + R) into smem;
// rows past t_len get 1/l = 0, so their p is 0
template <int R>
__device__ inline void load_stats(float* m_s, float* li_s, float* di_s,
                                  const float* m, const float* l,
                                  const float* di, int64_t base, int r0,
                                  int t_len, int tid, int n_threads) {
  for (int i = tid; i < R; i += n_threads) {
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

// Stores rows `row` of a wgmma accumulator acc[64 x D] (the layout of
// flash_hopper.cuh) into out (row stride `rs`), rows past t_len and
// columns past d left out
template <int D>
__device__ inline void store_rows(bf16* out, int64_t rs,
                                  const float (&acc)[D / 2],
                                  const int (&row)[2], int tq, int t_len,
                                  int d) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= t_len) continue;
    bf16* r = out + int64_t(row[i]) * rs + tq * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (j * 8 < d)
        *reinterpret_cast<__nv_bfloat162*>(r + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3, bfloat16: TMA ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------

// The instance of width D (see the top): consumer warpgroups of 64 query
// rows each, a producer warpgroup, 64-key K/V tiles in a ring
template <int D> struct DqTma {
  static constexpr int CONSUMERS = D > 128 ? 1 : 2;  // warpgroups
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int CONSUMER_WARPS = 4 * CONSUMERS;  // free a stage
  static constexpr int BM = 64 * CONSUMERS;  // query rows per block
  static constexpr int BN = 64;              // keys per tile
  static constexpr int STAGES = D > 128 ? 2 : 4;
  typedef Tile<BM, D> QTile;  // Q and dO
  typedef Tile<BN, D> KvTile;
  static constexpr uint32_t DO_OFF = QTile::BYTES;
  static constexpr uint32_t KV_OFF = 2 * QTile::BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * KvTile::BYTES;  // K then V
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * STAGE_BYTES;
  // barriers (full, empty per stage; Q/dO) and the alignment slack
  static constexpr size_t bytes = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// dS = p (dP - Di) scale into s, in the wgmma accumulator layout, with
// p = exp2(s c - m2) / l; masked entries (MASKED tiles only) get p = 0
template <int BN, bool MASKED>
__device__ inline void ds_tile(float (&s)[BN / 2], const float (&dp)[BN / 2],
                               const float (&m2)[2], const float (&li)[2],
                               const float (&dv)[2], const int (&row)[2],
                               int k0, int tq, int t_len, int causal, float c,
                               float scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = s[4 * j + e];
      if (MASKED) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        if (key >= t_len || (causal && key > row[i])) x = -INFINITY;
      }
      const float p = exp2f(fmaf(x, c, -m2[i])) * li[i];
      s[4 * j + e] = p * (dp[4 * j + e] - dv[i]) * scale;
    }
}

// one block per (head, sequence, BM-query tile); d: the operands' head
// dim (<= D), whose columns past d are zeros in the tiles and not stored
template <int D>
__global__ void __launch_bounds__(DqTma<D>::THREADS, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ l,
                            const float* __restrict__ m,
                            const float* __restrict__ di,
                            bf16* __restrict__ dq, int t_len, int n_heads,
                            int64_t dqsb, int64_t dqst, int64_t dqsh,
                            int causal, float scale, int d) {
  using L = DqTma<D>;
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
      mbar_init(&empty[s], L::CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread starts every load
    if constexpr (L::CONSUMERS > 1) regs_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&do_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_expect_tx(q_full, 2 * QTile::BYTES);
      QTile::load(smem, &q_map, q_full, h, q0, b);
      QTile::load(smem + L::DO_OFF, &do_map, q_full, h, q0, b);
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
  if constexpr (L::CONSUMERS > 1) regs_inc<240>();
  const int w = tid / 128 - 1;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = q0 + 64 * w;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const float c = scale * LOG2E;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;

  // m in base 2, 1/l (0 where l == 0 or past T, so p = 0) and Di
  float m2[2], li[2], dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m2[i] = 0.f;
    li[i] = 0.f;
    dv[i] = 0.f;
    if (row[i] < t_len) {
      const float lf = l[base + row[i]];
      m2[i] = m[base + row[i]] * LOG2E;
      li[i] = lf == 0.f ? 0.f : 1.f / lf;
      dv[i] = di[base + row[i]];
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = smem_u32(smem);
  const uint32_t do_base = q_base + L::DO_OFF;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES;
    const uint32_t k_base = q_base + L::KV_OFF + st * L::STAGE_BYTES;
    const uint32_t v_base = k_base + KvTile::BYTES;
    mbar_wait(&full[st], (kt / STAGES) & 1);

    float s[BN / 2], dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BN>::ss(s, QTile::k_major(q_base, 64 * w, kk),
                    KvTile::k_major(k_base, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BN>::ss(dp, QTile::k_major(do_base, 64 * w, kk),
                    KvTile::k_major(v_base, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int k0 = kt * BN;
    if ((causal && k0 + BN - 1 > r0) || k0 + BN > t_len)
      ds_tile<BN, true>(s, dp, m2, li, dv, row, k0, tq, t_len, causal, c,
                        scale);
    else
      ds_tile<BN, false>(s, dp, m2, li, dv, row, k0, tq, t_len, causal, c,
                         scale);

    // dQ += dS K: dS of keys [16 kk, 16 kk + 16) is the A fragment of
    // k-step kk; K[key][d] is the MN-major B
    uint32_t sa[BN / 16][4];
    pack_a<BN>(sa, s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      Wgmma<D>::rs(acc, sa[kk], KvTile::mn_major(k_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  store_rows<D>(dq + b * dqsb + h * dqsh, dqst, acc, row, tq, t_len, d);
}

// ---------------------------------------------------------------------------
// K2, bfloat16: TMA ring, wgmma on transposed tiles, no producer
// warpgroup (see the top: a 384-thread block leaves 168 registers a
// thread, a 256-thread one 255)
// ---------------------------------------------------------------------------

constexpr int DKV_THREADS = 256;  // two warpgroups

// The instance of width D: up to 128, a block of 128 keys (64 a
// warpgroup) over three stages of 64-row Q/dO; at 256 (SPLIT) one of
// 64 keys whose warpgroups split the products, two stages and the p^T
// exchange tile
template <int D> struct DkvTma {
  static constexpr bool SPLIT = D > 128;
  static constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage
  static constexpr int BN = SPLIT ? 64 : 128;  // keys per block
  static constexpr int BM = 64;                // query rows per tile
  static constexpr int STAGES = SPLIT ? 2 : 3;
  typedef Tile<BN, D> KvTile;  // K and V, loaded once
  typedef Tile<BM, D> QTile;   // Q and dO, streamed
  static constexpr uint32_t V_OFF = KvTile::BYTES;
  static constexpr uint32_t RING_OFF = 2 * KvTile::BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * QTile::BYTES;  // Q then dO
  // per stage: m in base 2, 1/l and Di of the tile's rows, f32
  static constexpr uint32_t STATS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr uint32_t STATS_FLOATS = 3 * BM;
  // SPLIT: p^T [64 keys x 64 queries] f32, in accumulator slots
  static constexpr uint32_t XCHG_OFF = STATS_OFF + STAGES * STATS_FLOATS * 4;
  static constexpr uint32_t XCHG_BYTES = SPLIT ? 64 * BM * 4 : 0;
  static constexpr uint32_t BAR_OFF = XCHG_OFF + XCHG_BYTES;
  // barriers (full, empty per stage; K/V) and the alignment slack
  static constexpr size_t bytes = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// p^T = exp2(s^T c - m2) / l into s, in the wgmma accumulator layout of a
// [64 keys x N queries] tile from query q0 on (statistics per query
// column, from shared memory); masked entries (MASKED tiles only) get
// p = 0
template <int N, bool MASKED>
__device__ inline void pt_tile(float (&s)[N / 2], const float* m2s,
                               const float* lis, const int (&key)[2], int q0,
                               int tq, int t_len, int causal, float c) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 m2 = *reinterpret_cast<const float2*>(m2s + col);
    const float2 li = *reinterpret_cast<const float2*>(lis + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (MASKED) {
        const int kr = key[e >> 1];
        if (kr >= t_len || (causal && kr > q0 + col + (e & 1)))
          x = -INFINITY;
      }
      s[4 * j + e] =
          exp2f(fmaf(x, c, -(e & 1 ? m2.y : m2.x))) * (e & 1 ? li.y : li.x);
    }
  }
}

// dS^T = p^T (dP^T - Di) scale into dp
template <int N>
__device__ inline void dst_tile(float (&dp)[N / 2], const float (&p)[N / 2],
                                const float* dis, int tq, float scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 dv = *reinterpret_cast<const float2*>(dis + 8 * j + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] =
          p[4 * j + e] * (dp[4 * j + e] - (e & 1 ? dv.y : dv.x)) * scale;
  }
}

// m, l and Di of rows q0 + lane and q0 + lane + 32 (0 past T; each
// pointer offset to the (sequence, head)): loads only, which the warp
// starts and leaves in flight until fill_stage uses them
__device__ inline void stats_load(float (&v)[6], const float* l,
                                  const float* m, const float* di, int q0,
                                  int lane, int t_len) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lane + 32 * r;
    const bool ok = row < t_len;
    v[r] = ok ? m[row] : 0.f;
    v[2 + r] = ok ? l[row] : 0.f;
    v[4 + r] = ok ? di[row] : 0.f;
  }
}

// The loading warp's fill of one ring stage with query tile q0: lane 0
// starts the Q and dO copies, every lane stores its two rows of
// statistics (m in base 2, 1/l, 0 where l == 0 or past T so that p = 0,
// and Di) and arrives (the stage's full barrier counts 1 + 32 arrivals)
template <typename L>
__device__ inline void fill_stage(unsigned char* smem, float* sr,
                                  uint64_t* full, const CUtensorMap* q_map,
                                  const CUtensorMap* do_map,
                                  const float (&v)[6], int stage, int h,
                                  int q0, int b, int lane) {
  typedef typename L::QTile QTile;
  if (lane == 0) {
    unsigned char* qs = smem + L::RING_OFF + stage * L::STAGE_BYTES;
    mbar_expect_tx(full, L::STAGE_BYTES);
    QTile::load(qs, q_map, full, h, q0, b);
    QTile::load(qs + QTile::BYTES, do_map, full, h, q0, b);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lf = v[2 + r];
    sr[lane + 32 * r] = v[r] * LOG2E;
    sr[L::BM + lane + 32 * r] = lf == 0.f ? 0.f : 1.f / lf;
    sr[2 * L::BM + lane + 32 * r] = v[4 + r];
  }
  mbar_arrive(full);
}

// The set-up shared by both K2 kernels: barriers initialised, then the
// loading warp starts the K/V copies and fills the first stages
template <typename L>
__device__ inline void dkv_prologue(unsigned char* smem, float* stats,
                                    uint64_t* full, uint64_t* empty,
                                    uint64_t* kv_full,
                                    const CUtensorMap* q_map,
                                    const CUtensorMap* k_map,
                                    const CUtensorMap* v_map,
                                    const CUtensorMap* do_map,
                                    const float* lr, const float* mr,
                                    const float* dr, bool loader, int tid,
                                    int lane, int h, int b, int k0, int qt0,
                                    int n_it, int t_len) {
  typedef typename L::KvTile KvTile;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the loads, the statistics
      mbar_init(&empty[s], L::CONSUMER_WARPS);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (!loader) return;
  if (lane == 0) {
    tma_prefetch_map(k_map);
    tma_prefetch_map(v_map);
    tma_prefetch_map(q_map);
    tma_prefetch_map(do_map);
    mbar_expect_tx(kv_full, 2 * KvTile::BYTES);
    KvTile::load(smem, k_map, kv_full, h, k0, b);
    KvTile::load(smem + L::V_OFF, v_map, kv_full, h, k0, b);
  }
  // the first stages are fresh
  for (int it = 0; it < min(L::STAGES, n_it); ++it) {
    float v[6];
    const int q0 = (qt0 + it) * L::BM;
    stats_load(v, lr, mr, dr, q0, lane, t_len);
    fill_stage<L>(smem, stats + it * L::STATS_FLOATS, &full[it], q_map,
                  do_map, v, it, h, q0, b, lane);
  }
}

// one block per (head, sequence, 128-key tile), D <= 128
template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_tma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ l,
    const float* __restrict__ m, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int n_heads,
    Strides st, int causal, float scale, int d) {
  using L = DkvTma<D>;
  constexpr int BN = L::BN, BM = L::BM, STAGES = L::STAGES;
  typedef typename L::KvTile KvTile;
  typedef typename L::QTile QTile;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::STATS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = int(blockIdx.z) * BN;  // the first key tiles see most
  const int n_q = (t_len + BM - 1) / BM;
  // causal: no query row before k0 sees these keys
  const int qt0 = causal ? k0 / BM : 0;
  const int n_it = n_q - qt0;
  const int tid = threadIdx.x;

  // warp-uniform roles (broadcast from lane 0, so the compiler sees
  // them so): warpgroup w takes keys [k0 + 64 w, k0 + 64 w + 64), warp 0
  // also loads
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int w = warp_id / 4;
  const bool loader = warp_id == 0;
  const int lane = tid % 32;
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;
  const float* lr = l + base;
  const float* mr = m + base;
  const float* dr = di + base;
  dkv_prologue<L>(smem, stats, full, empty, kv_full, &q_map, &k_map,
                  &v_map, &do_map, lr, mr, dr, loader, tid, lane, h, b, k0,
                  qt0, n_it, t_len);

  const int warp = warp_id % 4;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kw = k0 + 64 * w;
  // keys of d[4 j + 0, 1] (key[0]) and d[4 j + 2, 3] (key[1])
  const int key[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  const float c = scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_base = smem_u32(smem);
  const uint32_t v_base = k_base + L::V_OFF;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    const int q0 = (qt0 + it) * BM;
    const uint32_t q_base = k_base + L::RING_OFF + stage * L::STAGE_BYTES;
    const uint32_t do_base = q_base + QTile::BYTES;
    const float* sr = stats + stage * L::STATS_FLOATS;
    // warp 0 refills the stage of tile it - 1 with tile it - 1 + STAGES
    // once this tile is done; its statistics load meanwhile (nothing
    // waits for them before the fill)
    const int refill = it - 1 + STAGES;
    const bool refills = loader && it >= 1 && refill < n_it;
    float next[6];
    if (refills)
      stats_load(next, lr, mr, dr, (qt0 + refill) * BM, lane, t_len);
    mbar_wait(&full[stage], (it / STAGES) & 1);

    // a tile wholly before this warpgroup's keys adds nothing (causal);
    // the stage is handed back all the same
    if (!causal || q0 + BM - 1 >= kw) {
      float s[BM / 2], dp[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BM>::ss(s, KvTile::k_major(k_base, 64 * w, kk),
                      QTile::k_major(q_base, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BM>::ss(dp, KvTile::k_major(v_base, 64 * w, kk),
                      QTile::k_major(do_base, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if ((causal && kw + 63 > q0) || kw + 64 > t_len)
        pt_tile<BM, true>(s, sr, sr + BM, key, q0, tq, t_len, causal, c);
      else
        pt_tile<BM, false>(s, sr, sr + BM, key, q0, tq, t_len, causal, c);
      // dS^T before either product, so that p^T is packed as its f32
      // registers die
      dst_tile<BM>(dp, s, sr + 2 * BM, tq, scale);
      uint32_t pa[BM / 16][4], sa[BM / 16][4];
      pack_a<BM>(pa, s);
      pack_a<BM>(sa, dp);

      // dV += p^T dO and dK += dS^T Q: p^T (dS^T) of queries
      // [16 kk, 16 kk + 16) is the A fragment of k-step kk; dO and Q
      // ([query][d]) are the MN-major B
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        Wgmma<D>::rs(dva, pa[kk], QTile::mn_major(do_base, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        Wgmma<D>::rs(dka, sa[kk], QTile::mn_major(q_base, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      // the A fragments stay untouched until the products are done
      fence_frags(pa);
      fence_frags(sa);
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (refills) {
      // every consumer warp has released tile it - 1
      const int prev = (it - 1) % STAGES;
      mbar_wait(&empty[prev], ((it - 1) / STAGES) & 1);
      fill_stage<L>(smem, stats + prev * L::STATS_FLOATS, &full[prev],
                    &q_map, &do_map, next, prev, h, (qt0 + refill) * BM, b,
                    lane);
    }
  }

  store_rows<D>(dk + b * st.o1[0] + h * st.o1[2], st.o1[1], dka, key, tq,
                t_len, d);
  store_rows<D>(dv + b * st.o2[0] + h * st.o2[2], st.o2[1], dva, key, tq,
                t_len, d);
}

// ---------------------------------------------------------------------------
// K2 at D = 256, bfloat16: the two warpgroups split the products (see
// the top)
// ---------------------------------------------------------------------------

constexpr int XCHG_FULL = 1;   // named barrier: p^T written
constexpr int XCHG_EMPTY = 2;  // named barrier: p^T read

// one block per (head, sequence, 64-key tile)
template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_split_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ l,
    const float* __restrict__ m, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int n_heads,
    Strides st, int causal, float scale, int d) {
  using L = DkvTma<D>;
  constexpr int BN = L::BN, BM = L::BM, STAGES = L::STAGES;
  static_assert(L::SPLIT && BN == 64 && BM == 64,
                "one 64 x 64 score tile a warpgroup");
  typedef typename L::KvTile KvTile;
  typedef typename L::QTile QTile;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::STATS_OFF);
  float* xchg = reinterpret_cast<float*>(smem + L::XCHG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = int(blockIdx.z) * BN;  // the first key tiles see most
  const int n_q = (t_len + BM - 1) / BM;
  const int qt0 = causal ? k0 / BM : 0;  // every tile from it sees k0
  const int n_it = n_q - qt0;
  const int tid = threadIdx.x;

  // warp-uniform roles: warpgroup 0 makes p^T and dV, warpgroup 1 dP^T,
  // dS^T and dK; warp 4 also loads
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int w = warp_id / 4;
  const bool loader = warp_id == 4;
  const int lane = tid % 32;
  const int slot = tid % 128;  // the thread's column of the exchange
  const int64_t base = (int64_t(b) * n_heads + h) * t_len;
  const float* lr = l + base;
  const float* mr = m + base;
  const float* dr = di + base;
  dkv_prologue<L>(smem, stats, full, empty, kv_full, &q_map, &k_map,
                  &v_map, &do_map, lr, mr, dr, loader, tid, lane, h, b, k0,
                  qt0, n_it, t_len);

  const int warp = warp_id % 4;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float c = scale * LOG2E;
  const bool edge = k0 + BN > t_len;

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t k_base = smem_u32(smem);
  // the score product's A: K (s^T = K Q^T) or V (dP^T = V dO^T)
  const uint32_t a_base = k_base + (w == 0 ? 0u : L::V_OFF);

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    const int q0 = (qt0 + it) * BM;
    const uint32_t q_base = k_base + L::RING_OFF + stage * L::STAGE_BYTES;
    const uint32_t do_base = q_base + QTile::BYTES;
    // warpgroup 0: s^T from Q, then dV from dO; 1: dP^T from dO, then dK
    // from Q
    const uint32_t score_b = w == 0 ? q_base : do_base;
    const uint32_t grad_b = w == 0 ? do_base : q_base;
    const float* sr = stats + stage * L::STATS_FLOATS;
    // warp 4 refills this stage with tile it + STAGES once both
    // warpgroups have released it; its statistics load meanwhile
    const int refill = it + STAGES;
    const bool refills = loader && refill < n_it;
    float next[6];
    if (refills)
      stats_load(next, lr, mr, dr, (qt0 + refill) * BM, lane, t_len);
    mbar_wait(&full[stage], (it / STAGES) & 1);

    float s[BM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BM>::ss(s, KvTile::k_major(a_base, 0, kk),
                    QTile::k_major(score_b, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    uint32_t fa[BM / 16][4];
    if (w == 0) {
      if ((causal && k0 + BN - 1 > q0) || edge)
        pt_tile<BM, true>(s, sr, sr + BM, key, q0, tq, t_len, causal, c);
      else
        pt_tile<BM, false>(s, sr, sr + BM, key, q0, tq, t_len, causal, c);
      // p^T of tile it - 1 has been read
      if (it > 0) bar_sync(XCHG_EMPTY, DKV_THREADS);
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) xchg[j * 128 + slot] = s[j];
      bar_arrive(XCHG_FULL, DKV_THREADS);
      pack_a<BM>(fa, s);
    } else {
      float p[BM / 2];
      bar_sync(XCHG_FULL, DKV_THREADS);
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) p[j] = xchg[j * 128 + slot];
      if (it + 1 < n_it) bar_arrive(XCHG_EMPTY, DKV_THREADS);
      dst_tile<BM>(s, p, sr + 2 * BM, tq, scale);
      pack_a<BM>(fa, s);
    }

    // dV += p^T dO or dK += dS^T Q: the fragment of queries
    // [16 kk, 16 kk + 16) is the A of k-step kk; dO or Q the MN-major B
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      Wgmma<D>::rs(acc, fa[kk], QTile::mn_major(grad_b, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(fa);
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (refills) {
      mbar_wait(&empty[stage], (it / STAGES) & 1);
      fill_stage<L>(smem, stats + stage * L::STATS_FLOATS, &full[stage],
                    &q_map, &do_map, next, stage, h, (qt0 + refill) * BM, b,
                    lane);
    }
  }

  if (w == 0)
    store_rows<D>(dv + b * st.o2[0] + h * st.o2[2], st.o2[1], acc, key, tq,
                  t_len, d);
  else
    store_rows<D>(dk + b * st.o1[0] + h * st.o1[2], st.o1[1], acc, key, tq,
                  t_len, d);
}

// ---------------------------------------------------------------------------
// float32: FMA units over shared-memory tiles (16 x 16 threads)
// ---------------------------------------------------------------------------

// Each block holds one 64-row tile (K/V for K2, Q/dO for K3) and streams
// SR-row tiles of the other operands
template <int D> struct FmaLayout {
  static constexpr int KS = FmaTile<D>::KS;
  static constexpr int SR = D > 128 ? 32 : 64;  // streamed rows
  static constexpr int SJ = SR / 16;  // streamed rows a thread
  static constexpr int PS = SR + 1;
  static constexpr size_t tile = size_t(64) * KS * sizeof(float);
  static constexpr size_t s_tile = size_t(SR) * KS * sizeof(float);
  static constexpr size_t p_tile = size_t(64) * PS * sizeof(float);
  // two held and two streamed operand tiles, two score tiles (K2) and
  // three stat rows
  static constexpr size_t bytes =
      2 * tile + 2 * s_tile + 2 * p_tile + 3 * 64 * 4;
};

// K2, float32
template <int D>
__global__ void __launch_bounds__(FMA_THREADS) flash_bwd_dkv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ d_o,
    const float* __restrict__ l, const float* __restrict__ m,
    const float* __restrict__ di, float* __restrict__ dk,
    float* __restrict__ dv, int t_len, int n_heads, Strides st, int causal,
    float scale, int d) {
  using L = FmaLayout<D>;
  constexpr int KS = L::KS;
  constexpr int PS = L::PS;
  constexpr int SR = L::SR;
  constexpr int SJ = L::SJ;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + 64 * KS;
  float* qs = vs + 64 * KS;
  float* dos = qs + SR * KS;
  float* pt = dos + SR * KS;   // p^T [key][query]
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
                   tid, d);
  load_tile_f32<D>(vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, t_len,
                   tid, d);
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* dob = d_o + b * st.d_o[0] + h * st.d_o[2];

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_q = (t_len + SR - 1) / SR;
  for (int qt = causal ? k0 / SR : 0; qt < n_q; ++qt) {
    const int q0 = qt * SR;
    __syncthreads();
    load_tile_f32<D, SR>(qs, qb, st.q[1], q0, t_len, tid, d);
    load_tile_f32<D, SR>(dos, dob, st.d_o[1], q0, t_len, tid, d);
    load_stats<SR>(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid,
                   FMA_THREADS);
    __syncthreads();

    // s^T and dP^T for keys ty*4+i, queries tx+16j
    float s[4][SJ], dp[4][SJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float kv[4], vv[4], qv[SJ], ov[SJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * KS + e];
        vv[i] = vs[(ty * 4 + i) * KS + e];
      }
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        qv[j] = qs[(tx + 16 * j) * KS + e];
        ov[j] = dos[(tx + 16 * j) * KS + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
      const int kp = k0 + kr;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
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
    for (int qq = 0; qq < SR; ++qq) {
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
      if (tx + 16 * j >= d) continue;
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
    int n_heads, Strides st, int causal, float scale, int d) {
  using L = FmaLayout<D>;
  constexpr int KS = L::KS;
  constexpr int PS = L::PS;
  constexpr int SR = L::SR;
  constexpr int SJ = L::SJ;
  constexpr int DJ = D / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + 64 * KS;
  float* ks = dos + 64 * KS;
  float* vs = ks + SR * KS;
  float* ps = vs + SR * KS;  // dS [query][key]
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
                   tid, d);
  load_tile_f32<D>(dos, d_o + b * st.d_o[0] + h * st.d_o[2], st.d_o[1], q0,
                   t_len, tid, d);
  load_stats<BQ>(m_s, li_s, di_s, m, l, di, base, q0, t_len, tid,
                 FMA_THREADS);
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_k = (t_len + SR - 1) / SR;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_len) - 1) / SR + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * SR;
    __syncthreads();
    load_tile_f32<D, SR>(ks, kb, st.k[1], k0, t_len, tid, d);
    load_tile_f32<D, SR>(vs, vb, st.v[1], k0, t_len, tid, d);
    __syncthreads();

    // s and dP for queries ty*4+i, keys tx+16j
    float s[4][SJ], dp[4][SJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qv[4], ov[4], kv[SJ], vv[SJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * KS + e];
        ov[i] = dos[(ty * 4 + i) * KS + e];
      }
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        kv[j] = ks[(tx + 16 * j) * KS + e];
        vv[j] = vs[(tx + 16 * j) * KS + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
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
    for (int kk = 0; kk < SR; ++kk) {
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
      if (tx + 16 * j < d) dqb[int64_t(t) * st.o1[1] + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *d_o;
  const float *l, *m, *di;
  void *o1, *o2;  // dK, dV (K2) or dQ (K3)
  int64_t b, t, h, d;
  Strides st;
  int causal;
  float scale;
  const int64_t* maps;  // bf16: the q, k, v, dO tensor-map layouts
};

// K2 or K3, float32
template <int D>
int launch_fma(bool dkv, const Args& a, cudaStream_t stream) {
  static bool configured[2] = {false, false};
  constexpr size_t smem = FmaLayout<D>::bytes;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d_o = static_cast<const float*>(a.d_o);
  cudaError_t err;
  if (dkv) {
    err = configure(flash_bwd_dkv_fma_kernel<D>, smem, configured[0]);
    if (err != cudaSuccess) return err;
    const dim3 grid{unsigned((a.t + BK - 1) / BK), unsigned(a.h),
                    unsigned(a.b)};
    flash_bwd_dkv_fma_kernel<D><<<grid, FMA_THREADS, smem, stream>>>(
        q, k, v, d_o, a.l, a.m, a.di, static_cast<float*>(a.o1),
        static_cast<float*>(a.o2), int(a.t), int(a.h), a.st, a.causal,
        a.scale, int(a.d));
  } else {
    err = configure(flash_bwd_dq_fma_kernel<D>, smem, configured[1]);
    if (err != cudaSuccess) return err;
    const dim3 grid{unsigned((a.t + BQ - 1) / BQ), unsigned(a.h),
                    unsigned(a.b)};
    flash_bwd_dq_fma_kernel<D><<<grid, FMA_THREADS, smem, stream>>>(
        q, k, v, d_o, a.l, a.m, a.di, static_cast<float*>(a.o1), int(a.t),
        int(a.h), a.st, a.causal, a.scale, int(a.d));
  }
  return cudaGetLastError();
}

// The tensor maps of q, k, v, dO from their layouts, whose boxes must be
// the tiles of the instance of width D: rows_q query rows (q, dO) and
// rows_k keys (k, v)
template <int D>
int encode_operands(CUtensorMap (&maps)[4], const Args& a, int rows_q,
                    int rows_k) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.d_o};
  const int rows[4] = {rows_q, rows_k, rows_k, rows_q};
  for (int i = 0; i < 4; ++i) {
    const int64_t* layout = a.maps + i * LAYOUT_LEN;
    if (!layout_matches(layout, a.d, D, rows[i]))
      return cudaErrorInvalidValue;
    const int rc = encode_map(&maps[i], ptrs[i], layout);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int D>
int launch_dq_tma(const Args& a, cudaStream_t stream) {
  using L = DqTma<D>;
  static bool configured = false;
  CUtensorMap maps[4];
  const int rc = encode_operands<D>(maps, a, L::BM, L::BN);
  if (rc != 0) return rc;
  const cudaError_t err =
      configure(flash_bwd_dq_tma_kernel<D>, L::bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned(a.h), unsigned(a.b),
                  unsigned((a.t + L::BM - 1) / L::BM)};
  flash_bwd_dq_tma_kernel<D><<<grid, L::THREADS, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.l, a.m, a.di,
      static_cast<bf16*>(a.o1), int(a.t), int(a.h), a.st.o1[0], a.st.o1[1],
      a.st.o1[2], a.causal, a.scale, int(a.d));
  return cudaGetLastError();
}

template <int D>
int launch_dkv_tma(const Args& a, cudaStream_t stream) {
  using L = DkvTma<D>;
  static bool configured = false;
  CUtensorMap maps[4];
  const int rc = encode_operands<D>(maps, a, L::BM, L::BN);
  if (rc != 0) return rc;
  auto kernel = [] {
    if constexpr (L::SPLIT)
      return flash_bwd_dkv_split_kernel<D>;
    else
      return flash_bwd_dkv_tma_kernel<D>;
  }();
  const cudaError_t err = configure(kernel, L::bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned(a.h), unsigned(a.b),
                  unsigned((a.t + L::BN - 1) / L::BN)};
  kernel<<<grid, DKV_THREADS, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.l, a.m, a.di,
      static_cast<bf16*>(a.o1), static_cast<bf16*>(a.o2), int(a.t),
      int(a.h), a.st, a.causal, a.scale, int(a.d));
  return cudaGetLastError();
}

template <int D>
int launch_d(bool dkv, int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1 && a.maps != nullptr)
    return dkv ? launch_dkv_tma<D>(a, stream) : launch_dq_tma<D>(a, stream);
  if (dtype == 0) return launch_fma<D>(dkv, a, stream);
  return cudaErrorInvalidValue;
}

int launch(bool dkv, int dtype, const Args& a, void* stream) {
  if (a.t <= 0 || a.b <= 0 || a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel_width(a.d)) {
    case 32:
      return launch_d<32>(dkv, dtype, a, s);
    case 64:
      return launch_d<64>(dkv, dtype, a, s);
    case 128:
      return launch_d<128>(dkv, dtype, a, s);
    case 256:
      return launch_d<256>(dkv, dtype, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, dO, dK, dV: [B, T, H, D] with unit stride on D, D a multiple
// of 8 from 8 to 256 (it runs on the instance of the next width of 32,
// 64, 128, 256); strides in elements, (b, t, h) for q, k, v, dO, dK, dV
// in that order. l, m, di: [B, H, T] f32, contiguous. dtype: 0 =
// float32, 1 = bfloat16. bfloat16 operands are read through TMA: `maps`
// holds the q, k, v, dO layouts (4 x 12 int64, from
// ops/flash_attention.py:tma_layout, whose box rows must be this
// kernel's tiles at its width); float32 takes maps = NULL. Returns 0
// when launched, else the CUDA error of the launch or ENCODE_ERROR +
// cuTensorMapEncodeTiled's CUresult.
int veles_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* d_o, const void* l, const void* m,
                        const void* di, void* dk, void* dv, int64_t b,
                        int64_t t, int64_t h, int64_t d, int64_t qsb,
                        int64_t qst, int64_t qsh, int64_t ksb, int64_t kst,
                        int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
                        int64_t osb, int64_t ost, int64_t osh, int64_t dksb,
                        int64_t dkst, int64_t dksh, int64_t dvsb,
                        int64_t dvst, int64_t dvsh, int causal, float scale,
                        int dtype, const int64_t* maps, void* stream) {
  const Args a{q, k, v, d_o,
               static_cast<const float*>(l), static_cast<const float*>(m),
               static_cast<const float*>(di), dk, dv, b, t, h, d,
               Strides{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                       {osb, ost, osh}, {dksb, dkst, dksh},
                       {dvsb, dvst, dvsh}},
               causal, scale, maps};
  return launch(true, dtype, a, stream);
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
                       const int64_t* maps, void* stream) {
  const Args a{q, k, v, d_o,
               static_cast<const float*>(l), static_cast<const float*>(m),
               static_cast<const float*>(di), dq, nullptr, b, t, h, d,
               Strides{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                       {osb, ost, osh}, {dqsb, dqst, dqsh}, {0, 0, 0}},
               causal, scale, maps};
  return launch(false, dtype, a, stream);
}

// Dynamic shared memory of the bf16 dK/dV and dQ kernels at head dim d
// (their instance's width's; bytes, 0 for an unsupported d): ptxas
// reports static shared memory only.
int64_t veles_flash_bwd_dkv_smem(int64_t d) {
  switch (kernel_width(d)) {
    case 32:
      return DkvTma<32>::bytes;
    case 64:
      return DkvTma<64>::bytes;
    case 128:
      return DkvTma<128>::bytes;
    case 256:
      return DkvTma<256>::bytes;
    default:
      return 0;
  }
}

int64_t veles_flash_bwd_dq_smem(int64_t d) {
  switch (kernel_width(d)) {
    case 32:
      return DqTma<32>::bytes;
    case 64:
      return DqTma<64>::bytes;
    case 128:
      return DqTma<128>::bytes;
    case 256:
      return DqTma<256>::bytes;
    default:
      return 0;
  }
}

const char* veles_error_string(int code) { return error_string(code); }

}  // extern "C"
