// Single-query flash decode for Hopper, sm_90a, in two forms that share
// one kernel: over a contiguous KV slab (K4) and through a block table
// over a shared page pool (K5).
//
// K4 replaces the TPU kernel veles_tpu/ops/flash_attention.py:
// _decode_kernel, launched by _pallas_decode: one new query per
// sequence, q [B, H, D], attends over k/v caches [B, S, H, D] up to
// its own length lengths[b] (which includes the new token); keys past
// the length are never used, and a length-0 row returns zeros.
//
// K5 replaces _paged_decode_kernel, launched by _pallas_paged_decode:
// the same attention, but sequence b's cache is the ordered page list
// block_tables[b, :n_blk] into one pool [P, ps, H, D] shared by every
// sequence. Key j of sequence b sits in page block_tables[b, j / ps] at
// offset j % ps.
//
// What bounds them on this card: bytes. Every live cached key and value
// is read once and used for 2 FLOPs per element, so a step over eight
// sequences of up to 2048 tokens at D = 128 moves ~30 MB of K+V per
// layer and the 3.35 TB/s of HBM is the ceiling.
//
// What this design does about it (flash-decoding):
//
// - The key axis splits into fixed chunks of CHUNK keys counted from
//   key 0, one block of NT threads per (chunk, head, sequence). The grid
//   follows the capacity (S, or n_blk * ps), so it depends on shapes
//   only; a block whose chunk starts at or past the sequence's length
//   writes an empty partial (l = 0) and exits. At eight sequences of
//   lengths up to 2048 and eight heads that is ~490 live blocks on 132
//   SMs, where one block per (head, sequence) gave 64.
// - The block splits into G groups of D / VEC lanes, each lane owning
//   16 bytes of a row. A stage is U rows per group (rows u * G + g of
//   the stage for group g); each lane loads its 16 bytes of the stage's
//   K and V rows straight from global memory into registers, and the
//   loads of stage k + 1 are issued before stage k is computed, so 2 x
//   2 x U 16-byte loads a lane are in flight, with no shared-memory
//   staging, no barrier in the loop and no tensor map. Rows at or past
//   the length are not read.
// - Each group runs its own online softmax (f32 scores and statistics,
//   p rounded to the cache dtype before P.V, as the plain path does).
//   The groups' states merge in shared memory in group order and the
//   block writes its partial (o unnormalised, m, l) to an f32 workspace
//   [B, H, n_chunks, D + 2].
// - A second kernel, launched by the same C entry, merges the partials
//   of each (head, sequence) in ascending chunk order with the plain
//   path's flash_block_update formula, skipping empty partials, and
//   writes o / l. No atomics: two launches agree bitwise.
//
// K4 and K5 differ only in a row's address (the Rows template
// parameter, SlabRows or PagedRows): the same chunks, stages, groups and
// merge order, so on the same K/V they agree bitwise, whatever their
// capacities. K5 first stages the chunk's slice of the sequence's
// block-table row in shared memory with every id clamped to [0, P-1],
// as the reference's page_map clamps: a sentinel id (P, unallocated)
// never forms an address outside the pool, even where a length reaches
// into a sentinel block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;     // threads per block
constexpr int CHUNK = 128;  // keys per block
constexpr int U = 4;        // rows per group per stage

// 16 bytes of a row: 4 floats or 8 bf16, loaded raw and widened to f32
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& x, float (&out)[4]) {
    out[0] = __uint_as_float(x.x);
    out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z);
    out[3] = __uint_as_float(x.w);
  }
};

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& x, float (&out)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ inline uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ inline int clamp_len(int len, int cap) {
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// The element strides of one cache operand: (sequence or page, row,
// head); the head dim is at unit stride.
struct Strides {
  int64_t outer, row, head;
};

// Rows of a contiguous slab [B, S, H, D]: row j of head h of sequence b
// starts at b * outer + j * row + h * head.
struct SlabRows {
  int cap;  // slab length S

  __device__ void bind(int, int, int*) const {}
  __device__ int64_t at(const Strides& st, int b, int h, int j, int,
                        const int*) const {
    return b * st.outer + j * st.row + h * st.head;
  }
};

// Rows through a block table, over a pool [P, ps, H, D]: key row j of
// sequence b is row j & (ps - 1) of page table[b][j >> ps_log2]. bind()
// stages the chunk's slice of the table row in shared memory, each id
// clamped to the pool, before any address is formed.
struct PagedRows {
  const int* tables;
  int64_t tsb;  // table row stride (elements)
  int n_blk, n_pages, ps_log2;
  int cap;  // n_blk * ps

  __device__ void bind(int b, int row0, int* tbl) const {
    const int first = row0 >> ps_log2;
    int n = CHUNK >> ps_log2;
    n = n < 1 ? 1 : n;
    n = n > n_blk - first ? n_blk - first : n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = tables[int64_t(b) * tsb + first + i];
      tbl[i] = p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
    }
    __syncthreads();
  }
  // rel: the row's offset in its chunk (the chunk starts on a page or
  // inside one)
  __device__ int64_t at(const Strides& st, int, int h, int j, int rel,
                        const int* tbl) const {
    return int64_t(tbl[rel >> ps_log2]) * st.outer +
           (j & ((1 << ps_log2) - 1)) * st.row + h * st.head;
  }
};

// At least one block an SM: without that bound ptxas held the D = 64
// slab instances to 128 (bf16) and 96 (f32) registers and spilled.
template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(NT, 1) flash_decode_split_kernel(
    const T* __restrict__ k, const T* __restrict__ v, Strides ks,
    Strides vs, const T* __restrict__ q, const int* __restrict__ lengths,
    float* __restrict__ part, Rows rows, int64_t qsb, int64_t qsh,
    float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = D / VEC;          // lanes per key row
  constexpr int G = NT / LPR;           // key groups per block
  constexpr int STAGE = U * G;          // rows per stage
  constexpr int STAGES = CHUNK / STAGE;  // stages per chunk
  static_assert(NT % LPR == 0 && CHUNK % STAGE == 0, "row split");

  __shared__ float g_m[G];
  __shared__ float g_l[G];
  __shared__ float g_acc[G][D];
  __shared__ int tbl[CHUNK];

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % LPR;
  const int g = tid / LPR;
  const int d0 = lane * VEC;
  float* out =
      part + ((int64_t(b) * gridDim.y + h) * gridDim.x + c) * (D + 2);

  const int len = clamp_len(lengths[b], rows.cap);
  const int row0 = c * CHUNK;
  if (row0 >= len) {  // an empty partial, skipped by the merge
    if (tid == 0) {
      out[D] = -INFINITY;
      out[D + 1] = 0.f;
    }
    return;
  }
  const int live = len - row0 < CHUNK ? len - row0 : CHUNK;
  const int n_stages = (live + STAGE - 1) / STAGE;
  rows.bind(b, row0, tbl);

  // stage i's K and V for this lane (zeros for rows at or past the
  // length, which are never read)
  auto fetch = [&](int i, uint4 (&kr)[U], uint4 (&vr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rel = i * STAGE + u * G + g;
      const int j = row0 + rel;
      if (j < len) {
        kr[u] = load16(k + rows.at(ks, b, h, j, rel, tbl) + d0);
        vr[u] = load16(v + rows.at(vs, b, h, j, rel, tbl) + d0);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  uint4 kbuf[2][U], vbuf[2][U];
  fetch(0, kbuf[0], vbuf[0]);

  const T* qb = q + b * qsb + h * qsh + d0;
  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] = to_f(qb[e]);

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // every lane of a warp runs every stage, so the shuffles below always
  // see the full warp; unrolled, so the double buffer stays in registers
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i >= n_stages) continue;
    if (i + 1 < STAGES && i + 1 < n_stages)
      fetch(i + 1, kbuf[(i + 1) & 1], vbuf[(i + 1) & 1]);
    const uint4(&kr)[U] = kbuf[i & 1];
    const uint4(&vr)[U] = vbuf[i & 1];
    const int srow = row0 + i * STAGE;
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      Vec<T>::widen(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kf[e], dot);
      sc[u] = dot;
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o, LPR);
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] = srow + u * G + g < len ? sc[u] * scale : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx != -INFINITY) {  // uniform within the group
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);  // m = -inf -> 0
      l *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (srow + u * G + g >= len) continue;  // rows past the length
        const float p = expf(sc[u] - m_new);
        l += p;
        const float pr = round_to(p, q);
        float vf[VEC];
        Vec<T>::widen(vr[u], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
      }
      m = m_new;
    }
  }

#pragma unroll
  for (int e = 0; e < VEC; ++e) g_acc[g][d0 + e] = acc[e];
  if (lane == 0) {
    g_m[g] = m;
    g_l[g] = l;
  }
  __syncthreads();

  // the groups' states in group order, as flash_block_update merges
  if (tid < D) {
    float mm = -INFINITY, ll = 0.f, oo = 0.f;
    for (int i = 0; i < G; ++i) {
      if (g_l[i] == 0.f) continue;
      const float m_new = fmaxf(mm, g_m[i]);
      const float a = expf(mm - m_new);
      const float w = expf(g_m[i] - m_new);
      ll = ll * a + g_l[i] * w;
      oo = oo * a + g_acc[i][tid] * w;
      mm = m_new;
    }
    out[tid] = oo;
    if (tid == 0) {
      out[D] = mm;
      out[D + 1] = ll;
    }
  }
}

// The partials of one (head, sequence) in ascending chunk order (empty
// ones skipped), then o / l; a length-0 row writes zeros. Each thread
// loads TILE partials' (m, l, o[d]) at once, so the loads overlap
// instead of waiting one after another.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_decode_merge_kernel(
    const float* __restrict__ part, const int* __restrict__ lengths,
    int cap, int n_chunks, T* __restrict__ o, int64_t osb, int64_t osh) {
  constexpr int TILE = 16;  // partials loaded together
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int n_live = (clamp_len(lengths[b], cap) + CHUNK - 1) / CHUNK;
  const float* p = part + (int64_t(b) * gridDim.x + h) * n_chunks * (D + 2);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += TILE, p += TILE * (D + 2)) {
    float pm[TILE], pl[TILE], po[TILE];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const bool in = c0 + i < n_live;
      pl[i] = in ? p[i * (D + 2) + D + 1] : 0.f;
      pm[i] = in ? p[i * (D + 2) + D] : 0.f;
      po[i] = in ? p[i * (D + 2) + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (pl[i] == 0.f) continue;
      const float m_new = fmaxf(m, pm[i]);
      const float a = expf(m - m_new);
      const float w = expf(pm[i] - m_new);
      l = l * a + pl[i] * w;
      acc = acc * a + po[i] * w;
      m = m_new;
    }
  }
  store(o + b * osb + h * osh + d, l > 0.f ? acc / l : 0.f);
}

// q, o: (sb, sh) element strides
template <typename T, int D, typename Rows>
cudaError_t launch(const void* k, const void* v, const Strides& ks,
                   const Strides& vs, const void* q, const int* lengths,
                   void* o, float* part, int64_t b, int64_t h,
                   const Rows& rows, const int64_t* qst, const int64_t* ost,
                   float scale, cudaStream_t stream) {
  const int n_chunks = (rows.cap + CHUNK - 1) / CHUNK;
  const dim3 grid{unsigned(n_chunks), unsigned(h), unsigned(b)};
  flash_decode_split_kernel<T, D, Rows><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), ks, vs,
      static_cast<const T*>(q), lengths, part, rows, qst[0], qst[1], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T, D>
      <<<dim3{unsigned(h), unsigned(b)}, D, 0, stream>>>(
          part, lengths, rows.cap, n_chunks, static_cast<T*>(o), ost[0],
          ost[1]);
  return cudaGetLastError();
}

// a cache operand the kernel reads 16 bytes at a time: a 16-byte
// aligned base, every stride a multiple of 16 bytes
bool aligned16(const void* p, const Strides& st, int64_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         st.outer * elem % 16 == 0 && st.row * elem % 16 == 0 &&
         st.head * elem % 16 == 0;
}

template <typename Rows>
int dispatch(int dtype, int64_t d, const void* k, const void* v,
             const Strides& ks, const Strides& vs, const void* q,
             const void* lengths, void* o, void* part, int64_t b, int64_t h,
             const Rows& rows, int64_t chunk, const int64_t* qst,
             const int64_t* ost, float scale, void* stream) {
  if (b <= 0 || h <= 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int64_t elem = dtype == 0 ? 4 : 2;
  if (chunk != CHUNK || rows.cap < 1 || !aligned16(k, ks, elem) ||
      !aligned16(v, vs, elem))
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VELES_DECODE_CASE(D)                                                \
  case D:                                                                   \
    return dtype == 0 ? launch<float, D>(k, v, ks, vs, q, len, o, ws, b, h, \
                                         rows, qst, ost, scale, s)          \
                      : launch<bf16, D>(k, v, ks, vs, q, len, o, ws, b, h,  \
                                        rows, qst, ost, scale, s);
  switch (d) {
    VELES_DECODE_CASE(32)
    VELES_DECODE_CASE(64)
    VELES_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef VELES_DECODE_CASE
}

}  // namespace

extern "C" {

// K4. k, v: [B, S, H, D] with element strides (k_sb, k_ss, k_sh) and
// (v_sb, v_ss, v_sh), unit stride on D, 16-byte aligned bases and
// strides; q: [B, H, D]; o: [B, H, D]; part: f32 workspace [B, H,
// ceil(S / chunk), D + 2]. lengths: [B] int32 on the device, clamped to
// [0, S]. chunk must be CHUNK. dtype: 0 = float32, 1 = bfloat16.
// Launches the split and the merge kernel; returns the CUDA error of
// the launches (0 = launched).
int veles_flash_decode(const void* k, const void* v, const void* q,
                       const void* lengths, void* o, void* part, int64_t b,
                       int64_t s, int64_t h, int64_t d, int64_t k_sb,
                       int64_t k_ss, int64_t k_sh, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh, int64_t qsb, int64_t qsh,
                       int64_t osb, int64_t osh, int64_t chunk, float scale,
                       int dtype, void* stream) {
  if (s < 1 || s > INT32_MAX) return cudaErrorInvalidValue;
  const SlabRows rows{int(s)};
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int64_t qst[2] = {qsb, qsh}, ost[2] = {osb, osh};
  return dispatch(dtype, d, k, v, ks, vs, q, lengths, o, part, b, h, rows,
                  chunk, qst, ost, scale, stream);
}

// K5. k, v: pools [P, ps, H, D] with ps = 1 << ps_log2, element strides
// (page, row, head) and alignment as K4's caches; tables: [B, n_blk]
// int32 page ids (row stride tsb; ids outside [0, P) are clamped to the
// pool); lengths: [B] int32, clamped to [0, n_blk * ps]; part: f32
// workspace [B, H, ceil(n_blk * ps / chunk), D + 2]; the rest as K4's.
int veles_flash_decode_paged(const void* k, const void* v, const void* q,
                             const void* tables, const void* lengths,
                             void* o, void* part, int64_t b, int64_t p,
                             int64_t ps_log2, int64_t n_blk, int64_t h,
                             int64_t d, int64_t k_sp, int64_t k_ss,
                             int64_t k_sh, int64_t v_sp, int64_t v_ss,
                             int64_t v_sh, int64_t qsb, int64_t qsh,
                             int64_t tsb, int64_t osb, int64_t osh,
                             int64_t chunk, float scale, int dtype,
                             void* stream) {
  if (p <= 0 || n_blk <= 0 || ps_log2 < 0 || ps_log2 > 30 ||
      n_blk > (int64_t(INT32_MAX) >> ps_log2))
    return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(tables), tsb, int(n_blk),
                       int(p), int(ps_log2), int(n_blk << ps_log2)};
  const Strides ks{k_sp, k_ss, k_sh}, vs{v_sp, v_ss, v_sh};
  const int64_t qst[2] = {qsb, qsh}, ost[2] = {osb, osh};
  return dispatch(dtype, d, k, v, ks, vs, q, lengths, o, part, b, h, rows,
                  chunk, qst, ost, scale, stream);
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
