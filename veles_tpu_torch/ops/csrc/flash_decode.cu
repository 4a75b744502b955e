// Single-query flash decode for Hopper, sm_90a, in two forms that share
// one loop: over a contiguous KV slab (K4) and through a block table
// over a shared page pool (K5).
//
// K4 replaces the TPU kernel veles_tpu/ops/flash_attention.py:
// _decode_kernel, launched by _pallas_decode: one new query per
// sequence, q [B, H, D], attends over k/v caches [B, S, H, D] up to
// its own length lengths[b] (which includes the new token); keys past
// the length are never read, and a length-0 row returns zeros.
//
// K5 replaces _paged_decode_kernel, launched by _pallas_paged_decode:
// the same attention, but sequence b's cache is the ordered page list
// block_tables[b, :n_blk] into one pool [P, ps, H, D] shared by every
// sequence. Key j of sequence b sits in page block_tables[b, j / ps] at
// offset j % ps. The two kernels differ only in that address, so the
// loop below takes it as a template parameter (SlabRows, PagedRows) and
// both entries run the same instructions in the same order: on the same
// K/V laid out both ways they agree bitwise.
//
// What bounds them on this card: bytes. Every live cached key and value
// is read once and used for 2 FLOPs per element, so a step over eight
// sequences of up to 2048 tokens at D = 128 moves ~30 MB of K+V per
// layer and the 3.35 TB/s of HBM is the ceiling.
//
// What this design does about it: one block of 256 threads per (head,
// sequence). The block splits into groups of D/4 lanes; each lane
// owns four contiguous dims, so one group reads a whole key (and
// value) row with one coalesced 8- or 16-byte load per lane, and each
// group keeps U rows in flight. Each group runs its own online
// softmax (running m, l and its four-dim slice of the accumulator in
// f32 registers) over an interleaved subset of the keys, with no
// block-wide barrier inside the loop; the groups' partial states are
// merged once, in shared memory, at the end. The loop stops at the
// sequence's length, so the cost tracks the live cache, not the
// capacity. K5 first stages the sequence's block-table row in shared
// memory (n_blk ints: 128 at a 2048-token capacity and 16-token pages)
// with every id clamped to [0, P-1], as the reference's page_map
// clamps: a sentinel id (P, unallocated) never forms an address outside
// the pool, even where a length reaches into a sentinel block. Left for
// later: one block per (head, sequence) fills only B*H SMs (64 of 132
// at 8 slots x 8 heads); a split over the key axis (flash-decoding)
// and a second merge pass would fill the card.
//
// Numerics mirror the plain PyTorch versions (ops/flash_attention.py):
// f32 scores and statistics, p rounded to the cache dtype before the
// P.V product, the output divided by l at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int VEC = 4;   // contiguous dims per lane
constexpr int U = 8;     // key rows per group per round

__device__ inline void load4(const float* p, float out[VEC]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ inline void load4(const __nv_bfloat16* p, float out[VEC]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 c = __bfloat1622float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = c.x;
  out[3] = c.y;
}

__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Key and value rows of a contiguous slab: row j of sequence b starts at
// b * sb + j * st (elements; the head and the lane's dims are added by
// the kernel).
struct SlabRows {
  int64_t ksb, kst, vsb, vst;
  int cap;  // slab length S

  struct Bound {
    int64_t kb, kst, vb, vst;
    __device__ int64_t k(int j) const { return kb + j * kst; }
    __device__ int64_t v(int j) const { return vb + j * vst; }
  };
  static size_t smem_bytes(int) { return 0; }
  __device__ Bound bind(int b, int*) const {
    return Bound{b * ksb, kst, b * vsb, vst};
  }
};

// Key and value rows through a block table: row j of sequence b starts
// at table[b][j >> ps_log2] * sp + (j & (ps - 1)) * st. bind() stages
// the sequence's table row in shared memory, each id clamped to the
// pool, before any address is formed.
struct PagedRows {
  const int* tables;
  int64_t tsb;  // table row stride (elements)
  int n_blk, n_pages, ps_log2;
  int64_t ksp, kst, vsp, vst;
  int cap;  // n_blk * page size

  struct Bound {
    const int* tbl;
    int ps_log2, ps_mask;
    int64_t ksp, kst, vsp, vst;
    __device__ int64_t k(int j) const {
      return int64_t(tbl[j >> ps_log2]) * ksp + (j & ps_mask) * kst;
    }
    __device__ int64_t v(int j) const {
      return int64_t(tbl[j >> ps_log2]) * vsp + (j & ps_mask) * vst;
    }
  };
  static size_t smem_bytes(int n_blk) { return size_t(n_blk) * sizeof(int); }
  __device__ Bound bind(int b, int* smem) const {
    for (int i = threadIdx.x; i < n_blk; i += blockDim.x) {
      const int p = tables[b * tsb + i];
      smem[i] = p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
    }
    __syncthreads();
    return Bound{smem, ps_log2, (1 << ps_log2) - 1, ksp, kst, vsp, vst};
  }
};

template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ lengths,
    T* __restrict__ o, Rows rows, int64_t qsb, int64_t qsh, int64_t ksh,
    int64_t vsh, int64_t osb, int64_t osh, float scale) {
  constexpr int LPR = D / VEC;  // lanes per key row: 8, 16 or 32
  constexpr int G = NT / LPR;   // key groups per block

  __shared__ float g_m[G];
  __shared__ float g_l[G];
  __shared__ float g_acc[G][D];
  extern __shared__ int s_table[];  // PagedRows only

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % LPR;
  const int g = tid / LPR;
  const int d0 = lane * VEC;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > rows.cap ? rows.cap : len);
  const typename Rows::Bound at = rows.bind(b, s_table);

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = kc + h * ksh + d0;
  const T* vb = vc + h * vsh + d0;

  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] = to_f(qb[d0 + e]);

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};

  // every lane of a warp runs the same number of rounds, so the
  // shuffles below always see the full warp
  for (int r0 = 0; r0 < len; r0 += G * U) {
    const int base = r0 + g * U;
    float kf[U][VEC], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u;
      if (j < len) {
        load4(kb + at.k(j), kf[u]);
        load4(vb + at.v(j), vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float acc_d = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_d = fmaf(qv[e], kf[u][e], acc_d);
      sc[u] = acc_d;
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off, LPR);
    if (base < len) {  // uniform within the group
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = base + u < len ? sc[u] * scale : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);  // m = -inf -> 0
      l *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(sc[u] - m_new);  // masked: exp(-inf) = 0
        l += p;
        const float pr = round_to(p, q);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pr, vf[u][e], acc[e]);
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

  for (int d = tid; d < D; d += NT) {
    float mx = -INFINITY;
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, g_m[i]);
    float out = 0.f;
    if (mx != -INFINITY) {
      float lsum = 0.f, osum = 0.f;
      for (int i = 0; i < G; ++i) {
        if (g_l[i] == 0.f) continue;
        const float w = expf(g_m[i] - mx);
        lsum = fmaf(g_l[i], w, lsum);
        osum = fmaf(g_acc[i][d], w, osum);
      }
      out = osum * (1.f / lsum);
    }
    store(o + b * osb + h * osh + d, out);
  }
}

// st: q (sb, sh), k head stride, v head stride, o (sb, sh)
template <typename T, int D, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int64_t b, int64_t h,
                   const Rows& rows, size_t smem, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const dim3 grid{unsigned(h), unsigned(b)};
  flash_decode_kernel<T, D, Rows><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), rows, st[0],
      st[1], st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename Rows>
cudaError_t dispatch(int dtype, int64_t d, const void* q, const void* k,
                     const void* v, const int* lengths, void* o, int64_t b,
                     int64_t h, const Rows& rows, size_t smem,
                     const int64_t* st, float scale, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  if (b <= 0 || h <= 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return dtype == 0 ? launch<float, 32>(q, k, v, lengths, o, b, h, rows,
                                            smem, st, scale, stream)
                        : launch<bf16, 32>(q, k, v, lengths, o, b, h, rows,
                                           smem, st, scale, stream);
    case 64:
      return dtype == 0 ? launch<float, 64>(q, k, v, lengths, o, b, h, rows,
                                            smem, st, scale, stream)
                        : launch<bf16, 64>(q, k, v, lengths, o, b, h, rows,
                                           smem, st, scale, stream);
    case 128:
      return dtype == 0 ? launch<float, 128>(q, k, v, lengths, o, b, h, rows,
                                             smem, st, scale, stream)
                        : launch<bf16, 128>(q, k, v, lengths, o, b, h, rows,
                                            smem, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4. q: [B, H, D]; k, v: [B, S, H, D]; o: [B, H, D]; unit stride on D,
// other strides in elements and multiples of 4, base pointers 16-byte
// aligned. lengths: [B] int32 on the device. dtype: 0 = float32,
// 1 = bfloat16. Returns the CUDA error of the launch (0 = launched).
int veles_flash_decode(const void* q, const void* k, const void* v,
                       const void* lengths, void* o, int64_t b, int64_t s,
                       int64_t h, int64_t d, int64_t qsb, int64_t qsh,
                       int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                       int64_t vst, int64_t vsh, int64_t osb, int64_t osh,
                       float scale, int dtype, void* stream) {
  const SlabRows rows{ksb, kst, vsb, vst, int(s)};
  const int64_t st[6] = {qsb, qsh, ksh, vsh, osb, osh};
  return dispatch(dtype, d, q, k, v, static_cast<const int*>(lengths), o, b,
                  h, rows, SlabRows::smem_bytes(0), st, scale,
                  static_cast<cudaStream_t>(stream));
}

// K5. q: [B, H, D]; k, v pools: [P, ps, H, D] with ps = 1 << ps_log2;
// tables: [B, n_blk] int32 page ids (row stride tsb; ids outside
// [0, P) are clamped to the pool); lengths: [B] int32, clamped to
// n_blk * ps; o: [B, H, D]. Strides and alignment as K4's. Returns the
// CUDA error of the launch (0 = launched).
int veles_flash_decode_paged(const void* q, const void* k, const void* v,
                             const void* tables, const void* lengths,
                             void* o, int64_t b, int64_t p, int64_t ps_log2,
                             int64_t n_blk, int64_t h, int64_t d, int64_t qsb,
                             int64_t qsh, int64_t tsb, int64_t ksp,
                             int64_t kst, int64_t ksh, int64_t vsp,
                             int64_t vst, int64_t vsh, int64_t osb,
                             int64_t osh, float scale, int dtype,
                             void* stream) {
  if (p <= 0 || n_blk <= 0 || ps_log2 < 0 || ps_log2 > 20)
    return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(tables), tsb, int(n_blk),
                       int(p), int(ps_log2), ksp, kst, vsp, vst,
                       int(n_blk << ps_log2)};
  const int64_t st[6] = {qsb, qsh, ksh, vsh, osb, osh};
  return dispatch(dtype, d, q, k, v, static_cast<const int*>(lengths), o, b,
                  h, rows, PagedRows::smem_bytes(int(n_blk)), st, scale,
                  static_cast<cudaStream_t>(stream));
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
