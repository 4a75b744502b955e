// Cross-channel local response normalization for Hopper, sm_90a: the
// forward (K6) and the backward (K7), Caffe's formula
//
//   u = k + (alpha / n) * sum_{d=-lo..hi} x[c + d]^2,  y = x * u^-beta,
//   lo = (n - 1) / 2, hi = n - 1 - lo,
//
// over rows of C contiguous channels (the NHWC layout of the conv
// output: rows are the B*H*W positions).
//
// K6 replaces the TPU kernel veles_tpu/ops/lrn_pallas.py:_fwd_kernel
// (launched by lrn_fwd), K7 replaces _bwd_kernel (launched by lrn_bwd):
//
//   dx = dy t - 2 (alpha/n) beta x sum_{d=-hi..lo} inner[c + d],
//   t = u^-beta, inner = dy x t / u rounded to x's dtype,
//
// with the window sums recomputed from x (only x is saved for the
// backward). The arithmetic is the Pallas kernels' step for step: x^2
// rounded to x's dtype, window sums in f32 term by term from the
// window's low end, u, the products and the result's rounding as the
// plain PyTorch versions do them (ops/lrn.py: _plain_fwd, _plain_bwd),
// with round-to-nearest intrinsics so no fused multiply-add changes a
// bit. The window sums are bitwise the plain versions'. The power alone
// differs: t = 2^(-beta log2 u) and t / u = 2^((-beta - 1) log2 u), one
// base-2 logarithm and one or two base-2 exponentials on the
// special-function unit, where the plain versions call pow and divide:
// a few f32 ulps of t (at most 2e-7 of the output's scale in f32, on
// the card at AlexNet's shapes).
//
// What bounds them on this card: bytes, and in bf16 instruction issue
// nearly as much. K6 reads x once and writes y once, K7 reads x and dy
// once and writes dx once; AlexNet's LRN1 at batch 1536 in bf16 moves
// 1.78 GB forward (0.53 ms at 3.35 TB/s) and 2.68 GB backward (0.80
// ms). At bf16 those times leave ~35 (K6) and ~53 (K7) issue slots an
// element. The first port of these kernels staged tiles in shared
// memory as f32, squared every term of every window again and called
// powf per element: it took the same time in f32 as in bf16, 5-8x its
// bound, bound by instructions, not bytes (PERF.md).
//
// What this design does about it: the [M, C] tensor is one stream of
// V-element vectors in (row, channel) order, 16 bytes a lane where the
// pointers, the row strides and C allow (V chosen by the host,
// ops/lrn.py:lrn_plan; 8, 4 or 2 bytes or one element otherwise). A
// warp walks its own run of 32-vector chunks of that stream, so rows of
// any width pack the lanes with none idle, and keeps the next two
// chunks' loads in flight in registers while it computes the current
// one (nothing goes through shared memory, no block synchronizes). Each
// lane squares its own channels once; the lo channels below and hi
// above that its windows need come from the lanes below and above by
// one warp shuffle per 32-bit word (a bf16 word holds two squares),
// from the chunk before or after for the warp's edge lanes; a channel
// of another row counts as zero, as the Pallas boundary masks make it.
// K7 forms u, t and inner once per element, rounds inner to x's dtype,
// then takes the transposed window's halo of inner by shuffles too, one
// chunk behind, so nothing is recomputed. The power takes the special-
// function unit's base-2 approximations without the library's handling
// of subnormals (lg2, ex2 below): in bf16 that handling cost K6 and K7
// about a third of their time. Windows up to NMAX are template
// parameters (the sums unrolled in registers); a wider window takes a
// simple kernel that reads its terms from global memory. No atomics: a
// second launch is bitwise equal, and nothing is decided on the host
// per call but the grid, so the launches can be captured.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// widest window of the lane kernels; a wider one takes the wide kernels
constexpr int NMAX = 11;
// chunks a warp's loads run ahead of the chunk it computes
constexpr int FWD_AHEAD = 2;
constexpr int BWD_AHEAD = 2;

// one lane's V elements as raw bits: 16, 8, 4 or 2 bytes
template <int BYTES> struct Raw;
template <> struct Raw<16> { typedef uint4 type; };
template <> struct Raw<8> { typedef uint2 type; };
template <> struct Raw<4> { typedef unsigned int type; };
template <> struct Raw<2> { typedef unsigned short type; };

__device__ inline void to_words(uint4 r, uint32_t* w) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ inline void to_words(uint2 r, uint32_t* w) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ inline void to_words(unsigned int r, uint32_t* w) { w[0] = r; }
__device__ inline void to_words(unsigned short r, uint32_t* w) { w[0] = r; }
__device__ inline void from_words(const uint32_t* w, uint4* r) {
  *r = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ inline void from_words(const uint32_t* w, uint2* r) {
  *r = make_uint2(w[0], w[1]);
}
__device__ inline void from_words(const uint32_t* w, unsigned int* r) {
  *r = w[0];
}
__device__ inline void from_words(const uint32_t* w, unsigned short* r) {
  *r = static_cast<unsigned short>(w[0]);
}

// V elements of T held as 32-bit words: an f32 a word, two bf16 a word
// (element 2i in the low half)
template <typename T, int V>
struct Lane {
  static constexpr int PER_WORD = sizeof(T) == 2 ? 2 : 1;
  static constexpr int NW = (V + PER_WORD - 1) / PER_WORD;
  typedef typename Raw<V * sizeof(T)>::type R;

  __device__ static float get(const uint32_t* w, int i) {
    if (PER_WORD == 1) return __uint_as_float(w[i]);
    const uint32_t word = w[i / 2];
    return __uint_as_float(i % 2 ? word & 0xffff0000u : word << 16);
  }
  // f[0 .. V) rounded to T into words
  __device__ static void put(const float* f, uint32_t* w) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (PER_WORD == 1) {
        w[i] = __float_as_uint(f[i]);
      } else if (2 * i + 1 < V) {
        const __nv_bfloat162 b =
            __float22bfloat162_rn(make_float2(f[2 * i], f[2 * i + 1]));
        w[i] = uint32_t(__bfloat16_as_ushort(b.x)) |
               (uint32_t(__bfloat16_as_ushort(b.y)) << 16);
      } else {
        w[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      }
    }
  }
  __device__ static void load(const T* p, bool ok, uint32_t* w) {
    R r = R();
    if (ok) r = __ldg(reinterpret_cast<const R*>(p));
    to_words(r, w);
  }
  __device__ static void store(T* p, const uint32_t* w) {
    R r;
    from_words(w, &r);
    *reinterpret_cast<R*>(p) = r;
  }
  // x^2 of the lane's elements, rounded to T, as words
  __device__ static void square(const uint32_t* x, uint32_t* s) {
    float f[V];
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __fmul_rn(get(x, i), get(x, i));
    put(f, s);
  }
};

// A lane's place in the stream of vectors: row, and vector column in
// the row (nv vectors a row). Stepping by one chunk adds 32 vectors.
struct Pos {
  int64_t row;
  int col;
  __device__ void init(int64_t s, int nv) {
    row = s >= 0 ? s / nv : -((-s + nv - 1) / nv);
    col = int(s - row * nv);
  }
  __device__ void step(int q32, int r32, int nv) {
    col += r32;
    row += q32;
    if (col >= nv) {
      col -= nv;
      ++row;
    }
  }
  __device__ bool in(int64_t m) const { return row >= 0 && row < m; }
};

// The B channels below a lane's first (out[B - q] = channel -q), from
// the lanes ceil(q / V) below: of the chunk `cur`, or for the warp's
// first lanes of the chunk before, `prev`; zero where that lane holds
// another row (col < distance). One shuffle per word: the source lane
// picks which chunk the reader wants.
template <typename T, int V, int B>
__device__ inline void halo_below(const uint32_t* prev, const uint32_t* cur,
                                  int lane, int col, float* out) {
  typedef Lane<T, V> L;
  constexpr int D = (B + V - 1) / V;  // lanes reached
#pragma unroll
  for (int d = 1; d <= D; ++d) {
    uint32_t got[L::NW];
#pragma unroll
    for (int w = 0; w < L::NW; ++w) {
      // words holding an element r >= d V - B are needed
      if ((w + 1) * L::PER_WORD - 1 >= d * V - B)
        got[w] = __shfl_sync(FULL, lane < 32 - d ? cur[w] : prev[w],
                             (lane - d) & 31);
    }
#pragma unroll
    for (int q = 1; q <= B; ++q) {
      if ((q + V - 1) / V == d)
        out[B - q] = col >= d ? L::get(got, d * V - q) : 0.f;
    }
  }
}

// The B channels above a lane's last (out[q - 1] = channel V - 1 + q),
// from the lanes above: of `cur`, or for the warp's last lanes of the
// chunk after, `next`; zero past the row's end.
template <typename T, int V, int B>
__device__ inline void halo_above(const uint32_t* cur, const uint32_t* next,
                                  int lane, int col, int nv, float* out) {
  typedef Lane<T, V> L;
  constexpr int D = (B + V - 1) / V;
#pragma unroll
  for (int d = 1; d <= D; ++d) {
    uint32_t got[L::NW];
#pragma unroll
    for (int w = 0; w < L::NW; ++w) {
      // words holding an element r <= B - 1 - (d - 1) V are needed
      if (w * L::PER_WORD <= B - 1 - (d - 1) * V)
        got[w] = __shfl_sync(FULL, lane >= d ? cur[w] : next[w],
                             (lane + d) & 31);
    }
#pragma unroll
    for (int q = 1; q <= B; ++q) {
      if ((V - 1 + q) / V == d)
        out[q - 1] = col + d < nv ? L::get(got, V - 1 + q - d * V) : 0.f;
    }
  }
}

// Window sums of N terms over [below (B) | own (V) | above (N - 1 - B)],
// each from its window's low end, as the plain versions add them.
template <int N, int V, int B>
__device__ inline void window(const float* below, const float* own,
                              const float* above, float* sum) {
  float ext[B + V + N - 1 - B];
#pragma unroll
  for (int i = 0; i < B; ++i) ext[i] = below[i];
#pragma unroll
  for (int i = 0; i < V; ++i) ext[B + i] = own[i];
#pragma unroll
  for (int i = 0; i < N - 1 - B; ++i) ext[B + V + i] = above[i];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float acc = ext[e];
#pragma unroll
    for (int d = 1; d < N; ++d) acc = __fadd_rn(acc, ext[e + d]);
    sum[e] = acc;
  }
}

// log2(u) and 2^z on the special-function unit (MUFU), in their forms
// that flush subnormals: u >= k is a normal float, and t, t / u are
// normal for u < 2^(126 / (beta + 1)). CUDA's log2f and exp2f, which
// also handle subnormals, made the bf16 kernels ~1.4x slower (PERF.md).
__device__ inline float lg2(float u) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));
  return r;
}

__device__ inline float ex2(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

// u^e from log2(u)
__device__ inline float power(float log2u, float e) {
  return ex2(__fmul_rn(e, log2u));
}

// The warp's run of chunks [c0, c1): `per` chunks from chunk warp * per.
struct Run {
  int64_t c0, c1;
  __device__ Run(int64_t chunks, int64_t per) {
    c0 = (int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * per;
    c1 = c0 + per < chunks ? c0 + per : chunks;
  }
};

// dst[0 .. N) = src[0 .. N), or = v
template <int N, typename A>
__device__ inline void copy(A* dst, const A* src) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i];
}

template <int N, typename A>
__device__ inline void fill(A* dst, A v) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = v;
}

template <typename T, int V, int N>
__global__ void __launch_bounds__(THREADS)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t m,
                   int nv, int64_t xs, int64_t ys, float k, float coef,
                   float nbeta, int64_t chunks, int64_t per) {
  typedef Lane<T, V> L;
  constexpr int NW = L::NW, LO = (N - 1) / 2, HI = N - 1 - LO;
  constexpr int P = FWD_AHEAD;
  const Run run(chunks, per);
  if (run.c0 >= chunks) return;
  const int lane = threadIdx.x & 31;
  const int q32 = 32 / nv, r32 = 32 % nv;
  Pos ld, at;  // the next chunk to load, the chunk computed
  ld.init((run.c0 - 1) * 32 + lane, nv);
  int64_t next = run.c0 - 1;
  auto fetch = [&](uint32_t* w) {
    const bool ok = next <= run.c1 && ld.in(m);
    L::load(x + (ok ? ld.row * xs + int64_t(ld.col) * V : 0), ok, w);
    ld.step(q32, r32, nv);
    ++next;
  };
  // ring[i]: x of chunk c + i; sp, sc, sn: x^2 of chunks c - 1, c, c + 1
  uint32_t ring[P + 1][NW], sp[NW], sc[NW], sn[NW];
  fetch(sp);
  at = ld;
  L::square(sp, sp);
#pragma unroll
  for (int i = 0; i <= P; ++i) fetch(ring[i]);
  L::square(ring[0], sc);
  for (int64_t c = run.c0; c < run.c1; ++c) {
    uint32_t ahead[NW];
    fetch(ahead);  // chunk c + P + 1
    L::square(ring[1], sn);
    float below[LO > 0 ? LO : 1], above[HI > 0 ? HI : 1], own[V], sum[V];
    halo_below<T, V, LO>(sp, sc, lane, at.col, below);
    halo_above<T, V, HI>(sc, sn, lane, at.col, nv, above);
#pragma unroll
    for (int i = 0; i < V; ++i) own[i] = L::get(sc, i);
    window<N, V, LO>(below, own, above, sum);
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float u = __fadd_rn(k, __fmul_rn(coef, sum[i]));
      out[i] = __fmul_rn(L::get(ring[0], i), power(lg2(u), nbeta));
    }
    uint32_t w[NW];
    L::put(out, w);
    if (at.in(m)) L::store(y + at.row * ys + int64_t(at.col) * V, w);
    at.step(q32, r32, nv);
    copy<NW>(sp, sc);
    copy<NW>(sc, sn);
#pragma unroll
    for (int i = 0; i < P; ++i) copy<NW>(ring[i], ring[i + 1]);
    copy<NW>(ring[P], ahead);
  }
}

template <typename T, int V, int N>
__global__ void __launch_bounds__(THREADS)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int64_t m, int nv, int64_t xs,
                   int64_t dys, int64_t dxs, float k, float coef,
                   float nbeta, float c2, int64_t chunks, int64_t per) {
  typedef Lane<T, V> L;
  constexpr int NW = L::NW, LO = (N - 1) / 2, HI = N - 1 - LO;
  constexpr int P = BWD_AHEAD;
  const Run run(chunks, per);
  if (run.c0 >= chunks) return;
  const int lane = threadIdx.x & 31;
  const int q32 = 32 / nv, r32 = 32 % nv;
  const float nbeta1 = __fadd_rn(nbeta, -1.f);
  // inner is needed on chunks c0 - 1 .. c1 (the transposed window's
  // halo), which needs x^2 on c0 - 1 .. c1 and only the lanes of those
  // chunks that the halos reach (at most NMAX / 2 lanes each side)
  Pos ld, at, st;  // the next chunk to load, inner's chunk, dx's chunk
  ld.init((run.c0 - 1) * 32 + lane, nv);
  at = ld;
  int64_t next = run.c0 - 1;
  auto fetch = [&](uint32_t* wx, uint32_t* wdy) {
    const bool ok = next <= run.c1 && ld.in(m);
    L::load(x + (ok ? ld.row * xs + int64_t(ld.col) * V : 0), ok, wx);
    L::load(dy + (ok ? ld.row * dys + int64_t(ld.col) * V : 0), ok, wdy);
    ld.step(q32, r32, nv);
    ++next;
  };
  uint32_t rx[P + 1][NW], rdy[P + 1][NW], sp[NW], sc[NW], sn[NW];
#pragma unroll
  for (int i = 0; i <= P; ++i) fetch(rx[i], rdy[i]);
  fill<NW>(sp, 0u);
  L::square(rx[0], sc);
  st = at;
  st.step(q32, r32, nv);
  // carried from chunk c - 1: inner of c - 2 and c - 1, dy t, raw x
  uint32_t ip[NW], ic[NW], xp[NW];
  float g[V];
  fill<NW>(ip, 0u);
  fill<NW>(ic, 0u);
  fill<NW>(xp, 0u);
  fill<V>(g, 0.f);
#pragma unroll 2
  for (int64_t c = run.c0 - 1; c <= run.c1; ++c) {
    uint32_t ax[NW], ady[NW];
    fetch(ax, ady);  // chunk c + P + 1
    L::square(rx[1], sn);
    float below[LO > 0 ? LO : 1], above[HI > 0 ? HI : 1], own[V], sum[V];
    halo_below<T, V, LO>(sp, sc, lane, at.col, below);
    halo_above<T, V, HI>(sc, sn, lane, at.col, nv, above);
#pragma unroll
    for (int i = 0; i < V; ++i) own[i] = L::get(sc, i);
    window<N, V, LO>(below, own, above, sum);
    float inner[V], gn[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float u = __fadd_rn(k, __fmul_rn(coef, sum[i]));
      const float l2 = lg2(u);
      const float dyv = L::get(rdy[0], i);
      gn[i] = __fmul_rn(dyv, power(l2, nbeta));
      inner[i] = __fmul_rn(__fmul_rn(dyv, L::get(rx[0], i)),
                           power(l2, nbeta1));
    }
    uint32_t in[NW];
    L::put(inner, in);
    if (c > run.c0) {  // dx of chunk c - 1
      float b2[HI > 0 ? HI : 1], a2[LO > 0 ? LO : 1], acc[V], out[V];
      halo_below<T, V, HI>(ip, ic, lane, st.col, b2);
      halo_above<T, V, LO>(ic, in, lane, st.col, nv, a2);
#pragma unroll
      for (int i = 0; i < V; ++i) own[i] = L::get(ic, i);
      window<N, V, HI>(b2, own, a2, acc);
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = __fsub_rn(g[i], __fmul_rn(__fmul_rn(c2, L::get(xp, i)),
                                           acc[i]));
      uint32_t w[NW];
      L::put(out, w);
      if (st.in(m)) L::store(dx + st.row * dxs + int64_t(st.col) * V, w);
      st.step(q32, r32, nv);
    }
    at.step(q32, r32, nv);
    copy<NW>(ip, ic);
    copy<NW>(ic, in);
    copy<NW>(xp, rx[0]);
    copy<V>(g, gn);
    copy<NW>(sp, sc);
    copy<NW>(sc, sn);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      copy<NW>(rx[i], rx[i + 1]);
      copy<NW>(rdy[i], rdy[i + 1]);
    }
    copy<NW>(rx[P], ax);
    copy<NW>(rdy[P], ady);
  }
}

// Windows wider than NMAX: one thread per element, every term read
// from global memory (the rows stay in L1/L2), K7's inner recomputed
// per term. Slow and simple; the arithmetic is the lane kernels'.
template <typename T>
__device__ inline float elem(const T* p) {
  uint32_t w[1];
  Lane<T, 1>::load(p, true, w);
  return Lane<T, 1>::get(w, 0);
}

template <typename T>
__device__ inline float sq_at(const T* row, int64_t ch, int c) {
  if (ch < 0 || ch >= c) return 0.f;
  const float v = elem(row + ch);
  const float f[1] = {__fmul_rn(v, v)};
  uint32_t w[1];
  Lane<T, 1>::put(f, w);
  return Lane<T, 1>::get(w, 0);
}

template <typename T>
__device__ inline float log2u_at(const T* row, int64_t ch, int c, int n,
                                 float k, float coef) {
  const int64_t first = ch - (n - 1) / 2;
  float acc = sq_at(row, first, c);
  for (int d = 1; d < n; ++d) acc = __fadd_rn(acc, sq_at(row, first + d, c));
  return lg2(__fadd_rn(k, __fmul_rn(coef, acc)));
}

template <typename T>
__device__ inline void store1(T* p, float v) {
  uint32_t w[1];
  Lane<T, 1>::put(&v, w);
  Lane<T, 1>::store(p, w);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lrn_fwd_wide_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int64_t m, int c, int64_t xs, int64_t ys, int n,
                        float k, float coef, float nbeta) {
  for (int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x; i < m * c;
       i += int64_t(gridDim.x) * THREADS) {
    const int64_t r = i / c;
    const int ch = int(i - r * c);
    const T* row = x + r * xs;
    const float l2 = log2u_at(row, ch, c, n, k, coef);
    store1(y + r * ys + ch, __fmul_rn(elem(row + ch), power(l2, nbeta)));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lrn_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        T* __restrict__ dx, int64_t m, int c, int64_t xs,
                        int64_t dys, int64_t dxs, int n, float k, float coef,
                        float nbeta, float c2) {
  const float nbeta1 = __fadd_rn(nbeta, -1.f);
  const int hi = n - 1 - (n - 1) / 2;
  for (int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x; i < m * c;
       i += int64_t(gridDim.x) * THREADS) {
    const int64_t r = i / c;
    const int ch = int(i - r * c);
    const T* xr = x + r * xs;
    const T* dyr = dy + r * dys;
    float acc = 0.f;
    for (int d = 0; d < n; ++d) {
      const int64_t j = int64_t(ch) - hi + d;
      float inner = 0.f;
      if (j >= 0 && j < c) {
        const float f[1] = {__fmul_rn(
            __fmul_rn(elem(dyr + j), elem(xr + j)),
            power(log2u_at(xr, j, c, n, k, coef), nbeta1))};
        uint32_t w[1];
        Lane<T, 1>::put(f, w);
        inner = Lane<T, 1>::get(w, 0);
      }
      acc = d == 0 ? inner : __fadd_rn(acc, inner);
    }
    const float g = __fmul_rn(
        elem(dyr + ch), power(log2u_at(xr, ch, c, n, k, coef), nbeta));
    store1(dx + r * dxs + ch,
           __fsub_rn(g, __fmul_rn(__fmul_rn(c2, elem(xr + ch)), acc)));
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// One wave of the warps the card holds at once, each taking an equal
// run of chunks. The occupancy is asked once per kernel instance
// (`cache`), so a launch inside a CUDA graph capture asks nothing.
template <typename Kernel, typename... Args>
cudaError_t launch_lanes(Kernel kernel, int* cache, int64_t m, int nv,
                         cudaStream_t stream, Args... args) {
  if (*cache == 0) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      THREADS, 0) !=
            cudaSuccess ||
        blocks < 1)
      blocks = 1;
    *cache = blocks * WARPS * sm_count();
  }
  const int64_t chunks = (m * nv + 31) / 32;
  const int64_t per = (chunks + *cache - 1) / *cache;
  const int64_t blocks = ((chunks + per - 1) / per + WARPS - 1) / WARPS;
  kernel<<<unsigned(blocks), THREADS, 0, stream>>>(args..., chunks, per);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch_wide(Kernel kernel, int64_t m, int c, cudaStream_t stream,
                        Args... args) {
  const int64_t need = (m * c + THREADS - 1) / THREADS;
  const int64_t most = int64_t(sm_count()) * 8;
  kernel<<<unsigned(need < most ? need : most), THREADS, 0, stream>>>(
      args...);
  return cudaGetLastError();
}

struct Call {
  const void *x, *dy;
  void* out;
  int64_t m, xs, dys, outs;
  int c, n;
  float k, coef, nbeta, c2;
  cudaStream_t stream;
};

// K6 and K7 for window N, or the wide kernels past NMAX
template <typename T, int V, int N = 1>
cudaError_t fwd(const Call& a) {
  if (a.n > NMAX)
    return launch_wide(lrn_fwd_wide_kernel<T>, a.m, a.c, a.stream,
                       static_cast<const T*>(a.x), static_cast<T*>(a.out),
                       a.m, a.c, a.xs, a.outs, a.n, a.k, a.coef, a.nbeta);
  if (a.n != N) {
    if constexpr (N < NMAX) return fwd<T, V, N + 1>(a);
    return cudaErrorInvalidValue;
  }
  static int cache = 0;
  return launch_lanes(lrn_fwd_kernel<T, V, N>, &cache, a.m, a.c / V,
                      a.stream, static_cast<const T*>(a.x),
                      static_cast<T*>(a.out), a.m, a.c / V, a.xs, a.outs,
                      a.k, a.coef, a.nbeta);
}

template <typename T, int V, int N = 1>
cudaError_t bwd(const Call& a) {
  if (a.n > NMAX)
    return launch_wide(lrn_bwd_wide_kernel<T>, a.m, a.c, a.stream,
                       static_cast<const T*>(a.x),
                       static_cast<const T*>(a.dy), static_cast<T*>(a.out),
                       a.m, a.c, a.xs, a.dys, a.outs, a.n, a.k, a.coef,
                       a.nbeta, a.c2);
  if (a.n != N) {
    if constexpr (N < NMAX) return bwd<T, V, N + 1>(a);
    return cudaErrorInvalidValue;
  }
  static int cache = 0;
  return launch_lanes(lrn_bwd_kernel<T, V, N>, &cache, a.m, a.c / V,
                      a.stream, static_cast<const T*>(a.x),
                      static_cast<const T*>(a.dy), static_cast<T*>(a.out),
                      a.m, a.c / V, a.xs, a.dys, a.outs, a.k, a.coef,
                      a.nbeta, a.c2);
}

// The instance of `vec` elements a lane; refuses a vector that the
// pointers, the row strides or C do not allow.
template <typename T>
cudaError_t by_vec(const Call& a, int64_t vec, bool backward) {
  const int64_t bytes = vec * int64_t(sizeof(T));
  if (bytes != 16 && bytes != 8 && bytes != 4 && bytes != 2)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = uintptr_t(a.x) | uintptr_t(a.out) |
                         (backward ? uintptr_t(a.dy) : 0);
  if (a.c % vec || ptrs % bytes || (a.xs * sizeof(T)) % bytes ||
      (a.outs * sizeof(T)) % bytes ||
      (backward && (a.dys * sizeof(T)) % bytes))
    return cudaErrorInvalidValue;
  constexpr int W = 16 / sizeof(T);  // elements in 16 bytes
  switch (bytes) {
    case 16: return backward ? bwd<T, W>(a) : fwd<T, W>(a);
    case 8: return backward ? bwd<T, W / 2>(a) : fwd<T, W / 2>(a);
    case 4: return backward ? bwd<T, W / 4>(a) : fwd<T, W / 4>(a);
  }
  if constexpr (W == 8) return backward ? bwd<T, 1>(a) : fwd<T, 1>(a);
  return cudaErrorInvalidValue;
}

int run(const Call& a, int64_t vec, int dtype, bool backward) {
  if (a.m <= 0 || a.c <= 0) return cudaSuccess;
  if (a.n < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return by_vec<float>(a, vec, backward);
  if (dtype == 1) return by_vec<__nv_bfloat16>(a, vec, backward);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6. x: [m, c] rows with row stride xs (elements), unit channel stride;
// y: [m, c] with row stride ys; vec: elements a lane loads at once
// (ops/lrn.py:lrn_plan: 16 bytes where the pointers, the strides and c
// allow it); coef = alpha / n, nbeta = -beta; dtype: 0 = float32, 1 =
// bfloat16. Returns the CUDA error of the launch (0 = launched; an
// empty tensor launches nothing).
int veles_lrn_fwd(const void* x, void* y, int64_t m, int64_t c, int64_t xs,
                  int64_t ys, int64_t n, int64_t vec, float k, float coef,
                  float nbeta, int dtype, void* stream) {
  if (c > (int64_t(1) << 30) || n > (int64_t(1) << 30))
    return cudaErrorInvalidValue;
  const Call a{x,      nullptr, y,     m,     xs, 0,
               ys,     int(c),  int(n), k,    coef, nbeta,
               0.f,    static_cast<cudaStream_t>(stream)};
  return run(a, vec, dtype, false);
}

// K7. x, dy, dx: [m, c] rows with row strides xs, dys, dxs, unit channel
// stride; c2 = 2 * (alpha / n) * beta; the rest as K6's.
int veles_lrn_bwd(const void* x, const void* dy, void* dx, int64_t m,
                  int64_t c, int64_t xs, int64_t dys, int64_t dxs, int64_t n,
                  int64_t vec, float k, float coef, float nbeta, float c2,
                  int dtype, void* stream) {
  if (c > (int64_t(1) << 30) || n > (int64_t(1) << 30))
    return cudaErrorInvalidValue;
  const Call a{x,      dy,      dx,     m,     xs, dys,
               dxs,    int(c),  int(n), k,    coef, nbeta,
               c2,     static_cast<cudaStream_t>(stream)};
  return run(a, vec, dtype, true);
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
