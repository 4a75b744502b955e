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
// backward). The arithmetic is the Pallas kernels' step for step: x^2 in
// x's dtype, window sums in f32 term by term from the window's low end,
// the power and the products in f32, the result rounded to x's dtype.
// Every product and sum uses a round-to-nearest intrinsic, so no fused
// multiply-add changes a bit against the plain PyTorch versions
// (ops/lrn.py: _plain_fwd, _plain_bwd).
//
// What bounds them on this card: bytes. K6 reads x once and writes y
// once; K7 reads x and dy once and writes dx once; the arithmetic (n
// adds, one powf per element, and in K7 a second window) is far below
// the card's rate. AlexNet's LRN1 at batch 1536 in bf16 moves 1.78 GB
// forward (0.53 ms at 3.35 TB/s) and 2.68 GB backward (0.80 ms).
//
// What this design does about it: a block of 32 x 8 threads takes a
// tile of R rows by CT channels (CT = C up to 256, R ~ 2048 / CT), and
// stages x (and in K7 dy) for the tile plus its halo in shared memory
// as f32, each warp reading 32 neighbouring channels of one row; every
// window sum then reads shared memory only. K6's halo is lo channels
// below and hi above. K7 needs inner on a halo of hi below and lo above
// (the transposed window), and each of those needs u on its own window,
// so it stages x on n - 1 channels either side, computes t and inner
// for the tile plus halo into shared memory, synchronizes, and forms dx
// from there. Channels outside [0, C) count as zero, as the Pallas
// kernels' boundary masks make them. No atomics: each thread owns the
// outputs it writes. Left for later: 16-byte vector loads and stores,
// and a tile per warp instead of per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // threads along channels
constexpr int TY = 8;   // threads along rows
constexpr int TILE_ELEMS = 2048;
constexpr int MAX_CT = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x^2 in x's dtype, as f32
template <typename T>
__device__ inline float sq(float x) {
  return round_to(__fmul_rn(x, x), static_cast<const T*>(nullptr));
}

// sum of x^2 over s[0 .. n), from the low end, in f32
template <typename T>
__device__ inline float window_sq(const float* s, int n) {
  float acc = sq<T>(s[0]);
  for (int d = 1; d < n; ++d) acc = __fadd_rn(acc, sq<T>(s[d]));
  return acc;
}

// stage rows [row0, row0 + rows) of src, channels [ch0, ch0 + w) (zero
// outside [0, c)), into dst[r * w + j] as f32
template <typename T>
__device__ inline void stage(float* dst, const T* __restrict__ src,
                             int64_t row0, int rows, int64_t stride, int ch0,
                             int w, int c) {
  for (int r = threadIdx.y; r < rows; r += TY) {
    const T* row = src + (row0 + r) * stride;
    for (int j = threadIdx.x; j < w; j += TX) {
      const int ch = ch0 + j;
      dst[r * w + j] = (ch >= 0 && ch < c) ? to_f(row[ch]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TX* TY)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t m,
                   int c, int64_t xs, int64_t ys, int n, int R, int CT,
                   float k, float coef, float nbeta) {
  extern __shared__ float smem[];
  const int lo = (n - 1) / 2;
  const int W = CT + n - 1;  // channels [c0 - lo, c0 + CT + hi)
  const int64_t row0 = int64_t(blockIdx.x) * R;
  const int c0 = blockIdx.y * CT;
  const int rows = int(m - row0 < R ? m - row0 : R);
  const int cw = c - c0 < CT ? c - c0 : CT;
  stage(smem, x, row0, rows, xs, c0 - lo, W, c);
  __syncthreads();
  for (int r = threadIdx.y; r < rows; r += TY) {
    const float* s = smem + r * W;
    T* yr = y + (row0 + r) * ys + c0;
    for (int j = threadIdx.x; j < cw; j += TX) {
      const float u = __fadd_rn(k, __fmul_rn(coef, window_sq<T>(s + j, n)));
      store(yr + j, __fmul_rn(s[j + lo], powf(u, nbeta)));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TX* TY)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int64_t m, int c, int64_t xs,
                   int64_t dys, int64_t dxs, int n, int R, int CT, float k,
                   float coef, float nbeta, float c2) {
  extern __shared__ float smem[];
  const int lo = (n - 1) / 2;
  const int hi = n - 1 - lo;
  const int WX = CT + 2 * (n - 1);  // x: [c0 - (n - 1), c0 + CT + n - 1)
  const int WI = CT + n - 1;        // dy, t, inner: [c0 - hi, c0 + CT + lo)
  float* sx = smem;
  float* sdy = sx + R * WX;
  float* s_in = sdy + R * WI;
  float* st = s_in + R * WI;
  const int64_t row0 = int64_t(blockIdx.x) * R;
  const int c0 = blockIdx.y * CT;
  const int rows = int(m - row0 < R ? m - row0 : R);
  const int cw = c - c0 < CT ? c - c0 : CT;
  stage(sx, x, row0, rows, xs, c0 - (n - 1), WX, c);
  stage(sdy, dy, row0, rows, dys, c0 - hi, WI, c);
  __syncthreads();
  // t and inner on the tile and its transposed-window halo
  for (int r = threadIdx.y; r < rows; r += TY) {
    for (int j = threadIdx.x; j < WI; j += TX) {
      const int ch = c0 - hi + j;
      float t = 0.f, inner = 0.f;
      if (ch >= 0 && ch < c) {
        const float* s = sx + r * WX + j;  // channel ch - lo
        const float u = __fadd_rn(k, __fmul_rn(coef, window_sq<T>(s, n)));
        t = powf(u, nbeta);
        inner = round_to(__fmul_rn(__fmul_rn(sdy[r * WI + j], s[lo]),
                                   __fdiv_rn(t, u)),
                         static_cast<const T*>(nullptr));
      }
      st[r * WI + j] = t;
      s_in[r * WI + j] = inner;
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < rows; r += TY) {
    T* dxr = dx + (row0 + r) * dxs + c0;
    for (int j = threadIdx.x; j < cw; j += TX) {
      const float* si = s_in + r * WI + j;  // channel c0 + j - hi
      float acc = si[0];
      for (int d = 1; d < n; ++d) acc = __fadd_rn(acc, si[d]);
      const float xv = sx[r * WX + j + n - 1];
      const float g = __fmul_rn(sdy[r * WI + j + hi], st[r * WI + j + hi]);
      store(dxr + j, __fsub_rn(g, __fmul_rn(__fmul_rn(c2, xv), acc)));
    }
  }
}

// Tile shape and shared memory for C channels; words(R, CT)
// is the kernel's f32 count. Returns false when no tile fits.
template <typename Words>
bool plan(int c, Words words, int* R, int* CT, size_t* smem) {
  *CT = c < MAX_CT ? c : MAX_CT;
  *R = TILE_ELEMS / *CT > 1 ? TILE_ELEMS / *CT : 1;
  while (*R > 1 && words(*R, *CT) * sizeof(float) > DEFAULT_SMEM) *R /= 2;
  while (*CT > TX && words(*R, *CT) * sizeof(float) > MAX_SMEM) *CT /= 2;
  *smem = words(*R, *CT) * sizeof(float);
  return *smem <= MAX_SMEM;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int64_t m, int R, int CT, int c,
                   size_t smem, cudaStream_t stream, Args... args) {
  const int64_t gx = (m + R - 1) / R;
  const int64_t gy = (int64_t(c) + CT - 1) / CT;
  if (gx > 2147483647 || gy > 65535) return cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid{unsigned(gx), unsigned(gy)};
  kernel<<<grid, dim3{TX, TY}, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6. x: [m, c] rows with row stride xs (elements), unit channel stride;
// y: [m, c] with row stride ys; coef = alpha / n, nbeta = -beta;
// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the
// launch (0 = launched; an empty tensor launches nothing).
int veles_lrn_fwd(const void* x, void* y, int64_t m, int64_t c, int64_t xs,
                  int64_t ys, int64_t n, float k, float coef, float nbeta,
                  int dtype, void* stream) {
  if (m <= 0 || c <= 0) return cudaSuccess;
  if (n < 1 || c > (int64_t(1) << 30) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int nn = int(n);
  int R, CT;
  size_t smem;
  if (!plan(int(c),
            [nn](int r, int ct) { return size_t(r) * (ct + nn - 1); }, &R,
            &CT, &smem))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(lrn_fwd_kernel<float>, m, R, CT, int(c), smem, s,
                         static_cast<const float*>(x), static_cast<float*>(y),
                         m, int(c), xs, ys, nn, R, CT, k, coef, nbeta);
  typedef __nv_bfloat16 bf16;
  return launch(lrn_fwd_kernel<bf16>, m, R, CT, int(c), smem, s,
                      static_cast<const bf16*>(x), static_cast<bf16*>(y), m,
                      int(c), xs, ys, nn, R, CT, k, coef, nbeta);
}

// K7. x, dy, dx: [m, c] rows with row strides xs, dys, dxs, unit channel
// stride; c2 = 2 * (alpha / n) * beta; the rest as K6's.
int veles_lrn_bwd(const void* x, const void* dy, void* dx, int64_t m,
                  int64_t c, int64_t xs, int64_t dys, int64_t dxs, int64_t n,
                  float k, float coef, float nbeta, float c2, int dtype,
                  void* stream) {
  if (m <= 0 || c <= 0) return cudaSuccess;
  if (n < 1 || c > (int64_t(1) << 30) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int nn = int(n);
  int R, CT;
  size_t smem;
  if (!plan(int(c),
            [nn](int r, int ct) {
              return size_t(r) * ((ct + 2 * (nn - 1)) + 3 * (ct + nn - 1));
            },
            &R, &CT, &smem))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(lrn_bwd_kernel<float>, m, R, CT, int(c), smem, s,
                         static_cast<const float*>(x),
                         static_cast<const float*>(dy),
                         static_cast<float*>(dx), m, int(c), xs, dys, dxs, nn,
                         R, CT, k, coef, nbeta, c2);
  typedef __nv_bfloat16 bf16;
  return launch(lrn_bwd_kernel<bf16>, m, R, CT, int(c), smem, s,
                      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                      static_cast<bf16*>(dx), m, int(c), xs, dys, dxs, nn, R,
                      CT, k, coef, nbeta, c2);
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
