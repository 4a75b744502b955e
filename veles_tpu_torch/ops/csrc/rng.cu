// Uniform fill for Hopper, sm_90a: Philox-4x32-10 (K8).
//
// Replaces the TPU kernel veles_tpu/ops/rng.py:_kernel, launched by
// _fill_tpu: uniform [0, 1) f32 values, each 32-bit random word turned
// into a float by putting its top 23 bits under exponent 127 ([1, 2))
// and subtracting 1. The TPU kernel reads the core's hardware PRNG,
// seeded with seed + block; this one runs Philox-4x32-10 (the generator
// of cuRAND and Random123) keyed by the 64-bit seed, with the counter
// (i, 0, 0, 0) for the i-th group of four elements, so element e is word
// e % 4 of block e / 4: the values depend on the seed and the element
// count only, not on the grid. The plain PyTorch version
// (ops/rng.py:_plain_fill) runs the same rounds in int64 arithmetic and
// agrees bitwise.
//
// What bounds it on this card: bytes. Each element costs 4 bytes
// written and about ten 32-bit multiplies per four elements, far below
// the card's integer rate, so the write at 3.35 TB/s is the ceiling
// (a [1536, 4096] dropout mask: 25.2 MB, 7.5 us).
//
// What this design does about it: one thread per Philox block writes
// its four floats with one 16-byte store (the output is a fresh,
// aligned allocation), neighbouring threads on neighbouring blocks, so
// every warp writes 512 contiguous bytes; a grid-stride loop over at
// most 16 blocks of 256 threads per SM keeps every SM busy at any size;
// the ragged tail (count not a multiple of 4) is stored element by
// element. The optional affine map (u * scale + low) uses round-to-
// nearest intrinsics so no fused multiply-add changes a bit against the
// plain version.
//
// Two entries. veles_uniform_fill takes the key by value, fixed at the
// launch. veles_uniform_fill_keyed reads it from device memory, as the
// TPU kernel reads its seed operand (seed_ref, in memory space ANY),
// and can fold an integer into it first (ops/rng.py:fold_in): a
// captured train step replays with the key its host wrote into that
// memory, where a by-value key would repeat the captured step's masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;

__device__ inline uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x);
    const uint32_t lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z);
    const uint32_t lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ inline float to_unit(uint32_t bits, float scale, float low,
                                int affine) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
  return affine ? __fadd_rn(__fmul_rn(f, scale), low) : f;
}

// The Philox stream of key (k0, k1) over blocks [0, n_blocks), a grid
// stride apart, written as floats: the body both kernels share.
__device__ inline void fill_blocks(float* __restrict__ out, int64_t n,
                                   int64_t n_blocks, uint32_t k0,
                                   uint32_t k1, float scale, float low,
                                   int affine) {
  const int64_t stride = int64_t(gridDim.x) * NT;
  for (int64_t i = int64_t(blockIdx.x) * NT + threadIdx.x; i < n_blocks;
       i += stride) {
    const uint4 r =
        philox(make_uint4(uint32_t(i), uint32_t(i >> 32), 0u, 0u), k0, k1);
    const float v[4] = {to_unit(r.x, scale, low, affine),
                        to_unit(r.y, scale, low, affine),
                        to_unit(r.z, scale, low, affine),
                        to_unit(r.w, scale, low, affine)};
    const int64_t e = i * 4;
    if (e + 4 <= n) {
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && e + j < n; ++j) out[e + j] = v[j];
    }
  }
}

__global__ void __launch_bounds__(NT)
    uniform_fill_kernel(float* __restrict__ out, int64_t n, int64_t n_blocks,
                        uint32_t k0, uint32_t k1, float scale, float low,
                        int affine) {
  fill_blocks(out, n, n_blocks, k0, k1, scale, low, affine);
}

// The key in device memory, as _fill_tpu reads seed_ref[0]: every
// thread reads its two words (one 8-byte line, served by L1 after the
// first warp) and, with has_fold, folds ``fold`` in first (fold_in:
// the first two words of the block at counter (fold_lo, fold_hi, 0, 0)
// under the key). One Philox block a thread, a tenth of what the fill
// costs it, and no barrier: a thread needs no other thread's result.
__global__ void __launch_bounds__(NT)
    uniform_fill_keyed_kernel(float* __restrict__ out, int64_t n,
                              int64_t n_blocks,
                              const uint32_t* __restrict__ key,
                              uint64_t fold, int has_fold, float scale,
                              float low, int affine) {
  uint32_t k0 = __ldg(key), k1 = __ldg(key + 1);
  if (has_fold) {
    const uint4 f = philox(
        make_uint4(uint32_t(fold), uint32_t(fold >> 32), 0u, 0u), k0, k1);
    k0 = f.x;
    k1 = f.y;
  }
  fill_blocks(out, n, n_blocks, k0, k1, scale, low, affine);
}

// At most 16 blocks of NT threads per SM, fewer for a small fill.
unsigned grid_for(int64_t n_blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = (n_blocks + NT - 1) / NT;
  if (grid > int64_t(sms) * 16) grid = int64_t(sms) * 16;
  return unsigned(grid);
}

}  // namespace

extern "C" {

// K8. out: n f32, 16-byte aligned; (k0, k1): the Philox key (the seed's
// low and high words); affine != 0 maps u to u * scale + low. Returns
// the CUDA error of the launch (0 = launched; n <= 0 launches nothing).
int veles_uniform_fill(void* out, int64_t n, uint32_t k0, uint32_t k1,
                       float scale, float low, int affine, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_blocks = (n + 3) / 4;
  uniform_fill_kernel<<<grid_for(n_blocks), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, n_blocks, k0, k1, scale, low, affine);
  return cudaGetLastError();
}

// K8 with its key in device memory: key points at the 64-bit key (two
// 32-bit words, low first: the int64 the caller holds); has_fold != 0
// folds ``fold`` in on the device. The result is bitwise
// veles_uniform_fill's under the key fold_in(key, fold). A CUDA graph
// that captures this launch reads the key anew at every replay.
int veles_uniform_fill_keyed(void* out, int64_t n, const void* key,
                             uint64_t fold, int has_fold, float scale,
                             float low, int affine, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_blocks = (n + 3) / 4;
  uniform_fill_keyed_kernel<<<grid_for(n_blocks), NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, n_blocks,
      static_cast<const uint32_t*>(key), fold, has_fold, scale, low,
      affine);
  return cudaGetLastError();
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
