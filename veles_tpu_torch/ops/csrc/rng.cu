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

__global__ void __launch_bounds__(NT)
    uniform_fill_kernel(float* __restrict__ out, int64_t n, int64_t n_blocks,
                        uint32_t k0, uint32_t k1, float scale, float low,
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

}  // namespace

extern "C" {

// K8. out: n f32, 16-byte aligned; (k0, k1): the Philox key (the seed's
// low and high words); affine != 0 maps u to u * scale + low. Returns
// the CUDA error of the launch (0 = launched; n <= 0 launches nothing).
int veles_uniform_fill(void* out, int64_t n, uint32_t k0, uint32_t k1,
                       float scale, float low, int affine, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_blocks = (n + 3) / 4;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = (n_blocks + NT - 1) / NT;
  if (grid > int64_t(sms) * 16) grid = int64_t(sms) * 16;
  uniform_fill_kernel<<<unsigned(grid), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, n_blocks, k0, k1, scale, low, affine);
  return cudaGetLastError();
}

const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
