// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the 64-row tiles of the f32 FMA kernels and the launch
// set-up. The bf16 kernels K1, K2 and K3 build on flash_hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace veles_flash {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// float32: FMA units over shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;  // 16 x 16

// Padded smem rows (floats) of the operand tiles: one extra word per
// row, so the 16 rows a warp reads for one d fall in 16 banks.
template <int D> struct FmaTile {
  static constexpr int KS = D + 1;  // floats per smem row
};

// rows [r0, r0 + R) of a [T, d] f32 slice into a padded smem tile of
// D columns, zeros past t_len and in columns d..D-1 (an instance of
// width D serves every head dim d <= D)
template <int D, int R = 64>
__device__ inline void load_tile_f32(float* dst, const float* src,
                                     int64_t st, int r0, int t_len,
                                     int tid, int d = D) {
  constexpr int KS = FmaTile<D>::KS;
  for (int idx = tid; idx < R * D; idx += FMA_THREADS) {
    const int r = idx / D, c = idx % D;
    const int t = r0 + r;
    dst[r * KS + c] = t < t_len && c < d ? src[int64_t(t) * st + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The instance width a head dim d runs on: the next of 32, 64, 128 and
// 256 (the columns past d read as zeros and are never stored), for d a
// multiple of 8 from 8 to 256 (16-byte bf16 rows for TMA, and shared
// memory caps the width); 0 for any other d.
inline int64_t kernel_width(int64_t d) {
  if (d < 8 || d > 256 || d % 8) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Dynamic smem above 48 KB needs the attribute, set once per kernel
// instantiation (`configured` is that instantiation's flag).
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem_bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace veles_flash
