// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the 64-row tiles of the f32 FMA kernels and of K2, the
// bf16 tensor-core fragments of mma.sync m16n8k16 in the
// FlashAttention-2 register layout (K2), shared-memory tile loads and
// the launch set-up. The bf16 K1 and K3 use flash_hopper.cuh instead.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16): a warp's lane splits
// into g = lane / 4 (fragment row, and B column) and tq = lane % 4; the
// f32 accumulator c[16x8] holds c0, c1 at row g, columns 2 tq + {0, 1}
// and c2, c3 at row g + 8, the same columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace veles_flash {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // four warps x 16 rows

// A 64-row bf16 smem tile: rows of 16-byte chunks padded by one chunk,
// so the 8 rows a quad-major fragment load touches fall in distinct
// banks
template <int D> struct MmaTile {
  static constexpr int LD = D + 8;  // bf16 elements per smem row
  static constexpr size_t bytes = size_t(64) * LD * sizeof(bf16);
};

__device__ inline uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ inline uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// c[16x8] += a[16x16] (row) * b[16x8] (col), bf16 in, f32 accumulate
__device__ inline void mma_bf16(float c[4], const uint32_t a[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k-step kk from 16 smem rows starting at `rows`
template <int LD>
__device__ inline void frag_a(uint32_t a[4], const bf16* rows, int kk, int g,
                              int tq) {
  const bf16* r = rows + g * LD + kk * 16 + tq * 2;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * LD);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * LD + 8);
}

// A fragment re-packed from two f32 accumulator n-tiles (columns
// [16 kk, 16 kk + 8) and [16 kk + 8, 16 kk + 16) of a product): the
// register re-packing that feeds one product's result to the next
__device__ inline void frag_from_acc(uint32_t a[4], const float lo[4],
                                     const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// c += a * B for B held n-major in smem (one row per column n, as K
// for S = Q K^T): `b` points at row n0 + g, element 16 kk + 2 tq
__device__ inline void mma_nk(float c[4], const uint32_t a[4],
                              const bf16* b) {
  mma_bf16(c, a, ld32(b), ld32(b + 8));
}

// c += a * B for B held k-major in smem (one row per k, as V for
// O += P V): `b` points at row 16 kk + 2 tq, element n0 + g
template <int LD>
__device__ inline void mma_kn(float c[4], const uint32_t a[4],
                              const bf16* b) {
  mma_bf16(c, a, pack_bf16(b[0], b[LD]), pack_bf16(b[8 * LD], b[9 * LD]));
}

// rows [r0, r0 + 64) of a [T, D] slice (row stride st elements) into
// smem, 16 bytes per copy, zeros past t_len
template <int D>
__device__ inline void load_tile(bf16* dst, const bf16* src, int64_t st,
                                 int r0, int t_len, int tid) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < 64 * CPR; idx += MMA_THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      val = *reinterpret_cast<const uint4*>(src + int64_t(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// ---------------------------------------------------------------------------
// float32: FMA units over shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;  // 16 x 16

// Padded smem rows (floats) of the operand tiles: one extra word per
// row, so the 16 rows a warp reads for one d fall in 16 banks.
template <int D> struct FmaTile {
  static constexpr int KS = D + 1;  // floats per smem row
};

// rows [r0, r0 + 64) of a [T, D] f32 slice into a padded smem tile,
// zeros past t_len
template <int D>
__device__ inline void load_tile_f32(float* dst, const float* src,
                                     int64_t st, int r0, int t_len,
                                     int tid) {
  constexpr int KS = FmaTile<D>::KS;
  for (int idx = tid; idx < 64 * D; idx += FMA_THREADS) {
    const int r = idx / D, c = idx % D;
    const int t = r0 + r;
    dst[r * KS + c] = t < t_len ? src[int64_t(t) * st + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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
