// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels K1
// (flash_fwd.cu), K2 and K3 (flash_bwd.cu): TMA tile loads through tensor
// maps, mbarrier rings between a producer warp and consumer warpgroups,
// register rebalancing (setmaxnreg), and warpgroup matrix products
// (wgmma.mma_async) with their shared-memory descriptors.
//
// A tile of R rows x D bf16 columns lands in shared memory as TMA writes
// it with the widest swizzle a row allows (SW = min(128, 2 D) bytes):
// 2 D / SW column chunks, each R rows of SW bytes, XOR-swizzled in atoms
// of 8 rows. The wgmma descriptors below name the same swizzle, so the
// products read the tiles where TMA put them.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// looked up in libcuda (loaded by the CUDA runtime), from the
// layout that ops/flash_attention.py:tma_layout computes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace veles_hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// int64 values of one operand's layout (tma_layout): dims (D, H, T, B),
// byte strides of H, T, B, box (columns, 1, rows, 1), swizzle bytes
constexpr int LAYOUT_LEN = 12;

// return codes above this are cuTensorMapEncodeTiled's CUresult
constexpr int ENCODE_ERROR = 100000;

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The map of one bf16 [B, T, H, D] operand; rows past T (and any box
// element outside the tensor) load as zeros. Returns 0, or
// ENCODE_ERROR + cuTensorMapEncodeTiled's CUresult.
inline int encode_map(CUtensorMap* map, const void* ptr,
                      const int64_t* layout) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ENCODE_ERROR + int(CUDA_ERROR_NOT_FOUND);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = cuuint64_t(layout[i]);
  for (int i = 0; i < 3; ++i) strides[i] = cuuint64_t(layout[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = cuuint32_t(layout[7 + i]);
  const CUtensorMapSwizzle swizzle =
      layout[11] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : layout[11] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR + int(res);
}

// The layout a kernel was built for: box rows and the swizzle its
// descriptors assume
inline bool layout_matches(const int64_t* layout, int64_t d, int rows) {
  const int64_t sw = 2 * d < 128 ? 2 * d : 128;
  return layout[0] == d && layout[7] == sw / 2 && layout[8] == 1 &&
         layout[9] == rows && layout[10] == 1 && layout[11] == sw;
}

inline const char* error_string(int code) {
  if (code >= ENCODE_ERROR)
    return "cuTensorMapEncodeTiled refused the operand's layout (CUresult "
           "is the code minus 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024-byte swizzle atom
__device__ inline unsigned char* align_1024(unsigned char* p) {
  const uint32_t pad = (1024u - (smem_u32(p) & 1023u)) & 1023u;
  return p + pad;
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and expect `bytes` of TMA transactions on this phase
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts ~2^34 cycles (seconds) traps: a protocol fault ends the
// launch with an error instead of hanging the card.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// box at coordinates (c0 .. c3) of a 4-d tensor map into shared memory,
// completing `bytes` of the transaction count of `bar`
__device__ inline void tma_load_4d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ inline void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// device: register rebalancing between the producer and the consumers
// ---------------------------------------------------------------------------

template <int R> __device__ inline void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R> __device__ inline void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers an asynchronous
// wgmma is writing between its start and its wait.
template <int R> __device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the A fragments of register-A wgmmas: placed after their
// wait, it keeps the registers from reuse while the products read them
template <int K> __device__ inline void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B,
// 3 = 32 B)
__device__ inline uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo, uint32_t mode) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(mode) << 62);
}

// A bf16 tile of R rows x D columns as TMA lays it out (see the top)
template <int R, int D> struct Tile {
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;  // swizzle bytes
  static constexpr int CHUNKS = 2 * D / SW;
  static constexpr int COLS = SW / 2;  // bf16 columns per chunk
  static constexpr uint32_t BYTES = uint32_t(R) * D * 2;
  static constexpr uint32_t CHUNK_BYTES = uint32_t(R) * SW;
  static constexpr uint32_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;

  // The tile (all chunks) at coordinates (h, row0, b) of a map
  __device__ static void load(void* dst, const CUtensorMap* map,
                              uint64_t* bar, int h, int row0, int b) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      tma_load_4d(static_cast<unsigned char*>(dst) + c * CHUNK_BYTES, map,
                  bar, c * COLS, h, row0, b);
  }

  // K-major operand (rows are M or N, columns the product's depth):
  // columns [16 kk, 16 kk + 16) of rows [r, r + 8 n)
  __device__ static uint64_t k_major(uint32_t base, int r, int kk) {
    return smem_desc(base + (kk * 32 / SW) * CHUNK_BYTES + r * SW +
                         (kk * 32) % SW,
                     16, 8 * SW, MODE);
  }

  // MN-major operand (rows are the product's depth, columns N): rows
  // [16 kk, 16 kk + 16), all D columns
  __device__ static uint64_t mn_major(uint32_t base, int kk) {
    return smem_desc(base + kk * 16 * SW, CHUNK_BYTES, 8 * SW, MODE);
  }
};

// An f32 accumulator d[64 x N] (the layout below) rounded to the bf16
// A fragments of a product whose depth is its N: k-step kk takes
// columns [16 kk, 16 kk + 16)
template <int N>
__device__ inline void pack_a(uint32_t (&a)[N / 16][4],
                              const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
      a[kk][r] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// wgmma m64nNk16, bf16 in, f32 accumulate. A warpgroup's accumulator
// d[64 x N] is the mma.sync m16n8 C layout per warp (warp w holds rows
// [16 w, 16 w + 16)) repeated over N / 8: d[4 j + e] is row g + 8 (e / 2),
// column 8 j + 2 tq + e % 2 (g = lane / 4, tq = lane % 4). The register
// A of rs() is the mma.sync m16n8k16 A fragment of the same rows. Inline
// PTX names every accumulator register, hence one specialisation per N.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  static constexpr int REGS = 16;
  // d[64 x 32] (+)= A[64 x 16] (smem, K-major) * B[16 x 32] (smem,
  // K-major); scale_d 0 overwrites d
  __device__ static inline void ss(float (&d)[16], uint64_t da, uint64_t db,
                                   int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[64 x 32] += A[64 x 16] (registers, the accumulator layout re-packed)
  // * B[16 x 32] (smem, MN-major: the transposed-B form)
  __device__ static inline void rs(float (&d)[16], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  static constexpr int REGS = 32;
  // d[64 x 64] (+)= A[64 x 16] (smem, K-major) * B[16 x 64] (smem,
  // K-major); scale_d 0 overwrites d
  __device__ static inline void ss(float (&d)[32], uint64_t da, uint64_t db,
                                   int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[64 x 64] += A[64 x 16] (registers, the accumulator layout re-packed)
  // * B[16 x 64] (smem, MN-major: the transposed-B form)
  __device__ static inline void rs(float (&d)[32], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static constexpr int REGS = 64;
  // d[64 x 128] (+)= A[64 x 16] (smem, K-major) * B[16 x 128] (smem,
  // K-major); scale_d 0 overwrites d
  __device__ static inline void ss(float (&d)[64], uint64_t da, uint64_t db,
                                   int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[64 x 128] += A[64 x 16] (registers, the accumulator layout re-packed)
  // * B[16 x 128] (smem, MN-major: the transposed-B form)
  __device__ static inline void rs(float (&d)[64], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

}  // namespace veles_hopper
