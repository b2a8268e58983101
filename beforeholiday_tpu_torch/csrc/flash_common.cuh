// Device helpers shared by the flash-attention kernels K2 (flash_fwd.cu) and
// K4 (flash_bwd.cu): dtype conversion, warp reductions, the tensor-core
// fragments and their reuse as A operands, 4-byte cp.async, the decode
// kernel's bulk row copies and programmatic dependent launch, the
// tensor-core kernels' TMA tile loads (tensor maps, mbarriers) into wgmma's
// swizzled layout, the wgmma descriptors, fences and products, exp2, the
// dropout hash shared by the two lanes of a 2x2 tile, and the dynamic shared
// memory of every kernel above 48 KB.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

constexpr float kNeg = -1e30f;  // mask fill: large negative keeps exp/max NaN-free

// the two-byte types the tensor-core kernels take (bf16 and fp16): both 16
// bits, so the shared-memory layouts, swizzles and fragments are the same and
// only the conversions, the tensor maps' type and wgmma's type suffix differ
template <typename T>
constexpr bool kHalfType =
    std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// x rounded to T's precision and back: identity for fp32, one rounding for
// bf16 or fp16 (the tensor-core kernels round p and ds so for their products)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half*) {
  return __half2float(__float2half_rn(x));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// two fp32 values rounded to T (bf16 or fp16) as one 32-bit pair, lo first
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// the pair (lo, hi) rounded to T, stored at p (4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// The tensor-core fragments, per warp (g = lane / 4, t = lane % 4): an
// accumulator block of 16 rows x 8 columns holds rows g (regs 0, 1) and g + 8
// (2, 3) at columns 2t, 2t+1; a register A operand of 16 rows x 16
// contraction columns holds rows g and g + 8 at columns 2t, 2t+1 (regs 0, 1)
// and 2t+8, 2t+9 (regs 2, 3). wgmma keeps both layouts warp by warp (warp w
// of a warpgroup owns rows 16 w .. 16 w + 15 of its 64), the layouts of
// mma.sync m16n8k16. So the accumulators of two neighbouring 8-column
// blocks, rounded to T (bf16 or fp16) pairwise, are the A operand of the
// next product over those 16 columns: the A fragment made of accumulator
// blocks lo and hi (columns 0-7 and 8-15), rounded to T
template <typename T>
__device__ __forceinline__ void pack_c_as_a(uint32_t (&a)[4], const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// ------------------------------------------ asynchronous vector loads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, zeroed when not valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups of this thread's copies are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// start the copy of entries [r0, r0 + kRows) of a length-n fp32 vector,
// zero past n
template <int kRows, int kThreads>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in);
  }
}

// ------------------------------------ wgmma tiles (bf16 or fp16, 128B swizzle)
//
// wgmma reads its shared-memory operands through a descriptor, in the
// canonical 128-byte-swizzled layout: a (rows, D) tile is cut into atoms of
// 64 columns (128 bytes a row), stored one after the other; in an atom, row r
// takes 128 bytes at r * 128, and its 16-byte chunk c sits at chunk c ^ (r %
// 8). The same tile serves as a K-major operand (rows are the M or N index,
// the contraction runs along the row: Q, K in s = q k^T) and as an MN-major
// one (rows are the contraction index, read with the transpose bit: V in
// o = p v). The atoms must start on 1024-byte boundaries.

template <int D>
__host__ __device__ constexpr int sw_atoms() { return (D + 63) / 64; }

template <int kRows, int D>
__host__ __device__ constexpr int sw_bytes() { return kRows * 128 * sw_atoms<D>(); }

// the wgmma shared-memory descriptor: start address, leading byte offset,
// stride byte offset 1024 (8 rows of 128 bytes), 128-byte swizzle
__device__ __forceinline__ uint64_t sw_desc(const char* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// a K-major operand: rows [m0, m0 + 64) (A) or the tile's rows (B, m0 = 0),
// contraction [16 kc, 16 kc + 16): 32 bytes into a row of atom kc / 4
template <int kRows>
__device__ __forceinline__ uint64_t desc_kmajor(const char* tile, int m0, int kc) {
  return sw_desc(tile + (kc >> 2) * kRows * 128 + m0 * 128 + (kc & 3) * 32, 16);
}

// an MN-major operand (the transpose bit): contraction rows [16 kc, 16 kc +
// 16), the 64 columns of `atom` or fewer (an instruction never spans two
// atoms, so both offsets are the 1024 bytes between 8-row groups)
template <int kRows>
__device__ __forceinline__ uint64_t desc_mnmajor(const char* tile, int kc, int atom) {
  return sw_desc(tile + atom * kRows * 128 + kc * 16 * 128, 1024);
}

// ------------------------------------------------ TMA into swizzled tiles
//
// A tile load by the Tensor Memory Accelerator: one thread asks for a box of
// 64 columns x rows of one head of a (BH, S, D) tensor, described by a 3-D
// tensor map over (D, S, BH), and the copy lands in the 128-byte-swizzled
// layout above, reporting its bytes to an mbarrier. Rows past S and columns
// past D arrive as zeros, and a box never crosses into the next head.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the map of a contiguous (bh, rows, d) tensor of T (bf16 or fp16) in boxes
// of 64 columns x box_rows rows (a zeroed map for an empty tensor, which no
// load reads); cuTensorMapEncodeTiled is a driver function, reached through
// the runtime so that the library links no libcuda
template <typename T>
__host__ inline int make_tile_map(CUtensorMap* map, const void* base, int bh, int rows, int d,
                                  int box_rows) {
  static_assert(kHalfType<T>, "tile maps of two-byte types");
  constexpr CUtensorMapDataType kType = std::is_same<T, __half>::value
                                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  *map = CUtensorMap{};
  if (bh <= 0 || rows <= 0) return 0;
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, kType, 3, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// barriers initialised, before any thread or copy uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a stage, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// the box at (column c, row r, head h) of `map` into dst
__device__ __forceinline__ void tma_load(char* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r, int h) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r), "r"(h)
      : "memory");
}

// `bytes` contiguous bytes from global memory into shared memory by the bulk
// copy engine (TMA's 1-D form), reporting them to `bar`: both addresses and
// the size multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// programmatic dependent launch: a kernel launched with programmatic stream
// serialization may start before the one it follows ends; it waits here
// until that one has finished and its writes are visible, and the earlier
// kernel lets it start once every block has called launch_dependents (or
// exited)
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// rows [r0, r0 + kRows) of head h, every 64-column atom of D, into a
// swizzled tile (one thread issues; the barrier expects sw_bytes<kRows, D>())
template <int kRows, int D>
__device__ __forceinline__ void tma_load_tile(char* dst, const CUtensorMap* map, uint64_t* bar,
                                              int r0, int h) {
#pragma unroll
  for (int a = 0; a < sw_atoms<D>(); ++a) tma_load(dst + a * kRows * 128, map, bar, 64 * a, r0, h);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// after wgmma_wait: the accumulators are read no earlier
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// wgmma m64nNk16, T (bf16 or fp16) in, fp32 accumulators d[J .. J + N/8) of a [NT][4]
// array in the fragment layout above. ss: A and B K-major from shared
// memory; rs: A from registers and B MN-major from shared memory.
template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[NT][4], uint64_t a, uint64_t b) {
  static_assert(J + 4 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), \
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), \
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]) \
      : "l"(a), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}

template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NT][4], uint64_t a, uint64_t b) {
  static_assert(J + 8 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), \
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), \
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]), \
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]), "+f"(d[J + 4][2]), "+f"(d[J + 4][3]), \
        "+f"(d[J + 5][0]), "+f"(d[J + 5][1]), "+f"(d[J + 5][2]), "+f"(d[J + 5][3]), \
        "+f"(d[J + 6][0]), "+f"(d[J + 6][1]), "+f"(d[J + 6][2]), "+f"(d[J + 6][3]), \
        "+f"(d[J + 7][0]), "+f"(d[J + 7][1]), "+f"(d[J + 7][2]), "+f"(d[J + 7][3]) \
      : "l"(a), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}

template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[NT][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  static_assert(J + 2 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}

template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NT][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  static_assert(J + 4 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), \
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), \
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}

template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[NT][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  static_assert(J + 6 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), \
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), \
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]), \
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]), "+f"(d[J + 4][2]), "+f"(d[J + 4][3]), \
        "+f"(d[J + 5][0]), "+f"(d[J + 5][1]), "+f"(d[J + 5][2]), "+f"(d[J + 5][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}

template <typename T, int J, int NT>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NT][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  static_assert(J + 8 <= NT, "fragment range");
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]), "+f"(d[J + 0][2]), "+f"(d[J + 0][3]), \
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), \
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), \
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]), \
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]), "+f"(d[J + 4][2]), "+f"(d[J + 4][3]), \
        "+f"(d[J + 5][0]), "+f"(d[J + 5][1]), "+f"(d[J + 5][2]), "+f"(d[J + 5][3]), \
        "+f"(d[J + 6][0]), "+f"(d[J + 6][1]), "+f"(d[J + 6][2]), "+f"(d[J + 6][3]), \
        "+f"(d[J + 7][0]), "+f"(d[J + 7][1]), "+f"(d[J + 7][2]), "+f"(d[J + 7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  if constexpr (std::is_same<T, __half>::value) {
    FLASH_WGMMA("f16");
  } else {
    FLASH_WGMMA("bf16");
  }
#undef FLASH_WGMMA
}


// d[0 .. D/8) += a (64 x 16 from registers) times rows [16 kc, 16 kc + 16)
// of a swizzled MN-major tile of D columns: one wgmma per 64-column atom
template <typename T, int D, int kRows, int kAtom = 0>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[D / 8][4], const uint32_t (&a)[4],
                                              const char* tile, int kc) {
  constexpr int n = D - 64 * kAtom < 64 ? D - 64 * kAtom : 64;
  const uint64_t b = desc_mnmajor<kRows>(tile, kc, kAtom);
  if constexpr (n == 64) {
    wgmma_rs_n64<T, 8 * kAtom>(d, a, b);
  } else if constexpr (n == 48) {
    wgmma_rs_n48<T, 8 * kAtom>(d, a, b);
  } else if constexpr (n == 32) {
    wgmma_rs_n32<T, 8 * kAtom>(d, a, b);
  } else {
    wgmma_rs_n16<T, 8 * kAtom>(d, a, b);
  }
  if constexpr (64 * (kAtom + 1) < D) wgmma_rs_cols<T, D, kRows, kAtom + 1>(d, a, tile, kc);
}

// start d (64 x N, N = 32 or 64) = A B^T over a contraction of D: A rows
// [m0, m0 + 64) of swizzled tile a (kRowsA rows), B the whole swizzled tile b
// (N rows), both K-major. d is overwritten once the caller has waited
// (wgmma_wait, then fence_regs); work that does not read d, such as the
// dropout hash, runs meanwhile.
template <typename T, int D, int kRowsA, int N>
__device__ __forceinline__ void wgmma_ss_rows(float (&d)[N / 8][4], const char* a, int m0,
                                              const char* b) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint64_t da = desc_kmajor<kRowsA>(a, m0, kc), db = desc_kmajor<N>(b, 0, kc);
    if constexpr (N == 64) {
      wgmma_ss_n64<T, 0>(d, da, db);
    } else {
      wgmma_ss_n32<T, 0>(d, da, db);
    }
  }
  wgmma_commit();
}

// 2^x (ex2.approx, relative error about 2^-22; -inf gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The keep bits of a thread's two 2x2 hash tiles in an mma C fragment: the
// thread holds rows g and g + 8 of a 16-row block (g = lane / 4) at the two
// columns col, col + 1 (col even), and lanes g and g ^ 1 (lane ^ 4) share
// both tiles. So each lane of the pair hashes one of them (even g the tile
// of rows g, odd g that of rows g + 8) and the two swap results with one
// shuffle: one Philox call a lane where each would make two. `row0` is the
// thread's row g, the hash's row index (a query; in K4's dk/dv pass the C
// rows are keys and the hash is called with the roles of row and column
// swapped by `transposed`). Returns {tile of row0, tile of row0 + 8}.
__device__ __forceinline__ void keep_tiles_shared(uint32_t (&tiles)[2], const DropKey& d,
                                                  int row0, int col, int lane, bool transposed) {
  const bool odd = (lane >> 2) & 1;
  const int r = odd ? row0 + 8 : row0;
  const uint32_t mine = transposed ? keep_tile(d, col, r) : keep_tile(d, r, col);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);
  tiles[0] = odd ? other : mine;
  tiles[1] = odd ? mine : other;
}

// The keep bits of a tile's C fragments, hashed while the tile's products
// run: the two 4-bit tiles of 8-column block nt (keep_tiles_shared) at bits
// 8 (nt % 4) .. + 7 of word nt / 4. kNT is the tile's 8-column blocks; rows
// r0 and r0 + 8 are the C rows (transposed: keys, with the columns queries).
template <int kNT>
__device__ __forceinline__ void keep_bits(uint32_t (&bits)[(kNT + 3) / 4], const DropKey& d,
                                          int row0, int col0, int lane, bool transposed) {
#pragma unroll
  for (int w = 0; w < (kNT + 3) / 4; ++w) bits[w] = 0u;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    uint32_t tiles[2];
    keep_tiles_shared(tiles, d, row0, col0 + nt * 8, lane, transposed);
    bits[nt >> 2] |= (tiles[0] | (tiles[1] << 4)) << ((nt & 3) * 8);
  }
#pragma unroll
  for (int w = 0; w < (kNT + 3) / 4; ++w) asm volatile("" : "+r"(bits[w]));  // before the wait
}

// the 4-bit tile of block nt, row half h (0: row0, 1: row0 + 8)
template <int kNT>
__device__ __forceinline__ uint32_t keep_tile_of(const uint32_t (&bits)[(kNT + 3) / 4], int nt,
                                                 int h) {
  return (bits[nt >> 2] >> ((nt & 3) * 8 + h * 4)) & 0xFu;
}

// the column count a lane of the row kernels owns for head dim d: the row
// kernels are built for 1, 2, 4, 8 and 16 (d up to 512) and mask the rest
__host__ __device__ constexpr int cols_for(int d) {
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : d <= 256 ? 8 : 16;
}

// a launch of a row kernel with `bytes` of dynamic shared memory: above the
// default 48 KB the kernel must be allowed more first (up to 227 KB on H100)
template <typename Kernel>
__host__ int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
