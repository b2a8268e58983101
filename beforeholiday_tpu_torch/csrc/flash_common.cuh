// Device helpers shared by the flash-attention kernels K2 (flash_fwd.cu) and
// K4 (flash_bwd.cu): dtype conversion, warp reductions, 16-byte loads, the
// bf16 tensor-core product mma.sync m16n8k16 with its fragment packing, and
// the dynamic shared memory of the CUDA-core row kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // mask fill: large negative keeps exp/max NaN-free

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// x rounded to T's precision and back: identity for fp32, one bf16 rounding
// for bf16 (the tensor-core kernels round p and ds so for their products)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// 8 consecutive elements as floats, from a 16-byte-aligned address
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// D(16x8, fp32) += A(16x16, bf16, row-major) * B(16x8, bf16, "col": B^T rows)
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3); B holds
// column g at rows 2t, 2t+1 and 2t+8, 2t+9; C holds rows g (0, 1) and g + 8
// (2, 3) at columns 2t, 2t+1. So the C tiles of two neighbouring n-blocks,
// rounded to bf16 pairwise, are the A fragment of the next product over
// those 16 columns (see pack_c_as_a).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment (16 rows x 16 columns) made of C tiles lo and hi (16 x 8
// each, columns 0-7 and 8-15), rounded to bf16
__device__ __forceinline__ void pack_c_as_a(uint32_t (&a)[4], const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
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
