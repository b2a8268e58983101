// K13: the dropout keep mask for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/testing/tpu_checks.py:84 mask_kernel (launched
// at :89), which writes the TPU kernel's keep mask of one (BH, S, S) block
// as fp32 0/1 so that a plain reference can use the exact mask. Here it
// materializes the hash of csrc/philox.cuh for a (BH, rows, cols) coordinate
// block as one byte per element (0 or 1, read as torch.bool): the very bits
// that K2 and K4 draw in-kernel for attention probabilities, and the mask of
// every dropout site that random.dropout applies outside attention (the
// hidden states, the unfused path's probabilities).
//
// Bound on an H100: a thread hashes a 2-row by 8-column patch (four calls,
// every word used) and stores 8 bytes to each of its two rows. It reads
// nothing but the 16-byte key and writes 1 byte an element, so the bytes
// bound is 1 B / 3.35 TB/s an element; Philox4x32-10 spends about 106
// 32-bit integer operations a call (ten rounds of two 32x32 multiplies,
// high and low words, four xors and two key additions, then four shifts and
// compares), 26.5 an element, which at the 67 Tops/s of 32-bit work outside
// the tensor cores is the larger of the two: the kernel is bound by its
// integer work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;  // columns a thread writes in each of its two rows

__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(DropArgs args, uint8_t* __restrict__ out, int bh, int rows, int cols,
                    long long items) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= items) return;
  const int groups = (cols + kCols - 1) / kCols, pairs = (rows + 1) / 2;
  const int c0 = static_cast<int>(i % groups) * kCols;
  const long long rest = i / groups;
  const int r0 = static_cast<int>(rest % pairs) * 2;
  const int b = static_cast<int>(rest / pairs);
  const DropKey d = load_drop_key(args);

  uint32_t tiles[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) tiles[j] = keep_tile(d, b, r0, c0 + 2 * j);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + h;
    if (row >= rows) break;
    uint8_t* dst = out + (static_cast<long long>(b) * rows + row) * cols + c0;
    uint8_t m[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) m[e] = kept(tiles[e >> 1], row, c0 + e);
    if (c0 + kCols <= cols && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
      uint2 v;
      v.x = m[0] | (m[1] << 8) | (m[2] << 16) | (static_cast<uint32_t>(m[3]) << 24);
      v.y = m[4] | (m[5] << 8) | (m[6] << 16) | (static_cast<uint32_t>(m[7]) << 24);
      *reinterpret_cast<uint2*>(dst) = v;
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        if (c0 + e < cols) dst[e] = m[e];
    }
  }
}

}  // namespace

// key: int64 (2,) on the card; out: uint8 (bh, rows, cols), contiguous.
// Keeps where the hash word's top 24 bits are below threshold. Returns the
// CUDA error of the launch (0 on success).
extern "C" int dropout_mask(const long long* key, unsigned threshold, void* out, int bh,
                            int rows, int cols, void* stream) {
  if (bh <= 0 || rows <= 0 || cols <= 0) return 0;
  const long long items = static_cast<long long>(bh) * ((rows + 1) / 2) *
                          ((cols + kCols - 1) / kCols);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  DropArgs args{key, threshold, 1.f};
  dropout_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<uint8_t*>(out), bh, rows, cols, items);
  return static_cast<int>(cudaGetLastError());
}
