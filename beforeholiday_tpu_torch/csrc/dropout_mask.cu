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
// Bound on an H100: integer instructions. The kernel reads the 16-byte key
// and writes 1 byte an element (1 B / 3.35 TB/s), while a Philox4x32-10
// call, four elements, needs 20 IMAD.WIDE.U32 (both words of the ten rounds'
// two multiplies) on the FMA-heavy pipe and, on the ALU pipe, 20 LOP3 (the
// rounds' three-way xors), 4 ISETP (the threshold compares), 4 SEL (a byte
// an element) and a LOP3 merging the bytes: 7.25 ALU instructions an
// element against 5.5 on the FMA pipe (with the packing's two IMAD.SHL),
// each pipe retiring 64 instructions a clock on an SM. chip_smoke.py's
// PHILOX_OPS_PER_ELEMENT and PEAK_INT32 hold that count and rate. An
// IMAD.WIDE appears to hold the FMA-heavy pipe for two issue slots (moving
// the compares onto it as wide multiply-adds made the kernel 16% slower), so
// the FMA pipe, at about 10 slots an element, is what this kernel meets.
//
// Design: what bounds the kernel is the instruction count, so everything
// that is not the hash leaves the hot loop. A thread owns one 2-row by
// 16-column patch of a (rows, cols) plane, found with one 32-bit division
// when it starts, and walks the planes bh = blockIdx.y, + gridDim.y, ...:
// no 64-bit division, no per-element index arithmetic, and gridDim.y stays
// under 65,536 for any BH. The grid is one wave of resident blocks
// (dropout_mask_blocks_per_sm), so each thread amortizes its start (the key
// load, its round keys, and the multiplies of its eight calls' first two
// rounds that do not depend on bh, kept in registers) over several planes.
// A patch is
// eight calls, every word used, packed into bytes in registers and written
// as one 16-byte store a row; a row width that is not a multiple of 16
// takes a masked byte path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPatchCols = 16;  // columns a thread writes in each of its two rows
constexpr int kCalls = kPatchCols / 2;

__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const long long* __restrict__ key, uint32_t lim, bool any,
                    uint8_t* __restrict__ out, int bh, int rows, int cols, int groups,
                    int patches) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= patches) return;
  const int pair = p / groups;
  const int g = p - pair * groups;
  const int r0 = 2 * pair, c0 = kPatchCols * g;
  const bool second = r0 + 1 < rows;
  const bool vec = (cols % kPatchCols) == 0;  // every patch full and 16-byte aligned
  const PhiloxKeys k = philox_keys(static_cast<uint32_t>(__ldg(key)),
                                   static_cast<uint32_t>(__ldg(key + 1)));
  const size_t plane = static_cast<size_t>(rows) * cols;
  uint8_t* dst = out + static_cast<size_t>(blockIdx.y) * plane +
                 static_cast<size_t>(r0) * cols + c0;
  const size_t step = static_cast<size_t>(gridDim.y) * plane;
  const uint32_t ccol = static_cast<uint32_t>(c0 >> 1);
  for (int b = blockIdx.y; b < bh; b += gridDim.y, dst += step) {
    // bytes of the patch: row r0 from words x, y of each call, row r0 + 1
    // from z, w; call j covers columns c0 + 2j and c0 + 2j + 1
    uint32_t even[kCalls / 2], odd[kCalls / 2];
#pragma unroll
    for (int j = 0; j < kCalls; ++j) {
      const Philox4 w = philox4x32_10(ccol + j, static_cast<uint32_t>(pair),
                                      static_cast<uint32_t>(b), 0u, k);
      const uint32_t e = static_cast<uint32_t>(any && w.x <= lim) |
                         (static_cast<uint32_t>(any && w.y <= lim) << 8);
      const uint32_t o = static_cast<uint32_t>(any && w.z <= lim) |
                         (static_cast<uint32_t>(any && w.w <= lim) << 8);
      if (j & 1) {
        even[j >> 1] += e * 65536u;
        odd[j >> 1] += o * 65536u;
      } else {
        even[j >> 1] = e;
        odd[j >> 1] = o;
      }
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < kCalls / 2; q += 4) {
        *reinterpret_cast<uint4*>(dst + 4 * q) =
            make_uint4(even[q], even[q + 1], even[q + 2], even[q + 3]);
        if (second)
          *reinterpret_cast<uint4*>(dst + cols + 4 * q) =
              make_uint4(odd[q], odd[q + 1], odd[q + 2], odd[q + 3]);
      }
    } else {
      const int n = min(kPatchCols, cols - c0);
#pragma unroll
      for (int c = 0; c < kPatchCols; ++c) {
        if (c < n) {
          dst[c] = static_cast<uint8_t>(even[c >> 2] >> (8 * (c & 3)));
          if (second) dst[cols + c] = static_cast<uint8_t>(odd[c >> 2] >> (8 * (c & 3)));
        }
      }
    }
  }
}

}  // namespace

// key: int64 (2,) on the card; out: uint8 (bh, rows, cols), contiguous.
// Keeps where the hash word's top 24 bits are below threshold. The grid
// (ops/attention.py dropout_mask_geometry): grid_x blocks of kThreads over
// the plane's ceil(rows / 2) x groups patches, grid_y <= 65,535 planes at a
// time. Returns the CUDA error of the launch (0 on success).
extern "C" int dropout_mask(const long long* key, unsigned threshold, void* out, int bh,
                            int rows, int cols, int groups, int patches, int grid_x,
                            int grid_y, void* stream) {
  if (bh <= 0 || rows <= 0 || cols <= 0) return 0;
  if (grid_x <= 0 || grid_y <= 0 || grid_y > 65535 ||
      static_cast<long long>(grid_x) * kThreads < patches)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // (word >> 8) < threshold, as one compare: word <= threshold * 256 - 1,
  // which for threshold 2^24 (rate 0) keeps every word; threshold 0 keeps none
  const uint32_t lim =
      static_cast<uint32_t>(static_cast<unsigned long long>(threshold) * 256u - 1u);
  dropout_mask_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      key, lim, threshold > 0, static_cast<uint8_t*>(out), bh, rows, cols, groups, patches);
  return static_cast<int>(cudaGetLastError());
}

// resident blocks of the kernel an SM holds (the wrapper sizes the grid to
// one wave of them); 0 if the query fails
extern "C" int dropout_mask_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dropout_mask_kernel, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return n;
}
