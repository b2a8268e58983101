// The dropout hash shared by K2 (flash_fwd.cu), K4 (flash_bwd.cu) and K13
// (dropout_mask.cu): Philox4x32-10 (Salmon et al., SC'11; Random123's
// philox4x32) keyed on the dropout key and counted on the absolute coordinate
// of the element, so every kernel draws the same bit for (bh, row, col)
// whatever tiles it walks. ops/attention.py philox4x32 is its twin in torch
// integer ops.
//
// Layout: one hash call per 2x2 (row, col) tile, counter (col / 2, row / 2,
// bh, 0); element (row, col) reads word 2 (row % 2) + col % 2 and is kept
// when the word's top 24 bits are below threshold = round((1 - rate) 2^24),
// compared as integers (no float, so kernel and twin agree bit for bit).
// The tile is square because the kernels hold the scores in both
// orientations: K2 and K4's dq own two neighbouring keys of a query, K4's
// dk/dv two neighbouring queries of a key. Either way a thread uses half of
// each call (one row or one column of the tile), where a call per element
// would use a quarter, and K13 uses all of it.
#pragma once

#include <stdint.h>

namespace {

// the dropout operands of a launch: the key lives on the card (int64 (2,),
// low 32 bits of each), so a key derived on the device needs no host sync
struct DropArgs {
  const long long* key;
  uint32_t threshold;  // keep when (word >> 8) < threshold
  float inv_keep;      // 1 / (1 - rate)
};

struct DropKey {
  uint32_t k0, k1, threshold;
};

__device__ __forceinline__ DropKey load_drop_key(const DropArgs& a) {
  return {static_cast<uint32_t>(a.key[0]), static_cast<uint32_t>(a.key[1]), a.threshold};
}

struct Philox4 {
  uint32_t x, y, z, w;
};

// the ten round keys of a key: a thread that makes many calls under one key
// (K13) computes them once and keeps them in registers
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    k.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return k;
}

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, const PhiloxKeys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k.k0[r], n2 = hi0 ^ c3 ^ k.k1[r];
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, uint32_t k0, uint32_t k1) {
  return philox4x32_10(c0, c1, c2, c3, philox_keys(k0, k1));
}

// the keep bits of the 2x2 tile holding (row, col): bit 2 (row % 2) + col % 2
__device__ __forceinline__ uint32_t keep_tile(const DropKey& d, uint32_t bh, uint32_t row,
                                              uint32_t col) {
  const Philox4 r = philox4x32_10(col >> 1, row >> 1, bh, 0u, d.k0, d.k1);
  return static_cast<uint32_t>((r.x >> 8) < d.threshold) |
         (static_cast<uint32_t>((r.y >> 8) < d.threshold) << 1) |
         (static_cast<uint32_t>((r.z >> 8) < d.threshold) << 2) |
         (static_cast<uint32_t>((r.w >> 8) < d.threshold) << 3);
}

// whether (row, col) is kept, from its tile's keep bits
__device__ __forceinline__ bool kept(uint32_t tile, int row, int col) {
  return (tile >> (((row & 1) << 1) | (col & 1))) & 1u;
}

}  // namespace
