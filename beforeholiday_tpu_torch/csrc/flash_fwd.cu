// K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/ops/attention.py:152 _fa_fwd_kernel and its
// mask predicate _mask (:119), launched by _fa_fwd_pallas (:244). Same
// function: for every (bh, query row) the softmax over keys k < lens[bh]
// (and k <= row when causal) of scale * q.k, times v, with the running max m,
// normaliser l and accumulator in fp32 (online softmax). A fully masked row
// gives o = 0 and lse = -1e30. lse comes back as a plain (BH, Sq) fp32 array,
// not the TPU's lane-replicated (BQ, 128) block.
//
// Bound on an H100: at the serving shapes both calls are bound by bytes.
// Causal prefill BH=128, S=1024, D=64 in bf16 moves 67.1 MB (q, k, v read
// once, o written once; 20.0 us at 3.35 TB/s) for 17.2 GFLOP (17.4 us at the
// 989 TFLOP/s bf16 tensor-core peak). Decode BH=512, Sq=1, Sk=1024 reads
// 134 MB of K/V (40 us) for 0.27 GFLOP.
//
// Three kernels, chosen by shape and dtype in launch_dim():
// * flash_fwd_decode_kernel (Sq < 16, decode): one block per (query row, bh);
//   its 4 warps split the key tiles round-robin, each lane scores one key per
//   tile from a 16-byte-vector read of its K row, and the warps merge their
//   (m, l, acc) through shared memory at the end. Decode is a stream over
//   K/V: the split keeps 4x more loads in flight than one warp per row.
// * flash_fwd_mma_kernel (bf16, Sq >= 16, prefill): tensor cores through
//   mma.sync m16n8k16 with fp32 accumulation. A block owns 64 query rows
//   (16 per warp, Q fragments held in registers) and walks 64-key tiles of
//   K and transposed V staged in padded shared memory (conflict-free
//   fragment loads). The scores stay in registers; p is rounded to bf16 for
//   the p.v product, as the TPU kernel rounds p to v's dtype, while the
//   normaliser l sums the fp32 p.
// * flash_fwd_rows_kernel (fp32, Sq >= 16): CUDA cores in fp32, 16 query
//   rows per block (4 per warp), 32-key tiles staged in shared memory, lane j
//   scores key j. The exact fp32 path the card-side checks compare tightly.
// All three skip tiles wholly past lens or past the block's last causal
// diagonal and mask the ragged edge themselves. Still open (later work):
// cp.async/TMA pipelining of the tile loads, wgmma, and reading the paged
// cache in place instead of a gathered copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;  // mask fill: large negative keeps exp/max NaN-free
constexpr int kWarps = 4;
constexpr int kRows = 4;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per tile: lane j owns key j
constexpr int kDecodeRows = 16;       // fewer query rows than this: decode kernel
constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per tensor-core block
constexpr int kMmaBK = 64;              // keys per tensor-core tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lens,
                 T* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, float scale, int causal) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  __shared__ float qs[kBQ][D];
  __shared__ float ks[kBK][D + 1];  // +1: lane j reads row j at column d, distinct banks
  __shared__ float vs[kBK][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;

  const int len = min(max(lens[bh], 0), sk);
  // keys any row of this block can see
  const int kend = causal ? min(len, min(q0 + kBQ, sq)) : len;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < sq) ? to_float(q[qoff + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = 0; t0 < kend; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < sk;
      const size_t g = koff + (size_t)(t0 + r) * D + c;
      ks[r][c] = in ? to_float(k[g]) : 0.f;
      vs[r][c] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qs[warp * kRows + r][d], kd, s[r]);
    }

    const int key = t0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
      const bool masked = key >= len || (causal && key > row);
      const float sr = masked ? kNeg : s[r] * scale;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      // explicit zero: on a fully masked row sr == m_new and exp would be 1
      p[r] = masked ? 0.f : expf(sr - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < D ? vs[j][col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= sq) continue;
    const bool nonempty = l[r] > 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) store(&o[qoff + (size_t)row * D + col], nonempty ? acc[r][c] / l[r] : 0.f);
    }
    if (lane == 0) lse[(size_t)bh * sq + row] = nonempty ? m[r] + logf(l[r]) : kNeg;
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ o, float* __restrict__ lse,
                        int sq, int sk, float scale, int causal) {
  constexpr int kCols = (D + 31) / 32;
  __shared__ float qs[D];
  __shared__ float wm[kWarps], wl[kWarps];
  __shared__ float wacc[kWarps][D];

  const int row = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t koff = (size_t)bh * sk * D;
  const size_t orow = (size_t)bh * sq + row;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, row + 1) : len;  // keys this row sees

  for (int i = threadIdx.x; i < D; i += blockDim.x) qs[i] = to_float(q[orow * D + i]);
  __syncthreads();

  float m = kNeg, l = 0.f, acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int t0 = warp * 32; t0 < kend; t0 += kWarps * 32) {
    const int key = t0 + lane;
    const bool live = key < kend;
    float s = kNeg;
    if (live) {
      const T* kr = k + koff + (size_t)key * D;
      float dot = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qs[d0 + e], kv[e], dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    m = m_new;
    const int n = min(32, kend - t0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const T* vr = v + koff + (size_t)(t0 + j) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) acc[c] = fmaf(pj, to_float(vr[col]), acc[c]);
      }
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) wacc[warp][col] = acc[c];
  }
  __syncthreads();
  if (warp != 0) return;
  float mt = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, wm[w]);
  float lt = 0.f, out[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[c] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float a = expf(wm[w] - mt);  // 0 for a warp that saw no key
    lt += a * wl[w];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) out[c] += a * wacc[w][col];
    }
  }
  const bool nonempty = lt > 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) store(&o[orow * D + col], nonempty ? out[c] / lt : 0.f);
  }
  if (lane == 0) lse[orow] = nonempty ? mt + logf(lt) : kNeg;
}

// D(16x8, fp32) += A(16x16, bf16, row-major) * B(16x8, bf16, "col": B^T rows)
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

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3); B holds
// column g at rows 2t, 2t+1 and 2t+8, 2t+9; C holds rows g (0, 1) and g + 8
// (2, 3) at columns 2t, 2t+1. So a thread owns query rows r0 = g and r1 = g+8
// of its warp's 16, and S's accumulators become P's A fragments in place.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ lens, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale,
                     int causal) {
  constexpr int kDS = D + 8;       // padded K row: fragment loads hit distinct banks
  constexpr int kKS = kMmaBK + 8;  // padded row of transposed V, same reason
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK][kDS];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kKS];

  const int bh = blockIdx.y, q0 = blockIdx.x * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kMmaBQ, sq)) : len;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = r0 < sq ? ld32(q + qoff + (size_t)r0 * D + c) : 0u;
    qf[kc][1] = r1 < sq ? ld32(q + qoff + (size_t)r1 * D + c) : 0u;
    qf[kc][2] = r0 < sq ? ld32(q + qoff + (size_t)r0 * D + c + 8) : 0u;
    qf[kc][3] = r1 < sq ? ld32(q + qoff + (size_t)r1 * D + c + 8) : 0u;
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < kend; t0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kMmaBK * D / 8; i += blockDim.x) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (t0 + r < sk) {
        const size_t gofs = koff + (size_t)(t0 + r) * D + c8;
        kv = *reinterpret_cast<const uint4*>(k + gofs);
        vv = *reinterpret_cast<const uint4*>(v + gofs);
      }
      *reinterpret_cast<uint4*>(&ks[r][c8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c8 + e][r] = ve[e];
    }
    __syncthreads();

    float s[kMmaBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kc * 16 + 2 * t];
        mma16816(s[nt], qf[kc], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * t + (e & 1);
        const bool masked = key >= len || (causal && key > (e < 2 ? r0 : r1));
        s[nt][e] = masked ? kNeg : s[nt][e] * scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row's 8 keys of a tile sit on 4 lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * t + (e & 1);
        const bool masked = key >= len || (causal && key > (e < 2 ? r0 : r1));
        // explicit zero: on a fully masked row s == m and exp would be 1
        const float p = masked ? 0.f : expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = alpha[h] * l[h] + ps[h];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = &vt[dt * 8 + g][kc * 16 + 2 * t];
        mma16816(oacc[dt], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= sq) continue;
    const bool nonempty = l[h] > 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float lo = nonempty ? oacc[dt][2 * h] / l[h] : 0.f;
      const float hi = nonempty ? oacc[dt][2 * h + 1] / l[h] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(o + qoff + (size_t)row * D + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(lo, hi);
    }
    if (t == 0) lse[(size_t)bh * sq + row] = nonempty ? m[h] + logf(l[h]) : kNeg;
  }
}

template <typename T, int D>
void launch_dim(const void* q, const void* k, const void* v, const int* lens,
                void* o, float* lse, int bh, int sq, int sk, float scale,
                int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (sq < kDecodeRows) {
    flash_fwd_decode_kernel<T, D><<<dim3(sq, bh), kWarps * 32, 0, stream>>>(
        qt, kt, vt, lens, ot, lse, sq, sk, scale, causal);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    flash_fwd_mma_kernel<D><<<dim3((sq + kMmaBQ - 1) / kMmaBQ, bh), kMmaWarps * 32, 0,
                              stream>>>(qt, kt, vt, lens, ot, lse, sq, sk, scale, causal);
  } else {
    flash_fwd_rows_kernel<T, D><<<dim3((sq + kBQ - 1) / kBQ, bh), kWarps * 32, 0, stream>>>(
        qt, kt, vt, lens, ot, lse, sq, sk, scale, causal);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens, void* o,
           float* lse, int bh, int sq, int sk, int d, float scale, int causal,
           cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                       \
  case DIM:                                                                   \
    launch_dim<T, DIM>(q, k, v, lens, o, lse, bh, sq, sk, scale, causal, stream); \
    break;
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (bh, sq, d), k and v (bh, sk, d), all
// contiguous and 16-byte aligned; lens (bh,) int32; o like q; lse (bh, sq)
// float32. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const int* lens, void* o, float* lse, int bh, int sq,
                         int sk, int d, float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
