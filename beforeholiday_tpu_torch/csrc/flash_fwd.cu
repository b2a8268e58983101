// K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/ops/attention.py:152 _fa_fwd_kernel, its mask
// predicate _mask (:119) and its dropout _keep_mask (:130), launched by
// _fa_fwd_pallas (:244). Same function: for every (bh, query row) the
// softmax over keys k < lens[bh] (and k <= row when causal) of scale * q.k,
// times v, with the running max m, normaliser l and accumulator in fp32
// (online softmax). A fully masked row gives o = 0 and lse = -1e30. lse comes
// back as a plain (BH, Sq) fp32 array, not the TPU's lane-replicated (BQ,
// 128) block. With dropout (a key given) each probability is kept with the
// bit of csrc/philox.cuh at (bh, row, key) and scaled by 1 / (1 - rate) for
// the product with v, while l sums the undropped p: o = softmax -> dropout
// -> @ v, the TPU kernel's order (:188-197).
//
// Bound on an H100: at the serving shapes both calls are bound by bytes.
// Causal prefill BH=128, S=1024, D=64 in bf16 moves 67.1 MB (q, k, v read
// once, o written once; 20.0 us at 3.35 TB/s) for 17.2 GFLOP (17.4 us at the
// 989 TFLOP/s bf16 tensor-core peak). Decode BH=512, Sq=1, Sk=1024 reads
// 134 MB of K/V (40 us) for 0.27 GFLOP. With dropout the hash adds about
// 26.5 32-bit integer operations a live (query, key) pair (a quarter of one
// Philox4x32-10 call), 3.6 G at the causal training shape BH 256, S 1024:
// 53 us at 67 Tops/s, above the bytes and the products, so the dropout
// kernel is bound by its integer work. Each thread hashes the 2x2 tiles its
// scores touch and uses half of each call.
//
// Three kernels, chosen by shape, dtype and head dim in launch():
// * flash_fwd_decode_kernel (Sq < 16, decode; D in 16..128 step 16): one
//   block per (query row, bh); its 4 warps split the key tiles round-robin,
//   each lane scores one key per tile from a 16-byte-vector read of its K
//   row, and the warps merge their (m, l, acc) through shared memory at the
//   end. Decode is a stream over K/V: the split keeps 4x more loads in
//   flight than one warp per row.
// * flash_fwd_mma_kernel (bf16, Sq >= 16, D in 16..128 step 16, prefill):
//   tensor cores through mma.sync m16n8k16 with fp32 accumulation. A block
//   owns 64 query rows (16 per warp, Q fragments held in registers) and
//   walks 64-key tiles of K and transposed V staged in padded shared memory
//   (conflict-free fragment loads). The scores stay in registers; p is
//   rounded to bf16 for the p.v product, as the TPU kernel rounds p to v's
//   dtype, while the normaliser l sums the fp32 p.
// * flash_fwd_rows_kernel (fp32 at every head dim; bf16 at the head dims the
//   tensor-core kernels do not take, 8..512): CUDA cores in fp32, 16 query
//   rows per block (4 per warp), 32-key tiles staged in dynamic shared memory
//   (163 KB at D 512, allowed above the default 48 KB), lane j scores key j
//   and owns output columns lane + 32 c, c < kCols = 1, 2, 4, 8 or 16 by
//   head dim, the ragged last one masked. The bf16 variant rounds p to bf16
//   for p.v as the mma path does. fp32 is the exact path the card-side checks
//   compare tightly.
// All three skip tiles wholly past lens or past the block's last causal
// diagonal and mask the ragged edge themselves. Still open (later work):
// cp.async/TMA pipelining of the tile loads, wgmma, and reading the paged
// cache in place instead of a gathered copy.

#include <type_traits>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per tile: lane j owns key j
constexpr int kDecodeRows = 16;       // fewer query rows than this: decode kernel
constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per tensor-core block
constexpr int kMmaBK = 64;              // keys per tensor-core tile

// shared memory of the row kernel: q (kBQ x d), k (kBK x (d + 1): lane j reads
// row j at column c, distinct banks) and v (kBK x d), in fp32
size_t rows_smem(int d) { return sizeof(float) * (kBQ * d + kBK * (d + 1) + kBK * d); }

template <typename T, int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lens,
                      T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int D,
                      float scale, int causal, DropArgs drop) {
  extern __shared__ float smem[];
  float* qs = smem;                // [kBQ][D]
  float* ks = qs + kBQ * D;        // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);  // [kBK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;
  const int rbase = q0 + warp * kRows;  // even: its rows pair into hash tiles

  const int len = min(max(lens[bh], 0), sk);
  // keys any row of this block can see
  const int kend = causal ? min(len, min(q0 + kBQ, sq)) : len;
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(drop);

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[i] = (q0 + r < sq) ? to_float(q[qoff + (size_t)(q0 + r) * D + c]) : 0.f;
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
      ks[r * (D + 1) + c] = in ? to_float(k[g]) : 0.f;
      vs[i] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* qr = qs + warp * kRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qr[r * D + d], kd, s[r]);
    }

    const int key = t0 + lane;
    uint32_t tiles[kRows / 2];
    if constexpr (kDrop) {
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) tiles[j] = keep_tile(dk, bh, rbase + 2 * j, key);
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = rbase + r;
      const bool masked = key >= len || (causal && key > row);
      const float sr = masked ? kNeg : s[r] * scale;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      // explicit zero: on a fully masked row sr == m_new and exp would be 1
      p[r] = masked ? 0.f : expf(sr - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);  // the undropped p
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      if constexpr (kDrop) p[r] = kept(tiles[r >> 1], row, key) ? p[r] * drop.inv_keep : 0.f;
      p[r] = round_to(p[r], static_cast<T*>(nullptr));  // bf16: as the mma path
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < D ? vs[j * D + col] : 0.f;
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
    const int row = rbase + r;
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


template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ o, float* __restrict__ lse,
                        int sq, int sk, float scale, int causal, DropArgs drop) {
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
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(drop);

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
    float p = live ? expf(s - m_new) : 0.f;
    l = alpha * l + warp_sum(p);  // the undropped p
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    m = m_new;
    if constexpr (kDrop) {
      if (live) p = kept(keep_tile(dk, bh, row, key), row, key) ? p * drop.inv_keep : 0.f;
    }
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

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3); B holds
// column g at rows 2t, 2t+1 and 2t+8, 2t+9; C holds rows g (0, 1) and g + 8
// (2, 3) at columns 2t, 2t+1. So a thread owns query rows r0 = g and r1 = g+8
// of its warp's 16, and S's accumulators become P's A fragments in place. Its
// two keys 2t, 2t+1 of a row share one hash tile.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ lens, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale,
                     int causal, DropArgs drop) {
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
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(drop);

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
      const int key0 = t0 + nt * 8 + 2 * t;
      uint32_t tiles[2];
      if constexpr (kDrop) {
        tiles[0] = keep_tile(dk, bh, r0, key0);
        tiles[1] = keep_tile(dk, bh, r1, key0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e & 1), row = e < 2 ? r0 : r1;
        const bool masked = key >= len || (causal && key > row);
        // explicit zero: on a fully masked row s == m and exp would be 1
        float p = masked ? 0.f : expf(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += p;  // l sums the undropped p
        if constexpr (kDrop) p = kept(tiles[e >> 1], row, key) ? p * drop.inv_keep : 0.f;
        s[nt][e] = p;
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
      uint32_t a[4];
      pack_c_as_a(a, s[2 * kc], s[2 * kc + 1]);
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

struct Args {
  const void *q, *k, *v;
  const int* lens;
  void* o;
  float* lse;
  int bh, sq, sk, d;
  float scale;
  int causal;
  DropArgs drop;
  cudaStream_t stream;
};

template <typename T, int kCols, bool kDrop>
int launch_rows(const Args& a) {
  auto kernel = flash_fwd_rows_kernel<T, kCols, kDrop>;
  const size_t smem = rows_smem(a.d);
  int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3((a.sq + kBQ - 1) / kBQ, a.bh), kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lens, static_cast<T*>(a.o), a.lse, a.sq, a.sk, a.d, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDrop>
int launch_rows_any(const Args& a) {
  switch (cols_for(a.d)) {
    case 1: return launch_rows<T, 1, kDrop>(a);
    case 2: return launch_rows<T, 2, kDrop>(a);
    case 4: return launch_rows<T, 4, kDrop>(a);
    case 8: return launch_rows<T, 8, kDrop>(a);
    default: return launch_rows<T, 16, kDrop>(a);
  }
}

// the head dims the decode and tensor-core kernels are built for
template <typename T, int D, bool kDrop>
int launch_dim(const Args& a) {
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  T* ot = static_cast<T*>(a.o);
  if (a.sq < kDecodeRows) {
    flash_fwd_decode_kernel<T, D, kDrop><<<dim3(a.sq, a.bh), kWarps * 32, 0, a.stream>>>(
        qt, kt, vt, a.lens, ot, a.lse, a.sq, a.sk, a.scale, a.causal, a.drop);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    flash_fwd_mma_kernel<D, kDrop><<<dim3((a.sq + kMmaBQ - 1) / kMmaBQ, a.bh), kMmaWarps * 32,
                                     0, a.stream>>>(qt, kt, vt, a.lens, ot, a.lse, a.sq, a.sk,
                                                    a.scale, a.causal, a.drop);
  } else {
    return launch_rows<T, cols_for(D), kDrop>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDrop>
int launch(const Args& a) {
#define FLASH_CASE(DIM) \
  case DIM:             \
    return launch_dim<T, DIM, kDrop>(a);
  switch (a.d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return launch_rows_any<T, kDrop>(a);
  }
#undef FLASH_CASE
}

template <typename T>
int launch_drop(const Args& a) {
  return a.drop.key != nullptr ? launch<T, true>(a) : launch<T, false>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (bh, sq, d), k and v (bh, sk, d), all
// contiguous and 16-byte aligned, d in 8..512; lens (bh,) int32; o like q;
// lse (bh, sq) float32. key: null for no dropout, else int64 (2,) on the
// card, with threshold = round((1 - rate) 2^24) and inv_keep = 1 / (1 -
// rate). Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const int* lens, void* o, float* lse, int bh, int sq,
                         int sk, int d, float scale, int causal, const long long* key,
                         unsigned threshold, float inv_keep, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || d < 8 || d > 512) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
               DropArgs{key, threshold, inv_keep}, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_drop<float>(a);
  if (dtype == 1) return launch_drop<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
