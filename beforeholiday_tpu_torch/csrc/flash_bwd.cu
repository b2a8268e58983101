// K4: flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/ops/attention.py:305 _fa_dq_kernel and :342
// _fa_dkv_kernel with their shared recompute _block_p_ds (:265), launched by
// _fa_bwd_pallas (:389, calls at :406 and :428). Same function: from q, k, v,
// the forward's o and lse, and the output cotangent do (plus, when the caller
// differentiates through lse, its cotangent dlse), recompute
//   p_ij  = exp(scale * q_i.k_j - lse_i)   (0 where masked),
//   dp_ij = do_i.v_j,
//   ds_ij = p_ij * (dp_ij - delta_i + dlse_i) * scale,  delta_i = do_i.o_i,
// and return dq = ds k, dk = ds^T q, dv = p^T do. Masks are the forward's:
// keys at or past lens[bh], and keys past the row when causal. Dropout is not
// ported (the GPT path runs without it).
//
// Bound on an H100, the training shape BH 256, S 1024, D 64, causal, bf16:
// 134.3M live (query, key) pairs; the five products (q.k and do.v recomputed,
// ds.k, ds^T.q, p^T.do) make 10 * pairs * D = 86.0 GFLOP, 0.087 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against 268 MB of q, k, v, o, do in and
// dq, dk, dv out (0.080 ms). The backward is on the line between the two.
//
// Three launches, all deterministic (no atomics):
// * flash_bwd_delta_kernel: one warp per query row writes dd = delta - dlse
//   in fp32. The TPU recomputes delta in every block (:298); a pre-pass reads
//   do and o once. dlse is read here only, and only when it is given.
// * dq: one block per 64 query rows (bf16, mma.sync) or 8 rows (fp32, CUDA
//   cores) walks the key tiles up to the block's last causal diagonal,
//   recomputes p and ds in registers and accumulates ds k in fp32.
// * dk/dv: one block per 64 keys (bf16) or 8 keys (fp32) walks the query
//   tiles from its first causal diagonal, and accumulates p^T do and
//   ds^T q. Both skip dead tiles (the TPU's :323 and :362) and keys past
//   lens give exact zeros.
// The tensor-core kernels round p and ds to bf16 for their products, as the
// TPU kernel rounds them to the operand dtype; sums stay fp32. Rows with
// lens = 0 (lse = -1e30) never reach an exp: their key range is empty, so
// their gradients are exact zeros, never NaN. Still open (later work):
// cp.async/TMA pipelining, wgmma, and register tiling for D = 128.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kDeltaRows = 8;          // query rows per block of the pre-pass
constexpr int kRowsB = 2;              // fp32: query rows (dq) or keys (dkv) per warp
constexpr int kBlkB = kWarps * kRowsB; // fp32: rows or keys per block
constexpr int kTile = 32;              // fp32: keys (dq) or queries (dkv) per tile
constexpr int kMmaBlk = 16 * kWarps;   // bf16: query rows (dq) or keys (dkv) per block
constexpr int kMmaTile = 32;           // bf16: keys (dq) or queries (dkv) per tile

// dd[row] = sum_d do*o - dlse[row] (dlse may be null)
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaRows * 32)
flash_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                       const float* __restrict__ dlse, float* __restrict__ dd,
                       int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDeltaRows + warp;
  if (row >= rows) return;
  const size_t off = (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(to_float(dout[off + c]), to_float(o[off + c]), s);
  s = warp_sum(s);
  if (lane == 0) dd[row] = s - (dlse != nullptr ? dlse[row] : 0.f);
}

// ------------------------------------------------------------ fp32 (CUDA cores)

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq,
                         int sq, int sk, float scale, int causal) {
  constexpr int kCols = (D + 31) / 32;
  __shared__ float qs[kBlkB][D], dos[kBlkB][D];
  __shared__ float ks[kTile][D + 1], vs[kTile][D + 1];  // +1: lane j reads row j

  const int bh = blockIdx.y, q0 = blockIdx.x * kBlkB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kBlkB, sq)) : len;

  for (int i = threadIdx.x; i < kBlkB * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < sq;
    qs[r][c] = in ? q[qoff + (size_t)(q0 + r) * D + c] : 0.f;
    dos[r][c] = in ? dout[qoff + (size_t)(q0 + r) * D + c] : 0.f;
  }
  float lr[kRowsB], dr[kRowsB], acc[kRowsB][kCols];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
    const int row = q0 + warp * kRowsB + r;
    lr[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    dr[r] = row < sq ? dd[(size_t)bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = 0; t0 < kend; t0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < sk;
      ks[r][c] = in ? k[koff + (size_t)(t0 + r) * D + c] : 0.f;
      vs[r][c] = in ? v[koff + (size_t)(t0 + r) * D + c] : 0.f;
    }
    __syncthreads();
    float s[kRowsB], dp[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d], vd = vs[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        s[r] = fmaf(qs[warp * kRowsB + r][d], kd, s[r]);
        dp[r] = fmaf(dos[warp * kRowsB + r][d], vd, dp[r]);
      }
    }
    const int key = t0 + lane;
    float ds[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int row = q0 + warp * kRowsB + r;
      const bool masked = key >= len || row >= sq || (causal && key > row);
      const float p = masked ? 0.f : expf(s[r] * scale - lr[r]);
      ds[r] = p * (dp[r] - dr[r]) * scale;
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < D ? ks[j][col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
    const int row = q0 + warp * kRowsB + r;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[qoff + (size_t)row * D + col] = acc[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, float* __restrict__ dk,
                          float* __restrict__ dv, int sq, int sk, float scale,
                          int causal) {
  constexpr int kCols = (D + 31) / 32;
  __shared__ float kss[kBlkB][D], vss[kBlkB][D];
  __shared__ float qs[kTile][D + 1], dos[kTile][D + 1];  // +1: lane i reads row i
  __shared__ float ls[kTile], ds_[kTile];

  const int bh = blockIdx.y, k0 = blockIdx.x * kBlkB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);

  for (int i = threadIdx.x; i < kBlkB * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < sk;
    kss[r][c] = in ? k[koff + (size_t)(k0 + r) * D + c] : 0.f;
    vss[r][c] = in ? v[koff + (size_t)(k0 + r) * D + c] : 0.f;
  }
  float dka[kRowsB][kCols], dva[kRowsB][kCols];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[r][c] = dva[r][c] = 0.f;

  // keys at or past len get no gradient; causal: no query before k0 sees them
  const int qbeg = causal ? (k0 / kTile) * kTile : 0;
  const int qend = k0 < len ? sq : 0;
  for (int t0 = qbeg; t0 < qend; t0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < sq;
      qs[r][c] = in ? q[qoff + (size_t)(t0 + r) * D + c] : 0.f;
      dos[r][c] = in ? dout[qoff + (size_t)(t0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int row = t0 + threadIdx.x;
      ls[threadIdx.x] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      ds_[threadIdx.x] = row < sq ? dd[(size_t)bh * sq + row] : 0.f;
    }
    __syncthreads();
    const int qi = t0 + lane;
    float p[kRowsB], ds[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int kr = warp * kRowsB + r, key = k0 + kr;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[lane][d], kss[kr][d], s);
        dp = fmaf(dos[lane][d], vss[kr][d], dp);
      }
      const bool masked = key >= len || qi >= sq || (causal && key > qi);
      p[r] = masked ? 0.f : expf(s * scale - ls[lane]);
      ds[r] = p[r] * (dp - ds_[lane]) * scale;
    }
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float qc[kCols], dc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        qc[c] = col < D ? qs[i][col] : 0.f;
        dc[c] = col < D ? dos[i][col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        const float pi = __shfl_sync(0xffffffffu, p[r], i);
        const float dsi = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dva[r][c] = fmaf(pi, dc[c], dva[r][c]);
          dka[r][c] = fmaf(dsi, qc[c], dka[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
    const int key = k0 + warp * kRowsB + r;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dk[koff + (size_t)key * D + col] = dka[r][c];
        dv[koff + (size_t)key * D + col] = dva[r][c];
      }
    }
  }
}

// ------------------------------------------------------- bf16 (tensor cores)

// a warp's 16 rows of a (rows, D) bf16 matrix as m16n8k16 A fragments; rows
// at or past n read as zero
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base, int r0,
                                            int n, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    f[kc][0] = r0 < n ? ld32(base + (size_t)r0 * D + c) : 0u;
    f[kc][1] = r1 < n ? ld32(base + (size_t)r1 * D + c) : 0u;
    f[kc][2] = r0 < n ? ld32(base + (size_t)r0 * D + c + 8) : 0u;
    f[kc][3] = r1 < n ? ld32(base + (size_t)r1 * D + c + 8) : 0u;
  }
}

// stage rows [r0, r0 + kMmaTile) of two (n, D) bf16 matrices into shared
// memory, row-major (a, b) and transposed (at, bt); rows at or past n are 0
template <int D, int kDS, int kTS>
__device__ __forceinline__ void stage_tile(
    const __nv_bfloat16* a, const __nv_bfloat16* b, int r0, int n,
    __nv_bfloat16 (*as)[kDS], __nv_bfloat16 (*bs)[kDS],
    __nv_bfloat16 (*at)[kTS], __nv_bfloat16 (*bt)[kTS]) {
  for (int i = threadIdx.x; i < kMmaTile * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 av = make_uint4(0u, 0u, 0u, 0u), bv = av;
    if (r0 + r < n) {
      av = *reinterpret_cast<const uint4*>(a + (size_t)(r0 + r) * D + c8);
      bv = *reinterpret_cast<const uint4*>(b + (size_t)(r0 + r) * D + c8);
    }
    if (as != nullptr) *reinterpret_cast<uint4*>(&as[r][c8]) = av;
    if (bs != nullptr) *reinterpret_cast<uint4*>(&bs[r][c8]) = bv;
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&av);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (at != nullptr) at[c8 + e][r] = ae[e];
      if (bt != nullptr) bt[c8 + e][r] = be[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        const int* __restrict__ lens, __nv_bfloat16* __restrict__ dq,
                        int sq, int sk, float scale, int causal) {
  constexpr int kDS = D + 8;         // padded rows: fragment loads hit distinct banks
  constexpr int kTS = kMmaTile + 8;  // padded rows of the transposed tile
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaTile][kDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaTile][kDS];
  __shared__ __align__(16) __nv_bfloat16 kt[D][kTS];

  const int bh = blockIdx.y, q0 = blockIdx.x * kMmaBlk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kMmaBlk, sq)) : len;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_rows<D>(qf, q + qoff, r0, sq, t);
  load_a_rows<D>(df, dout + qoff, r0, sq, t);
  const float l0 = r0 < sq ? lse[(size_t)bh * sq + r0] : 0.f;
  const float l1 = r1 < sq ? lse[(size_t)bh * sq + r1] : 0.f;
  const float d0 = r0 < sq ? dd[(size_t)bh * sq + r0] : 0.f;
  const float d1 = r1 < sq ? dd[(size_t)bh * sq + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int t0 = 0; t0 < kend; t0 += kMmaTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<D, kDS, kTS>(k + koff, v + koff, t0, sk, ks, vs, kt, nullptr);
    __syncthreads();

    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kc * 16 + 2 * t];
        const __nv_bfloat16* vp = &vs[nt * 8 + g][kc * 16 + 2 * t];
        mma16816(s[nt], qf[kc], ld32(kp), ld32(kp + 8));
        mma16816(dp[nt], df[kc], ld32(vp), ld32(vp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMmaTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool masked = key >= len || row >= sq || (causal && key > row);
        const float p = masked ? 0.f : expf(s[nt][e] * scale - (e < 2 ? l0 : l1));
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? d0 : d1)) * scale;  // ds
      }
    }
#pragma unroll
    for (int kc = 0; kc < kMmaTile / 16; ++kc) {
      uint32_t a[4];
      pack_c_as_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* kp = &kt[dt * 8 + g][kc * 16 + 2 * t];
        mma16816(acc[dt], a, ld32(kp), ld32(kp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= sq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + (size_t)row * D + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * h], acc[dt][2 * h + 1]);
  }
}

// The dk/dv kernel works on the transposed problem: a warp owns 16 keys and
// computes S^T = K Q^T and dP^T = V dO^T for a tile of queries, so its C
// tiles hold (key, query) pairs and become the A fragments of P^T dO and
// dS^T Q in place.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk, float scale,
                         int causal) {
  constexpr int kDS = D + 8;
  constexpr int kTS = kMmaTile + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaTile][kDS];
  __shared__ __align__(16) __nv_bfloat16 dos[kMmaTile][kDS];
  __shared__ __align__(16) __nv_bfloat16 qt[D][kTS];
  __shared__ __align__(16) __nv_bfloat16 dot[D][kTS];
  __shared__ float ls[kMmaTile], dds[kMmaTile];

  const int bh = blockIdx.y, k0 = blockIdx.x * kMmaBlk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_rows<D>(kf, k + koff, key0, sk, t);
  load_a_rows<D>(vf, v + koff, key0, sk, t);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  // keys at or past len get no gradient; causal: no query before k0 sees them
  const int qbeg = causal ? (k0 / kMmaTile) * kMmaTile : 0;
  const int qend = k0 < len ? sq : 0;
  for (int t0 = qbeg; t0 < qend; t0 += kMmaTile) {
    __syncthreads();
    stage_tile<D, kDS, kTS>(q + qoff, dout + qoff, t0, sq, qs, dos, qt, dot);
    if (threadIdx.x < kMmaTile) {
      const int row = t0 + threadIdx.x;
      ls[threadIdx.x] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      dds[threadIdx.x] = row < sq ? dd[(size_t)bh * sq + row] : 0.f;
    }
    __syncthreads();

    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* qp = &qs[nt * 8 + g][kc * 16 + 2 * t];
        const __nv_bfloat16* dp_ = &dos[nt * 8 + g][kc * 16 + 2 * t];
        mma16816(s[nt], kf[kc], ld32(qp), ld32(qp + 8));
        mma16816(dp[nt], vf[kc], ld32(dp_), ld32(dp_ + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMmaTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1), qi = t0 + ql;
        const int key = e < 2 ? key0 : key1;
        const bool masked = key >= len || qi >= sq || (causal && key > qi);
        const float p = masked ? 0.f : expf(s[nt][e] * scale - ls[ql]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dds[ql]) * scale;  // ds
      }
    }
#pragma unroll
    for (int kc = 0; kc < kMmaTile / 16; ++kc) {
      uint32_t ap[4], ads[4];
      pack_c_as_a(ap, s[2 * kc], s[2 * kc + 1]);
      pack_c_as_a(ads, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* op = &dot[dt * 8 + g][kc * 16 + 2 * t];
        const __nv_bfloat16* qp = &qt[dt * 8 + g][kc * 16 + 2 * t];
        mma16816(dva[dt], ap, ld32(op), ld32(op + 8));
        mma16816(dka[dt], ads, ld32(qp), ld32(qp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key1 : key0;
    if (key >= sk) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t o = koff + (size_t)key * D + dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[dt][2 * h], dka[dt][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[dt][2 * h], dva[dt][2 * h + 1]);
    }
  }
}

template <typename T, int D>
int launch_dim(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, const float* dlse,
               const int* lens, void* dq, void* dk, void* dv, float* dd, int bh,
               int sq, int sk, float scale, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const int rows = bh * sq;
  flash_bwd_delta_kernel<T, D><<<(rows + kDeltaRows - 1) / kDeltaRows, kDeltaRows * 32, 0,
                                  stream>>>(dt, static_cast<const T*>(o), dlse, dd, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    flash_bwd_dq_mma_kernel<D><<<dim3((sq + kMmaBlk - 1) / kMmaBlk, bh), kWarps * 32, 0,
                                 stream>>>(qt, kt, vt, dt, lse, dd, lens,
                                           static_cast<T*>(dq), sq, sk, scale, causal);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    flash_bwd_dkv_mma_kernel<D><<<dim3((sk + kMmaBlk - 1) / kMmaBlk, bh), kWarps * 32, 0,
                                  stream>>>(qt, kt, vt, dt, lse, dd, lens,
                                            static_cast<T*>(dk), static_cast<T*>(dv), sq,
                                            sk, scale, causal);
  } else {
    flash_bwd_dq_rows_kernel<D><<<dim3((sq + kBlkB - 1) / kBlkB, bh), kWarps * 32, 0,
                                  stream>>>(qt, kt, vt, dt, lse, dd, lens,
                                            static_cast<T*>(dq), sq, sk, scale, causal);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    flash_bwd_dkv_rows_kernel<D><<<dim3((sk + kBlkB - 1) / kBlkB, bh), kWarps * 32, 0,
                                   stream>>>(qt, kt, vt, dt, lse, dd, lens,
                                             static_cast<T*>(dk), static_cast<T*>(dv), sq,
                                             sk, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, const float* dlse, const int* lens, void* dq, void* dk,
           void* dv, float* dd, int bh, int sq, int sk, int d, float scale, int causal,
           cudaStream_t stream) {
#define FLASH_BWD_CASE(DIM)                                                          \
  case DIM:                                                                          \
    return launch_dim<T, DIM>(q, k, v, o, dout, lse, dlse, lens, dq, dk, dv, dd, bh, \
                              sq, sk, scale, causal, stream);
  switch (d) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(112)
    FLASH_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq (bh, sq, d); k, v, dk, dv
// (bh, sk, d), all contiguous and 16-byte aligned; lse and dd (bh, sq) fp32,
// dd scratch; dlse (bh, sq) fp32 or null; lens (bh,) int32. Returns the CUDA
// error of the first launch that failed (0 on success).
extern "C" int flash_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* dlse, const int* lens, void* dq, void* dk,
                         void* dv, float* dd, int bh, int sq, int sk, int d, float scale,
                         int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;  // the caller zero-fills
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, lse, dlse, lens, dq, dk, dv, dd, bh, sq, sk, d,
                         scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dlse, lens, dq, dk, dv, dd, bh,
                                 sq, sk, d, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
