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
// keys at or past lens[bh], and keys past the row when causal. With dropout
// (a key given) the forward's keep bit of csrc/philox.cuh at (bh, row, key)
// regenerates: dv takes z = keep p / (1 - rate), dp becomes keep dp /
// (1 - rate), and ds keeps the undropped p with delta still do.o, because
// sum_k dp~_ik p_ik = do_i . o_i (the TPU docstring at :278-282).
//
// Bound on an H100, the training shape BH 256, S 1024, D 64, causal, bf16:
// 134.3M live (query, key) pairs; the five products (q.k and do.v recomputed,
// ds.k, ds^T.q, p^T.do) make 10 * pairs * D = 86.0 GFLOP, 0.087 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against 268 MB of q, k, v, o, do in and
// dq, dk, dv out (0.080 ms). The backward is on the line between the two.
// With dropout both the dq and the dk/dv pass hash every live pair (about
// 26.5 integer operations a pair counted once, 53 us at 67 Tops/s).
//
// Three launches, all deterministic (no atomics):
// * flash_bwd_delta_kernel: one warp per query row writes dd = delta - dlse
//   in fp32. The TPU recomputes delta in every block (:298); a pre-pass reads
//   do and o once. dlse is read here only, and only when it is given.
// * dq: one block per 64 query rows (bf16, mma.sync) or 8 rows (CUDA cores)
//   walks the key tiles up to the block's last causal diagonal, recomputes p
//   and ds in registers and accumulates ds k in fp32.
// * dk/dv: one block per 64 keys (bf16, mma.sync) or 8 keys (CUDA cores)
//   walks the query tiles from its first causal diagonal, and accumulates
//   p^T do and ds^T q. Both skip dead tiles (the TPU's :323 and :362) and
//   keys past lens give exact zeros.
// The tensor-core kernels (bf16, D in 16..128 step 16) round p and ds to
// bf16 for their products, as the TPU kernel rounds them to the operand
// dtype; sums stay fp32. The CUDA-core row kernels take fp32 at every head
// dim and bf16 at the others (8..512): a lane owns output columns lane +
// 32 c, c < kCols = 1, 2, 4, 8 or 16 by head dim, with the ragged last one
// masked, the tiles sit in dynamic shared memory (164 KB at D 512), and the
// bf16 variant rounds p and ds as the tensor-core kernels do. Rows with
// lens = 0 (lse = -1e30) never reach an exp: their key range is empty, so
// their gradients are exact zeros, never NaN. Still open (later work):
// cp.async/TMA pipelining, wgmma, and register tiling for D = 128.

#include <type_traits>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kDeltaRows = 8;          // query rows per block of the pre-pass
constexpr int kRowsB = 2;              // rows kernels: query rows (dq) or keys (dkv) per warp
constexpr int kBlkB = kWarps * kRowsB; // rows kernels: rows or keys per block
constexpr int kTile = 32;              // rows kernels: keys (dq) or queries (dkv) per tile
constexpr int kMmaBlk = 16 * kWarps;   // bf16: query rows (dq) or keys (dkv) per block
constexpr int kMmaTile = 32;           // bf16: keys (dq) or queries (dkv) per tile

// dd[row] = sum_d do*o - dlse[row] (dlse may be null); the head dim is kD,
// or d at run time where kD is 0
template <typename T, int kD>
__global__ void __launch_bounds__(kDeltaRows * 32)
flash_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                       const float* __restrict__ dlse, float* __restrict__ dd,
                       int rows, int d) {
  const int D = kD > 0 ? kD : d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDeltaRows + warp;
  if (row >= rows) return;
  const size_t off = (size_t)row * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(to_float(dout[off + c]), to_float(o[off + c]), s);
  s = warp_sum(s);
  if (lane == 0) dd[row] = s - (dlse != nullptr ? dlse[row] : 0.f);
}

// ------------------------------------------------------------ CUDA cores

// shared memory of the dq row kernel: q and do (kBlkB x d), k and v (kTile x
// (d + 1): lane j reads row j, distinct banks), in fp32
size_t dq_rows_smem(int d) { return sizeof(float) * (2 * kBlkB * d + 2 * kTile * (d + 1)); }
// of the dk/dv row kernel: k and v (kBlkB x d), q and do (kTile x (d + 1)),
// and the tile's lse and dd
size_t dkv_rows_smem(int d) {
  return sizeof(float) * (2 * kBlkB * d + 2 * kTile * (d + 1) + 2 * kTile);
}

template <typename T, int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, T* __restrict__ dq,
                         int sq, int sk, int D, float scale, int causal, DropArgs drop) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBlkB][D]
  float* dos = qs + kBlkB * D;           // [kBlkB][D]
  float* ks = dos + kBlkB * D;           // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);      // [kTile][D + 1]

  const int bh = blockIdx.y, q0 = blockIdx.x * kBlkB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kBlkB, sq)) : len;
  const int rbase = q0 + warp * kRowsB;  // even: its two rows share a hash tile
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(drop);

  for (int i = threadIdx.x; i < kBlkB * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < sq;
    qs[i] = in ? to_float(q[qoff + (size_t)(q0 + r) * D + c]) : 0.f;
    dos[i] = in ? to_float(dout[qoff + (size_t)(q0 + r) * D + c]) : 0.f;
  }
  float lr[kRowsB], dr[kRowsB], acc[kRowsB][kCols];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
    const int row = rbase + r;
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
      ks[r * (D + 1) + c] = in ? to_float(k[koff + (size_t)(t0 + r) * D + c]) : 0.f;
      vs[r * (D + 1) + c] = in ? to_float(v[koff + (size_t)(t0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
    float s[kRowsB], dp[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) s[r] = dp[r] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
    const float* qr = qs + warp * kRowsB * D;
    const float* dor = dos + warp * kRowsB * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        s[r] = fmaf(qr[r * D + d], kd, s[r]);
        dp[r] = fmaf(dor[r * D + d], vd, dp[r]);
      }
    }
    const int key = t0 + lane;
    uint32_t tile = 0;
    if constexpr (kDrop) tile = keep_tile(dk, bh, rbase, key);
    float ds[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int row = rbase + r;
      const bool masked = key >= len || row >= sq || (causal && key > row);
      const float p = masked ? 0.f : expf(s[r] * scale - lr[r]);
      float dpr = dp[r];
      if constexpr (kDrop) dpr = kept(tile, row, key) ? dpr * drop.inv_keep : 0.f;
      ds[r] = round_to(p * (dpr - dr[r]) * scale, static_cast<T*>(nullptr));
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < D ? ks[j * (D + 1) + col] : 0.f;
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
    const int row = rbase + r;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) store(&dq[qoff + (size_t)row * D + col], acc[r][c]);
    }
  }
}

template <typename T, int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, T* __restrict__ dk,
                          T* __restrict__ dv, int sq, int sk, int D, float scale,
                          int causal, DropArgs drop) {
  extern __shared__ float smem[];
  float* kss = smem;                     // [kBlkB][D]
  float* vss = kss + kBlkB * D;          // [kBlkB][D]
  float* qs = vss + kBlkB * D;           // [kTile][D + 1]: lane i reads row i
  float* dos = qs + kTile * (D + 1);     // [kTile][D + 1]
  float* ls = dos + kTile * (D + 1);     // [kTile]
  float* ds_ = ls + kTile;               // [kTile]

  const int bh = blockIdx.y, k0 = blockIdx.x * kBlkB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * sq * D, koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kbase = k0 + warp * kRowsB;  // even: its two keys share a hash tile
  DropKey dkey{};
  if constexpr (kDrop) dkey = load_drop_key(drop);

  for (int i = threadIdx.x; i < kBlkB * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < sk;
    kss[i] = in ? to_float(k[koff + (size_t)(k0 + r) * D + c]) : 0.f;
    vss[i] = in ? to_float(v[koff + (size_t)(k0 + r) * D + c]) : 0.f;
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
      qs[r * (D + 1) + c] = in ? to_float(q[qoff + (size_t)(t0 + r) * D + c]) : 0.f;
      dos[r * (D + 1) + c] = in ? to_float(dout[qoff + (size_t)(t0 + r) * D + c]) : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int row = t0 + threadIdx.x;
      ls[threadIdx.x] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      ds_[threadIdx.x] = row < sq ? dd[(size_t)bh * sq + row] : 0.f;
    }
    __syncthreads();
    const int qi = t0 + lane;
    uint32_t tile = 0;
    if constexpr (kDrop) tile = keep_tile(dkey, bh, qi, kbase);
    const float* qr = qs + lane * (D + 1);
    const float* dor = dos + lane * (D + 1);
    float p[kRowsB], ds[kRowsB];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int key = kbase + r;
      const float* kr = kss + (warp * kRowsB + r) * D;
      const float* vr = vss + (warp * kRowsB + r) * D;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      const bool masked = key >= len || qi >= sq || (causal && key > qi);
      const float pr = masked ? 0.f : expf(s * scale - ls[lane]);
      float z = pr;
      if constexpr (kDrop) {
        const bool keep = kept(tile, qi, key);
        z = keep ? pr * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      p[r] = round_to(z, static_cast<T*>(nullptr));
      ds[r] = round_to(pr * (dp - ds_[lane]) * scale, static_cast<T*>(nullptr));
    }
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float qc[kCols], dc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        qc[c] = col < D ? qs[i * (D + 1) + col] : 0.f;
        dc[c] = col < D ? dos[i * (D + 1) + col] : 0.f;
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
    const int key = kbase + r;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        store(&dk[koff + (size_t)key * D + col], dka[r][c]);
        store(&dv[koff + (size_t)key * D + col], dva[r][c]);
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

// a thread owns query rows r0, r1 = r0 + 8 and keys 2t, 2t+1 of each 8-key
// block: the two keys of a row share one hash tile
template <int D, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        const int* __restrict__ lens, __nv_bfloat16* __restrict__ dq,
                        int sq, int sk, float scale, int causal, DropArgs drop) {
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
  DropKey dkey{};
  if constexpr (kDrop) dkey = load_drop_key(drop);

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
      const int key0 = t0 + nt * 8 + 2 * t;
      uint32_t tiles[2] = {0u, 0u};
      if constexpr (kDrop) {
        tiles[0] = keep_tile(dkey, bh, r0, key0);
        tiles[1] = keep_tile(dkey, bh, r1, key0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool masked = key >= len || row >= sq || (causal && key > row);
        const float p = masked ? 0.f : expf(s[nt][e] * scale - (e < 2 ? l0 : l1));
        float dpe = dp[nt][e];
        if constexpr (kDrop) dpe = kept(tiles[e >> 1], row, key) ? dpe * drop.inv_keep : 0.f;
        s[nt][e] = p * (dpe - (e < 2 ? d0 : d1)) * scale;  // ds
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
// dS^T Q in place. A thread owns keys key0, key1 = key0 + 8 and queries 2t,
// 2t+1 of each 8-query block: the two queries of a key share one hash tile,
// the same tile that K2 and the dq kernel read at (query, key).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk, float scale,
                         int causal, DropArgs drop) {
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
  DropKey dkey{};
  if constexpr (kDrop) dkey = load_drop_key(drop);

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
      const int qa = t0 + nt * 8 + 2 * t;
      uint32_t tiles[2] = {0u, 0u};
      if constexpr (kDrop) {
        tiles[0] = keep_tile(dkey, bh, qa, key0);
        tiles[1] = keep_tile(dkey, bh, qa, key1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1), qi = t0 + ql;
        const int key = e < 2 ? key0 : key1;
        const bool masked = key >= len || qi >= sq || (causal && key > qi);
        const float p = masked ? 0.f : expf(s[nt][e] * scale - ls[ql]);
        float z = p, dpe = dp[nt][e];
        if constexpr (kDrop) {
          const bool keep = kept(tiles[e >> 1], qi, key);
          z = keep ? p * drop.inv_keep : 0.f;
          dpe = keep ? dpe * drop.inv_keep : 0.f;
        }
        s[nt][e] = z;
        dp[nt][e] = p * (dpe - dds[ql]) * scale;  // ds, with the undropped p
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

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *dlse;
  const int* lens;
  void *dq, *dk, *dv;
  float* dd;
  int bh, sq, sk, d;
  float scale;
  int causal;
  DropArgs drop;
  cudaStream_t stream;
};

template <typename T, int kD>
int launch_delta(const Args& a) {
  const int rows = a.bh * a.sq;
  flash_bwd_delta_kernel<T, kD><<<(rows + kDeltaRows - 1) / kDeltaRows, kDeltaRows * 32, 0,
                                  a.stream>>>(static_cast<const T*>(a.dout),
                                              static_cast<const T*>(a.o), a.dlse, a.dd, rows,
                                              a.d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCols, bool kDrop>
int launch_rows(const Args& a) {
  int err = launch_delta<T, 0>(a);
  if (err) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  auto dq_kernel = flash_bwd_dq_rows_kernel<T, kCols, kDrop>;
  auto dkv_kernel = flash_bwd_dkv_rows_kernel<T, kCols, kDrop>;
  const size_t dq_smem = dq_rows_smem(a.d), dkv_smem = dkv_rows_smem(a.d);
  err = allow_smem(dq_kernel, dq_smem);
  if (!err) err = allow_smem(dkv_kernel, dkv_smem);
  if (err) return err;
  dq_kernel<<<dim3((a.sq + kBlkB - 1) / kBlkB, a.bh), kWarps * 32, dq_smem, a.stream>>>(
      q, k, v, dout, a.lse, a.dd, a.lens, static_cast<T*>(a.dq), a.sq, a.sk, a.d, a.scale,
      a.causal, a.drop);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkv_kernel<<<dim3((a.sk + kBlkB - 1) / kBlkB, a.bh), kWarps * 32, dkv_smem, a.stream>>>(
      q, k, v, dout, a.lse, a.dd, a.lens, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq,
      a.sk, a.d, a.scale, a.causal, a.drop);
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

template <int D, bool kDrop>
int launch_mma(const Args& a) {
  using B = __nv_bfloat16;
  int err = launch_delta<B, D>(a);
  if (err) return err;
  const B* q = static_cast<const B*>(a.q);
  const B* k = static_cast<const B*>(a.k);
  const B* v = static_cast<const B*>(a.v);
  const B* dout = static_cast<const B*>(a.dout);
  flash_bwd_dq_mma_kernel<D, kDrop><<<dim3((a.sq + kMmaBlk - 1) / kMmaBlk, a.bh), kWarps * 32,
                                      0, a.stream>>>(q, k, v, dout, a.lse, a.dd, a.lens,
                                                     static_cast<B*>(a.dq), a.sq, a.sk,
                                                     a.scale, a.causal, a.drop);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dkv_mma_kernel<D, kDrop><<<dim3((a.sk + kMmaBlk - 1) / kMmaBlk, a.bh),
                                       kWarps * 32, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.dd, a.lens, static_cast<B*>(a.dk), static_cast<B*>(a.dv), a.sq,
      a.sk, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDrop>
int launch(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#define FLASH_BWD_CASE(DIM) \
  case DIM:                 \
    return launch_mma<DIM, kDrop>(a);
    switch (a.d) {
      FLASH_BWD_CASE(16)
      FLASH_BWD_CASE(32)
      FLASH_BWD_CASE(48)
      FLASH_BWD_CASE(64)
      FLASH_BWD_CASE(80)
      FLASH_BWD_CASE(96)
      FLASH_BWD_CASE(112)
      FLASH_BWD_CASE(128)
      default:
        break;
    }
#undef FLASH_BWD_CASE
  }
  return launch_rows_any<T, kDrop>(a);
}

template <typename T>
int launch_drop(const Args& a) {
  return a.drop.key != nullptr ? launch<T, true>(a) : launch<T, false>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq (bh, sq, d); k, v, dk, dv
// (bh, sk, d), all contiguous and 16-byte aligned, d in 8..512; lse and dd
// (bh, sq) fp32, dd scratch; dlse (bh, sq) fp32 or null; lens (bh,) int32.
// key: null for no dropout, else the forward's int64 (2,) key on the card,
// with threshold = round((1 - rate) 2^24) and inv_keep = 1 / (1 - rate).
// Returns the CUDA error of the first launch that failed (0 on success).
extern "C" int flash_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* dlse, const int* lens, void* dq, void* dk,
                         void* dv, float* dd, int bh, int sq, int sk, int d, float scale,
                         int causal, const long long* key, unsigned threshold,
                         float inv_keep, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;  // the caller zero-fills
  if (bh > 65535 || d < 8 || d > 512) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{q, k, v, o, dout, lse, dlse, lens, dq, dk, dv, dd, bh, sq, sk, d, scale, causal,
               DropArgs{key, threshold, inv_keep}, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_drop<float>(a);
  if (dtype == 1) return launch_drop<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
