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
// With dropout the hash counts about 26.5 integer operations a live pair
// once (53 us at 67 Tops/s).
//
// Three launches, all deterministic (no atomics):
// * flash_bwd_delta_kernel: one warp per query row writes dd = delta - dlse
//   in fp32. The TPU recomputes delta in every block (:298); a pre-pass reads
//   do and o once. dlse is read here only, and only when it is given.
// * dq: one block per 128 query rows (bf16, fp16) or 8 rows (CUDA cores) walks
//   the key tiles up to the block's last causal diagonal, recomputes p and
//   ds in registers and accumulates ds k in fp32. Recomputing s and dp here
//   instead of adding dq across the dk/dv blocks with atomics costs two of
//   the five products again (7/5 of the bound's operations) and keeps two
//   calls bitwise equal.
// * dk/dv: one block per 64 keys (bf16, fp16) or 8 keys (CUDA cores) walks the
//   query tiles from its first causal diagonal, and accumulates p^T do and
//   ds^T q. Both skip dead tiles (the TPU's :323 and :362) and keys past lens
//   give exact zeros.
// The tensor-core kernels (bf16 or fp16, D in 16..128 step 16) keep both units busy,
// as the bound asks: tiles arrive by TMA (3-D tensor maps over (D, S, BH):
// a ragged edge reads zeros, never the next head's rows) into a ring of
// shared-memory stages, the next tile landing while this one computes, in
// the 128-byte-swizzled layout that wgmma reads straight from shared memory;
// every product is a wgmma, the transposed operands (K in ds.k, Q and dO in
// ds^T.q and p^T.do) read through its transpose bit, so nothing is
// transposed or staged twice; p is one FFMA and one ex2 an element; the
// mask runs only on the diagonal, lens and sq tiles; causal dq blocks launch
// heaviest first; and with dropout the two lanes that share a 2x2 hash tile
// split its Philox call (keep_tiles_shared), so each pass hashes each live
// pair once, while the tile's s and dp are still on the tensor cores. They
// round p and ds to the operands' type (bf16 or fp16) for their products, as
// the TPU kernel rounds them to the operand dtype; sums stay fp32. fp16 shares
// bf16's layouts and fragments (both 16 bits); at a large loss scale its ds
// and its stored dq, dk, dv can overflow to inf, which the unscale's
// overflow flag then catches, as on the TPU. The CUDA-core row kernels take
// fp32 at every head dim and bf16 and fp16 at the others (8..512): a
// lane owns output columns lane + 32 c, c < kCols = 1, 2, 4, 8 or 16 by head
// dim, with the ragged last one masked, the tiles sit in dynamic shared
// memory (164 KB at D 512), and the half variants round p and ds as the
// tensor-core kernels do. Rows with lens = 0 (lse = -1e30) never reach an
// exp: their key range is empty, so their gradients are exact zeros, never
// NaN. Still open (later work): overlapping one tile's softmax with the
// next tile's wgmma (two consumer warpgroups taking turns), and reading the
// models' (B, S, H, D) projections in place through 4-D tensor maps.

#include <type_traits>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kDeltaRows = 8;          // query rows per block of the pre-pass
constexpr int kRowsB = 2;              // rows kernels: query rows (dq) or keys (dkv) per warp
constexpr int kBlkB = kWarps * kRowsB; // rows kernels: rows or keys per block
constexpr int kTile = 32;              // rows kernels: keys (dq) or queries (dkv) per tile
constexpr int kStages = 2;             // tensor cores: tiles in flight in the ring
constexpr int kDqWarps = 8;
constexpr int kDqBQ = 16 * kDqWarps;   // tensor-core dq: query rows per block
constexpr int kDkvWarps = 4;
constexpr int kDkvBK = 16 * kDkvWarps; // tensor-core dk/dv: keys per block
// keys per tile of dq and queries per tile of dk/dv, by head dim: the
// accumulators of a 16-row slice grow with D, the tile's scores shrink
template <int D>
__host__ __device__ constexpr int dq_bk() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D <= 64 ? 64 : 32; }
// a stage of the dk/dv ring: Q and dO tiles, then the tile's lse and dd,
// padded so the next stage's tiles start on 1024 bytes
template <int D>
__host__ __device__ constexpr int dkv_stage() {
  return 2 * sw_bytes<dkv_bq<D>(), D>() + (8 * dkv_bq<D>() + 1023) / 1024 * 1024;
}

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

// ------------------------------------------- bf16 and fp16 (tensor cores)

// The tensor-core kernels stream tiles through a ring of kStages shared-
// memory stages filled by TMA (tile i + kStages - 1 loads while tile i
// computes; thread 0 starts a stage's copies and every thread waits on its
// mbarrier), in wgmma's 128-byte swizzled layout (flash_common.cuh), and run
// every product as a wgmma m64nNk16 of one warpgroup over 64 rows: the two
// recomputed products (s and dp) read both operands from shared memory, the
// gradient products take ds or p from registers (the accumulators rounded
// to T in place) and read the other operand MN-major from the one
// row-major tile through the transpose bit. p = 2^(s scale log2(e) - lse
// log2(e)): one FFMA and one ex2. Only a warp's tiles that hold the causal
// diagonal, lens[bh] or (dk/dv) the query edge sq evaluate the mask (to
// -inf, whose ex2 is 0).

// dq: a block owns kDqBQ = 128 query rows, two warpgroups of 64, 16 per warp
// (rows r0 = g, r1 = g + 8, keys 2t, 2t+1 of each 8-key block, as K2). Q and
// dO stay in shared memory for the whole walk; K and V tiles of dq_bk<D>()
// keys stream through the ring. Causal blocks launch heaviest first.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kDqWarps * 32, D <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        const int* __restrict__ lens, T* __restrict__ dq,
                        int sq, int sk, float scale, int causal, DropArgs drop) {
  constexpr int kBK = dq_bk<D>();
  constexpr int kTile = sw_bytes<kBK, D>();  // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kStages + 1];  // a barrier a stage, then Q's and dO's
  char* qs = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* dos = qs + sw_bytes<kDqBQ, D>();
  char* ring = dos + sw_bytes<kDqBQ, D>();  // [kStages][K tile, V tile]

  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy first
  const int q0 = qb * kDqBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;
  const int m0 = (warp >> 2) * 64;  // the warpgroup's first row in the block
  const int r0 = w0 + g, r1 = r0 + 8;
  const size_t qoff = (size_t)bh * sq * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kDqBQ, sq)) : len;
  const int gend = causal ? min(kend, q0 + m0 + 64) : kend;
  const int ntiles = (kend + kBK - 1) / kBK;
  const float sl2 = scale * kLog2e;
  DropKey dkey{};
  if constexpr (kDrop) dkey = load_drop_key(drop);

  auto load_kv = [&](int i) {  // thread 0 starts tile i's copies
    if (i < ntiles && threadIdx.x == 0) {
      char* st = ring + (i % kStages) * 2 * kTile;
      uint64_t* bar = &bars[i % kStages];
      mbar_expect(bar, 2 * kTile);
      tma_load_tile<kBK, D>(st, &kmap, bar, i * kBK, bh);
      tma_load_tile<kBK, D>(st + kTile, &vmap, bar, i * kBK, bh);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (ntiles > 0 && threadIdx.x == 0) {
    mbar_expect(&bars[kStages], 2 * sw_bytes<kDqBQ, D>());
    tma_load_tile<kDqBQ, D>(qs, &qmap, &bars[kStages], q0, bh);
    tma_load_tile<kDqBQ, D>(dos, &domap, &bars[kStages], q0, bh);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_kv(i);
  // lse in base 2 and dd of the thread's two rows (rows past sq are never stored)
  const float l0 = r0 < sq ? lse[(size_t)bh * sq + r0] * kLog2e : 0.f;
  const float l1 = r1 < sq ? lse[(size_t)bh * sq + r1] * kLog2e : 0.f;
  const float d0 = r0 < sq ? dd[(size_t)bh * sq + r0] : 0.f;
  const float d1 = r1 < sq ? dd[(size_t)bh * sq + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  if (ntiles > 0) mbar_wait(&bars[kStages], 0);

  for (int it = 0; it < ntiles; ++it) {
    load_kv(it + kStages - 1);
    mbar_wait(&bars[it % kStages], (it / kStages) & 1);
    const int t0 = it * kBK;
    const char* ks = ring + (it % kStages) * 2 * kTile;
    const char* vs = ks + kTile;
    if (t0 < gend) {
      float s[kBK / 8][4], dp[kBK / 8][4];
      wgmma_ss_rows<T, D, kDqBQ, kBK>(s, qs, m0, ks);
      wgmma_ss_rows<T, D, kDqBQ, kBK>(dp, dos, m0, vs);
      uint32_t keep[kBK / 32];  // the dropout hash, while the products run
      if constexpr (kDrop) keep_bits<kBK / 8>(keep, dkey, bh, r0, t0 + 2 * t, lane, false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (t0 + kBK > len || (causal && t0 + kBK - 1 > w0)) {
#pragma unroll
        for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + nt * 8 + 2 * t + (e & 1);
            if (key >= len || (causal && key > (e < 2 ? r0 : r1))) s[nt][e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int key0 = t0 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[nt][e], sl2, -(e < 2 ? l0 : l1)));
          float dpe = dp[nt][e];
          if constexpr (kDrop) {
            dpe = kept(keep_tile_of<kBK / 8>(keep, nt, e >> 1), e < 2 ? r0 : r1, key0 + (e & 1))
                      ? dpe * drop.inv_keep
                      : 0.f;
          }
          s[nt][e] = p * (dpe - (e < 2 ? d0 : d1)) * scale;  // ds
        }
      }
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) pack_c_as_a<T>(a[kc], s[2 * kc], s[2 * kc + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) wgmma_rs_cols<T, D, kBK>(acc, a[kc], ks, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= sq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(dq + qoff + (size_t)row * D + dt * 8 + 2 * t, acc[dt][2 * h], acc[dt][2 * h + 1]);
  }
}

// dk/dv works on the transposed problem: a block owns kDkvBK = 64 keys, one
// warpgroup, 16 keys per warp, and computes S^T = K Q^T and dP^T = V dO^T
// for a tile of dkv_bq<D>() queries, so its accumulators hold (key, query)
// pairs and become the register A operands of P^T dO and dS^T Q in place. A
// thread owns keys g, g + 8 of its warp's 16 and queries 2t, 2t+1 of each
// 8-query block: the keys g and g ^ 1 share a hash tile, the tile that K2
// and dq read at (query, key). K and V sit in shared memory for the whole
// walk; Q, dO and their rows' lse and dd stream through the ring. Causal
// blocks of early keys, which see the most queries, have the lowest index
// and launch first.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kDkvWarps * 32, D <= 64 ? 3 : 2)
flash_bwd_dkv_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, float scale,
                         int causal, DropArgs drop) {
  constexpr int kBQ = dkv_bq<D>();
  constexpr int kThreads = kDkvWarps * 32;
  constexpr int kTile = sw_bytes<kBQ, D>();  // one Q or dO tile
  constexpr int kStage = dkv_stage<D>();     // Q tile, dO tile, lse, dd
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kStages + 1];  // a barrier a stage, then K's and V's
  char* kss = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* vss = kss + sw_bytes<kDkvBK, D>();
  char* ring = vss + sw_bytes<kDkvBK, D>();  // [kStages][kStage]

  const int bh = blockIdx.x, k0 = blockIdx.y * kDkvBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + warp * 16;  // the warp's first key
  const int key0 = wk0 + g, key1 = key0 + 8;
  const size_t koff = (size_t)bh * sk * D;
  const int len = min(max(lens[bh], 0), sk);
  const float sl2 = scale * kLog2e;
  DropKey dkey{};
  if constexpr (kDrop) dkey = load_drop_key(drop);

  // keys at or past len get no gradient; causal: no query before k0 sees them
  const int qbeg = causal ? (k0 / kBQ) * kBQ : 0;
  const int qend = k0 < len ? sq : 0;
  const int ntiles = qend > qbeg ? (qend - qbeg + kBQ - 1) / kBQ : 0;

  // tile i: Q and dO by TMA (thread 0), their rows' lse and dd by cp.async
  // (rows of a (BH, Sq) fp32 array need not start on 16 bytes)
  auto load_q = [&](int i) {
    if (i < ntiles) {
      const int t0 = qbeg + i * kBQ;
      char* st = ring + (i % kStages) * kStage;
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[i % kStages];
        mbar_expect(bar, 2 * kTile);
        tma_load_tile<kBQ, D>(st, &qmap, bar, t0, bh);
        tma_load_tile<kBQ, D>(st + kTile, &domap, bar, t0, bh);
      }
      float* vec = reinterpret_cast<float*>(st + 2 * kTile);
      load_vec_async<kBQ, kThreads>(vec, lse + (size_t)bh * sq, t0, sq);
      load_vec_async<kBQ, kThreads>(vec + kBQ, dd + (size_t)bh * sq, t0, sq);
    }
    cp_async_commit();
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (ntiles > 0 && threadIdx.x == 0) {
    mbar_expect(&bars[kStages], 2 * sw_bytes<kDkvBK, D>());
    tma_load_tile<kDkvBK, D>(kss, &kmap, &bars[kStages], k0, bh);
    tma_load_tile<kDkvBK, D>(vss, &vmap, &bars[kStages], k0, bh);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_q(i);
  if (ntiles > 0) mbar_wait(&bars[kStages], 0);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    load_q(it + kStages - 1);
    mbar_wait(&bars[it % kStages], (it / kStages) & 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // every thread's lse and dd of tile it have landed
    const int t0 = qbeg + it * kBQ;
    const char* qs = ring + (it % kStages) * kStage;
    const char* dos = qs + kTile;
    const float* ls = reinterpret_cast<const float*>(dos + kTile);
    const float* dds = ls + kBQ;
    // (causal) a tile whose queries all precede the block's keys adds nothing
    if (!(causal && t0 + kBQ - 1 < k0)) {
      float s[kBQ / 8][4], dp[kBQ / 8][4];
      wgmma_ss_rows<T, D, kDkvBK, kBQ>(s, kss, 0, qs);
      wgmma_ss_rows<T, D, kDkvBK, kBQ>(dp, vss, 0, dos);
      uint32_t keep[kBQ / 32];  // the dropout hash, while the products run
      if constexpr (kDrop) keep_bits<kBQ / 8>(keep, dkey, bh, key0, t0 + 2 * t, lane, true);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if ((causal && t0 < wk0 + 15) || wk0 + 16 > len || t0 + kBQ > sq) {
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = t0 + nt * 8 + 2 * t + (e & 1);
            const int key = e < 2 ? key0 : key1;
            if (key >= len || qi >= sq || (causal && key > qi)) s[nt][e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const int ql = nt * 8 + 2 * t, qa = t0 + ql;
        const float la[2] = {ls[ql] * kLog2e, ls[ql + 1] * kLog2e};
        const float da[2] = {dds[ql], dds[ql + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[nt][e], sl2, -la[e & 1]));
          float z = p, dpe = dp[nt][e];
          if constexpr (kDrop) {
            const bool kp =
                kept(keep_tile_of<kBQ / 8>(keep, nt, e >> 1), qa + (e & 1), e < 2 ? key0 : key1);
            z = kp ? p * drop.inv_keep : 0.f;
            dpe = kp ? dpe * drop.inv_keep : 0.f;
          }
          s[nt][e] = z;
          dp[nt][e] = p * (dpe - da[e & 1]) * scale;  // ds, with the undropped p
        }
      }
      uint32_t ap[kBQ / 16][4], ads[kBQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        pack_c_as_a<T>(ap[kc], s[2 * kc], s[2 * kc + 1]);
        pack_c_as_a<T>(ads[kc], dp[2 * kc], dp[2 * kc + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        wgmma_rs_cols<T, D, kBQ>(dva, ap[kc], dos, kc);
        wgmma_rs_cols<T, D, kBQ>(dka, ads[kc], qs, kc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key1 : key0;
    if (key >= sk) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t o = koff + (size_t)key * D + dt * 8 + 2 * t;
      store2(dk + o, dka[dt][2 * h], dka[dt][2 * h + 1]);
      store2(dv + o, dva[dt][2 * h], dva[dt][2 * h + 1]);
    }
  }
}

// dynamic shared memory (each with room to align to 1024 bytes): dq's Q, dO
// and ring; dk/dv's K, V and ring
template <int D>
constexpr size_t dq_smem() {
  return 2 * sw_bytes<kDqBQ, D>() + kStages * 2 * sw_bytes<dq_bk<D>(), D>() + 1024;
}

template <int D>
constexpr size_t dkv_smem() {
  return 2 * sw_bytes<kDkvBK, D>() + kStages * dkv_stage<D>() + 1024;
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

template <typename B, int D, bool kDrop>
int launch_mma(const Args& a) {
  int err = launch_delta<B, D>(a);
  if (err) return err;
  const B* q = static_cast<const B*>(a.q);
  const B* k = static_cast<const B*>(a.k);
  const B* v = static_cast<const B*>(a.v);
  const B* dout = static_cast<const B*>(a.dout);
  auto dq_kernel = flash_bwd_dq_mma_kernel<B, D, kDrop>;
  auto dkv_kernel = flash_bwd_dkv_mma_kernel<B, D, kDrop>;
  constexpr size_t dq_bytes = dq_smem<D>(), dkv_bytes = dkv_smem<D>();
  // the maps of each kernel's boxes: dq's 128 query rows and dq_bk<D>()
  // keys, dk/dv's 64 keys and dkv_bq<D>() query rows
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  err = allow_smem(dq_kernel, dq_bytes);
  if (!err) err = allow_smem(dkv_kernel, dkv_bytes);
  if (!err) err = make_tile_map<B>(&q1, q, a.bh, a.sq, D, kDqBQ);
  if (!err) err = make_tile_map<B>(&do1, dout, a.bh, a.sq, D, kDqBQ);
  if (!err) err = make_tile_map<B>(&k1, k, a.bh, a.sk, D, dq_bk<D>());
  if (!err) err = make_tile_map<B>(&v1, v, a.bh, a.sk, D, dq_bk<D>());
  if (!err) err = make_tile_map<B>(&q2, q, a.bh, a.sq, D, dkv_bq<D>());
  if (!err) err = make_tile_map<B>(&do2, dout, a.bh, a.sq, D, dkv_bq<D>());
  if (!err) err = make_tile_map<B>(&k2, k, a.bh, a.sk, D, kDkvBK);
  if (!err) err = make_tile_map<B>(&v2, v, a.bh, a.sk, D, kDkvBK);
  if (err) return err;
  dq_kernel<<<dim3(a.bh, (a.sq + kDqBQ - 1) / kDqBQ), kDqWarps * 32, dq_bytes, a.stream>>>(
      q1, k1, v1, do1, a.lse, a.dd, a.lens, static_cast<B*>(a.dq), a.sq, a.sk, a.scale,
      a.causal, a.drop);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkv_kernel<<<dim3(a.bh, (a.sk + kDkvBK - 1) / kDkvBK), kDkvWarps * 32, dkv_bytes,
               a.stream>>>(q2, k2, v2, do2, a.lse, a.dd, a.lens, static_cast<B*>(a.dk),
                           static_cast<B*>(a.dv), a.sq, a.sk, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDrop>
int launch(const Args& a) {
  if constexpr (kHalfType<T>) {
#define FLASH_BWD_CASE(DIM) \
  case DIM:                 \
    return launch_mma<T, DIM, kDrop>(a);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, o, dout, dq (bh, sq,
// d); k, v, dk, dv (bh, sk, d), all contiguous and 16-byte aligned, d in
// 8..512; lse and dd (bh, sq) fp32, dd scratch; dlse (bh, sq) fp32 or null; lens (bh,) int32.
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
  if (dtype == 2) return launch_drop<__half>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
