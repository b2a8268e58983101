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
// Bound on an H100 (bytes at 3.35 TB/s, products at the 989 TFLOP/s bf16
// tensor-core peak, the hash at 67 T integer operations/s): the causal
// training shape BH 256, S 1024, D 64 in bf16 moves 134 MB (q, k, v read
// once, o written once: 40.1 us) for 34.4 GFLOP over its 134.3M live pairs
// (34.8 us), so it is bound by bytes and close to the line; prefill BH 128
// the same at half the size. Decode BH=512, Sq=1, Sk=1024 reads 134 MB of K/V
// (40 us) for 0.27 GFLOP. With dropout the hash adds about 26.5 32-bit
// integer operations a live (query, key) pair (a quarter of one
// Philox4x32-10 call), 3.6 G at the training shape: 53 us, above the bytes
// and the products, so the dropout kernel is bound by its integer work.
//
// Three kernels, chosen by shape, dtype and head dim in launch():
// * flash_fwd_decode_kernel (Sq < 16, decode; D in 16..128 step 16): one
//   block per (query row, bh); its 4 warps split the key tiles round-robin,
//   each lane scores one key per tile from a 16-byte-vector read of its K
//   row, and the warps merge their (m, l, acc) through shared memory at the
//   end. Decode is a stream over K/V: the split keeps 4x more loads in
//   flight than one warp per row.
// * flash_fwd_mma_kernel (bf16, Sq >= 16, D in 16..128 step 16: training
//   and prefill): near the line between bytes and products, so it keeps
//   both units busy at once. Its 128 query rows a block (two warpgroups)
//   read each K/V tile once for 128 rows; the tiles stream by TMA (3-D
//   tensor maps over (D, S, BH): a ragged edge reads zeros, never the next
//   head's rows) through a ring of shared-memory stages, the next tile
//   landing while this one computes; both products run on wgmma (Hopper's warpgroup tensor-core
//   instruction) straight from the 128-byte-swizzled tiles, V through the
//   transpose bit, so nothing is transposed or staged twice; the softmax is
//   one FFMA and one ex2 an element, the mask predicate runs only on the
//   tiles that hold the diagonal or lens[bh], and causal blocks launch
//   heaviest first. With dropout the two lanes that share a 2x2 hash tile
//   split its Philox call (keep_tiles_shared), halving the integer work
//   that bounds it, and the hash runs while the tile's scores are still on
//   the tensor cores. p is rounded to bf16 for the p.v product, as the TPU
//   kernel rounds p to v's dtype, while the normaliser l sums the fp32 p.
// * flash_fwd_rows_kernel (fp32 at every head dim; bf16 at the head dims the
//   tensor-core kernels do not take, 8..512): CUDA cores in fp32, 16 query
//   rows per block (4 per warp), 32-key tiles staged in dynamic shared memory
//   (163 KB at D 512, allowed above the default 48 KB), lane j scores key j
//   and owns output columns lane + 32 c, c < kCols = 1, 2, 4, 8 or 16 by
//   head dim, the ragged last one masked. The bf16 variant rounds p to bf16
//   for p.v as the tensor-core path does. fp32 is the exact path the
//   card-side checks compare tightly.
// All three skip tiles wholly past lens or past the block's last causal
// diagonal and mask the ragged edge themselves. Still open (later work):
// overlapping one tile's softmax with the next tile's wgmma (two consumer
// warpgroups taking turns), reading the models' (B, S, H, D) projections in
// place through 4-D tensor maps, and reading the paged cache in place
// instead of a gathered copy.

#include <type_traits>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per tile: lane j owns key j
constexpr int kDecodeRows = 16;       // fewer query rows than this: decode kernel
constexpr int kMmaWarps = 8;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per tensor-core block
constexpr int kMmaBK = 64;              // keys per tensor-core tile
constexpr int kStages = 2;              // K/V tiles in flight

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

// The tensor-core kernel. A block owns kMmaBQ = 128 query rows: two
// warpgroups of 64, each warp 16 (g = lane / 4, t = lane % 4: a thread owns
// rows r0 = g and r1 = g + 8 of its warp's 16 and keys 2t, 2t+1 of each
// 8-key block of a tile; see pack_c_as_a). Q arrives once by TMA; K and V
// tiles of kMmaBK keys stream through a ring of kStages shared-memory stages,
// tile i + kStages - 1 loading while tile i computes, all in wgmma's 128-byte
// swizzled layout: thread 0 starts a stage's copies, and every thread waits
// on the stage's mbarrier. S = Q K^T is one wgmma m64n64k16 a 16-column
// step of the head, A and B read from shared memory; O += P V is a wgmma
// with P from registers (S's accumulators rounded to bf16 in place,
// pack_c_as_a) and V read MN-major through the transpose bit. The softmax runs in base 2: m is
// kept as max(s) scale log2(e), and p = 2^(s scale log2(e) - m) is one FFMA
// and one ex2. Only a warp's tiles that hold the causal diagonal or
// lens[bh] evaluate the mask (to -inf, whose ex2 is 0); a warpgroup skips
// tiles wholly past its last causal key. Causal blocks launch heaviest first.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaWarps * 32, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const int* __restrict__ lens, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale,
                     int causal, DropArgs drop) {
  constexpr int kTile = sw_bytes<kMmaBK, D>();  // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kStages + 1];  // a barrier a stage, then Q's
  char* qs = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* ring = qs + sw_bytes<kMmaBQ, D>();  // [kStages][K tile, V tile]

  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy first
  const int q0 = qb * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;               // the warp's first row
  const int m0 = (warp >> 2) * 64;             // the warpgroup's first row in the block
  const int r0 = w0 + g, r1 = r0 + 8;
  const size_t qoff = (size_t)bh * sq * D;
  const int len = min(max(lens[bh], 0), sk);
  const int kend = causal ? min(len, min(q0 + kMmaBQ, sq)) : len;  // keys the block sees
  const int gend = causal ? min(kend, q0 + m0 + 64) : kend;         // keys the warpgroup sees
  const int ntiles = (kend + kMmaBK - 1) / kMmaBK;
  const float sl2 = scale * kLog2e;
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(drop);

  auto load_kv = [&](int i) {  // thread 0 starts tile i's copies
    if (i < ntiles && threadIdx.x == 0) {
      char* st = ring + (i % kStages) * 2 * kTile;
      uint64_t* bar = &bars[i % kStages];
      mbar_expect(bar, 2 * kTile);
      tma_load_tile<kMmaBK, D>(st, &kmap, bar, i * kMmaBK, bh);
      tma_load_tile<kMmaBK, D>(st + kTile, &vmap, bar, i * kMmaBK, bh);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (ntiles > 0 && threadIdx.x == 0) {
    mbar_expect(&bars[kStages], sw_bytes<kMmaBQ, D>());
    tma_load_tile<kMmaBQ, D>(qs, &qmap, &bars[kStages], q0, bh);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_kv(i);
  if (ntiles > 0) mbar_wait(&bars[kStages], 0);

  float oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // m in base-2 units

  for (int it = 0; it < ntiles; ++it) {
    load_kv(it + kStages - 1);  // into the stage that tile it - 1 freed
    mbar_wait(&bars[it % kStages], (it / kStages) & 1);  // tile it has landed
    const int t0 = it * kMmaBK;
    const char* ks = ring + (it % kStages) * 2 * kTile;
    const char* vs = ks + kTile;
    if (t0 < gend) {
      float s[kMmaBK / 8][4];
      wgmma_ss_rows<D, kMmaBQ, kMmaBK>(s, qs, m0, ks);
      uint32_t keep[kMmaBK / 32];  // the dropout hash, while the product runs
      if constexpr (kDrop) keep_bits<kMmaBK / 8>(keep, dk, bh, r0, t0 + 2 * t, lane, false);
      wgmma_wait<0>();
      fence_regs(s);
      // the mask only where the tile holds lens[bh] or this warp's diagonal
      if (t0 + kMmaBK > len || (causal && t0 + kMmaBK - 1 > w0)) {
#pragma unroll
        for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + nt * 8 + 2 * t + (e & 1);
            if (key >= len || (causal && key > (e < 2 ? r0 : r1))) s[nt][e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kMmaBK / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a row's 8 keys of a block sit on 4 lanes
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * sl2);  // finite: m starts at kNeg
        alpha[h] = exp2_approx(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kMmaBK / 8; ++nt) {
        const int key0 = t0 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(s[nt][e], sl2, -m[e >> 1]));  // 0 where masked
          ps[e >> 1] += p;  // l sums the undropped p
          if constexpr (kDrop) {
            p = kept(keep_tile_of<kMmaBK / 8>(keep, nt, e >> 1), e < 2 ? r0 : r1, key0 + (e & 1))
                    ? p * drop.inv_keep
                    : 0.f;
          }
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
      uint32_t pa[kMmaBK / 16][4];
#pragma unroll
      for (int kc = 0; kc < kMmaBK / 16; ++kc) pack_c_as_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kMmaBK / 16; ++kc) wgmma_rs_cols<D, kMmaBK>(oacc, pa[kc], vs, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    __syncthreads();  // every warpgroup is done with this stage before it refills
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= sq) continue;
    const bool nonempty = l[h] > 0.f;
    const float inv = nonempty ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(o + qoff + (size_t)row * D + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[dt][2 * h] * inv, oacc[dt][2 * h + 1] * inv);
    }
    if (t == 0) lse[(size_t)bh * sq + row] = nonempty ? m[h] * kLn2 + logf(l[h]) : kNeg;
  }
}

// dynamic shared memory: Q, the ring, and room to align to 1024 bytes
template <int D>
constexpr size_t mma_smem() {
  return sw_bytes<kMmaBQ, D>() + kStages * 2 * sw_bytes<kMmaBK, D>() + 1024;
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
    auto kernel = flash_fwd_mma_kernel<D, kDrop>;
    constexpr size_t smem = mma_smem<D>();
    CUtensorMap qmap, kmap, vmap;
    int err = allow_smem(kernel, smem);
    if (!err) err = make_tile_map(&qmap, a.q, a.bh, a.sq, D, kMmaBQ);
    if (!err) err = make_tile_map(&kmap, a.k, a.bh, a.sk, D, kMmaBK);
    if (!err) err = make_tile_map(&vmap, a.v, a.bh, a.sk, D, kMmaBK);
    if (err) return err;
    kernel<<<dim3(a.bh, (a.sq + kMmaBQ - 1) / kMmaBQ), kMmaWarps * 32, smem, a.stream>>>(
        qmap, kmap, vmap, a.lens, ot, a.lse, a.sq, a.sk, a.scale, a.causal, a.drop);
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
