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
// the same at half the size. With dropout the hash adds about 26.5 32-bit
// integer operations a live (query, key) pair (a quarter of one
// Philox4x32-10 call), 3.6 G at the training shape: 53 us, above the bytes
// and the products, so the dropout kernel is bound by its integer work.
// Decode (Sq = 1) is a stream over the live keys: 4 D operations for 2 D
// elements of K and V read, far below the line, so it is bound by bytes. At
// the engine's decode shape (BH 512, Sk 1024, D 64, bf16, lens uniform in
// 0..1024) it reads 67 MB (20 us); its paged mode reads the fp32 pools, 134
// MB (40 us), where the gathered path moved about 1.2 GB a layer.
//
// The kernels, chosen by shape, dtype and head dim in launch():
// * flash_decode_chunk_kernel and flash_decode_merge_kernel (Sq < 16, D in
//   16..128 step 16; described at the decode section below): the keys of
//   each bh split into chunks of 32, one warp each, so the whole card
//   streams even at BH 512 and ragged lens; a chunk's two tiles of 16 keys
//   in flight at once by bulk copies on mbarriers; every query row in
//   one warp; then a fixed-order merge, a thread an output element. The
//   paged mode reads
//   the serving engine's fp32 page pools in place through the page table.
// * flash_fwd_mma_kernel (bf16 or fp16, Sq >= 16, D in 16..128 step 16:
//   training and prefill): near the line between bytes and products, so it keeps
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
//   the tensor cores. p is rounded to v's dtype (bf16 or fp16) for the p.v
//   product, as the TPU kernel rounds p to v's dtype, while the normaliser l
//   sums the fp32 p. The two 16-bit types share the layouts and fragments;
//   fp16 differs only in its conversions, its tensor maps' element type and
//   wgmma's .f16 form, and keeps three more bits of p (below 2^-14 it is
//   subnormal, where bf16 keeps its 8 bits down to 2^-126).
// * flash_fwd_rows_kernel (fp32 at every head dim; bf16 and fp16 at the head
//   dims the tensor-core kernels do not take, 8..512): CUDA cores in fp32, 16 query
//   rows per block (4 per warp), 32-key tiles staged in dynamic shared memory
//   (163 KB at D 512, allowed above the default 48 KB), lane j scores key j
//   and owns output columns lane + 32 c, c < kCols = 1, 2, 4, 8 or 16 by
//   head dim, the ragged last one masked. The bf16 and fp16 variants round
//   p to their type for p.v as the tensor-core path does. fp32 is the exact path the
//   card-side checks compare tightly.
// All of them skip tiles wholly past lens or past the block's last causal
// diagonal and mask the ragged edge themselves. Still open (later work):
// overlapping one tile's softmax with the next tile's wgmma (two consumer
// warpgroups taking turns), and reading the models' (B, S, H, D)
// projections in place through 4-D tensor maps.

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
      p[r] = round_to(p[r], static_cast<T*>(nullptr));  // half types: as the mma path
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


// ------------------------------------------------------------------ decode
//
// The decode path (Sq < 16; D in 16..128 step 16) splits each bh's keys into
// chunks of kDecChunk keys (flash-decoding), one warp each: a one-warp block
// per (bh, chunk), the grid chunk-major, and a chunk past its bh's length
// exits at once. A chunk's kDecTiles tiles of kDecBK keys are all in flight
// at once, each on its own mbarrier: lane j issues one bulk copy (TMA's 1-D
// cp.async.bulk) of key j's K row and lane j + 16 one of its V row, lane 0
// announces each tile's bytes, and the warp scores tile 0 while the next
// lands. Lanes j and j + 16 score key j on the two halves of the head
// (16-byte vectors, rows padded by 16 bytes so eight lanes on eight rows hit
// distinct banks), summed by one shuffle; p.v reads V in vectors of kE
// columns, lanes in key groups, reduced across the groups once per chunk.
// Every query row of the bh rides in the warp (kR = 1, or kDecodeRows for Sq
// 2..15), so K and V are read once. Scores, p and the sums are fp32, as in
// the row kernel, and p is not rounded. A bh with one live chunk writes o
// and lse from its warp; otherwise each chunk writes its partial (m, l,
// acc[D]) to the workspace, and flash_decode_merge_kernel, a thread an
// output element, folds them in chunk order: two calls agree bitwise,
// whatever order the blocks run in. The merge is a programmatic dependent
// launch, so its blocks start while the chunks drain, and is launched only
// where sk spans more than one chunk. sk 0 takes the same kernel: chunk 0's
// warp writes o = 0 and lse = -1e30.
//
// The paged mode (kPaged) is the same kernel reading one layer's fp32 page
// pools (n_pages, page_size, H D) in place through the page table (B,
// n_slots): bh = b H + h, key j of row b at pool row table[b, j / page_size]
// page_size + j % page_size, columns h D .. h D + D. Its sk is the caller's
// host-known bound on the lengths (kv_max), so short sequences launch few
// chunks. Each lane loads the page indices of its keys beside the length,
// before it issues their copies, reads only keys below kv_lens, and narrows
// each fp32 element to q's dtype T in registers (exact for values
// write_token widened), so it computes exactly what the contiguous mode
// computes on the gathered, narrowed copy. q and o are read and written
// through their strides.

constexpr int kDecBK = 16;                      // keys per tile: lanes j and j + 16 score key j
constexpr int kDecTiles = 2;                    // tiles per chunk, all in flight
constexpr int kDecChunk = kDecBK * kDecTiles;   // keys per warp: the split over the cache

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

__host__ __device__ constexpr int dec_chunks(int sk) { return sk > 0 ? (sk + kDecChunk - 1) / kDecChunk : 1; }

constexpr bool dec_dim(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

// the partials a decode call writes; none for one chunk, or for a call that
// takes another kernel
long long dec_ws_floats(int bh, int sq, int sk, int d) {
  if (sq >= kDecodeRows || !dec_dim(d) || dec_chunks(sk) == 1) return 0;
  return (long long)bh * sq * dec_chunks(sk) * (d + 2);
}

struct DecodeArgs {
  const void* q;          // T, (b, row, h D + c) at b q_sb + row q_sr + h D + c
  const void* k;          // S: contiguous (bh, sk, D), or a paged pool (n_pages, page_size, H D)
  const void* v;
  const int* lens;        // contiguous (bh,); paged (B,)
  const int* table;       // paged (B, n_slots); null: contiguous
  void* o;                // T, addressed as q with o_sb, o_sr
  float* lse;             // (bh, sq)
  float* ws;              // (bh, sq, dec_chunks(sk), D + 2): partial m, l, acc
  long long ws_floats;
  int bh, sq, sk, heads;  // heads: H paged (bh = b H + h), 1 contiguous
  long long q_sb, q_sr, o_sb, o_sr;
  int n_slots, page_size, row_elems;  // paged: table width, keys a page, elements between keys
  float scale;
  int causal;
  DropArgs drop;
  cudaStream_t stream;
};

// n elements of a row (shared memory) as floats, narrowed to T's precision:
// fp32 pages read for bf16 q round once (exact for widened bf16 values)
template <typename T, typename S, int N>
__device__ __forceinline__ void load_row(const S* p, float (&out)[N]) {
  if constexpr (std::is_same<S, float>::value) {
    static_assert(N == 2 || N == 4 || N == 8, "8, 16 or 32 bytes");
    if constexpr (N >= 4) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p + i);
        out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
      }
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[0] = x.x; out[1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = round_to(out[i], static_cast<T*>(nullptr));
  } else {
    static_assert(N == 2 || N == 4 || N == 8, "4, 8 or 16 bytes");
    uint32_t w[N / 2];
    if constexpr (N == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// columns a lane owns in p.v: 16 bytes of q's dtype T for one query row,
// fewer for kDecodeRows rows (their accumulators live in registers). A
// function of T, not of the rows' storage, so that the paged mode sums in
// the contiguous mode's order
template <typename T, int D, int kR>
__host__ __device__ constexpr int dec_cols() { return kR == 1 ? 16 / (int)sizeof(T) : (D <= 64 ? 2 : 4); }

template <typename S, int D>
__host__ __device__ constexpr int dec_stride() { return D * (int)sizeof(S) + 16; }

// dynamic shared memory: the chunk's tiles (K rows, then V rows, each), then
// q for kDecodeRows rows (one row lives in registers)
template <typename S, int D, int kR>
constexpr size_t dec_smem() {
  return (size_t)kDecTiles * 2 * kDecBK * dec_stride<S, D>() + (kR > 1 ? sizeof(float) * kR * D : 0);
}

template <typename T, typename S, int D, int kR, bool kDrop, bool kPaged>
__global__ void __launch_bounds__(32)
flash_decode_chunk_kernel(const DecodeArgs a) {
  constexpr int kRowBytes = D * (int)sizeof(S);
  constexpr int kStride = dec_stride<S, D>();
  constexpr int kTileBytes = 2 * kDecBK * kStride;  // K rows, then V rows
  constexpr int kVec = 16 / (int)sizeof(S);         // elements of a 16-byte vector
  constexpr int kHalf = D / 2;                      // columns a scoring lane covers
  constexpr int kE = dec_cols<T, D, kR>();
  constexpr int kLanes = pow2_at_least(D / kE);     // lanes a V row spans in p.v
  constexpr int kGroups = 32 / kLanes;              // key groups of p.v
  static_assert(kHalf % kVec == 0 && kGroups <= kDecBK, "tile geometry");
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ uint64_t bars[kDecTiles];
  float* qs = reinterpret_cast<float*>(dsmem + kDecTiles * kTileBytes);  // [kR][D], kR > 1

  griddep_launch_dependents();  // the merge's blocks may start as these drain
  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int c0 = chunk * kDecChunk;
  const int lane = threadIdx.x;
  const int j = lane & (kDecBK - 1);  // the tile row this lane copies and scores
  int page[kDecTiles] = {};  // paged: the page of each tile's key j, loaded beside the length
  if constexpr (kPaged) {
    if (a.sk > 0) {  // no key to read: the table may be empty
#pragma unroll
      for (int i = 0; i < kDecTiles; ++i)
        page[i] = a.table[(size_t)b * a.n_slots + min(c0 + i * kDecBK + j, a.sk - 1) / a.page_size];
    }
  }
  const int len = min(max(a.lens[b], 0), a.sk);
  const int kend = a.causal ? min(len, a.sq) : len;  // keys any row sees
  T* o = static_cast<T*>(a.o) + b * a.o_sb + (size_t)h * D;
  if (c0 >= kend) {
    if (kend == 0 && chunk == 0) {  // no key (sk 0 too): o = 0 and lse = -1e30
      for (int i = lane; i < a.sq * D; i += 32) store(&o[(i / D) * a.o_sr + i % D], 0.f);
      for (int r = lane; r < a.sq; r += 32) a.lse[(size_t)bh * a.sq + r] = kNeg;
    }
    return;
  }
  const int c1 = min(c0 + kDecChunk, kend);
  const int ntiles = (c1 - c0 + kDecBK - 1) / kDecBK;

  // this lane's rows of each tile: key c0 + 16 i + j, its K (lane < 16) or V
  // row (a key past c1 is never copied: its row address is unused)
  const S* src[kDecTiles];
#pragma unroll
  for (int i = 0; i < kDecTiles; ++i) {
    const int key = min(c0 + i * kDecBK + j, a.sk - 1);
    const void* base = lane < kDecBK ? a.k : a.v;
    size_t off;
    if constexpr (kPaged) {
      off = ((size_t)page[i] * a.page_size + key % a.page_size) * a.row_elems + (size_t)h * D;
    } else {
      off = ((size_t)bh * a.sk + key) * D;
    }
    src[i] = static_cast<const S*>(base) + off;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kDecTiles; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kDecTiles; ++i) {
    if (i < ntiles) {
      const int n = min(kDecBK, c1 - c0 - i * kDecBK);
      if (lane == 0) mbar_expect(&bars[i], 2 * n * kRowBytes);
      __syncwarp();
      if (j < n)
        bulk_load(dsmem + i * kTileBytes + (lane >= kDecBK ? kDecBK * kStride : 0) + j * kStride,
                  src[i], kRowBytes, &bars[i]);
    }
  }

  // q, while the tiles land
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (size_t)h * D;
  const int half = lane >> 4;  // the half of the head this lane scores
  float qr[kR == 1 ? kHalf : 1];
  if constexpr (kR == 1) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) qr[d] = to_float(q[half * kHalf + d]);
  } else {
    for (int i = lane; i < kR * D; i += 32) {
      const int r = i / D, c = i - r * D;
      qs[i] = r < a.sq ? to_float(q[r * a.q_sr + c]) : 0.f;
    }
    __syncwarp();
  }
  const int grp = lane / kLanes, cc = lane % kLanes;  // p.v: key group, column vector
  const bool col_live = cc * kE < D;
  float m[kR], l[kR], acc[kR][kE];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }
  DropKey dk{};
  if constexpr (kDrop) dk = load_drop_key(a.drop);

  for (int i = 0; i < ntiles; ++i) {
    const int t0 = c0 + i * kDecBK;
    const int n = min(kDecBK, c1 - t0);
    const unsigned char* st = dsmem + i * kTileBytes;
    mbar_wait(&bars[i], 0);

    // s = q . k for key t0 + j; rows past n are unwritten and masked below
    float s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0.f;
    const S* kr = reinterpret_cast<const S*>(st + j * kStride) + half * kHalf;
#pragma unroll(kR == 1 ? kHalf / kVec : 1)
    for (int v0 = 0; v0 < kHalf; v0 += kVec) {
      float kv[kVec];
      load_row<T, S, kVec>(kr + v0, kv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float qd = kR == 1 ? qr[v0 + e] : qs[r * D + half * kHalf + v0 + e];
          s[r] = fmaf(qd, kv[e], s[r]);
        }
      }
    }
    const int key = t0 + j;
    float p[kR];
    uint32_t tile = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 16);
      const bool live = j < n && (!a.causal || key <= r);
      const float sr = live ? s[r] * a.scale : kNeg;
      float mx = sr, ps;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      // explicit zero: on a fully masked tile sr == m_new and exp would be 1
      float pr = live ? expf(sr - m_new) : 0.f;
      ps = pr;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = alpha * l[r] + ps;  // the undropped p
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
      if constexpr (kDrop) {
        if ((r & 1) == 0) tile = keep_tile(dk, bh, r, key);  // rows r, r + 1 share a tile
        if (live) pr = kept(tile, r, key) ? pr * a.drop.inv_keep : 0.f;
      }
      p[r] = pr;
    }

    // acc += p v: this lane's keys grp, grp + kGroups, ... of the tile
#pragma unroll
    for (int k0 = 0; k0 < kDecBK; k0 += kGroups) {
      const int kk = k0 + grp;
      float pk[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) pk[r] = __shfl_sync(0xffffffffu, p[r], kk);
      if (kk < n && col_live) {
        float vv[kE];
        load_row<T, S, kE>(reinterpret_cast<const S*>(st + (kDecBK + kk) * kStride) + cc * kE, vv);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(pk[r], vv[e], acc[r][e]);
        }
      }
    }
  }

  // the key groups' sums; then o itself, or the chunk's partial
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  const int rows = min(a.sq, kR);
  const int nchunks = (kend + kDecChunk - 1) / kDecChunk;  // live chunks of this bh
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rows) break;
    if (nchunks == 1) {  // the only chunk: o itself
      const bool nonempty = l[r] > 0.f;
      if (grp == 0 && col_live) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          store(&o[r * a.o_sr + cc * kE + e], nonempty ? acc[r][e] / l[r] : 0.f);
      }
      if (lane == 0) a.lse[(size_t)bh * a.sq + r] = nonempty ? m[r] + logf(l[r]) : kNeg;
    } else {
      float* part = a.ws + (((size_t)bh * a.sq + r) * dec_chunks(a.sk) + chunk) * (D + 2);
      if (grp == 0 && col_live) {
#pragma unroll
        for (int e = 0; e < kE; ++e) part[2 + cc * kE + e] = acc[r][e];
      }
      if (lane == 0) {
        part[0] = m[r];
        part[1] = l[r];
      }
    }
  }
}

// The chunks' partials of each (bh, query row) folded in chunk order, a
// thread an output element: M = max m_c, L = sum exp(m_c - M) l_c, o = sum
// exp(m_c - M) acc_c / L, lse = M + log L, each sum chunk by chunk, so every
// thread of a row computes M and L alike and two calls agree bitwise. Each
// round of loads (the length, the m_c, then l_c and acc_c) is issued at
// once, the length before the chunks finish (a programmatic dependent
// launch). A row with one live chunk was written by its chunk, one with none
// by chunk 0's warp.
template <typename T>
__global__ void __launch_bounds__(128)
flash_decode_merge_kernel(const DecodeArgs a, int d, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.bh * a.sq * d) return;
  const int col = i % d, row = i / d, bh = row / a.sq, r = row - bh * a.sq;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int len = min(max(a.lens[b], 0), a.sk);
  const int kend = a.causal ? min(len, a.sq) : len;
  const int n = (kend + kDecChunk - 1) / kDecChunk;
  // the chunks' partials are written and visible; every thread waits, so
  // the merge never ends before the chunks it follows
  griddep_wait();
  if (n <= 1) return;
  const float* part = a.ws + (size_t)row * chunks * (d + 2);
  constexpr int kBatch = 16;  // loads issued together, predicated past n
  float mt = kNeg;
  for (int c0 = 0; c0 < n; c0 += kBatch) {
    float mv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) mv[u] = c0 + u < n ? part[(c0 + u) * (d + 2)] : kNeg;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) mt = fmaxf(mt, mv[u]);
  }
  float lt = 0.f, x = 0.f;
  for (int c0 = 0; c0 < n; c0 += kBatch) {
    float mv[kBatch], lv[kBatch], av[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = c0 + u < n;
      const float* pc = part + (c0 + u) * (d + 2);
      mv[u] = in ? pc[0] : kNeg;
      lv[u] = in ? pc[1] : 0.f;
      av[u] = in ? pc[2 + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // chunk order
      if (c0 + u < n) {
        const float w = expf(mv[u] - mt);
        lt += w * lv[u];
        x += w * av[u];
      }
    }
  }
  const bool nonempty = lt > 0.f;
  store(&static_cast<T*>(a.o)[b * a.o_sb + r * a.o_sr + (size_t)h * d + col],
        nonempty ? x / lt : 0.f);
  if (col == 0) a.lse[row] = nonempty ? mt + logf(lt) : kNeg;
}

// the chunks, then, where there is more than one, their merge; the
// caller's workspace must hold every partial (dec_ws_floats)
template <typename T, typename S, int D, int kR, bool kDrop, bool kPaged>
int launch_decode(const DecodeArgs& a) {
  const int chunks = dec_chunks(a.sk);
  const long long ws = dec_ws_floats(a.bh, a.sq, a.sk, D);
  if (ws > 0 && (a.ws == nullptr || a.ws_floats < ws)) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = flash_decode_chunk_kernel<T, S, D, kR, kDrop, kPaged>;
  constexpr size_t smem = dec_smem<S, D, kR>();
  int err = allow_smem(kernel, smem);
  if (!err)  // the most shared memory an SM can give: more warps resident
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
  if (err) return err;
  kernel<<<dim3(a.bh, chunks), 32, smem, a.stream>>>(a);
  const int launched = static_cast<int>(cudaGetLastError());
  if (launched || chunks == 1) return launched;
  // a programmatic dependent launch: the merge's blocks start as the
  // chunks' drain and wait (griddep_wait) before reading the partials
  const long long threads = (long long)a.bh * a.sq * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((threads + 127) / 128));
  cfg.blockDim = dim3(128);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, flash_decode_merge_kernel<T>, a, D, chunks));
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
// with P from registers (S's accumulators rounded to T, bf16 or fp16, in
// place, pack_c_as_a) and V read MN-major through the transpose bit. The softmax runs in base 2: m is
// kept as max(s) scale log2(e), and p = 2^(s scale log2(e) - m) is one FFMA
// and one ex2. Only a warp's tiles that hold the causal diagonal or
// lens[bh] evaluate the mask (to -inf, whose ex2 is 0); a warpgroup skips
// tiles wholly past its last causal key. Causal blocks launch heaviest first.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kMmaWarps * 32, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const int* __restrict__ lens, T* __restrict__ o,
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
      wgmma_ss_rows<T, D, kMmaBQ, kMmaBK>(s, qs, m0, ks);
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
      for (int kc = 0; kc < kMmaBK / 16; ++kc) pack_c_as_a<T>(pa[kc], s[2 * kc], s[2 * kc + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kMmaBK / 16; ++kc) wgmma_rs_cols<T, D, kMmaBK>(oacc, pa[kc], vs, kc);
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
      store2(o + qoff + (size_t)row * D + dt * 8 + 2 * t, oacc[dt][2 * h] * inv,
             oacc[dt][2 * h + 1] * inv);
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
  float* ws;  // the decode path's partials
  long long ws_floats;
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
    if constexpr (std::is_same<T, __half>::value) {
      return static_cast<int>(cudaErrorInvalidValue);  // no fp16 decode path
    } else {
      const DecodeArgs da{qt, kt, vt, a.lens, nullptr, ot, a.lse, a.ws, a.ws_floats,
                          a.bh, a.sq, a.sk, 1, (long long)a.sq * D, D, (long long)a.sq * D, D,
                          0, 0, D, a.scale, a.causal, a.drop, a.stream};
      return a.sq == 1 ? launch_decode<T, T, D, 1, kDrop, false>(da)
                       : launch_decode<T, T, D, kDecodeRows, kDrop, false>(da);
    }
  } else if constexpr (kHalfType<T>) {
    auto kernel = flash_fwd_mma_kernel<T, D, kDrop>;
    constexpr size_t smem = mma_smem<D>();
    CUtensorMap qmap, kmap, vmap;
    int err = allow_smem(kernel, smem);
    if (!err) err = make_tile_map<T>(&qmap, a.q, a.bh, a.sq, D, kMmaBQ);
    if (!err) err = make_tile_map<T>(&kmap, a.k, a.bh, a.sk, D, kMmaBK);
    if (!err) err = make_tile_map<T>(&vmap, a.v, a.bh, a.sk, D, kMmaBK);
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

template <typename T>
int launch_paged(const DecodeArgs& a, int d) {
#define PAGED_CASE(DIM) \
  case DIM:             \
    return launch_decode<T, float, DIM, 1, false, true>(a);
  switch (d) {
    PAGED_CASE(16)
    PAGED_CASE(32)
    PAGED_CASE(48)
    PAGED_CASE(64)
    PAGED_CASE(80)
    PAGED_CASE(96)
    PAGED_CASE(112)
    PAGED_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (sq >= 16 only: the decode
// path, sq < 16, takes fp32 and bf16). q (bh, sq, d), k and v (bh, sk, d),
// all contiguous and 16-byte aligned, d in 8..512; lens (bh,) int32; o like q;
// lse (bh, sq) float32. key: null for no dropout, else int64 (2,) on the
// card, with threshold = round((1 - rate) 2^24) and inv_keep = 1 / (1 -
// rate). ws: the decode path's fp32 workspace, flash_fwd_decode_ws_floats
// floats (null where that is 0).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const int* lens, void* o, float* lse, int bh, int sq,
                         int sk, int d, float scale, int causal, const long long* key,
                         unsigned threshold, float inv_keep, float* ws,
                         long long ws_floats, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || d < 8 || d > 512) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
               DropArgs{key, threshold, inv_keep}, ws, ws_floats,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_drop<float>(a);
  if (dtype == 1) return launch_drop<__nv_bfloat16>(a);
  if (dtype == 2 && sq >= kDecodeRows) return launch_drop<__half>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the fp32 workspace a flash_fwd call of these sizes needs, or a
// flash_decode_paged call at sq 1 and sk its kv_max: a partial (m, l,
// acc[d]) for each (bh, query row, chunk of keys); 0 where no call needs one
// (another kernel, or a single chunk, which writes o itself)
extern "C" long long flash_fwd_decode_ws_floats(int bh, int sq, int sk, int d) {
  return dec_ws_floats(bh, sq, sk, d);
}

// The paged mode of the decode path, for one query row. dtype of q and o: 0
// = float32, 1 = bfloat16. q (b, 1, heads d) read through its strides
// (q_sb, q_sr; unit column stride); k_pool and v_pool one layer's
// contiguous, 16-byte-aligned fp32 pools (n_pages, page_size, heads d);
// table (b, n_slots) int32 and lens (b,) int32, contiguous; o (b, 1, heads
// d) contiguous; lse (b heads, 1) float32. kv_max: the most keys a
// sequence reads, at most n_slots page_size, an upper bound of lens the
// caller knows on the host (a length above it reads kv_max keys); the grid
// holds its chunks, not the table's. ws as flash_fwd's at sq 1 and sk =
// kv_max. d in 16..128 step 16.
extern "C" int flash_decode_paged(int dtype, const void* q, long long q_sb, long long q_sr,
                                  const float* k_pool, const float* v_pool, const int* table,
                                  const int* lens, void* o, float* lse, float* ws,
                                  long long ws_floats, int b, int heads, int d, int n_slots,
                                  int page_size, int kv_max, float scale, void* stream) {
  const int bh = b * heads;
  if (b <= 0 || heads <= 0) return 0;
  if (n_slots < 0 || page_size <= 0 || kv_max < 0 || kv_max > (long long)n_slots * page_size)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long hd = (long long)heads * d;
  const DecodeArgs a{q, k_pool, v_pool, lens, table, o, lse, ws, ws_floats,
                     bh, 1, kv_max, heads, q_sb, q_sr, hd, hd,
                     n_slots, page_size, static_cast<int>(hd), scale, 0,
                     DropArgs{nullptr, 0u, 1.f}, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_paged<float>(a, d);
  if (dtype == 1) return launch_paged<__nv_bfloat16>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}
