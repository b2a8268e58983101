// K1: LayerNorm / RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/ops/normalization.py:55 _ln_fwd_kernel
// (launched by _ln_fwd_pallas at :112) and computes the same function: per
// row the fp32 mean, then the fp32 variance of x - mean (two passes, the TPU
// kernel's order; RMSNorm: the mean square), then y = xhat w + b written in
// the caller's output dtype. x comes in fp32, bf16 or fp16; w and b in any
// of the three; y in any of the three.
//
// Bound on an H100: bytes. At the training shape (16384 x 1024 bf16 x and
// y, fp32 w and b) a call must move 67.1 MB, 0.0200 ms at 3.35 TB/s,
// against about 0.13 GFLOP of fp32 arithmetic. A kernel that reaches the
// bound keeps HBM busy all the time: loads in flight while rows compute,
// and nothing but x and y crossing it.
//
// Design (modelled on K3, csrc/layer_norm_bwd.cu):
// - Persistent blocks of up to 8 warps, sized from the SM count by the
//   wrapper (ops/normalization.py ln_fwd_geometry), four an SM up to hidden
//   8192. A team of warps owns one row at a time: one warp up to hidden
//   1024, so both reductions are warp shuffles with no barrier; 2-8 warps
//   for wider rows, one named barrier a reduction. The team size follows
//   from the width alone; the row count sets only the teams a block (fewer
//   for few rows, so that decode's rows spread over SMs) and the grid. A
//   row's result is therefore the same bits whatever call, grid, block or
//   memory layout computes it. No atomics.
// - Each lane owns units of 8 consecutive elements, the same columns in
//   every row its team walks.
// - Gamma and beta sit in shared memory as fp32, copied once a block by
//   cp.async ahead of the first rows (16-bit ones widened in place once
//   they land). Kept in registers they would cost a lane 64 of them at
//   hidden 1024 and halve the warps an SM holds; each lane reads its
//   columns back with 16-byte loads placed so that a quarter warp hits 8
//   distinct bank groups.
// - A ring of up to 3 stages in shared memory, filled by 16-byte cp.async
//   from the team's next rows while it computes the current one. Each
//   thread copies exactly the 16-byte chunks of its own units, so it waits
//   on its own copies only: the ring needs no barrier.
// - The row moves from the ring to registers once; the mean, the variance
//   and the output are three passes over those registers; y leaves in
//   16-byte stores straight from registers.
// - Shapes that break 16-byte alignment (hidden not a multiple of 8, a
//   strided view with an odd stride, unaligned parameters) take a second
//   instantiation with plain loads and stores and no ring; it sums in the
//   same order, so it gives the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;                  // warps a block holds at most
constexpr int kVec = 8;                       // consecutive elements a lane owns: a unit
constexpr int kRedBytes = 2 * kMaxWarps * 4;  // two reductions' cross-warp sums

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float load_any(const void* p, int i, int dtype) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return to_float(static_cast<const __nv_bfloat16*>(p)[i]);
  return to_float(static_cast<const __half*>(p)[i]);
}

// a unit of kVec elements as stored: 16 bytes of a 16-bit type, 32 of fp32
template <typename T>
struct Unit {
  static constexpr int kChunks = sizeof(T) / 2;  // 16-byte chunks
  uint4 q[kChunks];
};

template <typename T>
__device__ __forceinline__ void unpack(const Unit<T>& u, float* v) {
  const T* h = reinterpret_cast<const T*>(u.q);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = to_float(h[i]);
}

// a whole unit to global memory in 16-byte stores
template <typename T>
__device__ __forceinline__ void store_unit(T* p, const float (&v)[kVec]) {
  Unit<T> u;
  T* h = reinterpret_cast<T*>(u.q);
#pragma unroll
  for (int i = 0; i < kVec; ++i) h[i] = from_float<T>(v[i]);
#pragma unroll
  for (int c = 0; c < Unit<T>::kChunks; ++c) reinterpret_cast<uint4*>(p)[c] = u.q[c];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's newest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a sum over the team, the same bits in every thread: warp shuffles (the
// butterfly gives every lane the same bits), then the team's warps in order
// through shared memory behind the team's named barrier (1 + team)
__device__ __forceinline__ float team_sum(float v, float* red, int team, int team_warps,
                                          int lane, int warp) {
  v = warp_sum(v);
  if (team_warps == 1) return v;
  if (lane == 0) red[warp] = v;
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(32 * team_warps) : "memory");
  const int first = team * team_warps;
  float s = 0.f;
  for (int k = 0; k < team_warps; ++k) s += red[first + k];
  return s;
}

// where 16-byte chunk ci of a staged parameter vector sits: a lane reads
// the two chunks of its unit, 32 bytes apart, so chunks ci and ci ^ 1 trade
// places in every other group of 8 and a quarter warp's reads hit 8
// distinct bank groups
__device__ __forceinline__ int param_chunk(int ci) { return ci ^ ((ci >> 3) & 1); }

__host__ __device__ __forceinline__ int dtype_bytes(int dtype) { return dtype == kF32 ? 4 : 2; }

// a 16-byte chunk of a parameter vector to fp32 in the staged vector
__device__ __forceinline__ void stage_chunk(const uint4& q, int dtype, int c, float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  if (dtype == kF32) {
    d4[param_chunk(c)] = *reinterpret_cast<const float4*>(&q);
    return;
  }
  float f[kVec];
  if (dtype == kBF16)
    unpack(*reinterpret_cast<const Unit<__nv_bfloat16>*>(&q), f);
  else
    unpack(*reinterpret_cast<const Unit<__half>*>(&q), f);
  d4[param_chunk(2 * c)] = make_float4(f[0], f[1], f[2], f[3]);
  d4[param_chunk(2 * c + 1)] = make_float4(f[4], f[5], f[6], f[7]);
}

// A parameter vector of n 16-byte chunks by cp.async, a thread taking
// chunks tid, tid + blockDim, ...: fp32 ones straight into place, 16-bit
// ones as they are into the upper half of their fp32 space (`padded`
// floats), for convert_params to widen once they have landed
__device__ __forceinline__ void copy_param(const void* p, int dtype, int n, int padded,
                                           float* dst) {
  uint4* d = reinterpret_cast<uint4*>(dtype == kF32 ? dst : dst + padded / 2);
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    cp_async16(d + (dtype == kF32 ? param_chunk(c) : c), static_cast<const uint4*>(p) + c);
}

// the 16-bit vectors that copy_param left as they are, widened in place:
// each thread reads back the chunks it copied (at most K of each vector),
// the block syncs, then each writes them as fp32
template <int K>
__device__ __forceinline__ void convert_params(int w_dtype, int nw, float* w_s, int b_dtype,
                                               int nb, float* b_s, int padded) {
  const int mw = w_dtype == kF32 ? 0 : nw, mb = b_dtype == kF32 ? 0 : nb;
  uint4 qw[K], qb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < mw) qw[k] = reinterpret_cast<const uint4*>(w_s + padded / 2)[c];
    if (c < mb) qb[k] = reinterpret_cast<const uint4*>(b_s + padded / 2)[c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < mw) stage_chunk(qw[k], w_dtype, c, w_s);
    if (c < mb) stage_chunk(qb[k], b_dtype, c, b_s);
  }
}

// the same where 16-byte chunks do not hold: one element at a time, padded
// with 0 to `padded` columns
__device__ __forceinline__ void stage_param_plain(const void* p, int dtype, int H, int padded,
                                                  float* dst) {
  for (int c = threadIdx.x; c < padded; c += blockDim.x)
    dst[4 * param_chunk(c / 4) + c % 4] = c < H ? load_any(p, c, dtype) : 0.f;
}

// this thread's 8 staged columns of unit u
__device__ __forceinline__ void read_unit(const float* s, int u, float (&v)[kVec]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 q = reinterpret_cast<const float4*>(s)[param_chunk(2 * u + h)];
    v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  int rows, hidden;
  long long x_stride;  // elements
  int w_dtype, b_dtype, team_warps, stages, rms;
  float eps;
};

// NU: units of kVec elements a lane owns in a row (the team's 32 x
// team_warps lanes cover ceil(hidden / kVec) units). FAST: x's rows, y and
// the parameters are 16-byte aligned and the width a multiple of kVec, so
// rows come through the ring and leave in whole-unit stores.
template <typename TX, typename TY, int NU, bool BIAS, bool FAST, int MinBlocks>
__global__ void __launch_bounds__(32 * kMaxWarps, MinBlocks) ln_fwd_rows(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunks = Unit<TX>::kChunks;
  const int H = a.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team_threads = 32 * a.team_warps, teams = blockDim.x / team_threads;
  const int team = warp / a.team_warps, t = tid - team * team_threads;
  const int units = (H + kVec - 1) / kVec;
  const int last = H - (units - 1) * kVec;  // elements of the last unit, 1..kVec
  const int hp = units * kVec;
  const int row_bytes = units * kVec * static_cast<int>(sizeof(TX));

  float* red = reinterpret_cast<float*>(smem);  // 2 reductions x kMaxWarps
  float* w_s = reinterpret_cast<float*>(smem + (a.team_warps > 1 ? kRedBytes : 0));
  float* b_s = w_s + hp;
  unsigned char* ring = reinterpret_cast<unsigned char*>(b_s + hp);
  const int S = a.stages;
  const int G = gridDim.x * teams;
  const int first_row = blockIdx.x * teams + team;

  // copy this thread's chunks of row r into stage s of its team's ring
  auto issue = [&](int r, int s) {
    if (r < a.rows) {
      const uint4* g = reinterpret_cast<const uint4*>(static_cast<const TX*>(a.x) +
                                                      static_cast<long long>(r) * a.x_stride);
      uint4* sl = reinterpret_cast<uint4*>(ring + (s * teams + team) * row_bytes);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const int u = t + j * team_threads;
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          if (u < units) cp_async16(sl + u * kChunks + c, g + u * kChunks + c);
      }
    }
    cp_async_commit();
  };

  // gamma and beta by cp.async (the oldest group), then the first rows: the
  // parameters' bytes are not queued behind the rows', and no load blocks
  // the rows' issue
  if constexpr (FAST) {
    const int nw = H / kVec * dtype_bytes(a.w_dtype) / 2;  // 16-byte chunks
    const int nb = BIAS ? H / kVec * dtype_bytes(a.b_dtype) / 2 : 0;
    copy_param(a.w, a.w_dtype, nw, hp, w_s);
    copy_param(a.b, a.b_dtype, nb, hp, b_s);
    cp_async_commit();
    for (int s = 0; s < S - 1; ++s) issue(first_row + s * G, s);
    cp_async_wait(S - 1);
    convert_params<NU>(a.w_dtype, nw, w_s, a.b_dtype, nb, b_s, hp);
  } else {
    stage_param_plain(a.w, a.w_dtype, H, hp, w_s);
    if constexpr (BIAS) stage_param_plain(a.b, a.b_dtype, H, hp, b_s);
  }
  __syncthreads();

  for (int k = 0;; ++k) {
    const int r = first_row + k * G;
    if (r >= a.rows) break;

    // the row, to registers as fp32: elements past the width read as 0
    float xv[NU * kVec];
    if constexpr (FAST) {
      issue(r + (S - 1) * G, (k + S - 1) % S);
      cp_async_wait(S - 1);
      const Unit<TX>* sl =
          reinterpret_cast<const Unit<TX>*>(ring + ((k % S) * teams + team) * row_bytes);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const int u = t + j * team_threads;
        if (u < units) {
          const Unit<TX> q = sl[u];  // 16-byte loads, then widened in registers
          unpack(q, xv + j * kVec);
        }
      }
    } else {
      const TX* gx = static_cast<const TX*>(a.x) + static_cast<long long>(r) * a.x_stride;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const int c0 = (t + j * team_threads) * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) xv[j * kVec + i] = c0 + i < H ? to_float(gx[c0 + i]) : 0.f;
      }
    }

    // pass 1: the mean (LayerNorm)
    float mean = 0.f;
    if (!a.rms) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (t + j * team_threads < units) {
          const float* v = xv + j * kVec;
          s += ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
        }
      }
      mean = team_sum(s, red, team, a.team_warps, lane, warp) / H;
    }
    // pass 2: the sum of (x - mean)^2 (RMSNorm: of x^2)
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = t + j * team_threads;
      if (u < units) {
        const int n = FAST || u < units - 1 ? kVec : last;
        float d[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = i < n ? xv[j * kVec + i] - mean : 0.f;
        s2 += ((d[0] * d[0] + d[1] * d[1]) + (d[2] * d[2] + d[3] * d[3])) +
              ((d[4] * d[4] + d[5] * d[5]) + (d[6] * d[6] + d[7] * d[7]));
      }
    }
    const float rstd =
        rsqrtf(team_sum(s2, red + kMaxWarps, team, a.team_warps, lane, warp) / H + a.eps);

    // pass 3: y = (x - mean) rstd w + b
    TY* yr = static_cast<TY*>(a.y) + static_cast<long long>(r) * H;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = t + j * team_threads;
      if (u < units) {
        float wv[kVec], bv[kVec], o[kVec];
        read_unit(w_s, u, wv);
        if constexpr (BIAS) read_unit(b_s, u, bv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          o[i] = (xv[j * kVec + i] - mean) * rstd * wv[i];
          if constexpr (BIAS) o[i] += bv[i];
        }
        if constexpr (FAST) {
          store_unit(yr + u * kVec, o);
        } else {
          const int n = u < units - 1 ? kVec : last;
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            if (i < n) yr[u * kVec + i] = from_float<TY>(o[i]);
        }
      }
    }
  }
}

// nothing: the least a kernel launched through this C path costs the card
__global__ void empty_kernel() {}

template <typename TX, typename TY, int NU, bool BIAS, bool FAST>
cudaError_t launch(const Args& a, int threads, int blocks, int smem, cudaStream_t stream) {
  auto kernel = ln_fwd_rows<TX, TY, NU, BIAS, FAST, NU == 4 ? 4 : 1>;
  if (smem > 48 * 1024) {  // set on every call: the attribute is per device
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TY, int NU>
cudaError_t launch_kind(const Args& a, int has_bias, int fast, int threads, int blocks, int smem,
                        cudaStream_t s) {
  if (fast)
    return has_bias ? launch<TX, TY, NU, true, true>(a, threads, blocks, smem, s)
                    : launch<TX, TY, NU, false, true>(a, threads, blocks, smem, s);
  return has_bias ? launch<TX, TY, NU, true, false>(a, threads, blocks, smem, s)
                  : launch<TX, TY, NU, false, false>(a, threads, blocks, smem, s);
}

template <typename TX, typename TY>
cudaError_t launch_units(const Args& a, int nu, int has_bias, int fast, int threads, int blocks,
                         int smem, cudaStream_t s) {
  if (nu == 4) return launch_kind<TX, TY, 4>(a, has_bias, fast, threads, blocks, smem, s);
  if (nu == 8) return launch_kind<TX, TY, 8>(a, has_bias, fast, threads, blocks, smem, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_out(const Args& a, int y_dtype, int nu, int has_bias, int fast, int threads,
                       int blocks, int smem, cudaStream_t s) {
  if (y_dtype == kF32)
    return launch_units<TX, float>(a, nu, has_bias, fast, threads, blocks, smem, s);
  if (y_dtype == kBF16)
    return launch_units<TX, __nv_bfloat16>(a, nu, has_bias, fast, threads, blocks, smem, s);
  return launch_units<TX, __half>(a, nu, has_bias, fast, threads, blocks, smem, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (rows, hidden) with row stride x_stride (elements, unit column
// stride); w, b (hidden,) contiguous (b null without a bias); y (rows,
// hidden) contiguous. Dtype codes: 0 fp32, 1 bf16, 2 fp16. The geometry
// (team_warps, nu, teams, stages, blocks, smem) comes from
// ops/normalization.py ln_fwd_geometry. One launch on `stream`; returns the
// CUDA error (0 on success).
extern "C" int ln_fwd(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
                      long long x_stride, int x_dtype, int w_dtype, int b_dtype, int y_dtype,
                      int rms, int has_bias, float eps, int team_warps, int nu, int teams,
                      int stages, int blocks, int smem, void* stream) {
  if (hidden <= 0 || rows < 0 || blocks <= 0 || stages < 1 || stages > 3 || teams < 1 ||
      (team_warps != 1 && team_warps != 2 && team_warps != 4 && team_warps != 8) ||
      team_warps * teams > kMaxWarps || x_dtype < kF32 || x_dtype > kF16 || y_dtype < kF32 ||
      y_dtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xs = dtype_bytes(x_dtype);
  // whole 16-byte chunks on 16-byte boundaries everywhere
  const int fast = hidden % kVec == 0 && aligned16(x) && (x_stride * xs) % 16 == 0 &&
                   aligned16(y) && aligned16(w) && aligned16(b);
  const Args a{x, w, b, y, rows, hidden, x_stride, w_dtype, b_dtype, team_warps, stages, rms, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * team_warps * teams;
  cudaError_t e;
  if (x_dtype == kF32)
    e = launch_out<float>(a, y_dtype, nu, has_bias, fast, threads, blocks, smem, s);
  else if (x_dtype == kBF16)
    e = launch_out<__nv_bfloat16>(a, y_dtype, nu, has_bias, fast, threads, blocks, smem, s);
  else
    e = launch_out<__half>(a, y_dtype, nu, has_bias, fast, threads, blocks, smem, s);
  return static_cast<int>(e);
}

// one launch of a kernel that does nothing, one warp, on `stream`: the
// launch floor that K1's smallest calls are read against
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
