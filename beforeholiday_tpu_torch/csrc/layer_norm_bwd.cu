// K3: LayerNorm / RMSNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces beforeholiday_tpu/ops/normalization.py:69 _ln_bwd_kernel
// (launched by _ln_bwd_pallas at :134): dx in closed form from the mean and
// rstd recomputed from x, as the TPU kernel does, and dgamma/dbeta summed
// over every row. x and dy come in fp32, bf16 or fp16 (not necessarily the
// same), w in any of the three; dx is written in x's dtype, dgamma/dbeta in
// w's, from fp32 sums.
//
// Bound on an H100: bytes. At the training shape (16384 x 1024 bf16 x, dy
// and dx, fp32 w) a call must move 100.7 MB, 0.030 ms at 3.35 TB/s, against
// about 0.18 GFLOP of fp32 arithmetic. A kernel that reaches the bound keeps
// HBM busy all the time: loads in flight while rows compute, and nothing but
// x, dy and dx crossing it.
//
// Design:
// - Persistent blocks of 8 warps (two an SM at widths up to 8192, one above),
//   sized from the SM count by the wrapper (ops/normalization.py
//   ln_bwd_geometry). A team of 1-8 warps owns one row at a time: one warp
//   up to hidden 1024, so a row's three reductions are warp shuffles with no
//   barrier; wider rows take a team of warps and one named barrier a
//   reduction.
// - A ring of up to 3 stages in shared memory, filled by 16-byte cp.async
//   from the team's next rows while it computes the current one (a row whose
//   bytes are not 16-byte aligned is copied by plain loads instead).
// - Three passes over the staged row: the mean; then the variance, sum(dy w)
//   and sum(dy w (x - mean)); then dx = rstd (dy w - m1 - xhat m2), stored
//   straight from registers, 4 elements a lane.
// - Each thread owns the same columns in every row its team walks and
//   accumulates their dgamma/dbeta in registers; at the end the teams of a
//   block are summed in team order in shared memory, one fp32 partial row a
//   block, and a second small launch sums the partial rows in block order.
//   No atomics: the result is the same bits on every call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;           // consecutive elements a lane owns: a unit
constexpr int kRedFloats = 4;     // reduction slots a warp writes per pass
constexpr int kSumCols = 32;      // columns of a block of the second launch
constexpr int kSumWarps = 32;     // and its warps

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

// four consecutive elements from shared memory (the unit is 4-element aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const T* h = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_float(h[i]);
}

// four consecutive elements to global memory, 16 or 8 bytes at once
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  uint2 q;
  T* h = reinterpret_cast<T*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = from_float<T>(v[i]);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ float load_any(const void* p, int i, int dtype) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return to_float(static_cast<const __nv_bfloat16*>(p)[i]);
  return to_float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void store_any(void* p, int i, float v, int dtype) {
  if (dtype == kF32)
    static_cast<float*>(p)[i] = v;
  else if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(v);
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

// the threads of one team: a warp, or warps on named barrier 1 + team
__device__ __forceinline__ void team_sync(int team, int team_threads) {
  if (team_threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(team_threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sums of `n` values over the team, the same bits in every thread: warp
// shuffles, then the team's warps in order through shared memory
template <int N>
__device__ __forceinline__ void team_sum(float (&v)[N], float* red, int team, int team_warps,
                                         int lane, int warp) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (team_warps == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp * kRedFloats + i] = v[i];
  }
  team_sync(team, 32 * team_warps);
  const int first = team * team_warps;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int k = 0; k < team_warps; ++k) s += red[(first + k) * kRedFloats + i];
    v[i] = s;
  }
}

struct Args {
  const void* x;
  const void* dy;
  const void* w;
  void* dx;
  float* partial;  // (2, gridDim.x, hidden): dgamma's partial rows, then dbeta's
  int rows, hidden;
  long long x_stride, dy_stride;  // elements
  int w_dtype, rms, has_bias, team_warps, stages, async_rows;
  float eps;
};

// NU: units of kVec elements a lane owns in a row (the team's 32 x team_warps
// lanes cover ceil(hidden / kVec) units)
template <typename TX, typename TD, int NU, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks) ln_bwd_rows(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team_threads = 32 * a.team_warps, teams = kWarps / a.team_warps;
  const int team = warp / a.team_warps, t = tid - team * team_threads;
  const int units = (H + kVec - 1) / kVec;
  const bool tail = (H % kVec) != 0;
  const int xb = (H * static_cast<int>(sizeof(TX)) + 15) & ~15;
  const int db = (H * static_cast<int>(sizeof(TD)) + 15) & ~15;
  const int row_bytes = xb + db;

  float* w_s = reinterpret_cast<float*>(smem);
  float* red = w_s + ((H + 3) & ~3);  // 2 passes x kWarps x kRedFloats
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + 2 * kWarps * kRedFloats);
  float acc_w[NU * kVec], acc_b[NU * kVec];
#pragma unroll
  for (int i = 0; i < NU * kVec; ++i) acc_w[i] = acc_b[i] = 0.f;

  const int S = a.stages;
  const int G = gridDim.x * teams;
  const int first_row = blockIdx.x * teams + team;

  // copy row r of x and dy into stage s of this team's ring
  auto issue = [&](int r, int s) {
    if (r < a.rows) {
      unsigned char* xs = ring + (s * teams + team) * row_bytes;
      unsigned char* ds = xs + xb;
      const TX* gx = static_cast<const TX*>(a.x) + r * a.x_stride;
      const TD* gd = static_cast<const TD*>(a.dy) + r * a.dy_stride;
      if (a.async_rows) {
        const int nx = H * static_cast<int>(sizeof(TX)) / 16;
        const int nd = H * static_cast<int>(sizeof(TD)) / 16;
        for (int c = t; c < nx; c += team_threads)
          cp_async16(xs + 16 * c, reinterpret_cast<const unsigned char*>(gx) + 16 * c);
        for (int c = t; c < nd; c += team_threads)
          cp_async16(ds + 16 * c, reinterpret_cast<const unsigned char*>(gd) + 16 * c);
      } else {
        TX* sx = reinterpret_cast<TX*>(xs);
        TD* sd = reinterpret_cast<TD*>(ds);
        for (int c = t; c < units * kVec; c += team_threads) {
          sx[c] = c < H ? gx[c] : from_float<TX>(0.f);
          sd[c] = c < H ? gd[c] : from_float<TD>(0.f);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) issue(first_row + s * G, s);
  // w, while the first rows are on their way
  for (int c = tid; c < H; c += kThreads) w_s[c] = load_any(a.w, c, a.w_dtype);
  __syncthreads();
  for (int k = 0;; ++k) {
    const int r = first_row + k * G;
    if (r >= a.rows) break;
    issue(r + (S - 1) * G, (k + S - 1) % S);
    cp_async_wait(S - 1);
    team_sync(team, team_threads);

    const unsigned char* xs = ring + ((k % S) * teams + team) * row_bytes;
    const TX* sx = reinterpret_cast<const TX*>(xs);
    const TD* sd = reinterpret_cast<const TD*>(xs + xb);

    // pass 1: the mean (LayerNorm)
    float mean = 0.f;
    if (!a.rms) {
      float s1[1] = {0.f};
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const int u = t + j * team_threads;
        if (u < units) {
          float xv[4];
          load4(sx + u * kVec, xv);
          s1[0] += (xv[0] + xv[1]) + (xv[2] + xv[3]);  // the tail is staged as 0
        }
      }
      team_sum(s1, red, team, a.team_warps, lane, warp);
      mean = s1[0] / H;
    }
    // pass 2: sum (x - mean)^2, sum dy w, sum dy w (x - mean)
    float s2[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = t + j * team_threads;
      if (u < units) {
        float xv[4], dv[4], wv[4];
        load4(sx + u * kVec, xv);
        load4(sd + u * kVec, dv);
        load4(w_s + u * kVec, wv);
        const int n = tail ? min(kVec, H - u * kVec) : kVec;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xc = i < n ? xv[i] - mean : 0.f, dyw = dv[i] * wv[i];
          s2[0] += xc * xc;
          s2[1] += dyw;
          s2[2] += dyw * xc;
        }
      }
    }
    team_sum(s2, red + kWarps * kRedFloats, team, a.team_warps, lane, warp);
    const float rstd = rsqrtf(s2[0] / H + a.eps);
    const float m1 = a.rms ? 0.f : s2[1] / H;
    const float m2 = s2[2] * rstd / H;
    // pass 3: dx, and this thread's columns of dgamma / dbeta
    TX* gdx = static_cast<TX*>(a.dx) + static_cast<long long>(r) * H;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = t + j * team_threads;
      if (u < units) {
        float xv[4], dv[4], wv[4], out[4];
        load4(sx + u * kVec, xv);
        load4(sd + u * kVec, dv);
        load4(w_s + u * kVec, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xhat = (xv[i] - mean) * rstd;
          out[i] = rstd * (dv[i] * wv[i] - m1 - xhat * m2);
          acc_w[j * kVec + i] += dv[i] * xhat;
          acc_b[j * kVec + i] += dv[i];
        }
        if (!tail) {
          store4(gdx + u * kVec, out);
        } else {
          const int n = min(kVec, H - u * kVec);
          for (int i = 0; i < n; ++i) gdx[u * kVec + i] = from_float<TX>(out[i]);
        }
      }
    }
    team_sync(team, team_threads);
  }

  // the block's partial row: each team's columns through shared memory,
  // summed over the teams in order
  cp_async_wait(0);
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(ring);  // (teams, 2, H)
  const int hp = (H + 3) & ~3;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = t + j * team_threads;
    if (u < units) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_s[(team * 2) * hp + u * kVec + i] = acc_w[j * kVec + i];
        acc_s[(team * 2 + 1) * hp + u * kVec + i] = acc_b[j * kVec + i];
      }
    }
  }
  __syncthreads();
  float* pw = a.partial + static_cast<long long>(blockIdx.x) * H;
  float* pb = a.partial + static_cast<long long>(gridDim.x + blockIdx.x) * H;
  for (int c = tid; c < H; c += kThreads) {
    float sw = 0.f, sb = 0.f;
    for (int q = 0; q < teams; ++q) {
      sw += acc_s[(q * 2) * hp + c];
      sb += acc_s[(q * 2 + 1) * hp + c];
    }
    pw[c] = sw;
    if (a.has_bias) pb[c] = sb;
  }
}

// dgamma / dbeta: the partial rows summed in block order, 32 columns a
// block; each of its warps sums a strided share of the rows (unrolled, so
// the loads are in flight together), then the warps in order
__global__ void __launch_bounds__(32 * kSumWarps)
ln_bwd_sum(const float* __restrict__ partial, int parts, int hidden, void* dw, void* db,
           int w_dtype, int has_bias) {
  __shared__ float s[2][kSumWarps][kSumCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kSumCols + lane;
  float sw = 0.f, sb = 0.f;
  if (c < hidden) {
#pragma unroll 4
    for (int p = warp; p < parts; p += kSumWarps) {
      sw += partial[static_cast<long long>(p) * hidden + c];
      if (has_bias) sb += partial[static_cast<long long>(parts + p) * hidden + c];
    }
  }
  s[0][warp][lane] = sw;
  s[1][warp][lane] = sb;
  __syncthreads();
  if (warp == 0 && c < hidden) {
    float tw = 0.f, tb = 0.f;
    for (int k = 0; k < kSumWarps; ++k) {
      tw += s[0][k][lane];
      tb += s[1][k][lane];
    }
    store_any(dw, c, tw, w_dtype);
    if (has_bias) store_any(db, c, tb, w_dtype);
  }
}

template <typename TX, typename TD, int NU, int MinBlocks>
cudaError_t launch_rows(const Args& a, int blocks, int smem, cudaStream_t stream) {
  auto kernel = ln_bwd_rows<TX, TD, NU, MinBlocks>;
  if (smem > 48 * 1024) {  // set on every call: the attribute is per device
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TD>
cudaError_t launch_units(const Args& a, int nu, int blocks, int smem, cudaStream_t stream) {
  if (nu == 8) return launch_rows<TX, TD, 8, 2>(a, blocks, smem, stream);
  if (nu == 16) return launch_rows<TX, TD, 16, 1>(a, blocks, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_dy(const Args& a, int dy_dtype, int nu, int blocks, int smem,
                      cudaStream_t stream) {
  if (dy_dtype == kF32) return launch_units<TX, float>(a, nu, blocks, smem, stream);
  if (dy_dtype == kBF16) return launch_units<TX, __nv_bfloat16>(a, nu, blocks, smem, stream);
  if (dy_dtype == kF16) return launch_units<TX, __half>(a, nu, blocks, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, hidden) and dy with row strides x_stride, dy_stride (elements,
// unit column stride); w (hidden,); dx (rows, hidden) contiguous in x's
// dtype; dw, db (hidden,) in w's dtype (db unused without a bias); partial:
// fp32 scratch of 2 x blocks x hidden. Dtype codes: 0 fp32, 1 bf16, 2 fp16.
// The geometry (team_warps, nu, stages, blocks, smem, async_rows) comes from
// ops/normalization.py ln_bwd_geometry. Two launches on `stream`; returns
// the first CUDA error (0 on success).
extern "C" int ln_bwd(const void* x, const void* dy, const void* w, void* dx, void* dw,
                      void* db, float* partial, int rows, int hidden, long long x_stride,
                      long long dy_stride, int x_dtype, int dy_dtype, int w_dtype, int rms,
                      int has_bias, float eps, int team_warps, int nu, int stages, int blocks,
                      int smem, int async_rows, void* stream) {
  if (hidden <= 0 || rows < 0 || blocks <= 0 || stages < 1 || stages > 3 ||
      (team_warps != 1 && team_warps != 2 && team_warps != 4 && team_warps != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, dy, w, dx, partial, rows, hidden, x_stride, dy_stride, w_dtype,
               rms, has_bias, team_warps, stages, async_rows, eps};
  cudaError_t e;
  if (x_dtype == kF32)
    e = launch_dy<float>(a, dy_dtype, nu, blocks, smem, s);
  else if (x_dtype == kBF16)
    e = launch_dy<__nv_bfloat16>(a, dy_dtype, nu, blocks, smem, s);
  else if (x_dtype == kF16)
    e = launch_dy<__half>(a, dy_dtype, nu, blocks, smem, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_sum<<<(hidden + kSumCols - 1) / kSumCols, 32 * kSumWarps, 0, s>>>(
      partial, blocks, hidden, dw, db, w_dtype, has_bias);
  return static_cast<int>(cudaGetLastError());
}
