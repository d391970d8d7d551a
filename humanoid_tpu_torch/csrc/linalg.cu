// Batched Cholesky factor, apply and solve of small SPD systems.
//
// Replaces the TPU kernels of humanoid_tpu/ops/linalg.py:
//   chol_factor_kernel  <- _chol_factor_kernel (factor_spd_pallas): L with
//                          its true diagonal and zeros above it;
//   chol_apply_kernel   <- _chol_apply_kernel (apply_spd_pallas): the two
//                          triangular sweeps L y = b, L^T x = y against a
//                          cached factor;
//   chol_solve_kernel   <- _chol_solve_kernel (solve_spd_pallas): factor and
//                          both sweeps in one pass, M x = b.
// The arithmetic is the TPU kernels': a left-looking factor with an rsqrt
// pivot, d = s * rsqrt(s), and the sweeps multiplying by the inverse
// diagonal (rsqrt in the solve, 1 / L[i][i] in the apply). A matrix that is
// not positive definite gives NaN, never an error: rsqrt of a negative
// pivot is NaN and 0 * rsqrt(0) is NaN, and both spread to every later
// entry.
//
// Layout: the port's env-major tensors, M and L (N, n, n) row-major, b and
// x (N, n); n is a runtime argument, at most MAX_N. The kernels read only
// the lower triangle of M and of L.
//
// What bounds it: at n = 18 a factor is 2,127 fp32 operations per env
// against 1,980 bytes moved (M's lower triangle in, the whole L out), a
// solve 2,775 against 828 bytes (M's lower triangle and b in, x out), an
// apply 666 against 828: all three are bound by bytes on this card.
//
// Design, the same for all three: a warp per env, several envs per block
// (FACTOR_ENVS, APPLY_ENVS, SOLVE_ENVS). The block copies its envs'
// matrices, which are contiguous, into shared memory with coalesced (float4
// where aligned) loads, keeping the lower triangle, each row at an odd
// stride so that the lanes reading one column of their rows hit distinct
// banks (stage_lower). Lane i owns row i and keeps it in registers
// (load_rows). The factor (factor_lanes): in column j the lanes i >= j form
// their entries in the left-looking order against row j of L, which lane j
// wrote back to shared memory, and take the pivot from lane j by shuffle.
// The sweeps (sweeps_lanes): the forward one runs by columns (x_j from lane
// j by shuffle, then lanes i > j update from their registers), the backward
// one reads row j of L across the lanes (lanes i < j update). b is read and
// x written by the lanes side by side. The factor writes its L back from
// shared memory over the block's whole range, zeros above the diagonal
// included, with coalesced (float4 where aligned) stores (write_lower). The
// loops over columns are unrolled to MAX_N, so that a lane's row stays in
// registers.
//
// The per-env bodies are __host__ __device__ so that a host compiler can
// check their arithmetic; the wrappers never run them on the host. They are
// written for L lanes, lane l owning rows l, l + L, ...; outside nvcc's
// device pass their shuffles and syncs compile to nothing and a host build
// runs them with one lane (factor_env, apply_env, solve_env).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#define HDI __host__ __device__ __forceinline__
#else
#include <cmath>
#define HD
#define HDI inline
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
#endif

#define MAX_N 24
#define ROWS(L) ((MAX_N + (L) - 1) / (L))   // rows a lane of L owns, at most

#ifdef __CUDA_ARCH__
#define LANES_SYNC() __syncwarp()
#else
#define LANES_SYNC() ((void)0)
#endif

// v of lane `src` of the warp, on every lane (off the device: v).
HDI float from_lane(float v, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v, src);
#else
  (void)src;
  return v;
#endif
}

// ---------------------------------------------------------------------------
// The lane bodies: lane `lane` of L owns rows lane, lane + L, ... of the
// lower triangle in S (row i at S + i * P). Every lane of the L takes the
// same path through the shuffles and syncs.

// a: the lane's rows of S, zeros above the diagonal and past n.
template <int L, int P>
HDI void load_rows(const float* S, float (&a)[ROWS(L)][MAX_N], int n, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS(L); ++r) {
    const int i = lane + r * L;
#pragma unroll
    for (int k = 0; k < MAX_N; ++k) a[r][k] = i < n && k <= i ? S[i * P + k] : 0.0f;
  }
}

// y: the lane's entries of v (n), zeros past n.
template <int L>
HDI void load_vec(const float* v, float (&y)[ROWS(L)], int n, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS(L); ++r) {
    const int i = lane + r * L;
    y[r] = i < n ? v[i] : 0.0f;
  }
}

template <int L>
HDI void store_vec(float* v, const float (&y)[ROWS(L)], int n, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS(L); ++r) {
    const int i = lane + r * L;
    if (i < n) v[i] = y[r];
  }
}

// The factor, column by column: the lane's rows of M in a become its rows
// of L, which it also writes back into S, and iv its inverse pivots.
template <int L, int P>
HDI void factor_lanes(float* S, float (&a)[ROWS(L)][MAX_N], float (&iv)[ROWS(L)], int n,
                      int lane) {
#pragma unroll
  for (int r = 0; r < ROWS(L); ++r) iv[r] = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j >= n) break;
    float tj = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r) {
      const int i = lane + r * L;
      if (i >= j && i < n) {
        float s = a[r][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= a[r][k] * S[j * P + k];
        a[r][j] = s;
        if (i == j) tj = s;
      }
    }
    const float s = from_lane(tj, j % L);
    const float ivj = rsqrtf(s);
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r) {
      const int i = lane + r * L;
      if (i >= j && i < n) {
        a[r][j] = i == j ? s * ivj : a[r][j] * ivj;
        S[i * P + j] = a[r][j];
        if (i == j) iv[r] = ivj;
      }
    }
    LANES_SYNC();   // column j is written before column j + 1 reads row j + 1
  }
}

// y <- (L L^T)^-1 y with the lane's rows of L in a, all of L in S and the
// lane's inverse diagonal in iv.
template <int L, int P>
HDI void sweeps_lanes(const float* S, const float (&a)[ROWS(L)][MAX_N],
                      const float (&iv)[ROWS(L)], float (&y)[ROWS(L)], int n, int lane) {
  // L y = b by columns: x_j from its lane, then the rows below it
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j >= n) break;
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r)
      if (lane + r * L == j) mine = y[r] * iv[r];
    const float xj = from_lane(mine, j % L);
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r) {
      const int i = lane + r * L;
      if (i == j) y[r] = xj;
      else if (i > j && i < n) y[r] -= a[r][j] * xj;
    }
  }
  // L^T x = y by rows of L: x_j from its lane, then the rows above it
#pragma unroll
  for (int j = MAX_N - 1; j >= 0; --j) {
    if (j >= n) continue;
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r)
      if (lane + r * L == j) mine = y[r] * iv[r];
    const float xj = from_lane(mine, j % L);
#pragma unroll
    for (int r = 0; r < ROWS(L); ++r) {
      const int i = lane + r * L;
      if (i == j) y[r] = xj;
      else if (i < j) y[r] -= S[j * P + i] * xj;
    }
  }
}

// B5: x = M^-1 b for the lower triangle of M in S; S ends holding L.
template <int L, int P>
HDI void solve_lanes(float* S, const float* b, float* x, int n, int lane) {
  float a[ROWS(L)][MAX_N], y[ROWS(L)], iv[ROWS(L)];
  load_rows<L, P>(S, a, n, lane);
  load_vec<L>(b, y, n, lane);
  factor_lanes<L, P>(S, a, iv, n, lane);
  sweeps_lanes<L, P>(S, a, iv, y, n, lane);
  store_vec<L>(x, y, n, lane);
}

// B4: x = (L L^T)^-1 b for the lower triangle of L in S, the inverse
// diagonal by a true division, as the TPU kernel's 1.0 / L[i][i].
template <int L, int P>
HDI void apply_lanes(const float* S, const float* b, float* x, int n, int lane) {
  float a[ROWS(L)][MAX_N], y[ROWS(L)], iv[ROWS(L)];
  load_rows<L, P>(S, a, n, lane);
#pragma unroll
  for (int r = 0; r < ROWS(L); ++r) {
    const int i = lane + r * L;
    iv[r] = i < n ? 1.0f / S[i * P + i] : 0.0f;
  }
  load_vec<L>(b, y, n, lane);
  sweeps_lanes<L, P>(S, a, iv, y, n, lane);
  store_vec<L>(x, y, n, lane);
}

// B3: the factor of the lower triangle of M in S, left in S.
template <int L, int P>
HDI void factor_only_lanes(float* S, int n, int lane) {
  float a[ROWS(L)][MAX_N], iv[ROWS(L)];
  load_rows<L, P>(S, a, n, lane);
  factor_lanes<L, P>(S, a, iv, n, lane);
}

// ---------------------------------------------------------------------------
// One env with one lane: the host build's entries.

HD inline void stage_env(const float* M, float* S, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) S[i * MAX_N + j] = M[i * n + j];
}

HD void factor_env(const float* M, float* Lout, int n) {
  float S[MAX_N * MAX_N];
  stage_env(M, S, n);
  factor_only_lanes<1, MAX_N>(S, n, 0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) Lout[i * n + j] = j <= i ? S[i * MAX_N + j] : 0.0f;
}

HD void apply_env(const float* Lin, const float* b, float* x, int n) {
  float S[MAX_N * MAX_N];
  stage_env(Lin, S, n);
  apply_lanes<1, MAX_N>(S, b, x, n, 0);
}

HD void solve_env(const float* M, const float* b, float* x, int n) {
  float S[MAX_N * MAX_N];
  stage_env(M, S, n);
  solve_lanes<1, MAX_N>(S, b, x, n, 0);
}

#ifdef __CUDACC__

#define WARP 32
// envs (warps) per block of each kernel: the fastest of 4, 8 and 16 (of 1,
// 2, 4 and 8 for the solve) at 4096 envs and n = 18 on an H100
constexpr int FACTOR_ENVS = 16;
constexpr int APPLY_ENVS = 8;
constexpr int SOLVE_ENVS = 8;
constexpr int STAGE_P = MAX_N | 1;   // the row stride: odd, so a column's lanes hit distinct banks
constexpr int STAGE_STRIDE = MAX_N * STAGE_P;   // floats per env

// Entry s of a block's row-major (n, n) matrices as env e, row i, column j
// (the quotients in float: exact for s < 2^22, since s + 0.5 sits 0.5 / nn
// inside its interval).
struct Entry {
  int e, i, j;
};
__device__ __forceinline__ Entry entry_of(int s, int n, int nn, float inv_n, float inv_nn) {
  const int e = static_cast<int>((s + 0.5f) * inv_nn), r = s - e * nn;
  const int i = static_cast<int>((r + 0.5f) * inv_n);
  return {e, i, r - i * n};
}

// The lower triangles of the block's `envs` matrices, contiguous from src,
// into S (env e's row i at S + e * STAGE_STRIDE + i * STAGE_P), by the
// whole block.
__device__ __forceinline__ void stage_lower(const float* __restrict__ src, float* S, int envs,
                                            int n) {
  const int nn = n * n, total = envs * nn;
  const float inv_nn = 1.0f / nn, inv_n = 1.0f / n;
  auto put = [&](int s, float v) {
    const Entry t = entry_of(s, n, nn, inv_n, inv_nn);
    if (t.j <= t.i) S[t.e * STAGE_STRIDE + t.i * STAGE_P + t.j] = v;
  };
  int s0 = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15u) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = threadIdx.x; q < total / 4; q += blockDim.x) {
      const float4 v = src4[q];
      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
    }
    s0 = total / 4 * 4;
  }
  for (int s = s0 + threadIdx.x; s < total; s += blockDim.x) put(s, src[s]);
}

// The whole (n, n) matrices of the block's `envs` envs from the lower
// triangles in S, exact zeros above the diagonal, contiguous into dst, by
// the whole block.
__device__ __forceinline__ void write_lower(const float* S, float* __restrict__ dst, int envs,
                                            int n) {
  const int nn = n * n, total = envs * nn;
  const float inv_nn = 1.0f / nn, inv_n = 1.0f / n;
  auto get = [&](int s) {
    const Entry t = entry_of(s, n, nn, inv_n, inv_nn);
    return t.j <= t.i ? S[t.e * STAGE_STRIDE + t.i * STAGE_P + t.j] : 0.0f;
  };
  int s0 = 0;
  if ((reinterpret_cast<unsigned long long>(dst) & 15u) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; q < total / 4; q += blockDim.x)
      dst4[q] = make_float4(get(4 * q), get(4 * q + 1), get(4 * q + 2), get(4 * q + 3));
    s0 = total / 4 * 4;
  }
  for (int s = s0 + threadIdx.x; s < total; s += blockDim.x) dst[s] = get(s);
}

// The factor: a warp per env, the block's matrices staged in shared memory
// and its L written back from there.
__global__ void __launch_bounds__(FACTOR_ENVS * WARP)
chol_factor_kernel(const float* __restrict__ M, float* __restrict__ L, int N, int n) {
  __shared__ float S[FACTOR_ENVS * STAGE_STRIDE];
  const int first = blockIdx.x * FACTOR_ENVS;
  const int envs = min(FACTOR_ENVS, N - first);
  const long long off = static_cast<long long>(first) * n * n;
  stage_lower(M + off, S, envs, n);
  __syncthreads();
  const int w = threadIdx.x / WARP;
  // a warp past N factors nothing, but stays for the block's write-out
  if (w < envs) factor_only_lanes<WARP, STAGE_P>(S + w * STAGE_STRIDE, n, threadIdx.x % WARP);
  __syncthreads();
  write_lower(S, L + off, envs, n);
}

// The apply: a warp per env, the block's factors staged in shared memory.
__global__ void __launch_bounds__(APPLY_ENVS * WARP)
chol_apply_kernel(const float* __restrict__ L, const float* __restrict__ b,
                  float* __restrict__ x, int N, int n) {
  __shared__ float S[APPLY_ENVS * STAGE_STRIDE];
  const int first = blockIdx.x * APPLY_ENVS;
  const int envs = min(APPLY_ENVS, N - first);
  stage_lower(L + static_cast<long long>(first) * n * n, S, envs, n);
  __syncthreads();
  const int w = threadIdx.x / WARP;
  if (w >= envs) return;   // a whole warp past N: no later sync waits for it
  const long long e = first + w;
  apply_lanes<WARP, STAGE_P>(S + w * STAGE_STRIDE, b + e * n, x + e * n, n, threadIdx.x % WARP);
}

// The solve: a warp per env, the block's matrices staged in shared memory.
__global__ void __launch_bounds__(SOLVE_ENVS * WARP)
chol_solve_kernel(const float* __restrict__ M, const float* __restrict__ b,
                  float* __restrict__ x, int N, int n) {
  __shared__ float S[SOLVE_ENVS * STAGE_STRIDE];
  const int first = blockIdx.x * SOLVE_ENVS;
  const int envs = min(SOLVE_ENVS, N - first);
  stage_lower(M + static_cast<long long>(first) * n * n, S, envs, n);
  __syncthreads();
  const int w = threadIdx.x / WARP;
  if (w >= envs) return;   // a whole warp past N: no later sync waits for it
  const long long e = first + w;
  solve_lanes<WARP, STAGE_P>(S + w * STAGE_STRIDE, b + e * n, x + e * n, n, threadIdx.x % WARP);
}

static inline int blocks(int N, int envs) { return (N + envs - 1) / envs; }

extern "C" int chol_factor_launch(const float* M, float* L, int N, int n, void* stream) {
  if (N == 0) return 0;
  chol_factor_kernel<<<blocks(N, FACTOR_ENVS), FACTOR_ENVS * WARP, 0,
                       static_cast<cudaStream_t>(stream)>>>(M, L, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chol_apply_launch(const float* L, const float* b, float* x, int N, int n,
                                 void* stream) {
  if (N == 0) return 0;
  chol_apply_kernel<<<blocks(N, APPLY_ENVS), APPLY_ENVS * WARP, 0,
                      static_cast<cudaStream_t>(stream)>>>(L, b, x, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chol_solve_launch(const float* M, const float* b, float* x, int N, int n,
                                 void* stream) {
  if (N == 0) return 0;
  chol_solve_kernel<<<blocks(N, SOLVE_ENVS), SOLVE_ENVS * WARP, 0,
                      static_cast<cudaStream_t>(stream)>>>(M, b, x, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linalg_max_n() { return MAX_N; }

extern "C" int chol_factor_envs_per_block() { return FACTOR_ENVS; }

extern "C" int chol_apply_envs_per_block() { return APPLY_ENVS; }

extern "C" int chol_solve_envs_per_block() { return SOLVE_ENVS; }

#endif
